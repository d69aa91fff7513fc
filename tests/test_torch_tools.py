"""The port's command-line tools that need no card: ``tools/sass_loads.py``
reads ``cuobjdump -sass`` text (the disassembly itself needs the CUDA
toolkit, so a fixed excerpt stands in for it here)."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from sass_loads import sass_summary  # noqa: E402

SASS = """
        code for sm_90a
                Function : _Z3onePKaPa
        .headerflags    @"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDG.E.64 R2, desc[UR4][R2.64] ;
        /*0020*/                   LDG.E R4, desc[UR4][R4.64] ;
        /*0030*/                   IMAD R6, R2, R4, RZ ;
        /*0040*/               @P0 LDG.E R7, desc[UR4][R8.64] ;
        /*0050*/                   LDGSTS.E.BYPASS.128 [R9], desc[UR4][R10.64] ;
        /*0060*/              @!P1 LDS R11, [R12] ;
        /*0070*/                   EXIT ;
                Function : _Z3twov
        /*0000*/                   EXIT ;
"""


def test_sass_summary_groups_global_loads():
    """Per function: instructions, global loads in runs issued back to back
    (a predicated load counts; cp.async and shared loads are apart)."""
    got = sass_summary(SASS)
    assert got["_Z3onePKaPa"] == {"instructions": 8, "ldg": 3, "ldgsts": 1,
                                  "lds": 1, "ldg_runs": [2, 1]}
    assert got["_Z3twov"] == {"instructions": 1, "ldg": 0, "ldgsts": 0,
                              "lds": 0, "ldg_runs": []}
