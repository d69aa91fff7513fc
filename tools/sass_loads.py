"""How a CUDA kernel issues its loads: build CUDA sources as the port
builds them (nvcc for sm_90a, see ``src/repro_torch/kernels/_build.py``),
disassemble them with ``cuobjdump -sass`` and print, per entry function,
the instruction count, the global loads (``LDG``), the asynchronous copies
to shared memory (``LDGSTS``, cp.async), the shared loads (``LDS``) and
how the global loads are grouped: ``ldg_runs`` lists the lengths of the
runs of global loads issued with no other instruction between them, in
program order. A kernel whose loads come one or two at a time between
arithmetic waits a round trip to memory per run. One JSON line per
function.

    python3 tools/sass_loads.py src/repro_torch/kernels/csrc/qdwconv.cu [...]

Needs the CUDA toolkit (nvcc, cuobjdump); the outputs go to a temporary
directory.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def sass_summary(sass: str) -> dict:
    """Entry function (mangled) -> load counts and runs of its SASS."""
    out, fn, ops = {}, None, []

    def close():
        if fn is None:
            return
        runs, run = [], 0
        for op in ops:
            if op.startswith("LDG") and not op.startswith("LDGSTS"):
                run += 1
            elif run:
                runs.append(run)
                run = 0
        if run:
            runs.append(run)
        out[fn] = {"instructions": len(ops),
                   "ldg": sum(runs),
                   "ldgsts": sum(op.startswith("LDGSTS") for op in ops),
                   "lds": sum(op.startswith("LDS") for op in ops),
                   "ldg_runs": runs}

    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            close()
            fn, ops = m.group(1), []
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                      line)
        if m and fn is not None:
            ops.append(m.group(1))
    close()
    return out


def main(paths) -> int:
    from repro_torch.kernels import _build
    nvcc = _build._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        for i, path in enumerate(paths):
            lib = os.path.join(tmp, f"lib{i}.so")
            subprocess.run([nvcc, *_build.NVCC_FLAGS, "-o", lib, path],
                           check=True, capture_output=True, text=True)
            sass = subprocess.run([cuobjdump, "-sass", lib], check=True,
                                  capture_output=True, text=True).stdout
            for fn, summary in sass_summary(sass).items():
                print(json.dumps({"source": path, "function": fn, **summary}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
