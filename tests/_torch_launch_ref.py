"""The reference's dry run on a small fake mesh, for
``tests/test_torch_launch_parity.py``.

  python tests/_torch_launch_ref.py OUT.json DATA MODEL SEQ BATCH [ARCH,...]

Runs ``repro.launch.dryrun.run_one`` on the ``reduced()`` config of every
architecture (or of those named), kinds train, prefill and decode, on a
``(DATA, MODEL)`` ``("data", "model")`` mesh of fake host devices, with the
decoder stack unrolled (``transformer.UNROLL_STACK = True``) so that
``cost_analysis`` counts every layer, and writes the records to OUT.json,
each with ``dot_flops_per_device`` (:func:`dot_flops` of the compiled
module, read where the dry run parses its collectives). The JAX package
is patched here, not edited: ``make_production_mesh``, ``INPUT_SHAPES``
and ``collective_bytes`` of its dry-run module.
"""
import os
import sys

out_path, data, model, seq, batch = sys.argv[1], *map(int, sys.argv[2:6])
os.environ["XLA_FLAGS"] = \
    f"--xla_force_host_platform_device_count={data * model}"
os.environ["JAX_PLATFORMS"] = "cpu"

import json  # noqa: E402
import re  # noqa: E402

import repro.launch.dryrun as D  # noqa: E402
from repro.configs import InputShape, get_config, list_configs  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models import transformer  # noqa: E402

KINDS = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}

_SHAPE = re.compile(r"^\s*(?:ROOT )?%?([\w.\-]+) = \w+\[([\d,]*)\]")
_DOT = re.compile(r"dot\(%?([\w.\-]+), %?([\w.\-]+)\).*"
                  r"lhs_contracting_dims=\{([\d,]*)\}")


def dot_flops(hlo: str) -> int:
    """2·M·N·K of every ``dot`` in the compiled module: the matmul part of
    ``cost_analysis()["flops"]``, which also counts elementwise ops."""
    dims, total = {}, 0
    for line in hlo.splitlines():
        m = _SHAPE.match(line)
        if m:
            dims[m.group(1)] = [int(d) for d in m.group(2).split(",") if d]
    for line in hlo.splitlines():
        d = _DOT.search(line)
        if not d or " dot(" not in line:
            continue
        k = 1
        for i in filter(None, d.group(3).split(",")):
            k *= dims[d.group(1)][int(i)]
        total += 2 * k * _numel(dims[_SHAPE.match(line).group(1)])
    return total


def _numel(shape):
    n = 1
    for d in shape:
        n *= d
    return n


_seen = []
_collective_bytes = D.collective_bytes


def collective_bytes(hlo):
    _seen.append(dot_flops(hlo))
    return _collective_bytes(hlo)


D.collective_bytes = collective_bytes
transformer.UNROLL_STACK = True
D.make_production_mesh = lambda multi_pod=False: make_mesh(
    (data, model), ("data", "model"))
D.INPUT_SHAPES = {name: InputShape(name, seq, batch, kind)
                  for kind, name in KINDS.items()}
recs = []
for arch in (sys.argv[6].split(",") if len(sys.argv) > 6
             else list_configs()):
    for kind, name in KINDS.items():
        rec = D.run_one(arch, name, False, cfg=get_config(arch).reduced(),
                        out_dir="")
        rec["dot_flops_per_device"] = _seen.pop() if _seen else None
        recs.append(rec)
with open(out_path, "w") as f:
    json.dump(recs, f)
