"""The reference's dry run, for the port's launch tests and for
``tests/data/launch_ref.json`` (``tests/_torch_launch_data.py`` runs it).

  python tests/_torch_launch_ref.py OUT.json DATA MODEL SEQ BATCH \\
      [ARCH,...] [--sharded-cache] [--float32]
  python tests/_torch_launch_ref.py OUT.json --full ARCH SHAPE single|multi

The first form runs ``repro.launch.dryrun.run_one`` on the ``reduced()``
config of every architecture (or of those named), kinds train, prefill and
decode, on a ``(DATA, MODEL)`` ``("data", "model")`` mesh of fake host
devices, with the decoder stack unrolled (``transformer.UNROLL_STACK =
True``) so that ``cost_analysis`` counts every layer, and writes the
records to OUT.json. Each record also has, read from the compiled module
where the dry run parses its collectives (``tests/_torch_hlo.py``):
``dot_flops_per_device`` (its dots' FLOPs), ``bytes_recounted_per_device``
(its bytes accessed recounted by XLA's rules: ``bytes_per_device``, but
for rounding) and ``bytes_less_layout_per_device`` (the same without the
ops that only move or retype data, which an eager step runs as views).
With ``--sharded-cache`` it runs the decode kind only, the cache policy
patched so that a cache leaf shards its sequence over ``model``
(``CACHE_REPL_THRESHOLD_BYTES = 0``: every leaf is large enough;
``CACHE_MIN_SLICE = SHARDED_MIN_SLICE``: a trailing head or rank dimension's
slice falls below it, the sequence's does not); an arch named
``NAME+window`` is NAME's config with ``sliding_window = WINDOW`` (both
constants of ``tests/_torch_launch_data.py``). With ``--float32`` the
parameters and the cache are float32 (``PARAM_DTYPE``, ``CACHE_DTYPE``):
XLA on the CPU runs a bfloat16 step in float32, widening every
activation, and in float32 the two steps keep the same dtypes.

The second form runs one full-size record on the production mesh, its
depth corrected as ``benchmarks/bench_roofline.py`` ``corrected_costs``
does: the step at full width with 1 and 2 periods (FSDP as the full config
has it), the stack unrolled,
every count extrapolated linearly to the config's periods,
``f(L) = f(1) + (L - 1) * max(f(2) - f(1), 0)``. Its record also has
``dot_flops_whole_batch_per_device``: the FLOPs of the dots with a batch
dimension the size of the global batch, which every rank of the data axes
computes whole (under FSDP, GSPMD runs the forward pass's attention
products so: ``ROADMAP.md`` Queue 3 aa), and ``whole_batch_dots``, those
dots at 2 periods: the einsum each came from (None where XLA made the
dot), its operands' and output's dimensions, how many there are and their
FLOPs.

The JAX package is patched here, not edited: ``make_production_mesh``,
``INPUT_SHAPES`` and ``collective_bytes`` of its dry-run module, the cache
policy of its sharding module, the dtypes of its specs module, and
``UNROLL_STACK``.
"""
import os
import sys

from _torch_hlo import dot_flops, hlo_bytes
from _torch_launch_data import SHARDED_MIN_SLICE, WINDOW

out_path = sys.argv[1]
FULL = sys.argv[2] == "--full"
if FULL:
    full_arch, full_shape, full_mesh = sys.argv[3:6]
    n_dev = 512 if full_mesh == "multi" else 256
else:
    data, model, seq, batch = map(int, sys.argv[2:6])
    rest = [a for a in sys.argv[6:] if not a.startswith("--")]
    sharded_cache = "--sharded-cache" in sys.argv
    float32 = "--float32" in sys.argv
    n_dev = data * model
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_dev}"
os.environ["JAX_PLATFORMS"] = "cpu"

import collections  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import repro.launch.dryrun as D  # noqa: E402
from repro.configs import InputShape, get_config, list_configs  # noqa: E402
from repro.launch import sharding  # noqa: E402
from repro.launch import specs  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models import transformer  # noqa: E402

KINDS = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}
KEEP = ("arch", "shape", "mesh", "kind", "tag", "status", "n_devices",
        "dot_flops_per_device", "dot_flops_whole_batch_per_device",
        "whole_batch_dots", "flops_per_device", "bytes_per_device",
        "bytes_recounted_per_device", "bytes_less_layout_per_device",
        "collectives", "collective_bytes_total", "memory")

_seen = []
_collective_bytes = D.collective_bytes
WHOLE_BATCH = None  # full form: the global batch (see the record's field)


def collective_bytes(hlo):
    found = []
    _seen.append(dict(
        dot_flops_per_device=dot_flops(hlo),
        bytes_recounted_per_device=hlo_bytes(hlo),
        bytes_less_layout_per_device=hlo_bytes(hlo, layout=False)))
    if WHOLE_BATCH:
        _seen[-1]["dot_flops_whole_batch_per_device"] = dot_flops(
            hlo, WHOLE_BATCH, found)
        dots = collections.defaultdict(lambda: [0, 0])
        for eq, *dims, flops in found:
            key = (eq or "", *map(tuple, dims))
            dots[key][0] += 1
            dots[key][1] += flops
        _seen[-1]["whole_batch_dots"] = [
            {"einsum": eq or None, "lhs": list(lhs), "rhs": list(rhs),
             "out": list(out), "count": n, "flops": f}
            for (eq, lhs, rhs, out), (n, f) in sorted(dots.items())]
    return _collective_bytes(hlo)


def run(arch, shape_name, multi_pod, cfg, tag="", fsdp="auto"):
    rec = D.run_one(arch, shape_name, multi_pod, fsdp, cfg=cfg, out_dir="",
                    tag=tag)
    rec.update(_seen.pop() if _seen else {"dot_flops_per_device": None})
    if rec["status"] != "ok":
        return rec
    return {k: rec[k] for k in KEEP if k in rec}


def extrapolate(r1, r2, units):
    """``corrected_costs``'s line through the 1- and 2-period records, at
    ``units`` periods, of every number of a record."""
    def ext(a, b):
        if isinstance(a, list):  # whole_batch_dots: kept at 2 periods
            return b
        if isinstance(a, dict):
            return {k: ext(a[k], b[k]) for k in a}
        if isinstance(a, (int, float)) and not isinstance(a, bool):
            return type(a)(a + (units - 1) * max(b - a, 0))
        return a
    out = ext(r1, r2)
    out["tag"] = ""
    return out


D.collective_bytes = collective_bytes
transformer.UNROLL_STACK = True
recs = []
if FULL:
    from repro.configs import INPUT_SHAPES
    WHOLE_BATCH = INPUT_SHAPES[full_shape].global_batch
    cfg = get_config(full_arch)
    units = cfg.n_periods
    period = len(cfg.pattern())
    # the full config's choice (run_one's "auto"), kept at both depths
    fsdp = "on" if cfg.param_count() * 2 > 64e9 else "off"

    def depth(u):
        kw = {"n_layers": u * period}
        if cfg.encoder_layers:
            kw["encoder_layers"] = u
        return run(full_arch, full_shape, full_mesh == "multi",
                   dataclasses.replace(cfg, **kw), tag=f"u{u}", fsdp=fsdp)
    r1, r2 = depth(1), depth(2)
    assert r1["status"] == r2["status"] == "ok", (r1, r2)
    rec = extrapolate(r1, r2, units)
    rec["method"] = (f"depth-extrapolated: 1 and 2 periods at full width, "
                     f"the stack unrolled, f(L) = f(1) + (L - 1) * "
                     f"max(f(2) - f(1), 0) at L = {units} "
                     f"(benchmarks/bench_roofline.py corrected_costs)")
    recs.append(rec)
else:
    D.make_production_mesh = lambda multi_pod=False: make_mesh(
        (data, model), ("data", "model"))
    D.INPUT_SHAPES = {name: InputShape(name, seq, batch, kind)
                      for kind, name in KINDS.items()}
    kinds = KINDS
    if float32:
        specs.PARAM_DTYPE = specs.CACHE_DTYPE = jnp.float32
    if sharded_cache:
        sharding.CACHE_REPL_THRESHOLD_BYTES = 0
        sharding.CACHE_MIN_SLICE = SHARDED_MIN_SLICE
        kinds = {"decode": KINDS["decode"]}
    for arch in (rest[0].split(",") if rest else list_configs()):
        name, _, variant = arch.partition("+")
        cfg = get_config(name).reduced()
        if variant == "window":
            cfg = dataclasses.replace(cfg, sliding_window=WINDOW)
        for kind, shape_name in kinds.items():
            recs.append(run(name, shape_name, False, cfg, tag=variant))
with open(out_path, "w") as f:
    json.dump(recs, f)
