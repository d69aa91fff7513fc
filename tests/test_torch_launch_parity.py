"""The port's dry run against the reference's, sharded: FLOPs a device,
collective bytes and argument bytes of the ``reduced()`` config of every
architecture, kinds train, prefill and decode, seq 32 × batch 8 on a
(2, 4) ``data`` × ``model`` mesh.

The reference runs in subprocesses (``tests/_torch_launch_ref.py``: fake
host devices, the decoder stack unrolled so that ``cost_analysis`` counts
every layer), the port here, at the same time.

What is compared, and why:

* FLOPs. The port's meter counts the products (``torch.utils.flop_counter``:
  matmuls, batched matmuls); ``cost_analysis()["flops"]`` counts XLA's
  ``dot``s and every elementwise op too. So the port's count is held to the
  reference's ``dot`` FLOPs of the same compiled module: XLA's dots split
  exactly by the 8 devices, and so do the port's products, 1.00–1.02 in
  every record but mamba2's decode (1.06: the SSM's one-token step runs
  replicated over ``model``), well inside [0.75, 1.25]. Against the whole
  ``cost_analysis`` count the port reads XLA's dot share of it, 0.57–0.93
  (the elementwise ops weigh most in decode, where one token's products
  are small beside the masks, norms and softmax over the cache, and in the
  SSM's scan), and never above 1.25.
* Collective bytes: the port's DTensor collectives against the ones XLA
  put in the compiled module: at most 2.0× for the dense attention
  configs, 2.5× for the others.
* Argument bytes: equal, but where ``jax.jit`` drops an input the step
  never reads (:func:`_dropped_by_jit`); the port's record counts every
  argument.

The fault these hold (PR 20's dry run): DTensor's own rules sharded the
residual stream on ``d_model`` over ``model``. Its rule for the lookup in
a vocab-sharded embedding moved the table to a ``d_model`` shard, each
residual add reduce-scattered a block's partial sum onto that shard, the
norms gave partial (``Partial(avg)``) or ``d_model``-sharded activations,
and every column-parallel product that met one gathered its weight and ran
whole on each rank (stablelm-3b: 2.04 / 2.71 of the reference's FLOPs in
train / prefill, 9.1× its decode collectives). ``dryrun.reference_layout``
now keeps the stream replicated over ``model`` at every block boundary, as
GSPMD does.
"""
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest
from torch.distributed.tensor import Replicate

from repro_torch.configs import InputShape, get_config, list_configs
from repro_torch.launch import dryrun as D

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESH = ((2, 4), ("data", "model"))
SEQ, BATCH = 32, 8
KINDS = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}
ARCHS = list_configs()
DENSE = ("stablelm-3b", "starcoder2-3b", "internlm2-20b", "chatglm3-6b")
# the reference's runs, balanced by its compile times (jamba alone ~30 s)
REF_GROUPS = (("jamba-v0.1-52b",),
              ("deepseek-v2-236b", "kimi-k2-1t-a32b", "chatglm3-6b"),
              ("whisper-small", "mamba2-780m", "starcoder2-3b"),
              ("internvl2-26b", "stablelm-3b", "internlm2-20b"))
RECORDS = [(a, k) for a in ARCHS for k in KINDS]


def _shape(kind):
    return InputShape(KINDS[kind], SEQ, BATCH, kind)


def _port(arch, kind, mesh=MESH):
    rec = D.run_one(arch, KINDS[kind], False, cfg=get_config(arch).reduced(),
                    out_dir="", mesh_shape=mesh, input_shape=_shape(kind))
    assert rec["status"] == "ok", rec.get("traceback")
    return rec


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("launch_ref")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_launch_ref.py"),
         str(out / f"ref{i}.json"), *map(str, MESH[0]), str(SEQ), str(BATCH),
         ",".join(group)], cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
        for i, group in enumerate(REF_GROUPS)]
    try:
        port = {(a, k): _port(a, k) for a, k in RECORDS}
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ref = {}
    for i in range(len(REF_GROUPS)):
        for rec in json.loads((out / f"ref{i}.json").read_text()):
            assert rec["status"] == "ok", rec.get("traceback")
            ref[rec["arch"], rec["kind"]] = rec
    assert set(ref) == set(port)
    return port, ref


@pytest.mark.parametrize("arch,kind", RECORDS)
def test_flops_a_device_split_as_the_references(records, arch, kind):
    port, ref = records
    p, r = port[arch, kind], ref[arch, kind]
    to_dots = p["flops_per_device"] / r["dot_flops_per_device"]
    to_all = p["flops_per_device"] / r["flops_per_device"]
    assert 0.99 <= to_dots <= 1.07, (to_dots, to_all, p["fallback_ops"])
    if arch in DENSE:
        assert to_dots <= 1.01, to_dots  # every product split
    assert to_all <= 1.25, to_all


@pytest.mark.parametrize("arch,kind", RECORDS)
def test_collective_bytes_within_the_references(records, arch, kind):
    port, ref = records
    p, r = port[arch, kind], ref[arch, kind]
    ratio = p["collective_bytes_total"] / r["collective_bytes_total"]
    assert ratio <= (2.0 if arch in DENSE else 2.5), (ratio, p["collectives"])
    assert p["collective_bytes_total"] > 0


def _dropped_by_jit(cfg, kind, path):
    """Whether ``jax.jit`` drops the argument at ``path`` (argument index,
    then keys) from the reference's step (``keep_unused=False``): it never
    reads it. In decode: weights only the prompt uses (a VLM's projector,
    whisper's encoder and its cross-attention key / value projections) and
    the position where no layer reads it (an attention-free stack); in
    prefill, cache leaves the prompt replaces whole (SSM states, whisper's
    cross-attention cache, a VLM's cache, which its patches and the prompt
    overrun)."""
    arg, keys = path[0], path[1:]
    if kind == "decode":
        if arg == 0:
            return keys[0] in ("projector", "encoder", "enc_pos",
                               "enc_norm") or (
                "cross" in keys and keys[-1] in ("wk", "wv"))
        return arg == 3 and all(ld.mixer == "ssm" for ld in cfg.pattern())
    if kind == "prefill" and arg == 2:
        return keys[-1] in ("conv", "state") or "cross" in keys \
            or cfg.modality == "vision"
    return False


@pytest.mark.parametrize("arch,kind", RECORDS)
def test_argument_bytes_equal_the_references(records, arch, kind):
    from repro_torch.launch import sharding as SH
    port, ref = records
    cfg = get_config(arch).reduced()
    step, args, _ = D.build_step(cfg, _shape(kind))
    sizes = dict(zip(MESH[1], MESH[0]))
    specs = D.arg_shardings(cfg, _shape(kind), args, sizes, False)
    dropped = 0

    def walk(tree, spec, path):
        nonlocal dropped
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], spec[k], path + (k,))
        elif isinstance(tree, (list, tuple)) and not isinstance(tree, SH.Spec):
            for i, (t, s) in enumerate(zip(tree, spec)):
                walk(t, s, path + (i,))
        elif _dropped_by_jit(cfg, kind, path):
            shape = SH.local_shape(tree.shape, spec, sizes)
            dropped += tree.dtype.itemsize * math.prod(shape)
    walk(list(args), list(specs), ())
    got = port[arch, kind]["memory"]["argument_bytes"]
    assert got == port[arch, kind]["memory"]["argument_bytes_by_specs"]
    assert got - dropped == ref[arch, kind]["memory"]["argument_bytes"], \
        (got, dropped)


@pytest.mark.parametrize("kind", list(KINDS))
def test_model_axis_splits_as_the_data_axis(kind, monkeypatch):
    """stablelm-3b ``reduced()`` (4 heads, which divide 4; 2 key / value
    heads, which do not): a (1, 4) mesh computes no more a device than a
    (4, 1) one, within 1.25× (PR 20's dry run read far above it), and the
    residual stream reaches every norm replicated over ``model``."""
    from repro_torch.models import transformer as TR
    seen = []
    norm = TR.apply_norm

    def spy(cfg, p, x, *a, **k):
        seen.append(tuple(x.placements))
        return norm(cfg, p, x, *a, **k)
    monkeypatch.setattr(TR, "apply_norm", spy)
    by_model = _port("stablelm-3b", kind, ((1, 4), ("data", "model")))
    on_model = list(seen)
    by_data = _port("stablelm-3b", kind, ((4, 1), ("data", "model")))
    ratio = by_model["flops_per_device"] / by_data["flops_per_device"]
    assert ratio <= 1.25, ratio
    assert on_model and all(pl[1] == Replicate() for pl in on_model), \
        on_model
