"""The port's dry run (``repro_torch.launch.dryrun``): meta DTensors over a
fake process group, per-device bytes by shard arithmetic, FLOPs and
collectives of rank 0's local ops, and the CLI's files."""
import json
import math

import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import InputShape, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import sharding as SH

MESH24 = ((2, 4), ("data", "model"))
SMALL = {"train": InputShape("train_4k", 16, 8, "train"),
         "prefill": InputShape("prefill_32k", 16, 8, "prefill"),
         "decode": InputShape("decode_32k", 16, 8, "decode")}


def _dt(mesh, shape, placements, dtype=torch.float32):
    local = list(shape)
    for m, pl in enumerate(placements):
        if isinstance(pl, Shard):
            local[pl.dim] //= mesh.size(m)
    return DTensor.from_local(torch.empty(local, dtype=dtype, device="meta"),
                              mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def test_meter_counts_known_collectives_and_local_flops():
    """Column- then row-parallel products on a (2, 4) mesh: the second
    product is a partial sum over 'model', reduced by one all-reduce of
    the local output; gathering a model-sharded tensor is one all-gather
    of the full local block. FLOPs are the local products' (DTensor's
    propagation on global shapes is not counted)."""
    with TMESH.fake_world(8):
        mesh = TMESH.make_mesh(*MESH24, "cpu")
        x = _dt(mesh, (8, 64), [Shard(0), Replicate()])
        w1 = _dt(mesh, (64, 128), [Replicate(), Shard(1)])
        w2 = _dt(mesh, (128, 64), [Replicate(), Shard(0)])
        meter = D.StepMeter()
        with implicit_replication(), meter.outside_propagation(), meter:
            h = x @ w1                      # (S(0), S(1)), local (4, 32)
            y = h @ w2                      # (S(0), Partial)
            y = y.redistribute(mesh, [Shard(0), Replicate()])
            g = h.redistribute(mesh, [Shard(0), Replicate()])
        assert h.placements == (Shard(0), Shard(1))
        assert g.to_local().shape == (4, 128)
    c = meter.collectives
    assert c["all-reduce"] == {"count": 1, "bytes": 4 * 64 * 4}
    assert c["all-gather"] == {"count": 1, "bytes": 4 * 128 * 4}
    assert c["reduce-scatter"]["count"] == c["all-to-all"]["count"] == 0
    assert meter.flops == 2 * 4 * 64 * 32 + 2 * 4 * 32 * 64


def _assert_arg_bytes(rec, cfg, shape, mesh_shape):
    """The record's per-device argument bytes are the shard arithmetic of
    its specs."""
    step, args, _ = D.build_step(cfg, shape, quantized=rec["quantized"])
    sizes = dict(zip(mesh_shape[1], mesh_shape[0]))
    specs = D.arg_shardings(cfg, shape, args, sizes, rec["fsdp"])
    want = 0

    def add(s, spec):
        nonlocal want
        want += math.prod(SH.local_shape(s.shape, spec, sizes)) \
            * s.dtype.itemsize
    D._zip(add, args, specs)
    assert rec["memory"]["argument_bytes"] == want
    assert rec["memory"]["argument_bytes_by_specs"] == want


@pytest.mark.parametrize("arch,kind,quantized", [
    ("stablelm-3b", "train", False), ("stablelm-3b", "prefill", False),
    ("stablelm-3b", "decode", False), ("stablelm-3b", "decode", True),
    ("kimi-k2-1t-a32b", "train", False), ("mamba2-780m", "prefill", False)])
def test_run_one_reduced_on_a_fake_mesh(arch, kind, quantized):
    cfg = get_config(arch).reduced()
    shape = SMALL[kind]
    rec = D.run_one(arch, shape.name, False, cfg=cfg, out_dir="",
                    quantized=quantized, mesh_shape=MESH24,
                    input_shape=shape)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_devices"] == 8 and rec["kind"] == kind
    _assert_arg_bytes(rec, cfg, shape, MESH24)
    mem = rec["memory"]
    assert mem["temp_bytes"] > 0 and mem["temp_method"] == D.TEMP_METHOD
    assert 0 < mem["alias_bytes"] <= mem["output_bytes"]
    assert rec["flops_per_device"] > 0
    assert rec["collective_bytes_total"] == sum(
        v["bytes"] for v in rec["collectives"].values())


def test_quantized_params_are_int8_with_scales():
    cfg = get_config("stablelm-3b").reduced()
    _, args, _ = D.build_step(cfg, SMALL["decode"], quantized=True)
    wq = args[0]["layers"][0]["mixer"]["wq"]
    assert wq.q.dtype == torch.int8 and wq.scale.shape == (wq.q.shape[-1],)
    assert args[0]["layers"][0]["norm1"]["scale"].dtype == torch.bfloat16


def test_flops_on_one_device_equal_flop_counter_of_plain_step():
    """On a (1, 1) mesh the meter's FLOPs are FlopCounterMode's of the same
    step on plain meta tensors."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = get_config("stablelm-3b").reduced()
    for shape in (SMALL["train"], SMALL["prefill"]):
        rec = D.run_one("stablelm-3b", shape.name, False, cfg=cfg,
                        out_dir="", mesh_shape=((1, 1), ("data", "model")),
                        input_shape=shape)
        assert rec["status"] == "ok", rec.get("traceback")
        step, args, _ = D.build_step(cfg, shape)
        plain = D._zip(lambda s, _: torch.empty(s.shape, dtype=s.dtype,
                                                device="meta"), args, args)
        if shape.kind == "train":
            from repro_torch.models.model import trainable
            trainable(plain[0])
        with FlopCounterMode(display=False) as fc:
            step(*plain)
        assert rec["flops_per_device"] == fc.get_total_flops() > 0


def test_skipped_record(tmp_path):
    rec = D.run_one("whisper-small", "long_500k", True, out_dir=str(tmp_path))
    assert rec["status"] == "skipped"
    assert rec["reason"].startswith("enc-dec decoder context")
    saved = json.loads((tmp_path / "whisper-small__long_500k__multi.json")
                       .read_text())
    assert saved == rec


def test_main_writes_files_and_skips_done(tmp_path, capsys, monkeypatch):
    argv = ["--arch", "whisper-small", "stablelm-3b", "--shape", "long_500k",
            "--mesh", "single", "--out", str(tmp_path)]
    assert D.main(argv) == 0
    out = capsys.readouterr().out
    assert "total=2 ok=1 skipped=1 error=0" in out
    rec = json.loads((tmp_path / "stablelm-3b__long_500k__single.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rec["memory"]["argument_bytes"] == \
        rec["memory"]["argument_bytes_by_specs"]
    monkeypatch.setattr(D, "run_one", lambda *a, **k: pytest.fail("re-run"))
    assert D.main(argv + ["--skip-done"]) == 0
    out = capsys.readouterr().out
    assert out.count("skip (done)") == 2
    assert "total=2 ok=1 skipped=1 error=0" in out


def test_error_is_recorded_not_raised(tmp_path):
    def broken(cfg, shape):
        raise ValueError("no step")
    rec = D.run_one("stablelm-3b", "decode_32k", False, out_dir=str(tmp_path),
                    step_override=broken, tag="broken")
    assert rec["status"] == "error" and "ValueError: no step" in rec["error"]
    assert (tmp_path / "stablelm-3b__decode_32k__single__broken.json").exists()


def test_dry_run_leaves_no_process_group():
    """Each record starts its fake world and destroys it."""
    import torch.distributed as dist
    rec = D.run_one("stablelm-3b", "decode_32k", False,
                    cfg=get_config("stablelm-3b").reduced(), out_dir="",
                    mesh_shape=MESH24, input_shape=SMALL["decode"])
    assert rec["status"] == "ok"
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="none is active"):
        TMESH.make_production_mesh(device_type="cpu")
