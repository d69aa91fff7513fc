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
  never reads (``_torch_launch_data.dropped_by_jit``); the port's record
  counts every argument.
* Bytes a device, on the same records in float32: at least 0.9 of XLA's
  bytes accessed less its layout ops (``tests/_torch_hlo.py``: the
  converts, copies, slices, transposes and concatenations an eager step
  runs as views or does not need). An unfused count cannot read less than
  a fused one but by rounding. In bfloat16 XLA on the CPU widens every
  activation to float32, which the port's step does not; there the ratios
  are printed, and the recount is held to XLA's own count.
* The committed reference records (``tests/data/launch_ref.json``, which
  the card is held to) equal the live ones.

The bounds are ``_torch_launch_data``'s (:func:`parity`), which
``chip_smoke.py``'s ``launch`` phase applies on the card.

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
import pytest
from torch.distributed.tensor import Replicate

import _torch_launch_data as LD
from repro_torch.configs import InputShape, get_config, list_configs
from repro_torch.launch import dryrun as D

MESH = (LD.MESH, ("data", "model"))
SEQ, BATCH = LD.SEQ, LD.BATCH
KINDS = LD.KINDS
ARCHS = list_configs()
RECORDS = [(a, k) for a in ARCHS for k in KINDS]


def _shape(kind):
    return InputShape(KINDS[kind], SEQ, BATCH, kind)


def _port(arch, kind, mesh):
    rec = D.run_one(arch, KINDS[kind], False, cfg=get_config(arch).reduced(),
                    out_dir="", mesh_shape=mesh, input_shape=_shape(kind))
    assert rec["status"] == "ok", rec.get("traceback")
    return rec


def _records(tmp_path_factory, section):
    """(port, reference) records of a :data:`LD.SECTIONS` section, keyed
    (arch, kind); the reference's made in subprocesses meanwhile."""
    procs = LD.spawn(tmp_path_factory.mktemp("launch_ref"),
                     float32=section == "float32")
    try:
        port = {(a, k): LD.port_record(
            {"arch": a, "shape": KINDS[k], "kind": k, "tag": ""},
            LD.SECTIONS[section]) for a, k in RECORDS}
        ref = LD.collect(procs)
    finally:
        LD.end(procs)
    ref = {(a, k): rec for (a, k, _), rec in ref.items()}
    assert set(ref) == set(port)
    for rec in port.values():
        assert rec["status"] == "ok", rec.get("traceback")
    return port, ref


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    return _records(tmp_path_factory, "reduced")


@pytest.fixture(scope="module")
def records32(tmp_path_factory):
    return _records(tmp_path_factory, "float32")


@pytest.mark.parametrize("arch,kind", RECORDS)
def test_flops_a_device_split_as_the_references(records, arch, kind):
    port, ref = records
    ratios, failed = LD.parity(port[arch, kind], ref[arch, kind])
    assert "flops" not in failed, (ratios, port[arch, kind]["fallback_ops"])


@pytest.mark.parametrize("arch,kind", RECORDS)
def test_collective_bytes_within_the_references(records, arch, kind):
    port, ref = records
    ratios, failed = LD.parity(port[arch, kind], ref[arch, kind])
    assert "collectives" not in failed, (ratios,
                                         port[arch, kind]["collectives"])


@pytest.mark.parametrize("arch,kind", RECORDS)
def test_argument_bytes_equal_the_references(records, arch, kind):
    port, ref = records
    p = port[arch, kind]
    assert p["memory"]["argument_bytes"] \
        == p["memory"]["argument_bytes_by_specs"]
    ratios, failed = LD.parity(p, ref[arch, kind])
    assert "argument_bytes" not in failed, (ratios, p["dropped_bytes"])


@pytest.mark.parametrize("arch,kind", RECORDS)
def test_committed_reference_records_are_the_live_ones(records, arch, kind):
    """``tests/data/launch_ref.json``'s reduced records (what the card is
    held to: it has no JAX) equal the reference's records made now."""
    _, ref = records
    committed = LD.keyed(LD.load()["reduced"])[arch, kind, ""]
    assert LD.same_record(committed, ref[arch, kind])


@pytest.mark.parametrize("arch,kind", RECORDS)
def test_bytes_a_device_beside_the_references(records, arch, kind):
    """bfloat16: the port's ``bytes_per_device`` beside XLA's ``bytes
    accessed`` and beside that less its layout ops (printed), and the
    reference's recount of its module by XLA's rules
    (``_torch_hlo.hlo_bytes``, what the float32 bound rests on) equal to
    XLA's own count within 1%. Unbounded here: on the CPU XLA runs the
    bfloat16 step in float32, every activation twice as wide as the
    port's, and copies each period's slice of a stacked weight (decode
    0.27–0.60 of XLA's count, ``test_torch_launch_dryrun.py::test_xla_*``)."""
    port, ref = records
    p, r = port[arch, kind], ref[arch, kind]
    assert p["bytes_method"] == D.BYTES_METHOD
    ratios, _ = LD.parity(p, r)
    print(f"{arch} {kind}: bytes a device {p['bytes_per_device']:.6g} / "
          f"{r['bytes_per_device']:.6g} = {ratios['bytes_over']:.3f}; "
          f"less layout {ratios['bytes_over_less_layout']:.3f}")
    recount = r["bytes_recounted_per_device"] / r["bytes_per_device"]
    assert abs(recount - 1) <= LD.RECOUNT_TOL, recount


@pytest.mark.parametrize("arch,kind", RECORDS)
def test_float32_bytes_a_device_at_least_the_references(records32, arch,
                                                         kind):
    """float32 parameters and cache in both packages: the port's bytes a
    device at least 0.9 of XLA's bytes accessed less its layout ops
    (printed, with the raw ratio): the port counts every op the reference
    runs. Its recount equals XLA's count within 1%."""
    port, ref = records32
    p, r = port[arch, kind], ref[arch, kind]
    ratios, failed = LD.parity(p, r, bytes_gated=True)
    print(f"{arch} {kind} float32: bytes a device {p['bytes_per_device']:.6g}"
          f" / {r['bytes_less_layout_per_device']:.6g} (less layout) = "
          f"{ratios['bytes_over_less_layout']:.3f}; raw "
          f"{ratios['bytes_over']:.3f}")
    assert "bytes" not in failed, ratios
    recount = r["bytes_recounted_per_device"] / r["bytes_per_device"]
    assert abs(recount - 1) <= LD.RECOUNT_TOL, recount


@pytest.mark.parametrize("arch,kind", RECORDS)
def test_float32_records_within_the_parity_bounds(records32, arch, kind):
    """The float32 records, which the card's gate also holds, within the
    FLOPs, collective and argument bounds of the bfloat16 ones."""
    port, ref = records32
    ratios, failed = LD.parity(port[arch, kind], ref[arch, kind])
    assert not failed, (failed, ratios)


@pytest.mark.parametrize("arch,kind", RECORDS)
def test_committed_float32_records_are_the_live_ones(records32, arch, kind):
    _, ref = records32
    committed = LD.keyed(LD.load()["float32"])[arch, kind, ""]
    assert LD.same_record(committed, ref[arch, kind])


def test_committed_sections_state_their_setting():
    """Each section of the file states the setting the tests and the card
    run it with."""
    data = LD.load()
    for name, setting in LD.SECTIONS.items():
        assert {k: v for k, v in data[name].items() if k != "records"} \
            == setting, name


@pytest.mark.parametrize("arch", [a for a, what in LD.FULL_GATE.items()
                                  if what == "flops"])
def test_full_records_split_only_attention_by_the_whole_batch(arch):
    """The full-size records' dots with a dimension of the global batch,
    which the card's gate splits over the data ranks, are the reference's
    attention score and value products, and nothing else."""
    rec = next(r for r in LD.load()["full"]["records"] if r["arch"] == arch)
    dots = rec["whole_batch_dots"]
    assert dots and rec["dot_flops_whole_batch_per_device"] > 0
    assert all(LD.attention_dot(d, rec) for d in dots), dots


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
