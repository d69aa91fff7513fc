"""Graph IR, paper models and post-training quantization: the port against
the JAX package, tensor for tensor."""
import io
import os
import pathlib

import msgpack
import numpy as np
import pytest

from repro.configs import paper_models as JM
from repro.core import graph as JG
from repro.core.quantize import quantize_graph as j_quantize
from repro_torch.configs import paper_models as TM
from repro_torch.core import graph as TG
from repro_torch.core.quantize import quantize_graph as t_quantize

from _torch_parity import carry

MODELS = {"sine": (1, 1), "speech": (1, 49, 40, 1), "person": (1, 96, 96, 1)}


def _assert_same_structure(pg, jg):
    assert pg.name == jg.name
    assert pg.inputs == jg.inputs and pg.outputs == jg.outputs
    assert len(pg.ops) == len(jg.ops)
    for po, jo in zip(pg.ops, jg.ops):
        assert (po.op, po.inputs, po.outputs) == (jo.op, jo.inputs, jo.outputs)
        assert po.attrs == jo.attrs
    assert len(pg.tensors) == len(jg.tensors)
    for pt, jt in zip(pg.tensors, jg.tensors):
        assert (pt.name, pt.shape, pt.dtype) == (jt.name, jt.shape, jt.dtype)
        assert (pt.data is None) == (jt.data is None)
        assert (pt.qparams is None) == (jt.qparams is None)


def _assert_same_graph(pg, jg):
    _assert_same_structure(pg, jg)
    for pt, jt in zip(pg.tensors, jg.tensors):
        if jt.data is not None:
            assert pt.data.dtype == jt.data.dtype
            np.testing.assert_array_equal(pt.data, jt.data)
        if jt.qparams is not None:
            np.testing.assert_array_equal(pt.qparams.scale, jt.qparams.scale)
            np.testing.assert_array_equal(pt.qparams.zero_point,
                                          jt.qparams.zero_point)
            assert pt.qparams.axis == jt.qparams.axis


@pytest.mark.parametrize("name", sorted(MODELS))
def test_paper_models_match(name):
    """Same seeds, same float weights, same topology and attributes."""
    _assert_same_graph(TM.PAPER_MODELS[name](), JM.PAPER_MODELS[name]())


@pytest.mark.parametrize("name", ["sine", "speech"])
def test_graph_from_doc_reads_jax_saved_graph(name, tmp_path):
    rng = np.random.default_rng(3)
    shape = MODELS[name]
    jq = j_quantize(JM.PAPER_MODELS[name](),
                    [rng.normal(0, 1, shape).astype("f") for _ in range(2)])
    _assert_same_graph(carry(jq, tmp_path), jq)
    with open(tmp_path / "g.msgpack", "rb") as f:
        doc = msgpack.unpackb(f.read(), raw=False, strict_map_key=False)
    pg = TG.graph_from_doc(doc)
    _assert_same_graph(pg, jq)
    # attributes come back as the tuples the builder wrote
    assert all(not isinstance(v, list) for o in pg.ops for v in o.attrs.values())


@pytest.mark.parametrize("name", ["sine", "speech"])
def test_graph_to_doc_is_what_the_jax_package_saves(name, tmp_path):
    """``graph_to_doc`` makes the document ``repro.core.graph.save`` packs,
    byte for byte once packed, and ``graph_from_doc`` reads it back."""
    rng = np.random.default_rng(4)
    jq = j_quantize(JM.PAPER_MODELS[name](),
                    [rng.normal(0, 1, MODELS[name]).astype("f")
                     for _ in range(2)])
    pg = carry(jq, tmp_path)
    doc = TG.graph_to_doc(pg)
    assert msgpack.packb(doc, use_bin_type=True) == \
        (tmp_path / "g.msgpack").read_bytes()
    _assert_same_graph(TG.graph_from_doc(doc), jq)


def test_graph_from_doc_rejects_a_broken_graph(tmp_path):
    jg = JM.build_sine()
    JG.save(jg, str(tmp_path / "g.msgpack"))
    with open(tmp_path / "g.msgpack", "rb") as f:
        doc = msgpack.unpackb(f.read(), raw=False, strict_map_key=False)
    doc["outputs"] = [len(doc["tensors"]) + 5]
    with pytest.raises(ValueError):
        TG.graph_from_doc(doc)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_quantize_graph_matches_reference(name):
    """Weights are quantized from the same float data: equal. Activation
    ranges come from the float graph, whose convolutions sum in another
    order in torch than in XLA, so a range can differ in the last ulp:
    scales agree within rtol 1e-5, zero points (a rounding of -rmin/scale)
    within 1, and a bias (a rounding of b / (s_x * s_w)) equals the
    reference wherever its input scale is bitwise equal, else within 1."""
    rng = np.random.default_rng(4)
    shape = MODELS[name]
    reps = [rng.normal(0, 1, shape).astype("f") for _ in range(2)]
    jq = j_quantize(JM.PAPER_MODELS[name](), reps)
    pq = t_quantize(TM.PAPER_MODELS[name](), reps, device="cpu")
    _assert_same_structure(pq, jq)
    const_role = {}
    for op in jq.ops:
        if len(op.inputs) > 1:
            const_role[op.inputs[1]] = ("w", op)
        if len(op.inputs) > 2:
            const_role[op.inputs[2]] = ("b", op)
    for tid, (pt, jt) in enumerate(zip(pq.tensors, jq.tensors)):
        if jt.data is None:
            np.testing.assert_allclose(pt.qparams.scale, jt.qparams.scale,
                                       rtol=1e-5)
            d = np.abs(pt.qparams.zero_point.astype(np.int64)
                       - jt.qparams.zero_point)
            assert d.max() <= 1, (tid, pt.name)
            continue
        role, op = const_role[tid]
        if role == "w":
            np.testing.assert_array_equal(pt.data, jt.data)
            np.testing.assert_array_equal(pt.qparams.scale, jt.qparams.scale)
        else:
            same_sx = np.array_equal(pq.tensor(op.inputs[0]).qparams.scale,
                                     jq.tensor(op.inputs[0]).qparams.scale)
            d = np.abs(pt.data.astype(np.int64) - jt.data)
            assert d.max() <= (0 if same_sx else 1), (tid, pt.name)


# -- graph files and the msgpack subset -------------------------------------------

def _graphs(name, quantized, tmp_path):
    """The same float (or quantized) paper model from each package: the
    quantized one is the JAX package's, carried across by its file."""
    jg = JM.PAPER_MODELS[name]()
    if not quantized:
        return jg, TM.PAPER_MODELS[name]()
    rng = np.random.default_rng(5)
    jg = j_quantize(jg, [rng.normal(0, 1, MODELS[name]).astype("f")
                         for _ in range(2)])
    return jg, carry(jg, tmp_path, "carried.mfg")


GRAPHS = [(n, q) for n in sorted(MODELS) for q in (False, True)]
GRAPH_IDS = [f"{n}-{'int8' if q else 'float'}" for n, q in GRAPHS]


@pytest.mark.parametrize("name,quantized", GRAPHS, ids=GRAPH_IDS)
def test_save_writes_the_jax_packages_bytes(name, quantized, tmp_path):
    """The port's ``save`` and ``repro.core.graph.save`` write the same
    file for the same graph, and each package loads the other's file into
    an equal graph."""
    jg, pg = _graphs(name, quantized, tmp_path)
    JG.save(jg, str(tmp_path / "j.mfg"))
    TG.save(pg, str(tmp_path / "p.mfg"))
    assert (tmp_path / "p.mfg").read_bytes() == \
        (tmp_path / "j.mfg").read_bytes()
    _assert_same_graph(TG.load(str(tmp_path / "j.mfg")), jg)
    _assert_same_graph(pg, JG.load(str(tmp_path / "p.mfg")))


@pytest.mark.parametrize("name,quantized", GRAPHS, ids=GRAPH_IDS)
def test_load_and_save_without_msgpack(name, quantized, tmp_path):
    """In a process where ``import msgpack`` fails (as on the card's
    machine), the port reads the JAX package's file and writes it back
    byte for byte, and never imports msgpack."""
    import subprocess
    import sys
    jg, _ = _graphs(name, quantized, tmp_path)
    JG.save(jg, str(tmp_path / "j.mfg"))
    code = (
        "import sys\n"
        "sys.modules['msgpack'] = None\n"
        "from repro_torch.core import graph as G\n"
        f"g = G.load({str(tmp_path / 'j.mfg')!r})\n"
        f"G.save(g, {str(tmp_path / 'p.mfg')!r})\n"
        "print(len(g.ops), sys.modules['msgpack'])\n")
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == [str(len(jg.ops)), "None"]
    assert (tmp_path / "p.mfg").read_bytes() == \
        (tmp_path / "j.mfg").read_bytes()


def test_committed_sine_file_is_what_the_jax_package_writes(tmp_path):
    """``tests/data/sine_int8.mfg`` (read by ``chip_smoke.py`` on the card)
    is ``repro.core.graph.save`` of the quantized sine: ``build_sine()``
    calibrated on 16 draws of U(0, 2π) from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    reps = [rng.uniform(0, 2 * np.pi, (1, 1)).astype("f") for _ in range(16)]
    JG.save(j_quantize(JM.build_sine(), reps), str(tmp_path / "j.mfg"))
    committed = pathlib.Path(__file__).parent / "data" / "sine_int8.mfg"
    assert committed.read_bytes() == (tmp_path / "j.mfg").read_bytes()
    _assert_same_graph(TG.load(str(committed)),
                       JG.load(str(tmp_path / "j.mfg")))


_CODEC_VALUES = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1,
    2**32, 2**64 - 1, -1, -32, -33, -128, -129, -2**15, -2**15 - 1,
    -2**31, -2**31 - 1, -2**63, 0.0, -0.0, 1.5, -2.75e-3, 1e300,
    float("inf"), "", "k" * 31, "k" * 32, "k" * 255, "k" * 256,
    "k" * 65535, "k" * 65536, "é✓", b"", b"\0" * 255, b"\0" * 256,
    b"\1" * 65535, b"\1" * 65536, [], [0] * 15, [0] * 16, [None] * 65535,
    [1] * 65536, (1, (2, 3)), {}, {str(i): i for i in range(15)},
    {str(i): i for i in range(16)}, {str(i): None for i in range(65536)},
    {"scale": [0.0235, 1e-7], "zero_point": [-128, 3], "axis": None},
]


@pytest.mark.parametrize("value", _CODEC_VALUES,
                         ids=lambda v: f"{type(v).__name__}"
                         f"{len(v) if hasattr(v, '__len__') else repr(v)}")
def test_packb_matches_msgpack_and_round_trips(value):
    """The subset packs every kind and length class as
    ``msgpack.packb(use_bin_type=True)`` does, and reads back the value."""
    from repro_torch.core import packb as P
    want = msgpack.packb(value, use_bin_type=True)
    assert P.packb(value) == want
    expect = msgpack.unpackb(want, raw=False, strict_map_key=False)
    f = io.BytesIO(want)
    assert P.Reader(f).value() == expect
    assert f.tell() == len(want)


def test_reader_reads_float32_and_rejects_other_types():
    from repro_torch.core import packb as P

    def read(b):
        return P.Reader(io.BytesIO(b)).value()
    assert read(msgpack.packb([1.5, -0.25], use_single_float=True)) \
        == [1.5, -0.25]
    with pytest.raises(ValueError, match="outside the subset"):
        read(msgpack.packb(msgpack.ExtType(1, b"x")))
    with pytest.raises(ValueError, match="truncated"):
        read(msgpack.packb("abc")[:-1])
    with pytest.raises(TypeError):
        P.packb(np.int64(3))
