"""Graph IR, paper models and post-training quantization: the port against
the JAX package, tensor for tensor."""
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
