"""Compile-time folding and the padded layout plan: the port's
``plan_layout(quantum=128)`` equals the JAX package's ``LayoutPlan`` field
for field and array for array, and the planned kernel wrappers equal the
JAX package's (Pallas, interpret mode) bit for bit, with every padding lane
zero. Graphs are quantized once, in JAX, and carried across."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import paper_models as JM
from repro.core import preprocess as JP
from repro.core.quantize import quantize_graph as j_quantize
from repro.kernels import ops as jops
from repro_torch.core import preprocess as TP
from repro_torch.kernels import ops as tops

from _torch_parity import assert_i8_equal, carry, person_like, t

SHAPES = {"sine": (1, 1), "speech": (1, 49, 40, 1), "person": (1, 96, 96, 1)}


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """name -> (JAX quantized graph, the same graph in the port)."""
    out = {}
    tmp = tmp_path_factory.mktemp("graphs")
    for name, shape in SHAPES.items():
        rng = np.random.default_rng(5)
        jq = j_quantize(JM.PAPER_MODELS[name](),
                        [rng.normal(0, 1, shape).astype("f")])
        out[name] = (jq, carry(jq, tmp, f"{name}.msgpack"))
    rng = np.random.default_rng(6)
    jq = j_quantize(person_like(rng), [rng.normal(0, 1, (1, 24, 24, 1))
                                       .astype("f") for _ in range(2)])
    out["person_like"] = (jq, carry(jq, tmp, "person_like.msgpack"))
    return out


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_folded_consts_match(graphs, name):
    jq, tq = graphs[name]
    jf, tf = JP.preprocess_graph(jq), TP.preprocess_graph(tq)
    assert sorted(jf) == sorted(tf)
    for i in jf:
        for field in ("bias_term", "rescale", "w_sum_zx", "const_off", "z_w",
                      "z_y", "s_y", "z_x"):
            a, b = np.asarray(getattr(tf[i], field)), np.asarray(getattr(jf[i], field))
            assert a.dtype == b.dtype, (i, field)
            np.testing.assert_array_equal(a, b, err_msg=f"op {i} {field}")


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plan_layout_matches_reference(graphs, name):
    jq, tq = graphs[name]
    jplan = JP.plan_layout(jq, JP.preprocess_graph(jq))
    tplan = TP.plan_layout(tq, TP.preprocess_graph(tq), quantum=128)
    assert tplan.phys == jplan.phys
    assert tplan.entry_phys == jplan.entry_phys
    assert sorted(tplan.layouts) == sorted(jplan.layouts)
    for i, jl in jplan.layouts.items():
        tl = tplan.layouts[i]
        for field in ("kind", "lo", "hi", "n_true", "in_lanes", "out_shape",
                      "c_true", "z_x"):
            assert getattr(tl, field) == getattr(jl, field), (i, field)
        assert tl.w_phys.dtype == jl.w_phys.dtype
        np.testing.assert_array_equal(tl.w_phys, jl.w_phys)
        assert len(tl.consts) == len(jl.consts) == 5
        for a, b in zip(tl.consts, jl.consts):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    if name == "person":  # conv0 + 13 dw + 13 pw + FC: the whole path
        assert len(tplan.layouts) == 28


def _planned_input(rng, lay, shape):
    """A physical-layout activation as an upstream planned op leaves it:
    lanes >= the logical input width (``c_true``) are zero."""
    x = rng.integers(-128, 128, shape).astype(np.int8)
    x[..., lay.c_true:] = 0
    return x


@pytest.mark.parametrize("batch", [1, 3])
def test_planned_wrappers_match_reference(graphs, batch):
    """Every planned op of the person-shaped graph, fed a lane-padded input,
    through the JAX wrapper (Pallas interpret) and the port's (plain
    versions on the CPU): equal, and zero on every padding lane."""
    jq, tq = graphs["person_like"]
    jplan = JP.plan_layout(jq, JP.preprocess_graph(jq))
    tplan = TP.plan_layout(tq, TP.preprocess_graph(tq))
    rng = np.random.default_rng(batch)
    for i, jl in jplan.layouts.items():
        op = jq.ops[i]
        tl = tplan.layouts[i]
        xt = jq.tensor(op.inputs[0])
        if jl.kind == "fc":
            x = _planned_input(rng, jl, (batch, xt.shape[0], jl.in_lanes))
            want = jops.qmatmul_planned_batched(jnp.asarray(x), jl)
            got = tops.qmatmul_planned_batched(t(x), tl)
            if batch == 1:  # the per-call form at the physical row count
                xs = np.zeros(jl.out_shape[:1] + (jl.in_lanes,), np.int8)
                xs[:xt.shape[0]] = x[0]
                assert_i8_equal(tops.qmatmul_planned(t(xs), tl),
                                jops.qmatmul_planned(jnp.asarray(xs), jl))
        else:
            shape = (batch,) + tuple(xt.shape[1:3]) + (jl.in_lanes,)
            x = _planned_input(rng, jl, shape)
            geo = dict(stride=tuple(op.attrs["stride"]),
                       padding=op.attrs["padding"])
            if jl.kind == "conv":
                kh, kw = jq.tensor(op.inputs[1]).shape[:2]
                want = jops.qconv_planned(jnp.asarray(x), jl, kh=kh, kw=kw, **geo)
                got = tops.qconv_planned(t(x), tl, kh=kh, kw=kw, **geo)
            else:
                want = jops.qdwconv_planned(jnp.asarray(x), jl, **geo)
                got = tops.qdwconv_planned(t(x), tl, **geo)
        assert_i8_equal(got, want)
        assert not got[..., jl.n_true:].any(), f"op {i}: padding lanes not zero"


def test_pad_border_planned_matches_reference():
    rng = np.random.default_rng(9)
    x = rng.integers(-128, 128, (2, 5, 6, 128)).astype(np.int8)
    x[..., 3:] = 0
    for stride, z_x in [((1, 1), -7), ((2, 2), 5), ((2, 2), 0)]:
        want = jops._pad_border_planned(jnp.asarray(x), 3, 3, stride, "SAME",
                                        z_x, 3)
        got = tops._pad_border_planned(t(x), 3, 3, stride, "SAME", z_x, 3)
        assert_i8_equal(got, want)
        assert not got[..., 3:].any()


@pytest.mark.parametrize("name", sorted(SHAPES) + ["person_like"])
def test_plan_layout_quantum32_keeps_logical_slices(graphs, name):
    """The engine's plan, at the qmatmul kernel's quantum of 32 lanes: the
    same ops planned with the same bounds and logical widths as the
    quantum-128 plan (itself the reference's), every logical slice of the
    weights and constants equal to that plan's, every padding lane zero,
    and the kernel's transposed weight equal to ``w_phys.T``."""
    from repro_torch.kernels.qmatmul import QUANTUM
    _, tq = graphs[name]
    folded = TP.preprocess_graph(tq)
    p128 = TP.plan_layout(tq, folded, quantum=128)
    p32 = TP.plan_layout(tq, folded, quantum=QUANTUM)
    assert QUANTUM == 32 and sorted(p32.layouts) == sorted(p128.layouts)
    for i, a in p32.layouts.items():
        b = p128.layouts[i]
        for field in ("kind", "lo", "hi", "n_true", "c_true", "z_x"):
            assert getattr(a, field) == getattr(b, field), (i, field)
        n, c = a.n_true, a.c_true
        assert a.in_lanes % QUANTUM == 0 and a.out_shape[-1] % QUANTUM == 0
        assert c <= a.in_lanes <= b.in_lanes and a.out_shape[-1] >= n
        assert a.out_shape[:-1] == b.out_shape[:-1] or a.kind == "fc"
        for ca, cb in zip(a.consts, b.consts):
            np.testing.assert_array_equal(ca[:n], cb[:n])
            assert not ca[n:].any(), f"op {i}: constant padding not zero"
        if a.kind == "dwconv":
            assert a.w_nk is None
            np.testing.assert_array_equal(a.w_phys[..., :n], b.w_phys[..., :n])
            assert not a.w_phys[..., n:].any()
            continue
        if a.kind == "fc":
            assert a.out_shape[0] == \
                -(-tq.tensor(tq.ops[i].inputs[0]).shape[0] // QUANTUM) * QUANTUM
            wa, wb = a.w_phys, b.w_phys
        else:  # conv: (kh*kw*Cin', N') -> (kh, kw, Cin', N')
            kh, kw = tq.tensor(tq.ops[i].inputs[1]).shape[:2]
            wa = a.w_phys.reshape(kh, kw, a.in_lanes, -1)
            wb = b.w_phys.reshape(kh, kw, b.in_lanes, -1)
        np.testing.assert_array_equal(wa[..., :c, :n], wb[..., :c, :n])
        assert not wa[..., c:, :].any() and not wa[..., n:].any()
        assert a.w_nk.flags.c_contiguous
        np.testing.assert_array_equal(a.w_nk, a.w_phys.T)
