"""The paged route (Sec. 4.3) of the port against the JAX package's, on the
CPU: the paged kernel's plain version against the Pallas ``paged_qmatmul``
(``interpret=True``), the plain page loop against ``core.paging``, the
layout plan with a paging map, and ``CompiledModel(paged=...)`` against the
JAX engine on the graphs of ``tests/test_paged_quantized.py`` and on the
three paper models. Every comparison is bit-exact int8 except softmax
outputs (±1 LSB: ``exp`` differs in the last ulp between torch and XLA).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_models as JM
from repro.core import CompiledModel as JCompiled
from repro.core import preprocess as JP
from repro.core.builder import GraphBuilder
from repro.core.ops_ref import FoldedConsts as JFolded
from repro.core.paging import paged_fc_folded as j_paged_fc
from repro.core.quantize import quantize_graph as j_quantize
from repro.kernels import ops as jops
from repro.kernels.paged_matmul import paged_qmatmul as j_paged_qmatmul
from repro_torch.core import preprocess as TP
from repro_torch.core.engine import CompiledModel
from repro_torch.core.ops_ref import FoldedConsts as TFolded
from repro_torch.core.ops_ref import clamp_bounds, fused_bounds_f32
from repro_torch.core.paging import paged_fc_folded as t_paged_fc
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_matmul as pm_mod
from repro_torch.kernels import ref

from _torch_parity import assert_i8_equal, assert_softmax_close, carry, t

FUSED = ["NONE", "RELU", "RELU6"]

#: The paged maps the paper models run with: one output unit per page on
#: sine and speech, the 256 -> 2 FC in two pages on person.
PAPER_PAGED = {"sine": {0: 16, 1: 16}, "speech": {2: 4}, "person": {29: 2}}
SHAPES = {"sine": (1, 1), "speech": (1, 49, 40, 1), "person": (1, 96, 96, 1)}


def _i8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


def _consts(rng, n, z_w):
    return (
        (rng.normal(size=n) * 5).astype(np.float32),
        (rng.random(n) * 0.02 + 1e-4).astype(np.float32),
        rng.integers(-5000, 5000, n).astype(np.int32),
        rng.integers(-100, 100, n).astype(np.int32),
        np.full(n, z_w, np.int32),
    )


def _folded(consts, z_y=3, s_y=0.03):
    return dict(bias_term=consts[0], rescale=consts[1], w_sum_zx=consts[2],
                const_off=consts[3], z_w=consts[4],
                z_y=np.asarray(z_y, np.int32), s_y=np.asarray(s_y, np.float32),
                z_x=np.asarray(0, np.int32))


# ---------------------------------------------------------------------------
# the kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,page", [(4, 16, 256, 128), (2, 64, 512, 128),
                                        (8, 32, 128, 128)])
@pytest.mark.parametrize("fused", FUSED)
def test_paged_qmatmul_ref_matches_pallas(m, k, n, page, fused):
    rng = np.random.default_rng(n + page)
    x, w = _i8(rng, (m, k)), _i8(rng, (k, n))
    c = _consts(rng, n, -2)
    lo, hi = clamp_bounds(TFolded(**_folded(c)), fused)
    want = j_paged_qmatmul(jnp.asarray(x), jnp.asarray(w),
                           *(jnp.asarray(v) for v in c), page=page, lo=lo,
                           hi=hi, interpret=True)
    got = ref.paged_qmatmul_ref(t(x), t(w), *(t(v) for v in c), page=page,
                                lo=lo, hi=hi)
    assert_i8_equal(got, want)
    before = pm_mod.launches
    assert_i8_equal(pm_mod.paged_qmatmul(t(x), t(w), *(t(v) for v in c),
                                         page=page, lo=lo, hi=hi), want)
    assert pm_mod.launches == before  # CPU tensors: the plain version


@pytest.mark.parametrize("m,k,n,page", [(4, 16, 256, 128), (2, 64, 512, 128),
                                        (8, 32, 128, 128)])
def test_qmatmul_folded_paged_matches_reference(m, k, n, page):
    """The shapes of the reference's ``test_paged_matmul_matches_ref``."""
    rng = np.random.default_rng(n + page)
    x, w = _i8(rng, (m, k)), _i8(rng, (k, n))
    fc = _folded(_consts(rng, n, -2))
    want = jops.qmatmul_folded(jnp.asarray(x), jnp.asarray(w), JFolded(**fc),
                               "NONE", paged=True, page=page)
    assert_i8_equal(tops.qmatmul_folded(t(x), t(w), TFolded(**fc), "NONE",
                                        paged=True, page=page), want)


def test_paged_equals_unpaged_kernel():
    """The reference's ``test_paged_equals_unpaged_kernel``: (7, 45, 300),
    RELU, the default page of 128 lanes."""
    rng = np.random.default_rng(42)
    x, w = _i8(rng, (7, 45)), _i8(rng, (45, 300))
    fc = _folded(_consts(rng, 300, 0))
    a = tops.qmatmul_folded(t(x), t(w), TFolded(**fc), "RELU")
    b = tops.qmatmul_folded(t(x), t(w), TFolded(**fc), "RELU", paged=True)
    assert_i8_equal(b, a)
    assert_i8_equal(b, jops.qmatmul_folded(jnp.asarray(x), jnp.asarray(w),
                                           JFolded(**fc), "RELU", paged=True))


@pytest.mark.parametrize("bad", ["page_not_dividing", "x_dtype", "const_shape",
                                 "page_zero", "k_mismatch", "w_dtype"])
def test_paged_qmatmul_wrapper_rejects(bad):
    rng = np.random.default_rng(3)
    x, w = t(_i8(rng, (3, 10))), t(_i8(rng, (10, 12)))
    c = [t(v) for v in _consts(rng, 12, 1)]
    page = {"page_not_dividing": 5, "page_zero": 0}.get(bad, 4)
    if bad == "x_dtype":
        x = x.to(torch.int32)
    elif bad == "const_shape":
        c[1] = c[1][:4]
    elif bad == "k_mismatch":
        w = w[:8].contiguous()
    elif bad == "w_dtype":
        w = w.to(torch.int16)
    with pytest.raises((ValueError, TypeError)):
        pm_mod.paged_qmatmul(x, w, *c, page=page)


#: (M, K, N, page) of the paged route: sine, speech and person at one unit
#: a page, the 256 x 256 FC at its three page sizes, at M = 1, 4 and 8.
PAGED_SHAPES = [(m, k, n, p) for m in (1, 4, 8) for k, n, p in [
    (1, 16, 1), (16, 16, 1), (4000, 4, 1), (256, 2, 1), (256, 256, 128),
    (256, 256, 32), (256, 256, 8)]]


@pytest.mark.parametrize("m,k,n,page", PAGED_SHAPES)
def test_paged_split(m, k, n, page):
    """``paged_split`` on the paged shapes: a slice of at most 16 units of
    one page (16 blocks or more for the 256-wide FC, whatever its page),
    all of K in one stage of whole 16-byte pieces within the shared-memory
    budget, and W read as the contiguous rows of a narrow matrix (N up to
    the 32 bytes of one row's segments) or as each row's segments."""
    sc, kc, flat = pm_mod.paged_split(k, n, page)
    assert sc == min(page, pm_mod.SLICE) and page % sc == 0
    assert kc % 16 == 0 and k <= kc < k + 16
    assert flat == (n <= 32)
    assert pm_mod.paged_smem(n, sc, kc, flat) <= pm_mod.SMEM_BYTES
    blocks = pm_mod.paged_blocks(m, n, page, sc)
    assert blocks == (n // page) * (page // sc) * -(-m // pm_mod.BM)
    if n == 256:
        assert blocks >= 16


@pytest.mark.parametrize("k,n,page", [(100000, 4, 1), (4000, 1024, 1024),
                                      (45, 300, 150)])
def test_paged_split_chunks_long_k(k, n, page):
    """Where all of K does not fit the budget, K is staged in chunks of a
    multiple of 16 bytes that do; a ragged page keeps a ragged last slice."""
    sc, kc, flat = pm_mod.paged_split(k, n, page)
    assert kc % 16 == 0 and 16 <= kc
    assert pm_mod.paged_smem(n, sc, kc, flat) <= pm_mod.SMEM_BYTES
    assert kc < k or kc == -(-k // 16) * 16
    assert pm_mod.paged_blocks(1, n, page, sc) == (n // page) * -(-page // sc)


# ---------------------------------------------------------------------------
# the plain page loop against core.paging
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_pages", [2, 4, 8, 16])
@pytest.mark.parametrize("fused", FUSED)
def test_paged_fc_folded_matches_reference(n_pages, fused):
    rng = np.random.default_rng(n_pages)
    x, w = _i8(rng, (5, 24)), _i8(rng, (24, 32))
    fc = _folded(_consts(rng, 32, 2), z_y=-7, s_y=0.021)
    want = j_paged_fc(jnp.asarray(x), jnp.asarray(w), JFolded(**fc), n_pages,
                      fused)
    assert_i8_equal(t_paged_fc(t(x), t(w), TFolded(**fc), n_pages, fused),
                    want)
    # the kernel route's entry point, with the plain route's float32 bounds,
    # clamps exactly where the reference's paged route does
    lo, hi = fused_bounds_f32(TFolded(**fc), fused)
    assert_i8_equal(tops.paged_fc(t(x), t(w), TFolded(**fc), n_pages, lo, hi),
                    want)


def test_paged_fc_folded_rejects_uneven_pages():
    rng = np.random.default_rng(0)
    fc = TFolded(**_folded(_consts(rng, 32, 0)))
    with pytest.raises(AssertionError):
        t_paged_fc(t(_i8(rng, (2, 8))), t(_i8(rng, (8, 32))), fc, 5)


# ---------------------------------------------------------------------------
# the layout plan leaves paged ops unplanned
# ---------------------------------------------------------------------------

def _mlp(rng, m=2, dims=(8, 16, 4)):
    b = GraphBuilder("mlp")
    x = b.input("x", (m, dims[0]))
    h = x
    for i in range(len(dims) - 1):
        h = b.fully_connected(
            h, rng.normal(0, 0.5, (dims[i], dims[i + 1])).astype("f"),
            rng.normal(0, 0.5, dims[i + 1]).astype("f"),
            fused="RELU" if i < len(dims) - 2 else "NONE", name=f"fc{i}")
    b.output(b.softmax(h))
    return b.build()


def test_plan_layout_skips_paged_ops(tmp_path):
    """The reference's ``test_mixed_boundaries_pallas_paged_batched``: a
    paged FC between planned ones is unplanned, and the plans agree."""
    rng = np.random.default_rng(5)
    jq = j_quantize(_mlp(rng), [rng.normal(size=(2, 8)).astype("f")
                                for _ in range(4)])
    tq = carry(jq, tmp_path)
    jplan = JP.plan_layout(jq, JP.preprocess_graph(jq), {1: 4})
    tplan = TP.plan_layout(tq, TP.preprocess_graph(tq), paged={1: 4})
    assert sorted(tplan.layouts) == sorted(jplan.layouts) == [0]
    assert tplan.phys == jplan.phys
    assert tplan.entry_phys == jplan.entry_phys
    x = jq.tensor(jq.inputs[0]).qparams.quantize(
        rng.normal(size=(5, 2, 8)).astype("f"))
    want = np.asarray(JCompiled(jq, use_pallas=True, paged={1: 4})
                      .predict_q(x))
    mixed = CompiledModel(tq, device="cpu", paged={1: 4})
    assert sorted(mixed.plan.layouts) == [0]
    assert_softmax_close(mixed.predict_q(x), want)


# ---------------------------------------------------------------------------
# CompiledModel(paged=...) against the JAX engine
# ---------------------------------------------------------------------------

def _fc_graph(n_in=24, n_out=32, batch=3, fused="RELU", seed=0):
    """``tests/test_paged_quantized.py::_fc_graph``."""
    rng = np.random.default_rng(seed)
    b = GraphBuilder("paged_fc_test")
    x = b.input("x", (batch, n_in))
    y = b.fully_connected(x, rng.normal(0, 0.3, (n_in, n_out)).astype("f"),
                          rng.normal(size=n_out).astype("f"), fused=fused)
    b.output(y)
    qg = j_quantize(b.build(),
                    [rng.normal(size=(batch, n_in)).astype("f")
                     for _ in range(4)])
    qx = np.asarray(qg.tensor(qg.inputs[0]).qparams.quantize(
        rng.normal(size=(batch, n_in)).astype("f")))
    return qg, qx


@pytest.mark.parametrize("n_pages", [1, 2, 8, 32])
@pytest.mark.parametrize("fused", ["NONE", "RELU"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_paged_fc_single_layer_matches_reference(tmp_path, n_pages, fused,
                                                 use_kernels):
    jq, qx = _fc_graph(fused=fused)
    tq = carry(jq, tmp_path)
    want = np.asarray(JCompiled(jq, paged={0: n_pages}).predict_q(qx))
    got = CompiledModel(tq, use_kernels=use_kernels, device="cpu",
                        paged={0: n_pages}).predict_q(qx)
    assert_i8_equal(got, want)
    unpaged = CompiledModel(tq, use_kernels=use_kernels, device="cpu")
    assert_i8_equal(unpaged.predict_q(qx), got)


def test_paged_fc_batched_buckets_match_reference(tmp_path):
    jq, _ = _fc_graph(batch=1)
    tq = carry(jq, tmp_path)
    xs = np.asarray(jq.tensor(jq.inputs[0]).qparams.quantize(
        np.random.default_rng(4).normal(size=(5, 1, 24)).astype("f")))
    want = np.asarray(JCompiled(jq, paged={0: 8}).predict_q(xs))
    for use_kernels in (True, False):
        got = CompiledModel(tq, use_kernels=use_kernels, device="cpu",
                            paged={0: 8}).predict_q(xs)
        assert_i8_equal(got, want)


def test_paged_fc_invalid_page_count_rejected(tmp_path):
    jq, qx = _fc_graph(n_out=32)
    tq = carry(jq, tmp_path)
    for use_kernels in (True, False):
        cm = CompiledModel(tq, use_kernels=use_kernels, device="cpu",
                           paged={0: 5})
        with pytest.raises(AssertionError):
            cm.predict_q(qx)  # 32 output units cannot split into 5 pages


@pytest.fixture(scope="module")
def paper(tmp_path_factory):
    """name -> (JAX quantized graph, the port's copy, 8 quantized inputs)."""
    out = {}
    tmp = tmp_path_factory.mktemp("paper")
    for name, shape in SHAPES.items():
        rng = np.random.default_rng(11)
        jq = j_quantize(JM.PAPER_MODELS[name](),
                        [rng.normal(0, 1, shape).astype("f") for _ in range(2)])
        xs = np.stack([jq.tensor(jq.inputs[0]).qparams.quantize(
            rng.normal(0, 1, shape).astype("f")) for _ in range(8)])
        out[name] = (jq, carry(jq, tmp, f"{name}.msgpack"), xs)
    return out


def _assert_rows(name, got, want):
    if name == "sine":
        assert_i8_equal(got, want)
    else:
        assert_softmax_close(got, want)


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("use_kernels", [True, False])
def test_paper_model_paged_matches_reference(paper, name, use_kernels):
    """Each paper model with its paging map: ``predict_q`` and buckets 1, 2,
    4 and 8 (through ``predict_q_many(max_batch=8)``) against the JAX
    package's paged engine, and every row against the port's unpaged
    engine."""
    jq, tq, xs = paper[name]
    paged = PAPER_PAGED[name]
    jm = JCompiled(jq, paged=paged)
    cm = CompiledModel(tq, use_kernels=use_kernels, device="cpu", paged=paged)
    assert not set(paged) & set(cm.plan.layouts if cm.plan else ())
    unpaged = CompiledModel(tq, use_kernels=use_kernels, device="cpu")
    _assert_rows(name, cm.predict_q(xs[0]), np.asarray(jm.predict_q(xs[0])))
    for batch in ((1, 2, 3, 8) if name != "person" else (3, 8)):
        got = cm.predict_q_many(xs[:batch], max_batch=8)
        _assert_rows(name, got, np.asarray(jm.predict_q_many(xs[:batch],
                                                             max_batch=8)))
        assert_i8_equal(got, unpaged.predict_q_many(xs[:batch], max_batch=8))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_paper_model_memory_report_of_paged_engine(paper, name):
    from repro.core.memory import plan_paged as j_plan_paged
    from repro_torch.core.memory import plan_paged as t_plan_paged
    jq, tq, _ = paper[name]
    cm = CompiledModel(tq, device="cpu", paged=PAPER_PAGED[name])
    assert cm.paged == PAPER_PAGED[name]
    assert cm.memory_report().as_dict() == JCompiled(jq).memory_report().as_dict()
    tp = t_plan_paged(tq, cm.paged)
    jp = j_plan_paged(jq, PAPER_PAGED[name])
    assert (tp.per_op, tp.peak_bytes, tp.pages) == (jp.per_op, jp.peak_bytes,
                                                    jp.pages)
