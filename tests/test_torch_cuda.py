"""The hand-written CUDA kernels on the card: each against its plain PyTorch
version, and the compiled engine's kernel route against its CPU plain route.
Port only (the card's machine has no JAX). Skips without a GPU; run there
with ``python -m pytest -q -m cuda tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.Generator(device="cuda").manual_seed(0)


def _operands(gen, xshape, wshape, n):
    def i8(shape):
        return torch.randint(-128, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int16).to(torch.int8)
    consts = (torch.randn(n, generator=gen, device="cuda") * 5,
              torch.rand(n, generator=gen, device="cuda") * 0.02 + 1e-4,
              torch.randint(-5000, 5000, (n,), generator=gen, device="cuda",
                            dtype=torch.int32),
              torch.randint(-100, 100, (n,), generator=gen, device="cuda",
                            dtype=torch.int32),
              torch.randint(-8, 9, (n,), generator=gen, device="cuda",
                            dtype=torch.int32))
    return i8(xshape), i8(wshape), consts


@pytest.mark.parametrize("m,k,n,n_true", [
    (64, 64, 64, None), (2304, 1152, 128, 8), (640, 256, 256, 200),
    (100, 288, 32, 8), (2305, 288, 32, None), (9, 256, 256, 256),
    (18432, 288, 32, 8), (4608, 64, 64, None), (4608, 32, 64, 50),
    (4096, 128, 128, 100)])
@pytest.mark.parametrize("lo,hi", [(float("-inf"), float("inf")), (-3.0, 57.7)])
def test_qmatmul_kernel_equals_plain(gen, m, k, n, n_true, lo, hi):
    """Ragged M (100, 2305, 9), person's conv0 at quantum 32 (K 288, N 32)
    at buckets 1 and 8, and the quantum-128 conv0 shape (2304 x 1152 x
    128): every block tile and K stage the wrapper picks."""
    from repro_torch.kernels import qmatmul as mm, ref
    x, w_nk, c = _operands(gen, (m, k), (n, k), n)
    before = mm.launches
    got = mm.qmatmul(x, w_nk, *c, lo=lo, hi=hi, n_true=n_true)
    assert mm.launches == before + 1
    torch.testing.assert_close(got, ref.qmatmul_ref(x, w_nk.t(), *c, lo=lo,
                                                    hi=hi, n_true=n_true),
                               rtol=0, atol=0)


@pytest.mark.parametrize("shape,kk,stride,pads,c_true", [
    ((1, 98, 98, 128), 3, 2, (0, 0, 0, 0), 8),    # pre-padded (VALID)
    ((8, 14, 14, 128), 3, 1, (0, 0, 0, 0), 64),
    ((2, 7, 7, 256), 3, 1, (0, 0, 0, 0), None),
    ((8, 48, 48, 32), 3, 1, (1, 1, 1, 1), 8),     # 3x3/s1 instantiation
    ((8, 48, 48, 32), 3, 2, (0, 1, 0, 1), 16),    # 3x3/s2, asymmetric
    ((1, 3, 3, 256), 3, 1, (1, 1, 1, 1), None),
    ((2, 12, 11, 32), 5, 2, (1, 2, 2, 2), 20),    # generic, asymmetric
    ((1, 10, 10, 8), 5, 1, (2, 2, 2, 2), 5),      # generic, C = 8
    ((3, 96, 96, 8), 3, 2, (0, 1, 0, 1), None),   # C = 8 (8-byte pieces)
    ((8, 95, 95, 8), 3, 1, (1, 1, 1, 1), None),   # ragged bands of 2 rows
    ((1, 9, 9, 12), 3, 1, (1, 1, 1, 1), 10),      # C = 12 (4-byte pieces)
])
def test_qdwconv_kernel_equals_plain(gen, shape, kk, stride, pads, c_true):
    """Every instantiation (3x3/s1, 3x3/s2, the generic one), the SAME
    border fused in (z_x on every lane, asymmetric pads), 16-, 8- and
    4-byte staging pieces, and bands that do not divide the output; two
    calls give the same bits."""
    from repro_torch.kernels import qdwconv as dw, ref
    x, w, c = _operands(gen, shape, (kk, kk, shape[-1]), shape[-1])
    kw = dict(stride=(stride, stride), pads=pads, z_x=-7, lo=-5.0, hi=100.0,
              c_true=c_true)
    before = dw.launches
    got = dw.qdwconv(x, w, *c, **kw)
    assert dw.launches == before + 1
    torch.testing.assert_close(got, ref.qdwconv_ref(x, w, *c, **kw), rtol=0,
                               atol=0)
    assert torch.equal(dw.qdwconv(x, w, *c, **kw), got)


def test_wrapper_rejects_misaligned_rows(gen):
    """Rows of K = 48 bytes are not whole mma depths (32): refused before
    any launch."""
    from repro_torch.kernels import qmatmul as mm
    x, w_nk, c = _operands(gen, (100, 48), (64, 48), 64)
    before = mm.launches
    with pytest.raises(ValueError):
        mm.qmatmul(x, w_nk, *c)
    assert mm.launches == before


def test_person_engine_on_card_equals_cpu_plain_route(gen):
    from repro_torch.configs.paper_models import build_person
    from repro_torch.core.engine import CompiledModel
    from repro_torch.core.quantize import quantize_graph
    rng = np.random.default_rng(1)
    qg = quantize_graph(build_person(), [rng.normal(0, 1, (1, 96, 96, 1))
                                         .astype("f")], device="cuda")
    xs = np.stack([qg.tensor(qg.inputs[0]).qparams.quantize(
        rng.normal(0, 1, (1, 96, 96, 1)).astype("f")) for _ in range(3)])
    got = CompiledModel(qg, device="cuda").predict_q_many(xs, max_batch=2)
    want = CompiledModel(qg, use_kernels=False, device="cpu").predict_q_many(xs)
    # softmax output: ±1 LSB (exp differs in the last ulp between devices)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("m,k,n,page", [
    (1, 1, 16, 1), (8, 16, 16, 1), (4, 256, 16, 1), (8, 4000, 4, 1),
    (1, 4000, 4, 1), (8, 256, 2, 1), (1, 256, 256, 128), (4, 256, 256, 128),
    (9, 256, 256, 128), (4, 256, 256, 8), (7, 45, 300, 150),
    (9, 333, 512, 512), (3, 100000, 4, 1)])
@pytest.mark.parametrize("lo,hi", [(float("-inf"), float("inf")), (-3.0, 57.7)])
def test_paged_qmatmul_kernel_equals_plain(gen, m, k, n, page, lo, hi):
    """The paged kernel at the paper models' paged shapes (sine, speech,
    person), page 1 at K = 1, 16, 256 and 4000, the 256-wide FC at page 128
    (split into slices) with M = 1, 4 and 9, a page of 8, an odd K, a
    ragged last slice, and a K staged in chunks; bit-exact, and two calls
    give the same bits (the K split adds its partial sums in a fixed
    order)."""
    from repro_torch.kernels import paged_matmul as pm, ref
    x, w, c = _operands(gen, (m, k), (k, n), n)
    before = pm.launches
    got = pm.paged_qmatmul(x, w, *c, page=page, lo=lo, hi=hi)
    assert pm.launches == before + 1
    torch.testing.assert_close(got, ref.paged_qmatmul_ref(
        x, w, *c, page=page, lo=lo, hi=hi), rtol=0, atol=0)
    assert torch.equal(pm.paged_qmatmul(x, w, *c, page=page, lo=lo, hi=hi),
                       got)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("m,k,n", [(8, 16, 8), (130, 70, 33), (8, 4000, 4),
                                   (128, 4096, 128)])
def test_fmatmul_kernel_within_tolerance(gen, dtype, tol, m, k, n):
    """Unsplit and split K (the speech FC, 8 x 4000 x 4, and 128 x 4096 x
    128, with the speech FC's weight scale, sigma 0.05): within the
    reference's tolerance, and two calls give the same bits (the split-K
    reduction runs in a fixed order)."""
    from repro_torch.kernels import ops, qmatmul as mm, ref
    assert not torch.backends.cuda.matmul.allow_tf32
    w_scale = 0.05 if k > 1024 else 1.0
    x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(k, n, generator=gen, device="cuda") * w_scale).to(dtype)
    before = mm.fmatmul_launches
    got = ops.fmatmul(x, w)
    assert mm.fmatmul_launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (m, n)
    torch.testing.assert_close(got.float(), ref.fmatmul_ref(x, w).float(),
                               rtol=tol, atol=tol)
    assert torch.equal(ops.fmatmul(x, w), got)


def test_probe_launches_on_the_card(gen):
    from repro_torch.kernels import ops
    ops.can_launch_kernels.cache_clear()
    assert ops.can_launch_kernels() == (True, None)


@pytest.mark.parametrize("name,paged", [("sine", {0: 16, 1: 16}),
                                        ("speech", {2: 4})])
def test_paged_engine_on_card_equals_cpu_plain_route(gen, name, paged):
    from repro_torch.configs.paper_models import PAPER_MODELS
    from repro_torch.core.engine import CompiledModel
    from repro_torch.core.quantize import quantize_graph
    from repro_torch.kernels import paged_matmul as pm
    shape = {"sine": (1, 1), "speech": (1, 49, 40, 1)}[name]
    rng = np.random.default_rng(1)
    qg = quantize_graph(PAPER_MODELS[name](), [rng.normal(0, 1, shape)
                                               .astype("f")], device="cuda")
    xs = np.stack([qg.tensor(qg.inputs[0]).qparams.quantize(
        rng.normal(0, 1, shape).astype("f")) for _ in range(5)])
    cm = CompiledModel(qg, device="cuda", paged=paged)
    before = pm.launches
    got = cm.predict_q_many(xs, max_batch=4)
    # buckets 4 and 1, each run once eagerly and captured as a CUDA graph
    assert pm.launches == before + 2 * 2 * len(paged)
    assert all(e["launches"]["paged_qmatmul"] == len(paged)
               for e in cm.compile_log)
    before = pm.launches
    np.testing.assert_array_equal(cm.predict_q_many(xs, max_batch=4), got)
    assert pm.launches == before  # replays call no wrapper
    want = CompiledModel(qg, use_kernels=False, device="cpu",
                         paged=paged).predict_q_many(xs, max_batch=4)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1  # softmax
    np.testing.assert_array_equal(got, CompiledModel(qg, device="cuda")
                                  .predict_q_many(xs, max_batch=4))
    for route in cm.routes():
        np.testing.assert_array_equal(cm.predict_q_routed(xs, route=route), got)


def _paper_engine(name, use_kernels=True):
    from repro_torch.configs.paper_models import PAPER_MODELS
    from repro_torch.core.engine import CompiledModel
    from repro_torch.core.quantize import quantize_graph
    shape = {"sine": (1, 1), "speech": (1, 49, 40, 1),
             "person": (1, 96, 96, 1)}[name]
    rng = np.random.default_rng(2)
    qg = quantize_graph(PAPER_MODELS[name](), [rng.normal(0, 1, shape)
                                               .astype("f")], device="cuda")
    xs = rng.integers(-128, 128, (8,) + shape).astype(np.int8)
    return CompiledModel(qg, use_kernels=use_kernels, device="cuda"), xs


@pytest.mark.parametrize("use_kernels", [True, False],
                         ids=["kernels", "compiled"])
@pytest.mark.parametrize("name", ["sine", "speech", "person"])
def test_bucket_graph_replays_equal_eager_rows(gen, name, use_kernels):
    """Every bucket up to 8, captured as a CUDA graph and replayed, gives
    the rows of the eager batched forward on the same staged input, on the
    kernel route and on the plain route; the graph holds exactly the
    kernel-wrapper calls of one eager forward."""
    import torch
    from repro_torch.kernels import launch_counts
    cm, xs = _paper_engine(name, use_kernels)
    (tid,) = cm.graph.inputs
    shape = cm.graph.tensor(tid).shape
    for b in (1, 2, 4, 8):
        for rows in sorted({b, max(1, b - 1)}):
            got = cm.predict_q_many(xs[:rows])
            staged = torch.zeros((b,) + cm.exec_plan.entry_shape(tid),
                                 dtype=torch.int8, device="cuda")
            staged[(slice(0, rows),) + tuple(slice(0, d) for d in shape)] = \
                torch.as_tensor(xs[:rows], device="cuda")
            before = launch_counts()
            eager = cm._batched_fn(staged)[0][:rows].cpu().numpy()
            calls = {k: v - before[k] for k, v in launch_counts().items()}
            np.testing.assert_array_equal(got, eager)
        assert [e["launches"] for e in cm.compile_log
                if e["bucket"] == b] == [calls]
    assert cm.bucket_sizes() == (1, 2, 4, 8) and cm.compile_events == 4


def test_no_recapture_or_wrapper_call_after_warmup(gen):
    """After ``warmup_routes(8)`` no batch of 0..11 rows on either engine
    route, and no staged flush of 1..8 rows, captures a graph, allocates a
    staging buffer or calls a kernel wrapper."""
    from repro_torch.kernels import launch_counts
    cm, xs = _paper_engine("person")
    xs = np.concatenate([xs, xs[:3]])
    cm.warmup_routes(8)
    fb = cm._fallback_compiled()
    state = (cm.compile_events, fb.compile_events, cm.staging_events,
             fb.staging_events, launch_counts())
    assert state[:2] == (4, 4)
    for n in range(12):
        a = cm.predict_q_many(xs[:n], max_batch=8)
        b = cm.predict_q_routed(xs[:n], route="compiled", max_batch=8)
        np.testing.assert_array_equal(a, b)
    for n in range(1, 9):
        np.testing.assert_array_equal(cm.staged_infer(list(xs[:n])),
                                      cm.predict_q_many(xs[:n]))
    assert (cm.compile_events, fb.compile_events, cm.staging_events,
            fb.staging_events, launch_counts()) == state
