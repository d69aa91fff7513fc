"""The hand-written CUDA kernels on the card: each against its plain PyTorch
version, and the compiled engine's kernel route against its CPU plain route.
Port only (the card's machine has no JAX). Skips without a GPU; run there
with ``python -m pytest -q -m cuda tests/test_torch_cuda.py``."""
import os

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


#: the fused conv on the card: (batch, H, W, cin, lanes, kh, kw, stride,
#: padding, cout, z_x). Speech's 10x8/s2 at buckets 1, 8, 32 and 256 and
#: conv0's 3x3/s2 at 1, 8 and 32 (one channel at 32 lanes, SAME, rows of 500
#: and 2,304 a sample); cin 3, 8 and 40 at 32 and 64 lanes (packed K 27 ->
#: 32, 72 -> 96, 360 -> 384, so slabs of 32, 128 and three of 128), N' 32
#: to 128 (blocks of 32 columns), VALID, ragged rows, n_true < N'
FUSED_CONVS = (
    [(b, 49, 40, 1, 32, 10, 8, 2, "SAME", 8, -5) for b in (1, 8, 32, 256)]
    + [(b, 96, 96, 1, 32, 3, 3, 2, "SAME", 8, 7) for b in (1, 8, 32)]
    + [(3, 11, 9, 3, 32, 3, 3, 1, "SAME", 16, -128),
       (2, 17, 13, 8, 32, 3, 3, 2, "VALID", 64, 3),
       (2, 12, 10, 40, 64, 3, 3, 1, "SAME", 70, -9),
       (1, 7, 7, 40, 64, 5, 3, 2, "VALID", 32, 0),
       (3, 9, 14, 3, 64, 2, 2, 2, "SAME", 32, 100),
       (2, 20, 20, 8, 64, 3, 3, 1, "SAME", 128, 1)])


@pytest.mark.parametrize("geo", FUSED_CONVS)
@pytest.mark.parametrize("lo,hi", [(float("-inf"), float("inf")),
                                   (-20.0, float("inf")), (-20.0, 35.0)],
                         ids=["none", "relu", "relu6"])
def test_qconv_fused_kernel_equals_plain(gen, geo, lo, hi):
    """A planned multi-tap conv on the card is one launch of the fused conv
    kernel, bit for bit the im2col route it replaces (the SAME border
    pre-padded, im2col, the qmatmul kernel) and the fused kernel's plain
    version, with zero padding lanes; two calls give the same bits."""
    from repro_torch.core.preprocess import OpLayout, pack_conv_taps
    from repro_torch.kernels import ops, qconv, qmatmul as mm, ref
    b, h, w, cin, lanes, kh, kw, s, padding, cout, z_x = geo
    n = -(-cout // 32) * 32
    x, f, c = _operands(gen, (b, h, w, lanes), (kh, kw, lanes, n), n)
    x[..., cin:] = 0  # a planned producer's padding lanes
    f[:, :, cin:, :] = 0
    f[..., cout:] = 0
    w_phys = f.reshape(kh * kw * lanes, n).cpu().numpy()
    lay = OpLayout("conv", w_phys, tuple(v.cpu().numpy() for v in c), lo, hi,
                   cout, lanes, (b, 0, 0, n), cin, z_x,
                   np.ascontiguousarray(w_phys.T),
                   pack_conv_taps(w_phys, kh, kw, cin)).to("cuda")
    geo_kw = dict(kh=kh, kw=kw, stride=(s, s), padding=padding)
    n_true = cout if cout < n else None
    before = (mm.launches, mm.conv_launches)
    got = ops.qconv_planned(x, lay, **geo_kw)
    assert (mm.launches, mm.conv_launches) == (before[0], before[1] + 1)
    im2col = qconv.qconv2d(
        ops._pad_border_planned(x, kh, kw, (s, s), padding, z_x, cin),
        lay.w_nk, *lay.consts, kh=kh, kw=kw, stride=(s, s), lo=lo, hi=hi,
        n_true=n_true)
    plain = ref.qconv_fused_ref(
        x, lay.w_packed, *lay.consts, kh=kh, kw=kw, stride=(s, s),
        pads=ops._border(x, kh, kw, (s, s), padding), c_true=cin, z_x=z_x,
        lo=lo, hi=hi, n_true=n_true)
    torch.testing.assert_close(got, im2col, rtol=0, atol=0)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    assert not got[..., cout:].any()
    assert torch.equal(ops.qconv_planned(x, lay, **geo_kw), got)


@pytest.mark.parametrize("name,per_forward", [
    ("speech", {"qmatmul": 1, "qmatmul_conv": 1}),
    ("person", {"qmatmul": 14, "qmatmul_conv": 1, "qdwconv": 13})])
def test_planned_conv_launches_fused_kernel_once_a_forward(gen, name,
                                                           per_forward):
    """Each multi-tap planned conv (speech's conv, person's conv0) is one
    fused conv launch a forward, per call and at buckets 1 and 8; person's
    13 pointwise convs and every FC still launch qmatmul."""
    from repro_torch.kernels import launch_counts
    cm, xs = _paper_engine(name)
    (tid,) = cm.graph.inputs
    shape = cm.graph.tensor(tid).shape
    cm.predict_q_many(xs, max_batch=8)
    forwards = [lambda: cm._fn(torch.as_tensor(xs[0], device="cuda"))]
    for b in (1, 8):
        staged = torch.as_tensor(xs[:b], device="cuda").reshape((b,) + shape)
        forwards.append(lambda staged=staged: cm._batched_fn(staged))
    for forward in forwards:
        before = launch_counts()
        forward()
        calls = {k: v - before[k] for k, v in launch_counts().items()
                 if v != before[k]}
        assert calls == per_forward


@pytest.mark.parametrize("name", ["speech", "person"])
def test_card_plan_concatenates_no_im2col(gen, name):
    """On the card's kernel route no forward calls ``torch.cat`` (the fused
    conv gathers its taps in the kernel), and ``measured_pads`` counts what
    the card's budget derives, per call and at buckets 1 and 8."""
    from torch.overrides import TorchFunctionMode
    from repro_torch.analysis.budget import measured_pads, pad_budget
    from repro_torch.core.engine import _DTYPES

    class Cats(TorchFunctionMode):
        n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            self.n += getattr(func, "__name__", "") == "cat"
            return func(*args, **(kwargs or {}))

    cm, _ = _paper_engine(name)
    plan = cm.exec_plan
    (tid,) = plan.graph.inputs
    t = plan.graph.tensor(tid)
    for batched, bucket in ((False, 1), (True, 1), (True, 8)):
        budget = pad_budget(plan, batched=batched, bucket=bucket)
        assert not any("im2col" in why for _, _, why in budget.items)
        assert measured_pads(plan, batched=batched, bucket=bucket) \
            == budget.total
        lead = (bucket,) if batched else ()
        x = torch.zeros(lead + tuple(t.shape), dtype=_DTYPES[t.dtype],
                        device="cuda")
        with Cats() as mode:
            plan.lower(batched=batched)(x)
        assert mode.n == 0


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


def test_no_collection_inside_a_capture(gen):
    """The cyclic collector never runs inside a CUDA-graph capture: there
    it could free a dead engine's graph, which a capturing stream does not
    permit. With the collector set to run at every allocation and a
    captured engine dead in a reference cycle, a second engine's capture
    sees no collection and succeeds."""
    import gc
    during = []

    def note(phase, info):
        if phase == "start" and torch.cuda.is_current_stream_capturing():
            during.append(info["generation"])

    dead, xs = _paper_engine("sine")
    dead.predict_q(xs[0])
    dead.cycle = dead
    del dead
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    gc.callbacks.append(note)
    try:
        cm, _ = _paper_engine("sine")
        got = cm.predict_q(xs[0])
    finally:
        gc.callbacks.remove(note)
        gc.set_threshold(*thresholds)
    assert during == []
    assert np.array_equal(got, cm.predict_q(xs[0]))
    assert gc.isenabled()


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
            staged = torch.zeros((b,) + shape, dtype=torch.int8,
                                 device="cuda")  # the logical rows
            staged[:rows] = torch.as_tensor(xs[:rows], device="cuda")
            before = launch_counts()
            eager = cm._batched_fn(staged)[0][:rows].cpu().numpy()
            calls = {k: v - before[k] for k, v in launch_counts().items()}
            np.testing.assert_array_equal(got, eager)
        assert [e["launches"] for e in cm.compile_log
                if e["kind"] == "bucket" and e["bucket"] == b] == [calls]
        assert tuple(cm.cached_bucket(b).inputs[0].shape) == (b,) + shape
    assert cm.bucket_sizes() == (1, 2, 4, 8) and cm.compile_events == 4


@pytest.mark.parametrize("use_kernels", [True, False],
                         ids=["kernels", "compiled"])
@pytest.mark.parametrize("name", ["sine", "speech", "person"])
def test_percall_graph_replays_equal_eager_rows(gen, name, use_kernels):
    """``predict_q`` on one sample captures the per-call forward at its
    first call (one ``"percall"`` entry holding the wrapper calls of one
    eager per-call forward) and replays it after: rows equal to the eager
    forward's, and a replay calls no wrapper."""
    from repro_torch.kernels import launch_counts
    cm, xs = _paper_engine(name, use_kernels)
    (tid,) = cm.graph.inputs
    before = launch_counts()
    eager = [cm._fn(torch.as_tensor(x, device="cuda"))[0].cpu().numpy()
             for x in xs[:3]]
    per_fwd = {k: (v - before[k]) // 3 for k, v in launch_counts().items()}
    first = cm.predict_q(xs[0])
    (entry,) = cm.compile_log
    assert entry["kind"] == "percall" and entry["launches"] == per_fwd
    before = launch_counts()
    got = [cm.predict_q(x) for x in xs[:3]]
    assert launch_counts() == before  # replays call no wrapper
    np.testing.assert_array_equal(first, got[0])
    for y, e in zip(got, eager):
        np.testing.assert_array_equal(y, e)
    assert cm.compile_events == 1 and cm.cached_percall() is cm.executable
    mem = cm.memory_analysis()
    assert mem["captures"] == 1
    assert 0 < mem["graph_pool_bytes"] <= mem["memory_reserved_bytes"]


def _staged_rows(cm, xs, b):
    """``xs`` staged as bucket ``b``'s logical input, on the card."""
    (tid,) = cm.graph.inputs
    x = torch.zeros((b,) + cm.graph.tensor(tid).shape, dtype=torch.int8,
                    device="cuda")
    x[:len(xs)] = torch.as_tensor(xs, device="cuda")
    return x


def test_graph_pool_pairs_replayed_out_of_order(gen):
    """Person's kernel route, buckets 1, 2, 4, 8 captured in that order into
    the model's one pool. For each pair (earlier capture e, later capture
    l), the raw sequence — replay l, replay e, then read l's static outputs
    — is recorded (a pair whose outputs changed shares pool blocks: the
    hazard), and the same interleaving through the API (l's call, e's call,
    l's call) gives every row of the eager forward: the model-wide lock
    keeps the raw sequence unreachable."""
    import itertools
    cm, _ = _paper_engine("person")
    rng = np.random.default_rng(7)
    shape = cm.graph.tensor(cm.graph.inputs[0]).shape
    xs = {b: rng.integers(-128, 128, (b,) + shape).astype(np.int8)
          for b in (1, 2, 4, 8)}
    exes = {b: cm.compile_batched(b) for b in (1, 2, 4, 8)}
    eager = {b: cm._batched_fn(_staged_rows(cm, xs[b], b))[0].cpu().numpy()
             for b in xs}
    aliased = []
    for e, l in itertools.combinations((1, 2, 4, 8), 2):
        E, L = exes[e], exes[l]
        with cm._replay_lock, torch.cuda.stream(cm._stream):
            L.inputs[0].copy_(_staged_rows(cm, xs[l], l))
            L.graph.replay()
            E.inputs[0].copy_(_staged_rows(cm, xs[e], e))
            E.graph.replay()
            raw = L.outputs[0].cpu().numpy()
        if not np.array_equal(raw, eager[l]):
            aliased.append((e, l))
        for b in (l, e, l):
            np.testing.assert_array_equal(cm.predict_q_many(xs[b]), eager[b])
    print(f"pairs whose raw out-of-order replay changed the later graph's "
          f"outputs: {aliased}")


def test_threaded_bucket_interleave_is_exact(gen):
    """8 threads call ``predict_q_many`` on buckets 1, 2, 4 and 8
    interleaved (and one-sample ``predict_q`` on the per-call graph, which
    shares the pool) on one warmed person engine: every row equals the
    eager forward's."""
    import sys
    import threading
    cm, _ = _paper_engine("person")
    cm.warmup_batched(8)
    rng = np.random.default_rng(9)
    shape = cm.graph.tensor(cm.graph.inputs[0]).shape
    xs = {b: rng.integers(-128, 128, (b,) + shape).astype(np.int8)
          for b in (1, 2, 4, 8)}
    want = {b: cm._batched_fn(_staged_rows(cm, xs[b], b))[0].cpu().numpy()
            for b in xs}
    single = cm._fn(torch.as_tensor(xs[1][0], device="cuda"))[0].cpu().numpy()
    errors, done = [], []

    def worker(k):
        try:
            for i in range(24):
                b = (1, 2, 4, 8)[(k + i) % 4]
                if i % 6 == 5:
                    if not np.array_equal(cm.predict_q(xs[1][0]), single):
                        errors.append((k, i, "percall"))
                elif not np.array_equal(cm.predict_q_many(xs[b]), want[b]):
                    errors.append((k, i, b))
            done.append(k)
        except Exception as e:  # surfaced by the assertion below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and sorted(done) == list(range(8))
    assert cm.compile_events == 5  # 4 buckets and the per-call graph


def test_no_recapture_or_wrapper_call_after_warmup(gen):
    """After ``warmup_routes(8)`` no batch of 0..11 rows on either engine
    route, and no staged flush of 1..8 rows, captures a graph, allocates a
    staging buffer or calls a kernel wrapper; the staging buffers hold the
    logical rows."""
    from repro_torch.kernels import launch_counts
    cm, xs = _paper_engine("person")
    xs = np.concatenate([xs, xs[:3]])
    cm.warmup_routes(8)
    fb = cm._fallback_compiled()
    shape = cm.graph.tensor(cm.graph.inputs[0]).shape
    for b, sets in cm._staging.items():
        assert all(tuple(s[0].shape) == (b,) + shape for s in sets)
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


def test_h2d_counters_count_each_call_of_host_rows(gen):
    """``h2d_copies`` / ``h2d_bytes``: each call of person's graphs copies
    its logical rows from the host once (96 × 96 × 1 int8 a row; bucket 8
    73,728 B, bucket 1 and the per-call graph 9,216 B), the capturing call
    too; a call whose input is already on the card copies nothing from the
    host."""
    cm, xs = _paper_engine("person")
    row = int(np.prod(xs.shape[1:]))
    assert (cm.h2d_copies, cm.h2d_bytes) == (0, 0)
    calls = [(xs, 8), (xs[:1], 1), (xs, 8), (xs, 8), (xs[:1], 1)]
    for i, (batch, bucket) in enumerate(calls):
        cm.predict_q_many(batch, max_batch=8)
        done = calls[:i + 1]
        assert (cm.h2d_copies, cm.h2d_bytes) == (
            len(done), row * sum(b for _, b in done))
    cm.predict_q(xs[0])
    state = (len(calls) + 1, row * (sum(b for _, b in calls) + 1))
    assert (cm.h2d_copies, cm.h2d_bytes) == state
    cm.compile_batched(8).run((_staged_rows(cm, xs, 8),), 8)
    assert (cm.h2d_copies, cm.h2d_bytes) == state


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_apply_moe_same_bits_on_two_runs(gen, dtype):
    """An MoE layer at top_k 6 (16 experts, d 512, 256 tokens) gives the
    same bits on two calls: its combine sums each token's picks in one
    order, where an ``index_add`` on the card adds them by atomics."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import draw
    from repro_torch.models.moe import apply_moe, init_moe
    cfg = dataclasses.replace(
        get_config("deepseek-v2-236b").reduced(), d_model=512, n_experts=16,
        top_k=6, moe_d_ff=256, capacity_factor=2.0)
    p = draw(init_moe(cfg, dtype), 0, "cuda")
    x = (torch.randn((4, 64, 512), generator=gen, device="cuda") * 0.3) \
        .to(dtype)
    (y1, a1), (y2, a2) = apply_moe(cfg, p, x), apply_moe(cfg, p, x)
    assert torch.isfinite(y1.float()).all()
    assert torch.equal(y1, y2) and torch.equal(a1, a2)


@pytest.mark.parametrize("use_kernels", [True, False],
                         ids=["kernels", "compiled"])
def test_warm_boot_from_cache_checks_every_capture(gen, tmp_path, use_kernels):
    """A warm boot in the same process: the cache carries person's capture
    records and, on the kernel route, the libraries it launches (qmatmul,
    qdwconv, the probe); the warm engine makes every graph again from its
    record (no build counted, as many captures), each capture holding the
    calls its record names, and serves the cold engine's rows."""
    import json
    from repro_torch.kernels import _build
    from repro_torch.serve.aotcache import AotCache
    cold, xs = _paper_engine("person", use_kernels)
    cache = AotCache(str(tmp_path))
    cold.compile()
    cold.warmup_batched(4, cache=cache)
    man = cache.manifest(cold.last_cache_result.fingerprint)
    want_libs = {"qmatmul", "qdwconv", "probe"} if use_kernels else set()
    assert set(man["libraries"]) == want_libs
    for name, lib in man["libraries"].items():
        assert lib["file"] == _build._target(name).name
        assert os.path.exists(os.path.join(str(tmp_path), "lib", lib["file"]))
    assert "driver" in man["environment"]
    warm = type(cold)(cold.graph, use_kernels=use_kernels, device="cuda")
    warm.warmup_batched(4, cache=cache)
    assert warm.last_cache_result.hit, warm.last_cache_result
    assert warm.compile_events == 0
    assert warm.capture_events == cold.capture_events == 4
    for entry in warm.compile_log:
        key = "percall" if entry["kind"] == "percall" \
            else f"bucket_{entry['bucket']}"
        with open(f"{cache.dir_for(man['fingerprint'])}/{key}.json") as f:
            assert entry["launches"] == json.load(f)["launches"]
        assert entry["cache"] == "hit"
    for n in (1, 3, 4):
        np.testing.assert_array_equal(warm.predict_q_many(xs[:n]),
                                      cold.predict_q_many(xs[:n]))
    np.testing.assert_array_equal(warm.predict_q(xs[0]), cold.predict_q(xs[0]))
    assert warm.compile_events == 0 and warm.capture_events == 4


def test_record_with_other_launches_is_a_miss(gen, tmp_path):
    """A record whose launches differ from what the capture holds (its
    digest made to agree) fails the install step: a miss naming the
    launches, nothing kept, and a cold boot that stores a good copy."""
    import hashlib
    import json
    from repro_torch.serve.aotcache import AotCache
    cold, xs = _paper_engine("sine")
    cache = AotCache(str(tmp_path))
    cold.warmup_batched(2, cache=cache)
    fp = cold.last_cache_result.fingerprint
    path = f"{cache.dir_for(fp)}/bucket_2.json"
    rec = json.loads(open(path).read())
    rec["launches"]["qmatmul"] += 1
    data = json.dumps(rec).encode()
    open(path, "wb").write(data)
    man = cache.manifest(fp)
    man["entries"]["bucket_2"] = hashlib.sha256(data).hexdigest()
    open(cache.manifest_path(fp), "w").write(json.dumps(man))
    warm = type(cold)(cold.graph, device="cuda")
    warm.warmup_batched(2, cache=cache)
    res = warm.last_cache_result
    assert not res.hit and "['launches']" in res.reason, res
    assert warm.cache_events["hit"] == 0 and warm.compile_events == 2
    np.testing.assert_array_equal(warm.predict_q_many(xs[:2]),
                                  cold.predict_q_many(xs[:2]))
    assert cache.verify(type(cold)(cold.graph, device="cuda"), 2).hit


def test_stablelm_depth2_card_matches_cpu(gen):
    """stablelm-3b at its published widths, cut to two layers: the same
    float32 weights, drawn on the CPU and copied to the card, give prefill
    and eight teacher-forced decode logits within 1e-4 · max |logit| of the
    CPU's, the same greedy token wherever the CPU's top-2 margin exceeds
    1e-3, the cache written in place, and TF32 off."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import cut_depth
    from repro_torch.models import model as M
    from repro_torch.models.layers import tree_map
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = cut_depth(get_config("stablelm-3b"), 2)
    cpu = M.init_params(cfg, 0, torch.float32, max_seq=64, device="cpu")
    card = M.Model(cfg, tree_map(lambda t: t.detach().to("cuda"), cpu.tree()))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int32)
    caches = {d: M.init_cache(cfg, 4, 64, torch.float32, device=d)
              for d in ("cpu", "cuda")}
    ptrs = [t.data_ptr() for t in caches["cuda"]["layers"][0]["mixer"]
            .values()]
    with torch.no_grad():
        want, _ = cpu("prefill", {"tokens": prompts}, caches["cpu"])
        got, _ = card("prefill", {"tokens": prompts}, caches["cuda"])
        for step in range(9):
            want, got = want[:, -1], got[:, -1].cpu()
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= 1e-4 * scale, step
            top2 = want.topk(2, -1).values
            sure = (top2[:, 0] - top2[:, 1]) > 1e-3
            tok = want.argmax(-1)
            assert torch.equal(got.argmax(-1)[sure], tok[sure]), step
            if step == 8:
                break
            want, _ = cpu("decode_step", tok[:, None], caches["cpu"],
                          16 + step)
            got, _ = card("decode_step", tok[:, None].cuda(), caches["cuda"],
                          16 + step)
    assert [t.data_ptr() for t in caches["cuda"]["layers"][0]["mixer"]
            .values()] == ptrs


def _train_step_card_vs_cpu(cfg, B, T):
    """One train step of ``cfg`` on the card and on the CPU from the same
    float32 weights and batch, held at the CPU parity tests' tolerances:
    the loss within 1e-4, each gradient leaf within 1e-3 of its largest
    |g|, the parameters after the update within 1e-5 (plus 1e-5 of the
    value) beyond the difference of the first AdamW steps the two devices'
    gradients give, ``lr * g s / (|g s| + eps)`` (s the clip scale), which
    is up to 2·lr where the gradients do not fix the step's sign. TF32 off
    throughout."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, frontend_stub
    from repro_torch.models import model as M
    from repro_torch.models.layers import tree_map
    from repro_torch.optim import adamw
    from repro_torch.train.checkpoint import _flatten
    from repro_torch.train.step import grads_of
    assert not torch.backends.cuda.matmul.allow_tf32
    cpu = M.init_params(cfg, 0, torch.float32, max_seq=T, device="cpu")
    card = M.trainable(M.Model(cfg, tree_map(lambda t: t.detach().cuda(),
                                             cpu.tree())))
    M.trainable(cpu)
    batch = SyntheticLM(DataConfig(cfg.vocab_size, T, B, seed=0)).batch(0)
    batch.update(frontend_stub(cfg, B, np.random.default_rng(0)))
    lc, _, gc = grads_of(cfg, cpu, batch)
    lg, _, gg = grads_of(cfg, card, batch)
    assert abs(float(lg) - float(lc)) <= 1e-4

    def direction(grads):
        s = min(1.0, 1.0 / (float(adamw.global_norm(grads)) + 1e-9))
        return {k: (g.detach().cpu() * s) / ((g.detach().cpu() * s).abs()
                                             + 1e-8)
                for k, g in _flatten(grads)}

    ggs = dict(_flatten(gg))
    for k, a in _flatten(gc):
        err = float((a - ggs[k].cpu()).abs().max())
        assert err <= 1e-3 * float(a.abs().max()), k
    dc, dg = direction(gc), direction(gg)
    ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=4)
    _, _, mc = adamw.update(ocfg, gc, adamw.init(cpu), cpu)
    adamw.update(ocfg, gg, adamw.init(card), card)
    lr = float(mc["lr"])
    cards = dict(_flatten(card))
    for k, a in _flatten(cpu):
        d = (a.detach() - cards[k].detach().cpu()).abs() - 1e-5 * a.abs()
        assert bool((d <= 1e-5 + lr * (dc[k] - dg[k]).abs()).all()), k


def test_train_step_depth2_card_matches_cpu(gen):
    """stablelm-3b at its published widths, cut to two layers."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import cut_depth
    _train_step_card_vs_cpu(cut_depth(get_config("stablelm-3b"), 2), 2, 32)


@pytest.mark.parametrize("arch", ["stablelm-3b", "mamba2-780m",
                                  "jamba-v0.1-52b", "whisper-small"])
def test_train_step_reduced_card_matches_cpu(gen, arch):
    """``reduced()`` configs of four block families; MoE under a capacity no
    token overflows."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced()
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k + 1.0)
    _train_step_card_vs_cpu(cfg, 2, 16)
