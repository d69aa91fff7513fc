"""The kernels' plain versions and wrappers against the JAX package's Pallas
kernels, run as the JAX tests run them on the CPU (``interpret=True``).

Every int8 comparison is bit-exact: the plain versions compute the
integer sums exactly and fuse the epilogue's multiply-add as the kernels
do. ``fmatmul`` keeps the reference's tolerances (1e-5 in float32, 5e-2 in
bfloat16: the sums run in another order). On CPU tensors the wrappers must
take the plain version (and count no launch); they must raise on operands
the CUDA kernels do not take. The paged kernel's cases are in
``test_torch_paging.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ops_ref import FoldedConsts as JFolded
from repro.core.ops_ref import pad_input_q as j_pad_input_q
from repro.core.quantize import quantize_graph as j_quantize
from repro.kernels import ops as jops
from repro.kernels.qconv import im2col_q as j_im2col
from repro.kernels.qdwconv import qdwconv as j_qdwconv
from repro.kernels.qmatmul import fmatmul as j_fmatmul
from repro.kernels.qmatmul import qmatmul as j_qmatmul
from repro_torch.core.ops_ref import FoldedConsts as TFolded, clamp_bounds
from repro_torch.core.ops_ref import same_pads
from repro_torch.core.preprocess import OpLayout, pack_conv_taps
from repro_torch.kernels import ops as tops
from repro_torch.kernels import qdwconv as dw_mod
from repro_torch.kernels import qmatmul as mm_mod
from repro_torch.kernels import ref
from repro_torch.kernels.qconv import im2col_q as t_im2col
from repro_torch.kernels.qdwconv import qdwconv as t_qdwconv
from repro_torch.kernels.qmatmul import qmatmul as t_qmatmul

from _torch_parity import assert_i8_equal, t

FUSED = ["NONE", "RELU", "RELU6"]


def _i8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


def _consts(rng, n, z_w):
    return (
        (rng.normal(size=n) * 5).astype(np.float32),
        (rng.random(n) * 0.02 + 1e-4).astype(np.float32),
        rng.integers(-5000, 5000, n).astype(np.int32),
        rng.integers(-100, 100, n).astype(np.int32),
        np.full(n, z_w, np.int32) if np.ndim(z_w) == 0 else z_w,
    )


def _folded(consts, z_y=3, s_y=0.03, z_x=0):
    return dict(bias_term=consts[0], rescale=consts[1], w_sum_zx=consts[2],
                const_off=consts[3], z_w=consts[4],
                z_y=np.asarray(z_y, np.int32), s_y=np.asarray(s_y, np.float32),
                z_x=np.asarray(z_x, np.int32))


def _bounds(consts, fused, z_y=3, s_y=0.03):
    return clamp_bounds(TFolded(**_folded(consts, z_y, s_y)), fused)


# ---------------------------------------------------------------------------
# qmatmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,n_true", [
    (128, 128, 128, None), (128, 128, 128, 5), (256, 384, 256, 200),
    (128, 1152, 128, 8)])
@pytest.mark.parametrize("fused", FUSED)
def test_qmatmul_ref_matches_pallas(m, k, n, n_true, fused):
    rng = np.random.default_rng(m + k + n)
    x, w = _i8(rng, (m, k)), _i8(rng, (k, n))
    c = _consts(rng, n, rng.integers(-8, 9, n).astype(np.int32))
    lo, hi = _bounds(c, fused)
    want = j_qmatmul(jnp.asarray(x), jnp.asarray(w), *(jnp.asarray(v) for v in c),
                     lo=lo, hi=hi, n_true=n_true, interpret=True)
    got = ref.qmatmul_ref(t(x), t(w), *(t(v) for v in c), lo=lo, hi=hi,
                          n_true=n_true)
    assert_i8_equal(got, want)
    before = mm_mod.launches
    # the wrapper takes the weight transposed, (N, K)
    w_nk = t(np.ascontiguousarray(w.T))
    assert_i8_equal(t_qmatmul(t(x), w_nk, *(t(v) for v in c), lo=lo, hi=hi,
                              n_true=n_true), want)
    assert mm_mod.launches == before  # CPU tensors: the plain version


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (3, 7, 5), (130, 257, 64),
                                   (1, 300, 200)])
@pytest.mark.parametrize("fused", FUSED)
def test_qmatmul_folded_matches_reference(m, k, n, fused):
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    x, w = _i8(rng, (m, k)), _i8(rng, (k, n))
    fc = _folded(_consts(rng, n, 3), z_y=-4)
    want = jops.qmatmul_folded(jnp.asarray(x), jnp.asarray(w), JFolded(**fc),
                               fused)
    assert_i8_equal(tops.qmatmul_folded(t(x), t(w), TFolded(**fc), fused), want)


# ---------------------------------------------------------------------------
# qdwconv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,hw,c,kk,stride,c_true", [
    (2, (8, 8), 8, 3, (1, 1), None),
    (1, (9, 9), 8, 3, (2, 2), 5),
    (2, (14, 14), 128, 3, (1, 1), 64),
    (1, (12, 10), 16, 5, (2, 2), None),
])
@pytest.mark.parametrize("fused", FUSED)
def test_qdwconv_ref_matches_pallas(b, hw, c, kk, stride, c_true, fused):
    rng = np.random.default_rng(c * 100 + kk)
    x, w = _i8(rng, (b,) + hw + (c,)), _i8(rng, (kk, kk, c))
    cst = _consts(rng, c, rng.integers(-8, 9, c).astype(np.int32))
    lo, hi = _bounds(cst, fused)
    oh = (hw[0] - kk) // stride[0] + 1
    ow = (hw[1] - kk) // stride[1] + 1
    want = j_qdwconv(jnp.asarray(x), jnp.asarray(w), *(jnp.asarray(v) for v in cst),
                     stride=stride, out_hw=(oh, ow), bc=min(c, 128), lo=lo,
                     hi=hi, c_true=c_true, interpret=True)
    got = ref.qdwconv_ref(t(x), t(w), *(t(v) for v in cst), stride=stride,
                          lo=lo, hi=hi, c_true=c_true)
    assert_i8_equal(got, want)
    before = dw_mod.launches
    assert_i8_equal(t_qdwconv(t(x), t(w), *(t(v) for v in cst), stride=stride,
                              lo=lo, hi=hi, c_true=c_true), want)
    assert dw_mod.launches == before


@pytest.mark.parametrize("b,hw,c,kk,stride,c_true", [
    (2, (8, 8), 8, 3, (1, 1), None),      # pads (1, 1, 1, 1)
    (1, (9, 9), 8, 3, (2, 2), 5),         # odd: (1, 1, 1, 1)
    (1, (10, 7), 16, 3, (2, 2), None),    # even H: (0, 1), odd W: (1, 1)
    (2, (14, 14), 128, 3, (1, 1), 64),
    (1, (12, 10), 16, 5, (2, 2), None),   # (1, 2, 1, 2)
    (1, (11, 13), 8, 5, (1, 1), 3),       # (2, 2, 2, 2)
    (2, (6, 5), 128, 5, (2, 2), 100),     # (1, 2, 2, 2)
])
@pytest.mark.parametrize("fused", FUSED)
def test_qdwconv_fused_border_matches_pallas(b, hw, c, kk, stride, c_true,
                                             fused):
    """The kernel's contract with the SAME border fused in: the plain
    version (and the wrapper on CPU tensors), given the unpadded x, the
    pads and z_x, equals the JAX package's ``pad_input_q`` followed by its
    Pallas kernel on the pre-padded input (``interpret=True``)."""
    rng = np.random.default_rng(c * 10 + kk + b)
    x, w = _i8(rng, (b,) + hw + (c,)), _i8(rng, (kk, kk, c))
    cst = _consts(rng, c, rng.integers(-8, 9, c).astype(np.int32))
    lo, hi = _bounds(cst, fused)
    z_x = -9
    (pt, pb), (pl, pr) = same_pads(hw[0], hw[1], kk, kk, stride)
    xp = j_pad_input_q(jnp.asarray(x), kk, kk, stride, "SAME", z_x)
    oh = (xp.shape[1] - kk) // stride[0] + 1
    ow = (xp.shape[2] - kk) // stride[1] + 1
    want = j_qdwconv(xp, jnp.asarray(w), *(jnp.asarray(v) for v in cst),
                     stride=stride, out_hw=(oh, ow), bc=min(c, 128), lo=lo,
                     hi=hi, c_true=c_true, interpret=True)
    kw = dict(stride=stride, pads=(pt, pb, pl, pr), z_x=z_x, lo=lo, hi=hi,
              c_true=c_true)
    assert_i8_equal(ref.qdwconv_ref(t(x), t(w), *(t(v) for v in cst), **kw),
                    want)
    before = dw_mod.launches
    assert_i8_equal(t_qdwconv(t(x), t(w), *(t(v) for v in cst), **kw), want)
    assert dw_mod.launches == before


def test_qdwconv_planned_runs_no_pad(tmp_path, monkeypatch):
    """Over a forward of a person-shaped graph on the kernel route, no
    ``F.pad`` runs inside ``qdwconv_planned`` outside the kernel's wrapper:
    the SAME border is the kernel's. (On CPU tensors the wrapper's plain
    version pads, as the kernel reads z_x, so it is excluded.) Every
    depthwise layer still reaches the wrapper once."""
    import torch.nn.functional as F
    from repro_torch.core.engine import CompiledModel
    from _torch_parity import carry, person_like

    rng = np.random.default_rng(4)
    jq = j_quantize(person_like(rng), [rng.normal(0, 1, (1, 24, 24, 1))
                                       .astype("f")])
    cm = CompiledModel(carry(jq, tmp_path), device="cpu")
    xs = np.stack([jq.tensor(jq.inputs[0]).qparams.quantize(
        rng.normal(0, 1, (1, 24, 24, 1)).astype("f")) for _ in range(3)])
    state = {"in_planned": False, "in_kernel": False, "pads": 0, "calls": 0}
    orig_pad, orig_planned, orig_kernel = F.pad, tops.qdwconv_planned, \
        tops._dw.qdwconv

    def pad(*a, **k):
        if state["in_planned"] and not state["in_kernel"]:
            state["pads"] += 1
        return orig_pad(*a, **k)

    def planned(*a, **k):
        state["in_planned"] = True
        try:
            return orig_planned(*a, **k)
        finally:
            state["in_planned"] = False

    def kernel(*a, **k):
        state["in_kernel"], state["calls"] = True, state["calls"] + 1
        try:
            return orig_kernel(*a, **k)
        finally:
            state["in_kernel"] = False

    monkeypatch.setattr(F, "pad", pad)
    monkeypatch.setattr(tops, "qdwconv_planned", planned)
    monkeypatch.setattr(tops._dw, "qdwconv", kernel)
    cm.predict_q(xs[0])
    cm.predict_q_many(xs, max_batch=4)
    n_dw = sum(op.op == "DEPTHWISE_CONV_2D" for op in jq.ops)
    assert state["calls"] == 2 * n_dw
    assert state["pads"] == 0


@pytest.mark.parametrize("hw,c,kk,stride,padding", [
    ((8, 8), 3, 3, (1, 1), "SAME"), ((9, 9), 5, 3, (2, 2), "SAME"),
    ((12, 10), 8, 5, (2, 2), "VALID"), ((96, 96), 8, 3, (2, 2), "SAME")])
@pytest.mark.parametrize("fused", ["NONE", "RELU6"])
def test_qdwconv_folded_matches_reference(hw, c, kk, stride, padding, fused):
    rng = np.random.default_rng(c * 10 + kk)
    x, w = _i8(rng, (2,) + hw + (c,)), _i8(rng, (kk, kk, c, 1))
    fc = _folded(_consts(rng, c, 1), z_x=4)
    want = jops.qdwconv_folded(jnp.asarray(x), jnp.asarray(w), JFolded(**fc),
                               stride=stride, padding=padding, fused=fused)
    assert_i8_equal(tops.qdwconv_folded(t(x), t(w), TFolded(**fc),
                                        stride=stride, padding=padding,
                                        fused=fused), want)


# ---------------------------------------------------------------------------
# qconv: im2col + qmatmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kk,stride", [((3, 3), (1, 1)), ((3, 3), (2, 2)),
                                       ((1, 1), (1, 1)), ((10, 8), (2, 2))])
def test_im2col_matches_reference(kk, stride):
    x = _i8(np.random.default_rng(0), (2, 13, 11, 3))
    jm, jshape = j_im2col(jnp.asarray(x), *kk, stride)
    tm, tshape = t_im2col(t(x), *kk, stride)
    assert tshape == jshape
    assert_i8_equal(tm, jm)


@pytest.mark.parametrize("shape,f,stride,padding", [
    ((2, 7, 7, 3), (3, 3, 3, 4), (1, 1), "SAME"),
    ((1, 9, 9, 5), (3, 3, 5, 7), (2, 2), "SAME"),
    ((2, 6, 6, 8), (1, 1, 8, 16), (1, 1), "SAME"),
    ((1, 49, 40, 1), (10, 8, 1, 8), (2, 2), "SAME"),
    ((1, 8, 8, 4), (3, 3, 4, 6), (1, 1), "VALID"),
])
@pytest.mark.parametrize("fused", FUSED)
def test_qconv_folded_matches_reference(shape, f, stride, padding, fused):
    rng = np.random.default_rng(int(np.prod(f)))
    x, fq = _i8(rng, shape), _i8(rng, f)
    fc = _folded(_consts(rng, f[3], rng.integers(-3, 4, f[3]).astype(np.int32)),
                 z_x=-6)
    want = jops.qconv_folded(jnp.asarray(x), jnp.asarray(fq), JFolded(**fc),
                             stride=stride, padding=padding, fused=fused)
    assert_i8_equal(tops.qconv_folded(t(x), t(fq), TFolded(**fc), stride=stride,
                                      padding=padding, fused=fused), want)


def _planned_conv(rng, kh, kw, cin, lanes, cout):
    """A planned conv's weights as ``plan_layout`` lays them out: w_phys
    (kh*kw*lanes, N') with zero padding lanes, and its packed taps."""
    n = -(-cout // 32) * 32
    f = np.zeros((kh, kw, lanes, n), np.int8)
    f[:, :, :cin, :cout] = _i8(rng, (kh, kw, cin, cout))
    w_phys = f.reshape(kh * kw * lanes, n)
    return w_phys, pack_conv_taps(w_phys, kh, kw, cin)


@pytest.mark.parametrize("kh,kw,cin,lanes,cout", [
    (10, 8, 1, 32, 8), (3, 3, 1, 32, 8), (3, 3, 3, 32, 16), (3, 3, 8, 32, 64),
    (3, 3, 40, 64, 70), (2, 5, 32, 32, 32), (1, 1, 3, 32, 8)])
def test_pack_conv_taps_layout(kh, kw, cin, lanes, cout):
    """Packed row n holds the c_true real lanes of each tap of w_phys's
    column n, tap-major and channel-minor, then zeros up to the next
    multiple of 32 (speech 80 -> 96, conv0 9 -> 32, 360 -> 384)."""
    w_phys, packed = _planned_conv(np.random.default_rng(kh * kw + cin),
                                   kh, kw, cin, lanes, cout)
    k = kh * kw * cin
    n = w_phys.shape[1]
    assert packed.dtype == np.int8 and packed.flags.c_contiguous
    assert packed.shape == (n, -(-k // 32) * 32)
    taps = w_phys.reshape(kh, kw, lanes, n)
    for i in range(kh):
        for j in range(kw):
            tap = (i * kw + j) * cin
            np.testing.assert_array_equal(packed[:, tap:tap + cin],
                                          taps[i, j, :cin, :].T)
    assert not packed[:, k:].any()


#: fused-conv geometries: (batch, H, W, cin, lanes, kh, kw, stride,
#: padding, cout, z_x): speech's 10x8/s2 and conv0's 3x3/s2 (one channel at
#: 32 lanes, SAME), cin 3, 8 and 40 at 32 and 64 lanes, VALID, ragged rows
FUSED_CONVS = [
    (2, 49, 40, 1, 32, 10, 8, 2, "SAME", 8, -5),
    (1, 96, 96, 1, 32, 3, 3, 2, "SAME", 8, 7),
    (3, 11, 9, 3, 32, 3, 3, 1, "SAME", 16, -128),
    (2, 17, 13, 8, 32, 3, 3, 2, "VALID", 64, 3),
    (2, 12, 10, 40, 64, 3, 3, 1, "SAME", 70, -9),
    (1, 7, 7, 40, 64, 5, 3, 2, "VALID", 32, 0),
    (3, 9, 14, 3, 64, 2, 2, 2, "SAME", 32, 100),
]


@pytest.mark.parametrize("geo", FUSED_CONVS)
@pytest.mark.parametrize("fused", FUSED)
def test_qconv_fused_plain_equals_planned_im2col(geo, fused):
    """The fused conv's plain version (the real lanes of each tap, the
    border as z_x, K packed) gives the bits of the planned im2col route
    over the lane-padded input, and counts no launch on the CPU."""
    b, h, w, cin, lanes, kh, kw, s, padding, cout, z_x = geo
    rng = np.random.default_rng(h * w + cin)
    w_phys, packed = _planned_conv(rng, kh, kw, cin, lanes, cout)
    n = w_phys.shape[1]
    c = _consts(rng, n, rng.integers(-8, 9, n).astype(np.int32))
    lo, hi = _bounds(c, fused)
    x = _i8(rng, (b, h, w, lanes))
    x[..., cin:] = 0
    lay = OpLayout("conv", w_phys, c, lo, hi, cout, lanes, (0, 0, 0, n), cin,
                   z_x, np.ascontiguousarray(w_phys.T), packed)
    want = tops.qconv_planned(t(x), lay, kh=kh, kw=kw, stride=(s, s),
                              padding=padding)
    before = mm_mod.conv_launches
    got = mm_mod.qconv_fused(
        t(x), t(packed), *(t(v) for v in c), kh=kh, kw=kw, stride=(s, s),
        pads=tops._border(t(x), kh, kw, (s, s), padding), c_true=cin,
        z_x=z_x, lo=lo, hi=hi, n_true=cout if cout < n else None)
    assert mm_mod.conv_launches == before
    assert_i8_equal(got, want)
    assert not got[..., cout:].any()


# ---------------------------------------------------------------------------
# wrappers reject what the kernels do not take
# ---------------------------------------------------------------------------

def _mm_args(m=64, k=64, n=64):
    """qmatmul's operands: x (M, K), the weight transposed (N, K), consts."""
    rng = np.random.default_rng(0)
    return [t(_i8(rng, (m, k))), t(_i8(rng, (n, k)))] + \
        [t(v) for v in _consts(rng, n, 0)]


@pytest.mark.parametrize("bad", ["x_dtype", "k_quantum", "n_quantum",
                                 "m_zero", "k_mismatch", "const_shape",
                                 "const_dtype", "noncontig"])
def test_qmatmul_wrapper_rejects(bad):
    args = _mm_args()
    if bad == "x_dtype":
        args[0] = args[0].to(torch.int32)
    elif bad == "k_quantum":
        args = _mm_args(k=48)
    elif bad == "n_quantum":
        args = _mm_args(n=48)
    elif bad == "m_zero":
        args = _mm_args(m=0)
    elif bad == "k_mismatch":
        args[1] = args[1][:, :32].contiguous()
    elif bad == "const_shape":
        args[2] = args[2][:10]
    elif bad == "const_dtype":
        args[4] = args[4].to(torch.float32)
    elif bad == "noncontig":
        args[0] = torch.cat([args[0], args[0]], 1)[:, ::2]
    with pytest.raises((ValueError, TypeError)):
        t_qmatmul(*args)


@pytest.mark.parametrize("bad", ["c_not_4", "w_shape", "x_dtype",
                                 "negative_pad", "pad_wider_than_window",
                                 "unread_bottom_pad", "unread_right_pad",
                                 "z_x_range"])
def test_qdwconv_wrapper_rejects(bad):
    """Besides the operands: a pad below zero, a pad as wide as the window
    (an output read only from the border), a bottom or right pad the window
    walk never reads (the output size the pads give disagrees with the
    input's), and a z_x that is no int8."""
    rng = np.random.default_rng(1)
    c = 6 if bad == "c_not_4" else 8
    x, w = t(_i8(rng, (1, 5, 5, c))), t(_i8(rng, (3, 3, c)))
    cst = [t(v) for v in _consts(rng, c, 0)]
    kw = dict(stride=(1, 1))
    if bad == "w_shape":
        w = w[..., :4]
    elif bad == "x_dtype":
        x = x.to(torch.int16)
    elif bad == "negative_pad":
        kw["pads"] = (1, -1, 1, 1)
    elif bad == "pad_wider_than_window":
        kw["pads"] = (3, 0, 0, 0)
    elif bad == "unread_bottom_pad":
        kw = dict(stride=(2, 2), pads=(0, 1, 0, 0))  # 5 + 1 rows, walk reads 5
    elif bad == "unread_right_pad":
        kw = dict(stride=(2, 2), pads=(0, 0, 0, 1))  # 5 + 1 cols, walk reads 5
    elif bad == "z_x_range":
        kw.update(pads=(1, 1, 1, 1), z_x=128)
    with pytest.raises((ValueError, TypeError)):
        t_qdwconv(x, w, *cst, **kw)


@pytest.mark.parametrize("bad", ["x_rank", "x_dtype", "noncontig",
                                 "k_not_packed", "k_lane_padded",
                                 "c_true_zero", "c_true_over_lanes",
                                 "n_quantum", "const_shape", "z_x_range",
                                 "negative_pad", "no_output", "zero_stride"])
def test_qconv_fused_wrapper_rejects(bad):
    """The fused conv refuses what its kernel does not take: a packed K
    that is not round_up(kh*kw*c_true, 32) (the K of the lane-padded
    weight included), real lanes outside the input's, an N that is no
    multiple of 32, a z_x that is no int8, a negative pad, a window that
    leaves no output, and the operands' dtype, shape and contiguity."""
    rng = np.random.default_rng(2)
    w_phys, packed = _planned_conv(rng, 3, 3, 1, 32, 8)
    x = t(_i8(rng, (2, 9, 9, 32)))
    w = t(packed)
    cst = [t(v) for v in _consts(rng, 32, 0)]
    kw = dict(kh=3, kw=3, stride=(2, 2), pads=(0, 1, 0, 1), c_true=1, z_x=4)
    if bad == "x_rank":
        x = x[0]
    elif bad == "x_dtype":
        x = x.to(torch.int16)
    elif bad == "noncontig":
        x = x.transpose(1, 2)
    elif bad == "k_not_packed":
        w = torch.zeros((32, 64), dtype=torch.int8)
    elif bad == "k_lane_padded":
        w = t(np.ascontiguousarray(w_phys.T))
    elif bad == "c_true_zero":
        kw["c_true"] = 0
    elif bad == "c_true_over_lanes":
        kw["c_true"] = 33
    elif bad == "n_quantum":
        w, cst = w[:16].contiguous(), [v[:16] for v in cst]
    elif bad == "const_shape":
        cst[2] = cst[2][:10]
    elif bad == "z_x_range":
        kw["z_x"] = -129
    elif bad == "negative_pad":
        kw["pads"] = (0, -1, 0, 1)
    elif bad == "no_output":
        kw.update(kh=11, pads=(0, 0, 0, 0))
        w = torch.zeros((32, 64), dtype=torch.int8)
    elif bad == "zero_stride":
        kw["stride"] = (0, 2)
    before = mm_mod.conv_launches
    with pytest.raises((ValueError, TypeError)):
        mm_mod.qconv_fused(x, w, *cst, **kw)
    assert mm_mod.conv_launches == before


#: person's 13 depthwise layers at the 32-lane quantum: (unpadded H = W,
#: lanes, stride)
PERSON_DW = [(48, 32, 1), (48, 32, 2), (24, 32, 1), (24, 32, 2), (12, 64, 1),
             (12, 64, 2)] + [(6, 128, 1)] * 5 + [(6, 128, 2), (3, 256, 1)]


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("layer", range(len(PERSON_DW)))
def test_qdwconv_tile(b, layer):
    """``dw_tile`` on person's 13 depthwise layers at buckets 1 and 8: at
    most 256 threads and 48 KB of shared memory a block, channel groups of
    a whole 32-byte sector that divide C (so every staging copy is 16
    bytes), the band no taller than the output, and at least 12 blocks."""
    h, c, s = PERSON_DW[layer]
    (pt, pb), (pl, pr) = same_pads(h, h, 3, 3, (s, s))
    oh = (h + pt + pb - 3) // s + 1
    cg, th, tpg = dw_mod.dw_tile(b, oh, oh, c, 3, 3, s, s)
    assert cg * th * tpg <= dw_mod.MAX_THREADS
    assert dw_mod.dw_smem(cg, th, tpg, 3, 3, s, s) <= 48 * 1024
    assert cg * dw_mod.V == 32 and c % (cg * dw_mod.V) == 0
    assert (cg * dw_mod.V) % 16 == 0
    assert 1 <= th <= oh and 1 <= tpg <= oh
    blocks = dw_mod.dw_blocks(b, oh, oh, c, (cg, th, tpg))
    assert blocks >= 12 * b
    assert blocks == b * -(-oh // th) * -(-oh // tpg) * (c // 32)


@pytest.mark.parametrize("b,h,w,c,kk,s", [
    (8, 95, 95, 8, 3, 1),     # a band of 2 rows: ragged bands and columns
    (1, 96, 96, 8, 3, 2), (2, 12, 11, 32, 5, 2), (1, 200, 200, 512, 3, 1),
    (1, 30, 30, 4, 7, 1)])
def test_qdwconv_tile_bounds(b, h, w, c, kk, s):
    """The tile rule away from person's shapes: the block stays within its
    thread and shared-memory budgets, and the grid covers the output."""
    oh, ow = -(-h // s), -(-w // s)
    cg, th, tpg = dw_mod.dw_tile(b, oh, ow, c, kk, kk, s, s)
    assert cg * th * tpg <= dw_mod.MAX_THREADS
    assert dw_mod.dw_smem(cg, th, tpg, kk, kk, s, s) <= 48 * 1024
    assert c % (cg * dw_mod.V) == 0
    assert -(-oh // th) * th >= oh and -(-ow // tpg) * tpg >= ow
    if (b, h, c) == (8, 95, 8):
        assert (cg, th, tpg) == (2, 2, 64)


# ---------------------------------------------------------------------------
# fmatmul — the float FullyConnected product
# ---------------------------------------------------------------------------

def _float_operands(dtype, m, k, n, w_scale=1.0):
    rng = np.random.default_rng(17)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * w_scale).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return (jnp.asarray(x, jdt), jnp.asarray(w, jdt), t(x).to(tdt),
            t(w).to(tdt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,w_scale", [(8, 16, 8, 1.0), (130, 70, 33, 1.0),
                                           (8, 4000, 4, 0.05)])
def test_fmatmul_matches_reference(dtype, m, k, n, w_scale):
    """The reference's ``test_fmatmul_dtypes`` shapes and the speech model's
    float FC (8 x 4000 x 4, weights of its scale), unpadded, through both
    packages' ``ops.fmatmul`` (JAX: the Pallas kernel in interpret mode)."""
    jx, jw, tx, tw = _float_operands(dtype, m, k, n, w_scale)
    want = np.asarray(jops.fmatmul(jx, jw), np.float32)
    before = mm_mod.fmatmul_launches
    got = tops.fmatmul(tx, tw)
    assert mm_mod.fmatmul_launches == before  # CPU tensors: the plain version
    assert got.dtype == tx.dtype and tuple(got.shape) == (m, n)
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,w_scale", [(128, 128, 128, 1.0),
                                           (128, 4096, 128, 0.05)])
def test_fmatmul_ref_matches_pallas(dtype, m, k, n, w_scale):
    """The plain version against the Pallas kernel at padded shapes. The
    second is the speech model's float FC (8 x 4000 x 4 padded), with its
    weights' scale (normal, sigma 0.05, as ``build_speech`` draws them)."""
    jx, jw, tx, tw = _float_operands(dtype, m, k, n, w_scale)
    want = np.asarray(j_fmatmul(jx, jw, interpret=True), np.float32)
    got = ref.fmatmul_ref(tx, tw)
    assert got.dtype == tx.dtype
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("bad", ["int_dtype", "mixed_dtype", "k_chunk",
                                 "n_chunk", "bf16_k_chunk", "noncontig"])
def test_fmatmul_wrapper_rejects(bad):
    """K and N must fill whole 16-byte rows: multiples of 4 in float32 and
    of 8 in bfloat16 (M is any size: the kernel masks it)."""
    x, w = torch.zeros(65, 64), torch.zeros(64, 64)
    if bad == "int_dtype":
        x, w = x.to(torch.int8), w.to(torch.int8)
    elif bad == "mixed_dtype":
        w = w.to(torch.bfloat16)
    elif bad == "k_chunk":
        x, w = torch.zeros(64, 70), torch.zeros(70, 64)
    elif bad == "n_chunk":
        w = torch.zeros(64, 33)
    elif bad == "bf16_k_chunk":
        x = torch.zeros(64, 12, dtype=torch.bfloat16)
        w = torch.zeros(12, 64, dtype=torch.bfloat16)
    elif bad == "noncontig":
        x = torch.zeros(64, 128)[:, ::2]
    with pytest.raises((ValueError, TypeError)):
        mm_mod.fmatmul(x, w)


@pytest.mark.parametrize("m,k,n,want", [
    (128, 4096, 128, (32, 128)),   # 4 tiles x 32 slices of 4 steps
    (8, 4000, 4, (63, 64)),        # the speech FC: 1 tile, 63 slices
    (128, 128, 128, (1, 128)),     # 4 steps: the ring holds them all
    (130, 72, 36, (1, 96)),
    (1, 33 * 32, 4, (17, 64)),     # the last slice is short
    (64, 160, 64, (3, 64)),        # 5 steps, 1 tile: 3 slices of 2
])
def test_fmatmul_splits(m, k, n, want):
    """fmatmul's K split on a 132-SM card: about one wave of blocks, at
    least 2 K steps a slice, every k in exactly one slice."""
    splits, kslice = mm_mod.fmatmul_splits(m, k, n, 132)
    assert (splits, kslice) == want
    assert kslice % mm_mod.F_STEP == 0
    assert (splits - 1) * kslice < k <= splits * kslice


@pytest.mark.parametrize("m,k,n,want", [
    (18432, 288, 32, (128, 32, 128)), (18432, 1152, 128, (128, 64, 128)),
    (4608, 32, 64, (128, 64, 32)), (9, 256, 256, (64, 64, 128)),
    (1, 256, 32, (128, 32, 128)), (2304, 32, 32, (128, 32, 32)),
    (144, 64, 64, (64, 64, 64))])
def test_qmatmul_block_tile(m, k, n, want):
    """qmatmul's tile: warps of 32 x 32, BN divides N, a K stage of up to
    128 bytes."""
    bm, bn, bk = mm_mod.block_tile(m, k, n)
    assert (bm, bn, bk) == want
    assert n % bn == 0 and bm * bn in (4096, 8192) and bk in (32, 64, 128)


def test_float_fc_kernel_route_matches_reference(tmp_path):
    """A float graph with ``use_kernels`` runs its FullyConnected products on
    ``fmatmul`` (the plain version here) and matches the JAX package's float
    engine within the float32 tolerance, per call and per bucket."""
    from repro.core import CompiledModel as JCompiled
    from repro.core.builder import GraphBuilder
    from repro_torch.core.engine import CompiledModel
    from _torch_parity import carry

    rng = np.random.default_rng(8)
    b = GraphBuilder("float_mlp")
    h = b.input("x", (2, 40))
    for i, (k, n) in enumerate([(40, 70), (70, 3)]):
        h = b.fully_connected(h, rng.normal(0, 0.3, (k, n)).astype("f"),
                              rng.normal(0, 0.3, n).astype("f"),
                              fused="RELU" if i == 0 else "NONE")
    b.output(h)
    jg = b.build()
    tg = carry(jg, tmp_path)
    xs = rng.normal(size=(5, 2, 40)).astype("f")
    jm = JCompiled(jg)
    cm = CompiledModel(tg, device="cpu")
    assert cm.plan is not None and not cm.plan.layouts  # float: unplanned
    np.testing.assert_allclose(cm.predict_q(xs[0]), np.asarray(jm.predict_q(xs[0])),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cm.predict_q_many(xs, max_batch=4),
                               np.asarray(jm.predict_q_many(xs, max_batch=4)),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the kernel-route probe
# ---------------------------------------------------------------------------

def test_can_launch_kernels_reports_why_not_here():
    """No card here: the probe returns (False, reason) and does not raise;
    the answer is cached, and the engine's kernel route on CUDA refuses to
    build with that reason."""
    tops.can_launch_kernels.cache_clear()
    before = tops.probe_launches
    ok, reason = tops.can_launch_kernels()
    assert ok is False and isinstance(reason, str) and reason
    assert len(reason) <= 200
    assert tops.can_launch_kernels() == (ok, reason)
    assert tops.probe_launches == before
