"""The kernels' plain versions and wrappers against the JAX package's Pallas
kernels, run as the JAX tests run them on the CPU (``interpret=True``).

Every comparison is bit-exact int8: the plain versions compute the
integer sums exactly and fuse the epilogue's multiply-add as the kernels
do. On CPU tensors the wrappers must take the plain version (and count no
launch); they must raise on operands the CUDA kernels do not take.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ops_ref import FoldedConsts as JFolded
from repro.kernels import ops as jops
from repro.kernels.qconv import im2col_q as j_im2col
from repro.kernels.qdwconv import qdwconv as j_qdwconv
from repro.kernels.qmatmul import qmatmul as j_qmatmul
from repro_torch.core.ops_ref import FoldedConsts as TFolded, clamp_bounds
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
    assert_i8_equal(t_qmatmul(t(x), t(w), *(t(v) for v in c), lo=lo, hi=hi,
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


# ---------------------------------------------------------------------------
# wrappers reject what the kernels do not take
# ---------------------------------------------------------------------------

def _mm_args(m=64, k=64, n=64):
    rng = np.random.default_rng(0)
    return [t(_i8(rng, (m, k))), t(_i8(rng, (k, n)))] + \
        [t(v) for v in _consts(rng, n, 0)]


@pytest.mark.parametrize("bad", ["x_dtype", "m_tile", "k_mismatch",
                                 "const_shape", "const_dtype", "noncontig"])
def test_qmatmul_wrapper_rejects(bad):
    args = _mm_args()
    if bad == "x_dtype":
        args[0] = args[0].to(torch.int32)
    elif bad == "m_tile":
        args = _mm_args(m=65)
    elif bad == "k_mismatch":
        args[1] = args[1][:32]
    elif bad == "const_shape":
        args[2] = args[2][:10]
    elif bad == "const_dtype":
        args[4] = args[4].to(torch.float32)
    elif bad == "noncontig":
        args[0] = torch.cat([args[0], args[0]], 1)[:, ::2]
    with pytest.raises((ValueError, TypeError)):
        t_qmatmul(*args)


@pytest.mark.parametrize("bad", ["c_not_4", "w_shape", "x_dtype"])
def test_qdwconv_wrapper_rejects(bad):
    rng = np.random.default_rng(1)
    c = 6 if bad == "c_not_4" else 8
    x, w = t(_i8(rng, (1, 5, 5, c))), t(_i8(rng, (3, 3, c)))
    cst = [t(v) for v in _consts(rng, c, 0)]
    if bad == "w_shape":
        w = w[..., :4]
    elif bad == "x_dtype":
        x = x.to(torch.int16)
    with pytest.raises((ValueError, TypeError)):
        t_qdwconv(x, w, *cst, stride=(1, 1))
