"""Every ``ops_ref`` op of the port against ``repro.core.ops_ref``, in its
quantized (``*_q``), folded and float forms, at the shapes of
``tests/test_core_ops.py`` / ``tests/test_extended_ops.py``.

The JAX side runs under ``jax.jit`` with the activations and weights as
arguments, the form in which the compiled engine runs it (XLA then fuses
``a + b * c``, which the port writes as ``torch.addcmul``).

Tolerances: int8 results are bit-exact, except softmax (±1 LSB: ``exp``
differs between torch and XLA in the last ulp). Float forms use the
reference's float32 tolerance (1e-5): torch and XLA sum convolutions in
another order.
"""
import jax
import numpy as np
import pytest

from repro.core import ops_ref as J
from repro_torch.core import ops_ref as P

from _torch_parity import assert_i8_equal, assert_softmax_close, t

FUSED = ["NONE", "RELU", "RELU6"]
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _jit(fn, *arrays, **static):
    return np.asarray(jax.jit(lambda *a: fn(*a, **static))(*arrays))


def _i8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


def _weighted_qparams(rng, n, per_channel_zw=True):
    s_x, z_x = np.float32(0.02), np.int32(rng.integers(-10, 10))
    s_w = (rng.random(n) * 0.01 + 1e-4).astype(np.float32)
    z_w = (rng.integers(-3, 4, n) if per_channel_zw
           else np.zeros(n)).astype(np.int32)
    return dict(s_x=s_x, z_x=z_x, s_b=(s_x * s_w).astype(np.float32),
                z_b=np.zeros(n, np.int32), s_y=np.float32(0.05),
                z_y=np.int32(rng.integers(-20, 20))), s_w, z_w


def _folded(rng, n, z_x):
    return dict(
        bias_term=(rng.normal(size=n) * 5).astype(np.float32),
        rescale=(rng.random(n) * 0.02 + 1e-4).astype(np.float32),
        w_sum_zx=rng.integers(-5000, 5000, n).astype(np.int32),
        const_off=rng.integers(-100, 100, n).astype(np.int32),
        z_w=rng.integers(-3, 4, n).astype(np.int32),
        z_y=np.asarray(rng.integers(-20, 20), np.int32),
        s_y=np.asarray(0.03, np.float32),
        z_x=np.asarray(z_x, np.int32))


# ---------------------------------------------------------------------------
# FULLY_CONNECTED
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("fused", FUSED)
def test_fully_connected_q_and_folded(seed, fused):
    rng = np.random.default_rng(seed)
    m, k, p = (int(v) for v in rng.integers(1, 25, 3))
    x, w = _i8(rng, (m, k)), _i8(rng, (k, p))
    b = rng.integers(-2000, 2000, p).astype(np.int32)
    common, s_w, z_w = _weighted_qparams(rng, p)
    ref = _jit(lambda x, w, b: J.fully_connected_q(
        x, w, b, s_w=s_w, z_w=z_w, fused=fused, **common), x, w, b)
    assert_i8_equal(P.fully_connected_q(t(x), t(w), t(b), s_w=s_w, z_w=z_w,
                                        fused=fused, **common), ref)
    ref_nob = _jit(lambda x, w: J.fully_connected_q(
        x, w, None, s_w=s_w, z_w=z_w, fused=fused, **common), x, w)
    assert_i8_equal(P.fully_connected_q(t(x), t(w), None, s_w=s_w, z_w=z_w,
                                        fused=fused, **common), ref_nob)
    fc = _folded(rng, p, 0)
    ref = _jit(lambda x, w: J.fully_connected_folded(
        x, w, J.FoldedConsts(**fc), fused), x, w)
    assert_i8_equal(P.fully_connected_folded(t(x), t(w), P.FoldedConsts(**fc),
                                             fused), ref)


@pytest.mark.parametrize("fused", FUSED)
def test_fully_connected_f(fused):
    rng = np.random.default_rng(7)
    x = rng.uniform(-2, 2, (5, 24)).astype(np.float32)
    w = rng.uniform(-1, 1, (24, 13)).astype(np.float32)
    b = rng.uniform(-1, 1, 13).astype(np.float32)
    np.testing.assert_allclose(
        P.fully_connected_f(t(x), t(w), t(b), fused).numpy(),
        _jit(lambda x, w, b: J.fully_connected_f(x, w, b, fused), x, w, b),
        **F32_TOL)


# ---------------------------------------------------------------------------
# CONV_2D / DEPTHWISE_CONV_2D
# ---------------------------------------------------------------------------

CONV_CASES = [(s, pad, fused) for s in [(1, 1), (2, 2)]
              for pad in ["SAME", "VALID"] for fused in FUSED]


@pytest.mark.parametrize("stride,padding,fused", CONV_CASES)
def test_conv2d_q_and_folded(stride, padding, fused):
    rng = np.random.default_rng(11)
    x, f = _i8(rng, (2, 7, 7, 3)), _i8(rng, (3, 3, 3, 4))
    b = rng.integers(-1000, 1000, 4).astype(np.int32)
    common, s_f, z_f = _weighted_qparams(rng, 4)
    geo = dict(stride=stride, padding=padding, fused=fused)
    ref = _jit(lambda x, f, b: J.conv2d_q(x, f, b, s_f=s_f, z_f=z_f, **common,
                                          **geo), x, f, b)
    assert_i8_equal(P.conv2d_q(t(x), t(f), t(b), s_f=s_f, z_f=z_f, **common,
                               **geo), ref)
    fc = _folded(rng, 4, -5)
    ref = _jit(lambda x, f: J.conv2d_folded(x, f, J.FoldedConsts(**fc), **geo),
               x, f)
    assert_i8_equal(P.conv2d_folded(t(x), t(f), P.FoldedConsts(**fc), **geo),
                    ref)


@pytest.mark.parametrize("stride,padding,fused", CONV_CASES)
def test_depthwise_conv2d_q_and_folded(stride, padding, fused):
    rng = np.random.default_rng(12)
    c = 5
    x, w = _i8(rng, (1, 8, 8, c)), _i8(rng, (3, 3, c, 1))
    b = rng.integers(-500, 500, c).astype(np.int32)
    common, s_w, z_w = _weighted_qparams(rng, c)
    geo = dict(stride=stride, padding=padding, fused=fused)
    ref = _jit(lambda x, w, b: J.depthwise_conv2d_q(
        x, w, b, s_w=s_w, z_w=z_w, **common, **geo), x, w, b)
    assert_i8_equal(P.depthwise_conv2d_q(t(x), t(w), t(b), s_w=s_w, z_w=z_w,
                                         **common, **geo), ref)
    fc = _folded(rng, c, 7)
    ref = _jit(lambda x, w: J.depthwise_conv2d_folded(
        x, w, J.FoldedConsts(**fc), **geo), x, w)
    assert_i8_equal(P.depthwise_conv2d_folded(t(x), t(w), P.FoldedConsts(**fc),
                                              **geo), ref)


@pytest.mark.parametrize("stride,padding,fused", CONV_CASES[::3])
def test_conv_float_forms(stride, padding, fused):
    rng = np.random.default_rng(13)
    x = rng.normal(size=(2, 7, 7, 3)).astype(np.float32)
    f = rng.normal(0, 0.4, (3, 3, 3, 4)).astype(np.float32)
    fb = rng.normal(size=4).astype(np.float32)
    geo = dict(stride=stride, padding=padding, fused=fused)
    np.testing.assert_allclose(
        P.conv2d_f(t(x), t(f), t(fb), **geo).numpy(),
        _jit(lambda x, f, b: J.conv2d_f(x, f, b, **geo), x, f, fb), **F32_TOL)
    w = rng.normal(0, 0.4, (3, 3, 3, 1)).astype(np.float32)
    wb = rng.normal(size=3).astype(np.float32)
    np.testing.assert_allclose(
        P.depthwise_conv2d_f(t(x), t(w), t(wb), **geo).numpy(),
        _jit(lambda x, w, b: J.depthwise_conv2d_f(x, w, b, **geo), x, w, wb),
        **F32_TOL)


def test_same_pads_and_pad_input_q():
    for h, w, k, s in [(7, 7, 3, 1), (96, 96, 3, 2), (49, 40, 10, 2),
                       (9, 9, 5, 2)]:
        assert P.same_pads(h, w, k, k, (s, s)) == J.same_pads(h, w, k, k, (s, s))
    x = _i8(np.random.default_rng(0), (2, 9, 8, 3))
    assert_i8_equal(P.pad_input_q(t(x), 3, 3, (2, 2), "SAME", np.int32(-7)),
                    J.pad_input_q(x, 3, 3, (2, 2), "SAME", np.int32(-7)))


# ---------------------------------------------------------------------------
# Pools, ADD, PAD, activations, softmax
# ---------------------------------------------------------------------------

def _io(rng):
    return dict(s_x=np.float32(0.0731), z_x=np.int32(rng.integers(-10, 10)),
                s_y=np.float32(0.0213), z_y=np.int32(rng.integers(-20, 20)))


@pytest.mark.parametrize("window,stride", [((3, 3), (3, 3)), ((2, 2), (1, 1)),
                                           ((3, 3), (2, 2))])
@pytest.mark.parametrize("padding", ["VALID", "SAME"])
def test_pools(window, stride, padding):
    rng = np.random.default_rng(14)
    x = _i8(rng, (2, 9, 8, 6))
    geo = dict(window=window, stride=stride, padding=padding)
    io = _io(rng)
    for jf, pf in [(J.average_pool2d_q, P.average_pool2d_q),
                   (J.max_pool2d_q, P.max_pool2d_q)]:
        assert_i8_equal(pf(t(x), **geo, **io),
                        _jit(lambda x: jf(x, **geo, **io), x))
    xf = rng.normal(size=(2, 9, 8, 6)).astype(np.float32)
    for jf, pf in [(J.average_pool2d_f, P.average_pool2d_f),
                   (J.max_pool2d_f, P.max_pool2d_f)]:
        np.testing.assert_allclose(pf(t(xf), **geo).numpy(),
                                   _jit(lambda x: jf(x, **geo), xf), **F32_TOL)


@pytest.mark.parametrize("fused", FUSED)
def test_add(fused):
    rng = np.random.default_rng(15)
    a, b = _i8(rng, (2, 5, 5, 4)), _i8(rng, (2, 5, 5, 4))
    qp = dict(s_a=np.float32(0.04), z_a=np.int32(3), s_b=np.float32(0.031),
              z_b=np.int32(-9), s_y=np.float32(0.05), z_y=np.int32(4))
    assert_i8_equal(P.add_q(t(a), t(b), fused=fused, **qp),
                    _jit(lambda a, b: J.add_q(a, b, fused=fused, **qp), a, b))
    af, bf = (rng.normal(size=(3, 4)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(P.add_f(t(af), t(bf), fused).numpy(),
                               _jit(lambda a, b: J.add_f(a, b, fused), af, bf),
                               **F32_TOL)


def test_pad():
    rng = np.random.default_rng(16)
    x = _i8(rng, (1, 2, 3, 2))
    pads = ((0, 0), (1, 2), (2, 1), (0, 1))
    assert_i8_equal(P.pad_q(t(x), pads=pads, z_x=np.int32(-5)),
                    J.pad_q(x, pads=pads, z_x=np.int32(-5)))
    xf = rng.normal(size=(1, 2, 3, 2)).astype(np.float32)
    np.testing.assert_array_equal(P.pad_f(t(xf), pads=pads).numpy(),
                                  np.asarray(J.pad_f(xf, pads=pads)))


@pytest.mark.parametrize("z", [(10, -20), (-30, -128), (0, 5)])
def test_relu_relu6(z):
    x = np.arange(-128, 128, dtype=np.int8)
    for s_x, s_y in [(0.1, 0.1), (0.06, 0.03), (0.0731, 0.0213)]:
        qp = dict(s_x=np.float32(s_x), z_x=np.int32(z[0]),
                  s_y=np.float32(s_y), z_y=np.int32(z[1]))
        for jf, pf in [(J.relu_q, P.relu_q), (J.relu6_q, P.relu6_q)]:
            assert_i8_equal(pf(t(x), **qp), _jit(lambda x: jf(x, **qp), x))
    xf = np.linspace(-8, 8, 101).astype(np.float32)
    np.testing.assert_array_equal(P.relu_f(t(xf)).numpy(), np.asarray(J.relu_f(xf)))
    np.testing.assert_array_equal(P.relu6_f(t(xf)).numpy(), np.asarray(J.relu6_f(xf)))


@pytest.mark.parametrize("n", [2, 5, 16])
@pytest.mark.parametrize("axis", [-1, 0])
def test_softmax(n, axis):
    rng = np.random.default_rng(n)
    x = _i8(rng, (3, n))
    qp = dict(s_x=np.float32(0.05), z_x=np.int32(0), s_y=np.float32(1 / 256),
              z_y=np.int32(-128))
    assert_softmax_close(P.softmax_q(t(x), axis=axis, **qp),
                         _jit(lambda x: J.softmax_q(x, axis=axis, **qp), x))
    xf = rng.normal(size=(3, n)).astype(np.float32)
    np.testing.assert_allclose(P.softmax_f(t(xf), axis=axis).numpy(),
                               _jit(lambda x: J.softmax_f(x, axis=axis), xf),
                               **F32_TOL)


def test_clamp_bounds_and_round_up():
    rng = np.random.default_rng(17)
    for _ in range(5):
        fc = _folded(rng, 3, 1)
        for fused in FUSED:
            assert P.clamp_bounds(P.FoldedConsts(**fc), fused) == \
                J.clamp_bounds(J.FoldedConsts(**fc), fused)
    assert [P.round_up(v, 128) for v in (1, 128, 129, 1152)] == \
        [J.round_up(v, 128) for v in (1, 128, 129, 1152)]
    assert P.MXU_LANES == J.MXU_LANES
