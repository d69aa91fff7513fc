"""Runtime operator math — the port of ``repro.core.ops_ref`` to PyTorch.

Each function is the *kernel* half of a MicroFlow operator (Fig. 7): the
unfolded ``*_q`` forms compute every term of Eqs. (3), (6), (9), (12), (14),
(16), (18) at call time, the ``*_folded`` forms take the compile-time
:class:`FoldedConsts` (Eq. (4) and friends), and the ``*_f`` forms are the
float graph that calibration runs.

Layouts and conventions are the JAX package's: NHWC activations, HWIO
filters, int8 activations, per-channel int8 weights, int32 biases.

Bit-exactness notes (the reference's contract is bit-exact int8):

* Integer contractions are exact: int32 on the CPU, float64 on CUDA, where
  torch has no integer matmul (every partial sum is an integer far below
  2**53, so float64 is exact in any summation order).
* Every ``a + b * c`` in float is written ``torch.addcmul(a, b, c)``: XLA
  contracts that pattern into one fused multiply-add under ``jit``, and
  ``addcmul`` rounds once where ``a + b * c`` rounds twice.
* Clamp bounds are float32 tensors, never Python floats.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

I8_MIN, I8_MAX = -128, 127

# MXU lane width of the TPU — the layout quantum the reference plan uses and
# the default quantum of the port's ``preprocess.plan_layout``.
MXU_LANES = 128


def round_up(x: int, m: int) -> int:
    """Round x up to a multiple of m (lane/tile alignment)."""
    return -(-x // m) * m


def _as(v, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """A constant (numpy array, scalar or tensor) as a tensor on ``like``'s
    device — a no-op for a tensor that is already there. A one-element host
    constant (the activation qparams of pools, softmax and activations) is
    filled in on the device, not copied from the host: a host-to-device
    copy cannot be captured in a CUDA graph, a fill can."""
    if torch.is_tensor(v):
        return torch.as_tensor(v, dtype=dtype, device=like.device)
    host = torch.as_tensor(v, dtype=dtype)  # the value and dtype, on the host
    if host.numel() != 1:
        return host.to(like.device)  # per-channel: the reference forms only
    return torch.empty(host.shape, dtype=host.dtype,
                       device=like.device).fill_(host.reshape(()))


@dataclasses.dataclass(frozen=True)
class FoldedConsts:
    """The compile-time constants of Eq. (4)/(7)/(10)/(13).

    bias_term : z_Y + (s_b/s_Y)(b_q - z_b)           float32 (per out channel)
    rescale   : (s_X s_W)/s_Y                         float32 (per out channel)
    w_sum_zx  : z_X * Σ W_q                           int32   (per out channel)
    const_off : n z_X z_W  (count * z_X * z_W)        int32   (per out channel)
    z_w       : weight zero point (input-dependent z_W ΣX term)
    z_y       : output zero point (fused activation clamping)
    s_y       : output scale      (fused RELU6 upper bound)
    z_x       : input zero point  (SAME border fill)

    Fields are numpy arrays as ``preprocess.fold_weighted_op`` makes them,
    or, after :meth:`to`, tensors on a device (:data:`HOST_FIELDS`
    excepted).
    """

    bias_term: object
    rescale: object
    w_sum_zx: object
    const_off: object
    z_w: object
    z_y: object
    s_y: object
    z_x: object

    #: Per-tensor scalars that are read on the host (clamp bounds, the
    #: SAME border's fill value): :meth:`to` leaves them where they are, so
    #: no forward reads a device scalar back (a sync, which a CUDA graph
    #: capture refuses).
    HOST_FIELDS = ("z_y", "s_y", "z_x")

    def to(self, device) -> "FoldedConsts":
        """The per-channel constants as tensors on ``device`` (done once,
        when an engine is built); :data:`HOST_FIELDS` stay on the host."""
        return FoldedConsts(*(
            getattr(self, f.name) if f.name in self.HOST_FIELDS
            else torch.as_tensor(getattr(self, f.name), device=device)
            for f in dataclasses.fields(self)))


def _saturate_i8(y: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(y), I8_MIN, I8_MAX).to(torch.int8)


def _fused_bounds(fused: str, z_y, s_y, like: torch.Tensor):
    """Quantized clamp bounds for fused activations (Eqs. (15), (17)),
    computed in float32 arithmetic as the reference's plain route does. The
    bounds are made on ``like``'s device (``torch.full``, no host-to-device
    copy), so the op can be captured in a CUDA graph."""
    lo = torch.full((), float("-inf"), dtype=torch.float32, device=like.device)
    hi = torch.full((), float("inf"), dtype=torch.float32, device=like.device)
    if fused in ("RELU", "RELU6"):
        lo = _as(z_y, like).to(torch.float32)
    if fused == "RELU6":
        # a tensor divided by a tensor: ``6.0 / t`` is ``t.reciprocal() *
        # 6.0`` in torch, two roundings where the reference has one
        s = _as(s_y, like, torch.float32)
        hi = lo + torch.full_like(s, 6.0) / s
    elif fused not in ("NONE", "RELU"):
        raise ValueError(fused)
    return lo, hi


def clamp_bounds(fc: FoldedConsts, fused: str):
    """Static (python float, i.e. float64) clamp bounds of a fused
    activation — the compile-time form of :func:`_fused_bounds` that the
    kernel routes and the layout planner use."""
    z_y = float(fc.z_y)
    s_y = float(fc.s_y)
    if fused == "RELU":
        return z_y, float("inf")
    if fused == "RELU6":
        return z_y, z_y + 6.0 / s_y
    if fused == "NONE":
        return float("-inf"), float("inf")
    raise ValueError(fused)


def fused_bounds_f32(fc: FoldedConsts, fused: str):
    """The float32 values of :func:`_fused_bounds` as Python floats, computed
    on the host: the bounds the paged kernel route hands its kernel, so that
    it clamps exactly where the plain paged route does."""
    cpu = torch.empty(0)
    lo, hi = _fused_bounds(fused, torch.as_tensor(fc.z_y).cpu(),
                           torch.as_tensor(fc.s_y).cpu(), cpu)
    return float(lo), float(hi)


def _apply_fused_float(y, fused: str):
    if fused == "RELU":
        return torch.clamp(y, min=0.0)
    if fused == "RELU6":
        return torch.clamp(y, 0.0, 6.0)
    if fused == "NONE":
        return y
    raise ValueError(fused)


def _no_tf32(x: torch.Tensor) -> None:
    # float32 convolutions go through cuDNN in TF32 by default on the card;
    # calibration needs full float32, like the reference.
    if x.is_cuda:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def imatmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 matrix product of two integer tensors. CUDA has no
    integer matmul in torch, so there it runs in float64, which is exact
    here: |acc| <= 128 * 128 * K with K <= 1152 on every model, far below
    2**53."""
    if a.is_cuda:
        return torch.matmul(a.double(), b.double()).to(torch.int32)
    return torch.matmul(a.to(torch.int32), b.to(torch.int32))


def _requant(inner, bias_term, rescale, fused, z_y, s_y):
    """Shared epilogue: ``y = bias + rescale * f32(inner)`` with one
    rounding, fused clamp, round half to even, saturate."""
    y = torch.addcmul(_as(bias_term, inner, torch.float32),
                      _as(rescale, inner, torch.float32),
                      inner.to(torch.float32))
    lo, hi = _fused_bounds(fused, z_y, s_y, inner)
    return _saturate_i8(torch.clamp(y, lo, hi))


def _bias_term(b_q, s_b, z_b, s_y, z_y, like):
    z_y_f = _as(z_y, like).to(torch.float32)
    if b_q is None:
        return z_y_f
    # numpy float32 host math, as the reference's s_b / s_y
    ratio = np.asarray(s_b, np.float32) / np.asarray(s_y, np.float32)
    return torch.addcmul(z_y_f, _as(ratio, like),
                         b_q.to(torch.float32) - _as(z_b, like).to(torch.float32))


# ---------------------------------------------------------------------------
# FullyConnected — Eq. (3)
# ---------------------------------------------------------------------------

def fully_connected_q(x_q, w_q, b_q, *, s_x, z_x, s_w, z_w, s_b, z_b, s_y,
                      z_y, fused: str = "NONE"):
    """Unfolded Eq. (3): every constant term computed at call time."""
    x32 = x_q.to(torch.int32)
    w32 = w_q.to(torch.int32)
    n = x_q.shape[-1]
    acc = imatmul(x32, w32)
    sum_x = x32.sum(-1, keepdim=True, dtype=torch.int32)
    sum_w = w32.sum(0, dtype=torch.int32)
    z_x = _as(z_x, x32, torch.int32)
    z_w = _as(z_w, x32, torch.int32)
    inner = acc - z_w * sum_x - z_x * sum_w + n * z_x * z_w
    bias_term = _bias_term(b_q, s_b, z_b, s_y, z_y, x32)
    rescale = (np.asarray(s_x, np.float32) * s_w) / s_y
    return _requant(inner, bias_term, rescale, fused, z_y, s_y)


def fully_connected_folded(x_q, w_q, fc: FoldedConsts, fused: str = "NONE"):
    """Folded Eq. (3): only the input-dependent terms remain (Eq. (4))."""
    x32 = x_q.to(torch.int32)
    acc = imatmul(x32, w_q)
    sum_x = x32.sum(-1, keepdim=True, dtype=torch.int32)
    inner = (acc - _as(fc.z_w, x32) * sum_x - _as(fc.w_sum_zx, x32)
             + _as(fc.const_off, x32))
    return _requant(inner, fc.bias_term, fc.rescale, fused, fc.z_y, fc.s_y)


def fully_connected_f(x, w, b, fused: str = "NONE", matmul=None):
    """Float path, Eq. (2). ``matmul`` replaces ``x @ w`` (the kernel
    route passes ``kernels.ops.fmatmul``)."""
    _no_tf32(x)
    y = x @ w if matmul is None else matmul(x, w)
    if b is not None:
        y = y + b
    return _apply_fused_float(y, fused)


# ---------------------------------------------------------------------------
# Conv2D — Eq. (6).  NHWC inputs, HWIO filters.
# ---------------------------------------------------------------------------

def same_pads(h, w, kh, kw, stride):
    """TF-style SAME padding amounts per spatial dim."""
    sh, sw = stride
    oh, ow = -(-h // sh), -(-w // sw)
    ph = max((oh - 1) * sh + kh - h, 0)
    pw = max((ow - 1) * sw + kw - w, 0)
    return (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)


def _pad_hw(x, pads_hw, value):
    (pt, pb), (pl, pr) = pads_hw
    return F.pad(x, (0, 0, pl, pr, pt, pb), value=value)


def pad_input_q(x_q, kh, kw, stride, padding, z_x):
    """Pad a quantized NHWC input so the conv can run VALID.

    Padded entries carry the INPUT ZERO POINT — the quantized value of real
    zero — so that (X_q - z_X) vanishes on the border and the compile-time
    folded ΣW term (Eqs. 7/10) stays exact for every output position.
    """
    if padding == "VALID":
        return x_q
    pads = same_pads(x_q.shape[1], x_q.shape[2], kh, kw, stride)
    return _pad_hw(x_q, pads, int(z_x))


def taps(x, kh: int, kw: int, stride):
    """The kh*kw strided views of a VALID window walk over NHWC ``x``, in
    tap-major order: each is (B, OH, OW, C)."""
    _, H, W, _ = x.shape
    sh, sw = stride
    oh = (H - kh) // sh + 1
    ow = (W - kw) // sw + 1
    return [x[:, i:i + (oh - 1) * sh + 1:sh, j:j + (ow - 1) * sw + 1:sw, :]
            for i in range(kh) for j in range(kw)]


def patches(x, kh, kw, stride):
    """(B, OH, OW, kh*kw*C) im2col rows of a VALID conv, tap-major /
    channel-minor, matching ``filter.reshape(kh*kw*C, Cout)`` for HWIO."""
    t = taps(x, kh, kw, stride)
    return torch.cat(t, dim=-1) if len(t) > 1 else t[0]


def _conv_acc(x32, f, stride):
    """Exact ΣΣΣ X F and ΣΣΣ X of a VALID conv: (B,OH,OW,Cout), (B,OH,OW,1)."""
    kh, kw, cin, cout = f.shape
    p = patches(x32, kh, kw, stride)
    acc = imatmul(p.reshape(-1, kh * kw * cin), f.reshape(kh * kw * cin, cout))
    sum_x = p.sum(-1, keepdim=True, dtype=torch.int32)
    return acc.reshape(p.shape[:3] + (cout,)), sum_x


def conv2d_q(x_q, f_q, b_q, *, stride, padding, s_x, z_x, s_f, z_f, s_b, z_b,
             s_y, z_y, fused: str = "NONE"):
    kh, kw, cin, cout = f_q.shape
    x32 = pad_input_q(x_q, kh, kw, stride, padding, z_x).to(torch.int32)
    f32 = f_q.to(torch.int32)
    count = kh * kw * cin                       # m·n·c in Eq. (6)
    acc, sum_x = _conv_acc(x32, f32, stride)
    sum_f = f32.sum((0, 1, 2), dtype=torch.int32)
    z_x = _as(z_x, x32, torch.int32)
    z_f = _as(z_f, x32, torch.int32)
    inner = acc - z_f * sum_x - z_x * sum_f + count * z_x * z_f
    bias_term = _bias_term(b_q, s_b, z_b, s_y, z_y, x32)
    rescale = (np.asarray(s_x, np.float32) * s_f) / s_y
    return _requant(inner, bias_term, rescale, fused, z_y, s_y)


def conv2d_folded(x_q, f_q, fc: FoldedConsts, *, stride, padding,
                  fused: str = "NONE"):
    kh, kw, _, _ = f_q.shape
    x32 = pad_input_q(x_q, kh, kw, stride, padding, fc.z_x).to(torch.int32)
    acc, sum_x = _conv_acc(x32, f_q.to(torch.int32), stride)
    inner = (acc - _as(fc.z_w, x32) * sum_x - _as(fc.w_sum_zx, x32)
             + _as(fc.const_off, x32))
    return _requant(inner, fc.bias_term, fc.rescale, fused, fc.z_y, fc.s_y)


def _conv_f(x, f_hwio, stride, padding, groups=1):
    _no_tf32(x)
    kh, kw = f_hwio.shape[:2]
    if padding == "SAME":
        x = _pad_hw(x, same_pads(x.shape[1], x.shape[2], kh, kw, stride), 0.0)
    y = F.conv2d(x.permute(0, 3, 1, 2), f_hwio.permute(3, 2, 0, 1),
                 stride=tuple(stride), groups=groups)
    return y.permute(0, 2, 3, 1)


def conv2d_f(x, f, b, *, stride, padding, fused: str = "NONE"):
    y = _conv_f(x, f, stride, padding)
    if b is not None:
        y = y + b
    return _apply_fused_float(y, fused)


# ---------------------------------------------------------------------------
# DepthwiseConv2D — Eq. (9).  Filters (kh, kw, c, 1).
# ---------------------------------------------------------------------------

def dw_acc(x32, w32, stride):
    """Exact per-channel ΣΣ X W and ΣΣ X of a VALID depthwise conv;
    ``w32`` is (kh, kw, C)."""
    kh, kw, _ = w32.shape
    acc = sum_x = None
    for t, (i, j) in zip(taps(x32, kh, kw, stride),
                         [(i, j) for i in range(kh) for j in range(kw)]):
        acc = t * w32[i, j] if acc is None else acc + t * w32[i, j]
        sum_x = t if sum_x is None else sum_x + t
    return acc, sum_x


def depthwise_conv2d_q(x_q, w_q, b_q, *, stride, padding, s_x, z_x, s_w, z_w,
                       s_b, z_b, s_y, z_y, fused: str = "NONE"):
    kh, kw, c, mult = w_q.shape
    if mult != 1:
        raise ValueError("depth multiplier 1 only")
    x32 = pad_input_q(x_q, kh, kw, stride, padding, z_x).to(torch.int32)
    w32 = w_q[..., 0].to(torch.int32)
    count = kh * kw                                     # m·n in Eq. (9)
    acc, sum_x = dw_acc(x32, w32, stride)
    sum_w = w32.sum((0, 1), dtype=torch.int32)
    z_x = _as(z_x, x32, torch.int32)
    z_w = _as(z_w, x32, torch.int32)
    inner = acc - z_w * sum_x - z_x * sum_w + count * z_x * z_w
    bias_term = _bias_term(b_q, s_b, z_b, s_y, z_y, x32)
    rescale = (np.asarray(s_x, np.float32) * s_w) / s_y
    return _requant(inner, bias_term, rescale, fused, z_y, s_y)


def depthwise_conv2d_folded(x_q, w_q, fc: FoldedConsts, *, stride, padding,
                            fused: str = "NONE"):
    kh, kw, _, _ = w_q.shape
    x32 = pad_input_q(x_q, kh, kw, stride, padding, fc.z_x).to(torch.int32)
    acc, sum_x = dw_acc(x32, w_q[..., 0].to(torch.int32), stride)
    inner = (acc - _as(fc.z_w, x32) * sum_x - _as(fc.w_sum_zx, x32)
             + _as(fc.const_off, x32))
    return _requant(inner, fc.bias_term, fc.rescale, fused, fc.z_y, fc.s_y)


def depthwise_conv2d_f(x, w, b, *, stride, padding, fused: str = "NONE"):
    # HWIO with feature groups: filter (kh, kw, 1, c)
    y = _conv_f(x, w.permute(0, 1, 3, 2), stride, padding, groups=x.shape[-1])
    if b is not None:
        y = y + b
    return _apply_fused_float(y, fused)


# ---------------------------------------------------------------------------
# AveragePool2D — Eq. (12)
# ---------------------------------------------------------------------------

def _window_pad(x, window, stride, padding, value):
    if padding == "VALID":
        return x
    return _pad_hw(x, same_pads(x.shape[1], x.shape[2], *window, stride),
                   value)


def _pool_sum_and_count(x, window, stride, padding):
    """Window sums (in ``x``'s dtype) and the count of real entries in each
    window (SAME borders count only the real ones, like reduce_window)."""
    wh, ww = window
    ones = torch.ones(x.shape[:3] + (1,), dtype=x.dtype, device=x.device)
    sums = sum(taps(_window_pad(x, window, stride, padding, 0), wh, ww, stride))
    counts = sum(taps(_window_pad(ones, window, stride, padding, 0), wh, ww,
                      stride))
    return sums, counts


def average_pool2d_q(x_q, *, window, stride, padding, s_x, z_x, s_y, z_y,
                     fused: str = "NONE"):
    sums, counts = _pool_sum_and_count(x_q.to(torch.int32), window, stride,
                                       padding)
    mean = sums.to(torch.float32) / counts.to(torch.float32)
    return _affine_requant(mean, s_x, z_x, s_y, z_y, fused)


def average_pool2d_f(x, *, window, stride, padding, fused: str = "NONE"):
    sums, counts = _pool_sum_and_count(x.to(torch.float32), window, stride,
                                       padding)
    return _apply_fused_float(sums / counts, fused)


def _affine_requant(v_f32, s_x, z_x, s_y, z_y, fused):
    """y_q = z_y + (s_x/s_y)(v - z_x), clamped and saturated (Eq. (12))."""
    ratio = np.asarray(s_x, np.float32) / np.asarray(s_y, np.float32)
    y = torch.addcmul(_as(z_y, v_f32).to(torch.float32), _as(ratio, v_f32),
                      v_f32 - _as(z_x, v_f32).to(torch.float32))
    lo, hi = _fused_bounds(fused, z_y, s_y, v_f32)
    return _saturate_i8(torch.clamp(y, lo, hi))


# ---------------------------------------------------------------------------
# MaxPool2D — max commutes with the (monotone) affine quantization map.
# ---------------------------------------------------------------------------

def _window_max(x, window, stride, padding, init):
    t = taps(_window_pad(x, window, stride, padding, init), *window, stride)
    out = t[0]
    for v in t[1:]:
        out = torch.maximum(out, v)
    return out


def max_pool2d_q(x_q, *, window, stride, padding, s_x, z_x, s_y, z_y,
                 fused: str = "NONE"):
    mx = _window_max(x_q.to(torch.int32), window, stride, padding, I8_MIN)
    return _affine_requant(mx.to(torch.float32), s_x, z_x, s_y, z_y, fused)


def max_pool2d_f(x, *, window, stride, padding, fused: str = "NONE"):
    return _apply_fused_float(
        _window_max(x, window, stride, padding, float("-inf")), fused)


# ---------------------------------------------------------------------------
# ADD (residual):  y_q = z_y + (s_a/s_y)(a_q - z_a) + (s_b/s_y)(b_q - z_b)
# ---------------------------------------------------------------------------

def add_q(a_q, b_q, *, s_a, z_a, s_b, z_b, s_y, z_y, fused: str = "NONE"):
    s_y32 = np.asarray(s_y, np.float32)
    ra = np.asarray(s_a, np.float32) / s_y32
    rb = np.asarray(s_b, np.float32) / s_y32
    y = torch.addcmul(_as(z_y, a_q).to(torch.float32), _as(ra, a_q),
                      a_q.to(torch.float32) - _as(z_a, a_q).to(torch.float32))
    y = torch.addcmul(y, _as(rb, a_q),
                      b_q.to(torch.float32) - _as(z_b, a_q).to(torch.float32))
    lo, hi = _fused_bounds(fused, z_y, s_y, a_q)
    return _saturate_i8(torch.clamp(y, lo, hi))


def add_f(a, b, fused: str = "NONE"):
    return _apply_fused_float(a + b, fused)


# ---------------------------------------------------------------------------
# PAD — quantized zero is the zero point (see pad_input_q)
# ---------------------------------------------------------------------------

def _torch_pads(pads):
    return tuple(int(v) for lo_hi in reversed(tuple(pads)) for v in lo_hi)


def pad_q(x_q, *, pads, z_x):
    return F.pad(x_q, _torch_pads(pads), value=int(z_x))


def pad_f(x, *, pads):
    return F.pad(x, _torch_pads(pads), value=0.0)


# ---------------------------------------------------------------------------
# Standalone activations — Eqs. (14), (16), (18)
# ---------------------------------------------------------------------------

def _relu_core(x_q, s_x, z_x, s_y, z_y):
    ratio = np.asarray(s_x, np.float32) / np.asarray(s_y, np.float32)
    z_y_f = _as(z_y, x_q).to(torch.float32)
    lin = torch.addcmul(z_y_f, _as(ratio, x_q),
                        x_q.to(torch.float32) - _as(z_x, x_q).to(torch.float32))
    return torch.where(x_q < _as(z_x, x_q), z_y_f, lin)


def relu_q(x_q, *, s_x, z_x, s_y, z_y):
    """Eq. (14)."""
    return _saturate_i8(_relu_core(x_q, s_x, z_x, s_y, z_y))


def relu6_q(x_q, *, s_x, z_x, s_y, z_y):
    """Eq. (16)."""
    # host float32 arithmetic, as the reference's numpy scalars
    upper_in = np.asarray(z_x, np.int32) + np.float32(6.0) / np.asarray(s_x, np.float32)
    top = np.asarray(z_y, np.int32) + np.float32(6.0) / np.asarray(s_y, np.float32)
    y = torch.where(x_q.to(torch.float32) >= _as(upper_in, x_q, torch.float32),
                    _as(top, x_q, torch.float32),
                    _relu_core(x_q, s_x, z_x, s_y, z_y))
    return _saturate_i8(y)


def softmax_q(x_q, *, s_x, z_x, s_y, z_y, axis=-1):
    """Eq. (18) — z_x cancels (Appendix A.6); computed with a max-shift.
    ``exp`` differs from XLA's in the last ulp, so outputs may differ from
    the reference by one LSB."""
    x = _as(s_x, x_q, torch.float32) * x_q.to(torch.float32)
    x = x - torch.amax(x, dim=axis, keepdim=True)
    e = torch.exp(x)
    p = e / torch.sum(e, dim=axis, keepdim=True)
    y = _as(z_y, x_q).to(torch.float32) + p / _as(s_y, x_q, torch.float32)
    return _saturate_i8(y)


def relu_f(x):
    return torch.clamp(x, min=0.0)


def relu6_f(x):
    return torch.clamp(x, 0.0, 6.0)


def softmax_f(x, axis=-1):
    return torch.softmax(x, dim=axis)
