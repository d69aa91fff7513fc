"""Quantized Conv2D via im2col on the qmatmul kernel — Eq. (7).

Port of ``repro.kernels.qconv``. As in the JAX package, im2col is plain
tensor code (torch here, XLA there) and the contraction with the folded
epilogue is the hand-written ``qmatmul`` kernel. Each output position's
receptive field becomes one row of an (M, K) = (B·OH·OW, kh·kw·C) int8
matrix (tap-major / channel-minor, matching ``filter.reshape(kh*kw*C,
Cout)`` for HWIO filters). Zero K padding adds nothing to ΣXW or ΣX, so
the result is exact after slicing; the kernel masks ragged rows, so M is
not padded. The 1×1/stride-1 case (the 13 pointwise convs of MobileNetV1)
is a pure reshape.

This is the per-call route's conv (``ops.qconv_folded``) and, on CPU
tensors, the planned one. A planned multi-tap conv on the card
(``ops.qconv_planned``: kh·kw > 1 and a CUDA tensor) never builds this
matrix: at a lane-padded layout it is almost all zeros (speech's 10×8 conv
of one channel at 32 lanes: K 2,560, of which 80 real). It runs as one
launch of ``qmatmul.qconv_fused``, the qmatmul kernel's implicit-GEMM
variant: the kernel gathers each row's real lanes from the activation
where it lies, fills the SAME border with z_X, and contracts K packed to
round_up(kh·kw·c_true, 32) against the weight packed once at plan time
(``preprocess.pack_conv_taps``), bit for bit the result of this route.
"""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.core.ops_ref import patches
from . import qmatmul as _qm


def im2col_q(x_q, kh: int, kw: int, stride):
    """(B, H, W, C) -> ((B*OH*OW, kh*kw*C), (B, OH, OW)) for a VALID conv."""
    b, H, W, c = x_q.shape
    sh, sw = stride
    oh = (H - kh) // sh + 1
    ow = (W - kw) // sw + 1
    if kh == kw == 1 and sh == sw == 1:
        return x_q.reshape(b * oh * ow, c), (b, oh, ow)  # pointwise: no copy
    return (patches(x_q, kh, kw, stride).reshape(b * oh * ow, kh * kw * c),
            (b, oh, ow))


def qconv2d(x_q, w_nk, bias_term, rescale, w_sum_zx, const_off, z_w, *,
            kh, kw, stride, lo=float("-inf"), hi=float("inf"), n_true=None):
    """Quantized VALID conv on the qmatmul kernel.

    x_q    (B, H, W, Cl) int8, already spatially pre-padded (SAME handled by
           the caller with the input zero point).
    w_nk   (N', K') int8: the flattened HWIO filter, transposed (K
           contiguous, as the qmatmul kernel takes it) and zero-padded, with
           K' a multiple of ``qmatmul.QUANTUM`` and >= kh*kw*Cl.
    consts (N',) per-output-channel folded Eq. (7) terms.

    Returns (B, OH, OW, N') int8; lanes >= ``n_true`` are zero when set.
    """
    stride = tuple(stride)
    mat, (b, oh, ow) = im2col_q(x_q, kh, kw, stride)
    k = mat.shape[1]
    kp = w_nk.shape[1]
    if kp < k:
        raise ValueError(f"qconv2d: filter width {kp} < patch width {k}")
    if kp != k:
        mat = F.pad(mat, (0, kp - k))
    out = _qm.qmatmul(mat.contiguous(), w_nk, bias_term, rescale, w_sum_zx,
                      const_off, z_w, lo=lo, hi=hi, n_true=n_true)
    return out.reshape(b, oh, ow, out.shape[-1])
