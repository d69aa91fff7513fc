"""Quantized DepthwiseConv2D — Eq. (9) on the card.

Port of ``repro.kernels.qdwconv.qdwconv``. The kernel is hand-written CUDA
C++ for sm_90a (``csrc/qdwconv.cu``; its header note gives the design);
:func:`qdwconv` checks its operands, allocates the output and launches it
for CUDA tensors, and runs the plain version (``ref.qdwconv_ref``) for CPU
tensors. A CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ._build import check_operands, cuda_stream, ptr
from .ref import qdwconv_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: Launches of the CUDA kernel so far in this process; the wrapper adds one
#: per launch and nowhere else (the plain version on CPU tensors does not
#: count).
launches = 0


@functools.cache
def _kernel():
    return _build.function("qdwconv", "repro_qdwconv",
                           [_P] * 8 + [_I] * 10 + [_F, _F, _I, _P])


def qdwconv(x_q, w_q, bias_term, rescale, w_sum_zx, const_off, z_w, *,
            stride, lo=float("-inf"), hi=float("inf"), c_true=None):
    """x_q (B, H, W, C) int8 pre-padded, w_q (kh, kw, C) int8, consts (C,)
    -> (B, OH, OW, C) int8 of the VALID depthwise conv with the folded
    epilogue. C must be a multiple of 4. ``c_true``: when set, output lanes
    >= c_true are written as zero (the padded-layout contract)."""
    global launches
    b, H, W, c = x_q.shape
    kh, kw = w_q.shape[:2]
    sh, sw = (int(s) for s in stride)
    check_operands("qdwconv", dict(
        x_q=x_q, w_q=w_q, bias_term=bias_term, rescale=rescale,
        w_sum_zx=w_sum_zx, const_off=const_off, z_w=z_w), dict(
        x_q=(torch.int8, (b, H, W, c)), w_q=(torch.int8, (kh, kw, c)),
        bias_term=(torch.float32, (c,)), rescale=(torch.float32, (c,)),
        w_sum_zx=(torch.int32, (c,)), const_off=(torch.int32, (c,)),
        z_w=(torch.int32, (c,))))
    if c % 4 or sh < 1 or sw < 1 or H < kh or W < kw or b * c == 0:
        raise ValueError(f"qdwconv: unsupported geometry x {tuple(x_q.shape)}, "
                         f"w {tuple(w_q.shape)}, stride {(sh, sw)}")
    if x_q.device.type == "cpu":
        return qdwconv_ref(x_q, w_q, bias_term, rescale, w_sum_zx, const_off,
                           z_w, stride=(sh, sw), lo=lo, hi=hi, c_true=c_true)
    oh = (H - kh) // sh + 1
    ow = (W - kw) // sw + 1
    out = torch.empty((b, oh, ow, c), dtype=torch.int8, device=x_q.device)
    err = _kernel()(
        ptr(x_q, 4), ptr(w_q, 4), ptr(bias_term, 4), ptr(rescale, 4),
        ptr(w_sum_zx, 4), ptr(const_off, 4), ptr(z_w, 4), ptr(out, 4),
        b, H, W, c, kh, kw, sh, sw, oh, ow, float(lo), float(hi),
        c if c_true is None else int(c_true), cuda_stream(x_q))
    _build.launch_check("qdwconv", err)
    launches += 1
    return out
