"""Quantized int8 matmul — the FullyConnected hot-spot (Eq. 3) on the card —
and the float matmul of the float FullyConnected path.

Port of ``repro.kernels.qmatmul.qmatmul`` and ``fmatmul``. The kernels are
hand-written CUDA C++ for sm_90a (``csrc/qmatmul.cu``, ``csrc/fmatmul.cu``;
their header notes give the designs). :func:`qmatmul` and :func:`fmatmul`
check their operands, allocate the output and launch the kernel for CUDA
tensors, and run the plain versions (``ref.qmatmul_ref``,
``ref.fmatmul_ref``) for CPU tensors. There is no other route: a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ._build import check_operands, cuda_stream, ptr
from .ref import fmatmul_ref, qmatmul_ref

#: M, K and N must be multiples of the kernel's tile.
TILE = 64

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: Launches of the CUDA kernel so far in this process; the wrapper adds one
#: per launch and nowhere else (the plain version on CPU tensors does not
#: count).
launches = 0
#: The same count for the float kernel (:func:`fmatmul`).
fmatmul_launches = 0


@functools.cache
def _kernel():
    return _build.function("qmatmul", "repro_qmatmul",
                           [_P] * 8 + [_I] * 3 + [_F, _F, _I, _P])


@functools.cache
def _fkernel():
    return _build.function("fmatmul", "repro_fmatmul",
                           [_P] * 3 + [_I] * 4 + [_P])


def qmatmul(x_q, w_q, bias_term, rescale, w_sum_zx, const_off, z_w, *,
            lo=float("-inf"), hi=float("inf"), n_true=None):
    """x_q (M, K) int8, w_q (K, N) int8, per-channel consts (N,) -> (M, N)
    int8: ``bias + rescale * (x@w - z_w ΣX - w_sum_zx + const_off)``,
    clamped to [lo, hi], rounded half to even, saturated. M, K, N must be
    multiples of :data:`TILE` (``ops`` pads). ``n_true``: when set, output
    columns >= n_true are written as zero (the padded-layout contract).
    """
    global launches
    m, k = x_q.shape
    n = w_q.shape[1]
    check_operands("qmatmul", dict(
        x_q=x_q, w_q=w_q, bias_term=bias_term, rescale=rescale,
        w_sum_zx=w_sum_zx, const_off=const_off, z_w=z_w), dict(
        x_q=(torch.int8, (m, k)), w_q=(torch.int8, (k, n)),
        bias_term=(torch.float32, (n,)), rescale=(torch.float32, (n,)),
        w_sum_zx=(torch.int32, (n,)), const_off=(torch.int32, (n,)),
        z_w=(torch.int32, (n,))))
    if m % TILE or k % TILE or n % TILE or m == 0 or n == 0:
        raise ValueError(f"qmatmul: M, K, N must be positive multiples of "
                         f"{TILE}, got {(m, k, n)}")
    if x_q.device.type == "cpu":
        return qmatmul_ref(x_q, w_q, bias_term, rescale, w_sum_zx, const_off,
                           z_w, lo=lo, hi=hi, n_true=n_true)
    out = torch.empty((m, n), dtype=torch.int8, device=x_q.device)
    err = _kernel()(
        ptr(x_q, 16), ptr(w_q, 16), ptr(bias_term, 4), ptr(rescale, 4),
        ptr(w_sum_zx, 4), ptr(const_off, 4), ptr(z_w, 4), ptr(out, 16),
        m, n, k, float(lo), float(hi), n if n_true is None else int(n_true),
        cuda_stream(x_q))
    _build.launch_check("qmatmul", err)
    launches += 1
    return out


def fmatmul(x, w):
    """x (M, K) @ w (K, N), both float32 or both bfloat16 -> (M, N) in that
    dtype, accumulated in float32 (IEEE, never TF32). M and N must be
    multiples of :data:`TILE`, K a multiple of 32 (``ops`` pads)."""
    global fmatmul_launches
    m, k = x.shape
    n = w.shape[1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fmatmul: float32 or bfloat16 only, got {x.dtype}")
    check_operands("fmatmul", dict(x=x, w=w),
                   dict(x=(x.dtype, (m, k)), w=(x.dtype, (k, n))))
    if m % TILE or n % TILE or k % 32 or m == 0 or n == 0 or k == 0:
        raise ValueError(f"fmatmul: M, N must be positive multiples of {TILE} "
                         f"and K of 32, got {(m, k, n)}")
    if x.device.type == "cpu":
        return fmatmul_ref(x, w)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    size = x.element_size()
    err = _fkernel()(ptr(x, size), ptr(w, size), ptr(out, size), m, n, k,
                     int(x.dtype == torch.bfloat16), cuda_stream(x))
    _build.launch_check("fmatmul", err)
    fmatmul_launches += 1
    return out
