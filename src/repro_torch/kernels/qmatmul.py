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

#: K and N of :func:`qmatmul` must be multiples of this: one
#: ``mma.m16n8k32`` depth of int8, and the lane quantum the engine plans at.
QUANTUM = 32

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: Launches of the CUDA kernel so far in this process; the wrapper adds one
#: per launch and nowhere else (the plain version on CPU tensors does not
#: count).
launches = 0
#: The same count for the float kernel (:func:`fmatmul`); one per call, its
#: reduction pass included.
fmatmul_launches = 0


@functools.cache
def _kernel():
    return _build.function("qmatmul", "repro_qmatmul",
                           [_P] * 8 + [_I] * 3 + [_F, _F] + [_I] * 4 + [_P])


@functools.cache
def _fkernel():
    return _build.function("fmatmul", "repro_fmatmul",
                           [_P] * 4 + [_I] * 6 + [_P])


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def block_tile(m: int, k: int, n: int) -> tuple:
    """The (BM, BN, BK) tile of ``csrc/qmatmul.cu`` for an (M, K, N)
    product: 64 x 64 blocks where N allows (128 x 64 from 4096 rows on),
    else 128 x 32 -- warps of 32 x 32 either way; BK, the bytes of K a
    pipeline stage carries: K itself up to 64, else 128. (Chosen from a
    sweep of tiles at the person path's shapes on the H100.)"""
    bk = 32 if k <= 32 else 64 if k <= 64 else 128
    if n % 64:
        return 128, 32, bk
    return (128 if m >= 4096 else 64), 64, bk


def qmatmul(x_q, w_nk, bias_term, rescale, w_sum_zx, const_off, z_w, *,
            lo=float("-inf"), hi=float("inf"), n_true=None):
    """x_q (M, K) int8, w_nk (N, K) int8 -- the weight TRANSPOSED, K
    contiguous -- per-channel consts (N,) -> (M, N) int8:
    ``bias + rescale * (x@w - z_w ΣX - w_sum_zx + const_off)``, clamped to
    [lo, hi], rounded half to even, saturated. M is any positive size; K and
    N must be multiples of :data:`QUANTUM` (``ops`` pads). ``n_true``: when
    set, output columns >= n_true are written as zero (the padded-layout
    contract).
    """
    global launches
    m, k = x_q.shape
    n = w_nk.shape[0]
    check_operands("qmatmul", dict(
        x_q=x_q, w_nk=w_nk, bias_term=bias_term, rescale=rescale,
        w_sum_zx=w_sum_zx, const_off=const_off, z_w=z_w), dict(
        x_q=(torch.int8, (m, k)), w_nk=(torch.int8, (n, k)),
        bias_term=(torch.float32, (n,)), rescale=(torch.float32, (n,)),
        w_sum_zx=(torch.int32, (n,)), const_off=(torch.int32, (n,)),
        z_w=(torch.int32, (n,))))
    if k % QUANTUM or n % QUANTUM or m == 0 or k == 0 or n == 0:
        raise ValueError(f"qmatmul: M must be positive and K, N positive "
                         f"multiples of {QUANTUM}, got {(m, k, n)}")
    if x_q.device.type == "cpu":
        return qmatmul_ref(x_q, w_nk.t(), bias_term, rescale, w_sum_zx,
                           const_off, z_w, lo=lo, hi=hi, n_true=n_true)
    out = torch.empty((m, n), dtype=torch.int8, device=x_q.device)
    bm, bn, bk = block_tile(m, k, n)
    err = _kernel()(
        ptr(x_q, 16), ptr(w_nk, 16), ptr(bias_term, 16), ptr(rescale, 16),
        ptr(w_sum_zx, 16), ptr(const_off, 16), ptr(z_w, 16), ptr(out, 16),
        m, n, k, float(lo), float(hi), n if n_true is None else int(n_true),
        bm, bn, bk, cuda_stream(x_q))
    _build.launch_check("qmatmul", err)
    launches += 1
    return out


#: fmatmul's output tile and K step (``csrc/fmatmul.cu``).
F_TILE, F_STEP = 64, 32


def fmatmul_splits(m: int, k: int, n: int, sms: int) -> tuple:
    """(S, kslice): the K slices ``csrc/fmatmul.cu`` splits an (M, K, N)
    product into. A K of up to 4 steps of 32 (the kernel's ring, all in
    flight at once) is not split; a longer one is cut so that output tiles
    x S fills about one wave of ``sms`` blocks, with at least 2 steps a
    slice. ``kslice`` is a multiple of 32 and S = ceil(K / kslice)."""
    tiles = -(-m // F_TILE) * -(-n // F_TILE)
    steps = -(-k // F_STEP)
    splits = 1 if steps <= 4 else min(-(-steps // 2), -(-sms // tiles))
    per = -(-steps // splits)
    return -(-steps // per), per * F_STEP


def fmatmul(x, w):
    """x (M, K) @ w (K, N), both float32 or both bfloat16 -> (M, N) in that
    dtype, accumulated in float32 (IEEE, never TF32). M is any positive
    size; K and N must be multiples of 16 bytes / element size (4 for
    float32, 8 for bfloat16: whole 16-byte rows; ``ops`` pads)."""
    global fmatmul_launches
    m, k = x.shape
    n = w.shape[1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fmatmul: float32 or bfloat16 only, got {x.dtype}")
    check_operands("fmatmul", dict(x=x, w=w),
                   dict(x=(x.dtype, (m, k)), w=(x.dtype, (k, n))))
    per_chunk = 16 // x.element_size()
    if k % per_chunk or n % per_chunk or m == 0 or n == 0 or k == 0:
        raise ValueError(f"fmatmul: M must be positive and K, N positive "
                         f"multiples of {per_chunk} for {x.dtype}, got "
                         f"{(m, k, n)}")
    if x.device.type == "cpu":
        return fmatmul_ref(x, w)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    splits, kslice = fmatmul_splits(m, k, n, _sm_count(x.device.index))
    partial = (torch.empty((splits, m, n), dtype=torch.float32,
                           device=x.device) if splits > 1 else out)
    err = _fkernel()(ptr(x, 16), ptr(w, 16), ptr(out, 16), ptr(partial, 16),
                     m, n, k, splits, kslice, int(x.dtype == torch.bfloat16),
                     cuda_stream(x))
    _build.launch_check("fmatmul", err)
    fmatmul_launches += 1
    return out
