"""Quantized int8 matmul — the FullyConnected hot-spot (Eq. 3) on the card —
its fused multi-tap Conv2D variant (Eq. 7), and the float matmul of the
float FullyConnected path.

Port of ``repro.kernels.qmatmul.qmatmul`` and ``fmatmul``. The kernels are
hand-written CUDA C++ for sm_90a (``csrc/qmatmul.cu``, ``csrc/fmatmul.cu``;
their header notes give the designs). :func:`qmatmul`, :func:`qconv_fused`
and :func:`fmatmul` check their operands, allocate the output and launch
the kernel for CUDA tensors, and run the plain versions
(``ref.qmatmul_ref``, ``ref.qconv_fused_ref``, ``ref.fmatmul_ref``) for CPU
tensors. There is no other route: a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ._build import check_operands, cuda_stream, ptr
from .ref import fmatmul_ref, qconv_fused_ref, qmatmul_ref

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
#: The same count for the fused conv variant (:func:`qconv_fused`).
conv_launches = 0


@functools.cache
def _kernel():
    return _build.function("qmatmul", "repro_qmatmul",
                           [_P] * 8 + [_I] * 3 + [_F, _F] + [_I] * 4 + [_P])


@functools.cache
def _ckernel():
    return _build.function("qmatmul", "repro_qconv",
                           [_P] * 8 + [_I] * 16 + [_F, _F] + [_I] * 2 + [_P])


@functools.cache
def _fkernel():
    return _build.function("fmatmul", "repro_fmatmul",
                           [_P] * 4 + [_I] * 6 + [_P])


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def stage_bytes(k: int) -> int:
    """The bytes of K a pipeline stage of ``csrc/qmatmul.cu`` carries (its
    BK; a conv slab's too): K itself up to 64, else 128."""
    return 32 if k <= 32 else 64 if k <= 64 else 128


def block_tile(m: int, k: int, n: int) -> tuple:
    """The (BM, BN, BK) tile of ``csrc/qmatmul.cu`` for an (M, K, N)
    product: 64 x 64 blocks where N allows (128 x 64 from 4096 rows on),
    else 128 x 32 -- warps of 32 x 32 either way; BK, the bytes of K a
    pipeline stage carries: K itself up to 64, else 128. (Chosen from a
    sweep of tiles at the person path's shapes on the H100.)"""
    bk = stage_bytes(k)
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


def qconv_fused(x_q, w_packed, bias_term, rescale, w_sum_zx, const_off, z_w,
                *, kh, kw, stride, pads, c_true, z_x, lo=float("-inf"),
                hi=float("inf"), n_true=None):
    """Quantized Conv2D as one implicit-GEMM launch of the qmatmul kernel's
    conv variant: x_q (B, H, W, L) int8 NHWC, of whose L lanes the first
    ``c_true`` are real (the rest zero, as a planned producer leaves them);
    w_packed (N, KP) int8, the filter's taps packed and transposed
    (``preprocess.pack_conv_taps``: KP = round_up(kh*kw*c_true, 32));
    per-channel consts (N,); ``pads`` (top, bottom, left, right) filled
    with ``z_x`` inside the kernel. Returns (B, OH, OW, N) int8, columns
    >= ``n_true`` zero. N must be a multiple of :data:`QUANTUM`."""
    global conv_launches
    if x_q.dim() != 4:
        raise ValueError(f"qconv_fused: x_q must be NHWC, got {tuple(x_q.shape)}")
    b, h, w, lanes = x_q.shape
    n, kp = w_packed.shape
    check_operands("qconv_fused", dict(
        x_q=x_q, w_packed=w_packed, bias_term=bias_term, rescale=rescale,
        w_sum_zx=w_sum_zx, const_off=const_off, z_w=z_w), dict(
        x_q=(torch.int8, (b, h, w, lanes)), w_packed=(torch.int8, (n, kp)),
        bias_term=(torch.float32, (n,)), rescale=(torch.float32, (n,)),
        w_sum_zx=(torch.int32, (n,)), const_off=(torch.int32, (n,)),
        z_w=(torch.int32, (n,))))
    sh, sw = (int(v) for v in stride)
    pt, pb, pl, pr = (int(v) for v in pads)
    k = kh * kw * c_true
    if not 0 < c_true <= lanes:
        raise ValueError(f"qconv_fused: c_true {c_true} not in 1..{lanes}")
    oh = (h + pt + pb - kh) // sh + 1 if sh > 0 else 0
    ow = (w + pl + pr - kw) // sw + 1 if sw > 0 else 0
    if min(kh, kw, oh, ow) < 1 or min(pt, pb, pl, pr) < 0:
        raise ValueError(f"qconv_fused: no output for a {kh}x{kw} filter, "
                         f"stride {(sh, sw)}, pads {tuple(pads)} over "
                         f"{(h, w)}")
    if kp != -(-k // QUANTUM) * QUANTUM:
        raise ValueError(f"qconv_fused: packed K {kp} is not {k} taps x "
                         f"lanes rounded up to {QUANTUM}")
    if n % QUANTUM or n == 0 or b == 0:
        raise ValueError(f"qconv_fused: N {n} must be a positive multiple "
                         f"of {QUANTUM}, B {b} positive")
    if not -128 <= int(z_x) <= 127:
        raise ValueError(f"qconv_fused: z_x {z_x} is not int8")
    if (kh * w * lanes >= 2 ** 31 or b * oh * ow >= 2 ** 31
            or max(kh, kw) >= 2 ** 15):
        raise ValueError("qconv_fused: offsets beyond 32 bits")
    if x_q.device.type == "cpu":
        return qconv_fused_ref(x_q, w_packed, bias_term, rescale, w_sum_zx,
                               const_off, z_w, kh=kh, kw=kw, stride=(sh, sw),
                               pads=(pt, pb, pl, pr), c_true=c_true, z_x=z_x,
                               lo=lo, hi=hi, n_true=n_true)
    out = torch.empty((b, oh, ow, n), dtype=torch.int8, device=x_q.device)
    err = _ckernel()(
        ptr(x_q), ptr(w_packed, 16), ptr(bias_term, 16), ptr(rescale, 16),
        ptr(w_sum_zx, 16), ptr(const_off, 16), ptr(z_w, 16), ptr(out, 16),
        b * oh * ow, n, kp, h, w, lanes, oh, ow, kw, sh, sw, pt, pl, c_true,
        k, int(z_x), float(lo), float(hi),
        n if n_true is None else int(n_true), stage_bytes(kp),
        cuda_stream(x_q))
    _build.launch_check("qconv_fused", err)
    conv_launches += 1
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
