"""Output-unit paging kernel — Sec. 4.3 / Fig. 6 on the card.

Port of ``repro.kernels.paged_matmul.paged_qmatmul``. The paper's page is
all connections from layer i into a slice of units of layer i+1; only one
page of weights is resident at a time. The kernel is hand-written CUDA C++
for sm_90a (``csrc/paged_qmatmul.cu``; its header note gives the design):
each block stages a slice of one page's (K, page) weights in shared memory,
and :func:`paged_split` picks the slice and the K chunk.
:func:`paged_qmatmul` checks its operands, allocates the output and
launches it for CUDA tensors, and runs the plain version
(``ref.paged_qmatmul_ref``) for CPU tensors. A CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ._build import check_operands, cuda_stream, ptr
from .ref import paged_qmatmul_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: Launches of the CUDA kernel so far in this process; the wrapper adds one
#: per launch and nowhere else (the plain version on CPU tensors does not
#: count).
launches = 0


@functools.cache
def _kernel():
    return _build.function("paged_qmatmul", "repro_paged_qmatmul",
                           [_P] * 8 + [_I] * 8 + [_F, _F, _P])


#: Rows of x a block takes, the most page units it stages, warps a block
#: has, and the shared memory a block may use (set as the kernel's
#: attribute where above the default 48 KB).
BM = 8
SLICE = 16
WARPS = 8
SMEM_BYTES = 96 * 1024


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def paged_smem(n: int, sc: int, kc: int, flat: bool) -> int:
    """Shared-memory bytes of one block of ``csrc/paged_qmatmul.cu`` (its
    ``Layout``): the raw W segments, x words, W transposed, the sums."""
    rowb = 16 * (-(-sc // 16) + 1)
    wraw = _round16(kc * n + 32 if flat else kc * rowb)
    return (wraw + BM * kc + sc * (kc // 4 + 1) * 4 + BM * sc * 4 + BM * 4
            + WARPS * 4 + WARPS * BM * 4)


def paged_split(k: int, n: int, page: int) -> tuple:
    """(SC, KC, flat): how ``csrc/paged_qmatmul.cu`` cuts an (M, K) x (K, N)
    product in pages of ``page`` units. A block takes up to :data:`BM` rows
    and SC = min(page, :data:`SLICE`) units of one page (the 256 x 256 FC at
    pages of 128 runs 16 blocks). It stages W as whole 16-byte segments:
    the contiguous range of a K chunk's rows when a row (N bytes) is no
    wider than the segments of one row's slice (``flat``), else those
    segments. KC, the bytes of K a block stages at once (a multiple of
    16), is all of K where :data:`SMEM_BYTES` holds it, else the most that
    fits."""
    sc = min(page, SLICE)
    rowb = 16 * (-(-sc // 16) + 1)
    flat = n <= rowb
    kc = _round16(k)
    while kc > 16 and paged_smem(n, sc, kc, flat) > SMEM_BYTES:
        kc = max(16, (kc // 2) // 16 * 16)
    return sc, kc, flat


def paged_blocks(m: int, n: int, page: int, sc: int) -> int:
    """The grid size of a launch with slice ``sc``."""
    return (n // page) * -(-page // sc) * -(-m // BM)


def paged_qmatmul(x_q, w_q, bias_term, rescale, w_sum_zx, const_off, z_w, *,
                  page, lo=float("-inf"), hi=float("inf")):
    """x_q (M, K) int8, w_q (K, N) int8, per-channel consts (N,) -> (M, N)
    int8, one (K, page) weight page per block; ``page`` must divide N. Any
    M and K: the operands are the layer's logical shapes. The result equals
    ``qmatmul`` on the same operands (there is no ``n_true``)."""
    global launches
    m, k = x_q.shape
    n = w_q.shape[1]
    check_operands("paged_qmatmul", dict(
        x_q=x_q, w_q=w_q, bias_term=bias_term, rescale=rescale,
        w_sum_zx=w_sum_zx, const_off=const_off, z_w=z_w), dict(
        x_q=(torch.int8, (m, k)), w_q=(torch.int8, (k, n)),
        bias_term=(torch.float32, (n,)), rescale=(torch.float32, (n,)),
        w_sum_zx=(torch.int32, (n,)), const_off=(torch.int32, (n,)),
        z_w=(torch.int32, (n,))))
    if k == 0 or n == 0 or page <= 0 or n % page:
        raise ValueError(f"paged_qmatmul: page {page} must divide N > 0 "
                         f"(K > 0), got K, N = {(k, n)}")
    if m > 65535 * 8:
        raise ValueError(f"paged_qmatmul: M = {m} exceeds the kernel's grid")
    if x_q.device.type == "cpu":
        return paged_qmatmul_ref(x_q, w_q, bias_term, rescale, w_sum_zx,
                                 const_off, z_w, page=page, lo=lo, hi=hi)
    out = torch.empty((m, n), dtype=torch.int8, device=x_q.device)
    if m == 0:
        return out
    sc, kc, flat = paged_split(k, n, int(page))
    x_vec = k % 16 == 0 and x_q.data_ptr() % 16 == 0
    err = _kernel()(
        ptr(x_q), ptr(w_q), ptr(bias_term, 4), ptr(rescale, 4),
        ptr(w_sum_zx, 4), ptr(const_off, 4), ptr(z_w, 4), ptr(out), m, n, k,
        int(page), sc, kc, int(flat), int(x_vec), float(lo), float(hi),
        cuda_stream(x_q))
    _build.launch_check("paged_qmatmul", err)
    launches += 1
    return out
