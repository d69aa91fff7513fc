"""Plain PyTorch versions of the hand-written kernels — the port of
``repro.kernels.ref``.

Each computes exactly the function its CUDA kernel computes (border pads /
per-channel argument convention, explicit clamp bounds, ``n_true`` /
``c_true`` lane zeroing), in the kernel's epilogue order. The wrappers run
them for CPU tensors; on the card only comparisons call them. They run on
any device: integer products are int32 on the CPU and float64 on CUDA
(exact, see ``ops_ref.imatmul``), and the epilogue's multiply-add is one
``torch.addcmul`` (one rounding, like the kernel's ``__fmaf_rn``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.ops_ref import (I8_MAX, I8_MIN, _no_tf32, dw_acc,
                                      imatmul, patches)


def _row(v, n: int, dtype, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=dtype, device=like.device).reshape(-1) \
        .expand(n)


def _requant(acc, sum_x, bias_term, rescale, w_sum_zx, const_off, z_w, lo, hi,
             n_true):
    n = acc.shape[-1]
    inner = (acc - _row(z_w, n, torch.int32, acc) * sum_x
             - _row(w_sum_zx, n, torch.int32, acc)
             + _row(const_off, n, torch.int32, acc))
    y = torch.addcmul(_row(bias_term, n, torch.float32, acc),
                      _row(rescale, n, torch.float32, acc),
                      inner.to(torch.float32))
    # torch.full, not torch.tensor: no host-to-device copy, so the plain
    # version can be captured in a CUDA graph for timing
    lo_t = torch.full((), float(lo), dtype=torch.float32, device=acc.device)
    hi_t = torch.full((), float(hi), dtype=torch.float32, device=acc.device)
    y = torch.minimum(torch.maximum(y, lo_t), hi_t)
    q = torch.clamp(torch.round(y), I8_MIN, I8_MAX).to(torch.int8)
    if n_true is not None and n_true < n:
        q[..., n_true:] = 0  # padded-layout contract: padding lanes are zero
    return q


def qmatmul_ref(x_q, w_q, bias_term, rescale, w_sum_zx, const_off, z_w, *,
                lo=float("-inf"), hi=float("inf"), n_true=None):
    """Plain version of ``kernels.qmatmul.qmatmul``: (M, K) x (K, N) int8 ->
    (M, N) int8 with the folded epilogue; columns >= ``n_true`` are 0."""
    x32 = x_q.to(torch.int32)
    acc = imatmul(x32, w_q)
    sum_x = x32.sum(-1, keepdim=True, dtype=torch.int32)
    return _requant(acc, sum_x, bias_term, rescale, w_sum_zx, const_off, z_w,
                    lo, hi, n_true)


def qconv_fused_ref(x_q, w_packed, bias_term, rescale, w_sum_zx, const_off,
                    z_w, *, kh, kw, stride, pads, c_true, z_x,
                    lo=float("-inf"), hi=float("inf"), n_true=None):
    """Plain version of ``kernels.qmatmul.qconv_fused``: the conv over the
    first ``c_true`` lanes of NHWC ``x_q``, its (top, bottom, left, right)
    border filled with ``z_x``, as packed im2col rows (tap-major, channel-
    minor, zero up to ``w_packed``'s K) times the (N, K) ``w_packed``
    -> (B, OH, OW, N) int8. It takes the kernel's own operands (the packed
    weight, the pads), so ``chip_smoke.py`` holds the kernel against it and
    times it at every call the engine makes, as it does every kernel's plain
    version; the engine's CPU route is im2col over the lane-padded input,
    which the CPU tests hold it to."""
    pt, pb, pl, pr = pads
    x = F.pad(x_q[..., :c_true], (0, 0, pl, pr, pt, pb), value=int(z_x))
    p = patches(x, kh, kw, tuple(stride))
    lead = tuple(p.shape[:3])
    mat = p.reshape(-1, p.shape[-1])
    mat = F.pad(mat, (0, w_packed.shape[1] - mat.shape[1]))
    out = qmatmul_ref(mat, w_packed.t(), bias_term, rescale, w_sum_zx,
                      const_off, z_w, lo=lo, hi=hi, n_true=n_true)
    return out.reshape(lead + (out.shape[-1],))


def paged_qmatmul_ref(x_q, w_q, bias_term, rescale, w_sum_zx, const_off,
                      z_w, *, page, lo=float("-inf"), hi=float("inf")):
    """Plain version of ``kernels.paged_matmul.paged_qmatmul``: the same
    folded FC as :func:`qmatmul_ref`, one (K, page) weight page at a time;
    N % page == 0."""
    n = w_q.shape[1]
    if page <= 0 or n % page:
        raise ValueError(f"page {page} does not divide N = {n}")
    x32 = x_q.to(torch.int32)
    sum_x = x32.sum(-1, keepdim=True, dtype=torch.int32)
    consts = [_row(v, n, dt, x32) for v, dt in zip(
        (bias_term, rescale, w_sum_zx, const_off, z_w),
        (torch.float32, torch.float32, torch.int32, torch.int32, torch.int32))]
    pages = []
    for j0 in range(0, n, page):
        cols = slice(j0, j0 + page)
        acc = imatmul(x32, w_q[:, cols])
        pages.append(_requant(acc, sum_x, *(c[cols] for c in consts), lo, hi,
                              None))
    return torch.cat(pages, dim=-1)


def fmatmul_ref(x, w):
    """Plain version of ``kernels.qmatmul.fmatmul``: the product in float32
    (full float32 on the card, never TF32), cast back to the input dtype."""
    _no_tf32(x)
    return (x.float() @ w.float()).to(x.dtype)


def qdwconv_ref(x_q, w_q, bias_term, rescale, w_sum_zx, const_off, z_w, *,
                stride, pads=(0, 0, 0, 0), z_x=0, lo=float("-inf"),
                hi=float("inf"), c_true=None):
    """Plain version of ``kernels.qdwconv.qdwconv``: x_q (B,H,W,C), w_q
    (kh,kw,C); the border ``pads`` = (top, bottom, left, right) is filled
    with ``z_x`` on every lane, then a VALID conv; channels >= ``c_true``
    are 0."""
    pt, pb, pl, pr = (int(p) for p in pads)
    if pt or pb or pl or pr:
        x_q = F.pad(x_q, (0, 0, pl, pr, pt, pb), value=int(z_x))
    acc, sum_x = dw_acc(x_q.to(torch.int32), w_q.to(torch.int32),
                        tuple(stride))
    return _requant(acc, sum_x, bias_term, rescale, w_sum_zx, const_off, z_w,
                    lo, hi, c_true)
