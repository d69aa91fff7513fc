"""Paging (Sec. 4.3) — the port of ``repro.core.paging``: split a layer into
pages, all connections into one slice of output units (Fig. 6), and process
them one at a time.

On the MCU this bounds RAM: only one page of weights is resident. On the
card, ``kernels.paged_matmul`` stages one (K, page) weight page in a block's
shared memory. This module is the plain route's paged FullyConnected: a
Python loop over pages in torch, which the compiled engine runs on the CPU
and with ``use_kernels=False``. The byte accounting is ``core.memory``.
"""
from __future__ import annotations

import torch

from .ops_ref import (FoldedConsts, _as, _fused_bounds, _saturate_i8,
                      imatmul)


def paged_fc_folded(x_q, w_q, fc: FoldedConsts, n_pages: int,
                    fused: str = "NONE"):
    """Folded Eq. (3) computed page by page over the output dimension.

    Bit-identical to ``fully_connected_folded``. Each page is independent:
    nothing carries from one page to the next, the paper's claim that a
    page leaves no memory trace after its execution."""
    n, p = w_q.shape
    assert p % n_pages == 0, (p, n_pages)
    page = p // n_pages

    x32 = x_q.to(torch.int32)
    sum_x = x32.sum(-1, keepdim=True, dtype=torch.int32)

    def per_channel(v, dtype):
        return _as(v, x32, dtype).reshape(-1).expand(p)

    bias_term = per_channel(fc.bias_term, torch.float32)
    rescale = per_channel(fc.rescale, torch.float32)
    w_sum_zx = per_channel(fc.w_sum_zx, torch.int32)
    const_off = per_channel(fc.const_off, torch.int32)
    z_w = per_channel(fc.z_w, torch.int32)
    lo, hi = _fused_bounds(fused, fc.z_y, fc.s_y, x32)

    pages = []
    for j in range(n_pages):
        cols = slice(j * page, (j + 1) * page)
        acc = imatmul(x32, w_q[:, cols])                     # (m, page)
        inner = acc - z_w[cols] * sum_x - w_sum_zx[cols] + const_off[cols]
        y = torch.addcmul(bias_term[cols], rescale[cols],
                          inner.to(torch.float32))
        pages.append(_saturate_i8(torch.clamp(y, lo, hi)))
    return torch.cat(pages, dim=-1)
