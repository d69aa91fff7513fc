"""The attention module's factored pieces on plain tensors: the cache write
``write_rows``, MLA's core ``_mla_attend``, ``_softmax`` and the router's
``router_logits`` give bit for bit what the inline code they replace gave
(copied below as it stood); and the dry run's split of a cache write over
the shards of its sequence (``dryrun.write_local``) composes to the same
write."""
import math

import numpy as np
import pytest
import torch

from repro_torch.launch import dryrun as D
from repro_torch.models import attention as AT
from repro_torch.models import moe as MO

DTYPES = (torch.float32, torch.bfloat16)


def _rand(shape, dtype, seed):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal(shape).astype(np.float32)) \
        .to(dtype)


# the code as it stood before the factoring --------------------------------

def _mla_expanded_inline(q_nope, q_rope, k_nope, kr_all, v, mask, qk, rp):
    B, T, H, vh = q_nope.shape[0], q_nope.shape[1], q_nope.shape[2], \
        v.shape[-1]
    scores = (torch.einsum("bthc,bshc->bhts", q_nope, k_nope)
              + torch.einsum("bthc,bsc->bhts", q_rope, kr_all)) \
        .float() / math.sqrt(qk + rp)
    scores = torch.where(mask[:, None, :, :], scores, AT.NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshc->bthc", w, v).reshape(B, T, H * vh)


def _mla_absorbed_inline(q_eff, q_rope, c_all, kr_all, mask, qk, rp):
    scores = (torch.einsum("bthr,bsr->bhts", q_eff, c_all)
              + torch.einsum("bthc,bsc->bhts", q_rope, kr_all)) \
        .float() / math.sqrt(qk + rp)
    scores = torch.where(mask[:, None, :, :], scores, AT.NEG_INF)
    w = torch.softmax(scores, dim=-1).to(c_all.dtype)
    return torch.einsum("bhts,bsr->bthr", w, c_all)


# ---------------------------------------------------------------------------

WRITES = [(16, 0, 1), (16, 7, 1), (16, 15, 1), (16, 0, 5), (16, 9, 7),
          (16, 0, 16)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,start,T", WRITES)
def test_write_rows_is_the_slice_copy(S, start, T, dtype):
    cache = _rand((3, S, 2, 4), dtype, 0)
    rows = _rand((3, T, 2, 4), dtype, 1)
    want = cache.clone()
    want[:, start:start + T].copy_(rows)
    AT.write_rows(cache, start, rows)
    assert torch.equal(cache, want)


@pytest.mark.parametrize("shards", (1, 2, 4))
@pytest.mark.parametrize("S,start,T", WRITES)
def test_write_local_on_every_shard_is_the_write(S, start, T, shards):
    """Each rank's ``write_local`` on its shard of the sequence, together,
    write what ``write_rows`` writes on the whole cache."""
    cache = _rand((3, S, 2, 4), torch.float32, 2)
    rows = _rand((3, T, 2, 4), torch.float32, 3)
    want = cache.clone()
    AT.write_rows(want, start, rows)
    width = S // shards
    for i, local in enumerate(cache.split(width, dim=1)):
        D.write_local(local, i * width, start, rows)
    assert torch.equal(cache, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,S", [(5, 5), (1, 9)])
def test_mla_attend_expanded_is_the_inline_code(T, S, dtype):
    B, H, qk, rp, vh = 2, 3, 8, 4, 6
    q_nope, q_rope = _rand((B, T, H, qk), dtype, 4), \
        _rand((B, T, H, rp), dtype, 5)
    k_nope, v = _rand((B, S, H, qk), dtype, 6), _rand((B, S, H, vh), dtype, 7)
    kr = _rand((B, S, rp), dtype, 8)
    pos = torch.arange(S)
    mask = (pos[None, :] <= pos[-T:, None])[None].expand(B, T, S)
    want = _mla_expanded_inline(q_nope, q_rope, k_nope, kr, v, mask, qk, rp)
    got = AT._mla_attend(q_nope, q_rope, k_nope, kr, v, mask,
                         math.sqrt(qk + rp)).reshape(B, T, H * vh)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_attend_absorbed_is_the_inline_code(dtype):
    B, T, S, H, r, qk, rp = 2, 1, 9, 3, 10, 8, 4
    q_eff, q_rope = _rand((B, T, H, r), dtype, 9), \
        _rand((B, T, H, rp), dtype, 10)
    c_all, kr = _rand((B, S, r), dtype, 11), _rand((B, S, rp), dtype, 12)
    mask = (torch.arange(S) <= 4)[None, None, :].expand(B, T, S)
    want = _mla_absorbed_inline(q_eff, q_rope, c_all, kr, mask, qk, rp)
    got = AT._mla_attend(q_eff, q_rope, c_all, kr, c_all, mask,
                         math.sqrt(qk + rp))
    assert torch.equal(got, want)


def test_softmax_is_torch_softmax():
    s = _rand((2, 3, 4, 7), torch.float32, 13)
    assert torch.equal(AT._softmax(s), torch.softmax(s, dim=-1))


def test_softmax_across_no_ranks_is_the_softmax():
    """The dry run's split softmax (its maximum and sum all-reduced over
    the ranks that hold the keys), with no ranks to reduce over, is the
    softmax within float32 rounding (another order of operations)."""
    s = _rand((2, 3, 4, 7), torch.float32, 14) * 10
    s[..., :2] = AT.NEG_INF
    got = D._softmax_across([])(s)
    torch.testing.assert_close(got, torch.softmax(s, dim=-1), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("dtype", DTYPES)
def test_router_logits_is_the_inline_product(dtype):
    xf, router = _rand((12, 8), dtype, 15), _rand((8, 5), torch.float32, 16)
    assert torch.equal(MO.router_logits(xf, router),
                       xf.float() @ router.float())
