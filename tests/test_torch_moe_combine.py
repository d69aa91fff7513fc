"""The MoE combine in a fixed order (``repro_torch.models.moe.combine``).

Each token sums its picks, gathered in the order of the table of expert
outputs, by one reduction. On the CPU that is what the ``index_add`` over
the table's token ids it replaces gave, bit for bit: the same adds in the
same order. This holds it there:

* ``apply_moe`` against the same function with the ``index_add`` combine
  (``_route_and_compute_index_add``, the code it replaced), at top_k 6 and
  8 (top_k 2 cannot tell two orders apart), with and without capacity
  drops, one and two routing groups, float32 and bfloat16;
* ``combine`` of a random table against ``index_add`` of the same table;
* ``moe_a2a``'s combine at the source, in (destination rank, slot) order,
  against the ``index_add`` it replaced;
* ``apply_moe`` at top_k 6 and 8 against the JAX package's (1e-5, as
  ``test_torch_llm_models.py::test_moe``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import moe as JMOE
from repro_torch.configs import get_config
from repro_torch.models import moe as MO
from repro_torch.models import moe_a2a as A2A
from repro_torch.models.layers import silu_as, tree_map

D, EXPERTS, FF, B, T = 64, 16, 32, 2, 24
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfg(arch, top_k, capacity_factor, groups):
    return dataclasses.replace(
        get_config(arch).reduced(), d_model=D, n_experts=EXPERTS,
        top_k=top_k, moe_d_ff=FF, capacity_factor=capacity_factor,
        moe_groups=groups)


def _params(cfg, dtype, seed):
    """``init_moe``'s tensors drawn from numpy at their scales."""
    rng = np.random.default_rng(seed)
    return tree_map(lambda s: torch.from_numpy(
        (rng.standard_normal(s.shape) * s.value).astype(np.float32))
        .to(s.dtype), MO.init_moe(cfg, dtype))


def _x(seed, dtype):
    rng = np.random.default_rng(seed + 100)
    return torch.from_numpy(
        (rng.standard_normal((B, T, D)) * 0.3).astype(np.float32)).to(dtype)


def _route_and_compute_index_add(cfg, p, xf, C):
    """``moe._route_and_compute`` with the combine it had before: an
    ``index_add`` of the weighted expert outputs over the dispatch table's
    token ids."""
    n, d = xf.shape
    E, k = cfg.n_experts, cfg.top_k
    logits = MO.router_logits(xf, p["router"])
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_e = torch.topk(probs, k, dim=-1)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True)
    e_flat = gate_e.reshape(-1)
    t_flat = torch.arange(n).repeat_interleave(k)
    w_flat = gate_w.reshape(-1)
    e_s, order = torch.sort(e_flat, stable=True)
    t_s, w_s = t_flat[order], w_flat[order]
    starts = torch.searchsorted(e_s, torch.arange(E), side="left")
    rank = torch.arange(n * k) - starts[e_s]
    keep = rank < C
    e_idx = torch.where(keep, e_s, E)
    r_idx = torch.where(keep, rank, 0)
    dispatch = torch.full((E + 1, C), n, dtype=torch.long) \
        .index_put((e_idx, r_idx), t_s)[:E]
    w_disp = torch.zeros((E + 1, C), dtype=torch.float32) \
        .index_put((e_idx, r_idx), w_s)[:E]
    xp = torch.cat([xf, xf.new_zeros((1, d))], 0)
    xe = xp[dispatch]
    h = silu_as(torch.bmm(xe, p["w_gate"]), xe)
    h.mul_(torch.bmm(xe, p["w_up"]))
    ye = torch.bmm(h, p["w_down"])
    ye.mul_(w_disp[..., None].to(ye.dtype))
    y = torch.zeros((n + 1, d), dtype=ye.dtype) \
        .index_add(0, dispatch.reshape(-1), ye.reshape(-1, d))[:n]
    frac_tokens = torch.nn.functional.one_hot(gate_e, E).float().sum(1) \
        .mean(0)
    aux = E * (frac_tokens * probs.mean(0)).sum() / cfg.top_k
    return y, aux


def _index_add(ye, table, n):
    d = ye.shape[-1]
    return torch.zeros((n + 1, d), dtype=ye.dtype).index_add(
        0, table.reshape(-1), ye.reshape(-1, d))[:n]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("capacity_factor", [0.5, 2.0],
                         ids=["drops", "no_drops"])
@pytest.mark.parametrize("arch,top_k", [("deepseek-v2-236b", 6),
                                        ("kimi-k2-1t-a32b", 8)])
def test_apply_moe_equals_the_index_add_combine(arch, top_k, capacity_factor,
                                                groups, dtype, monkeypatch):
    cfg = _cfg(arch, top_k, capacity_factor, groups)
    p, x = _params(cfg, DTYPES[dtype], top_k), _x(top_k, DTYPES[dtype])
    y, aux = MO.apply_moe(cfg, p, x)
    monkeypatch.setattr(MO, "_route_and_compute",
                        _route_and_compute_index_add)
    y_old, aux_old = MO.apply_moe(cfg, p, x)
    assert y.dtype == DTYPES[dtype] and torch.equal(y, y_old)
    assert torch.equal(aux, aux_old)
    n = B * T // groups
    dropped = n * top_k > EXPERTS * MO.capacity(cfg, n)
    assert dropped == (capacity_factor < 1)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("top_k", [3, 6, 8])
def test_combine_equals_index_add(top_k, dtype):
    """A random table of E × C slots, each token's picks in distinct
    experts, some dropped; the table's empty slots hold zeros, as the
    expert outputs of the pad row do."""
    rng = np.random.default_rng(top_k)
    n, E, d = 40, 12, 96
    C = n * top_k // E - 3
    gate_e = torch.from_numpy(np.stack([rng.permutation(E)[:top_k]
                                        for _ in range(n)]))
    e_s, order = torch.sort(gate_e.reshape(-1), stable=True)
    rank = torch.arange(n * top_k) \
        - torch.searchsorted(e_s, torch.arange(E))[e_s]
    keep = rank < C
    assert not keep.all()
    e_idx, r_idx = torch.where(keep, e_s, E), torch.where(keep, rank, 0)
    t_s = torch.arange(n).repeat_interleave(top_k)[order]
    table = torch.full((E + 1, C), n).index_put((e_idx, r_idx), t_s)[:E]
    ye = torch.from_numpy(rng.standard_normal((E, C, d)).astype(np.float32)
                          * rng.random((E, C, 1)).astype(np.float32))
    ye = ye.masked_fill((table == n)[..., None], 0).to(DTYPES[dtype])
    slots = MO.pick_slots(order, e_idx, r_idx, E, C, top_k)
    assert slots.shape == (n, top_k)
    assert bool((slots[:, 1:] >= slots[:, :-1]).all())
    assert torch.equal(MO.combine(ye, slots), _index_add(ye, table, n))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("capacity", [2, 40], ids=["drops", "no_drops"])
@pytest.mark.parametrize("top_k", [6, 8])
def test_a2a_combine_at_the_source_equals_index_add(top_k, capacity, dtype):
    """``moe_a2a._local``'s stage-1 tables for S = 4 destination ranks of
    16 experts: the combine of the returned rows, weighted, in
    (destination rank, slot) order; a token may send two picks to one
    rank."""
    rng = np.random.default_rng(10 + top_k)
    n, S, E, d = 24, 4, 16, 64
    gate_e = torch.from_numpy(np.stack([rng.permutation(E)[:top_k]
                                        for _ in range(n)]))
    e_flat = gate_e.reshape(-1)
    t_flat = torch.arange(n).repeat_interleave(top_k)
    w_flat = torch.from_numpy(rng.random(n * top_k).astype(np.float32))
    order, b_idx, r_idx = A2A._rank_in_bins(e_flat // (E // S), S, capacity)
    tok_tab = A2A._table(order, b_idx, r_idx, t_flat, S, capacity, n)
    w_tab = A2A._table(order, b_idx, r_idx, w_flat, S, capacity, 0.0)
    yback = torch.from_numpy(rng.standard_normal((S, capacity, d))
                             .astype(np.float32)).to(DTYPES[dtype])
    contrib = yback * w_tab[..., None].to(yback.dtype)
    got = MO.combine(contrib, MO.pick_slots(order, b_idx, r_idx, S, capacity,
                                            top_k))
    assert torch.equal(got, _index_add(contrib, tok_tab, n))


@pytest.mark.parametrize("arch,top_k", [("deepseek-v2-236b", 6),
                                        ("kimi-k2-1t-a32b", 8)])
def test_apply_moe_matches_reference_at_top_k(arch, top_k):
    over = dict(d_model=D, n_experts=EXPERTS, top_k=top_k, moe_d_ff=FF,
                capacity_factor=0.5)
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **over)
    pj = JMOE.init_moe(jcfg, jax.random.PRNGKey(top_k), jnp.float32)
    x = _x(top_k, torch.float32).numpy()
    yj, aj = JMOE.apply_moe(jcfg, pj, jnp.asarray(x))
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), pj)
    yt, at = MO.apply_moe(cfg, p, torch.from_numpy(x))
    scale = max(1.0, float(np.abs(np.asarray(yj)).max()))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5, atol=1e-5)
