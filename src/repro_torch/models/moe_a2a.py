"""Expert-parallel MoE with an explicit all-to-all dispatch; the port of
``repro.models.moe_a2a``.

The canonical two-hop expert-parallel schedule, the way Megatron/DeepSpeed
structure it: tokens split over the 'model' axis (each of its S ranks owns
n/S of them) → route locally → pack per-destination-rank slabs →
all_to_all → second-stage dispatch to the rank's local experts → grouped
FFN → inverse scatter → all_to_all back → weighted combine at the source.
The router is replicated; each rank routes its own token slice, so no
compute is duplicated and every token is owned by exactly one rank.

The reference runs this body under ``shard_map`` over the model axis.
Here each rank is one process and calls :func:`moe_all_to_all` with the
same arguments: the full ``x`` and either every expert's weights or only
its own E/S (the expert dimension of ``w_gate`` / ``w_up`` / ``w_down``
says which). It takes its token slice, runs the body, and gathers the
slices, so every rank returns what the reference's global function
returns. The collectives are ``torch.distributed.nn.functional``'s, which
carry gradients.

Numerically :func:`~repro_torch.models.moe.apply_moe` up to the capacity
policy: stage 1's capacity is per destination rank, not per expert.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .layers import apply_mlp, silu_as
from .moe import combine, pick_slots


def _rank_in_bins(ids, n_bins, capacity):
    """Stable-sort ids into bins, rank within bin, drop beyond capacity.
    Returns (order, bin_idx, rank_idx) where dropped entries map to the
    dummy bin ``n_bins`` / rank 0."""
    ids_s, order = torch.sort(ids, stable=True)
    starts = torch.searchsorted(
        ids_s, torch.arange(n_bins, device=ids.device, dtype=ids.dtype),
        side="left")
    rank = torch.arange(ids.shape[0], device=ids.device) \
        - starts[ids_s.clamp(0, n_bins - 1)]
    keep = (rank < capacity) & (ids_s < n_bins)
    return order, torch.where(keep, ids_s, n_bins), torch.where(keep, rank, 0)


def _table(order, b_idx, r_idx, payload, n_bins, capacity, fill):
    """(n_bins, capacity) table of ``payload`` placed at (bin, rank);
    empty slots hold ``fill``, dropped entries land in a dummy row."""
    return torch.full((n_bins + 1, capacity), fill, dtype=payload.dtype,
                      device=payload.device) \
        .index_put((b_idx, r_idx), payload[order])[:n_bins]


class _Comm:
    """The collectives of one mesh axis's group (any backend: gloo takes
    CUDA tensors too)."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)

    def all_to_all(self, t):
        """Slab s of ``t`` (dim 0, S slabs) to rank s; slab s of the result
        came from rank s."""
        from torch.distributed.nn.functional import all_to_all_single
        t = t.contiguous()
        return all_to_all_single(torch.empty_like(t), t, group=self.group)

    def all_gather(self, t):
        """Each rank's ``t`` concatenated along dim 0, in rank order."""
        from torch.distributed.nn.functional import all_gather
        return torch.cat(all_gather(t.contiguous(), group=self.group), 0)

    def mean(self, t):
        from torch.distributed.nn.functional import all_reduce
        return all_reduce(t, group=self.group) / self.size


def _local(cfg, xf, router, w_gate, w_up, w_down, comm, E_loc, C1, C2):
    """One rank's body: xf (n_loc, d) its tokens; experts (E_loc, ...) its
    own. Returns (y (n_loc, d), aux averaged over the axis)."""
    S, E, k = comm.size, cfg.n_experts, cfg.top_k
    n_loc, d = xf.shape
    dev = xf.device
    logits = xf.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_e = torch.topk(probs, k, dim=-1)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True)

    e_flat = gate_e.reshape(-1)                            # (n_loc·k,)
    t_flat = torch.arange(n_loc, device=dev).repeat_interleave(k)
    w_flat = gate_w.reshape(-1)
    dest = e_flat // E_loc

    # --- stage 1: pack per-destination slabs -------------------------------
    order, b_idx, r_idx = _rank_in_bins(dest, S, C1)
    tok_tab = _table(order, b_idx, r_idx, t_flat, S, C1, n_loc)
    eloc_tab = _table(order, b_idx, r_idx, e_flat % E_loc, S, C1, E_loc)
    w_tab = _table(order, b_idx, r_idx, w_flat, S, C1, 0.0)

    xp = torch.cat([xf, xf.new_zeros((1, d))], 0)
    xsend = xp[tok_tab]                                    # (S, C1, d)

    # --- all_to_all: slab s -> model rank s --------------------------------
    xrecv = comm.all_to_all(xsend)                         # (S, C1, d)
    erecv = comm.all_to_all(eloc_tab)

    # --- stage 2: dispatch received tokens to local experts ----------------
    m = S * C1
    order2, b2, r2 = _rank_in_bins(erecv.reshape(m), E_loc, C2)
    slot_tab = _table(order2, b2, r2, torch.arange(m, device=dev), E_loc,
                      C2, m)
    xr = torch.cat([xrecv.reshape(m, d), xf.new_zeros((1, d))], 0)
    xe = xr[slot_tab]                                      # (E_loc, C2, d)

    h = silu_as(torch.bmm(xe, w_gate), xe) * torch.bmm(xe, w_up)
    ye = torch.bmm(h, w_down)

    # --- inverse stage 2 + return a2a + combine at source ------------------
    ybuf = ye.new_zeros((m + 1, d)).index_add(
        0, slot_tab.reshape(-1), ye.reshape(-1, d))[:m]
    yback = comm.all_to_all(ybuf.reshape(S, C1, d))
    contrib = yback * w_tab[..., None].to(yback.dtype)
    y = combine(contrib, pick_slots(order, b_idx, r_idx, S, C1, k))

    frac_tokens = F.one_hot(gate_e, E).float().sum(1).mean(0)
    aux = E * (frac_tokens * probs.mean(0)).sum() / k
    return y, comm.mean(aux)


def moe_all_to_all(cfg, p, x, mesh, axis="model"):
    """x (B, T, d) -> (y, aux), on every rank of ``mesh``'s ``axis``.
    Requires n_experts % S == 0 and (B·T) % S == 0 for the axis size S."""
    S = mesh.size(mesh.mesh_dim_names.index(axis))
    r = mesh.get_local_rank(axis)
    E, k = cfg.n_experts, cfg.top_k
    assert E % S == 0, (E, S)
    E_loc = E // S
    B, T, d = x.shape
    n = B * T
    assert n % S == 0, (n, S)
    n_loc = n // S
    C1 = max(int(n_loc * k / S * cfg.capacity_factor), k)   # per dest rank
    C2 = max(int(S * C1 / E_loc * cfg.capacity_factor), 1)  # per local expert

    def mine(w):
        if w.shape[0] == E_loc:
            return w
        assert w.shape[0] == E, (w.shape, E)
        return w[r * E_loc:(r + 1) * E_loc]

    comm = _Comm(mesh.get_group(axis))
    xf = x.reshape(n, d)
    y, aux = _local(cfg, xf[r * n_loc:(r + 1) * n_loc], p["router"],
                    mine(p["w_gate"]), mine(p["w_up"]), mine(p["w_down"]),
                    comm, E_loc, C1, C2)
    y = comm.all_gather(y)
    if cfg.n_shared_experts:
        y = y + apply_mlp(cfg, p["shared"], xf)
    return y.reshape(B, T, d), aux
