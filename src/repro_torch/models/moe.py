"""Mixture-of-Experts (the port of ``repro.models.moe``): top-k routing with
a static per-expert capacity; dispatch by gather, and a combine that sums
each token's picks in a fixed order (:func:`combine`), so the work scales
with the capacity slots, not with the tokens times the experts. With
``A2A_MESH`` set, the expert-parallel all-to-all dispatch of
:mod:`~repro_torch.models.moe_a2a` runs instead.
"""
from __future__ import annotations

import torch

from .layers import apply_mlp, dense_init, init_mlp, silu_as


def init_moe(cfg, dtype, lead=()):
    d, E, eff = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    p = {
        "router": dense_init((d, E), torch.float32, lead=lead),  # fp32
        "w_gate": dense_init((E, d, eff), dtype, lead=lead),
        "w_up": dense_init((E, d, eff), dtype, lead=lead),
        "w_down": dense_init((E, eff, d), dtype, lead=lead),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(cfg, d, cfg.n_shared_experts * eff, dtype,
                               lead)
    return p


def capacity(cfg, n_tokens: int) -> int:
    c = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(c, cfg.top_k)


def router_logits(xf, router):
    """The router's logits (n, E) of the tokens xf (n, d), in float32."""
    return xf.float() @ router.float()


def pick_slots(order, bins, ranks, n_bins, capacity, k):
    """Each token's k picks as flat slots ``bin * capacity + rank`` of an
    (n_bins, capacity) table, (n, k), ascending: the table's row-major
    order. ``order`` is the stable sort of the token-major assignments by
    bin, ``bins`` / ``ranks`` their place in sorted order, a dropped one
    at bin ``n_bins``, rank 0: its slot is ``n_bins * capacity``, the zero
    row of :func:`combine`."""
    flat = bins * capacity + ranks
    slots = torch.zeros_like(flat).index_put((order,), flat)
    return slots.reshape(-1, k).sort(-1).values


def combine(ye, slots):
    """The tokens' outputs (n, d) from the table of weighted expert outputs
    ``ye`` (bins, capacity, d): row t sums the table's rows at ``slots[t]``
    (:func:`pick_slots`; the slot past the table reads a zero row), in
    their order, by one reduction over the picks. That is the order in
    which the CPU's ``index_add`` over the table's token ids adds them,
    and the same bits on every run: on the card ``index_add`` adds by
    atomics, in whichever order they land."""
    d = ye.shape[-1]
    rows = torch.cat([ye.reshape(-1, d), ye.new_zeros((1, d))], 0)
    return rows[slots].sum(1)


def _route_and_compute(cfg, p, xf, C):
    """Dispatch + expert FFN + combine for one token group xf (n, d)."""
    n, d = xf.shape
    E, k = cfg.n_experts, cfg.top_k
    dev = xf.device

    logits = router_logits(xf, p["router"])
    probs = torch.softmax(logits, dim=-1)                      # (n, E)
    gate_w, gate_e = torch.topk(probs, k, dim=-1)              # (n, k)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True)

    # Flatten assignments, rank tokens within their expert, drop overflow.
    e_flat = gate_e.reshape(-1)                                # (n*k,)
    t_flat = torch.arange(n, device=dev).repeat_interleave(k)
    w_flat = gate_w.reshape(-1)
    e_s, order = torch.sort(e_flat, stable=True)
    t_s, w_s = t_flat[order], w_flat[order]
    starts = torch.searchsorted(e_s, torch.arange(E, device=dev),
                                side="left")
    rank = torch.arange(n * k, device=dev) - starts[e_s]
    keep = rank < C
    e_idx = torch.where(keep, e_s, E)          # dropped -> dummy expert row
    r_idx = torch.where(keep, rank, 0)

    # the tables are written out of place (index_put): the same values, and
    # a sharded dry run keeps the layout of the result (launch/dryrun.py)
    dispatch = torch.full((E + 1, C), n, dtype=torch.long, device=dev) \
        .index_put((e_idx, r_idx), t_s)[:E]
    w_disp = torch.zeros((E + 1, C), dtype=torch.float32, device=dev) \
        .index_put((e_idx, r_idx), w_s)[:E]

    xp = torch.cat([xf, xf.new_zeros((1, d))], 0)              # pad row
    xe = xp[dispatch]                                          # (E, C, d)

    # each (E, C, ·) slab is freed as soon as it is used, and the products
    # are taken in place: the same arithmetic at a third of the peak
    h = silu_as(torch.bmm(xe, p["w_gate"]), xe)
    h.mul_(torch.bmm(xe, p["w_up"]))
    del xe
    ye = torch.bmm(h, p["w_down"])
    del h
    ye.mul_(w_disp[..., None].to(ye.dtype))

    y = combine(ye, pick_slots(order, e_idx, r_idx, E, C, k))

    # Switch-style load-balance loss.
    frac_tokens = torch.nn.functional.one_hot(gate_e, E).float().sum(1) \
        .mean(0)
    frac_probs = probs.mean(0)
    aux = E * (frac_tokens * frac_probs).sum() / cfg.top_k
    return y, aux


# When set to a DeviceMesh with a 'model' axis, apply_moe routes through
# the explicit all-to-all dispatch (models/moe_a2a.py) on every rank of
# that axis. Set by the caller around the step, as the reference's dry
# run and hill climb set their own.
A2A_MESH = None


def apply_moe(cfg, p, x):
    """x (B, T, d) -> (y (B, T, d), aux_loss scalar fp32).

    With ``cfg.moe_groups = G > 1`` the tokens are split into G groups
    (batch-major) and every group routes with a group-local capacity."""
    B, T, d = x.shape
    n = B * T
    if A2A_MESH is not None:
        S = dict(zip(A2A_MESH.mesh_dim_names, A2A_MESH.shape)).get("model", 1)
        if S > 1 and cfg.n_experts % S == 0 and n % S == 0:
            from .moe_a2a import moe_all_to_all
            return moe_all_to_all(cfg, p, x, A2A_MESH)
    G = cfg.moe_groups if cfg.moe_groups and cfg.moe_groups > 1 else 1
    if G > 1 and n % G == 0 and (n // G) >= cfg.top_k:
        C = capacity(cfg, n // G)
        outs = [_route_and_compute(cfg, p, xf, C)
                for xf in x.reshape(G, n // G, d)]
        y = torch.cat([o[0] for o in outs], 0)
        aux = torch.stack([o[1] for o in outs]).mean()
    else:
        y, aux = _route_and_compute(cfg, p, x.reshape(n, d), capacity(cfg, n))

    if cfg.n_shared_experts:
        y = y + apply_mlp(cfg, p["shared"], x.reshape(n, d))

    return y.reshape(B, T, d), aux
