"""Layer stacks: heterogeneous patterns (Jamba) over periods; the port of
``repro.models.transformer``.

Parameters keep the reference's stacked layout: one entry per pattern
position whose leaves have shape ``(n_periods, ...)``. The stack is a
Python loop over periods; each period indexes its slice of the weights,
and of the cache, whose slices are views, so a layer's in-place cache
writes land in the stacked tensors.
"""
from __future__ import annotations

import torch

from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import apply_mlp, apply_norm, init_mlp, init_norm, tree_map


# -- single layer -------------------------------------------------------------

def init_layer(cfg, ld, dtype, lead=()):
    d = cfg.d_model
    p = {"norm1": init_norm(cfg, d, dtype, lead)}
    if ld.mixer == "gqa":
        p["mixer"] = attn.init_gqa(cfg, dtype, lead)
    elif ld.mixer == "mla":
        p["mixer"] = attn.init_mla(cfg, dtype, lead)
    elif ld.mixer == "ssm":
        p["mixer"] = ssm_mod.init_ssm(cfg, dtype, lead)
    if ld.cross_attn:
        p["norm_x"] = init_norm(cfg, d, dtype, lead)
        p["cross"] = attn.init_cross(cfg, dtype, lead)
    if ld.mlp == "dense":
        p["norm2"] = init_norm(cfg, d, dtype, lead)
        p["mlp"] = init_mlp(cfg, d, cfg.d_ff, dtype, lead)
    elif ld.mlp == "moe":
        p["norm2"] = init_norm(cfg, d, dtype, lead)
        p["mlp"] = moe_mod.init_moe(cfg, dtype, lead)
    return p


def layer_cache_shapes(cfg, ld, B, S):
    """(shape, dtype; None: the cache's dtype) of each cache tensor of one
    layer."""
    c = {}
    if ld.mixer == "gqa":
        c["mixer"] = attn.gqa_cache_shapes(cfg, B, S)
    elif ld.mixer == "mla":
        c["mixer"] = attn.mla_cache_shapes(cfg, B, S)
    elif ld.mixer == "ssm":
        c["mixer"] = ssm_mod.ssm_cache_shapes(cfg, B)
    if ld.cross_attn:
        c["cross"] = attn.cross_cache_shapes(cfg, B)
    return c


def apply_layer(cfg, ld, p, x, positions, mode, cache=None, pos=None,
                memory=None, causal=True):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    h = apply_norm(cfg, p["norm1"], x)
    if ld.mixer == "gqa":
        y, _ = attn.apply_gqa(cfg, p["mixer"], h, positions, mode,
                              cache.get("mixer") if cache else None, pos,
                              causal=causal)
    elif ld.mixer == "mla":
        y, _ = attn.apply_mla(cfg, p["mixer"], h, positions, mode,
                              cache.get("mixer") if cache else None, pos)
    elif ld.mixer == "ssm":
        y, _ = ssm_mod.apply_ssm(cfg, p["mixer"], h, mode,
                                 cache.get("mixer") if cache else None)
    else:
        y = torch.zeros_like(x)
    x = x + y

    if ld.cross_attn:
        h = apply_norm(cfg, p["norm_x"], x)
        y, _ = attn.apply_cross(cfg, p["cross"], h, memory, mode,
                                cache.get("cross") if cache else None)
        x = x + y

    if ld.mlp == "dense":
        h = apply_norm(cfg, p["norm2"], x)
        x = x + apply_mlp(cfg, p["mlp"], h)
    elif ld.mlp == "moe":
        h = apply_norm(cfg, p["norm2"], x)
        y, aux_l = moe_mod.apply_moe(cfg, p["mlp"], h)
        x = x + y
        aux = aux + aux_l
    return x, aux


# -- stack --------------------------------------------------------------------

def init_stack(cfg, pattern, n_periods, dtype):
    """One entry per pattern position, leaves stacked over periods: leaf
    shape (n_periods, ...)."""
    return [init_layer(cfg, ld, dtype, lead=(n_periods,)) for ld in pattern]


def stack_cache_shapes(cfg, pattern, n_periods, B, S):
    return [tree_map(lambda sd: ((n_periods,) + sd[0], sd[1]),
                     layer_cache_shapes(cfg, ld, B, S)) for ld in pattern]


def apply_stack(cfg, pattern, params, x, positions, mode, caches=None,
                pos=None, memory=None, causal=True):
    """Loop over periods. Returns (x, caches, aux); ``caches`` is the
    argument, written in place."""
    n_periods = params[0]["norm1"]["scale"].shape[0]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_periods):
        for j, ld in enumerate(pattern):
            ps = tree_map(lambda a: a[i], params[j])
            cs = tree_map(lambda a: a[i], caches[j]) if caches else None
            x, a = apply_layer(cfg, ld, ps, x, positions, mode, cs, pos,
                               memory, causal)
            aux = aux + a
    return x, caches, aux
