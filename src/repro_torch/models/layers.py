"""Shared building blocks: norms, MLPs, initializers (the port of
``repro.models.layers``).

Parameters are described before they exist: every ``init_*`` function of
the model package returns a tree (nested dicts) of :class:`Init` leaves,
each the shape, dtype and initializer of one tensor, and
:func:`repro_torch.models.model.init_params` draws them. One description
thus gives the weights, the shapes ``params_from_reference`` checks, and
the stacked layout (a leading ``lead`` of ``(n_periods,)``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Init:
    """One parameter tensor to be made: ``kind`` "normal" (N(0, 1) in
    float32 times ``value``, then cast), "ones", "zeros" or "full"
    (``value``)."""
    shape: tuple
    dtype: torch.dtype
    kind: str
    value: float = 0.0


def dense_init(shape, dtype, scale=None, lead=()):
    """``repro.models.layers.dense_init``: the scale is ``fan_in ** -0.5``
    with ``fan_in`` the first axis of the unstacked shape."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else fan_in ** -0.5
    return Init(tuple(lead) + tuple(shape), dtype, "normal", scale)


def ones(shape, dtype, lead=()):
    return Init(tuple(lead) + tuple(shape), dtype, "ones")


def zeros(shape, dtype, lead=()):
    return Init(tuple(lead) + tuple(shape), dtype, "zeros")


def full(shape, value, dtype, lead=()):
    return Init(tuple(lead) + tuple(shape), dtype, "full", value)


def tree_map(fn, tree):
    """``fn`` on every leaf of a tree of dicts and lists (a tuple is a
    leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def mm(x, w):
    """``einsum("...d,df->...f", x, w)``; operands of two dtypes meet in the
    promoted one, as JAX promotes them."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def silu_as(x, like):
    """``jax.nn.silu(x.astype(float32)).astype(like.dtype)``."""
    return F.silu(x.float()).to(like.dtype)


# -- norms -------------------------------------------------------------------

def init_norm(cfg, d, dtype, lead=()):
    if cfg.norm == "layernorm":
        return {"scale": ones((d,), dtype, lead),
                "bias": zeros((d,), dtype, lead)}
    return {"scale": ones((d,), dtype, lead)}


def rms(xf, scale, eps=1e-5):
    """float32 RMS norm of ``xf`` times ``scale`` (float32 out)."""
    ms = xf.square().mean(-1, keepdim=True)
    return xf * torch.rsqrt(ms + eps) * scale.float()


def apply_norm(cfg, p, x, eps=1e-5):
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)  # jnp.var: population
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        y = rms(xf, p["scale"], eps)
    return y.to(x.dtype)


def gated_rmsnorm(x, z, scale, eps=1e-5):
    """Mamba2's RMSNormGated: norm(x * silu(z)); ``silu(z)`` is cast to
    ``x.dtype`` before the product."""
    return rms((x * silu_as(z, x)).float(), scale, eps).to(x.dtype)


# -- MLPs ----------------------------------------------------------------------

def init_mlp(cfg, d, ff, dtype, lead=()):
    if cfg.mlp_kind == "swiglu":
        return {"w_gate": dense_init((d, ff), dtype, lead=lead),
                "w_up": dense_init((d, ff), dtype, lead=lead),
                "w_down": dense_init((ff, d), dtype, lead=lead)}
    return {"w_in": dense_init((d, ff), dtype, lead=lead),
            "w_out": dense_init((ff, d), dtype, lead=lead)}


def apply_mlp(cfg, p, x):
    if cfg.mlp_kind == "swiglu":
        g = mm(x, p["w_gate"])
        u = mm(x, p["w_up"])
        return mm(silu_as(g, x) * u, p["w_down"])
    h = mm(x, p["w_in"])
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return mm(h, p["w_out"])
