"""AdamW + cosine schedule on trees of tensors (the port of
``repro.optim.adamw``).

The reference donates params and optimizer state to its jitted step; here
:func:`update` writes them in place, leaf by leaf, and returns the same
tensors. The gradients it is given are its scratch: each is scaled in
place, so the transient memory of an update is one float32 leaf on top of
what the caller already holds.

The arithmetic is the reference's float32 arithmetic: the step is an int32
tensor, ``b1 ** step`` a float32 power, the schedule's ``where`` and the
clip ``min(1, clip / (gnorm + 1e-9))`` on float32 tensors. Weight decay
goes to every leaf with ``ndim >= 2``, as in the reference, which on the
stacked ``(n_periods, d)`` norm scales and biases decays them too
(ROADMAP Queue 3).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..models.layers import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    grad_clip: float = 1.0


def _recip(n: int) -> float:
    """``1 / n`` rounded to float32 (as XLA folds it)."""
    return float(np.float32(1) / np.float32(n))


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_frac``; float32, as
    the reference's jitted step computes it: XLA turns each division by a
    constant into a product with its float32 reciprocal and contracts
    ``a + b * c`` into one FMA (``addcmul`` rounds once as well). The
    cosine is float64 rounded to float32, which XLA's float32 cosine
    meets but for one value in about a hundred (by one ulp)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step * _recip(max(cfg.warmup_steps, 1))
    t = (step - cfg.warmup_steps) \
        * _recip(max(cfg.total_steps - cfg.warmup_steps, 1))
    t = t.clamp(0.0, 1.0)
    cos = torch.addcmul(torch.tensor(cfg.min_lr_frac, device=step.device),
                        1 + torch.cos((math.pi * t).double()).float(),
                        torch.tensor((1 - cfg.min_lr_frac) * 0.5,
                                     device=step.device))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params) -> dict:
    """Zero moments in float32, one per leaf of ``params`` (same tree), and
    an int32 step."""
    tree = params.tree() if hasattr(params, "tree") else params
    leaves = tree_leaves(tree)
    dev = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return {"mu": tree_map(zeros, tree), "nu": tree_map(zeros, tree),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of the sum of squares, in float32."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: dict, params):
    """One AdamW step: params, ``state["mu"]``, ``state["nu"]`` and
    ``state["step"]`` are written in place and returned, with
    ``{"lr", "grad_norm"}`` (the norm before clipping). ``grads`` (a tree
    like ``params``) is overwritten."""
    tree = params.tree() if hasattr(params, "tree") else params
    state["step"].add_(1)
    step = state["step"]
    lr = schedule(cfg, step)

    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)

    dev = step.device
    b1, b2, wd = (torch.tensor(v, device=dev)
                  for v in (cfg.b1, cfg.b2, cfg.weight_decay))
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    neg_lr = -lr

    # the reference's jitted update, as XLA rewrites it: each ``a * b + c``
    # one FMA (addcmul), and (mu / bc1) / (sqrt(nu / bc2) + eps) as
    # mu / (bc1 * (sqrt(nu / bc2) + eps))
    for g, mu, nu, p in zip(tree_leaves(grads), tree_leaves(state["mu"]),
                            tree_leaves(state["nu"]), tree_leaves(tree),
                            strict=True):
        g = g.float() if g.dtype != torch.float32 else g
        g.mul_(scale)
        tmp = g * (1 - cfg.b1)
        torch.addcmul(tmp, mu, b1, out=mu)
        torch.mul(g, g, out=tmp).mul_(1 - cfg.b2)
        torch.addcmul(tmp, nu, b2, out=nu)
        del tmp
        torch.div(nu, bc2, out=g).sqrt_().add_(cfg.eps).mul_(bc1)
        delta = torch.div(mu, g, out=g)
        p32 = p if p.dtype == torch.float32 else p.float()
        if p.ndim >= 2:  # decay matrices only (and the stacked norms)
            torch.addcmul(delta, p32, wd, out=delta)
        torch.addcmul(p32, delta, neg_lr, out=p32)
        if p32 is not p:
            p.copy_(p32)
        del g, delta, p32
    return params, state, {"lr": lr, "grad_norm": gnorm}
