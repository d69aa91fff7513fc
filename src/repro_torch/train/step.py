"""Loss + train step (the port of ``repro.train.step``).

The reference's step is one jitted program with params and optimizer state
donated. Here ``train_step`` takes the gradients of the loss with
``torch.autograd.grad`` over the parameter leaves (nothing accumulates in
``.grad``) and :func:`repro_torch.optim.adamw.update` writes params and
state in place: the step returns the tensors it was given.
"""
from __future__ import annotations

import torch

from ..models import model as M
from ..models.layers import apply_norm, mm, tree_leaves, tree_map
from ..models.transformer import apply_stack
from ..optim import adamw

AUX_WEIGHT = 0.01  # MoE load-balance loss weight


def _chunked_ce(x, lm_head, labels, chunk: int):
    """Cross-entropy WITHOUT materializing the full (tokens, V) float32
    logits: the vocabulary is processed in static chunks with a running
    max and denominator (the online-softmax identity, exact). The gold
    logit is a gather of the label columns of ``lm_head``, one dot a
    token."""
    V = lm_head.shape[-1]
    B, T, _ = x.shape
    m = torch.full((B, T), -torch.inf, dtype=torch.float32, device=x.device)
    s = torch.zeros((B, T), dtype=torch.float32, device=x.device)
    for k0 in range(0, V, chunk):
        lg = mm(x, lm_head[:, k0:k0 + chunk]).float()
        m_new = torch.maximum(m, lg.amax(-1))
        s = s * torch.exp(m - m_new) \
            + torch.exp(lg - m_new[..., None]).sum(-1)
        m = m_new
    logz = m + torch.log(s)
    w_gold = lm_head.t()[labels]                     # (B, T, d)
    dt = torch.promote_types(x.dtype, w_gold.dtype)
    gold = torch.einsum("btd,btd->bt", x.to(dt), w_gold.to(dt)).float()
    return torch.mean(logz - gold)


def loss_fn(cfg, params, batch, remat=False, chunked_ce: int = 0):
    """(loss, {"ce", "aux"}): mean next-token cross-entropy plus
    ``AUX_WEIGHT`` times the MoE load-balance loss."""
    params = M._tree(params)
    labels = torch.as_tensor(batch["labels"],
                             device=params["embed"].device).long()
    if chunked_ce:
        x, positions, memory, n_prefix = M._assemble_inputs(cfg, params,
                                                            batch)
        x, _, aux = apply_stack(cfg, M._dec_pattern(cfg), params["layers"],
                                x, positions, "train", memory=memory,
                                remat=remat)
        x = apply_norm(cfg, params["final_norm"], x)
        if n_prefix:
            x = x[:, n_prefix:]
        ce = _chunked_ce(x, params["lm_head"], labels, chunked_ce)
    else:
        logits, aux = M.forward(cfg, params, batch, remat=remat)
        logits = logits.float()
        logz = torch.logsumexp(logits, -1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        ce = torch.mean(logz - gold)
    loss = ce + AUX_WEIGHT * aux
    return loss, {"ce": ce, "aux": aux}


def grads_of(cfg, params, batch, remat=False, chunked_ce: int = 0):
    """(loss, parts, grads): the loss and the gradient tree of every leaf
    of ``params`` (zeros where a leaf does not reach the loss). Every leaf
    must require grad (:func:`repro_torch.models.model.trainable`)."""
    tree = M._tree(params)
    leaves = tree_leaves(tree)
    frozen = sum(not t.requires_grad for t in leaves)
    if frozen:
        raise ValueError(f"{frozen} of {len(leaves)} parameter leaves do not "
                         "require grad; make them trainable first "
                         "(repro_torch.models.model.trainable)")
    with torch.enable_grad():
        loss, parts = loss_fn(cfg, tree, batch, remat=remat,
                              chunked_ce=chunked_ce)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, got))
    grads = tree_map(lambda _: next(it), tree)
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, remat=False,
                    chunked_ce: int = 0):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; params and state are updated in place and returned.
    ``metrics``: ``loss``, ``ce``, ``aux``, ``lr``, ``grad_norm`` (0-d
    tensors on the parameters' device)."""

    def train_step(params, opt_state, batch):
        loss, parts, grads = grads_of(cfg, params, batch, remat=remat,
                                      chunked_ce=chunked_ce)
        params, opt_state, opt_m = adamw.update(opt_cfg, grads, opt_state,
                                                params)
        return params, opt_state, {"loss": loss, **parts, **opt_m}

    return train_step


def make_eval_step(cfg):
    @torch.no_grad()
    def eval_step(params, batch):
        loss, parts = loss_fn(cfg, params, batch)
        return {"loss": loss, **parts}
    return eval_step
