"""Top-level model: embeddings, frontend stubs (VLM patches / audio frames),
encoder (Whisper), decoder stack, LM head; the port of
``repro.models.model``.

  init_params(cfg, seed_or_generator, dtype, max_seq, device) -> Model
  init_cache(cfg, B, S, dtype, device)         -> decode cache tree
  forward(cfg, params, batch, remat=False)     -> (logits, aux)
  prefill(cfg, params, batch, cache)           -> (last_logits, cache)
  decode_step(cfg, params, tokens, cache, pos) -> (logits, cache)

``params`` is a :class:`Model` or the tree of tensors ``Model.tree()``
gives. A cache is written in place: ``prefill`` and ``decode_step`` return
the tree they were given.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..configs.base import LayerDef
from ..core.device import resolve_device
from .layers import (Init, apply_norm, dense_init, init_norm, mm, tree_map,
                     zeros)
from .transformer import apply_stack, init_stack, stack_cache_shapes

ENC_PATTERN = [LayerDef(mixer="gqa", mlp="dense", cross_attn=False)]
_SLAB = 1 << 27  # elements drawn at once in float32 (512 MiB)


def _dec_pattern(cfg):
    pat = cfg.pattern()
    if cfg.encoder_layers:  # whisper decoder layers get cross-attention
        pat = [LayerDef(mixer=ld.mixer, mlp=ld.mlp, cross_attn=True)
               for ld in pat]
    return pat


def param_specs(cfg, dtype=torch.bfloat16, max_seq=4096):
    """The tree of :class:`~repro_torch.models.layers.Init` leaves of
    ``cfg``'s parameters, keyed as ``repro.models.model.init_params``'s
    pytree."""
    d, V = cfg.d_model, cfg.vocab_size
    p = {
        "embed": dense_init((V, d), dtype, scale=0.02),
        "final_norm": init_norm(cfg, d, dtype),
        "lm_head": dense_init((d, V), dtype),
    }
    if cfg.modality == "vision":
        p["projector"] = {"w": dense_init((cfg.frontend_dim, d), dtype),
                          "b": zeros((d,), dtype)}
    if cfg.rope == "learned":
        p["dec_pos"] = dense_init((max_seq, d), dtype, scale=0.02)
    if cfg.encoder_layers:
        p["enc_pos"] = dense_init((cfg.n_frames, d), dtype, scale=0.02)
        p["encoder"] = init_stack(cfg, ENC_PATTERN, cfg.encoder_layers, dtype)
        p["enc_norm"] = init_norm(cfg, d, dtype)
    p["layers"] = init_stack(cfg, _dec_pattern(cfg), cfg.n_periods, dtype)
    return p


def _make(spec: Init, gen, device):
    out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
    if spec.kind == "ones":
        return out.fill_(1)
    if spec.kind == "zeros":
        return out.zero_()
    if spec.kind == "full":
        return out.fill_(spec.value)
    # N(0, 1) in float32 times the scale, cast: drawn in slabs so that a
    # large leaf needs no float32 copy of itself
    flat = out.view(-1)
    for i in range(0, flat.numel(), _SLAB):
        part = flat[i:i + _SLAB]
        part.copy_(torch.randn(part.shape, generator=gen, device=device,
                               dtype=torch.float32) * spec.value)
    return out


class Params(nn.Module):
    """A tree of dicts (and lists) of tensors held as submodules and
    ``nn.Parameter``s (``requires_grad=False`` until :func:`trainable`):
    ``state_dict()`` keys are the reference's pytree paths joined by
    ``.``, e.g. ``layers.0.mixer.wq``. :meth:`tree` gives the tree back,
    reading each leaf through ``getattr`` so that
    ``torch.func.functional_call``'s substitutes are what it returns."""

    def __init__(self, tree: dict):
        super().__init__()
        self._names = list(tree)
        for name, v in tree.items():
            if isinstance(v, dict):
                self.add_module(name, Params(v))
            elif isinstance(v, (list, tuple)):
                self.add_module(name, nn.ModuleList(Params(x) for x in v))
            else:
                self.register_parameter(
                    name, nn.Parameter(v, requires_grad=False))

    def tree(self) -> dict:
        out = {}
        for name in self._names:
            v = getattr(self, name)
            if isinstance(v, Params):
                v = v.tree()
            elif isinstance(v, nn.ModuleList):
                v = [m.tree() for m in v]
            out[name] = v
        return out


class Model(Params):
    """The parameters of one config. Calling it runs one of ``forward``,
    ``prefill``, ``decode_step`` or ``encode`` on them: ``model("prefill",
    batch, cache)`` is ``prefill(model.cfg, model.tree(), batch, cache)``,
    the entry ``torch.func.functional_call`` reaches."""

    def __init__(self, cfg, tree: dict):
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, op: str, *args):
        fns = {"forward": forward, "prefill": prefill,
               "decode_step": decode_step, "encode": encode}
        if op not in fns:
            raise ValueError(f"unknown op {op!r}; one of {sorted(fns)}")
        return fns[op](self.cfg, self.tree(), *args)


def draw(specs, seed_or_generator=0, device="cuda"):
    """The tensors of a tree of :class:`~repro_torch.models.layers.Init`
    leaves, drawn in the tree's order on ``device`` with an explicit
    ``torch.Generator`` (an int seeds a new one)."""
    dev = resolve_device(device)
    gen = seed_or_generator
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(gen))
    return tree_map(lambda s: _make(s, gen, dev), specs)


def init_params(cfg, seed_or_generator=0, dtype=torch.bfloat16,
                max_seq=4096, device="cuda") -> Model:
    """Random weights at ``dense_init``'s scales (:func:`draw`)."""
    return Model(cfg, draw(param_specs(cfg, dtype, max_seq),
                           seed_or_generator, device))


def cache_shapes(cfg, B, S, dtype=torch.bfloat16):
    """The tree of (shape, dtype) of ``init_cache``'s tensors."""
    return {"layers": tree_map(
        lambda sd: (sd[0], sd[1] or dtype),
        stack_cache_shapes(cfg, _dec_pattern(cfg), cfg.n_periods, B, S))}


def init_cache(cfg, B, S, dtype=torch.bfloat16, device="cuda"):
    dev = resolve_device(device)
    return tree_map(lambda sd: torch.zeros(sd[0], dtype=sd[1], device=dev),
                    cache_shapes(cfg, B, S, dtype))


def trainable(params, flag: bool = True):
    """``params`` (a :class:`Model` or a tree of tensors) with every leaf's
    ``requires_grad`` set to ``flag``, in place; returns ``params``. A
    model is drawn frozen, for serving; a train step differentiates only
    leaves made trainable."""
    if isinstance(params, nn.Module):
        return params.requires_grad_(flag)
    tree_map(lambda t: t.requires_grad_(flag), params)
    return params


def _tree(params):
    return params.tree() if isinstance(params, Params) else params


def _take_fill(table, idx):
    """``jnp.take(table, idx, axis=0)``: rows past the end are NaN (the
    reference's default ``mode="fill"``), not an error."""
    n = table.shape[0]
    rows = table[idx.clamp(0, n - 1)]
    return torch.where((idx < n)[..., None], rows, math.nan)


def encode(cfg, params, frames):
    """Whisper encoder over STUB conv-frontend frame embeddings
    (B, n_frames, d_model)."""
    params = _tree(params)
    enc_pos = params["enc_pos"]
    frames = torch.as_tensor(frames, device=enc_pos.device)
    x = frames.to(torch.promote_types(frames.dtype, enc_pos.dtype)) \
        + enc_pos[None]
    pos = torch.arange(frames.shape[1], device=x.device)[None] \
        .expand(frames.shape[:2])
    x, _, _ = apply_stack(cfg, ENC_PATTERN, params["encoder"], x, pos,
                          "train", causal=False)
    return apply_norm(cfg, params["enc_norm"], x)


def _embed(cfg, params, tokens, positions):
    x = params["embed"][tokens.long()]
    if cfg.rope == "learned":
        x = x + _take_fill(params["dec_pos"], positions)
    return x


def _assemble_inputs(cfg, params, batch):
    """Returns (x, positions, memory, n_prefix).

    vision: projected patch embeddings are prepended to the text tokens;
    logits for the text part only. audio: memory = encoded frames for
    cross-attention."""
    dev = params["embed"].device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    B, T = tokens.shape
    memory = None
    n_prefix = 0
    if cfg.modality == "vision" and "patches" in batch:
        patches = torch.as_tensor(batch["patches"], device=dev)
        proj = mm(patches, params["projector"]["w"])
        proj = proj + params["projector"]["b"].to(proj.dtype)
        n_prefix = proj.shape[1]
        positions = torch.arange(T + n_prefix, device=dev)[None] \
            .expand(B, T + n_prefix)
        x = torch.cat([proj.to(params["embed"].dtype),
                       _embed(cfg, params, tokens, positions[:, n_prefix:])],
                      1)
    else:
        positions = torch.arange(T, device=dev)[None].expand(B, T)
        x = _embed(cfg, params, tokens, positions)
    if cfg.encoder_layers and "frames" in batch:
        memory = encode(cfg, params, batch["frames"])
    return x, positions, memory, n_prefix


def forward(cfg, params, batch, remat=False):
    """Logits over every position (text positions only for a VLM: patch
    positions are sliced off) and the MoE auxiliary loss. With ``remat``
    each period of the decoder stack recomputes its activations in the
    backward pass (``apply_stack``)."""
    params = _tree(params)
    x, positions, memory, n_prefix = _assemble_inputs(cfg, params, batch)
    x, _, aux = apply_stack(cfg, _dec_pattern(cfg), params["layers"], x,
                            positions, "train", memory=memory, remat=remat)
    x = apply_norm(cfg, params["final_norm"], x)
    if n_prefix:
        x = x[:, n_prefix:]
    return mm(x, params["lm_head"]), aux


def prefill(cfg, params, batch, cache):
    """Fill the cache from the prompt; return last-token logits + cache."""
    params = _tree(params)
    x, positions, memory, n_prefix = _assemble_inputs(cfg, params, batch)
    x, _, _ = apply_stack(cfg, _dec_pattern(cfg), params["layers"], x,
                          positions, "prefill", caches=cache["layers"],
                          memory=memory)
    x = apply_norm(cfg, params["final_norm"], x[:, -1:])
    return mm(x, params["lm_head"]), cache


def decode_step(cfg, params, tokens, cache, pos: int):
    """ONE token (B, 1) against a cache of capacity S, written at ``pos``
    in place (the port of the reference's donated cache)."""
    params = _tree(params)
    tokens = torch.as_tensor(tokens, device=params["embed"].device)
    B = tokens.shape[0]
    positions = torch.full((B, 1), int(pos), dtype=torch.long,
                           device=tokens.device)
    x = _embed(cfg, params, tokens, positions)
    x, _, _ = apply_stack(cfg, _dec_pattern(cfg), params["layers"], x,
                          positions, "decode", caches=cache["layers"],
                          pos=int(pos))
    x = apply_norm(cfg, params["final_norm"], x)
    return mm(x, params["lm_head"]), cache
