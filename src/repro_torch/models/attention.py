"""Attention mixers: GQA (with RoPE / 2D-RoPE / sliding window), MLA
(DeepSeek-V2 compressed-KV latent attention) and cross-attention for the
encoder-decoder (Whisper) family; the port of ``repro.models.attention``.

The cache contract of the serving path, as in the reference, except that
a cache is updated in place (the port of the serve step's buffer
donation: the tensors a cache holds are allocated once and written):
  * ``mode="train"``  — full self-attention, no cache.
  * ``mode="prefill"`` — full self-attention over T tokens, written into
    the cache from slot 0 (a sliding window shorter than the prompt keeps
    the prompt's tail).
  * ``mode="decode"`` — ONE new token, written at ``pos`` (``pos % W``
    with a window). Past the cache's end the write lands on the last slot:
    ``jax.lax.dynamic_update_slice`` clamps its start index, and the port
    mirrors it.
"""
from __future__ import annotations

import math

import torch

from .layers import dense_init, mm, ones, rms

NEG_INF = -1e30


# -- RoPE --------------------------------------------------------------------

def rope_angles(positions, dim, theta):
    """positions (...,) -> cos/sin (..., dim/2)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, kind, theta):
    """x (B, T, H, hd); positions (B, T) or (T,). kind: standard|2d|none|
    learned ("2d" rotates the first half of the head only)."""
    if kind in ("none", "learned"):
        return x
    hd = x.shape[-1]
    rot = hd if kind == "standard" else hd // 2
    xr, xp = x[..., :rot], x[..., rot:]
    cos, sin = rope_angles(positions, rot, theta)          # (B, T, rot/2)
    cos = cos[..., None, :].to(x.dtype)
    sin = sin[..., None, :].to(x.dtype)
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return torch.cat([out, xp], -1) if rot < hd else out


# -- shared core ---------------------------------------------------------------

def _sdpa(q, k, v, mask):
    """q (B,T,H,hd), k/v (B,S,KV,hd) with H = KV * rep; mask (B,T,S)
    boolean (True = attend). Scores in the input dtype, then float32."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    rep = H // KV
    q = q.reshape(B, T, KV, rep, hd)
    scores = torch.einsum("btkrh,bskh->bkrts", q, k).float()
    scores = scores / math.sqrt(hd)
    scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkrts,bskh->btkrh", w, v)
    return out.reshape(B, T, H, hd)


def causal_mask(positions_q, positions_k):
    """True where query may attend key (pos_k <= pos_q)."""
    return positions_k[:, None, :] <= positions_q[:, :, None]


def clamp_slot(pos, size, width):
    """The start index ``jax.lax.dynamic_update_slice`` writes ``width``
    rows at: ``pos`` clamped to ``[0, size - width]``."""
    return min(max(int(pos), 0), size - width)


# -- GQA ----------------------------------------------------------------------

def init_gqa(cfg, dtype, lead=()):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": dense_init((d, H * hd), dtype, lead=lead),
            "wk": dense_init((d, KV * hd), dtype, lead=lead),
            "wv": dense_init((d, KV * hd), dtype, lead=lead),
            "wo": dense_init((H * hd, d), dtype, lead=lead)}


def gqa_cache_shapes(cfg, B, S):
    """(shape, None: the cache's dtype) of each cache tensor."""
    W = min(S, cfg.sliding_window) if cfg.sliding_window else S
    shape = ((B, W, cfg.n_kv_heads, cfg.head_dim), None)
    return {"k": shape, "v": shape}


def apply_gqa(cfg, p, x, positions, mode, cache=None, pos=None,
              causal=True):
    """positions (B, T) absolute; ``pos`` the decode write index (an int).
    Returns (y, cache) with ``cache`` written in place."""
    B, T, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = mm(x, p["wq"]).reshape(B, T, H, hd)
    k = mm(x, p["wk"]).reshape(B, T, KV, hd)
    v = mm(x, p["wv"]).reshape(B, T, KV, hd)
    q = apply_rope(q, positions, cfg.rope, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope, cfg.rope_theta)

    if mode in ("train", "prefill"):
        if causal:
            mask = causal_mask(positions, positions)
            if cfg.sliding_window:
                mask &= (positions[:, None, :]
                         > positions[:, :, None] - cfg.sliding_window)
        else:
            mask = torch.ones((B, T, T), dtype=torch.bool, device=x.device)
        out = _sdpa(q, k, v, mask)
        if mode == "prefill":
            W = cache["k"].shape[1]
            if W >= T:
                cache["k"][:, :T].copy_(k)
                cache["v"][:, :T].copy_(v)
            else:  # sliding window shorter than the prompt: keep the tail
                cache["k"].copy_(k[:, T - W:])
                cache["v"].copy_(v[:, T - W:])
    else:  # decode: T == 1, write at pos (mod window), attend over cache
        W = cache["k"].shape[1]
        slot = pos % W if cfg.sliding_window else clamp_slot(pos, W, 1)
        cache["k"][:, slot:slot + 1].copy_(k)
        cache["v"][:, slot:slot + 1].copy_(v)
        valid = torch.arange(W, device=x.device) <= min(pos, W - 1)
        mask = valid[None, None, :].expand(B, 1, W)
        out = _sdpa(q, cache["k"], cache["v"], mask)
    y = mm(out.reshape(B, T, H * hd), p["wo"])
    return y, cache


# -- cross-attention (whisper decoder) ----------------------------------------

def init_cross(cfg, dtype, lead=()):
    return init_gqa(cfg, dtype, lead)


def cross_cache_shapes(cfg, B):
    shape = ((B, cfg.n_frames, cfg.n_kv_heads, cfg.head_dim), None)
    return {"k": shape, "v": shape}


def apply_cross(cfg, p, x, memory, mode, cache=None):
    """memory: encoder output (B, S_enc, d); no positional rotation
    (whisper uses learned absolute positions). Prefill writes the memory's
    keys and values into the cache; decode reads them."""
    B, T, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = mm(x, p["wq"]).reshape(B, T, H, hd)
    if mode == "decode":
        k, v = cache["k"], cache["v"]
    else:
        S = memory.shape[1]
        k = mm(memory, p["wk"]).reshape(B, S, KV, hd)
        v = mm(memory, p["wv"]).reshape(B, S, KV, hd)
        if mode == "prefill":
            cache["k"].copy_(k)
            cache["v"].copy_(v)
    mask = torch.ones((B, T, k.shape[1]), dtype=torch.bool, device=x.device)
    out = _sdpa(q, k, v, mask)
    y = mm(out.reshape(B, T, H * hd), p["wo"])
    return y, cache


# -- MLA (DeepSeek-V2) ---------------------------------------------------------

def _mla_absorbed(cfg, p, q_nope, q_rope, c_all, kr_all, mask):
    """Decode-time weight absorption (DeepSeek-V2 §2.1.2): W^UK folded into
    the query and W^UV into the output, so attention runs on the
    compressed cache without expanding per-head keys and values."""
    B, T, H, qk = q_nope.shape
    r, rp = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    vh = cfg.v_head_dim
    wkv_b = p["wkv_b"].reshape(r, H, qk + vh)
    w_k, w_v = wkv_b[..., :qk], wkv_b[..., qk:]

    q_eff = torch.einsum("bthc,rhc->bthr", q_nope, w_k)     # absorb W^UK
    scores = (torch.einsum("bthr,bsr->bhts", q_eff, c_all)
              + torch.einsum("bthc,bsc->bhts", q_rope, kr_all)) \
        .float() / math.sqrt(qk + rp)
    scores = torch.where(mask[:, None, :, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(c_all.dtype)
    ctx = torch.einsum("bhts,bsr->bthr", w, c_all)          # attend in r-space
    out = torch.einsum("bthr,rhv->bthv", ctx, w_v)          # absorb W^UV
    return mm(out.reshape(B, T, H * vh), p["wo"])


def init_mla(cfg, dtype, lead=()):
    d, H = cfg.d_model, cfg.n_heads
    r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
    qk, rp, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq_a": dense_init((d, qr), dtype, lead=lead),
        "q_norm": ones((qr,), dtype, lead),
        "wq_b": dense_init((qr, H * (qk + rp)), dtype, lead=lead),
        "wkv_a": dense_init((d, r + rp), dtype, lead=lead),
        "kv_norm": ones((r,), dtype, lead),
        "wkv_b": dense_init((r, H * (qk + vh)), dtype, lead=lead),
        "wo": dense_init((H * vh, d), dtype, lead=lead),
    }


def mla_cache_shapes(cfg, B, S):
    return {"ckv": ((B, S, cfg.kv_lora_rank), None),
            "krope": ((B, S, cfg.qk_rope_head_dim), None)}


def _rms(x, scale, eps=1e-5):
    return rms(x.float(), scale, eps).to(x.dtype)


def apply_mla(cfg, p, x, positions, mode, cache=None, pos=None):
    """Compressed-KV attention: the cache holds c_kv (rank r) and the shared
    rope key."""
    B, T, d = x.shape
    H = cfg.n_heads
    r, rp = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    qk, vh = cfg.qk_nope_head_dim, cfg.v_head_dim

    # queries
    q_c = _rms(mm(x, p["wq_a"]), p["q_norm"])
    q = mm(q_c, p["wq_b"]).reshape(B, T, H, qk + rp)
    q_nope, q_rope = q[..., :qk], q[..., qk:]
    q_rope = apply_rope(q_rope, positions, "standard", cfg.rope_theta)

    # compressed kv for the current tokens
    kv_a = mm(x, p["wkv_a"])
    c_kv = _rms(kv_a[..., :r], p["kv_norm"])                  # (B, T, r)
    k_rope = apply_rope(kv_a[..., r:][:, :, None, :], positions, "standard",
                        cfg.rope_theta)[:, :, 0, :]           # (B, T, rp)

    if mode == "decode":
        S = cache["ckv"].shape[1]
        slot = clamp_slot(pos, S, T)
        cache["ckv"][:, slot:slot + T].copy_(c_kv)
        cache["krope"][:, slot:slot + T].copy_(k_rope)
        c_all, kr_all = cache["ckv"], cache["krope"]
        mask = (torch.arange(S, device=x.device) <= pos)[None, None, :] \
            .expand(B, T, S)
        if getattr(cfg, "mla_absorb", True):
            return _mla_absorbed(cfg, p, q_nope, q_rope, c_all, kr_all,
                                 mask), cache
    else:
        c_all, kr_all = c_kv, k_rope
        mask = causal_mask(positions, positions)
        if mode == "prefill":
            cache["ckv"][:, :T].copy_(c_kv)
            cache["krope"][:, :T].copy_(k_rope)

    # expand compressed cache to per-head keys/values
    kv = mm(c_all, p["wkv_b"]).reshape(B, -1, H, qk + vh)
    k_nope, v = kv[..., :qk], kv[..., qk:]

    scores = (torch.einsum("bthc,bshc->bhts", q_nope, k_nope)
              + torch.einsum("bthc,bsc->bhts", q_rope, kr_all)) \
        .float() / math.sqrt(qk + rp)
    scores = torch.where(mask[:, None, :, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhts,bshc->bthc", w, v).reshape(B, T, H * vh)
    return mm(out, p["wo"]), cache
