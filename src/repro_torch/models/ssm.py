"""Mamba2 SSD mixer (state-space duality, arXiv:2405.21060); the port of
``repro.models.ssm``.

Prefill uses the chunked SSD algorithm: quadratic attention-like math
inside short chunks and a linear recurrence over chunk states (a Python
loop where the reference has ``lax.scan``). Decode is the O(1) recurrent
update of the cached (conv, state) pair, written in place. A step-by-step
recurrence is the test oracle.

Recurrence (per head h, head channels P, state N):
    a_t = exp(A * dt_t)                       A < 0 scalar per head
    h_t = a_t h_{t-1} + dt_t * x_t ⊗ B_t
    y_t = h_t · C_t + D x_t
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import dense_init, full, gated_rmsnorm, mm, ones, zeros


def dims(cfg):
    di = cfg.d_inner
    H = cfg.ssm_heads
    P = cfg.ssm_head_dim
    N = cfg.ssm_state
    G = 1
    conv_dim = di + 2 * G * N
    return di, H, P, N, G, conv_dim


def init_ssm(cfg, dtype, lead=()):
    d = cfg.d_model
    di, H, P, N, G, conv_dim = dims(cfg)
    f32 = torch.float32
    return {
        "w_in": dense_init((d, 2 * di + 2 * G * N + H), dtype, lead=lead),
        "conv_w": dense_init((cfg.ssm_conv_kernel, conv_dim), dtype,
                             scale=0.5, lead=lead),
        "conv_b": zeros((conv_dim,), dtype, lead),
        "A_log": zeros((H,), f32, lead),          # A = -exp(A_log) = -1
        "dt_bias": full((H,), -2.0, f32, lead),
        "D": ones((H,), f32, lead),
        "norm_scale": ones((di,), dtype, lead),
        "w_out": dense_init((di, d), dtype, lead=lead),
    }


def ssm_cache_shapes(cfg, B):
    """(shape, dtype; None: the cache's dtype) of each cache tensor."""
    di, H, P, N, G, conv_dim = dims(cfg)
    return {"conv": ((B, cfg.ssm_conv_kernel - 1, conv_dim), None),
            "state": ((B, H, P, N), torch.float32)}


def _split(cfg, zxbcdt):
    di, H, P, N, G, conv_dim = dims(cfg)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + conv_dim]
    dt = zxbcdt[..., di + conv_dim:]
    return z, xbc, dt


def _conv_full(cfg, xbc, p):
    """Causal depthwise conv over time, (B, T, conv_dim): k shifted
    multiply-adds in float32 (not ``F.conv1d``, which cuDNN may run in
    TF32 on the card). As in the reference, the conv's output and the
    bias are summed in ``xbc.dtype`` before the float32 silu."""
    k = cfg.ssm_conv_kernel
    T = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0)).float()
    w = p["conv_w"].float()
    out = pad[:, 0:T] * w[0]
    for j in range(1, k):
        out = out + pad[:, j:j + T] * w[j]
    out = out.to(xbc.dtype) + p["conv_b"].to(xbc.dtype)
    return F.silu(out.float()).to(xbc.dtype)


def _xbc_split(cfg, xbc_conv):
    di, H, P, N, G, conv_dim = dims(cfg)
    B_, T = xbc_conv.shape[:2]
    x = xbc_conv[..., :di].reshape(B_, T, H, P)
    Bm = xbc_conv[..., di:di + G * N].reshape(B_, T, G, N)
    Cm = xbc_conv[..., di + G * N:].reshape(B_, T, G, N)
    # G=1 groups broadcast over heads
    return x, Bm.expand(B_, T, H, N), Cm.expand(B_, T, H, N)


def ssd_chunked(cfg, x, Bm, Cm, dt, A, h0=None):
    """x (B,T,H,P), Bm/Cm (B,T,H,N), dt (B,T,H) fp32, A (H,) fp32.
    Returns y (B,T,H,P) and final state (B,H,P,N)."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    Q = cfg.ssm_chunk
    T0 = T
    if T % Q:  # pad tail with dt=0 (a=1, zero input -> state unchanged)
        padn = Q - T % Q

        def pad(a):
            return F.pad(a, (0, 0) * (a.ndim - 2) + (0, padn))
        x, Bm, Cm, dt = pad(x), pad(Bm), pad(Cm), pad(dt)
        T = T + padn
    nc = T // Q

    def chunk(a):
        return a.reshape((Bsz, nc, Q) + tuple(a.shape[2:]))

    xc, Bc, Cc = chunk(x).float(), chunk(Bm).float(), chunk(Cm).float()
    dtc = chunk(dt)                                  # (B,nc,Q,H) fp32
    la = dtc * A                                     # log a_t  (negative)
    L = torch.cumsum(la, dim=2)                      # (B,nc,Q,H)

    # intra-chunk (quadratic on Q)
    scores = torch.einsum("bcthn,bcshn->bchts", Cc, Bc)
    Lh = L.movedim(3, 2)                             # (B,nc,H,Q)
    decay = torch.exp(Lh[..., :, None] - Lh[..., None, :])   # (B,nc,H,Q,Q)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    dts = dtc.movedim(3, 2)[..., None, :]            # (B,nc,H,1,Q)
    M = torch.where(tri, scores * decay * dts, 0.0)
    y_intra = torch.einsum("bchts,bcshp->bcthp", M, xc)

    # chunk states: exp(L_Q - L_s) * dt_s
    w = torch.exp(Lh[..., -1][..., None] - Lh) * dtc.movedim(3, 2)
    S_c = torch.einsum("bchs,bcshp,bcshn->bchpn", w, xc, Bc)  # (B,nc,H,P,N)
    a_chunk = torch.exp(Lh[..., -1])                 # (B,nc,H)

    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_ins = []
    for c in range(nc):
        h_ins.append(h)                              # state entering chunk c
        h = a_chunk[:, c, :, None, None] * h + S_c[:, c]
    h_ins = torch.stack(h_ins, 1)                    # (B,nc,H,P,N)

    y_inter = torch.exp(L)[..., None] * torch.einsum(
        "bcthn,bchpn->bcthp", Cc, h_ins)

    y = (y_intra + y_inter).reshape(Bsz, T, H, P)[:, :T0]
    return y.to(x.dtype), h


def _step(h, xt, bt, ct, dtt, A):
    """One recurrence step: the new state and its output (float32)."""
    a = torch.exp(dtt * A)                           # (B,H)
    h = (a[..., None, None] * h
         + (dtt[..., None] * xt.float())[..., None] * bt.float()[..., None, :])
    return h, torch.einsum("bhpn,bhn->bhp", h, ct.float())


def ssd_naive(cfg, x, Bm, Cm, dt, A, h0=None):
    """Step-by-step oracle for tests."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(T):
        h, y = _step(h, x[:, t], Bm[:, t], Cm[:, t], dt[:, t], A)
        ys.append(y)
    return torch.stack(ys, 1).to(x.dtype), h


def apply_ssm(cfg, p, x, mode, cache=None):
    """The full Mamba2 block body (in_proj → conv → SSD → gated norm →
    out_proj). Returns (y, cache) with ``cache`` written in place."""
    Bsz, T, d = x.shape
    di, H, P, N, G, conv_dim = dims(cfg)
    k = cfg.ssm_conv_kernel
    zxbcdt = mm(x, p["w_in"])
    z, xbc, dt_raw = _split(cfg, zxbcdt)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    if mode == "decode":
        window = torch.cat([cache["conv"], xbc.to(cache["conv"].dtype)], 1)
        conv_out = torch.einsum("bkc,kc->bc", window.float(),
                                p["conv_w"].float())
        xbc_c = F.silu(conv_out + p["conv_b"].float()).to(x.dtype)[:, None]
        xs, Bm, Cm = _xbc_split(cfg, xbc_c)
        h, y = _step(cache["state"], xs[:, 0], Bm[:, 0], Cm[:, 0], dt[:, 0],
                     A)
        y = y + p["D"][:, None] * xs[:, 0].float()
        y = y[:, None].to(x.dtype)                   # (B,1,H,P)
        cache["conv"].copy_(window[:, 1:])
        cache["state"].copy_(h)
    else:
        if mode == "prefill" and T < k - 1:
            raise ValueError(
                f"SSM prefill of {T} token(s) is shorter than "
                f"ssm_conv_kernel - 1 = {k - 1}: the conv cache cannot be "
                "filled (the reference keeps a short conv cache here, and "
                "its decode step then fails on the shape)")
        xbc_c = _conv_full(cfg, xbc, p)
        xs, Bm, Cm = _xbc_split(cfg, xbc_c)
        y, h_final = ssd_chunked(cfg, xs, Bm, Cm, dt, A)
        y = y + (p["D"][:, None] * xs.float()).to(y.dtype)
        if mode == "prefill":
            cache["conv"].copy_(xbc[:, T - (k - 1):])
            cache["state"].copy_(h_final)

    y = gated_rmsnorm(y.reshape(Bsz, T, di), z, p["norm_scale"])
    return mm(y, p["w_out"]), cache
