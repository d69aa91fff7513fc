"""Plain reference of an int8 CNN given as a layer list (conv, depthwise
conv, fully connected, average pool, reshape, softmax), NHWC, written from
the MicroFlow equations and not from the program: it imports neither the
program nor JAX, and reads no constant the program made.

Arithmetic, for the ``correct`` check:

* every contraction is exact: ``sum (x - z_x)(w - z_w)`` in float64 (each
  partial sum is an integer far below 2**53), in the unfolded form of
  Eqs. (3)/(6)/(9);
* the requant constants are folded on the host as Eqs. (4)/(7)/(10) state
  them: ``rescale = f32((s_x * s_w) / s_y)`` in float64 and ``bias = f32(z_y
  + f32(s_b / s_y) * (b - z_b))``; the epilogue is ``bias + rescale *
  f32(inner)`` with one rounding (``addcmul``), the fused clamp in float32,
  round half to even, saturation to int8;
* average pool: ``f32(sum) / f32(count)``, then ``z_y + f32(s_x / s_y) *
  (mean - z_x)`` with one rounding (Eq. 12);
* softmax: ``z_y + softmax(s_x * x) / s_y`` in float32 with a max shift
  (Eq. 18).

``forward_float`` is the float model the benchmark calibrates with, in
float64.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _same_pads(h, w, kh, kw, sh, sw):
    oh, ow = -(-h // sh), -(-w // sw)
    ph = max((oh - 1) * sh + kh - h, 0)
    pw = max((ow - 1) * sw + kw - w, 0)
    return oh, ow, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2)


def window_taps(x, kernel, stride, pad_value=0.0):
    """(B, OH, OW, KH*KW, C): the SAME-padded windows of NHWC ``x``, tap
    by tap in row-major order (HWIO filters flatten the same way)."""
    (kh, kw), (sh, sw) = kernel, stride
    oh, ow, (pl, pr, pt, pb) = _same_pads(x.shape[1], x.shape[2], kh, kw,
                                          sh, sw)
    x = F.pad(x, (0, 0, pl, pr, pt, pb), value=pad_value)
    taps = [x[:, i:i + (oh - 1) * sh + 1:sh, j:j + (ow - 1) * sw + 1:sw, :]
            for i in range(kh) for j in range(kw)]
    return torch.stack(taps, dim=3)


# ---------------------------------------------------------------------------
# float model (calibration)
# ---------------------------------------------------------------------------

def forward_float(layers, x):
    """Every activation of the float model, input first, in float64.
    ``layers`` carry float ``w`` / ``b`` arrays (HWIO; depthwise (kh, kw,
    C, 1); FC (K, N))."""
    acts = [x]
    for lay in layers:
        op = lay["op"]
        if op in ("conv", "dwconv", "fc"):
            w = torch.as_tensor(lay["w"], dtype=torch.float64,
                                device=x.device)
            b = torch.as_tensor(lay["b"], dtype=torch.float64,
                                device=x.device)
            if op == "conv":
                p = window_taps(x, lay["kernel"], lay["stride"])
                y = p.flatten(3) @ w.reshape(-1, w.shape[-1])
            elif op == "dwconv":
                p = window_taps(x, lay["kernel"], lay["stride"])
                y = (p * w[..., 0].reshape(-1, w.shape[2])).sum(3)
            else:
                y = x @ w
            y = y + b
            if lay["fused"] == "RELU":
                y = y.clamp(min=0.0)
            elif lay["fused"] == "RELU6":
                y = y.clamp(0.0, 6.0)
        elif op == "avgpool":
            _valid_window(x, lay)
            y = window_taps(x, lay["window"], lay["window"]).mean(3)
        elif op == "reshape":
            y = x.reshape(x.shape[0], -1)
        elif op == "softmax":
            y = torch.softmax(x, dim=-1)
        else:
            raise ValueError(f"unknown op {op!r}")
        x = y
        acts.append(x)
    return acts


def _valid_window(x, lay):
    """The pools here are VALID windows that tile the input exactly (the
    models' global 3x3 pool), so no border enters a mean."""
    (wh, ww) = lay["window"]
    if x.shape[1] % wh or x.shape[2] % ww:
        raise ValueError(f"{lay['name']}: window {lay['window']} does not "
                         f"tile {tuple(x.shape[1:3])}")


# ---------------------------------------------------------------------------
# int8 model
# ---------------------------------------------------------------------------

def _f32(v) -> np.ndarray:
    return np.asarray(v, np.float32)


def folded(lay, s_x):
    """Host-side requant constants of one weighted layer (Eqs. 4/7/10)."""
    s_w = _f32(lay["w_scale"])
    s_y, z_y = _f32(lay["out_q"][0]), np.int32(lay["out_q"][1])
    s_b = _f32(lay["b_scale"])
    rescale = ((np.float64(s_x) * s_w.astype(np.float64))
               / np.float64(s_y)).astype(np.float32)
    ratio = (s_b / s_y).astype(np.float32)
    bias = (np.float64(z_y) + ratio.astype(np.float64)
            * np.asarray(lay["b"], np.float64)).astype(np.float32)  # z_b = 0
    return rescale, bias


def _bounds(fused, s_y, z_y):
    lo, hi = None, None
    if fused in ("RELU", "RELU6"):
        lo = np.float32(z_y)
    if fused == "RELU6":
        hi = np.float32(np.float32(z_y) + np.float32(6.0) / np.float32(s_y))
    return lo, hi


def _requant(inner, lay, s_x):
    rescale, bias = folded(lay, s_x)
    dev = inner.device
    y = torch.addcmul(torch.as_tensor(bias, device=dev),
                      torch.as_tensor(rescale, device=dev),
                      inner.to(torch.float32))
    lo, hi = _bounds(lay["fused"], *lay["out_q"])
    if lo is not None:
        y = torch.maximum(y, torch.tensor(lo, device=dev))
    if hi is not None:
        y = torch.minimum(y, torch.tensor(hi, device=dev))
    return torch.round(y).clamp(-128, 127)


def _layer_int8(lay, x, in_q):
    """One layer on int8 values held as float64 (exact integers)."""
    s_x, z_x = _f32(in_q[0]), int(in_q[1])
    op = lay["op"]
    if op in ("conv", "dwconv", "fc"):
        w = torch.as_tensor(np.asarray(lay["w"], np.float64), device=x.device)
        xc = x - z_x  # SAME borders carry z_x, so they pad with 0 here
        if op == "conv":
            p = window_taps(xc, lay["kernel"], lay["stride"])
            inner = p.flatten(3) @ w.reshape(-1, w.shape[-1])
        elif op == "dwconv":
            p = window_taps(xc, lay["kernel"], lay["stride"])
            inner = (p * w[..., 0].reshape(-1, w.shape[2])).sum(3)
        else:
            inner = xc @ w
        return _requant(inner, lay, s_x).to(torch.float64)
    if op == "avgpool":
        _valid_window(x, lay)
        taps = window_taps(x, lay["window"], lay["window"])
        mean = taps.sum(3).to(torch.float32) / np.float32(taps.shape[3])
        s_y, z_y = _f32(lay["out_q"][0]), np.float32(lay["out_q"][1])
        ratio = torch.tensor(np.float32(s_x / s_y), device=x.device)
        y = torch.addcmul(torch.tensor(z_y, device=x.device), ratio,
                          mean - np.float32(z_x))
        return torch.round(y).clamp(-128, 127).to(torch.float64)
    if op == "reshape":
        return x.reshape(x.shape[0], -1)
    if op == "softmax":
        s_y, z_y = _f32(lay["out_q"][0]), np.float32(lay["out_q"][1])
        v = x.to(torch.float32) * torch.tensor(s_x, device=x.device)
        v = v - v.amax(-1, keepdim=True)
        e = torch.exp(v)
        p = e / e.sum(-1, keepdim=True)
        y = torch.tensor(z_y, device=x.device) \
            + p / torch.tensor(s_y, device=x.device)
        return torch.round(y).clamp(-128, 127).to(torch.float64)
    raise ValueError(f"unknown op {op!r}")


def forward_int8(qmodel, xq, block: int = 1024):
    """int8 outputs (N, classes) of the int8 model for int8 rows ``xq``
    (N, H, W, C) (a torch tensor on the device to run on), computed in
    blocks of ``block`` rows so that a pool of any size fits."""
    outs = []
    for lo in range(0, xq.shape[0], block):
        x = xq[lo:lo + block].to(torch.float64)
        q = qmodel["input_q"]
        for lay in qmodel["layers"]:
            x = _layer_int8(lay, x, q)
            q = lay["out_q"]
        outs.append(x.to(torch.int8))
    return torch.cat(outs)
