"""The benchmark's int8 models and input rows, made from a configuration
file and ``--seed`` alone.

:func:`make_model` draws float weights on the device in one call, runs the
configuration's float model over calibration frames, and quantizes it as
TensorFlow Lite does post-training: activations int8 asymmetric per
tensor, weights int8 symmetric per output channel, biases int32 at
``s_x * s_w``, the softmax output at (1/256, -128). The result is a plain
dict of numpy arrays (a *qmodel*) that both the program
(:mod:`portbench.port`) and the reference (``portbench/reference``) are
handed. :func:`make_frames` draws the int8 input rows.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for stream ``stream`` of run seed ``seed`` (any whole
    number, also one past 32 bits)."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, stream))
    return g


def shapes(config) -> list:
    """Per-row input and output shape of every layer, with the weight and
    bias shapes of the weighted ones."""
    shape = tuple(config["input"])
    out = []
    for lay in config["layers"]:
        op, w, b = lay["op"], None, None
        if op in ("conv", "dwconv"):
            (kh, kw), (sh, sw) = lay["kernel"], lay["stride"]
            h, wd, c = shape
            cout = lay["out"] if op == "conv" else c
            new = (-(-h // sh), -(-wd // sw), cout)
            w = (kh, kw, c, cout) if op == "conv" else (kh, kw, c, 1)
            b = (cout,)
        elif op == "fc":
            new = (lay["out"],)
            w, b = (shape[0], lay["out"]), (lay["out"],)
        elif op == "avgpool":
            (wh, ww) = lay["window"]
            new = (shape[0] // wh, shape[1] // ww, shape[2])
        elif op == "reshape":
            new = (int(np.prod(shape)),)
        elif op == "softmax":
            new = shape
        else:
            raise ValueError(f"unknown op {op!r}")
        out.append({**lay, "in_shape": shape, "out_shape": new,
                    "w_shape": w, "b_shape": b})
        shape = new
    return out


def _w_std(config, lay) -> float:
    init = config["init"]
    if lay["op"] == "fc":
        return float(init["fc_w_std"])
    kh, kw, cin, _ = lay["w_shape"]
    fan_in = kh * kw * (1 if lay["op"] == "dwconv" else cin)
    return float(init["w_gain"]) * math.sqrt(2.0 / fan_in)


def _float_frames(config, n: int, g: torch.Generator, device,
                  dtype=torch.float64):
    fr = config["frames"]
    shape = (n,) + tuple(config["input"])
    noise = torch.randn(shape, generator=g, device=device,
                        dtype=dtype) * float(fr["noise_std"])
    u = torch.rand((2, n, 1, 1, 1), generator=g, device=device, dtype=dtype)
    (g0, g1), (o0, o1) = fr["gain"], fr["offset"]
    return noise * (g0 + (g1 - g0) * u[0]) + (o0 + (o1 - o0) * u[1])


def _act_q(lo: float, hi: float):
    lo, hi = min(lo, 0.0), max(hi, 0.0)
    if hi == lo:
        hi = lo + 1e-6
    scale = (hi - lo) / 255.0
    zp = int(np.clip(round(-128 - lo / scale), -128, 127))
    return float(np.float32(scale)), zp


def make_model(config, seed: int, device) -> dict:
    """The seeded int8 model of ``config`` (see the module docstring)."""
    layers = shapes(config)
    weighted = [lay for lay in layers if lay["w_shape"] is not None]
    sizes = [int(np.prod(lay["w_shape"])) + int(np.prod(lay["b_shape"]))
             for lay in weighted]
    draw = torch.randn(sum(sizes), generator=generator(seed, 0, device),
                       device=device, dtype=torch.float64).cpu().numpy()
    at = 0
    for lay, n in zip(weighted, sizes):
        nw = int(np.prod(lay["w_shape"]))
        lay["w"] = draw[at:at + nw].reshape(lay["w_shape"]) * _w_std(config,
                                                                     lay)
        lay["b"] = draw[at + nw:at + n] * float(config["init"]["b_std"])
        at += n
    cal = _float_frames(config, int(config["calibration_rows"]),
                        generator(seed, 1, device), device)
    from portbench.reference import load
    forward = load(config["reference"]).forward_float
    # the classifier is centred and scaled on the calibration frames, so
    # that its logits spread by ``logit_std`` from row to row: random
    # weights otherwise leave one class far ahead on every row, and a
    # saturated answer would hide a wrong one
    last = max(i for i, lay in enumerate(layers) if lay["w_shape"])
    z = forward(layers, cal)[last + 1].reshape(cal.shape[0], -1).cpu() \
        .numpy()
    k = float(config["init"]["logit_std"]) / np.maximum(z.std(0), 1e-12)
    layers[last]["w"] = layers[last]["w"] * k
    layers[last]["b"] = (layers[last]["b"] - z.mean(0)) * k
    acts = forward(layers, cal)
    ranges = [(float(a.min()), float(a.max())) for a in acts]

    input_q = _act_q(*ranges[0])
    q = input_q
    qlayers = []
    for lay, (lo, hi) in zip(layers, ranges[1:]):
        if lay["op"] == "softmax":
            out_q = (1.0 / 256.0, -128)
        elif lay["op"] == "reshape":
            out_q = q
        else:
            out_q = _act_q(lo, hi)
        ql = {k: v for k, v in lay.items() if k not in ("w", "b")}
        ql.update(in_q=q, out_q=out_q)
        if lay["w_shape"] is not None:
            axis = 2 if lay["op"] == "dwconv" else len(lay["w_shape"]) - 1
            red = tuple(i for i in range(len(lay["w_shape"])) if i != axis)
            w = lay["w"].astype(np.float32)
            s_w = (np.maximum(np.abs(w).max(axis=red), 1e-9) / 127.0) \
                .astype(np.float32)
            bshape = [1] * w.ndim
            bshape[axis] = -1
            ql["w"] = np.clip(np.round(w / s_w.reshape(bshape)), -127,
                              127).astype(np.int8)
            ql["w_scale"] = s_w
            s_b = np.maximum(np.float32(q[0]) * s_w, np.float32(1e-20)) \
                .astype(np.float32)
            ql["b_scale"] = s_b
            ql["b"] = np.round(np.clip(lay["b"] / s_b, -2**31, 2**31 - 1)) \
                .astype(np.int64).astype(np.int32)
        qlayers.append(ql)
        q = out_q
    return {"name": config["name"], "input": tuple(config["input"]),
            "input_q": input_q, "layers": qlayers}


def make_frames(config, qmodel, seed: int, n: int, device,
                stream: int = 2, block: int = 4096) -> torch.Tensor:
    """``n`` int8 input rows (N, H, W, C) on ``device``, drawn from the
    seed as the configuration's ``frames`` say (float32, ``block`` rows a
    call) and quantized with the model's input scale."""
    g = generator(seed, stream, device)
    s, z = qmodel["input_q"]
    out = torch.empty((n,) + tuple(config["input"]), dtype=torch.int8,
                      device=device)
    for lo in range(0, n, block):
        x = _float_frames(config, min(block, n - lo), g, device,
                          torch.float32)
        out[lo:lo + x.shape[0]] = (torch.round(x / s) + z).clamp(-128, 127)
    return out
