"""Post-training quantization (Eq. 1) with representative-data calibration —
the port of ``repro.core.quantize``.

Activations int8 asymmetric per-tensor, weights int8 symmetric per-channel
(output-channel axis), biases int32 with s_b = s_X * s_W and z_b = 0,
Softmax outputs pinned to s = 1/256, z = -128. Only calibration touches the
device (it runs the float graph); the rest is numpy on the host.
"""
from __future__ import annotations

import numpy as np

from . import graph as G
from . import registry

QMIN, QMAX = -128, 127


def _act_qparams(rmin: float, rmax: float) -> G.QParams:
    rmin = min(float(rmin), 0.0)  # representable zero (TFLite requirement)
    rmax = max(float(rmax), 0.0)
    if rmax == rmin:
        rmax = rmin + 1e-6
    scale = (rmax - rmin) / (QMAX - QMIN)
    zp = int(np.clip(round(QMIN - rmin / scale), QMIN, QMAX))
    return G.QParams(np.float32(scale), np.int32(zp), axis=None)


def _weight_qparams_per_channel(w: np.ndarray, axis: int) -> G.QParams:
    red = tuple(i for i in range(w.ndim) if i != axis)
    absmax = np.maximum(np.abs(w).max(axis=red), 1e-9)
    scale = (absmax / 127.0).astype(np.float32)
    zp = np.zeros_like(scale, dtype=np.int32)
    return G.QParams(scale, zp, axis=axis)


def calibrate(g: G.Graph, representative_inputs, device="cuda") -> dict:
    """Run the float graph over representative data on ``device`` and track
    min/max per activation tensor. Returns tensor id -> (min, max)."""
    ranges = {}
    for batch in representative_inputs:
        if not isinstance(batch, (tuple, list)):
            batch = (batch,)
        env = registry.run_graph_reference(g, batch, device=device)
        for tid, arr in env.items():
            lo, hi = float(arr.min()), float(arr.max())
            if tid in ranges:
                plo, phi = ranges[tid]
                ranges[tid] = (min(plo, lo), max(phi, hi))
            else:
                ranges[tid] = (lo, hi)
    return ranges


def quantize_graph(g: G.Graph, representative_inputs, device="cuda") -> G.Graph:
    """Float graph -> int8 graph with the same topology; calibration runs on
    ``device``."""
    ranges = calibrate(g, representative_inputs, device=device)

    producer = {}
    for op in g.ops:
        for t in op.outputs:
            producer[t] = op

    # Weights op by op (the op kind gives the axis), activations from the
    # calibration ranges.
    new_tensors = [None] * len(g.tensors)
    for op in g.ops:
        w_axis = registry.weight_axis(op.op)
        if w_axis is not None:
            w_id = op.inputs[1]
            w_t = g.tensor(w_id)
            qp_w = _weight_qparams_per_channel(w_t.data, w_axis)
            new_tensors[w_id] = G.TensorSpec(
                w_t.name, w_t.shape, "int8", qp_w, qp_w.quantize(w_t.data))

    for tid, t in enumerate(g.tensors):
        if new_tensors[tid] is not None or t.is_const:
            continue  # biases are handled below once input scales are known
        p = producer.get(tid)
        if p is not None and p.op == G.SOFTMAX:
            qp = G.QParams(np.float32(1.0 / 256.0), np.int32(-128), axis=None)
        else:
            qp = _act_qparams(*ranges[tid])
        new_tensors[tid] = G.TensorSpec(t.name, t.shape, "int8", qp, None)

    # Biases need s_x and s_w of their op.
    for op in g.ops:
        if registry.weight_axis(op.op) is not None and len(op.inputs) > 2:
            b_id = op.inputs[2]
            b_t = g.tensor(b_id)
            s_x = new_tensors[op.inputs[0]].qparams.scale
            s_w = new_tensors[op.inputs[1]].qparams.scale
            s_b = np.maximum(
                (np.asarray(s_x, np.float32) * s_w).astype(np.float32),
                np.float32(1e-20))
            zp = np.zeros_like(s_b, dtype=np.int32)
            qp_b = G.QParams(s_b, zp, axis=0 if s_b.ndim else None)
            q = np.round(np.clip(b_t.data / s_b, -2**31, 2**31 - 1)) \
                .astype(np.int64).astype(np.int32)
            new_tensors[b_id] = G.TensorSpec(b_t.name, b_t.shape, "int32", qp_b, q)

    for tid, t in enumerate(g.tensors):
        if new_tensors[tid] is None:
            new_tensors[tid] = t

    qg = G.Graph(new_tensors, [G.OpNode(o.op, list(o.inputs), list(o.outputs),
                                        dict(o.attrs)) for o in g.ops],
                 list(g.inputs), list(g.outputs), g.name + "_int8")
    qg.validate()
    return qg
