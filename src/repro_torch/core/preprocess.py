"""Compile-time pre-processing — the port of ``repro.core.preprocess``.

:func:`fold_weighted_op` computes the constant terms of Eqs. (4), (7), (10)
once, on the host, in numpy (float64 where the reference uses it), so the
folded constants are bit-identical to the reference's.

:func:`plan_layout` assigns every kernel-routed op a lane-padded physical
layout: weights and per-channel constants are pre-padded on the host, and
activations stay padded across consecutive kernel-routed layers. At the
default quantum of 128 lanes the plan equals the reference ``LayoutPlan``
array for array. :meth:`LayoutPlan.to` moves the padded weights and
constants to a device once, when an engine is built.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import graph as G
from . import registry
from .ops_ref import FoldedConsts, MXU_LANES, clamp_bounds, round_up


def fold_weighted_op(g: G.Graph, op: G.OpNode) -> FoldedConsts:
    """Compute the constant terms for FC / Conv2D / DepthwiseConv2D."""
    x_t = g.tensor(op.inputs[0])
    w_t = g.tensor(op.inputs[1])
    b_t = g.tensor(op.inputs[2]) if len(op.inputs) > 2 and op.inputs[2] >= 0 else None
    y_t = g.tensor(op.outputs[0])

    s_x, z_x = x_t.qparams.scale, x_t.qparams.zero_point
    s_w, z_w = w_t.qparams.scale, w_t.qparams.zero_point
    s_y, z_y = y_t.qparams.scale, y_t.qparams.zero_point

    desc = registry.get(op.op)
    if desc.w_sum_axes is None:
        raise ValueError(f"{op.op} has no folded form")
    w = w_t.data.astype(np.int64)
    sum_w = w.sum(axis=desc.w_sum_axes)
    count = int(np.prod([w.shape[a] for a in desc.w_count_axes]))

    if b_t is not None:
        s_b, z_b = b_t.qparams.scale, b_t.qparams.zero_point
        bias_term = z_y + (s_b / s_y) * (b_t.data.astype(np.float64) - z_b)
    else:
        bias_term = np.asarray(z_y, np.float64)

    rescale = (np.asarray(s_x, np.float64) * s_w) / s_y
    w_sum_zx = (np.asarray(z_x, np.int64) * sum_w).astype(np.int32)
    const_off = (count * np.asarray(z_x, np.int64) * z_w).astype(np.int32)

    return FoldedConsts(
        bias_term=np.asarray(bias_term, np.float32),
        rescale=np.asarray(rescale, np.float32),
        w_sum_zx=w_sum_zx,
        const_off=const_off,
        z_w=np.asarray(z_w, np.int32),
        z_y=np.asarray(z_y, np.int32),
        s_y=np.asarray(s_y, np.float32),
        z_x=np.asarray(z_x, np.int32),
    )


def preprocess_graph(g: G.Graph) -> dict:
    """op index -> FoldedConsts, for every quantized weighted op."""
    folded = {}
    for i, op in enumerate(g.ops):
        if registry.get(op.op).w_sum_axes is not None:
            if g.tensor(op.inputs[0]).dtype == "int8":
                folded[i] = fold_weighted_op(g, op)
    return folded


# ---------------------------------------------------------------------------
# Graph-level padded-layout planning
# ---------------------------------------------------------------------------

def _grow_const(v, n: int, n_pad: int, dtype) -> np.ndarray:
    """Broadcast a scalar/per-channel folded constant to ``n`` channels and
    zero-pad to the planned lane width — on the host, once."""
    out = np.zeros(n_pad, dtype)
    out[:n] = np.broadcast_to(np.asarray(v, dtype).reshape(-1), (n,))
    return out


@dataclasses.dataclass(frozen=True)
class OpLayout:
    """Compile-time physical layout of one kernel-routed op.

    ``w_phys``/``consts`` are the lane-padded weights and folded constants
    (numpy from :func:`plan_layout`, device tensors after :meth:`to`);
    ``w_nk`` is ``w_phys`` transposed for the qmatmul kernel (fc and conv;
    None for dwconv, whose kernel takes ``w_phys``); ``w_packed`` is a
    multi-tap conv's weight with K packed (:func:`pack_conv_taps`), the one
    the fused conv kernel takes (None for every other op).
    ``in_lanes``/``out_shape`` describe the padded activation layout the op
    consumes/produces; ``n_true`` is the logical output channel count (the
    kernels zero every lane beyond it, which is what makes chained padded
    layers exact).
    """

    kind: str            # "fc" | "conv" | "dwconv"
    w_phys: object       # fc: (K', N'); conv: (kh*kw*Cin', N'); dw: (kh, kw, C')
    consts: tuple        # 5 × (N',) per-channel folded constants
    lo: float            # fused-activation clamp bounds (static)
    hi: float
    n_true: int          # logical output channels / FC columns
    in_lanes: int        # physical lane width expected on the activation input
    out_shape: tuple     # physical (padded) output shape
    c_true: int          # logical input channels (border-fill mask for conv)
    z_x: int             # input zero point (SAME border fill)
    w_nk: object = None  # fc/conv: w_phys.T (N', K'), K contiguous
    w_packed: object = None  # multi-tap conv: (N', round_up(kh*kw*c_true, 32))

    def to(self, device) -> "OpLayout":
        def move(a):
            return None if a is None else torch.as_tensor(a, device=device)
        return dataclasses.replace(
            self, w_phys=move(self.w_phys), w_nk=move(self.w_nk),
            w_packed=move(self.w_packed),
            consts=tuple(torch.as_tensor(c, device=device)
                         for c in self.consts))


@dataclasses.dataclass(frozen=True)
class LayoutPlan:
    """op index -> OpLayout, plus tensor id -> physical shape for every
    activation stored in padded layout, plus ``entry_phys``: graph-input
    tensor id -> lane-padded per-sample shape when a planned op consumes it
    (the batched forward pads those inputs on entry), plus the lane
    ``quantum`` the plan was made at."""

    layouts: dict
    phys: dict
    entry_phys: dict = dataclasses.field(default_factory=dict)
    quantum: int = MXU_LANES

    def to(self, device) -> "LayoutPlan":
        return dataclasses.replace(
            self, layouts={i: lay.to(device) for i, lay in self.layouts.items()})


def plan_layout(g: G.Graph, folded: dict, quantum: int = MXU_LANES,
                paged=None) -> LayoutPlan:
    """One compile-time walk assigning lane-padded physical layouts.

    An op is planned iff it takes the kernel route in the compiled engine
    (quantized + folded + a registered ``lower_kernel`` + not in ``paged``:
    paging wins, as in ``registry.run_compiled``, and a paged op's planned
    producer hands it a logical view). ``quantum`` is the lane multiple
    that channels, FC columns and FC rows are padded to: 128, the TPU's, by
    default (the reference plan); the engine plans at the qmatmul kernel's
    ``QUANTUM`` (32). Exactness rests on two invariants: planned kernels
    zero their padding lanes, and SAME borders carry z_X only on real
    lanes.
    """
    paged = paged or {}
    layouts, phys = {}, {}
    for i, op in enumerate(g.ops):
        fc = folded.get(i)
        if fc is None or paged.get(i):
            continue
        if registry.get(op.op).lower_kernel is None:
            continue
        w_t = g.tensor(op.inputs[1])
        y_t = g.tensor(op.outputs[0])
        lo, hi = clamp_bounds(fc, op.attrs.get("fused", "NONE"))
        z_x = int(np.asarray(fc.z_x))
        w = w_t.data

        if op.op == G.FULLY_CONNECTED:
            if len(g.tensor(op.inputs[0]).shape) != 2:
                continue  # rank-folding FC stays on the per-call route
            k, n = w.shape
            m = g.tensor(op.inputs[0]).shape[0]
            kp, np_, mp = (round_up(d, quantum) for d in (k, n, m))
            w_phys = np.zeros((kp, np_), np.int8)
            w_phys[:k, :n] = w
            lay = OpLayout("fc", w_phys, _planned_consts(fc, n, np_),
                           lo, hi, n, kp, (mp, np_), k, z_x,
                           np.ascontiguousarray(w_phys.T))
        elif op.op == G.CONV_2D:
            kh, kw, cin, cout = w.shape
            cin_p = round_up(cin, quantum)
            np_ = round_up(cout, quantum)
            f = np.zeros((kh, kw, cin_p, cout), np.int8)
            f[:, :, :cin, :] = w
            w_phys = np.zeros((kh * kw * cin_p, np_), np.int8)
            w_phys[:, :cout] = f.reshape(kh * kw * cin_p, cout)
            lay = OpLayout("conv", w_phys, _planned_consts(fc, cout, np_),
                           lo, hi, cout, cin_p, y_t.shape[:3] + (np_,),
                           cin, z_x, np.ascontiguousarray(w_phys.T),
                           pack_conv_taps(w_phys, kh, kw, cin)
                           if kh * kw > 1 else None)
        else:  # DEPTHWISE_CONV_2D
            if w.shape[3] != 1:
                raise ValueError("depth multiplier 1 only (the kernel contract)")
            kh, kw, c, _ = w.shape
            cp = round_up(c, quantum)
            w_phys = np.zeros((kh, kw, cp), np.int8)
            w_phys[:, :, :c] = w[..., 0]
            lay = OpLayout("dwconv", w_phys, _planned_consts(fc, c, cp),
                           lo, hi, c, cp, y_t.shape[:3] + (cp,), c, z_x)

        layouts[i] = lay
        if tuple(lay.out_shape) != tuple(y_t.shape):
            phys[op.outputs[0]] = tuple(lay.out_shape)

    entry_phys = {}
    input_ids = set(g.inputs)
    for i, lay in layouts.items():
        tid = g.ops[i].inputs[0]
        if tid in input_ids:
            t = g.tensor(tid)
            if t.shape[-1] != lay.in_lanes:
                entry_phys[tid] = tuple(t.shape[:-1]) + (lay.in_lanes,)
    return LayoutPlan(layouts, phys, entry_phys, quantum)


#: The packed K of a multi-tap conv is a multiple of this: one int8
#: ``mma.m16n8k32`` depth, the qmatmul kernel's ``QUANTUM``.
PACK = 32


def pack_conv_taps(w_phys: np.ndarray, kh: int, kw: int,
                   c_true: int) -> np.ndarray:
    """A planned conv's (kh*kw*Cin', N') weight with K packed, transposed:
    (N', round_up(kh*kw*c_true, PACK)) int8, K contiguous. Row n holds the
    ``c_true`` real lanes of each tap, tap-major and channel-minor (the
    order of ``filter.reshape(kh*kw*c_true, N')``), then zeros. The fused
    conv kernel gathers its input rows in this order, so a lane-padded
    layer of one channel contracts 9 or 80 bytes of K, not 288 or 2,560."""
    n_pad = w_phys.shape[1]
    taps = w_phys.reshape(kh * kw, -1, n_pad)[:, :c_true, :]
    k = kh * kw * c_true
    out = np.zeros((n_pad, round_up(k, PACK)), np.int8)
    out[:, :k] = taps.reshape(k, n_pad).T
    return out


def _planned_consts(fc: FoldedConsts, n: int, n_pad: int) -> tuple:
    return (_grow_const(fc.bias_term, n, n_pad, np.float32),
            _grow_const(fc.rescale, n, n_pad, np.float32),
            _grow_const(fc.w_sum_zx, n, n_pad, np.int32),
            _grow_const(fc.const_off, n, n_pad, np.int32),
            _grow_const(fc.z_w, n, n_pad, np.int32))


def folded_const_bytes(folded: dict) -> int:
    """Bytes of the compile-time constants the engine keeps."""
    total = 0
    for fc in folded.values():
        for arr in (fc.bias_term, fc.rescale, fc.w_sum_zx, fc.const_off):
            total += np.asarray(arr).nbytes
    return total
