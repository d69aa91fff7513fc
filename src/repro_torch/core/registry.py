"""Single-source operator registry — the port of ``repro.core.registry``.

Each operator registers exactly one :class:`OpDescriptor`:

``eval_reference``
    Quantization parameters extracted at call time, every constant term of
    Eqs. (3)/(6)/(9)/(12) computed at run time.
``lower_compiled``
    The MicroFlow path: consumes the compile-time :class:`FoldedConsts`, so
    only input-dependent terms remain. Ops with nothing to fold leave this
    ``None`` and share ``eval_reference``.
``lower_kernel``
    The hand-written CUDA kernel route of the compiled engine (the
    counterpart of the reference's ``lower_pallas``); on a CPU tensor the
    kernel wrappers run their plain PyTorch versions.
``lower_kernel_float``
    The kernel route of a float op (port only: FULLY_CONNECTED's product on
    the ``fmatmul`` kernel, the reference's "float FC path" of ``fmatmul``).
``lower_paged``
    The paged route (Sec. 4.3), FULLY_CONNECTED only: the ``paged_qmatmul``
    kernel with ``use_kernels`` on a CUDA tensor, else the plain page loop
    of ``core.paging``. It wins over the kernel route (paging bounds
    resident weight bytes).
``batched``
    How the op runs with one extra leading batch dimension.
``weight_axis`` / ``w_sum_axes`` / ``w_count_axes``
    Quantization metadata for weighted ops (PTQ axis, ΣW folding spec).
``infer``
    Declarative shape/dtype inference from input specs and attributes.
``cost``
    The op's share of ``CompiledModel.cost_analysis()``: its products,
    transcendentals and bytes, read from the specs of its operands and
    output at the batch counted (the same on every route).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from . import graph as G
from . import ops_ref as K
from .device import resolve_device
from .paging import paged_fc_folded


class InferError(ValueError):
    """An op's operands cannot type-check: wrong rank, mismatched
    contraction dims, malformed attributes."""


# ---------------------------------------------------------------------------
# Shared qparam extraction
# ---------------------------------------------------------------------------

def qparams(t: G.TensorSpec):
    """(scale, zero_point) of a tensor, as numpy arrays."""
    qp = t.qparams
    return np.asarray(qp.scale), np.asarray(qp.zero_point)


def io_qparams(ctx: "OpContext"):
    """Input/output activation qparams as the s_x/z_x/s_y/z_y kwarg dict."""
    s_x, z_x = qparams(ctx.t_in(0))
    s_y, z_y = qparams(ctx.t_out())
    return dict(s_x=s_x, z_x=z_x, s_y=s_y, z_y=z_y)


def weighted_qparams(ctx: "OpContext", b):
    """Runtime qparams for a weighted op, with the TFLite bias defaults
    (s_b=1, z_b=0) when the op has no bias."""
    common = io_qparams(ctx)
    s_w, z_w = qparams(ctx.t_in(1))
    if b is not None:
        s_b, z_b = qparams(ctx.t_in(2))
    else:
        s_b, z_b = np.float32(1.0), np.int32(0)
    common.update(s_b=s_b, z_b=z_b)
    return common, s_w, z_w


@dataclasses.dataclass(frozen=True)
class OpContext:
    """Everything a lowering needs about one op instance.

    ``folded``/``use_kernels``/``n_pages`` are compiled-engine routing state
    (the reference path ignores them); ``use_kernels`` is the counterpart of
    the reference's ``use_pallas``. ``layout`` is the compile-time padded
    layout from ``preprocess.plan_layout``. ``bounds`` holds a paged op's
    float32 clamp bounds, computed on the host when the engine is built, so
    the paged kernel route reads no device scalar per call.
    """

    g: G.Graph
    op: G.OpNode
    index: int = 0
    folded: Optional[K.FoldedConsts] = None
    use_kernels: bool = False
    n_pages: Optional[int] = None
    layout: Optional[object] = None  # preprocess.OpLayout
    bounds: Optional[tuple] = None   # (lo, hi) of a paged op

    def t_in(self, j: int) -> G.TensorSpec:
        return self.g.tensor(self.op.inputs[j])

    def t_out(self, j: int = 0) -> G.TensorSpec:
        return self.g.tensor(self.op.outputs[j])

    @property
    def is_q(self) -> bool:
        return self.t_in(0).dtype == "int8"

    @property
    def fused(self) -> str:
        return self.op.attrs.get("fused", "NONE")


def _with_attrs(ctx: OpContext, **updates) -> OpContext:
    """Context whose op carries rewritten attrs (batched shape-op rules)."""
    op = ctx.op
    new_op = G.OpNode(op.op, op.inputs, op.outputs, {**op.attrs, **updates})
    return dataclasses.replace(ctx, op=new_op)


@dataclasses.dataclass(frozen=True)
class OpDescriptor:
    name: str
    eval_reference: Callable
    lower_compiled: Optional[Callable] = None
    lower_kernel: Optional[Callable] = None
    lower_kernel_float: Optional[Callable] = None
    lower_paged: Optional[Callable] = None
    batched: Optional[Callable] = None
    weight_axis: Optional[int] = None   # per-channel PTQ axis of inputs[1]
    w_sum_axes: Optional[tuple] = None  # ΣW reduction axes (Eq. 4/7/10)
    w_count_axes: Optional[tuple] = None  # axes whose sizes multiply to n
    infer: Optional[Callable] = None    # (op, in_specs) -> (shape, dtype)
    cost: Optional[Callable] = None     # (op, in_specs, out_spec) -> dict


_REGISTRY: dict = {}


def register(name: str, **fields) -> None:
    if name not in G.ALL_OPS:
        raise ValueError(f"unknown op {name!r}")
    _REGISTRY[name] = OpDescriptor(name=name, **fields)


def get(name: str) -> OpDescriptor:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise NotImplementedError(f"op {name!r} is not registered") from None


def registered_ops() -> tuple:
    return tuple(_REGISTRY)


def weight_axis(name: str) -> Optional[int]:
    d = _REGISTRY.get(name)
    return None if d is None else d.weight_axis


# ---------------------------------------------------------------------------
# Executors
# ---------------------------------------------------------------------------

def run_reference(ctx: OpContext, vals):
    """Runtime qparams, nothing folded."""
    return get(ctx.op.op).eval_reference(ctx, *vals)


def run_compiled(ctx: OpContext, vals):
    """Compiled/MicroFlow path with paged > kernel > plain route priority
    (paging bounds resident bytes, so it wins when both are requested)."""
    d = get(ctx.op.op)
    if ctx.is_q and ctx.folded is not None:
        if ctx.n_pages and d.lower_paged is not None:
            return d.lower_paged(ctx, *vals)
        if ctx.use_kernels and d.lower_kernel is not None:
            return d.lower_kernel(ctx, *vals)
    elif not ctx.is_q and ctx.use_kernels and d.lower_kernel_float is not None:
        return d.lower_kernel_float(ctx, *vals)
    fn = d.lower_compiled or d.eval_reference
    return fn(ctx, *vals)


def run_batched(ctx: OpContext, vals):
    """Compiled path with a leading batch dim on every activation value."""
    d = get(ctx.op.op)
    if d.batched is not None:
        return d.batched(ctx, *vals)
    return run_compiled(ctx, vals)  # elementwise: batch dim broadcasts


def run_graph_reference(g: G.Graph, inputs, device="cuda") -> dict:
    """Walk a graph through the reference lowerings with a plain dict env —
    every intermediate stays live (what calibration needs). Returns
    tensor id -> tensor on ``device`` for inputs and all op outputs."""
    dev = resolve_device(device)
    env = {}
    for tid, arr in zip(g.inputs, inputs):
        t = g.tensor(tid)
        env[tid] = torch.as_tensor(
            np.asarray(arr, t.dtype).reshape(t.shape), device=dev)
    consts = {}

    def val(tid):
        t = g.tensor(tid)
        if not t.is_const:
            return env[tid]
        if tid not in consts:
            consts[tid] = torch.as_tensor(t.data, device=dev)
        return consts[tid]

    for i, op in enumerate(g.ops):
        ctx = OpContext(g, op, i)
        env[op.outputs[0]] = run_reference(ctx, [val(t) for t in op.inputs])
    return env


# ---------------------------------------------------------------------------
# Batched helpers
# ---------------------------------------------------------------------------

def _merge_lead2(ctx: OpContext, x, *rest):
    """Fold the batch dim into the op's own leading dim — FC rows, or the
    native NHWC batch of convs/pools — run the normal compiled route, and
    split back. ``ctx.layout`` rides along, so planned convs keep their
    lane-padded kernels on the batched path."""
    b, d0 = x.shape[0], x.shape[1]
    y = run_compiled(ctx, (x.reshape((b * d0,) + tuple(x.shape[2:])),) + rest)
    return y.reshape((b, d0) + tuple(y.shape[1:]))


def _fc_batched(ctx: OpContext, x, *rest):
    """Batched FULLY_CONNECTED: a planned layout goes through the
    batch-aware wrapper (rows aligned and sliced inside), otherwise the batch
    folds into the row dim."""
    if ctx.layout is not None:
        from repro_torch.kernels import ops as kernel_ops
        return kernel_ops.qmatmul_planned_batched(x, ctx.layout)
    return _merge_lead2(ctx, x, *rest)


def _pad_batched(ctx: OpContext, x):
    pads = ((0, 0),) + tuple(ctx.op.attrs["pads"])
    return run_compiled(_with_attrs(ctx, pads=pads), [x])


def _reshape_batched(ctx: OpContext, x):
    shape = (x.shape[0],) + tuple(ctx.op.attrs["new_shape"])
    return run_compiled(_with_attrs(ctx, new_shape=shape), [x])


def _softmax_batched(ctx: OpContext, x):
    axis = ctx.op.attrs.get("axis", -1)
    if axis >= 0:
        ctx = _with_attrs(ctx, axis=axis + 1)
    return run_compiled(ctx, [x])


# ---------------------------------------------------------------------------
# Declarative shape/dtype inference (the ``infer`` specs)
# ---------------------------------------------------------------------------

def _require(cond, msg):
    if not cond:
        raise InferError(msg)


def _same_hw(h, w, kh, kw, stride, padding):
    _require(padding in ("SAME", "VALID"), f"bad padding {padding!r}")
    sh, sw = stride
    _require(sh >= 1 and sw >= 1, f"bad stride {stride!r}")
    if padding == "VALID":
        _require(h >= kh and w >= kw,
                 f"VALID window ({kh},{kw}) exceeds input ({h},{w})")
    return G.conv_out_hw(h, w, kh, kw, stride, padding)


def _bias_check(ins, n):
    if len(ins) > 2:
        b = ins[2]
        _require(tuple(b.shape) == (n,), f"bias shape {b.shape} != ({n},)")
        _require(b.dtype in ("int32", "float32"),
                 f"bias dtype {b.dtype} must be int32 (quantized) or float32")


def _fc_infer(op, ins):
    x, w = ins[0], ins[1]
    _require(len(w.shape) == 2, f"FC weight must be rank 2, got {w.shape}")
    _require(len(x.shape) >= 2, f"FC input must be rank >= 2, got {x.shape}")
    _require(x.shape[-1] == w.shape[0],
             f"FC contraction mismatch: input {x.shape} x weight {w.shape}")
    _bias_check(ins, w.shape[1])
    return tuple(x.shape[:-1]) + (w.shape[1],), x.dtype


def _conv_infer(op, ins):
    x, f = ins[0], ins[1]
    _require(len(x.shape) == 4, f"conv input must be NHWC, got {x.shape}")
    _require(len(f.shape) == 4, f"conv filter must be rank 4, got {f.shape}")
    kh, kw, cin, cout = f.shape
    _require(x.shape[3] == cin,
             f"conv channel mismatch: input {x.shape} x filter {f.shape}")
    oh, ow = _same_hw(x.shape[1], x.shape[2], kh, kw,
                      op.attrs["stride"], op.attrs["padding"])
    _bias_check(ins, cout)
    return (x.shape[0], oh, ow, cout), x.dtype


def _dwconv_infer(op, ins):
    x, w = ins[0], ins[1]
    _require(len(x.shape) == 4, f"dwconv input must be NHWC, got {x.shape}")
    _require(len(w.shape) == 4 and w.shape[3] == 1,
             f"dwconv weight must be (kh, kw, c, 1), got {w.shape}")
    kh, kw, c, _ = w.shape
    _require(x.shape[3] == c,
             f"dwconv channel mismatch: input {x.shape} x weight {w.shape}")
    oh, ow = _same_hw(x.shape[1], x.shape[2], kh, kw,
                      op.attrs["stride"], op.attrs["padding"])
    _bias_check(ins, c)
    return (x.shape[0], oh, ow, c), x.dtype


def _pool_infer(op, ins):
    x = ins[0]
    _require(len(x.shape) == 4, f"pool input must be NHWC, got {x.shape}")
    wh, ww = op.attrs["window"]
    oh, ow = _same_hw(x.shape[1], x.shape[2], wh, ww,
                      op.attrs["stride"], op.attrs["padding"])
    return (x.shape[0], oh, ow, x.shape[3]), x.dtype


def _add_infer(op, ins):
    a, b = ins[0], ins[1]
    _require(tuple(a.shape) == tuple(b.shape),
             f"ADD operand shapes differ: {a.shape} vs {b.shape}")
    _require(a.dtype == b.dtype,
             f"ADD operand dtypes differ: {a.dtype} vs {b.dtype}")
    return tuple(a.shape), a.dtype


def _pad_infer(op, ins):
    x = ins[0]
    pads = op.attrs["pads"]
    _require(len(pads) == len(x.shape),
             f"pads {pads} do not cover rank-{len(x.shape)} input")
    _require(all(lo >= 0 and hi >= 0 for lo, hi in pads),
             f"negative pad widths: {pads}")
    return tuple(d + lo + hi for d, (lo, hi) in zip(x.shape, pads)), x.dtype


def _reshape_infer(op, ins):
    x = ins[0]
    new = tuple(op.attrs["new_shape"])
    _require(int(np.prod(x.shape, dtype=np.int64))
             == int(np.prod(new, dtype=np.int64)),
             f"reshape {x.shape} -> {new} changes element count")
    return new, x.dtype


def _eltwise_infer(op, ins):
    return tuple(ins[0].shape), ins[0].dtype


def _softmax_infer(op, ins):
    x = ins[0]
    axis = op.attrs.get("axis", -1)
    _require(-len(x.shape) <= axis < len(x.shape),
             f"softmax axis {axis} out of range for {x.shape}")
    return tuple(x.shape), x.dtype


# ---------------------------------------------------------------------------
# Cost rules (``CompiledModel.cost_analysis``): the model's work, not a
# route's. ``flops`` counts products only, 2 per multiply-add; ``bytes
# accessed`` reads each operand once (weights and bias included) and writes the output
# once; ``transcendentals`` counts softmax's ``exp``.
# ---------------------------------------------------------------------------

def _numel(t) -> int:
    return int(np.prod(t.shape, dtype=np.int64))


def _moved(ins, out) -> int:
    return sum(t.nbytes for t in ins) + out.nbytes


def _cost(flops: int, moved: int, transcendentals: int = 0) -> dict:
    return {"flops": flops, "bytes accessed": moved,
            "transcendentals": transcendentals}


def _fc_cost(op, ins, out):
    return _cost(2 * _numel(out) * ins[1].shape[0], _moved(ins, out))


def _conv_cost(op, ins, out):
    kh, kw, cin, _ = ins[1].shape
    return _cost(2 * _numel(out) * kh * kw * cin, _moved(ins, out))


def _dwconv_cost(op, ins, out):
    kh, kw, _, _ = ins[1].shape
    return _cost(2 * _numel(out) * kh * kw, _moved(ins, out))


def _moves_cost(op, ins, out):
    """Pools, ADD, PAD, activations: no products (XLA's ``flops`` would
    count their elementwise work; this count does not)."""
    return _cost(0, _moved(ins, out))


def _view_cost(op, ins, out):
    """RESHAPE is a view: it moves nothing."""
    return _cost(0, 0)


def _softmax_cost(op, ins, out):
    return _cost(0, _moved(ins, out), _numel(ins[0]))


# ---------------------------------------------------------------------------
# FULLY_CONNECTED — Eqs. (2)-(4)
# ---------------------------------------------------------------------------

def _fc_reference(ctx, x, w, b=None):
    if not ctx.is_q:
        return K.fully_connected_f(x, w, b, ctx.fused)
    common, s_w, z_w = weighted_qparams(ctx, b)
    return K.fully_connected_q(x, w, b, s_w=s_w, z_w=z_w, fused=ctx.fused,
                               **common)


def _fc_compiled(ctx, x, w, b=None):
    if not ctx.is_q:
        return K.fully_connected_f(x, w, b, ctx.fused)
    return K.fully_connected_folded(x, w, ctx.folded, ctx.fused)


def _fc_kernel(ctx, x, w, b=None):
    from repro_torch.kernels import ops as kernel_ops
    if ctx.layout is not None:
        return kernel_ops.qmatmul_planned(x, ctx.layout)
    return kernel_ops.qmatmul_folded(x, w, ctx.folded, ctx.fused)


def _fc_kernel_float(ctx, x, w, b=None):
    from repro_torch.kernels import ops as kernel_ops
    return K.fully_connected_f(x, w, b, ctx.fused, matmul=kernel_ops.fmatmul)


def _fc_paged(ctx, x, w, b=None):
    n = w.shape[1]
    assert n % ctx.n_pages == 0, (n, ctx.n_pages)
    if ctx.use_kernels and x.is_cuda:
        from repro_torch.kernels import ops as kernel_ops
        return kernel_ops.paged_fc(x, w, ctx.folded, ctx.n_pages, *ctx.bounds)
    return paged_fc_folded(x, w, ctx.folded, ctx.n_pages, ctx.fused)


register(
    G.FULLY_CONNECTED,
    eval_reference=_fc_reference,
    lower_compiled=_fc_compiled,
    lower_kernel=_fc_kernel,
    lower_kernel_float=_fc_kernel_float,
    lower_paged=_fc_paged,
    batched=_fc_batched,
    infer=_fc_infer,
    cost=_fc_cost,
    weight_axis=1,
    w_sum_axes=(0,),
    w_count_axes=(0,),
)


# ---------------------------------------------------------------------------
# CONV_2D / DEPTHWISE_CONV_2D — Eqs. (5)-(10)
# ---------------------------------------------------------------------------

def _conv_geometry(ctx):
    return dict(stride=tuple(ctx.op.attrs["stride"]),
                padding=ctx.op.attrs["padding"])


def _conv_reference(ctx, x, f, b=None):
    kw = _conv_geometry(ctx)
    if not ctx.is_q:
        return K.conv2d_f(x, f, b, fused=ctx.fused, **kw)
    common, s_f, z_f = weighted_qparams(ctx, b)
    return K.conv2d_q(x, f, b, s_f=s_f, z_f=z_f, fused=ctx.fused,
                      **common, **kw)


def _conv_compiled(ctx, x, f, b=None):
    kw = _conv_geometry(ctx)
    if not ctx.is_q:
        return K.conv2d_f(x, f, b, fused=ctx.fused, **kw)
    return K.conv2d_folded(x, f, ctx.folded, fused=ctx.fused, **kw)


def _conv_kernel(ctx, x, f, b=None):
    from repro_torch.kernels import ops as kernel_ops
    geo = _conv_geometry(ctx)
    if ctx.layout is not None:
        return kernel_ops.qconv_planned(x, ctx.layout, kh=f.shape[0],
                                        kw=f.shape[1], **geo)
    return kernel_ops.qconv_folded(x, f, ctx.folded, fused=ctx.fused, **geo)


register(
    G.CONV_2D,
    eval_reference=_conv_reference,
    lower_compiled=_conv_compiled,
    lower_kernel=_conv_kernel,
    batched=_merge_lead2,
    infer=_conv_infer,
    cost=_conv_cost,
    weight_axis=3,
    w_sum_axes=(0, 1, 2),
    w_count_axes=(0, 1, 2),
)


def _dwconv_reference(ctx, x, w, b=None):
    kw = _conv_geometry(ctx)
    if not ctx.is_q:
        return K.depthwise_conv2d_f(x, w, b, fused=ctx.fused, **kw)
    common, s_w, z_w = weighted_qparams(ctx, b)
    return K.depthwise_conv2d_q(x, w, b, s_w=s_w, z_w=z_w, fused=ctx.fused,
                                **common, **kw)


def _dwconv_compiled(ctx, x, w, b=None):
    kw = _conv_geometry(ctx)
    if not ctx.is_q:
        return K.depthwise_conv2d_f(x, w, b, fused=ctx.fused, **kw)
    return K.depthwise_conv2d_folded(x, w, ctx.folded, fused=ctx.fused, **kw)


def _dwconv_kernel(ctx, x, w, b=None):
    from repro_torch.kernels import ops as kernel_ops
    if ctx.layout is not None:
        return kernel_ops.qdwconv_planned(x, ctx.layout, **_conv_geometry(ctx))
    return kernel_ops.qdwconv_folded(x, w, ctx.folded, fused=ctx.fused,
                                     **_conv_geometry(ctx))


register(
    G.DEPTHWISE_CONV_2D,
    eval_reference=_dwconv_reference,
    lower_compiled=_dwconv_compiled,
    lower_kernel=_dwconv_kernel,
    batched=_merge_lead2,
    infer=_dwconv_infer,
    cost=_dwconv_cost,
    weight_axis=2,
    w_sum_axes=(0, 1, 3),
    w_count_axes=(0, 1),
)


# ---------------------------------------------------------------------------
# Pools — Eq. (12) and the max-commutes-with-affine argument
# ---------------------------------------------------------------------------

def _make_pool(qf, ff):
    def impl(ctx, x):
        kw = dict(window=tuple(ctx.op.attrs["window"]),
                  stride=tuple(ctx.op.attrs["stride"]),
                  padding=ctx.op.attrs["padding"])
        if ctx.is_q:
            return qf(x, **io_qparams(ctx), **kw)
        return ff(x, **kw)
    return impl


register(G.AVERAGE_POOL_2D,
         eval_reference=_make_pool(K.average_pool2d_q, K.average_pool2d_f),
         batched=_merge_lead2, infer=_pool_infer, cost=_moves_cost)
register(G.MAX_POOL_2D,
         eval_reference=_make_pool(K.max_pool2d_q, K.max_pool2d_f),
         batched=_merge_lead2, infer=_pool_infer, cost=_moves_cost)


# ---------------------------------------------------------------------------
# ADD / PAD / RESHAPE — elementwise and shape ops
# ---------------------------------------------------------------------------

def _add_eval(ctx, a, b):
    if not ctx.is_q:
        return K.add_f(a, b, ctx.fused)
    s_a, z_a = qparams(ctx.t_in(0))
    s_b, z_b = qparams(ctx.t_in(1))
    s_y, z_y = qparams(ctx.t_out())
    return K.add_q(a, b, s_a=s_a, z_a=z_a, s_b=s_b, z_b=z_b,
                   s_y=s_y, z_y=z_y, fused=ctx.fused)


register(G.ADD, eval_reference=_add_eval,  # elementwise: default batch rule
         infer=_add_infer, cost=_moves_cost)


def _pad_eval(ctx, x):
    pads = ctx.op.attrs["pads"]
    if ctx.is_q:
        _, z_x = qparams(ctx.t_in(0))
        return K.pad_q(x, pads=pads, z_x=z_x)
    return K.pad_f(x, pads=pads)


register(G.PAD, eval_reference=_pad_eval, batched=_pad_batched,
         infer=_pad_infer, cost=_moves_cost)


def _reshape_eval(ctx, x):
    return x.reshape(tuple(ctx.op.attrs["new_shape"]))


register(G.RESHAPE, eval_reference=_reshape_eval, batched=_reshape_batched,
         infer=_reshape_infer, cost=_view_cost)


# ---------------------------------------------------------------------------
# Standalone activations — Eqs. (14), (16), (18)
# ---------------------------------------------------------------------------

def _make_act(qf, ff):
    def impl(ctx, x):
        if ctx.is_q:
            return qf(x, **io_qparams(ctx))
        return ff(x)
    return impl


register(G.RELU, eval_reference=_make_act(K.relu_q, K.relu_f),
         infer=_eltwise_infer, cost=_moves_cost)
register(G.RELU6, eval_reference=_make_act(K.relu6_q, K.relu6_f),
         infer=_eltwise_infer, cost=_moves_cost)


def _softmax_eval(ctx, x):
    axis = ctx.op.attrs.get("axis", -1)
    if ctx.is_q:
        return K.softmax_q(x, axis=axis, **io_qparams(ctx))
    return K.softmax_f(x, axis=axis)


register(G.SOFTMAX, eval_reference=_softmax_eval, batched=_softmax_batched,
         infer=_softmax_infer, cost=_softmax_cost)


assert set(registered_ops()) == set(G.ALL_OPS), (
    "registry must cover the full operator vocabulary")
