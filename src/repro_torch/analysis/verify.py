"""Graph verifier — pass 1 of the plan auditor; the port of
``repro.analysis.verify`` over the port's ``ExecutionPlan`` and registry.

Propagates shapes, dtypes, and quantization parameters through the
registry's declarative ``infer`` specs WITHOUT executing anything: every
tensor reference must resolve, every op's declared output must match what
its descriptor infers from the declared inputs, and the TFLite PTQ
invariants the folded kernels assume (Eq. 1 parameters: weights symmetric
per-channel, biases ``s_b = s_x * s_w`` with ``z_b = 0``, softmax outputs
pinned to ``1/256``) must actually hold in the plan. This is the paper's
"errors surface at compile time" claim made checkable for our plans: a
graph that passes lowers on every route without shape/dtype/scale
surprises at capture or serve time. The route check reads the port
registry's kernel lowering (``lower_kernel``) where the reference reads
``lower_pallas``; the codes are the reference's.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.core import graph as G
from repro_torch.core import registry as R
from repro_torch.core.engine import ExecutionPlan

from .report import ERROR, WARNING, Finding

_SOFTMAX_SCALE = 1.0 / 256.0
_SOFTMAX_ZP = -128


def _err(code: str, where: str, msg: str) -> Finding:
    return Finding(ERROR, code, where, msg)


def _warn(code: str, where: str, msg: str) -> Finding:
    return Finding(WARNING, code, where, msg)


def _check_refs(g: G.Graph) -> List[Finding]:
    """Structural pass: every tensor id resolves, activations are produced
    before use, constants are never written. (``Graph.validate`` asserts;
    the auditor reports.)"""
    out: List[Finding] = []
    n = len(g.tensors)

    def bad(tid: int) -> bool:
        return not (0 <= tid < n)

    for tid in list(g.inputs) + list(g.outputs):
        if bad(tid):
            out.append(_err("V001", f"tensor {tid}",
                            f"dangling tensor ref (graph has {n} tensors)"))
    produced = {t for t in g.inputs if not bad(t)}
    for i, op in enumerate(g.ops):
        where = f"op {i} ({op.op})"
        if len(op.outputs) != 1:
            out.append(_err("V002", where,
                            f"{len(op.outputs)} outputs; engines store "
                            f"exactly one result per op"))
        for tid in op.inputs:
            if tid == -1:
                continue  # no-bias sentinel (see preprocess.fold_weighted_op)
            if bad(tid):
                out.append(_err("V001", where, f"dangling input ref {tid}"))
            elif not g.tensor(tid).is_const and tid not in produced:
                out.append(_err("V003", where,
                                f"reads tensor {tid} before any producer"))
        for tid in op.outputs:
            if bad(tid):
                out.append(_err("V001", where, f"dangling output ref {tid}"))
            elif g.tensor(tid).is_const:
                out.append(_err("V004", where,
                                f"writes constant tensor {tid}"))
            else:
                produced.add(tid)
    for tid in g.outputs:
        if not bad(tid) and tid not in produced:
            out.append(_err("V003", f"tensor {tid}",
                            "graph output never produced"))
    return out


def _check_infer(g: G.Graph) -> List[Finding]:
    """Shape/dtype propagation through the registry ``infer`` specs."""
    out: List[Finding] = []
    for i, op in enumerate(g.ops):
        where = f"op {i} ({op.op})"
        try:
            desc = R.get(op.op)
        except NotImplementedError:
            out.append(_err("V010", where, "op is not registered"))
            continue
        if desc.infer is None:
            out.append(_warn("V011", where,
                             "descriptor has no infer spec; output "
                             "unchecked"))
            continue
        ins = [g.tensor(t) for t in op.inputs if 0 <= t < len(g.tensors)]
        if len(ins) != len(op.inputs):
            continue  # dangling refs already reported
        try:
            shape, dtype = desc.infer(op, ins)
        except R.InferError as e:
            out.append(_err("V012", where, str(e)))
            continue
        y = g.tensor(op.outputs[0]) if op.outputs and \
            0 <= op.outputs[0] < len(g.tensors) else None
        if y is None:
            continue
        if tuple(y.shape) != tuple(shape):
            out.append(_err("V013", where,
                            f"declared output shape {y.shape} != inferred "
                            f"{tuple(shape)}"))
        if y.dtype != dtype:
            out.append(_err("V014", where,
                            f"declared output dtype {y.dtype} != inferred "
                            f"{dtype}"))
    return out


def _qp_shape_ok(t: G.TensorSpec) -> Optional[str]:
    """None when the tensor's qparams are well-formed, else the defect."""
    qp = t.qparams
    if qp is None:
        return "int8 tensor without quantization parameters"
    s = np.asarray(qp.scale)
    z = np.asarray(qp.zero_point)
    if not np.all(np.isfinite(s)) or np.any(s <= 0):
        return f"non-positive or non-finite scale {s!r}"
    if qp.per_channel:
        axis = qp.axis
        if axis is None or not (0 <= axis < len(t.shape)):
            return f"per-channel axis {axis} out of range for {t.shape}"
        n = t.shape[axis]
        if s.shape != (n,):
            return f"per-channel scale shape {s.shape} != ({n},)"
        if z.shape != (n,):
            return f"dropped/mis-shaped zero point {z.shape} != ({n},)"
    else:
        if s.shape != () or z.shape != ():
            return (f"per-tensor qparams must be scalars, got scale "
                    f"{s.shape} / zero point {z.shape}")
    return None


def _check_quant(g: G.Graph) -> List[Finding]:
    """The PTQ invariants the folded lowerings assume (``quantize_graph``
    establishes them; the auditor re-derives them from the plan alone)."""
    out: List[Finding] = []
    producer = {op.outputs[0]: op for op in g.ops if op.outputs}

    for tid, t in enumerate(g.tensors):
        if t.dtype != "int8":
            continue
        defect = _qp_shape_ok(t)
        if defect is not None:
            out.append(_err("V020", f"tensor {tid} ({t.name})", defect))

    for i, op in enumerate(g.ops):
        where = f"op {i} ({op.op})"
        desc = R._REGISTRY.get(op.op)
        if desc is None:
            continue
        refs = [t for t in list(op.inputs) + list(op.outputs) if t != -1]
        if any(not (0 <= t < len(g.tensors)) for t in refs):
            continue  # dangling refs already reported by _check_refs
        # -- weighted ops: symmetric per-channel weights, tied bias scale
        if desc.weight_axis is not None and len(op.inputs) >= 2:
            x = g.tensor(op.inputs[0])
            w = g.tensor(op.inputs[1])
            if x.dtype != "int8":
                continue  # float op: no quant contract to check
            if w.qparams is None or _qp_shape_ok(w) is not None:
                continue  # malformed qparams already reported per tensor
            if w.qparams.axis != desc.weight_axis:
                out.append(_err(
                    "V021", where,
                    f"weight per-channel axis {w.qparams.axis} != "
                    f"descriptor axis {desc.weight_axis}"))
            if np.any(np.asarray(w.qparams.zero_point) != 0):
                out.append(_err("V022", where,
                                "weights must be symmetric (zero point 0)"))
            if len(op.inputs) > 2 and op.inputs[2] >= 0:
                b = g.tensor(op.inputs[2])
                if b.dtype != "int32":
                    out.append(_err("V023", where,
                                    f"quantized bias dtype {b.dtype} != "
                                    f"int32"))
                if (b.qparams is not None and x.qparams is not None
                        and w.qparams is not None):
                    s_b = np.asarray(b.qparams.scale, np.float64)
                    want = np.maximum(
                        np.asarray(x.qparams.scale, np.float64)
                        * np.asarray(w.qparams.scale, np.float64), 1e-20)
                    if s_b.shape != want.shape or not np.allclose(
                            s_b, want, rtol=1e-4, atol=0.0):
                        out.append(_err(
                            "V024", where,
                            f"bias scale != s_x*s_w (got {s_b!r}, expected "
                            f"{want!r}) — scales swapped or stale"))
                    if np.any(np.asarray(b.qparams.zero_point) != 0):
                        out.append(_err("V025", where,
                                        "bias zero point must be 0"))
        # -- softmax outputs pinned (TFLite contract the kernel bakes in)
        if op.op == G.SOFTMAX and op.outputs:
            y = g.tensor(op.outputs[0])
            if y.dtype == "int8" and y.qparams is not None:
                s = float(np.asarray(y.qparams.scale))
                z = int(np.asarray(y.qparams.zero_point))
                if not np.isclose(s, _SOFTMAX_SCALE, rtol=1e-6) \
                        or z != _SOFTMAX_ZP:
                    out.append(_err(
                        "V026", f"op {i} (SOFTMAX)",
                        f"output qparams (s={s}, z={z}) != pinned "
                        f"(1/256, -128)"))
    # mixed-dtype edges: a quantized op reading a float activation (or
    # vice versa) has no defined lowering
    for i, op in enumerate(g.ops):
        acts = [g.tensor(t) for t in op.inputs
                if 0 <= t < len(g.tensors) and not g.tensor(t).is_const]
        if acts and len({a.dtype for a in acts}) > 1 and op.op != G.ADD:
            out.append(_err(
                "V027", f"op {i} ({op.op})",
                f"mixed activation dtypes "
                f"{sorted({a.dtype for a in acts})}"))
    return out


def _check_route(plan: ExecutionPlan) -> List[Finding]:
    """Every op must have a lowering on the routes this plan selects, and
    the compile-time artifacts (folded consts, layout) must be consistent
    with the graph they claim to describe."""
    g = plan.graph
    out: List[Finding] = []
    for i, n_pages in plan.paged.items():
        where = f"op {i}"
        if not (0 <= i < len(g.ops)):
            out.append(_err("V030", where, "paged index out of range"))
            continue
        op = g.ops[i]
        desc = R._REGISTRY.get(op.op)
        if op.op != G.FULLY_CONNECTED or desc is None \
                or desc.lower_paged is None:
            out.append(_err("V031", f"op {i} ({op.op})",
                            "paged route requested but op has no paged "
                            "lowering"))
            continue
        n_out = g.tensor(op.inputs[1]).shape[1]
        if n_pages < 1 or n_out % n_pages != 0:
            out.append(_err("V032", f"op {i} ({op.op})",
                            f"{n_pages} pages do not divide {n_out} "
                            f"output units"))
    for i in plan.folded:
        if not (0 <= i < len(g.ops)):
            out.append(_err("V033", f"op {i}", "folded index out of range"))
            continue
        desc = R._REGISTRY.get(g.ops[i].op)
        if desc is None or desc.w_sum_axes is None:
            out.append(_err("V034", f"op {i} ({g.ops[i].op})",
                            "folded constants for an op with no folded "
                            "form"))
    if plan.layout is not None:
        if not plan.use_kernels:
            out.append(_warn("V035", "plan",
                             "layout plan present but kernel route off — "
                             "layouts will never be consumed"))
        for i, lay in plan.layout.layouts.items():
            where = f"op {i}"
            if not (0 <= i < len(g.ops)):
                out.append(_err("V036", where,
                                "layout index out of range"))
                continue
            op = g.ops[i]
            desc = R._REGISTRY.get(op.op)
            if i not in plan.folded or desc is None \
                    or desc.lower_kernel is None:
                out.append(_err("V037", f"op {i} ({op.op})",
                                "layout assigned but op cannot take the "
                                "planned kernel route"))
                continue
            n = g.tensor(op.outputs[0]).shape[-1]
            if lay.n_true != n:
                out.append(_err("V038", f"op {i} ({op.op})",
                                f"layout n_true {lay.n_true} != logical "
                                f"output channels {n}"))
            if len(lay.consts) != 5 or any(
                    tuple(c.shape) != tuple(lay.consts[0].shape)
                    for c in lay.consts):
                out.append(_err("V039", f"op {i} ({op.op})",
                                "malformed pre-padded folded constants"))
    return out


def static_output_bounds(plan: ExecutionPlan) -> dict:
    """Compile-time validity contract for every graph output: ``{tensor id:
    (dtype, lo, hi)}``.

    ``lo``/``hi`` are the tightest static bounds the plan proves for the
    output's values on EVERY route (the routes share one folding, so one
    bound covers kernels/compiled/reference alike): the dtype's
    representable range, narrowed by the producing op's folded fused-
    activation clamp (Eq. 4/7/10's static ``clamp_bounds``, read from the
    folded constants' host fields) when one is folded. The serving
    resilience layer uses this as its output-validity guard — a dispatch
    returning the wrong dtype, NaN/inf, or values outside these bounds is
    treated as a fault, exactly like a raised exception."""
    from repro_torch.core.ops_ref import clamp_bounds

    g = plan.graph
    producer = {op.outputs[0]: i for i, op in enumerate(g.ops)}
    out = {}
    for tid in g.outputs:
        t = g.tensor(tid)
        dt = np.dtype(t.dtype)
        if np.issubdtype(dt, np.integer):
            info = np.iinfo(dt)
            lo, hi = float(info.min), float(info.max)
        else:
            lo, hi = float("-inf"), float("inf")
        i = producer.get(tid)
        fc = plan.folded.get(i) if i is not None else None
        if fc is not None:
            clo, chi = clamp_bounds(fc, g.ops[i].attrs.get("fused", "NONE"))
            lo, hi = max(lo, clo), min(hi, chi)
        out[tid] = (dt, lo, hi)
    return out


def verify_plan(plan: ExecutionPlan) -> List[Finding]:
    """All verifier findings for one plan (structural, inference, quant,
    route). Structural errors suppress the downstream passes for the ops
    they invalidate but never abort the whole audit."""
    g = plan.graph
    findings = _check_refs(g)
    findings += _check_infer(g)
    findings += _check_quant(g)
    findings += _check_route(plan)
    return findings
