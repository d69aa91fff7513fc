"""Arena liveness — pass 2 of the plan auditor; the port of
``repro.analysis.liveness``.

The paper's static-memory claim, made checkable for the port's plans: from
the ``ExecutionPlan`` alone, compute each activation tensor's live range
over the (sequential) op order and the *physical* bytes it occupies on a
given route — per-call, any batched bucket (planned layouts keep
activations lane-padded, so physical != logical), or paged — and report the
peak sum of simultaneously-live bytes. That peak is the static arena bound
serving can rely on before any executable exists.

The bound is cross-validated two ways: :func:`measure_live_bytes` walks the
SAME registry lowerings the engine runs and records what each op actually
produces — abstractly under ``torch._subclasses.fake_tensor.FakeTensorMode``
(shapes and dtypes, no data; the counterpart of the reference's
``jax.eval_shape``) or concretely on zero inputs — so any drift between
the static shape model and the real lowering shows up as a mismatch; and
:func:`device_advisory` (the counterpart of the reference's
``xla_advisory``) reports what the card says of the model's memory.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import registry as R
from repro_torch.core.engine import ExecutionPlan
from repro_torch.core.memory import liveness, plan_paged


@dataclasses.dataclass
class ArenaBound:
    """Static liveness result for one route."""

    route: str
    peak_bytes: int
    peak_step: int               # op index at the peak (-1 = graph entry)
    per_step_bytes: List[int]    # live bytes after each step
    sizes: Dict[int, int]        # tensor id -> physical bytes on this route


def _phys_shape(plan: ExecutionPlan, tid: int, producer_layout: Any,
                batched: bool, bucket: int) -> Tuple[int, ...]:
    """Physical shape tensor ``tid`` occupies in the engine's value
    environment on the selected route (mirrors ``ExecutionPlan.lower``:
    planned producers store padded values, a batched graph input is lane
    padded on entry, everyone else logical)."""
    t = plan.graph.tensor(tid)
    if producer_layout is None:
        base = tuple(t.shape)
        if batched and tid in plan.graph.inputs:
            base = plan.entry_shape(tid)  # the entry pad of the forward
        return ((bucket,) + base) if batched else base
    lay = producer_layout
    if lay.kind == "fc":
        if batched:
            # qmatmul_planned_batched keeps rows logical: (B, m, N')
            m = tuple(t.shape)[0]
            return (bucket, m, lay.out_shape[-1])
        return tuple(lay.out_shape)
    # conv/dwconv: batch merges into the native NHWC batch and splits back
    return ((bucket,) + tuple(lay.out_shape)) if batched \
        else tuple(lay.out_shape)


def arena_liveness(plan: ExecutionPlan, batched: bool = False,
                   bucket: int = 1) -> ArenaBound:
    """Peak live activation bytes on one route, from the plan alone."""
    g = plan.graph
    lt = liveness(g)
    layouts = plan.layout.layouts if plan.layout is not None else {}
    producer_layout = {op.outputs[0]: layouts.get(i)
                       for i, op in enumerate(g.ops)}
    sizes: Dict[int, int] = {}
    for tid in lt:
        shape = _phys_shape(plan, tid, producer_layout.get(tid),
                            batched, bucket)
        sizes[tid] = int(np.prod(shape, dtype=np.int64)) * \
            np.dtype(g.tensor(tid).dtype).itemsize

    n_ops = len(g.ops)
    per_step: List[int] = []
    peak, peak_step = 0, -1
    for step in range(-1, n_ops):
        live = sum(sz for tid, sz in sizes.items()
                   if lt[tid].first <= step <= lt[tid].last)
        per_step.append(live)
        if live > peak:
            peak, peak_step = live, step
    route = f"batched[b={bucket}]" if batched else "per-call"
    return ArenaBound(route=route, peak_bytes=int(peak),
                      peak_step=peak_step, per_step_bytes=per_step,
                      sizes=sizes)


def paged_peak_bytes(plan: ExecutionPlan) -> Optional[int]:
    """Working-set peak for the paged route (Sec. 4.3 accounting), when
    the plan pages any layer."""
    if not plan.paged:
        return None
    return int(plan_paged(plan.graph, plan.paged).peak_bytes)


def _cpu_twin(plan: ExecutionPlan) -> ExecutionPlan:
    """The same plan with every constant copied to the CPU: the lowerings
    it walks are the device plan's, with the kernels' plain versions in
    place of the launches (same shapes, same dtypes)."""
    cpu = torch.device("cpu")
    if plan.device == cpu:
        return plan
    return dataclasses.replace(
        plan, folded={i: fc.to(cpu) for i, fc in plan.folded.items()},
        layout=None if plan.layout is None else plan.layout.to(cpu),
        consts={t: v.cpu() for t, v in plan.consts.items()}, device=cpu)


def measure_live_bytes(plan: ExecutionPlan, batched: bool = False,
                       bucket: int = 1, concrete: bool = False) -> int:
    """Peak live bytes measured against the real lowerings.

    Re-walks the graph exactly as ``ExecutionPlan.lower`` does — same
    registry routes, same entry pad, same keep-padded value environment,
    same liveness — but records each op's ACTUAL output shape instead of
    predicting it. The walk runs on :func:`_cpu_twin` of the plan. With
    ``concrete=True`` real tensors (zero inputs) are computed and their
    bytes summed; the default walks under ``FakeTensorMode``, which
    reports the same sizes without computing anything.
    """
    plan = _cpu_twin(plan)
    g = plan.graph
    lt = liveness(g)
    layouts = plan.layout.layouts if plan.layout is not None else {}
    lead = (slice(None),) if batched else ()
    run: Callable = R.run_batched if batched else R.run_compiled
    from repro_torch.core.engine import _DTYPES

    def walk() -> int:
        env: Dict[int, Any] = {}
        for tid in g.inputs:
            t = g.tensor(tid)
            x = torch.zeros(((bucket,) if batched else ()) + tuple(t.shape),
                            dtype=_DTYPES[t.dtype])
            phys = plan.entry_shape(tid)
            if batched and phys != tuple(t.shape):
                x = F.pad(x, (0, phys[-1] - t.shape[-1]))
            env[tid] = x

        def val(tid: int, keep_padded: bool = False) -> Any:
            if tid in plan.consts:
                return plan.consts[tid]
            v = env[tid]
            shape = g.tensor(tid).shape
            if not keep_padded and tuple(v.shape[len(lead):]) != shape:
                v = v[lead + tuple(slice(0, d) for d in shape)]
            return v

        def live_bytes(step: int) -> int:
            return sum(v.numel() * v.element_size() for tid, v in env.items()
                       if lt[tid].first <= step <= lt[tid].last)

        peak = live_bytes(-1)
        for i, op in enumerate(g.ops):
            lay = layouts.get(i)
            ctx = R.OpContext(g, op, i, folded=plan.folded.get(i),
                              use_kernels=plan.use_kernels,
                              n_pages=plan.paged.get(i), layout=lay,
                              bounds=plan.bounds.get(i))
            env[op.outputs[0]] = run(ctx, [val(t, keep_padded=lay is not None)
                                           for t in op.inputs])
            peak = max(peak, live_bytes(i))
            # liveness-based eviction: what the engine's buffer reuse drops
            for tid in [t for t in env if lt[t].last <= i]:
                del env[tid]
        return int(peak)

    if concrete:
        return walk()
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        return walk()


def device_advisory(compiled_model: Any) -> Dict[str, Any]:
    """Best-effort cross-check against what the card says of the model's
    memory — the counterpart of the reference's ``xla_advisory``, which
    reads XLA's memory and cost analyses of the per-call executable.
    Reports ``CompiledModel.memory_analysis()``: on the card the bytes the
    model's CUDA-graph captures drew into its graph pool and
    ``torch.cuda.memory_reserved()``, none on the CPU (there is no graph
    pool there); and ``bytes_accessed``, the per-call forward's ``"bytes
    accessed"`` from ``CompiledModel.cost_analysis()``, on every device."""
    out: Dict[str, Any] = {}
    try:
        out.update((k, int(v))
                   for k, v in compiled_model.memory_analysis().items())
    except Exception:  # advisory only: a model without the surface
        pass
    try:
        out["bytes_accessed"] = int(
            compiled_model.cost_analysis()["bytes accessed"])
    except (AttributeError, NotImplementedError):  # no surface, or an op
        pass                                      # without a cost rule
    return out
