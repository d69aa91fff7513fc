"""No-retrace auditor — pass 3 of the plan auditor; the port of
``repro.analysis.retrace``.

Proves, statically, that the serving hot path cannot build an executable
after warm-up; on CUDA a build is a CUDA-graph capture, so this is the
proof that serving never captures after ``warmup_batched``. The engine
builds the per-call executable and one executable per bucket (all counted
by ``CompiledModel.compile_events``). ``predict_q_many``'s chunking fully
determines which buckets and which staging keys a flush of any size can
touch, and ``warmup_batched``'s loops fully determine which ones warm-up
builds — both derivations live here, re-derived from the public
chunking/bucketing contracts rather than read out of the engine, so a drift
in either shows up as a failed proof. The audit then checks reachable ⊆
warmed, and (when handed a live, warmed ``CompiledModel``) checks both
sets against what the engine reports, through ``bucket_sizes`` /
``staged_pad_keys``.

A staging key is the reference's staged-pad cache key ``(shape, widths)``:
the bucket fill and the entry lane pad of one batch. The port has no
separate stage executable (the fill is the zero rows of the staging
buffer, the lane pad runs inside the bucket's executable), so the engine
reports a key as covered once the batch's bucket is built; the live
cross-check then means what it means in the reference.

The companion lint, :func:`lint_weak_types`, has no weak types to find:
torch has none. Its port target is the capture-safety rule of the
constants every forward reads — see its docstring.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine import ExecutionPlan, bucket_floor, bucket_for
from repro_torch.core.ops_ref import FoldedConsts

from .report import ERROR, Finding

StageKey = Tuple[Tuple[int, ...], Tuple[Tuple[int, int], ...]]


def _entry_widths(plan: ExecutionPlan, tid: int,
                  batch: int) -> Tuple[Tuple[int, int], ...]:
    """The bucket-fill + entry-lane-pad widths for one staged input
    (mirrors ``CompiledModel._entry_widths``)."""
    t = plan.graph.tensor(tid)
    phys = plan.entry_shape(tid)
    return ((0, bucket_for(batch) - batch),) + tuple(
        (0, p - d) for p, d in zip(phys, t.shape))


def _stage_keys(plan: ExecutionPlan,
                batches: Iterable[int]) -> List[StageKey]:
    """Staging keys touched when chunks of the given batch sizes are
    staged: key = (logical source shape, pad widths); a batch whose widths
    are all zero pads nothing and has no key."""
    keys: List[StageKey] = []
    for tid in plan.graph.inputs:
        t = plan.graph.tensor(tid)
        for b in batches:
            widths = _entry_widths(plan, tid, b)
            if any(w for _, w in widths):
                keys.append(((b,) + tuple(t.shape), widths))
    return sorted(set(keys))


def reachable_buckets(max_batch: int) -> Tuple[int, ...]:
    """Every bucket ``predict_q_many(..., max_batch=max_batch)`` can
    dispatch, for ANY request batch size: chunks are at most
    ``step = bucket_floor(max_batch)`` rows, so chunk batches range over
    1..step and their buckets are exactly the powers of two <= step."""
    step = bucket_floor(max_batch)
    return tuple(1 << i for i in range(step.bit_length()))


def reachable_chunk_batches(max_batch: int) -> Tuple[int, ...]:
    """Every chunk batch size the splitter can hand to staging: full chunks
    are exactly ``step`` rows, the tail is 1..step-1, and batch 0
    short-circuits before staging."""
    return tuple(range(1, bucket_floor(max_batch) + 1))


def reachable_stage_keys(plan: ExecutionPlan,
                         max_batch: int) -> List[StageKey]:
    return _stage_keys(plan, reachable_chunk_batches(max_batch))


def warmed_buckets(warm_batch: int) -> Tuple[int, ...]:
    """Buckets ``warmup_batched(warm_batch)`` builds: powers of two up to
    ``bucket_for(warm_batch)`` inclusive."""
    top = bucket_for(warm_batch)
    return tuple(1 << i for i in range(top.bit_length()))


def warmed_stage_keys(plan: ExecutionPlan,
                      warm_batch: int) -> List[StageKey]:
    """Staging keys ``warmup_batched(warm_batch)`` covers: every batch size
    1..bucket_for(warm_batch), nonzero widths only."""
    return _stage_keys(plan, range(1, bucket_for(warm_batch) + 1))


def audit_retrace(plan: ExecutionPlan, max_batch: int,
                  warm_batch: Optional[int] = None,
                  compiled_model: Any = None
                  ) -> Tuple[Dict[str, Any], List[Finding]]:
    """The no-retrace proof for one plan.

    ``max_batch`` is the serving cap (``predict_q_many(max_batch=...)``);
    ``warm_batch`` is what ``warmup_batched`` was (or will be) called with
    — defaults to ``bucket_floor(max_batch)``, which is what
    ``MicroBatcher.for_model`` warms. When ``compiled_model`` is given it
    must already be warmed; what it reports is then checked against both
    derivations, closing the loop between the static proof and the live
    object.
    """
    if warm_batch is None:
        warm_batch = bucket_floor(max_batch)
    need_b = reachable_buckets(max_batch)
    have_b = warmed_buckets(warm_batch)
    need_s = reachable_stage_keys(plan, max_batch)
    have_s = warmed_stage_keys(plan, warm_batch)

    findings: List[Finding] = []
    for b in need_b:
        if b not in have_b:
            findings.append(Finding(
                ERROR, "R001", f"bucket {b}",
                f"reachable via max_batch={max_batch} but not built by "
                f"warmup_batched({warm_batch}) — the first such flush would "
                f"capture on the hot path"))
    missing_s = sorted(set(need_s) - set(have_s))
    for shape, widths in missing_s:
        findings.append(Finding(
            ERROR, "R002", f"stage pad {shape}",
            f"staged entry pad (widths {widths}) reachable but not warmed "
            f"by warmup_batched({warm_batch})"))

    cache_b = cache_s = None
    if compiled_model is not None:
        cache_b = tuple(compiled_model.bucket_sizes())
        cache_s = tuple(compiled_model.staged_pad_keys())
        for b in need_b:
            if b not in cache_b:
                findings.append(Finding(
                    ERROR, "R003", f"bucket {b}",
                    f"reachable but absent from the live executable cache "
                    f"{cache_b} — model not (fully) warmed"))
        for key in sorted(set(need_s) - set(cache_s)):
            findings.append(Finding(
                ERROR, "R004", f"stage pad {key[0]}",
                "reachable staged pad absent from the live cache — model "
                "not (fully) warmed"))

    findings += lint_weak_types(plan)

    info: Dict[str, Any] = {
        "max_batch": max_batch,
        "warm_batch": warm_batch,
        "reachable_buckets": list(need_b),
        "warmed_buckets": list(have_b),
        "reachable_stage_keys": len(need_s),
        "warmed_stage_keys": len(have_s),
        "ok": not any(f.severity == ERROR for f in findings),
    }
    if cache_b is not None:
        info["live_buckets"] = list(cache_b)
        info["live_stage_keys"] = len(cache_s or ())
    return info, findings


def _on(v: Any, device: torch.device) -> bool:
    """Whether ``v`` is a tensor on ``device`` (a device without an index
    matches every index of its type)."""
    return (torch.is_tensor(v) and v.device.type == device.type
            and device.index in (None, v.device.index))


def lint_weak_types(plan: ExecutionPlan) -> List[Finding]:
    """The capture-safety lint over everything every forward reads — the
    port target of the reference's weak-type lint (torch has no weak
    types; what makes a "warm" forward unsafe on CUDA is a constant on the
    wrong side of the bus):

    * ``R010`` — a folded Eq. (4)/(7)/(10) constant a forward uses on the
      device is not a tensor on ``plan.device`` (it would be copied from
      the host inside the forward, which a CUDA-graph capture refuses), or
      a host field (``FoldedConsts.HOST_FIELDS``, read for clamp bounds and
      the border fill) is not a dtype-explicit numpy value (a device tensor
      would be read back, a sync; a Python scalar computes its bounds in
      another precision);
    * ``R011`` — a layout constant or planned weight is not a tensor on
      ``plan.device``;
    * ``R012`` — unhashable op attrs (they key the executables, as in the
      reference).
    """
    out: List[Finding] = []
    dev = plan.device
    for i, fc in plan.folded.items():
        for field, v in vars(fc).items():
            if field in FoldedConsts.HOST_FIELDS:
                ok = isinstance(v, (np.ndarray, np.generic))
                want = "a dtype-explicit host numpy value"
            else:
                ok = _on(v, dev)
                want = f"a tensor on {dev}"
            if not ok:
                out.append(Finding(
                    ERROR, "R010", f"op {i} folded.{field}",
                    f"constant is {type(v).__name__}, expected {want} — "
                    f"a capture of the forward would copy or sync"))
    if plan.layout is not None:
        for i, lay in plan.layout.layouts.items():
            named = [(f"consts[{j}]", c) for j, c in enumerate(lay.consts)]
            named.append(("w_phys", lay.w_phys))
            for field in ("w_nk", "w_packed"):
                if getattr(lay, field) is not None:
                    named.append((field, getattr(lay, field)))
            for field, c in named:
                if not _on(c, dev):
                    out.append(Finding(
                        ERROR, "R011", f"op {i} layout.{field}",
                        f"planned constant is {type(c).__name__}, expected "
                        f"a tensor padded at plan time and moved to {dev}"))
    for i, op in enumerate(plan.graph.ops):
        try:
            hash(tuple(sorted(op.attrs.items())))
        except TypeError:
            out.append(Finding(
                ERROR, "R012", f"op {i} ({op.op})",
                "unhashable op attrs — cannot key an executable"))
    return out
