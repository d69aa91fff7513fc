"""Pad/copy budget — pass 4 of the plan auditor; the port's own, not a
mirror of the reference's jaxpr pins.

The reference counts pad primitives in a traced jaxpr. The port has no
trace: it counts the torch calls that pad or concatenate —
``F.pad``, ``torch.constant_pad_nd`` and ``torch.cat`` — that its forward
makes, under a ``TorchFunctionMode`` while the forward runs
(:func:`measured_pads`), and derives the number the plan allows
(:func:`pad_budget`) from its own ``LayoutPlan`` and the lowerings'
pad predicates, so the budget moves with the plan and a mismatch localizes
WHICH op regressed. It counts calls, not bytes: a pad done inside a CUDA
kernel (the depthwise kernel fills its SAME border itself) is no torch call
and is not counted, which is why the derivation takes the device.

Derivation, mirroring the lowerings (``repro_torch.kernels.ops`` and
``repro_torch.core.ops_ref``):

* plain route: ``pad_input_q`` pads every SAME conv/dwconv (even at zero
  width); each SAME pool pads its input (average pools also the ones they
  count with); each PAD op is one pad; a quantized conv whose window is
  more than one tap concatenates its im2col taps (``patches``: one
  ``torch.cat``).
* planned kernel route: one entry pad of each batched graph input whose
  entry layout is lane-padded (``ExecutionPlan.lower``); an FC's pad of its
  input to ``(M', in_lanes)`` per call, or of its lanes batched, where the
  producer's physical shape differs; a conv's lane pad, and, on the CPU
  or for a 1-tap filter, its SAME border (``_pad_border_planned`` skips a
  zero halo), its im2col concatenation and its K pad (on the card a
  multi-tap conv is one fused kernel: border, taps and packed K inside); a
  depthwise conv's lane pad and, on the CPU only, its SAME border (the
  kernel's plain version pads; the CUDA kernel fuses it).
* a paged FullyConnected (Sec. 4.3): one concatenation of its pages,
  except on the card's kernel route, where the paged kernel writes each
  page in place. (The reference leaves paged ops out of its budget; the
  port's paged route pads nothing, so it is counted.)
* the float FullyConnected on ``fmatmul``: its row pads to whole 16-byte
  rows.

The budget is *enforceable* only when every other folded op takes the
planned route — an unplanned folded op on the kernel route pads its
weights and constants per call (a known-costly regime the plan should have
avoided), so the pass flags it instead of pretending to count it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from repro_torch.core import graph as G
from repro_torch.core import registry as R
from repro_torch.core.engine import ExecutionPlan, _DTYPES
from repro_torch.core.ops_ref import same_pads
from repro_torch.kernels.ops import conv_runs_fused

from .report import ERROR, Finding, WARNING

#: the torch calls the budget counts
PAD_CALLS = ("pad", "constant_pad_nd", "cat")


@dataclasses.dataclass
class PadBudget:
    """Derived pad allowance for one route of one plan."""

    route: str
    total: int
    items: List[Tuple[str, int, str]]   # (where, count, why)
    enforceable: bool                    # False: route pads per call
    notes: List[str] = dataclasses.field(default_factory=list)
    missed: List[str] = dataclasses.field(default_factory=list)  # plannable
    # ops the layout plan should have covered but did not — the definitive
    # over-budget regression (weights + five folded consts pad per call)

    def as_dict(self) -> Dict[str, Any]:
        return {"route": self.route, "budget": self.total,
                "enforceable": self.enforceable,
                "items": [{"where": w, "pads": c, "why": y}
                          for w, c, y in self.items],
                "notes": list(self.notes),
                "missed_plan": list(self.missed)}


def _conv_dims(g: G.Graph, op: G.OpNode) -> Tuple[int, int, tuple, str]:
    w = g.tensor(op.inputs[1])
    kh, kw = w.shape[0], w.shape[1]  # HWIO conv / (kh, kw, c, 1) depthwise
    stride = tuple(op.attrs.get("stride", (1, 1)))
    padding = op.attrs.get("padding", "VALID")
    return kh, kw, stride, padding


def _halo_nonzero(x_shape: tuple, kh: int, kw: int, stride: tuple) -> bool:
    h, w = x_shape[-3], x_shape[-2]
    (pt, pb), (pl, pr) = same_pads(h, w, kh, kw, stride)
    return bool(pt or pb or pl or pr)


def pad_budget(plan: ExecutionPlan, batched: bool = False,
               bucket: int = 1) -> PadBudget:
    """Derive the exact number of pad/cat calls ``plan.lower(batched=...)``
    makes on this route, fed the engine's logical inputs, on the plan's
    device — :func:`measured_pads` checks it."""
    dev = plan.device
    g = plan.graph
    layouts = plan.layout.layouts if plan.layout is not None else {}
    items: List[Tuple[str, int, str]] = []
    notes: List[str] = []
    missed: List[str] = []
    enforceable = True

    # physical shape each tensor has in the engine's value env (leading
    # batch dim excluded — it is layout-neutral)
    phys: Dict[int, tuple] = {}
    for tid in g.inputs:
        logical = tuple(g.tensor(tid).shape)
        phys[tid] = logical
        if batched and plan.entry_shape(tid) != logical:
            phys[tid] = plan.entry_shape(tid)
            items.append((f"input {tid}", 1,
                          f"batched entry lane pad {logical[-1]} -> "
                          f"{phys[tid][-1]}"))

    for i, op in enumerate(g.ops):
        where = f"op {i} ({op.op})"
        lay = layouts.get(i)
        folded = i in plan.folded
        y = g.tensor(op.outputs[0])

        if lay is not None:
            # -- planned kernel route ---------------------------------
            in_phys = phys.get(op.inputs[0],
                               tuple(g.tensor(op.inputs[0]).shape))
            if lay.kind == "fc":
                if batched:
                    if in_phys[-1] != lay.in_lanes:
                        items.append((where, 1, f"batched FC lane pad "
                                                f"{in_phys[-1]} -> "
                                                f"{lay.in_lanes}"))
                    out_phys = (in_phys[0], lay.out_shape[-1])
                else:
                    mp = lay.out_shape[0]
                    if tuple(in_phys) != (mp, lay.in_lanes):
                        items.append((where, 1,
                                      f"FC entry pad {tuple(in_phys)} -> "
                                      f"({mp}, {lay.in_lanes})"))
                    out_phys = tuple(lay.out_shape)
            else:
                kh, kw, stride, padding = _conv_dims(g, op)
                if in_phys[-1] != lay.in_lanes:
                    items.append((where, 1, f"entry lane pad {in_phys[-1]} "
                                            f"-> {lay.in_lanes}"))
                halo = padding == "SAME" and _halo_nonzero(in_phys, kh, kw,
                                                           stride)
                # the fused conv kernel makes its border, taps and packed K
                # itself, with no torch call; the im2col route pads K where
                # the weight's rows outnumber a patch's kh*kw*in_lanes
                if lay.kind == "conv" and not conv_runs_fused(kh * kw, dev):
                    if halo:
                        items.append((where, 1, "SAME border"))
                    if kh * kw > 1:
                        items.append((where, 1, "im2col concatenation"))
                    if lay.w_phys.shape[0] != kh * kw * lay.in_lanes:
                        items.append((where, 1, "im2col K pad"))
                elif lay.kind == "dwconv" and halo and dev.type == "cpu":
                    items.append((where, 1, "SAME border (plain depthwise "
                                            "version; the CUDA kernel fills "
                                            "it itself)"))
                out_phys = tuple(lay.out_shape)
            phys[op.outputs[0]] = out_phys
            continue

        # -- unplanned routes -----------------------------------------
        phys[op.outputs[0]] = tuple(y.shape)
        if folded and plan.paged.get(i):
            # both page loops (the plain route's and the paged kernel's
            # plain version) concatenate their pages; the kernel writes
            # each page in place
            if not (plan.use_kernels and dev.type == "cuda"):
                items.append((where, 1, "paged FC page concatenation"))
        elif folded and plan.use_kernels:
            # the folded wrappers pad weights AND the five folded
            # constants per call — a budget here would legitimize the
            # regression the plan exists to prevent.
            enforceable = False
            desc = R._REGISTRY.get(op.op)
            plannable = (desc is not None
                         and desc.lower_kernel is not None
                         and not (op.op == G.FULLY_CONNECTED and
                                  len(g.tensor(op.inputs[0]).shape) != 2))
            if plannable:
                missed.append(where)
            else:
                notes.append(f"{where}: folded op legitimately off the "
                             f"planned route (rank-folding) — pads per "
                             f"call")
        elif op.op in (G.CONV_2D, G.DEPTHWISE_CONV_2D):
            kh, kw, _, padding = _conv_dims(g, op)
            if padding == "SAME":
                items.append((where, 1, "SAME border (plain route)"))
            if op.op == G.CONV_2D and folded and kh * kw > 1:
                items.append((where, 1, "im2col concatenation (plain "
                                        "route)"))
        elif op.op in (G.AVERAGE_POOL_2D, G.MAX_POOL_2D):
            if op.attrs.get("padding", "VALID") == "SAME":
                n = 2 if op.op == G.AVERAGE_POOL_2D else 1
                items.append((where, n, "SAME pool border"))
        elif op.op == G.PAD:
            items.append((where, 1, "explicit PAD op"))
        elif (op.op == G.FULLY_CONNECTED and plan.use_kernels
              and g.tensor(op.inputs[0]).dtype != "int8"):
            k, n = g.tensor(op.inputs[1]).shape
            per_row = 16 // np.dtype(g.tensor(op.inputs[0]).dtype).itemsize
            pads = int(k % per_row != 0) + int(k % per_row != 0
                                               or n % per_row != 0)
            if pads:
                items.append((where, pads, "fmatmul 16-byte row pads"))

    total = sum(c for _, c, _ in items)
    route = f"batched[b={bucket}]" if batched else "per-call"
    return PadBudget(route=route, total=total, items=items,
                     enforceable=enforceable, notes=notes, missed=missed)


class _PadCalls(TorchFunctionMode):
    """Counts the pad/cat calls made while it is active (a call made inside
    another torch function is that function's business and not seen)."""

    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in PAD_CALLS:
            self.calls += 1
        return func(*args, **(kwargs or {}))


def measured_pads(plan: ExecutionPlan, batched: bool = False,
                  bucket: int = 1) -> int:
    """Pad/cat calls the forward actually makes on this route: one run of
    ``plan.lower(batched=...)`` on zero inputs of the engine's logical
    shapes, on the plan's device (on the card the kernels launch)."""
    g = plan.graph
    lead = (bucket,) if batched else ()
    xs = [torch.zeros(lead + tuple(g.tensor(t).shape),
                      dtype=_DTYPES[g.tensor(t).dtype], device=plan.device)
          for t in g.inputs]
    fn = plan.lower(batched=batched)
    with _PadCalls() as mode:
        fn(*xs)
    return mode.calls


def audit_pads(plan: ExecutionPlan, batched: bool = False,
               bucket: int = 1) -> Tuple[Dict[str, Any], List[Finding]]:
    """Budget + measured count + findings for one route."""
    budget = pad_budget(plan, batched=batched, bucket=bucket)
    findings: List[Finding] = []
    info = budget.as_dict()
    if not budget.enforceable:
        for where in budget.missed:
            findings.append(Finding(
                ERROR, "B004", where,
                "folded op fell off the planned route — weights and all "
                "five folded constants now pad on every call (pad over "
                "budget by construction)"))
        if budget.notes:
            findings.append(Finding(
                WARNING, "B001", budget.route, "; ".join(budget.notes)))
        info["traced"] = None
        return info, findings
    traced = measured_pads(plan, batched=batched, bucket=bucket)
    info["traced"] = traced
    if traced > budget.total:
        findings.append(Finding(
            ERROR, "B002", budget.route,
            f"measured {traced} pad/cat calls, budget allows "
            f"{budget.total} — a layout regression reintroduced data "
            f"movement"))
    elif traced < budget.total:
        findings.append(Finding(
            WARNING, "B003", budget.route,
            f"measured {traced} pad/cat calls under budget {budget.total} "
            f"— budget model is stale (tighten it)"))
    return info, findings
