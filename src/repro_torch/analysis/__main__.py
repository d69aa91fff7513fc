"""``python -m repro_torch.analysis`` — audit the paper models' plans.

Runs the static passes (verify / arena liveness / no-retrace / pad budget)
over each requested model on both engine routes (plain and kernels+layout),
on ``--device`` (``cuda`` by default; ``cpu`` runs the kernels' plain
versions), prints a human summary, optionally writes the JSON and markdown
reports, and exits non-zero if any plan fails. ``--selftest`` instead seeds
known-bad plans (swapped scales, a dangling ref, a dropped zero point, an
unwarmed bucket, an op knocked off the layout plan) and exits non-zero
unless the auditor catches every one — the guard that the guard itself
still works.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Any, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import graph as G
from repro_torch.core.engine import ExecutionPlan, bucket_floor

from .budget import audit_pads
from .fingerprint import plan_fingerprint
from .liveness import arena_liveness, measure_live_bytes, paged_peak_bytes
from .report import (ERROR, AuditReport, Finding, RouteReport, errors,
                     to_json, to_markdown)
from .retrace import audit_retrace
from .verify import verify_plan

ARENA_RTOL = 0.10  # acceptance: static peak within 10% of measured

_GENS = {
    "sine": lambda rng, n: rng.uniform(0, 2 * np.pi, (n, 1)).astype("f"),
    "speech": lambda rng, n: rng.normal(0, 1, (n, 49, 40, 1)).astype("f"),
    "person": lambda rng, n: rng.normal(0, 1, (n, 96, 96, 1)).astype("f"),
}


def quantized_graph(name: str, calib_samples: int = 8, seed: int = 0,
                    device="cuda") -> G.Graph:
    """The paper model, PTQ-quantized (calibration on ``device``) with the
    same calibrated-random representative data the serving registry uses."""
    from repro_torch.configs.paper_models import PAPER_MODELS
    from repro_torch.core.quantize import quantize_graph

    g = PAPER_MODELS[name](batch=1)
    rng = np.random.default_rng(seed)
    rep = [_GENS[name](rng, 1) for _ in range(calib_samples)]
    return quantize_graph(g, rep, device=device)


def _bare_plan(g: G.Graph) -> ExecutionPlan:
    """An ``ExecutionPlan`` assembled from loose pieces, as the reference's
    selftest assembles one: nothing folded, no layout, no paging, plain
    route, on the CPU (the verifier reads no tensor)."""
    return ExecutionPlan(g, {}, None, {}, False, torch.device("cpu"), {}, {})


def audit_plan(name: str, plan: ExecutionPlan, max_batch: int = 4,
               concrete: bool = False,
               compiled_model: Any = None) -> AuditReport:
    """All passes over one plan. The arena walk runs on the plan's CPU
    twin (abstractly unless ``concrete=True``); the pad budget's measured
    count runs the forward on the plan's device."""
    rep = AuditReport(model=name, use_kernels=plan.use_kernels)
    rep.verifier = verify_plan(plan)
    # A structurally broken plan cannot be lowered; the route passes would
    # crash on the same defect the verifier already reported.
    lowerable = not errors(rep.verifier)

    buckets = [None] + [1 << i
                        for i in range(bucket_floor(max_batch).bit_length())]
    for bucket in buckets:
        batched = bucket is not None
        b = bucket or 1
        route = RouteReport(route=f"batched[b={b}]" if batched
                            else "per-call")
        if lowerable:
            bound = arena_liveness(plan, batched=batched, bucket=b)
            route.arena["static_peak_bytes"] = bound.peak_bytes
            route.arena["peak_step"] = bound.peak_step
            measured = measure_live_bytes(plan, batched=batched, bucket=b,
                                          concrete=concrete)
            route.arena["measured_peak_bytes"] = measured
            if measured and abs(bound.peak_bytes - measured) > \
                    ARENA_RTOL * measured:
                route.findings.append(Finding(
                    ERROR, "A001", route.route,
                    f"static peak {bound.peak_bytes} B deviates more than "
                    f"{ARENA_RTOL:.0%} from measured {measured} B — the "
                    f"static shape model drifted from the lowering"))
            pads_info, pads_findings = audit_pads(plan, batched=batched,
                                                  bucket=b)
            route.pads = pads_info
            route.findings += pads_findings
        rep.routes.append(route)

    paged = paged_peak_bytes(plan)
    if paged is not None:
        pr = RouteReport(route="paged")
        pr.arena["static_peak_bytes"] = paged
        rep.routes.append(pr)

    rep.retrace, rep.retrace_findings = audit_retrace(
        plan, max_batch, compiled_model=compiled_model)
    # content address of the audited plan: an executable cache
    # cross-checks its manifest against this (fingerprint.verify_manifest,
    # finding C005)
    rep.fingerprint = plan_fingerprint(plan)
    return rep


def audit_models(names: Iterable[str], max_batch: int = 4,
                 concrete: bool = False,
                 routes: Tuple[bool, ...] = (False, True),
                 device="cuda") -> List[AuditReport]:
    reports: List[AuditReport] = []
    for name in names:
        g = quantized_graph(name, device=device)
        for use_kernels in routes:
            plan = ExecutionPlan.build(g, use_kernels=use_kernels,
                                       device=device)
            reports.append(audit_plan(name, plan, max_batch=max_batch,
                                      concrete=concrete))
    return reports


# ---------------------------------------------------------------------------
# Self-test: the auditor must catch seeded bad plans
# ---------------------------------------------------------------------------

def _expect(failures: List[str], what: str, findings: List[Finding],
            code: str) -> None:
    if not any(f.code == code and f.severity == ERROR for f in findings):
        failures.append(f"{what}: expected an {code} error, got "
                        f"{[str(f) for f in findings]}")


def selftest(verbose: bool = True, device="cuda") -> List[str]:
    """Seed one plan per defect class (the reference's five); return the
    defects that slipped through (empty = the auditor works)."""
    failures: List[str] = []

    # 1. swapped scales: bias scale set to s_w instead of s_x * s_w
    g = quantized_graph("sine", device=device)
    op = g.ops[0]
    b_t = g.tensor(op.inputs[2])
    w_t = g.tensor(op.inputs[1])
    b_t.qparams = G.QParams(np.asarray(w_t.qparams.scale),
                            np.zeros_like(np.asarray(w_t.qparams.scale),
                                          np.int32),
                            axis=b_t.qparams.axis)
    _expect(failures, "swapped scales", verify_plan(_bare_plan(g)), "V024")

    # 2. dangling tensor ref
    g = quantized_graph("sine", device=device)
    g.ops[1].inputs = [999] + list(g.ops[1].inputs[1:])
    _expect(failures, "dangling ref", verify_plan(_bare_plan(g)), "V001")

    # 3. dropped zero point on a per-channel weight
    g = quantized_graph("sine", device=device)
    w_t = g.tensor(g.ops[0].inputs[1])
    w_t.qparams = G.QParams(np.asarray(w_t.qparams.scale),
                            np.int32(0), axis=w_t.qparams.axis)
    _expect(failures, "dropped zero point", verify_plan(_bare_plan(g)),
            "V020")

    # 4. unwarmed bucket: warmed to 2, served with max_batch 8
    g = quantized_graph("sine", device=device)
    plan = ExecutionPlan.build(g, use_kernels=False, device=device)
    _, findings = audit_retrace(plan, max_batch=8, warm_batch=2)
    _expect(failures, "unwarmed bucket", findings, "R001")

    # 5. pad over budget: knock one FC off the layout plan
    g = quantized_graph("sine", device=device)
    plan = ExecutionPlan.build(g, use_kernels=True, device=device)
    broken = dict(plan.layout.layouts)
    broken.pop(sorted(broken)[0])
    plan2 = dataclasses.replace(
        plan, layout=dataclasses.replace(plan.layout, layouts=broken))
    _, findings = audit_pads(plan2)
    _expect(failures, "pad over budget", findings, "B004")

    if verbose:
        for f in failures:
            print(f"SELFTEST FAIL: {f}", file=sys.stderr)
        if not failures:
            print("selftest: all 5 seeded bad plans caught")
    return failures


# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static plan auditor for the compiled TinyML engine "
                    "(PyTorch/CUDA port)")
    ap.add_argument("--models", default="sine,speech,person",
                    help="comma-separated paper models to audit")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="serving cap the no-retrace proof assumes")
    ap.add_argument("--concrete", action="store_true",
                    help="measure arenas by computing real tensors instead "
                         "of a FakeTensorMode walk")
    ap.add_argument("--json", metavar="PATH",
                    help="write the JSON report here")
    ap.add_argument("--markdown", metavar="PATH",
                    help="write the markdown report here")
    ap.add_argument("--selftest", action="store_true",
                    help="verify the auditor catches seeded bad plans")
    ap.add_argument("--device", default="cuda",
                    help="device the plans are built on (default cuda; "
                         "cpu runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    if args.selftest:
        return 1 if selftest(device=args.device) else 0

    names = [n.strip() for n in args.models.split(",") if n.strip()]
    reports = audit_models(names, max_batch=args.max_batch,
                           concrete=args.concrete, device=args.device)
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(to_json(reports))
    if args.markdown:
        with open(args.markdown, "w") as fh:
            fh.write(to_markdown(reports))

    ok = True
    for rep in reports:
        route_kind = "kernels" if rep.use_kernels else "plain"
        status = "OK" if rep.ok else "FAIL"
        print(f"{rep.model:8s} [{route_kind:7s}] {status}")
        for r in rep.routes:
            a = r.arena
            print(f"  {r.route:14s} arena {a.get('static_peak_bytes', '-')}"
                  f" B (measured {a.get('measured_peak_bytes', '-')} B)"
                  f"  pads {r.pads.get('budget', '-')}"
                  f"/{r.pads.get('traced', '-')} (budget/measured)")
        rt = rep.retrace
        print(f"  no-retrace     buckets {rt.get('reachable_buckets')} "
              f"stage-keys {rt.get('reachable_stage_keys')} -> "
              f"{'proved' if rt.get('ok') else 'NOT PROVED'}")
        for f in errors(rep.findings):
            print(f"  {f}")
        ok = ok and rep.ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
