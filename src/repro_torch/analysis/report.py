"""Audit findings and the per-model report the CLI emits — the port's copy
of ``repro.analysis.report`` (which imports no JAX, but the port imports
nothing of the JAX package).

A :class:`Finding` is one fact the static passes established about a plan
— an error (the plan is unsafe to serve), a warning (suspicious but not
disqualifying), or info (a bound worth recording, e.g. the peak arena).
The :class:`AuditReport` aggregates the passes' findings per model and
route and renders them as JSON (machine-checkable artifact) or markdown.
The finding codes, the shapes and the JSON keys are the reference's; the
route flag follows the port (``use_kernels``, route ``"kernels+layout"``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

ERROR = "error"
WARNING = "warning"
INFO = "info"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One verdict from a static pass.

    ``code`` namespaces the check (``V``\\*: graph verifier, ``A``\\*:
    arena liveness, ``R``\\*: no-retrace auditor, ``B``\\*: pad budget,
    ``C``\\*: executable-cache manifest),
    ``where`` names the op/tensor it anchors to, and ``message`` states
    the fact — severities follow the module constants above.
    """

    severity: str
    code: str
    where: str
    message: str

    def as_dict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return f"[{self.severity}] {self.code} {self.where}: {self.message}"


def errors(findings: List[Finding]) -> List[Finding]:
    return [f for f in findings if f.severity == ERROR]


@dataclasses.dataclass
class RouteReport:
    """One route's audit results for one model (per-call / batched /
    paged lower from the same plan but have different static bounds)."""

    route: str                      # "per-call" | "batched[b=N]" | "paged"
    findings: List[Finding] = dataclasses.field(default_factory=list)
    arena: Dict[str, Any] = dataclasses.field(default_factory=dict)
    pads: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not errors(self.findings)


@dataclasses.dataclass
class AuditReport:
    """Everything the auditor established about one model's plan."""

    model: str
    use_kernels: bool
    verifier: List[Finding] = dataclasses.field(default_factory=list)
    routes: List[RouteReport] = dataclasses.field(default_factory=list)
    retrace: Dict[str, Any] = dataclasses.field(default_factory=dict)
    retrace_findings: List[Finding] = dataclasses.field(default_factory=list)
    # plan content address (repro_torch.analysis.fingerprint) — lets an
    # executable cache cross-check its manifest against this audit (C005)
    fingerprint: Optional[str] = None

    @property
    def findings(self) -> List[Finding]:
        out = list(self.verifier) + list(self.retrace_findings)
        for r in self.routes:
            out.extend(r.findings)
        return out

    @property
    def ok(self) -> bool:
        return not errors(self.findings)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "model": self.model,
            "use_kernels": self.use_kernels,
            "fingerprint": self.fingerprint,
            "ok": self.ok,
            "verifier": [f.as_dict() for f in self.verifier],
            "retrace": self.retrace,
            "retrace_findings": [f.as_dict()
                                 for f in self.retrace_findings],
            "routes": [{
                "route": r.route,
                "ok": r.ok,
                "arena": r.arena,
                "pads": r.pads,
                "findings": [f.as_dict() for f in r.findings],
            } for r in self.routes],
        }


def to_json(reports: List[AuditReport]) -> str:
    doc = {
        "ok": all(r.ok for r in reports),
        "models": [r.as_dict() for r in reports],
    }
    return json.dumps(doc, indent=2, sort_keys=True)


def _fmt_bytes(n: Optional[int]) -> str:
    if n is None:
        return "-"
    return f"{n / 1024:.1f} kB" if n >= 1024 else f"{n} B"


def to_markdown(reports: List[AuditReport]) -> str:
    lines: List[str] = ["# Static plan audit", ""]
    for rep in reports:
        route_kind = "kernels+layout" if rep.use_kernels else "plain"
        status = "OK" if rep.ok else "FAIL"
        lines.append(f"## {rep.model} ({route_kind}) — {status}")
        lines.append("")
        lines.append("| route | peak arena (static) | peak arena (measured)"
                     " | pads (budget) | pads (measured) |")
        lines.append("|---|---|---|---|---|")
        for r in rep.routes:
            budget = r.pads.get("budget")
            lines.append("| {} | {} | {} | {} | {} |".format(
                r.route,
                _fmt_bytes(r.arena.get("static_peak_bytes")),
                _fmt_bytes(r.arena.get("measured_peak_bytes")),
                "-" if budget is None else budget,
                r.pads.get("traced", "-")))
        lines.append("")
        if rep.retrace:
            lines.append(
                "- no-retrace: buckets {} / staged pads {} — {}".format(
                    rep.retrace.get("reachable_buckets"),
                    rep.retrace.get("reachable_stage_keys"),
                    "proved" if rep.retrace.get("ok") else "NOT proved"))
        shown = [f for f in rep.findings if f.severity != INFO]
        for f in shown:
            lines.append(f"- {f}")
        lines.append("")
    return "\n".join(lines)
