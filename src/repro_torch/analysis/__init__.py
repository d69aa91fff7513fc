"""Compile-time plan auditor — the port of ``repro.analysis``.

Five static passes over a :class:`repro_torch.core.engine.ExecutionPlan`:

* :mod:`.verify`  — graph verifier: shapes/dtypes/quant params propagate
  through the registry ``infer`` specs; TFLite PTQ invariants hold; every
  op has a lowering on the selected route.
* :mod:`.liveness` — arena liveness: per-tensor live ranges and the peak
  static arena bytes per route, cross-validated against a measured walk of
  the real lowerings and what the card reports (:func:`device_advisory`).
* :mod:`.retrace` — no-retrace auditor: the serving hot path cannot build
  (on CUDA: capture) after ``warmup_batched`` (reachable keys ⊆ warmed
  keys), plus the capture-safety lint of the plan's constants.
* :mod:`.budget`  — pad/copy budget: the exact number of pad and
  concatenation calls each route's forward makes, derived from the
  ``LayoutPlan`` and the device, against the count measured while it runs.
* :mod:`.fingerprint` — plan content address + executable-cache manifest
  verification (findings ``C001``–``C005``).

``python -m repro_torch.analysis`` audits the paper models and emits JSON /
markdown reports; ``--selftest`` proves the auditor still catches seeded
bad plans.
"""
from .budget import PadBudget, audit_pads, measured_pads, pad_budget
from .fingerprint import (build_manifest, environment_info,
                          plan_fingerprint, stage_key_id, verify_manifest)
from .liveness import (ArenaBound, arena_liveness, device_advisory,
                       measure_live_bytes, paged_peak_bytes)
from .report import (ERROR, INFO, WARNING, AuditReport, Finding,
                     RouteReport, errors, to_json, to_markdown)
from .retrace import (audit_retrace, lint_weak_types, reachable_buckets,
                      reachable_chunk_batches, reachable_stage_keys,
                      warmed_buckets, warmed_stage_keys)
from .verify import static_output_bounds, verify_plan

__all__ = [
    "ERROR", "INFO", "WARNING",
    "ArenaBound", "AuditReport", "Finding", "PadBudget", "RouteReport",
    "arena_liveness", "audit_pads", "audit_retrace", "build_manifest",
    "device_advisory", "environment_info", "errors", "lint_weak_types",
    "measure_live_bytes", "measured_pads", "pad_budget", "paged_peak_bytes",
    "plan_fingerprint", "reachable_buckets", "reachable_chunk_batches",
    "reachable_stage_keys", "stage_key_id", "to_json", "to_markdown",
    "verify_manifest", "verify_plan", "warmed_buckets", "warmed_stage_keys",
]
