"""Telemetry export: OpenMetrics text exposition + structured JSON.

Unifies the three telemetry sources the serving stack already produces —
per-model :class:`~repro_torch.serve.metrics.ModelMetrics` snapshots (request
accounting, resilience counters, per-class SLO attainment), the tracer's
per-stage latency histograms, and the flight recorder's status — into:

* :func:`openmetrics` — the OpenMetrics text format (the Prometheus
  exposition dialect: ``# TYPE`` metadata, ``_bucket``/``_sum``/
  ``_count`` histogram lines, a trailing ``# EOF``), ready to serve from
  any scrape endpoint or dump next to bench results;
* :func:`json_snapshot` — one machine-readable dict for dashboards and
  tests.

Pure functions over snapshots — no imports from the serve layer, so the
export path can never create an import cycle with it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

__all__ = ["openmetrics", "json_snapshot"]

# counter fields lifted verbatim from a ModelMetrics snapshot
_COUNTERS = ("submitted", "completed", "rejected", "failed", "cancelled",
             "preempted", "collateral", "deadline_exceeded", "retries",
             "breaker_transitions", "degraded_rows", "injected_faults")
_GAUGES = ("inflight", "inflight_rows", "batches", "throughput_rps",
           "batch_occupancy")
_QUANTILES = (("p50_ms", "0.5"), ("p95_ms", "0.95"), ("p99_ms", "0.99"))


def _esc(v: Any) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


def _num(v: Any) -> str:
    if v is None:
        return "NaN"
    return repr(float(v)) if isinstance(v, float) else str(v)


def openmetrics(models_snap: Dict[str, dict],
                tracer: Any = None, engines: Optional[dict] = None,
                cache: Optional[dict] = None) -> str:
    """Render ``{model: ModelMetrics.snapshot()}`` (e.g. from
    ``ServingRegistry.snapshot()``) — plus the tracer's stage histograms,
    the per-engine compile/cache accounting (``engines``), and the
    persistent AOT cache counters (``cache``) when passed — as
    OpenMetrics text."""
    out = []

    def family(name: str, mtype: str, help_: str) -> None:
        out.append(f"# TYPE repro_{name} {mtype}")
        out.append(f"# HELP repro_{name} {help_}")

    family("requests", "counter", "request terminal-state accounting")
    for model, snap in sorted(models_snap.items()):
        for c in _COUNTERS:
            out.append(f'repro_requests_total{{model="{_esc(model)}",'
                       f'state="{c}"}} {_num(snap.get(c, 0))}')
    family("serving", "gauge", "serving gauges (inflight, throughput, "
                               "occupancy)")
    for model, snap in sorted(models_snap.items()):
        for g in _GAUGES:
            out.append(f'repro_serving{{model="{_esc(model)}",'
                       f'gauge="{g}"}} {_num(snap.get(g))}')
    family("latency_ms", "gauge",
           "end-to-end request latency percentiles (windowed)")
    for model, snap in sorted(models_snap.items()):
        for key, q in _QUANTILES:
            out.append(f'repro_latency_ms{{model="{_esc(model)}",'
                       f'quantile="{q}"}} {_num(snap.get(key))}')
    family("slo_attainment", "gauge",
           "fraction of completed requests inside the class SLO")
    for model, snap in sorted(models_snap.items()):
        for cls, cs in sorted(snap.get("classes", {}).items()):
            att = cs.get("slo_attainment")
            if att is not None:
                out.append(f'repro_slo_attainment{{model="{_esc(model)}",'
                           f'class="{_esc(cls)}"}} {_num(att)}')
    family("breaker_state", "gauge",
           "circuit-breaker state per route (0=closed 1=half_open 2=open)")
    code = {"closed": 0, "half_open": 1, "open": 2}
    for model, snap in sorted(models_snap.items()):
        for route, st in sorted(snap.get("breaker_states", {}).items()):
            out.append(f'repro_breaker_state{{model="{_esc(model)}",'
                       f'route="{_esc(route)}"}} {code.get(st, -1)}')
    if tracer is not None and getattr(tracer, "enabled", False):
        family("stage_us", "histogram",
               "per-request stage latency (tracer-derived, microseconds)")
        for stage, h in sorted(tracer.stage_snapshot().items()):
            cum = 0
            for edge, n in zip(h["edges_us"], h["counts"]):
                cum += n
                out.append(f'repro_stage_us_bucket{{stage="{_esc(stage)}",'
                           f'le="{_num(edge)}"}} {cum}')
            out.append(f'repro_stage_us_bucket{{stage="{_esc(stage)}",'
                       f'le="+Inf"}} {h["count"]}')
            out.append(f'repro_stage_us_sum{{stage="{_esc(stage)}"}} '
                       f'{_num(h["sum_us"])}')
            out.append(f'repro_stage_us_count{{stage="{_esc(stage)}"}} '
                       f'{h["count"]}')
        family("compile_events", "counter",
               "bucket executables built inside traced flushes")
        out.append(f"repro_compile_events_total {tracer.compile_events}")
    if engines:
        family("engine_compiles", "counter",
               "bucket executables built per engine (CUDA-graph "
               "captures on the card)")
        for model, e in sorted(engines.items()):
            out.append(f'repro_engine_compiles_total{{model='
                       f'"{_esc(model)}"}} '
                       f'{_num(e.get("compile_events", 0))}')
        family("engine_cache_events", "counter",
               "persistent AOT cache interactions per engine")
        for model, e in sorted(engines.items()):
            for kind in ("hit", "miss", "store"):
                out.append(f'repro_engine_cache_events_total{{model='
                           f'"{_esc(model)}",event="{kind}"}} '
                           f'{_num(e.get("cache_events", {}).get(kind, 0))}')
    if cache:
        family("aot_cache", "counter",
               "registry-level persistent executable cache counters")
        for kind in ("hits", "misses", "stores"):
            out.append(f'repro_aot_cache_total{{event="{kind}"}} '
                       f'{_num(cache.get(kind, 0))}')
    out.append("# EOF")
    return "\n".join(out) + "\n"


def json_snapshot(models_snap: Dict[str, dict], tracer: Any = None,
                  flight: Any = None, engines: Optional[dict] = None,
                  cache: Optional[dict] = None) -> Dict[str, Any]:
    """One structured dict unifying every telemetry source."""
    doc: Dict[str, Any] = {"models": models_snap}
    if tracer is not None and getattr(tracer, "enabled", False):
        doc["trace"] = tracer.snapshot()
        doc["stage_breakdown_us"] = tracer.stage_means_us()
    if flight is not None:
        doc["flight"] = flight.status()
    if engines is not None:
        doc["engines"] = engines
    if cache is not None:
        doc["aot_cache"] = cache
    return doc
