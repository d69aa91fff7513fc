"""Observability for the serving stack: tracing, flight recorder, export.

Three layers, all bounded-memory and driven by the injected clock:

* :mod:`repro_torch.obs.trace` — per-request lifecycle spans
  (``admit -> queue -> flush_assemble -> pad_stage -> dispatch -> device
  -> validate -> retry/degrade -> complete|shed|expire``) with per-stage
  latency histograms; span context rides ``DispatchCtx.trace`` through
  the scheduler, executors, and the resilience ladder, and the engine
  attaches pad/device/compile spans via a thread-local scope. Counted
  spans split the host time of each engine call (``engine.stage``,
  ``engine.launch``, ``engine.sync``, ``engine.unstage``) and of each
  flush's resolution (``sched.resolve``) into ``Tracer.counters()``; while
  a torch profiler records they, and ``flush_assemble``, are profiler
  ranges too.
* :mod:`repro_torch.obs.flight` — a fixed-capacity ring buffer of recent
  span/fault/breaker/retry events, dumped to ``results/flightrec.json``
  on FlushError, breaker-open, or an SLO-miss burst.
* :mod:`repro_torch.obs.export` — OpenMetrics text exposition and a structured
  JSON snapshot unifying ModelMetrics, SLO attainment, resilience
  counters, and the stage histograms.

``python -m repro_torch.obs --selftest`` replays a seeded FakeClock scenario
end-to-end (clean flush, transient-fault retry, route degradation,
breaker-open flight dump) and asserts complete span trees.
"""
from .trace import (COUNTED, ENGINE_SPANS, NULL_TRACER, STAGES, TERMINALS,
                    Span, StageHist, TraceHandle, Tracer, engine_event,
                    engine_span)
from .flight import FlightRecorder
from .export import json_snapshot, openmetrics

__all__ = [
    "Tracer", "TraceHandle", "NULL_TRACER", "Span", "StageHist",
    "STAGES", "TERMINALS", "ENGINE_SPANS", "COUNTED", "engine_span",
    "engine_event",
    "FlightRecorder", "openmetrics", "json_snapshot",
]
