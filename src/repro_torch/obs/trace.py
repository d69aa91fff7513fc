"""Request-lifecycle tracing for the serving stack, and the engine's and
the batcher's host work in counted spans.

Every request admitted by a :class:`~repro_torch.serve.scheduler.MicroBatcher`
gets a trace id; every lifecycle stage it passes through —

    admit -> queue -> flush_assemble -> pad_stage -> dispatch -> device
          -> validate -> retry/degrade -> complete | shed | expire

— becomes a :class:`Span` stamped with the *injected* clock, so FakeClock
tests stay zero-sleep and bit-deterministic while wall-clock runs get real
timings.

Counted spans (:data:`COUNTED`) split the host time of one engine call
(one ``staged_infer`` / ``predict_q_staged``, one bucket chunk of
``predict_q_many``, one ``predict_q``) and of one flush's resolution:

    engine.stage    rows into the host buffer the copy reads (staging
                    checkout, the row loop or the buffer fill, numpy to
                    torch on the per-call path)
    engine.launch   the model's replay lock taken, the input copies, the
                    graph replay and the output copies issued (on the CPU,
                    the eager forward)
    engine.sync     the host waiting for the card (``done.synchronize``;
                    absent on the CPU)
    engine.unstage  answers copied out to numpy, the staging buffer
                    re-zeroed and returned
    sched.resolve   the batcher setting every row's answer and doing the
                    flush's accounting (``_distribute``)

The four engine spans are consecutive (:class:`Lap`): together they cover
the call from entry to return. Each adds its duration to the tracer's
accumulator (:meth:`Tracer.counters`: ``<span>.n`` and ``<span>.sum_us``,
one count per occurrence, not per request); inside a flush scope each is
also a child span of the flush. While a torch profiler records, each
counted span and ``flush_assemble`` is also a profiler range of its name
(``_RecordFunctionFast``: a host event only, no device-side copy), so a
device trace names an idle gap by the span over it. The tracer's clock
offset to ``time.time_ns()`` (:attr:`Tracer.clock_offset_ns`) lays dumped
spans on such a trace.

The design follows the repo's everything-bounded discipline:

* all per-request state lives in dicts/deques with hard caps — a tracer
  never grows without bound no matter how long the process serves;
* the hot path is allocation-light: one ``_Req`` per admission, one
  ``_Flush`` per batch, plain ``Span`` objects with ``__slots__``; outside
  a flush a counted span is two clock reads and an add;
* a disabled tracer (``NULL_TRACER``) costs one attribute check per hook,
  and an engine call with no tracer bound and no scope active reads no
  clock and allocates nothing for tracing.

Span context crosses the scheduler -> executor -> worker-thread boundary
via :class:`TraceHandle`, which rides ``DispatchCtx.trace``.  Because
``loop.run_in_executor`` does **not** propagate context to the worker
thread, executors re-enter the handle's scope explicitly (via
:meth:`TraceHandle.bind`); inside that scope the engine's
:func:`engine_call` / :func:`engine_span` / :func:`engine_event` helpers
attach spans to the active flush without the engine importing anything
from the serving layer. Outside a scope an engine call records into the
Tracer bound to the model (``CompiledModel.tracer``).
"""
from __future__ import annotations

import bisect
import itertools
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

try:  # a profiler range that is a host event only (no user annotation)
    from torch._C._profiler import _RecordFunctionFast as _Range
    from torch.autograd import _profiler_enabled
except ImportError:  # a torch without it: spans open no profiler range
    _Range = None

__all__ = [
    "Span", "StageHist", "Tracer", "TraceHandle", "Lap", "NULL_TRACER",
    "STAGES", "TERMINALS", "ENGINE_SPANS", "COUNTED", "engine_call",
    "end_call", "engine_span", "engine_event", "profile_range", "close_range",
]

# Span taxonomy (the names histograms and tests key on).  "queue" is the
# per-request wait from admission to flush take; the rest are per-flush
# stages shared by every member of the batch.
STAGES = ("queue", "flush_assemble", "pad_stage", "dispatch", "device",
          "validate", "retry", "total")
TERMINALS = ("complete", "failed", "shed", "expire")
# Counted spans: one count and one µs sum each per occurrence (engine call
# or flush), from construction on (see the module docstring).
ENGINE_SPANS = ("engine.stage", "engine.launch", "engine.sync",
                "engine.unstage")
COUNTED = ENGINE_SPANS + ("sched.resolve",)

_ids = itertools.count(1)  # shared span/trace id source (GIL-atomic next())


class Span:
    """One timed stage. ``trace_id`` is the owning request ("r<n>") or
    flush ("f<n>"); flush-child spans parent to the flush root span."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "t0", "t1",
                 "attrs")

    def __init__(self, trace_id: str, name: str, t0: float,
                 t1: Optional[float] = None, parent_id: Optional[str] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.trace_id = trace_id
        self.span_id = f"s{next(_ids)}"
        self.parent_id = parent_id
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.attrs = attrs or {}

    def dur_s(self) -> float:
        return 0.0 if self.t1 is None else max(0.0, self.t1 - self.t0)

    def to_dict(self) -> Dict[str, Any]:
        return {"trace": self.trace_id, "span": self.span_id,
                "parent": self.parent_id, "name": self.name,
                "t0": self.t0, "t1": self.t1, "attrs": dict(self.attrs)}

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"Span({self.name} {self.trace_id} "
                f"[{self.t0:.6f},{self.t1}])")


class StageHist:
    """Fixed-edge latency histogram (µs) — static footprint, OpenMetrics-
    exportable as ``_bucket``/``_sum``/``_count`` lines."""

    EDGES_US: Tuple[float, ...] = (
        10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
        1e3, 2e3, 5e3, 1e4, 2e4, 5e4, 1e5, 2e5, 5e5, 1e6)

    __slots__ = ("counts", "sum_us", "n")

    def __init__(self) -> None:
        self.counts = [0] * (len(self.EDGES_US) + 1)  # +Inf bucket
        self.sum_us = 0.0
        self.n = 0

    def observe(self, us: float) -> None:
        self.counts[bisect.bisect_left(self.EDGES_US, us)] += 1
        self.sum_us += us
        self.n += 1

    def mean_us(self) -> float:
        return self.sum_us / self.n if self.n else 0.0

    def snapshot(self) -> Dict[str, Any]:
        return {"edges_us": list(self.EDGES_US),
                "counts": list(self.counts),
                "sum_us": self.sum_us, "count": self.n,
                "mean_us": self.mean_us()}


class _Req:
    __slots__ = ("rid", "model", "cls", "t_admit", "fid", "queue_span")

    def __init__(self, rid: str, model: str, cls: str, t: float):
        self.rid = rid
        self.model = model
        self.cls = cls
        self.t_admit = t
        self.fid: Optional[str] = None
        self.queue_span = Span(rid, "queue", t)


class _Flush:
    __slots__ = ("fid", "model", "rows", "bucket", "root", "spans",
                 "pending", "closed")

    def __init__(self, fid: str, model: str, rows: int, bucket: int,
                 t0: float):
        self.fid = fid
        self.model = model
        self.rows = rows
        self.bucket = bucket
        self.root = Span(fid, "flush", t0,
                         attrs={"model": model, "rows": rows,
                                "bucket": bucket})
        self.spans: List[Span] = []  # child spans (append is GIL-atomic)
        self.pending: set = set()    # member rids not yet terminal
        self.closed = False


# --------------------------------------------------------------------------
# Thread-local scope: how engine spans find the active flush.  contextvars
# do NOT survive loop.run_in_executor, so executors re-enter the scope on
# the worker thread via TraceHandle.bind()/scope().
# --------------------------------------------------------------------------

class _Local(threading.local):
    handle: Optional["TraceHandle"] = None  # the flush scope active here
    call: Optional["Lap"] = None  # the engine call running on this thread


_tls = _Local()


class _Scope:
    __slots__ = ("handle", "prev")

    def __init__(self, handle: Optional["TraceHandle"]):
        self.handle = handle
        self.prev: Optional[TraceHandle] = None

    def __enter__(self) -> "_Scope":
        self.prev = _tls.handle
        _tls.handle = self.handle
        return self

    def __exit__(self, *exc: Any) -> None:
        _tls.handle = self.prev


def profile_range(name: str) -> Any:
    """A torch profiler range named ``name``, entered, while a profiler
    records; None otherwise (and where torch lacks the fast range).
    Close it with :func:`close_range`."""
    if _Range is None or not _profiler_enabled():
        return None
    rng = _Range(name)
    rng.__enter__()
    return rng


def close_range(rng: Any) -> None:
    if rng is not None:
        rng.__exit__(None, None, None)


class Lap:
    """Consecutive counted spans on one thread: the first starts at
    construction, :meth:`lap` closes the running span and starts the next
    at the same clock reading, :meth:`end` closes the last. Each closed
    span adds to ``tracer``'s accumulator and, with a ``handle``, lands on
    that flush's trace; while a torch profiler records (checked once, at
    construction) each is also a profiler range of its name. The
    accumulator is not locked: engine calls on several threads at once may
    lose an update."""

    __slots__ = ("acc", "handle", "now", "name", "t", "rng", "depth")

    def __init__(self, tracer: "Tracer", handle: Optional["TraceHandle"],
                 now: Callable[[], float], name: str):
        self.acc = tracer._acc
        self.handle = handle
        self.now = now
        self.depth = 0  # engine entry points nested inside this call
        self.name: Optional[str] = name
        # the running span's profiler range; None throughout when no
        # profiler records
        self.rng = profile_range(name)
        self.t = now()

    def _settle(self, t: float) -> None:
        if self.rng is not None:
            self.rng.__exit__(None, None, None)
        a = self.acc[self.name]
        a[0] += 1
        a[1] += t - self.t
        if self.handle is not None:
            self.handle.span(self.name, self.t, t)

    def lap(self, name: str) -> None:
        t = self.now()
        self._settle(t)
        self.name, self.t = name, t
        if self.rng is not None:
            self.rng = _Range(name)
            self.rng.__enter__()

    def end(self) -> None:
        if self.name is not None:
            self._settle(self.now())
            self.name = None


def engine_call(bound: Optional["Tracer"]) -> Optional[Lap]:
    """Start one engine call's counted spans at ``engine.stage``: on the
    flush whose scope is active on this thread, else on ``bound`` (the
    model's Tracer). An engine entry point called inside a running call
    joins it. Returns None — having read no clock and allocated nothing —
    when there is neither. The caller ends what it got with
    :func:`end_call`, also when it raises."""
    lap = _tls.call
    if lap is not None:
        lap.depth += 1
        return lap
    h = _tls.handle
    if h is not None:
        lap = Lap(h.tracer, h, h.clock.now, "engine.stage")
    elif bound is None or not bound.enabled:
        return None
    else:
        lap = Lap(bound, None, bound.now, "engine.stage")
    _tls.call = lap
    return lap


def end_call(lap: Lap) -> None:
    """End an engine call started (or joined) by :func:`engine_call`."""
    if lap.depth:
        lap.depth -= 1
        return
    _tls.call = None
    lap.end()


class _EngineSpan:
    """Context manager emitted by :func:`engine_span`; near-free when no
    trace scope is active on this thread."""

    __slots__ = ("name", "attrs", "handle", "t0")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self.handle = _tls.handle
        self.t0 = 0.0

    def __enter__(self) -> "_EngineSpan":
        h = self.handle
        if h is not None:
            self.t0 = h.clock.now()
        return self

    def __exit__(self, *exc: Any) -> None:
        h = self.handle
        if h is not None:
            h.span(self.name, self.t0, h.clock.now(), **self.attrs)


def engine_span(name: str, **attrs: Any) -> _EngineSpan:
    """Time a stage inside the engine (pad_stage) and attach it to the
    flush whose scope is active on this thread; no-op otherwise."""
    return _EngineSpan(name, attrs)


def engine_event(name: str, **attrs: Any) -> None:
    """Record a point event (e.g. a bucket capture) against the active
    flush; no-op when no trace scope is active on this thread."""
    h = _tls.handle
    if h is not None:
        h.event(name, h.clock.now(), **attrs)


class TraceHandle:
    """Capability to record spans against one flush; rides
    ``DispatchCtx.trace`` across executors and worker threads."""

    __slots__ = ("tracer", "fid", "clock")

    def __init__(self, tracer: "Tracer", fid: str, clock: Any):
        self.tracer = tracer
        self.fid = fid
        self.clock = clock

    def span(self, name: str, t0: float, t1: float, **attrs: Any) -> None:
        self.tracer.span(self.fid, name, t0, t1, **attrs)

    def event(self, name: str, t: float, **attrs: Any) -> None:
        self.tracer.event(self.fid, name, t, **attrs)

    def breaker(self, route: str, old: str, new: str, t: float) -> None:
        self.tracer.breaker_event(self.fid, route, old, new, t)

    def scope(self) -> _Scope:
        """Enter this flush's trace scope on the current thread."""
        return _Scope(self)

    def lap(self, name: str) -> Lap:
        """Start the counted span ``name`` on this flush."""
        return Lap(self.tracer, self, self.clock.now, name)

    def bind(self, fn: Callable[..., Any]) -> Callable[..., Any]:
        """Wrap ``fn`` so it runs inside this flush's scope — used by
        off-loop executors whose worker threads don't inherit it."""
        def wrapped(*args: Any, **kw: Any) -> Any:
            with _Scope(self):
                return fn(*args, **kw)
        return wrapped


class Tracer:
    """Stamps requests at admission, groups their batch stages into flush
    traces, and folds every terminal into per-stage histograms.

    All retention is bounded: ``keep_traces`` finished request trees and
    ``keep_flushes`` finished flush records are kept for introspection
    (tests, selftest, export); older ones are evicted FIFO.

    ``clock`` (an object with ``now()`` in seconds; ``time.monotonic`` when
    None) stamps the counted spans of engine calls made outside a flush
    scope; spans inside a flush take the batcher's clock.
    ``clock_offset_ns`` is read once, here: ``time.time_ns()`` less the
    clock's reading, in ns (None for a clock marked ``virtual``, such as
    ``FakeClock``), so that a span's ``t * 1e9 + clock_offset_ns`` is on
    the Unix-epoch timeline a torch profiler trace stamps.
    """

    def __init__(self, *, enabled: bool = True, flight: Any = None,
                 keep_traces: int = 256, keep_flushes: int = 64,
                 clock: Any = None):
        self.enabled = enabled
        self.flight = flight
        self.now: Callable[[], float] = (time.monotonic if clock is None
                                         else clock.now)
        self.clock_offset_ns: Optional[int] = (
            None if getattr(clock, "virtual", False)
            else time.time_ns() - round(self.now() * 1e9))
        if flight is not None:
            flight.clock_offset_ns = self.clock_offset_ns
        # counted spans: name -> [occurrences, seconds]
        self._acc: Dict[str, List[float]] = {n: [0, 0.0] for n in COUNTED}
        self._active: Dict[str, _Req] = {}
        self._flushes: Dict[str, _Flush] = {}
        self._done: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._recent_flushes: "OrderedDict[str, _Flush]" = OrderedDict()
        self._keep_traces = keep_traces
        self._keep_flushes = keep_flushes
        self.hists: Dict[str, StageHist] = {s: StageHist() for s in STAGES}
        self.counts: Dict[str, int] = {t: 0 for t in TERMINALS}
        self.counts["rejected"] = 0
        self.compile_events = 0

    # -- admission / queue ------------------------------------------------

    def admit(self, model: str, cls: str, t: float) -> Optional[str]:
        if not self.enabled:
            return None
        rid = f"r{next(_ids)}"
        self._active[rid] = _Req(rid, model, cls, t)
        return rid

    def rejected(self, model: str, cls: str, t: float) -> None:
        if not self.enabled:
            return
        self.counts["rejected"] += 1
        if self.flight is not None:
            self.flight.record("shed", t, model=model, cls=cls,
                               reason="rejected")

    # -- flush lifecycle --------------------------------------------------

    def flush_begin(self, rids: Sequence[Optional[str]], t: float, *,
                    model: str, rows: int, bucket: int) -> Optional[str]:
        if not self.enabled:
            return None
        fid = f"f{next(_ids)}"
        fl = _Flush(fid, model, rows, bucket, t)
        for rid in rids:
            req = self._active.get(rid) if rid else None
            if req is None:
                continue
            req.fid = fid
            req.queue_span.t1 = t
            fl.pending.add(rid)
        self._flushes[fid] = fl
        return fid

    def handle(self, fid: Optional[str], clock: Any) -> Optional[TraceHandle]:
        if not self.enabled or fid is None:
            return None
        return TraceHandle(self, fid, clock)

    def span(self, fid: Optional[str], name: str, t0: float, t1: float,
             **attrs: Any) -> None:
        if not self.enabled or fid is None:
            return
        fl = self._flushes.get(fid) or self._recent_flushes.get(fid)
        if fl is None:
            return
        fl.spans.append(Span(fid, name, t0, t1,
                             parent_id=fl.root.span_id, attrs=attrs))

    def event(self, fid: Optional[str], name: str, t: float,
              **attrs: Any) -> None:
        if not self.enabled:
            return
        if name == "compile":
            self.compile_events += 1
        self.span(fid, name, t, t, **attrs)
        if self.flight is not None:
            # Attrs may carry a "kind" key (engine compile events do), which
            # would collide with FlightRecorder.record's positional `kind`.
            fields = {("what" if k == "kind" else k): v
                      for k, v in attrs.items()}
            self.flight.record(name, t, fid=fid, **fields)

    def breaker_event(self, fid: Optional[str], route: str, old: str,
                      new: str, t: float) -> None:
        if not self.enabled:
            return
        self.span(fid, "breaker", t, t, route=route, old=old, new=new)
        if self.flight is not None:
            self.flight.record("breaker", t, fid=fid, route=route,
                               old=old, new=new)
            if new == "open":
                self.flight.trigger("breaker_open", t)

    def flush_end(self, fid: Optional[str], t: float) -> None:
        if not self.enabled or fid is None:
            return
        fl = self._flushes.get(fid)
        if fl is None:
            return
        fl.root.t1 = t
        fl.closed = True
        self._maybe_retire_flush(fl)

    def flush_error(self, fid: Optional[str], model: str, err: Exception,
                    t: float) -> None:
        if not self.enabled:
            return
        self.span(fid, "fault", t, t, model=model,
                  error=type(err).__name__, detail=repr(err))
        if self.flight is not None:
            self.flight.record("fault", t, fid=fid, model=model,
                               error=type(err).__name__, detail=repr(err))
            self.flight.trigger("flush_error", t)

    def slo_miss(self, model: str, cls: str, t: float,
                 latency_s: float, slo_s: float) -> None:
        if not self.enabled:
            return
        if self.flight is not None:
            self.flight.record("slo_miss", t, model=model, cls=cls,
                               latency_s=latency_s, slo_s=slo_s)
            self.flight.note_slo_miss(t)

    # -- terminals --------------------------------------------------------

    def terminal(self, rid: Optional[str], t: float, kind: str,
                 **attrs: Any) -> None:
        """Record the request's exactly-one terminal state; computes the
        per-stage breakdown and feeds the stage histograms."""
        if not self.enabled or rid is None:
            return
        req = self._active.pop(rid, None)
        if req is None:
            return
        self.counts[kind] = self.counts.get(kind, 0) + 1
        if req.queue_span.t1 is None:  # never flushed (shed/expired/...)
            req.queue_span.t1 = t
        fl = None
        if req.fid is not None:
            fl = (self._flushes.get(req.fid)
                  or self._recent_flushes.get(req.fid))
        sums_us = {s: 0.0 for s in
                   ("flush_assemble", "pad_stage", "dispatch", "device",
                    "validate", "retry")}
        spans: List[Span] = [req.queue_span]
        if fl is not None:
            spans.append(fl.root)
            spans.extend(fl.spans)
            for sp in fl.spans:
                if sp.name in sums_us:
                    sums_us[sp.name] += sp.dur_s() * 1e6
        queue_us = req.queue_span.dur_s() * 1e6
        total_us = max(0.0, t - req.t_admit) * 1e6
        self.hists["queue"].observe(queue_us)
        self.hists["total"].observe(total_us)
        for s, us in sums_us.items():
            self.hists[s].observe(us)
        tree = {"trace_id": rid, "model": req.model, "cls": req.cls,
                "terminal": kind, "t_admit": req.t_admit, "t_end": t,
                "flush": req.fid,
                "spans": spans,
                "breakdown_us": {"queue_wait_us": queue_us,
                                 "assemble_us": sums_us["flush_assemble"],
                                 "pad_us": sums_us["pad_stage"],
                                 "dispatch_us": sums_us["dispatch"],
                                 "device_us": sums_us["device"],
                                 "validate_us": sums_us["validate"],
                                 "retry_us": sums_us["retry"],
                                 "total_us": total_us},
                **({"attrs": attrs} if attrs else {})}
        self._done[rid] = tree
        while len(self._done) > self._keep_traces:
            self._done.popitem(last=False)
        if self.flight is not None:
            self.flight.record("terminal", t, rid=rid, model=req.model,
                               cls=req.cls, state=kind, **attrs)
        if fl is not None:
            fl.pending.discard(rid)
            self._maybe_retire_flush(fl)

    def _maybe_retire_flush(self, fl: _Flush) -> None:
        if not fl.closed or fl.pending:
            return
        self._flushes.pop(fl.fid, None)
        self._recent_flushes[fl.fid] = fl
        while len(self._recent_flushes) > self._keep_flushes:
            self._recent_flushes.popitem(last=False)

    # -- introspection ----------------------------------------------------

    def trees(self) -> List[Dict[str, Any]]:
        return list(self._done.values())

    def counters(self) -> Dict[str, float]:
        """The counted spans' accumulators as a flat dict with a fixed key
        set: ``<span>.n`` and ``<span>.sum_us`` for each of
        :data:`COUNTED`, zero before the first occurrence."""
        out: Dict[str, float] = {}
        for name in COUNTED:
            n, s = self._acc[name]
            out[name + ".n"] = n
            out[name + ".sum_us"] = s * 1e6
        return out

    def stage_snapshot(self) -> Dict[str, Dict[str, Any]]:
        return {s: h.snapshot() for s, h in self.hists.items()}

    def stage_means_us(self) -> Dict[str, float]:
        """``json_snapshot``'s ``stage_breakdown_us``: mean per-request µs
        spent in each headline stage (zeros count — a request with no
        retry contributes 0 to the retry mean)."""
        return {"queue_wait_us": self.hists["queue"].mean_us(),
                "pad_us": self.hists["pad_stage"].mean_us(),
                "device_us": self.hists["device"].mean_us(),
                "retry_us": self.hists["retry"].mean_us()}

    def snapshot(self) -> Dict[str, Any]:
        return {"active": len(self._active),
                "open_flushes": len(self._flushes),
                "terminals": dict(self.counts),
                "compile_events": self.compile_events,
                "stages": self.stage_snapshot(),
                "counters": self.counters(),
                "clock_offset_ns": self.clock_offset_ns}


#: Shared disabled tracer — the default everywhere a tracer is optional.
NULL_TRACER = Tracer(enabled=False)
