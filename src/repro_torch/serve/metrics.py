"""Per-model serving counters: latency percentiles, throughput, batch
occupancy, per-priority-class breakdowns.

The serving-scale analogue of the paper's static-memory discipline applies
here too: every structure is bounded up front (fixed-capacity latency
windows, scalar counters, one ``_ClassStats`` per configured priority
class), so metrics collection itself cannot grow RSS under sustained load.
Snapshots are plain dicts, cheap enough to take per flush.

All timestamps come from the owner's clock (``repro_torch.serve.scheduler.Clock``)
so the deterministic fake-clock tests pin percentile and throughput math
exactly — no wall-clock reads hide in here.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np


def _percentiles(lat: deque, ps=(50, 95, 99)) -> dict:
    if not lat:
        return {f"p{p}_ms": None for p in ps}
    arr = np.asarray(lat, np.float64) * 1e3
    return {f"p{p}_ms": float(np.percentile(arr, p)) for p in ps}


class _ClassStats:
    """Bounded per-priority-class accounting (one per class name)."""

    __slots__ = ("submitted", "completed", "rejected", "failed", "cancelled",
                 "preempted", "collateral", "deadline_exceeded",
                 "batched_rows", "slo_hits", "slo_misses", "_lat")

    def __init__(self, window: int):
        self.submitted = 0
        self.completed = 0
        self.rejected = 0
        self.failed = 0
        self.cancelled = 0
        self.preempted = 0
        self.collateral = 0   # failed rows attributed to a batchmate's
        #                       poison (a sub-count of failed)
        self.deadline_exceeded = 0  # expired while PENDING (wall deadline)
        self.batched_rows = 0
        self.slo_hits = 0     # completed with latency <= the class SLO
        self.slo_misses = 0   # completed past the SLO (hits+misses = with-SLO)
        self._lat = deque(maxlen=window)

    def snapshot(self, total_batched_rows: int) -> dict:
        with_slo = self.slo_hits + self.slo_misses
        snap = {
            "submitted": self.submitted,
            "completed": self.completed,
            "rejected": self.rejected,
            "failed": self.failed,
            "cancelled": self.cancelled,
            "preempted": self.preempted,
            "collateral": self.collateral,
            "deadline_exceeded": self.deadline_exceeded,
            # same exactly-one-terminal-state balance the model-level
            # snapshot derives: admitted minus every terminal. Non-zero
            # only while requests are genuinely pending/in flight; a
            # chaos storm that drains must leave every class at 0.
            "inflight": (self.submitted - self.completed - self.failed
                         - self.cancelled - self.preempted
                         - self.deadline_exceeded),
            # this class's share of all dispatched rows — the per-class
            # occupancy view: who is actually filling the buckets
            "row_share": (self.batched_rows / total_batched_rows
                          if total_batched_rows else None),
            "slo_attainment": (self.slo_hits / with_slo if with_slo
                               else None),
        }
        snap.update(_percentiles(self._lat))
        return snap


class ModelMetrics:
    """Counters for one served model.

    * ``submitted / completed / rejected / failed / cancelled / preempted``
      — request accounting. ``rejected`` counts admissions shed by the
      bounded queue (backpressure): load the system refused rather than
      buffered. ``failed`` counts admitted requests whose *inference*
      failed (poison batch). ``cancelled`` counts admitted requests whose
      caller abandoned the future (cancelled/timed out) before the result
      landed, or that were dropped by a non-drain close — previously these
      were folded into ``failed``, which made real inference errors
      indistinguishable from client disconnects. ``preempted`` counts
      pending requests evicted by shed-by-priority admission (a
      higher-priority newcomer took their queue slot).
      ``deadline_exceeded`` counts requests whose per-class SLO wall
      deadline passed while still pending (scheduler-expired, distinct
      from caller cancellation); ``collateral`` is a *sub-count* of
      ``failed``: rows attributed (by poison-batch bisection) to a
      batchmate's poison rather than their own. Every admitted request
      ends in exactly one of completed/failed/cancelled/preempted/
      deadline_exceeded, so the derived ``inflight`` balance cannot
      drift.
    * resilience counters — ``retries`` (dispatch attempts beyond the
      first), ``breaker_transitions`` + ``breaker_states`` (per-route
      circuit-breaker activity), ``degraded_rows`` / ``degraded_by_route``
      (rows served off the primary route), and ``injected_faults`` /
      ``injected_by_kind`` (chaos accounting when a ``FaultInjector`` is
      installed) — fed by ``repro_torch.serve.resilience`` and
      ``repro_torch.serve.faults`` through the flush's ``DispatchCtx``.
    * ``batches / batched_rows / bucket_rows`` — flush accounting;
      ``batched_rows / bucket_rows`` is batch occupancy, the fraction of
      bucket slots carrying real requests (1.0 = every built bucket slot
      did useful work; low values mean the deadline, not the bucket, is
      flushing).
    * ``inflight_rows`` — gauge: rows handed to the inference executor and
      not yet retired. The scheduler's joint admission bound is
      ``pending + inflight_rows <= max_queue``; this gauge is the
      observable half of that invariant.
    * latency windows — the last ``window`` end-to-end request latencies
      (enqueue -> result set), bounded reservoirs for p50/p95/p99, kept
      both overall and per class.
    * per-class stats — every hook takes a ``cls`` name; ``snapshot``
      reports a ``classes`` sub-dict with per-class counts, latency
      percentiles, row share, and SLO attainment (fraction of completed
      requests that met the class's ``slo_s`` target, when one is set).
    """

    def __init__(self, now: float = 0.0, window: int = 4096):
        self.submitted = 0
        self.completed = 0
        self.rejected = 0
        self.failed = 0
        self.cancelled = 0
        self.preempted = 0
        self.collateral = 0          # sub-count of failed (see _ClassStats)
        self.deadline_exceeded = 0   # expired while PENDING
        self.batches = 0
        self.batched_rows = 0
        self.bucket_rows = 0
        self.inflight_rows = 0
        self.infer_s = 0.0
        # resilience-layer counters (repro_torch.serve.resilience / .faults):
        self.retries = 0             # dispatch attempts beyond the first
        self.breaker_transitions = 0
        self.breaker_states: dict = {}   # route -> current breaker state
        self.degraded_rows = 0       # rows served off the primary route
        self.degraded_by_route: dict = {}
        self.injected_faults = 0     # faults the injector actually fired
        self.injected_by_kind: dict = {}
        self._window = window
        self._lat = deque(maxlen=window)
        self._classes: dict = {}
        self._t0 = float(now)

    def _cls(self, name: str) -> _ClassStats:
        st = self._classes.get(name)
        if st is None:
            st = self._classes[name] = _ClassStats(self._window)
        return st

    # -- observation hooks (called by the scheduler) ----------------------
    def observe_submit(self, cls: str = "default"):
        self.submitted += 1
        self._cls(cls).submitted += 1

    def observe_reject(self, cls: str = "default"):
        self.rejected += 1
        self._cls(cls).rejected += 1

    def observe_fail(self, cls: str = "default", collateral: bool = False):
        """A failed request row. ``collateral=True`` additionally counts
        the row as collateral damage — it failed only because a batchmate
        was poison (attribution comes from the resilience layer's
        bisection; unattributed whole-batch failures count plain
        ``failed``). ``collateral <= failed`` always."""
        self.failed += 1
        st = self._cls(cls)
        st.failed += 1
        if collateral:
            self.collateral += 1
            st.collateral += 1

    def observe_cancelled(self, cls: str = "default"):
        self.cancelled += 1
        self._cls(cls).cancelled += 1

    def observe_preempt(self, cls: str = "default"):
        self.preempted += 1
        self._cls(cls).preempted += 1

    def observe_expired(self, cls: str = "default"):
        """A request whose SLO wall deadline passed while still PENDING —
        cancelled by the scheduler (``DeadlineExceededError``), counted
        distinctly from caller-driven ``cancelled``."""
        self.deadline_exceeded += 1
        self._cls(cls).deadline_exceeded += 1

    # -- resilience hooks (called by ResilientExecutor / FaultInjector) ----
    def observe_retry(self, n: int = 1):
        """Dispatch attempts beyond the first for some batch segment."""
        self.retries += int(n)

    def observe_breaker(self, route, old: str, new: str):
        """A circuit-breaker state transition on ``route``."""
        self.breaker_transitions += 1
        self.breaker_states[str(route)] = new

    def observe_degraded(self, rows: int, route):
        """Rows served off the primary route (degradation chain)."""
        self.degraded_rows += int(rows)
        key = str(route)
        self.degraded_by_route[key] = \
            self.degraded_by_route.get(key, 0) + int(rows)

    def observe_injected(self, kind: str):
        """A fault the injector actually fired (chaos accounting)."""
        self.injected_faults += 1
        self.injected_by_kind[kind] = self.injected_by_kind.get(kind, 0) + 1

    def observe_dispatch(self, rows: int):
        """Rows handed to the executor (in-flight gauge up)."""
        self.inflight_rows += int(rows)

    def observe_retire(self, rows: int):
        """Rows back from the executor — success or failure (gauge down)."""
        self.inflight_rows -= int(rows)

    def observe_batch(self, rows: int, bucket: int, infer_s: float,
                      by_class: Optional[dict] = None):
        self.batches += 1
        self.batched_rows += rows
        self.bucket_rows += bucket
        self.infer_s += float(infer_s)
        for cls, n in (by_class or {}).items():
            self._cls(cls).batched_rows += int(n)

    def observe_done(self, latency_s: float, cls: str = "default",
                     slo_s: Optional[float] = None):
        self.completed += 1
        self._lat.append(float(latency_s))
        st = self._cls(cls)
        st.completed += 1
        st._lat.append(float(latency_s))
        if slo_s is not None:
            if latency_s <= slo_s:
                st.slo_hits += 1
            else:
                st.slo_misses += 1

    def observe_done_many(self, latencies: list, cls: str = "default",
                          slo_s: Optional[float] = None):
        """Batch-granular success accounting: one flush's completed rows
        of a single class in one call — one class-stats lookup and two
        C-speed deque extends instead of a per-row ``observe_done``.
        The dispatch hot path resolves a whole flush per event-loop
        callback; its terminal accounting must not reintroduce a per-row
        Python call. Identical counters to per-row observation."""
        n = len(latencies)
        self.completed += n
        self._lat.extend(latencies)
        st = self._cls(cls)
        st.completed += n
        st._lat.extend(latencies)
        if slo_s is not None:
            hits = 0
            for lat in latencies:
                if lat <= slo_s:
                    hits += 1
            st.slo_hits += hits
            st.slo_misses += n - hits

    # -- reporting --------------------------------------------------------
    def latency_percentiles(self, ps=(50, 95, 99)) -> dict:
        return _percentiles(self._lat, ps)

    def slo_attainment(self) -> dict:
        """{class: attained fraction} for classes with an SLO target."""
        out = {}
        for name, st in self._classes.items():
            with_slo = st.slo_hits + st.slo_misses
            if with_slo:
                out[name] = st.slo_hits / with_slo
        return out

    def snapshot(self, now: float) -> dict:
        elapsed = max(float(now) - self._t0, 1e-12)
        snap = {
            "submitted": self.submitted,
            "completed": self.completed,
            "rejected": self.rejected,
            "failed": self.failed,
            "cancelled": self.cancelled,
            "preempted": self.preempted,
            "collateral": self.collateral,
            "deadline_exceeded": self.deadline_exceeded,
            "retries": self.retries,
            "breaker_transitions": self.breaker_transitions,
            "breaker_states": dict(self.breaker_states),
            "degraded_rows": self.degraded_rows,
            "degraded_by_route": dict(self.degraded_by_route),
            "injected_faults": self.injected_faults,
            "injected_by_kind": dict(self.injected_by_kind),
            # submitted counts admitted requests only (rejects raise before
            # enqueue), so rejected is NOT part of the inflight balance;
            # every other terminal state is (collateral is a sub-count of
            # failed, not a state of its own)
            "inflight": (self.submitted - self.completed - self.failed
                         - self.cancelled - self.preempted
                         - self.deadline_exceeded),
            "inflight_rows": self.inflight_rows,
            "batches": self.batches,
            "throughput_rps": self.completed / elapsed,
            "mean_batch": (self.batched_rows / self.batches
                           if self.batches else None),
            "batch_occupancy": (self.batched_rows / self.bucket_rows
                                if self.bucket_rows else None),
            "infer_s": self.infer_s,
            "elapsed_s": elapsed,
            "classes": {name: st.snapshot(self.batched_rows)
                        for name, st in sorted(self._classes.items())},
        }
        snap.update(self.latency_percentiles())
        return snap
