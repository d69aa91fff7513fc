"""Inference executors — the dispatch stage of the serving pipeline.

The scheduler (``repro_torch.serve.scheduler.MicroBatcher``) owns admission,
priority classes, and deadline-driven coalescing; *where the coalesced
batch actually runs* is this module's job. Splitting the two stages is the
serving-scale version of MicroFlow's compile-time/runtime split: the
scheduling stage stays a straight line on the event loop, and the device
call — the only part with real latency — is behind a swappable backend:

* :class:`InlineExecutor` — runs the flush synchronously on the event
  loop, exactly the pre-pipeline behavior. Deterministic under
  ``FakeClock`` (no threads, no real time), so every scheduling-semantics
  test pins behavior with zero real sleeps. This is the default.
* :class:`ThreadPoolExecutorBackend` — runs flushes on worker threads via
  ``loop.run_in_executor``. While a batch is on device the event loop
  keeps admitting and coalescing, so arrivals pipeline into the *next*
  batch instead of queueing behind the current one; with ``max_workers >
  1`` flushes from several models in a ``ServingRegistry`` interleave on
  one shared pool (one pool ≈ one accelerator's submission streams).
  Requires the model call to be thread-safe — ``CompiledModel`` locks its
  executable builds, and every replay of a model's graphs, precisely so
  concurrent ``predict_q_many`` calls are safe (see
  ``repro_torch.core.engine``).

Executors never own scheduling state: the batcher counts in-flight rows
(the joint ``pending + in_flight`` bound) and distributes rows back to
request futures; ``run`` is just "execute this callable with this batch,
somewhere".

Two pieces of dispatch-stage *contract* also live here:

* :class:`DispatchCtx` — per-flush metadata the scheduler hands down with
  the batch (model name, clock, metrics sink, degradation routes, the
  earliest SLO wall deadline among the rows). Plain backends ignore it;
  the resilience layer (``repro_torch.serve.resilience``) and the fault
  injector (``repro_torch.serve.faults``) are built on it.
* :class:`RowOutcomes` — the mixed-result return type: ``run`` may return
  a stacked row array (every row succeeded, the classic contract) OR a
  ``RowOutcomes`` whose rows individually carry a result or an exception,
  which is how poison-batch bisection reports "row 3 was poison, rows
  0-2 and 4-7 are fine" instead of failing all eight.
"""
from __future__ import annotations

import asyncio
import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Optional

#: Environment override for :class:`ThreadPoolExecutorBackend`'s default
#: worker count — bench records carry the effective value so overhead
#: numbers stay comparable across machines.
WORKERS_ENV = "REPRO_EXECUTOR_WORKERS"


def default_workers() -> int:
    """Worker count a ``ThreadPoolExecutorBackend()`` gets when built
    without an explicit ``max_workers``: ``$REPRO_EXECUTOR_WORKERS`` when
    set to a positive integer, else 2 (one flush on device + one staging).
    Malformed values fall back to the default rather than failing serving
    startup."""
    raw = os.environ.get(WORKERS_ENV, "")
    try:
        n = int(raw)
    except ValueError:
        return 2
    return n if n >= 1 else 2


@dataclasses.dataclass
class DispatchCtx:
    """Everything a resilience-aware backend may need about one flush.

    * ``name`` — the served model's name (half of the per-(model, route)
      circuit-breaker key).
    * ``rows`` — real request rows in the batch.
    * ``clock`` — the scheduler's :class:`~repro_torch.serve.scheduler.Clock`;
      every backend timeout, backoff, and injected latency spike goes
      through it, so resilience behavior is exact under ``FakeClock``.
    * ``metrics`` — the model's ``ModelMetrics`` (retry / breaker /
      degradation / injection counters land here); may be ``None``.
    * ``routes`` — the degradation chain, primary first (from
      ``CompiledModel.routes()``); empty when the infer callable is not
      route-selectable.
    * ``infer_routed`` — ``infer(xs, route=...)`` when the model supports
      route-selectable dispatch, else ``None``.
    * ``deadline`` — absolute clock time of the earliest per-class SLO
      wall deadline among the batch's rows (``None`` when no row carries
      one); the resilience layer budgets per-dispatch timeouts and retry
      backoff from it.
    * ``max_batch`` — the batcher's bound; bisection splits on the bucket
      boundaries this implies.
    * ``route`` — the route this specific dispatch attempt runs (set by
      the resilience layer per attempt; ``None`` = primary). The fault
      injector reads it to target a specific route.
    * ``validate`` — optional output-validity guard ``validate(ys, rows)``
      raising on NaN/inf, wrong dtype, or out-of-static-range outputs
      (derived from the plan auditor's static per-route bounds).
    * ``trace`` — optional :class:`repro_torch.obs.trace.TraceHandle` for this
      flush. Trace-aware layers record attempt/retry/validate spans
      against it; off-loop backends re-enter its thread-local scope on
      the worker thread (``loop.run_in_executor`` does not carry it
      over) so the engine's pad/device/compile spans attach to the right
      flush. ``None`` = tracing off; everything ignores it for free.
    """

    name: str = "model"
    rows: int = 1
    clock: Any = None
    metrics: Any = None
    routes: tuple = ()
    infer_routed: Optional[Callable] = None
    deadline: Optional[float] = None
    max_batch: int = 1
    route: Optional[str] = None
    validate: Optional[Callable] = None
    trace: Any = None


class RowOutcomes:
    """Per-row results of one flush: each row holds a result OR an error.

    ``ys[i]`` is row ``i``'s output (``None`` while unset/failed);
    ``errors[i]`` is ``(exception, collateral)`` for failed rows —
    ``collateral=True`` means the row failed only because it shared a
    batch with a poison row (the group could not be split further inside
    the deadline/retry budget), ``False`` means the row failed alone and
    is itself the poison.
    """

    __slots__ = ("ys", "errors")

    def __init__(self, n: int):
        self.ys: list = [None] * n
        self.errors: dict = {}

    @property
    def ok(self) -> bool:
        return not self.errors

    def set_rows(self, idxs, ys) -> None:
        for i, y in zip(idxs, ys):
            self.ys[i] = y

    def fail_rows(self, idxs, err: Exception, collateral: bool) -> None:
        for i in idxs:
            self.errors[i] = (err, collateral)


class InferenceExecutor:
    """Backend interface: ``run`` executes one flush's ``infer(xs)``.

    ``inline`` advertises whether ``run`` completes synchronously on the
    calling (event-loop) thread — the scheduler uses it to keep the
    deterministic fast path free of task hops, and tests use it to pin
    FakeClock semantics. ``close`` releases backend resources and is
    idempotent; a closed backend refuses further dispatches.

    ``ctx`` (a :class:`DispatchCtx`) carries per-flush metadata for
    resilience-aware backends; plain backends ignore it. ``run`` returns
    either the stacked ``(rows, ...)`` output array or a
    :class:`RowOutcomes` with per-row results/errors.

    ``detached`` advertises the batch-granular dispatch capability
    (:meth:`submit_flush`): the backend delivers a finished flush to the
    scheduler as ONE event-loop callback instead of an awaited ``run``.
    Wrapper backends (resilience, fault injection) keep the default
    ``False`` — their per-attempt semantics live inside ``run`` — so the
    scheduler routes them through the legacy task path unchanged.
    """

    inline = True
    detached = False

    @property
    def closed(self) -> bool:
        """Whether :meth:`close` has run. Backends without resources
        (``InlineExecutor``) never close — their ``close`` is a no-op and
        this stays ``False``, so audits can tell "nothing to release"
        apart from "released"."""
        return False

    async def run(self, infer: Callable, xs, ctx: Optional[DispatchCtx] = None):
        raise NotImplementedError

    def submit_flush(self, infer: Callable, xs,
                     ctx: Optional[DispatchCtx],
                     done: Callable) -> None:
        """Batch-granular dispatch (only when ``detached`` is ``True``):
        start ``infer(xs)`` and later invoke ``done(result, error)``
        exactly once as a single event-loop callback. The scheduler
        resolves every row future of the flush inside that one callback —
        one loop wakeup per *flush* instead of an executor-future wakeup
        plus a task hop per flush and a callback per request. Must be
        called from the event-loop thread; raises if the backend does not
        support detached dispatch or is closed."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support detached dispatch")

    def close(self) -> None:
        pass


class InlineExecutor(InferenceExecutor):
    """Run the flush on the event loop (the pre-pipeline default).

    The call blocks the loop for its duration — for TinyML-scale graphs
    the call *is* the work, and on-loop execution is what makes FakeClock
    scheduling tests exact. The scheduler special-cases ``inline`` so this
    path never even creates a task; ``run`` exists so code written against
    the interface still works.
    """

    inline = True

    async def run(self, infer: Callable, xs,
                  ctx: Optional[DispatchCtx] = None):
        if ctx is not None and ctx.trace is not None:
            # resilient stacks bottom out here on the loop thread; enter
            # the flush's trace scope so engine spans attach to it
            with ctx.trace.scope():
                return infer(xs)
        return infer(xs)


class ThreadPoolExecutorBackend(InferenceExecutor):
    """Run flushes on a thread pool so inference overlaps scheduling.

    The pool is created lazily on first dispatch (constructing a backend
    is free) and bounded: ``max_workers`` is the number of flushes that
    can be *on device* at once — everything else about memory is already
    bounded by each batcher's joint ``pending + in_flight`` cap, so the
    pool's internal queue cannot grow past the registered batchers'
    ``max_queue`` sum. One backend can be shared by every model in a
    ``ServingRegistry``; with ``max_workers=1`` flushes from all models
    serialize in dispatch order (one submission stream), while larger
    pools interleave them.
    """

    inline = False
    detached = True

    def __init__(self, max_workers: Optional[int] = None,
                 thread_name_prefix: str = "repro-serve"):
        if max_workers is None:
            max_workers = default_workers()
        assert max_workers >= 1
        self._max_workers = max_workers
        self._prefix = thread_name_prefix
        self._pool: Optional[ThreadPoolExecutor] = None
        self._closed = False

    @property
    def max_workers(self) -> int:
        return self._max_workers

    @property
    def closed(self) -> bool:
        return self._closed

    def _ensure_pool(self) -> ThreadPoolExecutor:
        if self._closed:
            raise RuntimeError("executor is closed")
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self._max_workers,
                thread_name_prefix=self._prefix)
        return self._pool

    async def run(self, infer: Callable, xs,
                  ctx: Optional[DispatchCtx] = None):
        pool = self._ensure_pool()
        loop = asyncio.get_running_loop()
        if ctx is not None and ctx.trace is not None:
            # run_in_executor does not carry the trace scope to the worker
            # thread; re-enter it there so engine spans reach this flush
            infer = ctx.trace.bind(infer)
        return await loop.run_in_executor(pool, infer, xs)

    def submit_flush(self, infer: Callable, xs,
                     ctx: Optional[DispatchCtx],
                     done: Callable) -> None:
        """Batch-granular dispatch: the worker thread runs ``infer(xs)``
        and hands the finished flush back as ONE
        ``loop.call_soon_threadsafe(done, result, error)``. Compared to
        ``run`` this removes, per flush: the ``run_in_executor`` future,
        its done-callback wakeup, and the awaiting flight task — the
        scheduler's ``done`` retires the batch and resolves all row
        futures inside the single callback. Exceptions from ``infer``
        travel in the ``error`` slot; ``done`` is invoked exactly once."""
        pool = self._ensure_pool()
        loop = asyncio.get_running_loop()
        if ctx is not None and ctx.trace is not None:
            infer = ctx.trace.bind(infer)

        def work():
            res, err = None, None
            try:
                res = infer(xs)
            except Exception as e:
                err = e
            loop.call_soon_threadsafe(done, res, err)

        pool.submit(work)

    def recycle(self) -> None:
        """Tear down the current pool abruptly (no wait) and let the next
        dispatch lazily build a fresh one — the recovery half of a
        worker-death fault. Flushes already submitted to the dying pool
        still run to completion (their callers see results or the
        injected error, never a silent drop); flushes dispatched after
        ``recycle`` land on new workers. The fault injector
        (``repro_torch.serve.faults``) calls this to emulate a worker crashing
        mid-serve without killing the process."""
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    def close(self) -> None:
        """Idempotent; waits for in-flight flushes so no batch is dropped
        mid-device-call (batcher ``close`` already awaited its flights —
        this is the backstop for direct executor users)."""
        self._closed = True
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
