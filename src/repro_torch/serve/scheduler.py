"""Pipelined micro-batching scheduler for the compiled TinyML engine — the
port of ``repro.serve.scheduler`` (its logic is unchanged; it runs over
``repro_torch.core.engine``).

MicroFlow wins by moving everything expensive to compile time; the engine's
batched path extends that to serving — one executable per power-of-two
batch bucket (a CUDA graph on the card). Between "a stream of independent single-sample requests" and
"large batches that make those executables pay off" sits this module, now a
two-stage pipeline:

* **Scheduling stage** (this module): admission, priority classes, and
  deadline-driven coalescing. Each request is admitted under a
  :class:`ClassPolicy` (priority + per-class ``max_delay_s`` + optional
  ``slo_s`` latency target) and carries an absolute deadline; the pending
  set is a priority queue ordered **earliest-deadline-first**, so a flush
  drains the most urgent requests regardless of arrival order, and the
  flush timer always tracks the earliest pending deadline (a late-arriving
  interactive request pulls the flush forward past older batch-class
  requests' laxer deadlines).
* **Dispatch stage** (:mod:`repro_torch.serve.executor`): *where* the coalesced
  batch runs. The default :class:`~repro_torch.serve.executor.InlineExecutor`
  executes on the event loop — deterministic under :class:`FakeClock`,
  bit-for-bit the original behavior. With a
  :class:`~repro_torch.serve.executor.ThreadPoolExecutorBackend` the flush runs
  on a worker thread while the loop keeps admitting and coalescing, so
  arrivals pipeline into the *next* batch while the current one is on
  device; a shared backend interleaves flushes from every model in a
  ``ServingRegistry``.

* **Backpressure, jointly bounded**: admission enforces
  ``pending + in_flight_rows <= max_queue`` — the static-memory guarantee
  (paper Sec. 4.1) at serving scale now covers rows queued *and* rows on
  device, so off-loop dispatch cannot grow resident state past the same
  bound the inline path had. At capacity the scheduler **sheds by
  priority**: if some pending request has strictly lower priority than the
  newcomer, the least urgent such victim (lowest priority, latest
  deadline) is evicted — its future gets :class:`PreemptedError` — and the
  newcomer is admitted; otherwise the newcomer is refused with
  :class:`QueueFullError` (same-priority traffic keeps the original
  shed-at-tail behavior).
* ``Clock`` / ``FakeClock`` — every time read and every timed wait goes
  through an injected clock, so tests drive the batcher deterministically
  (virtual time, zero real sleeps) while production uses the monotonic
  wall clock.

The batcher serves single-input / single-output graphs (all three paper
models); requests are single samples of the graph's input shape.
"""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import heapq
import time
from collections import deque
from itertools import chain
from typing import Callable, Optional

import numpy as np

from repro_torch.core.engine import bucket_floor, dispatched_bucket_rows
from repro_torch.obs.trace import NULL_TRACER, Tracer
from .executor import DispatchCtx, InferenceExecutor, InlineExecutor, \
    RowOutcomes
from .metrics import ModelMetrics

DEFAULT_CLASS = "default"


class QueueFullError(RuntimeError):
    """Admission refused: the bounded request queue is at capacity.

    Raised synchronously from ``submit`` — the caller (or the load
    balancer above it) decides whether to retry, degrade, or drop.
    """

    def __init__(self, name: str, depth: int):
        super().__init__(f"{name}: queue full ({depth} pending), load shed")
        self.model = name
        self.depth = depth


class PreemptedError(QueueFullError):
    """A pending request was evicted by shed-by-priority admission.

    Set on the *victim's* future when a higher-priority newcomer claims
    its queue slot. Subclasses :class:`QueueFullError` so callers already
    handling shed load handle preemption the same way — including the
    base class's ``model``/``depth`` attributes.
    """

    def __init__(self, name: str, cls: str, depth: int):
        RuntimeError.__init__(
            self, f"{name}: request (class {cls!r}) preempted by "
                  f"higher-priority admission ({depth} pending)")
        self.model = name
        self.cls = cls
        self.depth = depth


class DeadlineExceededError(QueueFullError):
    """A request's end-to-end wall deadline passed while still PENDING.

    The scheduler expires the request (its future gets this error) instead
    of dispatching work whose answer is already too late — the per-class
    SLO made load-shedding-by-time. Subclasses :class:`QueueFullError`
    (the shed/cancel taxonomy root: admitted, never produced a result, not
    an inference failure) so callers handling shed load handle expiry the
    same way; counted distinctly (``deadline_exceeded``, not
    ``cancelled``) in :class:`~repro_torch.serve.metrics.ModelMetrics`.
    """

    def __init__(self, name: str, cls: str, waited_s: float):
        RuntimeError.__init__(
            self, f"{name}: request (class {cls!r}) exceeded its wall "
                  f"deadline after {waited_s * 1e3:.1f} ms pending")
        self.model = name
        self.cls = cls
        self.depth = 0
        self.waited_s = waited_s


class FlushError(RuntimeError):
    """One flush's failure, wrapped with its serving context.

    Every request whose flush failed gets a ``FlushError`` carrying the
    model name, the dispatched bucket size, the number of real rows that
    shared the batch, and the raw cause (``__cause__`` / ``.cause``) — so
    a caller can distinguish "my single-row dispatch failed" (``rows ==
    1``) from "I shared a batch that failed" (``rows > 1``).
    ``collateral`` refines that when the resilience layer's bisection
    attributed the failure: ``False`` = this row failed alone (it *is*
    the poison), ``True`` = it failed only because it could not be
    separated from a poison batchmate, ``None`` = unattributed (no
    bisection ran; any row may be the poison).
    """

    def __init__(self, model: str, bucket: int, rows: int, cause: Exception,
                 collateral: Optional[bool] = None):
        blame = {False: "poison row", True: "collateral",
                 None: "unattributed"}[collateral]
        super().__init__(
            f"{model}: flush of {rows} row(s) (bucket {bucket}) failed "
            f"[{blame}]: {cause!r}")
        self.model = model
        self.bucket = bucket
        self.rows = rows
        self.cause = cause
        self.collateral = collateral
        self.__cause__ = cause


@dataclasses.dataclass(frozen=True)
class ClassPolicy:
    """Admission/scheduling policy for one priority class.

    * ``priority`` — higher sheds later: under overload the lowest
      priority pending request is evicted first.
    * ``max_delay_s`` — this class's coalescing deadline (how long a
      request may wait for batchmates); ``None`` inherits the batcher's
      default.
    * ``slo_s`` — optional end-to-end latency target; per-class SLO
      attainment (fraction of completed requests meeting it) is reported
      in ``ModelMetrics.snapshot()["classes"]``.
    """

    priority: int = 0
    max_delay_s: Optional[float] = None
    slo_s: Optional[float] = None


class Clock:
    """Monotonic wall clock + real asyncio sleep (production default)."""

    def now(self) -> float:
        return time.monotonic()

    async def sleep(self, dt: float) -> None:
        await asyncio.sleep(max(dt, 0.0))


class FakeClock(Clock):
    """Deterministic virtual clock for tests: ``now()`` returns virtual
    time, ``sleep`` parks on a future, and ``advance(dt)`` releases due
    sleepers in deadline order, yielding to the event loop between each so
    woken coroutines run to their next await before time moves further.
    No real time passes."""

    def __init__(self):
        self._t = 0.0
        self._seq = 0
        self._sleepers = []  # heap of (deadline, seq, future)

    def now(self) -> float:
        return self._t

    async def sleep(self, dt: float) -> None:
        if dt <= 0:
            await asyncio.sleep(0)
            return
        fut = asyncio.get_running_loop().create_future()
        heapq.heappush(self._sleepers, (self._t + dt, self._seq, fut))
        self._seq += 1
        await fut

    async def advance(self, dt: float) -> None:
        target = self._t + dt
        # 1 ns tolerance: accumulated float steps (0.009 + 0.001) must still
        # release a sleeper parked at exactly 0.010.
        while self._sleepers and self._sleepers[0][0] <= target + 1e-9:
            deadline, _, fut = heapq.heappop(self._sleepers)
            self._t = max(self._t, deadline)
            if not fut.done():  # cancelled sleeps are skipped
                fut.set_result(None)
            await self.drain()
        self._t = max(self._t, target)  # never move backward past a sleeper
        await self.drain()

    @staticmethod
    async def drain(rounds: int = 10) -> None:
        """Yield to the loop until ready callbacks/coroutines settle."""
        for _ in range(rounds):
            await asyncio.sleep(0)


class _Request:
    """One pending request: EDF heap entry (deadline, then arrival seq).

    ``dead`` marks lazy heap deletion — preempted entries stay in the heap
    until a pop or peek skips past them, so eviction is O(n) scan + O(1)
    mark, never a heap rebuild. ``wall`` is the absolute end-to-end wall
    deadline (``None`` = never expires): a request still PENDING past it
    is expired with :class:`DeadlineExceededError` instead of dispatched.

    Records are slot-pooled by the batcher (:meth:`MicroBatcher._recycle`):
    a retired record is :meth:`reset` for the next admission instead of
    allocated fresh — under steady traffic the serving hot path allocates
    no request records at all.
    """

    __slots__ = ("x", "future", "t", "cls", "priority", "deadline", "seq",
                 "dead", "wall", "rid")

    def __init__(self, x, future, t, cls, priority, deadline, seq,
                 wall=None, rid=None):
        self.reset(x, future, t, cls, priority, deadline, seq,
                   wall=wall, rid=rid)

    def reset(self, x, future, t, cls, priority, deadline, seq,
              wall=None, rid=None) -> "_Request":
        self.x = x
        self.future = future
        self.t = t
        self.cls = cls
        self.priority = priority
        self.deadline = deadline
        self.seq = seq
        self.dead = False
        self.wall = wall
        self.rid = rid  # trace id (None when tracing is off)
        return self

    def __lt__(self, other: "_Request") -> bool:
        return (self.deadline, self.seq) < (other.deadline, other.seq)


class MicroBatcher:
    """Coalesce single-sample requests into bucket-sized device calls.

    ``infer`` is a blocking callable mapping a stacked ``(n, ...)`` input
    array to ``(n, ...)`` output rows; :meth:`for_model` builds one from a
    ``CompiledModel`` via ``predict_q_many`` and warms its batch buckets.
    ``executor`` picks the dispatch stage: the default
    :class:`~repro_torch.serve.executor.InlineExecutor` runs flushes on the
    event loop (deterministic under the fake clock), while an off-loop
    backend overlaps inference with coalescing — ``infer`` must then be
    thread-safe (``CompiledModel`` is: its bucket executables fill under
    a lock, and a replay holds its bucket's lock).
    The batcher never closes an executor it was handed (shared backends
    outlive individual models); the owner — usually the
    ``ServingRegistry`` — does.

    ``classes`` maps class names to :class:`ClassPolicy`; a ``"default"``
    class (priority 0, the batcher-level ``max_delay_s``) is always
    present unless explicitly overridden.
    """

    def __init__(self, infer: Callable, *, name: str = "model",
                 max_batch: int = 32, max_delay_s: float = 0.002,
                 max_queue: int = 256, clock: Optional[Clock] = None,
                 metrics: Optional[ModelMetrics] = None,
                 classes: Optional[dict] = None,
                 executor: Optional[InferenceExecutor] = None,
                 infer_routed: Optional[Callable] = None,
                 routes: tuple = (), validate: Optional[Callable] = None,
                 tracer: Optional[Tracer] = None,
                 infer_staged: Optional[Callable] = None,
                 staged_max_rows: int = 0, fast_path: bool = True):
        assert max_batch >= 1 and max_queue >= 1
        self._infer = infer
        # dispatch fast paths (``fast_path=False`` is the legacy lane the
        # dispatch microbench A/Bs against, and a debugging escape hatch):
        # * slot-pooled request records (``_recycle``)
        # * FIFO pending queue while arrival order == EDF order
        # * prestaged pooled-buffer flush assembly (``infer_staged``, from
        #   ``CompiledModel.staged_infer``; flushes of at most
        #   ``staged_max_rows`` rows qualify — one warmed bucket)
        # * detached batch-granular future resolution (``submit_flush``)
        self._fast = fast_path
        self._infer_staged = infer_staged
        self._staged_max = staged_max_rows
        # resilience-aware dispatch metadata, handed to the executor via
        # DispatchCtx on every off-loop flush: a route-selectable infer
        # (infer_routed(xs, route=...)), the model's degradation chain
        # (primary first), and an output-validity guard. All optional —
        # plain executors ignore them.
        self._infer_routed = infer_routed
        self._routes = tuple(routes)
        self._validate = validate
        self.name = name
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.max_queue = max_queue
        self.clock = clock or Clock()
        self.executor = executor if executor is not None else InlineExecutor()
        self.metrics = metrics if metrics is not None else \
            ModelMetrics(now=self.clock.now())
        # lifecycle tracing (repro_torch.obs): NULL_TRACER costs one enabled
        # check per hook, so untraced serving pays nothing measurable
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.classes = dict(classes or {})
        self.classes.setdefault(DEFAULT_CLASS, ClassPolicy())
        # Pending requests live in EXACTLY ONE container at a time:
        # ``_fifo`` while arrival order coincides with EDF order (deadlines
        # nondecreasing — the common one-class steady state), spilled into
        # ``_heap`` the moment a newcomer's deadline undercuts the tail
        # (e.g. an interactive request pulling the flush forward past
        # batch-class backlog). ``_heap`` non-empty ⇒ ``_fifo`` empty.
        self._heap = []          # EDF priority queue of _Request
        self._fifo: deque = deque()  # FIFO fast path (skips the heap)
        self._live = 0           # pending entries not marked dead
        self._in_flight_rows = 0  # dispatched to executor, not yet retired
        self._seq = 0
        self._flights: set = set()  # off-loop flush tasks in progress
        self._detached = 0          # detached flushes awaiting their done()
        self._quiesced = asyncio.Event()  # set whenever _detached hits 0
        self._arrival = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._loop = None  # cached running loop (set by start())
        self._create_future = None  # bound loop.create_future (start())
        self._now = self.clock.now  # bound clock read for the hot path
        # one-way latch: set the first time a request with a wall (SLO)
        # deadline is admitted, never cleared — while False, the per-flush
        # expiry scan over every pending request is provably a no-op and
        # the fast path skips it entirely (wall-free workloads pay zero)
        self._has_walls = False
        self._closed = False
        # Slot pool of retired _Request records (bounded by max_queue —
        # the most that can ever be outstanding at once); the counters are
        # the observable no-growth proof the pool tests pin.
        self._pool: list = []
        self.pool_created = 0  # _Request allocations (ever)
        self.pool_reused = 0   # admissions served from the pool

    @classmethod
    def for_model(cls, model, *, warmup: bool = True, cache=None,
                  **kw) -> "MicroBatcher":
        """Batcher over ``CompiledModel.predict_q_many``. With ``warmup``
        every bucket a flush can dispatch is built now (one CUDA-graph
        capture per bucket on the card), so no request ever pays a build on
        the hot path. ``predict_q_many`` chunks on bucket boundaries, so the
        largest bucket any flush reaches is ``bucket_floor(max_batch)`` —
        warming ``bucket_for(max_batch)`` would build a top bucket no flush
        ever uses when ``max_batch`` is not a power of two.

        ``cache`` (the persistent executable cache) is not ported yet and
        raises ``NotImplementedError``."""
        if cache is not None:
            raise NotImplementedError(
                "the persistent executable cache is not ported yet: "
                "ROADMAP Queue 1 item 9")
        max_batch = kw.get("max_batch", 32)
        if warmup:
            # only the bucketed batch executables: the batcher always stacks
            # requests, so the unbatched path is never on its hot path
            model.warmup_batched(bucket_floor(max_batch))
        # route-selectable dispatch + output-validity guard, when the model
        # provides them (duck-typed stand-ins without exec_plan still work)
        routed, routes, validate = None, (), None
        if hasattr(model, "predict_q_routed"):
            def routed(xs, route=None):
                return model.predict_q_routed(xs, route=route,
                                              max_batch=max_batch)
            routes = model.routes()
        staged, staged_max = None, 0
        if getattr(model, "exec_plan", None) is not None:
            from .resilience import make_output_guard
            validate = make_output_guard(model.exec_plan)
            if hasattr(model, "staged_infer") and \
                    len(model.graph.inputs) == 1:
                # zero-allocation flush assembly: rows go straight into
                # the engine's pooled physical-layout staging buffers; a
                # flush of <= bucket_floor(max_batch) rows fits one warmed
                # bucket, which the batcher guarantees by construction
                staged = model.staged_infer
                staged_max = bucket_floor(max_batch)
        kw.setdefault("infer_staged", staged)
        kw.setdefault("staged_max_rows", staged_max)
        return cls(lambda xs: model.predict_q_many(xs, max_batch=max_batch),
                   infer_routed=routed, routes=routes, validate=validate,
                   **kw)

    # -- client side ------------------------------------------------------
    def __len__(self) -> int:
        return self._live

    @property
    def in_flight_rows(self) -> int:
        """Rows dispatched to the executor and not yet retired — the other
        half of the ``pending + in_flight <= max_queue`` bound."""
        return self._in_flight_rows

    @property
    def closed(self) -> bool:
        """Whether :meth:`close` has run (close is terminal and
        idempotent); a closed batcher refuses ``submit``/``start``."""
        return self._closed

    def _policy(self, cls: str) -> ClassPolicy:
        try:
            return self.classes[cls]
        except KeyError:
            raise KeyError(f"{self.name}: unknown priority class {cls!r}; "
                           f"configured: {sorted(self.classes)}") from None

    def _shed(self, cls: str, priority: int) -> None:
        """Make room for a priority-``priority`` newcomer or refuse it.

        Victim = the live pending request with the lowest priority, latest
        deadline (least urgent of the least important). Only a *strictly*
        lower-priority victim is evicted — same-priority traffic keeps the
        original shed-at-tail semantics (newcomer refused). In-flight rows
        are never preempted: once a batch is on device its memory is
        committed."""
        victim = None
        for r in chain(self._heap, self._fifo):
            if r.dead:
                continue
            if victim is None or (r.priority, -r.deadline, -r.seq) < \
                    (victim.priority, -victim.deadline, -victim.seq):
                victim = r
        if victim is None or victim.priority >= priority:
            self.metrics.observe_reject(cls)
            self.tracer.rejected(self.name, cls, self.clock.now())
            raise QueueFullError(self.name, self._live)
        victim.dead = True
        self._live -= 1
        if not victim.future.done():
            victim.future.set_exception(
                PreemptedError(self.name, victim.cls, self._live))
        self.metrics.observe_preempt(victim.cls)
        self.tracer.terminal(victim.rid, self.clock.now(), "shed",
                             reason="preempted")
        # lazy deletion stays bounded: compact once dead entries outnumber
        # the queue cap, so the pending containers never hold more than
        # 2*max_queue entries no matter how preemption-heavy the overload
        if len(self._heap) + len(self._fifo) - self._live > self.max_queue:
            self._compact()

    def _compact(self) -> None:
        """Drop (and recycle) dead entries from both pending containers.
        Rebuilding preserves each container's invariant: heap order via
        ``heapify``, FIFO arrival order by filtering in place."""
        for r in self._heap:
            if r.dead:
                self._recycle(r)
        self._heap = [r for r in self._heap if not r.dead]
        heapq.heapify(self._heap)
        if any(r.dead for r in self._fifo):
            live = deque(r for r in self._fifo if not r.dead)
            for r in self._fifo:
                if r.dead:
                    self._recycle(r)
            self._fifo = live

    def _recycle(self, r: "_Request") -> None:
        """Return a retired request record to the slot pool. Callers must
        guarantee the record is out of BOTH pending containers — recycling
        a record still reachable from the heap/FIFO would let one slot
        serve two requests. Payload refs are dropped so the pool never
        pins request arrays or futures."""
        if self._fast and len(self._pool) < self.max_queue:
            r.x = None
            r.future = None
            r.rid = None
            self._pool.append(r)

    def submit(self, x, cls: str = DEFAULT_CLASS,
               deadline_s: Optional[float] = None,
               wall_deadline_s: Optional[float] = None) -> asyncio.Future:
        """Enqueue one request under priority class ``cls``; returns a
        future resolving to its output row. ``deadline_s`` overrides the
        class's coalescing delay for this request (seconds from now).
        ``wall_deadline_s`` is the end-to-end wall deadline (seconds from
        now; defaults to the class's ``slo_s`` when one is set): a request
        still PENDING past it is expired with
        :class:`DeadlineExceededError` instead of dispatched, and the
        dispatch stage budgets its per-attempt timeouts from it.

        At capacity (``pending + in_flight_rows >= max_queue``) admission
        sheds by priority: a strictly lower-priority pending request is
        evicted (its future gets :class:`PreemptedError`) in the
        newcomer's favor, otherwise the newcomer is refused with
        :class:`QueueFullError`. Raises ``RuntimeError`` when closed and
        ``KeyError`` for an unknown class."""
        if self._closed:
            raise RuntimeError(f"{self.name}: batcher is closed")
        policy = self._policy(cls)
        if self._live + self._in_flight_rows >= self.max_queue:
            self._shed(cls, policy.priority)  # raises unless a slot opened
        if self._fast:
            now = self._now()
            cf = self._create_future
            fut = cf() if cf is not None \
                else asyncio.get_running_loop().create_future()
            rid = self.tracer.admit(self.name, cls, now) \
                if self.tracer.enabled else None
        else:
            # legacy lane: the pre-teardown admission path verbatim —
            # per-request loop lookup and an unconditional tracer call —
            # so benchmarks/bench_dispatch.py's A/B reference reproduces
            # the pre-teardown per-request cost, not a hybrid
            now = self.clock.now()
            fut = asyncio.get_running_loop().create_future()
            rid = self.tracer.admit(self.name, cls, now)
        delay = deadline_s if deadline_s is not None else \
            (policy.max_delay_s if policy.max_delay_s is not None
             else self.max_delay_s)
        wall_s = wall_deadline_s if wall_deadline_s is not None \
            else policy.slo_s
        if wall_s is None:
            wall = None
        else:
            wall = now + wall_s
            self._has_walls = True
        if self._pool:  # slot-pooled record: reset, don't allocate
            req = self._pool.pop().reset(
                x, fut, now, cls, policy.priority, now + delay, self._seq,
                wall=wall, rid=rid)
            self.pool_reused += 1
        else:
            req = _Request(x, fut, now, cls, policy.priority, now + delay,
                           self._seq, wall=wall, rid=rid)
            self.pool_created += 1
        self._seq += 1
        if self._heap or not self._fast:
            heapq.heappush(self._heap, req)
        elif self._fifo and req.deadline < self._fifo[-1].deadline:
            # EDF order depends only on (deadline, seq), so FIFO == EDF
            # exactly while deadlines arrive nondecreasing. This newcomer
            # undercuts the tail (a shorter-deadline class pulling the
            # flush forward): spill the backlog into the heap — FIFO mode
            # resumes once the heap drains empty.
            self._spill(req)
        else:
            self._fifo.append(req)
        self._live += 1
        self.metrics.observe_submit(cls)
        self._arrival.set()
        return fut

    def _spill(self, req: "_Request") -> None:
        heap = [r for r in self._fifo if not r.dead]
        for r in self._fifo:
            if r.dead:
                self._recycle(r)
        self._fifo.clear()
        heap.append(req)
        heapq.heapify(heap)
        self._heap = heap

    async def infer(self, x, cls: str = DEFAULT_CLASS,
                    deadline_s: Optional[float] = None,
                    wall_deadline_s: Optional[float] = None):
        return await self.submit(x, cls=cls, deadline_s=deadline_s,
                                 wall_deadline_s=wall_deadline_s)

    # -- scheduler side ---------------------------------------------------
    def start(self) -> "MicroBatcher":
        if self._closed:  # close() is terminal — no half-alive restarts
            raise RuntimeError(f"{self.name}: batcher is closed")
        if self._task is None:
            self._loop = asyncio.get_running_loop()
            self._create_future = self._loop.create_future
            self._task = self._loop.create_task(self._run())
        return self

    async def close(self, drain: bool = True) -> None:
        """Stop the scheduler. With ``drain`` remaining requests are
        flushed (through the executor) and in-flight flushes awaited;
        otherwise pending futures are cancelled (counted ``cancelled``,
        not ``failed``) — in-flight flushes still complete either way.
        The executor itself is NOT closed: the batcher may share it.

        Idempotent, including with rows still in flight: a second close
        (even one racing the first) only awaits the remaining flights —
        it cannot re-cancel a request or double-count any metric, so
        every admitted request still ends in exactly one terminal state."""
        self._closed = True
        task, self._task = self._task, None  # claimed by ONE closer
        if task is not None:
            task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await task
        if drain:
            while self._live:
                self._flush()
        else:
            for r in chain(self._heap, self._fifo):
                if not r.dead:
                    if not r.future.done():
                        r.future.cancel()
                    self.metrics.observe_cancelled(r.cls)
                    self.tracer.terminal(r.rid, self.clock.now(), "shed",
                                         reason="cancelled")
                self._recycle(r)
            self._heap.clear()
            self._fifo.clear()
            self._live = 0
        if self._flights:
            await asyncio.gather(*list(self._flights))
        # detached flushes have no task to gather — await their done()
        # callbacks (delivered by call_soon_threadsafe while we yield)
        while self._detached:
            self._quiesced.clear()
            await self._quiesced.wait()

    async def __aenter__(self):
        return self.start()

    async def __aexit__(self, *exc):
        await self.close()

    def _earliest_deadline(self) -> Optional[float]:
        """Peek the earliest pending deadline, discarding dead (preempted)
        entries. The FIFO head is its minimum by the nondecreasing-deadline
        invariant; the heap top is its minimum by heap order."""
        while self._heap and self._heap[0].dead:
            self._recycle(heapq.heappop(self._heap))
        if self._heap:
            return self._heap[0].deadline
        while self._fifo and self._fifo[0].dead:
            self._recycle(self._fifo.popleft())
        return self._fifo[0].deadline if self._fifo else None

    def _expire(self, now: float) -> Optional[float]:
        """Expire live PENDING requests whose wall deadline has passed
        (their futures get :class:`DeadlineExceededError`, counted
        ``deadline_exceeded``); returns the earliest wall deadline still
        outstanding (``None`` if no live request carries one). Rows
        already dispatched are never expired — their memory is committed
        and their result may still arrive in time."""
        if self._fast and not self._has_walls:
            # no admitted request has ever carried a wall deadline: the
            # scan below is provably a no-op — skip the O(pending) walk
            # (the legacy lane keeps the pre-teardown scan for the A/B)
            return None
        earliest = None
        for r in chain(self._heap, self._fifo):
            if r.dead or r.wall is None:
                continue
            if r.wall <= now + 1e-9:
                r.dead = True
                self._live -= 1
                if not r.future.done():
                    r.future.set_exception(DeadlineExceededError(
                        self.name, r.cls, now - r.t))
                self.metrics.observe_expired(r.cls)
                self.tracer.terminal(r.rid, now, "expire",
                                     waited_s=now - r.t)
            elif earliest is None or r.wall < earliest:
                earliest = r.wall
        return earliest

    async def _run(self) -> None:
        while True:
            if not self._live:
                self._arrival.clear()
                await self._arrival.wait()
            # The earliest pending deadline anchors the flush timer and is
            # re-read after every arrival: a bucket-full queue flushes
            # immediately, and a late-arriving shorter-deadline class pulls
            # the flush forward past older laxer deadlines. Wall (SLO)
            # deadlines participate too: the timer never sleeps past the
            # earliest wall deadline, so an expiring request is cancelled
            # on time even when its coalescing deadline is laxer.
            while 0 < self._live < self.max_batch:
                now = self.clock.now()
                wall = self._expire(now)
                if not self._live:
                    break
                deadline = self._earliest_deadline()
                if deadline is None:
                    break
                if wall is not None:
                    deadline = min(deadline, wall)
                remaining = deadline - now
                if remaining <= 0:
                    break
                self._arrival.clear()
                await self._arrival_or_sleep(remaining)
            self._expire(self.clock.now())
            if self._live:
                self._flush()

    async def _arrival_or_sleep(self, dt: float) -> None:
        """Wake on a new arrival or after ``dt`` (clock-driven), whichever
        comes first; the loser is cancelled."""
        ev = asyncio.ensure_future(self._arrival.wait())
        sl = asyncio.ensure_future(self.clock.sleep(dt))
        try:
            await asyncio.wait({ev, sl},
                               return_when=asyncio.FIRST_COMPLETED)
        finally:
            for t in (ev, sl):
                t.cancel()
                with contextlib.suppress(asyncio.CancelledError):
                    await t

    def _take(self) -> list:
        """Drain up to ``max_batch`` live requests in EDF order. At most
        one container is populated (heap non-empty ⇒ FIFO empty), and the
        FIFO pops front-first — EDF order by its invariant, with no heap
        sift per request."""
        if not self._heap and len(self._fifo) <= self.max_batch:
            # whole-FIFO take (the common fast-path flush): one C-speed
            # filter and a clear instead of a per-row popleft loop
            fifo = self._fifo
            reqs = [r for r in fifo if not r.dead]
            if len(reqs) != len(fifo):
                for r in fifo:
                    if r.dead:
                        self._recycle(r)
            fifo.clear()
            self._live -= len(reqs)
            return reqs
        reqs = []
        while self._heap and len(reqs) < self.max_batch:
            r = heapq.heappop(self._heap)
            if r.dead:
                self._recycle(r)
            else:
                reqs.append(r)
        while self._fifo and len(reqs) < self.max_batch:
            r = self._fifo.popleft()
            if r.dead:
                self._recycle(r)
            else:
                reqs.append(r)
        self._live -= len(reqs)
        return reqs

    def _dispatch_ctx(self, reqs: list, handle=None) -> DispatchCtx:
        """Per-flush metadata for resilience-aware executors: the model's
        degradation routes, the route-selectable infer, the output guard,
        the earliest SLO wall deadline among the batch's rows (the
        dispatch stage budgets timeouts and retry backoff from it), and
        the flush's trace handle."""
        walls = [r.wall for r in reqs if r.wall is not None]
        return DispatchCtx(
            name=self.name, rows=len(reqs), clock=self.clock,
            metrics=self.metrics, routes=self._routes,
            infer_routed=self._infer_routed,
            deadline=min(walls) if walls else None,
            max_batch=self.max_batch, validate=self._validate,
            trace=handle)

    def _flush(self) -> None:
        reqs = self._take()
        if not reqs:
            return
        t_take = self.clock.now()
        if self.tracer.enabled or not self._fast:
            # legacy lane keeps the pre-teardown shape: unconditional
            # flush bookkeeping calls (NULL tracer no-ops inside)
            fid = self.tracer.flush_begin(
                [r.rid for r in reqs], t_take, model=self.name,
                rows=len(reqs),
                bucket=dispatched_bucket_rows(len(reqs), self.max_batch))
            handle = self.tracer.handle(fid, self.clock)
        else:  # untraced hot path: skip even the span-argument assembly
            fid = handle = None
        ex = self.executor
        detached = self._fast and not ex.inline and ex.detached
        # Prestaged assembly fast path: rows are copied straight into the
        # engine's pooled physical-layout staging buffers — no np.stack,
        # no per-flush allocation, no staged device pad. Only flushes that
        # fit one warmed bucket qualify, and only on the dispatch paths
        # whose executor calls ``infer`` exactly once (inline / detached);
        # resilience-wrapped executors keep the stacked-array contract
        # their retry/bisection semantics are written against.
        if (self._infer_staged is not None and self._fast
                and len(reqs) <= self._staged_max
                and (ex.inline or detached)):
            infer: Callable = self._infer_staged
            xs = [r.x for r in reqs]
        else:
            infer = self._infer
            try:
                # staging included: a malformed request (wrong sample
                # shape) must poison its batch, not kill the scheduler
                xs = np.stack([np.asarray(r.x) for r in reqs])
            except Exception as e:
                self._fail(reqs, e, fid=fid)
                return
        if fid is not None:
            self.tracer.span(fid, "flush_assemble", t_take,
                             self.clock.now(), rows=len(reqs))
        if ex.inline:
            # deterministic fast path: the flush completes synchronously on
            # the event loop (no task hop), exactly the FakeClock contract
            t0 = self.clock.now()
            self.metrics.observe_dispatch(len(reqs))
            try:
                if handle is not None:
                    with handle.scope():  # engine spans land on this flush
                        ys = infer(xs)
                else:
                    ys = infer(xs)
                t_disp = self.clock.now()
                self.tracer.span(fid, "dispatch", t0, t_disp)
                ys = self._validate_rows(ys, len(reqs))
                self.tracer.span(fid, "validate", t_disp, self.clock.now())
            except Exception as e:  # poison batch fails its requests, not
                self._fail(reqs, e, fid=fid)  # the scheduler — the loop
                return                        # keeps serving
            finally:
                self.metrics.observe_retire(len(reqs))
            self._distribute(reqs, ys, t0, self.clock.now(), fid=fid)
        elif detached:
            # batch-granular future resolution: the executor runs the
            # flush off-loop and delivers it back as ONE loop callback
            # (_flush_done) that retires the batch and resolves every row
            # future — no flight task, no per-flush executor-future hop.
            self._in_flight_rows += len(reqs)
            self.metrics.observe_dispatch(len(reqs))
            t0 = self.clock.now()
            self._detached += 1
            self._quiesced.clear()

            def done(res, err, reqs=reqs, t0=t0, fid=fid):
                self._flush_done(reqs, res, err, t0, fid)

            try:
                ex.submit_flush(infer, xs, self._dispatch_ctx(reqs, handle),
                                done)
            except Exception as e:  # refused (closed/shutdown pool): the
                self._detached -= 1  # flush fails, done() never fires
                if self._detached == 0:
                    self._quiesced.set()
                self._in_flight_rows -= len(reqs)
                self.metrics.observe_retire(len(reqs))
                self._fail(reqs, e, fid=fid)
        else:
            # pipelined legacy path (resilience / fault-injection
            # wrappers): hand the batch to the executor and return to
            # coalescing; the flight task distributes when the device call
            # lands. In-flight rows stay inside the max_queue bound.
            self._in_flight_rows += len(reqs)
            self.metrics.observe_dispatch(len(reqs))
            task = asyncio.get_running_loop().create_task(
                self._flush_offloop(reqs, xs, fid, handle))
            self._flights.add(task)
            task.add_done_callback(self._flights.discard)

    def _flush_done(self, reqs: list, res, err: Optional[Exception],
                    t0: float, fid) -> None:
        """Detached-flush retirement: runs as the single event-loop
        callback the executor scheduled via ``call_soon_threadsafe`` —
        every row future of the flush resolves here, in one loop wakeup."""
        self._detached -= 1
        if self._detached == 0:
            self._quiesced.set()
        self._in_flight_rows -= len(reqs)
        self.metrics.observe_retire(len(reqs))
        t1 = self.clock.now()
        if err is None:
            try:
                ys = res if isinstance(res, RowOutcomes) else \
                    self._validate_rows(res, len(reqs))
            except Exception as e:
                err, ys = e, None
        if err is not None:
            self.tracer.span(fid, "dispatch", t0, t1, ok=False)
            self._fail(reqs, err, fid=fid)
            return
        self.tracer.span(fid, "dispatch", t0, t1)
        if isinstance(ys, RowOutcomes):
            self._distribute_outcomes(reqs, ys, t0, t1, fid=fid)
        else:
            self._distribute(reqs, ys, t0, t1, fid=fid)

    def _validate_rows(self, ys, take: int):
        """One validation for both dispatch paths: inline and off-loop
        must poison batches under identical conditions."""
        ys = np.asarray(ys)
        if ys.shape[:1] != (take,):
            raise ValueError(f"{self.name}: infer returned shape "
                             f"{ys.shape} for a {take}-row batch")
        return ys

    async def _flush_offloop(self, reqs: list, xs, fid=None,
                             handle=None) -> None:
        t0 = self.clock.now()
        try:
            res = await self.executor.run(
                self._infer, xs, ctx=self._dispatch_ctx(reqs, handle))
            self.tracer.span(fid, "dispatch", t0, self.clock.now())
            ys = res if isinstance(res, RowOutcomes) else \
                self._validate_rows(res, len(reqs))
        except Exception as e:
            self.tracer.span(fid, "dispatch", t0, self.clock.now(),
                             ok=False)
            self._fail(reqs, e, fid=fid)
            return
        finally:
            self._in_flight_rows -= len(reqs)
            self.metrics.observe_retire(len(reqs))
        if isinstance(ys, RowOutcomes):
            self._distribute_outcomes(reqs, ys, t0, self.clock.now(),
                                      fid=fid)
        else:
            self._distribute(reqs, ys, t0, self.clock.now(), fid=fid)

    def _wrap(self, err: Exception, rows: int,
              collateral: Optional[bool]) -> FlushError:
        """Wrap a raw dispatch exception in :class:`FlushError` with this
        flush's serving context (already-wrapped errors pass through)."""
        if isinstance(err, FlushError):
            return err
        return FlushError(self.name,
                          dispatched_bucket_rows(rows, self.max_batch),
                          rows, err, collateral=collateral)

    def _fail(self, reqs: list, err: Exception, fid=None) -> None:
        """Poison batch: the error — wrapped in :class:`FlushError` with
        model/bucket/row-count context — reaches every request's caller;
        rows the caller already abandoned count cancelled, not failed.
        With more than one row the failure is unattributed
        (``collateral=None``): any row may be the poison."""
        n = len(reqs)
        wrapped = self._wrap(err, n, None if n > 1 else False)
        t = self.clock.now()
        self.tracer.flush_error(fid, self.name, wrapped, t)
        for r in reqs:
            if not r.future.done():
                r.future.set_exception(wrapped)
                self.metrics.observe_fail(r.cls)
                self.tracer.terminal(r.rid, t, "failed",
                                     error=type(err).__name__)
            else:
                self.metrics.observe_cancelled(r.cls)
                self.tracer.terminal(r.rid, t, "shed", reason="cancelled")
        self.tracer.flush_end(fid, t)
        for r in reqs:  # taken from the containers by _take: pool-safe
            self._recycle(r)

    def _complete(self, r: "_Request", y, t1: float, fid) -> None:
        """One request's success terminal: resolve the future, count it,
        and (when traced) close its trace + note an SLO miss for the
        flight recorder's burst trigger."""
        r.future.set_result(y)
        slo_s = self._policy(r.cls).slo_s
        latency = t1 - r.t
        self.metrics.observe_done(latency, cls=r.cls, slo_s=slo_s)
        if slo_s is not None and latency > slo_s:
            self.tracer.slo_miss(self.name, r.cls, t1, latency, slo_s)
        self.tracer.terminal(r.rid, t1, "complete")

    def _distribute(self, reqs: list, ys, t0: float, t1: float,
                    fid=None) -> None:
        # bucket rows as actually dispatched: predict_q_many chunks on
        # bucket boundaries, so occupancy reflects real padding, not the
        # bucket_for(take) a single un-chunked call would have paid
        by_class: dict = {}
        for r in reqs:
            by_class[r.cls] = by_class.get(r.cls, 0) + 1
        self.metrics.observe_batch(
            len(reqs), dispatched_bucket_rows(len(reqs), self.max_batch),
            t1 - t0, by_class=by_class)
        if self._fast:
            # batch-granular resolution: one tight set_result loop, then
            # the flush's terminal accounting folded into ONE metrics call
            # per class — no per-row observer call on the hot path. The
            # legacy lane below keeps the per-row shape so the pre-teardown
            # cost stays reconstructable for the dispatch A/B bench.
            traced = self.tracer.enabled
            lats: dict = {}
            for r, y in zip(reqs, ys):
                if not r.future.done():
                    r.future.set_result(y)
                    lat = t1 - r.t
                    by = lats.get(r.cls)
                    if by is None:
                        by = lats[r.cls] = []
                    by.append(lat)
                    if traced:
                        slo_s = self._policy(r.cls).slo_s
                        if slo_s is not None and lat > slo_s:
                            self.tracer.slo_miss(self.name, r.cls, t1,
                                                 lat, slo_s)
                        self.tracer.terminal(r.rid, t1, "complete")
                else:  # caller cancelled: distinct from infer failure
                    self.metrics.observe_cancelled(r.cls)
                    self.tracer.terminal(r.rid, t1, "shed",
                                         reason="cancelled")
            for cls, ls in lats.items():
                self.metrics.observe_done_many(
                    ls, cls=cls, slo_s=self._policy(cls).slo_s)
            self.tracer.flush_end(fid, t1)
            # recycle inline (taken from the containers by _take:
            # pool-safe) — no per-row call on the hot path
            pool, cap = self._pool, self.max_queue
            for r in reqs:
                if len(pool) < cap:
                    r.x = None
                    r.future = None
                    r.rid = None
                    pool.append(r)
            return
        for r, y in zip(reqs, ys):
            if not r.future.done():
                self._complete(r, y, t1, fid)
            else:  # caller cancelled: distinct from infer failure
                self.metrics.observe_cancelled(r.cls)
                self.tracer.terminal(r.rid, t1, "shed",
                                     reason="cancelled")
        self.tracer.flush_end(fid, t1)
        for r in reqs:  # taken from the containers by _take: pool-safe
            self._recycle(r)

    def _distribute_outcomes(self, reqs: list, out: RowOutcomes,
                             t0: float, t1: float, fid=None) -> None:
        """Mixed per-row distribution: the resilience layer's bisection
        isolated failures to specific rows, so surviving rows complete
        normally while failed rows get a :class:`FlushError` carrying
        their poison/collateral attribution."""
        by_class: dict = {}
        for r in reqs:
            by_class[r.cls] = by_class.get(r.cls, 0) + 1
        self.metrics.observe_batch(
            len(reqs), dispatched_bucket_rows(len(reqs), self.max_batch),
            t1 - t0, by_class=by_class)
        for i, r in enumerate(reqs):
            if r.future.done():  # caller abandoned: not failed, not done
                self.metrics.observe_cancelled(r.cls)
                self.tracer.terminal(r.rid, t1, "shed", reason="cancelled")
                continue
            hit = out.errors.get(i)
            if hit is None:
                self._complete(r, out.ys[i], t1, fid)
            else:
                err, collateral = hit
                wrapped = self._wrap(err, 1, collateral)
                r.future.set_exception(wrapped)
                self.metrics.observe_fail(r.cls,
                                          collateral=bool(collateral))
                self.tracer.flush_error(fid, self.name, wrapped, t1)
                self.tracer.terminal(r.rid, t1, "failed",
                                     error=type(err).__name__,
                                     collateral=bool(collateral))
        self.tracer.flush_end(fid, t1)
        for r in reqs:  # taken from the containers by _take: pool-safe
            self._recycle(r)
