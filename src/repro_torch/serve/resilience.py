"""Fault-tolerant dispatch: retries, circuit breakers, route degradation —
the port of ``repro.serve.resilience``.

:class:`ResilientExecutor` wraps any :class:`~repro_torch.serve.executor.
InferenceExecutor` and turns the dispatch stage's all-or-nothing contract
("the batch ran, or the batch raised") into a recovering one:

* **Per-dispatch timeouts** budgeted from the batch's earliest per-class
  SLO wall deadline (``DispatchCtx.deadline``): an attempt is raced
  against ``clock.sleep(timeout)`` — under ``FakeClock`` this makes
  timeout behavior exact with zero real sleeps, and a hung device call
  becomes :class:`DispatchTimeoutError` instead of a wedged flush.
* **Bounded retry with exponential backoff + deterministic jitter**
  (:class:`RetryPolicy`): transient faults — the dominant failure mode
  the chaos harness injects — are absorbed without the caller noticing
  anything but latency. The jitter RNG is seeded, so the whole backoff
  schedule is reproducible bit-for-bit in tests.
* **Per-(model, route) circuit breakers** (:class:`CircuitBreaker`,
  closed → open → half-open → closed): a route that keeps failing is
  taken out of rotation for ``recovery_s``, then probed with a single
  dispatch before being trusted again. Breaker transitions land in
  ``ModelMetrics`` via ``observe_breaker``.
* **Graceful route degradation** along the model's compile-time chain
  (``CompiledModel.routes()``: kernels → compiled → reference): when a
  route's attempts are exhausted or its breaker is open, the same batch
  is re-dispatched on the next route down. All routes share one
  ``ExecutionPlan`` folding, so a degraded answer is bit-identical to
  the primary's — degradation costs latency, never correctness.
* **Poison-batch bisection**: a group that fails on every usable route
  is split on bucket boundaries (``bucket_floor``) and each half retried
  independently, recursively, until the poison rows are isolated.
  Survivors complete normally; the scheduler distributes the resulting
  :class:`~repro_torch.serve.executor.RowOutcomes` per row, so one poison
  request no longer takes its batchmates down with it.
* **Output-validity guard** (:func:`make_output_guard`): the plan
  auditor's static per-output bounds (dtype, fused-activation clamp
  range — :func:`static_output_bounds`) become a runtime
  check; a dispatch returning NaN/inf, the wrong dtype, or values the
  plan proves impossible is treated exactly like a raised exception
  (silent corruption becomes a retryable fault).

The wrapper advertises ``inline = False`` so the scheduler always routes
flushes through it (the inline fast path would bypass ``run``), and it
never owns scheduling state: admission bounds, in-flight accounting, and
row distribution stay in the batcher.
"""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import random
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.core.engine import bucket_floor, dispatched_bucket_rows
from .executor import DispatchCtx, InferenceExecutor, RowOutcomes
from .scheduler import Clock, FlushError


class DispatchTimeoutError(RuntimeError):
    """One dispatch attempt outran its deadline-derived timeout."""

    def __init__(self, name: str, route, timeout_s: float):
        super().__init__(
            f"{name}: dispatch on route {route!r} exceeded its "
            f"{timeout_s * 1e3:.1f} ms budget")
        self.model = name
        self.route = route
        self.timeout_s = timeout_s


class BreakerOpenError(RuntimeError):
    """Every usable route's circuit breaker is open — nothing to try."""

    def __init__(self, name: str, routes):
        super().__init__(
            f"{name}: all routes unavailable (breakers open): "
            f"{list(routes)!r}")
        self.model = name
        self.routes = tuple(routes)


class InvalidOutputError(RuntimeError):
    """A dispatch returned output the execution plan proves impossible:
    wrong dtype, wrong row count, NaN/inf, or values outside the static
    fused-activation clamp bounds. Treated as a dispatch fault (retried,
    breaker-counted) — silent corruption must not reach callers."""

    def __init__(self, name: str, detail: str):
        super().__init__(f"{name}: invalid output — {detail}")
        self.model = name
        self.detail = detail


def static_output_bounds(plan) -> dict:
    """Compile-time validity contract for every graph output: ``{tensor id:
    (dtype, lo, hi)}`` — the port's copy of
    ``repro.analysis.static_output_bounds``, over the port's
    ``ExecutionPlan``.

    ``lo``/``hi`` are the tightest static bounds the plan proves for the
    output's values on EVERY route (the routes share one folding, so one
    bound covers kernels/compiled/reference alike): the dtype's
    representable range, narrowed by the producing op's folded fused-
    activation clamp (``ops_ref.clamp_bounds``) when one is folded."""
    from repro_torch.core.ops_ref import clamp_bounds

    g = plan.graph
    producer = {op.outputs[0]: i for i, op in enumerate(g.ops)}
    out = {}
    for tid in g.outputs:
        t = g.tensor(tid)
        dt = np.dtype(t.dtype)
        if np.issubdtype(dt, np.integer):
            info = np.iinfo(dt)
            lo, hi = float(info.min), float(info.max)
        else:
            lo, hi = float("-inf"), float("inf")
        i = producer.get(tid)
        fc = plan.folded.get(i) if i is not None else None
        if fc is not None:
            clo, chi = clamp_bounds(fc, g.ops[i].attrs.get("fused", "NONE"))
            lo, hi = max(lo, clo), min(hi, chi)
        out[tid] = (dt, lo, hi)
    return out


def make_output_guard(plan) -> Callable:
    """Build ``validate(ys, rows)`` from a plan's static output bounds.

    The guard raises :class:`InvalidOutputError` when the stacked output
    violates the compile-time contract (see :func:`static_output_bounds`);
    it costs one pass over the output rows and allocates nothing.
    Single-output graphs only (all three paper models), matching the
    batcher's contract.
    """
    bounds = static_output_bounds(plan)
    tid = plan.graph.outputs[0]
    dt, lo, hi = bounds[tid]

    def validate(ys, rows: int, name: str = "model") -> None:
        ys = np.asarray(ys)
        if ys.shape[:1] != (rows,):
            raise InvalidOutputError(
                name, f"shape {ys.shape} for a {rows}-row batch")
        if ys.dtype != dt:
            raise InvalidOutputError(
                name, f"dtype {ys.dtype} (plan says {dt})")
        if np.issubdtype(ys.dtype, np.floating) and \
                not bool(np.all(np.isfinite(ys))):
            raise InvalidOutputError(name, "non-finite values (NaN/inf)")
        if ys.size:
            vals = ys.astype(np.float64, copy=False)
            vmin, vmax = float(vals.min()), float(vals.max())
            if vmin < lo - 1e-9 or vmax > hi + 1e-9:
                raise InvalidOutputError(
                    name, f"values [{vmin}, {vmax}] outside static "
                          f"bounds [{lo}, {hi}]")

    return validate


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff + deterministic jitter.

    ``max_attempts`` counts dispatches per (group, route) — 1 disables
    retry. Backoff before attempt ``k`` (k >= 2) is
    ``min(base_s * 2**(k-2), cap_s)`` scaled by a jitter factor drawn
    from the executor's seeded RNG in ``[1 - jitter, 1 + jitter]`` — the
    schedule is fully reproducible for a given seed.
    """

    max_attempts: int = 3
    base_s: float = 0.002
    cap_s: float = 0.050
    jitter: float = 0.25
    seed: int = 0

    def backoff_s(self, attempt: int, rng: random.Random) -> float:
        """Backoff before retry number ``attempt`` (2 = first retry)."""
        b = min(self.base_s * (2.0 ** max(attempt - 2, 0)), self.cap_s)
        if self.jitter:
            b *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return b


@dataclasses.dataclass(frozen=True)
class BreakerPolicy:
    """Circuit-breaker tuning (per (model, route) breaker instance).

    ``failure_threshold`` consecutive failures open the breaker; after
    ``recovery_s`` it half-opens and admits a single serialized probe;
    ``probe_successes`` consecutive probe successes close it again (any
    probe failure re-opens and restarts the recovery clock).
    """

    failure_threshold: int = 3
    recovery_s: float = 0.050
    probe_successes: int = 1


CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


def _swallow(task: "asyncio.Task") -> None:
    """Retrieve an abandoned task's outcome so the loop never logs it."""
    if not task.cancelled():
        task.exception()


class CircuitBreaker:
    """One route's closed → open → half-open → closed state machine.

    Pure bookkeeping, clock passed in per call: the owner reads time from
    the flush's ``DispatchCtx.clock``, so breaker timing is exact under
    ``FakeClock``. ``on_transition(old, new)`` fires on every state
    change (wired to ``ModelMetrics.observe_breaker``).
    """

    __slots__ = ("policy", "state", "_fails", "_probes", "_opened_at",
                 "_probing", "_on_transition")

    def __init__(self, policy: BreakerPolicy,
                 on_transition: Optional[Callable] = None):
        self.policy = policy
        self.state = CLOSED
        self._fails = 0
        self._probes = 0
        self._opened_at = 0.0
        self._probing = False  # serialize half-open probes
        self._on_transition = on_transition

    def _to(self, new: str) -> None:
        old, self.state = self.state, new
        if old != new and self._on_transition is not None:
            self._on_transition(old, new)

    def allow(self, now: float) -> bool:
        """May a dispatch run on this route right now? A ``True`` from a
        half-open breaker claims the probe slot — the caller MUST report
        the outcome via ``record_success``/``record_failure``."""
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if now - self._opened_at >= self.policy.recovery_s - 1e-9:
                self._to(HALF_OPEN)
                self._probes = 0
            else:
                return False
        # HALF_OPEN: exactly one probe in flight at a time
        if self._probing:
            return False
        self._probing = True
        return True

    def record_success(self, now: float) -> None:
        if self.state == HALF_OPEN:
            self._probing = False
            self._probes += 1
            if self._probes >= self.policy.probe_successes:
                self._fails = 0
                self._to(CLOSED)
        else:
            self._fails = 0

    def record_failure(self, now: float) -> None:
        if self.state == HALF_OPEN:
            self._probing = False
            self._opened_at = now  # failed probe restarts recovery
            self._to(OPEN)
            return
        self._fails += 1
        if self.state == CLOSED and \
                self._fails >= self.policy.failure_threshold:
            self._opened_at = now
            self._to(OPEN)

    def release_probe(self) -> None:
        """Release a claimed half-open probe slot without an outcome
        (the probing flush was cancelled mid-air)."""
        self._probing = False


class ResilientExecutor(InferenceExecutor):
    """Wrap ``inner`` with timeouts, retries, breakers, degradation, and
    poison-batch bisection (module docstring has the full story).

    ``default_timeout_s`` bounds attempts when the batch carries no SLO
    deadline (``None`` = unbounded); ``min_timeout_s`` floors the
    deadline-derived budget so a nearly-expired batch still gets one real
    attempt window instead of an instant timeout.
    """

    inline = False  # the scheduler must route flushes through run()

    def __init__(self, inner: InferenceExecutor, *,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[BreakerPolicy] = None,
                 default_timeout_s: Optional[float] = None,
                 min_timeout_s: float = 0.001):
        self._inner = inner
        self.retry = retry if retry is not None else RetryPolicy()
        self.breaker_policy = breaker if breaker is not None \
            else BreakerPolicy()
        self.default_timeout_s = default_timeout_s
        self.min_timeout_s = min_timeout_s
        self._rng = random.Random(self.retry.seed)
        self._breakers: dict = {}  # (model, route) -> CircuitBreaker

    @property
    def inner(self) -> InferenceExecutor:
        return self._inner

    @property
    def closed(self) -> bool:
        return self._inner.closed

    def close(self) -> None:
        self._inner.close()

    def breaker(self, name: str, route,
                metrics: Any = None) -> CircuitBreaker:
        """The (model, route) breaker, created on first use."""
        key = (name, None if route is None else str(route))
        br = self._breakers.get(key)
        if br is None:
            def on_transition(old, new, _route=key[1]):
                if metrics is not None:
                    metrics.observe_breaker(_route or "primary", old, new)
            br = self._breakers[key] = CircuitBreaker(
                self.breaker_policy, on_transition)
        return br

    # -- dispatch ---------------------------------------------------------
    async def run(self, infer: Callable, xs,
                  ctx: Optional[DispatchCtx] = None):
        xs = np.asarray(xs)
        if ctx is None:
            ctx = DispatchCtx(rows=len(xs))
        clock = ctx.clock if ctx.clock is not None else Clock()
        n = len(xs)
        out = RowOutcomes(n)
        # Breaker interaction is flush-scoped: each route's breaker is
        # consulted ONCE per run (gate) and told ONE outcome at the end —
        # a route that served any row this flush is healthy; a route
        # whose every dispatch failed logs one failure sample. Bisection
        # probes therefore cannot trip a breaker mid-recovery and condemn
        # the clean rows they exist to save.
        state = {"gate": {}, "ok": set(), "fail": set()}
        try:
            await self._run_group(infer, xs, list(range(n)), ctx, clock,
                                  out, state)
        finally:
            now = clock.now()
            handle = ctx.trace
            for route, allowed in state["gate"].items():
                if not allowed:
                    continue
                br = self.breaker(ctx.name, route, ctx.metrics)
                old = br.state
                if route in state["ok"]:
                    br.record_success(now)
                elif route in state["fail"]:
                    br.record_failure(now)
                else:  # cancelled before any outcome: free the probe slot
                    br.release_probe()
                if handle is not None and br.state != old:
                    # breaker-open transitions also trigger a flight dump
                    handle.breaker(str(route or "primary"), old, br.state,
                                   now)
        if out.ok:
            # classic contract: every row succeeded -> one stacked array
            # (row slices of the per-group results, bit-identical)
            return np.stack(out.ys)
        return out

    async def _run_group(self, infer, xs, idxs, ctx, clock,
                         out: RowOutcomes, state: dict) -> None:
        """Dispatch ``xs[idxs]`` with the full recovery ladder; on total
        failure bisect on bucket boundaries and recurse. Results and
        per-row errors land in ``out``."""
        err, attempted = await self._dispatch(infer, xs, idxs, ctx, clock,
                                              out, state)
        if err is None:
            return
        k = len(idxs)
        deadline_ok = ctx.deadline is None or clock.now() < ctx.deadline
        if k > 1 and attempted and deadline_ok:
            # bisect on the bucket boundary predict_q_many chunks on, so
            # each half re-dispatches as its own (smaller) bucket
            h = bucket_floor(k)
            if h >= k:
                h = k // 2
            await self._run_group(infer, xs, idxs[:h], ctx, clock, out,
                                  state)
            await self._run_group(infer, xs, idxs[h:], ctx, clock, out,
                                  state)
            return
        # terminal: a single row failed alone (it IS the poison), or a
        # group we can no longer split (deadline/breakers) — batchmates
        # count as collateral damage
        collateral = k > 1
        wrapped = err if isinstance(err, FlushError) else FlushError(
            ctx.name, dispatched_bucket_rows(k, ctx.max_batch), k, err,
            collateral=collateral)
        out.fail_rows(idxs, wrapped, collateral)

    def _routes(self, ctx: DispatchCtx):
        """The degradation chain: configured routes, else the bare
        un-routed infer as the only 'route' (``None``)."""
        if ctx.routes and ctx.infer_routed is not None:
            return list(ctx.routes)
        return [None]

    async def _dispatch(self, infer, xs, idxs, ctx, clock, out,
                        state: dict):
        """Try every usable route in degradation order, with per-route
        retry/backoff. Success stores rows in ``out`` and returns
        ``(None, True)``; failure returns ``(last_error,
        any_dispatch_ran)`` — the second element gates bisection (if no
        dispatch ran, splitting cannot help)."""
        sub = xs if len(idxs) == len(xs) else xs[np.asarray(idxs)]
        routes = self._routes(ctx)
        metrics = ctx.metrics
        handle = ctx.trace
        last: Optional[Exception] = None
        attempted = False
        for ri, route in enumerate(routes):
            gate = state["gate"]
            if route not in gate:
                br = self.breaker(ctx.name, route, metrics)
                old = br.state
                gate[route] = br.allow(clock.now())
                if handle is not None and br.state != old:
                    # open -> half_open transition inside allow()
                    handle.breaker(str(route or "primary"), old, br.state,
                                   clock.now())
            if not gate[route]:
                last = last or BreakerOpenError(ctx.name, routes)
                continue  # this route is out of rotation; degrade
            call = infer if route is None else \
                (lambda b, _r=route: ctx.infer_routed(b, route=_r))
            for attempt in range(1, self.retry.max_attempts + 1):
                now = clock.now()
                if ctx.deadline is not None and now >= ctx.deadline:
                    return (last or DispatchTimeoutError(
                        ctx.name, route, 0.0), attempted)
                if attempt > 1:
                    if metrics is not None:
                        metrics.observe_retry()
                    t_b = clock.now()
                    await clock.sleep(
                        self.retry.backoff_s(attempt, self._rng))
                    if handle is not None:  # backoff wait = the retry span
                        handle.span("retry", t_b, clock.now(),
                                    route=str(route or "primary"),
                                    attempt=attempt, rows=len(idxs))
                attempted = True
                timeout = self._timeout_s(
                    ctx, clock.now(),
                    self.retry.max_attempts - attempt + 1)
                t_a = clock.now()
                try:
                    ys = await self._attempt(call, sub, ctx, route, clock,
                                             timeout)
                    t_v = clock.now()
                    if ctx.validate is not None:
                        ctx.validate(ys, len(idxs), ctx.name)
                    else:
                        ys = np.asarray(ys)
                        if ys.shape[:1] != (len(idxs),):
                            raise InvalidOutputError(
                                ctx.name, f"shape {ys.shape} for a "
                                          f"{len(idxs)}-row batch")
                    if handle is not None:
                        handle.span("validate", t_v, clock.now(),
                                    route=str(route or "primary"))
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    state["fail"].add(route)
                    last = e
                    if handle is not None:
                        handle.span("attempt", t_a, clock.now(), ok=False,
                                    route=str(route or "primary"),
                                    attempt=attempt, rows=len(idxs),
                                    error=type(e).__name__)
                    continue
                state["ok"].add(route)
                if handle is not None:
                    handle.span("attempt", t_a, clock.now(), ok=True,
                                route=str(route or "primary"),
                                attempt=attempt, rows=len(idxs))
                if ri > 0:
                    if metrics is not None:
                        metrics.observe_degraded(len(idxs), route)
                    if handle is not None:
                        handle.event("degrade", clock.now(),
                                     route=str(route), rows=len(idxs))
                out.set_rows(idxs, np.asarray(ys))
                return (None, True)
        return (last or BreakerOpenError(ctx.name, routes), attempted)

    def _timeout_s(self, ctx: DispatchCtx, now: float,
                   attempts_left: int) -> Optional[float]:
        """Per-attempt budget: the remaining wall-deadline headroom split
        evenly over the attempts still available (so one hung attempt
        cannot eat the whole budget and starve its own retries), floored
        at ``min_timeout_s``."""
        if ctx.deadline is None:
            return self.default_timeout_s
        remaining = ctx.deadline - now
        return max(remaining / max(attempts_left, 1), self.min_timeout_s)

    async def _attempt(self, call, sub, ctx, route, clock,
                       timeout: Optional[float]):
        """One dispatch on ``inner``, raced against the deadline-derived
        timeout on the flush's clock (FakeClock-exact; no real sleeps)."""
        attempt_ctx = dataclasses.replace(ctx, route=route,
                                          rows=len(sub))
        task = asyncio.ensure_future(
            self._inner.run(call, sub, ctx=attempt_ctx))
        if timeout is None:
            return await task
        sleeper = asyncio.ensure_future(clock.sleep(timeout))
        await asyncio.wait({task, sleeper},
                           return_when=asyncio.FIRST_COMPLETED)
        if task.done():
            sleeper.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await sleeper
            return task.result()  # raises the dispatch's own error
        # timeout won: abandon the hung dispatch (retrieve its eventual
        # result/exception via callback so nothing is logged as lost) —
        # awaiting it here would re-wedge the flush the timeout just saved
        task.cancel()
        task.add_done_callback(_swallow)
        raise DispatchTimeoutError(ctx.name, route, timeout)
