"""Seeded fault-injection harness for the serving pipeline (chaos layer).

A :class:`FaultInjector` sits at the executor boundary — ``injector.
wrap(backend)`` returns a :class:`FaultInjectingExecutor` that delegates
to the wrapped backend but, per dispatch, may deterministically (seeded
RNG) inject one of:

* ``transient``  — a :class:`TransientFault` raised *instead of* the
  dispatch: the canonical recoverable failure (a retry succeeds).
* ``persistent`` — a :class:`PersistentFault` raised whenever the
  dispatch targets a route in ``persistent_routes`` (read from
  ``DispatchCtx.route``; ``None`` matches the primary/un-routed path).
  This is the "route is broken" fault the circuit breaker + route
  degradation exist for; ``heal_route`` repairs it mid-test so breaker
  recovery (half-open probe → closed) can be exercised.
* ``nan``        — the dispatch RUNS, but its output is replaced with a
  NaN-filled float32 array: silent corruption, only catchable by the
  resilience layer's output-validity guard.
* ``spike``      — ``spike_s`` of injected latency via
  ``DispatchCtx.clock.sleep`` *before* a normal dispatch. Under
  ``FakeClock`` no real time passes; with a deadline-derived timeout the
  spike converts into a :class:`DispatchTimeoutError` upstream.
* ``worker_death`` — the wrapped backend's pool is torn down mid-serve
  (``ThreadPoolExecutorBackend.recycle``) and the dispatch fails with
  :class:`WorkerDeath`; the next dispatch transparently lands on a fresh
  pool. Backends without ``recycle`` just get the exception.
* ``poison``     — data-dependent: any dispatch whose batch contains a
  row matching the ``poison`` predicate fails with :class:`PoisonRow`,
  deterministically, every time. This is the fault poison-batch
  bisection isolates (clean batchmates must still complete).

Forced injection (``fail_next``) queues exact fault kinds for the next
dispatches regardless of rates — deterministic tests use it to script
scenarios ("two transients then success") without touching the RNG.

Every fired fault is counted on the injector (``injected`` /
``by_kind``) and, when the dispatch carries metrics in its ctx, in
``ModelMetrics.observe_injected`` — the chaos bench reads both to prove
faults actually fired at the configured rate.

``python -m repro_torch.serve.faults --selftest`` proves the harness still
injects every fault kind and that the resilience layer recovers from
each (CI runs it — see ``tools/check.sh``).
"""
from __future__ import annotations

import random
from collections import deque
from typing import Callable, Optional

import numpy as np

from .executor import DispatchCtx, InferenceExecutor

KINDS = ("transient", "persistent", "nan", "spike", "worker_death",
         "poison")


class InjectedFault(RuntimeError):
    """Base class for every fault the harness raises (never escapes a
    resilient stack un-handled in the success stories; always carries
    ``kind`` for attribution)."""

    kind = "injected"

    def __init__(self, detail: str = ""):
        super().__init__(f"injected {self.kind} fault"
                         + (f": {detail}" if detail else ""))


class TransientFault(InjectedFault):
    """Fails this dispatch attempt only — a retry succeeds."""

    kind = "transient"


class PersistentFault(InjectedFault):
    """Fails every dispatch on a broken route until it is healed."""

    kind = "persistent"


class WorkerDeath(InjectedFault):
    """The dispatch's worker died mid-serve (pool recycled underneath)."""

    kind = "worker_death"


class PoisonRow(InjectedFault):
    """A specific input row deterministically fails any batch it is in."""

    kind = "poison"


class FaultInjector:
    """Seeded fault source: rates in [0, 1] per dispatch, drawn from one
    ``random.Random(seed)`` so a chaos run is reproducible end-to-end.

    * ``transient_rate`` / ``nan_rate`` / ``spike_rate`` /
      ``worker_death_rate`` — independent per-dispatch probabilities
      (checked in that order; at most one random fault fires per
      dispatch).
    * ``persistent_routes`` — route names that are *broken*: every
      dispatch targeting one fails (not probabilistic). ``heal_route`` /
      ``break_route`` mutate the set mid-run.
    * ``poison`` — ``predicate(row) -> bool`` marking rows that
      deterministically poison any batch containing them.
    * ``spike_s`` — injected latency per spike (virtual under FakeClock).
    """

    def __init__(self, *, seed: int = 0, transient_rate: float = 0.0,
                 persistent_routes=(), nan_rate: float = 0.0,
                 spike_rate: float = 0.0, spike_s: float = 0.010,
                 worker_death_rate: float = 0.0,
                 poison: Optional[Callable] = None):
        self.seed = seed
        self._rng = random.Random(seed)
        self.transient_rate = transient_rate
        self.persistent_routes = set(persistent_routes)
        self.nan_rate = nan_rate
        self.spike_rate = spike_rate
        self.spike_s = spike_s
        self.worker_death_rate = worker_death_rate
        self.poison = poison
        self._forced: deque = deque()
        self.dispatches = 0
        self.injected = 0
        self.by_kind: dict = {}

    # -- scripting hooks (tests) -----------------------------------------
    def fail_next(self, kind: str = "transient", times: int = 1) -> None:
        """Queue ``times`` forced faults of ``kind`` for the next
        dispatches (consumed before any random draw)."""
        assert kind in KINDS, kind
        self._forced.extend([kind] * times)

    def break_route(self, route) -> None:
        self.persistent_routes.add(route)

    def heal_route(self, route) -> None:
        self.persistent_routes.discard(route)

    # -- accounting -------------------------------------------------------
    def _record(self, kind: str, ctx: Optional[DispatchCtx]) -> None:
        self.injected += 1
        self.by_kind[kind] = self.by_kind.get(kind, 0) + 1
        if ctx is not None and ctx.metrics is not None:
            ctx.metrics.observe_injected(kind)

    def _draw(self, ctx: Optional[DispatchCtx], xs) -> Optional[str]:
        """Pick at most one fault for this dispatch: forced queue first,
        then the deterministic conditions (broken route, poison row),
        then one seeded random draw per rate, in declaration order."""
        if self._forced:
            return self._forced.popleft()
        route = ctx.route if ctx is not None else None
        if route in self.persistent_routes:
            return "persistent"
        if self.poison is not None and \
                any(bool(self.poison(row)) for row in xs):
            return "poison"
        for kind, rate in (("transient", self.transient_rate),
                           ("nan", self.nan_rate),
                           ("spike", self.spike_rate),
                           ("worker_death", self.worker_death_rate)):
            if rate > 0.0 and self._rng.random() < rate:
                return kind
        return None

    def wrap(self, executor: InferenceExecutor) -> "FaultInjectingExecutor":
        """The chaos boundary: ``wrap`` the real backend, then hand the
        result to a :class:`~repro_torch.serve.resilience.ResilientExecutor`
        (faults inject *below* the recovery layer)."""
        return FaultInjectingExecutor(self, executor)


class FaultInjectingExecutor(InferenceExecutor):
    """Delegate to ``inner``, injecting the wrapped injector's faults."""

    inline = False

    def __init__(self, injector: FaultInjector, inner: InferenceExecutor):
        self._inj = injector
        self._inner = inner

    @property
    def injector(self) -> FaultInjector:
        return self._inj

    @property
    def inner(self) -> InferenceExecutor:
        return self._inner

    @property
    def closed(self) -> bool:
        return self._inner.closed

    def close(self) -> None:
        self._inner.close()

    async def run(self, infer, xs, ctx: Optional[DispatchCtx] = None):
        inj = self._inj
        inj.dispatches += 1
        kind = inj._draw(ctx, np.asarray(xs))
        if kind is None:
            return await self._inner.run(infer, xs, ctx=ctx)
        name = ctx.name if ctx is not None else "model"
        route = ctx.route if ctx is not None else None
        if kind == "transient":
            inj._record(kind, ctx)
            raise TransientFault(f"{name} route={route!r}")
        if kind == "persistent":
            inj._record(kind, ctx)
            raise PersistentFault(f"{name} route={route!r} is broken")
        if kind == "poison":
            inj._record(kind, ctx)
            raise PoisonRow(f"{name}: batch contains a poison row")
        if kind == "worker_death":
            inj._record(kind, ctx)
            recycle = getattr(self._inner, "recycle", None)
            if recycle is not None:
                recycle()
            raise WorkerDeath(f"{name}: worker died mid-serve")
        if kind == "spike":
            inj._record(kind, ctx)
            clock = ctx.clock if ctx is not None and ctx.clock is not None \
                else None
            if clock is not None:
                await clock.sleep(inj.spike_s)
            return await self._inner.run(infer, xs, ctx=ctx)
        # kind == "nan": run the real dispatch, corrupt its output —
        # shape-compatible garbage only the validity guard can catch
        inj._record(kind, ctx)
        ys = await self._inner.run(infer, xs, ctx=ctx)
        ys = np.asarray(ys)
        return np.full(ys.shape, np.nan, dtype=np.float32)


# ---------------------------------------------------------------------------
# selftest: the harness injects every kind; resilience recovers from each
# ---------------------------------------------------------------------------

def selftest(verbose: bool = False) -> int:
    """Prove the chaos harness end-to-end with no model and no real time:
    every fault kind fires on demand, counters count, and a
    ``ResilientExecutor`` over the injected backend recovers exactly as
    designed (retry absorbs transients, degradation routes around broken
    primaries, bisection isolates poison rows, the guard catches NaN).
    Returns 0 on success; raises ``AssertionError`` on any regression.
    """
    import asyncio

    from .executor import InlineExecutor
    from .resilience import (InvalidOutputError, ResilientExecutor,
                             RetryPolicy)
    from .scheduler import FakeClock, FlushError

    def say(msg):
        if verbose:
            print(f"  [faults-selftest] {msg}")

    def infer(xs):
        return np.asarray(xs) + 1

    def routed(xs, route=None):
        return infer(xs)

    def guard(ys, rows, name="model"):
        ys = np.asarray(ys)
        if ys.shape[:1] != (rows,):
            raise InvalidOutputError(name, f"shape {ys.shape}")
        if np.issubdtype(ys.dtype, np.floating) and \
                not bool(np.all(np.isfinite(ys))):
            raise InvalidOutputError(name, "non-finite")

    async def main():
        clock = FakeClock()
        xs = np.arange(8, dtype=np.int64).reshape(8, 1)

        async def settle(task, t=1.0):
            # let the task run to its first clock.sleep, then advance
            # virtual time far enough to cover every backoff/spike
            await clock.drain()
            await clock.advance(t)
            return task.result()

        # 1) forced transient absorbed by one retry, counted on both sides
        inj = FaultInjector(seed=7)
        rex = ResilientExecutor(inj.wrap(InlineExecutor()),
                                retry=RetryPolicy(max_attempts=3,
                                                  jitter=0.0))
        inj.fail_next("transient")
        task = asyncio.ensure_future(rex.run(
            infer, xs, ctx=DispatchCtx(name="m", rows=8, clock=clock)))
        ys = await settle(task)  # covers the backoff sleep
        assert np.array_equal(ys, xs + 1), "retry did not recover"
        assert inj.by_kind.get("transient") == 1, inj.by_kind
        say("transient -> retry recovers")

        # 2) broken primary route -> degradation to the next route
        inj2 = FaultInjector(persistent_routes={"kernels"})
        rex2 = ResilientExecutor(inj2.wrap(InlineExecutor()),
                                 retry=RetryPolicy(max_attempts=2,
                                                   jitter=0.0))
        ctx2 = DispatchCtx(name="m", rows=8, clock=clock,
                           routes=("kernels", "compiled"),
                           infer_routed=routed)
        task = asyncio.ensure_future(rex2.run(infer, xs, ctx=ctx2))
        assert np.array_equal(await settle(task), xs + 1), \
            "degradation failed"
        assert inj2.by_kind.get("persistent", 0) >= 2, inj2.by_kind
        say("persistent route -> degrades to fallback")

        # 3) poison row isolated by bisection; batchmates complete
        bad = 5
        inj3 = FaultInjector(poison=lambda row: int(row[0]) == bad)
        rex3 = ResilientExecutor(inj3.wrap(InlineExecutor()),
                                 retry=RetryPolicy(max_attempts=1),
                                 )
        task = asyncio.ensure_future(rex3.run(
            infer, xs, ctx=DispatchCtx(name="m", rows=8, clock=clock,
                                       max_batch=8)))
        out = await settle(task)
        assert not isinstance(out, np.ndarray), "poison batch succeeded?"
        assert set(out.errors) == {bad}, out.errors
        err, collateral = out.errors[bad]
        assert isinstance(err, FlushError) and collateral is False
        for i in range(8):
            if i != bad:
                assert np.array_equal(out.ys[i], xs[i] + 1)
        say("poison row isolated by bisection; 7/8 rows served")

        # 4) NaN corruption caught by the validity guard, retry recovers
        inj4 = FaultInjector()
        inj4.fail_next("nan")
        rex4 = ResilientExecutor(inj4.wrap(InlineExecutor()),
                                 retry=RetryPolicy(max_attempts=2,
                                                   jitter=0.0))
        task = asyncio.ensure_future(rex4.run(
            infer, xs, ctx=DispatchCtx(name="m", rows=8, clock=clock,
                                       validate=guard)))
        assert np.array_equal(await settle(task), xs + 1), \
            "guard+retry failed"
        assert inj4.by_kind.get("nan") == 1
        say("nan corruption -> guard trips, retry recovers")

        # 5) latency spike + deadline-budgeted timeout -> times out, then
        # the retry (no spike queued) succeeds before the deadline
        inj5 = FaultInjector(spike_s=0.5)
        inj5.fail_next("spike")
        rex5 = ResilientExecutor(inj5.wrap(InlineExecutor()),
                                 retry=RetryPolicy(max_attempts=2,
                                                   base_s=0.001,
                                                   jitter=0.0))
        ctx5 = DispatchCtx(name="m", rows=8, clock=clock,
                           deadline=clock.now() + 0.050)
        task = asyncio.ensure_future(rex5.run(infer, xs, ctx=ctx5))
        assert np.array_equal(await settle(task), xs + 1), \
            "spike not survived"
        assert inj5.by_kind.get("spike") == 1
        say("latency spike -> timeout fires, retry lands in budget")

        # 6) worker death recycles the pool; the kind is raised + counted
        class _Recyclable(InlineExecutor):
            recycles = 0

            def recycle(self):
                self.recycles += 1

        base = _Recyclable()
        inj6 = FaultInjector()
        inj6.fail_next("worker_death")
        rex6 = ResilientExecutor(inj6.wrap(base),
                                 retry=RetryPolicy(max_attempts=2,
                                                   jitter=0.0))
        task = asyncio.ensure_future(rex6.run(
            infer, xs, ctx=DispatchCtx(name="m", rows=8, clock=clock)))
        assert np.array_equal(await settle(task), xs + 1)
        assert base.recycles == 1 and inj6.by_kind.get("worker_death") == 1
        say("worker death -> pool recycled, retry recovers")

        # 7) rates actually fire: 5% transient over many dispatches
        inj7 = FaultInjector(seed=3, transient_rate=0.05)
        bex = inj7.wrap(InlineExecutor())
        hits = 0
        for _ in range(400):
            try:
                await bex.run(infer, xs[:1],
                              ctx=DispatchCtx(name="m", rows=1,
                                              clock=clock))
            except TransientFault:
                hits += 1
        assert hits == inj7.by_kind.get("transient"), "count drift"
        assert 0.01 < hits / 400 < 0.12, f"rate off: {hits}/400"
        say(f"seeded 5% transient rate fired {hits}/400 dispatches")

    asyncio.run(main())
    return 0


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.serve.faults",
        description="Fault-injection harness selftest")
    p.add_argument("--selftest", action="store_true",
                   help="prove every fault kind injects and the "
                        "resilience layer recovers from each")
    p.add_argument("-q", "--quiet", action="store_true")
    args = p.parse_args(argv)
    if not args.selftest:
        p.print_help()
        return 2
    selftest(verbose=not args.quiet)
    print("faults selftest: OK (all fault kinds inject; resilience "
          "recovers)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
