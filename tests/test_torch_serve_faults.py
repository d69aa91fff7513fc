"""Fault-injection harness semantics: seeded determinism, forced

The port's copy of ``tests/test_faults.py``: the same invariants, held on
``repro_torch.serve`` / ``repro_torch.obs`` over the port's
``CompiledModel(device="cpu")``.
scripting, per-kind accounting, and the executor-boundary behaviors
(pool recycling, clock-driven spikes, deterministic poison rows).

No real sleeps anywhere: injected latency goes through the ctx clock
(``FakeClock`` here), and the worker-death test only asserts pool
lifecycle, never timing.
"""
import asyncio

import numpy as np
import pytest

import repro_torch.serve.faults as faults
from repro_torch.serve.executor import (DispatchCtx, InlineExecutor,
                                  ThreadPoolExecutorBackend)
from repro_torch.serve.faults import (FaultInjector, PersistentFault, PoisonRow,
                                TransientFault, WorkerDeath)
from repro_torch.serve.metrics import ModelMetrics
from repro_torch.serve.scheduler import FakeClock


def run(coro):
    return asyncio.run(coro)


XS = np.arange(4, dtype=np.int64).reshape(4, 1)


def plus_one(xs):
    return np.asarray(xs) + 1


def ctx(clock=None, metrics=None, route=None):
    return DispatchCtx(name="m", rows=len(XS), clock=clock,
                       metrics=metrics, route=route)


def test_selftest_passes():
    assert faults.selftest() == 0


def test_no_faults_is_transparent():
    async def body():
        ex = FaultInjector().wrap(InlineExecutor())
        ys = await ex.run(plus_one, XS, ctx=ctx())
        assert np.array_equal(ys, XS + 1)
        assert ex.injector.injected == 0
        assert ex.injector.dispatches == 1
    run(body())


def test_seeded_draws_are_reproducible():
    def sequence(seed):
        inj = FaultInjector(seed=seed, transient_rate=0.3, nan_rate=0.2,
                            spike_rate=0.1)
        return [inj._draw(None, XS) for _ in range(200)]

    assert sequence(11) == sequence(11)
    assert sequence(11) != sequence(12)  # the seed actually matters


def test_forced_faults_consumed_fifo_before_random_draws():
    async def body():
        inj = FaultInjector(seed=0)  # all rates zero: only forced fire
        ex = inj.wrap(InlineExecutor())
        inj.fail_next("transient")
        inj.fail_next("worker_death")
        with pytest.raises(TransientFault):
            await ex.run(plus_one, XS, ctx=ctx())
        with pytest.raises(WorkerDeath):
            await ex.run(plus_one, XS, ctx=ctx())
        ys = await ex.run(plus_one, XS, ctx=ctx())  # queue drained
        assert np.array_equal(ys, XS + 1)
        assert inj.by_kind == {"transient": 1, "worker_death": 1}
        assert inj.injected == 2
    run(body())


def test_injection_counted_in_model_metrics():
    async def body():
        clock = FakeClock()
        metrics = ModelMetrics(now=clock.now())
        inj = FaultInjector()
        ex = inj.wrap(InlineExecutor())
        inj.fail_next("transient", times=2)
        for _ in range(2):
            with pytest.raises(TransientFault):
                await ex.run(plus_one, XS, ctx=ctx(clock, metrics))
        snap = metrics.snapshot(clock.now())
        assert snap["injected_faults"] == 2
        assert snap["injected_by_kind"] == {"transient": 2}
    run(body())


def test_persistent_route_targets_ctx_route_and_heals():
    async def body():
        inj = FaultInjector(persistent_routes={"kernels"})
        ex = inj.wrap(InlineExecutor())
        with pytest.raises(PersistentFault):
            await ex.run(plus_one, XS, ctx=ctx(route="kernels"))
        # other routes are untouched
        ys = await ex.run(plus_one, XS, ctx=ctx(route="compiled"))
        assert np.array_equal(ys, XS + 1)
        inj.heal_route("kernels")
        ys = await ex.run(plus_one, XS, ctx=ctx(route="kernels"))
        assert np.array_equal(ys, XS + 1)
        inj.break_route("compiled")
        with pytest.raises(PersistentFault):
            await ex.run(plus_one, XS, ctx=ctx(route="compiled"))
    run(body())


def test_poison_predicate_is_deterministic_and_data_dependent():
    async def body():
        inj = FaultInjector(poison=lambda row: int(row[0]) == 2)
        ex = inj.wrap(InlineExecutor())
        for _ in range(3):  # every time, not probabilistically
            with pytest.raises(PoisonRow):
                await ex.run(plus_one, XS, ctx=ctx())
        clean = XS[[0, 1, 3]]
        ys = await ex.run(plus_one, clean, ctx=DispatchCtx(name="m",
                                                           rows=3))
        assert np.array_equal(ys, clean + 1)
        assert inj.by_kind["poison"] == 3
    run(body())


def test_nan_corruption_is_shape_compatible_garbage():
    async def body():
        inj = FaultInjector()
        inj.fail_next("nan")
        ex = inj.wrap(InlineExecutor())
        ys = await ex.run(plus_one, XS, ctx=ctx())
        assert ys.shape == (XS + 1).shape
        assert ys.dtype == np.float32
        assert np.all(np.isnan(ys))  # silent corruption, no exception
    run(body())


def test_spike_waits_on_injected_clock_not_wall_time():
    async def body():
        clock = FakeClock()
        inj = FaultInjector(spike_s=0.5)
        inj.fail_next("spike")
        ex = inj.wrap(InlineExecutor())
        task = asyncio.ensure_future(ex.run(plus_one, XS,
                                            ctx=ctx(clock)))
        await clock.drain()
        assert not task.done()           # parked on the virtual clock
        await clock.advance(0.4)
        assert not task.done()           # spike_s not yet elapsed
        await clock.advance(0.2)
        assert np.array_equal(task.result(), XS + 1)
        assert inj.by_kind["spike"] == 1
    run(body())


def test_worker_death_recycles_thread_pool_and_serving_resumes():
    async def body():
        backend = ThreadPoolExecutorBackend(max_workers=1)
        inj = FaultInjector()
        ex = inj.wrap(backend)
        try:
            ys = await ex.run(plus_one, XS, ctx=ctx())
            assert np.array_equal(ys, XS + 1)  # pool lazily built
            assert backend._pool is not None
            inj.fail_next("worker_death")
            with pytest.raises(WorkerDeath):
                await ex.run(plus_one, XS, ctx=ctx())
            assert backend._pool is None       # torn down mid-serve
            ys = await ex.run(plus_one, XS, ctx=ctx())
            assert np.array_equal(ys, XS + 1)  # fresh pool, serving on
            assert backend._pool is not None
        finally:
            ex.close()
        assert ex.closed and backend.closed
    run(body())


def test_transient_rate_fires_near_configured_rate():
    async def body():
        inj = FaultInjector(seed=5, transient_rate=0.05)
        ex = inj.wrap(InlineExecutor())
        hits = 0
        for _ in range(600):
            try:
                await ex.run(plus_one, XS, ctx=ctx())
            except TransientFault:
                hits += 1
        assert hits == inj.by_kind["transient"] == inj.injected
        assert 0.02 < hits / 600 < 0.10  # seeded binomial, wide band
    run(body())


def test_fail_next_rejects_unknown_kind():
    inj = FaultInjector()
    with pytest.raises(AssertionError):
        inj.fail_next("meteor-strike")
