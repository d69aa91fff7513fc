"""Resilient-dispatch semantics, pinned deterministically.

The port's copy of ``tests/test_serve_resilience.py``: the same invariants, held on
``repro_torch.serve`` / ``repro_torch.obs`` over the port's
``CompiledModel(device="cpu")``.

Every test drives virtual time through ``FakeClock`` — retry backoff,
breaker recovery windows, timeout races, and injected latency spikes all
resolve with ZERO real sleeps. The bit-exactness tests (bisection
survivors, degraded-route parity) compare arrays with
``np.array_equal`` on the raw quantized dtypes: degradation and
recovery must be invisible in outputs, not merely "close".
"""
import asyncio
import random

import numpy as np
import pytest

from repro_torch.configs.paper_models import build_sine
from repro_torch.core import CompiledModel
from repro_torch.core.quantize import quantize_graph
from repro_torch.serve.executor import DispatchCtx, InlineExecutor, RowOutcomes
from repro_torch.serve.faults import FaultInjector, PersistentFault
from repro_torch.serve.metrics import ModelMetrics
from repro_torch.serve.resilience import (BreakerPolicy, CircuitBreaker,
                                    DispatchTimeoutError,
                                    InvalidOutputError, ResilientExecutor,
                                    RetryPolicy, make_output_guard)
from repro_torch.serve.scheduler import (ClassPolicy, DeadlineExceededError,
                                   FakeClock, FlushError, MicroBatcher,
                                   QueueFullError)


def run(coro):
    return asyncio.run(coro)


async def settle(clock, task, t=1.0):
    """Let ``task`` reach its first await, then advance virtual time."""
    await clock.drain()
    await clock.advance(t)
    return task.result()


XS = np.arange(8, dtype=np.int64).reshape(8, 1)


def plus_one(xs):
    return np.asarray(xs) + 1


# -- retry / backoff ------------------------------------------------------

def test_backoff_schedule_exponential_and_capped():
    pol = RetryPolicy(max_attempts=5, base_s=0.002, cap_s=0.005,
                      jitter=0.0)
    rng = random.Random(0)
    sched = [pol.backoff_s(k, rng) for k in (2, 3, 4, 5)]
    assert sched == [0.002, 0.004, 0.005, 0.005]  # doubles, then caps


def test_backoff_jitter_is_seeded_deterministic():
    pol = RetryPolicy(max_attempts=4, base_s=0.002, jitter=0.25, seed=42)
    a = [pol.backoff_s(k, random.Random(pol.seed)) for k in (2, 3, 4)]
    b = [pol.backoff_s(k, random.Random(pol.seed)) for k in (2, 3, 4)]
    assert a == b  # same seed -> bit-identical schedule
    lo, hi = 0.002 * 0.75, 0.002 * 1.25
    assert lo <= a[0] <= hi  # jitter stays inside the +/-25% band


def test_retry_absorbs_transients_and_counts():
    async def body():
        clock = FakeClock()
        metrics = ModelMetrics(now=clock.now())
        calls = []

        def flaky(xs):
            calls.append(len(xs))
            if len(calls) <= 2:
                raise RuntimeError("transient glitch")
            return plus_one(xs)

        rex = ResilientExecutor(InlineExecutor(),
                                retry=RetryPolicy(max_attempts=3,
                                                  jitter=0.0))
        task = asyncio.ensure_future(rex.run(
            flaky, XS, ctx=DispatchCtx(name="m", rows=8, clock=clock,
                                       metrics=metrics)))
        ys = await settle(clock, task)
        assert np.array_equal(ys, XS + 1)
        assert calls == [8, 8, 8]       # two retries, full batch each time
        assert metrics.retries == 2
    run(body())


def test_retry_exhaustion_bisects_then_fails_rows_as_poison():
    async def body():
        clock = FakeClock()

        def broken(xs):
            raise RuntimeError("always down")

        rex = ResilientExecutor(InlineExecutor(),
                                retry=RetryPolicy(max_attempts=1))
        task = asyncio.ensure_future(rex.run(
            broken, XS[:4], ctx=DispatchCtx(name="m", rows=4, clock=clock,
                                            max_batch=4)))
        out = await settle(clock, task)
        assert isinstance(out, RowOutcomes) and set(out.errors) == {0, 1,
                                                                    2, 3}
        for err, collateral in out.errors.values():
            # every row ended up dispatched alone -> it IS the poison
            assert collateral is False
            assert isinstance(err, FlushError) and err.rows == 1
    run(body())


def test_deadline_stops_bisection_and_marks_collateral():
    async def body():
        clock = FakeClock()

        def broken(xs):
            raise RuntimeError("down")

        rex = ResilientExecutor(InlineExecutor(),
                                retry=RetryPolicy(max_attempts=1),
                                min_timeout_s=1e-6)
        # deadline already unreachable after the first failed dispatch:
        # the group cannot be split inside the budget, so its rows are
        # collateral (unattributed batchmates), not per-row poison
        ctx = DispatchCtx(name="m", rows=4, clock=clock, max_batch=4,
                          deadline=clock.now())
        task = asyncio.ensure_future(rex.run(broken, XS[:4], ctx=ctx))
        out = await settle(clock, task)
        assert isinstance(out, RowOutcomes) and len(out.errors) == 4
        assert all(collateral is True
                   for _, collateral in out.errors.values())
    run(body())


# -- circuit breaker ------------------------------------------------------

def test_breaker_state_machine_closed_open_halfopen_closed():
    seen = []
    br = CircuitBreaker(BreakerPolicy(failure_threshold=2,
                                      recovery_s=0.05,
                                      probe_successes=1),
                        on_transition=lambda old, new: seen.append(
                            (old, new)))
    assert br.allow(0.0) and br.state == "closed"
    br.record_failure(0.0)
    assert br.state == "closed"          # below threshold
    br.record_failure(0.001)
    assert br.state == "open"            # threshold hit
    assert not br.allow(0.02)            # recovery window not elapsed
    assert br.allow(0.06)                # half-open: probe slot claimed
    assert br.state == "half_open"
    assert not br.allow(0.06)            # probes serialize: one at a time
    br.record_success(0.06)
    assert br.state == "closed"
    assert seen == [("closed", "open"), ("open", "half_open"),
                    ("half_open", "closed")]


def test_breaker_failed_probe_reopens_and_restarts_recovery():
    br = CircuitBreaker(BreakerPolicy(failure_threshold=1,
                                      recovery_s=0.05))
    br.record_failure(0.0)
    assert br.state == "open"
    assert br.allow(0.06) and br.state == "half_open"
    br.record_failure(0.06)              # probe failed
    assert br.state == "open"
    assert not br.allow(0.10)            # recovery clock restarted at 0.06
    assert br.allow(0.12)


def test_breaker_opens_skips_route_then_probe_recovers_end_to_end():
    async def body():
        clock = FakeClock()
        metrics = ModelMetrics(now=clock.now())
        inj = FaultInjector(persistent_routes={"kernels"})
        rex = ResilientExecutor(
            inj.wrap(InlineExecutor()),
            retry=RetryPolicy(max_attempts=1),
            breaker=BreakerPolicy(failure_threshold=1, recovery_s=0.05))

        def ctx():
            return DispatchCtx(name="m", rows=8, clock=clock,
                               metrics=metrics,
                               routes=("kernels", "compiled"),
                               infer_routed=lambda xs, route=None:
                                   plus_one(xs))

        # flush 1: kernels fails -> served degraded; breaker opens (one
        # failure sample per flush, threshold 1)
        task = asyncio.ensure_future(rex.run(plus_one, XS, ctx=ctx()))
        assert np.array_equal(await settle(clock, task, 0.001), XS + 1)
        assert metrics.breaker_states["kernels"] == "open"
        assert metrics.degraded_by_route["compiled"] == 8
        fired = inj.by_kind["persistent"]

        # flush 2 (inside recovery window): kernels skipped WITHOUT a
        # dispatch — no new injected persistent fault
        task = asyncio.ensure_future(rex.run(plus_one, XS, ctx=ctx()))
        assert np.array_equal(await settle(clock, task, 0.001), XS + 1)
        assert inj.by_kind["persistent"] == fired
        assert metrics.degraded_rows == 16

        # route heals; after recovery_s the half-open probe closes it
        inj.heal_route("kernels")
        await clock.advance(0.06)
        task = asyncio.ensure_future(rex.run(plus_one, XS, ctx=ctx()))
        assert np.array_equal(await settle(clock, task, 0.001), XS + 1)
        assert metrics.breaker_states["kernels"] == "closed"
        assert metrics.degraded_rows == 16  # probe served on primary
        assert metrics.breaker_transitions == 3  # open, half_open, closed
    run(body())


# -- poison-batch bisection ----------------------------------------------

def test_bisection_isolates_poison_survivors_bit_exact():
    async def body():
        clock = FakeClock()
        bad = 5
        inj = FaultInjector(poison=lambda row: int(row[0]) == bad)
        rex = ResilientExecutor(inj.wrap(InlineExecutor()),
                                retry=RetryPolicy(max_attempts=1))
        task = asyncio.ensure_future(rex.run(
            plus_one, XS, ctx=DispatchCtx(name="m", rows=8, clock=clock,
                                          max_batch=8)))
        out = await settle(clock, task)
        assert isinstance(out, RowOutcomes)
        assert set(out.errors) == {bad}
        err, collateral = out.errors[bad]
        assert collateral is False and isinstance(err, FlushError)
        assert err.collateral is False and err.rows == 1
        expected = XS + 1
        for i in range(8):
            if i != bad:
                assert np.array_equal(out.ys[i], expected[i])
    run(body())


def test_scheduler_distributes_bisected_outcomes_with_collateral_counts():
    async def body():
        clock = FakeClock()
        bad = 2
        inj = FaultInjector(poison=lambda row: int(row[0]) == bad)
        rex = ResilientExecutor(inj.wrap(InlineExecutor()),
                                retry=RetryPolicy(max_attempts=1))
        b = MicroBatcher(plus_one, name="m", clock=clock, max_batch=4,
                         max_delay_s=0.001, max_queue=16, executor=rex)
        async with b:
            futs = [b.submit(np.int64([i])) for i in range(4)]
            await clock.advance(0.5)
            for _ in range(5):  # bisection is several task hops deep
                await clock.drain()
            for i, f in enumerate(futs):
                if i == bad:
                    with pytest.raises(FlushError) as ei:
                        f.result()
                    assert ei.value.collateral is False
                else:
                    assert np.array_equal(f.result(), np.int64([i + 1]))
            snap = b.metrics.snapshot(clock.now())
            assert snap["completed"] == 3 and snap["failed"] == 1
            assert snap["collateral"] == 0  # the poison row is not
            #                                 collateral — it failed alone
            assert snap["inflight"] == 0
    run(body())


# -- per-dispatch timeouts -----------------------------------------------

def test_timeout_budget_splits_deadline_across_attempts():
    async def body():
        clock = FakeClock()
        metrics = ModelMetrics(now=clock.now())
        inj = FaultInjector(spike_s=1.0)   # a spike far past any budget
        inj.fail_next("spike")
        rex = ResilientExecutor(inj.wrap(InlineExecutor()),
                                retry=RetryPolicy(max_attempts=2,
                                                  base_s=0.001,
                                                  jitter=0.0))
        deadline = clock.now() + 0.040
        task = asyncio.ensure_future(rex.run(
            plus_one, XS, ctx=DispatchCtx(name="m", rows=8, clock=clock,
                                          metrics=metrics,
                                          deadline=deadline)))
        await clock.drain()
        # the hung attempt times out at HALF the budget (0.020), leaving
        # room for the retry to land BEFORE the deadline: done by 0.039
        await clock.advance(0.039)
        assert task.done()
        assert np.array_equal(task.result(), XS + 1)
        assert metrics.retries == 1
        assert clock.now() <= deadline + 1e-9
    run(body())


def test_timeout_alone_fails_with_dispatch_timeout():
    async def body():
        clock = FakeClock()
        inj = FaultInjector(spike_s=1.0)
        inj.fail_next("spike", times=2)   # both attempts hang
        rex = ResilientExecutor(inj.wrap(InlineExecutor()),
                                retry=RetryPolicy(max_attempts=2,
                                                  base_s=0.001,
                                                  jitter=0.0))
        ctx = DispatchCtx(name="m", rows=1, clock=clock,
                          deadline=clock.now() + 0.020)
        task = asyncio.ensure_future(rex.run(plus_one, XS[:1], ctx=ctx))
        out = await settle(clock, task)
        assert isinstance(out, RowOutcomes)
        (err, _), = out.errors.values()
        assert isinstance(err, FlushError)
        assert isinstance(err.cause, DispatchTimeoutError)
    run(body())


# -- wall deadline expiry (scheduler) -------------------------------------

def test_pending_request_expires_at_wall_deadline():
    async def body():
        clock = FakeClock()
        b = MicroBatcher(plus_one, name="m", clock=clock, max_batch=64,
                         max_delay_s=10.0, max_queue=64,
                         classes={"rt": ClassPolicy(priority=1,
                                                    slo_s=0.005)})
        async with b:
            doomed = b.submit(np.int64([1]), cls="rt")
            await clock.advance(0.010)  # wall (slo_s) passes, delay hasn't
            assert doomed.done()
            with pytest.raises(DeadlineExceededError) as ei:
                doomed.result()
            assert isinstance(ei.value, QueueFullError)  # shed taxonomy
            snap = b.metrics.snapshot(clock.now())
            assert snap["deadline_exceeded"] == 1
            assert snap["cancelled"] == 0 and snap["failed"] == 0
            assert snap["classes"]["rt"]["deadline_exceeded"] == 1
            assert snap["inflight"] == 0
    run(body())


def test_explicit_wall_deadline_overrides_class_slo():
    async def body():
        clock = FakeClock()
        b = MicroBatcher(plus_one, name="m", clock=clock, max_batch=64,
                         max_delay_s=10.0, max_queue=64,
                         classes={"rt": ClassPolicy(slo_s=0.005)})
        async with b:
            # a laxer explicit wall outlives the class SLO default
            f = b.submit(np.int64([3]), cls="rt", wall_deadline_s=0.050)
            await clock.advance(0.010)
            assert not f.done()
            await clock.advance(0.100)
            with pytest.raises(DeadlineExceededError):
                f.result()
    run(body())


def test_request_without_slo_never_expires():
    async def body():
        clock = FakeClock()
        b = MicroBatcher(plus_one, name="m", clock=clock, max_batch=4,
                         max_delay_s=0.002, max_queue=8)
        async with b:
            f = b.submit(np.int64([2]))  # default class: no slo_s
            await clock.advance(0.010)
            assert np.array_equal(f.result(), np.int64([3]))
    run(body())


# -- output-validity guard ------------------------------------------------

@pytest.fixture(scope="module")
def sine_model():
    rng = np.random.default_rng(0)
    qg = quantize_graph(
        build_sine(),
        [rng.uniform(0, 2 * np.pi, (1, 1)).astype("f") for _ in range(8)], device="cpu")
    return CompiledModel(qg, device="cpu")


def test_output_guard_enforces_static_contract(sine_model):
    guard = make_output_guard(sine_model.exec_plan)
    xq = np.zeros((4, 1, 1), np.int8)
    ys = np.asarray(sine_model.predict_q_many(xq, max_batch=4))
    guard(ys, 4, "sine")  # real outputs pass
    with pytest.raises(InvalidOutputError, match="shape"):
        guard(ys, 8, "sine")
    with pytest.raises(InvalidOutputError, match="dtype"):
        guard(ys.astype(np.int32), 4, "sine")
    # NaN corruption arrives as float32 garbage: the dtype check catches
    # it before the finiteness check even runs (int8 plan output)
    with pytest.raises(InvalidOutputError, match="dtype"):
        guard(np.full(ys.shape, np.nan, np.float32), 4, "sine")


# -- route degradation parity (bit-exact, real model) ---------------------

def test_routes_are_bit_identical(sine_model):
    rng = np.random.default_rng(1)
    qp = sine_model.graph.tensor(sine_model.graph.inputs[0]).qparams
    xq = np.asarray(qp.quantize(
        rng.uniform(0, 2 * np.pi, (6, 1, 1)).astype("f")))
    primary = np.asarray(sine_model.predict_q_many(xq, max_batch=4))
    for route in sine_model.routes():
        ys = np.asarray(sine_model.predict_q_routed(xq, route=route,
                                                    max_batch=4))
        assert ys.dtype == primary.dtype
        assert np.array_equal(ys, primary), route


def test_degraded_serving_bit_identical_to_reference(sine_model):
    """Break the primary route: every request is served off the
    degradation chain, and the answers are bit-identical to both the
    primary route AND the numpy reference interpreter."""
    async def body():
        clock = FakeClock()
        primary = sine_model.routes()[0]
        inj = FaultInjector(persistent_routes={primary})
        rex = ResilientExecutor(inj.wrap(InlineExecutor()),
                                retry=RetryPolicy(max_attempts=1))
        b = MicroBatcher.for_model(sine_model, name="sine", max_batch=4,
                                   max_delay_s=0.001, max_queue=32,
                                   clock=clock, executor=rex,
                                   metrics=ModelMetrics(now=clock.now()))
        qp = sine_model.graph.tensor(sine_model.graph.inputs[0]).qparams
        rng = np.random.default_rng(7)
        xs = [np.asarray(qp.quantize(
            rng.uniform(0, 2 * np.pi, (1, 1)).astype("f")))
            for _ in range(4)]
        async with b:
            futs = [b.submit(x) for x in xs]
            await clock.advance(0.5)
            rows = [f.result() for f in futs]
        stacked = np.stack(xs)
        want_primary = np.asarray(sine_model.predict_q_many(stacked,
                                                            max_batch=4))
        want_ref = np.asarray(sine_model.predict_q_routed(
            stacked, route="reference"))
        got = np.stack(rows)
        assert np.array_equal(want_primary, want_ref)
        assert np.array_equal(got, want_ref)  # degraded == reference, bit
        #                                       for bit
        assert b.metrics.degraded_rows == 4
        assert inj.by_kind["persistent"] >= 1
    run(body())
