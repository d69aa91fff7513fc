"""Tests for the dispatch stage of the serving pipeline: executor

The port's copy of ``tests/test_serve_executor.py``: the same invariants, held on
``repro_torch.serve`` / ``repro_torch.obs`` over the port's
``CompiledModel(device="cpu")``.
backends, the joint ``pending + in_flight`` admission bound, and
thread-safety of the engine's bucket executables under concurrent
``predict_q_many``.

Off-loop tests use real threads but stay deterministic by gating the
worker on ``threading.Event`` — control flow is event-driven, never
timing-driven (the only real sleeps are bounded awaits on futures that
are already guaranteed to resolve).
"""
import asyncio
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from repro_torch.core import CompiledModel
from repro_torch.core.quantize import quantize_graph
from repro_torch.configs.paper_models import build_sine
from repro_torch.serve.executor import InlineExecutor, ThreadPoolExecutorBackend
from repro_torch.serve.metrics import ModelMetrics
from repro_torch.serve.registry import ServingRegistry
from repro_torch.serve.scheduler import (ClassPolicy, MicroBatcher,
                                   PreemptedError, QueueFullError)


def run(coro):
    return asyncio.run(coro)


@pytest.fixture(scope="module")
def sine_model():
    rng = np.random.default_rng(0)
    qg = quantize_graph(
        build_sine(),
        [rng.uniform(0, 2 * np.pi, (1, 1)).astype("f") for _ in range(8)], device="cpu")
    return CompiledModel(qg, device="cpu")


def _sine_inputs(model, n, seed=3):
    qp = model.graph.tensor(model.graph.inputs[0]).qparams
    rng = np.random.default_rng(seed)
    return [np.asarray(qp.quantize(
        rng.uniform(0, 2 * np.pi, (1, 1)).astype("f"))) for _ in range(n)]


# ------------------------------------------------------------- executors --

def test_inline_is_default_and_threadpool_lifecycle():
    b = MicroBatcher(lambda xs: xs, name="x")
    assert isinstance(b.executor, InlineExecutor) and b.executor.inline

    ex = ThreadPoolExecutorBackend(max_workers=3)
    assert not ex.inline and ex.max_workers == 3
    assert ex._pool is None  # lazy: constructing a backend costs nothing

    async def body():
        assert np.array_equal(await ex.run(lambda xs: xs * 2,
                                           np.float32([1, 2])),
                              np.float32([2, 4]))
    run(body())
    ex.close()
    ex.close()  # idempotent

    async def after_close():
        with pytest.raises(RuntimeError, match="closed"):
            await ex.run(lambda xs: xs, np.float32([0]))
    run(after_close())


def test_offloop_rows_bit_identical_to_inline(sine_model):
    """The executor changes WHERE a flush runs, never WHAT it computes:
    off-loop served rows are bit-identical to direct predict_q."""
    xs = _sine_inputs(sine_model, 6)
    ex = ThreadPoolExecutorBackend(max_workers=2)

    async def body():
        b = MicroBatcher.for_model(sine_model, name="sine", max_batch=4,
                                   max_delay_s=0.001, max_queue=32,
                                   executor=ex)
        async with b:
            ys = await asyncio.gather(*(b.infer(x) for x in xs))
        for x, y in zip(xs, ys):
            direct = np.asarray(sine_model.predict_q(x[None]))[0]
            assert np.array_equal(np.asarray(y), direct)
    run(body())
    ex.close()


def test_offloop_pipelines_arrivals_while_batch_in_flight():
    """The tentpole behavior: while a batch is on the executor, the event
    loop keeps admitting — arrivals coalesce into the NEXT batch instead
    of serializing behind the device call."""
    release = threading.Event()
    started = threading.Event()
    batches = []

    def infer(xs):
        started.set()
        assert release.wait(10), "test deadlock: release never set"
        batches.append(xs.shape[0])
        return xs * 2

    ex = ThreadPoolExecutorBackend(max_workers=1)

    async def body():
        b = MicroBatcher(infer, name="pipe", max_batch=2, max_delay_s=0.2,
                         max_queue=16, executor=ex)
        async with b:
            first = [b.submit(np.float32([i])) for i in range(2)]
            # bucket-full flush dispatches off-loop; the worker is now
            # blocked inside infer, but the LOOP is free:
            await asyncio.get_running_loop().run_in_executor(
                None, started.wait, 10)
            assert b.in_flight_rows == 2
            # arrivals while in flight: admitted and coalesced as pending
            second = [b.submit(np.float32([10 + i])) for i in range(2)]
            assert len(b) == 0 or len(b) == 2  # second pair pending or
            release.set()                      # already dispatched
            ys = await asyncio.gather(*(first + second))
            assert [float(y[0]) for y in ys] == [0.0, 2.0, 20.0, 22.0]
            assert batches[0] == 2  # first batch never saw the late pair
            assert b.in_flight_rows == 0
            snap = b.metrics.snapshot(b.clock.now())
            assert snap["inflight_rows"] == 0 and snap["completed"] == 4
    run(body())
    ex.close()


def test_joint_bound_pending_plus_inflight_and_shed_priority():
    """Admission bounds pending + in-flight rows jointly (the static-memory
    guarantee covers rows on device too), in-flight rows are never
    preempted, and shed-by-priority only evicts PENDING requests."""
    release = threading.Event()
    dispatched = threading.Event()

    def infer(xs):
        dispatched.set()
        assert release.wait(10), "test deadlock"
        return xs * 2

    classes = {"interactive": ClassPolicy(priority=1, max_delay_s=0.005),
               "batch": ClassPolicy(priority=0, max_delay_s=10.0)}
    ex = ThreadPoolExecutorBackend(max_workers=1)

    async def body():
        b = MicroBatcher(infer, name="bound", max_batch=4, max_queue=6,
                         max_delay_s=10.0, classes=classes, executor=ex)
        async with b:
            flight = [b.submit(np.float32([i])) for i in range(4)]  # flush
            await asyncio.get_running_loop().run_in_executor(
                None, dispatched.wait, 10)
            assert b.in_flight_rows == 4 and len(b) == 0
            pend = [b.submit(np.float32([10 + i]), cls="batch")
                    for i in range(2)]
            assert len(b) == 2  # 4 in flight + 2 pending == max_queue
            # joint bound: queue "looks" short but admission still refuses
            with pytest.raises(QueueFullError):
                b.submit(np.float32([99]), cls="batch")
            # a higher-priority newcomer evicts a PENDING batch request —
            # never an in-flight row (that memory is already committed)
            hi = b.submit(np.float32([50]), cls="interactive")
            assert b.in_flight_rows == 4 and len(b) == 2
            assert sum(f.done() for f in pend) == 1
            assert b.metrics.preempted == 1
            release.set()
            ys = await asyncio.gather(*flight)
            assert [float(y[0]) for y in ys] == [0.0, 2.0, 4.0, 6.0]
            assert np.array_equal(await hi, np.float32([100]))
    run(body())
    ex.close()


def test_registry_shared_executor_across_models(sine_model):
    """One ThreadPoolExecutorBackend carries every model's flushes; the
    registry closes it on stop()."""
    ex = ThreadPoolExecutorBackend(max_workers=2)
    record = []

    class _FakeModel:
        def predict_q_many(self, xs, max_batch=None):
            record.append(np.asarray(xs).shape[0])
            return np.asarray(xs) * 2

    async def body():
        reg = ServingRegistry(max_batch=4, max_delay_s=0.001, executor=ex)
        reg.register("sine", sine_model)
        reg.register("echo", _FakeModel(), warmup=False)
        assert reg._entries["sine"].batcher.executor is ex
        assert reg._entries["echo"].batcher.executor is ex
        async with reg:
            x = reg.quantize_input("sine", np.float32([1.0]))
            ys = await asyncio.gather(reg.infer("sine", x),
                                      reg.infer("echo", np.float32([3])))
            assert np.array_equal(ys[1], np.float32([6]))
            direct = np.asarray(sine_model.predict_q(x[None]))[0]
            assert np.array_equal(np.asarray(ys[0]), direct)
    run(body())
    assert ex._closed  # registry stop() owns the shared executor
    with pytest.raises(RuntimeError):
        run(ex.run(lambda xs: xs, np.float32([0])))


def test_registry_class_and_executor_pass_through(sine_model):
    classes = {"interactive": ClassPolicy(priority=1, max_delay_s=0.001,
                                          slo_s=0.05)}

    async def body():
        reg = ServingRegistry(max_batch=2, max_delay_s=0.2, classes=classes)
        reg.register("sine", sine_model)
        async with reg:
            x = reg.quantize_input("sine", np.float32([0.5]))
            y = await reg.infer("sine", x, cls="interactive")
            assert y is not None
            with pytest.raises(KeyError, match="unknown priority class"):
                reg.submit("sine", x, cls="nope")
        snap = reg.snapshot()["sine"]
        assert snap["classes"]["interactive"]["completed"] == 1
        assert snap["classes"]["interactive"]["slo_attainment"] is not None
    run(body())


# ------------------------------------------- engine cache thread-safety --

@pytest.mark.parametrize("warm", [True, False])
def test_concurrent_predict_q_many_bit_exact(warm):
    """Hammer ONE CompiledModel with concurrent predict_q_many calls from
    many threads: rows must be bit-exact vs serial, for a pre-warmed model
    (lock-free hot path) AND a cold one (compile-on-miss races resolve to
    one compile per bucket under the lock)."""
    rng = np.random.default_rng(7)
    qg = quantize_graph(
        build_sine(),
        [rng.uniform(0, 2 * np.pi, (1, 1)).astype("f") for _ in range(8)], device="cpu")
    cm = CompiledModel(qg, device="cpu")
    if warm:
        cm.warmup_batched(8)
    qp = qg.tensor(qg.inputs[0]).qparams
    jobs = []
    for i in range(24):  # mixed batch sizes -> mixed buckets, incl. chunking
        n = 1 + (i % 7)
        jobs.append(np.asarray(qp.quantize(
            rng.uniform(0, 2 * np.pi, (n, 1, 1)).astype("f"))))

    def call(qx):
        return np.asarray(cm.predict_q_many(qx, max_batch=8))

    with ThreadPoolExecutor(max_workers=8) as pool:
        got = list(pool.map(call, jobs))
    for qx, y in zip(jobs, got):  # serial reference AFTER the storm
        assert np.array_equal(y, np.asarray(
            cm.predict_q_many(qx, max_batch=8)))
    assert set(cm.bucket_sizes()) == {1, 2, 4, 8}


def test_concurrent_warmup_and_compile_single_instance():
    """Racing warmup_batched + compile() from threads never double-fills a
    cache slot: one per-call executable, every bucket maps to exactly one
    executable object, each built once."""
    rng = np.random.default_rng(8)
    qg = quantize_graph(
        build_sine(),
        [rng.uniform(0, 2 * np.pi, (1, 1)).astype("f") for _ in range(8)], device="cpu")
    cm = CompiledModel(qg, device="cpu")
    with ThreadPoolExecutor(max_workers=4) as pool:
        list(pool.map(lambda _: cm.warmup_batched(4), range(4)))
        aots = list(pool.map(lambda _: cm.compile(), range(4)))
    assert all(a is aots[0] for a in aots)  # one per-call executable
    exes = [cm.compile_batched(b) for b in (1, 2, 4)]
    assert len({id(e) for e in exes}) == 3  # one executable per bucket
    assert cm.compile_events == 4
    assert [(e["kind"], e.get("bucket")) for e in cm.compile_log] == [
        ("bucket", 1), ("bucket", 2), ("bucket", 4), ("percall", None)]


# -------------------------------------------------- close idempotence --

def test_executor_close_idempotent_and_terminal():
    ex = ThreadPoolExecutorBackend(max_workers=1)
    assert not ex.closed
    ex.close()
    ex.close()  # second close: no raise, no pool to re-shutdown
    assert ex.closed

    async def body():
        with pytest.raises(RuntimeError):
            await ex.run(lambda xs: xs, np.float32([1]))
    run(body())
    # InlineExecutor has nothing to release: close is a no-op and
    # ``closed`` stays False ("nothing to release" != "released")
    inline = InlineExecutor()
    inline.close()
    inline.close()
    assert not inline.closed


def test_batcher_close_races_are_single_effect():
    """Two closes racing each other — one with rows still on the
    executor — must award the drain to exactly one closer: no request is
    cancelled twice, no metric double-counts, and every admitted request
    ends in exactly one terminal state."""
    release = threading.Event()
    started = threading.Event()

    def infer(xs):
        started.set()
        assert release.wait(10), "test deadlock: release never set"
        return xs * 2

    ex = ThreadPoolExecutorBackend(max_workers=1)

    async def body():
        b = MicroBatcher(infer, name="race", max_batch=2, max_delay_s=10.0,
                         max_queue=8, executor=ex)
        b.start()
        flight = [b.submit(np.float32([i])) for i in range(2)]  # dispatches
        await asyncio.get_running_loop().run_in_executor(
            None, started.wait, 10)
        assert b.in_flight_rows == 2
        pending = b.submit(np.float32([7]))  # coalesced behind the flight
        release.set()
        await asyncio.gather(b.close(), b.close())  # concurrent closers
        assert b.closed
        await b.close()  # and a third, after the fact
        ys = [np.asarray(await f) for f in flight]
        assert [float(y[0]) for y in ys] == [0.0, 2.0]
        assert float(np.asarray(await pending)[0]) == 14.0
        m = b.metrics
        assert m.submitted == 3 and m.completed == 3
        assert m.cancelled == 0 and m.failed == 0 and m.preempted == 0
        assert m.inflight_rows == 0 and b.in_flight_rows == 0
    run(body())
    ex.close()


def test_batcher_close_no_drain_counts_each_pending_once():
    async def body():
        b = MicroBatcher(lambda xs: xs, name="nodrain", max_batch=8,
                         max_delay_s=10.0, max_queue=8)
        b.start()
        futs = [b.submit(np.float32([i])) for i in range(3)]
        await asyncio.gather(b.close(drain=False), b.close(drain=False))
        assert all(f.cancelled() for f in futs)
        m = b.metrics
        assert m.submitted == 3 and m.cancelled == 3 and m.completed == 0
        assert m.submitted == m.completed + m.cancelled + m.failed \
            + m.preempted
    run(body())


def test_registry_stop_idempotent(sine_model):
    ex = ThreadPoolExecutorBackend(max_workers=1)

    async def body():
        reg = ServingRegistry(executor=ex)
        reg.register("sine", sine_model, max_batch=2, max_delay_s=0.5)
        reg.start()
        assert not reg.stopped
        [y] = await asyncio.gather(
            reg.submit("sine", _sine_inputs(sine_model, 1)[0]))
        assert np.asarray(y).shape[0] == 1
        await asyncio.gather(reg.stop(), reg.stop())  # racing stops
        assert reg.stopped and ex.closed
        await reg.stop()  # terminal: returns immediately, nothing re-closed
        with pytest.raises(RuntimeError):
            await reg.submit("sine", _sine_inputs(sine_model, 1)[0])
        m = reg.metrics("sine")
        assert m.submitted == m.completed + m.cancelled + m.failed \
            + m.preempted
    run(body())
