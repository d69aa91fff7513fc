"""Tests for the zero-allocation dispatch hot path (dispatch teardown).

The port's copy of ``tests/test_dispatch_fastpath.py``: the same invariants, held on
``repro_torch.serve`` / ``repro_torch.obs`` over the port's
``CompiledModel(device="cpu")``.

Pins the four fast paths the scheduler-admission→device-dispatch rework
introduced, all deterministically:

* **Batched future resolution** — a detached executor delivers a finished
  flush as ONE event-loop callback; every row future of the flush is
  already resolved by the time any future done-callback observes it, and
  the exactly-one-terminal metric accounting still balances.
* **Slot-pooled request records** — a 1k-request storm allocates no more
  ``_Request`` records than ``max_queue``; retired records are reused.
* **FIFO flush assembly** — single-class traffic never touches the EDF
  heap; a deadline-undercutting arrival spills to the heap and EDF order
  is preserved; the legacy lane (``fast_path=False``) serves identical
  results.
* **Prestaged assembly buffers** — ``CompiledModel.staged_infer`` is
  bit-identical to ``predict_q_many`` on the stacked rows, and after
  ``warmup_batched`` the staging pool never grows on the hot path.
"""
import asyncio

import numpy as np

from repro_torch.core import CompiledModel
from repro_torch.core.quantize import quantize_graph
from repro_torch.configs.paper_models import build_sine
from repro_torch.serve.executor import (InferenceExecutor,
                                  ThreadPoolExecutorBackend)
from repro_torch.serve.metrics import ModelMetrics
from repro_torch.serve.scheduler import ClassPolicy, FakeClock, MicroBatcher


def run(coro):
    return asyncio.run(coro)


def make_batcher(infer, clock, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_delay_s", 0.010)
    kw.setdefault("max_queue", 8)
    return MicroBatcher(infer, name="echo", clock=clock,
                        metrics=ModelMetrics(now=clock.now()), **kw)


class LoopbackDetachedExecutor(InferenceExecutor):
    """Detached executor without threads: ``submit_flush`` computes the
    result synchronously and schedules ``done`` as one ``call_soon`` loop
    callback — the delivery shape of ``ThreadPoolExecutorBackend``'s
    ``call_soon_threadsafe``, minus the worker thread, so FakeClock tests
    stay exact."""

    inline = False
    detached = True

    def __init__(self):
        self.flushes = 0
        self.callbacks = 0

    def submit_flush(self, infer, xs, ctx, done):
        self.flushes += 1
        res, err = None, None
        try:
            res = infer(xs)
        except Exception as e:
            err = e

        def deliver():
            self.callbacks += 1
            done(res, err)

        asyncio.get_running_loop().call_soon(deliver)


def _sine_model():
    rng = np.random.default_rng(0)
    qg = quantize_graph(build_sine(),
                        [rng.uniform(0, 2 * np.pi, (1, 1)).astype("f")
                         for _ in range(8)], device="cpu")
    cm = CompiledModel(qg, device="cpu")
    qp = qg.tensor(qg.inputs[0]).qparams
    qxs = [np.asarray(qp.quantize(
        rng.uniform(0, 2 * np.pi, (1, 1)).astype("f"))) for _ in range(64)]
    return cm, qxs


# ------------------------------------------- batched future resolution --

def test_detached_flush_resolves_all_rows_in_one_callback():
    """All row futures of a detached flush resolve inside ONE loop
    callback: by the time any future's done-callback runs, every future
    of the flush is already done (set_result happened for all of them
    before the loop ran any callback)."""
    async def body():
        clock = FakeClock()
        ex = LoopbackDetachedExecutor()
        b = make_batcher(lambda xs: xs * 2, clock, executor=ex)
        seen = []
        async with b:
            futs = [b.submit(np.array([float(i)])) for i in range(4)]
            for f in futs:
                f.add_done_callback(
                    lambda _f, futs=futs: seen.append(
                        sum(x.done() for x in futs)))
            await clock.drain()
            ys = [await f for f in futs]
        # one flush (bucket-full at max_batch=4), one delivery callback
        assert ex.flushes == 1 and ex.callbacks == 1
        # every done-callback observed ALL futures already resolved
        assert seen == [4, 4, 4, 4]
        for i, y in enumerate(ys):
            assert np.array_equal(y, np.array([2.0 * i]))
        snap = b.metrics.snapshot(clock.now())
        assert snap["submitted"] == 4 and snap["completed"] == 4
        assert b.in_flight_rows == 0
    run(body())


def test_detached_failure_is_one_callback_and_balances():
    async def body():
        clock = FakeClock()
        ex = LoopbackDetachedExecutor()

        def boom(xs):
            raise RuntimeError("poison")

        b = make_batcher(boom, clock, executor=ex)
        async with b:
            futs = [b.submit(np.array([1.0])) for _ in range(4)]
            await clock.drain()
            for f in futs:
                assert isinstance(f.exception(), Exception)
        assert ex.callbacks == 1
        snap = b.metrics.snapshot(clock.now())
        assert snap["submitted"] == 4 and snap["failed"] == 4
        assert snap["completed"] == 0 and b.in_flight_rows == 0
    run(body())


def test_threadpool_detached_bit_identical_to_inline():
    """The real thread-pool detached path returns rows bit-identical to
    the inline path, retires in_flight accounting, and every admitted
    request reaches exactly one terminal state."""
    cm, qxs = _sine_model()
    n = 24

    async def serve(executor):
        clock = FakeClock() if executor is None else None
        from repro_torch.serve.scheduler import Clock
        b = MicroBatcher.for_model(
            cm, name="sine", max_batch=8, max_delay_s=0.002, max_queue=64,
            clock=clock or Clock(),
            metrics=ModelMetrics(), executor=executor)
        async with b:
            futs = [b.submit(qxs[i]) for i in range(n)]
            if clock is not None:
                await clock.drain()
                await clock.advance(0.5)
            ys = [np.asarray(await f) for f in futs]
        snap = b.metrics.snapshot(0.0)
        assert snap["submitted"] == n and snap["completed"] == n
        assert b.in_flight_rows == 0
        return ys

    inline_ys = run(serve(None))
    pool = ThreadPoolExecutorBackend(max_workers=2)
    try:
        detached_ys = run(serve(pool))
    finally:
        pool.close()
    for a, b_ in zip(inline_ys, detached_ys):
        assert np.array_equal(a, b_)


# --------------------------------------------------- slot-pooled records --

def test_slot_pool_no_growth_across_1k_storm():
    async def body():
        clock = FakeClock()
        b = make_batcher(lambda xs: xs * 2, clock, max_queue=16)
        async with b:
            done = 0
            for _wave in range(125):  # 125 waves * 8 = 1000 requests
                futs = [b.submit(np.array([1.0])) for _ in range(8)]
                await clock.advance(0.011)
                done += sum(f.done() and f.exception() is None for f in futs)
        snap = b.metrics.snapshot(clock.now())
        assert snap["completed"] == 1000 and done == 1000
        # the storm allocated at most max_queue records, ever — everything
        # else was served from the slot pool
        assert b.pool_created <= 16, b.pool_created
        assert b.pool_reused >= 1000 - 16, b.pool_reused
    run(body())


def test_pool_disabled_on_legacy_lane():
    async def body():
        clock = FakeClock()
        b = make_batcher(lambda xs: xs * 2, clock, fast_path=False)
        async with b:
            for _ in range(3):
                futs = [b.submit(np.array([1.0])) for _ in range(4)]
                await clock.advance(0.011)
                assert all(f.done() for f in futs)
        assert b.pool_created == 12 and b.pool_reused == 0
    run(body())


# ------------------------------------------------------ FIFO fast path --

def test_single_class_traffic_never_touches_heap():
    async def body():
        clock = FakeClock()
        b = make_batcher(lambda xs: xs * 2, clock)
        async with b:
            for _ in range(5):
                futs = [b.submit(np.array([1.0])) for _ in range(4)]
                assert not b._heap  # FIFO fast path holds
                await clock.advance(0.011)
                assert all(f.done() for f in futs)
    run(body())


def test_deadline_undercut_spills_to_heap_and_keeps_edf_order():
    """An interactive arrival with a shorter deadline than the FIFO tail
    spills pending work into the EDF heap; the flush drains most-urgent
    first, exactly as the pure-heap scheduler did."""
    async def body():
        record = []

        def infer(xs):
            record.append([float(v) for v in np.asarray(xs)[:, 0]])
            return xs

        clock = FakeClock()
        classes = {"batch": ClassPolicy(priority=0, max_delay_s=0.050),
                   "inter": ClassPolicy(priority=1, max_delay_s=0.001)}
        b = make_batcher(infer, clock, max_batch=2, classes=classes)
        async with b:
            b.submit(np.array([1.0]), cls="batch")
            b.submit(np.array([2.0]), cls="batch")
            assert not b._heap and len(b._fifo) == 2
            b.submit(np.array([9.0]), cls="inter")  # undercuts the tail
            assert b._heap and not b._fifo
            await clock.advance(0.002)   # interactive deadline fires
            # EDF: the interactive row leads the first flush
            assert record[0][0] == 9.0
            await clock.advance(0.060)
        assert sorted(v for fl in record for v in fl) == [1.0, 2.0, 9.0]
        # backlog drained -> FIFO mode resumes for fresh arrivals
        assert not b._heap
    run(body())


def test_fast_and_legacy_lanes_serve_identical_rows():
    cm, qxs = _sine_model()
    n = 13

    async def serve(fast):
        clock = FakeClock()
        b = MicroBatcher.for_model(
            cm, name="sine", max_batch=4, max_delay_s=0.010, max_queue=32,
            clock=clock, metrics=ModelMetrics(now=clock.now()),
            fast_path=fast)
        async with b:
            futs = [b.submit(qxs[i]) for i in range(n)]
            await clock.advance(0.5)
            return [np.asarray(await f) for f in futs]

    fast_ys = run(serve(True))
    legacy_ys = run(serve(False))
    for a, b_ in zip(fast_ys, legacy_ys):
        assert np.array_equal(a, b_)


# -------------------------------------------- prestaged assembly buffers --

def test_staged_infer_bit_identical_and_pool_stable():
    cm, qxs = _sine_model()
    cm.warmup_batched(8)
    created_after_warmup = cm.staging_events
    rng = np.random.default_rng(3)
    for size in (1, 2, 3, 5, 8, 7, 4, 8, 1):
        rows = [qxs[int(i)] for i in rng.integers(0, len(qxs), size)]
        got = np.asarray(cm.staged_infer(list(rows)))
        ref = np.asarray(cm.predict_q_many(np.stack(rows), max_batch=8))
        assert np.array_equal(got, ref)
    # warmed pool served every flush: no staging allocation on the hot path
    assert cm.staging_events == created_after_warmup


def test_staged_infer_rejects_bad_row_and_buffer_stays_clean():
    cm, qxs = _sine_model()
    cm.warmup_batched(4)
    try:
        cm.staged_infer([qxs[0], np.zeros((3, 7))])  # malformed row
        raise AssertionError("expected a shape error")
    except Exception:
        pass
    # the poisoned checkout was re-zeroed on release: next flush is clean
    got = np.asarray(cm.staged_infer([qxs[0], qxs[1]]))
    ref = np.asarray(cm.predict_q_many(np.stack([qxs[0], qxs[1]]),
                                       max_batch=4))
    assert np.array_equal(got, ref)
