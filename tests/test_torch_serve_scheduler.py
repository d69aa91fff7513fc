"""Deterministic tests for the dynamic-batching serving subsystem.

The port's copy of ``tests/test_serve_scheduler.py``: the same invariants, held on
``repro_torch.serve`` / ``repro_torch.obs`` over the port's
``CompiledModel(device="cpu")``.

Every scheduler test runs under ``FakeClock``: virtual time only, zero real
sleeps, so bucket-fill flushes, deadline flushes, and backpressure are
pinned exactly (not statistically). Engine integration tests check that the
served rows are bit-identical to direct ``predict_q`` calls.
"""
import asyncio

import numpy as np
import pytest

from repro_torch.core import CompiledModel, bucket_for
from repro_torch.core.quantize import quantize_graph
from repro_torch.configs.paper_models import build_sine
from repro_torch.serve.metrics import ModelMetrics
from repro_torch.serve.registry import ServingRegistry
from repro_torch.serve.scheduler import (ClassPolicy, FakeClock, FlushError,
                                   MicroBatcher, PreemptedError,
                                   QueueFullError)


def run(coro):
    return asyncio.run(coro)


def echo_infer(record):
    """Fake model: y = 2*x; appends each flushed batch size to ``record``."""
    def infer(xs):
        record.append(xs.shape[0])
        return xs * 2
    return infer


def make_batcher(record, clock, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_delay_s", 0.010)
    kw.setdefault("max_queue", 8)
    return MicroBatcher(echo_infer(record), name="echo", clock=clock,
                        metrics=ModelMetrics(now=clock.now()), **kw)


# ---------------------------------------------------------------- engine --

def test_bucket_for_public():
    assert [bucket_for(b) for b in (1, 2, 3, 4, 5, 8, 9, 33)] == \
        [1, 2, 4, 4, 8, 8, 16, 64]


def test_predict_q_many_splits_and_matches():
    qg = quantize_graph(build_sine(),
                        [np.random.default_rng(0).uniform(
                            0, 2 * np.pi, (1, 1)).astype("f")
                         for _ in range(8)], device="cpu")
    cm = CompiledModel(qg, device="cpu")
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 2 * np.pi, (11, 1, 1)).astype("f")
    qx = np.asarray(qg.tensor(qg.inputs[0]).qparams.quantize(x))
    y_many = np.asarray(cm.predict_q_many(qx, max_batch=4))
    # splitting compiled only buckets <= max_batch (4), never a 16-bucket
    assert max(cm.bucket_sizes()) <= 4
    y_ref = np.asarray(cm.predict_q(qx))
    assert y_many.shape == y_ref.shape
    assert np.array_equal(y_many, y_ref)
    with pytest.raises(ValueError):
        cm.predict_q_many(qx[0], max_batch=4)  # unbatched input


# ------------------------------------------------------- bucket-full flush --

def test_bucket_full_flush_no_time_passes():
    async def body():
        clock = FakeClock()
        record = []
        async with make_batcher(record, clock, max_batch=4) as b:
            futs = [b.submit(np.full((2,), i, np.float32)) for i in range(4)]
            await clock.drain()  # no time advance: bucket, not deadline
            assert record == [4]
            for i, f in enumerate(futs):
                assert np.array_equal(f.result(), np.full((2,), 2 * i))
            snap = b.metrics.snapshot(clock.now())
            assert snap["batches"] == 1
            assert snap["batch_occupancy"] == 1.0
            assert snap["completed"] == 4 and snap["rejected"] == 0
    run(body())


def test_nonpow2_flush_occupancy_counts_dispatched_buckets():
    """A full max_batch=6 flush drains through predict_q_many as exact 4+2
    buckets, so metrics account 6 bucket rows (occupancy 1.0) — not the
    8-bucket a single un-chunked call would have padded to (and which
    warm-up deliberately never compiles)."""
    async def body():
        clock = FakeClock()
        record = []
        async with make_batcher(record, clock, max_batch=6,
                                max_queue=16) as b:
            futs = [b.submit(np.float32([i])) for i in range(6)]
            await clock.drain()
            assert record == [6]
            snap = b.metrics.snapshot(clock.now())
            assert snap["batch_occupancy"] == 1.0
            assert all(f.done() for f in futs)
            # a 3-request deadline flush still pads to its own 4-bucket
            for i in range(3):
                b.submit(np.float32([i]))
            await clock.advance(0.010)
            assert record == [6, 3]
            snap = b.metrics.snapshot(clock.now())
            assert snap["batch_occupancy"] == pytest.approx(9 / 10)
    run(body())


def test_oversized_burst_splits_into_bucket_flushes():
    async def body():
        clock = FakeClock()
        record = []
        async with make_batcher(record, clock, max_batch=4,
                                max_queue=64) as b:
            futs = [b.submit(np.float32([i])) for i in range(11)]
            await clock.drain()
            # two full buckets drain immediately; the 3-request tail waits
            # for its deadline
            assert record == [4, 4]
            assert len(b) == 3
            await clock.advance(0.010)
            assert record == [4, 4, 3]
            assert all(f.done() for f in futs)
            assert np.array_equal(futs[10].result(), np.float32([20]))
    run(body())


# --------------------------------------------------------- deadline flush --

def test_deadline_flush_partial_batch():
    async def body():
        clock = FakeClock()
        record = []
        async with make_batcher(record, clock, max_batch=4,
                                max_delay_s=0.010) as b:
            futs = [b.submit(np.float32([i])) for i in range(3)]
            await clock.advance(0.009)
            assert record == [] and not any(f.done() for f in futs)
            await clock.advance(0.001)  # hits the 10 ms deadline exactly
            assert record == [3]
            assert all(f.done() for f in futs)
            # deadline honored in virtual time: latency == max_delay_s
            lat = b.metrics.latency_percentiles()
            assert lat["p95_ms"] == pytest.approx(10.0)
            assert b.metrics.snapshot(clock.now())["batch_occupancy"] == \
                pytest.approx(3 / 4)
    run(body())


def test_deadline_anchored_to_oldest_request():
    async def body():
        clock = FakeClock()
        record = []
        async with make_batcher(record, clock, max_batch=4,
                                max_delay_s=0.010) as b:
            b.submit(np.float32([0]))
            await clock.advance(0.006)
            b.submit(np.float32([1]))  # late arrival must not extend wait
            await clock.advance(0.004)  # oldest hits 10 ms now
            assert record == [2]
    run(body())


def test_late_arrivals_join_current_window():
    async def body():
        clock = FakeClock()
        record = []
        async with make_batcher(record, clock, max_batch=4,
                                max_delay_s=0.010) as b:
            b.submit(np.float32([0]))
            await clock.advance(0.005)
            for i in range(3):  # fills the bucket -> immediate flush
                b.submit(np.float32([i + 1]))
            await clock.drain()
            assert record == [4]
            assert clock.now() == pytest.approx(0.005)
    run(body())


# ----------------------------------------------------------- backpressure --

def test_bounded_queue_sheds_load():
    async def body():
        clock = FakeClock()
        record = []
        # max_delay far away: nothing flushes while we overfill
        async with make_batcher(record, clock, max_batch=8, max_queue=4,
                                max_delay_s=10.0) as b:
            futs = [b.submit(np.float32([i])) for i in range(4)]
            for i in range(3):
                with pytest.raises(QueueFullError):
                    b.submit(np.float32([99]))
            assert len(b) == 4  # bounded: shed requests never buffered
            assert b.metrics.rejected == 3
            await b.close(drain=True)  # drains the 4 queued requests
            assert record == [4]
            assert all(f.done() for f in futs)
            # after shedding, accepted requests completed normally
            assert b.metrics.completed == 4
    run(body())


def test_failing_batch_fails_requests_not_scheduler():
    """An inference exception propagates to that batch's futures; the
    scheduler survives and keeps serving later requests."""
    async def body():
        clock = FakeClock()
        calls = []

        def flaky(xs):
            calls.append(xs.shape[0])
            if len(calls) == 1:
                raise ValueError("poison batch")
            return xs * 2

        b = MicroBatcher(flaky, name="flaky", clock=clock, max_batch=2,
                         max_delay_s=0.010, max_queue=8)
        async with b:
            bad = [b.submit(np.float32([i])) for i in range(2)]
            await clock.drain()
            for f in bad:
                # the raw error arrives wrapped with its serving context
                with pytest.raises(FlushError, match="poison batch") as ei:
                    f.result()
                assert isinstance(ei.value.cause, ValueError)
                assert ei.value.model == "flaky" and ei.value.rows == 2
                assert ei.value.collateral is None  # no bisection ran
            ok = b.submit(np.float32([5]))
            await clock.advance(0.010)
            assert np.array_equal(ok.result(), np.float32([10]))
            assert calls == [2, 1]
            snap = b.metrics.snapshot(clock.now())
            # failed requests reach a terminal state: inflight returns to 0
            assert snap["failed"] == 2 and snap["completed"] == 1
            assert snap["inflight"] == 0
    run(body())


def test_wrong_shaped_infer_fails_batch_not_scheduler():
    """A model returning the wrong row count is a poison batch (futures get
    the error), not a silent scheduler death leaving clients hanging."""
    async def body():
        clock = FakeClock()
        b = MicroBatcher(lambda xs: xs[:1], name="bad", clock=clock,
                         max_batch=2, max_delay_s=0.010, max_queue=8)
        async with b:
            futs = [b.submit(np.float32([i])) for i in range(2)]
            await clock.drain()
            for f in futs:
                with pytest.raises(FlushError, match="2-row batch"):
                    f.result()
            assert b.metrics.snapshot(clock.now())["inflight"] == 0
    run(body())


def test_closed_batcher_refuses_restart():
    async def body():
        clock = FakeClock()
        b = make_batcher([], clock).start()
        await b.close()
        with pytest.raises(RuntimeError):
            b.start()
    run(body())


def test_malformed_request_poisons_batch_not_scheduler():
    """Mismatched sample shapes make the flush's stack fail — that batch's
    futures get the error, later well-formed requests still serve."""
    async def body():
        clock = FakeClock()
        record = []
        async with make_batcher(record, clock, max_batch=2) as b:
            bad = [b.submit(np.zeros((2,), np.float32)),
                   b.submit(np.zeros((3,), np.float32))]
            await clock.drain()
            for f in bad:
                with pytest.raises(FlushError, match="same shape"):
                    f.result()
            ok = [b.submit(np.float32([i])) for i in range(2)]
            await clock.drain()
            assert record == [2]
            assert all(f.done() and not f.exception() for f in ok)
            assert b.metrics.snapshot(clock.now())["inflight"] == 0
    run(body())


def test_registry_stop_is_terminal(sine_model):
    async def body():
        clock = FakeClock()
        reg = ServingRegistry(clock=clock, max_batch=2)
        reg.register("sine", sine_model)
        async with reg:
            pass  # exiting stops (and drains) the registry
        with pytest.raises(RuntimeError, match="stopped"):
            reg.start()
    run(body())


def test_close_without_drain_cancels_pending():
    async def body():
        clock = FakeClock()
        record = []
        b = make_batcher(record, clock, max_delay_s=10.0).start()
        fut = b.submit(np.float32([1]))
        await b.close(drain=False)
        assert fut.cancelled()
        assert record == []
        with pytest.raises(RuntimeError):
            b.submit(np.float32([2]))
    run(body())


# ---------------------------------------------------- priority classes / EDF --

TWO_CLASSES = {
    "interactive": ClassPolicy(priority=1, max_delay_s=0.002, slo_s=0.004),
    "batch": ClassPolicy(priority=0, max_delay_s=0.050),
}


def test_edf_flush_order_and_earliest_deadline_trigger():
    """EDF: a flush drains the most urgent request first regardless of
    arrival order, and fires at the EARLIEST pending deadline — a
    batch-class request submitted first does not anchor the timer."""
    async def body():
        clock = FakeClock()
        rows = []

        def infer(xs):
            rows.append([float(v[0]) for v in xs])
            return xs * 2

        b = MicroBatcher(infer, name="edf", clock=clock, max_batch=4,
                         max_delay_s=0.010, max_queue=8,
                         classes=TWO_CLASSES)
        async with b:
            slow = b.submit(np.float32([1]), cls="batch")       # ddl 50ms
            fast = b.submit(np.float32([2]), cls="interactive")  # ddl 2ms
            await clock.advance(0.002)  # interactive deadline, not batch's
            # one flush at t=2ms carrying BOTH rows, interactive first
            assert rows == [[2.0, 1.0]]
            assert clock.now() == pytest.approx(0.002)
            assert np.array_equal(fast.result(), np.float32([4]))
            assert np.array_equal(slow.result(), np.float32([2]))
    run(body())


def test_late_interactive_arrival_pulls_flush_forward():
    """A shorter-deadline class arriving mid-wait re-anchors the flush
    timer (the old oldest-request anchor would have waited 50 ms)."""
    async def body():
        clock = FakeClock()
        record = []
        b = make_batcher(record, clock, max_batch=8, classes=TWO_CLASSES)
        async with b:
            b.submit(np.float32([0]), cls="batch")   # deadline t=50ms
            await clock.advance(0.010)
            assert record == []
            b.submit(np.float32([1]), cls="interactive")  # deadline t=12ms
            await clock.advance(0.002)
            assert record == [2]  # both flushed at the interactive deadline
            assert clock.now() == pytest.approx(0.012)
    run(body())


def test_per_request_deadline_override():
    async def body():
        clock = FakeClock()
        record = []
        b = make_batcher(record, clock, max_batch=8, classes=TWO_CLASSES)
        async with b:
            b.submit(np.float32([0]), cls="batch", deadline_s=0.003)
            await clock.advance(0.003)  # override, not the class's 50ms
            assert record == [1]
        with pytest.raises(KeyError, match="unknown priority class"):
            b2 = make_batcher([], clock, classes=TWO_CLASSES)
            b2.submit(np.float32([0]), cls="no-such-class")
    run(body())


def test_shed_by_priority_evicts_lowest_then_refuses_equal():
    """At capacity a higher-priority newcomer evicts the least urgent
    lowest-priority pending request (PreemptedError on the victim, counted
    ``preempted``); an equal-priority newcomer is refused (QueueFullError,
    counted ``rejected``) — the original shed-at-tail behavior."""
    async def body():
        clock = FakeClock()
        record = []
        b = make_batcher(record, clock, max_batch=8, max_queue=2,
                         classes=TWO_CLASSES)
        async with b:
            b1 = b.submit(np.float32([1]), cls="batch")
            b2 = b.submit(np.float32([2]), cls="batch")  # least urgent
            hi = b.submit(np.float32([3]), cls="interactive")
            await clock.drain()
            # b2 (same priority as b1 but less urgent: later seq at equal
            # deadline) was evicted in hi's favor
            assert b2.done()
            with pytest.raises(PreemptedError):
                b2.result()
            # PreemptedError is shed load: QueueFullError handlers catch it
            assert isinstance(b2.exception(), QueueFullError)
            assert len(b) == 2 and b.metrics.preempted == 1
            # equal-or-lower priority newcomer is refused, no eviction
            with pytest.raises(QueueFullError):
                b.submit(np.float32([4]), cls="batch")
            assert b.metrics.rejected == 1
            # another interactive evicts the remaining batch request...
            hi2 = b.submit(np.float32([5]), cls="interactive")
            assert b1.done() and isinstance(b1.exception(), PreemptedError)
            assert b.metrics.preempted == 2
            # ...but once every pending request is interactive, a further
            # interactive newcomer has no lower-priority victim: refused
            with pytest.raises(QueueFullError):
                b.submit(np.float32([6]), cls="interactive")
            assert b.metrics.rejected == 2
            await clock.advance(0.002)  # interactive deadline flushes both
            assert record == [2]
            assert hi.done() and not hi.exception()
            assert hi2.done() and not hi2.exception()
            snap = b.metrics.snapshot(clock.now())
            assert snap["preempted"] == 2 and snap["inflight"] == 0
            assert snap["classes"]["batch"]["preempted"] == 2
            assert snap["classes"]["batch"]["rejected"] == 1
            assert snap["classes"]["interactive"]["rejected"] == 1
            assert snap["classes"]["interactive"]["completed"] == 2
    run(body())


def test_per_class_metrics_latency_and_slo_attainment():
    async def body():
        clock = FakeClock()
        record = []
        b = make_batcher(record, clock, max_batch=8, classes=TWO_CLASSES)
        async with b:
            b.submit(np.float32([0]), cls="interactive")
            b.submit(np.float32([1]), cls="batch")
            await clock.advance(0.002)  # flush at the interactive deadline
            assert record == [2]
            snap = b.metrics.snapshot(clock.now())
            cls = snap["classes"]
            # both rows waited 2ms; interactive's 4ms SLO is attained,
            # batch has no SLO target -> attainment is None
            assert cls["interactive"]["p95_ms"] == pytest.approx(2.0)
            assert cls["interactive"]["slo_attainment"] == 1.0
            assert cls["batch"]["slo_attainment"] is None
            assert cls["interactive"]["row_share"] == pytest.approx(0.5)
            assert b.metrics.slo_attainment() == {"interactive": 1.0}
    run(body())


def test_caller_cancelled_rows_count_cancelled_not_failed():
    """Rows whose caller abandoned the future before the flush landed are
    ``cancelled``, not ``failed`` — client disconnects must not look like
    inference errors (the old metrics folded both into ``failed``)."""
    async def body():
        clock = FakeClock()
        record = []
        async with make_batcher(record, clock, max_batch=4) as b:
            futs = [b.submit(np.float32([i])) for i in range(3)]
            futs[1].cancel()  # caller gives up before the deadline flush
            await clock.advance(0.010)
            assert record == [3]
            snap = b.metrics.snapshot(clock.now())
            assert snap["completed"] == 2
            assert snap["cancelled"] == 1 and snap["failed"] == 0
            assert snap["inflight"] == 0  # balance includes cancelled
    run(body())


def test_close_without_drain_counts_cancelled_not_failed():
    async def body():
        clock = FakeClock()
        record = []
        b = make_batcher(record, clock, max_delay_s=10.0).start()
        b.submit(np.float32([1]))
        b.submit(np.float32([2]))
        await b.close(drain=False)
        assert record == []
        snap = b.metrics.snapshot(clock.now())
        assert snap["cancelled"] == 2 and snap["failed"] == 0
        assert snap["inflight"] == 0
    run(body())


# ----------------------------------------------------------------- metrics --

def test_metrics_percentiles_and_throughput_math():
    m = ModelMetrics(now=100.0)
    for ms in range(1, 101):  # 1..100 ms
        m.observe_submit()
        m.observe_done(ms / 1e3)
    m.observe_batch(100, 128, 0.5)
    snap = m.snapshot(now=110.0)  # 10 s window
    assert snap["p50_ms"] == pytest.approx(50.5)
    assert snap["p99_ms"] == pytest.approx(99.01)
    assert snap["throughput_rps"] == pytest.approx(10.0)
    assert snap["batch_occupancy"] == pytest.approx(100 / 128)
    assert snap["mean_batch"] == pytest.approx(100.0)
    assert snap["inflight"] == 0


# ------------------------------------------------------ engine integration --

@pytest.fixture(scope="module")
def sine_model():
    rng = np.random.default_rng(0)
    qg = quantize_graph(
        build_sine(),
        [rng.uniform(0, 2 * np.pi, (1, 1)).astype("f") for _ in range(8)], device="cpu")
    return CompiledModel(qg, device="cpu")


def test_batcher_rows_bit_identical_to_predict_q(sine_model):
    async def body():
        clock = FakeClock()
        b = MicroBatcher.for_model(sine_model, name="sine", max_batch=4,
                                   max_delay_s=0.010, max_queue=32,
                                   clock=clock,
                                   metrics=ModelMetrics(now=clock.now()))
        qp = sine_model.graph.tensor(sine_model.graph.inputs[0]).qparams
        rng = np.random.default_rng(2)
        xs = [np.asarray(qp.quantize(
            rng.uniform(0, 2 * np.pi, (1, 1)).astype("f")))
            for _ in range(6)]
        async with b:
            futs = [b.submit(x) for x in xs]
            await clock.advance(0.010)
            assert all(f.done() for f in futs)
            for x, f in zip(xs, futs):
                direct = np.asarray(sine_model.predict_q(x[None]))[0]
                assert np.array_equal(np.asarray(f.result()), direct)
    run(body())


def test_for_model_warmup_compiles_buckets(sine_model):
    async def body():
        clock = FakeClock()
        b = MicroBatcher.for_model(sine_model, name="sine", max_batch=4,
                                   clock=clock)
        assert set(sine_model.bucket_sizes()) >= {1, 2, 4}
        await b.close()
    run(body())


# ---------------------------------------------------------------- registry --

def test_registry_multi_model_admission_and_metrics(sine_model):
    async def body():
        clock = FakeClock()
        reg = ServingRegistry(clock=clock, max_batch=4, max_delay_s=0.010,
                              max_queue=4)
        reg.register("sine", sine_model)
        record = []
        reg.register("echo", _FakeModel(record), warmup=False)

        with pytest.raises(RuntimeError):  # not started yet
            reg.submit("echo", np.float32([0]))

        async with reg:
            assert set(reg.models()) == {"sine", "echo"}
            with pytest.raises(KeyError):
                reg.submit("nope", np.float32([0]))

            futs = [reg.submit("echo", np.float32([i])) for i in range(4)]
            await clock.drain()  # bucket-full on the echo model
            assert record == [4]
            assert [f.result()[0] for f in futs] == [0, 2, 4, 6]

            qx = reg.quantize_input("sine", np.float32([1.0]))
            sf = reg.submit("sine", qx)
            await clock.advance(0.010)
            assert sf.done()

            with pytest.raises(QueueFullError):
                for i in range(10):
                    reg.submit("echo", np.float32([i]))
            snap = reg.snapshot()
            assert snap["echo"]["rejected"] >= 1
            assert snap["sine"]["completed"] == 1
            assert snap["sine"]["p95_ms"] == pytest.approx(10.0)
    run(body())


class _FakeModel:
    """Duck-typed CompiledModel stand-in for registry plumbing tests."""

    def __init__(self, record):
        self._record = record

    def predict_q_many(self, xs, max_batch=None):
        self._record.append(np.asarray(xs).shape[0])
        return np.asarray(xs) * 2


def test_registry_quantize_roundtrip(sine_model):
    async def body():
        clock = FakeClock()
        reg = ServingRegistry(clock=clock, max_batch=2, max_delay_s=0.001)
        reg.register("sine", sine_model)
        x = np.float32([2.0])
        async with reg:
            fut = reg.submit("sine", reg.quantize_input("sine", x))
            await clock.advance(0.001)
            y = reg.dequantize_output("sine", fut.result())
        ref = sine_model.predict(x.reshape(1, 1))
        assert np.allclose(y, ref)
    run(body())
