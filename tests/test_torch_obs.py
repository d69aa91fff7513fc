"""Deterministic tests for the observability stack (repro_torch.obs).

The port's copy of ``tests/test_obs.py``: the same invariants, held on
``repro_torch.serve`` / ``repro_torch.obs`` over the port's
``CompiledModel(device="cpu")``.

Everything runs under ``FakeClock`` — virtual time only, zero real
sleeps — so span boundaries, flight-recorder triggers, and the
exactly-one-terminal accounting are pinned exactly, not statistically.
"""
import asyncio
import json
import time

import numpy as np
import pytest

from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.trace import (COUNTED, ENGINE_SPANS, NULL_TRACER,
                                   STAGES, TERMINALS, Tracer)
from repro_torch.serve.executor import InlineExecutor
from repro_torch.serve.faults import FaultInjector
from repro_torch.serve.metrics import ModelMetrics
from repro_torch.serve.resilience import (BreakerPolicy, ResilientExecutor,
                                    RetryPolicy)
from repro_torch.serve.scheduler import (ClassPolicy, FakeClock, FlushError,
                                   MicroBatcher, QueueFullError)


def run(coro):
    return asyncio.run(coro)


def echo_infer(xs):
    return xs * 2


def make_batcher(clock, tracer, *, infer=echo_infer, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_delay_s", 0.010)
    kw.setdefault("max_queue", 8)
    return MicroBatcher(infer, name="echo", clock=clock,
                        metrics=ModelMetrics(now=clock.now()),
                        tracer=tracer, **kw)


async def drive(b, clock, n, cls="default", advance=0.5):
    futs = [b.submit(np.full((1,), i, np.float32), cls=cls)
            for i in range(n)]
    await clock.drain()
    await clock.advance(advance)
    return futs


# ------------------------------------------------------------ span trees --

def test_span_ordering_and_exact_decomposition():
    """Every completed request gets a gap-free span tree: under virtual
    time, total == queue_wait + assemble + dispatch exactly, and the
    queue span closes before dispatch opens."""
    async def body():
        clock = FakeClock()
        tracer = Tracer()
        async with make_batcher(clock, tracer) as b:
            futs = await drive(b, clock, 6)  # one bucket + deadline flush
            [f.result() for f in futs]
        trees = tracer.trees()
        assert len(trees) == 6
        assert len({t["trace_id"] for t in trees}) == 6
        for tree in trees:
            assert tree["terminal"] == "complete"
            names = [s.name for s in tree["spans"]]
            for need in ("queue", "flush", "flush_assemble", "dispatch"):
                assert need in names, (need, names)
            by = {s.name: s for s in tree["spans"]}
            assert by["queue"].t0 <= by["queue"].t1 <= by["dispatch"].t0
            assert by["flush_assemble"].t1 <= by["dispatch"].t0
            bd = tree["breakdown_us"]
            recon = (bd["queue_wait_us"] + bd["assemble_us"]
                     + bd["dispatch_us"])
            assert abs(bd["total_us"] - recon) < 1e-6, (bd, recon)
    run(body())


def test_trace_ids_stable_across_retry_and_degrade():
    """A transient fault and a route degradation keep the request on ONE
    trace id: the retry span, both routes' attempt spans, and the degrade
    event all attach to the same flush, and the terminal closes the same
    trace admitted at submit."""
    async def body():
        clock = FakeClock()
        tracer = Tracer()
        inj = FaultInjector(seed=3, persistent_routes={"kernels"})
        rex = ResilientExecutor(
            inj.wrap(InlineExecutor()),
            retry=RetryPolicy(max_attempts=3, base_s=0.002, jitter=0.0))

        def routed(xs, route=None):
            return xs * 2

        async with make_batcher(clock, tracer, executor=rex,
                                infer_routed=routed,
                                routes=("kernels", "compiled")) as b:
            inj.fail_next("transient")  # on top of the broken primary
            futs = await drive(b, clock, 2)
            [f.result() for f in futs]
        trees = tracer.trees()
        assert len(trees) == 2
        fids = set()
        for tree in trees:
            assert tree["terminal"] == "complete"
            spans = tree["spans"]
            assert any(s.name == "retry" for s in spans)
            assert any(s.name == "degrade" for s in spans)
            routes = {s.attrs.get("route") for s in spans
                      if s.name == "attempt"}
            assert routes == {"kernels", "compiled"}, routes
            # every span in the tree belongs to the one flush the request
            # rode — the retry/degrade hops never forked the trace
            assert len({s.trace_id for s in spans
                        if s.name != "queue"}) == 1
            fids.add(tree["flush"])
        assert len(fids) == 1  # both rows shared the flush
    run(body())


def _sine_served():
    """A quantized sine CompiledModel + quantized inputs for end-to-end
    engine-span tests."""
    from repro_torch.core import CompiledModel
    from repro_torch.core.quantize import quantize_graph
    from repro_torch.configs.paper_models import build_sine

    rng = np.random.default_rng(0)
    qg = quantize_graph(build_sine(),
                        [rng.uniform(0, 2 * np.pi, (1, 1)).astype("f")
                         for _ in range(8)], device="cpu")
    cm = CompiledModel(qg, device="cpu")
    qp = qg.tensor(qg.inputs[0]).qparams
    qxs = [np.asarray(qp.quantize(
        rng.uniform(0, 2 * np.pi, (1, 1)).astype("f"))) for _ in range(6)]
    return cm, qxs


def test_engine_spans_cross_executor_boundary():
    """The real engine's device spans and compile events land on the
    flush's trace through the thread-local scope (sine CompiledModel,
    served end-to-end). The prestaged assembly fast path eliminates the
    staged device pad entirely, so no pad_stage span may appear — rows
    land in pooled physical-layout buffers instead."""
    cm, qxs = _sine_served()

    async def body():
        clock = FakeClock()
        tracer = Tracer()
        b = MicroBatcher.for_model(
            cm, name="sine", max_batch=4, max_delay_s=0.010, max_queue=8,
            clock=clock, metrics=ModelMetrics(now=clock.now()),
            tracer=tracer, warmup=False)
        async with b:
            futs = [b.submit(qxs[i]) for i in range(3)]
            await clock.drain()
            await clock.advance(0.5)
            ys = [np.asarray(f.result()) for f in futs]
        ref = [np.asarray(cm.predict_q(qxs[i])) for i in range(3)]
        for y, r in zip(ys, ref):
            assert np.array_equal(y, r)
        tree = tracer.trees()[-1]
        names = {s.name for s in tree["spans"]}
        assert "device" in names, names
        assert "pad_stage" not in names, \
            "staged fast path must not pay a device-side pad"
        assert tracer.compile_events, "bucket compile event not recorded"
        # under FakeClock the device call consumes zero VIRTUAL time, so
        # the mean is 0; the histogram still observed every terminal
        assert tracer.hists["device"].n == 3
    run(body())


# -------------------------------------------------------- flight recorder --

def test_ring_eviction_at_capacity():
    fr = FlightRecorder(capacity=4)
    for i in range(10):
        fr.record("tick", float(i), seq=i)
    evs = fr.events()
    assert len(evs) == 4
    assert [e["seq"] for e in evs] == [6, 7, 8, 9]  # oldest evicted first
    assert fr.dropped == 6
    assert fr.status()["capacity"] == 4


def test_dump_on_breaker_open(tmp_path):
    """A persistent failure storm trips the breaker; the flight recorder
    dumps a parseable postmortem naming both triggers."""
    path = str(tmp_path / "flightrec.json")
    reasons = []

    class Log(FlightRecorder):
        def dump(self, reason, t, path=None):
            reasons.append(reason)
            return super().dump(reason, t, path)

    async def body():
        clock = FakeClock()
        flight = Log(capacity=64, path=path, min_dump_interval_s=0.0)
        tracer = Tracer(flight=flight)
        inj = FaultInjector()
        rex = ResilientExecutor(
            inj.wrap(InlineExecutor()),
            retry=RetryPolicy(max_attempts=1),
            breaker=BreakerPolicy(failure_threshold=2, recovery_s=10.0))
        async with make_batcher(clock, tracer, executor=rex,
                                max_batch=1) as b:
            inj.fail_next("transient", times=6)
            for _ in range(3):
                futs = await drive(b, clock, 1)
                assert isinstance(futs[0].exception(), FlushError)
        return flight
    flight = run(body())
    assert flight.dumps >= 2
    assert {"flush_error", "breaker_open"} <= set(reasons), reasons
    doc = json.loads(open(path).read())
    assert doc["reason"] == reasons[-1]
    kinds = {e["kind"] for e in doc["events"]}
    assert {"terminal", "fault", "breaker"} <= kinds, kinds
    json.dumps(doc)  # round-trips


# ----------------------------------------------- chaos-storm accounting --

def test_chaos_storm_counters_balance():
    """Satellite audit: a storm exercising every exit path — completion,
    rejection, preemption, expiry, poison-row failure with collateral, and
    a non-drain close — leaves the books balanced per class AND overall:
    submitted == sum of terminals, the derived inflight gauges read 0, the
    inflight_rows gauge returns to 0, collateral stays a sub-count of
    failed, and the tracer's terminal counts agree with the metrics. Zero
    real sleeps (FakeClock)."""
    t_wall = time.perf_counter()

    async def body():
        clock = FakeClock()
        tracer = Tracer()
        inj = FaultInjector(poison=lambda row: int(row[0]) == 66)
        rex = ResilientExecutor(inj.wrap(InlineExecutor()),
                                retry=RetryPolicy(max_attempts=2,
                                                  jitter=0.0))
        classes = {
            "hi": ClassPolicy(priority=2, max_delay_s=0.001, slo_s=0.050),
            "lo": ClassPolicy(priority=0, max_delay_s=0.020, slo_s=0.200),
        }
        b = make_batcher(clock, tracer, executor=rex, classes=classes,
                         max_batch=4, max_queue=4)
        rejected = 0
        async with b:
            # 1) clean completions in both classes
            for f in await drive(b, clock, 3, cls="hi"):
                f.result()
            for f in await drive(b, clock, 2, cls="lo"):
                f.result()
            # 2) poison batch: row 66 fails alone, batchmates complete or
            #    are attributed collateral by bisection
            futs = [b.submit(np.full((1,), v, np.float32), cls="lo")
                    for v in (64.0, 65.0, 66.0, 67.0)]
            await clock.drain()
            await clock.advance(0.5)
            outcomes = [f.exception() for f in futs]
            assert any(o is not None for o in outcomes)
            # 3) backpressure: fill the queue with lo, then preempt with
            #    hi and reject past the bound (pause flushing by filling
            #    within one drain window)
            lo_futs = [b.submit(np.zeros((1,), np.float32), cls="lo")
                       for _ in range(4)]
            hi_futs = []
            for _ in range(4):
                hi_futs.append(b.submit(np.zeros((1,), np.float32),
                                        cls="hi"))
            try:
                for _ in range(3):
                    b.submit(np.zeros((1,), np.float32), cls="hi")
            except QueueFullError:
                rejected += 1
            preempted = [f for f in lo_futs if f.done()]
            assert preempted, "shed-by-priority never fired"
            await clock.drain()
            await clock.advance(0.5)
            # 4) expiry: park lo requests past their SLO wall deadline by
            #    submitting more rows than one flush drains before the
            #    deadline sweep sees them
            b2_futs = [b.submit(np.zeros((1,), np.float32), cls="lo")
                       for _ in range(2)]
            await clock.advance(1.0)  # way past lo's 0.200s SLO
            del b2_futs
            # 5) non-drain close with requests still pending
            pending = [b.submit(np.zeros((1,), np.float32), cls="lo")
                       for _ in range(2)]
            await b.close(drain=False)
            del pending

        m = b.metrics
        snap = m.snapshot(clock.now())
        # overall: exactly-one-terminal-state, gauges at rest
        assert snap["submitted"] == (
            snap["completed"] + snap["failed"] + snap["cancelled"]
            + snap["preempted"] + snap["deadline_exceeded"])
        assert snap["inflight"] == 0
        assert snap["inflight_rows"] == 0
        assert snap["collateral"] <= snap["failed"]
        assert snap["rejected"] >= rejected >= 1
        assert snap["preempted"] >= 1
        assert snap["failed"] >= 1
        # per-class: the same balance holds inside every class
        for cls, st in snap["classes"].items():
            assert st["inflight"] == 0, (cls, st)
            assert st["submitted"] == (
                st["completed"] + st["failed"] + st["cancelled"]
                + st["preempted"] + st["deadline_exceeded"]), (cls, st)
            assert st["collateral"] <= st["failed"], (cls, st)
        # the tracer agrees with the metrics terminal-for-terminal:
        # complete == completed; shed == cancelled + preempted; expire ==
        # deadline_exceeded; failed == failed
        tc = tracer.counts
        assert tc["complete"] == snap["completed"]
        assert tc["failed"] == snap["failed"]
        assert tc["shed"] == snap["cancelled"] + snap["preempted"]
        assert tc["expire"] == snap["deadline_exceeded"]
        assert tc["rejected"] == snap["rejected"]
        assert tracer.hists["total"].n == sum(tc[k] for k in TERMINALS)
        assert not tracer._active, "leaked active traces"
    run(body())
    assert time.perf_counter() - t_wall < 10.0  # virtual time did the work


# ------------------------------------------------------------------ export --

def test_openmetrics_and_json_snapshot():
    async def body():
        clock = FakeClock()
        tracer = Tracer()
        async with make_batcher(clock, tracer) as b:
            for f in await drive(b, clock, 4):
                f.result()
        return tracer, b.metrics.snapshot(clock.now())
    tracer, snap = run(body())

    from repro_torch.obs.export import json_snapshot, openmetrics
    text = openmetrics({"echo": snap}, tracer=tracer)
    for needle in ("# TYPE repro_requests counter",
                   'repro_requests_total{model="echo",state="completed"} 4',
                   "# TYPE repro_stage_us histogram",
                   'stage="queue"', "repro_stage_us_count",
                   "# TYPE repro_serving gauge", "# EOF"):
        assert needle in text, needle
    assert text.endswith("# EOF\n")
    doc = json_snapshot({"echo": snap}, tracer=tracer)
    assert set(doc["stage_breakdown_us"]) == \
        {"queue_wait_us", "pad_us", "device_us", "retry_us"}
    json.dumps(doc)  # serializable as-is


def test_registry_openmetrics_and_telemetry():
    """A tracer-equipped ServingRegistry exposes the unified telemetry
    surfaces: OpenMetrics text and the JSON snapshot, flight status
    included."""
    from repro_torch.serve.registry import ServingRegistry

    cm, qxs = _sine_served()

    async def body():
        clock = FakeClock()
        tracer = Tracer(flight=FlightRecorder(capacity=32))
        reg = ServingRegistry(clock=clock, max_batch=4, max_delay_s=0.010,
                              tracer=tracer)
        reg.register("sine", cm, warmup=False)
        async with reg:
            futs = [reg.submit("sine", qx) for qx in qxs[:3]]
            await clock.drain()
            await clock.advance(0.5)
            [f.result() for f in futs]
        text = reg.openmetrics()
        for needle in ('model="sine"', "repro_stage_us_bucket",
                       "repro_compile_events_total"):
            assert needle in text, needle
        assert text.endswith("# EOF\n")
        tel = reg.telemetry()
        assert tel["models"]["sine"]["completed"] == 3
        assert tel["flight"]["dumps"] == 0
        assert set(tel["stage_breakdown_us"]) == \
            {"queue_wait_us", "pad_us", "device_us", "retry_us"}
        json.dumps(tel)
    run(body())


def test_null_tracer_is_free_and_inert():
    """The disabled tracer's hooks all early-out: no ids, no state, and
    the serving path runs identically with it installed."""
    assert NULL_TRACER.admit("m", "c", 0.0) is None
    assert NULL_TRACER.flush_begin(["r1"], 0.0, model="m", rows=1,
                                   bucket=1) is None
    assert NULL_TRACER.handle(None, None) is None
    NULL_TRACER.terminal(None, 0.0, "complete")
    NULL_TRACER.flush_end(None, 0.0)
    assert NULL_TRACER.trees() == []

    async def body():
        clock = FakeClock()
        async with make_batcher(clock, None) as b:  # default -> NULL_TRACER
            for f in await drive(b, clock, 3):
                f.result()
        assert b.tracer is NULL_TRACER
    run(body())


def test_stage_taxonomy_is_closed():
    """The exported stage set, terminal set and counted-span set are the
    documented taxonomy — a new stage must be added deliberately (README
    table, histograms, export, counters) rather than leak in by typo."""
    assert STAGES == ("queue", "flush_assemble", "pad_stage", "dispatch",
                      "device", "validate", "retry", "total")
    assert TERMINALS == ("complete", "failed", "shed", "expire")
    assert ENGINE_SPANS == ("engine.stage", "engine.launch", "engine.sync",
                            "engine.unstage")
    assert COUNTED == ENGINE_SPANS + ("sched.resolve",)
    tr = Tracer()
    assert set(tr.hists) == set(STAGES)
    assert set(tr.counters()) == {f"{n}.{k}" for n in COUNTED
                                  for k in ("n", "sum_us")}
