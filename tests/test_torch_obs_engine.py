"""The port's counted spans (``repro_torch.obs.trace``): an engine call's
host time split into ``engine.stage`` / ``launch`` / ``sync`` / ``unstage``
and a flush's ``sched.resolve``, their counters, what they cost when off,
the profiler ranges a device trace names its idle gaps by, and
``tools/engine_spans.py``, which reads them in the benchmark's cells. CPU
only: ``engine.sync`` (the wait for the card) never occurs here."""
import asyncio
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from repro_torch.obs import trace as T
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.trace import COUNTED, NULL_TRACER, StageHist, Tracer
from repro_torch.serve.metrics import ModelMetrics
from repro_torch.serve.scheduler import FakeClock, MicroBatcher

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {f"{n}.{k}" for n in COUNTED for k in ("n", "sum_us")}


class CountingClock:
    """A clock that counts its reads."""

    def __init__(self):
        self.reads = 0

    def now(self):
        self.reads += 1
        return time.monotonic()


@pytest.fixture(scope="module")
def sine():
    from repro_torch.configs.paper_models import build_sine
    from repro_torch.core import CompiledModel
    from repro_torch.core.quantize import quantize_graph
    rng = np.random.default_rng(0)
    qg = quantize_graph(build_sine(),
                        [rng.uniform(0, 2 * np.pi, (1, 1)).astype("f")
                         for _ in range(8)], device="cpu")
    cm = CompiledModel(qg, device="cpu").warmup_batched(8)
    qp = qg.tensor(qg.inputs[0]).qparams
    xs = np.stack([np.asarray(qp.quantize(
        rng.uniform(0, 2 * np.pi, (1, 1)).astype("f"))) for _ in range(20)])
    return cm, xs


@pytest.fixture
def model(sine):
    cm, xs = sine
    cm.tracer = None
    yield cm, xs
    cm.tracer = None


def _counts(tracer):
    c = tracer.counters()
    return {n: c[n + ".n"] for n in COUNTED}


# (entry, engine calls it makes)
ENTRIES = {
    "predict_q": (lambda cm, xs: cm.predict_q(xs[0]), 1),
    "predict_q_batch": (lambda cm, xs: cm.predict_q(xs[:3]), 1),
    "predict_q_many": (lambda cm, xs: cm.predict_q_many(xs, max_batch=8),
                       3),
    "staged_infer": (lambda cm, xs: cm.staged_infer(list(xs[:5])), 1),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_bound_tracer_counts_each_engine_call_once(model, entry):
    """With a Tracer bound, stage, launch and unstage count once per
    engine call (a chunk of ``predict_q_many`` is one), sync never on the
    CPU, and the rows are the untraced rows."""
    cm, xs = model
    fn, calls = ENTRIES[entry]
    want = fn(cm, xs)
    cm.tracer = tr = Tracer()
    got = fn(cm, xs)
    assert np.array_equal(np.asarray(got), np.asarray(want))
    assert _counts(tr) == {"engine.stage": calls, "engine.launch": calls,
                           "engine.sync": 0, "engine.unstage": calls,
                           "sched.resolve": 0}
    c = tr.counters()
    assert all(c[n + ".sum_us"] > 0 for n in
               ("engine.stage", "engine.launch", "engine.unstage"))
    assert T._tls.call is None


def test_bound_span_is_one_clock_read(model):
    """A bound call reads the Tracer's clock once a span boundary: at
    entry, at the launch, at the unstage, at return (three spans, four
    reads on the CPU)."""
    cm, xs = model
    clock = CountingClock()
    cm.tracer = Tracer(clock=clock)
    clock.reads = 0
    cm.predict_q_many(xs, max_batch=8)
    assert clock.reads == 4 * 3


def test_spans_cover_the_call(model):
    """The four spans of a call add up to no more than the call as timed
    from outside, and to most of it: what they leave out is a few Python
    statements a call."""
    cm, xs = model
    cm.tracer = tr = Tracer()
    calls, wall = 0, 0.0
    for _ in range(20):
        t0 = time.monotonic()
        cm.predict_q_many(xs, max_batch=8)
        wall += time.monotonic() - t0
        calls += 3
    c = tr.counters()
    spans_us = sum(c[n + ".sum_us"] for n in T.ENGINE_SPANS)
    assert c["engine.stage.n"] == calls
    assert spans_us <= wall * 1e6
    assert spans_us >= 0.6 * wall * 1e6, (spans_us, wall * 1e6)


def test_untraced_call_reads_no_clock_and_allocates_no_span(model,
                                                            monkeypatch):
    """No Tracer bound and no scope: an engine call reads no clock, makes
    no Lap or Span, and opens no profiler range, on every entry."""
    cm, xs = model
    clock = CountingClock()
    Tracer(clock=clock)  # exists, bound to nothing
    clock.reads = 0

    def refuse(*a, **kw):
        raise AssertionError("a span object was made")

    monkeypatch.setattr(T, "Lap", refuse)
    monkeypatch.setattr(T, "Span", refuse)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for fn, _ in ENTRIES.values():
            fn(cm, xs)
        bufs = cm.acquire_staging(4)
        cm.predict_q_staged(bufs, 2)
        cm.release_staging(4, bufs, 2)
    assert clock.reads == 0
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not names & (set(COUNTED) | {"flush_assemble"}), names


def test_served_flush_puts_spans_on_its_trace(model):
    """Under FakeClock, a served flush puts the engine spans (and
    ``device``) and ``sched.resolve`` on the flush's trace, one of each;
    ``sched.resolve`` counts once per flush, the engine spans once per
    flush's engine call."""
    cm, xs = model

    async def body():
        clock = FakeClock()
        tracer = Tracer(clock=clock)
        b = MicroBatcher.for_model(
            cm, name="sine", max_batch=4, max_delay_s=0.010, max_queue=8,
            clock=clock, metrics=ModelMetrics(now=clock.now()),
            tracer=tracer, warmup=False)
        async with b:
            futs = [b.submit(xs[i]) for i in range(7)]
            await clock.drain()
            await clock.advance(0.5)
            [f.result() for f in futs]
        return tracer, b.metrics.batches
    tracer, flushes = asyncio.run(body())
    assert flushes == 2
    assert _counts(tracer) == {"engine.stage": 2, "engine.launch": 2,
                               "engine.sync": 0, "engine.unstage": 2,
                               "sched.resolve": 2}
    assert tracer.counters()["sched.resolve.sum_us"] == 0.0  # virtual
    assert len(tracer._recent_flushes) == 2
    for fl in tracer._recent_flushes.values():
        names = [s.name for s in fl.spans]
        for need in ("flush_assemble", "engine.stage", "engine.launch",
                     "device", "engine.unstage", "sched.resolve"):
            assert names.count(need) == 1, (need, names)
        assert "engine.sync" not in names
        assert names[-1] == "sched.resolve"
    assert cm.tracer is None  # a bare batcher binds nothing to the model


def test_registry_binds_its_tracer(model):
    """``ServingRegistry.register`` binds an enabled tracer to the model,
    so that calls outside a flush count on it; none when untraced."""
    from repro_torch.serve.registry import ServingRegistry
    cm, xs = model
    tr = Tracer()
    ServingRegistry(tracer=tr).register("sine", cm, warmup=False)
    assert cm.tracer is tr
    cm.predict_q(xs[0])
    assert _counts(tr)["engine.stage"] == 1
    cm.tracer = None
    ServingRegistry().register("sine", cm, warmup=False)
    assert cm.tracer is None


def test_counters_key_set_is_fixed(model):
    """``counters()`` has the same keys, zero, from construction on, and
    keeps them after traffic; the disabled tracer's are zero too."""
    cm, xs = model
    tr = Tracer()
    before = tr.counters()
    assert set(before) == KEYS and not any(before.values())
    cm.tracer = tr
    cm.predict_q_many(xs, max_batch=4)
    after = tr.counters()
    assert set(after) == KEYS and after["engine.stage.n"] == 5
    assert set(NULL_TRACER.counters()) == KEYS
    assert not any(NULL_TRACER.counters().values())


def test_clock_offset_reaches_snapshots_and_dumps(tmp_path):
    """The tracer's clock offset to ``time.time_ns()`` is read once, is
    None under the virtual clock, and rides ``snapshot()`` (so
    ``json_snapshot``) and the flight recorder's dumps."""
    from repro_torch.obs.export import json_snapshot
    flight = FlightRecorder(path=str(tmp_path / "f.json"))
    tr = Tracer(flight=flight)
    ref = time.time_ns() - time.monotonic_ns()
    assert abs(tr.clock_offset_ns - ref) < 50_000_000
    assert tr.snapshot()["clock_offset_ns"] == tr.clock_offset_ns
    assert json_snapshot({}, tracer=tr)["trace"]["clock_offset_ns"] == \
        tr.clock_offset_ns
    assert set(tr.snapshot()["counters"]) == KEYS
    doc = json.loads(open(flight.dump("test", 0.0)).read())
    assert doc["clock_offset_ns"] == tr.clock_offset_ns
    assert Tracer(clock=FakeClock()).clock_offset_ns is None


def test_profiler_ranges_name_a_gap_in_a_span(model):
    """Under a CPU torch profiler the counted spans are host events of
    ``kineto_results``, and ``portbench.devtrace.reduce`` names a device
    gap whose midpoint lies inside an ``engine.stage`` range by
    ``engine.stage``."""
    sys.path.insert(0, ROOT)
    from portbench.devtrace import reduce
    from torch.profiler import ProfilerActivity, profile
    cm, xs = model
    cm.tracer = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cm.predict_q_many(xs, max_batch=8)
    host = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]
    kinds = {str(e.device_type()) for e in
             prof.profiler.kineto_results.events()
             if e.name() in COUNTED}
    assert kinds == {"DeviceType.CPU"}
    named = [h for h in host if h[0] in COUNTED]
    assert [h[0] for h in named].count("engine.stage") == 3
    assert {h[0] for h in named} == {"engine.stage", "engine.launch",
                                     "engine.unstage"}
    stage = next(h for h in named if h[0] == "engine.stage")
    mid = stage[1] + 1
    device = [("k0", mid - 1000, mid - 1, "kernel"),
              ("k1", mid + 1, mid + 1000, "kernel")]
    got = reduce(device, host, 1.0)
    assert got["gaps"][0][0] == "engine.stage"


def test_stage_hist_bisect_keeps_edges():
    """A value on an edge falls in that edge's bucket; above the last,
    in +Inf."""
    h = StageHist()
    for us in (10.0, 10.5, 1e6, 2e6, 0.0):
        h.observe(us)
    assert h.counts[0] == 2 and h.counts[1] == 1
    assert h.counts[len(StageHist.EDGES_US) - 1] == 1
    assert h.counts[-1] == 1 and h.n == 5


def test_obs_selftest_passes():
    got = subprocess.run([sys.executable, "-m", "repro_torch.obs",
                          "--selftest", "-q"], cwd=ROOT,
                         env={**os.environ,
                              "PYTHONPATH": os.path.join(ROOT, "src")},
                         capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr[-2000:]
    assert "obs selftest: OK" in got.stdout


# the benchmark's cells at the small sizes of portbench/tests/_small.py
SMALL = {
    "person.flood": {"clients": 6, "pool_rows": 24, "warm_s": 0.1,
                     "registry": {"max_batch": 4, "max_delay_s": 0.002,
                                  "max_queue": 256}},
    "person.direct": {"pool_rows": 12, "warm_s": 0.1},
    "speech.bulk": {"pool_rows": 128, "rows_per_call": 32, "max_batch": 8,
                    "warm_s": 0.1},
}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_engine_spans_tool_reads_every_cell(cell):
    """``tools/engine_spans.py`` on a short traced run of a ``registry``,
    a ``predict_q`` and a ``predict_q_many`` mix: every answer right, each
    counted span of the family read, and the four engine spans add up to
    at most the call's time (``engine.call_us.*``, or the counted phase's
    seconds a call) and to most of it."""
    code = (
        "import sys, json; sys.path[:0] = [%r, %r, %r]\n"
        "import engine_spans as E\n"
        "print(json.dumps(E.run_cells([%r], 987654321987, 0.8, 'cpu', "
        "%r)[0]))\n" % (ROOT, os.path.join(ROOT, "src"),
                        os.path.join(ROOT, "tools"), cell, SMALL))
    got = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr[-2000:]
    line = json.loads(got.stdout.strip().splitlines()[-1])
    assert line["correct"]
    spans = line["spans_us"]
    assert spans["engine.sync"] is None  # no card
    for n in ("engine.stage", "engine.launch", "engine.unstage"):
        assert spans[n] > 0, (n, spans)
    assert (spans["sched.resolve"] is not None) == (cell == "person.flood")
    assert line["engine_sum_us"] <= line["call_us"]
    assert line["sum_over_call"] >= 0.6, line
    assert line["span_named_device_ops"] == []


def test_engine_spans_tool_pairs():
    """``tools/engine_spans.py --pairs``: person.direct's calls with and
    without a Tracer, alternating call by call; the bound calls count one
    of each engine span but sync (none on the CPU)."""
    code = (
        "import sys, json; sys.path[:0] = [%r, %r, %r]\n"
        "import engine_spans as E\n"
        "print(json.dumps(E.run_pairs(1, 987654321987, 0.3, 'cpu')))\n"
        % (ROOT, os.path.join(ROOT, "src"), os.path.join(ROOT, "tools")))
    got = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr[-2000:]
    line = json.loads(got.stdout.strip().splitlines()[-1])
    assert len(line["p50_ms"]["on"]) == len(line["p50_ms"]["off"]) == 1
    assert line["median_pair_ratio"] > 0
    assert line["spans_per_call"] == {
        "engine.stage.n": 1.0, "engine.launch.n": 1.0, "engine.sync.n": 0.0,
        "engine.unstage.n": 1.0, "sched.resolve.n": 0.0}
