"""CLI for the observability subsystem.

``python -m repro_torch.obs --selftest`` replays a seeded FakeClock serving
scenario through the REAL pipeline (MicroBatcher -> ResilientExecutor ->
FaultInjector -> InlineExecutor) and asserts the observability contract
end-to-end with zero real sleeps:

* every admitted request ends with exactly one terminal and a complete,
  gap-free span tree (queue + assemble + dispatch sums match the observed
  latency exactly under virtual time);
* engine-style spans recorded inside ``infer`` cross the executor
  boundary via the thread-local trace scope, and every flush counts one
  ``sched.resolve``;
* a transient fault produces a retry span on the SAME trace, and a broken
  primary route produces attempt spans on both routes plus a degrade
  event — trace ids stay stable across retry/degrade hops;
* a persistent failure storm trips the circuit breaker and the flight
  recorder dumps a parseable postmortem JSON (flush_error AND
  breaker_open triggers), with no clock offset under the virtual clock;
* the OpenMetrics exposition renders every family and parses the smoke
  checks below.

It needs no model and no card (``infer`` is a stub, so it runs anywhere
the port imports); ``--demo`` prints the scenario's OpenMetrics text for
eyeballing.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import tempfile

import numpy as np

from .export import json_snapshot, openmetrics
from .flight import FlightRecorder
from .trace import TERMINALS, Tracer, engine_span


class _ReasonLog(FlightRecorder):
    """FlightRecorder that remembers every dump reason (selftest aid)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.reasons: list = []

    def dump(self, reason, t, path=None):
        self.reasons.append(reason)
        return super().dump(reason, t, path)


def _stub_infer(xs):
    # stands in for CompiledModel.predict_q_many: the engine_span proves
    # the thread-local scope plumbing without building an engine
    with engine_span("device", bucket=len(xs), rows=len(xs)):
        return np.asarray(xs, np.float32) * 2.0


async def _scenario(tmpdir: str, verbose: bool = False):
    from repro_torch.serve.executor import InlineExecutor
    from repro_torch.serve.faults import FaultInjector
    from repro_torch.serve.resilience import (BreakerPolicy, ResilientExecutor,
                                        RetryPolicy)
    from repro_torch.serve.scheduler import (ClassPolicy, FakeClock, FlushError,
                                       MicroBatcher)

    def say(msg):
        if verbose:
            print(f"  [obs-selftest] {msg}")

    clock = FakeClock()
    flight = _ReasonLog(capacity=256,
                        path=os.path.join(tmpdir, "flightrec.json"),
                        min_dump_interval_s=0.0)
    tracer = Tracer(flight=flight, clock=clock)
    inj = FaultInjector(seed=11)
    rex = ResilientExecutor(
        inj.wrap(InlineExecutor()),
        retry=RetryPolicy(max_attempts=3, base_s=0.002, jitter=0.0),
        breaker=BreakerPolicy(failure_threshold=3, recovery_s=0.050))
    classes = {"interactive": ClassPolicy(priority=1, max_delay_s=0.001,
                                          slo_s=0.100),
               "batch": ClassPolicy(priority=0, max_delay_s=0.010)}

    async def drive(b, n, cls="interactive", advance=0.5):
        futs = [b.submit(np.full((1,), i, np.float32), cls=cls)
                for i in range(n)]
        await clock.drain()
        await clock.advance(advance)
        return futs

    # -- 1) clean storm: complete, gap-free span trees -------------------
    async with MicroBatcher(_stub_infer, name="sine", max_batch=4,
                            max_delay_s=0.010, clock=clock,
                            classes=classes, executor=rex,
                            tracer=tracer) as b:
        futs = await drive(b, 6)  # one full bucket + one deadline flush
        ys = [f.result() for f in futs]
        assert all(float(y[0]) == 2.0 * i for i, y in enumerate(ys))
        rids = [r["trace_id"] for r in tracer.trees()]
        assert len(rids) == 6 and len(set(rids)) == 6
        for tree in tracer.trees():
            assert tree["terminal"] == "complete", tree
            names = [s.name for s in tree["spans"]]
            for need in ("queue", "flush", "flush_assemble", "dispatch",
                         "attempt", "device"):
                assert need in names, (need, names)
            # gap-free: virtual time makes the decomposition exact
            bd = tree["breakdown_us"]
            recon = (bd["queue_wait_us"] + bd["assemble_us"]
                     + bd["dispatch_us"])
            assert abs(bd["total_us"] - recon) < 1.0, (bd, recon)
            # span ordering: queue closes before dispatch opens
            by = {s.name: s for s in tree["spans"]}
            assert by["queue"].t1 <= by["dispatch"].t0 + 1e-12
        assert tracer.counters()["sched.resolve.n"] == b.metrics.batches
        say("clean storm: 6/6 complete span trees, exact decomposition")

        # -- 2) transient fault: retry span, stable trace id -------------
        inj.fail_next("transient")
        futs = await drive(b, 2)
        [f.result() for f in futs]
        trees = tracer.trees()[-2:]
        for tree in trees:
            names = [s.name for s in tree["spans"]]
            assert "retry" in names, names
            assert tree["terminal"] == "complete"
            assert tree["breakdown_us"]["retry_us"] > 0.0
            bd = tree["breakdown_us"]
            recon = (bd["queue_wait_us"] + bd["assemble_us"]
                     + bd["dispatch_us"])
            assert abs(bd["total_us"] - recon) < 1.0, bd
        say("transient: retry span on the same trace, sums still exact")
        storm_snap = b.metrics.snapshot(clock.now())

    # -- 3) degradation: attempt spans on both routes, one trace ---------
    inj3 = FaultInjector(persistent_routes={"kernels"})
    rex3 = ResilientExecutor(inj3.wrap(InlineExecutor()),
                             retry=RetryPolicy(max_attempts=2, jitter=0.0))

    def routed(xs, route=None):
        return _stub_infer(xs)

    async with MicroBatcher(_stub_infer, name="sine", max_batch=4,
                            max_delay_s=0.001, clock=clock,
                            classes=classes, executor=rex3,
                            infer_routed=routed,
                            routes=("kernels", "compiled"),
                            tracer=tracer) as b:
        futs = await drive(b, 2)
        [f.result() for f in futs]
        tree = tracer.trees()[-1]
        assert tree["terminal"] == "complete"
        routes_tried = {s.attrs.get("route") for s in tree["spans"]
                        if s.name == "attempt"}
        assert routes_tried == {"kernels", "compiled"}, routes_tried
        assert any(s.name == "degrade" for s in tree["spans"])
        say("degradation: kernels attempts fail, compiled serves, "
            "one stable trace")

    # -- 4) breaker-open storm: flight dumps (flush_error + breaker) -----
    inj4 = FaultInjector()
    rex4 = ResilientExecutor(inj4.wrap(InlineExecutor()),
                             retry=RetryPolicy(max_attempts=1),
                             breaker=BreakerPolicy(failure_threshold=2,
                                                   recovery_s=10.0))
    async with MicroBatcher(_stub_infer, name="sine", max_batch=1,
                            max_delay_s=0.001, clock=clock,
                            classes=classes, executor=rex4,
                            tracer=tracer) as b:
        inj4.fail_next("transient", times=8)
        for _ in range(3):
            futs = await drive(b, 1)
            err = futs[0].exception()
            assert isinstance(err, FlushError), err
    assert flight.dumps >= 2, flight.status()
    assert "flush_error" in flight.reasons, flight.reasons
    assert "breaker_open" in flight.reasons, flight.reasons
    doc = json.loads(open(flight.path).read())
    assert doc["events"] and doc["reason"] == flight.reasons[-1]
    assert doc["clock_offset_ns"] is None  # virtual time: no epoch
    kinds = {e["kind"] for e in doc["events"]}
    assert {"terminal", "fault", "breaker"} <= kinds, kinds
    say(f"breaker storm: {flight.dumps} dumps "
        f"({sorted(set(flight.reasons))}), postmortem parses")

    # -- 5) bounded retention + histogram/ terminal accounting -----------
    n_terms = sum(tracer.counts[k] for k in TERMINALS)
    assert tracer.hists["total"].n == n_terms, \
        (tracer.hists["total"].n, n_terms)
    assert tracer.counts["complete"] == 10
    assert tracer.counts["failed"] == 3
    say(f"accounting: {n_terms} terminals == total-histogram count")

    # -- 6) export renders and parses ------------------------------------
    # Use the real snapshot from the section-1/2 storm so the --demo
    # exposition shows the scenario's actual request accounting.
    text = openmetrics({"sine": storm_snap}, tracer=tracer)
    for needle in ("# TYPE repro_requests counter", "repro_stage_us_bucket",
                   'stage="device"', "repro_compile_events_total",
                   "# EOF"):
        assert needle in text, needle
    snap = json_snapshot({"sine": storm_snap}, tracer=tracer,
                         flight=flight)
    assert set(snap["stage_breakdown_us"]) == \
        {"queue_wait_us", "pad_us", "device_us", "retry_us"}
    assert snap["flight"]["dumps"] == flight.dumps
    json.dumps(snap)  # must be JSON-serializable as-is
    say("export: OpenMetrics + JSON snapshot render")
    return text


def selftest(verbose: bool = False) -> int:
    with tempfile.TemporaryDirectory(prefix="repro-obs-") as tmp:
        asyncio.run(_scenario(tmp, verbose=verbose))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Observability selftest / OpenMetrics demo")
    p.add_argument("--selftest", action="store_true",
                   help="replay the seeded FakeClock scenario and assert "
                        "complete span trees + a valid flight dump")
    p.add_argument("--demo", action="store_true",
                   help="print the scenario's OpenMetrics exposition")
    p.add_argument("-q", "--quiet", action="store_true")
    args = p.parse_args(argv)
    if not (args.selftest or args.demo):
        p.print_help()
        return 2
    with tempfile.TemporaryDirectory(prefix="repro-obs-") as tmp:
        text = asyncio.run(_scenario(tmp, verbose=not args.quiet))
    if args.demo:
        print(text, end="")
    if args.selftest:
        print("obs selftest: OK (complete span trees, exact stage "
              "decomposition, flight dump parses, export renders)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
