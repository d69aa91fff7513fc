"""Where the host time of a bucket call goes, cell by cell: each cell of
``BENCHMARK.json`` run as ``portbench/run.py --trace 1`` runs it, with one
difference: a ``repro_torch.obs.Tracer`` is bound to the engine in every
entry (not only behind the registry), and its counters are read over the
counted phase. One JSON line a cell:

* ``spans_us``: the mean microseconds per occurrence of each counted span
  (``engine.stage`` / ``launch`` / ``sync`` / ``unstage`` per engine call,
  ``sched.resolve`` per flush), None where the program has no such
  counter;
* ``engine_sum_us``: the four engine spans added up, against
  ``call_us``: the cell's ``engine.call_us.*`` reading, or for a
  ``predict_q`` cell the counted phase's seconds per call;
* ``share``: each engine span's part of ``engine_sum_us``;
* the traced phase's ``idle_gaps`` and ``device_ops`` (as the result line
  has them), ``named_by_span``: the gaps the profiler names by a counted
  span or ``flush_assemble``, and ``span_named_device_ops``: the traced
  phase's device operations (all of them, not only the ten longest)
  bearing such a name (there should be none);
* the cell's per-layer readings, as the benchmark reads them.

``--pairs N`` instead times person.direct's traffic with a Tracer bound
and without, alternating call by call, in N windows in one process, and
prints each window's median latency of either kind and their ratios.

    python tools/engine_spans.py --cells person.flood person.direct \\
        --seed 3000001001 --seconds 20
    python tools/engine_spans.py --pairs 10 --seconds 3 --seed 3000001001

``--device cpu`` runs it without a card (the device trace is then the
CPU's). The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPANS = ("engine.stage", "engine.launch", "engine.sync", "engine.unstage",
         "sched.resolve")
NAMED = SPANS + ("flush_assemble",)


def bound_driver(drive, make_tracer):
    """``drive.driver`` with a Tracer in every entry: bound to the engine
    (``model.tracer``) and its counters merged into the driver's."""
    orig = drive.driver

    def driver(traffic, model, pool, tracer=None):
        tracer = tracer if tracer is not None else make_tracer()
        drv = orig(traffic, model, pool, tracer)
        model.tracer = tracer
        counted = getattr(tracer, "counters", None)
        if counted is not None:
            base = drv.counters
            drv.counters = lambda: {**base(), **counted()}
        return drv
    return driver


def readings(result, phase_a, device_ops, entry) -> dict:
    """The counted spans' means, their sum against the call's time, and
    what the traced phase's device trace (``device_ops``: the names of its
    operations) names by them."""
    counters = phase_a["counters"] if phase_a else {}
    spans = {}
    for name in SPANS:
        n = counters.get(name + ".n")
        spans[name] = (counters[name + ".sum_us"] / n) if n else None
    engine = [spans[n] for n in SPANS[:4] if spans[n] is not None]
    total = sum(engine) if engine else None
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    call = next((v for k, v in metrics.items()
                 if k.startswith("engine.call_us.")), None)
    if call is None and entry == "predict_q" and phase_a \
            and phase_a["calls"]:
        call = 1e6 * phase_a["s"] / phase_a["calls"]
    bd = result.get("breakdown", {})
    gaps = bd.get("idle_gaps", [])
    return {
        "spans_us": spans, "engine_sum_us": total, "call_us": call,
        "sum_over_call": (total / call) if total and call else None,
        "share": ({n: spans[n] / total for n in SPANS[:4]
                   if spans[n] is not None} if total else None),
        "idle_gaps": gaps, "device_ops": bd.get("device_ops", []),
        "named_by_span": sum(1 for g in gaps if g[0] in NAMED),
        "no_traced_host_op": sum(1 for g in gaps
                                 if g[0] == "no_traced_host_op"),
        "span_named_device_ops": [n for n in device_ops if n in NAMED],
        "metrics": metrics, "correct": result["correct"],
        "device": result["device"]}


def run_cells(names, seed, seconds, device, overrides=None) -> list:
    from portbench import drive, harness
    from repro_torch.obs.trace import Tracer
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {c["name"]: c for c in bench["workloads"]}
    drive.driver = bound_driver(drive, Tracer)
    out = []
    for name in names:
        cell = cells[name]
        traffic = harness.load_json(os.path.join(
            ROOT, "portbench", "traffic", f"{cell['traffic']}.json"))
        got = {}

        def inspect(qmodel, config, rec, pool):
            got.update(a=rec.phase_a,
                       ops=list(rec.trace["ops"]) if rec.trace else [])

        res = harness.run_cell(bench, cell, seed, seconds, True,
                               device=device, inspect=inspect,
                               overrides=(overrides or {}).get(name))
        out.append({"cell": name, "seed": seed,
                    **readings(res, got.get("a"), got.get("ops", []),
                               traffic["entry"])})
    return out


def run_pairs(pairs, seed, seconds, device) -> dict:
    """person.direct's calls with a Tracer bound and without, alternating
    call by call, in ``pairs`` windows of ``seconds``: each window's median
    latency (ms) of either kind and their ratio, so that drift between
    windows cancels."""
    import numpy as np
    from portbench import drive, harness, model as M, port
    from repro_torch.obs.trace import Tracer
    config = harness.load_json(os.path.join(ROOT, "portbench", "configs",
                                            "person.json"))
    traffic = harness.load_json(os.path.join(ROOT, "portbench", "traffic",
                                             "direct.json"))
    qmodel = M.make_model(config, seed, device)
    pool = drive.Pool(config, qmodel, traffic, seed, device)
    cm = port.compiled_model(qmodel, device)
    drive.driver(traffic, cm, pool).warm(float(traffic["warm_s"]))
    tracer = Tracer()
    pc = time.perf_counter
    p50 = {"off": [], "on": []}
    for _ in range(pairs):
        lat = {"off": [], "on": []}
        until = pc() + seconds
        while pc() < until:
            for mode, bound in (("off", None), ("on", tracer)):
                cm.tracer = bound
                x = pool.rows[pool.next_index()]
                t0 = pc()
                cm.predict_q(x)
                lat[mode].append(pc() - t0)
        for mode in p50:
            p50[mode].append(1e3 * float(np.median(lat[mode])))
    cm.tracer = None
    ratios = [b / a for a, b in zip(p50["off"], p50["on"])]
    counted = tracer.counters()
    calls = counted["engine.stage.n"] or 1
    return {"pairs": pairs, "seconds": seconds, "p50_ms": p50,
            "ratio_of_medians": (statistics.median(p50["on"])
                                 / statistics.median(p50["off"])),
            "pair_ratios": ratios,
            "median_pair_ratio": statistics.median(ratios),
            "spans_per_call": {n: v / calls for n, v in counted.items()
                               if n.endswith(".n")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", nargs="+", default=[])
    ap.add_argument("--pairs", type=int, default=0)
    ap.add_argument("--seed", type=int, default=3000001001)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="also append each line to this file")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from portbench.run import _environment
    _environment()  # the benchmark's threads and cache directories
    lines = []
    if args.cells:
        lines += run_cells(args.cells, args.seed, args.seconds, args.device)
    if args.pairs:
        lines.append(run_pairs(args.pairs, args.seed, args.seconds,
                               args.device))
    for line in lines:
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
