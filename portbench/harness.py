"""One run of one cell: set-up, the measured window, the check of every
answer against the reference, and the result line. Everything that belongs
to one configuration, traffic mix or metric is a file found by its name in
``BENCHMARK.json``: ``configs/<config>.json``, ``traffic/<mix>.json`` and
``metrics/<metric>.py``; the configuration's model family (its model, rows,
engine, driver, check and count of work) is ``families/<family>.py``."""
from __future__ import annotations

import gc
import json
import time
from pathlib import Path

import numpy as np
import torch

from portbench import drive, families, metrics as MX
from portbench.devtrace import DeviceTrace
from portbench.reference import load as load_reference

HERE = Path(__file__).resolve().parent


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def cell_metrics(bench, cell, trace: bool) -> list:
    """The metrics this cell reports: its end-to-end ones untraced, its
    per-layer ones traced. A metric with a ``workloads`` key is reported in
    the cells it lists; one without it in every cell that reports the
    end-to-end metric it moves."""
    def listed(spec):
        return cell["name"] in spec.get("workloads", [cell["name"]])

    e2e = [m for m in bench["end_to_end"] if listed(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}

    def wanted(m):
        if "workloads" in m:
            return cell["name"] in m["workloads"]
        return m["moves"] in names

    return [m for m in bench["per_layer"] if wanted(m)]


class Run:
    """What a metric reader reads (see ``portbench/metrics``)."""

    def __init__(self, work, rec, setup_s, peak, rows_ok):
        self.work, self.rec, self.setup_s, self.peak = (
            work, rec, setup_s, peak)
        self.rows_ok = rows_ok  # answered and right
        self.window_s = rec.t_close - rec.t_start

    @property
    def layers(self):
        """The int8 family's layers (``model.shapes``)."""
        return self.work.layers


def answers(rec, classes: int):
    """The pool index and the answer of every row answered, as arrays."""
    idx = np.frombuffer(rec.idx, np.int64)
    return idx, np.frombuffer(rec.out, np.int8).reshape(len(idx), classes)


def check(qmodel, config, rec, pool_rows, device, block=1024) -> dict:
    """Every answer of the window against the reference's answer to its row.
    Returns the numbers compared, each with its limit, and the rows that
    answered wrong."""
    ref_mod = load_reference(config["reference"])
    limit = int(config["limits"]["max_gap_lsb"])
    ref = []
    for lo in range(0, pool_rows.shape[0], block):
        x = torch.as_tensor(pool_rows[lo:lo + block, 0], device=device)
        ref.append(ref_mod.forward_int8(qmodel, x, block).cpu().numpy())
    ref = np.concatenate(ref).astype(np.int16)
    idx, out = answers(rec, ref.shape[1])
    gap = np.abs(out.astype(np.int16) - ref[idx]).max(axis=1, initial=0)
    wrong = int((gap > limit).sum())
    return {"answered": len(gap), "wrong": wrong,
            "compared": {
                "raised": {"value": rec.raised, "limit": 0},
                "rows_wrong": {"value": wrong, "limit": 0},
                "max_gap_lsb": {"value": int(gap.max()) if len(gap) else 0,
                                "limit": limit},
                "answered": {"value": len(gap), "min": 1}}}


def device_info(device, chips: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def run_cell(bench, cell, seed: int, seconds: float, trace: bool,
             device="cuda", started=None, overrides=None,
             inspect=None, marks=None) -> dict:
    """One run of ``cell``: the result line as a dict. ``started``: the
    ``time.perf_counter()`` reading that stands for the process's start
    (set-up is counted from it); ``overrides`` replace traffic keys (the
    tests' small sizes); ``inspect(qmodel, config, rec, pool)``, when
    given, is called once the answers are checked (the control's
    readings), with the family's model and pool; ``marks``: seconds of
    set-up already spent, by step, noted with the harness's own."""
    started = time.perf_counter() if started is None else started
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = {**load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
               **(overrides or {})}
    specs = cell_metrics(bench, cell, trace)
    family = families.of(config)
    work = family.work(config)

    marks = {**(marks or {}), "start": time.perf_counter() - started}
    qmodel = family.model(config, seed, device)
    marks["model"] = time.perf_counter() - started
    pool = family.pool(config, qmodel, traffic, seed, device)
    marks["rows"] = time.perf_counter() - started
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    drv = family.driver(traffic, family.engine(qmodel, device), pool, trace)
    marks["engine"] = time.perf_counter() - started
    drv.warm(float(traffic["warm_s"]))
    marks["warm"] = time.perf_counter() - started
    devtrace = None
    if trace:
        devtrace = DeviceTrace(device)
        devtrace.start()  # the profiler's first start pays its own set-up
        devtrace.stop()
    rec = drive.Record()
    trace_s = min(2.0, seconds / 2)
    phases = drive.Phases(rec, seconds, trace_s, drv.counters, devtrace)
    setup_s = time.perf_counter() - started
    rec.t_start = phases.t_start
    drv.window(rec, seconds, phases)

    dev = device_info(device, cell["chips"])
    drv.close()
    del drv
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    verdict = family.check(qmodel, config, rec, pool, device)
    if inspect is not None:
        inspect(qmodel, config, rec, pool)
    run = Run(work, rec, setup_s, MX.peak_of(dev["kind"]),
              verdict["answered"] - verdict["wrong"])
    values = {}
    for spec in specs:
        v = MX.load(spec["name"]).read(run)
        if v is not None:
            values[spec["name"]] = {"value": float(v), "unit": spec["unit"]}
    if trace and rec.trace is not None and cuda:
        dev.update(busy_s=rec.trace["busy_s"],
                   window_s=rec.trace["window_s"])
    # a row sent and neither answered nor raised never came: it failed
    missing = rec.attempted - verdict["answered"] - rec.raised
    failed = rec.raised + verdict["wrong"] + max(0, missing)
    compared = verdict["compared"]
    correct = (failed == 0 and verdict["answered"] >= 1
               and all(c["value"] <= c["limit"] for c in compared.values()
                       if "limit" in c))
    result = {"correct": bool(correct), "attempted": rec.attempted,
              "failed": failed, "metrics": values, "device": dev}
    if trace and rec.trace is not None:
        ops = sorted(rec.trace["ops"].items(), key=lambda kv: -kv[1][0])
        result["breakdown"] = {
            "device_ops": [[name[:96], s] for name, (s, _, _) in ops[:10]],
            "idle_gaps": [[name[:96], s] for name, s in rec.trace["gaps"]]}
    result["compared"] = compared
    result["_notes"] = {**rec.notes, "errors": rec.errors,
                        "window_s": run.window_s,
                        "setup_marks_s": marks, "setup_s": setup_s}
    return result
