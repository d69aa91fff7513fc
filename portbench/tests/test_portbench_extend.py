"""A configuration, a traffic mix and a per-layer metric are added by new
files and new entries of BENCHMARK.json alone: in a copy of the harness, a
throwaway set of them gives a new cell, and no file that was there
changes."""
import hashlib
import json
import os
import shutil
import subprocess
import sys

from _small import ROOT

TINY = {
    "name": "tiny", "source": "a test model", "reference": "int8_cnn",
    "dtype": "int8", "input": [8, 8, 1], "classes": 3,
    "layers": [
        {"name": "conv", "op": "conv", "kernel": [3, 3], "stride": [1, 1],
         "out": 4, "fused": "RELU"},
        {"name": "dw", "op": "dwconv", "kernel": [3, 3], "stride": [2, 2],
         "fused": "RELU6"},
        {"name": "reshape", "op": "reshape"},
        {"name": "fc", "op": "fc", "out": 3, "fused": "NONE"},
        {"name": "softmax", "op": "softmax"}],
    "init": {"w": "he", "w_gain": 1.0, "b_std": 0.1, "fc_w_std": 0.05,
             "logit_std": 1.5},
    "frames": {"noise_std": 1.0, "gain": [0.3, 2.0], "offset": [-1, 1]},
    "calibration_rows": 16, "limits": {"max_gap_lsb": 0}}
MIX = {"entry": "predict_q_many", "rows_per_call": 16, "max_batch": 8,
       "pool_rows": 64, "warm_s": 0.1}
METRIC = '''
def read(run):
    return float(run.rec.phase_a["rows"]) if run.rec.phase_a else None
'''


def digests(root):
    out = {}
    for d, _, files in os.walk(root):
        if "__pycache__" in d:
            continue
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_cell_from_files_alone(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(tmp_path / "portbench")
    (tmp_path / "portbench/configs/tiny.json").write_text(json.dumps(TINY))
    (tmp_path / "portbench/traffic/tiny_bulk.json").write_text(
        json.dumps(MIX))
    (tmp_path / "portbench/metrics/tiny.rows_counted.rows.py").write_text(
        METRIC)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["configs"].append({"name": "tiny", "source": "a test model",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny.bulk", "config": "tiny",
                               "traffic": "tiny_bulk", "chips": 1,
                               "why": "test"})
    {m["name"]: m for m in bench["end_to_end"]}["rows_per_s"][
        "workloads"].append("tiny.bulk")
    bench["per_layer"].append({
        "name": "tiny.rows_counted.rows", "unit": "rows", "better": "higher",
        "source": "program_counter", "layer": "engine",
        "moves": "rows_per_s", "workloads": ["tiny.bulk"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys, json; sys.path[:0] = [%r, %r]\n"
        "from portbench.harness import load_json, run_cell\n"
        "b = load_json('BENCHMARK.json')\n"
        "cell = {c['name']: c for c in b['workloads']}['tiny.bulk']\n"
        "out = [run_cell(b, cell, 77, 0.5, t, device='cpu') "
        "for t in (False, True)]\n"
        "print(json.dumps([{k: r[k] for k in ('correct', 'metrics')} "
        "for r in out]))\n" % (str(tmp_path), os.path.join(ROOT, "src")))
    got = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr[-2000:]
    plain, traced = json.loads(got.stdout.strip().splitlines()[-1])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"rows_per_s", "setup_s"}
    assert "tiny.rows_counted.rows" in traced["metrics"]
    after = digests(tmp_path / "portbench")
    assert {k: after[k] for k in before} == before


# A family of another kind: float32 answers, a vector a row, checked against
# a float64 reference under a relative tolerance, its work counted against
# the float32 peak. Plain torch, so that it runs in seconds on the CPU.
F32_FAMILY = '''
import time

import numpy as np
import torch

from portbench.reference import load as load_reference

PC = time.perf_counter


def _gen(seed, stream, device):
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 2 + stream) % 2**63)
    return g


def model(config, seed, device):
    d, n = config["width"], config["out"]
    wb = torch.randn(d * n + n, generator=_gen(seed, 0, device),
                     device=device)
    return {"w": wb[:d * n].reshape(d, n) / d ** 0.5, "b": wb[d * n:]}


def pool(config, model, traffic, seed, device):
    return torch.randn(int(traffic["pool_rows"]), config["width"],
                       generator=_gen(seed, 1, device), device=device)


def engine(model, device):
    def forward(x):
        return torch.tanh(x @ model["w"] + model["b"])
    return forward


class Driver:
    def __init__(self, traffic, forward, pool):
        self.forward, self.pool = forward, pool
        self.n = int(traffic["rows_per_call"])
        self.done = 0

    def counters(self):
        return {"calls": self.done}

    def loop(self, rec, until, phases=None):
        rows = calls = 0
        blocks = self.pool.shape[0] // self.n
        while True:
            now = PC()
            if now >= until:
                break
            if phases is not None and phases.due(now):
                phases.switch(rows, calls)
            lo = (self.done % blocks) * self.n
            t0 = PC()
            y = self.forward(self.pool[lo:lo + self.n]).cpu().numpy()
            rec.lat.append(PC() - t0)
            rec.idx.extend(range(lo, lo + self.n))
            rec.answers.append(y)
            rows += self.n
            calls += 1
            self.done += 1
            rec.attempted += self.n
        rec.calls += calls
        return rows, calls

    def warm(self, seconds):
        from portbench.drive import Record
        rec = Record()
        rec.answers = []
        self.loop(rec, PC() + seconds)

    def window(self, rec, seconds, phases):
        rec.answers = []
        rows, calls = self.loop(rec, phases.t_end, phases)
        rec.t_close = PC()
        phases.finish(rows, calls)

    def close(self):
        self.forward = None


def driver(traffic, engine, pool, trace):
    return Driver(traffic, engine, pool)


def check(model, config, rec, pool, device):
    idx = np.frombuffer(rec.idx, np.int64)
    out = np.concatenate(rec.answers)
    ref = load_reference(config["reference"]).forward(
        model, pool[torch.as_tensor(idx)]).cpu().numpy()
    err = np.abs(out - ref).max(axis=1) / np.abs(ref).max(axis=1)
    limit = float(config["limits"]["rtol"])
    wrong = int((err > limit).sum())
    return {"answered": len(idx), "wrong": wrong,
            "compared": {
                "raised": {"value": rec.raised, "limit": 0},
                "rows_wrong": {"value": wrong, "limit": 0},
                "max_rel_err": {"value": float(err.max(initial=0)),
                                "limit": limit},
                "answered": {"value": len(idx), "min": 1}}}


def work(config):
    d, n = config["width"], config["out"]

    def counted(rows, calls=1, ops=None):
        return {"flops": 2 * rows * d * n,
                "bytes": 4 * (rows * (d + n) + calls * (d * n + n)),
                "transcendentals": rows * n}

    counted.peak = "f32_flops_per_s"
    return counted
'''
F32_REFERENCE = '''
import torch


def forward(model, x):
    """tanh(x W + b) in float64."""
    return torch.tanh(x.double() @ model["w"].double()
                      + model["b"].double())
'''
F32_READER = '''
from portbench.metrics import roofline


def read(run):
    return roofline(run)
'''
F32_CONFIG = {"name": "tinyf32", "family": "tiny_f32",
              "reference": "tiny_f32", "width": 256, "out": 256,
              "limits": {"rtol": 1e-4}}
F32_MIX = {"rows_per_call": 256, "pool_rows": 1024, "warm_s": 0.1}
# On the CPU the profiler sees no card: the CPU's matrix products stand for
# the card's kernels, and the card's peaks for the CPU's.
F32_RUNS = '''
import sys, json, time; sys.path[:0] = [%r, %r]
from portbench import devtrace, families, harness, metrics


class CpuTrace(devtrace.DeviceTrace):
    def stop(self):
        window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        host = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                for e in self.prof.profiler.kineto_results.events()]
        self.prof = None
        return devtrace.reduce([h + ("kernel",) for h in host
                                if h[0] == "aten::mm"], host, window_s)


harness.DeviceTrace = CpuTrace
card = harness.load_json("portbench/peaks.json")["NVIDIA H100 80GB HBM3"]
metrics.peak_of = lambda kind: card
b = harness.load_json("BENCHMARK.json")
cell = {c["name"]: c for c in b["workloads"]}["tinyf32.bulk"]
seen = {}


def inspect(model, config, rec, pool):
    seen.update(rows=rec.trace["rows"], calls=rec.trace["calls"],
                secs=metrics.kernel_s(harness.Run(None, rec, 0, card, 0)))


out = [harness.run_cell(b, cell, 77, 0.5, False, device="cpu"),
       harness.run_cell(b, cell, 77, 0.5, True, device="cpu",
                        inspect=inspect)]
fam = families.load("tiny_f32")
engine = fam.engine
fam.engine = lambda m, d: (lambda x: engine(m, d)(x) * (1 + 1.2e-4))
out.append(harness.run_cell(b, cell, 78, 0.5, False, device="cpu"))
print(json.dumps({"runs": [{k: r[k] for k in ("correct", "failed",
                                              "metrics", "compared")}
                           for r in out], "seen": seen, "card": card}))
'''


def test_new_family_from_files_alone(tmp_path):
    """A family whose answers are float32 vectors, checked against a
    float64 reference under a relative tolerance and counted against the
    float32 peak, added with its configuration, mix, cell and reader by
    new files and entries alone: right plain and traced, its roofline read
    from its own count, and wrong once its program is off by 1.2 times
    the tolerance."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(tmp_path / "portbench")
    pb = tmp_path / "portbench"
    (pb / "families/tiny_f32.py").write_text(F32_FAMILY)
    (pb / "reference/tiny_f32.py").write_text(F32_REFERENCE)
    (pb / "configs/tinyf32.json").write_text(json.dumps(F32_CONFIG))
    (pb / "traffic/tinyf32_bulk.json").write_text(json.dumps(F32_MIX))
    (pb / "metrics/tinyf32_roofline.rows.py").write_text(F32_READER)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["configs"].append({"name": "tinyf32", "source": "a test model",
                             "file": "portbench/configs/tinyf32.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tinyf32.bulk", "config": "tinyf32",
                               "traffic": "tinyf32_bulk", "chips": 1,
                               "why": "test"})
    {m["name"]: m for m in bench["end_to_end"]}["rows_per_s"][
        "workloads"].append("tinyf32.bulk")
    bench["per_layer"].append({
        "name": "tinyf32_roofline.rows", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "kernels",
        "moves": "rows_per_s", "workloads": ["tinyf32.bulk"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = F32_RUNS % (str(tmp_path), os.path.join(ROOT, "src"))
    got = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr[-2000:]
    line = json.loads(got.stdout.strip().splitlines()[-1])
    plain, traced, off = line["runs"]
    assert plain["correct"] and traced["correct"]
    assert plain["failed"] == traced["failed"] == 0
    assert set(plain["metrics"]) == {"rows_per_s", "setup_s"}
    assert list(traced["metrics"]) == ["tinyf32_roofline.rows"]
    assert plain["compared"]["max_rel_err"]["value"] <= 1e-4
    # the reader's share is the family's own count over the float32 peak,
    # which bounds it (the bytes over the bandwidth take less)
    seen, card = line["seen"], line["card"]
    rows, calls, d, n = seen["rows"], seen["calls"], 256, 256
    need = 2 * rows * d * n / card["f32_flops_per_s"]
    assert need > 4 * (rows * (d + n) + calls * (d * n + n)) \
        / card["hbm_bytes_per_s"]
    assert rows > 0 and seen["secs"] > 0
    assert traced["metrics"]["tinyf32_roofline.rows"]["value"] == \
        100.0 * need / seen["secs"]
    assert off["correct"] is False
    assert off["compared"]["rows_wrong"]["value"] > 0
    assert off["failed"] == off["compared"]["rows_wrong"]["value"]
    after = digests(tmp_path / "portbench")
    assert {k: after[k] for k in before} == before
