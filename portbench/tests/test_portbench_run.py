"""Whole runs of each cell on the CPU at small sizes: the result line's keys,
every answer checked, the batcher's shed and expiry counters at 0, and
``correct`` false when the timed path is broken underneath."""
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from portbench.run import emit, forbidden_modules
from _small import ROOT, SMALL, run_small

CELLS = sorted(SMALL)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_result_line(name, trace):
    res = run_small(name, trace=trace)
    out, err = io.StringIO(), io.StringIO()
    emit(res, out, err)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    if trace:
        keys.append("breakdown")
    assert list(line) == keys + ["compared"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == line["compared"]["answered"]["value"] > 0
    assert err.getvalue().strip().splitlines()[-1].startswith(
        "compared answered")
    if not trace:
        assert "setup_s" in line["metrics"]
    if name == "person.flood":
        notes = json.loads(err.getvalue().splitlines()[0][len("notes "):])
        assert notes["batcher"] == {"rejected": 0, "preempted": 0,
                                    "deadline_exceeded": 0, "failed": 0}


def _swap(ys):
    ys = np.array(ys)
    if len(ys) > 1:
        ys[[0, 1]] = ys[[1, 0]]
    return ys


def _half(ys):
    ys = np.array(ys)
    h = max(1, len(ys) // 2)
    ys[h:] = np.round(ys[:h].astype(np.float64).mean(0)).astype(ys.dtype)
    return ys


def _alter(ys):
    ys = np.array(ys)
    v = int(ys.reshape(-1)[0])
    ys.reshape(-1)[0] = (v + 128 + 128) % 256 - 128  # 128 steps off
    return ys


FAULTS = {"swap": _swap, "half": _half, "alter": _alter}


# one row a call on the per-call path: it has no half of a batch to leave out
BROKEN = [(n, f) for n in CELLS for f in sorted(FAULTS)
          if not (n == "person.direct" and f == "half")]


@pytest.mark.parametrize("name,fault", BROKEN)
def test_broken_path_is_not_correct(name, fault, monkeypatch):
    """The timed path broken where an answer is produced: two rows of a
    bucket exchange answers (on the per-call path, each call gets the
    previous call's answer), half of a bucket answered by the mean of the
    rest, one value of an answer altered."""
    from repro_torch.core.engine import CompiledModel
    if name == "person.direct":
        orig = CompiledModel.predict_q
        last = {}

        def broken(self, *xs):
            y = orig(self, *xs)
            if fault == "swap":
                prev, last["y"] = last.get("y"), y
                return y if prev is None else prev
            return FAULTS[fault](y)

        monkeypatch.setattr(CompiledModel, "predict_q", broken)
    else:
        orig = CompiledModel.predict_q_staged
        monkeypatch.setattr(
            CompiledModel, "predict_q_staged",
            lambda self, bufs, rows: FAULTS[fault](
                orig(self, bufs, rows)))
    res = run_small(name)
    assert res["correct"] is False
    assert res["failed"] > 0


def test_no_jax_in_the_harness():
    """A small run in a fresh process loads no module named jax, jaxlib,
    flax or repro (names compared whole: repro_torch is the program)."""
    code = ("import sys; sys.path[:0] = [%r, %r]; sys.path.insert(0, %r)\n"
            "from _small import run_small\n"
            "from portbench.run import forbidden_modules\n"
            "from portbench import control, metrics\n"
            "import portbench.harness as h, json\n"
            "for m in json.load(open(%r))['per_layer']: "
            "metrics.load(m['name'])\n"
            "assert run_small('person.flood', trace=True)['correct']\n"
            "print(forbidden_modules())\n"
            % (os.path.join(ROOT, "src"), ROOT,
               os.path.dirname(os.path.abspath(__file__)),
               os.path.join(ROOT, "BENCHMARK.json")))
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert got.returncode == 0, got.stderr[-2000:]
    assert got.stdout.strip().splitlines()[-1] == "[]"
    assert forbidden_modules.__doc__


def test_run_without_cuda_prints_no_result():
    got = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "person.direct",
         "--seed", str(2**31 + 11), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert got.returncode != 0
    assert got.stdout.strip() == ""


def test_run_without_the_program_prints_no_result(tmp_path):
    """A directory with BENCHMARK.json and the harness alone."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "person.flood",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ""})
    assert got.returncode != 0
    assert got.stdout.strip() == ""


def test_open_loop_sweep(capsys):
    """The open-loop mix that ``sweep.py`` runs: every answer checked, the
    rate offered and the latency from when each request was due."""
    from portbench import sweep
    sweep.main(["--config", "speech", "--seed", "4", "--seconds", "0.5",
                "--rates", "40", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] > 0
    assert line["latency_p95_ms"] >= line["latency_p50_ms"] > 0
