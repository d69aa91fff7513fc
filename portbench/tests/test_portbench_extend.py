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
