"""BENCHMARK.json keeps to the form the benchmark's driver reads, and every
name in it has its file: a configuration, a traffic mix, a metric reader."""
import json
import os
import re

import pytest

from _small import ROOT, bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
B = bench()
E2E = {m["name"]: m for m in B["end_to_end"]}
CELLS = {c["name"]: c for c in B["workloads"]}


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_top_level():
    assert list(B) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    assert B["command"] == ["python3", "portbench/run.py"]
    assert B["paths"] == ["portbench"]
    rs = B["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits the driver's 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cfg", B["configs"], ids=lambda c: c["name"])
def test_configs(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and line(cfg["source"]) and line(
        cfg["why"])
    assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
    with open(os.path.join(ROOT, cfg["file"])) as fh:
        assert json.load(fh)["name"] == cfg["name"]
    assert cfg["reduced"] == []
    assert any(c["config"] == cfg["name"] for c in CELLS.values())


@pytest.mark.parametrize("cell", B["workloads"], ids=lambda c: c["name"])
def test_cells(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert line(cell["why"]) and cell["chips"] == 1
    assert os.path.exists(os.path.join(
        ROOT, "portbench", "traffic", f"{cell['traffic']}.json"))
    e2e = [m["name"] for m in B["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell["name"] in m["workloads"] for m in B["per_layer"])


def test_cell_pairs_are_unique():
    pairs = [(c["config"], c["traffic"]) for c in B["workloads"]]
    assert len(set(pairs)) == len(pairs)


@pytest.mark.parametrize("m", B["end_to_end"] + B["per_layer"],
                         ids=lambda m: m["name"])
def test_metrics(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                       f"{m['name']}.py"))
    for cell in m.get("workloads", []):
        assert cell in CELLS
    if m["name"] in E2E:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert line(m["layer"]) and m["moves"] in E2E
        moved = E2E[m["moves"]]
        # every cell listed reports the end-to-end metric this one moves
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell])
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


def test_setup_bound():
    assert E2E["setup_s"]["bound"] == 0.25
    assert "workloads" not in E2E["setup_s"]
