"""Metric readers. Each metric of ``BENCHMARK.json`` is read by
``metrics/<name>.py``, whose ``read(run)`` takes a
:class:`portbench.harness.Run` and returns the number, or None when the run
holds nothing to read (the metric is then left out of the line; a share of
a roofline or a peak is never given as 0). The helpers below are shared."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def load(name: str):
    path = HERE / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def peak_of(kind: str):
    """The card's published peaks (``peaks.json``), or None for a card the
    table does not hold."""
    with open(HERE.parent / "peaks.json") as fh:
        return json.load(fh).get(kind)


def phase_a(run):
    """The counted phase of a traced run (None untraced): its seconds, rows,
    calls, requests and the program's counters over it."""
    return run.rec.phase_a


def kernel_s(run, match=None) -> float:
    """Seconds of the traced kernels whose name ``match`` accepts (all
    kernels when None); memory copies and sets are not kernels."""
    tr = run.rec.trace
    if tr is None:
        return 0.0
    return sum(s for name, (s, _, kind) in tr["ops"].items()
               if "kernel" in kind and (match is None or match(name)))


def bound_s(work: dict, peak: dict, key: str) -> float:
    """The least time the card could take: the larger of the products over
    its ``key`` peak and the bytes over the memory bandwidth."""
    return max(work["flops"] / peak[key],
               work["bytes"] / peak["hbm_bytes_per_s"])


def roofline(run, ops=None, match=None):
    """Percent of the roofline: the least time the traced rows need (the
    family's frozen count of ``ops``, all when None, against its peak)
    over the kernels' time."""
    tr, peak = run.rec.trace, run.peak
    secs = kernel_s(run, match)
    if tr is None or peak is None or secs <= 0 or tr["rows"] <= 0:
        return None
    work = run.work(tr["rows"], tr["calls"], ops)
    return 100.0 * bound_s(work, peak, run.work.peak) / secs


def mfu(run):
    """Percent of the card's peak in the family's dtype that the first
    phase's answered rows needed, over that phase's seconds."""
    a, peak = run.rec.phase_a, run.peak
    if a is None or peak is None or a["s"] <= 0:
        return None
    flops = run.work(a["rows"])["flops"]
    return 100.0 * flops / (a["s"] * peak[run.work.peak])


def idle(run):
    tr = run.rec.trace
    if tr is None or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def percentile_ms(lat, q):
    return None if not lat else 1e3 * float(np.percentile(lat, q))


def is_qmatmul(name: str) -> bool:
    return "qmatmul_kernel" in name and "paged_qmatmul" not in name


def is_qdwconv(name: str) -> bool:
    return "qdwconv_kernel" in name
