"""How often the profiler's trace of five person bucket-8 calls holds fewer
than their five host-to-device copies. ``chip_smoke.py``'s ``trace`` phase
holds the engine's own count of one such window (``CompiledModel``'s
``h2d_copies`` / ``h2d_bytes``) to exactly five, and the trace to no more
than that; this repeats the window, with the profiler entered right before
the calls (as that phase does) and with a warm-up step of the profiler's
schedule before them, alternating, and reads both counts in each. On the
card:

  python3 tools/probe_trace_h2d.py [--windows N]

prints one JSON line: for each variant, the windows run, how many copies
each window's trace held and how many the engine counted (each a count to
its number of windows), and the windows whose trace held fewer copies
than the engine made.
"""
import argparse
import collections
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402


def window(cm, xq, warmup: bool) -> tuple:
    """The bytes of each H2D copy in the trace of five bucket-8 calls, and
    the copies the engine counted over the same calls."""
    from torch.profiler import ProfilerActivity, profile, schedule
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if not warmup:
        with profile(activities=acts) as prof:
            before = cm.h2d_copies
            for _ in range(5):
                cm.predict_q_many(xq, max_batch=CS.MAX_BATCH)
            torch.cuda.synchronize()
            counted = cm.h2d_copies - before
        return CS.h2d_copies(prof)["bytes"], counted
    with profile(activities=acts, schedule=schedule(
            wait=0, warmup=1, active=1, repeat=1)) as prof:
        cm.predict_q_many(xq, max_batch=CS.MAX_BATCH)  # traced, discarded
        torch.cuda.synchronize()
        prof.step()
        before = cm.h2d_copies
        for _ in range(5):
            cm.predict_q_many(xq, max_batch=CS.MAX_BATCH)
        torch.cuda.synchronize()
        counted = cm.h2d_copies - before
        prof.step()
    return CS.h2d_copies(prof)["bytes"], counted


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=40)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_trace_h2d: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.configs.paper_models import build_person
    from repro_torch.core.engine import CompiledModel
    from repro_torch.core.quantize import quantize_graph
    from repro_torch.kernels import _build
    _build.build()
    rng = np.random.default_rng(CS.SEED)
    qg = quantize_graph(build_person(), [rng.normal(0, 1, (1, 96, 96, 1))
                                         .astype("f") for _ in range(2)],
                        device="cuda")
    xq = np.stack([qg.tensor(qg.inputs[0]).qparams.quantize(
        rng.normal(0, 1, (1, 96, 96, 1)).astype("f")) for _ in range(8)])
    cm = CompiledModel(qg, use_kernels=True, device="cuda")
    cm.predict_q_many(xq, max_batch=CS.MAX_BATCH)
    torch.cuda.synchronize()
    want = [CS.H2D_ROWS_B8] * 5
    seen = {"plain": collections.Counter(), "warmup": collections.Counter()}
    counts = {"plain": collections.Counter(), "warmup": collections.Counter()}
    wrong = {"plain": [], "warmup": []}
    lost = {"plain": 0, "warmup": 0}
    for i in range(2 * args.windows):
        name = ("plain", "warmup")[i % 2]
        got, counted = window(cm, xq, name == "warmup")
        seen[name][len(got)] += 1
        counts[name][counted] += 1
        lost[name] += len(got) < counted
        if got != want:
            wrong[name].append(got)
    print(json.dumps({"probe": "trace_h2d", "windows": args.windows,
                      "copies_per_window": {k: dict(v)
                                            for k, v in seen.items()},
                      "counted_per_window": {k: dict(v)
                                             for k, v in counts.items()},
                      "windows_trace_lost_a_copy": lost,
                      "windows_off": {k: len(v) for k, v in wrong.items()},
                      "off_examples": {k: v[:3] for k, v in wrong.items()},
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
