"""Repeated runs of one cell through the benchmark's own command, each in a
fresh process and with its own seed, and the spread of every metric: the
distance between the first and third quartiles (``statistics.quantiles``,
n=4) as a share of the median. The bounds of ``BENCHMARK.json`` are set
from these spreads.

    python3 portbench/sets.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...] [--trace 0|1] [--out <file.jsonl>]
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spread(values) -> float:
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else float("nan")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--trace", default="0")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    lines = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = subprocess.run(
            [sys.executable, os.path.join("portbench", "run.py"),
             "--workload", args.workload, "--seed", str(seed), "--seconds",
             args.seconds, "--trace", args.trace],
            cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        out = got.stdout.strip().splitlines()
        res = json.loads(out[-1]) if got.returncode == 0 and out else None
        tail = [ln for ln in got.stderr.splitlines()
                if ln.startswith(("notes", "compared"))]
        line = {"workload": args.workload, "seed": seed, "rc": got.returncode,
                "wall_s": wall, "result": res, "stderr": tail or
                got.stderr[-1500:]}
        lines.append(line)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(line) + "\n")
        short = {k: v["value"] for k, v in (res or {}).get("metrics",
                                                          {}).items()}
        print(json.dumps({"seed": seed, "rc": got.returncode,
                          "wall_s": round(wall, 1),
                          "correct": (res or {}).get("correct"),
                          "failed": (res or {}).get("failed"),
                          **short}), flush=True)
    ok = [x["result"] for x in lines if x["result"]]
    names = sorted({k for r in ok for k in r["metrics"]})
    summary = {}
    for k in names:
        vals = [r["metrics"][k]["value"] for r in ok if k in r["metrics"]]
        if len(vals) >= 2:
            summary[k] = {"median": statistics.median(vals),
                          "spread": spread(vals), "min": min(vals),
                          "max": max(vals), "n": len(vals)}
    print(json.dumps({"workload": args.workload, "runs": len(lines),
                      "correct": sum(bool(r["correct"]) for r in ok),
                      "spreads": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
