"""The highest rate a configuration is served at: the open-loop mix
``traffic/open.json`` through the registry at each of a list of rates,
one short window each, in one process. For each rate it prints the rows
answered a second, the latency from when each request was due (median and
95th percentile), the requests refused, and how far the sender fell behind
its schedule. The knee is the highest rate answered in full with a tail
that does not grow. The benchmark's own runs never run this.

    python3 portbench/sweep.py --config person --seed <n> --seconds 5 \\
        --rates 10000 20000 30000
"""
from __future__ import annotations

import json
import os
import sys


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [root, os.path.join(root, "src")]
    from portbench.harness import load_json, run_cell
    cell = {"name": f"{args.config}.open", "config": args.config,
            "traffic": "open", "chips": 1}
    bench = {"end_to_end": [
        {"name": n, "unit": u, "workloads": [cell["name"]]}
        for n, u in (("served_rows_per_s", "rows/s"),
                     ("latency_p50_ms", "ms"), ("latency_p95_ms", "ms"))],
        "per_layer": []}
    for rate in args.rates:
        res = run_cell(bench, cell, args.seed, args.seconds, False,
                       device=args.device, overrides={"rate": rate})
        notes = res["_notes"]
        print(json.dumps({
            "rate": rate, "correct": res["correct"],
            "attempted": res["attempted"], "failed": res["failed"],
            **{k: v["value"] for k, v in res["metrics"].items()},
            "refused": notes["batcher"]["rejected"],
            "sender_late_s": notes["sender_late_s"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
