"""Small sizes of each cell's traffic that a CPU test run can hold, and a
helper that runs a cell with them."""
import json
import os

from portbench.harness import run_cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SMALL = {
    "person.flood": {"clients": 6, "pool_rows": 24, "warm_s": 0.1,
                     "registry": {"max_batch": 4, "max_delay_s": 0.002,
                                  "max_queue": 256}},
    "person.direct": {"pool_rows": 12, "warm_s": 0.1},
    "speech.bulk": {"pool_rows": 128, "rows_per_call": 32, "max_batch": 8,
                    "warm_s": 0.1},
    "person.bulk": {"pool_rows": 24, "rows_per_call": 8, "max_batch": 4,
                    "warm_s": 0.1},
}


def bench(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def run_small(name, seed=987654321987, seconds=0.6, trace=False, **kw):
    b = bench()
    cell = {c["name"]: c for c in b["workloads"]}[name]
    return run_cell(b, cell, seed, seconds, trace, device="cpu",
                    overrides=SMALL[name], **kw)
