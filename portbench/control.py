"""The readings that the limit of ``correct`` is set from, for one cell:

* the program's: the widest gap, in int8 steps, between an answer of a
  short run at the cell's own load and the reference's answer to its row,
  on each seed (the lower reading is the largest);
* the control's: the reference put in the program's place and computed one
  precision below the configuration's int8, with int4 weights (each
  channel's int8 weights rounded to 7 steps a side, its scale widened to
  match), answering the same rows; its widest gap against the int8
  reference on each seed (the upper reading is the smallest).

    python3 portbench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...]

prints one JSON line a seed and a summary line. The benchmark's own runs
never run this.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np


def int4_model(qmodel) -> dict:
    """``qmodel`` with every weight on a 4-bit symmetric grid (-7..7); the
    biases keep their int32 values and scales, so their real values stay."""
    out = dict(qmodel)
    layers = []
    for lay in qmodel["layers"]:
        lay = dict(lay)
        if "w" in lay:
            lay["w"] = np.clip(np.round(lay["w"].astype(np.float64)
                                        * 7.0 / 127.0), -7, 7) \
                .astype(np.int8)
            lay["w_scale"] = (lay["w_scale"].astype(np.float64) * 127.0
                              / 7.0).astype(np.float32)
        layers.append(lay)
    out["layers"] = layers
    return out


def readings(qmodel, config, rec, pool, device, block=1024) -> dict:
    """The program's and the control's widest gap over the rows the run
    answered."""
    import torch
    from portbench.reference import load
    ref_mod = load(config["reference"])
    from portbench.harness import answers
    idx, out = answers(rec, int(config["classes"]))
    uniq = np.unique(idx)
    rows = torch.as_tensor(pool.rows[uniq, 0], device=device)
    ref = ref_mod.forward_int8(qmodel, rows, block).cpu().numpy()
    ctl = ref_mod.forward_int8(int4_model(qmodel), rows, block).cpu().numpy()
    at = np.searchsorted(uniq, idx)
    gap = np.abs(out.astype(np.int16) - ref[at].astype(np.int16)).max(axis=1)
    cgap = np.abs(ctl[at].astype(np.int16)
                  - ref[at].astype(np.int16)).max(axis=1)
    return {"rows": int(len(idx)), "program_max_gap": int(gap.max()),
            "program_rows_differing": int((gap > 0).sum()),
            "control_max_gap": int(cgap.max()),
            "control_rows_differing": int((cgap > 0).sum())}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [root, os.path.join(root, "src")]
    from portbench.harness import load_json, run_cell
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cell = {c["name"]: c for c in bench["workloads"]}[args.workload]
    lines = []
    for seed in args.seeds:
        got = {}

        def inspect(qmodel, config, rec, pool):
            got.update(readings(qmodel, config, rec, pool, args.device))

        res = run_cell(bench, cell, seed, args.seconds, False,
                       device=args.device, inspect=inspect)
        line = {"workload": args.workload, "seed": seed,
                "correct": res["correct"], **got}
        lines.append(line)
        print(json.dumps(line), flush=True)
    print(json.dumps({
        "workload": args.workload, "seeds": len(lines),
        "lower": max(x["program_max_gap"] for x in lines),
        "upper": min(x["control_max_gap"] for x in lines)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
