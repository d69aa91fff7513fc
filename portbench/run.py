"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one run of one
cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. The last line of standard output is the result (JSON); the numbers
compared for ``correct`` are the last lines of standard error. Exits
non-zero, with no result, without CUDA or the cards the cell needs, when
the program is missing, or when JAX or the JAX package got loaded.
"""
from __future__ import annotations

import os
import sys
import time

_T0 = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started (its start time in
    ``/proc/self/stat`` against ``/proc/uptime``), 0 where unreadable."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE = _process_age()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """One intra-op thread (the load and the program share one process,
    and spinning worker threads would take cores from its event loop), and
    every build and kernel cache in fixed directories of the checkout (the
    program's nvcc output goes to ``build/repro_torch_kernels``)."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    base = os.path.join(ROOT, "build", "portbench")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package
    (``repro_torch`` is not ``repro``: names are compared whole)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [ROOT, os.path.join(ROOT, "src")] + [
        p for p in sys.path if os.path.abspath(p or ".") != here]
    _environment()
    import json
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; known: {sorted(cells)}",
              file=sys.stderr)
        return 2
    cell = cells[args.workload]
    pre = {"args": time.perf_counter() - _T0 + _AGE}
    try:
        import repro_torch  # noqa: F401  (the program under test)
    except ImportError as err:
        print(f"the program is missing: {err}", file=sys.stderr)
        return 2
    pre["program"] = time.perf_counter() - _T0 + _AGE
    import torch
    pre["torch"] = time.perf_counter() - _T0 + _AGE
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"cuda available: {torch.cuda.is_available()}, devices: "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from portbench.harness import run_cell
    pre["cuda"] = time.perf_counter() - _T0 + _AGE
    result = run_cell(bench, cell, args.seed, args.seconds,
                      bool(args.trace), device="cuda",
                      started=_T0 - _AGE, marks=pre)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad} (JAX or the JAX package)",
              file=sys.stderr)
        return 3
    emit(result)
    return 0


def emit(result, out=None, err=None) -> None:
    """Print a run: its notes (the batcher's shed and expiry counters
    among them) to standard error, then each number compared with its
    limit as the last lines there, then the result as the last line of
    standard output."""
    import json
    out = sys.stdout if out is None else out
    err = sys.stderr if err is None else err
    notes = result.pop("_notes", {})
    print("notes " + json.dumps(notes), file=err)
    for name, c in result["compared"].items():
        bound = (f"limit {c['limit']}" if "limit" in c
                 else f"at least {c['min']}")
        print(f"compared {name} {c['value']} {bound}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)


if __name__ == "__main__":
    sys.exit(main())
