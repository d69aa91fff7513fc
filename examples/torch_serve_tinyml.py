"""Serve the paper's TinyML models behind the pipelined micro-batcher, on
the PyTorch/CUDA port. The twin of ``examples/serve_tinyml.py``.

Starts a multi-model ServingRegistry (sine + speech by default) with:

* a **shared off-loop executor** — one ThreadPoolExecutorBackend carries
  every model's flushes, so speech's multi-ms conv call never blocks
  sine's arrival processing (and vice versa);
* **two priority classes** — ``interactive`` (priority 1, 1 ms coalescing
  deadline, 25 ms SLO) and ``batch`` (priority 0, 10 ms deadline): under
  overload the scheduler sheds batch-class requests first (preempting
  pending ones in interactive's favor), and earliest-deadline-first flush
  order lets interactive rows jump the queue into the next bucket.

A mixed burst of concurrent single-sample requests is fired at both
models, then the per-model metrics snapshot is printed — per-class
latency percentiles, SLO attainment, preemptions, and batch occupancy
(how full the power-of-two buckets ran; on the card each bucket is one
CUDA-graph replay).

With ``--chaos`` the shared executor is wrapped in a seeded
:class:`repro_torch.serve.faults.FaultInjector` (20% transient dispatch faults
plus one scripted worker death) behind the
:class:`repro_torch.serve.resilience.ResilientExecutor` — the same burst then
exercises retries, pool recycling, and (on repeated faults) circuit
breakers + route degradation, and the snapshot grows a resilience line:
faults injected, retries spent, rows degraded off the primary route,
and how many requests still failed after all of it.

  PYTHONPATH=src python examples/torch_serve_tinyml.py [n_requests] [--chaos]
      [--device cpu]

On the card by default; ``--device cpu`` runs the kernels' plain versions.
"""
import argparse
import asyncio

import numpy as np

from repro_torch.serve.executor import ThreadPoolExecutorBackend
from repro_torch.serve.faults import FaultInjector
from repro_torch.serve.registry import ClassPolicy, build_paper_registry
from repro_torch.serve.resilience import ResilientExecutor
from repro_torch.serve.scheduler import FlushError, QueueFullError

CLASSES = {
    "interactive": ClassPolicy(priority=1, max_delay_s=0.001, slo_s=0.025),
    "batch": ClassPolicy(priority=0, max_delay_s=0.010, slo_s=0.250),
}

# The chaos run enforces SLOs as *wall deadlines*: the resilient executor
# fails a dispatch group whose earliest deadline already passed instead of
# serving it late (no device time on dead-per-SLO work). The tail of this
# example's 64-deep conv burst queues ~50 ms on CPU, so the stock 25 ms
# interactive target is unmeetable regardless of faults — the chaos demo
# uses targets the burst can meet, and lets the injector be the villain.
CLASSES_CHAOS = {
    "interactive": ClassPolicy(priority=1, max_delay_s=0.001, slo_s=0.150),
    "batch": ClassPolicy(priority=0, max_delay_s=0.010, slo_s=0.750),
}


async def main(n_requests: int = 256, chaos: bool = False,
               device: str = "cuda"):
    rng = np.random.default_rng(0)
    # person's warm-up compile is slow on CPU; two models show the story.
    # The registry owns the shared executor and closes it on stop().
    executor = ThreadPoolExecutorBackend(max_workers=2)
    injector = None
    if chaos:
        injector = FaultInjector(seed=42, transient_rate=0.20)
        injector.fail_next("worker_death")  # one scripted pool teardown
        # speech's conv flush is ~15 ms on CPU: floor the per-attempt
        # timeout above it so deadline-splitting (25 ms interactive SLO /
        # 3 attempts) never cancels a healthy dispatch mid-flight
        executor = ResilientExecutor(injector.wrap(executor),
                                     min_timeout_s=0.050)
    reg = build_paper_registry(
        ("sine", "speech"), device=device, max_batch=16, max_delay_s=0.002,
        max_queue=128,
        executor=executor, classes=CLASSES_CHAOS if chaos else CLASSES)

    async with reg:
        # Concurrent clients: every request is an independent single sample
        # -- the batcher, not the client, assembles the big device batches.
        # Interactive requests take priority; batch requests shed first.
        async def client(model, x, cls):
            try:
                yq = await reg.infer(model, reg.quantize_input(model, x),
                                     cls=cls)
                return reg.dequantize_output(model, yq)
            except QueueFullError:  # shed OR preempted by a higher class
                return None
            except FlushError as e:  # chaos: retries/degradation exhausted
                return e

        jobs = []
        for i in range(n_requests):
            cls = "interactive" if i % 3 == 0 else "batch"
            if i % 2 == 0:
                jobs.append(client("sine",
                                   rng.uniform(0, 2 * np.pi, (1,)), cls))
            else:
                jobs.append(client("speech",
                                   rng.normal(0, 1, (49, 40, 1)), cls))
        results = await asyncio.gather(*jobs)
        failed = sum(isinstance(r, FlushError) for r in results)
        done = sum(r is not None for r in results) - failed
        print(f"{done}/{n_requests} served "
              f"({n_requests - done - failed} shed by "
              f"backpressure/priority, {failed} failed)\n")

        for model, snap in reg.snapshot().items():
            print(f"[{model}]")
            for k in ("completed", "rejected", "preempted", "cancelled",
                      "batches", "mean_batch", "batch_occupancy",
                      "throughput_rps", "p50_ms", "p95_ms", "p99_ms"):
                v = snap[k]
                s = f"{v:.3f}" if isinstance(v, float) else str(v)
                print(f"  {k:16s} {s}")
            if chaos:
                print(f"  resilience       injected="
                      f"{snap['injected_faults']} "
                      f"({snap['injected_by_kind']}) "
                      f"retries={snap['retries']} "
                      f"degraded_rows={snap['degraded_rows']} "
                      f"failed={snap['failed']} "
                      f"expired={snap['deadline_exceeded']}")
            for cls, c in snap["classes"].items():
                att = ("n/a" if c["slo_attainment"] is None
                       else f"{c['slo_attainment']:.2f}")
                p95 = ("n/a" if c["p95_ms"] is None
                       else f"{c['p95_ms']:.3f}")
                print(f"  class {cls:12s} completed={c['completed']:<4d} "
                      f"preempted={c['preempted']:<3d} p95_ms={p95} "
                      f"slo_attainment={att}")
            print()

    # sanity: batched serving matches direct batch-1 inference
    x = rng.uniform(0, 2 * np.pi, (1,)).astype("f")
    reg2 = build_paper_registry(("sine",), device=device, max_batch=4)
    async with reg2:
        y_served = await reg2.infer("sine", reg2.quantize_input("sine", x))
    y_direct = reg2._entries["sine"].model.predict_q(
        reg2.quantize_input("sine", x))
    assert np.array_equal(np.asarray(y_served), np.asarray(y_direct))
    print("served rows are bit-identical to direct predict_q ✓")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_requests", nargs="?", type=int, default=256)
    ap.add_argument("--chaos", action="store_true",
                    help="inject seeded dispatch faults behind the "
                         "resilient executor (see module docstring)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args()
    asyncio.run(main(args.n_requests, chaos=args.chaos, device=args.device))
