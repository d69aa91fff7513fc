"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
(into ``build/repro_torch_kernels/``), then, on the full-width person
detector (MobileNetV1-0.25 on 96×96×1, random weights from a seed):

1. device   — the card, as torch and nvidia-smi see it;
2. build    — nvcc time of every kernel source, built in parallel;
3. kernels  — each kernel at every distinct (shape, clamp bound, n_true)
              the person plan launches at buckets 1 and 8, on seeded random
              int8 inputs with nonzero z_w, held exactly against its plain
              PyTorch version; kernel, plain and library times;
4. layers   — the compiled engine's kernel route walked op by op through
              the registry, each op fed the kernel route's own previous
              output and held against the plain route of the same op on a
              CPU copy of the same input (exact; softmax ±1 LSB);
5. serve    — the main path: ``predict_q`` at batch 1 and ``predict_q_many``
              on batches 1, 3, 8 (``max_batch=8``), every row held against
              the port's CPU plain route, launch counters checked;
6. trace    — torch.profiler over bucket-8 forwards: device time by kernel
              and the device's busy share.

Each phase prints one JSON line (the ``kernels`` phase lists every shape
it timed); then the ``kernels`` summary line, the nvidia-smi line, and
last ``{"ok": true, "device": {...}}``. Any failure raises, and the script
exits non-zero without the last line.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BUCKETS = (1, 8)
SERVE_BATCHES = (1, 3, 8)
MAX_BATCH = 8
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
INT8_OPS_PER_S = 1.979e15   # H100 SXM dense int8 tensor-core peak
LAUNCHES_PER_FORWARD = {"qmatmul": 15, "qdwconv": 13}
REPLACES = {"qmatmul": "src/repro/kernels/qmatmul.py:66",
            "qdwconv": "src/repro/kernels/qdwconv.py:58"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps: int = 5, inner: int = 20) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls,
    from CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def graph_ms(fn, reps: int = 5, inner: int = 20) -> float:
    """Device time per call: ``inner`` calls captured in one CUDA graph and
    replayed, so the host's launch overhead drops out; median over ``reps``
    replays timed with CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def host_ms(fn, reps: int = 20) -> float:
    """Median host-clock time of ``fn`` (which ends in a device sync)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# kernel signatures of the person plan
# ---------------------------------------------------------------------------

def record_calls(cm, xs_by_bucket):
    """Run one forward per bucket through ``predict_q_many`` and record each
    kernel call's signature (shapes, bounds, lane mask, stride)."""
    from repro_torch.kernels import qdwconv as dw_mod
    from repro_torch.kernels import qmatmul as mm_mod

    calls = {b: [] for b in xs_by_bucket}
    current = []
    orig_mm, orig_dw = mm_mod.qmatmul, dw_mod.qdwconv

    def mm(x, w, *consts, lo, hi, n_true=None):
        current.append(("qmatmul", tuple(x.shape), tuple(w.shape), lo, hi,
                        n_true, None))
        return orig_mm(x, w, *consts, lo=lo, hi=hi, n_true=n_true)

    def dw(x, w, *consts, stride, lo, hi, c_true=None):
        current.append(("qdwconv", tuple(x.shape), tuple(w.shape), lo, hi,
                        c_true, tuple(stride)))
        return orig_dw(x, w, *consts, stride=stride, lo=lo, hi=hi,
                       c_true=c_true)

    mm_mod.qmatmul, dw_mod.qdwconv = mm, dw
    try:
        for b, xs in xs_by_bucket.items():
            current.clear()
            cm.predict_q_many(xs, max_batch=MAX_BATCH)
            calls[b] = list(current)
    finally:
        mm_mod.qmatmul, dw_mod.qdwconv = orig_mm, orig_dw
    return calls


def work(sig) -> tuple:
    """(bytes, int8 ops) the call must move and do: each input read once,
    each output written once; a multiply-add counts as two operations."""
    kind, xs, ws, *_rest, stride = sig
    if kind == "qmatmul":
        m, k = xs
        n = ws[1]
        return m * k + k * n + 5 * 4 * n + m * n, 2 * m * k * n
    b, h, w, c = xs
    kh, kw = ws[:2]
    oh = (h - kh) // stride[0] + 1
    ow = (w - kw) // stride[1] + 1
    return (b * h * w * c + kh * kw * c + 5 * 4 * c + b * oh * ow * c,
            2 * kh * kw * b * oh * ow * c)


def bound_ms(sig) -> tuple:
    nbytes, ops = work(sig)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def random_operands(sig, gen):
    kind, xs, ws, *_ = sig
    dev = "cuda"

    def i8(shape):
        return torch.randint(-128, 128, shape, generator=gen, device=dev,
                             dtype=torch.int16).to(torch.int8)

    n = ws[-1]
    consts = (torch.randn(n, generator=gen, device=dev) * 5,
              torch.rand(n, generator=gen, device=dev) * 0.02 + 1e-4,
              torch.randint(-5000, 5000, (n,), generator=gen, device=dev,
                            dtype=torch.int32),
              torch.randint(-100, 100, (n,), generator=gen, device=dev,
                            dtype=torch.int32),
              torch.randint(1, 9, (n,), generator=gen, device=dev,
                            dtype=torch.int32))  # nonzero z_w
    return i8(xs), i8(ws), consts


def library_qmatmul(x, w, consts, lo, hi, n_true):
    """Yardstick only: cuBLAS int8 GEMM (torch._int_mm) + requant in torch."""
    bias, resc, wsum, coff, zw = consts
    acc = torch._int_mm(x, w)
    sx = x.sum(1, keepdim=True, dtype=torch.int32)
    y = torch.addcmul(bias, resc, (acc - zw * sx - wsum + coff).float())
    q = y.clamp(lo, hi).round().clamp(-128, 127).to(torch.int8)
    if n_true is not None:
        q[:, n_true:] = 0
    return q


def library_qdwconv(x, w, consts, lo, hi, c_true, stride):
    """Yardstick only: cuDNN grouped float32 convolution (exact here: every
    sum is an integer below 2**24) + requant in torch."""
    bias, resc, wsum, coff, zw = consts
    c = x.shape[-1]
    xf = x.permute(0, 3, 1, 2).float()
    wf = w.permute(2, 0, 1).unsqueeze(1).float()
    acc = F.conv2d(xf, wf, stride=stride, groups=c)
    sx = F.conv2d(xf, torch.ones_like(wf), stride=stride, groups=c)
    inner = (acc.to(torch.int32).permute(0, 2, 3, 1)
             - zw * sx.to(torch.int32).permute(0, 2, 3, 1) - wsum + coff)
    y = torch.addcmul(bias, resc, inner.float())
    q = y.clamp(lo, hi).round().clamp(-128, 127).to(torch.int8)
    if c_true is not None:
        q[..., c_true:] = 0
    return q


def phase_kernels(calls):
    from repro_torch.kernels import ref
    from repro_torch.kernels.qdwconv import qdwconv
    from repro_torch.kernels.qmatmul import qmatmul

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, measured = [], {}
    distinct = sorted({s for b in calls for s in calls[b]},
                      key=lambda s: (s[0], s[1], s[2], str(s[3:])))
    for sig in distinct:
        kind, xs, ws, lo, hi, lanes, stride = sig
        x, w, consts = random_operands(sig, gen)
        lo_t = torch.tensor(lo, dtype=torch.float32, device="cuda")
        hi_t = torch.tensor(hi, dtype=torch.float32, device="cuda")
        if kind == "qmatmul":
            def kern():
                return qmatmul(x, w, *consts, lo=lo, hi=hi, n_true=lanes)

            def plain():
                return ref.qmatmul_ref(x, w, *consts, lo=lo, hi=hi,
                                       n_true=lanes)

            def lib():
                return library_qmatmul(x, w, consts, lo_t, hi_t, lanes)
        else:
            def kern():
                return qdwconv(x, w, *consts, stride=stride, lo=lo, hi=hi,
                               c_true=lanes)

            def plain():
                return ref.qdwconv_ref(x, w, *consts, stride=stride, lo=lo,
                                       hi=hi, c_true=lanes)

            def lib():
                return library_qdwconv(x, w, consts, lo_t, hi_t, lanes, stride)
        got, want, lib_out = kern(), plain(), lib()
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        check(err == 0, f"{kind} {xs}x{ws} differs from its plain version "
                        f"by up to {err}")
        b_ms, b_by = bound_ms(sig)
        m = dict(kind=kind, x=list(xs), w=list(ws), lo=lo, hi=hi,
                 lanes=lanes, stride=stride, max_abs_err=err,
                 library_equal=bool(torch.equal(lib_out, want)),
                 ms=graph_ms(kern), plain_ms=graph_ms(plain),
                 library_ms=graph_ms(lib), call_ms=cuda_ms(kern),
                 bound_ms=b_ms, bound_by=b_by)
        measured[sig] = m
        rows.append(m)
    emit({"phase": "kernels", "shapes": len(rows), "exact": True,
          "per_shape": [{k: r[k] for k in ("kind", "x", "w", "lanes", "stride",
                                           "ms", "call_ms", "plain_ms",
                                           "library_ms", "library_equal",
                                           "bound_ms", "bound_by")}
                        for r in rows]})
    return measured


def per_forward(calls, measured, bucket, kind, key):
    return sum(measured[s][key] for s in calls[bucket] if s[0] == kind)


# ---------------------------------------------------------------------------
# layer by layer
# ---------------------------------------------------------------------------

def phase_layers(cm, qg, x):
    from repro_torch.core import registry as R
    from repro_torch.core.engine import ExecutionPlan

    dev_plan = cm.exec_plan
    cpu_plan = ExecutionPlan.build(qg, use_kernels=False, device="cpu")
    layouts = dev_plan.layout.layouts
    env = {qg.inputs[0]: torch.as_tensor(x, device=dev_plan.device)}

    def val(plan, tid, keep_padded):
        if tid in plan.consts:
            return plan.consts[tid]
        v = env[tid]
        shape = qg.tensor(tid).shape
        if not keep_padded and tuple(v.shape) != shape:
            v = v[tuple(slice(0, d) for d in shape)]
        return v

    layers = []
    for i, op in enumerate(qg.ops):
        lay = layouts.get(i)
        ctx_k = R.OpContext(qg, op, i, folded=dev_plan.folded.get(i),
                            use_kernels=True, layout=lay)
        ctx_p = R.OpContext(qg, op, i, folded=cpu_plan.folded.get(i))
        out_k = R.run_compiled(ctx_k, [val(dev_plan, t, lay is not None)
                                       for t in op.inputs])
        ins_p = [cpu_plan.consts[t] if t in cpu_plan.consts
                 else val(dev_plan, t, False).cpu() for t in op.inputs]
        out_p = R.run_compiled(ctx_p, ins_p)
        y = qg.tensor(op.outputs[0])
        logical = out_k[tuple(slice(0, d) for d in y.shape)].cpu()
        check(tuple(out_p.shape) == y.shape, f"op {i}: plain shape {out_p.shape}")
        diff = int((logical.to(torch.int32) - out_p.to(torch.int32)).abs().max())
        tol = 1 if op.op == "SOFTMAX" else 0
        check(diff <= tol, f"op {i} {op.op}: kernel route differs from the "
                           f"plain route by {diff}")
        pad_zero = lay is None or not bool(out_k[..., lay.n_true:].any())
        check(pad_zero, f"op {i} {op.op}: padding lanes not zero")
        lo_q, hi_q = -128, 127
        if lay is not None:
            lo_q = max(lo_q, math.ceil(lay.lo) if math.isfinite(lay.lo) else lo_q)
            hi_q = min(hi_q, math.floor(lay.hi) if math.isfinite(lay.hi) else hi_q)
        inside = float(((out_p > lo_q) & (out_p < hi_q)).float().mean())
        layers.append(dict(op=i, kind=op.op, route="kernel" if lay else "plain",
                           shape=list(y.shape), max_abs_diff=diff,
                           inside_share=round(inside, 4)))
        env[op.outputs[0]] = out_k
    emit({"phase": "layers", "ops": len(layers),
          "kernel_ops": sum(1 for r in layers if r["route"] == "kernel"),
          "layers": layers})


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs.paper_models import build_person
    from repro_torch.core.engine import CompiledModel, bucket_for
    from repro_torch.core.quantize import quantize_graph
    from repro_torch.kernels import _build
    from repro_torch.kernels import qdwconv as dw_mod
    from repro_torch.kernels import qmatmul as mm_mod

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    built = _build.build()
    emit({"phase": "build", "wall_s": round(time.perf_counter() - t0, 3),
          "sources": {n: {"seconds": round(r["seconds"], 3),
                          "ptxas": [ln.strip() for ln in r["log"].splitlines()
                                    if "Used" in ln or "spill" in ln]}
                      for n, r in built.items()}})

    # the model: full-width person detector, random weights from a seed
    rng = np.random.default_rng(SEED)
    qg = quantize_graph(build_person(), [rng.normal(0, 1, (1, 96, 96, 1))
                                         .astype("f") for _ in range(2)],
                        device="cuda")
    xq = np.stack([qg.tensor(qg.inputs[0]).qparams.quantize(
        rng.normal(0, 1, (1, 96, 96, 1)).astype("f")) for _ in range(8)])
    cm = CompiledModel(qg, use_kernels=True, device="cuda")
    plain_cpu = CompiledModel(qg, use_kernels=False, device="cpu")

    calls = record_calls(cm, {b: xq[:b] for b in BUCKETS})
    for b in BUCKETS:
        counts = {k: sum(1 for s in calls[b] if s[0] == k)
                  for k in LAUNCHES_PER_FORWARD}
        check(counts == LAUNCHES_PER_FORWARD,
              f"bucket {b}: kernel calls per forward {counts}")
    measured = phase_kernels(calls)
    phase_layers(cm, qg, xq[0])

    # -- the main path, counted ------------------------------------------
    want_rows = plain_cpu.predict_q_many(xq, max_batch=MAX_BATCH)
    mm_mod.launches = 0
    dw_mod.launches = 0
    single = cm.predict_q(xq[0])
    served = {b: cm.predict_q_many(xq[:b], max_batch=MAX_BATCH)
              for b in SERVE_BATCHES}
    torch.cuda.synchronize()
    launches = {"qmatmul": mm_mod.launches, "qdwconv": dw_mod.launches}
    n_forwards = 1 + len(SERVE_BATCHES)
    check(launches == {k: v * n_forwards
                       for k, v in LAUNCHES_PER_FORWARD.items()},
          f"launches {launches} for {n_forwards} forwards")

    def close(got, want):
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        return int(d.max(initial=0))

    check(single.shape == (1, 2) and close(single, want_rows[0]) <= 1,
          "predict_q differs from the CPU plain route")
    for b, out in served.items():
        check(out.shape == (b, 1, 2), f"batch {b}: shape {out.shape}")
        check(close(out, want_rows[:b]) <= 1,
              f"batch {b}: rows differ from the CPU plain route")
    serve_ms = {str(bucket_for(b)): host_ms(
        lambda b=b: cm.predict_q_many(xq[:b], max_batch=MAX_BATCH))
        for b in SERVE_BATCHES}
    emit({"phase": "serve", "launches": launches, "forwards": n_forwards,
          "softmax_max_abs_diff": max(close(single, want_rows[0]),
                                      *(close(o, want_rows[:b])
                                        for b, o in served.items())),
          "ms_per_bucket_call": serve_ms})

    # -- device trace over bucket-8 forwards --------------------------------
    from torch.profiler import ProfilerActivity, profile
    cm.predict_q_many(xq, max_batch=MAX_BATCH)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            cm.predict_q_many(xq, max_batch=MAX_BATCH)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for evt in prof.key_averages():
        dt = getattr(evt, "device_time_total", None)
        if dt is None:
            dt = getattr(evt, "cuda_time_total", 0)
        if dt and getattr(evt, "device_type", None) is not None \
                and "CUDA" in str(evt.device_type):
            by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + dt / 1e3
    device_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    emit({"phase": "trace", "forwards": 5, "bucket": 8,
          "window_ms": round(window_ms, 3), "device_ms": round(device_ms, 3),
          "busy_share": round(device_ms / window_ms, 4) if window_ms else None,
          "top_device_ms": [[k[:80], round(v, 4)] for k, v in top],
          "script_s": round(time.perf_counter() - t_start, 3)})

    kernels = []
    for kname in ("qmatmul", "qdwconv"):
        entry = {"name": kname, "route": "cuda",
                 "source": f"src/repro_torch/kernels/csrc/{kname}.cu",
                 "replaces": REPLACES[kname], "launches": launches[kname],
                 "max_abs_err": max(m["max_abs_err"] for m in measured.values()
                                    if m["kind"] == kname),
                 "bucket": BUCKETS[0]}
        for key in ("ms", "plain_ms", "bound_ms", "library_ms", "call_ms"):
            entry[key] = per_forward(calls, measured, BUCKETS[0], kname, key)
        by = [measured[s]["bound_by"] for s in calls[BUCKETS[0]] if s[0] == kname]
        entry["bound_by"] = max(set(by), key=by.count)
        entry["per_forward_bucket8"] = {
            key: per_forward(calls, measured, 8, kname, key)
            for key in ("ms", "plain_ms", "bound_ms", "library_ms", "call_ms")}
        kernels.append(entry)

    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
