"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
(into ``build/repro_torch_kernels/``), then drives four paths of the port
at full width, with random weights from a seed. An engine call is a
CUDA-graph replay: the first one-sample ``predict_q`` captures the per-call
forward, the first call of a bucket its batched forward; a capture runs the
forward once eagerly and then captures it (two forwards' kernel-wrapper
calls), and a replay calls no wrapper. So the counted phases check the
calls each graph holds (``compile_log``), the total over eager runs and
captures, and that replays leave every launch counter where it was. Bucket
calls stage the logical rows only; the entry lane pad runs on the card,
inside the graph.

1. device   — the card, as torch and nvidia-smi see it;
2. build    — nvcc time of every kernel source, built in parallel;
3. probe    — ``can_launch_kernels() == (True, None)``, and the probe kernel
              held against ``x + 1``;
4. kernels  — each kernel at every distinct call the two paths launch, on
              seeded random inputs (int8 with nonzero z_w; float), held
              against its plain PyTorch version: ``qmatmul`` / ``qdwconv``
              at every (shape, clamp bound, n_true, border) of the person
              plan at buckets 1 and 8 (``qdwconv`` on the unpadded input,
              its SAME border fused in); ``paged_qmatmul`` at every shape
              the paged engines launch plus the 256×256 FC at pages 2/8/32
              (int8 exact, two calls bit-identical); ``fmatmul`` at
              (8,16,8), (130,70,33) and the speech model's float FC as
              ``ops.fmatmul`` calls it, in float32 (1e-5) and bfloat16
              (5e-2), two calls bit-identical. Kernel, plain and library
              times and the bound; then the explicit cases, with ptxas'
              registers, shared memory and spills (a spill in any of the
              four redesigned kernels fails the run): ``fmatmul`` at
              128×4096×128 (float32, bfloat16), ``qmatmul`` at conv0's
              quantum-128 shape 18432×1152×128, ``qdwconv`` through its
              generic instantiation (5×5/s2, an asymmetric border) and at
              C = 8, ``paged_qmatmul`` at 8×4000 page 1 and 4×256 page 128;
5. layers   — person's kernel route walked op by op through the registry,
              each op fed the kernel route's own previous output and held
              against the plain route of the same op on a CPU copy of the
              same input (exact; softmax ±1 LSB); no ``F.pad`` may run
              inside ``qdwconv_planned`` (the kernel fills the border);
6. serve    — the first main path, counted: person's ``predict_q`` at batch
              1 (the per-call graph: one ``"percall"`` capture holding 15
              ``qmatmul`` + 13 ``qdwconv`` calls; a second call launches
              nothing) and ``predict_q_many`` on batches 1, 3, 8
              (``max_batch=8``): each captured bucket's graph holds 15
              ``qmatmul`` + 13 ``qdwconv`` calls, replays call none; every
              row held against the port's CPU plain route, and no border
              pad before a depthwise layer; per-call replay latency beside
              the eager per-call forward's;
7. paging   — the second main path, counted: the paged route (Sec. 4.3)
              with ``use_kernels=True`` on sine ``{0: 16, 1: 16}``, speech
              ``{2: 4}`` and person ``{29: 2}`` at ``predict_q`` and buckets
              1, 4, 8, the 256×256 FC (batch 4) at pages 2, 8 and 32, and
              the float speech model, whose FC runs on ``fmatmul``. Engines
              are built inside the count with the probe's cache cleared;
              ``predict_q`` captures each engine's per-call graph.
              Every row equals the card's unpaged engine and the port's CPU
              plain paged route (paged FC logits exact; softmax ±1 LSB);
              paged calls per forward and per bucket graph are checked
              (sine 2, speech 1, person 1), with ``plan_paged`` beside
              ``plan_stack`` bytes and bucket-8 call times of the paged and
              unpaged engines;
8. routes   — ``predict_q_routed`` on person, and on speech with its paging
              map, for every route (both engine routes captured on the
              card): all rows equal the primary route's;
9. serving  — the third main path, counted: ``build_paper_registry`` of
              sine, speech and person at full width on the card (real
              clock, ``max_batch=32``, 4 executor workers, a tracer with a
              flight recorder); warm-up captures buckets 1..32 of both
              engine routes of every model (``compile_events``,
              ``staging_events``, ``memory_reserved`` printed); 320
              requests from 8 concurrent clients in two priority classes,
              every row held against the CPU plain route; no capture, no
              staging allocation and no wrapper call while serving;
              ``openmetrics()`` ends ``# EOF``, ``telemetry()`` carries
              ``stage_breakdown_us``; then ``FaultInjector(persistent_routes=
              {"kernels"})``: served on the captured ``"compiled"`` route,
              then, with that route failed too, on ``"reference"``, every
              row bit-identical to the healthy run's; the bucket-call
              latency per model at buckets 1 / 4 / 8 (graph replay and the
              eager forward);
10. trace   — torch.profiler over person bucket-8 calls (graph replays):
              device time by kernel and the device's busy share (over the
              profiled window, and over the same 5 calls unprofiled), the
              bucket-8 graph's replay time from CUDA events, and the H2D
              copies of the calls from the profiler's trace: one per call,
              of the logical rows (8 × 96 × 96 × 1 = 73,728 B);
11. pool    — a model's graphs share one memory pool: person's buckets 1,
              2, 4, 8 captured in that order; for each pair (earlier e,
              later l) the raw sequence replay l, replay e, read l's
              outputs is run and the pairs whose outputs changed are
              printed (the hazard), while the same interleaving through
              the API gives every row of the eager forward; then 8 threads
              call all four buckets and the per-call graph interleaved,
              every row exact (the model-wide lock);
12. audit   — the plan auditor on the card, for sine, speech and person on
              the kernel route and paged speech ``{2: 4}``: no verifier
              error, no no-retrace finding against the warmed engine, the
              derived pad/cat count equal to the measured one, the
              fingerprint equal to a CPU build's of the same graph and
              flags, ``device_advisory`` printed; and ``python -m
              repro_torch.analysis --selftest --device cuda`` exits 0;
13. coldstart — the fourth main path: the serving registry's boot from the
              executable cache (``repro_torch.serve.aotcache``), each boot
              in a fresh process (``chip_smoke.py --boot``):
              ``build_paper_registry`` of sine, speech and person at full
              width (``max_batch=32``, ``cache_dir=``), both engine routes
              warmed through the cache, then rows at batches 1, 3, 8 on
              both routes and 8 requests a model through the registry. The
              cold boot (empty cache, the checkout's build directory) builds
              and stores; the warm boot (same cache, an empty build
              directory) must hit on every engine with ``compile_events``
              0, the cold boot's ``capture_events`` and kernel launches, no
              nvcc run and the build directory still empty; a third boot
              from a copy of the cache with the ``qdwconv`` library
              truncated (stored once, under ``lib/``) must miss with C003
              on the first engine that needs it, boot it cold, hit on the
              others (a later one finds the library loaded) and heal the
              file. Every boot's rows equal the cold
              boot's bit for bit and the CPU plain route (±1 LSB on a
              softmax). Wall seconds split into plan builds, captures,
              staging, store, load and library installs, beside the
              ``build`` phase's nvcc seconds;
14. examples — ``examples/torch_quickstart.py``,
              ``torch_person_detection.py`` and ``torch_serve_tinyml.py 64``
              (and ``--chaos``) on the card, each in its own process: exit
              0 and their "✓" lines.

Each phase prints one JSON line (the ``kernels`` phase lists every call it
timed, and ``explicit`` the seven explicit cases); then the ``kernels``
summary line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failure raises, and the script exits
non-zero without the last line.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import re
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
FLOPS_PER_S = {"float32": 67e12,     # H100 SXM float32, CUDA cores
               "bfloat16": 989e12}   # H100 SXM dense bf16 tensor-core peak
LAUNCHES_PER_FORWARD = {"qmatmul": 15, "qdwconv": 13}
REPLACES = {"qmatmul": "src/repro/kernels/qmatmul.py:66",
            "qdwconv": "src/repro/kernels/qdwconv.py:58",
            "paged_qmatmul": "src/repro/kernels/paged_matmul.py:37",
            "fmatmul": "src/repro/kernels/qmatmul.py:130",
            "probe": "src/repro/kernels/ops.py:73"}
# the paged route: model -> (input shape, paging map, paged launches per
# forward, the paged FC's op index)
PAGED = {"sine": ((1, 1), {0: 16, 1: 16}, 2, 1),
         "speech": ((1, 49, 40, 1), {2: 4}, 1, 2),
         "person": ((1, 96, 96, 1), {29: 2}, 1, 29)}
PAGED_BUCKETS = (1, 4, 8)
FC256_PAGES = (2, 8, 32)
FMATMUL_SHAPES = ((8, 16, 8), (130, 70, 33))
FMATMUL_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
# the explicit cases: fmatmul at the padded float speech FC, qmatmul at
# person conv0's bucket-8 shape in the quantum-128 layout
FMATMUL_EXPLICIT = (128, 4096, 128)
QMATMUL_EXPLICIT = (18432, 1152, 128)
# qdwconv through its generic instantiation (5x5/s2, an asymmetric border)
# and at C = 8 (8-byte staging pieces): (x, w, c_true, (stride, pads, z_x));
# paged_qmatmul at speech's 8 x 4000 page of 1 unit and fc256's 4 x 256
# page of 128 units (the paged path's own calls): (x, w, page)
DWCONV_EXPLICIT = (
    ((2, 12, 11, 32), (5, 5, 32), 20, ((2, 2), (1, 2, 2, 2), 5)),
    ((8, 48, 48, 8), (3, 3, 8), None, ((1, 1), (1, 1, 1, 1), -3)))
PAGED_EXPLICIT = (((8, 4000), (4000, 4), 1), ((4, 256), (256, 256), 128))
# the serving stack: three paper models behind build_paper_registry, kernel
# calls each bucket's graph holds per model, clients and requests
SERVING_LAUNCHES = {"sine": {"qmatmul": 3}, "speech": {"qmatmul": 2},
                    "person": LAUNCHES_PER_FORWARD}
SERVING_MAX_BATCH = 32
SERVING_WORKERS = 4
SERVING_CLIENTS = 8
SERVING_REQUESTS = 40      # per client: 320 healthy requests
SERVING_FAULT_REQUESTS = 12   # per model, kernel route failed
SERVING_REFERENCE_REQUESTS = 4  # per model, both engine routes failed
SERVING_POOL = 64
SERVING_LATENCY_BUCKETS = (1, 4, 8)


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

def eager_forward(cm, xs):
    """One batched forward of ``cm``'s eager lowered function on ``xs``,
    staged as a bucket's CUDA graph receives them (the logical rows, zero
    rows up to the bucket; the lane pad runs inside): the kernel calls the
    bucket's graph captured."""
    from repro_torch.core.engine import bucket_for
    x = torch.as_tensor(np.asarray(xs), device="cuda")
    staged = torch.zeros((bucket_for(len(xs)),) + tuple(x.shape[1:]),
                         dtype=x.dtype, device="cuda")
    staged[:len(xs)] = x
    return cm._batched_fn(staged)


def record_calls(cm, xs_by_bucket):
    """Run one eager batched forward per bucket (:func:`eager_forward`) and
    record each kernel call's signature (kind, shapes, bounds or dtype, lane
    mask or page, stride): the calls each bucket's CUDA graph holds."""
    calls = {b: [] for b in xs_by_bucket}
    with recording() as current:
        for b, xs in xs_by_bucket.items():
            current.clear()
            eager_forward(cm, xs)
            calls[b] = list(current)
    return calls


class recording:
    """Within ``with recording() as calls:`` every kernel wrapper call
    appends its signature to ``calls`` (the launch still happens). A
    ``qmatmul`` signature's w shape is (N, K): the kernel takes the weight
    transposed. A ``qdwconv`` signature's last field is its geometry:
    (stride, pads, z_x)."""

    def __enter__(self):
        from repro_torch.kernels import paged_matmul as pm_mod
        from repro_torch.kernels import qdwconv as dw_mod
        from repro_torch.kernels import qmatmul as mm_mod
        self.mods = (mm_mod, dw_mod, pm_mod)
        current = []
        orig = self.orig = (mm_mod.qmatmul, dw_mod.qdwconv,
                            pm_mod.paged_qmatmul, mm_mod.fmatmul)

        def mm(x, w, *consts, lo, hi, n_true=None):
            current.append(("qmatmul", tuple(x.shape), tuple(w.shape), lo, hi,
                            n_true, None))
            return orig[0](x, w, *consts, lo=lo, hi=hi, n_true=n_true)

        def dw(x, w, *consts, stride, pads=(0, 0, 0, 0), z_x=0, lo, hi,
               c_true=None):
            current.append(("qdwconv", tuple(x.shape), tuple(w.shape), lo, hi,
                            c_true, (tuple(stride), tuple(pads), int(z_x))))
            return orig[1](x, w, *consts, stride=stride, pads=pads, z_x=z_x,
                           lo=lo, hi=hi, c_true=c_true)

        def pm(x, w, *consts, page, lo, hi):
            current.append(("paged_qmatmul", tuple(x.shape), tuple(w.shape),
                            lo, hi, page, None))
            return orig[2](x, w, *consts, page=page, lo=lo, hi=hi)

        def fm(x, w):
            current.append(("fmatmul", tuple(x.shape), tuple(w.shape),
                            str(x.dtype).removeprefix("torch."), None, None,
                            None))
            return orig[3](x, w)

        mm_mod.qmatmul, dw_mod.qdwconv, pm_mod.paged_qmatmul = mm, dw, pm
        mm_mod.fmatmul = fm
        return current

    def __exit__(self, *exc):
        mm_mod, dw_mod, pm_mod = self.mods
        (mm_mod.qmatmul, dw_mod.qdwconv, pm_mod.paged_qmatmul,
         mm_mod.fmatmul) = self.orig
        return False


def work(sig) -> tuple:
    """(bytes, ops, peak ops/s) of the call: each input read once, each
    output written once; a multiply-add counts as two operations."""
    kind, xs, ws, *_rest, geo = sig
    if kind in ("qmatmul", "paged_qmatmul"):
        m, k = xs
        n = ws[0] if kind == "qmatmul" else ws[1]
        return m * k + k * n + 5 * 4 * n + m * n, 2 * m * k * n, INT8_OPS_PER_S
    if kind == "fmatmul":
        m, k = xs
        n = ws[1]
        size = 4 if sig[3] == "float32" else 2
        return (m * k + k * n + m * n) * size, 2 * m * k * n, FLOPS_PER_S[sig[3]]
    if kind == "probe":
        return 2 * xs[0] * xs[1] * 4, xs[0] * xs[1], FLOPS_PER_S["float32"]
    # qdwconv: the unpadded input (the kernel fills the border itself)
    b, h, w, c = xs
    kh, kw = ws[:2]
    oh, ow = dw_out_hw(xs, ws, geo)
    return (b * h * w * c + kh * kw * c + 5 * 4 * c + b * oh * ow * c,
            2 * kh * kw * b * oh * ow * c, INT8_OPS_PER_S)


def dw_out_hw(xs, ws, geo) -> tuple:
    """(OH, OW) of a ``qdwconv`` call: its input, window, stride and pads."""
    (sh, sw), (pt, pb, pl, pr), _ = geo
    return ((xs[1] + pt + pb - ws[0]) // sh + 1,
            (xs[2] + pl + pr - ws[1]) // sw + 1)


def bound_ms(sig) -> tuple:
    nbytes, ops, peak = work(sig)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def random_operands(sig, gen):
    kind, xs, ws, *_ = sig
    dev = "cuda"
    if kind == "fmatmul":
        dtype = getattr(torch, sig[3])
        # the float FC's weight scale (build_speech draws sigma 0.05): a sum
        # of 4096 products keeps its rounding inside the 1e-5 tolerance
        w_scale = 0.05 if xs[1] > 1024 else 1.0
        return (torch.randn(xs, generator=gen, device=dev).to(dtype),
                (torch.randn(ws, generator=gen, device=dev) * w_scale)
                .to(dtype), ())

    def i8(shape):
        return torch.randint(-128, 128, shape, generator=gen, device=dev,
                             dtype=torch.int16).to(torch.int8)

    n = ws[0] if kind == "qmatmul" else ws[-1]
    consts = (torch.randn(n, generator=gen, device=dev) * 5,
              torch.rand(n, generator=gen, device=dev) * 0.02 + 1e-4,
              torch.randint(-5000, 5000, (n,), generator=gen, device=dev,
                            dtype=torch.int32),
              torch.randint(-100, 100, (n,), generator=gen, device=dev,
                            dtype=torch.int32),
              torch.randint(1, 9, (n,), generator=gen, device=dev,
                            dtype=torch.int32))  # nonzero z_w
    return i8(xs), i8(ws), consts


def int_mm_takes(x, w_kn) -> bool:
    """Whether cuBLAS' int8 GEMM (torch._int_mm) takes this product: its
    shape rules (M > 16, K and N multiples of 8), then one trial call
    (cuBLASLt refuses some layouts and shapes beyond those rules)."""
    m, k = x.shape
    if m <= 16 or k % 8 or w_kn.shape[1] % 8:
        return False
    try:
        torch._int_mm(x, w_kn)
        torch.cuda.synchronize()
        return True
    except RuntimeError:
        return False


def library_qmatmul(x, w_kn, consts, lo, hi, n_true=None, int_mm=False):
    """Yardstick only: cuBLAS int8 GEMM (torch._int_mm) where it takes the
    product (``int_mm``), else a float64 torch.matmul (exact here), each +
    requant in torch. ``w_kn`` is (K, N). Returns (result, label)."""
    bias, resc, wsum, coff, zw = consts
    if int_mm:
        acc, label = torch._int_mm(x, w_kn), "int_mm"
    else:
        acc, label = (x.double() @ w_kn.double()).to(torch.int32), "matmul_f64"
    sx = x.sum(1, keepdim=True, dtype=torch.int32)
    y = torch.addcmul(bias, resc, (acc - zw * sx - wsum + coff).float())
    q = y.clamp(lo, hi).round().clamp(-128, 127).to(torch.int8)
    if n_true is not None:
        q[:, n_true:] = 0
    return q, label


def library_qdwconv(x, w, consts, lo, hi, c_true, geo):
    """Yardstick only: the border pad, a cuDNN grouped float32 convolution
    (exact here: every sum is an integer below 2**24) + requant in torch."""
    bias, resc, wsum, coff, zw = consts
    stride, (pt, pb, pl, pr), z_x = geo
    c = x.shape[-1]
    xf = F.pad(x, (0, 0, pl, pr, pt, pb), value=z_x).permute(0, 3, 1, 2).float()
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


def phase_kernels(sigs):
    """Each distinct kernel call against its plain version, then timed."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_matmul import paged_qmatmul
    from repro_torch.kernels.qdwconv import qdwconv
    from repro_torch.kernels.qmatmul import fmatmul, qmatmul

    check(not torch.backends.cuda.matmul.allow_tf32,
          "torch.backends.cuda.matmul.allow_tf32 must be False")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, measured = [], {}
    distinct = sorted(set(sigs), key=lambda s: (s[0], s[1], s[2], str(s[3:])))
    for sig in distinct:
        kind, xs, ws, lo, hi, lanes, geo = sig
        x, w, consts = random_operands(sig, gen)
        if kind != "fmatmul":
            lo_t = torch.tensor(lo, dtype=torch.float32, device="cuda")
            hi_t = torch.tensor(hi, dtype=torch.float32, device="cuda")
        lib_label = "torch"
        if kind == "qmatmul":
            w_kn = w.t()  # (K, N), column-major: cuBLASLt's int8 layout
            use_int_mm = int_mm_takes(x, w_kn)

            def kern():
                return qmatmul(x, w, *consts, lo=lo, hi=hi, n_true=lanes)

            def plain():
                return ref.qmatmul_ref(x, w_kn, *consts, lo=lo, hi=hi,
                                       n_true=lanes)

            def lib():
                return library_qmatmul(x, w_kn, consts, lo_t, hi_t, lanes,
                                       use_int_mm)[0]
            lib_label = "int_mm" if use_int_mm else "matmul_f64"
        elif kind == "paged_qmatmul":
            use_int_mm = int_mm_takes(x, w)

            def kern():
                return paged_qmatmul(x, w, *consts, page=lanes, lo=lo, hi=hi)

            def plain():
                return ref.paged_qmatmul_ref(x, w, *consts, page=lanes, lo=lo,
                                             hi=hi)

            def lib():
                return library_qmatmul(x, w, consts, lo_t, hi_t,
                                       int_mm=use_int_mm)[0]
            lib_label = "int_mm" if use_int_mm else "matmul_f64"
        elif kind == "fmatmul":
            def kern():
                return fmatmul(x, w)

            def plain():
                return ref.fmatmul_ref(x, w)

            def lib():
                return torch.matmul(x, w)
        else:
            dw_kw = dict(stride=geo[0], pads=geo[1], z_x=geo[2], lo=lo, hi=hi,
                         c_true=lanes)

            def kern():
                return qdwconv(x, w, *consts, **dw_kw)

            def plain():
                return ref.qdwconv_ref(x, w, *consts, **dw_kw)

            def lib():
                return library_qdwconv(x, w, consts, lo_t, hi_t, lanes, geo)
        got, want, lib_out = kern(), plain(), lib()
        torch.cuda.synchronize()
        if kind == "fmatmul":
            tol = FMATMUL_TOL[lo]
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            excess = float((diff - tol - tol * want.float().abs()).max())
            check(excess <= 0, f"fmatmul {lo} {xs}x{ws} differs from its "
                               f"plain version by up to {err} (tol {tol})")
            check(torch.equal(kern(), got),
                  f"fmatmul {lo} {xs}x{ws}: two calls differ")
            lib_equal = bool(torch.allclose(lib_out.float(), want.float(),
                                            rtol=tol, atol=tol))
        else:
            err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
            check(err == 0, f"{kind} {xs}x{ws} differs from its plain version "
                            f"by up to {err}")
            check(torch.equal(kern(), got), f"{kind} {xs}x{ws}: two calls "
                                            f"differ")
            lib_equal = bool(torch.equal(lib_out, want))
        b_ms, b_by = bound_ms(sig)
        m = dict(kind=kind, x=list(xs), w=list(ws), lo=lo, hi=hi,
                 lanes=lanes, geometry=geo, max_abs_err=err,
                 library=lib_label, library_equal=lib_equal,
                 ms=graph_ms(kern), plain_ms=graph_ms(plain),
                 library_ms=graph_ms(lib), call_ms=cuda_ms(kern),
                 bound_ms=b_ms, bound_by=b_by)
        measured[sig] = m
        rows.append(m)
    emit({"phase": "kernels", "shapes": len(rows),
          "per_shape": [{"dtype": r["lo"] if r["kind"] == "fmatmul" else "int8",
                         **{k: r[k] for k in (
                             "kind", "x", "w", "lanes", "geometry",
                             "max_abs_err", "ms", "call_ms", "plain_ms",
                             "library", "library_ms", "library_equal",
                             "bound_ms", "bound_by")}}
                        for r in rows]})
    return measured


def per_forward(calls, measured, bucket, kind, key):
    return sum(measured[s][key] for s in calls[bucket] if s[0] == kind)


def with_output(g, op_index):
    """The same graph with op ``op_index``'s output appended to its outputs,
    so a paged FC's logits are compared exactly, not only through softmax."""
    from repro_torch.core import graph as G
    t = g.ops[op_index].outputs[0]
    if t in g.outputs:
        return g
    return G.Graph(g.tensors, g.ops, g.inputs, list(g.outputs) + [t], g.name)


def fc256_model():
    """``benchmarks/bench_paging.py``'s 256 -> 256 RELU FC at batch 4."""
    from repro_torch.core.builder import GraphBuilder
    from repro_torch.core.quantize import quantize_graph
    rng = np.random.default_rng(0)
    b = GraphBuilder("paged_fc")
    x = b.input("x", (4, 256))
    b.output(b.fully_connected(x, rng.normal(0, 0.3, (256, 256)).astype("f"),
                               rng.normal(size=256).astype("f"), fused="RELU"))
    qg = quantize_graph(b.build(), [rng.normal(size=(4, 256)).astype("f")
                                    for _ in range(4)], device="cuda")
    return qg, qg.tensor(qg.inputs[0]).qparams.quantize(
        rng.normal(size=(4, 256)).astype("f"))


def max_diff(got, want) -> float:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    check(len(got) == len(want), "output count differs")
    d = 0.0
    for a, b in zip(got, want):
        check(a.shape == b.shape, f"shape {a.shape} != {b.shape}")
        d = max(d, float(np.abs(a.astype(np.float64)
                                - b.astype(np.float64)).max(initial=0)))
    return d


def launch_counts() -> dict:
    from repro_torch.kernels import launch_counts as counts
    return counts()


def graph_launches(cm) -> dict:
    """bucket -> the kernel-wrapper calls its CUDA graph holds (counted
    during the capture; a replay calls no wrapper)."""
    return {e["bucket"]: e["launches"] for e in cm.compile_log
            if e["kind"] == "bucket"}


def percall_launches(cm) -> list:
    """The kernel-wrapper calls each ``"percall"`` capture of ``cm`` holds
    (one entry once ``predict_q`` has run on one sample)."""
    return [e["launches"] for e in cm.compile_log if e["kind"] == "percall"]


def reset_counts() -> None:
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import paged_matmul as pm_mod
    from repro_torch.kernels import qdwconv as dw_mod
    from repro_torch.kernels import qmatmul as mm_mod
    mm_mod.launches = dw_mod.launches = pm_mod.launches = 0
    mm_mod.fmatmul_launches = kops.probe_launches = 0


def ptxas_report(log: str) -> dict:
    """Entry function (mangled) -> registers, shared-memory, stack-frame
    and spill bytes, from nvcc's ``-Xptxas=-v`` output."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$]+)'?", line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, {})
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            (out[fn]["stack_bytes"], out[fn]["spill_stores"],
             out[fn]["spill_loads"]) = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            out[fn]["smem_bytes"] = int(m.group(1))
    return out


def phase_explicit(explicit, measured, built):
    """The explicit cases with the ptxas report of the kernels each
    launches; ptxas must report no spills in any of the four redesigned
    kernels."""
    from repro_torch.kernels import paged_matmul as pm_mod
    from repro_torch.kernels import qdwconv as dw_mod
    from repro_torch.kernels import qmatmul as mm_mod
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    reports = {name: ptxas_report(built[name]["log"])
               for name in ("qmatmul", "fmatmul", "qdwconv", "paged_qmatmul")}
    for name, rep in reports.items():
        check(rep, f"{name}: no ptxas report in the build log")
        spilled = {fn: r for fn, r in rep.items()
                   if r.get("spill_stores", 0) or r.get("spill_loads", 0)}
        check(not spilled, f"{name}: ptxas reports spills: {spilled}")
    cases = []
    for sig in explicit:
        kind, xs, ws = sig[:3]
        if kind == "qmatmul":
            m, k = xs
            bm, bn, bk = mm_mod.block_tile(m, k, ws[0])
            config, mkn = {"block_tile": [bm, bn, bk]}, [m, k, ws[0]]
            tags = [f"qmatmul_kernelILi{bm}ELi{bn}ELi{bk}E"]
        elif kind == "fmatmul":
            m, k = xs
            splits, kslice = mm_mod.fmatmul_splits(m, k, ws[1], sms)
            config, mkn = {"splits": splits, "kslice": kslice}, [m, k, ws[1]]
            t = "f" if sig[3] == "float32" else "13__nv_bfloat16"
            tags = [f"fmatmul_kernelI{t}E", f"fmatmul_reduceI{t}E"]
        elif kind == "paged_qmatmul":
            m, k = xs
            sc, kc, flat = pm_mod.paged_split(k, ws[1], sig[5])
            config = {"page": sig[5], "slice": sc, "kc": kc, "flat": flat,
                      "blocks": pm_mod.paged_blocks(m, ws[1], sig[5], sc)}
            mkn, tags = [m, k, ws[1]], ["paged_qmatmul_kernel"]
        else:
            (sh, sw), pads, z_x = sig[6]
            oh, ow = dw_out_hw(xs, ws, sig[6])
            tile = dw_mod.dw_tile(xs[0], oh, ow, xs[3], ws[0], ws[1], sh, sw)
            config = {"stride": [sh, sw], "pads": list(pads), "z_x": z_x,
                      "tile_cg_th_tpg": list(tile),
                      "blocks": dw_mod.dw_blocks(xs[0], oh, ow, xs[3], tile)}
            mkn = list(xs) + list(ws)
            geo = (ws[0], ws[1], sh, sw) if ws[:2] == (3, 3) and sh == sw \
                and sh in (1, 2) else (0, 0, 0, 0)
            tags = ["qdwconv_kernelI" + "".join(f"Li{g}E" for g in geo)]
        r = measured[sig]
        cases.append({
            "kind": kind, "dtype": sig[3] if kind == "fmatmul" else "int8",
            "shape": mkn, **config,
            **{key: r[key] for key in ("ms", "plain_ms", "library",
                                       "library_ms", "bound_ms", "bound_by",
                                       "max_abs_err")},
            "bound_share": r["bound_ms"] / r["ms"],
            "ms_le_library": r["ms"] <= r["library_ms"],
            "ptxas": {fn: rep for fn, rep in reports[kind].items()
                      if any(tag in fn for tag in tags)}})
    emit({"phase": "explicit", "cases": cases})


# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------

def phase_probe():
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as kops

    kops.can_launch_kernels.cache_clear()
    result = kops.can_launch_kernels()
    check(result == (True, None), f"can_launch_kernels() = {result}")
    fn = _build.function("probe", "repro_probe",
                         [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((8, 128), generator=gen, device="cuda")
    out = torch.empty_like(x)

    def kern():
        _build.launch_check("probe", fn(_build.ptr(x, 4), _build.ptr(out, 4),
                                        x.numel(), _build.cuda_stream(x)))

    kern()
    torch.cuda.synchronize()
    err = float((out - (x + 1)).abs().max())
    check(err == 0.0, f"probe kernel differs from x + 1 by {err}")
    sig = ("probe", (8, 128), (), "float32", None, None, None)
    b_ms, b_by = bound_ms(sig)
    m = dict(max_abs_err=err, ms=graph_ms(kern), plain_ms=graph_ms(lambda: x + 1),
             library_ms=graph_ms(lambda: torch.add(x, 1.0)),
             call_ms=cuda_ms(kern), bound_ms=b_ms, bound_by=b_by)
    emit({"phase": "probe", "can_launch_kernels": list(result), **m})
    return m


# ---------------------------------------------------------------------------
# the paged route: the second main path
# ---------------------------------------------------------------------------

def phase_paging(models, fc256, float_speech):
    """``models``: name -> (graph, 8 inputs); ``fc256``: (graph, input);
    ``float_speech``: (float graph, 8 float inputs). Builds the engines and
    runs every forward inside one count."""
    from repro_torch.core.engine import CompiledModel
    from repro_torch.core.memory import plan_paged, plan_stack
    from repro_torch.kernels import ops as kops

    def forwards(cm, xs):
        return ([cm.predict_q(xs[0])]
                + [cm.predict_q_many(xs[:b], max_batch=MAX_BATCH)
                   for b in PAGED_BUCKETS])

    # predict_q's first call and a bucket's first call are two forwards
    # each (the eager run before the capture, and the capture)
    n_fwd = 2 + 2 * len(PAGED_BUCKETS)
    want_card, want_cpu, unpaged = {}, {}, {}
    for name, (g, xs) in models.items():
        paged = PAGED[name][1]
        unpaged[name] = CompiledModel(g, device="cuda")
        want_card[name] = forwards(unpaged[name], xs)
        want_cpu[name] = forwards(CompiledModel(g, use_kernels=False,
                                                device="cpu", paged=paged), xs)
    fg, fx = fc256
    fc_card = CompiledModel(fg, device="cuda").predict_q(fx)
    fc_cpu = {p: CompiledModel(fg, use_kernels=False, device="cpu",
                               paged={0: p}).predict_q(fx) for p in FC256_PAGES}
    sg, sxs = float_speech
    float_plain = forwards(CompiledModel(sg, use_kernels=False, device="cuda"),
                           sxs)
    float_cpu = forwards(CompiledModel(sg, use_kernels=False, device="cpu"), sxs)
    torch.cuda.synchronize()

    # -- the count: engines built and driven as a fresh process would -------
    reset_counts()
    kops.can_launch_kernels.cache_clear()
    t0 = time.perf_counter()
    got, per_model, engines = {}, {}, {}
    for name, (g, xs) in models.items():
        before = launch_counts()
        cm = engines[name] = CompiledModel(g, device="cuda",
                                           paged=PAGED[name][1])
        got[name] = forwards(cm, xs)
        torch.cuda.synchronize()
        per_model[name] = {k: v - before[k] for k, v in launch_counts().items()}
    before = launch_counts()
    fc_got = {p: CompiledModel(fg, device="cuda", paged={0: p}).predict_q(fx)
              for p in FC256_PAGES}
    torch.cuda.synchronize()
    per_model["fc256"] = {k: v - before[k] for k, v in launch_counts().items()}
    before = launch_counts()
    float_cm = CompiledModel(sg, device="cuda")
    float_got = forwards(float_cm, sxs)
    torch.cuda.synchronize()
    per_model["speech_float"] = {k: v - before[k]
                                 for k, v in launch_counts().items()}
    launches = launch_counts()
    wall_s = time.perf_counter() - t0
    for cm, xs in [(engines[n], xs) for n, (_, xs) in models.items()] + [
            (float_cm, sxs)]:  # the graphs again: replays, no wrapper call
        forwards(cm, xs)
    torch.cuda.synchronize()
    check(launch_counts() == launches, "a replay called a kernel wrapper")

    # -- checks ---------------------------------------------------------------
    check(launches["probe"] == 1, f"probe launches {launches['probe']}")
    per_fwd_q = {"sine": (1, 0), "speech": (1, 0), "person": (14, 13)}
    report = {}
    for name, (g, xs) in models.items():
        shape, paged, paged_per_fwd, fc_op = PAGED[name]
        c = per_model[name]
        check(c["paged_qmatmul"] == paged_per_fwd * n_fwd,
              f"{name}: paged_qmatmul launches {c['paged_qmatmul']} for "
              f"{n_fwd} forwards, expected {paged_per_fwd} per forward")
        check((c["qmatmul"], c["qdwconv"]) == tuple(
            v * n_fwd for v in per_fwd_q[name]),
            f"{name}: unpaged launches {c}")
        check(len(percall_launches(engines[name])) == 1,
              f"{name}: per-call captures {engines[name].compile_log}")
        for e in engines[name].compile_log:
            gc = e["launches"]
            check((gc["paged_qmatmul"], gc["qmatmul"], gc["qdwconv"])
                  == (paged_per_fwd,) + per_fwd_q[name],
                  f"{name} {e['kind']} {e.get('bucket')}: kernel calls in "
                  f"its graph {gc}")
        card_d = max(max_diff(a, b) for a, b in zip(got[name], want_card[name]))
        check(card_d == 0, f"{name}: paged rows differ from the card's "
                           f"unpaged engine by {card_d}")
        producer = {op.outputs[0]: op.op for op in g.ops}
        soft = [producer[t] == "SOFTMAX" for t in g.outputs]
        logits_d, probs_d = 0.0, 0.0
        for a, b in zip(got[name], want_cpu[name]):
            a = a if isinstance(a, tuple) else (a,)
            b = b if isinstance(b, tuple) else (b,)
            for u, v, is_soft in zip(a, b, soft):
                if is_soft:
                    probs_d = max(probs_d, max_diff(u, v))
                else:
                    logits_d = max(logits_d, max_diff(u, v))
        check(logits_d == 0, f"{name}: paged logits differ from the CPU "
                             f"plain route by {logits_d}")
        check(probs_d <= 1, f"{name}: softmax differs from the CPU plain "
                            f"route by {probs_d}")
        # bucket-8 call, host clock, paged and unpaged engines in turns
        bucket8 = {"unpaged": [], "paged": []}
        for label in ("unpaged", "paged", "paged", "unpaged"):
            eng = unpaged[name] if label == "unpaged" else engines[name]
            bucket8[label].append(host_ms(
                lambda eng=eng: eng.predict_q_many(xs, max_batch=MAX_BATCH),
                reps=10))
        pp, st = plan_paged(g, paged), plan_stack(g)
        report[name] = {
            "paged": {str(k): v for k, v in paged.items()},
            "launches": c, "paged_per_forward": c["paged_qmatmul"] / n_fwd,
            "forwards": n_fwd, "vs_card_unpaged_max_abs_diff": card_d,
            "vs_cpu_plain_logits_max_abs_diff": logits_d,
            "vs_cpu_plain_softmax_max_abs_diff": probs_d,
            "plan_paged_peak_bytes": pp.peak_bytes,
            "plan_stack_peak_bytes": st.peak_bytes,
            "paged_op_bytes": {str(i): [pp.per_op[i], st.per_op[i]]
                               for i in paged},
            "bucket8_call_ms": bucket8}
    # each engine's predict_q: an eager run and the per-call capture
    check(per_model["fc256"]["paged_qmatmul"] == 2 * len(FC256_PAGES),
          f"fc256 launches {per_model['fc256']}")
    for p in FC256_PAGES:
        check(max_diff(fc_got[p], fc_card) == 0 and
              max_diff(fc_got[p], fc_cpu[p]) == 0,
              f"fc256 pages {p}: rows differ")
    pp = {p: plan_paged(fg, {0: p}) for p in FC256_PAGES}
    report["fc256"] = {"launches": per_model["fc256"],
                       "plan_stack_peak_bytes": plan_stack(fg).peak_bytes,
                       "plan_paged_peak_bytes": {str(p): pp[p].peak_bytes
                                                 for p in FC256_PAGES}}
    check(per_model["speech_float"]["fmatmul"] == n_fwd,
          f"float speech launches {per_model['speech_float']}")
    tol = FMATMUL_TOL["float32"]
    for a, b in zip(float_got, float_plain):
        check(np.allclose(a, b, rtol=tol, atol=tol),
              "float speech: kernel route differs from the card's plain route")
    report["speech_float"] = {
        "launches": per_model["speech_float"],
        "vs_card_plain_max_abs_diff": max(max_diff(a, b) for a, b in
                                          zip(float_got, float_plain)),
        "vs_cpu_plain_max_abs_diff": max(max_diff(a, b) for a, b in
                                         zip(float_got, float_cpu))}
    emit({"phase": "paging", "launches": launches, "wall_s": round(wall_s, 3),
          "models": report})
    return launches


def phase_routes(cases):
    """``cases``: (name, graph, inputs, paging map) -> every route of
    ``predict_q_routed`` equals the primary route bit for bit."""
    from repro_torch.core.engine import CompiledModel
    out = {}
    for name, g, xs, paged in cases:
        cm = CompiledModel(g, device="cuda", paged=paged)
        primary = cm.predict_q_routed(xs, max_batch=MAX_BATCH)
        ms = {}
        for route in cm.routes():
            rows = cm.predict_q_routed(xs, route=route, max_batch=MAX_BATCH)
            d = max_diff(rows, primary)
            check(d == 0, f"{name}: route {route} differs from the primary "
                          f"route by {d}")
            ms[route] = host_ms(lambda r=route: cm.predict_q_routed(
                xs, route=r, max_batch=MAX_BATCH), reps=3)
        out[name] = {"routes": list(cm.routes()), "rows": int(xs.shape[0]),
                     "captures": {"kernels": cm.compile_events, "compiled":
                                  cm._fallback_compiled().compile_events},
                     "paged": {str(k): v for k, v in (paged or {}).items()},
                     "identical": True, "ms_per_call": ms}
    emit({"phase": "routes", "models": out})


# ---------------------------------------------------------------------------
# the serving stack: the third main path
# ---------------------------------------------------------------------------

def _serving_pools(models) -> dict:
    """name -> SERVING_POOL seeded int8 rows of the model's input shape."""
    rng = np.random.default_rng(SEED + 3)
    return {name: rng.integers(-128, 128, (SERVING_POOL,) + tuple(
        m.graph.tensor(m.graph.inputs[0]).shape)).astype(np.int8)
        for name, m in models.items()}


def _rows_equal(name, got, want) -> int:
    """Max |got - want|; int8 logits must be equal, softmax rows (speech,
    person) may differ by one LSB from the CPU plain route."""
    d = int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max(initial=0))
    check(d <= (0 if name == "sine" else 1),
          f"{name}: a served row differs from the CPU plain route by {d}")
    return d


def phase_serving():
    """``build_paper_registry`` on the card at full width behind the real
    clock, a thread pool of SERVING_WORKERS and a tracer with a flight
    recorder; every bucket of every model captured at warm-up on both
    engine routes; concurrent clients in two priority classes; then the
    kernel route failed (served on the captured plain route) and the plain
    route failed too (served by the reference interpreter)."""
    import asyncio

    from repro_torch.core.engine import CompiledModel, bucket_floor
    from repro_torch.obs import FlightRecorder, Tracer
    from repro_torch.serve.executor import ThreadPoolExecutorBackend
    from repro_torch.serve.faults import FaultInjector
    from repro_torch.serve.registry import ServingRegistry, build_paper_registry
    from repro_torch.serve.resilience import (BreakerPolicy, ResilientExecutor,
                                              RetryPolicy)
    from repro_torch.serve.scheduler import ClassPolicy

    names = tuple(SERVING_LAUNCHES)
    classes = {"interactive": ClassPolicy(priority=1, max_delay_s=0.001),
               "batch": ClassPolicy(priority=0, max_delay_s=0.004)}
    top = bucket_floor(SERVING_MAX_BATCH)
    want_buckets = tuple(1 << i for i in range(top.bit_length()))

    # -- warm-up, counted: the captures are the only wrapper calls ----------
    reset_counts()
    t0 = time.perf_counter()
    tracer = Tracer(flight=FlightRecorder(
        path=os.path.join(ROOT, "build", "flightrec.json")))
    reg = build_paper_registry(names, device="cuda",
                               max_batch=SERVING_MAX_BATCH,
                               executor_workers=SERVING_WORKERS,
                               tracer=tracer, classes=classes, max_queue=1024)
    models = {n: reg._entry(n).model for n in names}
    for m in models.values():
        m.warmup_routes(SERVING_MAX_BATCH)  # the compiled fallback's buckets
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_counts = launch_counts()
    captures, staging = {}, {}
    for name, m in models.items():
        fb = m._fallback_compiled()
        for route, eng in (("kernels", m), ("compiled", fb)):
            check(eng.bucket_sizes() == want_buckets
                  and eng.compile_events == len(want_buckets),
                  f"{name} {route}: buckets {eng.bucket_sizes()}, "
                  f"{eng.compile_events} captures")
            for b, c in graph_launches(eng).items():
                want = SERVING_LAUNCHES[name] if route == "kernels" else {}
                check({k: v for k, v in c.items() if v} == want,
                      f"{name} {route} bucket {b}: kernel calls {c}")
        captures[name] = {"kernels": m.compile_events,
                          "compiled": fb.compile_events}
        staging[name] = {"kernels": m.staging_events,
                         "compiled": fb.staging_events}
    for k in ("qmatmul", "qdwconv"):
        check(warm_counts[k] > 0, f"serving warm-up launched no {k}")
    reserved = torch.cuda.memory_reserved()

    pools = _serving_pools(models)
    want = {n: CompiledModel(m.graph, use_kernels=False, device="cpu")
            .predict_q_many(pools[n], max_batch=SERVING_MAX_BATCH)
            for n, m in models.items()}

    # -- healthy serving: concurrent clients, real clock ----------------------
    async def client(k, registry, n_req, picks):
        out = []
        for i in range(n_req):
            name = names[(k + i) % len(names)]
            j = picks(name, k, i)
            y = await registry.infer(name, pools[name][j],
                                     cls=("interactive", "batch")[(k + i) % 2])
            out.append((name, j, np.asarray(y)))
            if i % 4 == 3:
                await asyncio.sleep(0.0005)
        return out

    async def healthy():
        async with reg:
            t = time.perf_counter()
            res = await asyncio.gather(*(client(
                k, reg, SERVING_REQUESTS,
                lambda name, k, i: (k * SERVING_REQUESTS + i) % SERVING_POOL)
                for k in range(SERVING_CLIENTS)))
            wall = time.perf_counter() - t
            return ([r for rs in res for r in rs], wall, reg.openmetrics(),
                    reg.telemetry(), reg.snapshot())

    served, wall, text, tel, snap = asyncio.run(healthy())
    torch.cuda.synchronize()
    check(len(served) == SERVING_CLIENTS * SERVING_REQUESTS, "rows missing")
    diffs = {n: 0 for n in names}
    healthy_rows = {}
    for name, j, y in served:
        diffs[name] = max(diffs[name], _rows_equal(name, y, want[name][j]))
        healthy_rows[(name, j)] = y
    check(launch_counts() == warm_counts,
          "a kernel wrapper ran while serving (replays call none)")
    for name, m in models.items():
        check({"kernels": m.compile_events,
               "compiled": m._fallback_compiled().compile_events}
              == captures[name], f"{name}: a bucket was captured again")
        check(m.staging_events == staging[name]["kernels"],
              f"{name}: the staging pool allocated while serving")
    check(text.rstrip().endswith("# EOF"), "openmetrics() must end # EOF")
    check("stage_breakdown_us" in tel, "telemetry() lacks stage_breakdown_us")
    for name in names:
        check(snap[name]["completed"] == sum(1 for r in served if r[0] == name)
              and snap[name]["failed"] == 0, f"{name}: {snap[name]}")

    # -- the kernel route failed, then the plain route too --------------------
    inj = FaultInjector(persistent_routes={"kernels"})
    rex = ResilientExecutor(inj.wrap(ThreadPoolExecutorBackend(
        max_workers=SERVING_WORKERS)), retry=RetryPolicy(max_attempts=2,
                                                         jitter=0.0),
        breaker=BreakerPolicy(failure_threshold=2, recovery_s=3600.0))
    reg2 = ServingRegistry(max_batch=SERVING_MAX_BATCH, executor=rex,
                           classes=classes, tracer=Tracer(), max_queue=1024)
    for name, m in models.items():
        reg2.register(name, m)
    seen = {n: sorted(j for m, j in healthy_rows if m == n) for n in names}

    def picks(name, k, i, n):  # rows the healthy run served
        return seen[name][(k * n + i) % len(seen[name])]

    async def degraded():
        async with reg2:
            out = {}
            for stage, n_req in (("compiled", SERVING_FAULT_REQUESTS),
                                 ("reference", SERVING_REFERENCE_REQUESTS)):
                if stage == "reference":
                    inj.break_route("compiled")
                res = await asyncio.gather(*(client(
                    k, reg2, n_req,
                    lambda name, k, i, n=n_req: picks(name, k, i, n))
                    for k in range(len(names))))
                out[stage] = ([r for rs in res for r in rs],
                              {n: dict(s["degraded_by_route"])
                               for n, s in reg2.snapshot().items()})
            return out

    deg = asyncio.run(degraded())
    torch.cuda.synchronize()
    degraded_report = {}
    for stage, (rows, by_route) in deg.items():
        for name, j, y in rows:
            check(np.array_equal(y, healthy_rows[(name, j)]),
                  f"{name}: a row served on {stage} differs from the "
                  f"healthy run's")
        check(all(by_route[n].get(stage, 0) > 0 for n in names),
              f"nothing was served on {stage}: {by_route}")
        degraded_report[stage] = {"rows": len(rows),
                                  "bit_identical_to_healthy": True,
                                  "degraded_by_route": by_route}
    check(launch_counts() == warm_counts,
          "a kernel wrapper ran while serving degraded")
    for name, m in models.items():
        fb = m._fallback_compiled()
        check(fb.compile_events == captures[name]["compiled"]
              and fb.staging_events == staging[name]["compiled"],
              f"{name}: the compiled route recaptured or allocated")

    # -- bucket-call latency (host clock), graph replay and eager forward -----
    latency = {}
    for name, m in models.items():
        latency[name] = {}
        for b in SERVING_LATENCY_BUCKETS:
            xs = pools[name][:b]
            replay = host_ms(lambda: m.predict_q_many(
                xs, max_batch=SERVING_MAX_BATCH), reps=20)
            eager = host_ms(lambda: [o[:b].cpu() for o in
                                     eager_forward(m, xs)], reps=20)
            latency[name][str(b)] = {"replay_ms": replay, "eager_ms": eager}
    emit({"phase": "serving", "models": list(names),
          "max_batch": SERVING_MAX_BATCH, "workers": SERVING_WORKERS,
          "buckets": list(want_buckets), "warmup_s": round(warm_s, 3),
          "compile_events": captures, "staging_events": staging,
          "warmup_launches": {k: v for k, v in warm_counts.items() if v},
          "memory_reserved_bytes": reserved,
          # this phase before logical staging and the per-model lock
          # (lane-padded staging and static inputs, a lock per bucket), on
          # an NVIDIA H100 80GB HBM3 at 700 W, for comparison
          "memory_reserved_bytes_before": 1830813696,
          "requests": len(served), "clients": SERVING_CLIENTS,
          "serve_wall_s": round(wall, 4),
          "rows_per_s": round(len(served) / wall, 1),
          "rows_per_s_before": [1611.6, 1522.3],
          "max_abs_diff_vs_cpu_plain": diffs,
          "stage_breakdown_us": tel["stage_breakdown_us"],
          "flight": tel.get("flight"), "degraded": degraded_report,
          "ms_per_bucket_call": latency})
    return models


# ---------------------------------------------------------------------------
# the trace's H2D copies, the shared graph pool, the plan auditor
# ---------------------------------------------------------------------------

def h2d_copies(prof) -> dict:
    """The host-to-device copies in ``prof``'s trace: the bytes and the
    device ms of each (the trace's memcpy events)."""
    path = os.path.join(ROOT, "build", "trace_person_b8.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")]
    return {"bytes": [int(e.get("args", {}).get("bytes", -1))
                      for e in copies],
            "ms": [round(float(e.get("dur", 0.0)) / 1e3, 5) for e in copies]}


def phase_pool(qg):
    """Person's kernel route, buckets 1, 2, 4, 8 captured in that order in
    the model's one graph pool. For each pair (earlier e, later l): the raw
    sequence — replay l, replay e, read l's static outputs — recorded
    (aliased: l's outputs changed), and the same interleaving through the
    API, every row equal to the eager forward's. Then 8 threads call the
    four buckets and the per-call graph interleaved; every row exact."""
    import itertools
    import threading

    from repro_torch.core.engine import CompiledModel
    cm = CompiledModel(qg, device="cuda")
    rng = np.random.default_rng(SEED + 5)
    shape = qg.tensor(qg.inputs[0]).shape
    buckets = (1, 2, 4, 8)
    xs = {b: rng.integers(-128, 128, (b,) + shape).astype(np.int8)
          for b in buckets}
    exes = {b: cm.compile_batched(b) for b in buckets}
    staged = {b: torch.as_tensor(xs[b], device="cuda") for b in buckets}
    eager = {b: cm._batched_fn(staged[b])[0].cpu().numpy() for b in buckets}
    single = cm._fn(staged[1][0])[0].cpu().numpy()
    aliased = []
    for e, l in itertools.combinations(buckets, 2):
        with cm._replay_lock, torch.cuda.stream(cm._stream):
            exes[l].inputs[0].copy_(staged[l])
            exes[l].graph.replay()
            exes[e].inputs[0].copy_(staged[e])
            exes[e].graph.replay()
            raw = exes[l].outputs[0].cpu().numpy()
        if not np.array_equal(raw, eager[l]):
            aliased.append([e, l])
        for b in (l, e, l):
            check(np.array_equal(cm.predict_q_many(xs[b]), eager[b]),
                  f"pool: bucket {b} differs after the pair ({e}, {l})")
    errors, done, calls = [], [], 40

    def worker(k):
        try:
            for i in range(calls):
                b = buckets[(k + i) % 4]
                if i % 8 == 7:
                    ok = np.array_equal(cm.predict_q(xs[1][0]), single)
                else:
                    ok = np.array_equal(cm.predict_q_many(xs[b]), eager[b])
                if not ok:
                    errors.append((k, i, b))
            done.append(k)
        except Exception as e:  # surfaced by the check below
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads) and errors == []
          and sorted(done) == list(range(8)),
          f"pool: threaded calls went wrong: {errors[:5]}")
    check(cm.compile_events == 5, f"pool: {cm.compile_events} captures")
    emit({"phase": "pool", "captures": [e["kind"] if e["kind"] == "percall"
                                        else e["bucket"]
                                        for e in cm.compile_log],
          "pairs": 6, "aliased_pairs_raw": aliased,
          "api_interleave_exact": True, "threads": 8,
          "calls": 8 * calls, "threaded_exact": True,
          "threaded_wall_s": round(wall, 4)})


AUDIT_CASES = (("sine", None), ("speech", None), ("person", None),
               ("speech", {2: 4}))


def phase_audit():
    """The plan auditor on the card (see the module docstring, 12)."""
    from repro_torch.analysis import (device_advisory, errors, measured_pads,
                                      pad_budget, plan_fingerprint)
    from repro_torch.analysis.__main__ import audit_plan, quantized_graph
    from repro_torch.core.engine import CompiledModel, ExecutionPlan

    graphs = {n: quantized_graph(n, device="cuda")
              for n in {n for n, _ in AUDIT_CASES}}
    out = []
    for name, paged in AUDIT_CASES:
        g = graphs[name]
        label = name + ("" if paged is None else f" paged {paged}")
        cm = CompiledModel(g, device="cuda", paged=paged)
        cm.warmup_batched(MAX_BATCH)
        rep = audit_plan(name, cm.exec_plan, max_batch=MAX_BATCH,
                         compiled_model=cm)
        check(not errors(rep.verifier),
              f"audit {label}: {[str(f) for f in errors(rep.verifier)]}")
        check(rep.retrace_findings == [] and rep.retrace["ok"],
              f"audit {label}: {[str(f) for f in rep.retrace_findings]}")
        check(rep.ok, f"audit {label}: {[str(f) for f in errors(rep.findings)]}")
        pads = {}
        for r in rep.routes:
            if r.route == "paged":
                continue
            batched = r.route != "per-call"
            b = int(r.route.split("=")[1].rstrip("]")) if batched else 1
            derived = pad_budget(cm.exec_plan, batched=batched, bucket=b)
            got = measured_pads(cm.exec_plan, batched=batched, bucket=b)
            check(derived.total == got,
                  f"audit {label} {r.route}: derived {derived.total} pad/cat "
                  f"calls, measured {got}: {derived.items}")
            pads[r.route] = [derived.total, got, derived.enforceable]
        cpu = ExecutionPlan.build(g, use_kernels=True, device="cpu",
                                  paged=paged)
        check(plan_fingerprint(cpu) == rep.fingerprint,
              f"audit {label}: the card's fingerprint differs from the CPU "
              f"build's")
        out.append({"model": label, "ok": rep.ok,
                    "findings": [str(f) for f in rep.findings],
                    "retrace": rep.retrace, "fingerprint": rep.fingerprint,
                    "fingerprint_equals_cpu_build": True,
                    "pads_derived_measured_enforceable": pads,
                    "arena_static_measured": {
                        r.route: [r.arena.get("static_peak_bytes"),
                                  r.arena.get("measured_peak_bytes")]
                        for r in rep.routes},
                    "device_advisory": device_advisory(cm)})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           "--selftest", "--device", "cuda"], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"auditor selftest rc {proc.returncode}: "
                                f"{proc.stderr[-2000:]}")
    emit({"phase": "audit", "max_batch": MAX_BATCH, "models": out,
          "selftest": {"rc": proc.returncode,
                       "stdout": proc.stdout.strip().splitlines()[-1:],
                       "wall_s": round(time.perf_counter() - t0, 3)}})


# ---------------------------------------------------------------------------
# cold start: the registry's boot, cold, warm from the cache, and corrupt
# ---------------------------------------------------------------------------

COLDSTART_NAMES = ("sine", "speech", "person")
COLDSTART_BATCHES = (1, 3, 8)
COLDSTART_BUCKETS = 6          # buckets 1..32 per engine route
COLDSTART_LIBRARIES = {"qmatmul", "qdwconv", "probe"}


class _Timers:
    """Exclusive wall seconds spent in wrapped functions, by key: a timed
    call nested in another (a capture inside a cache load) counts only
    under its own key. One thread (the boot's)."""

    def __init__(self):
        self.total: dict = {}
        self._stack: list = []

    def wrap(self, owner, attr: str, key: str) -> None:
        import inspect
        fn = getattr(owner, attr)
        static = isinstance(inspect.getattr_static(owner, attr), classmethod)

        def timed(*args, **kw):
            t0 = time.perf_counter()
            self._stack.append(0.0)
            try:
                return fn(*args, **kw)
            finally:
                dt = time.perf_counter() - t0
                inner = self._stack.pop()
                self.total[key] = self.total.get(key, 0.0) + dt - inner
                if self._stack:
                    self._stack[-1] += dt

        setattr(owner, attr, staticmethod(timed) if static else timed)


def boot_main(argv) -> int:
    """One registry boot in a fresh process (``chip_smoke.py --boot CACHE
    BUILD_DIR OUT``; the ``coldstart`` phase runs three): the three paper
    models at full width with ``cache_dir=CACHE``, both engine routes warmed
    through the cache, then requests; ``BUILD_DIR`` (if not empty) replaces
    the kernels' build directory. Writes what the boot did to ``OUT``."""
    import asyncio
    from pathlib import Path

    cache_dir, build_dir, out_path = argv
    if not torch.cuda.is_available():
        print("chip_smoke --boot: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.engine import CompiledModel, ExecutionPlan
    from repro_torch.kernels import _build
    from repro_torch.serve.aotcache import AotCache
    from repro_torch.serve.registry import build_paper_registry
    if build_dir:
        _build.BUILD_DIR = Path(build_dir)
    timers = _Timers()
    for owner, attr, key in (
            (ExecutionPlan, "build", "plan_builds"),
            (CompiledModel, "_make_executable", "captures"),
            (CompiledModel, "_warm_staging", "staging"),
            (AotCache, "store", "store"),
            (AotCache, "load", "load"),
            (AotCache, "install_libraries", "install_libraries")):
        timers.wrap(owner, attr, key)

    reset_counts()
    t0 = time.perf_counter()
    reg = build_paper_registry(COLDSTART_NAMES, device="cuda",
                               max_batch=SERVING_MAX_BATCH,
                               cache_dir=cache_dir)
    models = {n: reg._entry(n).model for n in COLDSTART_NAMES}
    for m in models.values():
        # the registry warmed the kernel route through the cache; the rest
        # of warmup_routes: the compiled fallback, through the cache too,
        # and the reference interpreter
        m._fallback_compiled().warmup_batched(SERVING_MAX_BATCH,
                                              cache=reg.cache)
        m._reference_interp()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    boot_launches = launch_counts()

    def engines():
        return {f"{n}/{route}": eng for n, m in models.items()
                for route, eng in (("kernels", m),
                                   ("compiled", m._fallback_compiled()))}

    state = {k: (e.compile_events, e.capture_events, e.staging_events)
             for k, e in engines().items()}
    pools = _serving_pools(models)
    rows = {}
    for n, m in models.items():
        for b in COLDSTART_BATCHES:
            rows[f"{n}/kernels/{b}"] = m.predict_q_many(
                pools[n][:b], max_batch=SERVING_MAX_BATCH)
            rows[f"{n}/compiled/{b}"] = m.predict_q_routed(
                pools[n][:b], route="compiled", max_batch=SERVING_MAX_BATCH)

    async def serve():
        async with reg:
            return {n: await asyncio.gather(*(
                reg.infer(n, pools[n][j]) for j in range(max(
                    COLDSTART_BATCHES)))) for n in models}

    for n, ys in asyncio.run(serve()).items():
        rows[f"{n}/served/{len(ys)}"] = np.stack([np.asarray(y) for y in ys])
    torch.cuda.synchronize()
    check({k: (e.compile_events, e.capture_events, e.staging_events)
           for k, e in engines().items()} == state,
          "an engine built, captured or allocated while serving")
    diffs = {}
    for n, m in models.items():
        want = CompiledModel(m.graph, use_kernels=False, device="cpu") \
            .predict_q_many(pools[n][:max(COLDSTART_BATCHES)])
        mine = {k: r for k, r in rows.items() if k.startswith(n + "/")}
        for k, r in mine.items():
            check(r.shape == want[:len(r)].shape, f"{k}: shape {r.shape}")
        diffs[n] = max(_rows_equal(n, r, want[:len(r)])
                       for r in mine.values())
    split = {k: round(v, 4) for k, v in sorted(timers.total.items())}
    doc = {"wall_s": round(wall, 4), "split_s": split,
           "other_s": round(wall - sum(timers.total.values()), 4),
           "engines": {k: {"compile_events": e.compile_events,
                           "capture_events": e.capture_events,
                           "cache_events": e.cache_events,
                           "cache": e.last_cache_result.to_dict()}
                       for k, e in engines().items()},
           "stats": reg.cache.stats(), "libraries": _build.libraries(),
           "build_dir": sorted(os.listdir(_build.BUILD_DIR))
           if _build.BUILD_DIR.exists() else None,
           "launches": boot_launches, "max_abs_diff_vs_cpu_plain": diffs,
           "telemetry": {k: {c: v[c] for c in ("compile_events",
                                                "capture_events",
                                                "cache_events")}
                         for k, v in reg.telemetry()["engines"].items()},
           "rows": {k: v.tolist() for k, v in rows.items()}}
    with open(out_path, "w") as f:
        json.dump(doc, f)
    return 0


def _boot(label: str, root: str, cache_dir: str, build_dir: str) -> dict:
    out = os.path.join(root, f"{label}.json")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--boot",
                           cache_dir, build_dir, out], cwd=ROOT,
                          env=dict(os.environ,
                                   PYTHONPATH=os.path.join(ROOT, "src")),
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"{label} boot: rc {proc.returncode}: "
                                f"{proc.stderr[-3000:]}")
    with open(out) as f:
        doc = json.load(f)
    doc["process_s"] = round(time.perf_counter() - t0, 3)
    return doc


def _boot_summary(doc: dict) -> dict:
    return {k: doc[k] for k in ("process_s", "wall_s", "split_s", "other_s",
                                "stats", "libraries", "build_dir",
                                "max_abs_diff_vs_cpu_plain")} | {
        "launches": {k: v for k, v in doc["launches"].items() if v},
        "engines": {k: {"hit": e["cache"]["hit"],
                        "reason": e["cache"]["reason"],
                        "findings": e["cache"]["findings"],
                        "compile_events": e["compile_events"],
                        "capture_events": e["capture_events"],
                        "cache_events": e["cache_events"]}
                    for k, e in doc["engines"].items()}}


def phase_coldstart(build_wall_s: float, nvcc_s: dict) -> dict:
    """The registry's boot from the executable cache (see the module
    docstring, 13): cold, warm with an empty build directory, and from a
    copy of the cache with one library truncated."""
    import shutil

    root = os.path.join(ROOT, "build", "coldstart")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    cache = os.path.join(root, "cache")
    cold = _boot("cold", root, cache, "")
    empty = os.path.join(root, "empty_build")
    os.makedirs(empty)
    warm = _boot("warm", root, cache, empty)
    damaged = os.path.join(root, "corrupt_cache")
    shutil.copytree(cache, damaged)
    victim, listing = None, set()  # the library, the manifests naming it
    for fp in sorted(os.listdir(damaged)):
        man = os.path.join(damaged, fp, "manifest.json")
        if os.path.exists(man):
            with open(man) as f:
                lib = json.load(f).get("libraries", {}).get("qdwconv")
            if lib:
                victim = os.path.join(damaged, "lib", lib["file"])
                listing.add(fp)
                victim_sha = lib["sha256"]
    check(victim is not None, "no cache entry carries the qdwconv library")
    size = os.path.getsize(victim)
    with open(victim, "r+b") as f:
        f.truncate(size // 2)
    corrupt = _boot("corrupt", root, damaged, "")
    with open(victim, "rb") as f:
        healed = hashlib.sha256(f.read()).hexdigest() == victim_sha

    want_hits = 2 * len(COLDSTART_NAMES)
    check(cold["stats"] == {"root": cache, "hits": 0, "misses": want_hits,
                            "stores": want_hits}, f"cold: {cold['stats']}")
    for key, e in cold["engines"].items():
        check(not e["cache"]["hit"]
              and e["cache"]["reason"].startswith("no manifest")
              and e["compile_events"] == e["capture_events"]
              == COLDSTART_BUCKETS, f"cold {key}: {e}")
    check(warm["stats"]["hits"] == want_hits and warm["stats"]["misses"] == 0,
          f"warm: {warm['stats']}")
    for key, e in warm["engines"].items():
        check(e["cache"]["hit"] and e["compile_events"] == 0
              and e["capture_events"]
              == cold["engines"][key]["capture_events"]
              and e["cache_events"]["hit"] == COLDSTART_BUCKETS,
              f"warm {key}: {e}")
    libs = warm["libraries"]
    check(libs["nvcc_s"] == {}, f"warm boot ran nvcc: {libs['nvcc_s']}")
    check(set(libs["loaded"]) == COLDSTART_LIBRARIES
          and all(v["source"] == "cache" for v in libs["loaded"].values()),
          f"warm boot libraries: {libs['loaded']}")
    check(warm["build_dir"] == [] and os.listdir(empty) == [],
          f"the warm boot wrote to its build directory: {warm['build_dir']}")
    for label, doc in (("cold", cold), ("warm", warm), ("corrupt", corrupt)):
        check({k for k, v in doc["launches"].items() if v}
              == COLDSTART_LIBRARIES, f"{label} boot launches: "
                                      f"{doc['launches']}")
    check(warm["launches"] == cold["launches"],
          f"launches: warm {warm['launches']}, cold {cold['launches']}")
    for label, doc in (("warm", warm), ("corrupt", corrupt)):
        check(doc["rows"] == cold["rows"],
              f"{label} rows differ from the cold boot's")
    # the first engine to need the truncated library misses (C003) and
    # builds cold, loading it from the build directory; one that needs it
    # later finds it loaded under the same build name and hits, as does
    # every engine that does not need it; the miss's store heals the file
    missed = []
    for key, e in corrupt["engines"].items():
        if e["cache"]["hit"]:
            check(e["compile_events"] == 0, f"corrupt {key}: {e}")
            continue
        missed.append(key)
        check(e["cache"]["fingerprint"] in listing
              and any(f.startswith("[error] C003 kernel_qdwconv")
                      for f in e["cache"]["findings"])
              and e["compile_events"] == COLDSTART_BUCKETS
              and e["cache_events"]["hit"] == 0, f"corrupt {key}: {e}")
    check(len(missed) == 1, f"corrupt boot: misses on {missed}")
    check(corrupt["libraries"]["loaded"]["qdwconv"]["source"] == "build",
          f"corrupt boot: {corrupt['libraries']}")
    check(healed, "the corrupt boot's store did not heal the library")
    doc = {"phase": "coldstart", "models": list(COLDSTART_NAMES),
           "max_batch": SERVING_MAX_BATCH, "routes": ["kernels", "compiled"],
           "batches": list(COLDSTART_BATCHES),
           "build_phase_nvcc": {"wall_s": build_wall_s,
                                "per_source_s": nvcc_s},
           "cold": _boot_summary(cold), "warm": _boot_summary(warm),
           "corrupt": _boot_summary(corrupt),
           "truncated": os.path.relpath(victim, root),
           "truncated_listed_by": len(listing), "missed": missed,
           "healed": healed,
           "rows_warm_equal_cold": True, "rows_corrupt_equal_cold": True,
           "telemetry_warm": warm["telemetry"]}
    emit(doc)
    return doc


EXAMPLE_RUNS = (("torch_quickstart.py",), ("torch_person_detection.py",),
                ("torch_serve_tinyml.py", "64"),
                ("torch_serve_tinyml.py", "64", "--chaos"))
EXAMPLE_MARKS = {
    "torch_quickstart.py": "engines agree bit-exactly ✓",
    "torch_person_detection.py": "engines agree ✓",
    "torch_serve_tinyml.py":
        "served rows are bit-identical to direct predict_q ✓"}


def phase_examples() -> None:
    """The three ``examples/torch_*.py`` CLIs on the card, each in its own
    process (see the module docstring, 14)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    runs = []
    for args in EXAMPLE_RUNS:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable,
                               os.path.join(ROOT, "examples", args[0]),
                               *args[1:]], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"{' '.join(args)}: rc {proc.returncode}"
                                    f": {proc.stderr[-3000:]}")
        lines = proc.stdout.splitlines()
        check(EXAMPLE_MARKS[args[0]] in lines
              or any(EXAMPLE_MARKS[args[0]] in ln for ln in lines),
              f"{' '.join(args)} did not print {EXAMPLE_MARKS[args[0]]!r}")
        keep = [ln.strip() for ln in lines
                if "✓" in ln or "median" in ln or "served (" in ln
                or "resilience" in ln]
        runs.append({"args": list(args), "rc": proc.returncode,
                     "wall_s": round(time.perf_counter() - t0, 3),
                     "lines": keep})
    emit({"phase": "examples", "runs": runs})


# ---------------------------------------------------------------------------
# layer by layer
# ---------------------------------------------------------------------------

class counting_border_pads:
    """Within ``with counting_border_pads() as n:``, ``n["pads"]`` counts
    the ``F.pad`` calls made inside ``kernels.ops.qdwconv_planned`` and
    ``n["calls"]`` its calls: the SAME border is the kernel's, so no pad may
    run before a depthwise layer."""

    def __enter__(self):
        from repro_torch.kernels import ops as kops
        self.kops, self.orig = kops, (F.pad, kops.qdwconv_planned)
        n = {"pads": 0, "calls": 0, "inside": False}
        orig_pad, orig_planned = self.orig

        def pad(*a, **k):
            n["pads"] += n["inside"]
            return orig_pad(*a, **k)

        def planned(*a, **k):
            n["inside"], n["calls"] = True, n["calls"] + 1
            try:
                return orig_planned(*a, **k)
            finally:
                n["inside"] = False

        F.pad, kops.qdwconv_planned = pad, planned
        return n

    def __exit__(self, *exc):
        F.pad, self.kops.qdwconv_planned = self.orig
        return False


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
    border = {"pads": 0, "calls": 0}
    for i, op in enumerate(qg.ops):
        lay = layouts.get(i)
        ctx_k = R.OpContext(qg, op, i, folded=dev_plan.folded.get(i),
                            use_kernels=True, layout=lay)
        ctx_p = R.OpContext(qg, op, i, folded=cpu_plan.folded.get(i))
        with counting_border_pads() as n:
            out_k = R.run_compiled(ctx_k, [val(dev_plan, t, lay is not None)
                                           for t in op.inputs])
        border["pads"] += n["pads"]
        border["calls"] += n["calls"]
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
    check(border == {"pads": 0, "calls": LAUNCHES_PER_FORWARD["qdwconv"]},
          f"depthwise layers: {border['calls']} calls, {border['pads']} "
          f"separate border pads (expected none)")
    emit({"phase": "layers", "ops": len(layers),
          "kernel_ops": sum(1 for r in layers if r["route"] == "kernel"),
          "depthwise_calls": border["calls"],
          "border_pads_before_depthwise": border["pads"], "layers": layers})


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs.paper_models import (PAPER_MODELS, build_person,
                                                  build_speech)
    from repro_torch.core.engine import CompiledModel, bucket_for
    from repro_torch.core.quantize import quantize_graph
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as kops

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
    build_wall_s = round(time.perf_counter() - t0, 3)
    emit({"phase": "build", "wall_s": build_wall_s,
          "sources": {n: {"seconds": round(r["seconds"], 3),
                          "ptxas": ptxas_report(r["log"])}
                      for n, r in built.items()}})
    probe = phase_probe()

    # the first path: full-width person detector, random weights from a seed
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

    # the second path: the paged route on the three paper models, the
    # 256x256 FC, and the float speech model's FC on fmatmul
    paged_models = {}
    for name, (shape, paged, _, fc_op) in PAGED.items():
        prng = np.random.default_rng(SEED + 1)
        g = quantize_graph(PAPER_MODELS[name](), [
            prng.normal(0, 1, shape).astype("f") for _ in range(2)],
            device="cuda")
        g = with_output(g, fc_op)
        xs = np.stack([g.tensor(g.inputs[0]).qparams.quantize(
            prng.normal(0, 1, shape).astype("f")) for _ in range(8)])
        paged_models[name] = (g, xs)
    fc256 = fc256_model()
    float_speech = (build_speech(), np.random.default_rng(SEED + 2).normal(
        0, 1, (8, 1, 49, 40, 1)).astype("f"))
    paged_calls = {name: record_calls(
        CompiledModel(g, device="cuda", paged=PAGED[name][1]),
        {b: xs[:b] for b in PAGED_BUCKETS})
        for name, (g, xs) in paged_models.items()}
    fc_calls = [s for p in FC256_PAGES for s in record_calls(
        CompiledModel(fc256[0], device="cuda", paged={0: p}),
        {4: fc256[1][None]})[4]]
    float_calls = record_calls(CompiledModel(float_speech[0], device="cuda"),
                               {b: float_speech[1][:b] for b in PAGED_BUCKETS})
    for name, pc in paged_calls.items():
        for b in PAGED_BUCKETS:
            n = sum(1 for s in pc[b] if s[0] == "paged_qmatmul")
            check(n == PAGED[name][2],
                  f"{name} bucket {b}: {n} paged_qmatmul calls per forward")

    # fmatmul as ops.fmatmul calls it (K and N padded to whole 16-byte rows):
    # the float speech engine's calls (float32), the same products in
    # bfloat16, and the reference's dtype-sweep shapes in both
    engine_mkn = {(s[1][0], s[1][1], s[2][1]) for b in float_calls
                  for s in float_calls[b] if s[0] == "fmatmul"}
    with recording() as fm_sigs:
        for dtype in (torch.float32, torch.bfloat16):
            for m, k, n in sorted(engine_mkn) + list(FMATMUL_SHAPES):
                kops.fmatmul(torch.zeros((m, k), dtype=dtype, device="cuda"),
                             torch.zeros((k, n), dtype=dtype, device="cuda"))
    conv0 = calls[max(BUCKETS)][0]  # conv0 at bucket 8: its bounds, n_true
    check(conv0[0] == "qmatmul", f"first call of a forward: {conv0}")
    qm_m, qm_k, qm_n = QMATMUL_EXPLICIT
    fm_m, fm_k, fm_n = FMATMUL_EXPLICIT
    paged_sigs = ([s for pc in paged_calls.values() for b in pc
                   for s in pc[b] if s[0] == "paged_qmatmul"]
                  + [s for s in fc_calls if s[0] == "paged_qmatmul"])
    explicit = ([("qmatmul", (qm_m, qm_k), (qm_n, qm_k)) + conv0[3:]] + [
        ("fmatmul", (fm_m, fm_k), (fm_k, fm_n), dtype, None, None, None)
        for dtype in ("float32", "bfloat16")]
        + [("qdwconv", xs, ws, -20.0, 90.0, lanes, geo)
           for xs, ws, lanes, geo in DWCONV_EXPLICIT]
        + [next(s for s in paged_sigs if s[1:3] == (xs, ws) and s[5] == page)
           for xs, ws, page in PAGED_EXPLICIT])
    sigs = ([s for b in calls for s in calls[b]] + paged_sigs + fm_sigs
            + explicit)
    measured = phase_kernels(sigs)
    phase_explicit(explicit, measured, built)
    phase_layers(cm, qg, xq[0])

    # -- the first main path, counted ----------------------------------------
    # the first one-sample predict_q runs the per-call forward once eagerly
    # and captures it as a CUDA graph (two forwards' kernel calls); the
    # first predict_q_many of a bucket does the same with its batched
    # forward; every later call replays
    want_rows = plain_cpu.predict_q_many(xq, max_batch=MAX_BATCH)
    reset_counts()
    with counting_border_pads() as border:
        single = cm.predict_q(xq[0])
        served = {b: cm.predict_q_many(xq[:b], max_batch=MAX_BATCH)
                  for b in SERVE_BATCHES}
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts().items()
                if k in LAUNCHES_PER_FORWARD}
    captured = graph_launches(cm)
    check(sorted(captured) == sorted({bucket_for(b) for b in SERVE_BATCHES}),
          f"captured buckets {sorted(captured)}")
    percall = percall_launches(cm)
    check(len(percall) == 1, f"per-call captures: {percall}")
    for what, c in [(f"bucket {b}", c) for b, c in captured.items()] + [
            ("per-call", percall[0])]:
        check({k: c[k] for k in LAUNCHES_PER_FORWARD} == LAUNCHES_PER_FORWARD
              and sum(c.values()) == sum(LAUNCHES_PER_FORWARD.values()),
              f"{what}: kernel calls in its graph {c}")
    n_forwards = 2 + 2 * len(captured)
    check(launches == {k: v * n_forwards
                       for k, v in LAUNCHES_PER_FORWARD.items()},
          f"launches {launches} for {n_forwards} forwards")
    check(border["pads"] == 0, f"{border['pads']} border pads before the "
                               f"depthwise layers of {n_forwards} forwards")
    single_again = cm.predict_q(xq[0])
    replayed = {b: cm.predict_q_many(xq[:b], max_batch=MAX_BATCH)
                for b in SERVE_BATCHES}
    torch.cuda.synchronize()
    check({k: v for k, v in launch_counts().items()
           if k in LAUNCHES_PER_FORWARD} == launches,
          "a replay called a kernel wrapper")

    def close(got, want):
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        return int(d.max(initial=0))

    check(single.shape == (1, 2) and close(single, want_rows[0]) <= 1,
          "predict_q differs from the CPU plain route")
    check(np.array_equal(single_again, single),
          "the per-call replay differs from the captured call")
    for b, out in served.items():
        check(out.shape == (b, 1, 2), f"batch {b}: shape {out.shape}")
        check(close(out, want_rows[:b]) <= 1,
              f"batch {b}: rows differ from the CPU plain route")
        check(np.array_equal(replayed[b], out),
              f"batch {b}: the replay differs from the captured call")
    serve_ms = {str(bucket_for(b)): host_ms(
        lambda b=b: cm.predict_q_many(xq[:b], max_batch=MAX_BATCH))
        for b in SERVE_BATCHES}
    x1 = torch.as_tensor(xq[0], device="cuda")
    percall_ms = {"replay_ms": host_ms(lambda: cm.predict_q(xq[0])),
                  "eager_ms": host_ms(lambda: [o.cpu() for o in cm._fn(x1)])}
    emit({"phase": "serve", "launches": launches, "forwards": n_forwards,
          "graph_launches": {str(b): c for b, c in captured.items()},
          "percall_launches": percall[0],
          "border_pads_before_depthwise": border["pads"],
          "softmax_max_abs_diff": max(close(single, want_rows[0]),
                                      *(close(o, want_rows[:b])
                                        for b, o in served.items())),
          "ms_per_bucket_call": serve_ms, "ms_per_percall": percall_ms})

    # -- the second main path, counted ---------------------------------------
    paging_launches = phase_paging(paged_models, fc256, float_speech)
    launches.update({k: paging_launches[k]
                     for k in ("paged_qmatmul", "fmatmul", "probe")})
    speech_g, speech_xs = paged_models["speech"]
    phase_routes([("person", qg, xq[:3], None),
                  ("speech", speech_g, speech_xs[:3], PAGED["speech"][1])])

    # -- the third main path: the serving stack, counted ---------------------
    phase_serving()

    # -- device trace over bucket-8 calls (graph replays) ---------------------
    from torch.profiler import ProfilerActivity, profile
    cm.predict_q_many(xq, max_batch=MAX_BATCH)
    torch.cuda.synchronize()
    exe = cm.compile_batched(8)
    with torch.cuda.stream(exe.stream):  # the model's replay stream
        replay_ms = cuda_ms(exe.graph.replay, reps=5, inner=5)
    t0 = time.perf_counter()  # the same 5 calls without the profiler
    for _ in range(5):
        cm.predict_q_many(xq, max_batch=MAX_BATCH)
    torch.cuda.synchronize()
    plain_window_ms = (time.perf_counter() - t0) * 1e3
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
    h2d = h2d_copies(prof)
    check(h2d["bytes"] == [8 * 96 * 96 * 1] * 5,
          f"H2D copies of 5 bucket-8 calls: {h2d}")
    emit({"phase": "trace", "forwards": 5, "bucket": 8,
          "h2d_copies": len(h2d["bytes"]), "h2d_bytes": h2d["bytes"],
          "h2d_ms": h2d["ms"],
          "window_ms": round(window_ms, 3), "device_ms": round(device_ms, 3),
          "busy_share": round(device_ms / window_ms, 4) if window_ms else None,
          "graph_replay_ms": replay_ms,
          "busy_share_replays": round(5 * replay_ms / window_ms, 4),
          "window_ms_unprofiled": round(plain_window_ms, 3),
          "busy_share_unprofiled": round(device_ms / plain_window_ms, 4),
          "top_device_ms": [[k[:80], round(v, 4)] for k, v in top],
          "script_s": round(time.perf_counter() - t_start, 3)})

    phase_pool(qg)
    phase_audit()
    phase_coldstart(build_wall_s, {n: round(r["seconds"], 3)
                                   for n, r in built.items()})
    phase_examples()

    # -- summary: per forward at bucket 1 (and 8) of the path each kernel is on
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "call_ms")
    paged_fwd = {b: [s for pc in paged_calls.values() for s in pc[b]]
                 for b in (1, 8)}
    fwd = {"qmatmul": (calls, "person"), "qdwconv": (calls, "person"),
           "paged_qmatmul": (paged_fwd, "sine+speech+person (paged)"),
           "fmatmul": (float_calls, "speech float")}
    kernels = []
    for kname in ("qmatmul", "qdwconv", "paged_qmatmul", "fmatmul"):
        fcalls, model = fwd[kname]
        errs = [measured[s]["max_abs_err"] for b in fcalls for s in fcalls[b]
                if s[0] == kname]
        entry = {"name": kname, "route": "cuda",
                 "source": f"src/repro_torch/kernels/csrc/{kname}.cu",
                 "replaces": REPLACES[kname], "launches": launches[kname],
                 "max_abs_err": max(errs), "per_forward_of": model,
                 "bucket": 1}
        for key in keys:
            entry[key] = per_forward(fcalls, measured, 1, kname, key)
        by = [measured[s]["bound_by"] for s in fcalls[1] if s[0] == kname]
        entry["bound_by"] = max(set(by), key=by.count)
        entry["per_forward_bucket8"] = {
            key: per_forward(fcalls, measured, 8, kname, key) for key in keys}
        kernels.append(entry)
    kernels.append({"name": "probe", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/probe.cu",
                    "replaces": REPLACES["probe"],
                    "launches": launches["probe"],
                    "per_forward_of": "one launch per process",
                    **{k: probe[k] for k in ("max_abs_err", "ms", "plain_ms",
                                             "bound_ms", "bound_by",
                                             "library_ms", "call_ms")}})

    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--boot"]:
        sys.exit(boot_main(sys.argv[2:]))
    sys.exit(main())
