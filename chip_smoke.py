"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
(into ``build/repro_torch_kernels/``), then drives four paths of the port
at full width, with random weights from a seed, and the LLM serving and
training paths, which launch none of the kernels (their products are
PyTorch matmuls, as the reference's are XLA einsums), and the launch
layer's dry run and all-to-all MoE. An engine call is a
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
              / the fused conv (``qconv_fused``, conv0) at every (shape,
              clamp bound, n_true, border) of the person plan at buckets 1
              and 8 (``qdwconv`` on the unpadded input, its SAME border
              fused in; the fused conv on the lane-padded input, its border
              and taps gathered in the kernel); ``paged_qmatmul`` at every
              shape the paged engines launch plus the 256×256 FC at pages
              2/8/32 (int8 exact, two calls bit-identical); ``fmatmul`` at
              (8,16,8), (130,70,33) and the speech model's float FC as
              ``ops.fmatmul`` calls it, in float32 (1e-5) and bfloat16
              (5e-2), two calls bit-identical. Kernel, plain and library
              times and the bound; then the explicit cases, with ptxas'
              registers, shared memory and spills (a spill in any of the
              four redesigned kernels fails the run): ``fmatmul`` at
              128×4096×128 (float32, bfloat16), ``qmatmul`` at conv0's
              quantum-128 shape 18432×1152×128, ``qdwconv`` through its
              generic instantiation (5×5/s2, an asymmetric border) and at
              C = 8, ``paged_qmatmul`` at 8×4000 page 1 and 4×256 page 128,
              the fused conv where the benchmark runs it (speech's 10×8/s2
              conv at bucket 256, M 128,000; conv0 at bucket 32);
5. layers   — person's kernel route walked op by op through the registry,
              each op fed the kernel route's own previous output and held
              against the plain route of the same op on a CPU copy of the
              same input (exact; softmax ±1 LSB); no ``F.pad`` may run
              inside ``qdwconv_planned`` (the kernel fills the border);
6. serve    — the first main path, counted: person's ``predict_q`` at batch
              1 (the per-call graph: one ``"percall"`` capture holding 14
              ``qmatmul`` + 1 fused conv (conv0, ``qconv_fused``) + 13
              ``qdwconv`` calls; a second call launches
              nothing) and ``predict_q_many`` on batches 1, 3, 8
              (``max_batch=8``): each captured bucket's graph holds the
              same 28 calls, replays call none; every
              row held against the port's CPU plain route, and no border
              pad before a depthwise layer; per-call replay latency beside
              the eager per-call forward's; ``cost``: the per-call
              forward's and buckets 1, 4, 8's ``cost_analysis`` count
              (flops, bytes, transcendentals), which must equal the CPU
              plain route's, with its bound (int8 peak, HBM rate) and
              ``bound_by``; ``roofline_share``: each bucket's bound over
              the device time of its graph's replay;
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
              copies of the 5 calls: the engine's counters
              (``h2d_copies`` / ``h2d_bytes``) must read exactly one a
              call, of the logical rows (8 × 96 × 96 × 1 = 73,728 B); the
              profiler's trace must hold no copy of another size and no
              more copies than the counters (it drops an event now and
              then: how many it lost is printed, and does not fail);
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
14. examples — ``examples/torch_quickstart.py`` (its graph saved,
              reloaded and run bit-identically too),
              ``torch_person_detection.py``, ``torch_serve_tinyml.py 64``
              (and ``--chaos``), ``torch_serve_llm.py`` (60 train steps,
              then fp32 and int8 serving) and ``torch_train_sine.py`` (the
              sine MLP trained, its int8 engines bit-identical) on the
              card, each in its own process: exit 0 and their "✓" (or
              agreement) lines;
15. llm     — LLM serving (``repro_torch.models``, ``.serve.engine`` /
              ``.quantized``), in its own process (``chip_smoke.py
              --llm``), started before this process touches the card so
              that it has the card's memory to itself; its lines are
              printed here, after ``examples``. The free bytes before each
              config and the headroom left at its peak are printed. The
              ten architecture configs at their published
              widths, with random weights from a seed drawn on the card;
              stablelm-3b, starcoder2-3b, chatglm3-6b, mamba2-780m and
              whisper-small at full depth, the others cut to whole periods
              (``LLM_CONFIGS``). Each is drawn in float32 first: check 1,
              prefill plus 16 teacher-forced decode steps against
              ``forward`` at positions 15..31 (MoE under a capacity no
              token overflows), max |diff| <= 1e-3 x max |logit|; the
              cache tensors' ``data_ptr()``s unchanged (check 3); TF32 off
              (check 5). Then the same seed in the config's dtype: check
              1 there, within 5e-2 x max |logit| (in bfloat16, but for the
              configs of ``LLM_BF16_ROUTED_AFTER_INEXACT``, whose ratio is
              printed: an MoE there routes the output of a path that
              rounds otherwise in ``forward``, and a token that picks
              another expert moves its logits far, in the reference as
              well), prefill and decode step times (CUDA events, median
              of 5) beside the decode step's memory bound (the weights the
              step reads, with only the experts its tokens route to, and
              the cache; the bound with every expert slab, which the
              static-capacity dispatch reads, is printed beside it),
              ``ServeSession.generate`` of 4 prompts
              of 16 tokens for 16 new, ``max_memory_allocated``.
              stablelm-3b also in int8 weight-only at full depth (bytes
              under 0.45 of float; times, top-token agreement printed),
              and at depth 2 against the CPU (check 2: the same float32
              weights, prefill and 8 teacher-forced decode logits within
              1e-4 x max |logit|, greedy tokens equal where the CPU's
              top-2 margin exceeds 1e-3; check 4: ``quantize_params``
              bit-equal on both devices).
16. train   — training (``repro_torch.optim``, ``.train``, remat,
              ``.launch.train``), in its own process (``chip_smoke.py
              --train``), run after the ``llm`` process and before this
              process touches the card; its lines are printed after
              ``llm``. Gate 1: ``repro_torch.launch.train.main`` on
              stablelm-3b at full width and depth in float32, B = 8 × 64
              tokens (the launcher's defaults), 4 AdamW steps without remat
              and 4 with it: every loss and grad norm finite, the remat
              losses within 1e-5 of the plain ones. Measured: step ms (the
              gradient and the update apart), tokens a second, the bound
              (matmul FLOPs ÷ 67 TFLOP/s plus the optimizer's bytes ÷ 3.35
              TB/s), peak ``max_memory_allocated`` beside the state's bytes
              (params, grads, ``mu``, ``nu``), the busy share and kernels
              of a profiled step, without and with remat and in bfloat16
              (and one bfloat16 launcher run). Gate 2: stablelm-3b at depth
              2, full width: one step on the card against the same step on
              the CPU (loss within 1e-4, each gradient leaf within 1e-3 of
              its largest |g|, parameters within 1e-5 but where Adam's step
              can flip, 2·lr there). Gate 3: each ``reduced()`` config, the
              same. Gate 4: a depth-2 checkpoint (params and AdamW state)
              saved and restored on the card bit for bit, and mamba2
              resumed from step 2 against four straight steps.
17. launch  — the launch layer (``repro_torch.launch.{mesh,specs,
              sharding,dryrun}``, ``models/moe_a2a.py``), in its own
              process (``chip_smoke.py --launch``), run after the ``train``
              process and before this process touches the card; its lines
              are printed after ``train``. Gate 1, the dry run at full
              width: ``python -m repro_torch.launch.dryrun`` (meta DTensors
              over a fake process group, no card) for every config,
              ``train_4k`` on the single-pod mesh (16×16) and
              ``decode_32k`` on the multi-pod mesh (2×16×16) — the whole
              sweep of 80 records takes longer on a CPU than the phase may
              — and whisper-small × ``long_500k``, which must be skipped
              with the reference's reason; every other record ``ok``, its
              per-device argument bytes equal to the sum of its leaves'
              local shard bytes; the ``train_4k`` FLOPs a device of the
              dense attention configs (stablelm-3b, starcoder2-3b,
              internlm2-20b, chatglm3-6b) at most 1.25× the analytic count
              (``analytic_train_flops``); argument + temp bytes a device
              printed beside the card's ``total_memory``, collective bytes
              by kind, and the sweep's wall seconds. Gate 2, the dry run
              against the card: ``build_step`` and ``arg_shardings`` on a
              (1, 1) mesh for
              stablelm-3b, kind ``train``, B 8 × T 64; the same
              ``input_specs`` made on the card and the step run once: the
              dry run's argument bytes equal the bytes of the arguments on
              the card; the temp estimate printed beside
              ``max_memory_allocated`` minus the argument bytes (an
              observation). Gate 3, the all-to-all: four processes
              (``chip_smoke.py --a2a RANK DIR``) on the one card over gloo
              (NCCL refuses two ranks on one device; NCCL across four
              cards waits for a four-card machine), deepseek-v2-236b's MoE
              layer at its published widths (E 160, d 5120, moe_d_ff
              1536, top-k 6, 2 shared experts; 15.1 GB of float32 expert
              weights, 3.8 GB a rank, expert e drawn from a generator
              seeded by (seed, e)), B 2 × 16 tokens at capacity factor
              16, and kimi-k2's ``reduced()`` at capacity factor 16: y on
              every rank within 5e-5 × max |y| of ``apply_moe`` on the
              card over every expert drawn the same way; ``apply_moe``
              twice, and each rank's ``moe_all_to_all`` twice, the same
              bits (the combine sums each token's picks in one order); the
              elements that the ``index_add`` combine it replaced changes
              between two runs on the same expert outputs (atomics),
              the bytes each rank holds and the wall seconds printed (a
              gloo time, not an NVLink one). Gate 4, the dry run on the
              card's torch held to the reference's records, committed in
              ``tests/data/launch_ref.json`` (the card's torch is held to
              data, not to a live JAX; ``PYTHONPATH=src python
              tests/_torch_launch_data.py --full`` writes it from
              ``src/repro`` on a machine with JAX, ~10 minutes, and
              ``tests/test_torch_launch_parity.py`` / ``_cache.py`` hold
              its records equal to the live reference's), with the bounds
              of ``tests/_torch_launch_data.py`` (``parity``,
              ``full_parity``), which the parity tests share: one process
              (``chip_smoke.py --launch-ref OUT``, on the CPU, beside gate
              1's) dry-runs its 30 reduced records (every ``reduced()`` config
              × train / prefill / decode, (2, 4), seq 32 × batch 8), its
              11 sequence-sharded-cache decode records (the cache policy
              patched so that the cache shards its sequence over
              ``model``, seq 128, a sliding window once) and the 30
              reduced records again in float32; each within: FLOPs a
              device 0.99–1.07 of the reference's dot FLOPs (≤ 1.01
              dense) and ≤ 1.25 of its whole count, collective bytes ≤
              2.0× (dense) / 2.5×, argument bytes equal but what
              ``jax.jit`` drops; a float32 record's ``bytes_per_device``
              at least 0.9 of XLA's bytes accessed less its layout ops
              (``tests/_torch_hlo.py``; in bfloat16 XLA on the CPU widens
              every activation to float32, so those ratios are printed
              only). At full size, gate 1's records against the
              reference's depth-corrected ones: deepseek-v2 and kimi-k2
              ``train_4k`` FLOPs a device 0.99–1.07 of the reference's dot
              FLOPs with its dots that carry the whole global batch
              counted once over the data axes, those dots attention score
              and value products (by einsum, or by the score tensor's
              size where XLA named none), and the raw ratio within 3% of
              its pinned 0.4720 / 0.7617; stablelm-3b ``decode_32k``
              (2×16×16) collective bytes ≤ 2.0× the reference's. Every
              ratio is printed before the gate fails. Gate 5, the hash
              seed: two processes on the CPU, beside gate 1's, dry-run the
              five MoE records of ``_torch_launch_data.HASHSEED_RECORDS``
              (reduced, (2, 4), seq 32 × batch 8) under
              ``PYTHONHASHSEED`` 0 and 7; their FLOPs, bytes, collectives
              by kind and memory must equal each other's and gate 4's
              records of the same five (made under no pinned seed).
              ``python chip_smoke.py --launch`` runs the phase alone.
18. graph   — graph files (``repro_torch.core.graph.save`` / ``load``,
              no msgpack), counted: sine, speech and person quantized on
              the card, each saved, loaded back (``msgpack`` never
              imported) and run on the kernel route at buckets 1 and 8
              beside the original graph's engine: rows bit-equal (±1 LSB
              on a softmax output only); the JAX package's quantized sine
              file (``tests/data/sine_int8.mfg``) loaded and run on the
              kernel route, its rows equal to the CPU plain route's; each
              file's bytes and sha256. Then the sine example's path
              (``examples/torch_train_sine.py``'s ``sine_metrics``:
              4000 AdamW steps on the card, the Table 5 protocol), counted:
              every MSE <= 0.006, the int8 interpreter and the compiled
              engine (``qmatmul``) bit-identical.

Each phase prints one JSON line (the ``kernels`` phase lists every call it
timed, ``explicit`` the nine explicit cases, ``llm`` one line a config
and one for checks 2 and 4 before its own, ``train`` and ``launch`` one
line a gate (and ``train`` one for the measurements) before their own);
then the ``kernels``
summary line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failure raises, and the script exits
non-zero without the last line.
"""
from __future__ import annotations

import dataclasses
import gc
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
H2D_ROWS_B8 = 8 * 96 * 96 * 1   # person's logical rows, one bucket-8 call
INT8_OPS_PER_S = 1.979e15   # H100 SXM dense int8 tensor-core peak
FLOPS_PER_S = {"float32": 67e12,     # H100 SXM float32, CUDA cores
               "bfloat16": 989e12}   # H100 SXM dense bf16 tensor-core peak
LAUNCHES_PER_FORWARD = {"qmatmul": 14, "qmatmul_conv": 1, "qdwconv": 13}
REPLACES = {"qmatmul": "src/repro/kernels/qmatmul.py:66",
            "qmatmul_conv": "src/repro/kernels/qconv.py:57",
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
# the fused conv at the buckets the benchmark runs it: speech's 10x8/s2 conv
# at 256 (speech.bulk's chunk) and person's conv0 at 32 (person.flood and
# person.bulk): model -> bucket
CONV_EXPLICIT = {"speech": 256, "person": 32}
# the serving stack: three paper models behind build_paper_registry, kernel
# calls each bucket's graph holds per model, clients and requests
SERVING_LAUNCHES = {"sine": {"qmatmul": 3},
                    "speech": {"qmatmul": 1, "qmatmul_conv": 1},
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
    (stride, pads, z_x); a ``qmatmul_conv`` (``qconv_fused``) one's w shape
    is the packed weight's (N, KP), its lanes field n_true and its last
    field (kh, kw, stride, pads, c_true, z_x)."""

    def __enter__(self):
        from repro_torch.kernels import paged_matmul as pm_mod
        from repro_torch.kernels import qdwconv as dw_mod
        from repro_torch.kernels import qmatmul as mm_mod
        self.mods = (mm_mod, dw_mod, pm_mod)
        current = []
        orig = self.orig = (mm_mod.qmatmul, dw_mod.qdwconv,
                            pm_mod.paged_qmatmul, mm_mod.fmatmul,
                            mm_mod.qconv_fused)

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

        def cf(x, w, *consts, kh, kw, stride, pads, c_true, z_x,
               lo=float("-inf"), hi=float("inf"), n_true=None):
            current.append(("qmatmul_conv", tuple(x.shape), tuple(w.shape),
                            lo, hi, n_true,
                            (kh, kw, tuple(stride), tuple(pads), c_true,
                             int(z_x))))
            return orig[4](x, w, *consts, kh=kh, kw=kw, stride=stride,
                           pads=pads, c_true=c_true, z_x=z_x, lo=lo, hi=hi,
                           n_true=n_true)

        mm_mod.qmatmul, dw_mod.qdwconv, pm_mod.paged_qmatmul = mm, dw, pm
        mm_mod.fmatmul, mm_mod.qconv_fused = fm, cf
        return current

    def __exit__(self, *exc):
        mm_mod, dw_mod, pm_mod = self.mods
        (mm_mod.qmatmul, dw_mod.qdwconv, pm_mod.paged_qmatmul,
         mm_mod.fmatmul, mm_mod.qconv_fused) = self.orig
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
    if kind == "qmatmul_conv":
        # the bytes the function needs: the c_true real lanes of the input
        # (not its padding lanes), the packed weight, the output; products
        # over the real taps
        b, h, w, _ = xs
        n, kp = ws
        kh, kw, _, _, c_true, _ = geo
        oh, ow = conv_out_hw(xs, geo)
        m = b * oh * ow
        return (b * h * w * c_true + n * kp + 5 * 4 * n + m * n,
                2 * m * kh * kw * c_true * n, INT8_OPS_PER_S)
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


def conv_out_hw(xs, geo) -> tuple:
    """(OH, OW) of a ``qmatmul_conv`` call: its input, filter, stride and
    pads."""
    kh, kw, (sh, sw), (pt, pb, pl, pr), _, _ = geo
    return (xs[1] + pt + pb - kh) // sh + 1, (xs[2] + pl + pr - kw) // sw + 1


def bound_ms(sig) -> tuple:
    nbytes, ops, peak = work(sig)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def forward_bound(cost: dict) -> dict:
    """A forward's count (``cost_analysis()``'s keys) and its bound: the
    larger of its products over the int8 tensor-core peak and its bytes
    over the memory rate, the peaks ``work()`` uses."""
    t_bytes = cost["bytes accessed"] / HBM_BYTES_PER_S * 1e3
    t_ops = cost["flops"] / INT8_OPS_PER_S * 1e3
    return {"flops": cost["flops"], "bytes": cost["bytes accessed"],
            "transcendentals": cost["transcendentals"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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

    n = ws[0] if kind in ("qmatmul", "qmatmul_conv") else ws[-1]
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


def library_qconv(x, w_packed, consts, lo, hi, n_true, geo):
    """Yardstick only: the border pad of the real lanes, a cuDNN float32
    convolution without TF32 (exact here: every sum is an integer below
    2**24) + requant in torch. ``w_packed`` is (N, KP), its taps
    tap-major and channel-minor."""
    bias, resc, wsum, coff, zw = consts
    kh, kw, stride, (pt, pb, pl, pr), c_true, z_x = geo
    n, k = w_packed.shape[0], kh * kw * c_true
    xf = F.pad(x[..., :c_true], (0, 0, pl, pr, pt, pb),
               value=z_x).permute(0, 3, 1, 2).float()
    wf = w_packed[:, :k].reshape(n, kh, kw, c_true).permute(0, 3, 1, 2)
    wf = wf.float()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        acc = F.conv2d(xf, wf, stride=stride)
        sx = F.conv2d(xf, torch.ones_like(wf[:1]), stride=stride)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    inner = (acc.to(torch.int32).permute(0, 2, 3, 1)
             - zw * sx.to(torch.int32).permute(0, 2, 3, 1) - wsum + coff)
    y = torch.addcmul(bias, resc, inner.float())
    q = y.clamp(lo, hi).round().clamp(-128, 127).to(torch.int8)
    if n_true is not None:
        q[..., n_true:] = 0
    return q


def phase_kernels(sigs):
    """Each distinct kernel call against its plain version, then timed."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_matmul import paged_qmatmul
    from repro_torch.kernels.qdwconv import qdwconv
    from repro_torch.kernels.qmatmul import fmatmul, qconv_fused, qmatmul

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
        elif kind == "qmatmul_conv":
            kh, kw, stride, pads, c_true, z_x = geo
            x[..., c_true:] = 0         # a planned producer's padding lanes
            w[:, kh * kw * c_true:] = 0  # the packed K's zero tail
            conv_kw = dict(kh=kh, kw=kw, stride=stride, pads=pads,
                           c_true=c_true, z_x=z_x, lo=lo, hi=hi,
                           n_true=lanes)

            def kern():
                return qconv_fused(x, w, *consts, **conv_kw)

            def plain():
                return ref.qconv_fused_ref(x, w, *consts, **conv_kw)

            def lib():
                return library_qconv(x, w, consts, lo_t, hi_t, lanes, geo)
            lib_label = "cudnn_f32"
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
    mm_mod.fmatmul_launches = mm_mod.conv_launches = kops.probe_launches = 0


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
        elif kind == "qmatmul_conv":
            kh, kw, stride, pads, c_true, z_x = sig[6]
            oh, ow = conv_out_hw(xs, sig[6])
            bk = mm_mod.stage_bytes(ws[1])
            config = {"filter": [kh, kw], "stride": list(stride),
                      "pads": list(pads), "c_true": c_true, "z_x": z_x,
                      "slab_bytes": bk}
            mkn = [xs[0] * oh * ow, ws[1], ws[0]]
            tags = [f"qmatmul_kernel_convILi{bk}E"]
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
            "ptxas": {fn: rep for fn, rep in reports[
                {"qmatmul_conv": "qmatmul"}.get(kind, kind)].items()
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
    # (qmatmul, qdwconv, fused conv) a forward beside the paged FC
    per_fwd_q = {"sine": (1, 0, 0), "speech": (0, 0, 1),
                 "person": (13, 13, 1)}
    report = {}
    for name, (g, xs) in models.items():
        shape, paged, paged_per_fwd, fc_op = PAGED[name]
        c = per_model[name]
        check(c["paged_qmatmul"] == paged_per_fwd * n_fwd,
              f"{name}: paged_qmatmul launches {c['paged_qmatmul']} for "
              f"{n_fwd} forwards, expected {paged_per_fwd} per forward")
        check((c["qmatmul"], c["qdwconv"], c["qmatmul_conv"]) == tuple(
            v * n_fwd for v in per_fwd_q[name]),
            f"{name}: unpaged launches {c}")
        check(len(percall_launches(engines[name])) == 1,
              f"{name}: per-call captures {engines[name].compile_log}")
        for e in engines[name].compile_log:
            gc = e["launches"]
            check((gc["paged_qmatmul"], gc["qmatmul"], gc["qdwconv"],
                   gc["qmatmul_conv"])
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

def device_ms_by_kernel(prof) -> tuple:
    """Device ms by kernel name in a profile, and the launches counted."""
    by_kernel, launches = {}, 0
    for evt in prof.key_averages():
        dt = getattr(evt, "device_time_total", None)
        if dt is None:
            dt = getattr(evt, "cuda_time_total", 0)
        if dt and getattr(evt, "device_type", None) is not None \
                and "CUDA" in str(evt.device_type):
            by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + dt / 1e3
            launches += evt.count
    return by_kernel, launches


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
# the kernels those libraries launch (the fused conv is in qmatmul's)
COLDSTART_KERNELS = COLDSTART_LIBRARIES | {"qmatmul_conv"}


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
              == COLDSTART_KERNELS, f"{label} boot launches: "
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
                ("torch_serve_tinyml.py", "64", "--chaos"),
                ("torch_serve_llm.py",), ("torch_train_sine.py",))
EXAMPLE_MARKS = {
    "torch_quickstart.py": ("engines agree bit-exactly ✓",
                            "saved and reloaded graph runs bit-identically ✓"),
    "torch_person_detection.py": ("engines agree ✓",),
    "torch_serve_tinyml.py":
        ("served rows are bit-identical to direct predict_q ✓",),
    "torch_serve_llm.py": ("int8 vs fp32 token agreement: ",),
    "torch_train_sine.py": ("int8 engines bit-identical: True",)}


def phase_examples() -> None:
    """The ``examples/torch_*.py`` CLIs on the card, each in its own
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
        for mark in EXAMPLE_MARKS[args[0]]:
            check(any(mark in ln for ln in lines),
                  f"{' '.join(args)} did not print {mark!r}")
        keep = [ln.strip() for ln in lines
                if "✓" in ln or "median" in ln or "served (" in ln
                or "resilience" in ln or "train step" in ln
                or "tok/s" in ln or "agreement" in ln
                or ln.startswith(("float ", "int8", "predict sin"))]
        runs.append({"args": list(args), "rc": proc.returncode,
                     "wall_s": round(time.perf_counter() - t0, 3),
                     "lines": keep})
    emit({"phase": "examples", "runs": runs})


# ---------------------------------------------------------------------------
# LLM serving
# ---------------------------------------------------------------------------

# (config, depth on the card or None for its full depth, dtype): published
# widths; depth is cut, in whole periods, only where the weights would not
# fit one card
LLM_CONFIGS = (("stablelm-3b", None, "float32"),
               ("starcoder2-3b", None, "float32"),
               ("chatglm3-6b", None, "bfloat16"),
               ("mamba2-780m", None, "float32"),
               ("whisper-small", None, "float32"),
               ("internlm2-20b", 4, "bfloat16"),
               ("internvl2-26b", 4, "bfloat16"),
               ("deepseek-v2-236b", 1, "bfloat16"),
               ("jamba-v0.1-52b", 8, "bfloat16"),
               ("kimi-k2-1t-a32b", 1, "bfloat16"))
LLM_BATCH, LLM_PROMPT, LLM_NEW, LLM_MAX_SEQ = 4, 16, 16, 64
LLM_TOL = {"float32": 1e-3, "bfloat16": 5e-2}   # check 1, × max |logit|
LLM_CPU_TOL, LLM_MARGIN, LLM_CPU_STEPS = 1e-4, 1e-3, 8   # check 2
# bfloat16 configs whose MoE routes the output of a path that rounds
# otherwise at decode than in ``forward`` (MLA absorbed against expanded,
# SSD recurrent against chunked): a token can pick another expert and its
# logits move far. The reference's own ratio leaves the bound there, and
# keeps to it once the MoE is taken out (tests/test_torch_llm_bf16.py).
# Their bfloat16 ratio is printed; float32 holds them to its bound.
LLM_BF16_ROUTED_AFTER_INEXACT = ("deepseek-v2-236b", "jamba-v0.1-52b")


def no_drop(cfg):
    """``cfg`` with a capacity no token overflows: C = n(1 + k/E) >= n, and
    an expert gets at most one assignment a token. Forward, prefill and
    decode route n = 128, 64 and 4 tokens, so under the published
    capacity they drop different assignments; check 1 compares the cache
    path, not the drops."""
    if not cfg.n_experts:
        return cfg
    return dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.top_k + 1.0)


def cache_bytes(cache) -> int:
    from repro_torch.models.layers import tree_map
    total = []
    tree_map(lambda t: total.append(t.numel() * t.element_size()), cache)
    return sum(total)


def cache_ptrs(cache) -> list:
    from repro_torch.models.layers import tree_map
    out = []
    tree_map(lambda t: out.append(t.data_ptr()), cache)
    return out


class routed_experts:
    """Within ``with routed_experts() as r:``, each MoE call adds the bytes
    of its expert slabs to ``r["all"]``, and those of the distinct experts
    its tokens route to (their top-k picks) to ``r["routed"]``."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.orig = moe, moe._route_and_compute
        r, orig = {"all": 0, "routed": 0}, self.orig

        def counted(cfg, p, xf, C):
            probs = torch.softmax(xf.float() @ p["router"].float(), -1)
            used = torch.topk(probs, cfg.top_k, -1).indices.unique().numel()
            slab = sum(p[k].numel() * p[k].element_size()
                       for k in ("w_gate", "w_up", "w_down"))
            r["all"] += slab
            r["routed"] += slab * used // cfg.n_experts
            return orig(cfg, p, xf, C)

        moe._route_and_compute = counted
        return r

    def __exit__(self, *exc):
        self.moe._route_and_compute = self.orig
        return False


def decode_weight_bytes(cfg, named, B, max_seq) -> int:
    """The weight bytes a decode step of ``B`` tokens reads, from ``named``
    (parameter name -> tensor or QuantizedTensor): the decoder stack, the
    final norm and the head, ``B`` rows of the embedding and one of the
    learned positions. The encoder and the projector run only in
    prefill."""
    from repro_torch.serve.quantized import param_bytes
    rows = {"embed": B / cfg.vocab_size, "dec_pos": 1 / max_seq}
    total = 0
    for name, t in named.items():
        head = name.split(".")[0]
        if head in ("layers", "final_norm", "lm_head"):
            total += param_bytes(t)
        elif head in rows:
            total += int(param_bytes(t) * rows[head])
    return total


def teacher_forced(run, batch, tokens, cache, n_prefix, steps):
    """Prefill on ``batch`` then ``steps`` decode steps fed ``tokens[:, i]``;
    the last-position logits of each, (steps + 1, B, V) float32 on the
    host."""
    logits, _ = run("prefill", batch, cache)
    out = [logits[:, -1].float().cpu()]
    Tp = batch["tokens"].shape[1]
    for i in range(steps):
        logits, _ = run("decode_step", tokens[:, i:i + 1], cache,
                        Tp + n_prefix + i)
        out.append(logits[:, -1].float().cpu())
    return torch.stack(out)


def decode_profile(fn, calls: int = 3) -> dict:
    """torch.profiler over ``calls`` decode steps: host window and device
    time a step, the device's busy share, kernels a step, the top five."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3 / calls
    by_kernel, launches = device_ms_by_kernel(prof)
    device_ms = sum(by_kernel.values()) / calls
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
    return {"window_ms": window_ms, "device_ms": device_ms,
            "busy_share": device_ms / window_ms if window_ms else None,
            "kernels": launches / calls,
            "top_device_ms": [[k[:60], v / calls] for k, v in top]}


def check1(cfg, model, tokens, extra, dtype, max_seq) -> tuple:
    """Prefill + teacher-forced decode at positions 15..31 against
    ``forward`` of each prompt (under :func:`no_drop`, so a token's output
    does not depend on the others'): max |diff| / max |logit| and the
    share of positions with the same top token; the cache written in place
    (check 3)."""
    from repro_torch.models import model as M
    c1 = no_drop(cfg)
    Tp = LLM_PROMPT
    n_prefix = cfg.n_patches if cfg.modality == "vision" else 0
    with torch.no_grad():  # one prompt at a time: the activations' peak
        full = torch.cat([M.forward(c1, model, {
            "tokens": tokens[b:b + 1],
            **{k: v[b:b + 1] for k, v in extra.items()}})[0][:, Tp - 1:]
            .float().cpu() for b in range(LLM_BATCH)]).transpose(0, 1)
        cache = M.init_cache(cfg, LLM_BATCH, max_seq, dtype, "cuda")
        ptrs = cache_ptrs(cache)
        steps = teacher_forced(
            lambda op, *a: getattr(M, op)(c1, model, *a),
            {"tokens": tokens[:, :Tp], **extra}, tokens[:, Tp:], cache,
            n_prefix, LLM_NEW)
    check(bool(torch.isfinite(full).all()) and
          bool(torch.isfinite(steps).all()), f"{cfg.name}: non-finite logits")
    check(cache_ptrs(cache) == ptrs, f"{cfg.name}: the cache moved")
    ratio = float((steps - full).abs().max()) / float(full.abs().max())
    return ratio, float((steps.argmax(-1) == full.argmax(-1)).float().mean())


def llm_config(arch, depth, dtype_name, rng) -> dict:
    """One config on the card: check 1 (hard) in float32 on float32
    weights, then the same seed's weights in the table's dtype: check 1's
    ratio there, times, ``generate``, memory (checks 3 and 5 throughout)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import frontend_stub
    from repro_torch.launch.serve import cut_depth
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeSession
    from repro_torch.serve.quantized import param_bytes

    cfg = get_config(arch)
    cfg = cut_depth(cfg, depth) if depth else cfg
    dtype = getattr(torch, dtype_name)
    n_prefix = cfg.n_patches if cfg.modality == "vision" else 0
    max_seq = LLM_MAX_SEQ + n_prefix
    B, Tp, n = LLM_BATCH, LLM_PROMPT, LLM_NEW
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, Tp + n)),
                             dtype=torch.int32, device="cuda")
    extra = {k: torch.as_tensor(v, device="cuda")
             for k, v in frontend_stub(cfg, B, rng).items()}
    check(not torch.backends.cuda.matmul.allow_tf32,
          f"{arch}: TF32 is on for float32 matmuls")
    row = {"phase": "llm_config", "arch": arch, "depth": cfg.n_layers,
           "full_depth": get_config(arch).n_layers, "dtype": dtype_name,
           "param_count": cfg.param_count()}

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    free, total = torch.cuda.mem_get_info()
    row.update(free_bytes_at_start=free, card_bytes=total)
    model = M.init_params(cfg, SEED, torch.float32, max_seq=max_seq,
                          device="cuda")
    ratio, top1 = check1(cfg, model, tokens, extra, torch.float32, max_seq)
    check(ratio <= LLM_TOL["float32"],
          f"{arch}: float32 prefill+decode vs forward {ratio:.3g} > "
          f"{LLM_TOL['float32']} x max |logit|")
    peak = torch.cuda.max_memory_reserved()
    row.update(check1_ratio=ratio, check1_tol=LLM_TOL["float32"],
               check1_top1_agree=top1,
               float32_max_memory_allocated=torch.cuda.max_memory_allocated())
    if dtype != torch.float32:  # the same seed drawn in the served dtype
        del model
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = M.init_params(cfg, SEED, dtype, max_seq=max_seq,
                              device="cuda")
        ratio, top1 = check1(cfg, model, tokens, extra, dtype, max_seq)
        gated = arch not in LLM_BF16_ROUTED_AFTER_INEXACT
        if gated:
            check(ratio <= LLM_TOL[dtype_name],
                  f"{arch}: {dtype_name} prefill+decode vs forward "
                  f"{ratio:.3g} > {LLM_TOL[dtype_name]} x max |logit|")
        row.update(served_check1_ratio=ratio, served_check1_gated=gated,
                   served_check1_tol=LLM_TOL[dtype_name],
                   served_check1_top1_agree=top1)
    weight_bytes = param_bytes(model.tree())

    # times (the published config), CUDA events, median of 5
    with torch.no_grad():
        cache = M.init_cache(cfg, B, max_seq, dtype, "cuda")
        batch = {"tokens": tokens[:, :Tp], **extra}
        prefill_ms = cuda_ms(lambda: M.prefill(cfg, model, batch, cache),
                             reps=5, inner=1)
        tok = tokens[:, Tp:Tp + 1]
        decode_ms = cuda_ms(lambda: M.decode_step(cfg, model, tok, cache,
                                                  Tp + n_prefix),
                            reps=5, inner=1)
        profile_row = decode_profile(lambda: M.decode_step(
            cfg, model, tok, cache, Tp + n_prefix))
        with routed_experts() as moe_bytes:  # one step, for its bound
            M.decode_step(cfg, model, tok, cache, Tp + n_prefix)
        sess = ServeSession(cfg, model, max_seq=max_seq, dtype=dtype,
                            device="cuda")
        t0 = time.perf_counter()
        out = sess.generate(tokens[:, :Tp].cpu().numpy(), n,
                            extra_inputs=extra or None)
        gen_s = time.perf_counter() - t0
    check(out.shape == (B, n) and out.dtype == np.int32
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          f"{arch}: generate gave {out.shape} {out.dtype}")
    check(not torch.backends.cuda.matmul.allow_tf32,
          f"{arch}: TF32 turned on")
    kv = cache_bytes(cache)
    read = decode_weight_bytes(cfg, dict(model.named_parameters()), B,
                               max_seq)
    need = read - moe_bytes["all"] + moe_bytes["routed"]
    peak = max(peak, torch.cuda.max_memory_reserved())
    row.update(weight_bytes=weight_bytes, cache_bytes=kv,
               decode_weight_bytes=need,
               decode_expert_bytes={"all": moe_bytes["all"],
                                    "routed": moe_bytes["routed"]},
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               max_memory_reserved=peak, headroom_bytes=free - peak,
               prefill_ms=prefill_ms, decode_ms=decode_ms,
               decode_bound_ms=(need + kv) / HBM_BYTES_PER_S * 1e3,
               decode_bound_all_experts_ms=(read + kv) / HBM_BYTES_PER_S
               * 1e3,
               generate_s=round(gen_s, 4), tokens_per_s=B * n / gen_s,
               decode_profile=profile_row,
               cache_in_place=True,
               tf32=torch.backends.cuda.matmul.allow_tf32)
    if arch == "stablelm-3b":
        row["int8"] = llm_int8(cfg, model, tokens, out, weight_bytes)
    del model, sess, cache
    gc.collect()
    torch.cuda.empty_cache()
    return row


def llm_int8(cfg, model, tokens, float_out, float_bytes) -> dict:
    """Check 4 at full depth: int8 weight-only stablelm-3b (bytes; times
    and top-token agreement with float are observations)."""
    from torch.func import functional_call
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeSession
    from repro_torch.serve.quantized import dequantize_params, param_bytes
    Tp, n = LLM_PROMPT, LLM_NEW
    sess = ServeSession(cfg, model, max_seq=LLM_MAX_SEQ, quantized=True,
                        device="cuda")
    q_bytes = param_bytes(sess.params)
    check(q_bytes < 0.45 * float_bytes,
          f"int8 weights {q_bytes} B >= 0.45 x {float_bytes} B")
    with torch.no_grad():
        lf, _ = M.forward(cfg, model, {"tokens": tokens})
        lq, _ = functional_call(sess.model, dequantize_params(sess.params),
                                ("forward", {"tokens": tokens}))
        cache = sess.init_cache(LLM_BATCH)
        batch = {"tokens": tokens[:, :Tp]}
        prefill_ms = cuda_ms(lambda: sess.run("prefill", batch, cache),
                             reps=5, inner=1)
        tok = tokens[:, Tp:Tp + 1]
        decode_ms = cuda_ms(lambda: sess.run("decode_step", tok, cache, Tp),
                            reps=5, inner=1)
        out = sess.generate(tokens[:, :Tp].cpu().numpy(), n)
    kv = cache_bytes(cache)
    read = decode_weight_bytes(cfg, sess.params, LLM_BATCH, LLM_MAX_SEQ)
    return {"weight_bytes": q_bytes, "bytes_ratio": q_bytes / float_bytes,
            "forward_top1_agree": float((lf.argmax(-1) == lq.argmax(-1))
                                        .float().mean()),
            "generate_agree": float((out == float_out).mean()),
            "prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "decode_weight_bytes": read,
            "decode_bound_ms": (read + kv) / HBM_BYTES_PER_S * 1e3}


def llm_card_vs_cpu() -> dict:
    """Checks 2 and 4 at depth 2: stablelm-3b at published widths, the same
    float32 weights on the CPU and on the card; prefill and eight
    teacher-forced decode steps fed the CPU's greedy tokens;
    ``quantize_params`` on both devices, bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import cut_depth
    from repro_torch.models import model as M
    from repro_torch.models.layers import tree_map
    from repro_torch.serve.quantized import QuantizedTensor, quantize_params
    cfg = cut_depth(get_config("stablelm-3b"), 2)
    cpu = M.init_params(cfg, SEED, torch.float32, max_seq=LLM_MAX_SEQ,
                        device="cpu")
    card = M.Model(cfg, tree_map(lambda t: t.detach().to("cuda"), cpu.tree()))
    rng = np.random.default_rng(SEED + 5)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                           (LLM_BATCH, LLM_PROMPT)),
                              dtype=torch.int32)
    with torch.no_grad():
        cache = M.init_cache(cfg, LLM_BATCH, LLM_MAX_SEQ, torch.float32,
                             "cpu")
        want = [cpu("prefill", {"tokens": prompts}, cache)[0][:, -1]]
        greedy = []
        for i in range(LLM_CPU_STEPS):   # the CPU's greedy tokens
            greedy.append(want[-1].argmax(-1))
            want.append(cpu("decode_step", greedy[-1][:, None], cache,
                            LLM_PROMPT + i)[0][:, -1])
        want = torch.stack(want)
        forced = torch.stack(greedy, 1).to(torch.int32)
        got = teacher_forced(
            card, {"tokens": prompts.to("cuda")}, forced.to("cuda"),
            M.init_cache(cfg, LLM_BATCH, LLM_MAX_SEQ, torch.float32, "cuda"),
            0, LLM_CPU_STEPS)
    ratio = float((got - want).abs().max()) / float(want.abs().max())
    check(ratio <= LLM_CPU_TOL, f"card vs CPU: {ratio:.3g} > {LLM_CPU_TOL}")
    top2 = want.topk(2, -1).values
    sure = (top2[..., 0] - top2[..., 1]) > LLM_MARGIN
    check(torch.equal(got.argmax(-1)[sure], want.argmax(-1)[sure]),
          "card vs CPU: a greedy token differs where the margin is sure")
    leaves = {"cpu": [], "card": []}
    tree_map(leaves["cpu"].append, quantize_params(cpu.tree()))
    tree_map(leaves["card"].append, quantize_params(card.tree()))
    n_q = 0
    for a, b in zip(leaves["cpu"], leaves["card"]):
        if isinstance(a, QuantizedTensor):
            n_q += 1
            check(torch.equal(a.q, b.q.cpu())
                  and torch.equal(a.scale, b.scale.cpu()),
                  "quantize_params differs between the CPU and the card")
    check(len(leaves["cpu"]) == len(leaves["card"]) and n_q > 0,
          "no quantized leaf compared")
    return {"check2_ratio": ratio, "check2_tol": LLM_CPU_TOL,
            "check2_sure_steps": int(sure.sum()),
            "check2_steps": int(sure.numel()),
            "int8_leaves_equal_cpu": n_q}


def llm_main() -> int:
    """The ``llm`` phase's own process (``chip_smoke.py --llm``): every
    config of :data:`LLM_CONFIGS`, then checks 2 and 4 at depth 2; one
    JSON line each."""
    if not torch.cuda.is_available():
        print("chip_smoke --llm: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    rng = np.random.default_rng(SEED + 4)
    for arch, depth, dtype in LLM_CONFIGS:
        emit(llm_config(arch, depth, dtype, rng))
    emit({"phase": "llm_card_vs_cpu", **llm_card_vs_cpu()})
    return 0


def run_llm() -> tuple:
    """The ``llm`` phase's process (see the module docstring, 15), run to
    its end before this process touches the card, so that the largest
    configs have the card's memory to themselves: (its stdout lines,
    seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--llm"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                 PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"),
        capture_output=True, text=True, timeout=900)
    check(proc.returncode == 0, f"llm: rc {proc.returncode}: "
                                f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    return proc.stdout.splitlines(), time.perf_counter() - t0


def phase_llm(lines, process_s) -> None:
    """The lines of :func:`run_llm`'s process, and the phase's summary."""
    rows = [json.loads(ln) for ln in lines if ln.startswith("{")]
    configs = [r for r in rows if r.get("phase") == "llm_config"]
    check([r["arch"] for r in configs] == [c[0] for c in LLM_CONFIGS],
          f"llm: configs run {[r['arch'] for r in configs]}")
    for r in rows:
        emit(r)
    card_cpu = next(r for r in rows if r.get("phase") == "llm_card_vs_cpu")
    gated = [r for r in configs if r.get("served_check1_gated")]
    emit({"phase": "llm", "configs": len(configs),
          "check1_worst": max(r["check1_ratio"] for r in configs),
          "bf16_check1_worst_gated": max(r["served_check1_ratio"]
                                         for r in gated),
          "bf16_gated": [r["arch"] for r in gated],
          "check2_ratio": card_cpu["check2_ratio"],
          "int8_bytes_ratio": configs[0]["int8"]["bytes_ratio"],
          "least_headroom_bytes": min(r["headroom_bytes"] for r in configs),
          "process_s": round(process_s, 3)})


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

TRAIN_ARCH, TRAIN_STEPS = "stablelm-3b", 4
TRAIN_B, TRAIN_T = 8, 64            # the launcher's defaults
TRAIN_REMAT_TOL = 1e-5              # gate 1: remat losses against plain
# gates 2 and 3, the CPU tests' tolerances: the loss; each gradient leaf
# against its largest |g|; parameters after the update within PARAM_TOL
# (plus PARAM_TOL of the value) beyond what the two devices' gradients
# themselves move Adam's first step by (:func:`adam_direction`; up to 2·lr
# where the step's sign is not fixed by the gradients' agreement)
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_PARAM_TOL = 1e-4, 1e-3, 1e-5
TRAIN_CPU_B, TRAIN_CPU_T = 2, 64    # gate 2's batch (the CPU takes it too)
TRAIN_LR = 3e-3
TRAIN_MEASURE_STEPS = 3


def run_launcher(argv) -> dict:
    """``repro_torch.launch.train.main(argv)`` on the card: its losses, the
    grad norms of its log lines (``--log-every 1``), wall seconds and the
    peak allocated bytes."""
    import contextlib
    import io
    from repro_torch.launch import train
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        losses = train.main(list(argv) + ["--log-every", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    gnorms = [float(ln.split("gnorm ")[1].split()[0]) for ln in lines
              if ln.startswith("[train] step")]
    check(len(losses) == len(gnorms) == TRAIN_STEPS,
          f"launcher {argv}: {len(losses)} losses, {len(gnorms)} log lines")
    check(all(math.isfinite(x) for x in losses + gnorms),
          f"launcher {argv}: losses {losses}, grad norms {gnorms}")
    return {"argv": list(argv), "losses": losses, "grad_norms": gnorms,
            "wall_s": round(wall, 3), "lines": lines,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def train_batch(cfg, B, T, step, seed=SEED):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, frontend_stub
    batch = SyntheticLM(DataConfig(cfg.vocab_size, T, B, seed=seed)).batch(step)
    batch.update(frontend_stub(cfg, B, np.random.default_rng(seed + step)))
    return batch


def train_work(cfg, model, B, T, remat) -> dict:
    """What a step of ``model`` must do: matmul FLOPs (forward 2 per weight
    and token in every stacked matrix and the head, plus QK^T and PV over
    the T x T scores; backward twice the forward; remat one forward more),
    the optimizer's bytes (params, moments read and written, the gradients
    read twice: once for the global norm), the state's bytes."""
    from repro_torch.models.layers import tree_leaves
    tree = model.tree()
    mm = sum(t.numel() for t in tree_leaves(tree["layers"]) if t.dim() >= 3)
    mm += tree["lm_head"].numel()
    n = sum(t.numel() for t in tree_leaves(tree))
    size = tree["lm_head"].element_size()
    attn = 4 * B * T * T * cfg.n_heads * cfg.head_dim * cfg.n_layers
    fwd = 2 * B * T * mm + attn
    flops = fwd * (4 if remat else 3)
    opt_bytes = n * (2 * size + 2 * size + 4 * 4)  # p r/w, g twice, mu nu r/w
    state = n * (2 * size + 8)                      # p, g, mu, nu
    peak = FLOPS_PER_S["float32" if size == 4 else "bfloat16"]
    return {"flops": flops, "flops_6nt": 6 * n * B * T, "opt_bytes": opt_bytes,
            "state_bytes": state, "params": n,
            "bound_ms": (flops / peak + opt_bytes / HBM_BYTES_PER_S) * 1e3,
            "grad_bound_ms": flops / peak * 1e3,
            "update_bound_ms": opt_bytes / HBM_BYTES_PER_S * 1e3}


def train_measure(cfg, dtype, remat) -> dict:
    """Step times of ``cfg`` on the card (host clock, each step synchronised;
    the gradient and the update apart), a profiled step (busy share,
    kernels a step, the top kernels), peak allocated bytes."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train.step import grads_of
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = M.trainable(M.init_params(cfg, SEED, dtype, max_seq=TRAIN_T,
                                      device="cuda"))
    opt = adamw.init(model)
    ocfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=100)

    def step(s):
        t0 = time.perf_counter()
        loss, _, grads = grads_of(cfg, model, train_batch(cfg, TRAIN_B,
                                                          TRAIN_T, s),
                                  remat=remat)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, _, m = adamw.update(ocfg, grads, opt, model)
        del grads
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(math.isfinite(float(loss)) and math.isfinite(
            float(m["grad_norm"])), f"{cfg.name}: step {s} not finite")
        return (t1 - t0) * 1e3, (t2 - t1) * 1e3

    step(0)  # warm-up: cuBLAS handles, the allocator's pool
    times = [step(s) for s in range(1, 1 + TRAIN_MEASURE_STEPS)]
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(TRAIN_MEASURE_STEPS + 1)
        window_ms = (time.perf_counter() - t0) * 1e3
    by_kernel, launches = device_ms_by_kernel(prof)
    device_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    work = train_work(cfg, model, TRAIN_B, TRAIN_T, remat)
    step_ms = statistics.median(g + u for g, u in times)
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return {"dtype": str(dtype).replace("torch.", ""), "remat": remat,
            "step_ms": step_ms,
            "grad_ms": statistics.median(g for g, _ in times),
            "update_ms": statistics.median(u for _, u in times),
            "steps_ms": [round(g + u, 3) for g, u in times],
            "tokens_per_s": TRAIN_B * TRAIN_T / step_ms * 1e3,
            "max_memory_allocated": peak,
            "profile": {"window_ms": window_ms, "device_ms": device_ms,
                        "busy_share": device_ms / window_ms,
                        "busy_share_unprofiled": device_ms / step_ms,
                        "kernels": launches,
                        "top_device_ms": [[k[:60], v] for k, v in top]},
            **work}


def _leafwise(cpu_tree, card_tree):
    from repro_torch.train.checkpoint import _flatten
    card = dict(_flatten(card_tree))
    for k, a in _flatten(cpu_tree):
        yield k, a.detach(), card[k].detach().cpu()


def adam_direction(grads, eps=1e-8) -> dict:
    """AdamW's first step of each leaf of ``grads``, over ``lr`` and before
    decay: ``g s / (|g s| + eps)`` with ``s`` the clip scale (at step 1
    ``mhat`` is ``g s`` and ``nhat`` its square), by path, on the host."""
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train.checkpoint import _flatten
    s = min(1.0, 1.0 / (float(global_norm(grads)) + 1e-9))
    out = {}
    for k, g in _flatten(grads):
        gs = g.detach().cpu() * s
        out[k] = gs / (gs.abs() + eps)
    return out


def train_card_vs_cpu(cfg, B, T, seed=SEED) -> dict:
    """One step of ``cfg`` on the card against the same step on the CPU,
    from the same float32 weights and batch: the loss, every gradient leaf
    and the parameters after the update, at the CPU tests' tolerances
    (``TRAIN_*``)."""
    from repro_torch.models import model as M
    from repro_torch.models.layers import tree_map
    from repro_torch.optim import adamw
    from repro_torch.train.step import grads_of
    cpu = M.init_params(cfg, seed, torch.float32, max_seq=T, device="cpu")
    card = M.trainable(M.Model(cfg, tree_map(lambda t: t.detach().to("cuda"),
                                             cpu.tree())))
    M.trainable(cpu)
    batch = train_batch(cfg, B, T, 0, seed)
    ocfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=4)
    lc, _, g_cpu = grads_of(cfg, cpu, batch)
    lg, _, g_card = grads_of(cfg, card, batch)
    check(abs(float(lg) - float(lc)) <= TRAIN_LOSS_TOL,
          f"{cfg.name}: card loss {float(lg)} vs CPU {float(lc)}")
    grad_worst = 0.0
    for k, a, b in _leafwise(g_cpu, g_card):
        scale = float(a.abs().max())
        err = float((a - b).abs().max())
        check(torch.isfinite(b).all() and (err <= TRAIN_GRAD_TOL * scale
                                           or err == 0.0),
              f"{cfg.name}: grad {k} differs by {err} (max |g| {scale})")
        grad_worst = max(grad_worst, err / scale if scale else 0.0)
    dir_cpu, dir_card = adam_direction(g_cpu), adam_direction(g_card)
    _, _, mc = adamw.update(ocfg, g_cpu, adamw.init(cpu), cpu)
    _, _, mg = adamw.update(ocfg, g_card, adamw.init(card), card)
    lr = float(mc["lr"])
    gn = (float(mg["grad_norm"]), float(mc["grad_norm"]))
    check(abs(gn[0] - gn[1]) <= 1e-4 * gn[1], f"{cfg.name}: grad norm {gn}")
    excess, moved, n = 0.0, 0, 0
    for k, a, b in _leafwise(cpu.tree(), card.tree()):
        step_diff = lr * (dir_cpu.pop(k) - dir_card.pop(k)).abs()
        d = (a - b).abs() - step_diff - TRAIN_PARAM_TOL * a.abs()
        check(bool((d <= TRAIN_PARAM_TOL).all()),
              f"{cfg.name}: parameter {k} after the step differs by "
              f"{float(d.max())} beyond its gradients' step difference")
        excess = max(excess, float(d.max()))
        moved += int((step_diff > TRAIN_PARAM_TOL).sum())
        n += a.numel()
    out = {"arch": cfg.name, "layers": cfg.n_layers, "batch": [B, T],
           "loss_card": float(lg), "loss_cpu": float(lc),
           "loss_diff": abs(float(lg) - float(lc)),
           "grad_worst_ratio": grad_worst, "grad_norm": gn,
           "param_worst_excess": excess,
           "step_moved_elements": moved, "elements": n}
    del cpu, card, g_cpu, g_card
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_checkpoints() -> dict:
    """Gate 4: a depth-2 stablelm-3b state (full width, after one step on
    the card) saved and restored on the card bit for bit; mamba2 (reduced)
    stopped at step 2, saved, restored into fresh tensors and continued
    against four straight steps (the reference's resume test)."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import cut_depth
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train.checkpoint import _flatten
    from repro_torch.train.step import make_train_step
    root = os.path.join(ROOT, "build", "train_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    cfg = cut_depth(get_config(TRAIN_ARCH), 2)
    model = M.trainable(M.init_params(cfg, SEED, torch.float32,
                                      max_seq=TRAIN_T, device="cuda"))
    opt = adamw.init(model)
    step = make_train_step(cfg, adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=1))
    step(model, opt, train_batch(cfg, TRAIN_CPU_B, TRAIN_T, 0))
    path = CKPT.step_path(root, 1)
    t0 = time.perf_counter()
    CKPT.save({"params": model, "opt": opt}, path)
    save_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    fresh = M.init_params(cfg, SEED + 1, torch.float32, max_seq=TRAIN_T,
                          device="cuda")
    t0 = time.perf_counter()
    got = CKPT.restore({"params": fresh.tree(), "opt": adamw.init(fresh)},
                       path)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    want = dict(_flatten({"params": model, "opt": opt}))
    leaves = 0
    for k, t in _flatten(got):
        check(t.device.type == "cuda" and t.dtype == want[k].dtype
              and torch.equal(t, want[k]), f"checkpoint: {k} differs")
        leaves += 1
    check(CKPT.latest_step(root) == 1, "checkpoint: latest_step")
    del model, opt, fresh, got, want

    mcfg = get_config("mamba2-780m").reduced()
    mstep = make_train_step(mcfg, adamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                                    total_steps=4))

    def fresh_state():
        p = M.trainable(M.init_params(mcfg, SEED, torch.float32, max_seq=16,
                                      device="cuda"))
        return p, adamw.init(p)

    def run(n0, n1, p, o):
        for s in range(n0, n1):
            p, o, _ = mstep(p, o, train_batch(mcfg, 2, 16, s))
        return p, o

    straight, _ = run(0, 4, *fresh_state())
    mid_p, mid_o = run(0, 2, *fresh_state())
    CKPT.save({"p": mid_p, "o": mid_o}, CKPT.step_path(root, 2))
    new_p, new_o = fresh_state()
    CKPT.restore({"p": new_p, "o": new_o}, CKPT.step_path(root, 2),
                 inplace=True)
    resumed, _ = run(2, 4, new_p, new_o)
    resume_diff = max(float((a - b).detach().abs().max()) for (_, a), (_, b) in
                      zip(_flatten(straight), _flatten(resumed)))
    check(resume_diff <= 1e-6, f"resume vs continuous: {resume_diff}")
    shutil.rmtree(root, ignore_errors=True)
    return {"depth2_leaves_bit_equal": leaves, "depth2_file_bytes": size,
            "save_s": round(save_s, 3), "restore_s": round(restore_s, 3),
            "mamba2_resume_max_diff": resume_diff}


def train_main() -> int:
    """The ``train`` phase's own process (``chip_smoke.py --train``): gates
    1-4 and the measurements; one JSON line each."""
    if not torch.cuda.is_available():
        print("chip_smoke --train: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config, list_configs
    from repro_torch.launch.serve import cut_depth
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    free, total = torch.cuda.mem_get_info()

    # gate 1: the launcher at full width and depth, without and with remat
    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--lr",
            str(TRAIN_LR), "--batch", str(TRAIN_B), "--seq", str(TRAIN_T)]
    plain = run_launcher(argv)
    remat = run_launcher(argv + ["--remat"])
    diff = max(abs(a - b) for a, b in zip(plain["losses"], remat["losses"]))
    check(diff <= TRAIN_REMAT_TOL,
          f"remat losses {remat['losses']} vs plain {plain['losses']}")
    emit({"phase": "train_launcher", "arch": TRAIN_ARCH,
          "free_bytes_at_start": free, "card_bytes": total,
          "plain": plain, "remat": remat, "remat_max_loss_diff": diff,
          "remat_tol": TRAIN_REMAT_TOL})

    # measurements: float32 without and with remat, and one bfloat16 run
    cfg = get_config(TRAIN_ARCH)
    rows = [train_measure(cfg, torch.float32, False),
            train_measure(cfg, torch.float32, True)]
    bf16 = run_launcher(argv + ["--dtype", "bfloat16"])
    rows.append(train_measure(cfg, torch.bfloat16, False))
    emit({"phase": "train_measure", "arch": TRAIN_ARCH, "batch": TRAIN_B,
          "seq": TRAIN_T, "runs": rows,
          "bf16_launcher": {k: bf16[k] for k in ("losses", "grad_norms",
                                                  "wall_s",
                                                  "max_memory_allocated")}})

    # gate 2: depth 2 at full width against the CPU; gate 3: every reduced()
    emit({"phase": "train_card_vs_cpu", **train_card_vs_cpu(
        cut_depth(cfg, 2), TRAIN_CPU_B, TRAIN_CPU_T)})
    reduced = [train_card_vs_cpu(no_drop(get_config(a).reduced()), 2, 16)
               for a in list_configs()]
    emit({"phase": "train_reduced", "configs": reduced})

    # gate 4
    emit({"phase": "train_checkpoint", **train_checkpoints()})
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 turned on")
    return 0


def run_train() -> tuple:
    """The ``train`` phase's process (see the module docstring, 16), after
    the ``llm`` process and before this process touches the card: (its
    stdout lines, seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--train"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                 PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"),
        capture_output=True, text=True, timeout=900)
    check(proc.returncode == 0, f"train: rc {proc.returncode}: "
                                f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    return proc.stdout.splitlines(), time.perf_counter() - t0


def phase_train(lines, process_s) -> None:
    """The lines of :func:`run_train`'s process, and the phase's summary."""
    rows = {r["phase"]: r for r in (json.loads(ln) for ln in lines
                                    if ln.startswith("{"))}
    want = ("train_launcher", "train_measure", "train_card_vs_cpu",
            "train_reduced", "train_checkpoint")
    check(all(p in rows for p in want), f"train: phases {sorted(rows)}")
    for p in want:
        emit(rows[p])
    f32 = rows["train_measure"]["runs"][0]
    emit({"phase": "train", "step_ms": f32["step_ms"],
          "bound_ms": f32["bound_ms"],
          "tokens_per_s": f32["tokens_per_s"],
          "max_memory_allocated": f32["max_memory_allocated"],
          "state_bytes": f32["state_bytes"],
          "remat_step_ms": rows["train_measure"]["runs"][1]["step_ms"],
          "remat_max_loss_diff": rows["train_launcher"]["remat_max_loss_diff"],
          "card_vs_cpu_loss_diff": rows["train_card_vs_cpu"]["loss_diff"],
          "reduced_configs": len(rows["train_reduced"]["configs"]),
          "checkpoint_leaves": rows["train_checkpoint"][
              "depth2_leaves_bit_equal"],
          "process_s": round(process_s, 3)})


# ---------------------------------------------------------------------------
# the launch layer: dry run, the dry run against the card, the all-to-all
# ---------------------------------------------------------------------------

# gate 1's records: train_4k on the single-pod mesh and decode_32k on the
# multi-pod mesh for every config (the whole sweep takes longer than the
# phase may on the CPU), and whisper-small × long_500k for the skip
LAUNCH_SWEEP = (("train_4k", "single"), ("decode_32k", "multi"))
LAUNCH_SKIP = ("whisper-small", "long_500k", "single")
LAUNCH_ARCH = "stablelm-3b"          # gate 2: B 8 × T 64, kind train
LAUNCH_B, LAUNCH_T = 8, 64
# gate 1: train_4k FLOPs a device of the dense attention configs within
# this factor of the analytic count (PR 20's dry run read 2.0 on stablelm)
LAUNCH_DENSE = ("stablelm-3b", "starcoder2-3b", "internlm2-20b",
                "chatglm3-6b")
LAUNCH_FLOPS_TOL = 1.25
# gate 4: the port's dry run on the card's torch against the reference's
# records (tests/data/launch_ref.json; tests/_torch_launch_data.py writes
# it from src/repro and holds the bounds, which the parity tests share)
LAUNCH_REF = os.path.join("tests", "data", "launch_ref.json")
LAUNCH_REF_SECTIONS = ("reduced", "sharded_cache", "float32")
LAUNCH_ENV = {"CUDA_VISIBLE_DEVICES": ""}
A2A_WORLD = 4                         # gate 3: ranks on the one card
A2A_ARCH, A2A_B, A2A_T, A2A_CF = "deepseek-v2-236b", 2, 16, 16.0
A2A_TOL = 5e-5                        # × max |y| of apply_moe on the card


def launch_records(out_dir) -> tuple:
    """Gate 1's dry runs, one CLI process a (shapes, mesh) pair: (records,
    wall seconds of each process)."""
    walls = []
    calls = [["--arch", "all", "--shape", s, "--mesh", m]
             for s, m in LAUNCH_SWEEP]
    calls.append(["--arch", LAUNCH_SKIP[0], "--shape", LAUNCH_SKIP[1],
                  "--mesh", LAUNCH_SKIP[2]])
    for argv in calls:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
             "--out", out_dir], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                     **LAUNCH_ENV),
            capture_output=True, text=True, timeout=600)
        walls.append(round(time.perf_counter() - t0, 3))
        check(proc.returncode == 0, f"dryrun {argv}: rc {proc.returncode}: "
                                    f"{proc.stdout[-3000:]}{proc.stderr[-2000:]}")
    recs = [json.load(open(os.path.join(out_dir, f)))
            for f in sorted(os.listdir(out_dir)) if f.endswith(".json")]
    return recs, walls


def shard_arg_bytes(rec, mesh_shape=None) -> int:
    """A record's per-device argument bytes from its specs alone: the sum
    of its leaves' local shard bytes."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD
    cfg, shape = get_config(rec["arch"]), INPUT_SHAPES[rec["shape"]]
    mshape, axes = mesh_shape or (MULTI_POD if rec["mesh"] == "multi"
                                  else SINGLE_POD)
    sizes = dict(zip(axes, mshape))
    _, args, _ = D.build_step(cfg, shape, quantized=rec["quantized"])
    specs = D.arg_shardings(cfg, shape, args, sizes, rec["fsdp"])
    return D.local_arg_bytes(args, specs, sizes)


def analytic_train_flops(cfg, shape, n_devices) -> float:
    """A dense attention config's train-step FLOPs a device from the config
    alone: the forward's products (2 × tokens × the decoder's matrix
    weights, and the attention scores and values, 2 × 2 × B × T² × H × hd a
    layer, the whole T × T as the port computes them) 4 times (forward,
    remat's recompute, and the two products of the backward), the LM
    head's 3 times (outside the remat), ÷ the devices."""
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.model import param_specs
    specs = param_specs(cfg)
    tokens = shape.global_batch * shape.seq_len
    matrices = sum(math.prod(s.shape) for s in tree_leaves(specs["layers"])
                   if len(s.shape) == 3)  # (n_periods, d_in, d_out)
    attn = 4 * shape.global_batch * shape.seq_len ** 2 * cfg.n_heads \
        * cfg.head_dim * cfg.n_layers
    stack = 2 * tokens * matrices + attn
    head = 2 * tokens * math.prod(specs["lm_head"].shape)
    return (4 * stack + 3 * head) / n_devices


def launch_sweep() -> dict:
    """Gate 1: every record ok but the skip, argument bytes by shard
    arithmetic, argument + temp bytes a device beside the card's."""
    import tempfile
    from repro_torch.configs import INPUT_SHAPES, get_config, list_configs
    from repro_torch.launch import specs as SP
    out_dir = tempfile.mkdtemp(prefix="launch_dryrun_", dir=os.path.join(
        ROOT, "build"))
    t0 = time.perf_counter()
    recs, walls = launch_records(out_dir)
    wall = time.perf_counter() - t0
    want = {(a, s, m) for a in list_configs() for s, m in LAUNCH_SWEEP}
    want.add(LAUNCH_SKIP)
    got = {(r["arch"], r["shape"], r["mesh"]): r for r in recs}
    check(set(got) == want, f"dry-run records {sorted(set(got) ^ want)}")
    card = torch.cuda.get_device_properties(0).total_memory
    rows = []
    for key in sorted(want):
        r = got[key]
        if key == LAUNCH_SKIP:
            check(r["status"] == "skipped" and r["reason"] == SP.skip_reason(
                get_config(key[0]), INPUT_SHAPES[key[1]]),
                f"{key}: {r['status']} {r.get('reason')}")
            continue
        check(r["status"] == "ok", f"{key}: {r['status']}: "
                                   f"{r.get('traceback', '')[-1500:]}")
        mem = r["memory"]
        want_b = shard_arg_bytes(r)
        check(mem["argument_bytes"] == want_b,
              f"{key}: argument bytes {mem['argument_bytes']} != shards "
              f"{want_b}")
        row = {}
        if key[0] in LAUNCH_DENSE and key[1:] == ("train_4k", "single"):
            analytic = analytic_train_flops(get_config(key[0]),
                                            INPUT_SHAPES[key[1]],
                                            r["n_devices"])
            ratio = r["flops_per_device"] / analytic
            check(ratio <= LAUNCH_FLOPS_TOL,
                  f"{key}: FLOPs a device {r['flops_per_device']:.4g} are "
                  f"{ratio:.3f} of the analytic {analytic:.4g}")
            row = {"analytic_flops_per_device": analytic,
                   "flops_over_analytic": round(ratio, 4)}
        rows.append({"arch": key[0], "shape": key[1], "mesh": key[2],
                     "fsdp": r["fsdp"], "argument_bytes": mem["argument_bytes"],
                     "temp_bytes": mem["temp_bytes"],
                     "argument_plus_temp_over_card": round(
                         (mem["argument_bytes"] + mem["temp_bytes"]) / card, 4),
                     "flops_per_device": r["flops_per_device"],
                     "bytes_per_device": r.get("bytes_per_device"),
                     "collective_bytes_total": r["collective_bytes_total"],
                     "collectives": {k: v["count"] for k, v in
                                     r["collectives"].items() if v["count"]},
                     "collective_bytes": {k: v["bytes"] for k, v in
                                          r["collectives"].items()
                                          if v["count"]},
                     "trace_s": r["trace_s"], "fallback_ops": r["fallback_ops"],
                     **row})
    return {"phase": "launch_dryrun", "records": len(recs),
            "ok": len(rows), "skipped": 1, "card_total_memory": card,
            "sweep": [list(p) for p in LAUNCH_SWEEP],
            "temp_method": next(r["memory"]["temp_method"] for r in recs
                                if r["status"] == "ok"),
            "process_wall_s": walls, "wall_s": round(wall, 3), "rows": rows}


def launch_ref_main(argv) -> int:
    """Gate 4's dry runs (``chip_smoke.py --launch-ref OUT``, CPU only):
    the port's record (``_torch_launch_data.port_record``) of each record
    of the reference file's ``LAUNCH_REF_SECTIONS``, each under its
    section's setting, written to OUT."""
    sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]
    from _torch_launch_data import port_record
    with open(os.path.join(ROOT, LAUNCH_REF)) as f:
        data = json.load(f)
    out = {}
    for name in LAUNCH_REF_SECTIONS:
        sec = data[name]
        for ref in sec["records"]:
            out["/".join((name, ref["arch"], ref["kind"], ref["tag"]))] = \
                port_record(ref, sec)
    with open(argv[0], "w") as f:
        json.dump(out, f)
    return 0


def start_launch_ref(out) -> subprocess.Popen:
    """:func:`launch_ref_main` in its own process, beside gate 1's."""
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--launch-ref", out],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                           **LAUNCH_ENV),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def launch_reference(proc, out, sweep, wall_t0) -> dict:
    """Gate 4: the port's dry run on the card's torch held to the
    reference's records, with ``tests/_torch_launch_data.py``'s bounds
    (``parity``, ``full_parity``). Reduced, sequence-sharded-cache and
    float32 records (:func:`launch_ref_main`): FLOPs a device within 0.99–1.07
    of the reference's dot FLOPs (at most 1.01 for a dense config) and at
    most 1.25 of its whole count, collective bytes at most 2.0× (dense) /
    2.5×, argument bytes equal (less what ``jax.jit`` drops); a float32
    record's bytes a device at least 0.9 of XLA's bytes accessed less its
    layout ops (in bfloat16 XLA on the CPU widens every activation to
    float32: those ratios are printed). Full size (gate 1's records): the
    deepseek-v2 and kimi-k2 ``train_4k`` FLOPs a device within the band of
    the reference's dot FLOPs with the dots that carry the whole global
    batch (attention score and value products, checked by einsum) counted
    once over the data axes, and the raw ratio within 3% of its pinned
    value; stablelm-3b ``decode_32k`` collective bytes at most 2.0×.
    Every ratio is printed; the gate fails after all are."""
    from _torch_launch_data import full_parity, parity
    from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD
    stdout, stderr = proc.communicate(timeout=600)
    check(proc.returncode == 0, f"--launch-ref: rc {proc.returncode}: "
                                f"{stdout[-2000:]}{stderr[-3000:]}")
    with open(out) as f:
        port = json.load(f)
    with open(os.path.join(ROOT, LAUNCH_REF)) as f:
        data = json.load(f)
    rows, failed = [], []
    for name in LAUNCH_REF_SECTIONS:
        for ref in data[name]["records"]:
            key = "/".join((name, ref["arch"], ref["kind"], ref["tag"]))
            p = port[key]
            if p["status"] != "ok":
                failed.append(f"{key}: {p.get('traceback', '')[-800:]}")
                continue
            ratios, bad = parity(p, ref, bytes_gated=name == "float32")
            row = {"record": key, **{k: round(v, 4) if isinstance(v, float)
                                     else v for k, v in ratios.items()}}
            if bad:
                failed.append(f"{key}: {bad} {row}")
            rows.append(row)
    got = {(r["arch"], r["shape"], r["mesh"]): r for r in sweep["rows"]}
    full = []
    for ref in data["full"]["records"]:
        key = (ref["arch"], ref["shape"], ref["mesh"])
        p = got[key]
        mshape, axes = MULTI_POD if ref["mesh"] == "multi" else SINGLE_POD
        ways = math.prod(n for a, n in zip(axes, mshape)
                         if a in ("pod", "data"))
        ratios, bad = full_parity(p, ref, ways)
        row = {"record": "/".join(key),
               "flops_per_device": p["flops_per_device"],
               "reference_dot_flops": ref["dot_flops_per_device"],
               "reference_whole_batch_dot_flops":
                   ref.get("dot_flops_whole_batch_per_device"),
               "reference_whole_batch_dots": sorted(
                   {d["einsum"] or f"unnamed, out {d['out']}"
                    for d in ref.get("whole_batch_dots", [])}),
               "collective_bytes": p["collective_bytes_total"],
               "reference_collective_bytes": ref["collective_bytes_total"],
               "bytes_per_device": p.get("bytes_per_device"),
               "reference_bytes_per_device": ref["bytes_per_device"],
               **{k: round(v, 4) for k, v in ratios.items()}}
        if bad:
            failed.append(f"full {bad} {row}")
        full.append(row)
    line = {"phase": "launch_reference", "reference": LAUNCH_REF,
            "reference_jax": data["jax"], "records": len(rows),
            "full_method": data["full"]["method"], "rows": rows,
            "full": full, "failed": failed,
            "wall_s": round(time.perf_counter() - wall_t0, 3)}
    emit(line)
    check(not failed, f"gate 4: {len(failed)} record(s) off the "
                      f"reference's: {failed[:6]}")
    return line


def start_launch_hashseed(work) -> list:
    """Gate 5's processes (``_torch_launch_data.spawn_hashseed``), one a
    seed of ``HASHSEEDS``, beside gate 1's: [(seed, process, output)]."""
    from _torch_launch_data import HASHSEEDS, spawn_hashseed
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), **LAUNCH_ENV)
    return [(seed, spawn_hashseed(seed, out, env), out)
            for seed in HASHSEEDS
            for out in [os.path.join(work, f"hashseed{seed}.json")]]


def launch_hashseed(procs, ref_out, wall_t0) -> dict:
    """Gate 5: the MoE records of ``HASHSEED_RECORDS`` made under each
    ``PYTHONHASHSEED`` of ``HASHSEEDS`` and gate 4's (no seed pinned), the
    same in every number of ``HASHSEED_COMPARED``."""
    from _torch_launch_data import HASHSEED_COMPARED, hashseed_differences
    runs = {}
    for seed, proc, out in procs:
        _, err = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"hashseed {seed}: rc {proc.returncode}"
                                    f": {err[-3000:]}")
        with open(out) as f:
            runs[f"PYTHONHASHSEED={seed}"] = json.load(f)
    with open(ref_out) as f:
        port = json.load(f)
    first = next(iter(runs.values()))
    runs["gate 4, unpinned"] = {
        key: {k: port["/".join(("reduced", *key.split("/"), ""))][k]
              for k in HASHSEED_COMPARED} for key in first}
    diffs = {name: hashseed_differences(first, run)
             for name, run in runs.items()}
    line = {"phase": "launch_hashseed", "runs": sorted(runs),
            "records": {key: {"flops_per_device": r["flops_per_device"],
                              "bytes_per_device": r["bytes_per_device"],
                              "collective_bytes_total":
                                  r["collective_bytes_total"],
                              "temp_bytes": r["memory"]["temp_bytes"]}
                        for key, r in first.items()},
            "differences": {k: v for k, v in diffs.items() if v},
            "wall_s": round(time.perf_counter() - wall_t0, 3)}
    emit(line)
    check(not line["differences"], "gate 5: the MoE records follow the "
                                   f"hash seed: {line['differences']}")
    return line


def launch_card() -> dict:
    """Gate 2: ``build_step`` and ``arg_shardings`` on a (1, 1) mesh, then
    the same specs made on the card and the step run once."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import specs as SP
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.model import trainable
    cfg = get_config(LAUNCH_ARCH)
    shape = InputShape("train", LAUNCH_T, LAUNCH_B, "train")
    rec = D.run_one(LAUNCH_ARCH, "train", False, cfg=cfg, out_dir="",
                    mesh_shape=((1, 1), ("data", "model")),
                    input_shape=shape)
    check(rec["status"] == "ok", f"gate 2 dry run: {rec.get('traceback')}")
    step, args, _ = D.build_step(cfg, shape)
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    real = tuple(SP.materialize(a, "cuda", SEED + i)
                 for i, a in enumerate(args))
    for t in tree_leaves(real[1]["mu"]) + tree_leaves(real[1]["nu"]):
        t.zero_()
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - before
    leaves = [t for a in real for t in tree_leaves(a)]
    arg_bytes = sum(t.untyped_storage().nbytes() for t in leaves)
    check(rec["memory"]["argument_bytes"] == arg_bytes,
          f"gate 2: dry run {rec['memory']['argument_bytes']} B of arguments, "
          f"{arg_bytes} B on the card")
    trainable(real[0])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, _, metrics = step(*real)
    loss = float(metrics["loss"])
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    check(math.isfinite(loss), f"gate 2: loss {loss}")
    out = {"phase": "launch_card", "arch": LAUNCH_ARCH, "batch": LAUNCH_B,
           "seq": LAUNCH_T, "argument_bytes_dry_run":
               rec["memory"]["argument_bytes"],
           "argument_bytes_on_card": arg_bytes,
           "memory_allocated_by_arguments": allocated,
           "temp_bytes_estimate": rec["memory"]["temp_bytes"],
           "peak_minus_arguments": peak - arg_bytes,
           "estimate_over_measured": round(
               rec["memory"]["temp_bytes"] / (peak - arg_bytes), 4),
           "temp_method": rec["memory"]["temp_method"],
           "flops_per_device": rec["flops_per_device"], "loss": loss,
           "step_s": round(step_s, 3)}
    del real, leaves, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return out


def a2a_params(cfg, experts, device, seed=SEED) -> dict:
    """One MoE layer's weights (float32) with only ``experts``' slabs of
    ``w_gate`` / ``w_up`` / ``w_down``: expert e drawn from a generator
    seeded by (seed, e), so that a rank draws its own slabs and the whole
    layer is the same draws; the router and shared experts from ``seed``."""
    from repro_torch.models.model import draw
    from repro_torch.models.moe import init_moe
    specs = init_moe(cfg, torch.float32)
    shared = {k: v for k, v in specs.items()
              if k not in ("w_gate", "w_up", "w_down")}
    p = draw(shared, seed, device)
    for name in ("w_gate", "w_up", "w_down"):
        spec = specs[name]
        out = torch.empty((len(experts),) + spec.shape[1:], device=device)
        for i, e in enumerate(experts):
            gen = torch.Generator(device=device).manual_seed(
                seed * 1_000_003 + int(e))
            out[i].normal_(generator=gen).mul_(spec.value)
        p[name] = out
    return p


def a2a_cases():
    import dataclasses as dc
    from repro_torch.configs import get_config
    return [("deepseek", dc.replace(get_config(A2A_ARCH),
                                    capacity_factor=A2A_CF)),
            ("kimi_reduced", dc.replace(get_config("kimi-k2-1t-a32b")
                                        .reduced(), capacity_factor=A2A_CF))]


def a2a_input(cfg, device):
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    return torch.randn((A2A_B, A2A_T, cfg.d_model), generator=gen,
                       device=device) * 0.2


def a2a_main(argv) -> int:
    """One rank of gate 3 (``chip_smoke.py --a2a RANK WORKDIR``): a gloo
    group of ``A2A_WORLD`` processes on the one card, each holding its own
    experts' slabs; writes its y and bytes to ``WORKDIR``."""
    rank, work = int(argv[0]), argv[1]
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models.moe_a2a import moe_all_to_all
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(work, "store"), A2A_WORLD), rank=rank,
        world_size=A2A_WORLD)
    mesh = init_device_mesh("cuda", (1, A2A_WORLD),
                            mesh_dim_names=("data", "model"))
    out = {}
    for name, cfg in a2a_cases():
        E_loc = cfg.n_experts // A2A_WORLD
        p = a2a_params(cfg, range(rank * E_loc, (rank + 1) * E_loc), "cuda")
        held = tree_bytes(p)
        t0 = time.perf_counter()
        with torch.no_grad():
            y, aux = moe_all_to_all(cfg, p, a2a_input(cfg, "cuda"), mesh)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        with torch.no_grad():
            again, _ = moe_all_to_all(cfg, p, a2a_input(cfg, "cuda"), mesh)
        out[name] = {"y": y.cpu(), "aux": float(aux), "bytes_held": held,
                     "call_s": call_s, "same_bits": torch.equal(y, again),
                     "backend": dist.get_backend(mesh.get_group("model"))}
        del p, y, again
        torch.cuda.empty_cache()
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def tree_bytes(tree) -> int:
    from repro_torch.models.layers import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


class combine_inputs:
    """Within ``with combine_inputs() as got:``, each call of
    ``moe.combine`` appends its (expert outputs, slots) to ``got``."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.orig = moe, moe.combine
        got, orig = [], self.orig

        def kept(ye, slots):
            got.append((ye, slots))
            return orig(ye, slots)

        moe.combine = kept
        return got

    def __exit__(self, *exc):
        self.moe.combine = self.orig
        return False


def index_add_combine(ye, slots):
    """The combine ``moe.combine`` replaced: an ``index_add`` of the table
    ``ye`` (bins, capacity, d) over its slots' token ids (from ``slots``,
    :func:`~repro_torch.models.moe.pick_slots`)."""
    n, k = slots.shape
    d = ye.shape[-1]
    tokens = torch.full((ye.shape[0] * ye.shape[1] + 1,), n,
                        device=ye.device).index_put(
        (slots.reshape(-1),), torch.arange(n, device=ye.device)
        .repeat_interleave(k))[:-1]
    return torch.zeros((n + 1, d), dtype=ye.dtype, device=ye.device) \
        .index_add(0, tokens, ye.reshape(-1, d))[:n]


def launch_a2a() -> dict:
    """Gate 3: ``A2A_WORLD`` processes on the card run ``moe_all_to_all``
    over gloo; every rank's y held against ``apply_moe`` on the card with
    every expert drawn the same way, and each of them the same bits on two
    runs; the elements the ``index_add`` combine changes between two runs
    on ``apply_moe``'s expert outputs, printed."""
    import tempfile
    from repro_torch.models.moe import apply_moe, combine
    work = tempfile.mkdtemp(prefix="a2a_", dir=os.path.join(ROOT, "build"))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--a2a", str(r), work],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(A2A_WORLD)]
    errs = []
    for r, pr in enumerate(procs):
        try:
            _, err = pr.communicate(timeout=400)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if pr.returncode:
            errs.append(f"rank {r}: rc {pr.returncode}: {err[-2000:]}")
    check(not errs, "a2a: " + "\n".join(errs))
    ranks_s = time.perf_counter() - t0
    got = [torch.load(os.path.join(work, f"rank{r}.pt"))
           for r in range(A2A_WORLD)]
    cases = []
    for name, cfg in a2a_cases():
        p = a2a_params(cfg, range(cfg.n_experts), "cuda")
        with torch.no_grad(), combine_inputs() as kept:
            y_ref, aux_ref = apply_moe(cfg, p, a2a_input(cfg, "cuda"))
            again, _ = apply_moe(cfg, p, a2a_input(cfg, "cuda"))
            ye, slots = kept[0]
            old = [index_add_combine(ye, slots) for _ in range(2)]
            new = combine(ye, slots)
        same = torch.equal(y_ref, again)
        ranks_same = [g[name]["same_bits"] for g in got]
        check(same and all(ranks_same),
              f"a2a {name}: two runs differ: apply_moe {same}, ranks "
              f"{ranks_same}")
        y_ref = y_ref.cpu()
        scale = float(y_ref.abs().max())
        errs = [float((g[name]["y"] - y_ref).abs().max()) for g in got]
        check(all(math.isfinite(e) for e in errs) and max(errs)
              <= A2A_TOL * scale,
              f"a2a {name}: max |y - apply_moe| {errs}, max |y| {scale}")
        cases.append({"case": name, "n_experts": cfg.n_experts,
                      "d_model": cfg.d_model, "moe_d_ff": cfg.expert_d_ff,
                      "top_k": cfg.top_k,
                      "shared_experts": cfg.n_shared_experts,
                      "tokens": A2A_B * A2A_T,
                      "capacity_factor": cfg.capacity_factor,
                      "layer_bytes": tree_bytes(p),
                      "bytes_held_per_rank": [g[name]["bytes_held"]
                                              for g in got],
                      "max_abs_err_per_rank": errs, "max_abs_y": scale,
                      "tol": A2A_TOL, "aux_per_rank": [g[name]["aux"]
                                                       for g in got],
                      "aux_apply_moe": float(aux_ref),
                      "same_bits_apply_moe": same,
                      "same_bits_per_rank": ranks_same,
                      "index_add_elements_changed_between_runs": int(
                          (old[0] != old[1]).sum()),
                      "index_add_max_abs_diff_from_combine": max(
                          float((o - new).abs().max()) for o in old),
                      "combine_elements": new.numel(),
                      "call_s_per_rank": [round(g[name]["call_s"], 3)
                                          for g in got]})
        del p, again, kept, ye, old, new
        torch.cuda.empty_cache()
    return {"phase": "launch_a2a", "ranks": A2A_WORLD,
            "backend": got[0][cases[0]["case"]]["backend"],
            "transport": "gloo on one card, CUDA tensors given to gloo as "
                         "they are (NCCL refuses two ranks on one device; "
                         "NCCL across four cards waits for a four-card "
                         "machine); its times are not NVLink's",
            "cases": cases, "ranks_wall_s": round(ranks_s, 3),
            "wall_s": round(time.perf_counter() - t0, 3)}


def launch_main() -> int:
    """The ``launch`` phase's own process (``chip_smoke.py --launch``):
    gates 1-5, one JSON line each."""
    if not torch.cuda.is_available():
        print("chip_smoke --launch: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]
    t0 = time.perf_counter()
    out = os.path.join(ROOT, "build", "launch_ref_port.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    proc = start_launch_ref(out)
    seeds = start_launch_hashseed(os.path.dirname(out))
    try:
        sweep = launch_sweep()
        emit(sweep)
        launch_reference(proc, out, sweep, t0)
        launch_hashseed(seeds, out, t0)
    finally:
        for p in [proc] + [p for _, p, _ in seeds]:
            if p.poll() is None:
                p.kill()
                p.wait()
    emit(launch_card())
    emit(launch_a2a())
    emit({"phase": "launch_process", "wall_s":
          round(time.perf_counter() - t0, 3)})
    return 0


def run_launch() -> tuple:
    """The ``launch`` phase's process (see the module docstring, 17), after
    the ``train`` process and before this process touches the card: (its
    stdout lines, seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--launch"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                 PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"),
        capture_output=True, text=True, timeout=900)
    check(proc.returncode == 0, f"launch: rc {proc.returncode}: "
                                f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    return proc.stdout.splitlines(), time.perf_counter() - t0


def phase_launch(lines, process_s) -> None:
    """The lines of :func:`run_launch`'s process, and the phase's summary."""
    rows = {r["phase"]: r for r in (json.loads(ln) for ln in lines
                                    if ln.startswith("{"))}
    want = ("launch_dryrun", "launch_reference", "launch_hashseed",
            "launch_card", "launch_a2a")
    check(all(p in rows for p in want), f"launch: phases {sorted(rows)}")
    for p in want:
        emit(rows[p])
    dr, ref, seeds, card, a2a = (rows[p] for p in want)
    emit({"phase": "launch", "dryrun_records": dr["records"],
          "dryrun_ok": dr["ok"], "dryrun_wall_s": dr["wall_s"],
          "max_argument_plus_temp_over_card": max(
              r["argument_plus_temp_over_card"] for r in dr["rows"]),
          "train_4k_flops_over_analytic": {
              r["arch"]: r["flops_over_analytic"] for r in dr["rows"]
              if "flops_over_analytic" in r},
          "reference_records": ref["records"],
          "reference_max_flops_over_dots": max(
              r["flops_over_dots"] for r in ref["rows"]),
          "reference_max_collectives_over": max(
              r["collectives_over"] for r in ref["rows"]),
          "reference_min_bytes_over": min(
              r["bytes_over"] for r in ref["rows"]),
          "reference_full": {r["record"]: {
              k: r[k] for k in ("flops_over_dots", "flops_over_split_dots",
                                "collectives_over")} for r in ref["full"]},
          "card_argument_bytes": card["argument_bytes_on_card"],
          "card_temp_estimate_over_measured": card["estimate_over_measured"],
          "hashseed_runs": seeds["runs"],
          "hashseed_differences": seeds["differences"],
          "a2a_max_rel_err": max(max(c["max_abs_err_per_rank"])
                                 / c["max_abs_y"] for c in a2a["cases"]),
          "a2a_same_bits": all(c["same_bits_apply_moe"]
                               and all(c["same_bits_per_rank"])
                               for c in a2a["cases"]),
          "index_add_elements_changed_between_runs": {
              c["case"]: c["index_add_elements_changed_between_runs"]
              for c in a2a["cases"]},
          "a2a_wall_s": a2a["wall_s"], "process_s": round(process_s, 3)})


# ---------------------------------------------------------------------------
# graph files
# ---------------------------------------------------------------------------

GRAPH_SHAPES = {"sine": (1, 1), "speech": (1, 49, 40, 1),
                "person": (1, 96, 96, 1)}
GRAPH_BUCKETS = (1, 8)
GRAPH_JAX_FILE = os.path.join("tests", "data", "sine_int8.mfg")
SINE_MSE_MAX = 0.006          # the noise floor of U(-0.1, 0.1) is 0.0033


def _file_facts(path) -> dict:
    with open(path, "rb") as f:
        data = f.read()
    return {"bytes": len(data), "sha256": hashlib.sha256(data).hexdigest()}


def _load_example(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_graph() -> None:
    """Graph files and the sine example's path on the card, counted (see
    the module docstring, 18)."""
    import tempfile
    from repro_torch.configs.paper_models import PAPER_MODELS
    from repro_torch.core import graph as G
    from repro_torch.core.engine import CompiledModel
    from repro_torch.core.quantize import quantize_graph
    rng = np.random.default_rng(SEED + 3)
    graphs = {}
    for name, shape in GRAPH_SHAPES.items():
        g = quantize_graph(PAPER_MODELS[name](), [
            rng.normal(0, 1, shape).astype("f") for _ in range(2)],
            device="cuda")
        xs = np.stack([g.tensor(g.inputs[0]).qparams.quantize(
            rng.normal(0, 1, shape).astype("f"))
            for _ in range(max(GRAPH_BUCKETS))])
        graphs[name] = (g, xs)
    jpath = os.path.join(ROOT, GRAPH_JAX_FILE)
    out_dir = tempfile.mkdtemp(prefix="graph_", dir=os.path.join(ROOT,
                                                                 "build"))

    reset_counts()
    files, lsb = {}, {}
    for name, (g, xs) in graphs.items():
        path = os.path.join(out_dir, f"{name}_int8.mfg")
        G.save(g, path)
        loaded = G.load(path)
        check("msgpack" not in sys.modules, "loading a graph imported msgpack")
        orig = CompiledModel(g, use_kernels=True, device="cuda")
        cm = CompiledModel(loaded, use_kernels=True, device="cuda")
        softmax = g.ops[-1].op == "SOFTMAX"
        lsb[name] = 0
        for b in GRAPH_BUCKETS:
            want = orig.predict_q_many(xs[:b], max_batch=b)
            got = cm.predict_q_many(xs[:b], max_batch=b)
            check(got.shape == want.shape, f"{name} bucket {b}: shape")
            d = int(np.abs(got.astype(np.int32) - want.astype(np.int32))
                    .max(initial=0))
            check(d <= (1 if softmax else 0),
                  f"{name} bucket {b}: reloaded rows differ by {d}")
            lsb[name] = max(lsb[name], d)
        files[name] = _file_facts(path)
    jg = G.load(jpath)
    jxs = np.stack([jg.tensor(jg.inputs[0]).qparams.quantize(
        rng.uniform(0, 2 * np.pi, (1, 1)).astype("f"))
        for _ in range(max(GRAPH_BUCKETS))])
    jax_rows = {}
    for b in GRAPH_BUCKETS:
        want = CompiledModel(jg, use_kernels=False, device="cpu") \
            .predict_q_many(jxs[:b], max_batch=b)
        got = CompiledModel(jg, use_kernels=True, device="cuda") \
            .predict_q_many(jxs[:b], max_batch=b)
        check(np.array_equal(got, want),
              f"the JAX package's sine file, bucket {b}: rows differ from "
              "the CPU plain route")
        jax_rows[str(b)] = got.reshape(b, -1)[:, 0].tolist()
    check("msgpack" not in sys.modules, "loading a graph imported msgpack")
    torch.cuda.synchronize()
    graph_counts = launch_counts()
    check(graph_counts["qmatmul"] > 0 and graph_counts["qdwconv"] > 0,
          f"graph files: launches {graph_counts}")

    # the sine example's path (the ``examples`` phase runs its CLI): its
    # trainer and Table 5 protocol, counted
    ts = _load_example("torch_train_sine")
    reset_counts()
    t0 = time.perf_counter()
    res = ts.sine_metrics(device="cuda")
    torch.cuda.synchronize()
    sine_s = time.perf_counter() - t0
    sine_counts = launch_counts()
    check(sine_counts["qmatmul"] > 0, f"sine example: launches {sine_counts}")
    check(res["engines_equal"], "sine example: int8 engines differ")
    for k in ("float", "int8_interp", "int8_compiled"):
        check(res[k]["mse"] <= SINE_MSE_MAX, f"sine example: {k} {res[k]}")
    emit({"phase": "graph", "files": files,
          "jax_file": {"path": GRAPH_JAX_FILE, **_file_facts(jpath),
                       "rows_equal_cpu_plain": True, "rows": jax_rows},
          "buckets": list(GRAPH_BUCKETS), "max_lsb_reloaded": lsb,
          "msgpack_imported": "msgpack" in sys.modules,
          "launches": {k: v for k, v in graph_counts.items() if v},
          "sine_example": {"launches": {k: v for k, v in sine_counts.items()
                                        if v},
                           "wall_s": round(sine_s, 3),
                           **{k: res[k] for k in ("float", "int8_interp",
                                                  "int8_compiled")}}})


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
    llm_lines, llm_s = run_llm()
    train_lines, train_s = run_train()
    launch_lines, launch_s = run_launch()
    from repro_torch.configs.paper_models import (PAPER_MODELS, build_person,
                                                  build_speech)
    from repro_torch.core.engine import (CompiledModel, bucket_for,
                                         cost_of_plan)
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
    # the first qmatmul call at bucket 8 (pw1: conv0 runs on the fused
    # conv): its bounds and n_true for the explicit qmatmul case
    conv0 = next(s for s in calls[max(BUCKETS)] if s[0] == "qmatmul")
    qm_m, qm_k, qm_n = QMATMUL_EXPLICIT
    fm_m, fm_k, fm_n = FMATMUL_EXPLICIT
    paged_sigs = ([s for pc in paged_calls.values() for b in pc
                   for s in pc[b] if s[0] == "paged_qmatmul"]
                  + [s for s in fc_calls if s[0] == "paged_qmatmul"])
    # the fused conv where the benchmark runs it: the recorded call with the
    # bucket's batch (speech's from its paged engine, whose conv is unpaged)
    conv_recorded = {
        "speech": paged_calls["speech"][max(PAGED_BUCKETS)],
        "person": calls[max(BUCKETS)]}
    conv_explicit = []
    for name, bucket in CONV_EXPLICIT.items():
        sig = next(s for s in conv_recorded[name] if s[0] == "qmatmul_conv")
        conv_explicit.append(sig[:1] + ((bucket,) + sig[1][1:],) + sig[2:])
    explicit = ([("qmatmul", (qm_m, qm_k), (qm_n, qm_k)) + conv0[3:]] + [
        ("fmatmul", (fm_m, fm_k), (fm_k, fm_n), dtype, None, None, None)
        for dtype in ("float32", "bfloat16")]
        + [("qdwconv", xs, ws, -20.0, 90.0, lanes, geo)
           for xs, ws, lanes, geo in DWCONV_EXPLICIT]
        + [next(s for s in paged_sigs if s[1:3] == (xs, ws) and s[5] == page)
           for xs, ws, page in PAGED_EXPLICIT] + conv_explicit)
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
    # the forward's count, as the CPU plain route of the same graph gives
    # it, and each bucket's roofline share: the count's bound over the
    # device time of the bucket's graph replay, on the model's stream
    percall_cost = cm.cost_analysis()
    check(percall_cost == plain_cpu.cost_analysis(),
          f"cost_analysis on the card {percall_cost}, on the CPU plain "
          f"route {plain_cpu.cost_analysis()}")
    cost, replay_ms, share = {"percall": forward_bound(percall_cost)}, {}, {}
    for b in sorted(captured):
        got = cost_of_plan(cm.exec_plan, b)
        check(got == cost_of_plan(plain_cpu.exec_plan, b),
              f"bucket {b}: the count on the card {got} is not the CPU "
              f"plain route's")
        exe = cm.compile_batched(b)
        with torch.cuda.stream(exe.stream):
            replay_ms[str(b)] = cuda_ms(exe.graph.replay, reps=5, inner=5)
        cost[str(b)] = forward_bound(got)
        share[str(b)] = cost[str(b)]["bound_ms"] / replay_ms[str(b)]
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
          "ms_per_bucket_call": serve_ms, "ms_per_percall": percall_ms,
          "cost": cost, "replay_ms_per_bucket": replay_ms,
          "roofline_share": share})

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
    counted = (cm.h2d_copies, cm.h2d_bytes)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            cm.predict_q_many(xq, max_batch=MAX_BATCH)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    counted = (cm.h2d_copies - counted[0], cm.h2d_bytes - counted[1])
    by_kernel = device_ms_by_kernel(prof)[0]
    device_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    h2d = h2d_copies(prof)
    check(counted == (5, 5 * H2D_ROWS_B8),
          f"the engine's H2D copies of 5 bucket-8 calls: {counted}")
    check(all(b == H2D_ROWS_B8 for b in h2d["bytes"])
          and len(h2d["bytes"]) <= counted[0],
          f"the trace's H2D copies of 5 bucket-8 calls: {h2d}, the "
          f"engine's {counted}")
    emit({"phase": "trace", "forwards": 5, "bucket": 8,
          "h2d_copies_counted": counted[0], "h2d_bytes_counted": counted[1],
          "h2d_copies": len(h2d["bytes"]), "h2d_bytes": h2d["bytes"],
          "h2d_copies_lost_by_trace": counted[0] - len(h2d["bytes"]),
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
    phase_llm(llm_lines, llm_s)
    phase_train(train_lines, train_s)
    phase_launch(launch_lines, launch_s)
    phase_graph()

    # -- summary: per forward at bucket 1 (and 8) of the path each kernel is on
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "call_ms")
    paged_fwd = {b: [s for pc in paged_calls.values() for s in pc[b]]
                 for b in (1, 8)}
    fwd = {"qmatmul": (calls, "person"), "qdwconv": (calls, "person"),
           "qmatmul_conv": (calls, "person"),
           "paged_qmatmul": (paged_fwd, "sine+speech+person (paged)"),
           "fmatmul": (float_calls, "speech float")}
    kernels = []
    for kname in ("qmatmul", "qmatmul_conv", "qdwconv", "paged_qmatmul",
                  "fmatmul"):
        fcalls, model = fwd[kname]
        errs = [measured[s]["max_abs_err"] for b in fcalls for s in fcalls[b]
                if s[0] == kname]
        source = "qmatmul" if kname == "qmatmul_conv" else kname
        entry = {"name": kname, "route": "cuda",
                 "source": f"src/repro_torch/kernels/csrc/{source}.cu",
                 "replaces": REPLACES[kname], "launches": launches[kname],
                 "max_abs_err": max(errs), "per_forward_of": model,
                 "bucket": 1}
        for key in keys:
            entry[key] = per_forward(fcalls, measured, 1, kname, key)
        by = [measured[s]["bound_by"] for s in fcalls[1] if s[0] == kname]
        entry["bound_by"] = max(set(by), key=by.count)
        entry["per_forward_bucket8"] = {
            key: per_forward(fcalls, measured, 8, kname, key) for key in keys}
        if kname == "qmatmul_conv":  # where the benchmark runs it
            entry["explicit"] = [
                {"of": name, "bucket": CONV_EXPLICIT[name], "x": list(s[1]),
                 **{key: measured[s][key] for key in keys + ("bound_by",)}}
                for name, s in zip(CONV_EXPLICIT, conv_explicit)]
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
    if sys.argv[1:2] == ["--llm"]:
        sys.exit(llm_main())
    if sys.argv[1:2] == ["--train"]:
        sys.exit(train_main())
    if sys.argv[1:2] == ["--launch"]:
        sys.exit(launch_main())
    if sys.argv[1:2] == ["--a2a"]:
        sys.exit(a2a_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--launch-ref"]:
        sys.exit(launch_ref_main(sys.argv[2:]))
    sys.exit(main())
