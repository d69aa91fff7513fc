"""Compiled engine — the port of ``repro.core.engine`` (the MicroFlow
counterpart, Sec. 3.3), running on a torch device.

Everything resolved before the first inference lives in ONE object, the
:class:`ExecutionPlan`: graph + folded Eq. (4)/(7)/(10) constants +
compile-time ``LayoutPlan`` + paging map + route flag, with every constant
(weights, biases, folded constants, pre-padded kernel operands) moved to
the device once, when the plan is built. The per-call and the batched
program are both produced by :meth:`ExecutionPlan.lower`, so routing and
layout cannot drift between them. With the layout plan, kernel-routed ops exchange activations
in lane-padded layout: padding at graph entry, slicing at graph outputs and
non-kernel boundaries.

Executables: the per-call forward (:meth:`CompiledModel.compile`, the
counterpart of the reference's AOT per-call executable) and one executable
per power-of-two batch bucket (:meth:`CompiledModel.compile_batched`, the
counterpart of its AOT bucket executables) are each built once. On CUDA
each is the forward captured as one CUDA graph over static device buffers
of the graph inputs' logical shapes, so a call is one graph replay between
two copies; on the CPU the eager function. ``predict_q`` accepts inputs
with one extra leading batch dimension, run in their bucket. Rows are
staged into pooled host buffers (pinned on CUDA) of the logical shape
``(bucket,) + t.shape``, zero outside the rows in use, so the bucket
zero-fill costs nothing and only the real rows cross to the device; the
entry lane pad of the layout plan runs inside the bucket's forward, on the
device. Rows are bit-identical to batch-1 calls. ``predict_q_many`` chunks
large batches on bucket boundaries; ``staged_infer`` is the serving
flush's zero-allocation path.

Persistence: ``warmup_batched(cache=...)`` consults a
:class:`repro_torch.serve.aotcache.AotCache`. A CUDA graph cannot be
stored, so a verified hit loads the kernel libraries and captures every
recorded bucket again, each capture checked against its record
(:meth:`CompiledModel.install_cached_executables`): no nvcc runs and no
build is counted in ``compile_events``; every capture, cold or warm, is
counted in ``capture_events``.

Degradation chain: :meth:`CompiledModel.routes` lists the routes a model
can serve, primary first (``"kernels"`` → ``"compiled"`` → ``"reference"``;
serving's port maps the reference's ``"pallas"`` to ``"kernels"``), and
:meth:`CompiledModel.predict_q_routed` runs a batch on any of them with
bit-identical rows.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import threading
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.obs.trace import (end_call, engine_call, engine_event,
                                   engine_span)
from . import graph as G
from . import registry as R
from .device import resolve_device
from .memory import memory_report
from .ops_ref import fused_bounds_f32
from .preprocess import LayoutPlan, plan_layout, preprocess_graph


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Everything resolved at compile time, in one object, with every
    constant already on ``device``."""

    graph: G.Graph
    folded: dict                  # op index -> FoldedConsts (device tensors)
    layout: Optional[LayoutPlan]  # device tensors; None without the plan
    paged: dict                   # op index -> n_pages (Sec. 4.3)
    use_kernels: bool
    device: torch.device
    consts: dict                  # const tensor id -> device tensor
    bounds: dict                  # paged op index -> float32 (lo, hi)

    @classmethod
    def build(cls, g: G.Graph, use_kernels: bool = True,
              layout_plan: bool = True, device="cuda",
              paged: Optional[dict] = None) -> "ExecutionPlan":
        """Fold, plan and move every constant to ``device``. On a CUDA
        device the kernel route first probes the card
        (``kernels.ops.can_launch_kernels``) and raises with its reason."""
        from repro_torch.kernels.qmatmul import QUANTUM
        g.validate()
        dev = resolve_device(device)
        if use_kernels and dev.type == "cuda":
            from repro_torch.kernels.ops import can_launch_kernels
            ok, reason = can_launch_kernels()
            if not ok:
                raise RuntimeError(f"the kernel route cannot run on {dev}: "
                                   f"{reason}")
        folded = preprocess_graph(g)  # compile-time parser phase, on the host
        paged = dict(paged or {})
        # the kernel route's layout, at the qmatmul kernel's lane quantum (on
        # every device, so the CPU walks the layout the card does)
        layout = (plan_layout(g, folded, quantum=QUANTUM, paged=paged).to(dev)
                  if (use_kernels and layout_plan) else None)
        consts = {tid: torch.as_tensor(t.data, device=dev)
                  for tid, t in enumerate(g.tensors) if t.is_const}
        bounds = {i: fused_bounds_f32(folded[i],
                                      g.ops[i].attrs.get("fused", "NONE"))
                  for i in paged if i in folded}
        return cls(g, {i: fc.to(dev) for i, fc in folded.items()}, layout,
                   paged, use_kernels, dev, consts, bounds)

    def entry_shape(self, tid) -> tuple:
        """Per-sample physical shape graph input ``tid`` is staged in on the
        batched path: lane-padded when a planned kernel op consumes it,
        logical otherwise."""
        if self.layout is not None:
            phys = self.layout.entry_phys.get(tid)
            if phys is not None:
                return tuple(phys)
        return tuple(self.graph.tensor(tid).shape)

    def lower(self, batched: bool = False):
        """Returns fn(*device_inputs) -> tuple(device_outputs).

        With ``batched=True`` every activation carries one extra leading
        batch dimension and ops run through their registry batch rules;
        inputs may arrive in ``entry_shape`` layout or logical. A logical
        input whose entry layout is lane-padded is padded once, on entry
        (the staged pad of the reference, inside the forward), so every
        planned consumer reads the same padded value."""
        g = self.graph
        run = R.run_batched if batched else R.run_compiled
        layouts = self.layout.layouts if self.layout is not None else {}
        lead = (slice(None),) if batched else ()
        # graph input -> lanes of its entry pad on the batched path
        entry_pad = ({tid: self.entry_shape(tid)[-1] - g.tensor(tid).shape[-1]
                      for tid in g.inputs
                      if self.entry_shape(tid) != tuple(g.tensor(tid).shape)}
                     if batched else {})
        ctxs = [R.OpContext(g, op, i, folded=self.folded.get(i),
                            use_kernels=self.use_kernels,
                            n_pages=self.paged.get(i), layout=layouts.get(i),
                            bounds=self.bounds.get(i))
                for i, op in enumerate(g.ops)]
        consts = self.consts

        def fn(*inputs):
            env = dict(zip(g.inputs, inputs))
            for tid, lanes in entry_pad.items():
                if tuple(env[tid].shape[1:]) == g.tensor(tid).shape:
                    env[tid] = F.pad(env[tid], (0, lanes))

            def val(tid, keep_padded=False):
                if tid in consts:
                    return consts[tid]
                v = env[tid]
                shape = g.tensor(tid).shape
                # padded values advertise themselves by shape; consumers
                # outside the planned region get the logical view
                if not keep_padded and tuple(v.shape[len(lead):]) != shape:
                    v = v[lead + tuple(slice(0, d) for d in shape)]
                return v

            for ctx in ctxs:
                env[ctx.op.outputs[0]] = run(
                    ctx, [val(t, keep_padded=ctx.layout is not None)
                          for t in ctx.op.inputs])
            return tuple(val(t) for t in g.outputs)

        return fn


def cost_of_plan(plan, batch: Optional[int] = None) -> dict:
    """The work of one forward of ``plan``'s graph, counted from the graph
    and not from a route's lowering, so the plain, kernel (with or without
    the layout plan) and paged routes, on the CPU or the card, all give the
    same dict — the port of the reference's ``cost_analysis()`` keys:

    ``"flops"``
        Products only, 2 per multiply-add at the graph's shapes:
        FULLY_CONNECTED ``2·M·K·N``, CONV_2D ``2·B·OH·OW·KH·KW·Cin·Cout``,
        DEPTHWISE_CONV_2D ``2·B·OH·OW·KH·KW·C``. Pools, adds, activations,
        pads, reshapes and the requant epilogue add nothing (XLA's
        ``flops`` also counts elementwise ops; the dry run's FLOPs do not).
    ``"bytes accessed"``
        Each op reads each of its operands once (weights and bias
        included) and writes its output once, at the stored dtype (int8
        activations and weights, int32 biases; float32 in a float graph).
        RESHAPE is a view and moves nothing. The folded constants of
        Eqs. (4)/(7)/(10), the kernels' pads to their lane quantum, the
        im2col copies and the paged route's page slices are how a route
        implements an op, and are left out.
    ``"transcendentals"``
        One ``exp`` per element of each SOFTMAX input.

    ``batch=None`` counts the per-call forward at the graph's shapes;
    ``batch=b`` the forward of bucket ``b``: every activation carries ``b``
    rows of its graph shape, and a weight counts once at any batch. An op
    kind with no cost rule raises: the count is never a partial sum."""
    g = plan.graph
    lead = () if batch is None else (int(batch),)

    def spec(tid):
        t = g.tensor(tid)
        return t if t.is_const or not lead else \
            G.TensorSpec(t.name, lead + t.shape, t.dtype)

    total = {"flops": 0, "bytes accessed": 0, "transcendentals": 0}
    for op in g.ops:
        rule = R.get(op.op).cost
        if rule is None:
            raise NotImplementedError(f"op {op.op!r} has no cost rule")
        for k, v in rule(op, [spec(t) for t in op.inputs],
                         spec(op.outputs[0])).items():
            total[k] += v
    return total


def bucket_for(batch: int) -> int:
    """Power-of-two shape bucket (``bucket_for(0) == bucket_for(1) == 1``;
    negative batches raise)."""
    if batch < 0:
        raise ValueError(f"batch must be >= 0, got {batch}")
    return 1 << int(max(1, batch) - 1).bit_length()


def bucket_floor(batch: int) -> int:
    """Largest power-of-two bucket <= ``batch`` (>= 1): the chunk size that
    fills a bucket exactly instead of padding past it."""
    if batch < 0:
        raise ValueError(f"batch must be >= 0, got {batch}")
    return 1 << (max(1, int(batch)).bit_length() - 1)


def dispatched_bucket_rows(batch: int, max_batch: Optional[int] = None) -> int:
    """Total bucket rows ``predict_q_many(batch, max_batch=...)`` dispatches:
    full ``bucket_floor(max_batch)`` chunks are exact, only the tail pads to
    its own bucket; an empty batch dispatches nothing."""
    if batch == 0:
        return 0
    if max_batch is None:
        return bucket_for(batch)
    step = bucket_floor(max_batch)
    if batch <= step:
        return bucket_for(batch)
    full, rem = divmod(batch, step)
    return full * step + (bucket_for(rem) if rem else 0)


def _single(outs):
    return outs if len(outs) > 1 else outs[0]


_DTYPES = {"int8": torch.int8, "int32": torch.int32,
           "float32": torch.float32}


class _EagerBucket:
    """A bucket's executable on the CPU: the eager batched function."""

    def __init__(self, fn):
        self._fn = fn

    def run(self, bufs, rows: int, call=None) -> tuple:
        if call is not None:
            call.lap("engine.launch")
        outs = self._fn(*bufs)
        if call is not None:
            call.lap("engine.unstage")
        return tuple(o[:rows].numpy().copy() for o in outs)


@contextlib.contextmanager
def _no_collection():
    """Python's cyclic collector off for a CUDA-graph capture. A collection
    inside the capture can free a dead engine's graph, and destroying a
    graph (or freeing its memory pool) while a stream captures is not
    permitted: the capture is invalidated. ``torch.cuda.graph`` no longer
    collects before it captures, so the garbage waits until after."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class _GraphExecutable:
    """An executable on CUDA: a forward (the per-call one, or a bucket's
    batched one) captured as one CUDA graph over static device inputs of
    the graph inputs' logical shapes, with static (contiguous) outputs and
    pinned host buffers for them.

    The forward runs once eagerly on the capture stream first (kernel
    libraries loaded, library handles made), then is captured on that
    private stream with ``capture_error_mode="thread_local"``, so serving
    threads that launch work meanwhile do not break the capture.

    Every graph of a model lives in the model's one memory pool, and a
    later capture may place its outputs in blocks an earlier one used as
    scratch: replaying the earlier graph between a later graph's replay
    and the read of its outputs would overwrite them. So every call holds
    ``lock``, the MODEL's lock (shared by all its graphs), from the copy in
    until the rows are back on the host; the replays serialize on the
    model's one stream anyway. ``launches`` counts the kernel-wrapper calls
    the graph holds (made during the capture; a replay calls no wrapper).
    ``note_h2d(copies, nbytes)`` is told of each call's host-to-device
    copies, under the lock. ``call`` (a :class:`repro_torch.obs.trace.Lap`,
    or None untraced) is lapped into ``engine.launch`` before the lock is
    taken, ``engine.sync`` once the output copies are issued and
    ``engine.unstage`` once the card is done."""

    def __init__(self, fn, shapes, dtypes, device, pool, stream, lock,
                 note_h2d):
        from repro_torch.kernels import launch_counts
        self.lock = lock
        self.note_h2d = note_h2d
        self.stream = stream
        self.inputs = tuple(torch.zeros(s, dtype=d, device=device)
                            for s, d in zip(shapes, dtypes))
        capture = torch.cuda.Stream(device)
        capture.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(capture):
            fn(*self.inputs)
        torch.cuda.current_stream(device).wait_stream(capture)
        self.graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        with _no_collection(), torch.cuda.graph(
                self.graph, pool=pool, stream=capture,
                capture_error_mode="thread_local"):
            self.outputs = tuple(o.contiguous() for o in fn(*self.inputs))
        self.launches = {k: v - before[k]
                         for k, v in launch_counts().items()}
        self.host = tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                          for o in self.outputs)
        self.done = torch.cuda.Event()

    def run(self, bufs, rows: Optional[int] = None, call=None) -> tuple:
        """Copy ``bufs`` in, replay, and return the outputs (their first
        ``rows`` rows on a bucket's graph) as fresh numpy arrays."""
        window = slice(None) if rows is None else slice(0, rows)
        if call is not None:
            call.lap("engine.launch")
        with self.lock, torch.cuda.stream(self.stream):
            copies = nbytes = 0
            for dst, src in zip(self.inputs, bufs):
                if src.device.type != "cuda":
                    copies += 1
                    nbytes += src.numel() * src.element_size()
                dst.copy_(src, non_blocking=True)
            self.note_h2d(copies, nbytes)
            self.graph.replay()
            for h, o in zip(self.host, self.outputs):
                h[window].copy_(o[window], non_blocking=True)
            if call is not None:
                call.lap("engine.sync")
            self.done.record(self.stream)
            self.done.synchronize()
            if call is not None:
                call.lap("engine.unstage")
            return tuple(h[window].numpy().copy() for h in self.host)


class CompiledModel:
    """The user-facing ``predict()`` of a quantized graph on a torch device.

    ``use_kernels`` — the counterpart of the reference's ``use_pallas``:
    route quantized FullyConnected / Conv2D / DepthwiseConv (and the float
    FullyConnected product) through the hand-written CUDA kernels
    (``repro_torch.kernels``; their plain PyTorch versions on
    ``device="cpu"``). ``False`` runs the plain folded route.
    ``layout_plan`` — on by default; ``False`` keeps the per-call pad/slice
    route of the kernel wrappers. ``paged`` — ``{op_index: n_pages}``: run
    those FullyConnected layers page by page (Sec. 4.3), on the
    ``paged_qmatmul`` kernel with ``use_kernels`` on the card, bounding
    resident weight bytes; outputs are bit-identical. ``device`` —
    ``"cuda"`` by default; raises when CUDA is absent instead of moving to
    the CPU.

    Results are numpy arrays in the graph's dtypes.

    Thread-safety, as in the reference: every lazy build (the per-call and
    bucket executables, the compiled fallback, the reference interpreter)
    fills under ``_compile_lock`` with a double-checked lookup, so racing
    callers build it exactly once (warm lookups take no lock); the
    interpreter's row loop holds ``_ref_lock`` alone. On CUDA every call of
    a captured graph holds the model's ``_replay_lock`` (see
    :class:`_GraphExecutable`), and so does every capture. The staging pool
    checks out and returns buffer sets under ``_staging_lock``. Every
    executable made is counted in the monotone ``capture_events`` (a
    CUDA-graph capture on the card, the eager function bound on the CPU),
    and logged in the typed ``compile_log`` (``{"kind": "bucket", "cache":
    ..., "bucket": b}`` or ``{"kind": "percall", "cache": ...}``, plus the
    kernel-wrapper calls the graph holds, ``"launches"``, on CUDA). A build
    that no verified cache served also moves ``compile_events`` (``cache``
    None, or ``"miss"`` inside a cache-backed warm-up); one made from a
    cache record is logged ``"hit"`` and moves only ``capture_events`` and
    ``cache_events``. After warm-up none of these moves on the serving
    path; the monotone ``h2d_copies`` / ``h2d_bytes`` do: every call of a
    captured graph adds the graph inputs it copies from the host.

    ``tracer`` (a :class:`repro_torch.obs.trace.Tracer`, None by default;
    ``ServingRegistry.register`` binds the registry's) receives the
    counted spans of every engine call made outside a flush's trace scope
    (``engine.stage`` / ``launch`` / ``sync`` / ``unstage``, see
    :mod:`repro_torch.obs.trace`); inside a scope they go to the flush.
    With neither, a call reads no clock for tracing.
    """

    def __init__(self, g: G.Graph, use_kernels: bool = True,
                 layout_plan: bool = True, device="cuda",
                 paged: Optional[dict] = None):
        self.exec_plan = ExecutionPlan.build(g, use_kernels, layout_plan,
                                             device, paged)
        self._fn = self.exec_plan.lower()
        self._batched_fn = self.exec_plan.lower(batched=True)
        self._percall = None    # the per-call executable
        self._fallback = None   # use_kernels=False sibling ("compiled")
        self._reference = None  # Interpreter ("reference")
        self._ref_lock = threading.Lock()  # the interpreter's arena
        self._compile_lock = threading.Lock()  # guards every lazy build
        self._buckets: dict = {}  # bucket size -> executable
        # one graph memory pool, one replay stream and one lock for all of
        # this model's graphs (made at the first capture)
        self._pool = None
        self._stream = None
        self._replay_lock = threading.Lock()
        # Pooled host staging buffers (pinned on CUDA) for the batched path:
        # bucket -> [tuple of per-input tensors], each of the logical shape
        # ``(bucket,) + t.shape`` and kept zero outside the rows in use, so
        # assembling a flush is a row copy, never an allocation.
        self._staging: dict = {}
        self._staging_lock = threading.Lock()
        self._staging_cap = 4   # buffer sets kept per bucket
        # Monotone count of staging-buffer allocations: after warm-up it
        # must not move on the serving hot path.
        self.staging_events = 0
        # Monotone count of executable builds that no verified cache served:
        # after warm-up it must not move either, and a warm boot leaves it 0.
        self.compile_events = 0
        # Monotone count of executables made, cold or from a cache record
        # (CUDA-graph captures on the card).
        self.capture_events = 0
        # Monotone counts of the host-to-device copies of graph inputs that
        # the captured graphs' calls made, and their bytes (an input
        # already on the card is not copied from the host; the CPU makes
        # none).
        self.h2d_copies = 0
        self.h2d_bytes = 0
        self.compile_log: list = []
        # persistent-cache interactions, the outcome of the last cache-backed
        # warm-up, and the tag of builds inside a cache-backed cold warm-up
        self.cache_events = {"hit": 0, "miss": 0, "store": 0}
        self.last_cache_result = None
        self._cache_mode: Optional[str] = None
        self.tracer = None

    @property
    def graph(self) -> G.Graph:
        return self.exec_plan.graph

    @property
    def device(self) -> torch.device:
        return self.exec_plan.device

    @property
    def use_kernels(self) -> bool:
        return self.exec_plan.use_kernels

    @property
    def paged(self) -> dict:
        return self.exec_plan.paged

    @property
    def plan(self) -> Optional[LayoutPlan]:
        return self.exec_plan.layout

    def memory_report(self):
        return memory_report(self.graph)

    # -- executables -------------------------------------------------------
    def _note_compile(self, kind: str, **extra) -> None:
        """Record one executable build that no cache served (caller holds
        ``_compile_lock``) and make it visible to an active trace scope: a
        traced request paying a build is what the serving warm-up promises
        never happens."""
        cache = self._cache_mode
        self.compile_events += 1
        if cache is not None:
            self.cache_events[cache] += 1
        self.compile_log.append({"kind": kind, "cache": cache, **extra})
        attrs = {"cache": cache, **extra} if cache is not None else extra
        engine_event("compile", kind=kind, **attrs)

    def _note_cache_event(self, kind: str, cache: str, **extra) -> None:
        """Record one persistent-cache interaction that is not a build (a
        capture from a record, a store): ``compile_events`` does not
        move."""
        self.cache_events[cache] += 1
        self.compile_log.append({"kind": kind, "cache": cache, **extra})
        engine_event("compile_cache", kind=kind, cache=cache, **extra)

    def _make_executable(self, bucket: Optional[int]):
        """The per-call executable (``bucket`` None) or ``bucket``'s: on
        CUDA the forward captured as a CUDA graph, on the CPU the eager
        function. Counted in ``capture_events`` (caller holds
        ``_compile_lock``)."""
        self.capture_events += 1
        if self.device.type == "cuda":
            if bucket is None:
                return self._capture(self._fn, ())
            return self._capture(self._batched_fn, (bucket,))
        return self._fn if bucket is None else _EagerBucket(self._batched_fn)

    @staticmethod
    def _launch_attrs(exe) -> dict:
        return ({"launches": exe.launches}
                if isinstance(exe, _GraphExecutable) else {})

    def _capture(self, fn, lead: tuple) -> _GraphExecutable:
        """Capture ``fn`` over static inputs of shape ``lead + t.shape`` into
        the model's pool (caller holds ``_compile_lock``)."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        g = self.graph
        with self._replay_lock:
            return _GraphExecutable(
                fn, [lead + tuple(g.tensor(t).shape) for t in g.inputs],
                [_DTYPES[g.tensor(t).dtype] for t in g.inputs], self.device,
                self._pool, self._stream, self._replay_lock, self._note_h2d)

    def _note_h2d(self, copies: int, nbytes: int) -> None:
        """Count one call's host-to-device copies (caller holds the model's
        ``_replay_lock``)."""
        self.h2d_copies += copies
        self.h2d_bytes += nbytes

    def compile(self):
        """The per-call executable, built once (the reference's AOT
        ``compile()``): on CUDA the per-call forward captured as one CUDA
        graph over logical-shape inputs, in the model's pool; on the CPU the
        eager per-call function. Logged as ``"percall"`` either way."""
        exe = self._percall
        if exe is not None:
            return exe
        with self._compile_lock:
            if self._percall is None:
                exe = self._make_executable(None)
                self._note_compile("percall", **self._launch_attrs(exe))
                self._percall = exe
            return self._percall

    @property
    def executable(self):
        return self.compile()

    def cached_percall(self):
        """The per-call executable when built, else None."""
        with self._compile_lock:
            return self._percall

    def compile_batched(self, batch: int):
        """The executable of ``batch``'s bucket, built once and cached,
        lowered from the shared :class:`ExecutionPlan` (layout plan
        included) over logical-shape inputs, the entry lane pad inside. On
        CUDA it is one CUDA-graph capture; on the CPU the eager batched
        function."""
        bucket = bucket_for(batch)
        exe = self._buckets.get(bucket)
        if exe is not None:
            return exe
        with self._compile_lock:
            exe = self._buckets.get(bucket)
            if exe is not None:
                return exe  # built while we waited
            exe = self._buckets[bucket] = self._make_executable(bucket)
            self._note_compile("bucket", bucket=bucket,
                               **self._launch_attrs(exe))
        return exe

    def bucket_sizes(self) -> tuple:
        """Batch buckets with a built executable, sorted."""
        with self._compile_lock:
            return tuple(sorted(self._buckets))

    def cached_bucket(self, bucket: int):
        """The built executable of ``bucket`` (KeyError when cold)."""
        with self._compile_lock:
            return self._buckets[bucket]

    def cached_stage_pads(self) -> dict:
        """Always ``{}``: the port has no staged-pad executable. A batch's
        bucket fill is the zero rows of its staging buffer and its entry
        lane pad runs inside its bucket's executable, so nothing of it is
        stored apart from the bucket (``staged_pad_keys`` lists the keys
        the built buckets cover)."""
        return {}

    # -- persistent-cache hooks (repro_torch.serve.aotcache) ---------------
    def _record(self, exe, bucket: Optional[int]) -> dict:
        """What a capture record holds for ``exe``: route, device, input
        and output shapes and dtypes, and on CUDA the kernel-wrapper calls
        the graph holds. On the CPU the shapes are the graph's, which the
        eager function returns by construction."""
        g = self.graph
        lead = () if bucket is None else (bucket,)

        def specs(tids):
            return [[list(lead + tuple(g.tensor(t).shape)), g.tensor(t).dtype]
                    for t in tids]

        rec = {"kind": "percall" if bucket is None else "bucket",
               "bucket": bucket, "route": self.routes()[0],
               "device": self.device.type,
               "inputs": specs(g.inputs), "outputs": specs(g.outputs)}
        if isinstance(exe, _GraphExecutable):
            def tensors(ts):
                return [[list(t.shape), str(t.dtype).removeprefix("torch.")]
                        for t in ts]
            rec.update(inputs=tensors(exe.inputs), outputs=tensors(exe.outputs),
                       launches=dict(sorted(exe.launches.items())))
        return rec

    def capture_record(self, bucket: Optional[int] = None) -> dict:
        """The capture record of ``bucket``'s executable, or of the
        per-call one when ``bucket`` is None (KeyError / ValueError when it
        is not built) — what the cache stores in place of a graph."""
        exe = self.cached_bucket(bucket) if bucket is not None \
            else self.cached_percall()
        if exe is None:
            raise ValueError("the per-call executable is not built")
        return self._record(exe, bucket)

    def _check_record(self, record: dict, exe, bucket: Optional[int]) -> None:
        got = json.loads(json.dumps(self._record(exe, bucket)))
        if got != record:
            diff = sorted(k for k in set(got) | set(record)
                          if got.get(k) != record.get(k))
            raise ValueError(f"{got['kind']} {bucket}: the capture differs "
                             f"from its record in {diff}")

    def install_cached_executables(self, buckets: dict, *,
                                   percall=None) -> int:
        """The warm boot's install step, once the cache has loaded the
        kernel libraries (no nvcc): make the executable of every bucket in
        ``buckets`` (bucket -> capture record) not yet built, and the
        per-call one when ``percall`` (its record) is given, and check each
        against its record. All or nothing: a failed capture or a capture
        unlike its record raises, and the model keeps none of them. Each
        executable kept is logged as a ``"hit"`` and moves
        ``capture_events``, never ``compile_events``. Returns the number
        kept."""
        with self._compile_lock:
            made = {}
            for b, rec in sorted(buckets.items()):
                if b not in self._buckets:
                    made[b] = self._make_executable(b)
                    self._check_record(rec, made[b], b)
            pc = None
            if percall is not None and self._percall is None:
                pc = self._make_executable(None)
                self._check_record(percall, pc, None)
            for b, exe in made.items():
                self._buckets[b] = exe
                self._note_cache_event("bucket", "hit", bucket=b,
                                       **self._launch_attrs(exe))
            if pc is not None:
                self._percall = pc
                self._note_cache_event("percall", "hit",
                                       **self._launch_attrs(pc))
            return len(made) + (pc is not None)

    def _entry_widths(self, tid, batch: int) -> tuple:
        """Per-dimension (0, pad) widths that stage one batched input: the
        bucket fill on the batch dim and the planned entry lane pad (the
        reference's ``_entry_widths``)."""
        t = self.graph.tensor(tid)
        return ((0, bucket_for(batch) - batch),) + tuple(
            (0, p - d) for p, d in zip(self.exec_plan.entry_shape(tid),
                                       t.shape))

    def staged_pad_keys(self) -> tuple:
        """(shape, widths) staging keys the built buckets cover, sorted —
        the reference's staged-pad cache keys, for the no-retrace auditor
        (``repro_torch.analysis.retrace``). The port has no separate stage
        executable: a batch's bucket fill is the zero rows of its staging
        buffer and its lane pad runs inside its bucket's executable, so a
        batch is covered exactly when its bucket is built. A key is listed
        for every batch whose bucket is built and whose widths are not all
        zero, as the reference lists the pads it compiled."""
        keys = set()
        for b in self.bucket_sizes():
            for batch in range(b // 2 + 1, b + 1):
                for tid in self.graph.inputs:
                    widths = self._entry_widths(tid, batch)
                    if any(w for _, w in widths):
                        keys.add(((batch,) + tuple(self.graph.tensor(tid).shape),
                                  widths))
        return tuple(sorted(keys))

    def memory_analysis(self) -> dict:
        """What the card can tell of this model's memory, after the
        per-call executable is built (as the reference's
        ``memory_analysis`` compiles it first): ``graph_pool_bytes``, the
        bytes of the segments the caching allocator holds for the model's
        graph pool (``torch.cuda.memory._snapshot``), what its captures
        drew; ``memory_reserved_bytes`` (``torch.cuda.memory_reserved``,
        the whole process) and ``captures``. ``{}`` on the CPU, which has
        no graph pool."""
        self.compile()
        if self.device.type != "cuda":
            return {}
        with self._compile_lock:
            captures = 1 + len(self._buckets)
            pool = tuple(self._pool)
        segments = torch.cuda.memory._snapshot(self.device)["segments"]
        return {"graph_pool_bytes": int(sum(
                    seg["total_size"] for seg in segments
                    if tuple(seg.get("segment_pool_id", ())) == pool)),
                "memory_reserved_bytes":
                    int(torch.cuda.memory_reserved(self.device)),
                "captures": captures}

    def cost_analysis(self) -> dict:
        """The per-call forward's ``"flops"``, ``"bytes accessed"`` and
        ``"transcendentals"``, as the reference's ``cost_analysis`` reports
        XLA's count of its per-call executable, but counted from the graph
        (:func:`cost_of_plan`, which states the rules and counts a bucket):
        the same on every route and device, with no build or capture."""
        return cost_of_plan(self.exec_plan)

    def warmup_batched(self, max_batch: int, *,
                       cache=None) -> "CompiledModel":
        """Ahead-of-serving warm-up: build every power-of-two bucket up to
        ``bucket_for(max_batch)`` (the reference's rule; the batcher passes
        ``bucket_floor(max_batch)``) and fill each bucket's staging pool to
        its cap. After this no batch of at most ``max_batch`` rows builds
        anything at request time, and up to ``_staging_cap`` flushes of one
        bucket in flight at once (an off-loop executor's workers) allocate
        nothing.

        ``cache`` (a :class:`repro_torch.serve.aotcache.AotCache`) makes it
        load-or-build-and-store, as in the reference: a verified hit makes
        every bucket not yet built from its record (``compile_events``
        stays put); a miss builds those (logged ``"miss"``) and stores
        every bucket, built before or now. The outcome lands in
        ``last_cache_result`` (after a miss: the store's, with the miss's
        reason and findings).

        Builds run one after another: the reference's ``parallel`` /
        ``workers`` thread pool is not ported, since builds take the
        model's compile lock one at a time (captures share one pool and
        stream). Racing warm-ups still build each bucket once."""
        top = bucket_for(max_batch)
        buckets = [1 << i for i in range(top.bit_length())]
        if cache is not None:
            miss = self.last_cache_result = cache.load(self, max_batch)
            if miss.hit:
                self._warm_staging(top)
                return self
            self._cache_mode = "miss"  # tag the cold builds below
        try:
            for b in buckets:
                self.compile_batched(b)
        finally:
            self._cache_mode = None
        if cache is not None:
            stored = cache.store(self, max_batch)
            # the boot's outcome keeps why the load missed
            self.last_cache_result = dataclasses.replace(
                stored, reason=f"{miss.reason}; {stored.reason}",
                findings=miss.findings)
            self._note_cache_event("manifest", "store", count=stored.stored)
        self._warm_staging(top)
        return self

    def _warm_staging(self, top: int) -> None:
        b = 1
        while b <= top:
            with self._staging_lock:
                pool = self._staging.setdefault(b, [])
                while len(pool) < self._staging_cap:
                    pool.append(self._new_staging(b))
            b *= 2

    # -- pooled staging (serving fast path) --------------------------------
    def _new_staging(self, bucket: int) -> tuple:
        self.staging_events += 1
        pin = self.device.type == "cuda"
        return tuple(torch.zeros((bucket,) + tuple(self.graph.tensor(tid).shape),
                                 dtype=_DTYPES[self.graph.tensor(tid).dtype],
                                 pin_memory=pin)
                     for tid in self.graph.inputs)

    def acquire_staging(self, bucket: int) -> tuple:
        """Check out one zero-filled staging buffer set (one host tensor per
        graph input, of the logical shape ``(bucket,) + t.shape``, pinned on
        CUDA). Thread-safe; a cold checkout allocates (counted in
        ``staging_events``), a warm one reuses — ``warmup_batched`` fills
        each bucket's pool so serving never allocates."""
        with self._staging_lock:
            pool = self._staging.get(bucket)
            if pool:
                return pool.pop()
        return self._new_staging(bucket)

    def release_staging(self, bucket: int, bufs: tuple, rows: int) -> None:
        """Return a staging buffer set, re-zeroing the ``rows`` rows that
        were written, so the pool invariant (zero outside the rows in use)
        holds for the next checkout. The pool keeps at most
        ``_staging_cap`` sets per bucket; extras are dropped."""
        for b in bufs:
            b[:rows] = 0
        with self._staging_lock:
            pool = self._staging.setdefault(bucket, [])
            if len(pool) < self._staging_cap:
                pool.append(bufs)

    def predict_q_staged(self, bufs: tuple, rows: int):
        """Run the bucket executable on prestaged logical-shape buffers:
        the copy in, the replay (entry lane pad included) and the first
        ``rows`` rows copied out."""
        call = engine_call(self.tracer)
        try:
            bucket = int(bufs[0].shape[0])
            exe = self.compile_batched(bucket)
            h = None if call is None else call.handle
            if h is None:
                return _single(exe.run(bufs, rows, call))
            # the device span covers the replay AND the host sync — what a
            # request actually waits for
            t0 = h.clock.now()
            outs = exe.run(bufs, rows, call)
            h.span("device", t0, h.clock.now(), bucket=bucket, rows=rows)
            return _single(outs)
        finally:
            if call is not None:
                end_call(call)

    def staged_infer(self, rows: list):
        """Serving fast-path flush: write single-sample ``rows`` of a
        single-input graph straight into a pooled staging buffer and run
        the bucket executable on it — the zero-allocation twin of
        ``predict_q_many(np.stack(rows))`` for flushes that fit one bucket,
        with bit-identical outputs. A row that cannot be staged raises, and
        the buffer goes back to the pool clean."""
        (tid,) = self.graph.inputs  # serving contract: single-input graph
        t = self.graph.tensor(tid)
        n = len(rows)
        if n == 0:
            return self._empty_rows()
        call = engine_call(self.tracer)
        try:
            bucket = bucket_for(n)
            bufs = self.acquire_staging(bucket)
            try:
                dst = bufs[0].numpy()
                for i, row in enumerate(rows):
                    dst[i] = np.asarray(row, t.dtype).reshape(t.shape)
                return self.predict_q_staged(bufs, n)
            finally:
                self.release_staging(bucket, bufs, n)
        finally:
            if call is not None:
                end_call(call)

    # -- inference ---------------------------------------------------------
    def _is_batched(self, first_input) -> bool:
        t0 = self.graph.tensor(self.graph.inputs[0])
        return np.ndim(first_input) == len(t0.shape) + 1

    def _empty_rows(self):
        return _single(tuple(
            np.empty((0,) + tuple(self.graph.tensor(t).shape),
                     np.dtype(self.graph.tensor(t).dtype))
            for t in self.graph.outputs))

    def _predict_q_batched(self, inputs, call):
        arrs = []
        for tid, arr in zip(self.graph.inputs, inputs):
            t = self.graph.tensor(tid)
            arrs.append(np.asarray(arr, t.dtype).reshape((-1,) + t.shape))
        batch = arrs[0].shape[0]
        for a in arrs:
            if a.shape[0] != batch:
                raise ValueError(f"all inputs must share the batch dim: "
                                 f"{a.shape[0]} != {batch}")
        bucket = bucket_for(batch)
        bufs = self.acquire_staging(bucket)
        scoped = call is not None and call.handle is not None
        try:
            for tid, a, buf in zip(self.graph.inputs, arrs, bufs):
                # the span marks staging that pads, as the reference's does:
                # a bucket fill (zero rows of the buffer) or an entry lane
                # pad (inside the bucket's forward, on the device)
                with (engine_span("pad_stage", batch=batch) if scoped and any(
                        w for _, w in self._entry_widths(tid, batch))
                      else contextlib.nullcontext()):
                    buf.numpy()[:batch] = a
            return self.predict_q_staged(bufs, batch)
        finally:
            self.release_staging(bucket, bufs, batch)

    def predict_q(self, *inputs):
        """Graph-dtype in / graph-dtype out. Inputs may carry one extra
        leading batch dimension (routed through the bucketed batch path);
        one sample runs the per-call executable (:meth:`compile`, built at
        the first call)."""
        call = engine_call(self.tracer)
        try:
            if self._is_batched(inputs[0]):
                return self._predict_q_batched(inputs, call)
            exe = self.executable
            args = [torch.from_numpy(
                np.array(arr, self.graph.tensor(tid).dtype)
                .reshape(self.graph.tensor(tid).shape))
                for tid, arr in zip(self.graph.inputs, inputs)]
            if self.device.type == "cuda":
                return _single(exe.run(args, None, call))
            if call is not None:
                call.lap("engine.launch")
            outs = exe(*args)
            if call is not None:
                call.lap("engine.unstage")
            return _single(tuple(o.numpy() for o in outs))
        finally:
            if call is not None:
                end_call(call)

    def predict_q_many(self, *inputs, max_batch: Optional[int] = None):
        """Batched ``predict_q`` that splits a batch into bucket-aligned
        chunks of at most ``bucket_floor(max_batch)`` rows and concatenates
        the results; only the last chunk can pad, to its own bucket."""
        if not self._is_batched(inputs[0]):
            raise ValueError("predict_q_many requires a leading batch dim")
        if max_batch is not None and max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        batch = int(inputs[0].shape[0])
        if batch == 0:
            return self._empty_rows()
        step = None if max_batch is None else bucket_floor(max_batch)
        if step is None or batch <= step:
            return self.predict_q(*inputs)
        chunks = []
        for lo in range(0, batch, step):
            out = self.predict_q(*(a[lo:lo + step] for a in inputs))
            chunks.append(out if isinstance(out, tuple) else (out,))
        return _single(tuple(np.concatenate([c[i] for c in chunks])
                             for i in range(len(chunks[0]))))

    # -- route-selectable dispatch (serving degradation chain) -------------
    def routes(self) -> tuple:
        """Dispatch routes this model can serve, primary first:

        * ``"kernels"`` — the hand-written CUDA kernel route (only when
          built with ``use_kernels=True``; then the primary);
        * ``"compiled"`` — the plain folded route (the primary without
          kernels, otherwise the first fallback: a ``use_kernels=False``
          sibling of the same graph, paging map and device);
        * ``"reference"`` — the :class:`~repro_torch.core.interpreter.
          Interpreter`, row by row: nothing folded, shared with the other
          routes only through the op registry.

        All routes give bit-identical rows on quantized graphs."""
        return (("kernels", "compiled", "reference") if self.use_kernels
                else ("compiled", "reference"))

    def _fallback_compiled(self) -> "CompiledModel":
        if self._fallback is None:
            with self._compile_lock:
                if self._fallback is None:
                    self._fallback = CompiledModel(
                        self.graph, use_kernels=False, device=self.device,
                        paged=self.paged)
        return self._fallback

    def _reference_interp(self):
        if self._reference is None:
            with self._compile_lock:
                if self._reference is None:
                    from .interpreter import Interpreter
                    self._reference = Interpreter(self.graph,
                                                  device=self.device)
        return self._reference

    def _predict_q_reference(self, inputs):
        """Row-by-row interpreter execution of a batched input. The
        interpreter's arena is reused across rows, so calls serialize on
        ``_ref_lock`` (and on nothing else)."""
        arrs = [np.asarray(a) for a in inputs]
        if arrs[0].shape[0] == 0:
            return self._empty_rows()
        interp = self._reference_interp()
        rows = []
        with self._ref_lock:
            for i in range(arrs[0].shape[0]):
                out = interp.invoke_q(*(a[i] for a in arrs))
                rows.append(out if isinstance(out, tuple) else (out,))
        return _single(tuple(np.stack([r[i] for r in rows])
                             for i in range(len(rows[0]))))

    def predict_q_routed(self, *inputs, route: Optional[str] = None,
                         max_batch: Optional[int] = None):
        """Batched ``predict_q_many`` on an explicit route: ``None`` or the
        primary route is ``predict_q_many`` itself, ``"compiled"`` the plain
        sibling, ``"reference"`` the interpreter row by row."""
        names = self.routes()
        if route is None or route == names[0]:
            return self.predict_q_many(*inputs, max_batch=max_batch)
        if route == "compiled":
            return self._fallback_compiled().predict_q_many(
                *inputs, max_batch=max_batch)
        if route == "reference":
            return self._predict_q_reference(inputs)
        raise ValueError(f"unknown route {route!r}; available: {names}")

    def warmup_routes(self, max_batch: int, *, cache=None) -> "CompiledModel":
        """Warm every degradation route before serving: the primary bucket
        executables (``warmup_batched``), the compiled fallback's buckets
        (when the primary is the kernel route; on the card they are
        captured too), and the reference interpreter's arena — so a breaker
        trip degrades to a route that is already built. ``cache`` flows to
        both engine routes; the fallback (``use_kernels`` off) has a
        fingerprint, and so a cache entry, of its own."""
        self.warmup_batched(max_batch, cache=cache)
        if self.use_kernels:
            self._fallback_compiled().warmup_batched(max_batch, cache=cache)
        self._reference_interp()
        return self

    def predict(self, *inputs):
        """Float in / float out (TFLite-style interface), with or without a
        leading batch dimension."""
        batched = self._is_batched(inputs[0])
        qin = []
        for tid, arr in zip(self.graph.inputs, inputs):
            t = self.graph.tensor(tid)
            shape = ((-1,) + t.shape) if batched else t.shape
            arr = np.asarray(arr, np.float32).reshape(shape)
            qin.append(t.qparams.quantize(arr) if t.dtype == "int8" else arr)
        outs = self.predict_q(*qin)
        if not isinstance(outs, tuple):
            outs = (outs,)
        res = []
        for tid, o in zip(self.graph.outputs, outs):
            t = self.graph.tensor(tid)
            res.append(t.qparams.dequantize(o) if t.dtype == "int8"
                       else o.astype(np.float32))
        return _single(tuple(res))
