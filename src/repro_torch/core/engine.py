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

Bucket executables: ``predict_q`` accepts inputs with one extra leading
batch dimension. Each batch runs in its power-of-two bucket, whose
executable (:meth:`CompiledModel.compile_batched`, the counterpart of the
reference's AOT bucket executables) is built once: on CUDA the batched
forward captured as one CUDA graph over static device buffers in the
staged entry layout (``entry_shape``), so a bucket call is one graph
replay between two copies; on the CPU the eager batched function. Rows are
staged into pooled host buffers (pinned on CUDA) that are born in the
physical entry layout and zero outside the rows in use, so the bucket
zero-fill and the entry lane pad cost nothing; rows are bit-identical to
batch-1 calls. ``predict_q_many`` chunks large batches on bucket
boundaries; ``staged_infer`` is the serving flush's zero-allocation path.

Degradation chain: :meth:`CompiledModel.routes` lists the routes a model
can serve, primary first (``"kernels"`` → ``"compiled"`` → ``"reference"``;
serving's port maps the reference's ``"pallas"`` to ``"kernels"``), and
:meth:`CompiledModel.predict_q_routed` runs a batch on any of them with
bit-identical rows.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.obs.trace import engine_event, engine_span
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
        inputs may arrive in ``entry_shape`` layout or logical."""
        g = self.graph
        run = R.run_batched if batched else R.run_compiled
        layouts = self.layout.layouts if self.layout is not None else {}
        lead = (slice(None),) if batched else ()
        ctxs = [R.OpContext(g, op, i, folded=self.folded.get(i),
                            use_kernels=self.use_kernels,
                            n_pages=self.paged.get(i), layout=layouts.get(i),
                            bounds=self.bounds.get(i))
                for i, op in enumerate(g.ops)]
        consts = self.consts

        def fn(*inputs):
            env = dict(zip(g.inputs, inputs))

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

    def run(self, bufs, rows: int) -> tuple:
        return tuple(o[:rows].numpy().copy() for o in self._fn(*bufs))


class _GraphBucket:
    """A bucket's executable on CUDA: the batched forward captured as one
    CUDA graph over static device inputs of the staged entry layout, with
    static (contiguous) outputs and pinned host buffers for them.

    The forward runs once eagerly on the capture stream first (kernel
    libraries loaded, library handles made), then is captured on that
    private stream with ``capture_error_mode="thread_local"``, so serving
    threads that launch work meanwhile do not break the capture. The
    static buffers are shared by every call of the bucket, so a call holds
    ``lock`` from the copy in until its rows are back on the host.
    ``launches`` counts the kernel-wrapper calls the graph holds (made
    during the capture; a replay calls no wrapper)."""

    def __init__(self, fn, shapes, dtypes, device, pool, stream):
        from repro_torch.kernels import launch_counts
        self.lock = threading.Lock()
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
        with torch.cuda.graph(self.graph, pool=pool, stream=capture,
                              capture_error_mode="thread_local"):
            self.outputs = tuple(o.contiguous() for o in fn(*self.inputs))
        self.launches = {k: v - before[k]
                         for k, v in launch_counts().items()}
        self.host = tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                          for o in self.outputs)
        self.done = torch.cuda.Event()

    def run(self, bufs, rows: int) -> tuple:
        with self.lock, torch.cuda.stream(self.stream):
            for dst, src in zip(self.inputs, bufs):
                dst.copy_(src, non_blocking=True)
            self.graph.replay()
            for h, o in zip(self.host, self.outputs):
                h[:rows].copy_(o[:rows], non_blocking=True)
            self.done.record(self.stream)
            self.done.synchronize()
            return tuple(h[:rows].numpy().copy() for h in self.host)


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

    Thread-safety: the bucket executables fill under ``_compile_lock``
    with a double-checked lookup, so concurrent ``predict_q_many`` calls
    on a cold bucket build it exactly once (warm lookups take no lock);
    a bucket's call holds that bucket's lock. The staging pool checks out
    and returns buffer sets under ``_staging_lock``. Every fill is recorded
    twice: the monotone ``compile_events`` counter (after warm-up it must
    not move on the serving path) and the typed ``compile_log``
    (``{"kind": "bucket", "cache": None, "bucket": b}``, plus the
    kernel-wrapper calls the graph holds, ``"launches"``, on CUDA).
    """

    def __init__(self, g: G.Graph, use_kernels: bool = True,
                 layout_plan: bool = True, device="cuda",
                 paged: Optional[dict] = None):
        self.exec_plan = ExecutionPlan.build(g, use_kernels, layout_plan,
                                             device, paged)
        self._fn = self.exec_plan.lower()
        self._batched_fn = self.exec_plan.lower(batched=True)
        self._fallback = None   # use_kernels=False sibling ("compiled")
        self._reference = None  # Interpreter ("reference")
        self._lock = threading.Lock()  # lazy routes; the arena is stateful
        self._compile_lock = threading.Lock()  # guards bucket fills
        self._buckets: dict = {}  # bucket size -> executable
        # one graph memory pool and one replay stream for all of this
        # model's buckets (made at the first capture): replays on one
        # stream never overlap, so the buckets can share scratch memory
        self._pool = None
        self._stream = None
        # Pooled host staging buffers (pinned on CUDA) for the batched path:
        # bucket -> [tuple of per-input tensors], each born in the bucket's
        # physical entry layout, ``(bucket,) + entry_shape(tid)``, and kept
        # zero outside the rows in use, so assembling a flush is a row
        # copy, never an allocation or a pad.
        self._staging: dict = {}
        self._staging_lock = threading.Lock()
        self._staging_cap = 4   # buffer sets kept per bucket
        # Monotone count of staging-buffer allocations: after warm-up it
        # must not move on the serving hot path.
        self.staging_events = 0
        # Monotone count of bucket-executable builds (CUDA-graph captures
        # on the card): after warm-up it must not move either.
        self.compile_events = 0
        self.compile_log: list = []

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

    # -- bucket executables ------------------------------------------------
    def _note_compile(self, kind: str, **extra) -> None:
        """Record one executable build (caller holds ``_compile_lock``) and
        make it visible to an active trace scope: a traced request paying a
        build is what the serving warm-up promises never happens."""
        self.compile_events += 1
        self.compile_log.append({"kind": kind, "cache": None, **extra})
        engine_event("compile", kind=kind, **extra)

    def compile_batched(self, batch: int):
        """The executable of ``batch``'s bucket, built once and cached,
        lowered from the shared :class:`ExecutionPlan` (layout plan
        included) over inputs in the staged entry layout. On CUDA it is one
        CUDA-graph capture; on the CPU the eager batched function."""
        bucket = bucket_for(batch)
        exe = self._buckets.get(bucket)
        if exe is not None:
            return exe
        with self._compile_lock:
            exe = self._buckets.get(bucket)
            if exe is not None:
                return exe  # built while we waited
            if self.device.type == "cuda":
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                    self._stream = torch.cuda.Stream(self.device)
                g = self.graph
                exe = _GraphBucket(
                    self._batched_fn,
                    [(bucket,) + self.exec_plan.entry_shape(t)
                     for t in g.inputs],
                    [_DTYPES[g.tensor(t).dtype] for t in g.inputs],
                    self.device, self._pool, self._stream)
                self._buckets[bucket] = exe
                self._note_compile("bucket", bucket=bucket,
                                   launches=exe.launches)
            else:
                exe = self._buckets[bucket] = _EagerBucket(self._batched_fn)
                self._note_compile("bucket", bucket=bucket)
        return exe

    def bucket_sizes(self) -> tuple:
        """Batch buckets with a built executable, sorted."""
        with self._compile_lock:
            return tuple(sorted(self._buckets))

    def warmup_batched(self, max_batch: int) -> "CompiledModel":
        """Ahead-of-serving warm-up: build every power-of-two bucket up to
        ``bucket_for(max_batch)`` (the reference's rule; the batcher passes
        ``bucket_floor(max_batch)``) and fill each bucket's staging pool to
        its cap. After this no batch of at most ``max_batch`` rows builds
        anything at request time, and up to ``_staging_cap`` flushes of one
        bucket in flight at once (an off-loop executor's workers) allocate
        nothing."""
        top = bucket_for(max_batch)
        b = 1
        while b <= top:
            self.compile_batched(b)
            b *= 2
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
        return tuple(torch.zeros((bucket,) + self.exec_plan.entry_shape(tid),
                                 dtype=_DTYPES[self.graph.tensor(tid).dtype],
                                 pin_memory=pin)
                     for tid in self.graph.inputs)

    def acquire_staging(self, bucket: int) -> tuple:
        """Check out one zero-filled staging buffer set (one host tensor per
        graph input, ``(bucket,) + entry_shape``, pinned on CUDA).
        Thread-safe; a cold checkout allocates (counted in
        ``staging_events``), a warm one reuses — ``warmup_batched``
        fills each bucket's pool so serving never allocates."""
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
        """Run the bucket executable on prestaged physical-layout buffers:
        they already ARE its entry contract (bucket zero-fill and lane pad
        included), so this is the copy in, the replay and the first
        ``rows`` rows copied out."""
        bucket = int(bufs[0].shape[0])
        exe = self.compile_batched(bucket)
        # the device span covers the replay AND the host sync — what a
        # request actually waits for
        with engine_span("device", bucket=bucket, rows=rows):
            outs = exe.run(bufs, rows)
        return _single(outs)

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
        bucket = bucket_for(n)
        bufs = self.acquire_staging(bucket)
        try:
            dst = bufs[0].numpy()
            window = tuple(slice(0, d) for d in t.shape)  # logical region
            for i, row in enumerate(rows):
                dst[(i,) + window] = np.asarray(row, t.dtype).reshape(t.shape)
            return self.predict_q_staged(bufs, n)
        finally:
            self.release_staging(bucket, bufs, n)

    # -- inference ---------------------------------------------------------
    def _is_batched(self, first_input) -> bool:
        t0 = self.graph.tensor(self.graph.inputs[0])
        return np.ndim(first_input) == len(t0.shape) + 1

    def _empty_rows(self):
        return _single(tuple(
            np.empty((0,) + tuple(self.graph.tensor(t).shape),
                     np.dtype(self.graph.tensor(t).dtype))
            for t in self.graph.outputs))

    def _to_device(self, arr, t: G.TensorSpec, shape) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr, t.dtype).reshape(shape),
                               device=self.device)

    def _predict_q_batched(self, inputs):
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
        try:
            # the rows go into buffers that are born bucket-filled and
            # lane-padded; the span marks a flush that pads its bucket
            with (engine_span("pad_stage", batch=batch) if batch < bucket
                  else contextlib.nullcontext()):
                for tid, a, buf in zip(self.graph.inputs, arrs, bufs):
                    shape = self.graph.tensor(tid).shape
                    buf.numpy()[(slice(0, batch),)
                                + tuple(slice(0, d) for d in shape)] = a
            return self.predict_q_staged(bufs, batch)
        finally:
            self.release_staging(bucket, bufs, batch)

    def predict_q(self, *inputs):
        """Graph-dtype in / graph-dtype out. Inputs may carry one extra
        leading batch dimension (routed through the bucketed batch path)."""
        if self._is_batched(inputs[0]):
            return self._predict_q_batched(inputs)
        args = [self._to_device(arr, self.graph.tensor(tid),
                                self.graph.tensor(tid).shape)
                for tid, arr in zip(self.graph.inputs, inputs)]
        return _single(tuple(o.cpu().numpy() for o in self._fn(*args)))

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
        with self._lock:
            if self._fallback is None:
                self._fallback = CompiledModel(
                    self.graph, use_kernels=False, device=self.device,
                    paged=self.paged)
        return self._fallback

    def _reference_interp(self):
        with self._lock:
            if self._reference is None:
                from .interpreter import Interpreter
                self._reference = Interpreter(self.graph, device=self.device)
        return self._reference

    def _predict_q_reference(self, inputs):
        """Row-by-row interpreter execution of a batched input. The
        interpreter's arena is reused across rows, so calls serialize."""
        arrs = [np.asarray(a) for a in inputs]
        if arrs[0].shape[0] == 0:
            return self._empty_rows()
        interp = self._reference_interp()
        rows = []
        with self._lock:
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

    def warmup_routes(self, max_batch: int) -> "CompiledModel":
        """Warm every degradation route before serving: the primary bucket
        executables (``warmup_batched``), the compiled fallback's buckets
        (when the primary is the kernel route; on the card they are
        captured too), and the reference interpreter's arena — so a breaker
        trip degrades to a route that is already built."""
        self.warmup_batched(max_batch)
        if self.use_kernels:
            self._fallback_compiled().warmup_batched(max_batch)
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
