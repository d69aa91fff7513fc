"""Multi-model serving registry for the compiled TinyML engine — the port
of ``repro.serve.registry``.

One process serves several compiled models (the paper's sine / speech /
person trio by default), each behind its own
:class:`repro_torch.serve.scheduler.MicroBatcher`:

* **Warm-up** — ``register`` builds every power-of-two bucket executable
  up to the model's ``max_batch`` ahead of serving, each lowered from the
  model's single ``ExecutionPlan``, layout plan included: on the card one
  CUDA-graph capture per bucket (a flush is then one graph replay), on the
  CPU the eager batched function. The staging pool is filled too, so the
  first request is as fast as the millionth.
* **Shared dispatch stage** — the registry can hand every batcher one
  :class:`repro_torch.serve.executor.InferenceExecutor`. With the default
  ``InlineExecutor`` flushes run on the event loop (deterministic); with a
  shared ``ThreadPoolExecutorBackend`` flushes from *all* models
  interleave on one worker pool, so one model's device call no longer
  blocks another model's arrival processing. The registry owns the
  executor's lifecycle: ``stop()`` closes it after the batchers drain.
* **Admission control** — ``infer``/``submit`` reject unknown models
  (``KeyError``) and route each request through its model's priority
  classes: at capacity the batcher sheds by priority (lowest-priority
  pending request evicted with ``PreemptedError``) or refuses the
  newcomer with :class:`QueueFullError`. Together with the engine's
  static buffers and the joint ``pending + in_flight`` bound this keeps
  resident memory flat under overload.
* **Metrics** — per-model :class:`repro_torch.serve.metrics.ModelMetrics`
  snapshots (p50/p95/p99 latency, throughput, batch occupancy, per-class
  SLO attainment) via :meth:`snapshot`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import CompiledModel
from .executor import InferenceExecutor  # noqa: F401  (re-export)
from .metrics import ModelMetrics
from .scheduler import (Clock, ClassPolicy, MicroBatcher,  # noqa: F401
                        PreemptedError, QueueFullError)


@dataclasses.dataclass
class _Entry:
    name: str
    model: CompiledModel
    batcher: MicroBatcher


class ServingRegistry:
    """Named compiled models, each behind a dynamic micro-batcher.

    ``executor`` (optional) is shared by every registered model's batcher
    and closed by :meth:`stop`; ``executor_workers`` (optional) builds a
    shared ``ThreadPoolExecutorBackend`` of that width when no explicit
    ``executor`` is given (the ``REPRO_EXECUTOR_WORKERS`` env var sets the
    default width when neither is passed); ``classes`` (optional ``{name:
    ClassPolicy}``) is the default priority-class table each batcher
    starts from — executor and classes can be overridden per model in
    :meth:`register`.
    """

    def __init__(self, *, clock: Optional[Clock] = None, max_batch: int = 32,
                 max_delay_s: float = 0.002, max_queue: int = 256,
                 executor: Optional[InferenceExecutor] = None,
                 executor_workers: Optional[int] = None,
                 classes: Optional[dict] = None, tracer=None,
                 cache=None, cache_dir: Optional[str] = None,
                 audit_path: Optional[str] = None):
        if cache is not None or cache_dir is not None \
                or audit_path is not None:
            raise NotImplementedError(
                "the persistent executable cache (cache=, cache_dir=, "
                "audit_path=) is not ported yet: ROADMAP Queue 1 item 9")
        self.clock = clock or Clock()
        if executor is None and executor_workers is not None:
            # convenience: size the shared off-loop pool without importing
            # the backend (the env default REPRO_EXECUTOR_WORKERS applies
            # when neither is given and an explicit backend is built)
            from .executor import ThreadPoolExecutorBackend
            executor = ThreadPoolExecutorBackend(max_workers=executor_workers)
        self.executor = executor
        # one repro_torch.obs.Tracer shared by every batcher (None = off)
        self.tracer = tracer
        self._defaults = dict(max_batch=max_batch, max_delay_s=max_delay_s,
                              max_queue=max_queue, classes=classes,
                              tracer=tracer)
        self._entries: dict = {}
        self._started = False
        self._stopped = False

    # -- registration / lifecycle ----------------------------------------
    def register(self, name: str, model: CompiledModel, *,
                 warmup: bool = True, **overrides) -> CompiledModel:
        """Admit ``model`` (an int8 ``CompiledModel``) under ``name``.
        ``overrides`` replace the registry-level batcher defaults
        (``max_batch`` / ``max_delay_s`` / ``max_queue`` / ``classes`` /
        ``executor`` / ``tracer``) for this model."""
        if name in self._entries:
            raise ValueError(f"model {name!r} already registered")
        kw = {**self._defaults, "executor": self.executor, **overrides}
        batcher = MicroBatcher.for_model(
            model, warmup=warmup, name=name, clock=self.clock,
            metrics=ModelMetrics(now=self.clock.now()), **kw)
        self._entries[name] = _Entry(name, model, batcher)
        if self._started:  # late registration joins a running registry
            batcher.start()
        return model

    def models(self) -> tuple:
        return tuple(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def start(self) -> "ServingRegistry":
        if self._stopped:
            raise RuntimeError("registry is stopped (stop() is terminal); "
                               "build a new ServingRegistry")
        for e in self._entries.values():
            e.batcher.start()
        self._started = True
        return self

    @property
    def stopped(self) -> bool:
        """Whether :meth:`stop` has run (stop is terminal and
        idempotent)."""
        return self._stopped

    async def stop(self, drain: bool = True) -> None:
        """Terminal: drains (or cancels) every batcher, closes every
        executor handed to the registry (the registry-level one AND any
        per-model ``register(..., executor=...)`` override — handing an
        executor to the registry transfers ownership), and shuts the
        registry down for good — serving again means building a new
        registry (warm-ups are per-``CompiledModel``, so the models
        themselves can be re-registered cheaply).

        Idempotent: a second stop (e.g. ``__aexit__`` after an explicit
        ``stop()``) returns immediately — batchers are not re-closed and
        no metric is counted twice."""
        if self._stopped:
            return
        self._stopped = True
        for e in self._entries.values():
            await e.batcher.close(drain=drain)
        owned = {id(self.executor): self.executor} \
            if self.executor is not None else {}
        for e in self._entries.values():  # per-model overrides included;
            owned[id(e.batcher.executor)] = e.batcher.executor  # close()
        for ex in owned.values():         # is idempotent and a no-op for
            ex.close()                    # InlineExecutor
        self._started = False

    async def __aenter__(self):
        return self.start()

    async def __aexit__(self, *exc):
        await self.stop()

    # -- serving ----------------------------------------------------------
    def _entry(self, name: str) -> _Entry:
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(f"unknown model {name!r}; "
                           f"registered: {sorted(self._entries)}") from None

    def submit(self, name: str, x, cls: str = "default",
               deadline_s: Optional[float] = None,
               wall_deadline_s: Optional[float] = None):
        """Admission-controlled enqueue under priority class ``cls``;
        returns the request's future. Raises ``KeyError`` for
        unregistered models or unknown classes, ``QueueFullError`` when
        the model's bounded queue sheds the request (a lower-priority
        pending request may be preempted in its favor instead).
        ``wall_deadline_s`` caps the request's end-to-end wall time
        (defaults to the class's ``slo_s``): still pending past it, the
        request is expired with ``DeadlineExceededError`` instead of
        dispatched."""
        if not self._started:
            raise RuntimeError("registry not started (use `async with` "
                               "or call start())")
        return self._entry(name).batcher.submit(
            x, cls=cls, deadline_s=deadline_s,
            wall_deadline_s=wall_deadline_s)

    async def infer(self, name: str, x, cls: str = "default",
                    deadline_s: Optional[float] = None,
                    wall_deadline_s: Optional[float] = None):
        return await self.submit(name, x, cls=cls, deadline_s=deadline_s,
                                 wall_deadline_s=wall_deadline_s)

    # -- dtype helpers (requests travel in graph dtype) --------------------
    def quantize_input(self, name: str, x):
        """Float sample -> graph-dtype sample for ``submit``/``infer``."""
        g = self._entry(name).model.graph
        t = g.tensor(g.inputs[0])
        x = np.asarray(x, np.float32).reshape(t.shape)
        return np.asarray(t.qparams.quantize(x)) if t.dtype == "int8" else x

    def dequantize_output(self, name: str, y):
        g = self._entry(name).model.graph
        t = g.tensor(g.outputs[0])
        y = np.asarray(y)
        return (t.qparams.dequantize(y) if t.dtype == "int8"
                else y.astype(np.float32))

    # -- observability -----------------------------------------------------
    def metrics(self, name: str) -> ModelMetrics:
        return self._entry(name).batcher.metrics

    def snapshot(self) -> dict:
        """{model: metrics snapshot} for every registered model."""
        now = self.clock.now()
        return {e.name: e.batcher.metrics.snapshot(now)
                for e in self._entries.values()}

    def engines(self) -> dict:
        """Per-model build accounting straight off the engines:
        ``compile_events`` (bucket executables built: CUDA-graph captures
        on the card), the typed ``compile_log`` tail, and the hit/miss/store
        ``cache_events`` split (all zero until the persistent cache is
        ported). Duck-typed stand-ins without the counters report empty."""
        out = {}
        for e in self._entries.values():
            m = e.model
            out[e.name] = {
                "compile_events": getattr(m, "compile_events", 0),
                "cache_events": dict(getattr(m, "cache_events", {}) or {}),
                "compile_log": list(getattr(m, "compile_log", ()) or ())[-32:],
            }
        return out

    def cache_status(self) -> Optional[dict]:
        """The registry-level cache's counters: ``None``, since the
        persistent executable cache is not ported yet."""
        return None

    def openmetrics(self) -> str:
        """OpenMetrics text exposition of every model's metrics (plus the
        per-stage latency histograms when a tracer is installed) — ready
        to serve from a scrape endpoint."""
        from repro_torch.obs.export import openmetrics
        return openmetrics(self.snapshot(), tracer=self.tracer,
                           engines=self.engines(),
                           cache=self.cache_status())

    def telemetry(self) -> dict:
        """Structured JSON snapshot unifying metrics, trace histograms,
        the flight recorder's status, and the engines' compile/cache
        accounting (``repro_torch.obs.export``)."""
        from repro_torch.obs.export import json_snapshot
        flight = self.tracer.flight if self.tracer is not None else None
        return json_snapshot(self.snapshot(), tracer=self.tracer,
                             flight=flight, engines=self.engines(),
                             cache=self.cache_status())


def build_paper_registry(names=("sine", "speech", "person"), *,
                         calib_samples: int = 8, seed: int = 0,
                         use_kernels: bool = True, layout_plan: bool = True,
                         device="cuda", **registry_kw) -> ServingRegistry:
    """Registry serving the paper's models (Table 3), quantized with
    calibrated-random representative data exactly as the JAX package's
    ``build_paper_registry`` does (same generators, same seed).

    ``use_kernels``/``layout_plan``/``device`` select the engine every
    served bucket lowers through (see ``repro_torch.core.engine``): by
    default the hand-written CUDA kernels on the card, each bucket captured
    as one CUDA graph at warm-up; ``device="cpu"`` runs the kernels' plain
    versions. ``registry_kw`` reaches :class:`ServingRegistry` — including
    ``executor`` (shared off-loop dispatch) and ``classes`` (priority
    table)."""
    from repro_torch.configs.paper_models import PAPER_MODELS
    from repro_torch.core.quantize import quantize_graph

    gens = {
        "sine": lambda rng, n: rng.uniform(0, 2 * np.pi, (n, 1)).astype("f"),
        "speech": lambda rng, n: rng.normal(0, 1, (n, 49, 40, 1)).astype("f"),
        "person": lambda rng, n: rng.normal(0, 1, (n, 96, 96, 1)).astype("f"),
    }
    reg = ServingRegistry(**registry_kw)
    rng = np.random.default_rng(seed)
    for name in names:
        g = PAPER_MODELS[name](batch=1)
        rep = [gens[name](rng, 1) for _ in range(calib_samples)]
        reg.register(name, CompiledModel(
            quantize_graph(g, rep, device=device), use_kernels=use_kernels,
            layout_plan=layout_plan, device=device))
    return reg
