"""The port's serving stack held against the JAX package's on one FakeClock
scenario.

The same seeded arrival script (sine and speech requests in two priority
classes, bursts that hit the bounded queue) goes through ``repro.serve``
over the JAX ``CompiledModel`` and through ``repro_torch.serve`` over the
port's ``CompiledModel(device="cpu")``: the port's kernel route against the
reference's Pallas route (``use_pallas=True``, interpret mode), its plain
route against the reference's plain engine. The quantized graphs are
carried across with ``repro.core.graph.save`` ->
``repro_torch.core.graph.load``. Compared with tolerance 0 (softmax rows
±1 LSB): every request's served row and terminal status, the retry and
degrade counts and every other ``ModelMetrics`` counter, each trace id's
span-stage sequence (less the port's counted engine spans, ``engine.*``,
which the reference does not record), and the OpenMetrics exposition with
the ``compile`` lines masked (a bucket capture is not an XLA compile).

Route names follow each package (the reference's primary of a plain engine
is ``"compiled"``, the port's kernel engine's is ``"kernels"``), so they
are compared by their place in ``routes()``. The kernel-route engine's
fallback is an engine route that records engine spans, the reference's
fallback of a plain engine is the interpreter, which records none: the
scenario that degrades therefore runs the port's plain engine, whose
route chain is the reference's.
"""
import asyncio
import re

import numpy as np
import pytest

from repro.configs.paper_models import build_sine as j_build_sine
from repro.configs.paper_models import build_speech as j_build_speech
from repro.core import CompiledModel as JModel
from repro.core.quantize import quantize_graph as j_quantize
from repro.obs.trace import Tracer as JTracer
from repro.serve import executor as j_executor
from repro.serve import faults as j_faults
from repro.serve import registry as j_registry
from repro.serve import resilience as j_resilience
from repro.serve import scheduler as j_scheduler
from repro_torch.core.engine import CompiledModel as TModel
from repro_torch.obs.trace import COUNTED, Tracer as TTracer
from repro_torch.serve import executor as t_executor
from repro_torch.serve import faults as t_faults
from repro_torch.serve import registry as t_registry
from repro_torch.serve import resilience as t_resilience
from repro_torch.serve import scheduler as t_scheduler

from _torch_parity import assert_i8_equal, assert_softmax_close, carry

JAX = dict(executor=j_executor, faults=j_faults, registry=j_registry,
           resilience=j_resilience, scheduler=j_scheduler, tracer=JTracer)
PORT = dict(executor=t_executor, faults=t_faults, registry=t_registry,
            resilience=t_resilience, scheduler=t_scheduler, tracer=TTracer)
MAX_BATCH = 4
POISON = -128  # first element of a poisoned request's row
N_REQUESTS = 48


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """JAX-quantized sine and speech graphs, and their port carries."""
    rng = np.random.default_rng(3)
    sine = j_quantize(j_build_sine(), [
        rng.uniform(0, 2 * np.pi, (1, 1)).astype("f") for _ in range(8)])
    speech = j_quantize(j_build_speech(), [
        rng.normal(0, 1, (1, 49, 40, 1)).astype("f") for _ in range(4)])
    tmp = tmp_path_factory.mktemp("graphs")
    return {"sine": (sine, carry(sine, tmp, "sine.msgpack")),
            "speech": (speech, carry(speech, tmp, "speech.msgpack"))}


def _script(graphs):
    """(gap_s, model, class, row) for every request: seeded, the same for
    both packages; rows have the graph input's full shape. Rows are int8 with a first element above POISON, except
    the two poisoned requests'."""
    rng = np.random.default_rng(11)
    out = []
    for i in range(N_REQUESTS):
        name = ("sine", "speech")[int(rng.integers(0, 2))]
        shape = graphs[name][0].tensor(graphs[name][0].inputs[0]).shape
        row = rng.integers(-127, 128, shape).astype(np.int8)
        if i in (9, 30):
            row.reshape(-1)[0] = POISON
        gap = float(rng.choice([0.0, 0.0, 0.0, 0.0005, 0.002, 0.006]))
        cls = ("interactive", "batch")[int(rng.integers(0, 2))]
        out.append((gap, name, cls, row))
    return out


def _poisoned(row) -> bool:
    return int(np.asarray(row).reshape(-1)[0]) == POISON


def _run(pkg, models, script, faults: str):
    """Serve ``script`` through ``pkg`` with ``models`` on a FakeClock.
    Returns (outcomes, snapshot, exposition, span sequences, routes)."""
    S = pkg["scheduler"]
    clock = S.FakeClock()
    tracer = pkg["tracer"]()
    classes = {"interactive": S.ClassPolicy(priority=1, max_delay_s=0.002,
                                            slo_s=0.040),
               "batch": S.ClassPolicy(priority=0, max_delay_s=0.008)}
    routes = next(iter(models.values())).routes()
    executor = inj = None
    if faults != "none":
        if faults == "scripted":
            inj = pkg["faults"].FaultInjector(seed=5)
        else:
            inj = pkg["faults"].FaultInjector(
                seed=5, transient_rate=0.15, nan_rate=0.05,
                persistent_routes={routes[0]}, poison=_poisoned)
        R = pkg["resilience"]
        executor = R.ResilientExecutor(
            inj.wrap(pkg["executor"].InlineExecutor()),
            retry=R.RetryPolicy(max_attempts=3, jitter=0.25, seed=2),
            breaker=R.BreakerPolicy(failure_threshold=2, recovery_s=0.020))
    # the chaos run's queue is shorter than a bucket, so bursts are shed
    # (or preempt a pending batch-class request) at admission
    reg = pkg["registry"].ServingRegistry(
        clock=clock, max_batch=MAX_BATCH, max_delay_s=0.004,
        max_queue=3 if faults == "chaos" else 16,
        classes=classes, tracer=tracer, executor=executor)
    for name, m in models.items():
        m.warmup_routes(MAX_BATCH)
        reg.register(name, m)
    outcomes = []

    async def main():
        futs = []
        async with reg:
            for i, (gap, name, cls, row) in enumerate(script):
                if gap:
                    await clock.advance(gap)
                if faults == "scripted" and i % 10 == 4:
                    inj.fail_next("transient")  # one fault, then a retry
                try:
                    futs.append(reg.submit(name, row, cls=cls))
                except Exception as e:  # shed at admission
                    futs.append(e)
            for _ in range(40):
                await clock.advance(0.010)
                if all(isinstance(f, Exception) or f.done() for f in futs):
                    break
        for f in futs:
            if isinstance(f, Exception):
                outcomes.append(("shed", type(f).__name__, None))
            elif f.exception() is not None:
                outcomes.append(("failed", type(f.exception()).__name__,
                                 None))
            else:
                outcomes.append(("ok", None, np.asarray(f.result())))
        return reg.snapshot(), reg.openmetrics()

    snap, text = asyncio.run(main())
    # trace ids come from a process-wide counter, so a request's trace is
    # found by its place in admission order (ids grow with admissions)
    spans = [(t["terminal"], [s.name for s in t["spans"]
                              if s.name not in COUNTED])
             for t in sorted(tracer.trees(),
                             key=lambda t: int(t["trace_id"][1:]))]
    return outcomes, snap, text, spans, routes


def _renamed(obj, names: dict):
    """``obj`` with route names mapped: dict keys, and ``route="..."``
    labels of an exposition."""
    if isinstance(obj, str):
        return re.sub(r'route="([^"]*)"',
                      lambda m: f'route="{names.get(m.group(1), m.group(1))}"',
                      obj)
    if isinstance(obj, dict):
        return {names.get(k, k) if isinstance(k, str) else k:
                _renamed(v, names) for k, v in obj.items()}
    return obj


def _masked(text: str) -> list:
    return [line for line in text.splitlines() if "compile" not in line]


@pytest.mark.parametrize("route,faults", [
    ("kernels", "none"), ("kernels", "scripted"), ("compiled", "chaos")])
def test_serving_matches_reference(graphs, route, faults):
    script = _script(graphs)
    # the kernel route against the reference's Pallas route (interpret
    # mode here), the plain route against its plain engine
    jax_models = {n: JModel(j, use_pallas=route == "kernels")
                  for n, (j, _) in graphs.items()}
    port_models = {n: TModel(t, use_kernels=route == "kernels",
                             device="cpu") for n, (_, t) in graphs.items()}
    j_out, j_snap, j_text, j_spans, j_routes = _run(JAX, jax_models, script,
                                                    faults)
    t_out, t_snap, t_text, t_spans, t_routes = _run(PORT, port_models, script,
                                                    faults)
    names = dict(zip(t_routes, j_routes))

    assert len(t_out) == len(j_out) == N_REQUESTS
    for (_, name, _, _), (js, je, jy), (ts, te, ty) in zip(script, j_out,
                                                           t_out):
        assert (ts, te) == (js, je)
        if js == "ok":
            (assert_softmax_close if name == "speech" else
             assert_i8_equal)(ty, jy)
    assert _renamed(t_snap, names) == j_snap
    assert t_spans == j_spans
    assert _renamed(_masked(t_text), names) == _masked(j_text)
    # the scenario exercised what it claims
    kinds = {s for s, _, _ in t_out}
    assert "ok" in kinds
    if faults == "chaos":
        assert {"shed", "failed"} <= kinds
        assert all(t_snap[n]["retries"] > 0 and t_snap[n]["degraded_rows"] > 0
                   for n in t_snap)
    elif faults == "scripted":
        assert sum(t_snap[n]["retries"] for n in t_snap) == 5
        assert all(t_snap[n]["degraded_rows"] == 0 for n in t_snap)
