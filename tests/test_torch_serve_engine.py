"""The engine's serving layer in the port: bucket executables
(``compile_batched`` / ``warmup_batched`` / ``bucket_sizes``), the staging
pool (``acquire_staging`` / ``release_staging`` / ``predict_q_staged`` /
``staged_infer``), the build accounting (``compile_events``,
``staging_events``, ``compile_log``) and the capture safety of the batched
forward — held against the JAX package's ``CompiledModel`` on the CPU.

On the card a bucket's executable is a CUDA graph (``tests/test_torch_cuda.py``
replays it); here it is the eager batched function, noted once per bucket,
so the compile-once and bucket invariants are the same ones.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro.configs.paper_models import build_sine as j_build_sine
from repro.configs.paper_models import build_speech as j_build_speech
from repro.core import CompiledModel as JModel
from repro.core import engine as JE
from repro.core import ops_ref as JO
from repro.core.quantize import quantize_graph as j_quantize
from repro.obs import trace as j_trace
from repro.serve import registry as j_registry
from repro.serve import scheduler as j_scheduler
from repro_torch.core import engine as TE
from repro_torch.core import ops_ref as TO
from repro_torch.core.engine import CompiledModel as TModel
from repro_torch.core.engine import ExecutionPlan
from repro_torch.obs import trace as t_trace
from repro_torch.serve import registry as t_registry
from repro_torch.serve import scheduler as t_scheduler

from _torch_parity import (assert_i8_equal, assert_softmax_close, carry,
                           person_like)


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """JAX-quantized sine, speech and a small person-shaped graph, with
    their port carries."""
    rng = np.random.default_rng(5)
    sine = j_quantize(j_build_sine(), [
        rng.uniform(0, 2 * np.pi, (1, 1)).astype("f") for _ in range(8)])
    speech = j_quantize(j_build_speech(), [
        rng.normal(0, 1, (1, 49, 40, 1)).astype("f") for _ in range(4)])
    person = j_quantize(person_like(rng), [
        rng.normal(0, 1, (1, 24, 24, 1)).astype("f") for _ in range(4)])
    tmp = tmp_path_factory.mktemp("graphs")
    return {name: (g, carry(g, tmp, f"{name}.msgpack"))
            for name, g in (("sine", sine), ("speech", speech),
                            ("person", person))}


def _rows(g, n, seed=0):
    t = g.tensor(g.inputs[0])
    rng = np.random.default_rng(seed)
    return rng.integers(-128, 128, (n,) + tuple(t.shape)).astype(np.int8)


def _same_rows(got, want, softmax: bool):
    (assert_softmax_close if softmax else assert_i8_equal)(got, want)


# ---------------------------------------------------------------- buckets --

def test_bucket_helpers_match_reference():
    for batch in range(41):
        assert TE.bucket_for(batch) == JE.bucket_for(batch)
        assert TE.bucket_floor(batch) == JE.bucket_floor(batch)
        for max_batch in (None, *range(1, 13)):
            assert TE.dispatched_bucket_rows(batch, max_batch) == \
                JE.dispatched_bucket_rows(batch, max_batch)
    for fn in (TE.bucket_for, TE.bucket_floor):
        with pytest.raises(ValueError):
            fn(-1)


@pytest.mark.parametrize("max_batch", [1, 3, 6, 9])
def test_warmup_buckets_match_reference(graphs, max_batch):
    """``warmup_batched`` warms ``bucket_for(max_batch)``'s buckets and the
    batcher warms ``bucket_floor(max_batch)``'s, as in the JAX package;
    ``warmup_routes`` warms the primary and the compiled fallback alike."""
    jg, tg = graphs["sine"]
    want = JModel(jg).warmup_batched(max_batch).bucket_sizes()
    port = TModel(tg, device="cpu").warmup_routes(max_batch)
    assert port.bucket_sizes() == want
    assert port._fallback_compiled().bucket_sizes() == want
    jm, tm = JModel(jg), TModel(tg, device="cpu")
    j_scheduler.MicroBatcher.for_model(jm, max_batch=max_batch)
    t_scheduler.MicroBatcher.for_model(tm, max_batch=max_batch)
    assert tm.bucket_sizes() == jm.bucket_sizes()
    assert tm.compile_events == len(tm.bucket_sizes())
    assert tm.staging_events == tm._staging_cap * len(tm.bucket_sizes())


@pytest.mark.parametrize("use_kernels", [True, False],
                         ids=["kernels", "compiled"])
@pytest.mark.parametrize("name", ["sine", "speech"])
def test_compile_once_and_pool_stable(graphs, name, use_kernels):
    """After ``warmup_batched(8)`` no batch of 0..11 rows (chunked at 8) and
    no staged flush of 1..8 rows builds a bucket or allocates a staging
    buffer, and every row equals the JAX engine's."""
    jg, tg = graphs[name]
    jm = JModel(jg).warmup_batched(8)
    tm = TModel(tg, use_kernels=use_kernels, device="cpu").warmup_batched(8)
    assert tm.bucket_sizes() == (1, 2, 4, 8)
    warm = tm._staging_cap * 4
    assert tm.compile_events == 4 and tm.staging_events == warm
    assert [(e["kind"], e["bucket"]) for e in tm.compile_log] == [
        ("bucket", b) for b in (1, 2, 4, 8)]
    xs = _rows(tg, 11, seed=1)
    soft = name == "speech"
    assert tm.predict_q_many(xs[:0], max_batch=8).shape[0] == 0
    for n in range(1, 12):
        _same_rows(tm.predict_q_many(xs[:n], max_batch=8),
                   jm.predict_q_many(xs[:n], max_batch=8), soft)
    for n in range(1, 9):
        rows = list(xs[:n])
        _same_rows(tm.staged_infer(rows), jm.staged_infer(rows), soft)
    assert tm.compile_events == 4 and tm.staging_events == warm
    assert len(tm.compile_log) == 4
    # the pool is clean: every buffer went back zeroed
    for bufs in tm._staging.values():
        for bset in bufs:
            assert all(not bool(b.any()) for b in bset)


def test_predict_q_staged_takes_physical_buffers(graphs):
    """A staging buffer set has the LOGICAL shape ``(bucket,) + t.shape``,
    also where the planned first op consumes a lane-padded entry: the lane
    pad runs inside the bucket's forward, so only the real rows are staged
    (and, on the card, copied to the device). It is zero outside the rows
    in use; ``predict_q_staged`` on it equals ``predict_q_many`` of the
    rows, and the JAX engine's rows."""
    jg, tg = graphs["person"]
    tm = TModel(tg, device="cpu")
    (tid,) = tg.inputs
    logical = tuple(tg.tensor(tid).shape)
    phys = tm.exec_plan.entry_shape(tid)
    assert phys[-1] > logical[-1]  # conv0 consumes a lane-padded input
    bufs = tm.acquire_staging(4)
    assert tuple(bufs[0].shape) == (4,) + logical
    assert bufs[0].dtype == torch.int8
    xs = _rows(tg, 3, seed=2)
    bufs[0].numpy()[:3] = xs
    got = tm.predict_q_staged(bufs, 3)
    tm.release_staging(4, bufs, 3)
    want = tm.predict_q_many(xs)
    for a, b in zip(got, want):
        assert_i8_equal(a, b)
    assert not bool(bufs[0].any())
    ref = JModel(jg, use_pallas=True).predict_q_many(xs)
    assert_i8_equal(got[0], ref[0])
    assert_softmax_close(got[1], ref[1])


class _SpanNames:
    """A trace handle that records the names of the engine spans made while
    it is the active scope (both packages' ``obs.trace._Scope``); its
    ``tracer`` takes the port's counted spans' sums."""

    def __init__(self):
        self.names = []
        self.clock = types.SimpleNamespace(now=lambda: 0.0)
        self.tracer = t_trace.Tracer()

    def span(self, name, t0, t1, **attrs):
        self.names.append(name)

    def event(self, name, t, **attrs):
        pass


@pytest.mark.parametrize("use_kernels", [True, False],
                         ids=["kernels", "compiled"])
@pytest.mark.parametrize("name", ["sine", "person"])
def test_pad_stage_spans_match_reference(graphs, name, use_kernels):
    """``pad_stage`` is emitted where the reference emits it: on every
    batched call that pads, by a bucket fill (batch < bucket) or by an entry
    lane pad (a planned first op: every call on the kernel route), and by
    neither ``staged_infer`` nor a call that pads nothing. The port's kernel
    route is held against the reference's Pallas route. The port also
    records its counted engine spans (which the reference has not): stage,
    launch and unstage once per bucket call on the CPU, in that order."""
    jg, tg = graphs[name]
    jm = JModel(jg, use_pallas=use_kernels).warmup_batched(4)
    tm = TModel(tg, use_kernels=use_kernels, device="cpu").warmup_batched(4)
    xs = _rows(tg, 4, seed=7)
    for call in ([lambda m, n=n: m.predict_q_many(xs[:n], max_batch=4)
                  for n in range(1, 5)]
                 + [lambda m, n=n: m.staged_infer(list(xs[:n]))
                    for n in (1, 3)]):
        spans, counted = [], []
        for mod, m in ((j_trace, jm), (t_trace, tm)):
            rec = _SpanNames()
            with mod._Scope(rec):
                call(m)
            spans.append([n for n in rec.names if n not in t_trace.COUNTED])
            counted.append([n for n in rec.names if n in t_trace.COUNTED])
        assert spans[1] == spans[0]
        assert spans[1][-1] == "device"
        assert counted[0] == []
        assert counted[1] == ["engine.stage", "engine.launch",
                              "engine.unstage"]
    lane = tm.exec_plan.entry_shape(tg.inputs[0]) != tg.tensor(
        tg.inputs[0]).shape
    assert lane == use_kernels


def test_compiled_route_does_not_wait_for_reference_rows(graphs):
    """The lock split of the reference: the interpreter's row loop holds
    ``_ref_lock`` and nothing else, and the lazy builds take
    ``_compile_lock``; so a ``"compiled"`` call (its fallback built cold
    here) returns while another thread is inside a ``"reference"`` call."""
    import threading
    _, tg = graphs["sine"]
    tm = TModel(tg, device="cpu")
    xs = _rows(tg, 3, seed=8)
    interp = tm._reference_interp()
    inside, release = threading.Event(), threading.Event()
    invoke = interp.invoke_q

    def held(*args):
        inside.set()
        release.wait(60)
        return invoke(*args)

    interp.invoke_q = held
    ref_rows, compiled_rows, done = [], [], threading.Event()
    ref = threading.Thread(target=lambda: ref_rows.append(
        tm.predict_q_routed(xs, route="reference")))
    comp = threading.Thread(target=lambda: (compiled_rows.append(
        tm.predict_q_routed(xs, route="compiled")), done.set()))
    ref.start()
    try:
        assert inside.wait(30) and tm._ref_lock.locked()
        comp.start()
        returned = done.wait(10)
    finally:
        release.set()
        ref.join(60)
        comp.join(60)
    assert not ref.is_alive() and not comp.is_alive()
    assert returned, "the compiled route waited for the reference rows"
    assert_i8_equal(compiled_rows[0], ref_rows[0])
    assert_i8_equal(compiled_rows[0], tm.predict_q_many(xs))


def test_staging_pool_is_bounded():
    """``release_staging`` keeps at most ``_staging_cap`` sets per bucket;
    a cold checkout allocates and is counted."""
    rng = np.random.default_rng(0)
    from repro_torch.configs.paper_models import build_sine
    from repro_torch.core.quantize import quantize_graph
    qg = quantize_graph(build_sine(), [
        rng.uniform(0, 2 * np.pi, (1, 1)).astype("f") for _ in range(4)],
        device="cpu")
    cm = TModel(qg, device="cpu")
    sets = [cm.acquire_staging(2) for _ in range(6)]
    assert cm.staging_events == 6
    for s in sets:
        cm.release_staging(2, s, 0)
    assert len(cm._staging[2]) == cm._staging_cap == 4
    again = [cm.acquire_staging(2) for _ in range(4)]
    assert cm.staging_events == 6
    assert {id(s) for s in again} <= {id(s) for s in sets}


def test_concurrent_flushes_share_the_pool_safely(graphs):
    """16 threads (more than the cores here, a short switch interval) run
    staged flushes and chunked batches on one warmed model: every row equals
    the serial result, no bucket is built again, and every pooled buffer
    goes back zeroed with the pool at most at its cap."""
    import sys
    import threading
    _, tg = graphs["sine"]
    tm = TModel(tg, device="cpu").warmup_batched(8)
    xs = _rows(tg, 8, seed=6)
    want = {n: tm.predict_q_many(xs[:n]) for n in range(1, 9)}
    errors, done = [], []

    def worker(k):
        try:
            for i in range(40):
                n = 1 + (k + i) % 8
                got = (tm.staged_infer(list(xs[:n])) if i % 2
                       else tm.predict_q_many(xs[:n], max_batch=8))
                if not np.array_equal(got, want[n]):
                    errors.append((k, i, n))
            done.append(k)
        except Exception as e:  # surfaced by the assertion below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and sorted(done) == list(range(16))
    assert tm.compile_events == 4
    for pool in tm._staging.values():
        assert len(pool) <= tm._staging_cap
        for bset in pool:
            assert all(not bool(b.any()) for b in bset)


# ---------------------------------------------------------- capture safety --

@pytest.mark.parametrize("z_y,s_y", [(-7, 0.0234), (3, 0.0471), (-128, 0.1)])
def test_fused_bounds_values(z_y, s_y):
    """``_fused_bounds`` makes its ±inf on the device (``torch.full``), not
    from a host copy. Every bound keeps its float32 value, except RELU6's
    upper one, now divided as the reference divides (one rounding: torch's
    ``6.0 / t`` was ``t.reciprocal() * 6.0``, one ulp off at s_y = 0.0234)."""
    z_y, s_y = np.asarray(z_y, np.int32), np.asarray(s_y, np.float32)
    like = torch.zeros(3, dtype=torch.int32)
    for fused in ("NONE", "RELU", "RELU6"):
        with _HostTraffic() as seen:
            lo, hi = TO._fused_bounds(fused, z_y, s_y, like)
        assert seen == []
        before_lo = torch.tensor(float("-inf"))
        before_hi = torch.tensor(float("inf"))
        if fused in ("RELU", "RELU6"):
            before_lo = torch.as_tensor(z_y).to(torch.float32)
        j_lo, j_hi = JO._fused_bounds(fused, jnp.asarray(z_y),
                                      jnp.asarray(s_y))
        for got, ref in ((lo, j_lo), (hi, j_hi)):
            assert got.dtype == torch.float32 and got.shape == ()
            assert got.numpy().tobytes() == np.float32(ref).tobytes()
        assert lo.numpy().tobytes() == before_lo.numpy().tobytes()
        if fused != "RELU6":
            assert hi.numpy().tobytes() == before_hi.numpy().tobytes()


class _HostTraffic(TorchFunctionMode):
    """Records every call in the block that would copy between the host and
    a device on the card: a tensor made from host data on a named device,
    and any read of a tensor's value back into Python."""

    FACTORIES = ("tensor", "as_tensor", "asarray")
    READS = ("item", "tolist", "numpy", "cpu", "__int__", "__float__",
             "__bool__", "__index__")

    def __enter__(self):
        self.seen = []
        super().__enter__()
        return self.seen

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in self.FACTORIES and "device" in kwargs and args \
                and not torch.is_tensor(args[0]):
            self.seen.append(f"{name}(host data, device=...)")
        elif name in self.READS:
            self.seen.append(name)
        return func(*args, **kwargs)


@pytest.mark.parametrize("paged", [False, True], ids=["unpaged", "paged"])
@pytest.mark.parametrize("use_kernels", [True, False],
                         ids=["kernels", "compiled"])
@pytest.mark.parametrize("name", ["sine", "speech", "person"])
def test_batched_forward_is_capture_safe(graphs, name, use_kernels, paged):
    """What a bucket's CUDA graph captures: the batched forward makes no
    tensor from host data on a device and reads no value back to the host
    (either would fail a capture on the card), on both engine routes and
    the paged route."""
    _, tg = graphs[name]
    fc = [i for i, op in enumerate(tg.ops) if op.op == "FULLY_CONNECTED"
          and tg.tensor(op.inputs[1]).shape[1] % 2 == 0]
    pages = {fc[-1]: 2} if paged else None
    tm = TModel(tg, use_kernels=use_kernels, device="cpu", paged=pages)
    (tid,) = tg.inputs
    # a bucket's static input: the logical rows; the lane pad is inside
    x = torch.zeros((4,) + tg.tensor(tid).shape, dtype=torch.int8)
    with _HostTraffic() as seen:
        outs = tm._batched_fn(x)
    assert seen == []
    assert outs[0].shape[0] == 4


@pytest.mark.parametrize("paged", [False, True], ids=["unpaged", "paged"])
@pytest.mark.parametrize("use_kernels", [True, False],
                         ids=["kernels", "compiled"])
@pytest.mark.parametrize("name", ["sine", "speech", "person"])
def test_percall_forward_is_capture_safe(graphs, name, use_kernels, paged):
    """What the per-call CUDA graph captures: the per-call forward on one
    logical sample makes no tensor from host data on a device and reads no
    value back, on both engine routes and the paged route."""
    _, tg = graphs[name]
    fc = [i for i, op in enumerate(tg.ops) if op.op == "FULLY_CONNECTED"
          and tg.tensor(op.inputs[1]).shape[1] % 2 == 0]
    pages = {fc[-1]: 2} if paged else None
    tm = TModel(tg, use_kernels=use_kernels, device="cpu", paged=pages)
    (tid,) = tg.inputs
    x = torch.zeros(tg.tensor(tid).shape, dtype=torch.int8)
    with _HostTraffic() as seen:
        outs = tm._fn(x)
    assert seen == []
    assert tuple(outs[0].shape) == tg.tensor(tg.outputs[0]).shape


def test_folded_consts_keep_host_scalars(graphs):
    _, tg = graphs["speech"]
    plan = ExecutionPlan.build(tg, use_kernels=False, device="cpu")
    for fc in plan.folded.values():
        for f in ("bias_term", "rescale", "w_sum_zx", "const_off", "z_w"):
            assert torch.is_tensor(getattr(fc, f))
        for f in TO.FoldedConsts.HOST_FIELDS:
            assert isinstance(getattr(fc, f), np.ndarray)


# -------------------------------------------------------- paper registry --

@pytest.mark.parametrize("name", ["sine", "speech"])
def test_paper_registry_matches_reference(name):
    """``build_paper_registry(device="cpu")`` quantizes the paper model
    exactly as the JAX package's does (same generators and seed): the
    engines serve equal rows for the same inputs."""
    jreg = j_registry.build_paper_registry((name,), max_batch=4)
    treg = t_registry.build_paper_registry((name,), device="cpu",
                                           max_batch=4)
    jm, tm = jreg._entry(name).model, treg._entry(name).model
    assert tm.use_kernels and tm.bucket_sizes() == jm.bucket_sizes()
    xs = _rows(tm.graph, 5, seed=4)
    _same_rows(tm.predict_q_many(xs, max_batch=4),
               jm.predict_q_many(xs, max_batch=4), name == "speech")
