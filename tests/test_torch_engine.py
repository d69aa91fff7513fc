"""The port's compiled engine against the JAX package's, on the CPU.

Graphs are quantized once, in JAX, and carried across, so both engines run
the same int8 graph. The port runs ``device="cpu"``: its kernel route then
takes the kernels' plain versions. Tolerances: every weighted-op output is
bit-exact; the softmax output may differ by one LSB (``exp`` differs in the
last ulp between torch and XLA).
"""
import numpy as np
import pytest
import torch

from repro.configs.paper_models import build_person as j_build_person
from repro.core import CompiledModel as JCompiled
from repro.core import engine as JE
from repro.core.quantize import quantize_graph as j_quantize
from repro_torch.core import engine as TE
from repro_torch.core.engine import CompiledModel
from repro_torch.core.quantize import quantize_graph as t_quantize

from _torch_parity import assert_i8_equal, assert_softmax_close, carry, person_like


def _assert_outputs(port, ref):
    logits, probs = port
    assert_i8_equal(logits, ref[0])
    assert_softmax_close(probs, ref[1])


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    rng = np.random.default_rng(21)
    jq = j_quantize(person_like(rng), [rng.normal(0, 1, (1, 24, 24, 1))
                                       .astype("f") for _ in range(3)])
    tq = carry(jq, tmp_path_factory.mktemp("small"))
    xs = np.stack([jq.tensor(jq.inputs[0]).qparams.quantize(
        rng.normal(0, 1, (1, 24, 24, 1)).astype("f")) for _ in range(8)])
    return jq, tq, xs


@pytest.mark.parametrize("use_kernels", [True, False])
def test_small_predict_q_matches_reference(small, use_kernels):
    jq, tq, xs = small
    ref = JCompiled(jq, use_pallas=use_kernels).predict_q(xs[0])
    port = CompiledModel(tq, use_kernels=use_kernels, device="cpu")
    _assert_outputs(port.predict_q(xs[0]), [np.asarray(r) for r in ref])


@pytest.mark.parametrize("use_kernels", [True, False])
def test_small_predict_q_many_matches_reference(small, use_kernels):
    """Buckets 1..8 through ``predict_q_many(max_batch=8)``; every row also
    equals the port's own batch-1 call (the bucket zero-fill is exact)."""
    jq, tq, xs = small
    jm = JCompiled(jq, use_pallas=use_kernels)
    port = CompiledModel(tq, use_kernels=use_kernels, device="cpu")
    singles = [port.predict_q(x) for x in xs]
    for batch in (1, 3, 5, 8):
        ref = jm.predict_q_many(xs[:batch], max_batch=8)
        got = port.predict_q_many(xs[:batch], max_batch=8)
        _assert_outputs(got, ref)
        for r in range(batch):
            np.testing.assert_array_equal(got[0][r], singles[r][0])
            np.testing.assert_array_equal(got[1][r], singles[r][1])


@pytest.mark.parametrize("use_kernels", [True, False])
def test_percall_executable_is_logged_once(small, use_kernels):
    """The per-call executable (the reference's ``compile()``): built at the
    first one-sample ``predict_q`` (or by ``compile()``), logged once as
    ``"percall"`` exactly as the JAX engine logs its AOT compile, and
    reused; on the CPU it is the eager per-call function, whose rows it
    gives, equal to the JAX engine's."""
    jq, tq, xs = small
    jm = JCompiled(jq, use_pallas=use_kernels)
    jm.compile()
    port = CompiledModel(tq, use_kernels=use_kernels, device="cpu")
    assert port.cached_percall() is None
    got = [port.predict_q(x) for x in xs[:3]]
    assert port.compile_log == jm.compile_log == [{"kind": "percall",
                                                   "cache": None}]
    assert port.compile_events == 1
    assert port.compile() is port.executable is port.cached_percall() \
        is port._fn
    assert port.memory_analysis() == {}  # no graph pool on the CPU
    for x, y in zip(xs[:3], got):
        eager = port.exec_plan.lower()(torch.from_numpy(x))
        np.testing.assert_array_equal(y[0], eager[0].numpy())
        np.testing.assert_array_equal(y[1], eager[1].numpy())
        _assert_outputs(y, [np.asarray(r) for r in jm.predict_q(x)])


def test_small_per_call_route_matches_planned(small):
    """``layout_plan=False`` (pad/slice per call) computes the same rows."""
    _, tq, xs = small
    a = CompiledModel(tq, device="cpu").predict_q_many(xs[:5], max_batch=4)
    b = CompiledModel(tq, layout_plan=False, device="cpu").predict_q_many(
        xs[:5], max_batch=4)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


def test_small_predict_float_matches_reference(small):
    jq, tq, _ = small
    x = np.random.default_rng(3).normal(0, 1, (2, 1, 24, 24, 1)).astype("f")
    ref = JCompiled(jq, use_pallas=False).predict(x)
    got = CompiledModel(tq, device="cpu").predict(x)
    np.testing.assert_array_equal(got[0], ref[0])  # dequantized logits
    s = tq.tensor(tq.outputs[1]).qparams.scale
    assert np.abs(got[1] - ref[1]).max() <= s + 1e-7  # one softmax LSB


def test_full_width_person_matches_reference(tmp_path):
    """The paper's person detector at full width, batch 1, against the JAX
    package's plain compiled route; the FC logits are made a second graph
    output in both packages so the weighted path is compared exactly."""
    rng = np.random.default_rng(2)
    jq = j_quantize(j_build_person(), [rng.normal(0, 1, (1, 96, 96, 1))
                                       .astype("f") for _ in range(2)])
    fc_out = jq.ops[-2].outputs[0]
    jq.outputs.append(fc_out)
    tq = carry(jq, tmp_path)
    x = jq.tensor(jq.inputs[0]).qparams.quantize(
        rng.normal(0, 1, (1, 96, 96, 1)).astype("f"))
    probs, logits = (np.asarray(v) for v in
                     JCompiled(jq, use_pallas=False).predict_q(x))
    for use_kernels in (True, False):
        got = CompiledModel(tq, use_kernels=use_kernels, device="cpu").predict_q(x)
        assert_softmax_close(got[0], probs)
        assert_i8_equal(got[1], logits)


PAPER_SHAPES = {"sine": (1, 1), "speech": (1, 49, 40, 1),
                "person": (1, 96, 96, 1)}


@pytest.mark.parametrize("name", sorted(PAPER_SHAPES))
def test_paper_model_kernel_route_matches_reference(tmp_path, name):
    """The kernel route on the CPU (the kernels' plain versions) walks the
    engine's layout, planned at the qmatmul kernel's 32-lane quantum, and
    equals the JAX package's plain compiled route on the paper's three
    models: ``predict_q`` and every batch 1..8 through buckets 1, 2, 4, 8.
    The last FC's output is made a graph output in both packages, so the
    weighted path is compared exactly (softmax within one LSB)."""
    from repro.configs.paper_models import PAPER_MODELS as J_MODELS
    from repro_torch.kernels.qmatmul import QUANTUM
    shape = PAPER_SHAPES[name]
    rng = np.random.default_rng(31)
    jq = j_quantize(J_MODELS[name](), [rng.normal(0, 1, shape).astype("f")
                                       for _ in range(2)])
    fc_out = [op for op in jq.ops if op.op == "FULLY_CONNECTED"][-1].outputs[0]
    if fc_out not in jq.outputs:
        jq.outputs.append(fc_out)
    soft = [any(op.op == "SOFTMAX" and op.outputs[0] == t for op in jq.ops)
            for t in jq.outputs]
    tq = carry(jq, tmp_path)
    xs = np.stack([jq.tensor(jq.inputs[0]).qparams.quantize(
        rng.normal(0, 1, shape).astype("f")) for _ in range(8)])
    jm = JCompiled(jq, use_pallas=False)
    cm = CompiledModel(tq, device="cpu")
    lanes = [lay.out_shape[-1] for lay in cm.plan.layouts.values()]
    assert lanes and all(n % QUANTUM == 0 for n in lanes) and min(lanes) < 128

    def compare(got, want):
        for g, w, is_soft in zip(got, want, soft):
            (assert_softmax_close if is_soft else assert_i8_equal)(g, w)

    compare(cm.predict_q(xs[0]), jm.predict_q(xs[0]))
    for batch in range(1, 9):
        compare(cm.predict_q_many(xs[:batch], max_batch=8),
                jm.predict_q_many(xs[:batch], max_batch=8))


def test_bucket_helpers_match_reference():
    for b in range(0, 40):
        assert TE.bucket_for(b) == JE.bucket_for(b)
        assert TE.bucket_floor(b) == JE.bucket_floor(b)
        assert TE.bucket_for(b) >= max(b, 1)
        assert TE.bucket_floor(b) <= max(b, 1)
        for mb in (None, 1, 3, 6, 8):
            got = TE.dispatched_bucket_rows(b, mb)
            assert got == JE.dispatched_bucket_rows(b, mb)
            assert got >= b
    for f in (TE.bucket_for, TE.bucket_floor):
        with pytest.raises(ValueError):
            f(-1)


def test_predict_q_many_rejects_bad_calls(small):
    _, tq, xs = small
    cm = CompiledModel(tq, device="cpu")
    with pytest.raises(ValueError):
        cm.predict_q_many(xs[0])          # no batch dim
    with pytest.raises(ValueError):
        cm.predict_q_many(xs, max_batch=0)
    empty = cm.predict_q_many(xs[:0])
    assert [e.shape for e in empty] == [(0, 1, 2), (0, 1, 2)]


def test_entry_points_raise_without_cuda(small, monkeypatch):
    """The default device is CUDA; without a card the port raises instead of
    moving to the CPU."""
    _, tq, _ = small
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        CompiledModel(tq)
    with pytest.raises(RuntimeError, match="cuda"):
        t_quantize(person_like(np.random.default_rng(0)),
                   [np.zeros((1, 24, 24, 1), np.float32)])
