"""The port's reference interpreter and the engine's degradation routes
against the JAX package's, on the CPU: ``Interpreter.invoke_q`` and
``invoke`` on the three paper models, and every route of
``predict_q_routed`` (``kernels`` → ``compiled`` → ``reference``, the
reference's ``pallas`` → ``compiled`` → ``reference``). Graphs are
quantized once, in JAX, and carried across. int8 outputs are bit-exact,
softmax outputs within ±1 LSB (``exp`` differs in the last ulp between
torch and XLA); every route of the port equals its primary route exactly.
"""
import numpy as np
import pytest
import torch

from repro.configs import paper_models as JM
from repro.core import CompiledModel as JCompiled
from repro.core import Interpreter as JInterpreter
from repro.core.quantize import quantize_graph as j_quantize
from repro_torch.core.engine import CompiledModel
from repro_torch.core.interpreter import Interpreter

from _torch_parity import assert_i8_equal, assert_softmax_close, carry

SHAPES = {"sine": (1, 1), "speech": (1, 49, 40, 1), "person": (1, 96, 96, 1)}
PAGES = {"sine": {0: 16, 1: 16}, "speech": {2: 4}, "person": {29: 2}}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """name -> (JAX quantized graph, the port's copy, 3 quantized inputs)."""
    out = {}
    tmp = tmp_path_factory.mktemp("interp")
    for name, shape in SHAPES.items():
        rng = np.random.default_rng(13)
        jq = j_quantize(JM.PAPER_MODELS[name](),
                        [rng.normal(0, 1, shape).astype("f") for _ in range(2)])
        xs = np.stack([jq.tensor(jq.inputs[0]).qparams.quantize(
            rng.normal(0, 1, shape).astype("f")) for _ in range(3)])
        out[name] = (jq, carry(jq, tmp, f"{name}.msgpack"), xs)
    return out


def _assert_rows(name, got, want):
    (assert_i8_equal if name == "sine" else assert_softmax_close)(got, want)


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("use_arena", [True, False])
def test_invoke_q_matches_reference(models, name, use_arena):
    jq, tq, xs = models[name]
    want = np.asarray(JInterpreter(jq, use_arena=use_arena).invoke_q(xs[0]))
    interp = Interpreter(tq, use_arena=use_arena, device="cpu")
    got = interp.invoke_q(xs[0])
    _assert_rows(name, got, want)
    # the interpreter agrees with the port's own compiled engine exactly
    assert_i8_equal(got, CompiledModel(tq, use_kernels=False,
                                       device="cpu").predict_q(xs[0]))
    # a second call on the same arena gives the same answer
    assert_i8_equal(interp.invoke_q(xs[0]), got)


def test_invoke_float_matches_reference(models):
    jq, tq, _ = models["sine"]
    x = np.array([[1.25]], np.float32)
    np.testing.assert_array_equal(Interpreter(tq, device="cpu").invoke(x),
                                  np.asarray(JInterpreter(jq).invoke(x)))


def test_arena_views_follow_the_plan(models):
    """Activations are views of one byte tensor at the planned offsets."""
    _, tq, xs = models["speech"]
    interp = Interpreter(tq, device="cpu")
    env = interp.invoke_env(xs[0])
    base = interp.arena.data_ptr()
    assert interp.arena.numel() == interp.plan.arena_bytes
    for tid, off in interp.plan.offsets.items():
        assert env[tid].data_ptr() == base + off
        assert env[tid].dtype == getattr(torch, tq.tensor(tid).dtype)


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("use_kernels", [True, False])
def test_every_route_matches_reference(models, name, use_kernels):
    """Every route of the port equals its primary route bit for bit, and the
    JAX package's plain compiled route."""
    jq, tq, xs = models[name]
    cm = CompiledModel(tq, use_kernels=use_kernels, device="cpu")
    assert cm.routes() == (("kernels", "compiled", "reference") if use_kernels
                           else ("compiled", "reference"))
    want = np.asarray(JCompiled(jq).predict_q_routed(xs, route="compiled"))
    primary = cm.predict_q_routed(xs, max_batch=2)
    _assert_rows(name, primary, want)
    for route in cm.routes():
        assert_i8_equal(cm.predict_q_routed(xs, route=route, max_batch=2),
                        primary)


def test_paged_routes_match_reference(models):
    """Speech with its paging map: the compiled fallback keeps ``paged``."""
    jq, tq, xs = models["speech"]
    jm = JCompiled(jq, paged=PAGES["speech"])
    cm = CompiledModel(tq, device="cpu", paged=PAGES["speech"])
    assert cm._fallback_compiled().paged == PAGES["speech"]
    want = np.asarray(jm.predict_q_routed(xs, route="reference"))
    primary = cm.predict_q_routed(xs)
    _assert_rows("speech", primary, want)
    for route in cm.routes():
        assert_i8_equal(cm.predict_q_routed(xs, route=route), primary)


def test_routes_reject_unknown_and_handle_empty(models):
    _, tq, xs = models["sine"]
    cm = CompiledModel(tq, device="cpu")
    with pytest.raises(ValueError, match="unknown route"):
        cm.predict_q_routed(xs, route="pallas")
    assert cm.predict_q_routed(xs[:0], route="reference").shape == (0, 1, 1)


def test_warmup_routes_builds_every_route(models):
    _, tq, xs = models["sine"]
    cm = CompiledModel(tq, device="cpu", paged=PAGES["sine"])
    assert cm.warmup_routes(4) is cm
    assert cm._fallback is not None and cm._reference is not None
    assert_i8_equal(cm.predict_q_routed(xs, route="reference"),
                    cm.predict_q_routed(xs))


def test_interpreter_raises_without_cuda(models, monkeypatch):
    """The default device is CUDA; without a card the interpreter raises
    instead of moving to the CPU."""
    _, tq, _ = models["sine"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Interpreter(tq)
