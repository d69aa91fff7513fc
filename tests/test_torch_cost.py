"""``CompiledModel.cost_analysis`` and ``engine.cost_of_plan`` (the port's
count of a forward's work) against XLA's count of the reference's plain
route, on the CPU.

The port counts the model, not its lowering (the rules are in
``cost_of_plan``'s docstring). XLA counts the module it compiled, so the
two are held as follows, per call and at buckets 1, 4 and 8:

* float graphs: ``flops`` equals the module's products exactly — its dots,
  its convolutions and the dots XLA rewrote into a multiply
  (``_torch_hlo.dot_flops(conv=True)``);
* int8 graphs: ``flops`` equals the float graph's (the same multiply-adds)
  and is at most the module's products; the excess is named instruction by
  instruction: XLA's CPU backend runs each grouped int32 depthwise
  convolution as a dense one over a block-diagonal ``(kh, kw, C, C)``
  kernel, C times the products of the model;
* ``transcendentals`` equals XLA's;
* ``bytes accessed`` is at most XLA's raw ``"bytes accessed"`` (XLA widens int8 to int32 before its products and fuses some ops, so the
  two are held by a ratio only).

The count is route-independent: the plain, kernel (with and without the
layout plan) and paged routes give the same dict.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_cost.py

prints the counts of every model and batch beside XLA's and their ratios.
"""
import dataclasses
import sys

import numpy as np
import pytest

from repro.analysis.__main__ import quantized_graph as j_quantized_graph
from repro.configs.paper_models import PAPER_MODELS
from repro.core import CompiledModel as JModel
from repro.core.builder import GraphBuilder
from repro.core.quantize import quantize_graph as j_quantize
from repro_torch.core import graph as TG
from repro_torch.core import registry as R
from repro_torch.core.engine import CompiledModel as TModel
from repro_torch.core.engine import ExecutionPlan, cost_of_plan

from _torch_hlo import conv_flops, dot_flops, hlo_bytes
from _torch_parity import carry

MODELS = ("sine", "speech", "person", "quickstart")
KINDS = ("float", "int8")
BATCHES = (None, 1, 4, 8)  # None: the per-call forward
# the page maps of chip_smoke.py's PAGED; quickstart pages its FC in two
PAGED = {"sine": {0: 16, 1: 16}, "speech": {2: 4}, "person": {29: 2},
         "quickstart": {4: 2}}


def quickstart_float():
    """``examples/quickstart.py``'s float CNN, from its seed."""
    rng = np.random.default_rng(0)
    b = GraphBuilder("quickstart_cnn")
    x = b.input("image", (1, 16, 16, 3))
    h = b.conv2d(x, rng.normal(0, 0.3, (3, 3, 3, 8)).astype("f"),
                 rng.normal(size=8).astype("f"), stride=(2, 2),
                 padding="SAME", fused="RELU6")
    h = b.depthwise_conv2d(h, rng.normal(0, 0.3, (3, 3, 8, 1)).astype("f"),
                           rng.normal(size=8).astype("f"), padding="SAME",
                           fused="RELU")
    h = b.average_pool2d(h, (8, 8))
    h = b.reshape(h, (1, 8))
    h = b.fully_connected(h, rng.normal(0, 0.3, (8, 4)).astype("f"), None)
    h = b.softmax(h)
    b.output(h)
    return b.build(), [rng.normal(0, 1, (1, 16, 16, 3)).astype("f")
                       for _ in range(16)]


def reference_graph(name, kind):
    if name == "quickstart":
        fg, rep = quickstart_float()
        return fg if kind == "float" else j_quantize(fg, rep)
    if kind == "float":
        return PAPER_MODELS[name](batch=1)
    return j_quantized_graph(name)


class Reference:
    """One graph in both packages: the reference's plain-route modules and
    XLA's counts, compiled once per batch."""

    def __init__(self, name, kind, tmp):
        self.jg = reference_graph(name, kind)
        self.tg = carry(self.jg, tmp, f"{name}_{kind}.msgpack")
        self.jm = JModel(self.jg, use_pallas=False)
        self._exe = {}

    def executable(self, batch):
        if batch not in self._exe:
            self._exe[batch] = (self.jm.executable if batch is None
                                else self.jm.compile_batched(batch))
        return self._exe[batch]

    def hlo(self, batch):
        return self.executable(batch).as_text()

    def xla(self, batch):
        ca = self.executable(batch).cost_analysis()
        return ca[0] if isinstance(ca, (list, tuple)) else ca

    def port(self, batch, **route):
        return cost_of_plan(ExecutionPlan.build(self.tg, device="cpu",
                                                **route), batch)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp, cache = tmp_path_factory.mktemp("cost"), {}

    def get(name, kind):
        if (name, kind) not in cache:
            cache[name, kind] = Reference(name, kind, tmp)
        return cache[name, kind]
    return get


# ------------------------------------------------- _torch_hlo's counters --

def _xla(f, *args):
    import jax
    exe = jax.jit(f).lower(*args).compile()
    ca = exe.cost_analysis()
    return (ca[0] if isinstance(ca, (list, tuple)) else ca)["flops"], \
        exe.as_text()


@pytest.mark.parametrize("stride", [(1, 1), (2, 2)], ids=["s1", "s2"])
@pytest.mark.parametrize("kernel,groups", [((3, 3, 6, 4), 1),
                                           ((3, 3, 1, 6), 6),
                                           ((3, 3, 2, 6), 3)],
                         ids=["plain", "depthwise", "grouped"])
def test_conv_flops_equal_xla_on_one_op(kernel, groups, stride):
    """On a VALID convolution ``conv_flops`` is XLA's own ``flops``,
    exactly. On a SAME one it counts the padded window positions as well
    (a kernel computes them; XLA leaves them out): it equals XLA's count of
    the same convolution on the input padded beforehand."""
    import jax.numpy as jnp
    from jax import lax
    x = jnp.asarray(np.random.default_rng(0).normal(size=(2, 9, 11, 6)),
                    jnp.float32)
    w = jnp.ones(kernel, jnp.float32)

    def conv(padding):
        return lambda x, w: lax.conv_general_dilated(
            x, w, stride, padding, dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=groups)
    flops, hlo = _xla(conv("VALID"), x, w)
    assert conv_flops(hlo) == dot_flops(hlo, conv=True) == flops > 0

    _, same = _xla(conv("SAME"), x, w)
    pads = lax.padtype_to_pads(x.shape[1:3], kernel[:2], stride, "SAME")
    padded = jnp.pad(x, ((0, 0), *pads, (0, 0)))
    flops_padded, _ = _xla(conv("VALID"), padded, w)
    assert conv_flops(same) == flops_padded > _xla(conv("SAME"), x, w)[0]


@pytest.mark.parametrize("lhs,rhs", [((5, 7), (7, 3)), ((5, 7), (7, 1)),
                                     ((5, 1), (1, 3))],
                         ids=["dot", "n1", "k1"])
def test_dot_flops_with_conv_mode_on_one_dot(lhs, rhs):
    """A dot is 2·M·K·N, XLA's own count; a contraction of size 1 XLA
    rewrites into a broadcast multiply, which it counts once a product and
    ``dot_flops(conv=True)`` twice, as the dot it was."""
    import jax.numpy as jnp
    flops, hlo = _xla(lambda a, b: a @ b, jnp.ones(lhs), jnp.ones(rhs))
    want = 2 * lhs[0] * lhs[1] * rhs[1]
    found = []
    assert dot_flops(hlo, conv=True, found=found) == want
    assert flops == (want // 2 if lhs[1] == 1 else want)
    assert [f[0] for f in found] == (["multiply"] if lhs[1] == 1
                                     else ["dot"])


# ------------------------------------------------------------ hand count --

@pytest.mark.parametrize("kind,nbytes", [("int8", 486), ("float", 1548)])
def test_sine_hand_count(ref, kind, nbytes):
    """Sine is FC 1→16 ReLU, FC 16→16 ReLU, FC 16→1. flops =
    2·(16 + 256 + 16) = 576. int8 bytes, each FC's input + weight + int32
    bias + output: (1+16+64+16) + (16+256+64+16) + (16+16+4+1) = 486;
    float32: (4+64+64+64) + (64+1024+64+64) + (64+64+4+4) = 1548."""
    r = ref("sine", kind)
    assert [op.op for op in r.tg.ops] == [TG.FULLY_CONNECTED] * 3
    want = {"flops": 576, "bytes accessed": nbytes, "transcendentals": 0}
    assert TModel(r.tg, use_kernels=False, device="cpu").cost_analysis() \
        == want
    assert r.port(None, use_kernels=False) == want
    assert r.port(8, use_kernels=False)["flops"] == 8 * 576


# ------------------------------------------------- against XLA's modules --

@pytest.mark.parametrize("batch", BATCHES, ids=lambda b: f"b{b}")
@pytest.mark.parametrize("name", MODELS)
def test_float_flops_equal_module_products(ref, name, batch):
    r = ref(name, "float")
    found = []
    module = dot_flops(r.hlo(batch), conv=True, found=found)
    assert r.port(batch, use_kernels=False)["flops"] == module > 0, found


def _dense_depthwise(r, found, batch):
    """The int8 module's convolutions that run a depthwise layer densely:
    a ``(kh, kw, C, C)`` kernel where the graph's depthwise weight is
    ``(kh, kw, C, 1)``, on that layer's output shape; each with the
    products it adds, ``(C − 1) / C`` of its own."""
    rows = 1 if batch is None else batch
    layers = {}
    for op in r.tg.ops:
        if op.op == TG.DEPTHWISE_CONV_2D:
            kh, kw, c, _ = r.tg.tensor(op.inputs[1]).shape
            out = r.tg.tensor(op.outputs[0]).shape
            key = ((kh, kw, c, c), (rows * out[0],) + tuple(out[1:]))
            layers[key] = layers.get(key, 0) + 1
    extra = []
    for kind, lhs, rhs, out, flops in found:
        key = (tuple(rhs), tuple(out))
        if kind == "convolution" and layers.get(key):
            layers[key] -= 1
            extra.append((tuple(rhs), tuple(out), flops * (rhs[2] - 1)
                          // rhs[2]))
    assert not any(layers.values()), layers
    return extra


@pytest.mark.parametrize("batch", BATCHES, ids=lambda b: f"b{b}")
@pytest.mark.parametrize("name", MODELS)
def test_int8_flops_equal_float_and_name_the_module_excess(ref, name, batch):
    r, f = ref(name, "int8"), ref(name, "float")
    port = r.port(batch, use_kernels=False)["flops"]
    assert port == f.port(batch, use_kernels=False)["flops"]
    found = []
    module = dot_flops(r.hlo(batch), conv=True, found=found)
    assert port <= module
    extra = _dense_depthwise(r, found, batch)
    for kernel, out, flops in extra:
        print(f"{name} b{batch}: s32 convolution {kernel} -> {out} "
              f"+{flops} flops")
    assert module - port == sum(e[2] for e in extra), (module, port, found)


@pytest.mark.parametrize("batch", BATCHES, ids=lambda b: f"b{b}")
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", MODELS)
def test_transcendentals_equal_xla(ref, name, kind, batch):
    r = ref(name, kind)
    want = r.xla(batch).get("transcendentals", 0)
    assert r.port(batch, use_kernels=False)["transcendentals"] == want
    softmax = [op for op in r.tg.ops if op.op == TG.SOFTMAX]
    assert (want > 0) == bool(softmax)


@pytest.mark.parametrize("batch", BATCHES, ids=lambda b: f"b{b}")
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", MODELS)
def test_bytes_at_most_xla(ref, name, kind, batch):
    """The port's bytes are at most XLA's raw ``bytes accessed``, per call
    and at the buckets (the ratio to that and to the module recounted
    without layout ops is printed; PERF.md has them)."""
    r = ref(name, kind)
    port = r.port(batch, use_kernels=False)["bytes accessed"]
    raw = r.xla(batch)["bytes accessed"]
    bare = hlo_bytes(r.hlo(batch), layout=False)
    print(f"{name} {kind} b{batch}: port {port} / XLA {raw:.0f} = "
          f"{port / raw:.4f}; / without layout ops {bare:.0f} = "
          f"{port / bare:.4f}")
    assert 0 < port <= raw


# ---------------------------------------------------------------- routes --

@pytest.mark.parametrize("name", MODELS)
def test_same_count_on_every_route(ref, name):
    r = ref(name, "int8")
    for batch in BATCHES:
        plain = r.port(batch, use_kernels=False)
        assert r.port(batch, use_kernels=True) == plain
        assert r.port(batch, use_kernels=True, layout_plan=False) == plain
        assert r.port(batch, use_kernels=False, paged=PAGED[name]) == plain
        assert r.port(batch, use_kernels=True, paged=PAGED[name]) == plain
    for route in ({"use_kernels": False}, {"use_kernels": True},
                  {"use_kernels": True, "layout_plan": False},
                  {"use_kernels": True, "paged": PAGED[name]}):
        model = TModel(r.tg, device="cpu", **route)
        assert model.cost_analysis() == r.port(None, use_kernels=False)
        assert model.capture_events == 0  # counted without a build


def test_paged_maps_name_fully_connected_layers(ref):
    for name, pages in PAGED.items():
        g = ref(name, "int8").tg
        for i, n in pages.items():
            assert g.ops[i].op == TG.FULLY_CONNECTED
            assert g.tensor(g.ops[i].inputs[1]).shape[1] % n == 0


def test_counts_are_python_ints(ref):
    ca = TModel(ref("speech", "int8").tg, device="cpu").cost_analysis()
    assert set(ca) == {"flops", "bytes accessed", "transcendentals"}
    assert all(type(v) is int for v in ca.values())


def test_batch_scales_activations_not_weights(ref):
    """A bucket of ``b`` rows moves ``b`` times each activation and each
    weight once."""
    g = ref("person", "int8").tg
    const = sum(t.nbytes for t in g.tensors if t.is_const)
    plan = ExecutionPlan.build(g, use_kernels=False, device="cpu")
    one, eight = cost_of_plan(plan, 1), cost_of_plan(plan, 8)
    assert one == cost_of_plan(plan)
    assert eight["bytes accessed"] - const \
        == 8 * (one["bytes accessed"] - const)
    assert eight["flops"] == 8 * one["flops"]


# ------------------------------------------------------------ no fallback --

def test_raises_on_an_op_without_a_cost_rule(ref, monkeypatch):
    plan = ExecutionPlan.build(ref("speech", "int8").tg, use_kernels=False,
                               device="cpu")
    softmax = R.get(TG.SOFTMAX)
    monkeypatch.setitem(R._REGISTRY, TG.SOFTMAX,
                        dataclasses.replace(softmax, cost=None))
    with pytest.raises(NotImplementedError, match="SOFTMAX"):
        cost_of_plan(plan)
    with pytest.raises(NotImplementedError, match="SOFTMAX"):
        TModel(plan.graph, use_kernels=False, device="cpu").cost_analysis()


def test_raises_on_an_unknown_op_kind(ref, tmp_path):
    g = carry(ref("sine", "int8").jg, tmp_path)
    plan = ExecutionPlan.build(g, use_kernels=False, device="cpu")
    g.ops[1].op = "GELU"  # past OpNode's check: a kind no rule covers
    with pytest.raises(NotImplementedError, match="GELU"):
        cost_of_plan(plan)


def test_every_registered_op_has_a_cost_rule():
    assert all(R.get(op).cost is not None for op in TG.ALL_OPS)


# ------------------------------------------------------------ as a script --

def main():
    import pathlib
    import tempfile
    tmp = pathlib.Path(tempfile.mkdtemp())
    print("model kind batch | port flops / bytes / transc | XLA products / "
          "flops / bytes / transc | bytes ratio raw, without layout ops")
    for name in MODELS:
        for kind in KINDS:
            r = Reference(name, kind, tmp)
            for batch in BATCHES:
                p, x = r.port(batch, use_kernels=False), r.xla(batch)
                hlo = r.hlo(batch)
                bare = hlo_bytes(hlo, layout=False)
                print(f"{name} {kind} {batch} | {p['flops']} / "
                      f"{p['bytes accessed']} / {p['transcendentals']} | "
                      f"{dot_flops(hlo, conv=True)} / {x['flops']:.0f} / "
                      f"{x['bytes accessed']:.0f} / "
                      f"{x.get('transcendentals', 0):.0f} | "
                      f"{p['bytes accessed'] / x['bytes accessed']:.4f} "
                      f"{p['bytes accessed'] / bare:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
