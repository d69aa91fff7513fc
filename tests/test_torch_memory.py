"""The port's static memory planners (paper Sec. 4) against the JAX
package's, on the same graphs: liveness, the interpreter's arena, the stack
plan in both accountings, the paged plan, the FC page/full byte counts
(with the paper's ATmega328 example) and the engine memory report. All of
it is integer byte accounting, so every number must be equal."""
import numpy as np
import pytest

from repro.configs import paper_models as JM
from repro.core import memory as JMem
from repro.core.builder import GraphBuilder
from repro.core.quantize import quantize_graph as j_quantize
from repro_torch.core import memory as TMem

from _torch_parity import carry

SHAPES = {"sine": (1, 1), "speech": (1, 49, 40, 1), "person": (1, 96, 96, 1)}
PAGES = {"sine": {0: 16, 1: 16}, "speech": {2: 4}, "person": {29: 2}}


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """name -> (JAX quantized graph, the port's copy, the float graph in
    both packages)."""
    from repro_torch.configs import paper_models as TM
    out = {}
    tmp = tmp_path_factory.mktemp("mem")
    for name, shape in SHAPES.items():
        rng = np.random.default_rng(7)
        jq = j_quantize(JM.PAPER_MODELS[name](),
                        [rng.normal(0, 1, shape).astype("f")])
        out[name] = (jq, carry(jq, tmp, f"{name}.msgpack"),
                     JM.PAPER_MODELS[name](), TM.PAPER_MODELS[name]())
    return out


def _random_mlp(seed, depth):
    """``tests/test_memory.py::_random_mlp``."""
    rng = np.random.default_rng(seed)
    dims = rng.integers(4, 40, depth + 1)
    b = GraphBuilder("m")
    h = b.input("x", (1, int(dims[0])))
    for i in range(depth):
        w = rng.normal(0, 0.3, (int(dims[i]), int(dims[i + 1]))).astype("f")
        h = b.fully_connected(h, w,
                              rng.normal(size=int(dims[i + 1])).astype("f"),
                              fused="RELU", name=f"fc{i}")
    b.output(h)
    return j_quantize(b.build(), [rng.normal(size=(1, int(dims[0])))
                                  .astype("f") for _ in range(2)])


def _lifetimes(lt):
    return {t: (v.first, v.last) for t, v in lt.items()}


def test_paper_atmega_example():
    """Sec. 4.3: a 32×32 dense layer needs about 5 kB unpaged; 32 pages →
    163 B."""
    assert TMem.fc_full_bytes(32, 32) == JMem.fc_full_bytes(32, 32) == 5216
    assert TMem.fc_page_bytes(32, 32, 32) == JMem.fc_page_bytes(32, 32, 32) == 163


@pytest.mark.parametrize("n_in,n_out,pages,itemsize", [
    (32, 32, 1, 1), (32, 32, 4, 1), (256, 256, 8, 1), (4000, 4, 4, 1),
    (16, 16, 16, 4), (256, 2, 2, 1)])
def test_fc_byte_counts_match(n_in, n_out, pages, itemsize):
    assert (TMem.fc_page_bytes(n_in, n_out, pages, itemsize)
            == JMem.fc_page_bytes(n_in, n_out, pages, itemsize))
    assert (TMem.fc_full_bytes(n_in, n_out, itemsize)
            == JMem.fc_full_bytes(n_in, n_out, itemsize))


def test_fc_page_bytes_rejects_uneven_pages():
    with pytest.raises(AssertionError):
        TMem.fc_page_bytes(32, 32, 5)


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("quantized", [True, False])
def test_arena_and_liveness_match(graphs, name, quantized):
    jq, tq, jf, tf = graphs[name]
    jg, tg = (jq, tq) if quantized else (jf, tf)
    assert _lifetimes(TMem.liveness(tg)) == _lifetimes(JMem.liveness(jg))
    ta, ja = TMem.plan_arena(tg), JMem.plan_arena(jg)
    assert ta.offsets == ja.offsets
    assert ta.arena_bytes == ja.arena_bytes


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("accounting", ["paper", "fused"])
def test_stack_plan_matches(graphs, name, accounting):
    jq, tq, _, _ = graphs[name]
    ts, js = TMem.plan_stack(tq, accounting), JMem.plan_stack(jq, accounting)
    assert (ts.per_op, ts.peak_bytes, ts.residual_bytes) == \
        (js.per_op, js.peak_bytes, js.residual_bytes)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_paged_plan_matches(graphs, name):
    jq, tq, _, _ = graphs[name]
    for pages in ({}, PAGES[name]):
        tp, jp = TMem.plan_paged(tq, pages), JMem.plan_paged(jq, pages)
        assert (tp.per_op, tp.peak_bytes, tp.pages) == \
            (jp.per_op, jp.peak_bytes, jp.pages)
    # paging never raises the peak, and lowers the paged layers' own bytes
    paged = TMem.plan_paged(tq, PAGES[name])
    stack = TMem.plan_stack(tq)
    assert paged.peak_bytes <= stack.peak_bytes
    for i in PAGES[name]:
        assert paged.per_op[i] < stack.per_op[i]


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_memory_report_matches(graphs, name):
    jq, tq, _, _ = graphs[name]
    assert TMem.memory_report(tq).as_dict() == JMem.memory_report(jq).as_dict()


@pytest.mark.parametrize("seed,depth", [(0, 1), (1, 3), (2, 6), (3, 4)])
def test_random_mlp_plans_match(tmp_path, seed, depth):
    jq = _random_mlp(seed, depth)
    tq = carry(jq, tmp_path)
    assert TMem.plan_arena(tq).offsets == JMem.plan_arena(jq).offsets
    assert TMem.plan_stack(tq).per_op == JMem.plan_stack(jq).per_op
    pages = {i: 2 for i, op in enumerate(jq.ops)
             if jq.tensor(op.inputs[1]).shape[1] % 2 == 0}
    assert TMem.plan_paged(tq, pages).per_op == JMem.plan_paged(jq, pages).per_op
