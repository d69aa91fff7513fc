"""Static memory planning (paper Sec. 4) — the port of ``repro.core.memory``.

Three planners, all byte-exact and computed at compile time, in numpy:

* :func:`plan_arena` — the interpreter baseline (TFLM, Sec. 4.2): one tensor
  arena sized by greedy first-fit over activation lifetimes; the arena is
  allocated for the entire inference and never shrinks.
* :func:`plan_stack` — MicroFlow's ownership model (Sec. 4.1–4.2): each
  operator owns its input, borrows constants, and drops the input after
  producing its output; peak memory is the largest single operator working
  set, and memory after inference is zero.
* :func:`plan_paged` — Sec. 4.3: a layer is split into pages (all
  connections into one output unit, Fig. 6); peak memory is per page. It
  reproduces the paper's ATmega328 example (5216 B unpaged, 163 B with 32
  pages).

Accounting follows the paper's footnote 13: for a weighted op the working
set counts input + output + bias vectors, the weights resident in RAM, and
the 32-bit accumulators / intermediate products used by the kernel.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from . import graph as G


# ---------------------------------------------------------------------------
# Liveness
# ---------------------------------------------------------------------------

@dataclass
class Lifetime:
    first: int  # op index producing it (-1 for graph inputs)
    last: int   # last op index consuming it (len(ops) for graph outputs)


def liveness(g: G.Graph) -> dict:
    """Tensor id -> Lifetime, for activation tensors only."""
    n_ops = len(g.ops)
    lt = {}
    for tid in g.inputs:
        lt[tid] = Lifetime(first=-1, last=-1)
    for i, op in enumerate(g.ops):
        for t in op.inputs:
            if not g.tensor(t).is_const and t in lt:
                lt[t].last = max(lt[t].last, i)
        for t in op.outputs:
            lt[t] = Lifetime(first=i, last=i)
    for tid in g.outputs:
        lt[tid].last = n_ops  # graph outputs stay live to the end
    return lt


# ---------------------------------------------------------------------------
# Arena planner (TFLM-style interpreter baseline)
# ---------------------------------------------------------------------------

@dataclass
class ArenaPlan:
    offsets: dict          # tensor id -> byte offset
    arena_bytes: int       # total arena (lives for the whole inference)
    lifetimes: dict


def plan_arena(g: G.Graph) -> ArenaPlan:
    """Greedy first-fit offset assignment (largest first), the strategy of
    TFLM's ``GreedyMemoryPlanner``."""
    lt = liveness(g)
    ids = sorted(lt.keys(), key=lambda t: -g.tensor(t).nbytes)
    placed = []  # (offset, size, first, last)
    offsets = {}
    for tid in ids:
        size = g.tensor(tid).nbytes
        life = lt[tid]
        # forbidden intervals: tensors whose lifetimes overlap this one's
        overlaps = sorted(
            (off, off + sz) for off, sz, f, l in placed
            if not (l < life.first or f > life.last))
        pos = 0
        for a, b in overlaps:
            if pos + size <= a:
                break
            pos = max(pos, b)
        offsets[tid] = pos
        placed.append((pos, size, life.first, life.last))
    arena = max((off + g.tensor(t).nbytes for t, off in offsets.items()),
                default=0)
    return ArenaPlan(offsets=offsets, arena_bytes=int(arena), lifetimes=lt)


# ---------------------------------------------------------------------------
# Working-set accounting (paper footnote 13)
# ---------------------------------------------------------------------------

def op_working_set(g: G.Graph, op: G.OpNode, accounting: str = "paper") -> int:
    """Bytes held while this operator executes.

    ``accounting="paper"``: footnote-13 style — the kernel materializes the
    full int32 product/accumulator block (4·n·p for an n→p dense layer).
    ``accounting="fused"``: accumulators only, one per output element (what
    a fused kernel holds).
    """
    acts = [t for t in op.inputs if not g.tensor(t).is_const]
    consts = [t for t in op.inputs if g.tensor(t).is_const]
    total = sum(g.tensor(t).nbytes for t in acts + consts + list(op.outputs))

    out_elems = int(np.prod(g.tensor(op.outputs[0]).shape, dtype=np.int64))
    if op.op == G.FULLY_CONNECTED:
        n, p = g.tensor(op.inputs[1]).shape
        if accounting == "paper":
            total += 4 * n * p          # int32 intermediate products
        else:
            total += 4 * out_elems      # int32 accumulators
    elif op.op in (G.CONV_2D, G.DEPTHWISE_CONV_2D, G.AVERAGE_POOL_2D):
        total += 4 * out_elems          # int32 accumulators per output
    return int(total)


@dataclass
class StackPlan:
    per_op: list           # working-set bytes per op
    peak_bytes: int        # max over ops (MicroFlow's RAM requirement)
    residual_bytes: int    # memory held after inference (always 0)


def plan_stack(g: G.Graph, accounting: str = "paper") -> StackPlan:
    per_op = [op_working_set(g, op, accounting) for op in g.ops]
    return StackPlan(per_op=per_op, peak_bytes=max(per_op, default=0),
                     residual_bytes=0)


# ---------------------------------------------------------------------------
# Paging (Sec. 4.3) — executed by core.paging and kernels.paged_matmul
# ---------------------------------------------------------------------------

def fc_page_bytes(n_in: int, n_out: int, n_pages: int,
                  weight_itemsize: int = 1) -> int:
    """RAM for one page of a FullyConnected layer split into ``n_pages``.

    A page carries the connections from all n_in inputs to n_out/n_pages
    output units (Fig. 6): its weights, the int32 intermediate products for
    those units, plus one bias / input / output element slot each — the
    accounting of the paper's ATmega328 example (32×32 layer, 32 pages →
    163 bytes)."""
    assert n_out % n_pages == 0, (n_out, n_pages)
    per_page_out = n_out // n_pages
    weights = n_in * per_page_out * weight_itemsize
    accumulators = 4 * n_in * per_page_out
    vectors = 3 * per_page_out  # bias, input slot, output slot per unit
    return int(weights + accumulators + vectors)


def fc_full_bytes(n_in: int, n_out: int, weight_itemsize: int = 1) -> int:
    """Unpaged working set of the same layer (paper footnote 13)."""
    return int(n_in * n_out * weight_itemsize + 4 * n_in * n_out
               + 3 * n_out)


@dataclass
class PagedPlan:
    per_op: list
    peak_bytes: int
    pages: dict  # op index -> n_pages


def plan_paged(g: G.Graph, pages: dict) -> PagedPlan:
    """Stack plan where the selected FULLY_CONNECTED ops run page by page."""
    per_op = []
    for i, op in enumerate(g.ops):
        if i in pages and op.op == G.FULLY_CONNECTED:
            w = g.tensor(op.inputs[1])
            n_in, n_out = w.shape
            itemsize = np.dtype(w.dtype).itemsize
            x_b = g.tensor(op.inputs[0]).nbytes
            y_b = g.tensor(op.outputs[0]).nbytes
            per_op.append(x_b + y_b + fc_page_bytes(n_in, n_out, pages[i],
                                                    itemsize))
        else:
            per_op.append(op_working_set(g, op))
    return PagedPlan(per_op=per_op, peak_bytes=max(per_op, default=0),
                     pages=dict(pages))


# ---------------------------------------------------------------------------
# Engine memory report (Figs. 9/10 analogue)
# ---------------------------------------------------------------------------

@dataclass
class MemoryReport:
    weight_bytes: int
    arena_bytes: int           # interpreter: persists the whole inference
    stack_peak_bytes: int      # compiled: peak only
    stack_peak_fused: int
    folded_const_bytes: int

    def as_dict(self):
        return dataclasses.asdict(self)


def memory_report(g: G.Graph) -> MemoryReport:
    from .preprocess import folded_const_bytes, preprocess_graph

    return MemoryReport(
        weight_bytes=g.weight_bytes,
        arena_bytes=plan_arena(g).arena_bytes,
        stack_peak_bytes=plan_stack(g, "paper").peak_bytes,
        stack_peak_fused=plan_stack(g, "fused").peak_bytes,
        folded_const_bytes=folded_const_bytes(preprocess_graph(g)),
    )
