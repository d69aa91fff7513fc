"""The port's plan auditor (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``), on the CPU.

The paper models are quantized once, in JAX (``repro.analysis.__main__.
quantized_graph``), and carried into the port, so both auditors read the
same int8 graph. Held against the reference: the verifier's ``(code,
where)`` findings on the paper models and on every seeded mutation, the
no-retrace bucket/chunk math and staging keys, the static arena bound (the
kernel route at a port plan made with ``plan_layout(quantum=128)``, which
reproduces the reference's ``LayoutPlan``; the engine's quantum-32 plan has
no JAX twin), the output bounds serving guards with, and the selftest's
five seeded plans. Held within the port: static bytes against the measured
walk of the real lowerings, and the derived pad/cat budget against the
calls the forward makes.

The JAX file's jaxpr pad-pin tests (``test_pad_budget_equals_traced`` and
the pins of ``test_layout*.py``) have no port twin: the port's budget
counts torch calls under a ``TorchFunctionMode``, derived from its own
plan, and does not mirror jaxpr primitive counts.
"""
import collections
import copy
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.analysis import arena_liveness as j_arena
from repro.analysis import reachable_buckets as j_reachable_buckets
from repro.analysis import reachable_chunk_batches as j_reachable_chunks
from repro.analysis import reachable_stage_keys as j_reachable_keys
from repro.analysis import static_output_bounds as j_bounds
from repro.analysis import verify_plan as j_verify
from repro.analysis import warmed_buckets as j_warmed_buckets
from repro.analysis import warmed_stage_keys as j_warmed_keys
from repro.analysis.liveness import xla_advisory as j_xla_advisory
from repro.analysis.__main__ import quantized_graph as j_quantized_graph
from repro.core import CompiledModel as JModel
from repro.core import ExecutionPlan as JPlan
from repro.core import graph as JG
from repro_torch.analysis import (arena_liveness, audit_pads, audit_retrace,
                                  device_advisory, errors, lint_weak_types,
                                  measure_live_bytes, measured_pads,
                                  pad_budget, paged_peak_bytes,
                                  reachable_buckets, reachable_chunk_batches,
                                  reachable_stage_keys, static_output_bounds,
                                  to_json, to_markdown, verify_plan,
                                  warmed_buckets, warmed_stage_keys)
from repro_torch.analysis import __main__ as cli
from repro_torch.core import graph as TG
from repro_torch.core.engine import CompiledModel as TModel
from repro_torch.core.engine import ExecutionPlan as TPlan
from repro_torch.core.ops_ref import same_pads
from repro_torch.core.preprocess import plan_layout, preprocess_graph
from repro_torch.kernels.ops import conv_runs_fused

from _torch_parity import carry

MODELS = ("sine", "speech", "person")
ROUTES = (False, True)
SHAPES = ((False, 1), (True, 1), (True, 4))  # (batched, bucket)


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """name -> (JAX-quantized paper graph, its port carry)."""
    tmp = tmp_path_factory.mktemp("graphs")
    out = {}
    for name in MODELS:
        jg = j_quantized_graph(name)
        out[name] = (jg, carry(jg, tmp, f"{name}.msgpack"))
    return out


def _plans(graphs, name, route):
    jg, tg = graphs[name]
    return (JPlan.build(jg, use_pallas=route),
            TPlan.build(tg, use_kernels=route, device="cpu"))


def _q128(plan):
    """The port's plan with the reference's layout (quantum 128)."""
    g = plan.graph
    lay = plan_layout(g, preprocess_graph(g), quantum=128)
    return dataclasses.replace(plan, layout=lay.to(plan.device))


def _on_card(plan):
    """The plan labelled for the card: what the budget derives there (the
    derivation reads only shapes and the device)."""
    return dataclasses.replace(plan, device=torch.device("cuda"))


def _found(findings):
    return collections.Counter((f.code, f.where) for f in findings)


# ------------------------------------------------------------- verifier --

@pytest.mark.parametrize("route", ROUTES, ids=["plain", "kernels"])
@pytest.mark.parametrize("name", MODELS)
def test_verifier_matches_reference_on_paper_models(graphs, name, route):
    jplan, tplan = _plans(graphs, name, route)
    got = verify_plan(tplan)
    assert not errors(got), [str(f) for f in errors(got)]
    assert _found(got) == _found(j_verify(jplan))


def _mutate(G, g, mutation):
    """The reference test's seeded defects, on either package's graph;
    returns the code the verifier must raise."""
    i = next(i for i, op in enumerate(g.ops) if op.op == G.FULLY_CONNECTED)
    op = g.ops[i]
    if mutation == "swapped_scales":
        w = g.tensor(op.inputs[1])
        b = g.tensor(op.inputs[2])
        b.qparams = G.QParams(np.asarray(w.qparams.scale),
                              np.zeros(np.asarray(w.qparams.scale).shape,
                                       np.int32), axis=b.qparams.axis)
        return "V024"
    if mutation == "dropped_zero_point":
        w = g.tensor(op.inputs[1])
        w.qparams = G.QParams(np.asarray(w.qparams.scale), np.int32(0),
                              axis=w.qparams.axis)
        return "V020"
    assert mutation == "dangling_ref"
    op.inputs = [len(g.tensors) + 7] + list(op.inputs[1:])
    return "V001"


@pytest.mark.parametrize("mutation", ["swapped_scales", "dropped_zero_point",
                                      "dangling_ref"])
@pytest.mark.parametrize("name", MODELS)
def test_verifier_matches_reference_on_seeded_mutations(graphs, name,
                                                        mutation):
    """The same defect seeded into both packages' graph: the same ``(code,
    where)`` findings, the expected code among the errors."""
    jg, tg = (copy.deepcopy(g) for g in graphs[name])
    code = _mutate(JG, jg, mutation)
    assert _mutate(TG, tg, mutation) == code
    want = j_verify(JPlan(jg, {}, None, {}, False))
    got = verify_plan(cli._bare_plan(tg))
    assert any(f.code == code for f in errors(got)), [str(f) for f in got]
    assert _found(got) == _found(want)


def test_verifier_route_checks(graphs):
    _, tg = graphs["sine"]
    plan = TPlan.build(tg, use_kernels=False, device="cpu")
    fc0 = next(i for i, op in enumerate(tg.ops)
               if op.op == TG.FULLY_CONNECTED)
    n_out = tg.tensor(tg.ops[fc0].inputs[1]).shape[1]
    bad = dataclasses.replace(plan, paged={fc0: n_out + 1})
    assert any(f.code == "V032" for f in errors(verify_plan(bad)))
    # a layout handed to a plan that never takes the kernel route: warning
    planned = TPlan.build(tg, use_kernels=True, device="cpu")
    off = dataclasses.replace(planned, use_kernels=False)
    assert any(f.code == "V035" for f in verify_plan(off))


@pytest.mark.parametrize("route", ROUTES, ids=["plain", "kernels"])
@pytest.mark.parametrize("name", MODELS)
def test_static_output_bounds_match_reference(graphs, name, route):
    """The bounds serving's output guard enforces, from the port's plan,
    equal the reference's; the guard takes them from the auditor."""
    from repro_torch.serve import resilience
    jplan, tplan = _plans(graphs, name, route)
    assert static_output_bounds(tplan) == j_bounds(jplan)
    assert not hasattr(resilience, "static_output_bounds")


# ------------------------------------------------------------ no-retrace --

@pytest.mark.parametrize("max_batch", range(1, 41))
def test_retrace_math_matches_reference(graphs, max_batch):
    """Buckets and chunks reachable from ``max_batch`` and warmed by
    ``warmup_batched(max_batch)``, and the staging keys of both, equal the
    reference's (plain route, and the kernel route at quantum 128)."""
    assert reachable_buckets(max_batch) == j_reachable_buckets(max_batch)
    assert reachable_chunk_batches(max_batch) == \
        j_reachable_chunks(max_batch)
    assert warmed_buckets(max_batch) == j_warmed_buckets(max_batch)
    for route in ROUTES:
        jplan, tplan = _plans(graphs, "speech", route)
        if route:
            tplan = _q128(tplan)
        assert reachable_stage_keys(tplan, max_batch) == \
            j_reachable_keys(jplan, max_batch)
        assert warmed_stage_keys(tplan, max_batch) == \
            j_warmed_keys(jplan, max_batch)


@pytest.mark.parametrize("route", ROUTES, ids=["plain", "kernels"])
def test_retrace_live_cross_check(graphs, route):
    """A warmed engine covers every reachable bucket and staging key; the
    port's staging keys equal the reference's staged-pad cache keys (plain
    route, where both stage the same widths); under-warmed, R001/R003."""
    jg, tg = graphs["sine"]
    cm = TModel(tg, use_kernels=route, device="cpu").warmup_batched(4)
    info, findings = audit_retrace(cm.exec_plan, 4, compiled_model=cm)
    assert info["ok"], [str(f) for f in findings]
    assert set(info["reachable_buckets"]) <= set(info["live_buckets"])
    assert info["live_stage_keys"] == info["reachable_stage_keys"]
    if not route:
        jm = JModel(jg).warmup_batched(4)
        assert cm.staged_pad_keys() == jm.staged_pad_keys()
    info, findings = audit_retrace(cm.exec_plan, 16, warm_batch=4,
                                   compiled_model=cm)
    assert not info["ok"]
    assert {"R001", "R003", "R004"} <= {f.code for f in errors(findings)}


def test_no_retrace_runtime_counter(graphs):
    """The runtime half of the proof: after warmup_batched, a storm of
    every batch size (0 included) does not move compile_events."""
    _, tg = graphs["sine"]
    cm = TModel(tg, device="cpu").warmup_batched(4)
    t = tg.tensor(tg.inputs[0])
    events = cm.compile_events
    assert events == 3
    for batch in (0, 1, 2, 3, 4, 5, 7, 8, 11):
        x = np.zeros((batch,) + t.shape, np.dtype(t.dtype))
        assert np.asarray(cm.predict_q_many(x, max_batch=4)).shape[0] == batch
    assert cm.compile_events == events


def test_capture_safety_lint(graphs):
    """The port target of the weak-type lint: every constant a forward
    uses on the device is a tensor there, and every host field a numpy
    value."""
    _, tg = graphs["sine"]
    plan = TPlan.build(tg, use_kernels=True, device="cpu")
    assert lint_weak_types(plan) == []
    fc0 = sorted(plan.folded)[0]
    for field, value, code in (("s_y", 0.5, "R010"),
                               ("rescale", np.float32([1.0]), "R010"),
                               ("z_x", torch.tensor(0), "R010")):
        folded = dict(plan.folded)
        folded[fc0] = dataclasses.replace(folded[fc0], **{field: value})
        bad = dataclasses.replace(plan, folded=folded)
        assert [(f.code, f.where) for f in lint_weak_types(bad)] == [
            (code, f"op {fc0} folded.{field}")]
    layouts = dict(plan.layout.layouts)
    lay = layouts[fc0]
    layouts[fc0] = dataclasses.replace(lay, w_phys=lay.w_phys.numpy())
    bad = dataclasses.replace(plan, layout=dataclasses.replace(
        plan.layout, layouts=layouts))
    assert [f.code for f in lint_weak_types(bad)] == ["R011"]


# ------------------------------------------------------- arena liveness --

@pytest.mark.parametrize("route", ROUTES, ids=["plain", "kernels"])
@pytest.mark.parametrize("name", MODELS)
def test_arena_liveness_matches_reference(graphs, name, route):
    """The static bound, step by step, equals the reference's: on the
    plain route as built, on the kernel route at quantum 128."""
    jplan, tplan = _plans(graphs, name, route)
    if route:
        tplan = _q128(tplan)
    for batched, bucket in SHAPES:
        got = arena_liveness(tplan, batched=batched, bucket=bucket)
        want = j_arena(jplan, batched=batched, bucket=bucket)
        assert (got.peak_bytes, got.peak_step, got.per_step_bytes) == \
            (want.peak_bytes, want.peak_step, want.per_step_bytes)


@pytest.mark.parametrize("route", ROUTES, ids=["plain", "kernels"])
@pytest.mark.parametrize("name", MODELS)
def test_arena_static_equals_measured(graphs, name, route):
    """The static bound of the engine's own plan equals the measured walk
    of the real lowerings, abstract (FakeTensorMode) and concrete."""
    _, tplan = _plans(graphs, name, route)
    for batched, bucket in SHAPES:
        bound = arena_liveness(tplan, batched=batched, bucket=bucket)
        abstract = measure_live_bytes(tplan, batched=batched, bucket=bucket)
        concrete = measure_live_bytes(tplan, batched=batched, bucket=bucket,
                                      concrete=True)
        assert bound.peak_bytes == abstract == concrete > 0, (
            batched, bucket, bound.peak_bytes, abstract, concrete)


def test_paged_and_device_advisory(graphs):
    _, tg = graphs["sine"]
    fc0 = next(i for i, op in enumerate(tg.ops)
               if op.op == TG.FULLY_CONNECTED)
    plan = TPlan.build(tg, use_kernels=False, device="cpu", paged={fc0: 2})
    assert not errors(verify_plan(plan))
    assert paged_peak_bytes(plan) > 0
    assert paged_peak_bytes(TPlan.build(tg, device="cpu")) is None
    # no graph pool on the CPU: only the cost analysis's bytes
    cm = TModel(tg, device="cpu")
    assert device_advisory(cm) == {
        "bytes_accessed": cm.cost_analysis()["bytes accessed"]}


@pytest.mark.parametrize("route", ROUTES, ids=["plain", "kernels"])
@pytest.mark.parametrize("name", MODELS)
def test_device_advisory_bytes_accessed(graphs, name, route):
    """``bytes_accessed`` as the reference's ``xla_advisory`` has it, read
    from ``cost_analysis()``: the model's bytes, at most XLA's count of the
    reference's plain route, the same on both routes, and present on the
    CPU, where the memory keys are not."""
    jg, tg = graphs[name]
    cm = TModel(tg, use_kernels=route, device="cpu")
    got = device_advisory(cm)
    assert set(got) == {"bytes_accessed"}
    assert got["bytes_accessed"] == cm.cost_analysis()["bytes accessed"] \
        == device_advisory(TModel(tg, use_kernels=not route,
                                  device="cpu"))["bytes_accessed"]
    xla = j_xla_advisory(JModel(jg, use_pallas=False))["bytes_accessed"]
    assert 0 < got["bytes_accessed"] <= xla


# ------------------------------------------------------------ pad budget --

def _dropped_on_card(plan):
    """The pad/cat calls of the CPU's forward that the card's kernels make
    themselves, from the plan's geometry: each depthwise SAME border with a
    halo, and for each multi-tap planned conv (the fused conv kernel) its
    SAME border with a halo, its im2col concatenation and its K pad where
    the weight's K is not kh*kw*in_lanes."""
    dropped = 0
    layouts = plan.layout.layouts if plan.layout is not None else {}
    for i, lay in layouts.items():
        if lay.kind == "fc":
            continue
        op = plan.graph.ops[i]
        kh, kw = plan.graph.tensor(op.inputs[1]).shape[:2]
        h, w = plan.graph.tensor(op.inputs[0]).shape[1:3]
        halo = op.attrs["padding"] == "SAME" and any(
            sum(same_pads(h, w, kh, kw, tuple(op.attrs["stride"])), ()))
        if lay.kind == "dwconv":
            dropped += int(halo)
        elif conv_runs_fused(kh * kw, "cuda"):
            dropped += int(halo) + 1 + int(
                lay.w_phys.shape[0] != kh * kw * lay.in_lanes)
    return dropped


@pytest.mark.parametrize("batched", [False, True], ids=["percall", "batched"])
@pytest.mark.parametrize("route", ROUTES, ids=["plain", "kernels"])
@pytest.mark.parametrize("name", MODELS)
def test_pad_budget_equals_measured(graphs, name, route, batched):
    """The derived pad/cat calls equal the calls the forward makes on the
    CPU; on the card the derivation drops exactly the calls the kernels
    make themselves: the depthwise SAME borders (13 on person's kernel
    route) and, for each multi-tap planned conv (the fused conv kernel),
    its SAME border where the halo is not zero, its im2col concatenation
    and its K pad where the weight's K is not kh*kw*in_lanes (speech's
    10x8/s2 conv and person's conv0: a border and a concatenation each)."""
    _, tplan = _plans(graphs, name, route)
    dropped = _dropped_on_card(tplan)
    assert dropped == ({"sine": 0, "speech": 2, "person": 13 + 2}[name]
                       if route else 0)
    for bucket in ((1, 2) if batched else (1,)):
        budget = pad_budget(tplan, batched=batched, bucket=bucket)
        assert budget.enforceable
        assert budget.total == measured_pads(tplan, batched=batched,
                                             bucket=bucket), budget.items
        card = pad_budget(_on_card(tplan), batched=batched, bucket=bucket)
        assert budget.total - card.total == dropped
        if route:  # the planned convs on the card concatenate nothing
            assert not any("im2col" in why for _, _, why in card.items)


@pytest.mark.parametrize("route", ROUTES, ids=["plain", "kernels"])
@pytest.mark.parametrize("name,paged", [("sine", {0: 16, 1: 16}),
                                        ("speech", {2: 4})])
def test_pad_budget_counts_paged_fc(graphs, name, paged, route):
    """A paged FC concatenates its pages in both page loops (one call), and
    on the card's kernel route writes them in place (none); the card's
    kernels also fill the borders and gather the taps of the planned convs
    (speech's conv: two calls)."""
    _, tg = graphs[name]
    plan = TPlan.build(tg, use_kernels=route, device="cpu", paged=paged)
    for batched in (False, True):
        budget = pad_budget(plan, batched=batched, bucket=2)
        assert budget.enforceable
        assert budget.total == measured_pads(plan, batched=batched,
                                             bucket=2), budget.items
        card = pad_budget(_on_card(plan), batched=batched, bucket=2)
        assert budget.total - card.total == (
            len(paged) + _dropped_on_card(plan) if route else 0)


def test_pad_budget_flags_op_knocked_off_plan(graphs):
    _, tg = graphs["sine"]
    plan = TPlan.build(tg, use_kernels=True, device="cpu")
    layouts = dict(plan.layout.layouts)
    layouts.pop(sorted(layouts)[0])
    broken = dataclasses.replace(plan, layout=dataclasses.replace(
        plan.layout, layouts=layouts))
    info, findings = audit_pads(broken)
    assert any(f.code == "B004" for f in errors(findings))
    assert info["missed_plan"] and info["traced"] is None


# ------------------------------------------------------------ CLI / e2e --

def test_audit_plan_end_to_end(graphs):
    _, tg = graphs["sine"]
    cm = TModel(tg, device="cpu").warmup_batched(4)
    rep = cli.audit_plan("sine", cm.exec_plan, max_batch=4,
                         compiled_model=cm)
    assert rep.ok, [str(f) for f in errors(rep.findings)]
    assert {"per-call", "batched[b=1]", "batched[b=2]",
            "batched[b=4]"} <= {r.route for r in rep.routes}
    doc = json.loads(to_json([rep]))
    assert doc["ok"] and doc["models"][0]["use_kernels"] is True
    assert doc["models"][0]["fingerprint"].startswith("pf1-")
    md = to_markdown([rep])
    assert "sine" in md and "no-retrace" in md and "proved" in md


def test_selftest_catches_every_seeded_plan():
    assert cli.selftest(verbose=False, device="cpu") == []


def test_cli_writes_reports_under_tmp_path(tmp_path):
    js, md = tmp_path / "audit.json", tmp_path / "audit.md"
    assert cli.main(["--models", "sine", "--device", "cpu", "--json",
                     str(js), "--markdown", str(md)]) == 0
    doc = json.loads(js.read_text())
    assert doc["ok"] and [m["use_kernels"] for m in doc["models"]] == [
        False, True]
    assert "# Static plan audit" in md.read_text()
    assert cli.main(["--selftest", "--device", "cpu"]) == 0
