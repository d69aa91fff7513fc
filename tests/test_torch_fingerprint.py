"""The plan fingerprint and the executable-cache manifest of the port
(``repro_torch.analysis.fingerprint``): the port of the fingerprint and
manifest cases of ``tests/test_aotcache.py`` that need no cache.

The fingerprint is stable across builds and changes on one folded constant,
one layout entry, the route flag or one weight bit; plans of the same graph
and flags fingerprint alike whatever device they were built for (tensors
are hashed from host copies). ``verify_manifest`` rejects a stale plan
(C001), partial coverage (C002), a wrong digest (C003), another environment
(C004) and a disagreeing audit document (C005), here through
``build_manifest`` / ``verify_manifest`` directly; the cases that go
through a stored cache wait for the executable cache itself.
"""
import copy
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from repro.analysis.__main__ import quantized_graph as j_quantized_graph
from repro_torch.analysis import (build_manifest, environment_info,
                                  plan_fingerprint, stage_key_id,
                                  verify_manifest, warmed_buckets,
                                  warmed_stage_keys)
from repro_torch.analysis.fingerprint import kernel_sources_sha256
from repro_torch.core.engine import ExecutionPlan
from repro_torch.core.preprocess import plan_layout, preprocess_graph

from _torch_parity import carry


@pytest.fixture(scope="module")
def sine(tmp_path_factory):
    return carry(j_quantized_graph("sine"), tmp_path_factory.mktemp("g"))


def _plan(g, **kw):
    return ExecutionPlan.build(copy.deepcopy(g), device="cpu", **kw)


def _bytes(name: str) -> bytes:
    return f"entry {name}".encode()


def _manifest(plan, warm_batch, **extra):
    """A manifest for ``plan`` warmed to ``warm_batch``, entries named as
    a cache names them, with digests of stand-in bytes."""
    names = [f"bucket_{b}" for b in warmed_buckets(warm_batch)] + [
        f"stage_{stage_key_id(k)}" for k in warmed_stage_keys(plan,
                                                             warm_batch)]
    entries = {n: hashlib.sha256(_bytes(n)).hexdigest() for n in names}
    man = build_manifest(plan, warm_batch, entries,
                         extra={"model": "sine",
                                "use_kernels": plan.use_kernels, **extra})
    return man, {n: _bytes(n) for n in names}


def _codes(findings):
    return {f.code for f in findings}


# ------------------------------------------------------ fingerprint -----

@pytest.mark.parametrize("use_kernels", [False, True])
def test_fingerprint_stable_across_builds(sine, use_kernels):
    a = _plan(sine, use_kernels=use_kernels)
    b = _plan(sine, use_kernels=use_kernels)
    assert plan_fingerprint(a) == plan_fingerprint(b)
    assert plan_fingerprint(a).startswith("pf1-")


def test_fingerprint_ignores_the_device(sine):
    """The plan's device is not hashed, and tensors are hashed by value:
    the same plan with copies of every constant, labelled for another
    device, fingerprints the same. (chip_smoke's ``audit`` phase compares
    a plan built on the card with one built on the CPU.)"""
    plan = _plan(sine, use_kernels=True)
    again = dataclasses.replace(
        plan, folded={i: fc.to("cpu") for i, fc in plan.folded.items()},
        layout=plan.layout.to("cpu"),
        consts={t: v.clone() for t, v in plan.consts.items()},
        device=torch.device("cuda"))
    assert plan_fingerprint(again) == plan_fingerprint(plan)


def test_fingerprint_changes_on_folded_const(sine):
    plan = _plan(sine)
    fp = plan_fingerprint(plan)
    mutated = copy.deepcopy(plan)
    fc = mutated.folded[sorted(mutated.folded)[0]]
    fc.bias_term.view(-1)[0] += 1  # one retrained-weight-worth of drift
    assert plan_fingerprint(mutated) != fp


def test_fingerprint_changes_on_layout_entry(sine):
    plan = _plan(sine, use_kernels=True)
    fp = plan_fingerprint(plan)
    tid = sorted(plan.layout.phys)[0]
    phys = dict(plan.layout.phys)
    phys[tid] = tuple(d + 8 for d in phys[tid])  # one re-planned lane pad
    mutated = dataclasses.replace(
        plan, layout=dataclasses.replace(plan.layout, phys=phys))
    assert plan_fingerprint(mutated) != fp
    # the lane quantum is part of the plan
    g = plan.graph
    q128 = dataclasses.replace(plan, layout=plan_layout(
        g, preprocess_graph(g), quantum=128).to("cpu"))
    assert plan_fingerprint(q128) != fp


def test_fingerprint_changes_on_route_flags(sine):
    plain = _plan(sine, use_kernels=False)
    kernels = _plan(sine, use_kernels=True)
    flipped = dataclasses.replace(plain, use_kernels=True)
    fps = {plan_fingerprint(p) for p in (plain, kernels, flipped)}
    assert len(fps) == 3


def test_fingerprint_changes_on_graph_weight(sine):
    g = copy.deepcopy(sine)
    fp = plan_fingerprint(_plan(g))
    w = next(t for t in g.tensors if t.data is not None
             and np.asarray(t.data).size)
    w.data = np.array(w.data)
    w.data.flat[0] = w.data.flat[0] ^ 1  # one flipped weight bit
    assert plan_fingerprint(_plan(g)) != fp


def test_environment_info_names_the_device_and_the_sources():
    env = environment_info("cpu")
    assert env == {"torch": torch.__version__, "cuda": str(torch.version.cuda),
                   "device": "cpu", "capability": "none",
                   "kernels_sha256": kernel_sources_sha256()}
    assert len(env["kernels_sha256"]) == 64


# ------------------------------------------------ manifest verification --

def test_manifest_admits_its_own_plan(sine):
    plan = _plan(sine, use_kernels=True)
    man, blobs = _manifest(plan, 4)
    info, findings = verify_manifest(man, plan, 4, entry_bytes=blobs)
    assert info["ok"] and info["digests_checked"], [str(f) for f in findings]
    assert info["required_buckets"] == [1, 2, 4]
    assert info["required_stage_keys"] == 4  # lane pad: every batch 1..4


def test_manifest_rejects_stale_plan(sine):
    plan = _plan(sine)
    man, _ = _manifest(plan, 4)
    mutated = copy.deepcopy(plan)
    mutated.folded[sorted(mutated.folded)[0]].rescale.view(-1)[0] += 1
    info, findings = verify_manifest(man, mutated, 4)
    assert not info["ok"] and "C001" in _codes(findings)


def test_manifest_rejects_partial_coverage(sine):
    """A manifest warmed to 2 cannot admit a replica serving 4 (C002)."""
    plan = _plan(sine, use_kernels=True)
    man, _ = _manifest(plan, 2)
    info, findings = verify_manifest(man, plan, 4)
    assert not info["ok"] and "C002" in _codes(findings)


def test_manifest_rejects_corrupt_entry(sine):
    plan = _plan(sine)
    man, blobs = _manifest(plan, 4)
    blobs["bucket_2"] = blobs["bucket_2"][:4]  # truncated
    info, findings = verify_manifest(man, plan, 4, entry_bytes=blobs)
    assert not info["ok"]
    assert [(f.code, f.where) for f in findings] == [("C003", "bucket_2")]
    del blobs["bucket_2"]  # missing on disk
    _, findings = verify_manifest(man, plan, 4, entry_bytes=blobs)
    assert [(f.code, f.where) for f in findings] == [("C003", "bucket_2")]
    del man["entries"]["bucket_4"]  # absent from the entry table
    _, findings = verify_manifest(man, plan, 4)
    assert ("C003", "bucket_4") in {(f.code, f.where) for f in findings}


@pytest.mark.parametrize("key", ["torch", "cuda", "device", "capability",
                                 "kernels_sha256"])
def test_manifest_rejects_environment_mismatch(sine, key):
    plan = _plan(sine)
    man, _ = _manifest(plan, 2)
    man["environment"][key] = "0.0.0"
    info, findings = verify_manifest(man, plan, 2)
    assert not info["ok"]
    assert [(f.code, f.where) for f in findings] == [
        ("C004", f"environment.{key}")]


def test_manifest_audit_cross_check(sine):
    """Audit documents (``python -m repro_torch.analysis --json``) arm the
    C005 cross-check: an audit proving a bucket reachable that the manifest
    lacks, or carrying another fingerprint, rejects the cache; entries for
    the other route are ignored."""
    plan = _plan(sine, use_kernels=False)
    man, _ = _manifest(plan, 4)
    fp = plan_fingerprint(plan)
    ok_audit = {"models": [{"model": "sine", "use_kernels": False,
                            "fingerprint": fp,
                            "retrace": {"reachable_buckets": [1, 2, 4]}}]}
    info, findings = verify_manifest(man, plan, 4, audit=ok_audit)
    assert info["ok"] and info["audit_checked"], [str(f) for f in findings]

    wide = {"models": [{"model": "sine", "use_kernels": False,
                        "retrace": {"reachable_buckets": [1, 2, 4, 8]}}]}
    _, findings = verify_manifest(man, plan, 4, audit=wide)
    assert "C005" in _codes(findings)

    other = {"models": [{"model": "sine", "use_kernels": False,
                         "fingerprint": "pf1-deadbeef",
                         "retrace": {"reachable_buckets": [1]}}]}
    _, findings = verify_manifest(man, plan, 4, audit=other)
    assert "C005" in _codes(findings)

    cross = {"models": [{"model": "sine", "use_kernels": True,
                         "fingerprint": "pf1-deadbeef",
                         "retrace": {"reachable_buckets": [1, 2, 4, 8]}}]}
    info, findings = verify_manifest(man, plan, 4, audit=cross)
    assert info["ok"], [str(f) for f in findings]
