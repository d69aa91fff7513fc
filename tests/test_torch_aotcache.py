"""The port's executable cache (``repro_torch.serve.aotcache``) through a
stored cache: the port of the cases of ``tests/test_aotcache.py`` that go
through one, over ``CompiledModel(device="cpu")`` on the three paper
models (the fingerprint-only and manifest-only cases are in
``tests/test_torch_fingerprint.py``).

A CUDA graph cannot be stored, so the cache keeps each bucket's capture
record and, on the card, the kernel libraries; a warm boot makes every
executable again from its record and checks it against the record. Each
fast path is paired with its rejection twin, as in the reference: a stale
plan (C001), partial coverage (C002), a corrupt entry (C003, nothing half
installed), another environment (C004), a disagreeing audit (C005), a
capture unlike its record; and the warm boot counts no build
(``compile_events == 0``), as many captures as the cold boot, and gives
the cold boot's rows, which are the JAX package's. On the CPU an
executable is the eager function and binding it counts as its capture;
the card's libraries and graphs are held by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``'s ``coldstart`` phase.
"""
import asyncio
import copy
import glob
import hashlib
import json
import os
import threading

import numpy as np
import pytest

from repro.analysis.__main__ import quantized_graph as j_quantized_graph
from repro.core import CompiledModel as JModel
from repro_torch.analysis import plan_fingerprint, verify_manifest
from repro_torch.core.engine import CompiledModel
from repro_torch.kernels import _build
from repro_torch.serve.aotcache import AotCache, serialization_support
from repro_torch.serve.registry import ServingRegistry
from repro_torch.serve.scheduler import MicroBatcher

from _torch_parity import assert_i8_equal, assert_softmax_close, carry

MODELS = ("sine", "speech", "person")


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """name -> (JAX-package graph, its port carry)."""
    tmp = tmp_path_factory.mktemp("graphs")
    out = {}
    for name in MODELS:
        jg = j_quantized_graph(name)
        out[name] = (jg, carry(jg, tmp, f"{name}.msgpack"))
    return out


def _model(graphs, name="sine", **kw):
    return CompiledModel(copy.deepcopy(graphs[name][1]), device="cpu", **kw)


def _mutate_folded(cm):
    fc = cm.exec_plan.folded[sorted(cm.exec_plan.folded)[0]]
    fc.rescale.view(-1)[0] += 1  # one retrained-weight-worth of drift


def _rows(cm, batch, seed):
    t = cm.graph.tensor(cm.graph.inputs[0])
    return np.random.default_rng(seed).integers(
        -128, 128, size=(batch,) + tuple(t.shape)).astype(t.dtype)


def test_serialization_is_supported():
    assert serialization_support() == (True, "")


# ------------------------------------------------ manifest verification --

def test_manifest_rejects_stale_plan(graphs, tmp_path):
    """A cache stored for one plan is invisible to a mutated plan: the new
    fingerprint addresses an empty directory, the warm-up misses, builds
    fresh and stores under the NEW address."""
    cache = AotCache(str(tmp_path))
    _model(graphs).warmup_batched(4, cache=cache)
    mutated = _model(graphs)
    _mutate_folded(mutated)
    mutated.warmup_batched(4, cache=cache)
    assert mutated.compile_events > 0  # fresh build, not a stale load
    assert mutated.cache_events["hit"] == 0
    assert mutated.last_cache_result.reason == "no manifest; stored"
    assert len(os.listdir(tmp_path)) == 2  # one dir per fingerprint

    # and the cross-plan manifest check itself reports C001
    man = cache.manifest(plan_fingerprint(_model(graphs).exec_plan))
    info, findings = verify_manifest(man, mutated.exec_plan, 4)
    assert not info["ok"]
    assert any(f.code == "C001" for f in findings)


def test_manifest_rejects_partial_coverage(graphs, tmp_path):
    """A cache warmed to 2 cannot admit a replica serving 4 (C002)."""
    cache = AotCache(str(tmp_path))
    cm = _model(graphs).warmup_batched(2, cache=cache)
    man = cache.manifest(plan_fingerprint(cm.exec_plan))
    info, findings = verify_manifest(man, cm.exec_plan, 4)
    assert not info["ok"]
    assert any(f.code == "C002" for f in findings)
    # and the boot path agrees: load misses, a fresh warm-up builds
    cm2 = _model(graphs)
    cm2.warmup_batched(4, cache=cache)
    assert not cm2.last_cache_result.hit
    assert cm2.compile_events > 0


@pytest.mark.parametrize("entry", ["bucket_2", "percall"])
def test_manifest_rejects_corrupt_entry(graphs, tmp_path, entry):
    """A truncated record digest-fails (C003) and the load is all or
    nothing: the model stays cold and builds everything; the miss path
    stores a good copy again (the cache heals)."""
    cache = AotCache(str(tmp_path))
    cold = _model(graphs)
    cold.compile()  # the per-call executable is recorded too
    cold.warmup_batched(4, cache=cache)
    (path,) = glob.glob(str(tmp_path / "*" / f"{entry}.json"))
    with open(path, "r+b") as f:
        f.truncate(16)
    res = cache.verify(_model(graphs), 4)
    assert not res.hit
    assert [(f.code, f.where) for f in res.findings] == [("C003", entry)]
    cm = _model(graphs)
    cm.warmup_batched(4, cache=cache)
    assert not cm.last_cache_result.hit
    assert cm.cache_events["hit"] == 0  # nothing half-installed
    assert cm.compile_events == 3 and cm.capture_events == 3
    assert cm.cached_percall() is None
    assert cache.stats()["misses"] == 2  # the cold boot, then this one
    assert cache.verify(_model(graphs), 4).hit


@pytest.mark.parametrize("key", ["torch", "cuda", "device", "capability",
                                 "kernels_sha256"])
def test_manifest_rejects_environment_mismatch(graphs, tmp_path, key):
    """A cache made under another torch, CUDA, device, capability or kernel
    sources is rejected (C004), through the manifest and at boot."""
    cache = AotCache(str(tmp_path))
    cm = _model(graphs).warmup_batched(2, cache=cache)
    fp = plan_fingerprint(cm.exec_plan)
    man = cache.manifest(fp)
    man["environment"][key] = "0.0.0"
    info, findings = verify_manifest(man, cm.exec_plan, 2)
    assert not info["ok"]
    assert [(f.code, f.where) for f in findings] == [
        ("C004", f"environment.{key}")]
    with open(cache.manifest_path(fp), "w") as f:
        json.dump(man, f)
    boot = _model(graphs).warmup_batched(2, cache=cache)
    assert not boot.last_cache_result.hit and boot.compile_events == 2
    assert boot.last_cache_result.reason == \
        "manifest rejected (C004); stored"


def test_manifest_audit_cross_check(graphs, tmp_path):
    """Audit documents (``python -m repro_torch.analysis --json``) arm the
    C005 cross-check: an audit proving a bucket reachable that the manifest
    lacks, or carrying another fingerprint, rejects the cache; entries for
    the other route are ignored. At boot (``audit_path``) the auditor's own
    report counts, though it names the model "sine" where the manifest
    names the graph: its entry carries the plan's fingerprint."""
    from repro_torch.analysis.__main__ import audit_plan
    cache = AotCache(str(tmp_path / "c"))
    cm = _model(graphs, use_kernels=False).warmup_batched(4, cache=cache)
    fp = plan_fingerprint(cm.exec_plan)
    man = cache.manifest(fp)
    assert man["use_kernels"] is False and man["model"] == cm.graph.name

    def check(models):
        return verify_manifest(man, cm.exec_plan, 4, audit={"models": models})

    info, findings = check([{"model": man["model"], "use_kernels": False,
                             "fingerprint": fp,
                             "retrace": {"reachable_buckets": [1, 2, 4]}}])
    assert info["ok"] and info["audit_checked"], [str(f) for f in findings]
    wide = [{"model": man["model"], "use_kernels": False,
             "retrace": {"reachable_buckets": [1, 2, 4, 8]}}]
    assert any(f.code == "C005" for f in check(wide)[1])
    other = [{"model": man["model"], "use_kernels": False,
              "fingerprint": "pf1-deadbeef",
              "retrace": {"reachable_buckets": [1]}}]
    assert any(f.code == "C005" for f in check(other)[1])
    cross = [{"model": man["model"], "use_kernels": True,
              "fingerprint": "pf1-deadbeef",
              "retrace": {"reachable_buckets": [1, 2, 4, 8]}}]
    info, findings = check(cross)
    assert info["ok"], [str(f) for f in findings]

    for max_batch, hit in ((4, True), (8, False)):
        rep = audit_plan("sine", cm.exec_plan, max_batch=max_batch)
        audit = tmp_path / f"audit{max_batch}.json"
        audit.write_text(json.dumps({"models": [rep.as_dict()]}))
        boot = _model(graphs, use_kernels=False)
        boot.warmup_batched(4, cache=AotCache(str(tmp_path / "c"),
                                              audit_path=str(audit)))
        res = boot.last_cache_result
        assert res.hit is hit, res
        assert hit or "C005" in {f.code for f in res.findings}


def test_capture_unlike_its_record_is_a_miss(graphs, tmp_path):
    """A record whose shapes differ from the executable the plan makes
    (here: a self-consistent manifest over an altered record) is caught by
    the install step's check: a miss with the reason, nothing installed."""
    cache = AotCache(str(tmp_path))
    cold = _model(graphs).warmup_batched(2, cache=cache)
    fp = plan_fingerprint(cold.exec_plan)
    path = os.path.join(cache.dir_for(fp), "bucket_2.json")
    rec = json.loads(open(path).read())
    rec["outputs"][0][0][0] = 3
    data = json.dumps(rec).encode()
    open(path, "wb").write(data)
    man = cache.manifest(fp)
    man["entries"]["bucket_2"] = hashlib.sha256(data).hexdigest()
    open(cache.manifest_path(fp), "w").write(json.dumps(man))
    assert cache.verify(_model(graphs), 2).hit  # every digest checks out
    cm = _model(graphs)
    cm.warmup_batched(2, cache=cache)
    res = cm.last_cache_result
    assert not res.hit and res.reason.startswith("install failed: ")
    assert "differs from its record in ['outputs']" in res.reason
    assert cache.stats()["misses"] == 2  # the cold boot, then this one
    assert cm.cache_events["hit"] == 0 and cm.compile_events == 2
    # the discarded capture of the failed install is counted too
    assert cm.capture_events == 2 + 2


# ------------------------------------------------------- warm boots -----

@pytest.mark.parametrize("name", MODELS)
def test_warm_boot_zero_compiles_and_bit_exact(graphs, tmp_path, name):
    """The acceptance claim, on every paper model: a warm boot from a
    populated cache counts ZERO builds and as many captures as the cold
    boot, and every bucket gives the cold boot's rows, which are the JAX
    package's ``CompiledModel`` rows on the same graph."""
    cache = AotCache(str(tmp_path))
    cold = _model(graphs, name).warmup_batched(2, cache=cache)
    assert cold.compile_events == cold.capture_events == 2
    assert cold.cache_events["store"] == 1

    warm = _model(graphs, name)
    warm.warmup_batched(2, cache=cache)
    assert warm.compile_events == 0, warm.compile_log
    assert warm.capture_events == cold.capture_events
    assert warm.last_cache_result.hit and warm.last_cache_result.loaded == 2
    assert warm.bucket_sizes() == cold.bucket_sizes()
    assert warm.staged_pad_keys() == cold.staged_pad_keys()

    jm = JModel(graphs[name][0])
    check = assert_i8_equal if name == "sine" else assert_softmax_close
    for batch, seed in ((1, 3), (2, 4)):
        x = _rows(warm, batch, seed)
        a, b = cold.predict_q(x), warm.predict_q(x)
        assert a.dtype == b.dtype and np.array_equal(a, b), (name, batch)
        check(b, np.asarray(jm.predict_q(x)))
    # the whole boot (warm-up + requests above) stayed build-free
    assert warm.compile_events == 0, warm.compile_log
    assert warm.capture_events == cold.capture_events


def test_typed_compile_log(graphs, tmp_path):
    """``compile_events`` counts builds no cache served; the typed log
    tells bucket and percall builds apart and their cache disposition
    (None / miss / hit / store); ``capture_events`` counts every one."""
    cache = AotCache(str(tmp_path))
    cold = _model(graphs)
    cold.compile()                      # percall, no cache in scope
    cold.warmup_batched(4, cache=cache)
    kinds = {(e["kind"], e["cache"]) for e in cold.compile_log}
    assert kinds == {("percall", None), ("bucket", "miss"),
                     ("manifest", "store")}
    assert cold.compile_events == cold.capture_events == sum(
        1 for e in cold.compile_log if e["kind"] in ("percall", "bucket"))
    assert cold.cache_events == {"hit": 0, "miss": 3, "store": 1}

    warm = _model(graphs)
    warm.warmup_batched(4, cache=cache)
    assert warm.compile_events == 0
    assert {(e["kind"], e["cache"]) for e in warm.compile_log} == \
        {("bucket", "hit"), ("percall", "hit")}
    assert warm.cache_events["hit"] == len(warm.compile_log) == 4
    assert warm.capture_events == cold.capture_events
    warm.predict_q(_rows(warm, 1, 0)[0])  # the per-call executable is warm
    assert warm.compile_events == 0 and warm.capture_events == 4
    assert warm.cached_stage_pads() == {}


def test_parallel_warmup_single_compile_per_bucket(graphs):
    """Racing warm-ups, and a thread pool building the buckets as the
    reference's parallel warm-up does, still build each bucket once."""
    from concurrent.futures import ThreadPoolExecutor
    cm = _model(graphs)

    def race():
        with ThreadPoolExecutor(max_workers=4) as pool:
            list(pool.map(cm.compile_batched, (1, 2, 4, 8)))
        cm.warmup_batched(8)

    threads = [threading.Thread(target=race) for _ in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    buckets = [e for e in cm.compile_log if e["kind"] == "bucket"]
    assert sorted(e["bucket"] for e in buckets) == [1, 2, 4, 8]
    assert cm.bucket_sizes() == (1, 2, 4, 8)
    assert cm.compile_events == cm.capture_events == 4
    # a sequential warm-up fills the identical key sets
    seq = _model(graphs).warmup_batched(8)
    assert seq.bucket_sizes() == cm.bucket_sizes()
    assert seq.staged_pad_keys() == cm.staged_pad_keys()


def test_store_requires_warmed_model(graphs, tmp_path):
    cache = AotCache(str(tmp_path))
    with pytest.raises(ValueError, match="not warmed"):
        cache.store(_model(graphs), 4)


def test_install_refuses_a_mismatched_library(tmp_path, monkeypatch):
    """``_build.install`` loads a stored library only under the file name
    this checkout's sources and flags build and with the recorded sha256;
    a library already loaded is left as it is. Stand-in files: no library
    is loaded here."""
    data = b"stand-in bytes, not a shared library"
    digest = hashlib.sha256(data).hexdigest()
    good = tmp_path / _build._target("probe").name
    good.write_bytes(data)
    renamed = tmp_path / "libprobe-0000000000000000.so"
    renamed.write_bytes(data)
    with pytest.raises(ValueError, match="not the probe library"):
        _build.install("probe", renamed, digest)
    with pytest.raises(ValueError, match="sha256"):
        _build.install("probe", good, hashlib.sha256(b"other").hexdigest())
    with pytest.raises(OSError):  # passes both checks, but is no library
        _build.install("probe", good, digest)
    assert "probe" not in _build.libraries()["loaded"]
    sentinel = object()
    monkeypatch.setitem(_build._LIBS, "probe", sentinel)
    good.write_bytes(b"")  # a loaded library is not read again
    assert _build.install("probe", good, digest) is False
    assert _build._LIBS["probe"] is sentinel
    # ... but a copy installed earlier must have had the recorded sha256
    monkeypatch.setitem(_build._ORIGIN, "probe",
                        {"path": str(good), "source": "cache",
                         "sha256": hashlib.sha256(b"other").hexdigest()})
    with pytest.raises(ValueError, match="copy loaded here"):
        _build.install("probe", good, digest)


@pytest.mark.parametrize("damage", ["truncated", "not_a_library"])
def test_stored_library_checked_before_install(graphs, tmp_path, damage):
    """A manifest's libraries live once under ``<root>/lib`` and are held
    against their recorded sha256 only after the records passed: a
    truncated copy is a C003 finding already at ``verify``; one whose
    bytes check but that does not load is a C003 finding at ``load``.
    Either way the load is a miss, nothing is loaded or installed, and the
    miss's store heals the manifest. Stand-in files on the CPU."""
    cache = AotCache(str(tmp_path))
    _model(graphs).warmup_batched(2, cache=cache)
    fp = plan_fingerprint(_model(graphs).exec_plan)
    data = b"stand-in bytes, not a shared library"
    fname = _build._target("probe").name
    os.makedirs(tmp_path / "lib")
    (tmp_path / "lib" / fname).write_bytes(
        data[:8] if damage == "truncated" else data)
    man = cache.manifest(fp)
    man["libraries"] = {"probe": {"file": fname,
                                  "sha256": hashlib.sha256(data).hexdigest()}}
    open(cache.manifest_path(fp), "w").write(json.dumps(man))
    res = cache.verify(_model(graphs), 2)
    assert res.hit is (damage == "not_a_library"), res
    cm = _model(graphs)
    cm.warmup_batched(2, cache=cache)
    res = cm.last_cache_result
    assert not res.hit and res.reason.startswith("manifest rejected (C003)")
    (finding,) = res.findings
    assert (finding.code, finding.where) == ("C003", "kernel_probe")
    assert ("OSError" if damage == "not_a_library" else "sha256") \
        in finding.message
    assert "probe" not in _build.libraries()["loaded"]
    assert cm.cache_events["hit"] == 0 and cm.compile_events == 2
    assert cache.manifest(fp)["libraries"] == {}  # no library on the CPU
    assert cache.verify(_model(graphs), 2).hit


def test_warmed_model_stores_at_its_first_cached_warmup(graphs, tmp_path):
    """A model warmed before it meets a cache still loads first, as in the
    reference: the miss builds nothing more and stores every bucket; the
    next cached warm-up hits and installs nothing it has; a fresh model
    boots warm from that store."""
    cache = AotCache(str(tmp_path))
    cm = _model(graphs).warmup_batched(4)
    assert cm.compile_events == 3 and cm.last_cache_result is None
    cm.warmup_batched(4, cache=cache)
    res = cm.last_cache_result
    assert res.reason == "no manifest; stored" and res.stored == 3
    assert cm.compile_events == 3
    assert cache.stats() | {"root": None} == {"root": None, "hits": 0,
                                              "misses": 1, "stores": 1}
    cm.warmup_batched(4, cache=cache)
    assert cm.last_cache_result.hit and cm.last_cache_result.loaded == 0
    warm = _model(graphs).warmup_batched(4, cache=cache)
    assert warm.compile_events == 0 and warm.last_cache_result.loaded == 3


# ---------------------------------------------------- serving wiring ----

def test_for_model_warms_from_the_cache(graphs, tmp_path):
    """``MicroBatcher.for_model(model, cache=)`` warms through the cache:
    the first model stores, the second boots warm and serves its rows."""
    cache = AotCache(str(tmp_path))
    first = _model(graphs, "speech")
    MicroBatcher.for_model(first, cache=cache, max_batch=4)
    assert first.compile_events == 3 and cache.stats()["stores"] == 1
    second = _model(graphs, "speech")
    MicroBatcher.for_model(second, cache=cache, max_batch=4)
    assert second.compile_events == 0 and second.last_cache_result.hit
    assert second.capture_events == 3
    x = _rows(second, 3, 9)
    assert np.array_equal(second.predict_q_many(x, max_batch=4),
                          first.predict_q_many(x, max_batch=4))


def test_registry_cache_dir_boots_warm(graphs, tmp_path):
    """End to end through ``ServingRegistry(cache_dir=...)``: the first
    registry pays the builds and stores, the second boots with zero builds
    and the same captures; both surface the outcome in ``cache_status()``,
    the telemetry and the exposition."""

    async def boot():
        reg = ServingRegistry(cache_dir=str(tmp_path), max_batch=4)
        reg.register("sine", _model(graphs))
        cm = reg._entries["sine"].model
        async with reg:
            x = reg.quantize_input("sine", np.array([[1.0]], np.float32))
            y = await reg.infer("sine", x)
        return reg, cm, np.asarray(y)

    reg1, cold, y1 = asyncio.run(boot())
    assert cold.compile_events == 3
    assert reg1.cache_status()["stores"] == 1
    assert not reg1.cache_status()["boots"]["sine"]["hit"]

    reg2, warm, y2 = asyncio.run(boot())
    assert warm.compile_events == 0, warm.compile_log
    status = reg2.cache_status()
    assert status["hits"] == 1 and status["boots"]["sine"]["hit"]
    assert status["root"] == str(tmp_path)
    assert np.array_equal(y1, y2)

    tel = reg2.telemetry()
    eng = tel["engines"]["sine"]
    assert eng["compile_events"] == 0
    assert eng["capture_events"] == cold.capture_events == 3
    assert eng["cache_events"] == {"hit": 3, "miss": 0, "store": 0}
    assert tel["aot_cache"]["hits"] == 1
    om = reg2.openmetrics()
    assert 'repro_engine_compiles_total{model="sine"} 0' in om
    assert 'repro_aot_cache_total{event="hits"} 1' in om
