"""Persistent, content-addressed executable cache — the port of
``repro.serve.aotcache``.

Design note
-----------

*What is stored, and what a warm boot still does.* The reference stores
each XLA executable (``jax.experimental.serialize_executable``) and a warm
boot loads them. On CUDA an engine's executable has two parts:

* the device code: the ``kernels/csrc/*.cu`` libraries that
  :mod:`repro_torch.kernels._build` compiles with nvcc for sm_90a, each
  under a file name that carries a digest of its sources and nvcc flags;
* the capture: ``core/engine.py``'s ``_GraphExecutable`` runs the forward
  once eagerly, then captures it with ``torch.cuda.graph``.

A CUDA graph holds device addresses of one process's allocations and cannot
be serialized. So the cache stores the device code, plus one *capture
record* for each bucket (and for the per-call graph when it was built): the
route, the device, the input and output shapes and dtypes, and on CUDA the
kernel-wrapper calls the graph holds (``_GraphExecutable.launches``). A
warm boot still builds the ``ExecutionPlan`` (folding, layout planning,
constants to the device: the fingerprint that finds the entry is taken
from it). It verifies the manifest, loads the libraries with
``_build.install`` instead of running nvcc, and captures every recorded
graph again, checking each capture against its record. What it skips is
nvcc, which a new replica pays in full (its ``build/`` starts empty).

*What the reference's zero-compile warm boot becomes.* ``compile_events``
counts the executables that no verified cache served: it stays 0 on a warm
boot, as in the reference. A capture is not a compile: every capture, cold
or warm, adds one to ``capture_events``, and a warm boot makes as many as
the cold boot did. Each warm capture is logged as ``{"kind": "bucket",
"cache": "hit", "bucket": b, "launches": ...}`` (``"percall"`` for the
per-call graph). On the card a warm boot is proven by every engine's
``last_cache_result.hit``, ``compile_events == 0``, ``capture_events``
equal to the cold boot's, no nvcc run (``_build.libraries()["nvcc_s"]``
empty) and an untouched build directory. On the CPU an executable is the
eager function, and binding it is counted as its capture.

*What C001–C005 guard here* (``repro_torch.analysis.fingerprint``):

* C001, the plan: graph, weights, folded constants, layout plan and its
  lane quantum, paging map, route flag. A record's shapes and launches
  follow from the plan, so a record is valid only for its own plan.
* C002, coverage: a record for every bucket ``warmup_batched(warm_batch)``
  builds. Staging keys are listed for coverage alone: the port has no
  staged-pad executable (a batch's bucket fill is the zero rows of its
  staging buffer, its lane pad runs inside its bucket's graph), so there
  are no ``stage_*`` entries.
* C003, the entries: the sha256 of every record and every library, so a
  truncated or altered file rejects the cache before anything is loaded
  (a library's finding is ``kernel_<name>``, from ``_build.check``).
* C004, the environment, above all here: a library is machine code, valid
  only for the compute capability it was compiled for (sm_90a runs on 9.0
  only) and for the sources it was compiled from (``kernels_sha256``).
  The manifest also names the torch and CUDA runtime versions, the device
  and the CUDA version of the driver. Besides, ``_build.check`` refuses a
  library whose file name is not the one this checkout's sources and
  ``NVCC_FLAGS`` build. The store launched the very bytes it stored, in
  its captures, under the driver it names; so a process whose environment
  matches runs them too, and one under another driver is refused before
  any library is loaded. The nvcc that compiled a library is not named:
  what it decides (the CUDA runtime, linked statically, and the machine
  code) is in the bytes whose launch the store proved.
* C005, the audit: an audit document (``python -m repro_torch.analysis
  --json``) whose reachable buckets the manifest must cover and whose
  fingerprint must agree.

*All or nothing.* :meth:`AotCache.load` installs nothing into the model
unless every check passed, every library loaded and every capture matched
its record; otherwise it returns a miss with the reason, the caller's cold
path starts from a clean model, and its store writes a good copy (the
cache heals). Libraries are installed only after the manifest and every
record passed their checks. A library that passed its own checks stays
loaded even when a later capture fails: under a matching environment it
is what the build directory would hold (its name is the digest of the
same sources and flags, its bytes ran under this driver), so keeping it
changes no result.

*Libraries before plans.* The kernel route probes the card while its plan
is built (``ExecutionPlan.build`` → ``can_launch_kernels``), before there
is a fingerprint to find the model's entry. So :meth:`AotCache.install_libraries`
(which ``ServingRegistry`` calls when it is given a cache) loads every
library of every manifest under the root whose environment is this
process's and whose bytes check; the probe then finds its library loaded.
It and each model's load go through one loader (``_build.install``), which
leaves a loaded library as it is without reading it again, so a warm boot
hashes each library once.

Layout on disk (one directory per plan fingerprint; the libraries once,
under their build names, which carry the digest of their sources)::

    <root>/<fingerprint>/
        manifest.json          # build_manifest + model, route, libraries
        bucket_<n>.json        # capture record of bucket n
        percall.json           # capture record of the per-call graph
    <root>/lib/
        lib<name>-<digest>.so  # CUDA: each library a stored route
                               # launches; a manifest's "libraries" name
                               # its file and sha256

Entries are written first and the manifest last, each by ``os.replace``,
so a killed store never leaves a cache that looks loadable.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["AotCache", "CacheResult", "serialization_support"]


def serialization_support() -> Tuple[bool, str]:
    """Whether this backend's executables can be stored: ``(True, "")`` on
    every device, since nothing the cache stores needs a backend's
    serializer (records are JSON, libraries are the build's files)."""
    return True, ""


@dataclasses.dataclass
class CacheResult:
    """Outcome of one cache interaction — what the boot path logs and the
    registry surfaces in telemetry."""

    hit: bool
    fingerprint: str
    reason: str = ""
    loaded: int = 0       # executables captured from records into the model
    stored: int = 0       # files (records and libraries) written to disk
    findings: List[Any] = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return {"hit": self.hit, "fingerprint": self.fingerprint,
                "reason": self.reason, "loaded": self.loaded,
                "stored": self.stored,
                "findings": [str(f) for f in self.findings]}


_KERNEL = "kernel_"


def _json_bytes(doc: dict) -> bytes:
    return (json.dumps(doc, indent=1, sort_keys=True) + "\n").encode()


class AotCache:
    """Persistent executable cache rooted at ``root`` (created lazily).

    Thread-safe for the boot pattern (one load/store per model); a store is
    crash-consistent (entries first, the manifest last, each by an atomic
    rename)."""

    def __init__(self, root: str, *, audit_path: Optional[str] = None):
        self.root = str(root)
        # optional audit document (python -m repro_torch.analysis --json):
        # when the file exists, verify_manifest also proves the manifest
        # covers the audit's reachable buckets (C005)
        self.audit_path = audit_path
        self._lock = threading.Lock()
        # monotone interaction counters (registry telemetry reads these)
        self.hits = 0
        self.misses = 0
        self.stores = 0

    # -- paths -------------------------------------------------------------
    def dir_for(self, fingerprint: str) -> str:
        return os.path.join(self.root, fingerprint)

    def manifest_path(self, fingerprint: str) -> str:
        return os.path.join(self.dir_for(fingerprint), "manifest.json")

    def manifest(self, fingerprint: str) -> Optional[dict]:
        try:
            with open(self.manifest_path(fingerprint)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _audit_doc(self) -> Optional[dict]:
        if self.audit_path is None or not os.path.exists(self.audit_path):
            return None
        try:
            with open(self.audit_path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _library_path(self, fname: str) -> str:
        return os.path.join(self.root, "lib", fname)

    def _read_entries(self, fp: str, man: dict) -> Dict[str, bytes]:
        out: Dict[str, bytes] = {}
        for name in man.get("entries", {}):
            try:
                with open(os.path.join(self.dir_for(fp), f"{name}.json"),
                          "rb") as f:
                    out[name] = f.read()
            except OSError:
                pass  # verify_manifest reports the gap as C003
        return out

    def _libraries(self, man: dict, *, install: bool) -> List[Any]:
        """Hold every library ``man`` lists against its recorded sha256,
        loading it when ``install`` (``_build.check`` / ``_build.install``:
        a library already loaded is not read again). Returns the C003
        findings."""
        from repro_torch.analysis.report import ERROR, Finding
        from repro_torch.kernels import _build
        step = _build.install if install else _build.check
        findings = []
        for name, lib in sorted(man.get("libraries", {}).items()):
            try:
                step(name, self._library_path(lib["file"]), lib["sha256"])
            except (KeyError, TypeError, ValueError, OSError) as e:
                findings.append(Finding(ERROR, "C003", _KERNEL + name,
                                        f"{type(e).__name__}: {e}"))
        return findings

    def _check(self, model: Any, warm_batch: int, *, install: bool):
        """Verify ``model``'s manifest and records, then hold its libraries
        against their digests (loading them when ``install``): libraries
        are touched only once everything else passed."""
        from repro_torch.analysis.fingerprint import (plan_fingerprint,
                                                      verify_manifest)
        plan = model.exec_plan
        fp = plan_fingerprint(plan)
        man = self.manifest(fp)
        if man is None:
            return fp, None, None, CacheResult(False, fp, reason="no manifest")
        entry_bytes = self._read_entries(fp, man)
        info, findings = verify_manifest(man, plan, warm_batch,
                                         entry_bytes=entry_bytes,
                                         audit=self._audit_doc())
        if info["ok"]:
            findings = self._libraries(man, install=install)
        if findings:
            codes = ", ".join(sorted({f.code for f in findings}))
            return fp, man, entry_bytes, CacheResult(
                False, fp, reason=f"manifest rejected ({codes})",
                findings=findings)
        return fp, man, entry_bytes, None

    # -- verification ------------------------------------------------------
    def verify(self, model: Any, warm_batch: int) -> CacheResult:
        """Warm-boot admission: manifest and digest verification WITHOUT
        loading anything. ``hit`` means a :meth:`load` would pass its
        checks (the captures it makes are checked only then)."""
        fp, _, _, rejected = self._check(model, warm_batch, install=False)
        return rejected or CacheResult(True, fp)

    # -- load --------------------------------------------------------------
    def _miss(self, res: CacheResult) -> CacheResult:
        with self._lock:
            self.misses += 1
        return res

    def load(self, model: Any, warm_batch: int) -> CacheResult:
        """Verify, then install: load the libraries, capture every recorded
        bucket (and the per-call graph when recorded) and check each capture
        against its record (``CompiledModel.install_cached_executables``).
        All or nothing: a failed check, a library that does not load or a
        capture unlike its record installs nothing into the model and
        returns a miss with the reason."""
        fp, man, entry_bytes, rejected = self._check(model, warm_batch,
                                                     install=True)
        if rejected is not None:
            return self._miss(rejected)
        try:
            buckets = {int(b): json.loads(entry_bytes[f"bucket_{int(b)}"])
                       for b in man["buckets"]}
            percall = (json.loads(entry_bytes["percall"])
                       if "percall" in man["entries"] else None)
            n = model.install_cached_executables(buckets, percall=percall)
        except (KeyError, ValueError, OSError, RuntimeError) as e:
            return self._miss(CacheResult(
                False, fp, reason=f"install failed: {type(e).__name__}: {e}"))
        with self._lock:
            self.hits += 1
        return CacheResult(True, fp, loaded=n)

    def install_libraries(self) -> List[str]:
        """Load, before any plan is built, every kernel library that a
        manifest under the root lists, when its environment is this
        process's, and that passes ``_build.install``'s checks; a refused
        one is built by nvcc when first needed, and its model's load
        reports it (C003). Returns the names loaded now. Does nothing
        without a card."""
        import torch
        if not torch.cuda.is_available():
            return []
        from repro_torch.analysis.fingerprint import environment_info
        from repro_torch.kernels import _build
        env = environment_info("cuda")
        try:
            fps = sorted(os.listdir(self.root))
        except OSError:
            return []
        wanted = set()
        for fp in fps:
            man = self.manifest(fp)
            if man and man.get("environment") == env:
                wanted |= {(name, lib.get("file"), lib.get("sha256"))
                           for name, lib in man.get("libraries", {}).items()}
        done = []
        for name, fname, digest in sorted(wanted, key=str):
            try:
                if _build.install(name, self._library_path(fname), digest):
                    done.append(name)
            except (TypeError, ValueError, OSError):
                continue
        return done

    # -- store -------------------------------------------------------------
    @staticmethod
    def _libraries_of(model: Any, records: List[dict]) -> Dict[str, str]:
        """name -> loaded path of each library the model's route launches:
        those its graphs hold calls of, and on the kernel route on the card
        the probe its plan's build launched."""
        from repro_torch.kernels import _build
        names = {k for r in records for k, v in r.get("launches", {}).items()
                 if v}
        if model.use_kernels and model.device.type == "cuda":
            names.add("probe")
        loaded = _build.libraries()["loaded"]
        return {n: loaded[n]["path"] for n in sorted(names) if n in loaded}

    def store(self, model: Any, warm_batch: int) -> CacheResult:
        """Write ``model``'s capture records (every bucket up to
        ``warm_batch``, and the per-call graph when built) under the plan
        fingerprint, and each library its route launches under ``lib/``
        unless the same bytes are there already. The model must already be
        warmed to ``warm_batch`` — a partial store would just be rejected
        at load time, so this raises instead."""
        from repro_torch.analysis.fingerprint import (build_manifest,
                                                      plan_fingerprint)
        from repro_torch.analysis.retrace import warmed_buckets
        fp = plan_fingerprint(model.exec_plan)
        need = set(warmed_buckets(warm_batch))
        have = set(model.bucket_sizes())
        if not need <= have:
            raise ValueError(
                f"model not warmed to {warm_batch}: buckets {sorted(have)} "
                f"do not cover {sorted(need)} — call warmup_batched first")
        records = {f"bucket_{b}": model.capture_record(b)
                   for b in sorted(need)}
        if model.cached_percall() is not None:
            records["percall"] = model.capture_record(None)
        written = 0
        libraries = {}
        for name, path in self._libraries_of(model,
                                             list(records.values())).items():
            with open(path, "rb") as f:
                data = f.read()
            fname = os.path.basename(path)
            dest = self._library_path(fname)
            try:
                with open(dest, "rb") as f:
                    same = f.read() == data
            except OSError:
                same = False
            if not same:
                os.makedirs(os.path.dirname(dest), exist_ok=True)
                self._write_atomic(dest, data)
                written += 1
            libraries[name] = {"file": fname,
                               "sha256": hashlib.sha256(data).hexdigest()}
        d = self.dir_for(fp)
        os.makedirs(d, exist_ok=True)
        entries = {}
        for name, rec in records.items():
            data = _json_bytes(rec)
            self._write_atomic(os.path.join(d, f"{name}.json"), data)
            entries[name] = hashlib.sha256(data).hexdigest()
        manifest = build_manifest(
            model.exec_plan, warm_batch, entries,
            extra={"model": model.graph.name,
                   "use_kernels": bool(model.use_kernels),
                   "libraries": libraries})
        self._write_atomic(self.manifest_path(fp), _json_bytes(manifest))
        with self._lock:
            self.stores += 1
        return CacheResult(False, fp, reason="stored",
                           stored=written + len(records))

    @staticmethod
    def _write_atomic(path: str, data: bytes) -> None:
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   prefix=".tmp-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- telemetry ---------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {"root": self.root, "hits": self.hits,
                    "misses": self.misses, "stores": self.stores}
