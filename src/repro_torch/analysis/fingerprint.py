"""Plan fingerprint + executable-cache manifest verification — pass 5 of
the plan auditor; the port of ``repro.analysis.fingerprint``.

Every lowering decision is static in the :class:`ExecutionPlan` (graph
topology, folded Eq. (4)/(7)/(10) constants, ``LayoutPlan`` with its lane
quantum, paging map, route flag), so two plans with the same fingerprint
lower to the same forwards and their executables are interchangeable. That
makes the fingerprint the content address of a persistent executable cache.
Every tensor is hashed from a host copy, in a fixed order, so the same
graph and flags give the same fingerprint whether the plan was built on the
CPU or on the card (the device is not part of the plan's content; it is
part of the environment).

The flip side is that a stale cache must be provably rejected, so this
module also owns the cache **manifest**: what a stored cache claims to
contain (fingerprint, environment, bucket set, staging keys, per-entry
content digests) and :func:`verify_manifest` — the admission check a
replica runs before trusting a cache hit. Verification cross-checks the
manifest against the no-retrace auditor's derivations
(:func:`repro_torch.analysis.retrace.warmed_buckets` /
:func:`~repro_torch.analysis.retrace.warmed_stage_keys`), and optionally
against an audit document (``python -m repro_torch.analysis --json``), so
"this cache covers every bucket the serving path can reach" is a proof,
not a hope.

Finding codes (continuing the auditor's V/A/R/B families), as in the
reference:

* ``C001`` — fingerprint mismatch: the cached plan is not this plan
  (stale weights, different layout/route flags, edited graph).
* ``C002`` — partial coverage: a warmed bucket or staging key the serving
  path needs is missing from the manifest.
* ``C003`` — entry corruption: a manifest entry's file is missing or its
  content digest does not match.
* ``C004`` — environment mismatch: the cache was produced under a
  different torch / CUDA version, device, compute capability, CUDA driver
  or kernel sources than this process runs.
* ``C005`` — audit cross-check failure: the manifest does not cover the
  reachable bucket set recorded in the audit document (or the audit's
  fingerprint disagrees).
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import json
from typing import Any, Dict, List, Optional, Tuple

import os

import numpy as np
import torch

from repro_torch.core.engine import ExecutionPlan

from .report import ERROR, Finding
from .retrace import StageKey, warmed_buckets, warmed_stage_keys

FINGERPRINT_VERSION = "pf1"

__all__ = [
    "FINGERPRINT_VERSION", "plan_fingerprint", "environment_info",
    "kernel_sources_sha256", "stage_key_id", "build_manifest",
    "verify_manifest",
]


# ---------------------------------------------------------------------------
# canonical hashing
# ---------------------------------------------------------------------------

def _feed(h: "hashlib._Hash", obj: Any) -> None:
    """Canonical, recursive hash feed. Every branch tags its type so e.g.
    the int 1 and the string "1" (or an empty dict and an empty list)
    can never collide; ndarrays contribute dtype + shape + raw bytes so a
    single flipped weight changes the fingerprint; a torch tensor is fed as
    its host copy (``.cpu().numpy()``), so where a plan keeps it does not
    matter."""
    if obj is None:
        h.update(b"N")
    elif isinstance(obj, (bool, np.bool_)):
        h.update(b"B" + (b"1" if obj else b"0"))
    elif isinstance(obj, (int, np.integer)):
        h.update(b"I" + str(int(obj)).encode())
    elif isinstance(obj, (float, np.floating)):
        h.update(b"F" + np.float64(obj).tobytes())
    elif isinstance(obj, str):
        b = obj.encode()
        h.update(b"S" + str(len(b)).encode() + b":" + b)
    elif isinstance(obj, bytes):
        h.update(b"Y" + str(len(obj)).encode() + b":" + obj)
    elif isinstance(obj, np.ndarray):
        h.update(b"A" + str(obj.dtype).encode())
        _feed(h, tuple(obj.shape))
        h.update(np.ascontiguousarray(obj).tobytes())
    elif isinstance(obj, (tuple, list)):
        h.update(b"T" + str(len(obj)).encode())
        for v in obj:
            _feed(h, v)
    elif isinstance(obj, dict):
        h.update(b"D" + str(len(obj)).encode())
        for k in sorted(obj, key=repr):
            _feed(h, k)
            _feed(h, obj[k])
    elif torch.is_tensor(obj):  # hashed as its host copy
        _feed(h, obj.detach().cpu().numpy())
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        h.update(b"C" + type(obj).__name__.encode())
        _feed(h, vars(obj))
    else:  # numpy scalars and other array-likes reduce to ndarray
        arr = np.asarray(obj)
        _feed(h, arr)


def _qparams_repr(qp: Any) -> Optional[dict]:
    if qp is None:
        return None
    return {"scale": np.asarray(qp.scale),
            "zero_point": np.asarray(qp.zero_point),
            "axis": qp.axis}


def plan_fingerprint(plan: ExecutionPlan) -> str:
    """Stable content hash of everything that determines the plan's
    lowerings: graph topology (ops, attrs, wiring), tensor specs (shapes,
    dtypes, quant params, const data), the folded Eq. (4)/(7)/(10)
    constants, the ``LayoutPlan`` (pre-padded weights and the lane quantum
    included), the paging map, and ``use_kernels``. Two plans with equal
    fingerprints lower to the same forwards; any semantic change — one
    retrained weight, one layout entry, one flipped route flag — changes
    the fingerprint. The plan's device does not enter it."""
    h = hashlib.sha256()
    h.update(FINGERPRINT_VERSION.encode())
    g = plan.graph
    _feed(h, {"name": g.name, "inputs": list(g.inputs),
              "outputs": list(g.outputs)})
    for t in g.tensors:
        _feed(h, (t.name, tuple(t.shape), t.dtype, _qparams_repr(t.qparams),
                  t.data if t.data is not None else None))
    for op in g.ops:
        _feed(h, (op.op, list(op.inputs), list(op.outputs),
                  dict(op.attrs)))
    _feed(h, {str(i): fc for i, fc in plan.folded.items()})
    if plan.layout is None:
        h.update(b"L0")
    else:
        h.update(b"L1")
        _feed(h, {str(i): lay for i, lay in plan.layout.layouts.items()})
        _feed(h, {str(k): tuple(v) for k, v in plan.layout.phys.items()})
        _feed(h, {str(k): tuple(v)
                  for k, v in plan.layout.entry_phys.items()})
        _feed(h, int(plan.layout.quantum))
    _feed(h, {str(k): int(v) for k, v in plan.paged.items()})
    _feed(h, bool(plan.use_kernels))
    return f"{FINGERPRINT_VERSION}-{h.hexdigest()}"


KERNEL_SOURCES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "kernels", "csrc")


def kernel_sources_sha256() -> str:
    """sha256 over ``kernels/csrc/*`` (names and bytes, in name order): the
    sources every executable's kernels are built from."""
    h = hashlib.sha256()
    for name in sorted(os.listdir(KERNEL_SOURCES)):
        with open(os.path.join(KERNEL_SOURCES, name), "rb") as fh:
            data = fh.read()
        h.update(name.encode() + b"\0" + str(len(data)).encode() + b"\0")
        h.update(data)
    return h.hexdigest()


def environment_info(device="cuda") -> Dict[str, str]:
    """The executable-compatibility envelope of ``device``: a captured
    executable is only valid under the same torch and CUDA versions, the
    same device and compute capability, and kernels built from the same
    sources, so the manifest records where it was produced and
    :func:`verify_manifest` rejects a cache from anywhere else (C004). On
    CUDA it also names the CUDA version the driver supports
    (``cuDriverGetVersion``): a stored kernel library ran under that
    driver when it was stored."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"torch": torch.__version__, "cuda": str(torch.version.cuda),
                "device": dev.type, "capability": "none",
                "kernels_sha256": kernel_sources_sha256()}
    version = ctypes.c_int()
    ctypes.CDLL("libcuda.so.1").cuDriverGetVersion(ctypes.byref(version))
    return {"torch": torch.__version__,
            "cuda": str(torch.version.cuda),
            "device": torch.cuda.get_device_name(dev),
            "capability": "%d.%d" % torch.cuda.get_device_capability(dev),
            "driver": "%d.%d" % divmod(version.value // 10, 100),
            "kernels_sha256": kernel_sources_sha256()}


# ---------------------------------------------------------------------------
# manifest
# ---------------------------------------------------------------------------

def stage_key_id(key: StageKey) -> str:
    """Filesystem-safe content id for one staged-pad cache key
    ``(shape, widths)`` — the manifest's stable entry name."""
    shape, widths = key
    canon = json.dumps([list(shape), [list(w) for w in widths]])
    return hashlib.sha256(canon.encode()).hexdigest()[:16]


def _stage_key_json(key: StageKey) -> list:
    shape, widths = key
    return [list(shape), [list(w) for w in widths]]


def stage_key_from_json(doc: list) -> StageKey:
    shape, widths = doc
    return tuple(shape), tuple(tuple(w) for w in widths)


def build_manifest(plan: ExecutionPlan, warm_batch: int,
                   entries: Dict[str, str],
                   extra: Optional[dict] = None) -> dict:
    """The cache's self-description, written next to its stored entries.
    ``entries`` maps entry name (``bucket_<n>`` / ``percall``) to the
    sha256 hex digest of the entry file's bytes. The environment is that of the plan's device."""
    doc = {
        "version": 1,
        "fingerprint": plan_fingerprint(plan),
        "environment": environment_info(plan.device),
        "warm_batch": int(warm_batch),
        "buckets": [int(b) for b in warmed_buckets(warm_batch)],
        "stage_keys": {stage_key_id(k): _stage_key_json(k)
                       for k in warmed_stage_keys(plan, warm_batch)},
        "entries": dict(entries),
    }
    if extra:
        doc.update(extra)
    return doc


def verify_manifest(manifest: dict, plan: ExecutionPlan, warm_batch: int,
                    entry_bytes: Optional[Dict[str, bytes]] = None,
                    audit: Optional[dict] = None
                    ) -> Tuple[Dict[str, Any], List[Finding]]:
    """Warm-boot admission check: does this manifest prove the cache can
    stand in for ``warmup_batched(warm_batch)`` on ``plan``?

    Checks, in order of how cheaply they reject:

    1. fingerprint equality (C001) and environment equality (C004);
    2. coverage: the manifest's bucket set and staged-pad key set must
       include every key ``warmup_batched(warm_batch)`` would fill —
       derived independently by the no-retrace auditor (C002);
    3. every required entry must exist in ``entries`` and, when
       ``entry_bytes`` is supplied, every entry the table lists must be
       there with a matching content digest (C003). Staging keys are
       checked for coverage alone (C002): the port has no staged-pad
       executable, a batch's bucket covers it;
    4. the optional ``audit`` document (the auditor's ``--json`` report)
       must agree: the reachable buckets (``retrace.reachable_buckets``) of
       every entry on this manifest's route that names its model or
       carries its fingerprint must be covered and, when the entry carries
       a ``fingerprint``, it must match (C005).

    Returns ``(info, findings)`` in the auditor's house style; admission
    is ``info["ok"]``.
    """
    findings: List[Finding] = []
    want_fp = plan_fingerprint(plan)
    got_fp = manifest.get("fingerprint")
    if got_fp != want_fp:
        findings.append(Finding(
            ERROR, "C001", "fingerprint",
            f"cache fingerprint {str(got_fp)[:24]}... does not match the "
            f"plan's {want_fp[:24]}... — stale cache (plan, weights, "
            f"layout, or route flags changed)"))

    env = environment_info(plan.device)
    got_env = manifest.get("environment") or {}
    for k, v in env.items():
        if got_env.get(k) != v:
            findings.append(Finding(
                ERROR, "C004", f"environment.{k}",
                f"cache produced under {k}={got_env.get(k)!r}, this "
                f"process runs {v!r} — executables are not portable "
                f"across it"))

    need_b = warmed_buckets(warm_batch)
    have_b = {int(b) for b in manifest.get("buckets", ())}
    for b in need_b:
        if b not in have_b:
            findings.append(Finding(
                ERROR, "C002", f"bucket {b}",
                f"warmup_batched({warm_batch}) fills bucket {b} but the "
                f"manifest does not carry it — partial cache"))

    need_s = warmed_stage_keys(plan, warm_batch)
    have_s = set(manifest.get("stage_keys", {}))
    for key in need_s:
        if stage_key_id(key) not in have_s:
            findings.append(Finding(
                ERROR, "C002", f"stage pad {key[0]}",
                "reachable staged-pad key missing from the manifest — "
                "partial cache"))

    entries = manifest.get("entries", {})
    required = [f"bucket_{b}" for b in need_b]
    for name in required:
        if name not in entries:
            findings.append(Finding(
                ERROR, "C003", name,
                "required entry absent from the manifest's entry table"))
    if entry_bytes is not None:
        for name, digest in entries.items():
            data = entry_bytes.get(name)
            if data is None:
                findings.append(Finding(
                    ERROR, "C003", name, "entry file missing on disk"))
            elif hashlib.sha256(data).hexdigest() != digest:
                findings.append(Finding(
                    ERROR, "C003", name,
                    "entry file content digest mismatch — corrupt or "
                    "tampered cache entry"))

    audit_checked = False
    if audit is not None:
        audit_checked = True
        models = audit.get("models", audit)
        if isinstance(models, dict):
            models = [models]
        for m in models or ():
            # an entry is about this cache when it names the manifest's
            # model, or carries its plan's fingerprint: the auditor's CLI
            # names a model by its registry name ("sine"), a manifest by
            # its graph's ("sine_predictor_int8")
            if m.get("model") != manifest.get("model") and \
                    (got_fp is None or m.get("fingerprint") != got_fp):
                continue
            # the audit carries one entry per (model, route); only the
            # entry for this manifest's route is comparable
            if "use_kernels" in manifest and \
                    m.get("use_kernels") != manifest.get("use_kernels"):
                continue
            retr = m.get("retrace") or {}
            for b in retr.get("reachable_buckets", ()):
                if int(b) not in have_b:
                    findings.append(Finding(
                        ERROR, "C005", f"audit bucket {b}",
                        f"the audit proves bucket {b} reachable "
                        f"for model {m.get('model')!r} but the manifest "
                        f"does not cover it"))
            afp = m.get("fingerprint")
            if afp is not None and afp != got_fp:
                findings.append(Finding(
                    ERROR, "C005", "audit fingerprint",
                    "the audit was produced from a different plan than "
                    "this cache"))

    info: Dict[str, Any] = {
        "fingerprint": want_fp,
        "manifest_fingerprint": got_fp,
        "warm_batch": int(warm_batch),
        "required_buckets": [int(b) for b in need_b],
        "required_stage_keys": len(need_s),
        "entries_checked": len(required),
        "digests_checked": entry_bytes is not None,
        "audit_checked": audit_checked,
        "ok": not any(f.severity == ERROR for f in findings),
    }
    return info, findings
