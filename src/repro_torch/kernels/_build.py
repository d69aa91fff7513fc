"""Build the hand-written CUDA kernels with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles, on first use, into its own shared library
with a plain C interface under ``build/repro_torch_kernels/`` at the root of
the checkout. The file name carries a digest of the sources and flags, so an
edited kernel is rebuilt and an unchanged one is reused. :func:`build` starts
one nvcc per source, all at once. :func:`install` loads a stored copy of a
library (the executable cache's, ``repro_torch.serve.aotcache``) once
:func:`check` holds it against the same digest, so a process can run every kernel
without nvcc; :func:`libraries` says where each loaded library came from
and how long this process spent in nvcc. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
SOURCES = ("qmatmul", "qdwconv", "paged_qmatmul", "fmatmul", "probe")

_LIBS: dict = {}  # name -> loaded ctypes library (one per process)
_ORIGIN: dict = {}  # name -> {"path", "source": "build" | "cache"}
_NVCC: dict = {}  # name -> seconds of the nvcc this process ran for it


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every named source that has no up-to-date library, with one
    nvcc process per source running in parallel. Returns name ->
    ``{"path", "seconds", "log"}`` (``log`` holds ptxas' register, shared
    memory and spill report, kept beside the library; ``seconds`` is 0.0
    for a library that was reused). Raises ``RuntimeError`` with the
    compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    result, running = {}, {}
    for name in names:
        target = _target(name)
        if target.exists():
            log = target.with_suffix(".log")
            result[name] = {"path": target, "seconds": 0.0,
                            "log": log.read_text() if log.exists() else ""}
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, target, time.perf_counter())
    failures = []
    for name, (proc, tmp, target, t0) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        target.with_suffix(".log").write_text(log)
        os.replace(tmp, target)  # atomic: a reader never sees half a library
        seconds = time.perf_counter() - t0
        _NVCC[name] = _NVCC.get(name, 0.0) + seconds
        result[name] = {"path": target, "seconds": seconds, "log": log}
    if failures:
        raise RuntimeError("\n".join(failures))
    return result


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of kernel library ``name`` (built if
    needed), with its argument types declared and an int return (the
    ``cudaGetLastError()`` after the launch)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build([name])[name]["path"]
        lib = _LIBS[name] = ctypes.CDLL(str(path))
        _ORIGIN[name] = {"path": str(path), "source": "build"}
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(name: str, path, sha256: str) -> bool:
    """Check that ``path`` is a stored copy of kernel library ``name``:
    ``ValueError`` unless its file name is the one :func:`build` gives
    ``name`` here (the digest over this checkout's sources and
    ``NVCC_FLAGS``) and its bytes hash to ``sha256``; ``OSError`` when it
    cannot be read. A library this process has loaded already is not read
    again: one it built carries the same name, so the same sources and
    flags, and one it installed must have had the same ``sha256``. Returns
    whether ``name`` is loaded."""
    path = Path(path)
    want = _target(name).name
    if path.name != want:
        raise ValueError(f"{path.name} is not the {name} library these "
                         f"sources and flags build ({want})")
    if name in _LIBS:
        had = _ORIGIN.get(name, {}).get("sha256")
        if had is not None and had != sha256:
            raise ValueError(f"{name}: the copy loaded here has sha256 "
                             f"{had[:16]}..., not the recorded "
                             f"{sha256[:16]}...")
        return True
    got = hashlib.sha256(path.read_bytes()).hexdigest()
    if got != sha256:
        raise ValueError(f"{path}: sha256 {got[:16]}... differs from the "
                         f"recorded {sha256[:16]}...")
    return False


def install(name: str, path, sha256: str) -> bool:
    """Load kernel library ``name`` from ``path``, a stored copy of a build
    that passes :func:`check`, so that :func:`function` never runs nvcc for
    it. Returns False, and leaves it as it is, when ``name`` is already
    loaded in this process."""
    if check(name, path, sha256):
        return False
    _LIBS[name] = ctypes.CDLL(str(path))
    _ORIGIN[name] = {"path": str(path), "source": "cache", "sha256": sha256}
    return True


def libraries() -> dict:
    """What this process has loaded and compiled: ``{"loaded": {name:
    {"path", "source"}}, "nvcc_s": {name: seconds}}``. ``source`` is
    ``"build"`` (the build directory, compiled here or reused) or
    ``"cache"`` (:func:`install`, with the ``sha256`` it checked);
    ``nvcc_s`` holds only the sources this process ran nvcc for."""
    return {"loaded": {k: dict(v) for k, v in _ORIGIN.items()},
            "nvcc_s": dict(_NVCC)}


def launch_check(kernel: str, err: int) -> None:
    """Raise when a launch was refused (the C entry point returns the CUDA
    error code; 0 is success)."""
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed with CUDA error {err}")


def check_operands(kernel: str, tensors: dict, expect: dict) -> None:
    """Raise ``ValueError`` unless every tensor has the expected dtype and
    shape, lies on the first tensor's device and is contiguous."""
    dev = next(iter(tensors.values())).device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: unsupported device {dev}")
    for name, t in tensors.items():
        dtype, shape = expect[name]
        if not torch.is_tensor(t):
            raise TypeError(f"{kernel}: {name} must be a tensor, got {type(t)}")
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} must be {dtype} {tuple(shape)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{kernel}: {name} on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def ptr(t: torch.Tensor, align: int = 1) -> int:
    p = t.data_ptr()
    if p % align:
        raise ValueError(f"tensor data at {p:#x} is not {align}-byte aligned")
    return p


def cuda_stream(t: torch.Tensor) -> int:
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"tensor on {t.device}, but the current CUDA device "
                         f"is cuda:{torch.cuda.current_device()}")
    return torch.cuda.current_stream(t.device).cuda_stream
