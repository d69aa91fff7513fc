"""Build the hand-written CUDA kernels with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles, on first use, into its own shared library
with a plain C interface under ``build/repro_torch_kernels/`` at the root of
the checkout. The file name carries a digest of the sources and flags, so an
edited kernel is rebuilt and an unchanged one is reused. :func:`build` starts
one nvcc per source, all at once. Nothing here runs at import time.
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
        result[name] = {"path": target, "seconds": time.perf_counter() - t0,
                        "log": log}
    if failures:
        raise RuntimeError("\n".join(failures))
    return result


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of kernel library ``name`` (built if
    needed), with its argument types declared and an int return (the
    ``cudaGetLastError()`` after the launch)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build([name])[name]["path"]))
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


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
