"""The device trace of a traced run, and its reduction to what the per-layer
readers and the result's ``breakdown`` read: the seconds in which some
operation ran on the device (the union of their intervals), the seconds of
each kernel by name, and the longest idle gaps with the host operation
that was running in each."""
from __future__ import annotations

import time

import torch


def _kind(name: str) -> str:
    """A device operation's kind by its trace name: kineto names copies
    ``Memcpy ...`` and sets ``Memset ...``; every other one is a kernel."""
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


class DeviceTrace:
    """``torch.profiler`` over one phase of the window, on the card."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.prof = None
        self.t0 = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> dict:
        if self.cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        device, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            name, t0 = e.name(), e.start_ns()
            span = (name, t0, t0 + e.duration_ns())
            if "cuda" in str(e.device_type()).lower():
                device.append(span + (_kind(name),))
            else:
                host.append(span)
        self.prof = None
        return reduce(device, host, window_s)


def reduce(device, host, window_s: float) -> dict:
    """``device``: (name, start_ns, end_ns, kind); ``host``: (name,
    start_ns, end_ns). Returns ``window_s``, ``busy_s``, ``ops`` (name ->
    [seconds, count, kind]) and ``gaps`` (the ten longest idle gaps between
    device operations, longest first, each [host op, seconds])."""
    ops = {}
    for name, t0, t1, kind in device:
        o = ops.setdefault(name, [0.0, 0, kind])
        o[0] += (t1 - t0) / 1e9
        o[1] += 1
    busy_ns, gaps = 0, []
    end = None
    for _, t0, t1, _ in sorted(device, key=lambda d: d[1]):
        if end is None or t0 > end:
            if end is not None:
                gaps.append((t0 - end, end, t0))
            busy_ns += t1 - t0
            end = t1
        elif t1 > end:
            busy_ns += t1 - end
            end = t1
    gaps.sort(reverse=True)
    top = []
    for dur, g0, g1 in gaps[:10]:
        mid = (g0 + g1) // 2
        inner = [h for h in host if h[1] <= mid <= h[2]]
        name = max(inner, key=lambda h: h[1])[0] if inner \
            else "no_traced_host_op"
        top.append([name, dur / 1e9])
    return {"window_s": window_s, "busy_s": busy_ns / 1e9, "ops": ops,
            "gaps": top}
