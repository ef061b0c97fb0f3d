"""What the benchmark reads from `torch.profiler`: the device time of the
build's kernels, and the device's busy time, heaviest operations and idle
gaps over a stretch of requests, the gaps named by what the host was
doing (the harness's own spans, `cudabench.*`, and the innermost host
operation running at the gap).

The profiler can drop device events (seen on the H100 in windows of a few
hundred milliseconds), so a stretch is retried while it recorded fewer
kernels than the host launched.
"""

from __future__ import annotations

import bisect
import contextlib
import re

import torch

SPAN = "cudabench."
B1_KERNEL = re.compile(r"scan_i8_wgmma|(?<![A-Za-z0-9_])scan_merge(?![A-Za-z0-9_])")
B1_MAIN = "scan_i8_wgmma"
B4_KERNEL = re.compile(r"topk_lanes_kernel")
LAUNCH_CALLS = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx"}


@contextlib.contextmanager
def profiling(host: bool):
    """A `torch.profiler` session over the device (and the host's
    operations and the harness's spans, with `host`); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts) as prof:
        yield prof


def span(name: str):
    """A span of the harness's own, recorded by a profiler that traces the host."""
    return torch.profiler.record_function(SPAN + name)


def split_events(prof) -> tuple[list, list]:
    """(device events, host events), each as (name, start us, end us). The
    device-side copies of the harness's spans (annotations, not work) are
    left out of the device events."""
    dev, host = [], []
    for e in prof.events():
        row = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.name.startswith(SPAN):
                dev.append(row)
        else:
            host.append(row)
    return dev, host


def knn_kernels(device_events: list) -> dict:
    """Device microseconds of B1 and B4 in a kNN pass, and the number of
    events of each one's main kernel (B1's scan, B4's cut): one a launch."""
    out = {"B1": {"us": 0.0, "events": 0}, "B4": {"us": 0.0, "events": 0}}
    for name, t0, t1 in device_events:
        if B1_KERNEL.search(name):
            out["B1"]["us"] += t1 - t0
            out["B1"]["events"] += B1_MAIN in name
        elif B4_KERNEL.search(name):
            out["B4"]["us"] += t1 - t0
            out["B4"]["events"] += 1
    return out


def _union(intervals: list) -> list:
    merged: list = []
    for t0, t1 in sorted(intervals):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    return merged


class _Innermost:
    """The latest-starting interval that covers a time, among nested ones."""

    def __init__(self, events: list):
        self.events = sorted(events, key=lambda e: e[1])
        self.starts = [e[1] for e in self.events]

    def at(self, t: float, lookback: int = 20000) -> str | None:
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(i - lookback, -1), -1):
            name, t0, t1 = self.events[j]
            if t1 >= t:
                return name
        return None


def stretch(device_events: list, host_events: list, top: int = 10) -> dict | None:
    """Busy and idle time of the device between the first request span's
    start and the last one's end, the heaviest device operations, the
    idle gaps summed by what the host was doing, and the counts that show
    whether events were dropped. None without request spans."""
    reqs = [e for e in host_events if e[0] == SPAN + "request"]
    if not reqs:
        return None
    w0, w1 = min(e[1] for e in reqs), max(e[2] for e in reqs)
    inside = [(t0, t1) for _, t0, t1 in device_events if t1 > w0 and t0 < w1]
    busy = _union([(max(t0, w0), min(t1, w1)) for t0, t1 in inside])
    busy_us = sum(t1 - t0 for t0, t1 in busy)
    by_op: dict = {}
    for name, t0, t1 in device_events:
        if t1 > w0 and t0 < w1:
            by_op[name] = by_op.get(name, 0.0) + (min(t1, w1) - max(t0, w0))
    spans = _Innermost([e for e in host_events if e[0].startswith(SPAN)])
    ops = _Innermost([e for e in host_events if not e[0].startswith(SPAN)])
    gaps: dict = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        where = (spans.at(mid) or "client").removeprefix(SPAN)
        op = ops.at(mid)
        name = f"{where}:{op}" if op else where
        gaps[name] = gaps.get(name, 0.0) + (g1 - g0)
    n_kernels = sum(1 for name, _, _ in device_events
                    if not name.startswith(("Memcpy", "Memset")))
    n_launches = sum(1 for e in host_events if e[0] in LAUNCH_CALLS)
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "requests": len(reqs),
        "kernels": n_kernels,
        "launch_calls": n_launches,
        "device_ops": [[n[:160], s / 1e6] for n, s in
                       sorted(by_op.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[n[:160], s / 1e6] for n, s in
                      sorted(gaps.items(), key=lambda kv: -kv[1])[:top]],
    }


def complete(st: dict | None) -> bool:
    """Whether a stretch recorded a kernel for (nearly) every launch the
    host made; where the host's launch calls were not recorded, whether it
    recorded any device activity at all."""
    if st is None or st["busy_s"] <= 0:
        return False
    return st["launch_calls"] == 0 or st["kernels"] >= 0.9 * st["launch_calls"]
