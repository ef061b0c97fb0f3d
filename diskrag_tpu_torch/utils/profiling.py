"""Tracing / profiling utilities (counterpart of
`diskrag_tpu/utils/profiling.py`): phase timers with cumulative stats, a
`torch.profiler` capture that writes a Chrome trace, and a
warm-then-time helper whose window is closed by a device synchronize.
"""

from __future__ import annotations

import contextlib
import logging
import pathlib
import threading
import time
from collections import defaultdict

import torch

from diskrag_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)


class PhaseTimer:
    """Thread-safe named phase timing (engine/build instrumentation)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._totals: dict[str, float] = defaultdict(float)
        self._counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._totals[name] += dt
                self._counts[name] += 1

    def summary(self) -> dict[str, dict[str, float]]:
        with self._lock:
            return {
                name: {
                    "total_s": self._totals[name],
                    "count": self._counts[name],
                    "mean_ms": self._totals[name] / max(self._counts[name], 1) * 1e3,
                }
                for name in self._totals
            }

    def reset(self) -> None:
        with self._lock:
            self._totals.clear()
            self._counts.clear()


@contextlib.contextmanager
def device_trace(log_dir: str = "diskrag_tpu_torch_trace", *, device: str = "cuda"):
    """Capture a `torch.profiler` trace of the block (host activity, and
    the card's when `device` is one) and write it as a Chrome trace
    (`trace.json`, viewable in Perfetto / chrome://tracing) under
    `log_dir`. Yields the directory."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield log_dir
        finally:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    prof.export_chrome_trace(str(out / "trace.json"))
    logger.info("device trace written to %s", out / "trace.json")


def block_and_time(
    fn, *args, repeats: int = 3, device: str = "cuda", **kwargs
) -> tuple[float, object]:
    """Warm up, then time a callable; returns (seconds per call, result).

    PyTorch returns before the card finishes, so the timed window is
    closed by `torch.cuda.synchronize(device)`, which waits for every
    stream of the device: a full barrier. (Use `benchmark._measure` for a
    repeat count that grows until the window is long enough.)"""
    dev = resolve_device(device)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = fn(*args, **kwargs)
    sync()
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn(*args, **kwargs)
    sync()
    return (time.perf_counter() - t0) / repeats, out
