"""Tracing of the port: one span recorder, and a `torch.profiler` capture
that writes a Chrome trace.

The recorder is off by default. `tracing()` (a context manager) or
`enable()` / `disable()` turn it on. While it is off, `span()` and
`request()` return one shared no-op context manager and `count()` returns
at once: a site costs a check of the module's flag.

While it is on, each span records its name, its own id, its parent's id,
the request id, the thread, its start and end (`time.perf_counter_ns`)
and its attributes. The open span and its request travel in a
`contextvars.ContextVar`, so work handed to a thread pool through
`contextvars.copy_context().run` records under the span that handed it
over. `request()` opens a span with a fresh request id; a `span()` takes
its enclosing span's. Each collection of the interpreter's garbage
collector is recorded as a `gc` span (attribute `generation`) under the
span open on the thread that triggered it. When a `torch.profiler` session
is recording, each span also opens `record_function("diskrag." + name)`,
so the spans lie on the profiler's timeline beside the device's work and
in the Chrome trace `device_trace` writes.

Records are held in memory, the newest `CAPACITY` of them (older ones are
counted as `dropped()`); `drain()` returns and clears them, `summary()`
gives count, total ms and self ms by name. `count(name, n)` adds to a
named counter, `counters()` reads them.
"""

from __future__ import annotations

import contextlib
import contextvars
import gc
import itertools
import logging
import pathlib
import threading
import time
from collections import deque
from typing import NamedTuple

import torch

from diskrag_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)

CAPACITY = 1 << 20
PREFIX = "diskrag."


class SpanRecord(NamedTuple):
    name: str
    id: int
    parent: int | None
    request: int | None
    thread: int
    start_ns: int
    end_ns: int
    attrs: dict


# the one context manager every span site gets while tracing is off
_OFF = contextlib.nullcontext()
_on = False
# reentrant: the collector can run (and record its `gc` span) on a thread
# between any two bytecodes, also while that thread holds the lock
_lock = threading.RLock()
# plain tuples in SpanRecord's order, made `SpanRecord`s when read; a
# deque's append is atomic, so recording takes no lock
_records: deque = deque(maxlen=CAPACITY)
_dropped = 0
_counters: dict[str, int] = {}
_ids = itertools.count(1)
_requests = itertools.count(1)
_current: contextvars.ContextVar = contextvars.ContextVar("diskrag_span", default=None)


def _keep(rec: tuple) -> None:
    global _dropped
    if len(_records) == _records.maxlen:
        with _lock:
            _dropped += 1
    _records.append(rec)


class _Span:
    __slots__ = ("name", "attrs", "new_request", "id", "parent", "request", "t0", "token", "rf")

    def __init__(self, name: str, attrs: dict, new_request: bool):
        self.name, self.attrs, self.new_request = name, attrs, new_request

    def __enter__(self):
        outer = _current.get()
        self.parent = outer.id if outer is not None else None
        if self.new_request:
            self.request = next(_requests)
        else:
            self.request = outer.request if outer is not None else None
        self.id = next(_ids)
        self.token = _current.set(self)
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.autograd.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        _current.reset(self.token)
        _keep((self.name, self.id, self.parent, self.request, threading.get_ident(), self.t0, t1,
               self.attrs))
        return False


def span(name: str, **attrs):
    """A span of the enclosing span's request (none outside one)."""
    if not _on:
        return _OFF
    return _Span(name, attrs, False)


def request(name: str, **attrs):
    """A span that starts a request: its spans carry a fresh request id."""
    if not _on:
        return _OFF
    return _Span(name, attrs, True)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


class _GcHook:
    """Records each collection as a `gc` span under the span open on the
    thread that triggered it (collections do not nest)."""

    def __init__(self):
        self.t0 = 0
        self.rf = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self.rf = None
            if torch.autograd._profiler_enabled():
                self.rf = torch.autograd.profiler.record_function(PREFIX + "gc")
                self.rf.__enter__()
            self.t0 = time.perf_counter_ns()
            return
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None
        outer = _current.get()
        _keep(("gc", next(_ids), outer.id if outer is not None else None,
               outer.request if outer is not None else None, threading.get_ident(), self.t0, t1,
               {"generation": info["generation"]}))


_gc_hook = _GcHook()


def enabled() -> bool:
    return _on


def enable() -> None:
    """Start recording spans, counters and the collector's pauses."""
    global _on
    if not _on:
        gc.callbacks.append(_gc_hook)
        _on = True


def disable() -> None:
    """Stop recording; what was recorded stays until `drain()`."""
    global _on
    if _on:
        _on = False
        gc.callbacks.remove(_gc_hook)


@contextlib.contextmanager
def tracing():
    """Recording on for the block (and left as it was after it)."""
    was = _on
    enable()
    try:
        yield
    finally:
        if not was:
            disable()


def drain() -> list[SpanRecord]:
    """The records held, oldest first; clears them and the dropped count."""
    global _dropped
    with _lock:
        # popped one by one: a span recorded meanwhile stays for the next drain
        out = [SpanRecord._make(_records.popleft()) for _ in range(len(_records))]
        _dropped = 0
    return out


def dropped() -> int:
    """Records lost to the buffer's capacity since the last `drain()`."""
    return _dropped


def counters(reset: bool = False) -> dict[str, int]:
    """The counters' values (zeroed after reading with `reset`)."""
    with _lock:
        out = dict(_counters)
        if reset:
            _counters.clear()
    return out


def summary(records: list[SpanRecord] | None = None) -> dict[str, dict[str, float]]:
    """{name: {count, total_ms, self_ms}} over `records` (default: those
    held). A span's self time is its own less the parts of its children
    (the `gc` spans under it included) that fall inside it."""
    if records is None:
        records = [SpanRecord._make(r) for r in list(_records)]
    inside: dict[int, int] = {}
    by_id = {r.id: r for r in records}
    for r in records:
        p = by_id.get(r.parent) if r.parent is not None else None
        if p is not None:
            inside[p.id] = inside.get(p.id, 0) + max(
                0, min(r.end_ns, p.end_ns) - max(r.start_ns, p.start_ns))
    out: dict[str, dict[str, float]] = {}
    for r in records:
        s = out.setdefault(r.name, {"count": 0, "total_ms": 0.0, "self_ms": 0.0})
        dur = r.end_ns - r.start_ns
        s["count"] += 1
        s["total_ms"] += dur / 1e6
        s["self_ms"] += (dur - inside.get(r.id, 0)) / 1e6
    return out


@contextlib.contextmanager
def device_trace(log_dir: str = "diskrag_tpu_torch_trace", *, device: str = "cuda"):
    """Capture a `torch.profiler` trace of the block (host activity, and
    the card's when `device` is one) and write it as a Chrome trace
    (`trace.json`, viewable in Perfetto / chrome://tracing) under
    `log_dir`. Yields the directory. With the recorder on (`tracing()`),
    the program's spans appear in it as `diskrag.*` ranges."""
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
