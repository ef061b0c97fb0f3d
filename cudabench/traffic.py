"""The one general generator: reads a traffic mix's data file and drives
requests at the system for a fixed time.

A mix (`traffic/<name>.json`) gives `batch` (query texts a request),
`l_search`, `loop` and its parameters, `warmup_requests` and
`profile_requests`. The request stream is the query pool in one seeded
order, cycled: request i asks for positions [i * batch, (i + 1) * batch)
of it.

- `"loop": "closed"`: one caller sends the next request when the last
  returned. A request's latency is call to return.
- `"loop": "open"`: requests fall due at `rate` a second (Poisson gaps,
  their order drawn from the seed), plus `burst_size` extra requests due
  together every `burst_every_s` seconds (0: no bursts);
  `concurrency` caller threads take them in order of due time. A
  request's latency runs from its due time, so a stall counts against
  every request queued behind it; `lateness_s` says how late a request
  was taken up.
"""

from __future__ import annotations

import json
import pathlib
import threading
import time

import numpy as np


def load(path: pathlib.Path) -> dict:
    mix = json.loads(path.read_text())
    for key in ("batch", "l_search", "loop", "warmup_requests", "profile_requests"):
        if key not in mix:
            raise ValueError(f"{path}: traffic mix lacks {key!r}")
    if mix["loop"] not in ("closed", "open"):
        raise ValueError(f"{path}: unknown loop {mix['loop']!r}")
    return mix


class RequestStream:
    """Request i's pool positions and query texts; text "q<j>" is pool query j."""

    def __init__(self, mix: dict, pool_size: int, seed: int):
        self.batch = int(mix["batch"])
        self.order = np.random.default_rng([int(seed), 2]).permutation(pool_size)

    def pool_ids(self, i: int) -> np.ndarray:
        pos = np.arange(i * self.batch, (i + 1) * self.batch) % self.order.size
        return self.order[pos]

    def texts(self, i: int) -> list[str]:
        return [f"q{j}" for j in self.pool_ids(i).tolist()]


def drive(call, stream: RequestStream, mix: dict, seconds: float, first: int,
          seed: int, consume) -> tuple[list[dict], float]:
    """Send requests from request `first` on for `seconds`; `call(texts)`
    answers one request and `consume(i, answer)` takes its result after the
    latency is read (a closed loop's caller pays for it before its next
    request). Returns (one record a request, in order of request number:
    i, t_due, t_start, t_end, latency_s, answer or error; the window's
    seconds, from its start to the last answer)."""
    if mix["loop"] == "closed":
        return _closed(call, stream, seconds, first, consume)
    return _open(call, stream, mix, seconds, first, seed, consume)


def _one(call, stream, i, t_due, consume) -> dict:
    texts = stream.texts(i)
    t0 = time.perf_counter()
    try:
        out, err = call(texts), None
    except Exception as e:  # noqa: BLE001 — a failed request is counted, not fatal
        out, err = None, f"{type(e).__name__}: {e}"
    t1 = time.perf_counter()
    rec = {"i": i, "t_due": t_due, "t_start": t0, "t_end": t1,
           "latency_s": t1 - (t0 if t_due is None else t_due), "error": err}
    consume(rec, out)
    return rec


def _closed(call, stream, seconds, first, consume):
    recs = []
    t_start = time.perf_counter()
    deadline = t_start + seconds
    i = first
    while time.perf_counter() < deadline:
        recs.append(_one(call, stream, i, None, consume))
        i += 1
    return recs, time.perf_counter() - t_start


def due_times(mix: dict, seconds: float, seed: int) -> np.ndarray:
    """Seconds after the window's start at which each request falls due:
    round(rate * seconds) Poisson arrivals (exponential gaps, scaled to
    the window) plus the bursts. Every seed gets the same set of gaps,
    drawn from a fixed stream, in its own order: the seed changes the
    arrivals, not the load."""
    n = max(1, round(float(mix["rate"]) * seconds))
    gaps = np.random.default_rng(0).exponential(1.0, size=n + 1)
    gaps *= seconds / gaps.sum()
    t = np.cumsum(np.random.default_rng([int(seed), 3]).permutation(gaps))[:n]
    every, size = float(mix.get("burst_every_s", 0)), int(mix.get("burst_size", 0))
    if every > 0 and size > 0:
        bursts = np.repeat(np.arange(every, seconds, every), size)
        t = np.sort(np.concatenate([t, bursts]), kind="stable")
    return t


def _open(call, stream, mix, seconds, first, seed, consume):
    due = due_times(mix, seconds, seed)
    lock = threading.Lock()
    nxt = [0]
    recs: list[dict] = []
    answers: dict = {}
    t_start = time.perf_counter()

    def keep(rec, out):
        with lock:
            answers[rec["i"]] = out

    def caller():
        while True:
            with lock:
                j = nxt[0]
                nxt[0] += 1
            if j >= due.size:
                return
            t_due = t_start + float(due[j])
            wait = t_due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            rec = _one(call, stream, first + j, t_due, keep)
            rec["lateness_s"] = rec["t_start"] - t_due
            with lock:
                recs.append(rec)

    threads = [threading.Thread(target=caller) for _ in range(int(mix.get("concurrency", 1)))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    window = time.perf_counter() - t_start
    recs.sort(key=lambda r: r["i"])
    for r in recs:
        consume(r, answers.pop(r["i"]))
    return recs, window
