"""What the benchmark can read from the program's own spans and counters
(`diskrag_tpu_torch/utils/profiling.py`): the stretches that record them,
the readers of the per-layer numbers they give, and a probe that runs one
cell with those stretches.

Two stretches, which every `--trace 1` run makes (`harness.measure`)
after the window and the harness's profiled stretch, on request numbers
past those it took, so that stretch sees the requests it saw before:

- the span stretch (`span_stretch`): `n` requests, each sent once with
  tracing on and no profiler running: the spans, the counters and each
  request's engine stats. The probe sends each request a second time,
  with tracing off, beside its traced send (`paired`), for the tracing's
  cost (the median over the requests of the traced send's latency over
  the untraced one's: paired, since the host's speed drifts by more than
  that cost over seconds);
- the profiled span stretch (`profiled_span_stretch`): requests with
  tracing on under `torch.profiler` (device and host), where each span is
  a `diskrag.*` range: the launches a traversal round, the device time of
  the kernels launched inside each span, and the device's idle gaps named
  by the innermost program span.

Both run after the profiler has run once in the process, which slows the
host's later work (~20%): their host times are comparable from run to
run and from PR to PR, not with the window's.

The readers take the `program` dict a traced run keeps as `run.program`
(`span_stretch`'s result, with the profiled span stretch under
"profiled"; the probe adds the set-up's records under "setup") and return
None where it holds nothing to read, as a program without the recorder
leaves it.

    python3 -m cudabench.program_spans --workload sift1m-exact-b1 --seed 7 --seconds 50

from the root of a checkout runs the cell as `run.py --trace 1` does
(`harness.measure`), with the span stretch paired, the collection stage
of the set-up traced and the cost of one span site taken first; it prints
the harness's summary and result lines, then one line of its own: every
reader's value, the digest of the stretches (`digest`: the span summary
and counters, the tracing's cost, the idle gaps by program span, the
check that the round spans lie inside the engine's search time), the
set-up's spans and the cost of a span site.
"""

from __future__ import annotations

import bisect
import json
import statistics
import time

from cudabench import trace

PREFIX = "diskrag."
ROUND = PREFIX + "graph.round"


def recorder():
    """The program's span recorder, or None where the program has none."""
    try:
        from diskrag_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "tracing") else None


# --- the stretches --------------------------------------------------------


def span_stretch(call, stream, first: int, n: int, paired: bool = False) -> dict | None:
    """Requests `first` .. `first + n - 1`, each sent once with tracing on:
    the spans and counters they recorded and each one's engine stats.
    With `paired` each is also sent with tracing off, beside its traced
    send (first for every other request, so that neither side always
    runs second), for the tracing's cost: the median over the requests of
    the traced send's latency over the untraced one's. None without the
    recorder."""
    prof = recorder()
    if prof is None:
        return None
    prof.drain()
    prof.counters(reset=True)
    ratios, lat_off, lat_on, stats = [], [], [], []
    for j, i in enumerate(range(first, first + n)):
        lat = {}
        sends = ((False, True) if j % 2 == 0 else (True, False)) if paired else (True,)
        for on in sends:
            t0 = time.perf_counter()
            if on:
                with prof.tracing():
                    out = call(stream.texts(i))
                stats.append(dict(out["stats"]))
            else:
                call(stream.texts(i))
            lat[on] = time.perf_counter() - t0
        lat_on.append(lat[True])
        if paired:
            lat_off.append(lat[False])
            ratios.append(lat[True] / lat[False])
    dropped = prof.dropped()
    records = prof.drain()
    out = {"records": records, "counters": prof.counters(reset=True), "dropped": dropped,
           "summary": prof.summary(records), "stats": stats,
           "median_ms_on": statistics.median(lat_on) * 1e3}
    if paired:
        out.update(median_ms_off=statistics.median(lat_off) * 1e3,
                   overhead=statistics.median(ratios))
    return out


def span_cost_ns(reps: int = 100_000) -> dict | None:
    """Host ns of one span site (enter and exit) with tracing off and on,
    and of one counter site off, on this host."""
    import timeit

    prof = recorder()
    if prof is None:
        return None
    span = prof.span
    site = "with span('graph.round.sync'):\n    pass"
    t = {"off": timeit.timeit(site, globals={"span": span}, number=reps)}
    t["count_off"] = timeit.timeit("count('graph.rounds')", globals={"count": prof.count},
                                   number=reps)
    with prof.tracing():
        t["on"] = timeit.timeit(site, globals={"span": span}, number=reps)
    prof.drain()
    return {k: v / reps * 1e9 for k, v in t.items()}


def profiled_span_stretch(call, stream, first: int, n: int, attempts: int = 3) -> dict | None:
    """`n` requests with tracing on under the profiler (device and host),
    each inside the harness's request span; retried while the profiler
    dropped kernels (`complete` says whether the last try kept them all).
    None without the recorder."""
    import torch

    prof = recorder()
    if prof is None:
        return None
    out = None
    for _ in range(attempts):
        with prof.tracing():
            with trace.profiling(host=True) as p:
                for i in range(first, first + n):
                    with trace.span("request"):
                        call(stream.texts(i))
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        prof.drain()
        by_span = device_ms_by_span(p.events())
        dev, host = trace.split_events(p)
        dev = [e for e in dev if not e[0].startswith(PREFIX)]  # the spans' device-side copies
        st = trace.stretch(dev, host)
        out = {"complete": trace.complete(st), "stretch": st,
               "launches_per_round": launches_per_round(host),
               "device_ms_by_span": by_span,
               "idle_gaps_by_span": idle_gaps_by_span(dev, host)}
        if out["complete"]:
            break
    return out


# --- readers of the span records --------------------------------------------


def _records(program) -> list:
    return (program or {}).get("records") or []


def _requests(records) -> int:
    return sum(1 for r in records if r.name == "engine.request")


def _ms(r) -> float:
    return (r.end_ns - r.start_ns) / 1e6


def _per_round(program, part: str):
    """Summed ms of each round's `part` ("dispatch": the round less its
    sync; "sync": its sync) over the rounds executed."""
    rounds_executed = ((program or {}).get("counters") or {}).get("graph.rounds")
    if not rounds_executed:
        return None
    recs = _records(program)
    sync = {r.parent: _ms(r) for r in recs if r.name == "graph.round.sync"}
    rounds = [r for r in recs if r.name == "graph.round"]
    if part == "sync":
        total = sum(sync.get(r.id, 0.0) for r in rounds)
    else:
        total = sum(_ms(r) - sync.get(r.id, 0.0) for r in rounds)
    return total / rounds_executed


def dispatch_ms(program):
    """Host ms a traversal round outside its wait on the device."""
    return _per_round(program, "dispatch")


def sync_wait_ms(program):
    """Ms a traversal round waits on the device ("is any query active?")."""
    return _per_round(program, "sync")


def join_self_ms(program):
    """Mean ms a request of the engine's text join, less the collector's
    pauses that fall inside it."""
    recs = _records(program)
    if not _requests(recs):
        return None
    pauses = [(r.start_ns, r.end_ns) for r in recs if r.name == "gc"]
    total = 0.0
    for j in (r for r in recs if r.name == "engine.join"):
        inside = sum(max(0, min(e, j.end_ns) - max(s, j.start_ns)) for s, e in pauses)
        total += (j.end_ns - j.start_ns - inside) / 1e6
    return total / _requests(recs)


def _mean_per_request(program, name: str):
    recs = _records(program)
    spans = [r for r in recs if r.name == name]
    if not spans or not _requests(recs):
        return None
    return sum(_ms(r) for r in spans) / _requests(recs)


def seed_ms(program):
    """Mean host ms a request of the traversal's seeding (`graph.seed` spans)."""
    return _mean_per_request(program, "graph.seed")


def seed_device_ms(program):
    """Mean device ms a request of the kernels the traversal's seeding
    launched (inside `diskrag.graph.seed` ranges of the profiled span
    stretch), wherever on the device they ran after the span closed."""
    p = (program or {}).get("profiled") or {}
    ms = (p.get("device_ms_by_span") or {}).get("graph.seed")
    requests = (p.get("stretch") or {}).get("requests")
    return ms / requests if ms and requests else None


def rerank_exposed_ms(program):
    """Mean ms a request waits for the host tier's reranks after its last traversal."""
    return _mean_per_request(program, "host_tier.rerank_wait")


def rerank_gather_ms(program):
    """Mean ms a request of the host tier's record reads (all its chunks)."""
    return _mean_per_request(program, "host_tier.rerank.gather")


def collection_update_s(program):
    """Seconds of the set-up's `update_collection`."""
    spans = [r for r in (program or {}).get("setup") or () if r.name == "collection.update"]
    return sum(_ms(r) for r in spans) / 1e3 if spans else None


def launches_per_round(host_events):
    """Kernel launches the host made inside traversal rounds (the
    `diskrag.graph.round` ranges of a profiled stretch) over those rounds."""
    rounds = sorted((t0, t1) for name, t0, t1 in host_events if name == ROUND)
    if not rounds:
        return None
    starts = [t0 for t0, _ in rounds]
    n = 0
    for name, t0, _ in host_events:
        if name in trace.LAUNCH_CALLS:
            i = bisect.bisect_right(starts, t0) - 1
            n += i >= 0 and t0 <= rounds[i][1]
    return n / len(rounds)


def device_ms_by_span(events) -> dict:
    """Device ms of the kernels launched inside each program span (a
    `diskrag.*` host range of a profiled stretch; a span's own kernels and
    those of the spans inside it), summed by span name. `events` are the
    profiler's function events: the profiler links a kernel to the
    PyTorch operator that launched it, which lies inside the span. A
    kernel launched outside any operator (the port's own library's, as
    the graph traversal's) is linked to none and counts nowhere."""
    import torch

    out: dict = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(PREFIX):
            name = e.name.removeprefix(PREFIX)
            out[name] = out.get(name, 0.0) + e.device_time_total / 1e3
    return out


def profiled_launches_per_round(program):
    """`launches_per_round` of the profiled span stretch."""
    p = (program or {}).get("profiled")
    return p["launches_per_round"] if p else None


def idle_gaps_by_span(device_events, host_events, top: int = 10):
    """The device's idle gaps between the first and the last request span,
    summed by the innermost program span (`diskrag.*`) at each gap's
    middle ("none" outside every one), the `top` largest in seconds."""
    reqs = [e for e in host_events if e[0] == trace.SPAN + "request"]
    if not reqs:
        return None
    w0, w1 = min(e[1] for e in reqs), max(e[2] for e in reqs)
    busy = trace._union([(max(t0, w0), min(t1, w1)) for _, t0, t1 in device_events
                         if t1 > w0 and t0 < w1])
    spans = trace._Innermost([e for e in host_events if e[0].startswith(PREFIX)])
    gaps: dict = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        name = (spans.at(0.5 * (g0 + g1)) or "none").removeprefix(PREFIX)
        gaps[name] = gaps.get(name, 0.0) + (g1 - g0) / 1e6
    return [[n, s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]


def round_cover(program):
    """Per request of the span stretch, the summed round spans over the
    engine's search time less its fetch: (smallest, largest)."""
    if not (program or {}).get("stats"):
        return None
    recs = _records(program)
    reqs = [r.request for r in recs if r.name == "engine.request"]
    by_req: dict = {}
    for r in recs:
        if r.name == "graph.round":
            by_req[r.request] = by_req.get(r.request, 0.0) + _ms(r)
    cover = [by_req.get(q, 0.0) / ((s["search_time"] - s["fetch_time"]) * 1e3)
             for q, s in zip(reqs, program["stats"])]
    return min(cover), max(cover)


READERS = {
    "graph.seed_ms": seed_ms,
    "graph.seed_device_ms": seed_device_ms,
    "graph.dispatch_ms": dispatch_ms,
    "graph.sync_wait_ms": sync_wait_ms,
    "graph.launches_per_round": profiled_launches_per_round,
    "engine.join_self_ms": join_self_ms,
    "host_tier.rerank_exposed_ms": rerank_exposed_ms,
    "host_tier.rerank_gather_ms": rerank_gather_ms,
    "collection.update_s": collection_update_s,
}


# --- the digest and the probe ------------------------------------------------


def digest(program: dict) -> dict:
    """What the stretches saw, for a run's summary line: the span summary,
    counters and dropped records, the tracing's cost, the round cover
    and, of the profiled span stretch, its completeness, its stretch and
    its idle gaps by program span; the tracing's cost where the span
    stretch was paired (the probe)."""
    prof = recorder()
    p = program.get("profiled") or {}
    return {
        "spans": prof.summary(_records(program)) if prof else None,
        "counters": program.get("counters"), "dropped": program.get("dropped"),
        "tracing_overhead": program.get("overhead"),
        "median_ms_off_on": [program.get("median_ms_off"), program.get("median_ms_on")],
        "round_cover": round_cover(program),
        "profiled_complete": p.get("complete"),
        "profiled_stretch": {k: (p.get("stretch") or {}).get(k) for k in
                             ("window_s", "busy_s", "requests", "kernels", "launch_calls")},
        "device_ms_by_span": p.get("device_ms_by_span"),
        "idle_gaps_by_span": p.get("idle_gaps_by_span"),
    }


def probe(workload: str, seed: int, seconds: float) -> dict:
    """One `--trace 1` run of `workload` (`harness.measure`, its span
    stretch paired), with the cost of a span site taken first (before any
    profiler runs in the process) and the set-up's collection stage
    traced; returns the probe's line."""
    from cudabench import harness
    from diskrag_tpu_torch.data.collection import CollectionManager

    prof = recorder()
    if prof is None:
        raise SystemExit("cudabench: the program has no span recorder")
    cost = span_cost_ns()
    setup: list = []
    update = CollectionManager.update_collection

    def traced_update(self, *a, **kw):
        with prof.tracing():
            out = update(self, *a, **kw)
        setup.extend(prof.drain())
        prof.counters(reset=True)
        return out

    CollectionManager.update_collection = traced_update
    try:
        run, line = harness.measure(workload, seed, seconds, True, span_pairs=True)
    finally:
        CollectionManager.update_collection = update
    print(json.dumps(line), flush=True)
    program = {**(run.program or {}), "setup": setup}
    return {"workload": workload, "seed": seed,
            "metrics": {name: fn(program) for name, fn in READERS.items()},
            **digest(program), "setup_spans": prof.summary(setup), "span_cost_ns": cost}


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="One traced run of a cell with the program's spans.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=50.0)
    args = ap.parse_args(argv)
    print(json.dumps(probe(args.workload, args.seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    from cudabench import harness

    harness.cache_dirs(harness.ROOT)
    raise SystemExit(main())
