"""Readers shared by several metric files: each takes the run
(`harness.Run`) and returns the metric, or None where the run holds
nothing to read it from."""

from __future__ import annotations

import numpy as np

from cudabench import program_spans, roofline


def qps(run):
    """Queries answered in the window over the window's seconds."""
    n = sum(len(r["qidx"]) for r in run.answered)
    return n / run.window_s if run.window_s > 0 and n else None


def p95_ms(run):
    """95th percentile of every request's latency in the window."""
    lat = [r["latency_s"] for r in run.requests]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None


def join_ms(run):
    """Mean of the engine's own split of `search_many`: total less search
    less embedding, the text join."""
    t = [r["timing"] for r in run.answered]
    if not t:
        return None
    return float(np.mean([x["total_time"] - x["search_time"] - x["embedding_time"] for x in t])) * 1e3


def round_ms(run):
    """Host milliseconds a traversal round: the summed search time less
    the result fetch, over the summed rounds."""
    st = [r["stats"] for r in run.answered if "rounds" in r["stats"]]
    rounds = sum(s["rounds"] for s in st)
    if not rounds:
        return None
    return sum(s["search_time"] - s["fetch_time"] for s in st) / rounds * 1e3


def rounds(run):
    """Mean traversal rounds a request."""
    st = [r["stats"] for r in run.answered if "rounds" in r["stats"]]
    return float(np.mean([s["rounds"] for s in st])) if st else None


def stage_ms(run, stage: str):
    """Mean of the host tier's own stage split a request."""
    v = [r["stats"]["stage_ms"][stage] for r in run.answered
         if stage in r["stats"].get("stage_ms", {})]
    return float(np.mean(v)) if v else None


def build_stage_s(run, stage: str):
    v = run.build_stages.get(stage)
    return float(v) if v is not None else None


def setup_stage_s(run, stage: str):
    """Host-clock seconds of one stage of the set-up (`run.setup_spans`)."""
    v = run.setup_spans.get(stage)
    return float(v) if v is not None else None


def program(run, name: str):
    """The reader `name` of `program_spans.READERS` on the run's span
    stretches (`run.program`); None untraced or without the program's recorder."""
    return program_spans.READERS[name](run.program)


def roofline_share(run, kernel: str):
    """Percent of the kernel's bound in the build's kNN pass: the summed
    bounds of its launches over its device time, scaled up for events the
    profiler dropped. None without a profile, without launches, with under
    half of them recorded, or with launches other than the pass's shapes
    give."""
    prof = run.knn_profile or {}
    bk = prof.get("kernels", {}).get(kernel)
    launches = prof.get("launches", {}).get(kernel, 0)
    if not bk or not launches or bk["events"] < 0.5 * launches or bk["us"] <= 0:
        return None
    rows, _, kk = roofline.knn_params(int(run.config["n"]), int(run.config["degree_bound"]))
    if launches != len(rows):
        return None
    nb = roofline.KNN_BUCKETS
    if kernel == "B1":
        bound = sum(roofline.b1_bound_ms(b, int(run.config["n"]), int(run.config["dim"]), nb)[0]
                    for b in rows)
    else:
        bound = sum(roofline.b4_bound_ms(b, nb, kk)[0] for b in rows)
    device_ms = bk["us"] / 1e3 * launches / bk["events"]
    return 100.0 * bound / device_ms


def idle_pct(run):
    """Percent of the traced stretch in which no operation ran on the device."""
    st = run.stretch
    if not st or st["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - st["busy_s"] / st["window_s"])


def gc_share(run):
    """Percent of the window spent in the interpreter's garbage collector."""
    if run.gc is None or run.window_s <= 0:
        return None
    return 100.0 * sum(run.gc.seconds) / run.window_s
