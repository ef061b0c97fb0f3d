#!/usr/bin/env python3
"""The PyTorch/CUDA port's bench (counterpart of `bench.py`, which stays
the JAX package's): prints ONE JSON line.

Metric: QPS on one card at recall@10 >= 0.95 on the seeded SIFT-like
clustered set (`make_dataset(n, 128, 1000, seed=42)`), with the graph's
build time beside it. Stages, in `bench.py`'s order and under its budget
gate (a stage runs only if its estimate fits in what is left):
  1. 200k core: `sweep_flat` with the B = 2048 packed point, the degree-48
     `build_vamana_knn` cold (and warm when the cold build fits its
     estimate), `sweep_exact` at L (16, 24) x E (8, 12)
  2. 1M compact: `sweep_flat` (no big batch), the same build,
     `sweep_exact` at L 16 / E 12, `sweep_iq` iq8 at L 16 / E 8
  3. 1M host tier: the 1M graph persisted with iq8 rows and the record
     file, served by `SearchEngine(serving_mode="host_tier")` at
     L 32 / 48, E 8, the best of 3
  4. 200k extras: `sweep_ivf` (cold and warm builds), iq8 (L 16 / 24),
     iq4 with 1024 cells (L 32), residual PQ m = 32 (L 32 / 64, E 4)
  5. serving: `tools/serving_bench.measure_serving` at B = 512 in modes
     flat, vamana, streaming and host_tier, no HTTP
An error in the 200k core prints the line and exits 1; an error in a
later stage becomes its `*_error` key and the line still prints.

Output: ONE JSON line, the detail keys first and the headline group last
(`metric` leading it, at most 1800 characters), so that a reader of the
last 2000 characters of stdout gets the metric of record. Floats in the
line are rounded; the full record, unrounded, is written indented to
chiprun_out/last_bench_cuda.json by runs of the full 200k protocol.
`device` names the card and its power limit (nvidia-smi), `launches` the
run's kernel launches by kernel id, `kernel_build_seconds` the first use's
nvcc build of `diskrag_tpu_torch/csrc/`. `vs_baseline` is null: no
baseline was measured for this card.

    python3 bench_cuda.py [--device cuda|cpu]

Runs on the card by default and raises without one; `--device cpu` runs
every stage on the CPU through the kernels' plain versions (a pipeline
smoke, not a measurement: the sweeps' timed windows shrink from 1.5 s to
0.01 s there). Env knobs, as bench.py's: BENCH_N (200000),
BENCH_QUERIES (1000), BENCH_DIM (128), BENCH_BUDGET_S (1560),
BENCH_1M (1), BENCH_1M_N (1000000), BENCH_HOST_TIER (1), BENCH_HT_DIR
(the host tier's collection directory, default build/bench_cuda_host_tier
in the checkout), BENCH_SERVING (1).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# Stage estimates in seconds for the budget gate, about three times the
# walls of this script's first run on an H100 80GB HBM3 at 700 W (PERF.md
# §6): the 1M stage 40.9 s (two 1M builds 13.1 / 12.8 s, the iq8
# point included), the host tier 8.3, the 200k extras 33.1 in all, serving
# 11.0; the kNN builds' figures before it (1M degree 48: 14.3-20.7 s;
# 200k: 2.9 s) agree.
EST_1M_STAGE_S = 120      # data, ground truth, 5 flat points, 2 builds, 1 exact point
EST_1M_EXTRAS_S = 30      # iq8 fit + encode (4.7 s at 1M) and one point
EST_HOST_TIER_S = 30      # iq8 fit, save with the record file, 2 widths x 4 calls
EST_IVF_S = 20            # two 200k IVF builds (0.45 s each) and 4 probe widths
EST_IQ8_S = 20
EST_IQ4_S = 30            # 1024-cell k-means over 200k and one point
EST_RPQ_S = 40            # residual PQ fit (32 subspaces, 1024 cells) and two points
EST_SERVING_S = 60        # the 200k collection, 4 modes, 16 pipelined batches
# a cold build over this many seconds skips the warm rebuild (1M / 200k)
WARM_AFTER_COLD_S = {True: 60, False: 30}


class _Budget:
    """Elapsed-wall gate: a stage runs only if its estimate fits in what
    is left, so a slow early stage makes later ones skip instead of
    overrunning the cap."""

    def __init__(self, total_s: float):
        self.t0 = time.monotonic()
        self.total = total_s
        self.skipped: list[str] = []

    @property
    def elapsed(self) -> float:
        return time.monotonic() - self.t0

    def allow(self, stage: str, need_s: float) -> bool:
        if self.elapsed + need_s > self.total:
            self.skipped.append(stage)
            print(f"# budget: skipping {stage} ({self.elapsed:.0f}s elapsed + ~{need_s:.0f}s "
                  f"needed > {self.total:.0f}s cap)", file=sys.stderr)
            return False
        return True


def _min_seconds(dev) -> float:
    """The sweeps' shortest timed window: 1.5 s on the card (the sweeps'
    default); 0.01 s on the CPU, whose run is a pipeline smoke, not a
    measurement."""
    return 1.5 if dev.type == "cuda" else 0.01


def _core_scale(n: int, dim: int, n_queries: int, k: int, *, compact: bool, bud: _Budget, dev):
    """The metric-of-record sweep at one scale: the flat scans (default,
    packed and adaptive points; at 200k the B = 2048 packed point) and the
    degree-48 graph (the kNN build, exact traversal). Returns (points,
    timings, (pts, queries, gt, index))."""
    import torch

    from diskrag_tpu_torch.benchmark import ground_truth, make_dataset, sweep_exact, sweep_flat
    from diskrag_tpu_torch.graph.knn_build import build_vamana_knn

    pts, queries = make_dataset(n, dim, n_queries)
    gt = ground_truth(pts, queries, k, device=dev)
    ms = _min_seconds(dev)
    points = sweep_flat(pts, queries, gt, k=k, big_batch=0 if compact else 2048,
                        min_seconds=ms, device=dev)

    def build():
        t0 = time.perf_counter()
        index = build_vamana_knn(pts, degree_bound=48, alpha=1.2, seed=0, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return index, time.perf_counter() - t0

    # the first build also pays the data's upload and every operation's
    # first call; the second is the steady-state build
    index, cold = build()
    timings = {"build_seconds_cold": cold}
    if cold <= WARM_AFTER_COLD_S[compact] and bud.allow(f"warm_build_{n // 1000}k", cold):
        index, timings["build_seconds"] = build()
    points += sweep_exact(index, queries, gt, k=k, widths=(16,) if compact else (16, 24),
                          expand_widths=(12,) if compact else (8, 12), min_seconds=ms)
    return points, timings, (pts, queries, gt, index)


def _extras_scale(pts, queries, gt, index, k: int, *, tag: str, compact: bool, bud: _Budget, dev):
    """The optional tiers at a built scale: IVF tiles, and the compressed
    traversals iq8, iq4 with 1024 cells and residual PQ m = 32."""
    from diskrag_tpu_torch.benchmark import sweep_iq, sweep_ivf, sweep_pq
    from diskrag_tpu_torch.pq import IntQuantizer, ResidualPQ

    ms = _min_seconds(dev)
    points, timings = [], {}
    if not compact and bud.allow(f"ivf_{tag}", EST_IVF_S):
        ivf_points, (ivf_cold, ivf_warm) = sweep_ivf(pts, queries, gt, k=k, min_seconds=ms,
                                                     device=dev)
        points += ivf_points
        timings["ivf_build_seconds_cold"] = ivf_cold
        timings["ivf_build_seconds"] = ivf_warm
    if bud.allow(f"iq8_{tag}", EST_IQ8_S):
        iq8 = IntQuantizer(bits=8, device=dev).fit(pts, seed=0)
        points += sweep_iq(index, iq8, iq8.encode(pts), queries, gt, k=k,
                           widths=(16,) if compact else (16, 24), expand_widths=(8,),
                           min_seconds=ms)
    if not compact:
        if bud.allow(f"iq4_{tag}", EST_IQ4_S):
            iq4 = IntQuantizer(bits=4, n_cells=1024, device=dev).fit(pts, seed=0)
            points += sweep_iq(index, iq4, iq4.encode(pts), queries, gt, k=k, widths=(32,),
                               expand_widths=(8,), min_seconds=ms)
        if bud.allow(f"rpq_{tag}", EST_RPQ_S):
            rpq = ResidualPQ(n_subvectors=32, device=dev).fit(pts, seed=0)
            codes, cids = rpq.encode(pts)
            points += sweep_pq(index, rpq, codes, queries, gt, k=k, widths=(32, 64),
                               expand_widths=(4,), coarse_ids=cids, min_seconds=ms)
    return points, timings


def _host_tier_stage(pts, queries, gt, index, k: int, dev) -> dict:
    """The beyond-HBM tier through the engine: the built 1M graph
    persisted with iq8 rows and the packed record file, then served by
    `SearchEngine(serving_mode="host_tier")` (int8 traversal on the card,
    exact rerank of host vectors read by the native record reader) at
    L 32 / 48, E 8, the best of 3 calls after a full-shape warm-up."""
    import numpy as np

    from diskrag_tpu_torch.benchmark import recall_at_k
    from diskrag_tpu_torch.data.collection import CollectionManager
    from diskrag_tpu_torch.engine import SearchEngine
    from diskrag_tpu_torch.index.persist import save_index
    from diskrag_tpu_torch.pq.intq import IntQuantizer

    base = os.environ.get("BENCH_HT_DIR") or str(ROOT / "build" / "bench_cuda_host_tier")
    name = "bench1m"
    mgr = CollectionManager(base)
    if mgr.get_collection_info(name) is None:
        mgr.create_collection(name, int(pts.shape[1]))
    t0 = time.perf_counter()
    iq8 = IntQuantizer(bits=8, device=dev).fit(pts, seed=0)
    save_index(mgr.get_index_dir(name), index, pq=iq8, pq_codes=iq8.encode(pts),
               meta_extra={"recommended_search_L": 32, "recommended_expand_width": 8},
               write_compat=True, host_vectors=pts)
    prep_s = time.perf_counter() - t0
    eng = SearchEngine(name, base_dir=base, serving_mode="host_tier", run_diagnostics=False,
                       device=str(dev))
    out: dict = {"quantizer": "iq8", "prep_seconds": prep_s, "points": []}
    q = np.asarray(queries, np.float32)
    for l_search in (32, 48):
        eng.search_batch(q, k=k, l_search=l_search)
        best, ids, stats = float("inf"), None, None
        for _ in range(3):
            t0 = time.perf_counter()
            _, ids, stats = eng.search_batch(q, k=k, l_search=l_search)
            best = min(best, time.perf_counter() - t0)
        out["points"].append({"L": l_search, "E": 8, "recall": recall_at_k(ids, gt, k),
                              "qps": len(q) / best, "search_type": stats["search_type"]})
        out["stage_ms"] = dict(stats.get("stage_ms") or {})
    return out


def _device_report(dev) -> str:
    """The card's name and power limit as nvidia-smi prints them, or "cpu"."""
    import torch

    if dev.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={dev.index}"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(dev)}, power limit not read"


def _build_kernels(dev) -> float | None:
    """Build and load every CUDA kernel now (the first use's nvcc build of
    csrc/); its seconds. None on the CPU, where nothing is built."""
    if dev.type != "cuda":
        return None
    from diskrag_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    for stem in _build.build_all():
        _build.load(stem)
    return time.perf_counter() - t0


# Keys a reader of the last ~2000 characters of stdout must find, emitted
# in this order at the END of the line
_HEADLINE_KEYS = (
    "metric", "value", "unit", "recall", "search_width", "mode", "vs_baseline", "device",
    "build_seconds_cold", "build_seconds", "ivf_build_seconds_cold", "ivf_build_seconds",
    "kernel_build_seconds", "1m", "host_tier", "serving_qps_b512", "launches",
    "error", "extras_error", "1m_error", "host_tier_error", "serving_error",
    "budget_skipped", "bench_wall_seconds",
)
# head members dropped (in this order) if the group outgrows 1800 characters
_HEADLINE_DROPPABLE = ("serving_qps_b512", "launches", "host_tier", "1m")
_HEAD_MAX_CHARS = 1800


def _rounded(x):
    """`x` with every float rounded for the line: 4 decimals below 100,
    1 above."""
    if isinstance(x, float):
        return round(x, 4) if abs(x) < 100 else round(x, 1)
    if isinstance(x, dict):
        return {k: _rounded(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_rounded(v) for v in x]
    return x


def _split(record: dict) -> tuple[dict, dict]:
    """(detail keys, headline group in `_HEADLINE_KEYS` order)."""
    detail = {k: v for k, v in record.items() if k not in _HEADLINE_KEYS}
    return detail, {k: record[k] for k in _HEADLINE_KEYS if k in record}


def _emit(record: dict) -> None:
    """Print the one JSON line, the detail keys first and the headline
    group last, `metric` leading it (json.dumps keeps insertion order);
    drop optional head members while the group exceeds 1800 characters.
    The full-protocol (200k) run also writes the whole record, unrounded,
    to chiprun_out/last_bench_cuda.json."""
    if "sift-like-200k" in str(record.get("metric", "")):
        detail, head = _split(record)
        out = ROOT / "chiprun_out" / "last_bench_cuda.json"
        out.parent.mkdir(exist_ok=True)
        out.write_text(json.dumps({**detail, **head}, indent=1))
    detail, head = _split(_rounded(record))
    for k in _HEADLINE_DROPPABLE:
        if len(json.dumps(head)) <= _HEAD_MAX_CHARS:
            break
        head.pop(k, None)
    print(json.dumps({**detail, **head}), flush=True)


def _fmt(points) -> list[dict]:
    return [{"L": p.search_width, "E": p.expand_width, "recall": p.recall, "qps": p.qps,
             "mode": p.mode} for p in points]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="The port's bench: one JSON line.")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without a card) or cpu (a pipeline smoke)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from diskrag_tpu_torch.benchmark import best_qps_at_recall
    from diskrag_tpu_torch.device import resolve_device
    from diskrag_tpu_torch.kernels.launches import launch_counts, reset_launch_counts

    dev = resolve_device(args.device)
    n = int(os.environ.get("BENCH_N", "200000"))
    dim = int(os.environ.get("BENCH_DIM", "128"))
    n_queries = int(os.environ.get("BENCH_QUERIES", "1000"))
    k = 10
    bud = _Budget(float(os.environ.get("BENCH_BUDGET_S", "1560")))
    reset_launch_counts()
    walls: dict = {}
    record = {
        "metric": "qps_per_chip_at_recall10>=0.95_sift-like-%dk" % (n // 1000),
        "value": 0.0,
        "unit": "qps",
        "vs_baseline": None,
        "device": _device_report(dev),
        "stage_wall_seconds": walls,
    }

    def finish() -> None:
        record["launches"] = launch_counts()
        if bud.skipped:
            record["budget_skipped"] = bud.skipped
        record["bench_wall_seconds"] = bud.elapsed
        _emit(record)

    t_stage = time.perf_counter()
    try:
        record["kernel_build_seconds"] = _build_kernels(dev)
        points, timings, (pts, queries, gt, index) = _core_scale(
            n, dim, n_queries, k, compact=False, bud=bud, dev=dev)
        best = best_qps_at_recall(points, 0.95)
        if best is None:  # the highest-recall point, so that the line still says something
            best = max(points, key=lambda p: p.recall)
        record.update(value=best.qps, recall=best.recall, search_width=best.search_width,
                      mode=best.mode, **timings)
        record["sweep"] = _fmt(points)
    except Exception as e:  # noqa: BLE001 — the line must still print
        record["error"] = f"{type(e).__name__}: {e}"
        finish()
        return 1
    walls[f"core_{n // 1000}k"] = time.perf_counter() - t_stage

    n_1m = int(os.environ.get("BENCH_1M_N", "1000000"))
    if n_1m > n and os.environ.get("BENCH_1M", "1") == "1" and bud.allow("1m_stage",
                                                                         EST_1M_STAGE_S):
        t_stage = time.perf_counter()
        try:
            points_1m, timings_1m, (pts1, q1, gt1, index1) = _core_scale(
                n_1m, dim, n_queries, k, compact=True, bud=bud, dev=dev)
            if bud.allow("1m_extras", EST_1M_EXTRAS_S):
                extra_pts, extra_t = _extras_scale(pts1, q1, gt1, index1, k, tag="1000k",
                                                   compact=True, bud=bud, dev=dev)
                points_1m += extra_pts
                timings_1m.update(extra_t)
            best_1m = best_qps_at_recall(points_1m, 0.95)
            record["sweep_1m"] = _fmt(points_1m)
            record["1m"] = {
                "qps_at_recall0.95": best_1m.qps if best_1m else None,
                "recall": best_1m.recall if best_1m else None,
                "mode": best_1m.mode if best_1m else None,
                **timings_1m,
            }
            walls["1m"] = time.perf_counter() - t_stage
            if os.environ.get("BENCH_HOST_TIER", "1") == "1" and bud.allow("host_tier",
                                                                            EST_HOST_TIER_S):
                t_stage = time.perf_counter()
                try:
                    record["host_tier"] = _host_tier_stage(pts1, q1, gt1, index1, k, dev)
                except Exception as e:  # noqa: BLE001
                    record["host_tier_error"] = f"{type(e).__name__}: {e}"
                walls["host_tier"] = time.perf_counter() - t_stage
            del pts1, q1, gt1, index1
        except Exception as e:  # noqa: BLE001
            record["1m_error"] = f"{type(e).__name__}: {e}"
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    t_stage = time.perf_counter()
    try:
        extra_pts, extra_t = _extras_scale(pts, queries, gt, index, k, tag=f"{n // 1000}k",
                                           compact=False, bud=bud, dev=dev)
        points += extra_pts
        record["sweep"] = _fmt(points)
        record.update(**extra_t)
        best2 = best_qps_at_recall(points, 0.95)
        if best2 is not None and best2.qps > record["value"]:
            record.update(value=best2.qps, recall=best2.recall,
                          search_width=best2.search_width, mode=best2.mode)
    except Exception as e:  # noqa: BLE001
        record["extras_error"] = f"{type(e).__name__}: {e}"
    walls[f"extras_{n // 1000}k"] = time.perf_counter() - t_stage

    if os.environ.get("BENCH_SERVING", "1") == "1" and bud.allow("serving", EST_SERVING_S):
        t_stage = time.perf_counter()
        try:
            from diskrag_tpu_torch.tools.serving_bench import measure_serving

            serving = measure_serving(
                pts, np.asarray(queries), index=index, batches=(512,), k=k, repeats=5,
                http=False, modes=("flat", "vamana", "streaming", "host_tier"), device=str(dev),
            )
            record["serving_qps_b512"] = {m: rows[0]["qps"] for m, rows in serving.items()
                                          if isinstance(rows, list)}
            record["serving"] = serving
        except Exception as e:  # noqa: BLE001
            record["serving_error"] = f"{type(e).__name__}: {e}"
        walls["serving"] = time.perf_counter() - t_stage

    finish()
    return 0


if __name__ == "__main__":
    sys.exit(main())
