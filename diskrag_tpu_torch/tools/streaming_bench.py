"""Streaming-ingest measurement (counterpart of
`benchmarks/streaming_bench.py`): build a Vamana base graph, stream new
points through `StreamingIndex.insert` in batches, and time the whole
ingest (appends plus every merge it triggers).

Protocol, as the JAX script's: the base is the first `base_n` points of
`make_dataset(base_n + stream_n, dim, n_queries, seed)`, built by
`build_vamana_knn(degree_bound=48, alpha=1.2, seed=0)`; the tier takes the
other `stream_n` points in batches of `batch`. The first `capacity` points
and one merge are a warm-up outside the timed region (on the card the
first merge builds the scan kernels). Recall@k against an exact ground
truth over the live set is probed twice with the buffer half full (outside
the timed region) and after the last merge; then merged-search QPS is
measured with a half-full buffer. Each merge's seconds by stage and, on
the card, its kernel launches (`kernels/launches.py`) are recorded.

    python -m diskrag_tpu_torch.tools.streaming_bench [--base-n 200000] [--stream-n 131072]
        [--capacity 0] [--fraction 0.25] [--merge-method knn] [--device cuda]

prints one JSON line (`chip_smoke.py` calls `run` in process).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(
    *,
    base_n: int = 200_000,
    stream_n: int = 131_072,
    batch: int = 1024,
    dim: int = 128,
    n_queries: int = 1000,
    k: int = 10,
    search_width: int = 32,
    capacity: int | None = None,
    fraction: float = 0.25,
    merge_method: str = "knn",
    seed: int = 42,
    device: str = "cuda",
    qps_reps: int = 5,
) -> tuple[dict, object, np.ndarray]:
    """Run the protocol; returns (result dict, the StreamingIndex after the
    QPS measurement — its buffer half full —, the queries)."""
    from diskrag_tpu_torch.benchmark import ground_truth, make_dataset, recall_at_k
    from diskrag_tpu_torch.device import resolve_device
    from diskrag_tpu_torch.graph.knn_build import build_vamana_knn
    from diskrag_tpu_torch.index.streaming import StreamingIndex
    from diskrag_tpu_torch.kernels.launches import launch_counts

    dev = resolve_device(device)
    pts, queries = make_dataset(base_n + stream_n, dim, n_queries, seed=seed)
    base, stream = pts[:base_n], pts[base_n:]

    counts = launch_counts()
    t0 = time.perf_counter()
    index = build_vamana_knn(base, degree_bound=48, alpha=1.2, seed=0, device=dev)
    _sync(dev)
    build_s = time.perf_counter() - t0
    build_launches = {name: n - counts[name] for name, n in launch_counts().items()}

    idx = StreamingIndex(index, buffer_capacity=capacity, merge_insert_max_fraction=fraction,
                         merge_method=merge_method, reserve_inserts=stream_n)
    capacity = idx.capacity
    merges: list[dict] = []

    def recorded(call, *args) -> None:
        """`call(*args)` (an insert or a merge); a merge it ran is recorded
        with its stage seconds and its kernel launches."""
        before, counts = idx.n_merges, launch_counts()
        t = time.perf_counter()
        call(*args)
        if idx.n_merges > before:
            _sync(dev)
            after = launch_counts()
            merges.append({
                "seconds": time.perf_counter() - t,
                "stage_seconds": idx.last_merge_stage_seconds,
                "launches": {name: after[name] - counts[name] for name in after},
            })

    warm_n = capacity
    for off in range(0, warm_n, batch):
        recorded(idx.insert, stream[off : off + batch])
    recorded(idx.merge)
    idx.search(queries, k=k, search_width=search_width)
    _sync(dev)

    probes = []
    t0 = time.perf_counter()
    for off in range(warm_n, stream_n, batch):
        recorded(idx.insert, stream[off : off + batch])
        if idx.n_buffered == capacity // 2 and len(probes) < 2:
            # a serving call, not ingest work: outside the rate
            t_probe = time.perf_counter()
            live = np.concatenate([base, stream[: off + batch]])
            gt = ground_truth(live, queries, k, device=str(dev))
            ids, _ = idx.search(queries, k=k, search_width=search_width)
            probes.append({"n_live": int(idx.n_total_live), "n_buffered": int(idx.n_buffered),
                           "recall": recall_at_k(ids.cpu().numpy(), gt, k)})
            t0 += time.perf_counter() - t_probe
    recorded(idx.merge)
    ids, _ = idx.search(queries, k=k, search_width=search_width)
    ids = ids.cpu().numpy()  # the drain: everything enqueued above has run
    ingest_s = time.perf_counter() - t0

    gt = ground_truth(pts, queries, k, device=str(dev))
    final_recall = recall_at_k(ids, gt, k)

    # merged-search QPS with a half-full buffer, queries uploaded once
    idx.insert(stream[: capacity // 2])
    q_dev = torch.as_tensor(queries, device=dev)
    idx.search(q_dev, k=k, search_width=search_width)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(qps_reps):
        ids_t, _ = idx.search(q_dev, k=k, search_width=search_width)
    ids_t.cpu()
    search_s = (time.perf_counter() - t0) / qps_reps

    result = {
        "base_n": base_n, "stream_n": stream_n, "batch": batch, "capacity": capacity,
        "merge_method": merge_method, "merge_insert_max_fraction": fraction,
        "device": str(dev), "base_build_seconds": build_s, "base_build_launches": build_launches,
        "ingest_per_s": (stream_n - warm_n) / ingest_s, "ingest_seconds": ingest_s,
        "n_merges": idx.n_merges, "merges": merges,
        "mid_stream_probes": probes, "final_recall": final_recall,
        "search_ms_half_buffer": search_s * 1e3,
        "search_qps_half_buffer": n_queries / search_s,
        "search_width": search_width,
    }
    return result, idx, queries


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="diskrag_tpu_torch streaming-ingest benchmark")
    ap.add_argument("--base-n", type=int, default=200_000)
    ap.add_argument("--stream-n", type=int, default=131_072)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--n-queries", type=int, default=1000)
    ap.add_argument("--capacity", type=int, default=0, help="0 = the auto-sized buffer")
    ap.add_argument("--fraction", type=float, default=0.25)
    ap.add_argument("--merge-method", choices=["knn", "wave"], default="knn")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    result, _, _ = run(
        base_n=args.base_n, stream_n=args.stream_n, batch=args.batch, dim=args.dim,
        n_queries=args.n_queries, capacity=args.capacity or None, fraction=args.fraction,
        merge_method=args.merge_method, device=args.device,
    )
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
