"""Benchmark helpers — part of `diskrag_tpu/benchmark.py`: the seeded
dataset (numpy, byte-identical to the JAX package's), recall@k, an exact
tiled ground-truth oracle in PyTorch, the graph sweeps (`sweep_exact`,
`sweep_pq`, `sweep_iq`), the host tier's (`sweep_host_tier`), the
flat-index sweep (`sweep_flat`, `adaptive_flat_point`), the IVF sweep
(`sweep_ivf`) with their timing helper, and `best_qps_at_recall`. A test,
smoke and measurement tool, not on the search path.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from diskrag_tpu_torch.device import resolve_device


def make_dataset(
    n: int, dim: int, n_queries: int, seed: int = 42, n_clusters: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Seeded clustered dataset + queries (perturbed database points)."""
    rng = np.random.default_rng(seed)
    if n_clusters is None:
        n_clusters = max(16, n // 1000)
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32) * 4.0
    assign = rng.integers(0, n_clusters, size=n)
    pts = centers[assign] + rng.normal(size=(n, dim)).astype(np.float32)
    qi = rng.integers(0, n, size=n_queries)
    queries = pts[qi] + rng.normal(size=(n_queries, dim)).astype(np.float32) * 0.3
    return pts, queries


def recall_at_k(got_ids: np.ndarray, gt_ids: np.ndarray, k: int) -> float:
    return float(
        np.mean(
            [
                len(set(got_ids[i, :k].tolist()) & set(gt_ids[i, :k].tolist())) / k
                for i in range(len(got_ids))
            ]
        )
    )


def ground_truth(
    points: np.ndarray | torch.Tensor,
    queries: np.ndarray | torch.Tensor,
    k: int,
    metric: str = "l2",
    *,
    device: str = "cuda",
) -> np.ndarray:
    """Exact top-k ids [B, k]: f32 distances, one pass over 65,536-row
    tiles with an exact per-tile top-k merged into the running best."""
    from diskrag_tpu_torch.ops.distance import exact_topk_tiled

    dev = resolve_device(device)
    pts = torch.as_tensor(points, dtype=torch.float32, device=dev)
    q = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    _, ids = exact_topk_tiled(q, pts, k, metric, query_block=1024)
    return ids.cpu().numpy()


@dataclasses.dataclass
class SweepPoint:
    search_width: int
    recall: float
    qps: float
    mean_latency_ms: float
    mode: str
    expand_width: int = 1
    # graph sweeps: traversal rounds executed by one pass over the queries
    # (summed over its chunks), and the passes run (warm-up included)
    rounds: int = 0
    passes: int = 0


def _measure(run, repeats: int, device: torch.device, min_seconds: float = 1.5):
    """Warm up, then time whole passes of `run()` on the host clock, each
    window closed by a device synchronize (PyTorch returns before the
    card finishes), growing the repeat count until a window lasts
    `min_seconds`. Returns (seconds per pass, last result, calls of
    `run()` made in all, warm-up included)."""

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = run()
    sync()
    reps = max(repeats, 1)
    calls = 1
    while True:
        t0 = time.perf_counter()
        for _ in range(reps):
            out = run()
        sync()
        total = time.perf_counter() - t0
        calls += reps
        if total >= min_seconds or reps >= 512:
            return total / reps, out, calls
        reps *= min(16, max(2, int(min_seconds / max(total, 1e-3)) + 1))


def _chunked(q: torch.Tensor, pipeline: int) -> list[torch.Tensor]:
    step = -(-q.shape[0] // pipeline)
    return [q[i : i + step] for i in range(0, q.shape[0], step)]


def _graph_sweep(search_chunk, index, queries, gt, *, k, widths, expand_widths, repeats,
                 pipeline, mode, min_seconds) -> list[SweepPoint]:
    """One SweepPoint per (L, E): `search_chunk(chunk, L, E)` -> a
    SearchResult for each of the `pipeline` query chunks, timed by
    `_measure`."""
    q = torch.as_tensor(np.asarray(queries, np.float32), device=index.device)
    chunks = _chunked(q, pipeline)
    points = []
    for w in widths:
        for e in expand_widths:
            dt, out, passes = _measure(lambda: [search_chunk(c, w, e) for c in chunks],
                                       repeats, index.device, min_seconds)
            ids = torch.cat([r.ids for r in out]).cpu().numpy()
            points.append(SweepPoint(w, recall_at_k(ids, gt, k), len(q) / dt,
                                     dt / len(q) * 1e3, mode, e,
                                     rounds=sum(int(r.n_steps) for r in out), passes=passes))
    return points


def sweep_exact(
    index, queries: np.ndarray, gt: np.ndarray, *, k: int,
    widths=(32, 48, 64, 96, 128), expand_widths=(1,), repeats: int = 3,
    pipeline: int = 4, bf16: bool = False, min_seconds: float = 1.5,
) -> list[SweepPoint]:
    """In-memory graph search sweep over (L, expand_width) on the index's
    device. `pipeline` splits the batch into chunks searched one after the
    other; `bf16` uses the compressed-traversal + f32-rerank path."""
    from diskrag_tpu_torch.graph.search import beam_search, beam_search_reranked

    tv = index.vectors.to(torch.bfloat16) if bf16 else None

    def search_chunk(c, w, e):
        kw = dict(search_width=w, k=k, metric=index.metric, expand_width=e,
                  entry_points=index.entry_points)
        if bf16:
            return beam_search_reranked(tv, index.vectors, index.adjacency, index.medoid,
                                        c, **kw)
        return beam_search(index.vectors, index.adjacency, index.medoid, c, **kw)

    return _graph_sweep(search_chunk, index, queries, gt, k=k, widths=widths,
                        expand_widths=expand_widths, repeats=repeats, pipeline=pipeline,
                        mode="exact-bf16" if bf16 else "exact", min_seconds=min_seconds)


def sweep_pq(
    index, pq, codes, queries: np.ndarray, gt: np.ndarray, *,
    k: int, widths=(32, 48, 64, 96, 128), expand_widths=(1,),
    repeats: int = 3, pipeline: int = 4, coarse_ids=None,
    mode_label: str | None = None, min_seconds: float = 1.5,
) -> list[SweepPoint]:
    """PQ-traversal + exact-rerank sweep (the "pq_accelerated" mode). Pass
    a ResidualPQ plus its `coarse_ids` to sweep the residual serving
    decomposition."""
    from diskrag_tpu_torch.graph.search import beam_search_pq

    dev = index.device
    codes_t = torch.as_tensor(codes, device=dev)
    residual = coarse_ids is not None
    if residual:
        cells = torch.as_tensor(coarse_ids, device=dev).to(torch.int32)
        bias = pq.point_bias(codes_t, cells)
        mode = mode_label or f"rpq{int(pq.n_subvectors)}+rerank"
    else:
        mode = mode_label or "pq+rerank"

    def search_chunk(c, w, e):
        if residual:
            tables = pq.inner_tables(c)
            aux = {"point_cell": cells, "point_bias": bias, "cell_tables": pq.cell_tables(c)}
        else:
            tables, aux = pq.compute_distance_tables(c), {}
        return beam_search_pq(
            codes_t, tables, index.adjacency, index.medoid, search_width=w, k=k,
            rerank=True, vectors=index.vectors, queries=c, metric=index.metric,
            expand_width=e, entry_points=index.entry_points, **aux,
        )

    return _graph_sweep(search_chunk, index, queries, gt, k=k, widths=widths,
                        expand_widths=expand_widths, repeats=repeats, pipeline=pipeline,
                        mode=mode, min_seconds=min_seconds)


def sweep_iq(
    index, iq, rows: np.ndarray, queries: np.ndarray, gt: np.ndarray, *,
    k: int, widths=(16, 24), expand_widths=(8,), repeats: int = 3,
    pipeline: int = 4, min_seconds: float = 1.5,
) -> list[SweepPoint]:
    """Int-quantized traversal + exact-rerank sweep (`pq/intq.py`,
    `beam_search_iq`): int8 / int4 rows guide the beam, the rerank of beam
    ∪ visited restores recall. The query tables are built inside the timed
    pass, as `sweep_pq` builds its own."""
    from diskrag_tpu_torch.graph.search import beam_search_iq

    rows_t = torch.as_tensor(np.asarray(rows, np.int8), device=index.device)
    label = f"iq{iq.bits}" + (f"c{iq.n_cells}" if iq.n_cells else "")

    def search_chunk(c, w, e):
        return beam_search_iq(
            rows_t, iq.query_tables(c), index.adjacency, index.medoid,
            dim=iq.dim, bits=iq.bits, n_cells=iq.n_cells, search_width=w, k=k,
            rerank=True, vectors=index.vectors, queries=c, metric=index.metric,
            expand_width=e, entry_points=index.entry_points,
        )

    return _graph_sweep(search_chunk, index, queries, gt, k=k, widths=widths,
                        expand_widths=expand_widths, repeats=repeats, pipeline=pipeline,
                        mode=label, min_seconds=min_seconds)


def sweep_host_tier(
    index_dir, queries: np.ndarray, gt: np.ndarray, *, k: int,
    widths=(32, 48, 64), expand_widths=(4,), repeats: int = 3, device: str = "cuda",
) -> list[SweepPoint]:
    """Host-offload tier sweep (the analog of the reference's disk-mode
    beam sweep): the compressed traversal form and the graph on the
    device, the full vectors fetched from the host record file for the
    rerank. `HostTierIndex.search` on the whole batch, after one warm-up
    pass at the batch's shape; `rounds` are one pass's."""
    from diskrag_tpu_torch.index.host_tier import HostTierIndex

    ht = HostTierIndex.from_store(index_dir, device=device)
    points = []
    for w in widths:
        for e in expand_widths:
            ht.search(queries, search_width=w, k=k, expand_width=e)
            t0 = time.perf_counter()
            for _ in range(repeats):
                _, ids, stats = ht.search(queries, search_width=w, k=k, expand_width=e)
            dt = (time.perf_counter() - t0) / repeats
            points.append(SweepPoint(w, recall_at_k(ids, gt, k), len(queries) / dt,
                                     dt / len(queries) * 1e3, "host-tier", e,
                                     rounds=stats["rounds"], passes=repeats + 1))
    return points


def _point(idx, q, gt, k, mode, repeats, min_seconds, width=0) -> SweepPoint:
    """Time `idx.search(q)` and take its recall against `gt`."""
    b = q.shape[0]
    dt, (_, ids), _ = _measure(lambda: idx.search(q, k=k), repeats, idx.device, min_seconds)
    rec = recall_at_k(ids.cpu().numpy(), gt, k)
    return SweepPoint(width, rec, b / dt, dt / b * 1e3, mode)


def sweep_flat(
    pts: np.ndarray, queries: np.ndarray, gt: np.ndarray, *, k: int,
    metric: str = "l2", repeats: int = 3, adaptive_target: float = 0.96,
    big_batch: int = 0, min_seconds: float = 1.5, device: str = "cuda",
) -> list[SweepPoint]:
    """Exhaustive-scan sweep (the JAX package's `sweep_flat`): the default
    per-row int8 scan ("flat") and, where the index is fused, its
    narrow-rerank point ("flat-rr24"), for l2 and cosine the packed scan
    at the default width ("flat-packed") and at 24 ("flat-packed-rr24"),
    and the recall-targeted adaptive width point. Variants of one
    precision share one index: only `rerank_width` changes.

    `big_batch` > 0 adds, for l2 and cosine, a packed point at that batch
    size, "flat-packed-b{big_batch}", at rerank width 20: the protocol
    queries tiled to `big_batch` rows and searched as one batch (its
    query scale is taken over all of them), QPS over `big_batch` queries,
    recall over the leading `len(queries)` rows."""
    from diskrag_tpu_torch.ops.flat import FlatIndex

    idx = FlatIndex(pts, metric=metric, device=device)
    q = torch.as_tensor(np.asarray(queries, np.float32), device=idx.device)
    points = [_point(idx, q, gt, k, "flat", repeats, min_seconds)]
    if not idx.use_fused:
        return points
    variants = [("flat-rr24", "int8", 24)]
    if metric != "dot":
        variants += [("flat-packed", "int8_packed", None),
                     ("flat-packed-rr24", "int8_packed", 24)]
    indexes = {"int8": idx}
    for mode, prec, rw in variants:
        if prec not in indexes:
            indexes[prec] = FlatIndex(pts, metric=metric, fused_precision=prec, device=device)
        indexes[prec].rerank_width = rw
        points.append(_point(indexes[prec], q, gt, k, mode, repeats, min_seconds))
    if big_batch and metric != "dot":
        packed = indexes["int8_packed"]
        packed.rerank_width = 20
        qb = q[torch.as_tensor(np.arange(big_batch) % len(queries), device=idx.device)]
        dt, (_, ids), _ = _measure(lambda: packed.search(qb, k=k), repeats, idx.device,
                                   min_seconds)
        rec = recall_at_k(ids[: len(queries)].cpu().numpy(), gt, k)
        points.append(SweepPoint(0, rec, big_batch / dt, dt / big_batch * 1e3,
                                 f"flat-packed-b{big_batch}"))
    idx.rerank_width = None
    if metric != "dot":
        p = adaptive_flat_point(
            pts, queries, gt, k=k, metric=metric, target_recall=adaptive_target,
            repeats=repeats, idx=indexes["int8_packed"], min_seconds=min_seconds,
            device=device,
        )
        if p is not None:
            points.append(p)
    return points


def adaptive_flat_point(
    pts: np.ndarray, queries: np.ndarray, gt: np.ndarray, *, k: int,
    metric: str = "l2", target_recall: float = 0.96, max_width: int = 48,
    repeats: int = 3, idx=None, min_seconds: float = 1.5, device: str = "cuda",
) -> SweepPoint | None:
    """Recall-targeted rerank width for the packed flat scan: binary-search
    the narrowest `rerank_width` whose recall@k on the first half of the
    queries clears `target_recall` (recall is monotone in the width), then
    measure QPS at that width on all queries. None when even `max_width`
    misses the target, or when `idx` is not fused. `idx` shares an
    already-built packed index."""
    from diskrag_tpu_torch.ops.flat import FlatIndex

    if idx is None:
        idx = FlatIndex(pts, metric=metric, fused_precision="int8_packed", device=device)
    if not idx.use_fused:
        return None
    q = torch.as_tensor(np.asarray(queries, np.float32), device=idx.device)
    n_sel = max(1, q.shape[0] // 2)

    def recall_at_width(rw: int) -> float:
        idx.rerank_width = rw
        _, ids = idx.search(q[:n_sel], k=k)
        return recall_at_k(ids.cpu().numpy(), gt[:n_sel], k)

    lo, hi = k, max_width
    if recall_at_width(hi) < target_recall:
        return None
    while lo < hi:
        mid = (lo + hi) // 2
        if recall_at_width(mid) >= target_recall:
            hi = mid
        else:
            lo = mid + 1
    idx.rerank_width = hi
    return _point(idx, q, gt, k, f"flat-packed-rr{hi}-auto", repeats, min_seconds, width=hi)


def sweep_ivf(
    pts: np.ndarray, queries: np.ndarray, gt: np.ndarray, *, k: int,
    metric: str = "l2", n_probes=(8, 16, 32, 64), n_cells: int | None = None,
    repeats: int = 3, min_seconds: float = 1.5, tile_precision: str = "int8",
    device: str = "cuda",
) -> tuple[list[SweepPoint], tuple[float, float]]:
    """The IVF-Flat index swept over n_probe (the JAX package's
    `sweep_ivf`; probes above the cell count are skipped). Returns
    (points, (build_cold_s, build_warm_s)): two builds of the same index,
    each closed by a device synchronize; the first also pays the data's
    upload and the first calls of every operation, the second is the
    steady-state build. `width` of a point is its n_probe."""
    from diskrag_tpu_torch.index.ivf import build_ivf

    dev = resolve_device(device)

    def build():
        t0 = time.perf_counter()
        idx = build_ivf(pts, n_cells, metric=metric, tile_precision=tile_precision, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return idx, time.perf_counter() - t0

    _, build_cold_s = build()
    idx, build_s = build()
    q = torch.as_tensor(np.asarray(queries, np.float32), device=dev)
    points = []
    for p in n_probes:
        if p > idx.n_cells:
            continue
        dt, (_, ids), _ = _measure(lambda p=p: idx.search(q, k=k, n_probe=p), repeats, dev,
                                   min_seconds)
        points.append(SweepPoint(p, recall_at_k(ids.cpu().numpy(), gt, k), len(queries) / dt,
                                 dt / len(queries) * 1e3, f"ivf-{tile_precision}"))
    return points, (build_cold_s, build_s)


def best_qps_at_recall(points: list[SweepPoint], min_recall: float) -> SweepPoint | None:
    """The fastest sweep point whose recall reaches `min_recall`, or None."""
    ok = [p for p in points if p.recall >= min_recall]
    return max(ok, key=lambda p: p.qps) if ok else None
