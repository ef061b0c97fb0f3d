"""kNN-graph-based Vamana construction (counterpart of
`diskrag_tpu/graph/knn_build.py`): no sequential insertion, three
data-parallel passes.

  1. near-exact kNN: top-C neighbors of every point through the fused
     per-row int8 scan (kernel B1), the candidate cut (B4) and an f32
     rerank (`ops/flat_scan.py`); or, above 2M points, approximate kNN by
     an IVF probe (`approx_knn_ivf`, `index/ivf.py`: no kernel), with
     checkpoint and resume (`graph/checkpoint.py`);
  2. alpha-prune: vectorized RobustPrune of each point's candidate list
     (top-C plus a few seeded random long-range candidates, which keep
     the graph connected across clusters);
  3. reverse edges: group all chosen edges by target (one global sort),
     keep the nearest `max_incoming` per target, then per node
     union-or-reprune.

A graph built here draws its random numbers from a `torch.Generator`,
not from the JAX package's keys, so it is another graph of the same
quality; every deterministic stage (`_prune_block`, `_incoming_tables`,
`_merge_block`) returns the JAX package's ids on carried-over inputs.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from diskrag_tpu_torch.device import resolve_device
from diskrag_tpu_torch.graph.prune import robust_prune_batch
from diskrag_tpu_torch.graph.search import _gathered_distance
from diskrag_tpu_torch.graph.types import VamanaIndex
from diskrag_tpu_torch.ops.distance import Metric
from diskrag_tpu_torch.ops.medoid import approximate_medoid
from diskrag_tpu_torch.ops.topk import INF, INVALID_ID, mask_duplicates, sort_topk_unique, topk_smallest

logger = logging.getLogger(__name__)

# Device-residency ceiling for the [N, knn_k] candidate tables during the
# alpha-prune phase; larger tables stay on the host and each prune block's
# rows are sliced and uploaded on demand (the same rows cross the link
# either way). 16 GB: a fifth of an 80 GB card, which leaves room for the
# f32 vectors (N * D * 4), the int8 scan table and the two [N, R]
# accumulators of a build whose tables are that large. Tests set it to 0
# to force the host path.
_HOST_KNN_BYTES = 16 << 30

# Past this many edges (N * R) the edge distances are stored as bf16 and
# the reverse-edge grouping runs on the host: the device sort of N * R
# (target, dist, source) triples holds about ten [N * R] 4- to 8-byte
# arrays at once, 40 GB at 750M edges, half the card.
_HUGE_EDGES = 750 << 20

# bucket count of the kNN scan: expected tail loss of the bucketed fold is
# (k - 1) / (2 * NB), under 1% at the build's k of about 66
_KNN_BUCKETS = 4096


def exact_knn(
    vectors: torch.Tensor,
    k: int,
    *,
    metric: str = Metric.L2.value,
    query_block: int = 8192,
    rerank_mult: int = 2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Near-exact top-k neighbors of every database point (self excluded):
    per block of `query_block` points one fused int8 scan of the whole
    database (B1 at NB = 4096), the cut to max(rerank_mult, 4) * (k + 1)
    candidates (B4) and their f32 rerank. The scan table is built once.
    Occasional tail-candidate misses do not matter to graph quality: the
    recall gate is on the final index.
    Returns (ids int32[N, k], dists float32[N, k]) ascending."""
    from diskrag_tpu_torch.ops.flat_scan import align_code_rows, build_rowscan_table, flat_search_fused

    n = vectors.shape[0]
    k = min(k, n - 1)
    if Metric(metric) == Metric.COSINE:
        norms = torch.sum(vectors * vectors, dim=-1)
        scan_src = vectors * torch.rsqrt(norms + 1e-12)[:, None]
    else:
        scan_src = vectors
    vec_scan, scan_block, scan_scales, scan_n = build_rowscan_table(scan_src, metric=metric)
    vec_scan = align_code_rows(vec_scan)
    del scan_src
    ids_out, dists_out = [], []
    for i in range(0, n, query_block):
        q = vectors[i : i + query_block]
        d, ids = flat_search_fused(
            q, vec_scan, scan_block, vectors, k=k + 1, metric=metric,
            rerank_mult=max(rerank_mult, 4), n_buckets=_KNN_BUCKETS,
            db_scales=scan_scales, n_valid=scan_n,
        )
        gid = torch.arange(i, i + q.shape[0], device=vectors.device)[:, None]
        d = torch.where(ids == gid, INF, d)
        top_d, take = topk_smallest(d, k)
        ids_out.append(torch.gather(ids, 1, take).to(torch.int32))
        dists_out.append(top_d)
    return torch.cat(ids_out), torch.cat(dists_out)


def approx_knn_ivf(
    vectors: torch.Tensor,
    k: int,
    *,
    metric: str = Metric.L2.value,
    n_probe: int = 8,
    query_block: int = 8192,
    seed: int = 0,
    cap_factor: float = 2.0,
    n_cells: int | None = None,
    checkpoint=None,
    checkpoint_every_s: float = 600.0,
    host_vectors: np.ndarray | None = None,
    stage_seconds: dict | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Approximate top-k neighbors of every point (self excluded) by an
    IVF probe of its `n_probe` nearest cells: O(N * probed cells) instead
    of O(N^2), the backend for builds past a couple of million points.
    Table misses are not benign: a true neighbor placed outside the
    probed cells is absent from every point's candidate pool, so the
    graph inherits the tables' recall ceiling; `cap_factor` sets it (see
    `index.ivf.build_ivf`).

    The IVF is built once over `vectors` (a device tensor), which serves
    as its rerank master: no second device copy. `host_vectors` is a host
    copy when the caller holds one (the build's placement runs on the
    host). Results accumulate on the host, block by block. With
    `checkpoint` (a `BuildCheckpoint`) they are written to
    `knn_partial.npz` every `checkpoint_every_s` seconds with a resume
    cursor; a restarted build rebuilds the (seeded, deterministic) IVF and
    continues from the cursor. The partial is left for the caller to
    clear once it has saved the completed tables. `stage_seconds`
    receives the IVF build's stages. Returns (ids int32 [N, k], dists f32
    [N, k]) as numpy arrays, ascending."""
    from diskrag_tpu_torch.graph.checkpoint import pack_bf16, unpack_bf16
    from diskrag_tpu_torch.index.ivf import build_ivf

    n = vectors.shape[0]
    k = min(k, n - 1)
    start = 0
    ids_out, dists_out = [], []
    if checkpoint is not None:
        part = checkpoint.load("knn_partial")
        if part is not None and int(part["k"]) == k:
            start = int(part["next_i"])
            if start > 0:
                ids_out = [part["ids"]]
                dists_out = [unpack_bf16(part["dists"])]
            logger.info("resuming kNN pass at row %d/%d from checkpoint", start, n)

    if host_vectors is None:
        host_vectors = vectors.cpu().numpy()
    ivf = build_ivf(
        host_vectors, n_cells, metric=metric, seed=seed, cap_factor=cap_factor,
        rerank_master=vectors, stage_seconds=stage_seconds,
    )

    def save_partial(next_i: int) -> None:
        checkpoint.save(
            "knn_partial",
            ids=np.concatenate(ids_out) if ids_out else np.zeros((0, k), np.int32),
            dists=pack_bf16(
                np.concatenate(dists_out) if dists_out else np.zeros((0, k), np.float32)
            ),
            next_i=np.int64(next_i),
            k=np.int64(k),
        )

    last_save = time.perf_counter()
    for i in range(start, n, query_block):
        q = vectors[i : i + query_block]
        d, ids = ivf.search(q, k=k + 1, n_probe=n_probe)
        gid = torch.arange(i, i + q.shape[0], device=vectors.device)[:, None]
        d = torch.where(ids == gid, INF, d)
        top_d, take = topk_smallest(d, k)
        ids_out.append(torch.gather(ids, 1, take).to(torch.int32).cpu().numpy())
        dists_out.append(top_d.cpu().numpy())
        if checkpoint is not None and time.perf_counter() - last_save >= checkpoint_every_s:
            # consolidate, so the partial holds one array per table
            ids_out = [np.concatenate(ids_out)]
            dists_out = [np.concatenate(dists_out)]
            save_partial(i + query_block)
            last_save = time.perf_counter()
    del ivf
    return np.concatenate(ids_out), np.concatenate(dists_out)


def _prune_block(
    vectors: torch.Tensor,
    block_ids: torch.Tensor,
    knn_ids_full: torch.Tensor,
    knn_dists_full: torch.Tensor,
    rand_ids_full: torch.Tensor,
    alpha: float | torch.Tensor,
    *,
    degree_bound: int,
    metric: str,
    pre_sliced: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Alpha-prune one block of points' candidate pools: exact kNN (ids +
    dists precomputed) ++ random long-range candidates (distances computed
    here). Returns (out_ids [W, R], out_dists [W, R]); out_dists of -1
    slots are +inf.

    `pre_sliced`: the kNN tables are already this block's rows [W, k]
    (host-resident tables) instead of the full [N, k] device tables."""
    n = vectors.shape[0]
    rows = block_ids.long()
    if pre_sliced:
        knn_ids = knn_ids_full
        knn_dists = knn_dists_full.to(torch.float32)
    else:
        knn_ids = knn_ids_full[rows]
        knn_dists = knn_dists_full[rows].to(torch.float32)
    rand_ids = rand_ids_full[rows]
    queries = vectors[rows]
    rand_vecs = vectors[torch.clamp(rand_ids, 0, n - 1).long()]
    rand_dists = _gathered_distance(queries, rand_vecs, metric)
    cand_ids = torch.cat([knn_ids, rand_ids], dim=1)
    cand_dists = torch.cat([knn_dists, rand_dists], dim=1)
    cand_vecs = torch.cat([vectors[torch.clamp(knn_ids, 0, n - 1).long()], rand_vecs], dim=1)
    out_ids = robust_prune_batch(
        block_ids, cand_ids, cand_vecs, cand_dists, alpha,
        degree_bound=degree_bound, metric=metric,
    )
    # each kept edge's distance by compare-lookup against the pool
    # (duplicate pool ids share one masked-min distance)
    eq = out_ids[:, :, None] == cand_ids[:, None, :]  # [W, R, C]
    out_dists = torch.amin(torch.where(eq, cand_dists[:, None, :], INF), dim=2)
    out_dists = torch.where(out_ids == INVALID_ID, INF, out_dists)
    return out_ids, out_dists


def _incoming_tables_host(
    out_ids: torch.Tensor, out_dists: torch.Tensor, *, max_incoming: int, n: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Host-numpy version of `_incoming_tables` for edge counts whose
    device sort workspace would crowd the card (see `_HUGE_EDGES`). The
    tables come back on the edges' device as int32 ids + bf16 dists."""
    dev = out_ids.device
    r = out_ids.shape[1]
    t = out_ids.cpu().numpy().reshape(-1)
    d = out_dists.to(torch.float32).cpu().numpy().reshape(-1)
    s = np.repeat(np.arange(n, dtype=np.int32), r)
    tk = np.where(t == INVALID_ID, n, t)
    order = np.lexsort((d, tk))
    t_s, s_s, d_s = tk[order], s[order], d[order]
    node_ids = np.arange(n)
    start = np.searchsorted(t_s, node_ids, side="left")
    end = np.searchsorted(t_s, node_ids, side="right")
    pos = start[:, None] + np.arange(max_incoming)[None, :]
    ok = pos < end[:, None]
    pos = np.clip(pos, 0, n * r - 1)
    inc_ids = np.where(ok, s_s[pos], INVALID_ID).astype(np.int32)
    inc_dists = np.where(ok, d_s[pos], np.inf).astype(np.float32)
    return (
        torch.as_tensor(inc_ids, device=dev),
        torch.as_tensor(inc_dists, device=dev).to(torch.bfloat16),
    )


def _incoming_tables(
    out_ids: torch.Tensor, out_dists: torch.Tensor, *, max_incoming: int, n: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Group edges by target; keep the `max_incoming` nearest sources per
    target. One global sort by (target, dist) — a stable sort by dist and
    then a stable sort by target, so equal (target, dist) pairs keep
    source order, as `lexsort` — then each target's run is located with a
    binary search and sliced.

    Returns (inc_ids int32[N, max_incoming], inc_dists float32[N, ...])."""
    r = out_ids.shape[1]
    dev = out_ids.device
    targets = out_ids.reshape(-1).long()
    dists = out_dists.to(torch.float32).reshape(-1)
    sources = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(r)
    tkey = torch.where(targets == INVALID_ID, n, targets)
    by_dist = torch.sort(dists, stable=True).indices
    order = by_dist[torch.sort(tkey[by_dist], stable=True).indices]
    t_s, s_s, d_s = tkey[order], sources[order], dists[order]
    node_ids = torch.arange(n, device=dev)
    start = torch.searchsorted(t_s, node_ids, right=False)
    end = torch.searchsorted(t_s, node_ids, right=True)
    pos = start[:, None] + torch.arange(max_incoming, device=dev)[None, :]
    ok = pos < end[:, None]
    pos = torch.clamp(pos, 0, n * r - 1)
    return torch.where(ok, s_s[pos], INVALID_ID), torch.where(ok, d_s[pos], INF)


def _merge_block(
    vectors: torch.Tensor,
    block_ids: torch.Tensor,
    out_ids_full: torch.Tensor,
    out_dists_full: torch.Tensor,
    inc_ids_full: torch.Tensor,
    inc_dists_full: torch.Tensor,
    alpha: float | torch.Tensor,
    *,
    degree_bound: int,
    metric: str,
) -> torch.Tensor:
    """Union out-edges with incoming reverse edges; RobustPrune only the
    rows that overflow the degree bound (add-then-prune-on-overflow)."""
    n = vectors.shape[0]
    r = degree_bound
    rows = block_ids.long()
    out_ids = out_ids_full[rows]
    out_dists = out_dists_full[rows].to(torch.float32)  # bf16 on huge builds
    inc_ids = inc_ids_full[rows]
    inc_dists = inc_dists_full[rows].to(torch.float32)
    cand_ids = torch.cat([out_ids, inc_ids], dim=1)
    cand_dists = torch.cat([out_dists, inc_dists], dim=1)
    masked = mask_duplicates(cand_ids, cand_dists)
    n_unique = torch.sum(torch.isfinite(masked), dim=1)
    union_ids, _, _ = sort_topk_unique(cand_ids, cand_dists, r)
    cand_vecs = vectors[torch.clamp(cand_ids, 0, n - 1).long()]
    pruned = robust_prune_batch(
        block_ids, cand_ids, cand_vecs, cand_dists, alpha, degree_bound=r, metric=metric,
    )
    return torch.where((n_unique > r)[:, None], pruned, union_ids)


def _ivf_knn_tables(vectors, host_vectors, *, knn_k, knn_probe, metric, seed, query_block,
                    checkpoint_dir, checkpoint_every_s, stage_seconds):
    """The ivf backend's kNN tables as host tensors (ids int32, dists
    bf16), from `checkpoint_dir`'s completed "knn" phase when its tag
    matches, else from `approx_knn_ivf` (then saved, and the partial
    cleared only after the save landed, so a crash between loses
    nothing). The distances are rounded to bf16, the JAX package's table
    precision, whether or not a checkpoint is kept."""
    from diskrag_tpu_torch.graph.checkpoint import BuildCheckpoint, dataset_fingerprint, pack_bf16

    n = vectors.shape[0]
    # the cap factor sets the tables' recall ceiling (see build_ivf): 3.0
    # up to 8M points, 2.5 above, as the JAX package chose
    cap_factor = 3.0 if n <= 8_000_000 else 2.5
    ckpt = None
    if checkpoint_dir is not None:
        ckpt = BuildCheckpoint(checkpoint_dir, tag={
            "phase_inputs": "ivf-knn",
            "n": n, "dim": int(vectors.shape[1]),
            "knn_k": knn_k, "knn_probe": knn_probe,
            "metric": metric, "seed": seed,
            "query_block": query_block,
            "cap_factor": cap_factor,  # a cap change must invalidate old checkpoints
            "data": dataset_fingerprint(vectors if host_vectors is None else host_vectors),
        })
    done = ckpt.load("knn") if ckpt is not None else None
    if done is not None:
        logger.info("kNN tables loaded from checkpoint %s", checkpoint_dir)
        ids_np, dists16 = done["ids"], done["dists"]
    else:
        ivf_stages: dict = {}
        ids_np, dists_np = approx_knn_ivf(
            vectors, knn_k, metric=metric, query_block=query_block, seed=seed,
            n_probe=knn_probe, cap_factor=cap_factor, checkpoint=ckpt,
            checkpoint_every_s=checkpoint_every_s, host_vectors=host_vectors,
            stage_seconds=ivf_stages,
        )
        if stage_seconds is not None:
            stage_seconds["knn_ivf_build"] = ivf_stages
        dists16 = pack_bf16(dists_np)
        del dists_np
        if ckpt is not None:
            ckpt.save("knn", ids=ids_np, dists=dists16)
            ckpt.clear("knn_partial")
    ids = torch.from_numpy(np.ascontiguousarray(ids_np, np.int32))
    dists = torch.from_numpy(np.ascontiguousarray(dists16).view(np.int16)).view(torch.bfloat16)
    return ids, dists


def compute_entry_points(
    vectors: torch.Tensor,
    n_entry: int,
    generator: torch.Generator,
    *,
    metric: str = Metric.L2.value,
    sample_cap: int = 65_536,
    max_iter: int = 8,
) -> np.ndarray:
    """Well-spread search seeds: k-means cell centres on a subsample,
    snapped to their nearest database points; from 20,000 seeds up a plain
    random sample (it covers the data's clusters as well, and k-means over
    the sample that many centres need would take minutes). Returned unique
    and sorted, so the search loop needs no O(S^2) dedup. `generator`
    lives on the vectors' device."""
    from diskrag_tpu_torch.ops.flat import flat_search
    from diskrag_tpu_torch.pq.kmeans import kmeans_fit

    n = vectors.shape[0]
    dev = vectors.device
    n_entry = min(n_entry, n)
    if n_entry >= 20_000:
        ids = torch.randperm(n, generator=generator, device=dev)[:n_entry]
        return np.unique(ids.cpu().numpy()).astype(np.int32)
    # k-means needs enough samples per centre to place them well
    sample_cap = max(sample_cap, 16 * n_entry)
    if n > sample_cap:
        sample = vectors[torch.randperm(n, generator=generator, device=dev)[:sample_cap]]
    else:
        sample = vectors
    centers, _ = kmeans_fit(generator, sample[None], n_entry, max_iter=max_iter, init="d2")
    norms = torch.sum(vectors * vectors, dim=-1)
    _, ids = flat_search(
        centers[0], vectors.to(torch.bfloat16), norms, vectors, k=1, metric=metric,
    )
    return np.unique(ids[:, 0].cpu().numpy()).astype(np.int32)


def random_long_range_ids(n: int, n_random: int, generator: torch.Generator,
                          device: torch.device) -> torch.Tensor:
    """int32 [N, n_random] random candidates, never the row's own id:
    (row + 1 + u) mod N with u uniform in [0, N - 1)."""
    if n_random <= 0:
        return torch.zeros((n, 0), dtype=torch.int32, device=device)
    u = torch.randint(0, max(n - 1, 1), (n, n_random), generator=generator, device=device)
    rows = torch.arange(n, device=device)[:, None]
    return ((rows + 1 + u) % n).to(torch.int32)


def build_vamana_knn(
    vectors,
    *,
    degree_bound: int = 32,
    alpha: float = 1.2,
    metric: str = Metric.L2.value,
    knn_k: int | None = None,
    n_random: int = 8,
    max_incoming: int | None = None,
    query_block: int = 4096,
    wave_size: int = 2048,
    n_entry_points: int | None = None,
    knn_backend: str = "auto",
    knn_probe: int = 8,
    seed: int = 0,
    progress: bool = False,
    checkpoint_dir: str | None = None,
    checkpoint_every_s: float = 600.0,
    device: str | torch.device = "cuda",
    stage_seconds: dict | None = None,
) -> VamanaIndex:
    """Build a Vamana-quality graph from near-exact kNN lists (see the
    module docstring).

    `degree_bound` is R; `knn_k` the kNN candidate count (default
    max(64, 4R/3)); `n_random` seeded long-range candidates per point keep
    the graph connected across clusters; `n_entry_points` well-spread
    search seeds (default min(65536, N/64)) are stored on the index:
    searches seed from them plus the medoid. `knn_backend`: "flat" (the
    fused scans over the whole database), "ivf" (`approx_knn_ivf`, probing
    `knn_probe` cells a point; cap factor 3.0 up to 8M points, 2.5 above)
    or "auto" (flat up to 2M points, ivf above).

    `checkpoint_dir` enables checkpoint and resume of the ivf kNN pass
    (the dominant phase of multi-million-point builds): its partial
    accumulation every `checkpoint_every_s` seconds, then the completed
    tables, tagged with the build's parameters and a dataset fingerprint
    so a changed build never resumes stale state; the JAX package writes
    and reads the same files. The flat backend ignores it. `stage_seconds`,
    when given, receives the seconds spent per stage (entry_points, knn,
    prune, reverse, merge; with ivf also `knn_ivf_build`, the IVF's own
    stages), each closed by a device synchronisation; on a CUDA device also
    `peak_device_bytes`, each stage's peak of allocated device bytes (the
    allocator's peak statistic is reset at every stage's start, so a
    caller's own reading after the build covers the last stage only)."""
    dev = resolve_device(device)
    host_vectors = None
    if isinstance(vectors, torch.Tensor):
        vectors = vectors.to(device=dev, dtype=torch.float32)
    else:
        host_vectors = np.asarray(vectors, np.float32)
        vectors = torch.as_tensor(host_vectors, device=dev)
    n = vectors.shape[0]
    if n < 2:
        raise ValueError("need at least 2 points")
    degree_bound = min(degree_bound, n - 1)
    if knn_k is None:
        knn_k = max(64, (4 * degree_bound) // 3)
    knn_k = min(knn_k, n - 1)
    n_random = min(n_random, max(n - 1 - knn_k, 0))
    if max_incoming is None:
        max_incoming = max(degree_bound // 2, 8)
    wave_size = min(wave_size, n)
    metric = Metric(metric).value
    if n_entry_points is None:
        n_entry_points = min(65_536, max(n // 64, 0))
    if knn_backend == "auto":
        knn_backend = "flat" if n <= 2_000_000 else "ivf"
    if knn_backend not in ("flat", "ivf"):
        raise ValueError(f"unknown knn_backend: {knn_backend}")

    # on the card, the peak device bytes of each stage, beside its seconds:
    # the allocator's peak is reset at every stage's start
    peaks = stage_seconds is not None and dev.type == "cuda"
    if peaks:
        stage_seconds["peak_device_bytes"] = {}

    def lap(stage: str, t_start: float) -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        if stage_seconds is not None:
            stage_seconds[stage] = now - t_start
        if peaks:
            stage_seconds["peak_device_bytes"][stage] = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        if progress:
            logger.info("%s done (%.1fs)", stage, now - t0)
        return now

    if peaks:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = t = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    medoid = approximate_medoid(
        vectors, torch.Generator().manual_seed(int(seed)), metric=metric
    ).to(torch.int32)
    entry_points = None
    if n_entry_points > 1:
        eps = compute_entry_points(vectors, n_entry_points, gen, metric=metric)
        eps = eps[eps != int(medoid)]
        if eps.size > 1:
            entry_points = torch.as_tensor(eps, dtype=torch.int32, device=dev)
    t = lap("entry_points", t)

    if knn_backend == "ivf":
        knn_ids, knn_dists = _ivf_knn_tables(
            vectors, host_vectors, knn_k=knn_k, knn_probe=knn_probe, metric=metric,
            seed=seed, query_block=query_block, checkpoint_dir=checkpoint_dir,
            checkpoint_every_s=checkpoint_every_s, stage_seconds=stage_seconds,
        )
    else:
        knn_ids, knn_dists = exact_knn(vectors, knn_k, metric=metric, query_block=query_block)
    host_knn = (
        knn_ids.numel() * knn_ids.element_size()
        + knn_dists.numel() * knn_dists.element_size()
    ) > _HOST_KNN_BYTES
    if host_knn:
        knn_ids, knn_dists = knn_ids.cpu(), knn_dists.cpu()
        logger.info("kNN tables stay host-resident; prune blocks slice on demand")
    else:
        knn_ids, knn_dists = knn_ids.to(dev), knn_dists.to(dev)
    t = lap("knn", t)

    rand_ids = random_long_range_ids(n, n_random, gen, dev)

    ids_all = torch.arange(n, dtype=torch.int32, device=dev)
    pad = (-n) % wave_size
    if pad:
        ids_all = torch.cat([ids_all, ids_all[:pad]])
    blocks = ids_all.reshape(-1, wave_size)

    huge = n * degree_bound > _HUGE_EDGES
    dist_dtype = torch.bfloat16 if huge else torch.float32
    # the accumulators are allocated once and written in place, block by
    # block (a padded tail block rewrites its first rows with equal values)
    out_ids = torch.zeros((n, degree_bound), dtype=torch.int32, device=dev)
    out_dists = torch.zeros((n, degree_bound), dtype=dist_dtype, device=dev)
    for blk in blocks:
        if host_knn:
            rows = blk.cpu().long()
            o_ids, o_dists = _prune_block(
                vectors, blk, knn_ids[rows].to(dev), knn_dists[rows].to(dev),
                rand_ids, alpha, degree_bound=degree_bound, metric=metric, pre_sliced=True,
            )
        else:
            o_ids, o_dists = _prune_block(
                vectors, blk, knn_ids, knn_dists, rand_ids, alpha,
                degree_bound=degree_bound, metric=metric,
            )
        out_ids.index_copy_(0, blk.long(), o_ids.to(torch.int32))
        out_dists.index_copy_(0, blk.long(), o_dists.to(dist_dtype))
    del knn_ids, knn_dists, rand_ids
    t = lap("prune", t)

    inc_fn = _incoming_tables_host if huge else _incoming_tables
    inc_ids, inc_dists = inc_fn(out_ids, out_dists, max_incoming=max_incoming, n=n)
    t = lap("reverse", t)

    adjacency = torch.zeros((n, degree_bound), dtype=torch.int32, device=dev)
    for blk in blocks:
        rows = _merge_block(
            vectors, blk, out_ids, out_dists, inc_ids, inc_dists, alpha,
            degree_bound=degree_bound, metric=metric,
        )
        adjacency.index_copy_(0, blk.long(), rows.to(torch.int32))
    t = lap("merge", t)
    if progress:
        logger.info("knn build done in %.1fs", t - t0)
    return VamanaIndex(
        vectors=vectors, adjacency=adjacency, medoid=medoid, metric=metric,
        entry_points=entry_points,
    )
