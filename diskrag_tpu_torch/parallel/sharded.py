"""Sharded Vamana index: partitioned sub-indexes and a merged top-k
(counterpart of `diskrag_tpu/parallel/sharded.py`).

  - the vectors are partitioned by one seeded permutation into S shards;
    each shard gets its own Vamana graph (local ids) and a local -> global
    id map;
  - a search runs every shard's frontier loop on that shard's device, then
    concatenates the per-shard top-k lists in shard order on the data
    row's first device and cuts the merged top-k there (the JAX package's
    `all_gather` over the "shard" axis);
  - queries may also be split over a "data" mesh axis: each data row sees
    every shard;
  - builds are independent per shard.

Inside one process the shards are a loop: each shard's local step runs on
its own device, one after another. Wrap-around pad rows (global id -1, at
most S - 1, all in the last shard) are masked exactly as in the JAX
package: each shard over-selects k + S - 1, maps pads to +inf, cuts back to
k (padding a tiny shard's list back to k), and the merge is a stable top-k
(ties to the lower position, as `lax.top_k`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import time

import numpy as np
import torch

from diskrag_tpu_torch.ops.distance import Metric
from diskrag_tpu_torch.ops.topk import INF, INVALID_ID, topk_smallest
from diskrag_tpu_torch.parallel.mesh import Mesh, PlacedShards, place


@dataclasses.dataclass(frozen=True)
class ShardedIndex:
    """Stacked per-shard index arrays (leading axis = shard), as host
    numpy arrays (memory-mapped after `load_sharded_index` without a mesh)
    or, after `shard_to_mesh`, as `PlacedShards` on `mesh`.

    vectors:    float32[S, Ns, D]
    adjacency:  int32[S, Ns, R]   (local ids)
    medoids:    int32[S]
    global_ids: int32[S, Ns]      (local -> global; -1 for padding rows)
    entry_points: int32[S, E] per-shard local entry points, padded with the
                shard's own medoid (masked as a duplicate seed by the
                search loop); None = medoid-only seeding.
    """

    vectors: np.ndarray | PlacedShards
    adjacency: np.ndarray | PlacedShards
    medoids: np.ndarray | PlacedShards
    global_ids: np.ndarray | PlacedShards
    metric: str = Metric.L2.value
    entry_points: np.ndarray | PlacedShards | None = None
    mesh: Mesh | None = None

    @property
    def n_shards(self) -> int:
        return int(self.vectors.shape[0])


def partition(n: int, n_shards: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(shard_gids int32 [S, per], valid bool [S, per]): the JAX package's
    partition, one `default_rng(seed).permutation(n)` cut into S rows, the
    last row padded with wrap-around copies of the permutation's head."""
    perm = np.random.default_rng(seed).permutation(n)
    per = -(-n // n_shards)
    pad = per * n_shards - n
    shard_gids = np.concatenate([perm, perm[:pad]]).reshape(n_shards, per).astype(np.int32)
    valid = np.ones_like(shard_gids, dtype=bool)
    if pad:
        valid[-1, per - pad:] = False
    return shard_gids, valid


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def build_sharded(
    vectors: np.ndarray,
    n_shards: int,
    *,
    degree_bound: int = 32,
    build_width: int = 64,
    alpha: float = 1.2,
    metric: str = Metric.L2.value,
    seed: int = 0,
    wave_size: int | None = None,
    build_method: str = "knn",
    device: str | torch.device = "cuda",
    shard_stats: list | None = None,
) -> ShardedIndex:
    """Partition and build per-shard Vamana graphs, one shard after
    another on `device`; returns host arrays. build_method "knn" (the kNN
    build with per-shard entry points; B1 + B4 in its kNN pass) or "wave"
    (insertion). Shard s is built with seed `seed + s`.

    `shard_stats`, when given, gets one dict per shard: build seconds, the
    build's stage seconds (knn) and the kernel launches it caused."""
    from diskrag_tpu_torch.kernels.launches import launch_counts

    vectors = np.asarray(vectors, np.float32)
    n = vectors.shape[0]
    shard_gids, valid = partition(n, n_shards, seed)
    vecs, adjs, meds, gids, entries = [], [], [], [], []
    for s in range(n_shards):
        local_vecs = vectors[shard_gids[s]]
        stages: dict = {}
        before = launch_counts()
        t0 = time.perf_counter()
        if build_method == "knn":
            from diskrag_tpu_torch.graph.knn_build import build_vamana_knn

            idx = build_vamana_knn(local_vecs, degree_bound=degree_bound, alpha=alpha,
                                   metric=metric, seed=seed + s, device=device,
                                   stage_seconds=stages)
        elif build_method == "wave":
            from diskrag_tpu_torch.graph.build import build_vamana

            idx = build_vamana(local_vecs, degree_bound=degree_bound, build_width=build_width,
                               alpha=alpha, metric=metric, seed=seed + s, wave_size=wave_size,
                               device=device)
        else:
            raise ValueError(f"unknown build_method: {build_method}")
        adjs.append(_host(idx.adjacency))
        seconds = time.perf_counter() - t0
        if shard_stats is not None:
            after = launch_counts()
            shard_stats.append({"shard": s, "rows": int(local_vecs.shape[0]), "seconds": seconds,
                                "stage_seconds": stages,
                                "launches": {k: after[k] - before[k] for k in after}})
        vecs.append(local_vecs)
        meds.append(int(idx.medoid))
        g = shard_gids[s].copy()
        g[~valid[s]] = INVALID_ID
        gids.append(g)
        entries.append(np.zeros((0,), np.int32) if idx.entry_points is None
                       else _host(idx.entry_points).astype(np.int32))
        del idx
    e_max = max(e.shape[0] for e in entries)
    entry_arr = None
    if e_max > 0:
        entry_arr = np.stack([
            np.concatenate([e, np.full(e_max - e.shape[0], meds[i], np.int32)])
            for i, e in enumerate(entries)
        ])
    return ShardedIndex(
        vectors=np.stack(vecs),
        adjacency=np.stack(adjs).astype(np.int32),
        medoids=np.asarray(meds, np.int32),
        global_ids=np.stack(gids),
        metric=Metric(metric).value,
        entry_points=entry_arr,
    )


def shard_to_mesh(index: ShardedIndex, mesh: Mesh) -> ShardedIndex:
    """Each shard's arrays on its devices of `mesh` (one copy per device
    and shard, whatever the number of data rows on that device); an index
    placed on another mesh is placed anew."""
    if index.mesh == mesh:
        return index
    return ShardedIndex(
        vectors=place(index.vectors, mesh),
        adjacency=place(index.adjacency, mesh),
        medoids=place(index.medoids, mesh),
        global_ids=place(index.global_ids, mesh),
        metric=index.metric,
        entry_points=None if index.entry_points is None else place(index.entry_points, mesh),
        mesh=mesh,
    )


def _pad_batch(queries, n_data: int, device: torch.device) -> tuple[torch.Tensor, int]:
    """The batch as f32 on `device`, padded with zero rows to a multiple of
    the data axis; (queries, original batch size)."""
    q = torch.as_tensor(np.asarray(queries, np.float32) if not isinstance(queries, torch.Tensor)
                        else queries, device=device).to(torch.float32)
    if q.ndim == 1:
        q = q[None, :]
    b = q.shape[0]
    pad = (-b) % n_data
    if pad:
        q = torch.cat([q, torch.zeros((pad, q.shape[1]), dtype=q.dtype, device=q.device)])
    return q, b


def _globalize_and_cut(local_ids, local_dists, gid, k: int, kk: int):
    """Local result ids -> global ids (pads and invalid slots: -1 at +inf),
    cut to min(k, kk) and padded back to k, so every shard contributes one
    [Bd, k] block to the merge."""
    ns = gid.shape[0]
    gids = torch.where(local_ids == INVALID_ID, INVALID_ID,
                       gid[torch.clamp(local_ids, 0, ns - 1).long()])
    dists = torch.where(gids == INVALID_ID, INF, local_dists)
    dists, cut = topk_smallest(dists, min(k, kk))
    gids = torch.gather(gids, 1, cut)
    if kk < k:
        pad = k - kk
        gids = torch.cat([gids, torch.full((gids.shape[0], pad), INVALID_ID, dtype=gids.dtype,
                                           device=gids.device)], 1)
        dists = torch.cat([dists, torch.full((dists.shape[0], pad), INF, dtype=dists.dtype,
                                             device=dists.device)], 1)
    return gids, dists


def _merge_in_shard_order(mesh: Mesh, ids_rows, dist_rows, k: int):
    """The JAX package's all-gather and merge, in one process: each data
    row's per-shard [Bd, k] lists concatenated in shard order on the row's
    first device ([Bd, S * k]) and cut to the stable top-k; the rows
    stacked on the mesh's first device. Returns (ids [B, k], dists [B, k])."""
    out_i, out_d = [], []
    for i, row in enumerate(mesh.grid):
        all_g = torch.cat([g.to(row[0]) for g in ids_rows[i]], 1)
        all_d = torch.cat([d.to(row[0]) for d in dist_rows[i]], 1)
        top_d, take = topk_smallest(all_d, k)
        out_i.append(torch.gather(all_g, 1, take).to(mesh.first_device))
        out_d.append(top_d.to(mesh.first_device))
    return torch.cat(out_i), torch.cat(out_d)


def _local_search_blocks(index: ShardedIndex, q: torch.Tensor, *, search_width: int, k: int,
                         max_steps: int, n_pad_bound: int):
    """Every local shard's [Bd, k] (global ids, dists) block for every data
    row: ([data row][shard] ids, the same for dists, rounds, nodes
    expanded), rounds and nodes summed over data rows and shards."""
    from diskrag_tpu_torch.graph.search import beam_search

    mesh = index.mesh
    n_data = len(mesh.grid)
    bd = q.shape[0] // n_data
    ids_rows, dist_rows, rounds, expanded = [], [], 0, 0
    for i, row in enumerate(mesh.grid):
        ids_row, dist_row = [], []
        for j, dev in enumerate(row):
            vecs = index.vectors.blocks[i][j]
            ns = vecs.shape[0]
            kk = min(k + n_pad_bound, ns)
            res = beam_search(
                vecs, index.adjacency.blocks[i][j], index.medoids.blocks[i][j],
                q[i * bd : (i + 1) * bd].to(dev),
                search_width=max(search_width, kk), k=kk, max_steps=max_steps,
                metric=index.metric,
                entry_points=None if index.entry_points is None else index.entry_points.blocks[i][j],
            )
            g, d = _globalize_and_cut(res.ids, res.dists, index.global_ids.blocks[i][j], k, kk)
            ids_row.append(g)
            dist_row.append(d)
            rounds += int(res.n_steps)
            expanded += int(torch.sum(res.n_expanded))
        ids_rows.append(ids_row)
        dist_rows.append(dist_row)
    return ids_rows, dist_rows, rounds, expanded


def _sharded_search_impl(index: ShardedIndex, queries: torch.Tensor, *, search_width: int, k: int,
                         max_steps: int):
    """Search a placed index for a batch padded to the data axis: (ids
    [B, k], dists [B, k] on the mesh's first device, rounds, nodes
    expanded)."""
    mesh = index.mesh
    ids_rows, dist_rows, rounds, expanded = _local_search_blocks(
        index, queries, search_width=search_width, k=k, max_steps=max_steps,
        n_pad_bound=mesh.shape["shard"] - 1)
    ids, dists = _merge_in_shard_order(mesh, ids_rows, dist_rows, k)
    return ids, dists, rounds, expanded


def sharded_build_wave(vectors, adjacency, medoids, wave_local_ids, alpha, *, build_width: int,
                       max_incoming: int, chunk: int, metric: str, mesh: Mesh) -> PlacedShards:
    """One index-build step over the mesh: every shard refines one wave of
    its local points (`graph.build.wave_step` on the shard's device, on a
    copy of its adjacency). Stacked arrays are placed first; returns the
    updated adjacency placed as the input is (data rows on other devices
    get a copy of the result)."""
    from diskrag_tpu_torch.graph.build import wave_step

    vectors, adjacency, medoids, waves = (
        place(a, mesh) for a in (vectors, adjacency, medoids, wave_local_ids))
    new = []
    for j, dev in enumerate(mesh.grid[0]):
        new.append(wave_step(
            vectors.blocks[0][j], adjacency.blocks[0][j].clone(), medoids.blocks[0][j],
            waves.blocks[0][j], float(alpha), build_width=build_width,
            max_incoming=max_incoming, chunk=chunk, metric=metric,
        ))
    rows = []
    for row in mesh.grid:
        rows.append(tuple(new[j].to(dev) for j, dev in enumerate(row)))
    return PlacedShards(tuple(rows))


def _local_flat_blocks(vectors_bf16: PlacedShards, norms_sq: PlacedShards,
                       global_ids: PlacedShards, q: torch.Tensor, *, k: int, metric: str,
                       mesh: Mesh, n_pad_bound: int):
    """Every local shard's [Bd, k] block of the exhaustive scan, per data
    row (as `_local_search_blocks`, without counters)."""
    from diskrag_tpu_torch.ops.flat import flat_search

    n_data = len(mesh.grid)
    bd = q.shape[0] // n_data
    ids_rows, dist_rows = [], []
    for i, row in enumerate(mesh.grid):
        ids_row, dist_row = [], []
        for j, dev in enumerate(row):
            vecs = vectors_bf16.blocks[i][j]
            ns = vecs.shape[0]
            kk = min(k + n_pad_bound, ns)
            # one tile while the [Bd, Ns] f32 block stays near 2 GB
            d, li = flat_search(q[i * bd : (i + 1) * bd].to(dev), vecs, norms_sq.blocks[i][j],
                                None, k=kk, metric=metric,
                                chunk=min(ns, max(32_768, (2**29) // max(bd, 1))))
            g, d = _globalize_and_cut(li, d, global_ids.blocks[i][j], k, kk)
            ids_row.append(g)
            dist_row.append(d)
        ids_rows.append(ids_row)
        dist_rows.append(dist_row)
    return ids_rows, dist_rows


def sharded_flat_search(vectors_bf16, norms_sq, global_ids, queries, mesh: Mesh, *, k: int,
                        metric: str = "l2"):
    """Sharded exhaustive scan: each shard's bf16 rows scanned on its
    device (`ops.flat.flat_search`, f32 sums, plain PyTorch as the JAX
    package's XLA scan), the per-shard top-k lists merged. vectors_bf16
    [S, Ns, D], norms_sq [S, Ns] f32, global_ids [S, Ns] int32: stacked
    arrays, placed here, or already `PlacedShards`; the batch is split over
    "data" (odd sizes padded). Returns (ids [B, k], dists [B, k])."""
    vectors_bf16 = place(vectors_bf16, mesh, torch.bfloat16)
    norms_sq = place(norms_sq, mesh, torch.float32)
    global_ids = place(global_ids, mesh)
    q, b = _pad_batch(queries, mesh.shape["data"], mesh.first_device)
    ids_rows, dist_rows = _local_flat_blocks(vectors_bf16, norms_sq, global_ids, q, k=k,
                                             metric=metric, mesh=mesh,
                                             n_pad_bound=mesh.shape["shard"] - 1)
    ids, dists = _merge_in_shard_order(mesh, ids_rows, dist_rows, k)
    return ids[:b], dists[:b]


def sharded_search(index: ShardedIndex, queries, mesh: Mesh, *, search_width: int, k: int,
                   max_steps: int | None = None, stats: dict | None = None):
    """Search all shards; returns (global ids [B, k], dists [B, k]) on the
    mesh's first device. The batch is split over the "data" axis (padded
    with zero rows to a multiple of it); every shard runs exact traversal
    at width max(search_width, kk) for at most `max_steps` rounds (default
    2 * search_width), kk = min(k + S - 1, Ns). `stats`, when given, gets
    the rounds and nodes expanded, summed over shards and data rows."""
    if max_steps is None:
        max_steps = 2 * search_width
    index = shard_to_mesh(index, mesh)
    q, b = _pad_batch(queries, mesh.shape["data"], mesh.first_device)
    ids, dists, rounds, expanded = _sharded_search_impl(index, q, search_width=search_width, k=k,
                                                        max_steps=max_steps)
    if stats is not None:
        stats.update(rounds=rounds, nodes_expanded=expanded)
    return ids[:b], dists[:b]


SHARDED_FORMAT_VERSION = "tpu-sharded-1"


def _stacked(a) -> np.ndarray:
    return a.numpy() if isinstance(a, PlacedShards) else np.asarray(a)


def save_sharded_index(index: ShardedIndex, index_dir: str | os.PathLike) -> None:
    """Persist a ShardedIndex (the JAX package's files and format, atomic
    .tmp -> rename writes):

        <index_dir>/
          vectors.npy       float32[S, Ns, D]
          adjacency.npy     int32[S, Ns, R]
          medoids.npy       int32[S]
          global_ids.npy    int32[S, Ns]
          entry_points.npy  int32[S, E]        (only when present)
          sharded_meta.json format/shape/metric
    """
    from diskrag_tpu_torch.index.persist import _atomic_save_npy, _atomic_write_bytes

    d = pathlib.Path(index_dir)
    d.mkdir(parents=True, exist_ok=True)
    vectors = _stacked(index.vectors).astype(np.float32, copy=False)
    adjacency = _stacked(index.adjacency).astype(np.int32, copy=False)
    _atomic_save_npy(d / "vectors.npy", vectors)
    _atomic_save_npy(d / "adjacency.npy", adjacency)
    _atomic_save_npy(d / "medoids.npy", _stacked(index.medoids).astype(np.int32, copy=False))
    _atomic_save_npy(d / "global_ids.npy", _stacked(index.global_ids).astype(np.int32, copy=False))
    if index.entry_points is not None:
        _atomic_save_npy(d / "entry_points.npy",
                         _stacked(index.entry_points).astype(np.int32, copy=False))
    s, ns, dim = vectors.shape
    meta = {
        "format": SHARDED_FORMAT_VERSION,
        "n_shards": int(s),
        "points_per_shard": int(ns),
        "dim": int(dim),
        "degree_bound": int(adjacency.shape[-1]),
        "metric": index.metric,
        "has_entry_points": index.entry_points is not None,
    }
    _atomic_write_bytes(d / "sharded_meta.json", json.dumps(meta, indent=2).encode())


def load_sharded_index(index_dir: str | os.PathLike, mesh: Mesh | None = None) -> ShardedIndex:
    """Load a saved ShardedIndex. Without `mesh` the arrays stay on the
    host (vectors and adjacency memory-mapped): consumers place what they
    need (the sharded host tier keeps only a compressed copy on the
    device). With `mesh`, each shard goes straight to its devices."""
    d = pathlib.Path(index_dir)
    meta = json.loads((d / "sharded_meta.json").read_text())
    if meta.get("format") != SHARDED_FORMAT_VERSION:
        raise ValueError(f"unsupported sharded index format: {meta.get('format')!r}")
    entry_arr = np.load(d / "entry_points.npy") if meta.get("has_entry_points") else None
    index = ShardedIndex(
        vectors=np.load(d / "vectors.npy", mmap_mode="r"),
        adjacency=np.load(d / "adjacency.npy", mmap_mode="r"),
        medoids=np.load(d / "medoids.npy"),
        global_ids=np.load(d / "global_ids.npy"),
        metric=Metric(meta["metric"]).value,
        entry_points=entry_arr,
    )
    if mesh is not None:
        index = shard_to_mesh(index, mesh)
    return index
