"""Dynamic index operations (counterpart of `diskrag_tpu/graph/dynamic.py`):
batched insert, tombstone delete, consolidation.

  - inserts are batched: the new points extend the dense tensors and one
    build wave (batched search + RobustPrune + reverse edges) links them
    in; the waves' searches start from the index's entry points where it
    has them (`graph/build.py`), the medoid alone otherwise, as in the JAX
    package;
  - deletes are tombstones in a boolean mask; a search traverses through
    tombstoned nodes and the caller filters them from its results
    (`filter_deleted`);
  - consolidation compacts the arrays: deleted rows are dropped, ids
    remapped, edges into deleted nodes replaced by the deleted node's own
    out-edges (a stitch, numpy on the host as in the JAX package), then a
    refinement pass of build waves restores graph quality.
"""

from __future__ import annotations

import numpy as np
import torch

from diskrag_tpu_torch.device import resolve_device
from diskrag_tpu_torch.graph.build import wave_step
from diskrag_tpu_torch.graph.types import VamanaIndex
from diskrag_tpu_torch.ops.medoid import approximate_medoid
from diskrag_tpu_torch.ops.topk import INF, INVALID_ID, topk_smallest


def random_links(n: int, m: int, r: int, device: torch.device) -> torch.Tensor:
    """int32 [m, r] random links of m new rows into the n existing ones,
    drawn from a generator seeded with n (deterministic per current
    size, as the JAX package's `jax.random.key(n)`)."""
    gen = torch.Generator(device=device).manual_seed(int(n))
    return torch.randint(0, n, (m, r), generator=gen, device=device).to(torch.int32)


def insert_points(
    index: VamanaIndex,
    new_vectors,
    *,
    build_width: int = 64,
    alpha: float = 1.2,
    max_incoming: int | None = None,
    expand_width: int = 8,
) -> VamanaIndex:
    """Insert a batch of new points into an existing index. Returns a new,
    larger index on the same device; existing ids are unchanged, the new
    points get ids n..n+M-1."""
    dev = index.device
    new_vectors = torch.as_tensor(new_vectors, dtype=torch.float32, device=dev)
    if new_vectors.ndim == 1:
        new_vectors = new_vectors[None, :]
    m = new_vectors.shape[0]
    n, r = index.adjacency.shape
    if new_vectors.shape[1] != index.dim:
        raise ValueError(f"dimension mismatch: {new_vectors.shape[1]} vs {index.dim}")

    vectors = torch.cat([index.vectors, new_vectors])
    # new rows start with random links into the existing graph, so reverse
    # edges can reach them before their wave completes
    adjacency = torch.cat([index.adjacency, random_links(n, m, r, dev)])
    wave_ids = torch.arange(n, n + m, dtype=torch.int32, device=dev)
    adjacency = wave_step(
        vectors, adjacency, index.medoid, wave_ids, alpha,
        build_width=build_width, max_incoming=max_incoming or min(16, r),
        chunk=min(8192, m * r), metric=index.metric, expand_width=expand_width,
        entry_points=index.entry_points,
    )
    return VamanaIndex(vectors=vectors, adjacency=adjacency, medoid=index.medoid,
                       metric=index.metric, entry_points=index.entry_points)


def make_deleted_mask(n: int, deleted_ids=None, *, device: str | torch.device = "cuda") -> torch.Tensor:
    """bool [n] tombstone mask with `deleted_ids` set."""
    dev = resolve_device(device)
    mask = torch.zeros((n,), dtype=torch.bool, device=dev)
    if deleted_ids is not None and len(deleted_ids) > 0:
        mask[torch.as_tensor(np.asarray(deleted_ids), device=dev).long()] = True
    return mask


def delete_points(deleted_mask: torch.Tensor, ids) -> torch.Tensor:
    """A copy of the mask with `ids` tombstoned as well."""
    out = deleted_mask.clone()
    out[torch.as_tensor(np.asarray(ids), device=out.device).long()] = True
    return out


def filter_deleted(
    ids: torch.Tensor, dists: torch.Tensor, deleted_mask: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Drop tombstoned ids from search results (callers over-fetch when
    deletions are pending): the k best survivors, id -1 / +inf past them."""
    n = deleted_mask.shape[0]
    bad = (ids == INVALID_ID) | deleted_mask[torch.clamp(ids, 0, n - 1).long()]
    vals, take = topk_smallest(torch.where(bad, INF, dists), k)
    out_ids = torch.gather(ids, -1, take)
    return torch.where(torch.isinf(vals), INVALID_ID, out_ids), vals


def _stitch(adj_full: np.ndarray, deleted: np.ndarray, old_to_new: np.ndarray) -> np.ndarray:
    """The compacted adjacency int32 [n_new, R]: each kept row's edges
    into deleted nodes replaced by those nodes' own out-edges, remapped to
    new ids, deduplicated in column order and capped at R. Built per row
    chunk, so the [rows, R, R] hop tensor stays bounded."""
    n = len(deleted)
    keep = ~deleted
    kept_adj = adj_full[keep]  # [n_new, R] old ids
    n_new, r = kept_adj.shape
    new_adj = np.full((n_new, r), -1, np.int32)
    c = r * (r + 1)
    chunk_rows = max(1, (1 << 24) // max(c, 1))
    for lo in range(0, n_new, chunk_rows):
        ka = kept_adj[lo : lo + chunk_rows]
        safe = np.clip(ka, 0, n - 1)
        edge_deleted = (ka >= 0) & deleted[safe]
        hop = adj_full[safe]  # [m, R, R]
        cand = np.concatenate(
            [
                np.where(edge_deleted, -1, ka)[:, :, None],
                np.where(edge_deleted[:, :, None], hop, -1),
            ],
            axis=2,
        ).reshape(ka.shape[0], -1)
        cand_safe = np.clip(cand, 0, n - 1)
        rows = np.where(
            (cand >= 0) & ~deleted[cand_safe], old_to_new[cand_safe], -1
        ).astype(np.int32)
        # dedup per row keeping column order: an id-sorted stable argsort
        # marks repeats, a second stable argsort on validity compacts the
        # survivors to the front
        m = rows.shape[0]
        self_col = np.arange(lo, lo + m, dtype=rows.dtype)[:, None]
        valid = (rows >= 0) & (rows != self_col)
        by_id = np.argsort(np.where(valid, rows, np.iinfo(np.int32).max), axis=1, kind="stable")
        sorted_ids = np.take_along_axis(rows, by_id, axis=1)
        dup_sorted = np.zeros_like(valid)
        dup_sorted[:, 1:] = sorted_ids[:, 1:] == sorted_ids[:, :-1]
        dup = np.zeros_like(valid)
        np.put_along_axis(dup, by_id, dup_sorted, axis=1)
        keep_c = valid & ~dup
        compact = np.argsort(~keep_c, axis=1, kind="stable")[:, :r]
        vals = np.take_along_axis(rows, compact, axis=1)
        kept = np.take_along_axis(keep_c, compact, axis=1)
        new_adj[lo : lo + m] = np.where(kept, vals, -1)
    return new_adj


def consolidate(
    index: VamanaIndex,
    deleted_mask,
    *,
    build_width: int = 64,
    alpha: float = 1.2,
    refine_fraction: float = 1.0,
    seed: int = 0,
    refine_rows: np.ndarray | None = None,
) -> tuple[VamanaIndex, np.ndarray]:
    """Compact away tombstoned nodes. Returns (new_index, old_to_new) with
    old_to_new[i] the new id of old node i, or -1 if it was deleted. The
    refinement re-inserts a random `refine_fraction` of the nodes or,
    given `refine_rows` (old ids of kept nodes), exactly those, in an
    order drawn from
    `numpy.random.default_rng(seed)` (the JAX package's)."""
    dev = index.device
    deleted = np.asarray(torch.as_tensor(deleted_mask).cpu().numpy(), bool)
    n = len(deleted)
    keep = ~deleted
    n_new = int(keep.sum())
    if n_new == 0:
        raise ValueError("cannot consolidate an index with every node deleted")
    old_to_new = np.full(n, -1, np.int64)
    old_to_new[keep] = np.arange(n_new)

    keep_t = torch.as_tensor(keep, device=dev)
    vectors = index.vectors[keep_t]
    adj_full = index.adjacency.cpu().numpy()  # one device -> host copy
    new_adj = _stitch(adj_full, deleted, old_to_new)
    r = new_adj.shape[1]

    # surviving entry points, remapped (deleted ones are dropped)
    new_entries = None
    if index.entry_points is not None:
        eps = index.entry_points.cpu().numpy()
        eps = old_to_new[eps[~deleted[eps]]]
        if eps.size > 1:
            new_entries = torch.as_tensor(np.unique(eps), dtype=torch.int32, device=dev)

    medoid = approximate_medoid(vectors, metric=index.metric).to(torch.int32)
    adjacency = torch.as_tensor(new_adj, device=dev)

    # refinement pass over some of the nodes to restore quality
    rng = np.random.default_rng(seed)
    if refine_rows is not None:
        order = rng.permutation(old_to_new[np.asarray(refine_rows)]).astype(np.int32)
    elif refine_fraction > 0:
        order = rng.permutation(n_new)[: max(1, int(n_new * refine_fraction))].astype(np.int32)
    else:
        order = np.zeros(0, np.int32)
    if len(order):
        wave = min(512, len(order))
        pad = (-len(order)) % wave
        if pad:
            order = np.concatenate([order, order[:pad]])
        waves = torch.as_tensor(order.reshape(-1, wave), device=dev)
        for i in range(waves.shape[0]):
            adjacency = wave_step(
                vectors, adjacency, medoid, waves[i], alpha,
                build_width=build_width, max_incoming=min(16, r),
                chunk=min(8192, wave * r), metric=index.metric, entry_points=new_entries,
            )
    new_index = VamanaIndex(vectors=vectors, adjacency=adjacency, medoid=medoid,
                            metric=index.metric, entry_points=new_entries)
    return new_index, old_to_new
