"""Streaming ingest (counterpart of `diskrag_tpu/index/streaming.py`): a
mutable serving tier between one-wave insert and rebuild.

New points go into a small exact side buffer that is brute-scanned beside
the graph, and the buffer is folded into the graph in bulk when it fills
(FreshDiskANN's design):

  - the buffer is a preallocated device tensor [capacity, D]; an append is
    one slice copy per batch;
  - search = graph beam search + masked exact scan of the buffer + a top-k
    merge (`_search_merged`). Buffer hits are exact, so recall during
    ingest is the graph's on old points and 1.0 on buffered ones;
  - the graph tensors are padded to a capacity bucket (multiples of
    `_BUCKET` rows, grown geometrically) with tombstoned pad rows far away
    (`_PAD_VALUE`), and a merge folds every populated buffer slot (dead
    ones become graph tombstones): every merge of a full buffer has the
    same shapes;
  - a merge takes the new rows by exact-kNN insertion
    (`_knn_merge_waves`: candidates from one fused int8 flat scan per
    4096-row sub-wave — kernels B1 and B4 on the card — then forward rows
    for all sub-waves and one reverse-edge repair), or by
    `graph.build.wave_step` (`merge_method="wave"`), while the buffer is a
    small fraction of the graph, and by a full kNN rebuild
    (`graph.knn_build.build_vamana_knn`) once it is not. Deletes are
    tombstones in both tiers; `consolidate()` compacts them
    (`graph/dynamic.py`);
  - ids are stable across merges: each point gets a permanent external id
    at insert, and searches return external ids through a device-resident
    translation row.

Not thread-safe: callers serialize mutations (the engine holds a lock).
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

from diskrag_tpu_torch.graph import dynamic
from diskrag_tpu_torch.graph.build import _reverse_edges, wave_step
from diskrag_tpu_torch.graph.prune import gathered_distance_int8, robust_prune_batch
from diskrag_tpu_torch.graph.search import _gathered_distance, beam_search
from diskrag_tpu_torch.graph.types import VamanaIndex
from diskrag_tpu_torch.ops.distance import Metric, pairwise_distance
from diskrag_tpu_torch.ops.topk import INF, INVALID_ID, topk_smallest

logger = logging.getLogger(__name__)

# capacity-pad rows: far but finite vectors (1e30 would overflow the
# squared distance to inf and risk inf - inf = NaN in the masked merges;
# 1e15 keeps ||pad||^2 ~ 1e32), no out-edges, tombstoned
_PAD_VALUE = 1e15
_BUCKET = 65_536
# sub-wave rows of the kNN merge's reverse-edge repair
_REVERSE_ROWS = 32_768


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _search_merged(
    vectors, adjacency, medoid, entry_points, graph_ext, graph_deleted,
    buf, buf_ext, buf_live, buf_count: int, queries,
    *, search_width: int, k: int, expand_width: int, metric: str,
):
    """Graph beam search + exact buffer scan + top-k merge. Graph results
    are over-fetched at the full beam width so tombstoned rows can be
    dropped without losing k survivors; buffer slots past `buf_count` (or
    tombstoned) are masked to +inf; capacity-pad rows are tombstoned and
    unreachable. Returns (EXTERNAL ids, dists)."""
    res = beam_search(
        vectors, adjacency, medoid, queries,
        search_width=search_width, k=search_width, metric=metric,
        expand_width=expand_width, entry_points=entry_points,
    )
    n = graph_deleted.shape[0]
    safe = torch.clamp(res.ids, 0, n - 1).long()
    bad = (res.ids == INVALID_ID) | graph_deleted[safe]
    g_dists = torch.where(bad, INF, res.dists)
    g_ext = torch.where(bad, INVALID_ID, graph_ext[safe])

    cap = buf.shape[0]
    slot_live = (torch.arange(cap, device=buf.device) < buf_count) & buf_live
    b_d = torch.where(slot_live[None, :], pairwise_distance(queries, buf, Metric(metric)), INF)
    b_vals, b_idx = topk_smallest(b_d, min(k, cap))
    b_ext = torch.where(torch.isinf(b_vals), INVALID_ID, buf_ext[b_idx])

    all_d = torch.cat([g_dists, b_vals], dim=1)
    all_i = torch.cat([g_ext, b_ext], dim=1)
    vals, take = topk_smallest(all_d, k)
    ids = torch.gather(all_i, 1, take)
    return torch.where(torch.isinf(vals), INVALID_ID, ids), vals


def _knn_forward_rows(
    vectors, adjacency, wave_ids, cand_ids, cand_dists, n_used: int, alpha,
    *, metric: str, codes=None, code_scales=None,
):
    """Prune one sub-wave's exact-kNN candidate pool and write the forward
    rows. The pool = the flat scan's top candidates (self and rows past
    the in-use watermark `n_used` masked out here: pads are far under L2
    but identical unit vectors under cosine) ++ the rows' current links.
    `codes` / `code_scales`: the merge scan's int8 copy, for the pool
    gathers and the prune distances (the scan's candidate distances stay
    exact f32). Updates `adjacency` in place; returns (adjacency, pruned
    [W, R])."""
    n, r = adjacency.shape
    rows = wave_ids.long()
    bad = (cand_ids >= n_used) | (cand_ids == wave_ids[:, None])
    cand_dists = torch.where(bad, INF, cand_dists)
    cand_ids = torch.where(bad, INVALID_ID, cand_ids).to(torch.int32)
    cur = adjacency[rows]
    cur_safe = torch.clamp(cur, 0, n - 1).long()
    pool_ids = torch.cat([cand_ids, cur], dim=1)
    safe_pool = torch.clamp(pool_ids, 0, n - 1).long()
    if codes is not None:
        cur_d = gathered_distance_int8(codes[rows], code_scales[rows], codes[cur_safe],
                                       code_scales[cur_safe], metric)
        pool_vecs = codes[safe_pool]
        pool_sc = code_scales[safe_pool]
    else:
        cur_d = _gathered_distance(vectors[rows], vectors[cur_safe], metric)
        pool_vecs = vectors[safe_pool]
        pool_sc = None
    cur_d = torch.where(cur == INVALID_ID, INF, cur_d)
    pool_dists = torch.cat([cand_dists, cur_d], dim=1)
    pruned = robust_prune_batch(
        wave_ids, pool_ids, pool_vecs, pool_dists, alpha,
        degree_bound=r, metric=metric, cand_scales=pool_sc,
    ).to(adjacency.dtype)
    adjacency[rows] = pruned
    return adjacency, pruned


def _reverse_pass(vectors, adjacency, wave_ids, pruned, alpha, *, max_incoming: int, chunk: int,
                  metric: str, codes=None, code_scales=None):
    """The reverse-edge repair of the kNN merge (`graph.build._reverse_edges`)
    over one slice of rows whose forward rows are written; `codes` /
    `code_scales`: the merge scan's int8 copy. Updates `adjacency` in place."""
    return _reverse_edges(
        vectors, adjacency, wave_ids, pruned, alpha, max_incoming=max_incoming, chunk=chunk,
        metric=metric, codes=codes, code_scales=code_scales,
    )


def _place_rows(vectors, adjacency, n0: int, vecs, rand_links) -> None:
    """Write a wave of new rows and their links into the padded region at n0."""
    m = vecs.shape[0]
    vectors[n0 : n0 + m] = vecs
    adjacency[n0 : n0 + m] = rand_links


def merge_scan_table(vectors: torch.Tensor, n_used: int, metric: str):
    """The kNN merge's scan operands over the padded table `vectors`: (int8
    codes [N, D], per-row scales [N], squared norms [N]). Under cosine the
    codes are those of the normalized rows, and the capacity pads (rows
    from `n_used` on) get zero codes and scales: normalized, they would
    all be ONE unit direction, tens of thousands of identical rows that
    could crowd the candidate slots of a query correlated with it (they
    are masked only after the cut, in `_knn_forward_rows`); at similarity
    0 they rank behind every positively correlated real candidate. Under
    L2 the pads are ~1e30 away already."""
    from diskrag_tpu_torch.ops.flat_scan import quantize_int8

    norms = torch.sum(vectors * vectors, dim=-1)
    if metric != Metric.COSINE.value:
        vec_scan, scan_scales = quantize_int8(vectors)
        return vec_scan, scan_scales, norms
    vec_scan, scan_scales = quantize_int8(vectors * torch.rsqrt(norms + 1e-12)[:, None])
    pad_rows = torch.arange(vectors.shape[0], device=vectors.device) >= n_used
    vec_scan = torch.where(pad_rows[:, None], 0, vec_scan).to(torch.int8)
    return vec_scan, torch.where(pad_rows, 0.0, scan_scales), norms


def auto_buffer_capacity(n: int) -> int:
    """Default side-buffer capacity for a base of `n` rows: 32768 for any
    base that can absorb it, shrinking (in steps of 4096, down to 4096)
    for small collections where a 32k buffer would rival the base. The
    JAX package chose 32768 from its merge-cost measurements; the port
    keeps the rule so both serve the same buffer."""
    return min(32_768, max(4_096, -(-(n // 4) // 4_096) * 4_096))


class StreamingIndex:
    """Mutable serving tier: a padded Vamana graph + an exact device buffer,
    on the graph's device.

    Single writer: callers serialize mutations (the engine's lock does)."""

    def __init__(
        self,
        index: VamanaIndex,
        *,
        buffer_capacity: Optional[int] = None,
        merge_insert_max_fraction: float = 0.25,
        build_width: int = 64,
        alpha: float = 1.2,
        degree_bound: Optional[int] = None,
        seed: int = 0,
        wave_chunk: int = 4096,
        merge_method: str = "knn",
        reserve_inserts: int = 0,
    ):
        if merge_method not in ("knn", "wave"):
            raise ValueError(f"unknown merge_method {merge_method!r}")
        n = int(index.adjacency.shape[0])
        if buffer_capacity is None:
            buffer_capacity = auto_buffer_capacity(n)
        elif n >= 4 * int(buffer_capacity) and int(buffer_capacity) < 32_768:
            logger.warning(
                "buffer_capacity=%d below 32768 at a base of %d rows: the merge's "
                "fixed costs amortize over fewer inserts", int(buffer_capacity), n,
            )
        self.capacity = int(buffer_capacity)
        # insert headroom kept padded beyond the live rows: a growth event
        # reallocates the padded tensors, so a long-running service
        # reserves its expected ingest up front
        self._reserve = int(reserve_inserts)
        self.merge_insert_max_fraction = merge_insert_max_fraction
        self._wave_chunk = int(wave_chunk)
        self.merge_method = merge_method
        self.build_width = build_width
        self.alpha = alpha
        self.degree_bound = degree_bound or int(index.adjacency.shape[1])
        self.seed = seed
        self.metric = index.metric
        self.device = index.device

        dim = int(index.vectors.shape[1])
        self._buf = torch.zeros((self.capacity, dim), dtype=torch.float32, device=self.device)
        self._buf_ext = torch.full((self.capacity,), INVALID_ID, dtype=torch.int32,
                                   device=self.device)
        self._buf_live = torch.zeros((self.capacity,), dtype=torch.bool, device=self.device)
        self._count = 0
        # external-id bookkeeping: graph row i serves external id
        # _graph_ext[i]; external ids are dense and never reused
        self._n_graph = n
        self._next_ext = n
        self._n_deleted = 0
        self.n_merges = 0
        # host mirror for delete-by-external-id on the buffer
        self._buf_ext_host: dict[int, int] = {}
        # external ids tombstoned in either tier: makes delete idempotent
        self._deleted_ext: set[int] = set()
        # sticky: set whenever rows are dropped and compacted (rebuild-path
        # merge or consolidate). From then on graph row i != external id i,
        # so persisting the rows over a collection whose vector_index is
        # positional would mis-join every compacted row; the engine's
        # flush_index refuses while it is set (_n_deleted alone cannot
        # guard this: compaction returns it to 0)
        self.rows_compacted = False
        # the last kNN merge's stage boundaries: (stage closed, CUDA event
        # or host clock); read through last_merge_stage_seconds
        self._merge_marks: list | None = None
        self._adopt_index(index, np.arange(n, dtype=np.int32), None)

    # --- capacity padding ------------------------------------------------------
    def _adopt_index(self, index: VamanaIndex, ext: np.ndarray, deleted: np.ndarray | None) -> None:
        """Install `index` (exact-size tensors) padded to the capacity bucket;
        `ext` / `deleted` are its per-row external ids / tombstone mask
        (deleted None = all live)."""
        dev = self.device
        n = int(index.adjacency.shape[0])
        cap = _round_up(n + self.capacity + self._reserve, _BUCKET)
        pad = cap - n
        dim = int(index.vectors.shape[1])
        r = int(index.adjacency.shape[1])
        vectors = torch.cat([
            index.vectors.to(dev, torch.float32),
            torch.full((pad, dim), _PAD_VALUE, dtype=torch.float32, device=dev),
        ])
        adjacency = torch.cat([
            index.adjacency.to(dev, torch.int32),
            torch.full((pad, r), INVALID_ID, dtype=torch.int32, device=dev),
        ])
        self.index = VamanaIndex(vectors=vectors, adjacency=adjacency,
                                 medoid=index.medoid.to(dev), metric=index.metric,
                                 entry_points=index.entry_points)
        self._n_graph = n
        self._graph_ext = torch.cat([
            torch.as_tensor(np.asarray(ext, np.int32), device=dev),
            torch.full((pad,), INVALID_ID, dtype=torch.int32, device=dev),
        ])
        base_deleted = (torch.zeros((n,), dtype=torch.bool, device=dev) if deleted is None
                        else torch.as_tensor(np.asarray(deleted, bool), device=dev))
        self._graph_deleted = torch.cat([base_deleted,
                                         torch.ones((pad,), dtype=torch.bool, device=dev)])

    @property
    def _graph_capacity(self) -> int:
        return int(self.index.adjacency.shape[0])

    def _ensure_graph_capacity(self, need: int) -> None:
        """Grow the padded region (geometric, bucket-rounded) so `need` rows fit."""
        cap = self._graph_capacity
        if need <= cap:
            return
        grow = _round_up(max(need, cap + cap // 2), _BUCKET) - cap
        dev = self.device
        dim = int(self.index.vectors.shape[1])
        r = int(self.index.adjacency.shape[1])
        self.index = VamanaIndex(
            vectors=torch.cat([self.index.vectors, torch.full(
                (grow, dim), _PAD_VALUE, dtype=torch.float32, device=dev)]),
            adjacency=torch.cat([self.index.adjacency, torch.full(
                (grow, r), INVALID_ID, dtype=torch.int32, device=dev)]),
            medoid=self.index.medoid, metric=self.index.metric,
            entry_points=self.index.entry_points,
        )
        self._graph_ext = torch.cat([self._graph_ext, torch.full(
            (grow,), INVALID_ID, dtype=torch.int32, device=dev)])
        self._graph_deleted = torch.cat([self._graph_deleted, torch.ones(
            (grow,), dtype=torch.bool, device=dev)])

    def reserve(self, n_inserts: int) -> None:
        """Pre-grow the padded region for `n_inserts` upcoming inserts: one
        reallocation now instead of a growth event mid-serving."""
        self._reserve = max(self._reserve, int(n_inserts))
        self._ensure_graph_capacity(self._n_graph + self.capacity + int(n_inserts))

    # --- sizes -----------------------------------------------------------------
    @property
    def n_graph(self) -> int:
        """Graph rows in use (live + tombstoned; excludes the capacity pad)."""
        return self._n_graph

    @property
    def n_buffered(self) -> int:
        return self._count

    @property
    def n_total_live(self) -> int:
        return self._n_graph + self._count - self._n_deleted

    # --- mutation ----------------------------------------------------------------
    def insert(self, vectors) -> np.ndarray:
        """Insert a batch; returns the external ids assigned. When a batch
        would overflow the buffer, the buffer is merged into the graph
        first (see `merge`); a batch larger than the whole buffer goes
        straight into the graph."""
        v = torch.as_tensor(vectors, dtype=torch.float32, device=self.device)
        if v.ndim == 1:
            v = v[None, :]
        m = int(v.shape[0])
        if m > self.capacity:
            ids = np.arange(self._next_ext, self._next_ext + m, dtype=np.int32)
            self._merge_vectors(v, torch.as_tensor(ids, device=self.device),
                                np.zeros((m,), bool))
            self._next_ext += m
            return ids
        if self._count + m > self.capacity:
            self.merge()
        ids = np.arange(self._next_ext, self._next_ext + m, dtype=np.int32)
        c = self._count
        self._buf[c : c + m] = v
        self._buf_ext[c : c + m] = torch.as_tensor(ids, device=self.device)
        self._buf_live[c : c + m] = True
        for j, e in enumerate(ids.tolist()):
            self._buf_ext_host[e] = c + j
        self._count += m
        self._next_ext += m
        return ids

    def delete(self, external_ids) -> int:
        """Tombstone by external id (either tier). Idempotent: re-deleting a
        tombstoned id is a no-op. An id that never existed raises KeyError
        before any state changes (every id is resolved first, so a failed
        batch is a full no-op). Returns the count of newly tombstoned ids."""
        ext = np.atleast_1d(np.asarray(external_ids, np.int64))
        ext_to_row = None
        resolved: list[tuple[int, int | None, int | None]] = []
        for e in ext.tolist():
            slot = self._buf_ext_host.get(e)
            row = None
            if slot is None:
                if ext_to_row is None:
                    ext_host = self._graph_ext[: self._n_graph].cpu().numpy()
                    ext_to_row = {int(x): i for i, x in enumerate(ext_host)}
                row = ext_to_row.get(e)
                if row is None:
                    raise KeyError(f"unknown external id {e}")
            resolved.append((e, slot, row))
        graph_rows, buf_slots = [], []
        for e, slot, row in resolved:
            if e in self._deleted_ext:
                continue
            self._deleted_ext.add(e)
            if slot is not None:
                buf_slots.append(slot)
            else:
                graph_rows.append(row)
        if graph_rows:
            self._graph_deleted = dynamic.delete_points(self._graph_deleted, graph_rows)
        if buf_slots:
            self._buf_live[torch.as_tensor(buf_slots, device=self.device)] = False
        n_new = len(graph_rows) + len(buf_slots)
        self._n_deleted += n_new
        return n_new

    # --- merge -----------------------------------------------------------------
    def merge(self) -> None:
        """Fold the buffer into the graph in bulk. Folds every populated
        slot (tombstoned buffered rows become graph tombstones), so a merge
        of a full buffer always has the same shapes; `consolidate()`
        reclaims the tombstones."""
        if self._count == 0:
            return
        c = self._count
        dead = ~self._buf_live[:c].cpu().numpy()
        self._merge_vectors(self._buf[:c].clone(), self._buf_ext[:c].clone(), dead)
        self._buf_live.zero_()
        self._buf_ext.fill_(INVALID_ID)
        self._count = 0
        self._buf_ext_host.clear()
        self.n_merges += 1

    def _merge_vectors(self, vecs: torch.Tensor, exts: torch.Tensor, dead: np.ndarray) -> None:
        m = int(vecs.shape[0])
        if m == 0:
            return
        self._merge_marks = None
        n0 = self._n_graph
        n_live = (n0 - int(torch.sum(self._graph_deleted[:n0]))) if self._n_deleted else n0
        if m <= self.merge_insert_max_fraction * max(n_live, 1):
            self._ensure_graph_capacity(n0 + m)
            vectors, adjacency = self.index.vectors, self.index.adjacency
            r = int(adjacency.shape[1])
            # new rows start with random links into the existing graph, so
            # reverse edges can reach them before their wave runs
            _place_rows(vectors, adjacency, n0, vecs, dynamic.random_links(n0, m, r, self.device))
            # fixed-size sub-waves bound the prune intermediates ([W, C, C]
            # + [W, C, D]) whatever the buffer capacity
            wc = self._wave_chunk
            if self.merge_method == "knn":
                self._knn_merge_waves(vectors, adjacency, n0, m, wc)
            else:
                for lo in range(0, m, wc):
                    mm = min(wc, m - lo)
                    wave_ids = torch.arange(n0 + lo, n0 + lo + mm, dtype=torch.int32,
                                            device=self.device)
                    wave_step(
                        vectors, adjacency, self.index.medoid, wave_ids, self.alpha,
                        build_width=self.build_width, max_incoming=min(16, r),
                        chunk=min(8192, mm * r), metric=self.metric,
                        entry_points=self.index.entry_points,
                    )
            self._graph_ext[n0 : n0 + m] = exts.to(torch.int32)
            self._graph_deleted[n0 : n0 + m] = torch.as_tensor(dead, device=self.device)
            self._n_graph = n0 + m
        else:
            from diskrag_tpu_torch.graph.knn_build import build_vamana_knn

            # the rebuild drops every tombstone (graph + dead buffered);
            # only live rows carry over
            keep = ~self._graph_deleted[:n0].cpu().numpy()
            ext0 = self._graph_ext[:n0].cpu().numpy()
            exts_np = exts.cpu().numpy()
            gone = ext0[~keep]
            gone_new = exts_np[dead]
            self._deleted_ext.difference_update(int(e) for e in gone)
            self._deleted_ext.difference_update(int(e) for e in gone_new)
            self._n_deleted -= len(gone) + len(gone_new)
            if len(gone) or len(gone_new):
                # dropping rows shifts every later row: external ids are no
                # longer positional (see rows_compacted in __init__)
                self.rows_compacted = True
            keep_t = torch.as_tensor(keep, device=self.device)
            live_new = torch.as_tensor(~dead, device=self.device)
            all_vecs = torch.cat([self.index.vectors[:n0][keep_t], vecs[live_new]])
            all_ext = np.concatenate([ext0[keep], exts_np[~dead]])
            new_index = build_vamana_knn(
                all_vecs, degree_bound=self.degree_bound, alpha=self.alpha, seed=self.seed,
                metric=self.metric, device=self.device,
            )
            self._adopt_index(new_index, all_ext, None)

    def _knn_merge_waves(self, vectors, adjacency, n0: int, m: int, wc: int) -> None:
        """Exact-kNN bulk insert. Candidates come from one fused int8 flat
        scan per sub-wave over the padded table (`ops.flat_scan.
        flat_search_fused`: B1 + B4 + the f32 rerank on the card) instead of
        a beam search; the scan sees every placed row, so sub-waves need no
        reverse edges to be reachable: forward rows are written for all
        sub-waves first, and the reverse-edge repair runs once per
        `_REVERSE_ROWS` slice at the end. Tombstoned rows take part as
        candidates; `consolidate()` clears them."""
        from diskrag_tpu_torch.ops.flat_scan import flat_search_fused

        r = int(adjacency.shape[1])
        knn_k = max(64, (4 * r) // 3)
        metric = self.metric
        n_used = n0 + m
        marks = self._merge_marks = []

        def lap(stage: str) -> None:
            if self.device.type == "cuda":
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append((stage, ev))
            else:
                marks.append((stage, time.perf_counter()))

        lap("start")
        vec_scan, scan_scales, norms = merge_scan_table(vectors, n_used, metric)
        lap("quantize")
        pruned_slices = []
        for lo in range(0, m, wc):
            mm = min(wc, m - lo)
            wave_ids = torch.arange(n0 + lo, n0 + lo + mm, dtype=torch.int32, device=self.device)
            d, ids = flat_search_fused(
                vectors[n0 + lo : n0 + lo + mm], vec_scan, norms, vectors, k=knn_k + 1,
                metric=metric, rerank_mult=4, n_buckets=4096, db_scales=scan_scales,
            )
            lap("scan")
            _, pruned = _knn_forward_rows(
                vectors, adjacency, wave_ids, ids, d, n_used, self.alpha, metric=metric,
                codes=vec_scan, code_scales=scan_scales,
            )
            pruned_slices.append(pruned)
            lap("forward")
        pruned_all = torch.cat(pruned_slices)
        for lo in range(0, m, _REVERSE_ROWS):
            mm = min(_REVERSE_ROWS, m - lo)
            wave_ids = torch.arange(n0 + lo, n0 + lo + mm, dtype=torch.int32, device=self.device)
            _reverse_pass(
                vectors, adjacency, wave_ids, pruned_all[lo : lo + mm], self.alpha,
                max_incoming=min(16, r), chunk=min(8192, mm * r), metric=metric,
                codes=vec_scan, code_scales=scan_scales,
            )
        lap("reverse")

    def consolidate(self) -> None:
        """Merge the buffer, then compact the graph's tombstones
        (`graph.dynamic.consolidate`: edges into deleted rows are replaced
        by those rows' own out-edges, then rows are refined by build
        waves). The rows refined are the live rows that lost an
        out-neighbour to a tombstone. The JAX package refines a random
        tenth of all rows instead, which leaves most stitched rows
        unrepaired: at 10% of the rows deleted it loses more than 0.01 of
        recall@10 (tests/test_torch_dynamic.py::
        test_consolidate_random_tenth_loses_recall_in_both_packages)."""
        self.merge()
        n0 = self._n_graph
        deleted = self._graph_deleted[:n0]
        n_del = int(torch.sum(deleted))
        if not n_del:
            return
        adj = self.index.adjacency[:n0]
        lost = (adj >= 0) & deleted[torch.clamp(adj, 0, n0 - 1).long()]
        touched = (torch.any(lost, dim=1) & ~deleted).cpu().numpy()
        keep = ~deleted.cpu().numpy()
        # compact over the in-use rows only (the capacity pad would count
        # as deleted rows)
        used = VamanaIndex(
            vectors=self.index.vectors[:n0], adjacency=adj, medoid=self.index.medoid,
            metric=self.metric, entry_points=self.index.entry_points,
        )
        new_index, _ = dynamic.consolidate(
            used, ~keep, build_width=self.build_width, alpha=self.alpha, seed=self.seed,
            refine_rows=np.flatnonzero(touched),
        )
        ext0 = self._graph_ext[:n0].cpu().numpy()
        self._deleted_ext.difference_update(int(e) for e in ext0[~keep])
        self._adopt_index(new_index, ext0[keep], None)
        self._n_deleted -= n_del
        self.rows_compacted = True

    @property
    def last_merge_stage_seconds(self) -> dict | None:
        """Seconds by stage (quantize, scan, forward, reverse) of the last
        kNN merge, None after any other merge. On the card they come from
        CUDA events recorded at the stage boundaries, so the merge itself
        never waits for the device: this read does, for its last event."""
        marks = self._merge_marks
        if marks is None:
            return None
        if self.device.type == "cuda":
            marks[-1][1].synchronize()
        stages = dict.fromkeys(("quantize", "scan", "forward", "reverse"), 0.0)
        for (_, a), (stage, b) in zip(marks, marks[1:]):
            stages[stage] += a.elapsed_time(b) / 1e3 if self.device.type == "cuda" else b - a
        return stages

    # --- search ------------------------------------------------------------------
    def search(self, queries, *, k: int = 10, search_width: int = 32, expand_width: int = 8):
        """Merged search over graph + buffer. Returns (ids, dists) device
        tensors, in EXTERNAL ids; dists are squared L2 under L2 (the
        engine takes the square root at its edge)."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        squeeze = q.ndim == 1
        if squeeze:
            q = q[None, :]
        ids, dists = _search_merged(
            self.index.vectors, self.index.adjacency, self.index.medoid,
            self.index.entry_points, self._graph_ext, self._graph_deleted,
            self._buf, self._buf_ext, self._buf_live, self._count, q,
            search_width=search_width, k=k, expand_width=expand_width, metric=self.metric,
        )
        if squeeze:
            return ids[0], dists[0]
        return ids, dists

    # --- state carried across ------------------------------------------------------
    @classmethod
    def from_state(cls, index: VamanaIndex, state: dict, *, params: dict) -> "StreamingIndex":
        """A tier over an already padded `index` (its tensors at the
        capacity bucket) with the bookkeeping of another tier: `state` holds
        numpy arrays / ints `graph_ext`, `graph_deleted`, `buf`, `buf_ext`,
        `buf_live`, `count`, `n_graph`, `next_ext`, `n_deleted`,
        `deleted_ext`, `rows_compacted`, `n_merges`, `reserve`; `params` the
        constructor's keywords (`buffer_capacity` and the merge settings)."""
        self = cls.__new__(cls)
        dev = index.device
        self.capacity = int(params["buffer_capacity"])
        self._reserve = int(state["reserve"])
        self.merge_insert_max_fraction = params["merge_insert_max_fraction"]
        self._wave_chunk = int(params["wave_chunk"])
        self.merge_method = params["merge_method"]
        self.build_width = params["build_width"]
        self.alpha = params["alpha"]
        self.degree_bound = int(params["degree_bound"])
        self.seed = params["seed"]
        self.metric = index.metric
        self.device = dev
        self.index = index

        def put(name, dtype):
            return torch.as_tensor(np.array(state[name], dtype=dtype), device=dev)

        self._graph_ext = put("graph_ext", np.int32)
        self._graph_deleted = put("graph_deleted", bool)
        self._buf = put("buf", np.float32)
        self._buf_ext = put("buf_ext", np.int32)
        self._buf_live = put("buf_live", bool)
        self._count = int(state["count"])
        self._n_graph = int(state["n_graph"])
        self._next_ext = int(state["next_ext"])
        self._n_deleted = int(state["n_deleted"])
        self._deleted_ext = {int(e) for e in state["deleted_ext"]}
        self.rows_compacted = bool(state["rows_compacted"])
        self.n_merges = int(state["n_merges"])
        self._merge_marks = None
        buf_ext = np.asarray(state["buf_ext"])[: self._count]
        self._buf_ext_host = {int(e): j for j, e in enumerate(buf_ext.tolist())}
        return self

