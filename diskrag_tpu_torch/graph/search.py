"""Batched best-first graph search as a fixed-width masked frontier loop
(counterpart of `diskrag_tpu/graph/search.py`).

The candidate list is a sorted fixed-width tensor (ids / dists / expanded
flags); each round does, for a whole batch of queries at once: pick the E
closest unexpanded candidates -> gather their adjacency rows -> score the
neighbors -> mask duplicates -> merge into the top L. Per-query early exit
is masking; the loop ends when every query has converged or at
`max_steps`.

The JAX package runs the loop as `lax.while_loop` on the device. The exact
search on the card runs in two CUDA kernels launched back to back
(`ops/traverse.py`): G2 makes the seeded list, G1 runs the rounds, a block
a query, with no host wait between rounds. Everywhere else
(`_seed_candidates` and `_plain_rounds`: CPU tensors, bf16 vectors, cosine
and dot, shapes past the kernels' limits, the PQ- and int-guided searches)
the host seeds with PyTorch ops and steers the rounds: a Python
loop that asks the device "is any query still active?" once a round (one
synchronisation each) and stops at the first "no", so no round runs past
convergence and the PQ-guided search launches its ADC kernel exactly once
per executed round. Measured on an H100 at 200,000 x 128, asking every 4th
round instead was within the host clock's spread of asking every round.

Every selection is a stable sort (`ops/topk.py`): the lower slot first
among equal distances, as `lax.top_k`.

With tracing on (`utils/profiling.py`) the seeding is a `graph.seed` span
and each loop iteration a `graph.round` span (attribute `step`) made of
`graph.round.select`, `graph.round.sync` (the wait on "is any query still
active?"), `graph.round.expand` and `graph.round.merge`; the counters
`graph.iterations` and `graph.rounds` count the iterations and the rounds
executed (the last iteration stops at its sync). On the kernels the
seeding is G2's launch inside `graph.seed`, the rounds G1's inside one
`graph.traverse` span, and the counters `graph.seed_kernel` and
`graph.traverse_kernel` count the searches each served. The exact rerank
of beam ∪ visited is a `graph.rerank` span (attribute `pool`, its width)
and the counter `graph.rerank_pool` adds B x pool; the PQ-guided rounds count their ADC calls in
`pq.adc_launches` and the (query, candidate) pairs those score in
`pq.adc_ids`. Every count is taken from shapes: none waits on the device.
"""

from __future__ import annotations

import dataclasses

import torch

from diskrag_tpu_torch.ops import traverse
from diskrag_tpu_torch.ops.distance import Metric, pairwise_distance, squared_norms
from diskrag_tpu_torch.ops.topk import INF, INVALID_ID, mask_duplicates, topk_smallest
from diskrag_tpu_torch.utils.profiling import count, span

@dataclasses.dataclass(frozen=True)
class SearchResult:
    """Batched search output.

    ids/dists: [B, k] nearest candidates found (ascending; squared L2 for
    the L2 metric — callers take sqrt at the API edge).
    visited_ids/visited_dists: [B, max_steps * E] log of expanded nodes
    (-1 / +inf padded) — the RobustPrune candidate pool during build.
    n_expanded: [B] number of nodes expanded per query.
    n_steps: 0-d int32, rounds executed (the same for all queries).
    """

    ids: torch.Tensor
    dists: torch.Tensor
    visited_ids: torch.Tensor
    visited_dists: torch.Tensor
    n_expanded: torch.Tensor
    n_steps: torch.Tensor


def _gathered_distance(queries: torch.Tensor, nbr_vecs: torch.Tensor, metric: str) -> torch.Tensor:
    """Distance from queries [B, D] to per-query gathered vectors
    [B, R, D]. With bf16 `nbr_vecs` (the low-bandwidth traversal path) the
    queries are rounded to bf16 too and the contraction accumulates in
    f32: bf16 x bf16 products are exact in f32, so it is taken on f32
    copies."""
    m = Metric(metric)
    q = queries.to(nbr_vecs.dtype).to(torch.float32)
    v = nbr_vecs.to(torch.float32)
    if m == Metric.L2:
        qn = squared_norms(q)[:, None]
        vn = squared_norms(v)
        qv = torch.einsum("bd,brd->br", q, v)
        return torch.clamp_min(qn + vn - 2.0 * qv, 0.0)
    if m == Metric.COSINE:
        low = nbr_vecs.dtype
        qh = (q.to(low) * torch.rsqrt(squared_norms(q) + 1e-12)[:, None].to(low)).to(torch.float32)
        vh = (nbr_vecs * torch.rsqrt(squared_norms(v) + 1e-12)[..., None].to(low)).to(torch.float32)
        return 1.0 - torch.einsum("bd,brd->br", qh, vh)
    return -torch.einsum("bd,brd->br", q, v)


def exact_rerank(
    vectors: torch.Tensor,
    queries: torch.Tensor,
    res: SearchResult,
    k: int,
    metric: str = Metric.L2.value,
) -> SearchResult:
    """Rerank beam ∪ visited with full-precision distances and return the
    exact top-k. Used after bf16 or PQ/ADC traversal."""
    n = vectors.shape[0]
    b, pool = res.ids.shape[0], res.ids.shape[1] + res.visited_ids.shape[1]
    count("graph.rerank_pool", b * pool)
    with span("graph.rerank", pool=pool):
        pool_ids = torch.cat([res.ids, res.visited_ids], dim=1)
        exact = _gathered_distance(
            queries, vectors[torch.clamp(pool_ids, 0, n - 1).long()], metric
        )
        exact = mask_duplicates(pool_ids, torch.where(pool_ids == INVALID_ID, INF, exact))
        top_d, take = topk_smallest(exact, k)
        top_i = torch.gather(pool_ids, 1, take)
        top_i = torch.where(torch.isinf(top_d), INVALID_ID, top_i)
    return dataclasses.replace(res, ids=top_i, dists=top_d)


def _seed_candidates(
    adjacency: torch.Tensor,
    medoid: torch.Tensor,
    seed_expand_fn,
    batch: int,
    *,
    search_width: int,
    entry_points: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The seeded candidate list (ids int32 [B, L], dists f32 [B, L],
    expanded bool [B, L]): the medoid and the `entry_points` (int32[S],
    unique), scored by `seed_expand_fn(seeds [S]) -> [B, S]` (one shared
    [S] gather and a dense [B, S] distance), cut to the L closest; fewer
    than L seeds are padded with id -1 / +inf, unsorted."""
    b = batch
    dev = adjacency.device
    medoid = torch.as_tensor(medoid, device=dev).to(torch.int32)
    with span("graph.seed"):
        if entry_points is None:
            seeds = medoid[None]
        else:
            seeds = torch.cat([medoid[None], entry_points.to(device=dev, dtype=torch.int32)])
        s = seeds.shape[0]
        seeds_b = seeds[None, :].expand(b, s)
        d0 = seed_expand_fn(seeds.long())
        if s > 1:
            # entry_points are unique (the build guarantees it); only the
            # medoid can repeat — mask those copies
            dup_med = (seeds == medoid) & (torch.arange(s, device=dev) > 0)
            d0 = torch.where(dup_med[None, :], INF, d0)
        if s >= search_width:
            cand_dists, take = topk_smallest(d0, search_width)
            cand_ids = torch.gather(seeds_b, 1, take)
            cand_ids = torch.where(torch.isinf(cand_dists), INVALID_ID, cand_ids)
        else:
            pad = search_width - s
            cand_ids = torch.cat(
                [
                    torch.where(torch.isinf(d0), INVALID_ID, seeds_b),
                    torch.full((b, pad), INVALID_ID, dtype=torch.int32, device=dev),
                ],
                dim=1,
            )
            cand_dists = torch.cat(
                [d0, torch.full((b, pad), INF, dtype=torch.float32, device=dev)], dim=1
            )
    return cand_ids, cand_dists, cand_ids == INVALID_ID


def _plain_rounds(
    adjacency: torch.Tensor,
    expand_fn,
    cand_ids: torch.Tensor,
    cand_dists: torch.Tensor,
    expanded: torch.Tensor,
    *,
    k: int,
    max_steps: int,
    expand_width: int = 1,
) -> SearchResult:
    """The best-first rounds from a seeded candidate list, for the whole
    batch at once, one PyTorch op at a time and one host wait a round.
    `expand_fn(ids [B, C] int64, clamped) -> dists [B, C]` supplies the
    distance backend (exact gather-product or PQ/ADC). Also the plain
    version of G1 (`ops/traverse.py`), which runs these rounds in one
    kernel for the exact search on the card.

    `expand_width` (E) expands the E closest unexpanded candidates per
    round instead of 1: about the same expansion budget in E times fewer
    sequential rounds.
    """
    b, search_width = cand_ids.shape
    n, r = adjacency.shape
    e = expand_width
    dev = adjacency.device
    visited_cap = max_steps * e

    visited_ids = torch.full((b, visited_cap), INVALID_ID, dtype=torch.int32, device=dev)
    visited_dists = torch.full((b, visited_cap), INF, dtype=torch.float32, device=dev)
    n_expanded = torch.zeros((b,), dtype=torch.int32, device=dev)
    n_steps = torch.zeros((), dtype=torch.int32, device=dev)

    l_new = min(search_width, e * r)
    slot_iota = torch.arange(search_width, device=dev)
    lower = torch.tril(torch.ones((l_new, l_new), dtype=torch.bool, device=dev), diagonal=-1)
    fresh = torch.zeros((b, l_new), dtype=torch.bool, device=dev)

    for step in range(max_steps):
        with span("graph.round", step=step):
            with span("graph.round.select"):
                frontier = torch.where(expanded | (cand_ids == INVALID_ID), INF, cand_dists)
                # E closest unexpanded candidates this round
                sel_dists, sel_slots = topk_smallest(frontier, e)  # [B, E]
                active = sel_dists < INF
                any_active = torch.any(active)
            # the round's one wait on the device
            with span("graph.round.sync"):
                done = step and not bool(any_active)
            count("graph.iterations")
            if done:
                break
            count("graph.rounds")
            n_steps = n_steps + any_active.to(torch.int32)

            with span("graph.round.expand"):
                cur_ids = torch.gather(cand_ids, 1, sel_slots)
                cur_ids_safe = torch.where(active, cur_ids, 0)

                # mark the selected slots expanded (only where active)
                hit = torch.any(
                    (slot_iota[None, None, :] == sel_slots[:, :, None]) & active[:, :, None],
                    dim=1,
                )
                expanded = expanded | hit

                # log visited (E entries per round)
                visited_ids[:, step * e : (step + 1) * e] = torch.where(active, cur_ids, INVALID_ID)
                visited_dists[:, step * e : (step + 1) * e] = torch.where(active, sel_dists, INF)
                n_expanded = n_expanded + torch.sum(active, dim=1, dtype=torch.int32)

                # expand: gather neighbor ids [B, E, R] -> [B, E*R]; an inactive
                # slot reads row 0 and `valid` masks it
                nbrs = adjacency[cur_ids_safe.long()].reshape(b, e * r)
                valid = (nbrs != INVALID_ID) & active.repeat_interleave(r, dim=1)
                nbr_dists = expand_fn(torch.clamp(nbrs, 0, n - 1).long())
                nbr_dists = torch.where(valid, nbr_dists, INF)

            with span("graph.round.merge"):
                # mask beam-resident duplicates BEFORE the width cut: each one
                # kept past the cut would waste an insertion slot and drop a
                # genuinely new candidate ranked just below it
                on_beam = torch.any(nbrs[:, :, None] == cand_ids[:, None, :], dim=2)
                nbr_dists = torch.where(on_beam, INF, nbr_dists)

                # two-stage merge: cut the E*R fresh candidates down to the L'
                # best — at most L' can enter the list
                sel_new_dists, new_take = topk_smallest(nbr_dists, l_new)
                sel_new_ids = torch.gather(nbrs, 1, new_take)

                # dedup the selected few against the visited log (ids that were on
                # the beam once and got displaced) and against themselves (one
                # neighbor reached from two parents in the same round)
                in_vis = torch.any(sel_new_ids[:, :, None] == visited_ids[:, None, :], dim=2)
                eq = sel_new_ids[:, :, None] == sel_new_ids[:, None, :]
                dup = torch.any(eq & lower, dim=2)
                drop = in_vis | dup | torch.isinf(sel_new_dists)
                sel_new_dists = torch.where(drop, INF, sel_new_dists)
                sel_new_ids = torch.where(drop, INVALID_ID, sel_new_ids)

                # final merge: [L + L'] -> top L (both parts unique and disjoint)
                all_ids = torch.cat([cand_ids, sel_new_ids], dim=1)
                all_dists = torch.cat([cand_dists, sel_new_dists], dim=1)
                all_exp = torch.cat([expanded, fresh], dim=1)
                cand_dists, take = topk_smallest(all_dists, search_width)
                cand_ids = torch.gather(all_ids, 1, take)
                cand_ids = torch.where(torch.isinf(cand_dists), INVALID_ID, cand_ids)
                expanded = torch.gather(all_exp, 1, take) | (cand_ids == INVALID_ID)

    return SearchResult(
        ids=cand_ids[:, :k],
        dists=cand_dists[:, :k],
        visited_ids=visited_ids,
        visited_dists=visited_dists,
        n_expanded=n_expanded,
        n_steps=n_steps,
    )


def _frontier_search(
    adjacency: torch.Tensor,
    medoid: torch.Tensor,
    expand_fn,
    seed_expand_fn,
    batch: int,
    *,
    search_width: int,
    k: int,
    max_steps: int,
    expand_width: int = 1,
    entry_points: torch.Tensor | None = None,
) -> SearchResult:
    """Shared best-first loop: `_seed_candidates` (seeds scored by
    `seed_expand_fn`), then `_plain_rounds` (candidates by `expand_fn`)."""
    seeded = _seed_candidates(adjacency, medoid, seed_expand_fn, batch,
                              search_width=search_width, entry_points=entry_points)
    return _plain_rounds(adjacency, expand_fn, *seeded, k=k, max_steps=max_steps,
                         expand_width=expand_width)


def _default_steps(search_width: int, expand_width: int, k: int, max_steps: int | None) -> int:
    if k > search_width:
        raise ValueError(f"k={k} must be <= search_width={search_width}")
    if max_steps is None:
        max_steps = -(-2 * search_width // expand_width)
    return max_steps


def beam_search(
    vectors: torch.Tensor,
    adjacency: torch.Tensor,
    medoid: torch.Tensor,
    queries: torch.Tensor,
    *,
    search_width: int,
    k: int,
    max_steps: int | None = None,
    metric: str = Metric.L2.value,
    expand_width: int = 1,
    entry_points: torch.Tensor | None = None,
) -> SearchResult:
    """Batched best-first graph search with exact distances.

    Where `ops.traverse.refusal` finds nothing against the inputs (CUDA f32
    vectors, L2, the kernels' limits on D, L, E x R and max_steps x E) the
    search runs on two kernels launched back to back (`ops/traverse.py`):
    G2 makes the seeded list, G1 runs every round from it. Else
    `_seed_candidates` seeds and `_plain_rounds` runs the rounds.

    Args:
      vectors: [N, D] database vectors (f32, or bf16 for the low-bandwidth
        traversal of `beam_search_reranked`).
      adjacency: [N, R] int32 neighbor ids, -1 padded.
      medoid: 0-d int32 entry point.
      queries: [B, D] query batch.
      search_width: candidate-list size L (larger = better recall, more
        work).
      k: number of results to return (k <= search_width).
      max_steps: hard bound on expansion rounds; defaults to
        ceil(2 * search_width / expand_width).
      expand_width: candidates expanded per round (1 is strictly
        best-first).
    """
    max_steps = _default_steps(search_width, expand_width, k, max_steps)
    if traverse.refusal(vectors, adjacency, queries, search_width=search_width,
                        expand_width=expand_width, max_steps=max_steps, metric=metric) is None:
        ids, dists, *log = traverse.seed_and_traverse(
            vectors, adjacency, queries, medoid, entry_points, search_width=search_width,
            expand_width=expand_width, max_steps=max_steps)
        return SearchResult(ids[:, :k], dists[:, :k], *log)

    def expand(ids):
        return _gathered_distance(queries, vectors[ids], metric)

    def seed_expand(seeds):
        seed_vecs = vectors[seeds].to(torch.float32)  # one shared gather
        return pairwise_distance(queries, seed_vecs, metric).to(torch.float32)

    return _frontier_search(
        adjacency, medoid, expand, seed_expand, queries.shape[0],
        search_width=search_width, k=k, max_steps=max_steps,
        expand_width=expand_width, entry_points=entry_points,
    )


def beam_search_reranked(
    traversal_vectors: torch.Tensor,
    rerank_vectors: torch.Tensor,
    adjacency: torch.Tensor,
    medoid: torch.Tensor,
    queries: torch.Tensor,
    *,
    search_width: int,
    k: int,
    max_steps: int | None = None,
    metric: str = Metric.L2.value,
    expand_width: int = 1,
    entry_points: torch.Tensor | None = None,
) -> SearchResult:
    """Low-bandwidth traversal + full-precision rerank:
    `traversal_vectors` is typically a bf16 copy of the database (half the
    gather bytes in the frontier loop), `rerank_vectors` the f32 original.
    The final beam ∪ visited pool is reranked exactly."""
    res = beam_search(
        traversal_vectors, adjacency, medoid, queries,
        search_width=search_width, k=search_width, max_steps=max_steps,
        metric=metric, expand_width=expand_width, entry_points=entry_points,
    )
    return exact_rerank(rerank_vectors, queries, res, k, metric)


def beam_search_pq(
    codes: torch.Tensor,
    tables: torch.Tensor,
    adjacency: torch.Tensor,
    medoid: torch.Tensor,
    *,
    search_width: int,
    k: int,
    max_steps: int | None = None,
    rerank: bool = True,
    vectors: torch.Tensor | None = None,
    queries: torch.Tensor | None = None,
    metric: str = Metric.L2.value,
    expand_width: int = 1,
    entry_points: torch.Tensor | None = None,
    point_cell: torch.Tensor | None = None,
    point_bias: torch.Tensor | None = None,
    cell_tables: torch.Tensor | None = None,
) -> SearchResult:
    """PQ-accelerated graph search: traversal guided purely by ADC
    distances looked up from per-query tables; optionally the final beam ∪
    visited pool is reranked with exact distances.

    Every round's distance step is one call of
    `ops.pq_scan.adc_lookup_ids_kernel`: the CUDA kernel B5 for tensors on
    the card (one launch per executed round: the code gather, the lookup
    and, for a residual PQ, the cell and bias terms), its plain version for
    CPU tensors, which composes the same steps as the JAX package's
    `expand`. The seed scoring is a shared-code lookup (`adc_lookup`) in
    plain PyTorch, as in the JAX package.

    Args:
      codes: uint8 [N, m] PQ codes (m bytes gathered per neighbor instead
        of 4*D).
      tables: [B, m, 256] per-query ADC tables. For a ResidualPQ pass the
        inner tables (`rpq.inner_tables(q)`) plus the three aux operands.
      adjacency / medoid: graph.
      rerank: if True, `vectors` [N, D] and `queries` [B, D] must be given;
        the returned ids/dists are the exact top-k of the pool.
      point_cell / point_bias / cell_tables: residual-PQ aux — coarse cell
        id int32 [N], per-point bias f32 [N], per-query cell cross terms
        [B, C]; all three together.
    """
    from diskrag_tpu_torch.ops.pq_scan import adc_lookup_ids_kernel
    from diskrag_tpu_torch.pq.product_quantizer import adc_lookup

    max_steps = _default_steps(search_width, expand_width, k, max_steps)
    residual = point_cell is not None
    if residual and (point_bias is None or cell_tables is None):
        raise ValueError("point_cell/point_bias/cell_tables must be given together")
    b = tables.shape[0]
    tables = tables.contiguous()
    # the kernel's operand types, once a search rather than once a round
    aux = {}
    if residual:
        aux = {"point_cell": point_cell.to(torch.int32).contiguous(),
               "point_bias": point_bias.to(torch.float32).contiguous(),
               "cell_tables": cell_tables.to(torch.float32).contiguous()}

    def expand(ids):
        count("pq.adc_launches")
        count("pq.adc_ids", ids.shape[0] * ids.shape[1])
        return adc_lookup_ids_kernel(tables, codes, ids, **aux)

    def _seed_scores(seeds):
        d = adc_lookup(tables, codes[seeds])  # one shared code gather
        if residual:
            d = d + cell_tables[:, point_cell[seeds].long()] + point_bias[seeds][None, :]
        return d

    def seed_expand(seeds):
        # the shared lookup materializes [B, m, S] f32; walked in tiles of
        # 4096 seeds so the transient stays [B, m, 4096] however many
        # entry points the index carries
        ch = 4096
        if seeds.shape[0] <= ch:
            return _seed_scores(seeds)
        return torch.cat(
            [_seed_scores(seeds[s0 : s0 + ch]) for s0 in range(0, seeds.shape[0], ch)], dim=1
        )

    res = _frontier_search(
        adjacency, medoid, expand, seed_expand, b,
        search_width=search_width, k=search_width, max_steps=max_steps,
        expand_width=expand_width, entry_points=entry_points,
    )
    if not rerank:
        return dataclasses.replace(res, ids=res.ids[:, :k], dists=res.dists[:, :k])
    if vectors is None or queries is None:
        raise ValueError("rerank=True requires vectors and queries")
    # rerank pool = final beam ∪ visited log: ADC noise evicts true
    # neighbors from the beam, but anything ever expanded is recoverable
    # from the visited log at the cost of one more gather
    return exact_rerank(vectors, queries, res, k, metric)


def beam_search_iq(
    rows: torch.Tensor,
    tables,
    adjacency: torch.Tensor,
    medoid: torch.Tensor,
    *,
    dim: int,
    bits: int,
    n_cells: int,
    search_width: int,
    k: int,
    max_steps: int | None = None,
    rerank: bool = True,
    vectors: torch.Tensor | None = None,
    queries: torch.Tensor | None = None,
    metric: str = Metric.L2.value,
    expand_width: int = 1,
    entry_points: torch.Tensor | None = None,
) -> SearchResult:
    """Int-quantized graph search: traversal guided by int8 / int4 rows
    (`pq/intq.py`), optionally an exact rerank of beam ∪ visited.

    A candidate costs one row gather and its share of one [B, Cand, D]
    product, both plain PyTorch: the JAX package scores these rows outside
    Pallas too, so no kernel of the port serves this search.

    Args:
      rows: int8 [N, W] encoded rows (`IntQuantizer.encode`; trailing pad
        lanes allowed).
      tables: `IQTables` from `IntQuantizer.query_tables(queries)`.
      dim / bits / n_cells: the quantizer's geometry.
    """
    from diskrag_tpu_torch.pq.intq import iq_score_gathered, iq_score_shared

    max_steps = _default_steps(search_width, expand_width, k, max_steps)
    b = tables.qw.shape[0]

    def expand(ids):
        return iq_score_gathered(tables, rows[ids], dim=dim, bits=bits, n_cells=n_cells)

    def seed_expand(seeds):
        return iq_score_shared(tables, rows[seeds], dim=dim, bits=bits, n_cells=n_cells)

    res = _frontier_search(
        adjacency, medoid, expand, seed_expand, b,
        search_width=search_width, k=search_width, max_steps=max_steps,
        expand_width=expand_width, entry_points=entry_points,
    )
    if not rerank:
        return dataclasses.replace(res, ids=res.ids[:, :k], dists=res.dists[:, :k])
    if vectors is None or queries is None:
        raise ValueError("rerank=True requires vectors and queries")
    return exact_rerank(vectors, queries, res, k, metric)
