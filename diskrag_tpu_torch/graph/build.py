"""Wave-batched Vamana construction (counterpart of
`diskrag_tpu/graph/build.py`).

Points are inserted in waves of W at a time: a batched beam search of the
whole wave against the pre-wave graph, a vectorized RobustPrune of the
wave, a write of the new out-edges, and a grouped reverse-edge repair
(union, or re-prune where the union overflows the degree bound). The graph
starts random-R-regular over all points, so every wave sees a connected
graph; two passes (alpha 1.0, then the caller's alpha) give Vamana
quality. Wave batching changes the exact edge set against sequential
insertion; the bar is recall at equal R / L / alpha.

The random draws (the initial links, the entry points and each pass's
permutation) come from a `torch.Generator`, not from the JAX package's
keys, so a graph built here is another graph; `wave_step` and
`_reverse_edges` are deterministic and return the JAX package's rows on
the same inputs, up to near-ties of f32 distances.

One deliberate difference: `build_vamana` seeds every wave's beam search,
and the index it returns, with well-spread entry points (k-means cell
centres snapped to points, `knn_build.compute_entry_points`), as the
kNN-based build does. The JAX package's wave build starts every search at
the medoid alone, and on clustered data whole clusters stay out of reach:
at 4096 points of `make_dataset` (d = 128, R = 20, L = 48) its graph
reaches recall@10 0.6355 at L = 48, the port's without entry points
0.6175, with them 0.9955 (`tests/test_torch_wave_build.py::
test_medoid_only_wave_build_collapses_in_both_packages`).

`adjacency` is updated in place by `wave_step` and `_reverse_edges` (the
JAX functions donate it): callers that keep the old graph pass a copy.
"""

from __future__ import annotations

import logging
import time

import torch

from diskrag_tpu_torch.device import resolve_device
from diskrag_tpu_torch.graph.prune import gathered_distance_int8, robust_prune_batch
from diskrag_tpu_torch.graph.search import _gathered_distance, beam_search
from diskrag_tpu_torch.graph.types import VamanaIndex
from diskrag_tpu_torch.ops.distance import Metric
from diskrag_tpu_torch.ops.medoid import approximate_medoid
from diskrag_tpu_torch.ops.topk import INF, INVALID_ID, mask_duplicates, sort_topk_unique, topk_smallest

logger = logging.getLogger(__name__)

_INT32_MAX = 2**31 - 1


def random_regular_init(generator: torch.Generator, n: int, degree_bound: int) -> torch.Tensor:
    """Random initial adjacency int32 [n, degree_bound] on the generator's
    device, no self-loops ((row + 1 + u) mod n, u uniform in [0, n - 1));
    duplicates are possible but rare, and the adjacency has set semantics
    downstream."""
    u = torch.randint(0, max(n - 1, 1), (n, degree_bound), generator=generator,
                      device=generator.device)
    ids = torch.arange(n, device=generator.device)[:, None]
    return ((ids + 1 + u) % n).to(torch.int32)


def _fix_targets(vectors, adjacency, t_chunk, inc_chunk, alpha, *, metric, codes, code_scales):
    """New rows for one chunk of reverse-edge targets: the union of the
    old row and the incoming sources, RobustPruned where it holds more
    than R distinct ids."""
    n, r = adjacency.shape
    t_safe = torch.clamp(t_chunk, 0, n - 1).long()
    old = adjacency[t_safe]  # [CH, R]
    cands = torch.cat([old, inc_chunk], dim=1)  # [CH, R + K]
    cands = torch.where(t_chunk[:, None] == INVALID_ID, INVALID_ID, cands)
    c_safe = torch.clamp(cands, 0, n - 1).long()
    if codes is not None:
        cand_vecs = codes[c_safe]  # [CH, C2, D] int8
        cand_sc = code_scales[c_safe]
        dists = gathered_distance_int8(codes[t_safe], code_scales[t_safe], cand_vecs, cand_sc,
                                       metric)
    else:
        cand_vecs = vectors[c_safe]
        cand_sc = None
        dists = _gathered_distance(vectors[t_safe], cand_vecs, metric)
    dists = torch.where(cands == INVALID_ID, INF, dists)
    union_ids, _, _ = sort_topk_unique(cands, dists, r)
    n_unique = torch.sum(torch.isfinite(mask_duplicates(cands, dists)), dim=1)
    pruned = robust_prune_batch(
        t_chunk, cands, cand_vecs, dists, alpha, degree_bound=r, metric=metric,
        cand_scales=cand_sc,
    )
    return torch.where((n_unique > r)[:, None], pruned, union_ids)


def _reverse_edges(
    vectors: torch.Tensor,
    adjacency: torch.Tensor,
    wave_ids: torch.Tensor,
    pruned: torch.Tensor,
    alpha: float | torch.Tensor,
    *,
    max_incoming: int,
    chunk: int,
    metric: str,
    codes: torch.Tensor | None = None,
    code_scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Insert reverse edges wave -> graph with conditional re-prune.

    Every new edge (p -> t) of `pruned` makes p a candidate in-neighbor of
    t. Edges are grouped by target with one stable sort; each target keeps
    at most `max_incoming` new in-edges per wave (in source order). Where
    old-union-new exceeds the degree bound the target is RobustPruned,
    otherwise the plain union is written back. `codes` / `code_scales`
    ([N, D] int8 + [N] f32, the merge scan's quantized copy): the target
    and candidate gathers and every prune distance then run on the int8
    codes. The grouping runs on the device; the chunks of live targets are
    walked by a host loop bounded by one read of their count. Updates
    `adjacency` in place and returns it."""
    n, r = adjacency.shape
    w = wave_ids.shape[0]
    e = w * r
    dev = adjacency.device

    targets = pruned.reshape(-1)
    sources = wave_ids.to(torch.int32).repeat_interleave(r)
    sort_key = torch.where(targets != INVALID_ID, targets, _INT32_MAX)
    order = torch.argsort(sort_key, stable=True)
    t_s = sort_key[order]
    s_s = sources[order]
    v_s = t_s != _INT32_MAX

    is_first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), t_s[1:] != t_s[:-1]]) & v_s
    seg_id = torch.cumsum(is_first.to(torch.int32), 0) - 1
    pos = torch.arange(e, dtype=torch.int32, device=dev)
    # slot s holds the position of segment s's first edge (segments are
    # contiguous runs of the sorted edges); unused slots hold e
    start = torch.full((e,), e, dtype=torch.int32, device=dev)
    start[seg_id[is_first].long()] = pos[is_first]
    n_seg = int(torch.sum(is_first))  # the one read that bounds the host loop
    n_valid = torch.sum(v_s.to(torch.int32))
    slot = pos
    live_slot = slot < n_seg
    start_c = torch.clamp(start, 0, e - 1).long()
    uniq_t = torch.where(live_slot, t_s[start_c], INVALID_ID)
    seg_end = torch.where(slot + 1 < n_seg, start[torch.clamp(slot + 1, 0, e - 1).long()], n_valid)
    take_pos = start_c[:, None] + torch.arange(max_incoming, device=dev)[None, :]  # [E, K]
    in_seg = live_slot[:, None] & (take_pos < seg_end[:, None])
    inc = torch.where(in_seg, s_s[torch.clamp(take_pos, 0, e - 1)], INVALID_ID)

    # live targets are compacted at the front (seg_id is dense): chunks
    # past ceil(n_seg / chunk) hold no target and are never run. A
    # target's row is read only by its own chunk, so writing each chunk
    # back at once leaves the later chunks' reads unchanged.
    for lo in range(0, n_seg, chunk):
        hi = min(lo + chunk, n_seg)
        t_chunk = uniq_t[lo:hi]
        rows = _fix_targets(vectors, adjacency, t_chunk, inc[lo:hi], alpha, metric=metric,
                            codes=codes, code_scales=code_scales)
        adjacency[t_chunk.long()] = rows.to(adjacency.dtype)
    return adjacency


def wave_step(
    vectors: torch.Tensor,
    adjacency: torch.Tensor,
    medoid: torch.Tensor,
    wave_ids: torch.Tensor,
    alpha: float | torch.Tensor,
    *,
    build_width: int,
    max_incoming: int,
    chunk: int,
    metric: str,
    expand_width: int = 8,
    entry_points: torch.Tensor | None = None,
) -> torch.Tensor:
    """Insert or refine one wave of points; updates `adjacency` in place
    and returns it. `entry_points` seed the wave's beam search besides the
    medoid (None: the medoid alone, the JAX function's search)."""
    n, r = adjacency.shape
    rows = wave_ids.long()
    queries = vectors[rows]

    res = beam_search(
        vectors, adjacency, medoid, queries,
        search_width=build_width, k=build_width, metric=metric, expand_width=expand_width,
        entry_points=entry_points,
    )

    cur_nbrs = adjacency[rows]  # [W, R]
    cur_vecs = vectors[torch.clamp(cur_nbrs, 0, n - 1).long()]
    cur_dists = torch.where(cur_nbrs == INVALID_ID, INF,
                            _gathered_distance(queries, cur_vecs, metric))

    pool_ids = torch.cat([res.visited_ids.to(torch.int32), res.ids.to(torch.int32), cur_nbrs], dim=1)
    pool_dists = torch.cat([res.visited_dists, res.dists, cur_dists], dim=1)
    # cap the prune pool at the closest `pool_cap` unique candidates: the
    # O(C^2) pairwise tensor dominates the prune, and far candidates never
    # survive RobustPrune
    pool_cap = min(pool_ids.shape[1], max(2 * build_width, 4 * r))
    pool_dists, take = topk_smallest(mask_duplicates(pool_ids, pool_dists), pool_cap)
    pool_ids = torch.gather(pool_ids, 1, take)
    pool_vecs = vectors[torch.clamp(pool_ids, 0, n - 1).long()]

    pruned = robust_prune_batch(
        wave_ids, pool_ids, pool_vecs, pool_dists, alpha, degree_bound=r, metric=metric,
    ).to(adjacency.dtype)
    adjacency[rows] = pruned
    return _reverse_edges(
        vectors, adjacency, wave_ids, pruned, alpha,
        max_incoming=max_incoming, chunk=chunk, metric=metric,
    )


def build_vamana(
    vectors,
    *,
    degree_bound: int = 32,
    build_width: int = 64,
    alpha: float = 1.2,
    metric: str = Metric.L2.value,
    n_passes: int = 2,
    wave_size: int | None = None,
    max_incoming: int | None = None,
    expand_width: int = 8,
    seed: int = 0,
    progress: bool = False,
    device: str | torch.device = "cuda",
) -> VamanaIndex:
    """Build a Vamana index by wave insertion: `n_passes` passes over a
    random order, alpha 1.0 for all but the last, which takes `alpha`.
    degree_bound is R, build_width L. min(65536, N/64) well-spread entry
    points (as `build_vamana_knn` takes by default) start every wave's
    search and are stored on the index."""
    from diskrag_tpu_torch.graph.knn_build import compute_entry_points

    dev = resolve_device(device)
    vectors = torch.as_tensor(vectors, dtype=torch.float32, device=dev)
    n = vectors.shape[0]
    if n < 2:
        raise ValueError("need at least 2 points")
    degree_bound = min(degree_bound, n - 1)
    if wave_size is None:
        wave_size = int(min(2048, max(32, n // 8)))
    wave_size = min(wave_size, n)
    if max_incoming is None:
        max_incoming = min(16, degree_bound)
    chunk = min(16384, wave_size * degree_bound)
    metric = Metric(metric).value

    n_entry_points = min(65_536, n // 64)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    adjacency = random_regular_init(gen, n, degree_bound)
    medoid = approximate_medoid(
        vectors, torch.Generator().manual_seed(int(seed)), metric=metric
    ).to(torch.int32)
    entry_points = None
    if n_entry_points > 1:
        eps = compute_entry_points(vectors, n_entry_points, gen, metric=metric)
        eps = eps[eps != int(medoid)]
        if eps.size > 1:
            entry_points = torch.as_tensor(eps, dtype=torch.int32, device=dev)

    alphas = [1.0] * (n_passes - 1) + [float(alpha)]
    t0 = time.perf_counter()
    for pass_idx, a in enumerate(alphas):
        perm = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
        pad = (-n) % wave_size
        if pad:
            perm = torch.cat([perm, perm[:pad]])
        waves = perm.reshape(-1, wave_size)
        for i in range(waves.shape[0]):
            adjacency = wave_step(
                vectors, adjacency, medoid, waves[i], a,
                build_width=build_width, max_incoming=max_incoming, chunk=chunk,
                metric=metric, expand_width=expand_width, entry_points=entry_points,
            )
            if progress and (i + 1) % 16 == 0:
                logger.info("pass %d/%d wave %d/%d (%.1fs)", pass_idx + 1, len(alphas), i + 1,
                            waves.shape[0], time.perf_counter() - t0)
    if progress:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        logger.info("build done in %.1fs", time.perf_counter() - t0)
    return VamanaIndex(vectors=vectors, adjacency=adjacency, medoid=medoid, metric=metric,
                       entry_points=entry_points)
