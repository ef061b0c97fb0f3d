"""Vectorized RobustPrune (alpha-relaxed neighbor pruning), counterpart of
`diskrag_tpu/graph/prune.py`.

Sort candidates by distance to the point; greedily keep the nearest
remaining candidate p*; discard every remaining candidate p' with
    alpha * d(p*, p') <= d(p, p')
and stop at R kept. For a wave of W points at once: the [W, C, C]
candidate-candidate distances from one batched f32 product, then rounds of
masked selection + elimination steered by a host loop; a round run after
every row is done changes nothing, so the "all done?" check (one
synchronisation) is taken every `SYNC_EVERY` rounds only.

The int8 variant (`cand_scales`, used by the reverse-edge repair of the
streaming merge) takes the candidate-candidate distances from int8 codes
with per-row scales (`_pairwise_within_int8`); `gathered_distance_int8` is
its point-to-candidates companion. CUDA has no batched s8 x s8 -> s32
product, so the integer cross term is an f32 `bmm` of the codes, exact
while every partial sum stays below 2^24 (127^2 * D < 2^24, D <= 1040),
taken over column chunks of at most that width and added in int32 past
it: the JAX package's integers, bit for bit.
"""

from __future__ import annotations

import torch

from diskrag_tpu_torch.ops.distance import Metric, squared_norms
from diskrag_tpu_torch.ops.topk import INF, INVALID_ID, mask_duplicates, topk_smallest

# rounds between two "is every row done?" checks (one synchronisation each)
SYNC_EVERY = 2


def _pairwise_within(cand_vecs: torch.Tensor, metric: str) -> torch.Tensor:
    """[W, C, D] -> [W, C, C] pairwise distances among candidates (full
    f32 products)."""
    m = Metric(metric)
    if m == Metric.L2:
        n = squared_norms(cand_vecs)
        cross = torch.bmm(cand_vecs, cand_vecs.transpose(1, 2))
        return torch.clamp_min(n[:, :, None] + n[:, None, :] - 2.0 * cross, 0.0)
    if m == Metric.COSINE:
        vh = cand_vecs * torch.rsqrt(squared_norms(cand_vecs) + 1e-12)[..., None]
        return 1.0 - torch.bmm(vh, vh.transpose(1, 2))
    return -torch.bmm(cand_vecs, cand_vecs.transpose(1, 2))


# widest column chunk whose int8 x int8 partial sums stay exact in f32:
# 127^2 * 1040 < 2^24
_EXACT_D = 1040


def _int8_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 batched product a [W, C, D] x b [W, E, D]^T -> int32
    [W, C, E]: f32 `bmm`s over column chunks of at most `_EXACT_D`,
    converted to int32 and added."""
    out = None
    for d0 in range(0, a.shape[-1], _EXACT_D):
        af = a[..., d0 : d0 + _EXACT_D].to(torch.float32)
        bf = b[..., d0 : d0 + _EXACT_D].to(torch.float32)
        part = torch.bmm(af, bf.transpose(1, 2)).to(torch.int32)
        out = part if out is None else out + part
    return out


def _code_norms(codes: torch.Tensor) -> torch.Tensor:
    """Squared norms of int8 codes [..., D] as exact f32 integers."""
    c = codes.to(torch.float32)
    return torch.sum(c * c, dim=-1)


def gathered_distance_int8(
    q_codes: torch.Tensor,
    q_scales: torch.Tensor,
    codes: torch.Tensor,
    scales: torch.Tensor,
    metric: str,
) -> torch.Tensor:
    """Distance from int8 queries [W, D] (+ [W] scales) to per-row gathered
    int8 candidates [W, C, D] (+ [W, C] scales): the companion of
    `search._gathered_distance` for callers holding the scan's quantized
    copy instead of f32 rows."""
    m = Metric(metric)
    cross_i = _int8_bmm(codes, q_codes[:, None, :])[..., 0]  # [W, C]
    cross = cross_i.to(torch.float32) * q_scales[:, None] * scales
    if m == Metric.L2:
        qn = (_code_norms(q_codes) * (q_scales * q_scales))[:, None]
        cn = _code_norms(codes) * (scales * scales)
        return torch.clamp_min(qn + cn - 2.0 * cross, 0.0)
    if m == Metric.COSINE:
        qn = _code_norms(q_codes)
        cn = _code_norms(codes)
        return 1.0 - cross_i.to(torch.float32) * (
            torch.rsqrt(qn + 1e-12)[:, None] * torch.rsqrt(cn + 1e-12)
        )
    return -cross


def _pairwise_within_int8(
    codes: torch.Tensor, scales: torch.Tensor, metric: str
) -> torch.Tensor:
    """[W, C, D] int8 codes + [W, C] f32 per-row dequant scales -> [W, C, C]
    pairwise distances; the scales enter as a rank-1 outer product, so the
    candidates never materialize in f32 rows of their own."""
    m = Metric(metric)
    cross_i = _int8_bmm(codes, codes)
    ss = scales[:, :, None] * scales[:, None, :]  # [W, C, C]
    cross = cross_i.to(torch.float32) * ss
    if m == Metric.L2:
        n = _code_norms(codes) * (scales * scales)  # [W, C]
        return torch.clamp_min(n[:, :, None] + n[:, None, :] - 2.0 * cross, 0.0)
    if m == Metric.COSINE:
        inv = torch.rsqrt(_code_norms(codes) + 1e-12)  # scales cancel in the cosine
        return 1.0 - cross_i.to(torch.float32) * (inv[:, :, None] * inv[:, None, :])
    return -cross


def robust_prune_batch(
    point_ids: torch.Tensor,
    cand_ids: torch.Tensor,
    cand_vecs: torch.Tensor,
    cand_dists: torch.Tensor,
    alpha: float | torch.Tensor,
    *,
    degree_bound: int,
    metric: str = Metric.L2.value,
    block_size: int = 8,
    cand_scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Prune candidate lists for a wave of points.

    Args:
      point_ids: [W] id of each point being pruned (self-edges removed).
      cand_ids: [W, C] candidate ids, -1 for invalid; duplicates allowed
        (the best occurrence stays).
      cand_vecs: [W, C, D] f32 candidate vectors (garbage rows are fine
        where id = -1); with `cand_scales` [W, C] given, int8 codes
        instead, and the pairwise distances come from
        `_pairwise_within_int8`.
      cand_dists: [W, C] distance from the point to each candidate.
      alpha: pruning relaxation (>= 1.0).
      degree_bound: R, max neighbors kept.
      block_size: candidates considered per sequential round (G). G = 1
        is the strictly sequential selection; G > 1 selects the G closest
        active candidates per round with exact sequential elimination
        within the block. The only deviation from sequential order: a
        candidate outside the current top-G that would have been reached
        after in-block eliminations is picked next round.

    Returns int32[W, degree_bound] pruned neighbor ids, -1 padded, in
    selection order.
    """
    w, c = cand_ids.shape
    dev = cand_ids.device
    g = min(block_size, degree_bound)
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=dev)

    dists = torch.where(cand_ids == point_ids[:, None], INF, cand_dists)
    active_dists = mask_duplicates(cand_ids, dists)
    if cand_scales is not None:
        pair = _pairwise_within_int8(cand_vecs, cand_scales, metric)
    else:
        pair = _pairwise_within(cand_vecs, metric)  # [W, C, C]

    # Worst case one survivor per round (tight clusters eliminate the other
    # G-1 in-block), so up to `degree_bound` rounds; the loop ends as soon
    # as every row has R kept or no active candidate left.
    n_rounds = degree_bound
    col_iota = torch.arange(c, device=dev)
    picks = torch.full((n_rounds, w, g), INVALID_ID, dtype=cand_ids.dtype, device=dev)
    kept = torch.zeros((w,), dtype=torch.int64, device=dev)

    for r in range(n_rounds):
        if r and r % SYNC_EVERY == 0:
            done = (kept >= degree_bound) | torch.all(torch.isinf(active_dists), dim=1)
            if bool(torch.all(done)):
                break
        # G closest active candidates this round
        sel_dist, sel = topk_smallest(active_dists, g)  # [W, G] columns of C
        ok = sel_dist < INF

        # exact sequential elimination within the block
        kept_rows = torch.gather(pair, 1, sel[:, :, None].expand(-1, -1, c))  # [W, G, C]
        bp = torch.gather(kept_rows, 2, sel[:, None, :].expand(-1, g, -1))    # [W, G, G]
        beats = alpha * bp <= sel_dist[:, None, :]  # [W, j, i]: j eliminates i
        surv = ok.clone()
        for i in range(1, g):
            elim_i = torch.any(surv[:, :i] & beats[:, :i, i], dim=1)
            surv[:, i] = surv[:, i] & ~elim_i

        # eliminate: anything dominated by a surviving block member plus
        # the whole selected block (survivors are consumed; in-block
        # rejects were dominated, matching the sequential algorithm)
        dominated = torch.any(
            surv[:, :, None] & (alpha * kept_rows <= active_dists[:, None, :]), dim=1
        )
        picked = torch.any((sel[:, :, None] == col_iota) & ok[:, :, None], dim=1)
        active_dists = torch.where(dominated | picked, INF, active_dists)
        sel_ids = torch.where(surv, torch.gather(cand_ids, 1, sel), INVALID_ID)
        picks[r] = sel_ids
        kept = kept + torch.sum(sel_ids != INVALID_ID, dim=1)

    # picks: [rounds, W, G] in selection order (round-major, in-block
    # ascending). Compact the first `degree_bound` valid entries per row.
    flat = picks.permute(1, 0, 2).reshape(w, n_rounds * g)
    order_key = torch.where(
        flat == INVALID_ID, INF,
        torch.arange(n_rounds * g, dtype=torch.float32, device=dev)[None, :],
    )
    _, take = topk_smallest(order_key, degree_bound)
    return torch.gather(flat, 1, torch.sort(take, dim=1).values)
