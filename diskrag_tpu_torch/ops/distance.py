"""Batched distances and exact top-k (counterpart of
`diskrag_tpu/ops/distance.py`).

Same conventions as the JAX package: L2 is the squared euclidean
distance, cosine is 1 - cosine similarity, dot is the negated inner
product; every top-k returns ascending distances and breaks ties by the
lower index, as `jax.lax.top_k` does. `torch.topk` promises no order on
ties, so the exact selections here use a stable sort instead.
"""

from __future__ import annotations

import enum

import torch


class Metric(str, enum.Enum):
    """Distance metric; values match the JAX package's."""

    L2 = "l2"
    COSINE = "cosine"
    DOT = "dot"


def squared_norms(x: torch.Tensor) -> torch.Tensor:
    """Row-wise squared L2 norms. x: [..., D] -> [...]."""
    return torch.sum(x * x, dim=-1)


def pairwise_l2_sq(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise squared L2 in matmul form, [M, N], clamped at 0."""
    d = squared_norms(x)[:, None] + squared_norms(y)[None, :] - 2.0 * (x @ y.T)
    return torch.clamp_min(d, 0.0)


def pairwise_cosine_distance(
    x: torch.Tensor, y: torch.Tensor, eps: float = 1e-12
) -> torch.Tensor:
    """Pairwise cosine distance (1 - cosine similarity), [M, N]."""
    xn = x * torch.rsqrt(squared_norms(x) + eps)[:, None]
    yn = y * torch.rsqrt(squared_norms(y) + eps)[:, None]
    return 1.0 - xn @ yn.T


def pairwise_dot_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Negative inner product as a distance, [M, N]."""
    return -(x @ y.T)


def pairwise_distance(
    x: torch.Tensor, y: torch.Tensor, metric: Metric | str = Metric.L2
) -> torch.Tensor:
    metric = Metric(metric)
    if metric == Metric.L2:
        return pairwise_l2_sq(x, y)
    if metric == Metric.COSINE:
        return pairwise_cosine_distance(x, y)
    return pairwise_dot_distance(x, y)


def query_point_distance(
    query: torch.Tensor, points: torch.Tensor, metric: Metric | str = Metric.L2
) -> torch.Tensor:
    """Distances from one query [D] to points [K, D] -> [K]."""
    return pairwise_distance(query[None, :], points, metric)[0]


def smallest_k(
    d: torch.Tensor, k: int, ids: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest entries of each row of `d` [B, M], ascending, ties
    to the lower column (a stable sort). Returns (values, columns), or
    (values, ids gathered at those columns) when `ids` is given."""
    vals, cols = torch.sort(d, dim=1, stable=True)
    vals, cols = vals[:, :k], cols[:, :k]
    if ids is not None:
        return vals, torch.gather(ids, 1, cols)
    return vals, cols


def exact_topk_tiled(
    queries: torch.Tensor,
    points: torch.Tensor,
    k: int,
    metric: Metric | str = Metric.L2,
    *,
    tile: int = 65_536,
    query_block: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by full distances, tiled over the database so no
    [B, N] matrix is ever held: per tile the k smallest (stable), merged
    with the running best. Running ids all precede the tile's, so the
    stable merge keeps the lower id first on ties — the same answer as
    one `lax.top_k` over the whole row."""
    b = queries.shape[0]
    n = points.shape[0]
    k_eff = min(k, n)
    out_d, out_i = [], []
    for q0 in range(0, b, query_block):
        q = queries[q0 : q0 + query_block]
        best_d = torch.empty((q.shape[0], 0), dtype=torch.float32, device=q.device)
        best_i = torch.empty((q.shape[0], 0), dtype=torch.int64, device=q.device)
        for t0 in range(0, n, tile):
            d = pairwise_distance(q, points[t0 : t0 + tile], metric)
            td, ti = smallest_k(d, k_eff)
            cat_d = torch.cat([best_d, td], dim=1)
            cat_i = torch.cat([best_i, ti + t0], dim=1)
            best_d, best_i = smallest_k(cat_d, k_eff, cat_i)
        out_d.append(best_d)
        out_i.append(best_i)
    return torch.cat(out_d), torch.cat(out_i).to(torch.int32)


def brute_force_topk(
    queries: torch.Tensor,
    points: torch.Tensor,
    k: int,
    metric: Metric | str = Metric.L2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k nearest neighbours: (dists [B, k], ids [B, k] int32)."""
    return exact_topk_tiled(queries, points, k, metric)


def rerank_exact_topk(
    queries: torch.Tensor,
    vectors_f32: torch.Tensor,
    cand_ids: torch.Tensor,
    k: int,
    metric: str | Metric = Metric.L2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact f32 rerank of gathered candidates (JAX `distance.py:118-150`):
    gathers `vectors_f32[cand_ids]` [B, kk, D], computes the exact metric
    (difference-form L2, 1 - cos on normalized copies, negated dot), masks
    id -1 to +inf, returns the ascending top-k (dists, ids)."""
    m = Metric(metric)
    n = vectors_f32.shape[0]
    cand = vectors_f32[torch.clamp(cand_ids.long(), 0, n - 1)]  # [B, kk, D]
    if m == Metric.L2:
        diff = cand - queries[:, None, :]
        exact = torch.sum(diff * diff, dim=-1)
    elif m == Metric.COSINE:
        qh = queries / (torch.linalg.vector_norm(queries, dim=-1, keepdim=True) + 1e-12)
        ch = cand / (torch.linalg.vector_norm(cand, dim=-1, keepdim=True) + 1e-12)
        exact = 1.0 - torch.einsum("bd,bkd->bk", qh, ch)
    else:
        exact = -torch.einsum("bd,bkd->bk", queries, cand)
    exact = torch.where(cand_ids == -1, torch.inf, exact)
    return smallest_k(exact, k, cand_ids)
