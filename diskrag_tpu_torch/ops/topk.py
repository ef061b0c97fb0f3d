"""Top-k / candidate-list primitives (counterpart of
`diskrag_tpu/ops/topk.py`).

Candidate lists are fixed-width sorted tensors with duplicate and invalid
entries masked to +inf. Conventions, as in the JAX package: invalid ids
are -1, masked distances are +inf, lists are ascending by distance.

Every selection here is a stable sort: `jax.lax.top_k` puts the lower
index first among equal values and `torch.topk` promises no order, and
equal distances are common (+inf padding, equal PQ codes), so anything
else returns other ids than the JAX package on the first tie.
"""

from __future__ import annotations

import torch

INF = float("inf")
INVALID_ID = -1

# mask_duplicates compares every pair of a row; rows are walked in chunks
# so that one [rows, K, K] temporary stays under this many elements
_PAIR_ELEMS = 1 << 27


def topk_smallest(dists: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k along the last axis: (values, indices), ascending, the
    lower index first among equal values."""
    vals, idx = torch.sort(dists, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def _mask_duplicates_rows(ids: torch.Tensor, dists: torch.Tensor) -> torch.Tensor:
    k = ids.shape[-1]
    eq = ids[..., :, None] == ids[..., None, :]
    d_i = dists[..., :, None]
    d_j = dists[..., None, :]
    pos = torch.arange(k, device=ids.device)
    # occurrence j beats occurrence i with a smaller dist, or an equal
    # dist and an earlier position
    beats = (d_j < d_i) | ((d_j == d_i) & (pos[None, :] < pos[:, None]))
    dup = torch.any(eq & beats, dim=-1)
    return torch.where(dup | (ids == INVALID_ID), INF, dists)


def mask_duplicates(ids: torch.Tensor, dists: torch.Tensor) -> torch.Tensor:
    """`dists` with duplicate and invalid ids masked to +inf: of each
    distinct id the occurrence with the smallest (dist, position) stays.
    ids, dists: [..., K] -> [..., K]."""
    k = ids.shape[-1]
    if ids.ndim < 2 or ids.numel() * k <= _PAIR_ELEMS:
        return _mask_duplicates_rows(ids, dists)
    flat_i = ids.reshape(-1, k)
    flat_d = dists.reshape(-1, k)
    rows = max(1, _PAIR_ELEMS // (k * k))
    out = [
        _mask_duplicates_rows(flat_i[r : r + rows], flat_d[r : r + rows])
        for r in range(0, flat_i.shape[0], rows)
    ]
    return torch.cat(out).reshape(dists.shape)


def sort_topk_unique(
    ids: torch.Tensor, dists: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k unique entries of one list: (ids [.., k], dists [.., k], take
    [.., k]), ascending; `take` indexes the input's last axis. Slots past
    the valid uniques hold id -1 and dist +inf."""
    masked = mask_duplicates(ids, dists)
    top_d, take = topk_smallest(masked, k)
    top_i = torch.gather(ids, -1, take)
    top_i = torch.where(torch.isinf(top_d), INVALID_ID, top_i)
    return top_i, top_d, take


def merge_topk(
    ids_a: torch.Tensor,
    dists_a: torch.Tensor,
    ids_b: torch.Tensor,
    dists_b: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge two candidate lists into the k best unique entries; `take`
    indexes the concatenated [A + B] axis, so callers can gather payloads
    with `torch.gather(concat_payload, -1, take)`."""
    ids = torch.cat([ids_a, ids_b], dim=-1)
    dists = torch.cat([dists_a, dists_b], dim=-1)
    return sort_topk_unique(ids, dists, k)
