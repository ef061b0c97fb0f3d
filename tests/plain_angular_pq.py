"""Plain reference for the angular deployment served through residual PQ
(ann-benchmarks `glove-100-angular`: word vectors, angular distance,
k = 10), in float64 `torch` operations alone.

- `cosine_topk`: the exact top-k by cosine similarity over the raw,
  unnormalized vectors, as the published benchmark ranks them (angular
  distance 1 - cos; its order is the order of descending cosine).
- `angular_l2sq`: 2 - 2 cos of query and point, the squared L2 distance
  of the two once each is divided by its norm: what a "normalize, then
  L2" index returns, squared.
- `residual_pq_l2sq`: the residual-PQ distance of a query to a point by
  decoding, ||q - c - e||^2 with c the point's coarse centroid and e its
  decoded residual (the codebook entry of each sub-vector's code, in
  subspace order), from the quantizer's centroids and codebooks.

Departures from the published description: the published set is
compared by angle only, with no quantizer; here the points are unit
vectors before they are encoded (the deployment normalizes before it
indexes), and the residual-PQ distance is the squared L2 of the decoded
point, which on unit vectors approximates 2 - 2 cos. Ties in the cosine
top-k go to the lower id (a stable sort), where the published ground
truth leaves them unspecified.

It imports neither JAX nor anything of the JAX package or of the port.
"""

from __future__ import annotations

import numpy as np
import torch


def _f64(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def cosine_topk(points, queries, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(ids int64 [B, k], cosine similarities float64 [B, k]) of the k
    points most similar to each query by cosine, most similar first."""
    p, q = _f64(points), _f64(queries)
    cos = (q / q.norm(dim=1, keepdim=True)) @ (p / p.norm(dim=1, keepdim=True)).T
    order = torch.sort(-cos, dim=1, stable=True).indices[:, :k]
    return order.numpy(), torch.gather(cos, 1, order).numpy()


def angular_l2sq(points, queries, ids) -> np.ndarray:
    """2 - 2 cos(query b, point ids[b, j]), float64 [B, J]."""
    p, q = _f64(points), _f64(queries)
    idx = torch.as_tensor(np.asarray(ids), dtype=torch.int64)
    pn = p[idx] / p[idx].norm(dim=2, keepdim=True)
    qn = q / q.norm(dim=1, keepdim=True)
    return (2.0 - 2.0 * torch.einsum("bd,bjd->bj", qn, pn)).numpy()


def residual_pq_l2sq(queries, ids, *, coarse_centroids, codebooks, codes,
                     coarse_ids) -> np.ndarray:
    """||q_b - c[cell[i]] - e(codes[i])||^2 for each i = ids[b, j], float64
    [B, J]. coarse_centroids [C, D], codebooks [m, 256, D / m], codes
    [N, m] (uint8), coarse_ids [N]."""
    q = _f64(queries)
    idx = torch.as_tensor(np.asarray(ids), dtype=torch.int64)
    cb = _f64(codebooks)
    m, _, ds = cb.shape
    code = torch.as_tensor(np.asarray(codes)).to(torch.int64)[idx]            # [B, J, m]
    residual = cb[torch.arange(m), code].reshape(*idx.shape, m * ds)          # [B, J, D]
    cell = torch.as_tensor(np.asarray(coarse_ids)).to(torch.int64)[idx]
    point = _f64(coarse_centroids)[cell] + residual
    return ((q[:, None, :] - point) ** 2).sum(dim=2).numpy()
