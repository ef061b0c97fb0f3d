"""Approximate medoid (counterpart of `diskrag_tpu/ops/medoid.py`): one
[S, N'] distance matrix and a row sum."""

from __future__ import annotations

import torch

from diskrag_tpu_torch.ops.distance import Metric, pairwise_distance


def approximate_medoid(
    points: torch.Tensor,
    generator: torch.Generator | None = None,
    sample_size: int = 1024,
    target_size: int = 16384,
    metric: Metric | str = Metric.L2,
) -> torch.Tensor:
    """Index (0-d int64 tensor) of the approximate medoid of `points`
    [N, D]: of up to `sample_size` candidate rows, the one with the
    smallest distance sum to up to `target_size` target rows. With N below
    both caps it is the exact medoid and draws nothing. Samples are drawn
    on the host from `generator` (default: seed 0), so a seed gives the
    same medoid on any device."""
    n = points.shape[0]
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    dev = points.device
    if n <= sample_size:
        cand_idx = torch.arange(n, device=dev)
    else:
        cand_idx = torch.randperm(n, generator=generator)[:sample_size].to(dev)
    if n <= target_size:
        targets = points
    else:
        targets = points[torch.randperm(n, generator=generator)[:target_size].to(dev)]
    d = pairwise_distance(points[cand_idx], targets, metric)
    return cand_idx[torch.argmin(torch.sum(d, dim=1))]
