"""Benchmark helpers — part of `diskrag_tpu/benchmark.py`: the seeded
dataset (numpy, byte-identical to the JAX package's), recall@k, and an
exact tiled ground-truth oracle in PyTorch. A test and smoke tool, not on
the search path.
"""

from __future__ import annotations

import numpy as np
import torch

from diskrag_tpu_torch.device import resolve_device


def make_dataset(
    n: int, dim: int, n_queries: int, seed: int = 42, n_clusters: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Seeded clustered dataset + queries (perturbed database points)."""
    rng = np.random.default_rng(seed)
    if n_clusters is None:
        n_clusters = max(16, n // 1000)
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32) * 4.0
    assign = rng.integers(0, n_clusters, size=n)
    pts = centers[assign] + rng.normal(size=(n, dim)).astype(np.float32)
    qi = rng.integers(0, n, size=n_queries)
    queries = pts[qi] + rng.normal(size=(n_queries, dim)).astype(np.float32) * 0.3
    return pts, queries


def recall_at_k(got_ids: np.ndarray, gt_ids: np.ndarray, k: int) -> float:
    return float(
        np.mean(
            [
                len(set(got_ids[i, :k].tolist()) & set(gt_ids[i, :k].tolist())) / k
                for i in range(len(got_ids))
            ]
        )
    )


def ground_truth(
    points: np.ndarray | torch.Tensor,
    queries: np.ndarray | torch.Tensor,
    k: int,
    metric: str = "l2",
    *,
    device: str = "cuda",
) -> np.ndarray:
    """Exact top-k ids [B, k]: f32 distances, one pass over 65,536-row
    tiles with an exact per-tile top-k merged into the running best."""
    from diskrag_tpu_torch.ops.distance import exact_topk_tiled

    dev = resolve_device(device)
    pts = torch.as_tensor(points, dtype=torch.float32, device=dev)
    q = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    _, ids = exact_topk_tiled(q, pts, k, metric, query_block=1024)
    return ids.cpu().numpy()
