"""Distances, top-k primitives, the fused flat scans (kernels B1-B4, B6), the
flat index and the gathered ADC lookup (kernel B5).

The package exports the JAX package's `diskrag_tpu.ops` names. Importing it
builds no kernel: the kernels' modules (`flat_scan`, `pq_scan`, `mm_probe`)
are imported by name, and build their libraries at first launch.
"""

from diskrag_tpu_torch.ops.distance import (
    Metric,
    brute_force_topk,
    pairwise_cosine_distance,
    pairwise_distance,
    pairwise_l2_sq,
    query_point_distance,
    squared_norms,
)
from diskrag_tpu_torch.ops.medoid import approximate_medoid
from diskrag_tpu_torch.ops.topk import mask_duplicates, merge_topk, topk_smallest

__all__ = [
    "Metric",
    "brute_force_topk",
    "pairwise_l2_sq",
    "pairwise_cosine_distance",
    "pairwise_distance",
    "query_point_distance",
    "squared_norms",
    "topk_smallest",
    "merge_topk",
    "mask_duplicates",
    "approximate_medoid",
]
