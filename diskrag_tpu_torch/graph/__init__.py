"""Vamana graph: build + search on dense tensors (counterpart of
`diskrag_tpu/graph/`). The graph is an int32[N, R] padded adjacency (-1
sentinel); search is a fixed-width masked frontier loop; the build is the
kNN-based one (`knn_build`, with the IVF kNN backend and its checkpoints,
`checkpoint`). The wave-insertion build and the dynamic graph are not
ported yet (ROADMAP.md)."""

from diskrag_tpu_torch.graph.knn_build import build_vamana_knn
from diskrag_tpu_torch.graph.prune import robust_prune_batch
from diskrag_tpu_torch.graph.search import (
    SearchResult,
    beam_search,
    beam_search_iq,
    beam_search_pq,
    beam_search_reranked,
)
from diskrag_tpu_torch.graph.types import VamanaIndex

__all__ = [
    "VamanaIndex",
    "SearchResult",
    "beam_search",
    "beam_search_iq",
    "beam_search_pq",
    "beam_search_reranked",
    "robust_prune_batch",
    "build_vamana_knn",
]
