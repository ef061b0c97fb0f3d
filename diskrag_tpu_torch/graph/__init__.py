"""Vamana graph: build + search on dense tensors (counterpart of
`diskrag_tpu/graph/`). The graph is an int32[N, R] padded adjacency (-1
sentinel); search is a fixed-width masked frontier loop; the builds are the
kNN-based one (`knn_build`, with the IVF kNN backend and its checkpoints,
`checkpoint`) and the wave-insertion one (`build`); `dynamic` inserts,
tombstones and consolidates."""

from diskrag_tpu_torch.graph.build import build_vamana, random_regular_init
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
    "build_vamana",
    "build_vamana_knn",
    "random_regular_init",
]
