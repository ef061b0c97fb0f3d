"""Index data model (counterpart of `diskrag_tpu/graph/types.py`): a
Vamana graph as dense tensors on one device."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from diskrag_tpu_torch.device import resolve_device
from diskrag_tpu_torch.ops.distance import Metric


@dataclasses.dataclass(frozen=True)
class VamanaIndex:
    """A Vamana graph index resident on one device.

    Attributes:
      vectors:   float32[N, D] full-precision vectors.
      adjacency: int32[N, R] neighbor ids, -1 padded.
      medoid:    0-d int32 tensor, the start node for search.
      metric:    distance metric name.
      entry_points: optional int32[S] extra unique search seeds (besides
                 the medoid), computed at build time as the database
                 points nearest to k-means cell centers. The kNN-based
                 build's long-range edges are unstructured: one [B, S]
                 seed product replaces the navigation a sequential build
                 encodes in its edges.
    """

    vectors: torch.Tensor
    adjacency: torch.Tensor
    medoid: torch.Tensor
    metric: str = Metric.L2.value
    entry_points: torch.Tensor | None = None

    @property
    def n_points(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def degree_bound(self) -> int:
        return self.adjacency.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    @classmethod
    def from_numpy(
        cls,
        vectors: np.ndarray,
        adjacency: np.ndarray,
        medoid: int,
        metric: str = Metric.L2.value,
        entry_points: np.ndarray | None = None,
        *,
        device: str | torch.device = "cuda",
    ) -> "VamanaIndex":
        dev = resolve_device(device)
        return cls(
            vectors=torch.as_tensor(np.asarray(vectors, np.float32), device=dev),
            adjacency=torch.as_tensor(np.asarray(adjacency, np.int32), device=dev),
            medoid=torch.as_tensor(int(medoid), dtype=torch.int32, device=dev),
            metric=Metric(metric).value,
            entry_points=(
                None
                if entry_points is None
                else torch.as_tensor(np.asarray(entry_points, np.int32), device=dev)
            ),
        )

    def degrees(self) -> torch.Tensor:
        """Out-degree per node."""
        return torch.sum(self.adjacency >= 0, dim=1)

    def no_in_edge_share(self) -> float:
        """Share of the nodes no edge points to: a search reaches them only
        as seeds (the medoid, the entry points)."""
        n = self.n_points
        targets = self.adjacency.reshape(-1).long()
        hit = torch.zeros(n, dtype=torch.bool, device=self.device)
        hit[targets[targets >= 0]] = True
        return float(n - int(hit.sum())) / n
