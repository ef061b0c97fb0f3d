"""Product quantizer (counterpart of `diskrag_tpu/pq/product_quantizer.py`):
256 centroids per subspace, uint8 codes, all m sub-quantizers trained at
once by the batched k-means, encode / decode / ADC as chunked tensor
programs, optional OPQ rotation. Same `to_arrays` layout as the JAX
package, so a model saved by either loads in the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from diskrag_tpu_torch.device import resolve_device
from diskrag_tpu_torch.pq.kmeans import _batched_sq_dists, kmeans_fit, make_generator

N_CENTROIDS = 256  # uint8 codes


def _f32(x, device: torch.device) -> torch.Tensor:
    """`x` (numpy or tensor) as an f32 tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _encode_impl(codebooks: torch.Tensor, vectors: torch.Tensor, chunk: int = 8192) -> torch.Tensor:
    """vectors [N, D] -> uint8 codes [N, m] (argmin centroid per subspace,
    the lowest centroid on ties)."""
    m, k, ds = codebooks.shape
    out = []
    for t0 in range(0, vectors.shape[0], chunk):
        td = vectors[t0 : t0 + chunk]
        sub = td.reshape(td.shape[0], m, ds).transpose(0, 1)  # [m, chunk, ds]
        d = _batched_sq_dists(sub.contiguous(), codebooks)
        out.append(torch.argmin(d, dim=-1).to(torch.uint8).T)
    if not out:
        return torch.empty((0, m), dtype=torch.uint8, device=vectors.device)
    return torch.cat(out)


def _decode_impl(codebooks: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """codes uint8 [N, m] -> reconstructed vectors [N, m*ds]."""
    m = codebooks.shape[0]
    sub = codebooks[torch.arange(m, device=codebooks.device)[None, :], codes.long()]
    return sub.reshape(codes.shape[0], -1)


def _distance_table_impl(codebooks: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """ADC lookup tables: queries [B, D] -> [B, m, K] squared distances."""
    b = queries.shape[0]
    m, k, ds = codebooks.shape
    q = queries.reshape(b, m, ds).transpose(0, 1).contiguous()  # [m, B, ds]
    return _batched_sq_dists(q, codebooks).transpose(0, 1).contiguous()


def adc_lookup(tables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Asymmetric distance against a shared code set: tables [B, m, K],
    codes [N, m] -> [B, N]."""
    c = codes.long().T  # [m, N]
    g = torch.gather(tables, 2, c[None, :, :].expand(tables.shape[0], -1, -1))
    return torch.sum(g, dim=1)


def adc_lookup_gathered(tables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """ADC for per-query candidate sets in the gather formulation: tables
    [B, m, K], codes [B, C, m] -> [B, C]. On the card the graph search
    goes through the kernel in `ops/pq_scan.py` instead."""
    g = torch.gather(tables, 2, codes.long().transpose(1, 2))  # [B, m, C]
    return torch.sum(g, dim=1)


@dataclasses.dataclass
class ProductQuantizer:
    """PQ model: fit / encode / decode / compute_distance_tables /
    asymmetric_distance_sq, batched over queries. Tensors live on
    `device` (resolved at construction, default the card)."""

    n_subvectors: int
    n_centroids: int = N_CENTROIDS
    codebooks: torch.Tensor | None = None  # [m, 256, sub_dim]
    rotation: torch.Tensor | None = None   # [D, D] orthogonal (OPQ), optional
    is_fitted: bool = False
    device: str | torch.device = "cuda"

    def __post_init__(self):
        if self.n_centroids != N_CENTROIDS:
            raise ValueError(
                f"n_centroids is fixed at {N_CENTROIDS} (uint8 codes), got "
                f"{self.n_centroids}"
            )
        self.device = resolve_device(self.device)

    @property
    def sub_dim(self) -> int:
        if self.codebooks is not None:
            return self.codebooks.shape[-1]
        raise RuntimeError("not fitted")

    def fit(
        self,
        vectors,
        *,
        seed: int = 0,
        max_iter: int | None = None,
        max_train_points: int = 262_144,
        opq_iters: int = 0,
    ) -> "ProductQuantizer":
        """Train the codebooks, on a subsample of `max_train_points` rows
        when there are more.

        opq_iters > 0 enables OPQ: alternate (fit codebooks on rotated
        data) and (update the rotation by orthogonal Procrustes against
        the reconstruction): R <- U V^T from SVD(X^T X_hat). Queries and
        vectors are rotated transparently by encode / decode /
        compute_distance_tables."""
        vectors = _f32(vectors, self.device)
        n, dim = vectors.shape
        m = self.n_subvectors
        if dim % m != 0:
            raise ValueError(f"dimension {dim} not divisible by m={m}")
        if n < self.n_centroids:
            raise ValueError(f"need >= {self.n_centroids} points to fit PQ, got {n}")
        if max_iter is None:
            max_iter = 25 if n <= 100_000 else 15
        gen = make_generator(seed, self.device)
        if n > max_train_points:
            idx = torch.randperm(n, generator=gen, device=self.device)[:max_train_points]
            train = vectors[idx]
        else:
            train = vectors

        def fit_codebooks(x):
            sub = x.reshape(x.shape[0], m, dim // m).transpose(0, 1).contiguous()
            centers, _ = kmeans_fit(gen, sub, self.n_centroids, max_iter=max_iter)
            return centers

        if opq_iters <= 0:
            self.codebooks = fit_codebooks(train)
            self.rotation = None
            self.is_fitted = True
            return self

        rot = torch.eye(dim, dtype=torch.float32, device=self.device)
        rot_updated = False
        for it in range(opq_iters):
            x = train if not rot_updated else train @ rot
            self.codebooks = fit_codebooks(x)
            self.is_fitted = True
            if it == opq_iters - 1:
                break
            x_hat = _decode_impl(self.codebooks, _encode_impl(self.codebooks, x))
            u, _, vt = torch.linalg.svd(train.T @ x_hat, full_matrices=False)
            rot = u @ vt
            rot_updated = True
        # opq_iters=1 never rotates: no identity matrix is stored
        self.rotation = rot if rot_updated else None
        return self

    def _rotate(self, vectors: torch.Tensor) -> torch.Tensor:
        if self.rotation is None:
            return vectors
        return vectors @ self.rotation

    def encode(self, vectors) -> torch.Tensor:
        self._check_fitted()
        return _encode_impl(self.codebooks, self._rotate(_f32(vectors, self.device)))

    def decode(self, codes) -> torch.Tensor:
        """Reconstruct in the original space (rotation undone)."""
        self._check_fitted()
        rec = _decode_impl(self.codebooks, torch.as_tensor(codes, device=self.device))
        if self.rotation is None:
            return rec
        return rec @ self.rotation.T

    def compute_distance_tables(self, queries) -> torch.Tensor:
        """[B, D] -> [B, m, 256] ADC tables; the query is rotated into
        codebook space first."""
        self._check_fitted()
        return _distance_table_impl(self.codebooks, self._rotate(_f32(queries, self.device)))

    def asymmetric_distance_sq(self, tables: torch.Tensor, codes) -> torch.Tensor:
        """tables [B, m, 256], codes [N, m] -> [B, N] squared distances."""
        return adc_lookup(tables, torch.as_tensor(codes, device=tables.device))

    def symmetric_distance_tables(self) -> torch.Tensor:
        """Per-subspace centroid-pair squared distances [m, 256, 256]."""
        self._check_fitted()
        cb = self.codebooks
        n2 = torch.sum(cb * cb, dim=-1)
        cross = torch.bmm(cb, cb.transpose(1, 2))
        return torch.clamp_min(n2[:, :, None] + n2[:, None, :] - 2.0 * cross, 0.0)

    def symmetric_distance_sq(self, codes_a, codes_b, tables: torch.Tensor | None = None) -> torch.Tensor:
        """Approximate squared distance between coded points:
        codes_a [A, m], codes_b [B, m] -> [A, B]."""
        if tables is None:
            tables = self.symmetric_distance_tables()
        a = torch.as_tensor(codes_a, device=tables.device).long()
        b = torch.as_tensor(codes_b, device=tables.device).long()
        m = tables.shape[0]
        sub = tables[
            torch.arange(m, device=tables.device)[None, None, :],
            a[:, None, :],
            b[None, :, :],
        ]
        return torch.sum(sub, dim=-1)

    def reconstruction_error(self, vectors) -> float:
        """Mean squared reconstruction error."""
        v = _f32(vectors, self.device)
        rec = self.decode(self.encode(v))
        return float(torch.mean(torch.sum((v - rec) ** 2, dim=1)))

    def estimate_selectivity(self, n_points: int) -> dict:
        """Compression stats."""
        self._check_fitted()
        dim = self.n_subvectors * self.sub_dim
        raw = n_points * dim * 4
        compressed = n_points * self.n_subvectors
        return {
            "n_points": n_points,
            "raw_bytes": raw,
            "compressed_bytes": compressed,
            "compression_ratio": raw / max(compressed, 1),
        }

    # --- persistence ----------------------------------------------------
    def to_arrays(self) -> dict[str, np.ndarray]:
        self._check_fitted()
        out = {
            "codebooks": self.codebooks.cpu().numpy().astype(np.float32),
            "n_subvectors": np.asarray(self.n_subvectors),
            "n_centroids": np.asarray(self.n_centroids),
        }
        if self.rotation is not None:
            out["rotation"] = self.rotation.cpu().numpy().astype(np.float32)
        return out

    @classmethod
    def from_arrays(cls, arrays: dict, *, device: str | torch.device = "cuda") -> "ProductQuantizer":
        pq = cls(n_subvectors=int(arrays["n_subvectors"]), device=device)
        cb = _f32(arrays["codebooks"], pq.device)
        if cb.shape[0] != pq.n_subvectors or cb.shape[1] != N_CENTROIDS:
            raise ValueError(f"bad codebook shape {tuple(cb.shape)}")
        pq.codebooks = cb
        if "rotation" in arrays:
            pq.rotation = _f32(arrays["rotation"], pq.device)
        pq.is_fitted = True
        return pq

    def _check_fitted(self):
        if not self.is_fitted or self.codebooks is None:
            raise RuntimeError("ProductQuantizer is not fitted")
