"""Residual product quantizer — coarse k-means + PQ on residuals
(counterpart of `diskrag_tpu/pq/residual.py`).

Plain PQ spends its 256 centroids per subspace on the global point
distribution; on clustered data most of that goes to cluster structure.
Quantizing the residual r = x - c_assign(x) makes the codebooks model a
homogeneous zero-mean cloud (the IVFADC decomposition, Jégou et al.).

ADC decomposition per subspace s (codeword e, coarse centroid c_j):
    ||q - c_j - e||² = ||q - c_j||²                 (term0, [B, C] per query)
                     + Σ_s (||e_s||² - 2 q_s·e_s)   (T1,   [B, m, 256] per query)
                     + Σ_s (2 c_{j,s}·e_s)          (T2,   [C, m, 256] precomputed)

The graph traversal uses the cheaper serving decomposition instead
(`inner_tables`, `cell_tables`, `point_bias` below), which reuses the
plain-PQ table lookup (kernel B5, `ops/pq_scan.py`) unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from diskrag_tpu_torch.device import resolve_device
from diskrag_tpu_torch.pq.kmeans import kmeans_fit, make_generator
from diskrag_tpu_torch.pq.product_quantizer import (
    N_CENTROIDS,
    ProductQuantizer,
    _f32,
    adc_lookup,
    adc_lookup_gathered,
)


def _coarse_assign_impl(centers: torch.Tensor, vectors: torch.Tensor, chunk: int = 8192) -> torch.Tensor:
    """vectors [N, D] -> nearest-coarse-centroid ids int32 [N] (the lowest
    id on ties)."""
    cn = torch.sum(centers * centers, dim=-1)
    out = [
        torch.argmin(cn[None, :] - 2.0 * (vectors[t0 : t0 + chunk] @ centers.T), dim=-1)
        for t0 in range(0, vectors.shape[0], chunk)
    ]
    if not out:
        return torch.empty((0,), dtype=torch.int32, device=vectors.device)
    return torch.cat(out).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class RPQTables:
    """Per-query-batch ADC state for a ResidualPQ."""

    t1: torch.Tensor     # [B, m, 256] — residual part (query-dependent)
    term0: torch.Tensor  # [B, C] — query-to-coarse-centroid squared distances


def _t2_index(coarse_ids: torch.Tensor, codes: torch.Tensor, m: int) -> torch.Tensor:
    return (
        coarse_ids.long()[..., None] * (m * N_CENTROIDS)
        + torch.arange(m, device=codes.device) * N_CENTROIDS
        + codes.long()
    )


def rpq_lookup_gathered(
    tables: RPQTables, t2_flat: torch.Tensor, codes: torch.Tensor, coarse_ids: torch.Tensor,
) -> torch.Tensor:
    """ADC for per-query candidate sets: codes [B, Cand, m] uint8,
    coarse_ids [B, Cand] int32 -> [B, Cand] squared distances. `t2_flat`
    is the flattened [C*m*256] cross-term table."""
    m = tables.t1.shape[1]
    d1 = adc_lookup_gathered(tables.t1, codes)
    d0 = torch.gather(tables.term0, 1, coarse_ids.long())
    d2 = torch.sum(t2_flat[_t2_index(coarse_ids, codes, m)], dim=-1)
    return d0 + d1 + d2


def rpq_lookup(
    tables: RPQTables, t2_flat: torch.Tensor, codes: torch.Tensor, coarse_ids: torch.Tensor,
) -> torch.Tensor:
    """ADC against a shared candidate set: codes [S, m], coarse_ids [S]
    -> [B, S]. The T2 / coarse parts are computed once for the set."""
    m = tables.t1.shape[1]
    d1 = adc_lookup(tables.t1, codes)
    d0 = tables.term0[:, coarse_ids.long()]
    d2 = torch.sum(t2_flat[_t2_index(coarse_ids, codes, m)], dim=-1)
    return d0 + d1 + d2[None, :]


@dataclasses.dataclass
class ResidualPQ:
    """Coarse quantizer + PQ over residuals. `encode` returns (codes,
    coarse_ids); the query tables are an `RPQTables` pair. Per point: m
    bytes of codes + 4 bytes of coarse id; plus one [C, m, 256] f32
    cross-term table that does not grow with N."""

    n_subvectors: int
    n_coarse: int = 1024
    n_centroids: int = N_CENTROIDS
    coarse_centroids: torch.Tensor | None = None  # [C, D] f32
    pq: ProductQuantizer | None = None
    is_fitted: bool = False
    device: str | torch.device = "cuda"
    _t2_flat: torch.Tensor | None = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if self.n_centroids != N_CENTROIDS:
            raise ValueError(f"n_centroids is fixed at {N_CENTROIDS} (uint8 codes)")
        self.device = resolve_device(self.device)

    @property
    def sub_dim(self) -> int:
        self._check_fitted()
        return self.pq.sub_dim

    @property
    def dim(self) -> int:
        self._check_fitted()
        return int(self.coarse_centroids.shape[1])

    def fit(
        self,
        vectors,
        *,
        seed: int = 0,
        max_iter: int | None = None,
        coarse_iters: int = 12,
        max_train_points: int = 262_144,
    ) -> "ResidualPQ":
        """Train the coarse codebook (d2-init k-means) then the residual
        PQ, both on one training subsample."""
        vectors = _f32(vectors, self.device)
        n, dim = vectors.shape
        m = self.n_subvectors
        if dim % m != 0:
            raise ValueError(f"dimension {dim} not divisible by m={m}")
        c = min(self.n_coarse, max(1, n // 4))
        if n < self.n_centroids:
            raise ValueError(f"need >= {self.n_centroids} points to fit PQ, got {n}")
        gen = make_generator(seed, self.device)
        if n > max_train_points:
            idx = torch.randperm(n, generator=gen, device=self.device)[:max_train_points]
            train = vectors[idx]
        else:
            train = vectors
        centers, assign = kmeans_fit(gen, train[None], c, max_iter=coarse_iters, init="d2")
        self.coarse_centroids = centers[0]
        self.n_coarse = c
        residuals = train - self.coarse_centroids[assign[0].long()]
        self.pq = ProductQuantizer(n_subvectors=m, device=self.device).fit(
            residuals, seed=seed, max_iter=max_iter, max_train_points=max_train_points,
        )
        self.is_fitted = True
        self._t2_flat = None
        return self

    # --- encoding ---------------------------------------------------------
    def coarse_assign(self, vectors) -> torch.Tensor:
        self._check_fitted()
        return _coarse_assign_impl(self.coarse_centroids, _f32(vectors, self.device))

    def encode(self, vectors, chunk: int = 8_000_000) -> tuple[torch.Tensor, torch.Tensor]:
        """vectors [N, D] -> (codes uint8 [N, m], coarse_ids int32 [N]).

        Walked in chunks of `chunk` rows: the rows and their residuals
        are two [chunk, D] f32 intermediates on the device, 8 GB together
        at D = 128, a tenth of an 80 GB card next to the vectors
        themselves. The outputs are small (m + 4 bytes a row)."""
        self._check_fitted()
        n = int(vectors.shape[0])
        if n > chunk:
            parts = [self.encode(vectors[i : i + chunk]) for i in range(0, n, chunk)]
            return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
        v = _f32(vectors, self.device)
        cid = _coarse_assign_impl(self.coarse_centroids, v)
        residuals = v - self.coarse_centroids[cid.long()]
        return self.pq.encode(residuals), cid

    def decode(self, codes, coarse_ids) -> torch.Tensor:
        self._check_fitted()
        cid = torch.as_tensor(coarse_ids, device=self.device).long()
        return self.coarse_centroids[cid] + self.pq.decode(codes)

    # --- ADC ---------------------------------------------------------------
    @property
    def t2_flat(self) -> torch.Tensor:
        """Flattened cross-term table [C*m*256] f32: T2[j,s,k] = 2 c_{j,s}·e_{s,k}.
        Query-independent — computed once and cached."""
        self._check_fitted()
        if self._t2_flat is None:
            m = self.n_subvectors
            csub = self.coarse_centroids.reshape(self.n_coarse, m, self.pq.sub_dim)
            t2 = 2.0 * torch.einsum("cmd,mkd->cmk", csub, self.pq.codebooks)
            self._t2_flat = t2.reshape(-1)
        return self._t2_flat

    def compute_query_tables(self, queries) -> RPQTables:
        """queries [B, D] -> (T1 [B, m, 256], term0 [B, C])."""
        self._check_fitted()
        q = _f32(queries, self.device)
        b = q.shape[0]
        cb = self.pq.codebooks
        m, _, ds = cb.shape
        qn = torch.sum(q * q, dim=-1)[:, None]
        cn = torch.sum(self.coarse_centroids * self.coarse_centroids, dim=-1)[None, :]
        term0 = torch.clamp_min(qn + cn - 2.0 * (q @ self.coarse_centroids.T), 0.0)
        e2 = torch.sum(cb * cb, dim=-1)  # [m, K]
        qe = torch.einsum("bmd,mkd->bmk", q.reshape(b, m, ds), cb)
        return RPQTables(t1=e2[None, :, :] - 2.0 * qe, term0=term0)

    # so callers can treat plain and residual PQ alike where the table
    # object goes straight back into the matching lookup
    compute_distance_tables = compute_query_tables

    def asymmetric_distance_sq(self, tables: RPQTables, codes, coarse_ids) -> torch.Tensor:
        """tables, codes [N, m], coarse_ids [N] -> [B, N] squared dists."""
        dev = tables.t1.device
        return rpq_lookup(
            tables, self.t2_flat, torch.as_tensor(codes, device=dev),
            torch.as_tensor(coarse_ids, device=dev).to(torch.int32),
        )

    # --- serving decomposition ---------------------------------------------
    #     ||q - c - e||^2 = sum_s ||q_s - e_s||^2          (inner tables)
    #                     - 2 q.c                          (cell_tables [B, C])
    #                     + ||c||^2 + 2 c.e                (point_bias f32 [N])
    # so a candidate costs the plain-PQ code gather + one int32 cell-id
    # gather + one f32 bias gather: no [C, m, 256] cross-term gathers on
    # the hot path (those stay in rpq_lookup* for oracles and diagnostics).

    def inner_tables(self, queries) -> torch.Tensor:
        """Plain-PQ ADC tables of the residual codebooks against the full
        query: [B, m, 256]. Feed to the unchanged ADC lookups."""
        self._check_fitted()
        return self.pq.compute_distance_tables(queries)

    def cell_tables(self, queries) -> torch.Tensor:
        """[B, C] query-cell cross terms: -2 q . c_j."""
        self._check_fitted()
        return -2.0 * (_f32(queries, self.device) @ self.coarse_centroids.T)

    def point_bias(self, codes, coarse_ids, *, chunk: int = 1 << 20) -> torch.Tensor:
        """f32 [N] per-point constant: ||c||^2 + 2 c . e (c = assigned
        coarse centroid, e = decoded residual). Persisted next to the
        codes so serving never touches the codebooks per candidate.
        Walked in chunks: the two decode intermediates are [chunk, D]
        f32, 1 GB together at D = 128."""
        self._check_fitted()
        n = int(codes.shape[0])
        out = []
        for lo in range(0, n, chunk):
            cid = torch.as_tensor(coarse_ids[lo : lo + chunk], device=self.device).long()
            c = self.coarse_centroids[cid]
            e = self.pq.decode(codes[lo : lo + chunk])
            out.append(torch.sum(c * (c + 2.0 * e), dim=-1))
        if not out:
            return torch.empty((0,), dtype=torch.float32, device=self.device)
        return torch.cat(out) if len(out) > 1 else out[0]

    def reconstruction_error(self, vectors) -> float:
        v = _f32(vectors, self.device)
        rec = self.decode(*self.encode(v))
        return float(torch.mean(torch.sum((v - rec) ** 2, dim=1)))

    def estimate_selectivity(self, n_points: int) -> dict:
        """Compression stats (the coarse id adds 4 bytes a point; the T2
        table is O(C), not O(N))."""
        self._check_fitted()
        raw = n_points * self.dim * 4
        compressed = n_points * (self.n_subvectors + 4)
        return {
            "n_points": n_points,
            "raw_bytes": raw,
            "compressed_bytes": compressed,
            "compression_ratio": raw / max(compressed, 1),
        }

    # --- persistence --------------------------------------------------------
    def to_arrays(self) -> dict[str, np.ndarray]:
        self._check_fitted()
        out = self.pq.to_arrays()
        out["coarse_centroids"] = self.coarse_centroids.cpu().numpy().astype(np.float32)
        return out

    @classmethod
    def from_arrays(cls, arrays: dict, *, device: str | torch.device = "cuda") -> "ResidualPQ":
        pq = ProductQuantizer.from_arrays(
            {k: v for k, v in arrays.items() if k != "coarse_centroids"}, device=device
        )
        cc = _f32(arrays["coarse_centroids"], pq.device)
        return cls(
            n_subvectors=pq.n_subvectors, n_coarse=int(cc.shape[0]),
            coarse_centroids=cc, pq=pq, is_fitted=True, device=pq.device,
        )

    def _check_fitted(self):
        if not self.is_fitted or self.pq is None:
            raise RuntimeError("ResidualPQ is not fitted")


def pq_from_arrays(arrays: dict, *, device: str | torch.device = "cuda"):
    """Factory: the right quantizer type for a persisted artifact dict
    (IntQuantizer when `iq_meta` is present, ResidualPQ when the coarse
    codebook is, ProductQuantizer otherwise)."""
    if "iq_meta" in arrays:
        from diskrag_tpu_torch.pq.intq import IntQuantizer

        return IntQuantizer.from_arrays(arrays, device=device)
    if "coarse_centroids" in arrays:
        return ResidualPQ.from_arrays(arrays, device=device)
    return ProductQuantizer.from_arrays(arrays, device=device)


def default_n_coarse(n_points: int) -> int:
    """Coarse codebook sizing: recall is insensitive to C past a few
    hundred cells (the win is cluster-mean removal, not cell granularity),
    so C stays modest: the [C, m, 256] cross-term table costs C·m KB."""
    return int(min(2048, max(64, n_points // 64)))
