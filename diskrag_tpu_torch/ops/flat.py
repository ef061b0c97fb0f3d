"""Flat (exhaustive) index — counterpart of `diskrag_tpu/ops/flat.py`.

`FlatIndex.search` runs a fused scan of `ops/flat_scan.py`, a candidate
cut and the exact f32 rerank: by default the per-row int8 scan (B1) with
the cut B4; with `fused_precision="int8_packed"` the packed folds (B2 or
B3, with the cut fused in); or the per-row scan on a bf16 copy. On a card
the scans and cuts are the hand-written CUDA kernels; with `device="cpu"`
their plain PyTorch versions.
`flat_search` is the chunked path with an exact per-chunk top-k, used
when a caller passes `chunk`.
"""

from __future__ import annotations

import numpy as np
import torch

from diskrag_tpu_torch.device import resolve_device
from diskrag_tpu_torch.ops.distance import (
    Metric,
    rerank_exact_topk,
    smallest_k,
)
from diskrag_tpu_torch.ops.flat_scan import align_code_rows


def flat_search(
    queries: torch.Tensor,
    vectors_bf16: torch.Tensor,
    norms_sq: torch.Tensor,
    vectors_f32: torch.Tensor | None = None,
    *,
    k: int,
    metric: str = Metric.L2.value,
    chunk: int = 32_768,
    rerank_mult: int = 4,
    rerank_width: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exhaustive top-k over N-chunks: bf16 products (f32 sums), an exact
    top-kk per chunk merged into a running best (ties to the lower id),
    then the exact f32 rerank. Returns (dists [B, k] ascending, ids)."""
    m = Metric(metric)
    n = vectors_bf16.shape[0]
    kk = k * rerank_mult if rerank_width is None else max(rerank_width, k)
    kk = min(kk, n)
    if m == Metric.COSINE:
        qn = torch.sqrt(torch.sum(queries * queries, -1, keepdim=True)) + 1e-12
        qb = (queries / qn).to(torch.bfloat16)
    else:
        qb = queries.to(torch.bfloat16)
    qf = qb.to(torch.float32)
    qn2 = torch.sum(queries * queries, -1, keepdim=True)
    b = queries.shape[0]
    best_d = torch.empty((b, 0), dtype=torch.float32, device=queries.device)
    best_i = torch.empty((b, 0), dtype=torch.int64, device=queries.device)
    for t0 in range(0, n, chunk):
        tile = vectors_bf16[t0 : t0 + chunk].to(torch.float32)
        vn = norms_sq[t0 : t0 + chunk][None, :]
        cross = qf @ tile.T
        if m == Metric.L2:
            dist = qn2 + vn - 2.0 * cross
        elif m == Metric.COSINE:
            dist = 1.0 - cross * torch.rsqrt(vn + 1e-12)
        else:
            dist = -cross
        td, ti = smallest_k(dist, min(kk, dist.shape[1]))
        best_d, best_i = smallest_k(
            torch.cat([best_d, td], 1), kk, torch.cat([best_i, ti + t0], 1)
        )
    best_i = best_i.to(torch.int32)
    if vectors_f32 is None:
        return best_d[:, :k], best_i[:, :k]
    return rerank_exact_topk(queries, vectors_f32, best_i, k, m)


class FlatIndex:
    """On-device exhaustive index: f32 master vectors, their squared
    norms and the scan copy (per-row int8 table, packed int8 table or
    bf16).

    A request for `int8_packed` is served per-row int8 instead, as in the
    JAX package, where the packed fold cannot run: the dot metric (the
    fold is L2-only; cosine rides it on normalized copies), D > 192 (the
    packed int32 would overflow), or so many rows that the reference's
    packed layout fits no TPU block."""

    def __init__(
        self,
        vectors: np.ndarray | torch.Tensor,
        metric: str = "l2",
        fused_precision: str = "int8",
        rerank_width: int | None = None,
        *,
        device: str | torch.device = "cuda",
    ):
        if fused_precision not in ("int8", "int8_packed", "bf16"):
            raise ValueError(f"unknown fused_precision: {fused_precision!r}")
        self.device = resolve_device(device)
        self.rerank_width = rerank_width
        self.metric = Metric(metric).value
        self.vectors = torch.as_tensor(
            np.asarray(vectors, np.float32), device=self.device
        )
        self.norms_sq = torch.sum(self.vectors * self.vectors, dim=-1)
        self._fused_db_norms = None
        self._fused_db_scales = None
        self._fused_db_scale_global = None
        self._fused_nf = None
        self._fused_n_valid = None
        if fused_precision == "int8_packed":
            from diskrag_tpu_torch.ops.flat_scan import _PACKED_MAX_DIM, _packed_layout

            n, d = self.vectors.shape
            if (
                self.metric == Metric.DOT.value
                or d > _PACKED_MAX_DIM
                or _packed_layout(n, d, 1024, 1024, 2048)[2] == 0
            ):
                fused_precision = "int8"
        if self.metric == Metric.COSINE.value:
            scan_src = self.vectors * torch.rsqrt(self.norms_sq + 1e-12)[:, None]
        else:
            scan_src = self.vectors
        if fused_precision == "int8_packed":
            from diskrag_tpu_torch.ops.flat_scan import build_packed_scan_table

            # the nf row carries the scan copy's own norms (ones for
            # cosine) over the global dequant scale
            (
                self._fused_db,
                self._fused_nf,
                self._fused_db_scale_global,
                self._fused_n_valid,
            ) = build_packed_scan_table(scan_src)
        elif fused_precision == "int8":
            from diskrag_tpu_torch.ops.flat_scan import build_rowscan_table

            (
                self._fused_db,
                self._fused_db_norms,
                self._fused_db_scales,
                self._fused_n_valid,
            ) = build_rowscan_table(scan_src, metric=self.metric)
        else:
            self._fused_db = scan_src.to(torch.bfloat16)
        self._fused_db = align_code_rows(self._fused_db)

    @classmethod
    def from_state(
        cls,
        vectors: torch.Tensor,
        fused_db: torch.Tensor,
        *,
        metric: str = "l2",
        fused_db_norms: torch.Tensor | None = None,
        fused_db_scales: torch.Tensor | None = None,
        fused_db_scale_global: torch.Tensor | None = None,
        fused_nf: torch.Tensor | None = None,
        n_valid: int | None = None,
        rerank_width: int | None = None,
        norms_sq: torch.Tensor | None = None,
    ) -> "FlatIndex":
        """An index over given arrays (all on one device) instead of ones
        built from `vectors` — used to carry a JAX index across
        (`convert.flat_state_from_jax`)."""
        self = cls.__new__(cls)
        self.device = vectors.device
        self.rerank_width = rerank_width
        self.metric = Metric(metric).value
        self.vectors = vectors.to(torch.float32)
        if norms_sq is None:
            norms_sq = torch.sum(self.vectors * self.vectors, dim=-1)
        self.norms_sq = norms_sq
        self._fused_db = align_code_rows(fused_db)
        self._fused_db_norms = fused_db_norms
        self._fused_db_scales = fused_db_scales
        self._fused_db_scale_global = fused_db_scale_global
        self._fused_nf = fused_nf
        self._fused_n_valid = n_valid
        return self

    @property
    def n_points(self) -> int:
        return self.vectors.shape[0]

    def search(self, queries, k: int = 10, chunk: int | None = None):
        """(dists [B, k] ascending, ids [B, k]) as tensors on the index's
        device. `chunk` selects the chunked exact path."""
        from diskrag_tpu_torch.ops.flat_scan import flat_search_fused

        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        if q.ndim == 1:
            q = q[None, :]
        if chunk is not None:
            return flat_search(
                q, self.vectors.to(torch.bfloat16), self.norms_sq,
                self.vectors, k=k, metric=self.metric,
                chunk=min(chunk, self.n_points), rerank_width=self.rerank_width,
            )
        return flat_search_fused(
            q,
            self._fused_db,
            self._fused_db_norms if self._fused_db_norms is not None else self.norms_sq,
            self.vectors,
            k=k,
            metric=self.metric,
            db_scales=self._fused_db_scales,
            db_scale_global=self._fused_db_scale_global,
            rerank_width=self.rerank_width,
            db_nf=self._fused_nf,
            n_valid=self._fused_n_valid,
        )
