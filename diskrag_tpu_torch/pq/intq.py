"""Int quantizer: self-contained int8 / int4 rows scored by one gather and
one product (counterpart of `diskrag_tpu/pq/intq.py`).

A point's approximate squared distance to a query decomposes as

    ||q - xhat||^2 = ||q||^2                     (per query)
                   - 2 q . c_cell                 (cell term, [B, C] table)
                   - 2 (q * s) . z                (the product, int rows)
                   + ||xhat||^2                   (bias, folded into the row)

with xhat = c_cell + s * z. Everything a candidate needs lives in ONE int8
row: the quantized coordinates z, the cell id and the bias quantized to 16
bits across two lanes, so a traversal round gathers one row per candidate
and no other per-candidate operand.

Formats (D = vector dim):
  int8:  row = [ z int8 x D | bias_hi | bias_lo ]              (D+2 bytes)
  int4:  row = [ z nibble-packed x D/2 | cid_hi | cid_lo |
                 bias_hi | bias_lo ]                           (D/2+4 bytes)

int8 needs no coarse cell; int4's 16 levels only resolve a zero-mean
residual, so it pairs with a coarse k-means cell whose id rides in the
row. L2 only: for cosine, normalize the corpus and use L2.

The JAX package scores these rows outside Pallas (an XLA gather and an
einsum), and so does this port: the score is plain PyTorch, a row gather
and a batched product in float32 (TF32 stays off, `device.py`). Rows and
the scores' operands live on the quantizer's device; `encode` returns
numpy int8 rows, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from diskrag_tpu_torch.device import resolve_device
from diskrag_tpu_torch.pq.kmeans import kmeans_fit, make_generator
from diskrag_tpu_torch.pq.product_quantizer import _f32
from diskrag_tpu_torch.pq.residual import _coarse_assign_impl

_BIAS_LANES = 2
_CID_LANES = 2


@dataclasses.dataclass(frozen=True)
class IQTables:
    """Per-query-batch scoring state of an IntQuantizer.

    qw:     [B, D] f32 — query pre-scaled by the per-dim step (q * s).
    qn:     [B] f32 — ||q||^2.
    cell_t: [B, C] f32 — -2 q . c_j per coarse cell (None when cell-less).
    bias_lo / bias_scale: 0-d f32 — the bias lanes' 16-bit dequant affine.
    """

    qw: torch.Tensor
    qn: torch.Tensor
    cell_t: torch.Tensor | None
    bias_lo: torch.Tensor
    bias_scale: torch.Tensor


def _unpack_rows(rows: torch.Tensor, dim: int, bits: int, n_cells: int):
    """rows int8 [..., W] -> (z f32 [..., D], cid int64 [...] | None,
    bias f32 [...] in quantized 16-bit units). Lanes are read by absolute
    position, so trailing pad lanes are ignored."""
    zl = dim // 2 if bits == 4 else dim
    zb = rows[..., :zl]
    if bits == 4:
        u = zb.to(torch.int32) & 0xFF
        lo = u & 0xF
        hi = u >> 4
        lo = lo - 16 * (lo >= 8).to(torch.int32)  # two's-complement nibble sign
        hi = hi - 16 * (hi >= 8).to(torch.int32)
        z = torch.stack([lo, hi], dim=-1).reshape(*rows.shape[:-1], dim)
    else:
        z = zb
    pos = zl
    cid = None
    if n_cells > 0:
        cid_hi = rows[..., pos].to(torch.int64)
        cid_lo = rows[..., pos + 1].to(torch.int64) + 128
        cid = cid_hi * 256 + cid_lo
        pos += _CID_LANES
    b_hi = rows[..., pos].to(torch.int32) + 128
    b_lo = rows[..., pos + 1].to(torch.int32) + 128
    bias_q = (b_hi * 256 + b_lo).to(torch.float32)
    return z.to(torch.float32), cid, bias_q


def pad_rows_for_gather(rows: np.ndarray, min_bytes: int = 256) -> np.ndarray:
    """Pad int8 rows with trailing zero lanes up to >= `min_bytes`.

    The JAX package pads for its TPU's gather engine (rows of >= 256 B
    gather ~3x faster there). Scoring ignores trailing lanes
    (`_unpack_rows` slices by absolute position), so the pad changes no
    score; it costs device memory (130 -> 256 B a point at D = 128, bits
    = 8). The host tier keeps it as the default so both packages hold the
    same table; whether it pays on the card is measured in PERF.md."""
    w = int(rows.shape[-1])
    if w >= min_bytes:
        return np.asarray(rows)
    return np.pad(np.asarray(rows), [(0, 0)] * (rows.ndim - 1) + [(0, min_bytes - w)])


def iq_score_gathered(
    tables: IQTables,
    rows: torch.Tensor,
    *,
    dim: int,
    bits: int,
    n_cells: int,
) -> torch.Tensor:
    """Score per-query gathered rows: rows int8 [B, Cand, W] -> [B, Cand]
    approximate squared L2 distances (the exact distance to the decoded
    point, up to the 16-bit bias quantization). The cell term is a gather:
    the JAX package's one-hot compare-select-reduce in its place (a TPU
    lever, `onehot_cells`) sums one nonzero among zeros, so gives the
    same values."""
    z, cid, bias_q = _unpack_rows(rows, dim, bits, n_cells)
    cross = torch.bmm(z, tables.qw[:, :, None])[..., 0]
    out = tables.qn[:, None] - 2.0 * cross
    out = out + bias_q * tables.bias_scale + tables.bias_lo
    if n_cells > 0:
        out = out + torch.gather(tables.cell_t, 1, cid)
    return out


def iq_score_shared(
    tables: IQTables,
    rows: torch.Tensor,
    *,
    dim: int,
    bits: int,
    n_cells: int,
) -> torch.Tensor:
    """Score a SHARED candidate set: rows int8 [S, W] -> [B, S]. One row
    decode for the whole batch (the search's seeds)."""
    z, cid, bias_q = _unpack_rows(rows, dim, bits, n_cells)
    cross = tables.qw @ z.T
    out = tables.qn[:, None] - 2.0 * cross
    out = out + (bias_q * tables.bias_scale + tables.bias_lo)[None, :]
    if n_cells > 0:
        out = out + tables.cell_t[:, cid]
    return out


@dataclasses.dataclass
class IntQuantizer:
    """Per-dim scalar quantizer with optional coarse cells, encoded into
    self-contained int8 rows. `bits` in {4, 8}; `n_cells` 0 disables the
    coarse stage (recommended for bits=8)."""

    bits: int = 8
    n_cells: int = 0
    cell_centroids: torch.Tensor | None = None  # [C, D] f32
    scales: torch.Tensor | None = None          # [D] f32 per-dim step
    bias_lo: float = 0.0
    bias_scale: float = 1.0
    is_fitted: bool = False
    device: str | torch.device = "cuda"

    def __post_init__(self):
        if self.bits not in (4, 8):
            raise ValueError(f"bits must be 4 or 8, got {self.bits}")
        if self.n_cells > 32768:
            raise ValueError("n_cells > 32768 does not fit the cid lanes")
        self.device = resolve_device(self.device)

    # --- geometry ---------------------------------------------------------
    @property
    def dim(self) -> int:
        self._check_fitted()
        return int(self.scales.shape[0])

    @property
    def row_width(self) -> int:
        """int8 lanes per encoded row."""
        d = self.dim
        zl = d // 2 if self.bits == 4 else d
        return zl + (_CID_LANES if self.n_cells > 0 else 0) + _BIAS_LANES

    @property
    def _lim(self) -> int:
        return 2 ** (self.bits - 1) - 1  # 7 or 127

    def fit(
        self,
        vectors,
        *,
        seed: int = 0,
        cell_iters: int = 10,
        max_train_points: int = 262_144,
    ) -> "IntQuantizer":
        """Train the coarse cells (d2-init k-means, when n_cells > 0) and the
        per-dim steps on a subsample, and freeze the bias lanes' affine.
        At or below `max_train_points` points without cells the result is
        deterministic (a max-abs over all points); above it the subsample
        is drawn from a `torch.Generator` seeded with `seed`, not from the
        JAX package's stream."""
        v = _f32(vectors, self.device)
        n, d = v.shape
        if self.bits == 4 and d % 2 != 0:
            raise ValueError("bits=4 requires an even dimension")
        gen = make_generator(seed, self.device)
        if n > max_train_points:
            idx = torch.randperm(n, generator=gen, device=self.device)[:max_train_points]
            train = v[idx]
        else:
            train = v
        if self.n_cells > 0:
            c = min(self.n_cells, max(1, int(train.shape[0]) // 4))
            centers, assign = kmeans_fit(gen, train[None], c, max_iter=cell_iters, init="d2")
            self.cell_centroids = centers[0]
            self.n_cells = c
            res = train - self.cell_centroids[assign[0].long()]
        else:
            res = train
        # per-dim step: symmetric max-abs grid (values beyond the training
        # range clip)
        self.scales = torch.clamp_min(torch.amax(torch.abs(res), dim=0) / self._lim, 1e-8)
        # bias range with headroom for unseen points
        zt = torch.clamp(torch.round(res / self.scales), -self._lim - 1, self._lim)
        xhat = zt * self.scales
        if self.n_cells > 0:
            xhat = xhat + self.cell_centroids[assign[0].long()]
        bn = torch.sum(xhat * xhat, dim=-1)
        lo = float(torch.min(bn))
        hi = float(torch.max(bn))
        span = max(hi - lo, 1e-6)
        self.bias_lo = max(0.0, lo - 0.15 * span)
        self.bias_scale = (hi + 0.35 * span - self.bias_lo) / 65535.0
        self.is_fitted = True
        return self

    # --- encoding ---------------------------------------------------------
    def encode(self, vectors, chunk: int = 2_000_000) -> np.ndarray:
        """vectors [N, D] -> int8 rows [N, row_width] (numpy). Walked in
        chunks of `chunk` rows, which bounds the device intermediates."""
        self._check_fitted()
        n = int(vectors.shape[0])
        if n > chunk:
            return np.concatenate(
                [self.encode(vectors[i : i + chunk]) for i in range(0, n, chunk)], axis=0
            )
        v = _f32(vectors, self.device)
        if self.n_cells > 0:
            cid = _coarse_assign_impl(self.cell_centroids, v).long()
            res = v - self.cell_centroids[cid]
        else:
            cid = None
            res = v
        z = torch.clamp(torch.round(res / self.scales), -self._lim - 1, self._lim).to(torch.int32)
        xhat = z.to(torch.float32) * self.scales
        if cid is not None:
            xhat = xhat + self.cell_centroids[cid]
        bias = torch.sum(xhat * xhat, dim=-1)
        lo = torch.tensor(self.bias_lo, dtype=torch.float32, device=self.device)
        scale = torch.tensor(self.bias_scale, dtype=torch.float32, device=self.device)
        bq = torch.clamp(torch.round((bias - lo) / scale), 0, 65535).to(torch.int32)

        z = z.cpu().numpy()
        parts = []
        if self.bits == 4:
            zu = (z & 0xF).astype(np.uint8)
            packed = (zu[:, 1::2] << 4) | zu[:, 0::2]
            parts.append(packed.view(np.int8))
        else:
            parts.append(z.astype(np.int8))
        if cid is not None:
            cid = cid.cpu().numpy().astype(np.int32)
            parts.append((cid >> 8).astype(np.int8)[:, None])
            parts.append(((cid & 0xFF) - 128).astype(np.int8)[:, None])
        bq = bq.cpu().numpy()
        parts.append(((bq >> 8) - 128).astype(np.int8)[:, None])
        parts.append(((bq & 0xFF) - 128).astype(np.int8)[:, None])
        return np.concatenate(parts, axis=1)

    def _rows(self, rows) -> torch.Tensor:
        if isinstance(rows, torch.Tensor):
            return rows.to(device=self.device, dtype=torch.int8)
        return torch.as_tensor(np.asarray(rows, np.int8), device=self.device)

    def decode(self, rows) -> torch.Tensor:
        """rows [N, W] -> dequantized xhat [N, D] f32 (exact, not via the
        16-bit bias)."""
        self._check_fitted()
        z, cid, _ = _unpack_rows(self._rows(rows), self.dim, self.bits, self.n_cells)
        xhat = z * self.scales
        if cid is not None:
            xhat = xhat + self.cell_centroids[cid]
        return xhat

    # --- scoring ----------------------------------------------------------
    def query_tables(self, queries) -> IQTables:
        """queries [B, D] -> the batch's scoring state."""
        self._check_fitted()
        q = _f32(queries, self.device)
        cell_t = None
        if self.cell_centroids is not None and self.n_cells > 0:
            cell_t = -2.0 * (q @ self.cell_centroids.T)
        return IQTables(
            qw=q * self.scales,
            qn=torch.sum(q * q, dim=-1),
            cell_t=cell_t,
            bias_lo=torch.tensor(self.bias_lo, dtype=torch.float32, device=self.device),
            bias_scale=torch.tensor(self.bias_scale, dtype=torch.float32, device=self.device),
        )

    # alias: engine code treats quantizers uniformly
    compute_distance_tables = query_tables

    def asymmetric_distance_sq(self, tables: IQTables, rows) -> torch.Tensor:
        """tables, rows [N, W] -> [B, N] approximate squared distances
        (the dense path of diagnostics and tests)."""
        self._check_fitted()
        return iq_score_shared(tables, self._rows(rows), dim=self.dim, bits=self.bits,
                               n_cells=self.n_cells)

    def reconstruction_error(self, vectors) -> float:
        v = _f32(vectors, self.device)
        rec = self.decode(self.encode(v))
        return float(torch.mean(torch.sum((v - rec) ** 2, dim=1)))

    def estimate_selectivity(self, n_points: int) -> dict:
        """Compression stats."""
        self._check_fitted()
        raw = n_points * self.dim * 4
        compressed = n_points * self.row_width
        return {
            "n_points": n_points,
            "raw_bytes": raw,
            "compressed_bytes": compressed,
            "compression_ratio": raw / max(compressed, 1),
        }

    # --- persistence ------------------------------------------------------
    def to_arrays(self) -> dict[str, np.ndarray]:
        self._check_fitted()
        out = {
            "iq_scales": self.scales.cpu().numpy().astype(np.float32),
            "iq_meta": np.asarray(
                [float(self.bits), float(self.n_cells), self.bias_lo, self.bias_scale], np.float64
            ),
        }
        if self.n_cells > 0:
            out["iq_cell_centroids"] = self.cell_centroids.cpu().numpy().astype(np.float32)
        return out

    @classmethod
    def from_arrays(cls, arrays: dict, *, device: str | torch.device = "cuda") -> "IntQuantizer":
        meta = np.asarray(arrays["iq_meta"], np.float64)
        q = cls(bits=int(meta[0]), n_cells=int(meta[1]), device=device)
        q.bias_lo = float(meta[2])
        q.bias_scale = float(meta[3])
        q.scales = _f32(arrays["iq_scales"], q.device)
        if q.n_cells > 0:
            q.cell_centroids = _f32(arrays["iq_cell_centroids"], q.device)
        q.is_fitted = True
        return q

    def _check_fitted(self):
        if not self.is_fitted or self.scales is None:
            raise RuntimeError("IntQuantizer is not fitted")


def default_iq_cells(n_points: int, bits: int) -> int:
    """int4 rows need the coarse stage (16 levels only resolve a zero-mean
    residual); int8 resolves the raw range on its own."""
    if bits == 8:
        return 0
    return int(min(1024, max(16, n_points // 64)))
