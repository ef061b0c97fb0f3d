"""IVF-Flat index (counterpart of `diskrag_tpu/index/ivf.py`): k-means
cells laid out as padded scan tiles [C, cap, D] (per-row int8 by
default, or bf16), probed cell by cell with a batched product, then the
exact f32 rerank of the kept candidates.

The third in-memory index family beside the flat index and the Vamana
graph: a probe reads whole cell tiles, so p probes a query cost p
contiguous tile reads and one small product each, no per-row random
gathers. The JAX package computes the probe with an XLA gather and an
einsum inside `lax.scan`, and the cell assignment with a matmul and
`lax.top_k`: no Pallas kernel, so both stay plain PyTorch here.

Same results as the JAX package on the same state (`convert.ivf_from_jax`):
the int8 codes, scales and tile norms are bit-identical, the int8 cross
product is exact (int32 sums, see `int8_cross`), the running top-kk keeps
`lax.top_k`'s order (a stable sort: the running best before the new
probe's slots, slots in order, the lower index first among equals). A
port-built index draws its k-means seeding from a `torch.Generator`, so
its cells are other cells of the same quality; the assignment given the
same centroids (`assign_cells`) returns the JAX package's `tile_ids`.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from diskrag_tpu_torch.device import resolve_device
from diskrag_tpu_torch.ops.distance import Metric, rerank_exact_topk
from diskrag_tpu_torch.ops.topk import topk_smallest

INVALID_ID = -1

# A probe multiplies [b, cap, D] gathered tile rows in f32: the search is
# walked over query chunks whose f32 operand stays under this many bytes
# (the kNN pass hands it 4096 queries at cap 750, D 128: 1.5 GB).
_PROBE_BYTES = 2 << 30

# int8 products are taken in f32 over column chunks no wider than this:
# every partial sum of one chunk is at most 127 * 127 * 1024 < 2^24 in
# magnitude, so it is exact in f32 whatever the order of the sums; the
# chunks are then added in int32, as the JAX package's int32 einsum adds.
_EXACT_D = 1024

# Assignment and tile construction work in chunks whose f32 blocks stay
# under this many bytes ([rows, C] scores; [cells, cap, D] gathered rows).
_BLOCK_BYTES = 1 << 30


def int8_cross(q_codes: torch.Tensor, tile_codes: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 dot products summed in int32: q_codes [b, D],
    tile_codes [b, cap, D] -> int32 [b, cap]. PyTorch has no batched int8
    product on CUDA (`torch.bmm` takes no int8, `torch._int_mm` is 2-D),
    so each chunk of at most `_EXACT_D` columns is an f32 `bmm` of the
    codes, exact there, converted to int32 and added."""
    out = None
    for d0 in range(0, q_codes.shape[1], _EXACT_D):
        qf = q_codes[:, d0 : d0 + _EXACT_D].to(torch.float32)
        tf = tile_codes[:, :, d0 : d0 + _EXACT_D].to(torch.float32)
        part = torch.bmm(tf, qf[:, :, None])[..., 0].to(torch.int32)
        out = part if out is None else out + part
    return out


def _probe_search(queries, centroids, tiles, tile_ids, tile_norms, vectors, tile_scales,
                  *, k: int, n_probe: int, metric: str):
    """The JAX package's `_ivf_search_impl` on one chunk of queries:
    (dists [B, k], ids int32 [B, k]) ascending."""
    from diskrag_tpu_torch.ops.flat_scan import quantize_int8

    m = Metric(metric)
    b = queries.shape[0]
    cap = tiles.shape[1]
    int8 = tiles.dtype == torch.int8

    # pick cells: [B, C] centroid scores -> the n_probe best
    qc = queries @ centroids.T
    if m == Metric.L2:
        cd = torch.sum(centroids * centroids, -1)[None, :] - 2.0 * qc
    else:  # cosine / dot: cells are chosen by dot
        cd = -qc
    _, probe = topk_smallest(cd, n_probe)  # [B, P]

    if int8:
        qb, q_scales = quantize_int8(queries)
    else:
        qf = queries.to(torch.bfloat16).to(torch.float32)
    qn2 = torch.sum(queries * queries, -1, keepdim=True)
    # never below k: with a large k and narrow probes (k > cap * n_probe)
    # the final top-k over the [B, kk] candidates would outrun its width
    kk = max(min(4 * k, cap * n_probe), k)

    best_d = torch.full((b, kk), torch.inf, dtype=torch.float32, device=queries.device)
    best_i = torch.full((b, kk), INVALID_ID, dtype=torch.int32, device=queries.device)
    for p in range(n_probe):
        cells = probe[:, p]
        tile = tiles[cells]     # [B, cap, D]: whole-tile reads
        ids = tile_ids[cells]   # [B, cap]
        vn = tile_norms[cells]  # [B, cap]
        if int8:
            cross = int8_cross(qb, tile).to(torch.float32)
            cross = cross * q_scales[:, None] * tile_scales[cells]
        else:  # bf16 values, exact products, f32 sums
            cross = torch.bmm(tile.to(torch.float32), qf[:, :, None])[..., 0]
        if m == Metric.L2:
            dist = qn2 + vn - 2.0 * cross
        elif m == Metric.COSINE:
            qnn = torch.rsqrt(qn2 + 1e-12)
            dist = 1.0 - cross * torch.rsqrt(vn + 1e-12) * qnn
        else:
            dist = -cross
        dist = torch.where(ids == INVALID_ID, torch.inf, dist)
        best_d, take = topk_smallest(torch.cat([best_d, dist], dim=1), kk)
        best_i = torch.gather(torch.cat([best_i, ids], dim=1), 1, take)

    return rerank_exact_topk(queries, vectors, best_i, k, m)


@dataclasses.dataclass
class IVFIndex:
    """An IVF-Flat index on one device.

    Attributes:
      centroids:   f32 [C, D] cell centres.
      tiles:       [C, cap, D] int8 (default) or bf16 scan tiles, pad rows 0.
      tile_ids:    int32 [C, cap] point id of each tile row, -1 at pads.
      tile_norms:  f32 [C, cap] squared norms, +inf at pads.
      vectors:     f32 [N, D] rerank master.
      metric:      distance metric name.
      tile_scales: f32 [C, cap] per-row dequant scales (int8 tiles only).
    """

    centroids: torch.Tensor
    tiles: torch.Tensor
    tile_ids: torch.Tensor
    tile_norms: torch.Tensor
    vectors: torch.Tensor
    metric: str = "l2"
    tile_scales: torch.Tensor | None = None

    @property
    def n_points(self) -> int:
        return self.vectors.shape[0]

    @property
    def n_cells(self) -> int:
        return self.centroids.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    @property
    def tile_precision(self) -> str:
        return "int8" if self.tiles.dtype == torch.int8 else "bf16"

    def device_bytes(self) -> dict:
        """Bytes the index holds on its device: the scan tiles with their
        ids, norms and scales, the centroids, and the f32 master."""
        def nbytes(t):
            return 0 if t is None else t.numel() * t.element_size()

        tiles = sum(nbytes(t) for t in (self.tiles, self.tile_ids, self.tile_norms,
                                        self.tile_scales, self.centroids))
        return {"tiles": tiles, "f32_master": nbytes(self.vectors),
                "total": tiles + nbytes(self.vectors)}

    def search(self, queries, k: int = 10, n_probe: int = 32):
        """(dists [B, k], ids int32 [B, k]) ascending, -1 / +inf where
        fewer than k points were probed. Queries are walked in chunks
        whose probe operand stays under `_PROBE_BYTES`; results do not
        depend on the chunk."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        if q.ndim == 1:
            q = q[None, :]
        n_probe = min(n_probe, self.n_cells)
        cap, d = self.tiles.shape[1], self.tiles.shape[2]
        step = max(1, _PROBE_BYTES // (cap * d * 4))
        outs = [
            _probe_search(
                q[i : i + step], self.centroids, self.tiles, self.tile_ids, self.tile_norms,
                self.vectors, self.tile_scales, k=k, n_probe=n_probe, metric=self.metric,
            )
            for i in range(0, q.shape[0], step)
        ]
        if len(outs) == 1:
            return outs[0]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def tiles_from_ids(
    vectors: np.ndarray,
    tile_ids: np.ndarray,
    tile_precision: str,
    *,
    master: torch.Tensor | None = None,
    device: str | torch.device = "cuda",
):
    """The [C, cap, D] scan tiles of a tile layout, from the f32 master.

    Owns the probe's masking invariants — pad rows zeroed, pad norms
    +inf — and the tile precision, in one place shared by `build_ivf` and
    `persist.load_ivf_index`. The rows are gathered from `master` (the
    device copy of `vectors`; uploaded when not given) and quantized on
    its device, cells in chunks; the norms are numpy's per-row f32 sums of
    the host `vectors`, the JAX package's own, so both hold the same bits.

    Returns (tiles, tile_norms f32 [C, cap], tile_scales f32 [C, cap] |
    None), on the master's device."""
    if tile_precision not in ("int8", "bf16"):
        raise ValueError(f"unknown tile_precision: {tile_precision!r}")
    from diskrag_tpu_torch.ops.flat_scan import quantize_int8

    vectors = np.asarray(vectors, np.float32)
    tile_ids = np.asarray(tile_ids, np.int32)
    n, d = vectors.shape
    c, cap = tile_ids.shape
    pad = tile_ids == INVALID_ID
    norms = np.sum(vectors * vectors, axis=-1, dtype=np.float32)
    tile_norms = norms[np.clip(tile_ids, 0, n - 1)]
    tile_norms[pad] = np.inf
    if master is None:
        master = torch.as_tensor(vectors, device=resolve_device(device))
    dev = master.device
    ids_t = torch.as_tensor(tile_ids, device=dev)
    int8 = tile_precision == "int8"
    tiles = torch.empty((c, cap, d), dtype=torch.int8 if int8 else torch.bfloat16, device=dev)
    scales = torch.empty((c, cap), dtype=torch.float32, device=dev) if int8 else None
    step = max(1, _BLOCK_BYTES // (cap * d * 4))
    for c0 in range(0, c, step):
        tid = ids_t[c0 : c0 + step]
        rows = master[torch.clamp(tid, 0, n - 1).long()]
        rows = torch.where((tid == INVALID_ID)[..., None], 0.0, rows)
        if int8:
            tiles[c0 : c0 + step], scales[c0 : c0 + step] = quantize_int8(rows)
        else:
            tiles[c0 : c0 + step] = rows.to(torch.bfloat16)
    return tiles, torch.as_tensor(tile_norms, device=dev), scales


def default_n_cells(n: int) -> int:
    """The JAX package's cell count: 4 sqrt(N), at least 16, at most N / 8."""
    return int(max(16, min(4 * np.sqrt(n), n // 8)))


def _lap(stage_seconds: dict | None, stage: str, t: float, dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    now = time.perf_counter()
    if stage_seconds is not None:
        stage_seconds[stage] = now - t
    return now


def assign_cells(
    vectors: np.ndarray,
    centroids: torch.Tensor,
    cap: int,
    *,
    metric: str = "l2",
    master: torch.Tensor | None = None,
    stage_seconds: dict | None = None,
) -> np.ndarray:
    """The tile layout of `vectors` (host f32 [N, D]) over the cells of
    `centroids` ([C, D], on the device the work runs on): int32 [C, cap]
    point ids, -1 at pads.

    Each point ranks its 8 nearest cells by the score the probe uses (L2
    by distance, cosine and dot by dot: an assignment that disagreed with
    the probe would place points in cells no query visits), in full f32;
    then rounds of capacity-aware placement take each point to its first
    choice with room, ranked within a cell by point order; stragglers go
    to their nearest cell with room. `master` is the device copy of
    `vectors` when the caller holds one. `stage_seconds` receives
    "assign" (the choices) and "place" (the rest)."""
    vectors = np.asarray(vectors, np.float32)
    n = len(vectors)
    dev = centroids.device
    cj = centroids.to(torch.float32)
    n_cells = cj.shape[0]
    n_choice = min(8, n_cells)
    l2_cells = Metric(metric) == Metric.L2
    cn = torch.sum(cj * cj, -1)[None, :]
    t = time.perf_counter()
    choices = np.empty((n, n_choice), np.int32)
    step = max(1, _BLOCK_BYTES // (n_cells * 4 * 3))  # cross, score, the sort's copy
    for i in range(0, n, step):
        q = master[i : i + step] if master is not None else torch.as_tensor(
            vectors[i : i + step], device=dev)
        cross = q @ cj.T
        dist = cn - 2.0 * cross if l2_cells else -cross
        choices[i : i + step] = topk_smallest(dist, n_choice)[1].cpu().numpy()
    t = _lap(stage_seconds, "assign", t, dev)

    # capacity-aware placement: rank points within each chosen cell by
    # choice round; spill to the next choice when a cell is full
    assigned = np.full(n, -1, np.int64)
    remaining = np.full(n_cells, cap, np.int64)
    todo = np.arange(n)
    for round_i in range(n_choice):
        if len(todo) == 0:
            break
        want = choices[todo, round_i].astype(np.int64)
        order = np.argsort(want, kind="stable")
        w_sorted = want[order]
        first = np.searchsorted(w_sorted, np.arange(n_cells), side="left")
        pos_in_cell = np.arange(len(order)) - first[w_sorted]
        ok = pos_in_cell < remaining[w_sorted]
        placed = todo[order[ok]]
        assigned[placed] = w_sorted[ok]
        remaining -= np.bincount(w_sorted[ok], minlength=n_cells)
        todo = todo[order[~ok]]
    if len(todo):
        # stragglers go to their NEAREST cell with space (by the same
        # score), through a preference list of the 16 nearest open cells
        centroids_np = cj.cpu().numpy()
        open_cells = np.flatnonzero(remaining > 0)
        slack = remaining[open_cells].copy()
        oc = centroids_np[open_cells]
        oc_norm = np.sum(oc * oc, axis=-1)
        n_pref = min(16, len(open_cells))
        for s in range(0, len(todo), 4096):
            chunk = todo[s : s + 4096]
            if l2_cells:
                d2 = oc_norm[None, :] - 2.0 * vectors[chunk] @ oc.T
            else:
                d2 = -(vectors[chunk] @ oc.T)
            pref = np.argpartition(d2, n_pref - 1, axis=1)[:, :n_pref]
            pref = np.take_along_axis(pref, np.argsort(np.take_along_axis(d2, pref, 1), 1), 1)
            for row, p in enumerate(chunk):
                for j in pref[row]:
                    if slack[j] > 0:
                        assigned[p] = open_cells[j]
                        slack[j] -= 1
                        break
                else:  # every preferred cell full: the least-filled one
                    j = int(np.argmax(slack))
                    assigned[p] = open_cells[j]
                    slack[j] -= 1

    tile_ids = np.full((n_cells, cap), INVALID_ID, np.int32)
    order = np.argsort(assigned, kind="stable")
    a_sorted = assigned[order]
    first = np.searchsorted(a_sorted, np.arange(n_cells), side="left")
    pos = np.arange(n) - first[a_sorted]
    tile_ids[a_sorted, np.minimum(pos, cap - 1)] = order
    _lap(stage_seconds, "place", t, dev)
    return tile_ids


def build_ivf(
    vectors: np.ndarray,
    n_cells: int | None = None,
    *,
    metric: str = "l2",
    seed: int = 0,
    max_train: int | None = None,
    cap_factor: float = 2.0,
    kmeans_iters: int = 12,
    tile_precision: str = "int8",
    rerank_master: torch.Tensor | None = None,
    device: str | torch.device = "cuda",
    stage_seconds: dict | None = None,
) -> IVFIndex:
    """Train cells (batched k-means with one-shot D² seeding), assign with
    capacity-aware spill (`assign_cells`) and lay the members out as
    padded scan tiles (`tiles_from_ids`): the JAX package's `build_ivf`,
    with its defaults.

    `n_cells` (None: 4 sqrt(N), within [16, N / 8]); `max_train` (None:
    max(131072, 24 C)) caps the k-means sample, drawn with numpy's
    `default_rng(seed)` as in the JAX package; `cap_factor` bounds each
    cell's tile at `cap_factor * N / C` rows — the recall-ceiling knob:
    points that fit none of their 8 nearest cells land where queries
    never probe; below 1 it is refused (the tiles could not hold N
    points). `rerank_master`: the device copy of `vectors` when the caller
    holds one (the kNN pass does), so no second copy is uploaded; it also
    sets the device. `stage_seconds` receives "fit", "assign", "place"
    and "tiles", each closed by a device synchronisation."""
    from diskrag_tpu_torch.pq.kmeans import kmeans_fit, make_generator

    vectors = np.asarray(vectors, np.float32)
    n, _ = vectors.shape
    metric = Metric(metric).value
    if cap_factor < 1.0:
        raise ValueError(f"cap_factor must be >= 1, got {cap_factor}")
    if n_cells is None:
        n_cells = default_n_cells(n)
    if max_train is None:
        max_train = max(131_072, 24 * n_cells)
    cap = int(np.ceil(cap_factor * n / n_cells))
    dev = rerank_master.device if rerank_master is not None else resolve_device(device)

    t = time.perf_counter()
    rng = np.random.default_rng(seed)
    train = vectors
    if n > max_train:
        train = vectors[rng.choice(n, size=max_train, replace=False)]
    centers, _ = kmeans_fit(
        make_generator(seed, dev), torch.as_tensor(train, device=dev)[None], n_cells,
        max_iter=kmeans_iters, init="d2",
    )
    centroids = centers[0]
    master = rerank_master if rerank_master is not None else torch.as_tensor(vectors, device=dev)
    t = _lap(stage_seconds, "fit", t, dev)
    tile_ids = assign_cells(vectors, centroids, cap, metric=metric, master=master,
                            stage_seconds=stage_seconds)
    t = time.perf_counter()
    tiles, tile_norms, tile_scales = tiles_from_ids(vectors, tile_ids, tile_precision, master=master)
    index = IVFIndex(
        centroids=centroids, tiles=tiles, tile_ids=torch.as_tensor(tile_ids, device=dev),
        tile_norms=tile_norms, vectors=master, metric=metric, tile_scales=tile_scales,
    )
    _lap(stage_seconds, "tiles", t, dev)
    return index
