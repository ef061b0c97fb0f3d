"""Index persistence — the flat, Vamana and IVF parts of
`diskrag_tpu/index/persist.py`.

Same artifact layout and `FORMAT_VERSION`, so an index written by either
package loads in the other:

    index/
      vectors.npy        float32[N, D]
      adjacency.npy      int32[N, R], -1 padded            (vamana)
      meta.json          params + stats
      pq_codes.npy       uint8[N, m]                       (when PQ enabled)
      pq_model.npz       codebooks float32[m, 256, ds] + params
                         (+ coarse_centroids for a residual PQ)
      pq_aux.npz         point_cell int32[N], point_bias f32[N] (residual PQ)
      index.dat          packed records f32[D] ‖ u32[R]    (write_compat)
      ivf_centroids.npy  float32[C, D]                     (ivf)
      ivf_tile_ids.npy   int32[C, cap], -1 padded          (ivf)

`pq_codes.npy` holds an IntQuantizer's int8 rows [N, row_width] instead
of PQ codes when `pq_kind` is int8 / int4 (self-contained, no aux file).
Writes are atomic (`.tmp` then rename); the PQ model is reloaded before
it replaces the old one. The packed record file is what the host tier
(`index/host_tier.py`) reads its f32 vectors from.
"""

from __future__ import annotations

import json
import logging
import os
import pathlib

import numpy as np
import torch

from diskrag_tpu_torch.graph.types import VamanaIndex

logger = logging.getLogger(__name__)

FORMAT_VERSION = "tpu-1"
COMPAT_PAD = np.uint32(0xFFFFFFFF)  # an empty neighbour slot of a packed record


def _atomic_write_bytes(path: pathlib.Path, data: bytes) -> None:
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def _atomic_save_npy(path: pathlib.Path, arr: np.ndarray) -> None:
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        np.save(f, arr)
    os.replace(tmp, path)


class IndexStore:
    """Filesystem layout helper for one index directory."""

    def __init__(self, index_dir: str | os.PathLike):
        self.dir = pathlib.Path(index_dir)

    @property
    def vectors_path(self):
        return self.dir / "vectors.npy"

    @property
    def adjacency_path(self):
        return self.dir / "adjacency.npy"

    @property
    def meta_path(self):
        return self.dir / "meta.json"

    @property
    def pq_codes_path(self):
        return self.dir / "pq_codes.npy"

    @property
    def pq_model_path(self):
        return self.dir / "pq_model.npz"

    @property
    def pq_aux_path(self):
        # residual-PQ per-point serving arrays: point_cell int32[N] +
        # point_bias f32[N]
        return self.dir / "pq_aux.npz"

    @property
    def compat_path(self):
        return self.dir / "index.dat"

    def exists(self) -> bool:
        return self.meta_path.exists() and self.vectors_path.exists()


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_pq_artifacts(
    store: IndexStore,
    pq,
    pq_codes,
    coarse_ids=None,
) -> dict:
    """Persist pq_codes.npy + pq_model.npz (atomic, reload-validated);
    returns the meta keys describing them. A ResidualPQ additionally
    persists pq_aux.npz (coarse cell ids + per-point serving bias), and
    its coarse codebook rides inside pq_model.npz. An IntQuantizer
    persists its int8 rows in pq_codes.npy (self-contained: no aux
    file)."""
    from diskrag_tpu_torch.pq.intq import IntQuantizer
    from diskrag_tpu_torch.pq.residual import ResidualPQ, pq_from_arrays

    if pq_codes is None:
        raise ValueError("pq given without pq_codes")
    residual = isinstance(pq, ResidualPQ)
    intq = isinstance(pq, IntQuantizer)
    if residual and coarse_ids is None:
        raise ValueError("ResidualPQ needs coarse_ids alongside the codes")
    pq_codes = np.asarray(_np(pq_codes), np.int8 if intq else np.uint8)
    _atomic_save_npy(store.pq_codes_path, pq_codes)
    tmp = store.pq_model_path.with_suffix(".npz.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **pq.to_arrays())
    with np.load(tmp) as loaded:
        pq_from_arrays(dict(loaded), device="cpu")
    os.replace(tmp, store.pq_model_path)
    if intq:
        return {
            "pq_kind": f"int{pq.bits}",
            "iq_row_width": int(pq.row_width),
            "iq_n_cells": int(pq.n_cells),
        }
    meta = {
        "n_subvectors": int(pq.n_subvectors),
        "pq_centroids": int(pq.n_centroids),
        "pq_kind": "residual" if residual else "plain",
    }
    if residual:
        cells = np.asarray(_np(coarse_ids), np.int32)
        bias = np.asarray(_np(pq.point_bias(pq_codes, cells)), np.float32)
        tmp = store.pq_aux_path.with_suffix(".npz.tmp")
        with open(tmp, "wb") as f:
            np.savez(f, point_cell=cells, point_bias=bias)
        os.replace(tmp, store.pq_aux_path)
        meta["pq_n_coarse"] = int(pq.n_coarse)
    return meta


def replace_pq_artifacts(index_dir: str | os.PathLike, pq, pq_codes, coarse_ids=None) -> dict:
    """Swap the quantizer of a persisted index: `save_pq_artifacts`, then
    the meta's pq-family keys (every `pq_*` and `iq_*` key, `n_subvectors`
    and `use_pq`) replaced by the new quantizer's, not merged, so no key of
    the previous kind is left to mislead the serving mode's auto-detection;
    a `pq_aux.npz` left by a residual PQ goes when the new one is not
    residual. The JAX package's host-tier bench swaps its quantizers the
    same way (`benchmarks/host_tier_multi.py::train_quantizer`). Returns
    the meta written."""
    store = IndexStore(index_dir)
    extra = save_pq_artifacts(store, pq, pq_codes, coarse_ids=coarse_ids)
    if "pq_n_coarse" not in extra:
        store.pq_aux_path.unlink(missing_ok=True)
    meta = json.loads(store.meta_path.read_text())
    meta = {k: v for k, v in meta.items()
            if not k.startswith(("pq_", "iq_")) and k not in ("n_subvectors", "use_pq")}
    meta.update(extra)
    _atomic_write_bytes(store.meta_path, json.dumps(meta, indent=2).encode("utf-8"))
    return meta


def load_pq_aux(
    store: IndexStore, expect_n: int | None = None
) -> tuple[np.ndarray | None, np.ndarray | None]:
    """(point_cell int32[N], point_bias f32[N]) of a residual-PQ index,
    (None, None) when absent (plain PQ or no PQ). `expect_n` (the code
    row count) guards against a torn or stale aux file: the search clamps
    out-of-range ids instead of failing, so a length mismatch would serve
    wrong traversal distances without a word."""
    if not store.pq_aux_path.exists():
        return None, None
    with np.load(store.pq_aux_path) as z:
        cells = np.asarray(z["point_cell"], np.int32)
        bias = np.asarray(z["point_bias"], np.float32)
    if expect_n is not None and (cells.shape[0] != expect_n or bias.shape[0] != expect_n):
        raise ValueError(
            f"pq_aux.npz is stale: {cells.shape[0]} cells / "
            f"{bias.shape[0]} biases for {expect_n} code rows — rebuild "
            f"the PQ artifacts (cli doctor, or --force-rebuild)"
        )
    return cells, bias


def save_index(
    index_dir: str | os.PathLike,
    index: VamanaIndex,
    *,
    pq=None,
    pq_codes=None,
    pq_coarse_ids=None,
    meta_extra: dict | None = None,
    write_compat: bool = False,
    host_vectors: np.ndarray | None = None,
) -> dict:
    """Persist a Vamana index; returns the meta dict written.

    `host_vectors`: a host-side copy of `index.vectors`, when the caller
    still holds the numpy array the index was built from: it saves the
    device-to-host copy of the vector matrix. `write_compat` also writes
    the packed record file (`index.dat`) the host tier serves from."""
    store = IndexStore(index_dir)
    store.dir.mkdir(parents=True, exist_ok=True)
    if host_vectors is not None:
        vectors = np.asarray(host_vectors, np.float32)
        if vectors.shape != tuple(index.vectors.shape):
            raise ValueError(
                f"host_vectors shape {vectors.shape} != index {tuple(index.vectors.shape)}"
            )
    else:
        vectors = np.asarray(_np(index.vectors), np.float32)
    adjacency = np.asarray(_np(index.adjacency), np.int32)
    _atomic_save_npy(store.vectors_path, vectors)
    _atomic_save_npy(store.adjacency_path, adjacency)

    meta = {
        "format_version": FORMAT_VERSION,
        "index_type": "vamana",
        "dimension": int(vectors.shape[1]),
        "R": int(adjacency.shape[1]),
        "num_points": int(vectors.shape[0]),
        "medoid_idx": int(index.medoid),
        "distance_metric": index.metric,
        "use_pq": pq is not None,
    }
    if index.entry_points is not None:
        meta["entry_points"] = _np(index.entry_points).tolist()
    if pq is not None:
        meta.update(save_pq_artifacts(store, pq, pq_codes, coarse_ids=pq_coarse_ids))
    if meta_extra:
        meta.update(meta_extra)
    _atomic_write_bytes(store.meta_path, json.dumps(meta, indent=2).encode("utf-8"))
    if write_compat:
        write_compat_records(store.compat_path, vectors, adjacency)
    return meta


def load_index(
    index_dir: str | os.PathLike,
    *,
    to_device: bool = True,
    device: str | torch.device = "cuda",
):
    """Load (index, pq_model | None, pq_codes uint8 numpy | None, meta).
    With `to_device=False` the index tensors stay on the host (only the
    quantizer's small codebooks go to `device`)."""
    from diskrag_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    store = IndexStore(index_dir)
    if not store.exists():
        raise FileNotFoundError(f"no index at {store.dir}")
    meta = json.loads(store.meta_path.read_text())
    vectors = np.load(store.vectors_path)
    adjacency = np.load(store.adjacency_path)
    if vectors.shape[0] != meta["num_points"]:
        raise ValueError("meta/num_points mismatch with vectors.npy")
    eps = meta.get("entry_points")
    index = VamanaIndex.from_numpy(
        vectors, adjacency, meta["medoid_idx"],
        metric=meta.get("distance_metric", "l2"),
        entry_points=None if eps is None else np.asarray(eps, np.int32),
        device=dev if to_device else "cpu",
    )
    pq = None
    codes = None
    if meta.get("use_pq") and not (
        store.pq_model_path.exists() and store.pq_codes_path.exists()
    ):
        # torn artifact set (model or codes missing): serve without PQ,
        # but say so — silence would hide a half-written index dir
        missing = (
            store.pq_model_path if not store.pq_model_path.exists() else store.pq_codes_path
        )
        logger.warning(
            "meta says use_pq but %s is missing — loading without PQ "
            "(rebuild with --force-rebuild to retrain)", missing,
        )
    elif meta.get("use_pq"):
        from diskrag_tpu_torch.pq.residual import pq_from_arrays

        with np.load(store.pq_model_path) as loaded:
            pq = pq_from_arrays(dict(loaded), device=dev)
        codes = np.load(store.pq_codes_path)
        from diskrag_tpu_torch.pq.intq import IntQuantizer

        want_w = pq.row_width if isinstance(pq, IntQuantizer) else pq.n_subvectors
        if codes.shape != (meta["num_points"], want_w):
            raise ValueError(f"pq_codes shape {codes.shape} mismatch")
    return index, pq, codes, meta


def write_compat_records(
    path: str | os.PathLike, vectors: np.ndarray, adjacency: np.ndarray
) -> int:
    """Write the packed per-node record file: float32[dim] ‖ uint32[R]
    per node, record size 4 * (dim + R), an empty neighbour slot
    0xFFFFFFFF (the reference's layout, io/diskann_persist.py:15-24,
    except its padding is 0). Returns the record size in bytes."""
    n, dim = vectors.shape
    r = adjacency.shape[1]
    nbrs = adjacency.astype(np.int64)
    packed_nbrs = np.where(nbrs < 0, COMPAT_PAD, nbrs.astype(np.uint32)).astype(np.uint32)
    rec = np.empty((n, 4 * (dim + r)), np.uint8)
    rec[:, : 4 * dim] = np.ascontiguousarray(vectors.astype(np.float32)).view(np.uint8).reshape(n, -1)
    rec[:, 4 * dim:] = np.ascontiguousarray(packed_nbrs).view(np.uint8).reshape(n, -1)
    tmp = pathlib.Path(path).with_suffix(".dat.tmp")
    rec.tofile(tmp)
    os.replace(tmp, path)
    return 4 * (dim + r)


def read_compat_records(
    path: str | os.PathLike, n: int, dim: int, r: int
) -> tuple[np.ndarray, np.ndarray]:
    """Read back the packed record file (one record per node: `dim` f32
    values, then `r` uint32 neighbour ids) -> (vectors [N, D], adjacency
    [N, R] int32 with -1 padding). Memory-maps; no full copy until sliced."""
    record_size = 4 * (dim + r)
    raw = np.memmap(path, dtype=np.uint8, mode="r", shape=(n, record_size))
    vectors = raw[:, : 4 * dim].copy().view(np.float32).reshape(n, dim)
    nbrs_u = raw[:, 4 * dim:].copy().view(np.uint32).reshape(n, r)
    adjacency = np.where(nbrs_u == COMPAT_PAD, -1, nbrs_u.astype(np.int64)).astype(np.int32)
    return vectors, adjacency


def save_flat_index(
    index_dir: str | os.PathLike,
    vectors: np.ndarray,
    *,
    metric: str = "l2",
    meta_extra: dict | None = None,
) -> dict:
    """Persist a flat (exhaustive-scan) index: vectors + meta."""
    store = IndexStore(index_dir)
    store.dir.mkdir(parents=True, exist_ok=True)
    vectors = np.asarray(vectors, np.float32)
    _atomic_save_npy(store.vectors_path, vectors)
    meta = {
        "format_version": FORMAT_VERSION,
        "index_type": "flat",
        "dimension": int(vectors.shape[1]),
        "num_points": int(vectors.shape[0]),
        "distance_metric": metric,
        "use_pq": False,
    }
    if meta_extra:
        meta.update(meta_extra)
    _atomic_write_bytes(
        store.meta_path, json.dumps(meta, indent=2).encode("utf-8")
    )
    return meta


def load_flat_vectors(index_dir: str | os.PathLike) -> tuple[np.ndarray, dict]:
    """(vectors float32 [N, D], meta) of a persisted flat index."""
    store = IndexStore(index_dir)
    if not store.exists():
        raise FileNotFoundError(f"no index at {store.dir}")
    meta = json.loads(store.meta_path.read_text())
    if meta.get("index_type") != "flat":
        raise ValueError(f"not a flat index: {store.dir}")
    vectors = np.load(store.vectors_path)
    if vectors.shape[0] != meta["num_points"]:
        raise ValueError("meta/num_points mismatch with vectors.npy")
    return vectors, meta


def save_ivf_index(
    index_dir: str | os.PathLike,
    ivf,
    *,
    meta_extra: dict | None = None,
    host_vectors: np.ndarray | None = None,
) -> dict:
    """Persist an IVF-Flat index (`index.ivf.IVFIndex`): vectors,
    centroids and the tile id layout; the tiles themselves are rebuilt
    from the vectors at load, in the precision `meta.json` records.
    `host_vectors`: a host copy of `ivf.vectors`, when the caller holds
    one (saves the device-to-host copy)."""
    store = IndexStore(index_dir)
    store.dir.mkdir(parents=True, exist_ok=True)
    vectors = np.asarray(_np(ivf.vectors) if host_vectors is None else host_vectors, np.float32)
    tile_ids = np.asarray(_np(ivf.tile_ids), np.int32)
    _atomic_save_npy(store.vectors_path, vectors)
    _atomic_save_npy(store.dir / "ivf_centroids.npy", np.asarray(_np(ivf.centroids), np.float32))
    _atomic_save_npy(store.dir / "ivf_tile_ids.npy", tile_ids)
    meta = {
        "format_version": FORMAT_VERSION,
        "index_type": "ivf",
        "dimension": int(vectors.shape[1]),
        "num_points": int(vectors.shape[0]),
        "n_cells": int(ivf.n_cells),
        "cell_capacity": int(tile_ids.shape[1]),
        "distance_metric": ivf.metric,
        "tile_precision": ivf.tile_precision,
        "use_pq": False,
    }
    if meta_extra:
        meta.update(meta_extra)
    _atomic_write_bytes(store.meta_path, json.dumps(meta, indent=2).encode("utf-8"))
    return meta


def load_ivf_index(index_dir: str | os.PathLike, *, device: str | torch.device = "cuda"):
    """(IVFIndex on `device`, meta) of an index saved by either package's
    `save_ivf_index`; the scan tiles are rebuilt by `tiles_from_ids` (the
    padding invariants live there) in the meta's tile precision."""
    from diskrag_tpu_torch.device import resolve_device
    from diskrag_tpu_torch.index.ivf import IVFIndex, tiles_from_ids

    dev = resolve_device(device)
    store = IndexStore(index_dir)
    meta = json.loads(store.meta_path.read_text())
    if meta.get("index_type") != "ivf":
        raise ValueError(f"not an ivf index: {store.dir}")
    vectors = np.load(store.vectors_path)
    centroids = np.load(store.dir / "ivf_centroids.npy")
    tile_ids = np.load(store.dir / "ivf_tile_ids.npy")
    master = torch.as_tensor(vectors, device=dev)
    tiles, norms, scales = tiles_from_ids(
        vectors, tile_ids, meta.get("tile_precision", "int8"), master=master
    )
    index = IVFIndex(
        centroids=torch.as_tensor(centroids, device=dev), tiles=tiles,
        tile_ids=torch.as_tensor(tile_ids, device=dev), tile_norms=norms, vectors=master,
        metric=meta.get("distance_metric", "l2"), tile_scales=scales,
    )
    return index, meta
