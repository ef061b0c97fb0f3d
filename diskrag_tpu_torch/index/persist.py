"""Index persistence — the flat-index part of `diskrag_tpu/index/persist.py`.

Same artifact layout and `FORMAT_VERSION`, so an index written by either
package loads in the other:

    index/
      vectors.npy        float32[N, D]
      meta.json          params + stats

Writes are atomic (`.tmp` then rename).
"""

from __future__ import annotations

import json
import os
import pathlib

import numpy as np

FORMAT_VERSION = "tpu-1"


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
    def meta_path(self):
        return self.dir / "meta.json"

    def exists(self) -> bool:
        return self.meta_path.exists() and self.vectors_path.exists()


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
