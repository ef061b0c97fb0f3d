"""Index build — the flat part of `diskrag_tpu/build_index.py`.

`build_index_from_vectors` builds and persists a flat index for
`index_type="flat"`, and for `"auto"` below 100k points (the JAX
package's rule). The graph, IVF and sharded builders are later slices of
the port (ROADMAP.md, "Modules still to port"); asking for one raises
`NotImplementedError` rather than building something else.
"""

from __future__ import annotations

import json
import logging

import numpy as np

from diskrag_tpu_torch.device import resolve_device
from diskrag_tpu_torch.index.persist import IndexStore, save_flat_index

logger = logging.getLogger(__name__)

AUTO_FLAT_MAX_POINTS = 100_000


def _vector_stats(vectors: np.ndarray) -> dict:
    norms = np.linalg.norm(vectors, axis=1)
    return {
        "mean_norm": float(norms.mean()),
        "std_norm": float(norms.std()),
        "min_norm": float(norms.min()),
        "max_norm": float(norms.max()),
        "mean": float(vectors.mean()),
        "std": float(vectors.std()),
    }


def build_index_from_vectors(
    vectors: np.ndarray,
    index_dir,
    *,
    target_quality: str = "balanced",
    metric: str = "l2",
    index_type: str = "flat",
    force_rebuild: bool = False,
    flat_precision: str = "int8",
    flat_rerank_width: int | None = None,
    device: str = "cuda",
) -> dict:
    """Build + persist an index; returns its meta.

    An existing index is kept unless `force_rebuild` (a request for a
    different type is logged at WARNING, as in the JAX package). A flat
    index persists only the f32 vectors and meta: the scan table is built
    on the device at load. `device` is resolved first, so a run meant for
    the card fails here when none is visible."""
    resolve_device(device)
    store = IndexStore(index_dir)
    if not force_rebuild and store.exists():
        prev = json.loads(store.meta_path.read_text())
        prev_type = prev.get("index_type", "vamana")
        if index_type not in ("auto", prev_type):
            logger.warning(
                "existing index at %s is type=%s but type=%s was requested "
                "— keeping the existing one (use force_rebuild to convert)",
                store.dir, prev_type, index_type,
            )
        else:
            logger.info("index already exists at %s (use force_rebuild)", store.dir)
        return prev

    vectors = np.asarray(vectors)
    if vectors.dtype != np.float32:
        vectors = vectors.astype(np.float32)
    if vectors.ndim == 1:
        vectors = vectors.reshape(1, -1)
    n = vectors.shape[0]
    if n < 16:
        raise ValueError(f"need at least 16 vectors to build an index, got {n}")
    if index_type == "auto":
        index_type = "flat" if n < AUTO_FLAT_MAX_POINTS else "vamana"
    if index_type != "flat":
        raise NotImplementedError(
            f"index_type={index_type!r} is not ported yet: the port serves "
            "flat indexes; the Vamana graph, IVF and sharded builds are "
            "queued in ROADMAP.md ('Modules still to port')"
        )
    if flat_precision not in ("int8", "int8_packed", "bf16"):
        raise ValueError(f"unknown flat_precision: {flat_precision!r}")
    meta = save_flat_index(
        index_dir, vectors, metric=metric,
        meta_extra={
            "target_quality": target_quality,
            "flat_precision": flat_precision,
            "flat_rerank_width": flat_rerank_width,
            "vector_stats": _vector_stats(vectors),
        },
    )
    logger.info("flat index persisted -> %s", store.dir)
    return meta
