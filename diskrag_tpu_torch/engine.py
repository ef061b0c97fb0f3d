"""Search engine — the flat-index part of `diskrag_tpu/engine.py`.

Loads a collection's index, runs the startup self-check, and serves
`search_batch` / `search` / `search_many` / `faq_search` with timing and
cumulative statistics. Serving mode "auto" covers:

  - a flat index (`meta.json` says `index_type: flat`), served by
    `ops.flat.FlatIndex` with the collection's precision and rerank width;
  - no index at all (or an unreadable flat one): brute-force mode, the
    same flat scan over the collection's `vectors.npy`.

Every other index type (vamana, ivf, sharded) and serving mode raises
`NotImplementedError`: those are later slices of the port, and serving
them by brute force would hide that. Results come back to the host with
one plain `.cpu()` per batch.
"""

from __future__ import annotations

import contextlib
import json
import logging
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from diskrag_tpu_torch.data.collection import CollectionManager
from diskrag_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)


class SearchEngine:
    """Per-collection search engine on one device."""

    def __init__(
        self,
        collection_name: str,
        base_dir: str = "collections",
        use_lock: bool = True,
        run_diagnostics: bool = True,
        serving_mode: str = "auto",
        *,
        device: str = "cuda",
    ):
        if serving_mode != "auto":
            raise NotImplementedError(
                f"serving_mode={serving_mode!r} is not ported yet (ROADMAP.md);"
                " the port serves mode 'auto' over a flat index"
            )
        self.device = resolve_device(device)
        self.serving_mode = serving_mode
        self.collection_name = collection_name
        self.manager = CollectionManager(base_dir)
        info = self.manager.get_collection_info(collection_name)
        if info is None:
            raise ValueError(f"collection {collection_name} not found")
        self.info = info
        self._lock = threading.Lock() if use_lock else None
        self._stats: dict[str, float] = {
            "total_searches": 0,
            "total_exact_computations": 0,
            "total_pq_computations": 0,
            "total_nodes_visited": 0,
            "total_search_time": 0.0,
        }
        self.meta: dict = {}
        self.brute_force_mode = False
        self.recommended_l = 0
        self._load_artifacts()
        self.diagnostics: Optional[dict] = None
        if run_diagnostics:
            try:
                self.diagnostics = self._run_diagnostic_check()
            except Exception as e:  # noqa: BLE001 — diagnostic is non-fatal
                logger.warning("startup diagnostic failed (non-fatal): %s", e)

    # --- bring-up --------------------------------------------------------
    def _load_artifacts(self) -> None:
        from diskrag_tpu_torch.index.persist import load_flat_vectors
        from diskrag_tpu_torch.ops.flat import FlatIndex

        index_dir = self.manager.get_index_dir(self.collection_name)
        meta_path = index_dir / "meta.json"
        self.index_type = None
        metric_hint = "l2"
        if meta_path.exists():
            try:
                peek = json.loads(meta_path.read_text())
                self.index_type = peek.get("index_type", "vamana")
                metric_hint = peek.get("distance_metric", "l2")
            except ValueError:
                pass
        if self.index_type not in (None, "flat"):
            raise NotImplementedError(
                f"index_type={self.index_type!r} is not ported yet: the port "
                "serves flat indexes (ROADMAP.md, 'Modules still to port')"
            )
        if self.index_type == "flat":
            try:
                vecs, self.meta = load_flat_vectors(index_dir)
            except (FileNotFoundError, ValueError) as e:
                logger.warning("flat index not loadable (%s) — brute-force mode", e)
            else:
                self.flat = FlatIndex(
                    vecs, metric=self.meta.get("distance_metric", "l2"),
                    fused_precision=self.meta.get("flat_precision", "int8"),
                    rerank_width=self.meta.get("flat_rerank_width"),
                    device=self.device,
                )
                return
        # graceful degradation to brute force over the collection's raw
        # vectors (reference search_engine.py:49-72), keeping its metric
        logger.warning("no loadable index — brute-force mode over vectors.npy")
        self.brute_force_mode = True
        vecs = np.load(self.manager.get_vectors_path(self.collection_name))
        self.flat = FlatIndex(vecs, metric=metric_hint, device=self.device)
        self.meta = {"distance_metric": metric_hint}

    def _diagnostic_sample(self, n_sample: int = 8):
        rng = np.random.default_rng(0)
        n = self.flat.n_points
        ids = np.sort(rng.choice(n, size=min(n_sample, n), replace=False))
        vecs = self.flat.vectors[torch.as_tensor(ids, device=self.device)]
        return vecs.cpu().numpy().astype(np.float32), ids

    def _run_diagnostic_check(self) -> dict:
        """Startup self-check: vector stats on a small sample, then a
        self-retrieval probe (the sampled vectors, searched as queries,
        must find their own ids in the top-10 at a rate >= 0.8)."""
        from diskrag_tpu_torch.data.config import validate_vector_dimension

        sample_vecs, sample_gids = self._diagnostic_sample()
        dim = int(sample_vecs.shape[1])
        if not validate_vector_dimension(dim):
            logger.warning("dimension %d is outside the supported whitelist", dim)
        mode = "brute_force" if self.brute_force_mode else self.index_type
        result = {
            "vector_stats": {
                "n_points": self._n_points(),
                "dimension": dim,
                "mean_norm": float(np.mean(np.linalg.norm(sample_vecs, axis=1))),
            },
            "serving_mode": mode,
            "passed": True,
        }
        if not np.all(np.isfinite(sample_vecs)):
            result["passed"] = False
            result["finite"] = False
            logger.warning("sampled vectors contain non-finite values")
            return result
        snapshot = dict(self._stats)
        try:
            _, ids, _ = self.search_batch(sample_vecs, k=10)
        finally:
            with self._lock if self._lock else contextlib.nullcontext():
                self._stats.clear()
                self._stats.update(snapshot)
        hits = [g in set(ids[i].tolist()) for i, g in enumerate(sample_gids)]
        rate = float(np.mean(hits))
        result["self_retrieval_rate"] = rate
        if rate < 0.8:
            result["passed"] = False
            logger.warning("self-retrieval smoke probe %.2f < 0.8 in %s mode", rate, mode)
        return result

    def _n_points(self) -> int:
        if self.meta.get("num_points"):
            return int(self.meta["num_points"])
        return int(self.flat.n_points)

    # --- stats -----------------------------------------------------------
    def _update_stats(self, **updates: float) -> None:
        with self._lock if self._lock else contextlib.nullcontext():
            for k, v in updates.items():
                self._stats[k] = self._stats.get(k, 0) + v

    def get_search_statistics(self) -> dict[str, Any]:
        with self._lock if self._lock else contextlib.nullcontext():
            stats = dict(self._stats)
        n = max(stats["total_searches"], 1)
        stats["avg_search_time"] = stats["total_search_time"] / n
        stats["avg_nodes_visited"] = stats["total_nodes_visited"] / n
        exact = stats["total_exact_computations"]
        pq = stats["total_pq_computations"]
        stats["computation_reduction_rate"] = (
            pq / max(exact + pq, 1) if (exact + pq) else 0.0
        )
        return stats

    # --- core batched search --------------------------------------------
    def search_batch(
        self,
        query_vectors: np.ndarray,
        k: int = 5,
        l_search: Optional[int] = None,
        use_pq_search: bool = True,
    ) -> tuple[np.ndarray, np.ndarray, dict]:
        """Batched vector search. Returns (dists [B, k] float64, sqrt for
        L2; ids [B, k]; stats). `l_search` and `use_pq_search` are
        accepted for the JAX engine's signature; a flat scan reads neither."""
        t0 = time.perf_counter()
        q = torch.as_tensor(
            np.asarray(query_vectors, np.float32), device=self.device
        )
        if q.ndim == 1:
            q = q[None, :]
        b = q.shape[0]
        if l_search is None:
            l_search = max(2 * k, 20, self.recommended_l)
        l_search = max(l_search, k)
        dists_t, ids_t = self.flat.search(q, k=k)
        t_fetch = time.perf_counter()
        ids = ids_t.cpu().numpy()
        dists = dists_t.cpu().numpy().astype(np.float64)
        fetch_time = time.perf_counter() - t_fetch
        if self.meta.get("distance_metric", "l2") == "l2":
            dists = np.sqrt(np.maximum(dists, 0.0))  # reference returns sqrt
        nv = self.flat.n_points * b
        dt = time.perf_counter() - t0
        self._update_stats(
            total_searches=b,
            total_search_time=dt,
            total_nodes_visited=nv,
            total_exact_computations=nv,
            total_pq_computations=0,
        )
        stats = {
            "search_type": "brute_force" if self.brute_force_mode else "flat",
            "nodes_visited": nv,
            "search_time": dt,
            "fetch_time": fetch_time,
            "k": k,
            "L_search": l_search,
        }
        return dists, ids, stats

    # --- public text API -------------------------------------------------
    def search(
        self,
        query: str,
        k: int = 5,
        embedding_fn: Optional[Callable[[str], np.ndarray]] = None,
        l_search: Optional[int] = None,
        use_pq_search: bool = True,
    ) -> dict[str, Any]:
        out = self.search_many(
            [query], k=k, embedding_fn=embedding_fn, l_search=l_search,
            use_pq_search=use_pq_search,
        )
        return {**out, "results": out["results"][0]}

    def search_many(
        self,
        queries: list[str],
        k: int = 5,
        embedding_fn: Optional[Callable[[str], np.ndarray]] = None,
        l_search: Optional[int] = None,
        use_pq_search: bool = True,
    ) -> dict[str, Any]:
        """Batched text search: one device batch for the whole query
        list, per-query result lists in order."""
        if embedding_fn is None:
            raise ValueError("embedding_fn is required to embed the queries")
        if not queries:
            raise ValueError("queries must be non-empty")
        t_total = time.perf_counter()
        qv = np.stack([np.asarray(embedding_fn(q), np.float32) for q in queries])
        embedding_time = time.perf_counter() - t_total
        if qv.ndim != 2 or qv.shape[1] != self.info.dimension:
            raise ValueError(
                f"query vector dimension mismatch: expected "
                f"{self.info.dimension}, got {qv.shape}"
            )
        dists, ids, stats = self.search_batch(
            qv, k=k, l_search=l_search, use_pq_search=use_pq_search
        )
        return {
            "results": self._attach_texts_batch(ids, dists),
            "timing": {
                "embedding_time": embedding_time,
                "search_time": stats["search_time"],
                "total_time": time.perf_counter() - t_total,
            },
            "stats": stats,
        }

    def faq_search(
        self,
        query: str,
        k: int = 5,
        embedding_fn: Optional[Callable[[str], np.ndarray]] = None,
        l_search: Optional[int] = None,
    ) -> dict[str, Any]:
        """FAQ search: over-fetch 3k, dedup by qa_id, keep type=='faq'."""
        out = self.search(
            query, k=k * 3, embedding_fn=embedding_fn, l_search=l_search
        )
        seen_qa: set[str] = set()
        deduped = []
        for r in out["results"]:
            meta = r.get("metadata") or {}
            if meta.get("type") != "faq":
                continue
            qa_id = meta.get("qa_id")
            if qa_id is not None:
                if qa_id in seen_qa:
                    continue
                seen_qa.add(qa_id)
            deduped.append(r)
            if len(deduped) >= k:
                break
        out["results"] = deduped
        out["stats"]["faq_dedup"] = True
        out["stats"]["k"] = k
        return out

    def _attach_texts_batch(
        self, ids: np.ndarray, dists: np.ndarray
    ) -> list[list[dict]]:
        """Text join for a [B, K] result batch: one column-store lookup
        for all B*K ids."""
        ids = np.asarray(ids)
        found = self.manager.get_texts_by_indices(
            self.collection_name, ids[ids >= 0].tolist()
        )
        results: list[list[dict]] = []
        j = 0
        for id_row, dist_row in zip(
            ids.tolist(), np.asarray(dists, np.float64).tolist()
        ):
            row: list[dict] = []
            for idx, dist in zip(id_row, dist_row):
                if idx < 0:
                    continue
                item = found[j]
                j += 1
                if item is None:
                    continue
                text, metadata = item
                if not isinstance(metadata, dict):
                    metadata = {"id": idx, "text": text}
                row.append({"text": text, "distance": dist, "metadata": metadata})
            results.append(row)
        return results

