"""Search engine — the flat and Vamana parts of `diskrag_tpu/engine.py`.

Loads a collection's index, runs the startup self-check, and serves
`search_batch` / `search` / `search_many` / `faq_search` /
`search_with_debug` with timing and cumulative statistics. Serving mode
"auto" covers:

  - a Vamana graph (`index_type: vamana`, the default): PQ-guided
    traversal + exact rerank of beam ∪ visited ("pq_accelerated") when
    the index carries PQ artifacts, the metric is L2 and the caller did
    not turn it off; exact traversal ("exact") otherwise;
  - a flat index (`index_type: flat`), served by `ops.flat.FlatIndex`
    with the collection's precision and rerank width;
  - no loadable index: brute-force mode, the flat scan over the
    collection's `vectors.npy`.

The other index types (ivf, sharded) and serving modes (host_tier,
sharded_flat, streaming) raise `NotImplementedError`: those are later
slices of the port, and serving them by brute force would hide that.
Results come back to the host with one `.cpu()` per output per batch;
`search_pipelined` of the JAX package (it hides a remote device's fetch
latency) is not ported.
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
        if serving_mode not in ("auto", "host_tier", "sharded_flat", "streaming"):
            raise ValueError(f"unknown serving_mode: {serving_mode}")
        if serving_mode != "auto":
            raise NotImplementedError(
                f"serving_mode={serving_mode!r} is not ported yet (ROADMAP.md, "
                "'Modules still to port'); the port serves mode 'auto'"
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
        self.index = None
        self.pq = None
        self.codes = None       # uint8 [N, m] on the host, as loaded
        self.codes_t = None     # the same on the device
        self.pq_cells_t = None  # residual-PQ aux (pq/residual.py)
        self.pq_bias_t = None
        self.flat = None
        self.meta: dict = {}
        self.use_pq = False
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
        from diskrag_tpu_torch.index.persist import load_flat_vectors, load_index
        from diskrag_tpu_torch.ops.flat import FlatIndex

        index_dir = self.manager.get_index_dir(self.collection_name)
        meta_path = index_dir / "meta.json"
        self.index_type = "vamana"
        metric_hint = "l2"
        if meta_path.exists():
            try:
                peek = json.loads(meta_path.read_text())
                self.index_type = peek.get("index_type", "vamana")
                metric_hint = peek.get("distance_metric", "l2")
            except ValueError:
                pass
        if self.index_type not in ("vamana", "flat"):
            raise NotImplementedError(
                f"index_type={self.index_type!r} is not ported yet: the port "
                "serves vamana and flat indexes (ROADMAP.md, 'Modules still to port')"
            )
        try:
            if self.index_type == "flat":
                vecs, self.meta = load_flat_vectors(index_dir)
                self.flat = FlatIndex(
                    vecs, metric=self.meta.get("distance_metric", "l2"),
                    fused_precision=self.meta.get("flat_precision", "int8"),
                    rerank_width=self.meta.get("flat_rerank_width"),
                    device=self.device,
                )
                return
            self.index, self.pq, self.codes, self.meta = load_index(
                index_dir, device=self.device
            )
        except (FileNotFoundError, ValueError) as e:
            # graceful degradation to brute force over the collection's raw
            # vectors, keeping its metric
            logger.warning("index not loadable (%s) — brute-force mode over vectors.npy", e)
            self.brute_force_mode = True
            vecs = np.load(self.manager.get_vectors_path(self.collection_name))
            self.flat = FlatIndex(vecs, metric=metric_hint, device=self.device)
            self.meta = {"distance_metric": metric_hint}
            return
        self.use_pq = self.pq is not None
        if self.use_pq:
            self.codes_t = torch.as_tensor(self.codes, device=self.device)
            from diskrag_tpu_torch.pq.residual import ResidualPQ

            if isinstance(self.pq, ResidualPQ):
                from diskrag_tpu_torch.index.persist import IndexStore, load_pq_aux

                try:
                    cells, bias = load_pq_aux(
                        IndexStore(index_dir), expect_n=int(self.codes.shape[0])
                    )
                except ValueError as e:  # stale length — treat as torn
                    logger.warning("%s", e)
                    cells = None
                if cells is None:
                    # torn artifact set (model present, aux missing or
                    # stale): recompute from the resident vectors — cheap,
                    # and keeps the serving mode available
                    logger.warning(
                        "recomputing residual-PQ serving arrays from the index vectors"
                    )
                    cells = self.pq.coarse_assign(self.index.vectors)
                    bias = self.pq.point_bias(self.codes_t, cells)
                self.pq_cells_t = torch.as_tensor(cells, device=self.device).to(torch.int32)
                self.pq_bias_t = torch.as_tensor(bias, device=self.device).to(torch.float32)
        self.recommended_l = int(self.meta.get("recommended_search_L", 64))

    def _pq_serving_tables(self, q: torch.Tensor) -> tuple:
        """(tables, beam_search_pq aux kwargs) for the active quantizer:
        inner tables + cell / bias operands for a ResidualPQ (its serving
        decomposition, pq/residual.py), plain ADC tables otherwise."""
        if self.pq_cells_t is not None:
            return self.pq.inner_tables(q), {
                "point_cell": self.pq_cells_t,
                "point_bias": self.pq_bias_t,
                "cell_tables": self.pq.cell_tables(q),
            }
        return self.pq.compute_distance_tables(q), {}

    def _diagnostic_sample(self, n_sample: int = 8):
        rng = np.random.default_rng(0)
        vectors = self.flat.vectors if self.flat is not None else self.index.vectors
        n = vectors.shape[0]
        ids = np.sort(rng.choice(n, size=min(n_sample, n), replace=False))
        vecs = vectors[torch.as_tensor(ids, device=self.device)]
        return vecs.cpu().numpy().astype(np.float32), ids

    def _run_diagnostic_check(self) -> dict:
        """Startup self-check: vector stats on a small sample, then a
        self-retrieval probe (the sampled vectors, searched as queries,
        must find their own ids in the top-10 at a rate >= 0.8). The
        PQ-enabled vamana mode also checks the exact-vs-ADC distance
        correlation (>= 0.5) and that >= 90% of sampled ADC/exact ratios
        fall in [0.1, 10]."""
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

        if self.use_pq and self.index is not None:
            vecs = self.index.vectors
            n = int(vecs.shape[0])
            sample = np.random.default_rng(0).choice(n, size=min(512, n), replace=False)
            sample_t = torch.as_tensor(sample, device=self.device)
            q = vecs[sample_t[: min(8, len(sample))]]
            tables = self.pq.compute_distance_tables(q)
            if self.pq_cells_t is not None:  # residual PQ
                adc = self.pq.asymmetric_distance_sq(
                    tables, self.codes_t[sample_t], self.pq_cells_t[sample_t]
                )
            else:
                adc = self.pq.asymmetric_distance_sq(tables, self.codes_t[sample_t])
            adc = adc.cpu().numpy()
            exact = torch.sum((q[:, None, :] - vecs[sample_t][None, :, :]) ** 2, dim=-1)
            exact = exact.cpu().numpy()
            corrs = [float(np.corrcoef(adc[i], exact[i])[0, 1]) for i in range(len(q))]
            corr = float(np.nanmean(corrs))
            result["pq_exact_correlation"] = corr
            if corr < 0.5:
                result["passed"] = False
                logger.warning("PQ/exact correlation %.3f < 0.5 — PQ quality suspect", corr)
            # per-node ratio band [0.1, 10]; self-pairs (exact == 0) excluded
            valid = exact > 1e-12
            ratio = adc[valid] / exact[valid]
            in_band = float(np.mean((ratio >= 0.1) & (ratio <= 10.0)))
            result["pq_ratio_band_fraction"] = in_band
            if in_band < 0.9:
                result["passed"] = False
                logger.warning(
                    "only %.1f%% of sampled ADC/exact ratios fall in "
                    "[0.1, 10] — PQ distances are mis-scaled", in_band * 100,
                )
        return result

    def _n_points(self) -> int:
        if self.meta.get("num_points"):
            return int(self.meta["num_points"])
        if self.index is not None:
            return int(self.index.n_points)
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
        L2; ids [B, k]; stats). `use_pq_search=False` forces exact
        traversal on a PQ-enabled graph; a flat scan reads neither it nor
        `l_search`."""
        t0 = time.perf_counter()
        q = torch.as_tensor(
            np.asarray(query_vectors, np.float32), device=self.device
        )
        if q.ndim == 1:
            q = q[None, :]
        b = q.shape[0]
        if l_search is None:
            # the tuned value of the build is the default floor; an
            # explicit l_search overrides it either way
            l_search = max(2 * k, 20, self.recommended_l)
        l_search = max(l_search, k)
        dists_t, ids_t, res, search_type, counts = self._dispatch_branches(
            q, b, k, l_search, use_pq_search
        )
        t_fetch = time.perf_counter()
        ids = ids_t.cpu().numpy()
        dists = dists_t.cpu().numpy().astype(np.float64)
        counter = 0 if res is None else int(torch.sum(res.n_expanded))
        fetch_time = time.perf_counter() - t_fetch
        nodes_visited, n_exact, n_pq = counts(counter)
        if self.meta.get("distance_metric", "l2") == "l2":
            dists = np.sqrt(np.maximum(dists, 0.0))  # reference returns sqrt
        dt = time.perf_counter() - t0
        self._update_stats(
            total_searches=b,
            total_search_time=dt,
            total_nodes_visited=nodes_visited,
            total_exact_computations=n_exact,
            total_pq_computations=n_pq,
        )
        stats = {
            "search_type": search_type,
            "nodes_visited": nodes_visited,
            "search_time": dt,
            "fetch_time": fetch_time,
            "k": k,
            "L_search": l_search,
        }
        if res is not None:
            stats["rounds"] = int(res.n_steps)  # traversal rounds executed
        return dists, ids, stats

    def _dispatch_branches(self, q: torch.Tensor, b: int, k: int, l_search: int,
                           use_pq_search: bool):
        """(dists, ids, graph SearchResult | None, search_type, counts) of
        the active mode; `counts(total_expanded)` gives the (nodes_visited,
        n_exact, n_pq) stats triple."""
        from diskrag_tpu_torch.graph.search import beam_search, beam_search_pq

        if self.flat is not None:
            dists, ids = self.flat.search(q, k=k)
            nv = self.flat.n_points * b
            kind = "brute_force" if self.brute_force_mode else "flat"
            return dists, ids, None, kind, lambda c: (nv, nv, 0)
        index = self.index
        deg = index.degree_bound
        if use_pq_search and self.use_pq and index.metric == "l2":
            # ADC tables rank by squared L2 only: on a cosine / dot index
            # PQ-guided traversal would converge to the wrong region, so
            # those metrics fall through to exact traversal below
            tables, aux = self._pq_serving_tables(q)
            res = beam_search_pq(
                self.codes_t, tables, index.adjacency, index.medoid,
                search_width=l_search, k=k, rerank=True,
                vectors=index.vectors, queries=q, metric=index.metric,
                entry_points=index.entry_points, **aux,
            )
            ne = b * (l_search + res.visited_ids.shape[1])
            return res.dists, res.ids, res, "pq_accelerated", lambda c: (c, ne, c * deg)
        res = beam_search(
            index.vectors, index.adjacency, index.medoid, q,
            search_width=l_search, k=k, metric=index.metric,
            entry_points=index.entry_points,
        )
        return res.dists, res.ids, res, "exact", lambda c: (c, c * deg, 0)

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

    def search_with_debug(
        self,
        query: str,
        k: int = 5,
        embedding_fn: Optional[Callable[[str], np.ndarray]] = None,
        l_search: Optional[int] = None,
        use_pq_search: bool = True,
        debug_mode: bool = False,
    ) -> dict[str, Any]:
        """Debug-instrumented search: with `debug_mode`, re-runs the
        startup diagnostic, searches the same query both exactly and
        PQ-guided, and reports both result lists plus their overlap;
        without it, delegates to `search`."""
        if embedding_fn is None:
            raise ValueError("embedding_fn is required to embed the query")
        if not debug_mode:
            return self.search(
                query, k=k, embedding_fn=embedding_fn, l_search=l_search,
                use_pq_search=use_pq_search,
            )
        diagnostic = None
        if not self.brute_force_mode and self.index is not None:
            try:
                diagnostic = self._run_diagnostic_check()
            except Exception as e:  # noqa: BLE001 — diagnostic is non-fatal
                logger.error("diagnostic check failed: %s", e)
        qv = np.asarray(embedding_fn(query), np.float32)
        _, exact_ids, exact_stats = self.search_batch(
            qv, k=k, l_search=l_search, use_pq_search=False
        )
        out: dict[str, Any] = {
            "exact_results": exact_ids[0].tolist(),
            "exact_stats": exact_stats,
            "pq_results": [],
            "diagnostic": diagnostic,
            "diagnostic_passed": bool(diagnostic and diagnostic.get("passed")),
        }
        if use_pq_search and self.use_pq:
            _, pq_ids, pq_stats = self.search_batch(
                qv, k=k, l_search=l_search, use_pq_search=True
            )
            out["pq_results"] = pq_ids[0].tolist()
            out["pq_stats"] = pq_stats
            out["exact_pq_overlap"] = len(
                set(out["exact_results"]) & set(out["pq_results"])
            ) / max(k, 1)
        return out

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

