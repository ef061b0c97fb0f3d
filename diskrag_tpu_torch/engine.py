"""Search engine — the flat and Vamana parts of `diskrag_tpu/engine.py`.

Loads a collection's index, runs the startup self-check, and serves
`search_batch` / `search` / `search_many` / `faq_search` /
`search_with_debug` with timing and cumulative statistics. Serving mode
"auto" covers:

  - a Vamana graph (`index_type: vamana`, the default): PQ-guided
    traversal + exact rerank of beam ∪ visited ("pq_accelerated") when
    the index carries PQ artifacts, the metric is L2 and the caller did
    not turn it off — int-quantized traversal ("iq_accelerated") when
    those artifacts are IntQuantizer rows, both expanding the index
    meta's `recommended_expand_width` candidates a round (1 where the
    build recorded none); exact traversal ("exact") otherwise;
  - a flat index (`index_type: flat`), served by `ops.flat.FlatIndex`
    with the collection's precision and rerank width;
  - an IVF-Flat index (`index_type: ivf`), served by `index.ivf.IVFIndex`
    with n_probe = max(8, min(l_search // 2, cells));
  - no loadable index: brute-force mode, the flat scan over the
    collection's `vectors.npy`.

Serving mode "host_tier" serves a vamana index saved with `write_compat`
from `index.host_tier.HostTierIndex`: the graph and a compressed
traversal form on the device, the f32 vectors in the host record file,
the exact rerank on the host; batches over one chunk are pipelined. It
never degrades to brute force: a missing or broken artifact raises
`ServingConfigError`, as it does on an index other than vamana.

Serving mode "streaming" wraps the loaded vamana index in the mutable
tier (`index.streaming.StreamingIndex`): `insert_texts` appends to the
collection and the tier together, `delete_ids` tombstones rows, searches
merge the graph with the exact buffer, and `flush_index` folds the buffer
in and persists the grown index.

A sharded index (`index_type: sharded`, `parallel/`) is served over a
mesh of `mesh_devices` (default: every visible card, or the CPU for
`device="cpu"`; a list may name one device more than once), which must
hold a multiple of its shard count: mode "auto" runs exact traversal per
shard and merges the per-shard top-k ("sharded"); "sharded_flat" scans a
bf16 copy of every shard exhaustively ("sharded_flat"); "host_tier" keeps
each shard's graph and a compressed copy (pq, iq or bf16) on the devices
and reranks on the host against the record file ("sharded_host_tier").
A mesh that does not fit the shard count, and a sharded_flat request on an
index that is not sharded, raise `ServingConfigError`.

`search_batch` is `_prep_queries` (the queries go up through a pinned
buffer, without waiting) -> `_dispatch_search` (every device operation of
the batch enqueued, then its results packed into one int32 [B, 2k + 2]
tensor: ids, the f32 distances' bits, the summed expansion counter and the
rounds executed, copied into a pinned host buffer of its own behind one
CUDA event) -> `_finish_search` (waits on that event, decodes, takes the
sqrt for L2, counts the stats). `search_pipelined` runs the same three
steps over a stream of text batches: the main thread embeds and
dispatches batch i + 1 while worker threads wait on, decode and join the
texts of earlier batches; the workers launch nothing on the device.
Searches in streaming mode do not take the mutation lock, in either call.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from diskrag_tpu_torch.data.collection import CollectionManager
from diskrag_tpu_torch.device import resolve_device
from diskrag_tpu_torch.utils.profiling import request, span

logger = logging.getLogger(__name__)


def _pack(dists: torch.Tensor, ids: torch.Tensor, n_expanded: Optional[torch.Tensor],
          n_steps: Optional[torch.Tensor]) -> torch.Tensor:
    """One int32 [B, 2k + 2] tensor on the results' device: the ids, the
    f32 distances bit-viewed as int32, then the summed `n_expanded` and
    `n_steps` (0 and 0 without a graph traversal) in every row."""
    b = ids.shape[0]
    if n_expanded is None:
        counters = torch.zeros((2,), dtype=torch.int32, device=ids.device)
    else:
        counters = torch.stack([torch.sum(n_expanded).to(torch.int32),
                                n_steps.reshape(()).to(torch.int32)])
    return torch.cat([
        ids.to(torch.int32),
        dists.to(torch.float32).contiguous().view(torch.int32),
        counters[None, :].expand(b, 2),
    ], dim=1)


def _enqueue_packed(dists, ids, n_expanded=None, n_steps=None):
    """Pack a batch's device results and start their one transfer to the
    host without waiting: (host int32 [B, 2k + 2] tensor, event). On CUDA
    the pack is copied with `non_blocking=True` into a pinned tensor
    allocated for this batch alone (the caching host allocator does not
    hand it out again before the copy's stream has passed it) and the event
    is recorded on the current stream after the copy; read the tensor only
    after `event.synchronize()`. On the CPU the pack is already on the host
    and the event is None."""
    packed = _pack(dists, ids, n_expanded, n_steps)
    if packed.device.type != "cuda":
        return packed, None
    host = torch.empty(packed.shape, dtype=torch.int32, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(packed.device))
    return host, event


def _decode_packed(buf: np.ndarray, k: int):
    """(dists float64 [B, k], ids int32 [B, k], summed n_expanded, n_steps)
    of a packed [B, 2k + 2] host buffer; the arrays are copies, so the
    buffer may be released."""
    ids = np.array(buf[:, :k])
    dists = np.ascontiguousarray(buf[:, k : 2 * k]).view(np.float32).astype(np.float64)
    return dists, ids, int(buf[0, 2 * k]), int(buf[0, 2 * k + 1])


class ServingConfigError(RuntimeError):
    """A request the engine's serving configuration cannot take (a live
    insert or delete on an engine that is not in streaming mode, a
    host-tier engine over an index without its record file).
    Deliberately not a ValueError: the artifact-loading path degrades
    ValueError / FileNotFoundError to brute-force serving, and a
    configuration error must reach the operator instead."""


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
        mesh_devices: list | None = None,
    ):
        if serving_mode not in ("auto", "host_tier", "sharded_flat", "streaming"):
            raise ValueError(f"unknown serving_mode: {serving_mode}")
        self.device = resolve_device(device)
        self.mesh_devices = mesh_devices
        self.serving_mode = serving_mode
        # host-tier batches larger than this are pipelined (the host
        # reranks chunk i while the device traverses chunk i+1)
        self.host_tier_pipeline_chunk = 256
        self.collection_name = collection_name
        self._lock = threading.Lock() if use_lock else None
        self._stats: dict[str, float] = {
            "total_searches": 0,
            "total_exact_computations": 0,
            "total_pq_computations": 0,
            "total_nodes_visited": 0,
            "total_search_time": 0.0,
        }
        self.index = None
        self.guide = None       # vamana with PQ or int rows: graph/guided.py
        self.flat = None
        self.ivf = None         # index_type "ivf"
        self.host_tier = None   # serving_mode "host_tier"
        self.streaming = None   # serving_mode "streaming": index/streaming.py
        self.mesh = None        # index_type "sharded": parallel/mesh.py
        self.sharded = None     # mode "auto" on a sharded index
        self.sharded_flat = None  # mode "sharded_flat": (bf16 rows, norms, global ids)
        self.meta: dict = {}
        self.brute_force_mode = False
        self.recommended_l = 0
        with span("engine.load"):
            self.manager = CollectionManager(base_dir)
            info = self.manager.get_collection_info(collection_name)
            if info is None:
                raise ValueError(f"collection {collection_name} not found")
            self.info = info
            with span("engine.load_artifacts"):
                self._load_artifacts()
                if serving_mode == "streaming":
                    self._init_streaming()
            self.diagnostics: Optional[dict] = None
            if run_diagnostics:
                try:
                    with span("engine.diagnostic"):
                        self.diagnostics = self._run_diagnostic_check()
                except Exception as e:  # noqa: BLE001 — diagnostic is non-fatal
                    logger.warning("startup diagnostic failed (non-fatal): %s", e)

    # --- bring-up --------------------------------------------------------
    def _load_artifacts(self) -> None:
        from diskrag_tpu_torch.graph.guided import load_guide
        from diskrag_tpu_torch.index.persist import (
            IndexStore, load_flat_vectors, load_index, load_ivf_index,
        )
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
        if self.serving_mode == "sharded_flat" and self.index_type != "sharded":
            raise ServingConfigError(
                f"sharded_flat serving needs a sharded index, got {self.index_type}"
            )
        if self.index_type == "sharded":
            if self.serving_mode == "streaming":  # the mutable tier wraps one vamana graph
                raise ServingConfigError(
                    "streaming serving needs a loaded vamana index (index_type='sharded') — "
                    "build one with index type 'vamana' first"
                )
            self._load_sharded(index_dir, meta_path)
            return
        if self.serving_mode == "host_tier":
            self._load_host_tier(index_dir, meta_path)
            return
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
            if self.index_type == "ivf":
                self.ivf, self.meta = load_ivf_index(index_dir, device=self.device)
                return
            self.index, pq, codes, self.meta = load_index(index_dir, device=self.device)
        except (FileNotFoundError, ValueError) as e:
            self._brute_force(e, metric_hint)
            return
        if pq is not None:
            # a torn residual aux is recomputed from the resident vectors
            self.guide = load_guide(IndexStore(index_dir), device=self.device, pq=pq, codes=codes,
                                    vectors=self.index.vectors).to(self.device)
        self.recommended_l = int(self.meta.get("recommended_search_L", 64))

    @property
    def use_pq(self) -> bool:
        """Whether the loaded vamana index carries a guide (PQ or int rows)."""
        return self.guide is not None

    def _brute_force(self, why: Exception, metric: str) -> None:
        """Graceful degradation of mode "auto" to brute force over the
        collection's raw vectors, keeping its metric."""
        from diskrag_tpu_torch.ops.flat import FlatIndex

        logger.warning("index not loadable (%s) — brute-force mode over vectors.npy", why)
        self.brute_force_mode = True
        vecs = np.load(self.manager.get_vectors_path(self.collection_name))
        self.flat = FlatIndex(vecs, metric=metric, device=self.device)
        self.meta = {"distance_metric": metric}

    def _load_host_tier(self, index_dir, meta_path) -> None:
        """The single-card host tier over a vamana index with its record
        file. Configuration errors, and artifacts that are missing or
        broken, raise `ServingConfigError`: an explicit host-tier request
        never degrades to a brute-force load of the full f32 set it
        exists to keep off the device."""
        from diskrag_tpu_torch.index.host_tier import HostTierIndex
        from diskrag_tpu_torch.index.persist import IndexStore

        if self.index_type != "vamana":
            # the JAX package's message (its host tier also serves a sharded index)
            raise ServingConfigError(
                f"host_tier serving needs a vamana or sharded index, got {self.index_type}"
            )
        compat = IndexStore(index_dir).compat_path
        if not compat.exists():
            raise ServingConfigError(
                f"host_tier serving needs the packed record file {compat} "
                "(build with write_compat)"
            )
        try:
            self.host_tier = HostTierIndex.from_store(index_dir, device=self.device)
            self.meta = json.loads(meta_path.read_text())
        except (FileNotFoundError, ValueError) as e:
            raise ServingConfigError(f"host_tier serving could not load its artifacts: {e}") from e
        self.recommended_l = int(self.meta.get("recommended_search_L", 64))

    def _make_mesh(self, n_shards: int):
        """The serving mesh of a sharded index over `mesh_devices`: a
        device count that is not a multiple of the shard count is a
        configuration error, never a reason to serve something else."""
        from diskrag_tpu_torch.parallel import make_mesh

        devices = self.mesh_devices
        if devices is None:
            devices = (["cpu"] if self.device.type == "cpu"
                       else [f"cuda:{i}" for i in range(torch.cuda.device_count())])
        ndev = len(devices)
        if ndev % n_shards:
            raise ServingConfigError(
                f"sharded index has {n_shards} shards but {ndev} device(s) are given "
                f"(mesh_devices={[str(d) for d in devices]}) — serving needs "
                "len(mesh_devices) % n_shards == 0 (one shard per mesh slot; a device "
                "may be named more than once)"
            )
        return make_mesh(n_shards=n_shards, n_data=ndev // n_shards, devices=devices)

    def _load_sharded(self, index_dir, meta_path) -> None:
        """A sharded index in mode "auto" (placed on the mesh), "sharded_flat"
        (a bf16 copy and f32 norms per shard) or "host_tier" (compressed
        copy per shard, f32 rerank from the record file). A missing or
        broken artifact degrades mode "auto" to brute force, as for every
        index type, and raises `ServingConfigError` in the other modes."""
        from diskrag_tpu_torch.parallel import load_sharded_index, place

        try:
            self.meta = json.loads(meta_path.read_text())
            self.mesh = self._make_mesh(int(self.meta["n_shards"]))
            self.recommended_l = int(self.meta.get("recommended_search_L", 64))
            if self.serving_mode == "host_tier":
                self._load_sharded_host_tier(index_dir)
            elif self.serving_mode == "sharded_flat":
                idx = load_sharded_index(index_dir / "sharded")
                v = idx.vectors
                # bf16 scan copy (cast on the host, chunked) + f32 norms summed
                # from the memory map; pad rows are masked by their -1 global id
                self.sharded_flat = (
                    place(v, self.mesh, torch.bfloat16),
                    place(np.einsum("snd,snd->sn", v, v, dtype=np.float32), self.mesh),
                    place(np.asarray(idx.global_ids), self.mesh),
                    idx.metric,
                )
            else:
                self.sharded = load_sharded_index(index_dir / "sharded", mesh=self.mesh)
        except (FileNotFoundError, ValueError, KeyError) as e:
            if self.serving_mode != "auto":
                raise ServingConfigError(
                    f"{self.serving_mode} serving could not load its artifacts: {e}") from e
            self.mesh = self.sharded = None
            self._brute_force(e, self.meta.get("distance_metric", "l2"))

    def _load_sharded_host_tier(self, index_dir) -> None:
        """The sharded host tier: pq traversal when PQ artifacts exist and
        the metric is L2 (iq for IntQuantizer rows), else bf16."""
        from diskrag_tpu_torch.graph.guided import load_guide, traversal_mode
        from diskrag_tpu_torch.index.persist import IndexStore
        from diskrag_tpu_torch.parallel import ShardedHostTier, load_sharded_index

        store = IndexStore(index_dir)
        if not store.compat_path.exists():
            raise ServingConfigError(
                f"host_tier serving needs the packed record file {store.compat_path} "
                "(build with write_compat)"
            )
        from diskrag_tpu_torch.native import RecordReader

        reader = RecordReader(
            store.compat_path, int(self.meta["num_points"]), int(self.meta["dimension"]),
            int(self.meta.get("compat_R", 0)), cache_capacity=65_536,
        )
        mode_kwargs: dict = {}
        if traversal_mode(store, self.meta) != "bf16":
            g = load_guide(store, device=self.mesh.first_device)
            mode_kwargs = {"mode": g.mode, "pq": g.pq, "codes": g.codes, "pq_cells": g.cells,
                           "pq_bias": g.bias}
        self.host_tier = ShardedHostTier.from_sharded_index(
            load_sharded_index(index_dir / "sharded"), reader, self.mesh, **mode_kwargs)

    def _diagnostic_sample(self, n_sample: int = 8):
        """(vectors f32 [S, D], ids [S]) from the storage the serving mode
        keeps: the device tensors, or the host record file of the host
        tier."""
        rng = np.random.default_rng(0)
        if self.host_tier is not None:
            n = int(self.meta["num_points"])
            ids = np.sort(rng.choice(n, size=min(n_sample, n), replace=False))
            return self.host_tier.reader.get_vectors(ids), ids
        if self.mesh is not None:
            # shard 0's rows (its pad rows, if any, sit at the end)
            if self.sharded_flat is not None:
                vectors, gids = self.sharded_flat[0], self.sharded_flat[2]
            else:
                vectors, gids = self.sharded.vectors, self.sharded.global_ids
            g = gids.shard(0).cpu().numpy()
            local = np.sort(rng.choice(int(np.sum(g >= 0)), size=min(n_sample, int(np.sum(g >= 0))),
                                       replace=False))
            vecs = vectors.shard(0)[torch.as_tensor(local, device=vectors.shard(0).device)]
            return vecs.to(torch.float32).cpu().numpy(), g[local]
        vectors = next(x for x in (self.flat, self.ivf, self.index) if x is not None).vectors
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
        mode = ("brute_force" if self.brute_force_mode
                else self.serving_mode if self.serving_mode != "auto" else self.index_type)
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

        if self.guide is not None and self.index is not None:
            vecs = self.index.vectors
            n = int(vecs.shape[0])
            sample = np.random.default_rng(0).choice(n, size=min(512, n), replace=False)
            sample_t = torch.as_tensor(sample, device=self.device)
            q = vecs[sample_t[: min(8, len(sample))]]
            adc = self.guide.adc(q, sample_t).cpu().numpy()
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
        if self.ivf is not None:
            return int(self.ivf.n_points)
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
        `l_search`, an IVF index takes its probe count from `l_search`."""
        t0 = time.perf_counter()
        with span("engine.prep"):
            q, b, l_search = self._prep_queries(query_vectors, k, l_search)
        with span("engine.dispatch"):
            disp = self._dispatch_search(q, b, k, l_search, use_pq_search)
        return self._finish_search(disp, b=b, k=k, l_search=l_search, t0=t0)

    def _prep_queries(self, query_vectors, k: int, l_search: Optional[int]):
        """(queries [B, D] f32 on the device, B, l_search). On CUDA the
        queries go up through a pinned host tensor with `non_blocking=True`:
        a copy from pageable memory would hold the host until the stream's
        earlier work is done."""
        qv = np.ascontiguousarray(query_vectors, np.float32)
        if qv.ndim == 1:
            qv = qv[None, :]
        if self.device.type == "cuda":
            q = torch.from_numpy(qv).pin_memory().to(self.device, non_blocking=True)
        else:
            q = torch.as_tensor(qv, device=self.device)
        if l_search is None:
            # the tuned value of the build is the default floor; an
            # explicit l_search overrides it either way
            l_search = max(2 * k, 20, self.recommended_l)
        return q, q.shape[0], max(l_search, k)

    def _dispatch_search(self, q: torch.Tensor, b: int, k: int, l_search: int,
                         use_pq_search: bool):
        """The active mode's search, enqueued and not waited for:
        ("packed", host buffer, k, event, meta) for device results (the
        batch's one packed transfer is on its way, `_enqueue_packed`), or
        ("host", (dists, ids), None, None, meta) for the host tier's numpy
        results. meta holds the search type, `counts`, the extra stats and
        whether a graph traversal ran (its rounds ride in the pack). Nothing
        here waits on the device after `_dispatch_branches` returns."""
        dists, ids, res, search_type, counts, extra = self._dispatch_branches(
            q, b, k, l_search, use_pq_search
        )
        meta = {"search_type": search_type, "counts": counts, "extra": extra,
                "graph": res is not None}
        if not isinstance(ids, torch.Tensor):
            return "host", (dists, ids), None, None, meta
        # every id served is a collection row (the text join reads it), so
        # the collection's size bounds them: the pack carries them as int32
        if self.info.num_vectors >= 2**31:
            raise OverflowError(
                f"{self.info.num_vectors} vectors: result ids do not fit the int32 pack")
        if res is None:
            buf, event = _enqueue_packed(dists, ids)
        else:
            buf, event = _enqueue_packed(dists, ids, res.n_expanded, res.n_steps)
        return "packed", buf, ids.shape[1], event, meta

    def _finish_search(self, disp, *, b: int, k: int, l_search: int,
                       t0: float) -> tuple[np.ndarray, np.ndarray, dict]:
        """Drain a `_dispatch_search` result: wait on the batch's event
        (which releases the GIL), decode, sqrt for L2, count the stats under
        the engine lock. Touches nothing on the device, so
        `search_pipelined` runs it on worker threads."""
        kind, payload, kk, event, meta = disp
        t_fetch = time.perf_counter()
        n_steps = 0
        with span("engine.fetch"):
            if kind == "packed":
                if event is not None:
                    event.synchronize()
                dists, ids, counter, n_steps = _decode_packed(payload.numpy(), kk)
            else:
                dists, ids = payload
                ids = np.asarray(ids)
                dists = np.asarray(dists, np.float64)
                counter = 0
        fetch_time = time.perf_counter() - t_fetch
        nodes_visited, n_exact, n_pq = meta["counts"](counter)
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
            "search_type": meta["search_type"],
            "nodes_visited": nodes_visited,
            "search_time": dt,
            "fetch_time": fetch_time,
            "k": k,
            "L_search": l_search,
        }
        if meta["graph"]:
            stats["rounds"] = n_steps  # traversal rounds executed
        stats.update(meta["extra"])
        return dists, ids, stats

    def _dispatch_branches(self, q: torch.Tensor, b: int, k: int, l_search: int,
                           use_pq_search: bool):
        """(dists, ids, graph SearchResult | None, search_type, counts,
        extra stats) of the active mode; `counts(total_expanded)` gives the
        (nodes_visited, n_exact, n_pq) stats triple. dists / ids are device
        tensors, or numpy arrays from the host tier."""
        from diskrag_tpu_torch.graph.search import beam_search

        if self.host_tier is not None:
            return self._host_tier_branch(q, b, k, l_search)
        if self.sharded_flat is not None:
            from diskrag_tpu_torch.parallel import sharded_flat_search

            v16, norms, gids, metric = self.sharded_flat
            ids, dists = sharded_flat_search(v16, norms, gids, q, self.mesh, k=k, metric=metric)
            nv = int(gids.shape[0] * gids.shape[1]) * b
            return dists, ids, None, "sharded_flat", lambda c: (nv, nv, 0), {}
        if self.sharded is not None:
            from diskrag_tpu_torch.parallel import sharded_search

            st: dict = {}
            ids, dists = sharded_search(self.sharded, q, self.mesh, search_width=l_search, k=k,
                                        stats=st)
            # every shard's expansions, summed; a candidate costs R
            # distances (the JAX package reports the bound 2 L rounds a shard)
            nv = st["nodes_expanded"]
            ne = nv * int(self.sharded.adjacency.shape[-1])
            return dists, ids, None, "sharded", lambda c: (nv, ne, 0), {
                "rounds": st["rounds"], "n_shards": self.sharded.n_shards}
        if self.streaming is not None:
            # graph beam + exact buffer scan; the ids are external ids, which
            # equal collection vector_index rows by the alignment invariant
            # (_init_streaming)
            ids, dists = self.streaming.search(q, k=k, search_width=l_search)
            nv = b * 2 * l_search  # frontier bound
            ne = nv * int(self.streaming.index.adjacency.shape[1]) + b * self.streaming.capacity
            return dists, ids, None, "streaming", lambda c: (nv, ne, 0), {}
        if self.ivf is not None:
            n_probe = max(8, min(l_search // 2, self.ivf.n_cells))
            dists, ids = self.ivf.search(q, k=k, n_probe=n_probe)
            nv = n_probe * self.ivf.tiles.shape[1] * b
            return dists, ids, None, "ivf", lambda c: (nv, nv, 0), {}
        if self.flat is not None:
            dists, ids = self.flat.search(q, k=k)
            nv = self.flat.n_points * b
            kind = "brute_force" if self.brute_force_mode else "flat"
            return dists, ids, None, kind, lambda c: (nv, nv, 0), {}
        index = self.index
        deg = index.degree_bound
        if use_pq_search and self.guide is not None and index.metric == "l2":
            # ADC / iq tables rank by squared L2 only: on a cosine / dot
            # index quantized traversal would converge to the wrong region,
            # so those metrics fall through to exact traversal below.
            # E from the index meta where the build recorded one, else 1
            e = int(self.meta.get("recommended_expand_width", 0) or 1)
            g = self.guide
            if g.kind == "iq":
                tables = g.tables(q)
            else:  # a PQ's tables: one span (`cells` 0 for a plain PQ)
                with span("engine.pq_tables", m=g.pq.n_subvectors,
                          cells=g.pq.n_coarse if g.kind == "rpq" else 0):
                    tables = g.tables(q)
            res = g.search(
                tables, index.adjacency, index.medoid,
                search_width=l_search, k=k, rerank=True,
                vectors=index.vectors, queries=q, metric=index.metric,
                expand_width=e, entry_points=index.entry_points,
            )
            ne = b * (l_search + res.visited_ids.shape[1])
            return (res.dists, res.ids, res, g.search_type,
                    lambda c: (c, ne, c * deg), {"expand_width": e})
        res = beam_search(
            index.vectors, index.adjacency, index.medoid, q,
            search_width=l_search, k=k, metric=index.metric,
            entry_points=index.entry_points,
        )
        return res.dists, res.ids, res, "exact", lambda c: (c, c * deg, 0), {}

    def _host_tier_branch(self, q: torch.Tensor, b: int, k: int, l_search: int):
        """The host tier's search: batches over one chunk pipelined
        (chunk >= half the batch: narrower chunks add traversal rounds
        faster than the overlap pays back), the expand width and the
        rerank-pool cut from the index meta when the build tuned them."""
        chunk = max(self.host_tier_pipeline_chunk, -(-b // 2))
        e = int(self.meta.get("recommended_expand_width", 0) or 4)
        kwargs = {}
        rp = int(self.meta.get("recommended_rerank_pool", 0) or 0)
        if self.mesh is not None:
            # the sharded tier's chunks are split over the data axis; its
            # pool has no truncation knob
            n_data = self.mesh.shape["data"]
            chunk = -(-chunk // n_data) * n_data
        elif rp:
            kwargs["rerank_pool"] = rp
        dists, ids, ht = self.host_tier.search_pipelined(
            q.cpu().numpy(), search_width=l_search, k=k, chunk=chunk,
            expand_width=e, **kwargs,
        )
        nv = ht["nodes_visited"]
        ne = ht["host_vectors_fetched"]
        npq = nv * int(self.host_tier.adjacency.shape[-1]) if self.host_tier.mode == "pq" else 0
        extra = {"rounds": ht["rounds"], "stage_ms": ht["stage_ms"], "mode": ht["mode"],
                 "expand_width": e, "host_vectors_fetched": ne, "cache": ht["cache"]}
        for key in ("pipelined_chunks", "n_shards"):
            if key in ht:
                extra[key] = ht[key]
        return dists, ids, None, ht["search_type"], lambda c: (nv, ne, npq), extra

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
        with request("engine.request", batch=len(queries), mode=self.serving_mode):
            t_total = time.perf_counter()
            qv = self._embed(queries, embedding_fn)
            embedding_time = time.perf_counter() - t_total
            dists, ids, stats = self.search_batch(
                qv, k=k, l_search=l_search, use_pq_search=use_pq_search
            )
            return self._joined(ids, dists, stats, t_total, embedding_time)

    def _embed(self, texts: list[str], embedding_fn) -> np.ndarray:
        """The texts' vectors f32 [B, D] (span `engine.embed`); a vector of
        another dimension than the collection's raises ValueError."""
        with span("engine.embed"):
            qv = np.stack([np.asarray(embedding_fn(t), np.float32) for t in texts])
        if qv.ndim != 2 or qv.shape[1] != self.info.dimension:
            raise ValueError(
                f"query vector dimension mismatch: expected "
                f"{self.info.dimension}, got {qv.shape}"
            )
        return qv

    def _joined(self, ids, dists, stats: dict, t_start: float, embedding_time: float) -> dict:
        """A text search's result dict: the text join of a [B, k] result,
        its timing from `t_start` and its stats."""
        results = self._attach_texts_batch(ids, dists)
        return {
            "results": results,
            "timing": {
                "embedding_time": embedding_time,
                "search_time": stats["search_time"],
                "total_time": time.perf_counter() - t_start,
            },
            "stats": stats,
        }

    def search_pipelined(
        self,
        query_batches: list[list[str]],
        k: int = 5,
        embedding_fn: Optional[Callable[[str], np.ndarray]] = None,
        l_search: Optional[int] = None,
        use_pq_search: bool = True,
        max_in_flight: int = 8,
    ) -> list[dict[str, Any]]:
        """Sustained-throughput serving over a stream of query batches:
        one `search_many`-shaped dict per batch, in order.

        The main thread embeds, prepares and dispatches batch i + 1 before
        batch i is drained; a pool of `max_in_flight` worker threads waits
        on each batch's event, decodes its packed result and joins its
        texts, and the oldest batch is drained once more than
        `max_in_flight` are pending. The workers launch nothing on the
        device (a worker's current stream is its own thread's default, not
        the one the main thread enqueued on, so a device call there would
        race or serialise). The exact graph search on the card waits on no
        round (its rounds run in one kernel, `ops/traverse.py`); the PQ- and
        iq-guided searches run the plain loop, which waits on the device
        once a round inside the dispatch, so there the overlap is only the
        drain and the join. An error in a dispatch raises here; one in a worker re-raises from
        its future."""
        import concurrent.futures as cf
        import contextvars
        from collections import deque

        if embedding_fn is None:
            raise ValueError("embedding_fn is required to embed the queries")
        if not query_batches or any(not qs for qs in query_batches):
            raise ValueError("query_batches must be non-empty batches")
        out: list[Any] = [None] * len(query_batches)

        def finish_and_join(disp, b, ls, t_start, t_emb):
            dists, ids, stats = self._finish_search(disp, b=b, k=k, l_search=ls, t0=t_start)
            return self._joined(ids, dists, stats, t_start, t_emb)

        pending: deque = deque()
        with cf.ThreadPoolExecutor(max_workers=max(1, max_in_flight)) as ex:
            for bi, texts in enumerate(query_batches):
                # the batch's request span closes once its drain is handed
                # over; the drain's spans carry its id from the worker
                with request("engine.request", batch=len(texts), mode=self.serving_mode):
                    t_start = time.perf_counter()
                    qv = self._embed(texts, embedding_fn)
                    t_emb = time.perf_counter() - t_start
                    with span("engine.prep"):
                        q, b, ls = self._prep_queries(qv, k, l_search)
                    with span("engine.dispatch"):
                        disp = self._dispatch_search(q, b, k, ls, use_pq_search)
                    fut = ex.submit(contextvars.copy_context().run, finish_and_join,
                                    disp, b, ls, t_start, t_emb)
                pending.append((bi, fut))
                while len(pending) > max_in_flight:
                    bj, fut = pending.popleft()
                    out[bj] = fut.result()
            while pending:
                bj, fut = pending.popleft()
                out[bj] = fut.result()
        return out

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

    # --- streaming serving mode (live insert / delete) ---------------------
    def _init_streaming(self) -> None:
        """Wrap the loaded vamana index in the mutable tier.

        Row alignment: graph row i serves collection vector_index i, and
        the tier hands out external ids from N on, so the collection must
        hold at least the index's rows. Rows the collection holds past the
        index (inserts of an earlier session that were never flushed, or a
        `process` without a reindex) are adopted into the buffer, in order.
        DISKRAG_STREAMING_RESERVE pre-pads the tier for that many upcoming
        inserts (a growth event mid-serving reallocates the padded tensors)."""
        from diskrag_tpu_torch.index.streaming import StreamingIndex

        if self.brute_force_mode or self.index is None:
            raise ServingConfigError(
                "streaming serving needs a loaded vamana index "
                f"(index_type={self.index_type!r}, brute_force={self.brute_force_mode}) — "
                "build one with index type 'vamana' first"
            )
        n_index = int(self.index.adjacency.shape[0])
        n_coll = int(self.info.num_vectors)
        if n_coll < n_index:
            raise ServingConfigError(
                f"collection has {n_coll} vectors but the index covers {n_index} — the "
                "collection is behind its index (corrupt or hand-edited); rebuild before serving"
            )
        reserve = int(os.environ.get("DISKRAG_STREAMING_RESERVE", "0"))
        self.streaming = StreamingIndex(self.index, reserve_inserts=reserve)
        if n_coll > n_index:
            vecs = np.load(self.manager.get_vectors_path(self.collection_name), mmap_mode="r")
            got = self.streaming.insert(np.array(vecs[n_index:n_coll], np.float32))
            logger.info("streaming: adopted %d collection rows past the index watermark (%d..%d)",
                        len(got), n_index, n_coll - 1)

    def _mutation_lock(self):
        return self._lock if self._lock else contextlib.nullcontext()

    def insert_texts(self, texts, metadata_list=None, embedding_fn=None, vectors=None) -> np.ndarray:
        """Live-append texts (streaming mode only): embed, dedup-append to
        the collection, insert into the serving tier. Returns the assigned
        vector ids (duplicate texts are skipped, as `update_collection`
        skips them)."""
        if self.streaming is None:
            raise ServingConfigError("insert_texts requires serving_mode='streaming'")
        if metadata_list is None:
            metadata_list = [{} for _ in texts]
        if vectors is None:
            if embedding_fn is None:
                raise ValueError("need embedding_fn or precomputed vectors")
            vectors = np.stack([np.asarray(embedding_fn(t), np.float32) for t in texts])
        vectors = np.asarray(vectors, np.float32)
        with self._mutation_lock():
            info, new_vecs, new_idx = self.manager.update_collection(
                self.collection_name, vectors, texts, metadata_list, return_rows=True,
            )
            self.info = info
            if len(new_vecs) == 0:
                return np.empty((0,), np.int32)
            got = self.streaming.insert(new_vecs)
            if list(np.asarray(got)) != list(np.asarray(new_idx)):
                # alignment is the correctness invariant: never serve on
                raise RuntimeError(
                    "streaming/collection id divergence: collection assigned "
                    f"{list(new_idx[:4])}..., serving tier {list(got[:4])}..."
                )
        return np.asarray(got)

    def delete_ids(self, external_ids) -> int:
        """Tombstone rows in the serving tier by vector id (streaming mode
        only; idempotent). The collection keeps the rows until a rebuild:
        deletion is a serving-visibility operation. Returns the count of
        newly tombstoned ids; unknown ids raise KeyError before anything
        changes."""
        if self.streaming is None:
            raise ServingConfigError("delete_ids requires serving_mode='streaming'")
        with self._mutation_lock():
            return self.streaming.delete(external_ids)

    def flush_index(self) -> dict:
        """Fold the buffered inserts into the graph and persist the grown
        index over the collection's index artifacts, so a restarted engine
        (any serving mode) serves every inserted row; PQ codes are
        re-encoded over all rows. Returns {n_points, n_buffered_before}.

        Refuses with live tombstones (persisting would resurrect them on
        restart: deletions are serving-session-local) and after rows were
        compacted (a rebuild-path merge or `consolidate` dropped rows, so
        graph row i is no longer collection row i); reprocess and rebuild
        to drop rows from storage."""
        if self.streaming is None:
            raise ServingConfigError("flush_index requires serving_mode='streaming'")
        from diskrag_tpu_torch.graph.types import VamanaIndex
        from diskrag_tpu_torch.index.persist import save_index

        with self._mutation_lock():
            if self.streaming._n_deleted:
                raise ServingConfigError(
                    "flush_index with live tombstones would resurrect them on restart "
                    "(deletions are serving-session-local); rebuild the collection + "
                    "index to persist deletions"
                )
            if self.streaming.rows_compacted:
                raise ServingConfigError(
                    "flush_index after rows were compacted (a merge or consolidate dropped "
                    "deleted rows) would persist an index misaligned with the collection's "
                    "vector_index; rebuild the collection + index instead"
                )
            n_buf = self.streaming.n_buffered
            self.streaming.merge()
            n = self.streaming.n_graph
            idx = self.streaming.index
            exact = VamanaIndex(
                vectors=idx.vectors[:n], adjacency=idx.adjacency[:n], medoid=idx.medoid,
                metric=idx.metric, entry_points=idx.entry_points,
            )
            # save_index derives these from the index / PQ it is handed and
            # applies meta_extra last: carrying stale values over would
            # override the fresh ones
            derived = {
                "num_points", "medoid_idx", "entry_points", "R", "dimension", "use_pq",
                "format_version", "index_type", "distance_metric", "n_subvectors",
                "pq_centroids", "pq_kind", "pq_n_coarse", "iq_row_width", "iq_n_cells",
            }
            meta_extra = {k: v for k, v in self.meta.items() if k not in derived}
            # re-encode, so the persisted codes cover the merged rows
            pq_kwargs = {} if self.guide is None else self.guide.encode_artifacts(exact.vectors)
            save_index(self.manager.get_index_dir(self.collection_name), exact,
                       meta_extra=meta_extra, **pq_kwargs)
        return {"n_points": n, "n_buffered_before": n_buf}

    def _attach_texts(self, ids: np.ndarray, dists: np.ndarray) -> list[dict]:
        """The text join of one result row."""
        return self._attach_texts_batch(np.asarray(ids)[None, :], np.asarray(dists)[None, :])[0]

    def _attach_texts_batch(
        self, ids: np.ndarray, dists: np.ndarray
    ) -> list[list[dict]]:
        """Text join for a [B, K] result batch: one column-store lookup
        for all B*K ids."""
        with span("engine.join"):
            ids = np.asarray(ids)
            with span("engine.join.lookup"):
                found = self.manager.get_texts_by_indices(
                    self.collection_name, ids[ids >= 0].tolist()
                )
            with span("engine.join.build"):
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

