"""Host-offload index tier (counterpart of `diskrag_tpu/index/host_tier.py`):
the analog of the reference's disk-resident index (mmap + beam search over
on-disk records, reference vamana_graph.py:719-760 +
io/diskann_persist.py:209-235).

Memory layout:
  - device: adjacency int32[N, R] and a compressed traversal form — a
    guide (`graph/guided.py`): PQ codes uint8[N, m] (`mode="pq"`, the ADC
    lookup by id, kernel B5, once a round) or IntQuantizer int8 rows
    (`mode="iq"`, `pq/intq.py`, plain PyTorch); or bfloat16 vectors
    (`mode="bf16"`);
  - host: the float32 vectors in the packed record file (`index.dat`),
    read by the native batched reader (`diskrag_tpu_torch.native`);
  - a query batch: compressed-guided traversal on the device -> candidate
    pool (beam ∪ visited) ids to the host -> batched host gather of the
    pool's full vectors -> exact rerank on the host (numpy BLAS).

The rerank stays on the host because the pool's vectors live there; only
ids cross to it.

With tracing on (`utils/profiling.py`) both searches record one set of
spans: `host_tier.traverse` a chunk (its pool's copy to the host,
`host_tier.pool_copy`, inside), `host_tier.rerank` a chunk (made of
`host_tier.rerank.unique`, `.gather`, `.products` and `.select`, the
pieces of `exact_rerank_pool`) and, pipelined, `host_tier.rerank_wait`;
the counter `host_tier.vectors_fetched` adds the unique rows read.
"""

from __future__ import annotations

import concurrent.futures
import contextvars
import dataclasses
import json
import logging
import time

import numpy as np
import torch

from diskrag_tpu_torch.device import resolve_device
from diskrag_tpu_torch.graph.guided import Guide, load_guide, traversal_mode
from diskrag_tpu_torch.graph.search import beam_search
from diskrag_tpu_torch.native import RecordReader
from diskrag_tpu_torch.ops.topk import INVALID_ID
from diskrag_tpu_torch.utils.profiling import count, span

logger = logging.getLogger(__name__)


def exact_rerank_pool(
    queries: np.ndarray,
    pool: np.ndarray,
    reader: RecordReader,
    *,
    metric: str,
    k: int,
    n_threads: int = 8,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Host-side exact rerank of candidate-pool ids.

    queries [B, D] f32, pool [B, P] int global ids (-1 = invalid) ->
    (dists [B, k] squared / float64, ids [B, k] int64, n_unique_fetched).
    Dedups ids before the gather (hot nodes appear in many pools; sorted
    unique reads make the mmap access near-sequential), computes norms
    once on the unique set, uses batched BLAS for the cross term, and
    drops duplicate ids per row with an id-sorted first-occurrence mask.
    """
    b, p = pool.shape
    with span("host_tier.rerank.unique"):
        # -1 padding clips to row 0; its distance is masked to +inf below
        flat = np.maximum(pool.reshape(-1).astype(np.int64), 0)
        uniq, inverse = np.unique(flat, return_inverse=True)
    with span("host_tier.rerank.gather"):
        uvecs = reader.get_vectors(uniq, n_threads=n_threads)
        vecs = uvecs[inverse].reshape(b, p, -1)

    with span("host_tier.rerank.products"):
        q_np = np.asarray(queries, np.float32)
        if metric == "cosine":
            qh = q_np / (np.linalg.norm(q_np, axis=1, keepdims=True) + 1e-12)
            un = np.linalg.norm(uvecs, axis=1) + 1e-12
            cos = np.matmul(vecs, qh[:, :, None])[:, :, 0]
            exact = 1.0 - cos / un[inverse].reshape(b, p)
        elif metric == "dot":
            exact = -np.matmul(vecs, q_np[:, :, None])[:, :, 0]
        else:
            qn = np.sum(q_np * q_np, axis=1, keepdims=True)
            un = np.sum(uvecs * uvecs, axis=1)
            cross = np.matmul(vecs, q_np[:, :, None])[:, :, 0]
            exact = np.maximum(qn + un[inverse].reshape(b, p) - 2.0 * cross, 0.0)
        exact = np.where(pool == INVALID_ID, np.inf, exact)

    with span("host_tier.rerank.select"):
        # drop duplicate ids per row (the first occurrence in id-sorted order
        # keeps its distance, repeats are masked)
        id_order = np.argsort(pool, axis=1, kind="stable")
        pool_by_id = np.take_along_axis(pool, id_order, axis=1)
        dup = np.zeros_like(pool_by_id, bool)
        dup[:, 1:] = pool_by_id[:, 1:] == pool_by_id[:, :-1]
        dup_mask = np.zeros_like(dup)
        np.put_along_axis(dup_mask, id_order, dup, axis=1)
        exact = np.where(dup_mask, np.inf, exact)

        if p < k:  # keep the [B, k] output contract
            pad = k - p
            pool = np.pad(pool, ((0, 0), (0, pad)), constant_values=INVALID_ID)
            exact = np.pad(exact, ((0, 0), (0, pad)), constant_values=np.inf)
        order = np.argsort(exact, axis=1, kind="stable")[:, :k]
        ids = np.take_along_axis(pool, order, axis=1).astype(np.int64)
        dists = np.take_along_axis(exact, order, axis=1).astype(np.float64)
        invalid = ~np.isfinite(dists)
        ids[invalid] = INVALID_ID
        dists[invalid] = np.inf
    count("host_tier.vectors_fetched", int(len(uniq)))
    return dists, ids, int(len(uniq))


@dataclasses.dataclass
class HostTierIndex:
    """Graph + compressed traversal data on the device, f32 vectors on the
    host."""

    adjacency: torch.Tensor   # [N, R] on the device
    medoid: torch.Tensor
    reader: RecordReader      # host-side full vectors
    guide: Guide | None = None  # pq / iq traversal; None: bf16
    vectors_bf16: torch.Tensor | None = None   # [N, D] bf16 (bf16 mode)
    metric: str = "l2"
    entry_points: torch.Tensor | None = None   # [S] extra search seeds

    @property
    def device(self) -> torch.device:
        return self.adjacency.device

    @property
    def mode(self) -> str:
        """"pq" | "iq" | "bf16"."""
        return "bf16" if self.guide is None else self.guide.mode

    @classmethod
    def from_store(
        cls,
        index_dir,
        cache_capacity: int = 65_536,
        mode: str | None = None,
        gather_pad: bool = True,
        *,
        device: str = "cuda",
    ) -> "HostTierIndex":
        """Open a persisted index directory that holds the packed record
        file (`index.dat`). `mode` None picks "iq" for IntQuantizer
        artifacts, "pq" for plain / residual ADC codes, else "bf16"
        (always "bf16" on a non-L2 index). bf16 mode converts
        `vectors.npy` to bf16 on the host, in chunks, and makes one copy
        to the device: device memory peaks at exactly N * D * 2 bytes; the
        f32 master stays on the host, read through the record file for
        the rerank."""
        from diskrag_tpu_torch.index.persist import IndexStore

        dev = resolve_device(device)
        store = IndexStore(index_dir)
        meta = json.loads(store.meta_path.read_text())
        if not store.compat_path.exists():
            raise FileNotFoundError(
                f"host-tier mode needs the packed record file {store.compat_path} "
                "(save with write_compat=True)"
            )
        mode = traversal_mode(store, meta, mode)
        if mode == "bf16" and not store.vectors_path.exists():
            # bf16 mode reads the f32 master from vectors.npy (the record
            # file interleaves it with neighbour ids)
            raise FileNotFoundError(
                f"host-tier bf16 mode needs {store.vectors_path} alongside the "
                "record file (standard save_index output); pq mode serves "
                "record-file-only layouts"
            )
        reader = RecordReader(
            store.compat_path, meta["num_points"], meta["dimension"], meta["R"],
            cache_capacity=cache_capacity,
        )
        adjacency = torch.as_tensor(np.load(store.adjacency_path), device=dev)
        guide = vec_bf16 = None
        if mode != "bf16":
            guide = load_guide(store, device=dev)
            if gather_pad:
                guide = guide.gather_padded()
            guide = guide.to(dev)
        else:
            vecs = np.load(store.vectors_path, mmap_mode="r")
            host_bf16 = torch.empty(vecs.shape, dtype=torch.bfloat16)
            step = 262_144
            for i in range(0, vecs.shape[0], step):
                host_bf16[i : i + step] = torch.from_numpy(np.array(vecs[i : i + step]))
            vec_bf16 = host_bf16.to(dev)
            del host_bf16
        eps = meta.get("entry_points")
        return cls(
            adjacency=adjacency,
            medoid=torch.as_tensor(int(meta["medoid_idx"]), dtype=torch.int32, device=dev),
            reader=reader, guide=guide, vectors_bf16=vec_bf16,
            metric=meta.get("distance_metric", "l2"),
            entry_points=None if eps is None else torch.as_tensor(
                np.asarray(eps, np.int32), device=dev),
        )

    def device_bytes(self) -> int:
        """Bytes the tier holds on its device (graph, traversal form,
        seeds, residual aux)."""
        guide = () if self.guide is None else self.guide.arrays()
        return sum(int(t.numel() * t.element_size()) for t in (
            self.adjacency, self.vectors_bf16, self.entry_points, *guide) if t is not None)

    def _traverse(self, q: torch.Tensor, *, search_width: int, expand_width: int):
        """One traversal of a query chunk on the device: (SearchResult,
        pool [B, P] = beam ∪ visited, still on the device)."""
        if self.guide is not None:
            res = self.guide.search(
                self.guide.tables(q), self.adjacency, self.medoid,
                search_width=search_width, k=search_width, rerank=False,
                expand_width=expand_width, entry_points=self.entry_points,
            )
        else:
            res = beam_search(
                self.vectors_bf16, self.adjacency, self.medoid, q,
                search_width=search_width, k=search_width, metric=self.metric,
                expand_width=expand_width, entry_points=self.entry_points,
            )
        return res, torch.cat([res.ids, res.visited_ids], dim=1)

    def _traverse_to_host(self, chunk: int, q_np: np.ndarray, *, search_width: int,
                          expand_width: int, rerank_pool: int | None):
        """(pool [B, P] int32 numpy, nodes expanded, rounds) of one chunk:
        the traversal, then the pool's ids (only the reranked prefix when
        `rerank_pool` cuts it) copied to the host."""
        with span("host_tier.traverse", chunk=chunk):
            q = torch.as_tensor(q_np, device=self.device)
            res, pool = self._traverse(q, search_width=search_width, expand_width=expand_width)
            if rerank_pool is not None and pool.shape[1] > rerank_pool:
                pool = pool[:, :rerank_pool]
            with span("host_tier.pool_copy"):
                pool_np = pool.cpu().numpy()
            return pool_np, int(torch.sum(res.n_expanded)), int(res.n_steps)

    def _rerank(self, chunk: int, q_np: np.ndarray, pool: np.ndarray, *, k: int,
                n_threads: int):
        """The exact rerank of one chunk's pool on the host."""
        with span("host_tier.rerank", chunk=chunk):
            return exact_rerank_pool(q_np, pool, self.reader, metric=self.metric, k=k,
                                     n_threads=n_threads)

    def search(
        self,
        queries: np.ndarray,
        *,
        search_width: int,
        k: int,
        expand_width: int = 4,
        rerank_pool: int | None = None,
        n_threads: int = 8,
    ) -> tuple[np.ndarray, np.ndarray, dict]:
        """Compressed traversal on the device + exact rerank on the host.

        Returns (dists [B, k] squared, ids [B, k], stats)."""
        t0 = time.perf_counter()
        q_np = np.asarray(queries, np.float32)
        if q_np.ndim == 1:
            q_np = q_np[None, :]
        pool, n_exp, rounds = self._traverse_to_host(
            0, q_np, search_width=search_width, expand_width=expand_width, rerank_pool=rerank_pool)
        t1 = time.perf_counter()
        dists, ids, n_uniq = self._rerank(0, q_np, pool, k=k, n_threads=n_threads)
        t2 = time.perf_counter()
        stats = {
            "search_type": "host_tier",
            "mode": self.mode,
            "nodes_visited": n_exp,
            "rounds": rounds,
            "host_vectors_fetched": n_uniq,
            "cache": self.reader.cache_stats(),
            "stage_ms": {
                "traverse_and_fetch": (t1 - t0) * 1e3,
                "gather_rerank_select": (t2 - t1) * 1e3,
            },
        }
        return dists, ids, stats

    def search_pipelined(
        self,
        queries: np.ndarray,
        *,
        search_width: int,
        k: int,
        chunk: int = 256,
        expand_width: int = 4,
        rerank_pool: int | None = None,
        n_threads: int = 8,
    ) -> tuple[np.ndarray, np.ndarray, dict]:
        """Two-stage software pipeline over query chunks: one worker thread
        gathers and reranks chunk i on the host while this thread
        traverses chunk i+1 on the device.

        The frontier loop asks the device once a round whether any query
        is still active, so a traversal blocks its thread; the rerank
        (numpy BLAS and the native reader both release the GIL) runs
        beside it. Each query's result is independent of the chunk it
        rides in, so the output equals `search()`'s. Batches of at most
        one chunk go to `search()`.

        stage_ms: "traverse" (this thread's traversals, the pools' copies
        included), "gather_rerank_select" (the worker's reranks),
        "rerank_wait" (waiting for the reranks after the last traversal)
        and "wall"."""
        q_np = np.asarray(queries, np.float32)
        if q_np.ndim == 1:
            q_np = q_np[None, :]
        b = q_np.shape[0]
        if b <= chunk:
            return self.search(
                q_np, search_width=search_width, k=k, expand_width=expand_width,
                rerank_pool=rerank_pool, n_threads=n_threads,
            )
        starts = range(0, b, chunk)

        def rerank(c: int, s: int, pool: np.ndarray):
            tr = time.perf_counter()
            out = self._rerank(c, q_np[s : s + chunk], pool, k=k, n_threads=n_threads)
            return out, time.perf_counter() - tr

        t0 = time.perf_counter()
        t_trav = 0.0
        n_exp = rounds = 0
        futures = []
        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as worker:
            for c, s in enumerate(starts):
                tt = time.perf_counter()
                pool, ne, nr = self._traverse_to_host(
                    c, q_np[s : s + chunk], search_width=search_width,
                    expand_width=expand_width, rerank_pool=rerank_pool)
                t_trav += time.perf_counter() - tt
                n_exp += ne
                rounds += nr
                futures.append(worker.submit(contextvars.copy_context().run, rerank, c, s, pool))
            tw = time.perf_counter()
            with span("host_tier.rerank_wait"):
                results = [f.result() for f in futures]
            t_wait = time.perf_counter() - tw
        out_d = np.concatenate([r[0][0] for r in results])
        out_i = np.concatenate([r[0][1] for r in results])
        stats = {
            "search_type": "host_tier",
            "mode": self.mode,
            "pipelined_chunks": len(starts),
            "nodes_visited": n_exp,
            "rounds": rounds,
            "host_vectors_fetched": sum(r[0][2] for r in results),
            "cache": self.reader.cache_stats(),
            "stage_ms": {
                "traverse": t_trav * 1e3,
                "gather_rerank_select": sum(r[1] for r in results) * 1e3,
                "rerank_wait": t_wait * 1e3,
                "wall": (time.perf_counter() - t0) * 1e3,
            },
        }
        return out_d, out_i, stats
