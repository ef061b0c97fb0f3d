"""Sharded host-offload tier (counterpart of
`diskrag_tpu/parallel/host_tier.py`): every shard's graph and a compressed
traversal copy on its device, the f32 vectors in the host record file,
the per-shard candidate pools merged.

Query flow:
  1. device: every shard traverses its local graph (bf16 vectors, or a
     guide, `graph/guided.py`: PQ codes with the ADC lookup by id, kernel
     B5, once a round, or IntQuantizer rows), globalizes its candidate
     pool (beam ∪ visited) and the pools are concatenated in shard order:
     one [B, S * P] int32 tensor, no vectors cross devices;
  2. host: one exact rerank over the pooled ids against the f32 record
     file (`index.host_tier.exact_rerank_pool`).

The f32 vectors never reach a device: a host-resident (memory-mapped)
index is cast to bf16 on the host, in chunks, and only the bf16 copy is
uploaded.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import time

import numpy as np
import torch

from diskrag_tpu_torch.graph.guided import Guide
from diskrag_tpu_torch.graph.search import beam_search
from diskrag_tpu_torch.index.host_tier import exact_rerank_pool
from diskrag_tpu_torch.native import RecordReader
from diskrag_tpu_torch.ops.distance import Metric
from diskrag_tpu_torch.ops.topk import INVALID_ID
from diskrag_tpu_torch.parallel.mesh import Mesh, PlacedShards, place
from diskrag_tpu_torch.parallel.sharded import ShardedIndex, _pad_batch, _stacked


def _local_pool(res, gid: torch.Tensor) -> torch.Tensor:
    """A shard's candidate pool (beam ∪ visited) as global ids, -1 where
    invalid: [Bd, P]."""
    ns = gid.shape[0]
    pool_local = torch.cat([res.ids, res.visited_ids], dim=1)
    return torch.where(pool_local == INVALID_ID, INVALID_ID,
                       gid[torch.clamp(pool_local, 0, ns - 1).long()])


def _pool_over_mesh(mesh: Mesh, b: int, global_ids: PlacedShards, traverse):
    """Run `traverse(i, j, rows, device) -> SearchResult` for every data
    row i and shard j over the rows of the batch that data row owns; the
    pools are concatenated in shard order on the row's first device.
    Returns (pool [B, S * P] on the mesh's first device, rounds, nodes
    expanded), rounds and nodes summed over shards and data rows."""
    n_data = len(mesh.grid)
    bd = b // n_data
    out, rounds, expanded = [], 0, 0
    for i, row in enumerate(mesh.grid):
        rows = slice(i * bd, (i + 1) * bd)
        pools = []
        for j, dev in enumerate(row):
            res = traverse(i, j, rows, dev)
            pools.append(_local_pool(res, global_ids.blocks[i][j]).to(row[0]))
            rounds += int(res.n_steps)
            expanded += int(torch.sum(res.n_expanded))
        out.append(torch.cat(pools, dim=1).to(mesh.first_device))
    return torch.cat(out), rounds, expanded


def _pad_rows(index: ShardedIndex, pad_mask: np.ndarray) -> np.ndarray:
    """The f32 vectors of the wrap-around pad rows (at most S - 1), read
    alone: never the whole [S, Ns, D] set."""
    ps, pr = np.nonzero(pad_mask)
    v = index.vectors
    if isinstance(v, PlacedShards):
        return np.stack([v.shard(int(s))[int(r)].cpu().numpy() for s, r in zip(ps, pr)])
    return np.asarray(v[ps, pr], np.float32)


@dataclasses.dataclass
class ShardedHostTier:
    """Sharded compressed-traversal tier + host-resident f32 rerank.

    mode "bf16": bf16 vectors per shard on the device (2 * D bytes a
    node). "pq" and "iq": a guide over `PlacedShards` — uint8 PQ codes per
    shard (m bytes a node; B5 by id once a round and shard), a residual
    PQ's cells and biases beside them, or IntQuantizer int8 rows
    (row_width bytes a node, plain PyTorch)."""

    vectors_bf16: PlacedShards | None   # [S, Ns, D] bf16 (bf16 mode)
    adjacency: PlacedShards             # [S, Ns, R]
    medoids: PlacedShards               # [S]
    global_ids: PlacedShards            # [S, Ns]
    reader: RecordReader                # global id -> f32 vector (host)
    mesh: Mesh
    metric: str = Metric.L2.value
    entry_points: PlacedShards | None = None
    guide: Guide | None = None          # over PlacedShards [S, Ns, ...]; None: bf16

    @property
    def n_shards(self) -> int:
        return int(self.adjacency.shape[0])

    @property
    def mode(self) -> str:
        """"bf16" | "pq" | "iq"."""
        return "bf16" if self.guide is None else self.guide.mode

    @classmethod
    def from_sharded_index(
        cls, index: ShardedIndex, reader: RecordReader, mesh: Mesh, *, mode: str = "bf16",
        pq=None, codes=None, pq_cells=None, pq_bias=None,
    ) -> "ShardedHostTier":
        """Wrap a built ShardedIndex: each shard's graph and compressed
        traversal copy on its devices; the f32 master stays behind
        `reader` and is never uploaded. For mode "pq" / "iq" pass the
        fitted quantizer and the *global* codes [N, m] (a residual PQ also
        its global pq_cells and pq_bias); they are regathered per shard
        through the global id maps here, and the pad rows are encoded from
        their own vectors."""
        common = dict(
            adjacency=place(index.adjacency, mesh),
            medoids=place(index.medoids, mesh),
            global_ids=place(index.global_ids, mesh),
            reader=reader, mesh=mesh, metric=index.metric,
            entry_points=None if index.entry_points is None else place(index.entry_points, mesh),
        )
        if mode == "bf16":
            # a host-resident index is cast on the host, so only the bf16
            # copy is uploaded; a placed one is cast shard by shard
            return cls(vectors_bf16=place(index.vectors, mesh, torch.bfloat16), **common)
        if mode not in ("pq", "iq"):
            raise ValueError(f"unknown sharded host-tier mode: {mode}")
        if pq is None or codes is None:
            raise ValueError(f"mode={mode!r} needs pq model + global codes")
        if Metric(index.metric) != Metric.L2:
            raise ValueError(
                f"sharded host-tier {mode} traversal is L2-only; this index uses "
                f"metric={index.metric!r} — use bf16 mode, or normalize the vectors and "
                "build with metric='l2'"
            )
        gids = _stacked(index.global_ids)
        guide = Guide(pq, codes, pq_cells, pq_bias).regather(
            gids, lambda: _pad_rows(index, gids < 0))
        return cls(vectors_bf16=None, guide=guide.map(lambda a: place(a, mesh)), **common)

    def device_bytes(self) -> dict[str, int]:
        """Bytes the tier holds on each device (graph, traversal copy,
        seeds, ids, residual aux)."""
        out: dict[str, int] = {}
        guide = () if self.guide is None else self.guide.arrays()
        for p in (self.adjacency, self.medoids, self.global_ids, self.entry_points,
                  self.vectors_bf16, *guide):
            if p is not None:
                for dev, nb in p.nbytes_by_device().items():
                    out[dev] = out.get(dev, 0) + nb
        return out

    def _pool(self, q: torch.Tensor, *, search_width: int, max_steps: int, expand_width: int):
        """One traversal of a batch padded to the data axis: every shard
        traverses its graph over its bf16 rows, or over its block of the
        guide (B5 by id once a round and shard, or int rows) from the query
        tables of the whole batch split over the data rows. Returns (pool
        [B, S*P] on the mesh's first device, rounds, nodes expanded)."""
        kw = dict(search_width=search_width, k=search_width, max_steps=max_steps,
                  expand_width=expand_width)
        tables = None if self.guide is None else self.guide.tables(q)

        def traverse(i, j, rows, dev):
            graph = (self.adjacency.blocks[i][j], self.medoids.blocks[i][j])
            ep = None if self.entry_points is None else self.entry_points.blocks[i][j]
            if tables is None:
                return beam_search(self.vectors_bf16.blocks[i][j], *graph, q[rows].to(dev),
                                   metric=self.metric, entry_points=ep, **kw)
            return self.guide.block(i, j).search(tables.take(rows, dev), *graph, rerank=False,
                                                 entry_points=ep, **kw)

        return _pool_over_mesh(self.mesh, q.shape[0], self.global_ids, traverse)

    def _pool_to_host(self, q_np: np.ndarray, *, search_width: int, max_steps: int,
                      expand_width: int):
        """(pool [B, S*P] int32 numpy, rounds, nodes expanded) of a batch."""
        q, b = _pad_batch(q_np, self.mesh.shape["data"], self.mesh.first_device)
        pool, rounds, expanded = self._pool(q, search_width=search_width, max_steps=max_steps,
                                            expand_width=expand_width)
        return pool[:b].cpu().numpy(), rounds, expanded

    def search(self, queries: np.ndarray, *, search_width: int, k: int, expand_width: int = 4,
               max_steps: int | None = None, n_threads: int = 8):
        """Returns (dists [B, k] squared, ids [B, k] global, stats).
        max_steps defaults to max(search_width, 16); the batch is padded
        with zero rows to a multiple of the data axis."""
        t0 = time.perf_counter()
        q_np = np.asarray(queries, np.float32)
        if q_np.ndim == 1:
            q_np = q_np[None, :]
        if max_steps is None:
            max_steps = max(search_width, 16)
        pool, rounds, expanded = self._pool_to_host(
            q_np, search_width=search_width, max_steps=max_steps, expand_width=expand_width)
        t1 = time.perf_counter()
        dists, ids, n_uniq = exact_rerank_pool(q_np, pool, self.reader, metric=self.metric, k=k,
                                               n_threads=n_threads)
        t2 = time.perf_counter()
        stats = {
            "search_type": "sharded_host_tier",
            "mode": self.mode,
            "n_shards": self.n_shards,
            "pool_width": int(pool.shape[1]),
            "nodes_visited": expanded,
            "rounds": rounds,
            "host_vectors_fetched": n_uniq,
            "cache": self.reader.cache_stats(),
            "stage_ms": {"traverse_and_fetch": (t1 - t0) * 1e3,
                         "gather_rerank_select": (t2 - t1) * 1e3},
        }
        return dists, ids, stats

    def search_pipelined(self, queries: np.ndarray, *, search_width: int, k: int,
                         chunk: int = 256, expand_width: int = 4, max_steps: int | None = None,
                         n_threads: int = 8):
        """Chunked two-stage pipeline, the sharded twin of
        `HostTierIndex.search_pipelined`: one worker thread reranks chunk i
        on the host while this thread traverses chunk i+1. The last chunk
        is padded with copies of row 0. The same results as `search()`.
        `chunk` must be a multiple of the mesh's data axis."""
        n_data = self.mesh.shape["data"]
        if chunk % n_data:
            raise ValueError(f"chunk={chunk} must be divisible by the mesh data axis ({n_data})")
        q_np = np.asarray(queries, np.float32)
        if q_np.ndim == 1:
            q_np = q_np[None, :]
        b = q_np.shape[0]
        if b <= chunk:
            return self.search(q_np, search_width=search_width, k=k, expand_width=expand_width,
                               max_steps=max_steps, n_threads=n_threads)
        if max_steps is None:
            max_steps = max(search_width, 16)
        n_chunks = -(-b // chunk)
        padded = n_chunks * chunk
        if padded != b:
            q_np = np.concatenate([q_np, np.broadcast_to(q_np[:1], (padded - b, q_np.shape[1]))])

        def rerank(s: int, pool: np.ndarray):
            tr = time.perf_counter()
            out = exact_rerank_pool(q_np[s : s + chunk], pool, self.reader, metric=self.metric,
                                    k=k, n_threads=n_threads)
            return out, time.perf_counter() - tr

        t0 = time.perf_counter()
        t_trav = 0.0
        rounds = expanded = pool_width = 0
        futures = []
        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as worker:
            for s in range(0, padded, chunk):
                tt = time.perf_counter()
                pool, nr, ne = self._pool_to_host(
                    q_np[s : s + chunk], search_width=search_width, max_steps=max_steps,
                    expand_width=expand_width)
                t_trav += time.perf_counter() - tt
                rounds += nr
                expanded += ne
                pool_width = pool.shape[1]
                futures.append(worker.submit(rerank, s, pool))
            tw = time.perf_counter()
            results = [f.result() for f in futures]
            t_wait = time.perf_counter() - tw
        out_d = np.concatenate([r[0][0] for r in results])[:b]
        out_i = np.concatenate([r[0][1] for r in results])[:b]
        stats = {
            "search_type": "sharded_host_tier",
            "mode": self.mode,
            "n_shards": self.n_shards,
            "pool_width": int(pool_width),
            "pipelined_chunks": n_chunks,
            "nodes_visited": expanded,
            "rounds": rounds,
            "host_vectors_fetched": sum(r[0][2] for r in results),
            "cache": self.reader.cache_stats(),
            "stage_ms": {"traverse": t_trav * 1e3,
                         "gather_rerank_select": sum(r[1] for r in results) * 1e3,
                         "rerank_wait": t_wait * 1e3,
                         "wall": (time.perf_counter() - t0) * 1e3},
        }
        return out_d, out_i, stats
