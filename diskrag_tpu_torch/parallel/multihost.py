"""Several processes, one sharded index (counterpart of
`diskrag_tpu/parallel/multihost.py`).

N processes each own a contiguous block of the dataset and of the index
shards: each builds its own shards from its own block (the vectors never
cross processes), and all of them serve one global search. A search runs
every local shard on its device, concatenates the per-shard [B, k] lists
in shard order, `all_gather`s the [B, S_local * k] blocks over
`torch.distributed` in rank order (process-major, the order of the
single-process merge) and cuts the stable top-k on every process, so every
process returns the same ids as `parallel.sharded.sharded_search` over
the same shards.

The caller picks the collective backend in `initialize`: "nccl" needs one
card per process; "gloo" runs on the CPU and on processes that share one
card, and the per-shard lists are then copied to the host before the
collective. Every process passes the same query batch, and the processes
build with equal padded shapes (`rows_per_shard`, `entry_width`).
"""

from __future__ import annotations

import dataclasses
import datetime
import logging

import numpy as np
import torch

from diskrag_tpu_torch.ops.distance import Metric
from diskrag_tpu_torch.ops.topk import INVALID_ID, topk_smallest
from diskrag_tpu_torch.parallel.mesh import Mesh, make_mesh, place
from diskrag_tpu_torch.parallel.sharded import (
    ShardedIndex,
    _local_flat_blocks,
    _local_search_blocks,
    _pad_batch,
    shard_to_mesh,
)

logger = logging.getLogger(__name__)


def initialize(coordinator_address: str, num_processes: int, process_id: int, *, backend: str,
               timeout_s: float = 120.0) -> None:
    """Join the process group (a no-op when this process already has
    one). `coordinator_address` is "host:port" of rank 0; `timeout_s`
    bounds the rendezvous and every collective."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def shutdown() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def global_shard_mesh(n_data: int = 1, devices: list | None = None) -> Mesh:
    """A ("data", "shard") mesh whose shard axis spans every process:
    this process's `devices` (default every visible card) as n_data rows
    of local shard slots, its shards after those of lower ranks."""
    import torch.distributed as dist

    local = make_mesh(n_data=n_data, devices=devices)
    return Mesh(local.grid, n_processes=dist.get_world_size(), process_index=dist.get_rank())


def build_local_shards(
    vectors: np.ndarray,
    global_id_base: int,
    *,
    n_local_shards: int,
    degree_bound: int = 32,
    alpha: float = 1.2,
    metric: str = Metric.L2.value,
    seed: int = 0,
    entry_width: int = 8,
    rows_per_shard: int | None = None,
    device: str | torch.device = "cuda",
) -> dict[str, np.ndarray]:
    """Build THIS process's shards from its block of the dataset (global
    ids `global_id_base ..`); nothing here communicates.

    `rows_per_shard` must be the global per-shard row count (every process
    pads to the same shapes; None derives it from this block alone), and
    `entry_width` fixes the entry-point lanes (padded with the shard's
    medoid). Pad rows are zero vectors with no edges and global id -1.
    Returns stacked per-shard numpy arrays for `assemble_global_index`."""
    from diskrag_tpu_torch.graph.knn_build import build_vamana_knn

    vectors = np.asarray(vectors, np.float32)
    n = vectors.shape[0]
    per = rows_per_shard or -(-n // n_local_shards)
    if per * n_local_shards < n:
        raise ValueError(f"rows_per_shard={per} x {n_local_shards} shards < {n} rows")
    vecs, adjs, meds, gids, entries = [], [], [], [], []
    for s in range(n_local_shards):
        lo, hi = s * per, min((s + 1) * per, n)
        block = vectors[lo:hi]
        idx = build_vamana_knn(block, degree_bound=degree_bound, alpha=alpha, metric=metric,
                               seed=seed + s, device=device)
        pad = per - (hi - lo)
        v = block
        a = idx.adjacency.cpu().numpy().astype(np.int32)
        g = np.arange(global_id_base + lo, global_id_base + hi, dtype=np.int32)
        if pad:
            v = np.concatenate([v, np.zeros((pad, v.shape[1]), v.dtype)])
            a = np.concatenate([a, np.full((pad, a.shape[1]), INVALID_ID, a.dtype)])
            g = np.concatenate([g, np.full(pad, INVALID_ID, np.int32)])
        med = int(idx.medoid)
        e = (np.zeros((0,), np.int32) if idx.entry_points is None
             else idx.entry_points.cpu().numpy().astype(np.int32)[:entry_width])
        e = np.concatenate([e, np.full(entry_width - e.shape[0], med, np.int32)])
        vecs.append(v)
        adjs.append(a)
        meds.append(med)
        gids.append(g)
        entries.append(e)
        del idx
    return {
        "vectors": np.stack(vecs),
        "adjacency": np.stack(adjs),
        "medoids": np.asarray(meds, np.int32),
        "global_ids": np.stack(gids),
        "entry_points": np.stack(entries),
        "metric": metric,
    }


def assemble_global_index(local: dict[str, np.ndarray], mesh: Mesh,
                          n_global_shards: int) -> ShardedIndex:
    """This process's part of the global index: its stacked shard arrays
    placed on its devices of `mesh`. Nothing crosses processes: each one
    holds exactly the shards it built."""
    s_local = int(local["vectors"].shape[0])
    if s_local != mesh.local_shards or mesh.shape["shard"] != n_global_shards:
        raise ValueError(
            f"{s_local} local shards on a mesh of {mesh.local_shards} local / "
            f"{mesh.shape['shard']} global shard slots; expected {n_global_shards} in all"
        )
    return shard_to_mesh(ShardedIndex(
        vectors=local["vectors"], adjacency=local["adjacency"], medoids=local["medoids"],
        global_ids=local["global_ids"], metric=str(local["metric"]),
        entry_points=local["entry_points"],
    ), mesh)


def _all_gather_columns(t: torch.Tensor) -> torch.Tensor:
    """Every process's [B, C] block, concatenated along columns in rank
    order: [B, world * C] on `t`'s device. Over gloo the block is copied to
    the host first."""
    import torch.distributed as dist

    src = (t.cpu() if dist.get_backend() == "gloo" else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, src)
    return torch.cat(parts, dim=1).to(t.device)


def _merge_across(mesh: Mesh, ids_rows, dist_rows, k: int, b: int):
    """This process's per-(data row, shard) blocks -> the global merged
    top-k on every process, as host numpy ([:b] of the padded batch)."""
    dev = mesh.first_device
    local_i = torch.cat([torch.cat([g.to(row[0]) for g in ids_rows[i]], 1).to(dev)
                         for i, row in enumerate(mesh.grid)])
    local_d = torch.cat([torch.cat([d.to(row[0]) for d in dist_rows[i]], 1).to(dev)
                         for i, row in enumerate(mesh.grid)])
    all_i = _all_gather_columns(local_i)
    all_d = _all_gather_columns(local_d)
    top_d, take = topk_smallest(all_d, k)
    ids = torch.gather(all_i, 1, take)
    return ids[:b].cpu().numpy(), top_d[:b].cpu().numpy()


def multihost_sharded_search(index: ShardedIndex, queries, mesh: Mesh, *, search_width: int,
                             k: int, max_steps: int | None = None):
    """Global graph search over a multi-process mesh: (ids [B, k], dists
    [B, k]) as host numpy on every process, the ids of
    `sharded_search` over the same shards in one process. Every process
    passes the same query batch."""
    if max_steps is None:
        max_steps = 2 * search_width
    index = shard_to_mesh(index, mesh)
    q, b = _pad_batch(queries, mesh.shape["data"], mesh.first_device)
    ids_rows, dist_rows, _, _ = _local_search_blocks(
        index, q, search_width=search_width, k=k, max_steps=max_steps,
        n_pad_bound=mesh.shape["shard"] - 1)
    return _merge_across(mesh, ids_rows, dist_rows, k, b)


def multihost_flat_search(vectors_bf16, norms_sq, global_ids, queries, mesh: Mesh, *, k: int,
                          metric: str = "l2"):
    """Global exhaustive bf16 scan over a multi-process mesh (the
    sharded_flat mode's multi-process form); the operands are this
    process's stacked shards (or `PlacedShards`)."""
    vectors_bf16 = place(vectors_bf16, mesh, torch.bfloat16)
    norms_sq = place(norms_sq, mesh, torch.float32)
    global_ids = place(global_ids, mesh)
    q, b = _pad_batch(queries, mesh.shape["data"], mesh.first_device)
    ids_rows, dist_rows = _local_flat_blocks(vectors_bf16, norms_sq, global_ids, q, k=k,
                                             metric=metric, mesh=mesh,
                                             n_pad_bound=mesh.shape["shard"] - 1)
    return _merge_across(mesh, ids_rows, dist_rows, k, b)


@dataclasses.dataclass
class MultihostConfig:
    """Topology of a multi-process deployment: `shards_per_host` shards
    on each process's devices; queries go to every process; the merge
    gathers each process's shard lists once."""

    coordinator_address: str
    num_processes: int
    process_id: int
    shards_per_host: int

    @property
    def n_global_shards(self) -> int:
        return self.num_processes * self.shards_per_host

    def my_block(self, n_total_rows: int) -> tuple[int, int]:
        """[lo, hi) global-row block this process ingests (contiguous,
        equal-padded; the last block may be short)."""
        per_host = -(-n_total_rows // self.num_processes)
        lo = self.process_id * per_host
        return lo, min(lo + per_host, n_total_rows)
