"""Carry state across from the JAX package, handed over as numpy arrays,
so that both packages compute on the same index.

`flat_state_from_jax` builds the port's `FlatIndex` from the arrays of a
JAX `diskrag_tpu.ops.flat.FlatIndex` (the scan table is taken as it is,
not rebuilt); `vamana_index_from_jax` a `VamanaIndex` from a JAX graph's
arrays; `pq_from_jax` a quantizer from a JAX quantizer's `to_arrays()`,
with its codes and residual serving arrays moved to the device;
`iq_from_jax` an `IntQuantizer` from a JAX one's state; `ivf_from_jax` an
`IVFIndex` from a JAX `IVFIndex` (its cells, tile layout, vectors, metric
and tile precision; the tiles are rebuilt, bit-identical);
`streaming_from_jax` a `StreamingIndex` with a JAX `StreamingIndex`'s
whole state (its padded graph, buffer and id bookkeeping), so a stream
begun in the JAX package goes on in the port;
`sharded_index_from_jax` a `ShardedIndex` from a JAX `ShardedIndex`'s
arrays, placed on a mesh; `sharded_host_tier_from_jax` a
`ShardedHostTier` with a JAX tier's per-shard graph, traversal copy (bf16
rows, PQ codes with the residual arrays, or int rows, taken as they are)
and quantizer (through `pq_from_jax` / `iq_from_jax`). Persisted
indexes need no conversion: both packages read and write the same
`index/` layout.
"""

from __future__ import annotations

import numpy as np
import torch

from diskrag_tpu_torch.device import resolve_device
from diskrag_tpu_torch.graph.types import VamanaIndex
from diskrag_tpu_torch.ops.flat import FlatIndex


def _tensor(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: move the raw bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)  # a writable copy


def flat_state_from_jax(
    arrays: dict[str, np.ndarray],
    *,
    metric: str = "l2",
    rerank_width: int | None = None,
    device: str = "cuda",
) -> FlatIndex:
    """The port's index over a JAX FlatIndex's arrays: `vectors` (f32
    master), optionally `norms_sq` (its squared norms, which the bf16
    scan subtracts), `_fused_db` (int8 table or bf16 copy) and, for
    per-row int8, `_fused_db_norms` ([2, Npad] norm block),
    `_fused_db_scales` and `_fused_n_valid`; for packed int8, `_fused_nf`
    ([1, Npad] nf row), `_fused_db_scale_global` and `_fused_n_valid`."""
    dev = resolve_device(device)
    fused_db = _tensor(arrays["_fused_db"], dev)
    opt = {
        key: None if arrays.get(name) is None else _tensor(arrays[name], dev)
        for key, name in (
            ("fused_db_norms", "_fused_db_norms"),
            ("fused_db_scales", "_fused_db_scales"),
            ("fused_db_scale_global", "_fused_db_scale_global"),
            ("fused_nf", "_fused_nf"),
            ("norms_sq", "norms_sq"),
        )
    }
    n_valid = arrays.get("_fused_n_valid")
    return FlatIndex.from_state(
        _tensor(arrays["vectors"], dev).to(torch.float32),
        fused_db,
        metric=metric,
        n_valid=None if n_valid is None else int(n_valid),
        rerank_width=rerank_width,
        **opt,
    )


def vamana_index_from_jax(
    vectors: np.ndarray,
    adjacency: np.ndarray,
    medoid: int,
    *,
    metric: str = "l2",
    entry_points: np.ndarray | None = None,
    device: str = "cuda",
) -> VamanaIndex:
    """The port's graph over a JAX `VamanaIndex`'s arrays (vectors f32
    [N, D], adjacency int32 [N, R] with -1 padding, medoid, metric,
    entry_points int32 [S] or None)."""
    return VamanaIndex.from_numpy(
        np.asarray(vectors), np.asarray(adjacency), int(medoid), metric=metric,
        entry_points=None if entry_points is None else np.asarray(entry_points),
        device=device,
    )


def pq_from_jax(
    arrays: dict[str, np.ndarray],
    codes: np.ndarray | None = None,
    point_cell: np.ndarray | None = None,
    point_bias: np.ndarray | None = None,
    *,
    device: str = "cuda",
):
    """(quantizer, codes, point_cell, point_bias) on the device from a JAX
    `ProductQuantizer` / `ResidualPQ`'s `to_arrays()` dict plus, as numpy
    arrays, its uint8 codes [N, m] and, for a residual quantizer, the
    coarse cell ids int32 [N] and the serving bias f32 [N]; what is not
    given comes back as None."""
    from diskrag_tpu_torch.pq.residual import pq_from_arrays

    dev = resolve_device(device)
    pq = pq_from_arrays({k: np.asarray(v) for k, v in arrays.items()}, device=dev)

    def put(a, dtype):
        return None if a is None else torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    return (pq, put(codes, torch.uint8), put(point_cell, torch.int32),
            put(point_bias, torch.float32))


def iq_from_jax(jax_iq, *, device: str = "cuda"):
    """The port's `IntQuantizer` with a JAX `diskrag_tpu.pq.intq.IntQuantizer`'s
    state (bits, cells, per-dim steps, cell centroids, the bias lanes'
    affine), carried across as numpy: the two then encode and score the
    same rows."""
    from diskrag_tpu_torch.pq.intq import IntQuantizer

    return IntQuantizer.from_arrays(
        {k: np.asarray(v) for k, v in jax_iq.to_arrays().items()}, device=device
    )


def ivf_from_jax(ivf, *, device: str = "cuda"):
    """The port's `IVFIndex` over a JAX `diskrag_tpu.index.ivf.IVFIndex`:
    its centroids, `tile_ids`, f32 vectors, metric and tile precision,
    carried across as numpy; the scan tiles, norms and scales are rebuilt
    by `tiles_from_ids`, bit-identical to the JAX package's."""
    from diskrag_tpu_torch.index.ivf import IVFIndex, tiles_from_ids

    dev = resolve_device(device)
    vectors = np.array(ivf.vectors, np.float32)  # a writable copy
    tile_ids = np.array(ivf.tile_ids, np.int32)
    precision = "int8" if str(ivf.tiles.dtype) == "int8" else "bf16"
    master = torch.as_tensor(vectors, device=dev)
    tiles, norms, scales = tiles_from_ids(vectors, tile_ids, precision, master=master)
    return IVFIndex(
        centroids=torch.as_tensor(np.array(ivf.centroids, np.float32), device=dev),
        tiles=tiles, tile_ids=torch.as_tensor(tile_ids, device=dev), tile_norms=norms,
        vectors=master, metric=ivf.metric, tile_scales=scales,
    )


def streaming_from_jax(jax_streaming, *, device: str = "cuda"):
    """The port's `StreamingIndex` with a JAX `diskrag_tpu.index.streaming.
    StreamingIndex`'s whole state, carried across as numpy: the padded
    vectors and adjacency, medoid and entry points; the external-id row,
    the tombstones, the buffer with its ids, live mask and count; the id
    counter, the tombstone count and set, the merge count, `rows_compacted`,
    the reserve and the merge settings."""
    from diskrag_tpu_torch.index.streaming import StreamingIndex

    s = jax_streaming
    idx = s.index
    # writable copies: the port updates its adjacency in place, and a CPU
    # tensor made from a numpy array shares its memory
    index = vamana_index_from_jax(
        np.array(idx.vectors), np.array(idx.adjacency), int(np.asarray(idx.medoid)),
        metric=idx.metric,
        entry_points=None if idx.entry_points is None else np.array(idx.entry_points),
        device=device,
    )
    state = {
        "graph_ext": np.asarray(s._graph_ext), "graph_deleted": np.asarray(s._graph_deleted),
        "buf": np.asarray(s._buf), "buf_ext": np.asarray(s._buf_ext),
        "buf_live": np.asarray(s._buf_live), "count": s._count, "n_graph": s._n_graph,
        "next_ext": s._next_ext, "n_deleted": s._n_deleted,
        "deleted_ext": sorted(s._deleted_ext), "rows_compacted": s.rows_compacted,
        "n_merges": s.n_merges, "reserve": s._reserve,
    }
    params = {
        "buffer_capacity": s.capacity, "merge_insert_max_fraction": s.merge_insert_max_fraction,
        "wave_chunk": s._wave_chunk, "merge_method": s.merge_method,
        "build_width": s.build_width, "alpha": s.alpha, "degree_bound": s.degree_bound,
        "seed": s.seed,
    }
    return StreamingIndex.from_state(index, state, params=params)


def sharded_index_from_jax(index, *, device: str = "cuda", mesh=None):
    """The port's `ShardedIndex` with a JAX `diskrag_tpu.parallel.ShardedIndex`'s
    arrays (vectors, adjacency, medoids, global ids, entry points, metric),
    carried across as numpy and placed on `mesh` (default: every shard on
    `device`)."""
    from diskrag_tpu_torch.parallel import ShardedIndex, make_mesh, shard_to_mesh

    s = int(index.vectors.shape[0])
    host = ShardedIndex(
        vectors=np.array(index.vectors, np.float32), adjacency=np.array(index.adjacency, np.int32),
        medoids=np.array(index.medoids, np.int32), global_ids=np.array(index.global_ids, np.int32),
        metric=index.metric,
        entry_points=None if index.entry_points is None else np.array(index.entry_points, np.int32),
    )
    return shard_to_mesh(host, mesh if mesh is not None else make_mesh(devices=[device] * s))


def sharded_host_tier_from_jax(tier, reader, mesh):
    """The port's `ShardedHostTier` over a JAX `diskrag_tpu.parallel.ShardedHostTier`:
    its per-shard adjacency, medoids, global ids and entry points, its
    traversal copy as it holds it (bf16 rows; uint8 codes with the residual
    cells and biases; int8 rows, gather pad included) and its quantizer,
    placed on `mesh`; `reader` is the port's reader of the same record
    file."""
    from diskrag_tpu_torch.graph.guided import Guide
    from diskrag_tpu_torch.parallel import ShardedHostTier, place

    dev = mesh.first_device

    def put(a, dtype=None):
        return None if a is None else place(_tensor(a, torch.device("cpu")), mesh, dtype)

    guide = None
    if tier.mode != "bf16":
        quantizer = (iq_from_jax(tier.pq, device=dev) if tier.mode == "iq"
                     else pq_from_jax(tier.pq.to_arrays(), device=dev)[0])
        guide = Guide(quantizer, tier.codes, tier.pq_cells, tier.pq_bias).map(put)
    return ShardedHostTier(
        vectors_bf16=put(tier.vectors_bf16, torch.bfloat16),
        adjacency=put(tier.adjacency), medoids=put(tier.medoids), global_ids=put(tier.global_ids),
        entry_points=put(tier.entry_points), reader=reader, mesh=mesh, metric=tier.metric,
        guide=guide,
    )
