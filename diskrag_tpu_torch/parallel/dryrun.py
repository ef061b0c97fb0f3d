"""One step of every sharded path on tiny shapes (counterpart of
`__graft_entry__.py::dryrun_multichip`).

    python -c 'from diskrag_tpu_torch.parallel.dryrun import dryrun_multichip; \\
               print(dryrun_multichip(["cpu"] * 8))'

On a mesh of the given devices (2 data rows when their count is even, the
rest shards; one device may be named more than once): one sharded build
wave over random-regular graphs, one sharded search step with the data
axis, one sharded flat step, and the host tier's pool step in bf16, PQ
and residual-PQ traversal. Returns the output shapes and the traversal
rounds; raises on a wrong shape.
"""

from __future__ import annotations

import numpy as np
import torch


def dryrun_multichip(devices: list) -> dict:
    from diskrag_tpu_torch.graph.build import random_regular_init
    from diskrag_tpu_torch.graph.guided import Guide
    from diskrag_tpu_torch.ops.medoid import approximate_medoid
    from diskrag_tpu_torch.parallel.host_tier import ShardedHostTier
    from diskrag_tpu_torch.parallel.mesh import make_mesh, place
    from diskrag_tpu_torch.parallel.sharded import (
        ShardedIndex,
        shard_to_mesh,
        sharded_build_wave,
        sharded_flat_search,
        sharded_search,
    )
    from diskrag_tpu_torch.pq import ProductQuantizer, ResidualPQ

    n_devices = len(devices)
    n_data = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    n_shards = n_devices // n_data
    mesh = make_mesh(n_shards=n_shards, n_data=n_data, devices=devices)
    dev = mesh.first_device

    ns, d, r, w = 256, 32, 8, 32
    rng = np.random.default_rng(0)
    vecs = np.stack([rng.normal(size=(ns, d)).astype(np.float32) for _ in range(n_shards)])
    adj = np.stack([random_regular_init(torch.Generator().manual_seed(s), ns, r).numpy()
                    for s in range(n_shards)])
    meds = np.asarray([int(approximate_medoid(torch.as_tensor(vecs[s]),
                                              torch.Generator().manual_seed(0)))
                       for s in range(n_shards)], np.int32)
    gids = np.arange(n_shards * ns, dtype=np.int32).reshape(n_shards, ns)
    out: dict = {"mesh": mesh.shape}

    # one sharded build step
    waves = np.stack([rng.permutation(ns)[:w].astype(np.int32) for _ in range(n_shards)])
    new_adj = sharded_build_wave(vecs, adj, meds, waves, 1.2, build_width=16, max_incoming=4,
                                 chunk=256, metric="l2", mesh=mesh)
    if new_adj.shape != adj.shape:
        raise AssertionError(f"build wave: {new_adj.shape} != {adj.shape}")
    out["build_wave"] = list(new_adj.shape)

    # one sharded search step (the batch split over the data axis)
    index = shard_to_mesh(ShardedIndex(vectors=vecs, adjacency=new_adj.numpy(), medoids=meds,
                                       global_ids=gids, metric="l2"), mesh)
    queries = torch.as_tensor(rng.normal(size=(8 * n_data, d)).astype(np.float32), device=dev)
    stats: dict = {}
    ids, _ = sharded_search(index, queries, mesh, search_width=16, k=5, stats=stats)
    if tuple(ids.shape) != (8 * n_data, 5):
        raise AssertionError(f"search: {tuple(ids.shape)}")
    out["search"] = {"shape": list(ids.shape), "rounds": stats["rounds"]}

    # one sharded flat step
    v16 = place(vecs, mesh, torch.bfloat16)
    norms = np.sum(vecs.astype(np.float32) ** 2, axis=-1)
    fids, _ = sharded_flat_search(v16, norms, gids, queries, mesh, k=5)
    if tuple(fids.shape) != (8 * n_data, 5):
        raise AssertionError(f"flat: {tuple(fids.shape)}")
    out["flat"] = list(fids.shape)

    # the host tier's pool step: bf16, PQ and residual-PQ traversal (no
    # record file: the pool step reads none)
    flat = vecs.reshape(-1, d)
    pq = ProductQuantizer(n_subvectors=4, device=dev).fit(flat, seed=0, max_iter=4)
    rpq = ResidualPQ(n_subvectors=4, n_coarse=32, device=dev).fit(flat, seed=0)
    rcodes, rcids = rpq.encode(flat)
    rguide = Guide(rpq, rcodes, rcids, rpq.point_bias(rcodes, rcids))
    for key, guide in (("pool_bf16", None), ("pool_pq", Guide(pq, pq.encode(flat))),
                       ("pool_residual_pq", rguide)):
        # a guide's global arrays are regathered per shard through the global ids
        tier = ShardedHostTier(
            vectors_bf16=v16 if guide is None else None, adjacency=index.adjacency,
            medoids=index.medoids, global_ids=index.global_ids, reader=None, mesh=mesh,
            guide=None if guide is None else guide.regather(gids, None).map(
                lambda a: place(a, mesh)))
        pool, rounds, _ = tier._pool(queries, search_width=16, max_steps=16, expand_width=2)
        out[key] = {"shape": list(pool.shape), "rounds": rounds}
    for key in ("pool_bf16", "pool_pq", "pool_residual_pq"):
        if out[key]["shape"][0] != 8 * n_data:
            raise AssertionError(f"{key}: {out[key]['shape']}")
    return out
