"""The port's multi-process sharded search (`diskrag_tpu_torch/parallel/
multihost.py`) on the CPU: two real processes over gloo on 127.0.0.1, each
building and searching its own two shards
(`diskrag_tpu_torch.tools.multihost_check`). Both return byte-identical
ids, and those equal the single-process `sharded_search` (and
`sharded_flat_search`) over the same four shards, which
`test_torch_sharded.py` holds against the JAX package. The run has its own
timeout (110 s), so it can never hang the suite. `build_local_shards`'
layout and `MultihostConfig` are held against the JAX package's."""

import socket

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # the suite runs several workers: do not let each spin a thread per core

from diskrag_tpu.parallel import multihost as jax_mh
from diskrag_tpu_torch.benchmark import ground_truth, recall_at_k
from diskrag_tpu_torch.parallel import make_mesh, multihost as mh, sharded_flat_search, sharded_search
from diskrag_tpu_torch.tools.multihost_check import run_local, stack_shards

N, DIM, Q, K = 2000, 32, 48, 10


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    return run_local(tmp_path_factory.mktemp("mh"), n=N, dim=DIM, queries=Q, k=K,
                     search_width=32, processes=2, shards_per_process=2, degree_bound=16,
                     device="cpu", timeout=110.0, threads=1)


def test_two_process_gloo_search_equals_single_process(two_processes):
    r0, r1 = two_processes
    assert r0["ids"].tobytes() == r1["ids"].tobytes()
    assert r0["dists"].tobytes() == r1["dists"].tobytes()
    idx = stack_shards(two_processes)
    assert idx.n_shards == 4
    g = idx.global_ids
    assert np.array_equal(np.sort(g[g >= 0]), np.arange(N))
    mesh = make_mesh(n_shards=4, devices=["cpu"] * 4)
    ids, dists = sharded_search(idx, r0["queries"], mesh, search_width=32, k=K)
    assert ids.numpy().tobytes() == r0["ids"].astype(np.int32).tobytes()
    np.testing.assert_array_equal(dists.numpy(), r0["dists"])
    from diskrag_tpu_torch.benchmark import make_dataset

    pts, q = make_dataset(N, DIM, Q, seed=0)
    assert np.array_equal(q, r0["queries"])
    gt = ground_truth(pts, q, K, device="cpu")
    assert recall_at_k(r0["ids"], gt, K) >= 0.9


def test_two_process_flat_search_equals_single_process(two_processes):
    r0, r1 = two_processes
    assert r0["flat_ids"].tobytes() == r1["flat_ids"].tobytes()
    idx = stack_shards(two_processes)
    v = idx.vectors
    norms = np.einsum("snd,snd->sn", v, v, dtype=np.float32)
    mesh = make_mesh(n_shards=4, devices=["cpu"] * 4)
    ids, dists = sharded_flat_search(torch.as_tensor(v).to(torch.bfloat16), norms, idx.global_ids,
                                     r0["queries"], mesh, k=K)
    assert np.array_equal(ids.numpy(), r0["flat_ids"])
    np.testing.assert_array_equal(dists.numpy(), r0["flat_dists"])


def test_build_local_shards_layout_matches_jax():
    """Equal padded shapes, pad rows (zero vectors, no edges, global id
    -1) and medoid-padded entry lanes, as the JAX package lays them out."""
    rng = np.random.default_rng(0)
    block = rng.normal(size=(300, 16)).astype(np.float32)
    kw = dict(n_local_shards=2, degree_bound=8, rows_per_shard=160, entry_width=8)
    ours = mh.build_local_shards(block, 1000, device="cpu", **kw)
    theirs = jax_mh.build_local_shards(block, 1000, **kw)
    for key in ("vectors", "global_ids"):
        assert np.array_equal(ours[key], np.asarray(theirs[key])), key
    for key in ("adjacency", "entry_points", "medoids"):
        assert ours[key].shape == np.asarray(theirs[key]).shape, key
    assert (ours["adjacency"][1, 140:] == -1).all()
    for s in range(2):
        e = ours["entry_points"][s]
        assert ((e >= 0) & (e < 160)).all()
    with pytest.raises(ValueError, match="rows_per_shard"):
        mh.build_local_shards(block, 0, n_local_shards=2, rows_per_shard=100, device="cpu")


@pytest.mark.parametrize("n,procs", [(4096, 2), (1001, 2), (10, 3)])
def test_multihost_config_matches_jax(n, procs):
    for pid in range(procs):
        ours = mh.MultihostConfig("127.0.0.1:1", procs, pid, shards_per_host=4)
        theirs = jax_mh.MultihostConfig("127.0.0.1:1", procs, pid, shards_per_host=4)
        assert ours.my_block(n) == theirs.my_block(n)
        assert ours.n_global_shards == theirs.n_global_shards


def test_one_process_group_in_process(two_processes):
    """A world of one (gloo) in this process: the mesh's shard axis is the
    local one and the gathered search is `sharded_search`."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mh.initialize(f"127.0.0.1:{port}", 1, 0, backend="gloo", timeout_s=60)
    try:
        mesh = mh.global_shard_mesh(devices=["cpu"] * 2)
        assert mesh.shape == {"data": 1, "shard": 2} and mesh.n_processes == 1
        r0 = two_processes[0]
        local = {k[len("local_"):]: v for k, v in r0.items() if k.startswith("local_")}
        local["metric"] = "l2"
        index = mh.assemble_global_index(local, mesh, 2)
        ids, dists = mh.multihost_sharded_search(index, r0["queries"], mesh, search_width=32, k=K)
        want_i, want_d = sharded_search(index, r0["queries"], mesh, search_width=32, k=K)
        assert np.array_equal(ids, want_i.numpy()) and np.array_equal(dists, want_d.numpy())
        with pytest.raises(ValueError, match="global shard slots"):
            mh.assemble_global_index(local, mesh, 4)
    finally:
        mh.shutdown()
