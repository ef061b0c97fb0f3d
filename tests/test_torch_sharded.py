"""The port's sharded index (`diskrag_tpu_torch/parallel/`) against the JAX
package's (`diskrag_tpu/parallel/`), on the CPU: meshes of ["cpu"] * 8 (2 x
4) and ["cpu"] * 4 against the JAX package's emulated 8-device mesh.

The partition is held bit for bit. Exact sharded search runs on JAX-built
shards carried across by `convert.sharded_index_from_jax`, over
integer-valued vectors (every product and sum exact in f32, as in
`test_torch_graph_search.py`), so the merged ids and their order are held
id for id with one and two data rows, wrap-around pads and shards smaller
than k. The flat scan sums bf16 products in another order: ids are held
equal outside 1e-5-relative near-ties, and recall equal. A build wave is
held per shard as `test_torch_wave_build.py` holds `wave_step`."""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # the suite runs several workers: do not let each spin a thread per core

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from diskrag_tpu.parallel import (
    build_sharded as jax_build_sharded,
    load_sharded_index as jax_load,
    make_mesh as jax_make_mesh,
    save_sharded_index as jax_save,
    shard_to_mesh as jax_shard_to_mesh,
    sharded_build_wave as jax_build_wave,
    sharded_flat_search as jax_flat,
    sharded_search as jax_search,
)
from diskrag_tpu_torch.benchmark import ground_truth, recall_at_k
from diskrag_tpu_torch.convert import sharded_index_from_jax
from diskrag_tpu_torch.parallel import (
    ShardedIndex,
    build_sharded,
    load_sharded_index,
    make_mesh,
    place,
    save_sharded_index,
    shard_to_mesh,
    sharded_build_wave,
    sharded_flat_search,
    sharded_search,
)
from diskrag_tpu_torch.parallel.dryrun import dryrun_multichip


def _jput(mesh, arr, dtype=None):
    arr = jnp.asarray(arr, dtype)
    return jax.device_put(arr, NamedSharding(mesh, P("shard", *([None] * (arr.ndim - 1)))))


@pytest.fixture(scope="module")
def ints(clustered_data):
    """The clustered set rounded to integers: exact in f32 and in bf16."""
    return np.round(clustered_data).astype(np.float32)


@pytest.fixture(scope="module")
def jax_shards(ints):
    return {
        "full": jax_build_sharded(ints, 4, degree_bound=24),
        "pad": jax_build_sharded(ints[:1995], 4, degree_bound=16),  # per 499, one pad row
        "tiny": jax_build_sharded(ints[:100], 8, degree_bound=8),   # 13 points a shard < k
    }


def _queries(ints, case, jidx, rng):
    if case == "tiny":
        return ints[:5]
    q = ints[rng.integers(0, len(ints), size=37)] + rng.integers(-1, 2, size=(37, ints.shape[1]))
    if case == "pad":
        gids = np.asarray(jidx.global_ids)
        # the pad row's source point and a real last-shard point (the JAX
        # package's regression case)
        q[0], q[1] = ints[int(gids[0, 0])], ints[int(gids[-1, -2])]
    return q.astype(np.float32)


@pytest.mark.parametrize("n_shards,n_data", [(4, 2), (None, 2), (None, 1), (8, 1), (None, 3),
                                             (5, 2)])
def test_make_mesh_matches_jax(n_shards, n_data):
    def run(fn):
        try:
            return fn().shape
        except ValueError as e:
            return str(e)

    got = run(lambda: make_mesh(n_shards=n_shards, n_data=n_data, devices=["cpu"] * 8))
    want = run(lambda: jax_make_mesh(n_shards=n_shards, n_data=n_data))
    assert got == (want if isinstance(want, str) else dict(want))
    if not isinstance(got, str):
        mesh = make_mesh(n_shards=n_shards, n_data=n_data, devices=["cpu"] * 8)
        assert len(mesh.grid) == got["data"] and len(mesh.grid[0]) == got["shard"]
        assert all(d == torch.device("cpu") for row in mesh.grid for d in row)


@pytest.mark.parametrize("n,n_shards,method", [(2000, 4, "knn"), (1995, 4, "knn"), (100, 8, "knn"),
                                               (1003, 3, "wave")])
def test_partition_matches_jax_bit_for_bit(ints, n, n_shards, method):
    """`global_ids` and the pad mask equal the JAX build's (its partition
    does not depend on the build method), wrap-around pads included; the
    entry points are padded with each shard's medoid."""
    ours = build_sharded(ints[:n], n_shards, degree_bound=8, build_width=16, wave_size=64,
                         build_method=method, device="cpu")
    theirs = jax_build_sharded(ints[:n], n_shards, degree_bound=8)
    g = ours.global_ids
    assert g.dtype == np.int32 and g.shape == (n_shards, -(-n // n_shards))
    assert np.array_equal(g, np.asarray(theirs.global_ids))
    assert np.array_equal(g < 0, np.asarray(theirs.global_ids) < 0)
    valid = g[g >= 0]
    assert len(np.unique(valid)) == n and (g < 0).sum() == g.size - n
    assert set((g < 0).any(axis=1).nonzero()[0]) <= {n_shards - 1}  # pads: last shard only
    np.testing.assert_array_equal(ours.vectors[g >= 0], ints[:n][valid])
    ep, ns = ours.entry_points, g.shape[1]
    if method == "knn":  # tiny shards (n // 64 < 2) get none, in both packages
        assert (ep is None) == (theirs.entry_points is None) == (ns < 128)
    if ep is None:
        return
    assert ep.shape[0] == n_shards and ((ep >= 0) & (ep < ns)).all()
    for s in range(n_shards):
        others = ep[s][ep[s] != ours.medoids[s]]
        assert len(np.unique(others)) == len(others)  # medoid copies are the padding


@pytest.mark.parametrize("case,n_data,k", [("full", 1, 10), ("full", 2, 10), ("pad", 2, 8),
                                           ("tiny", 1, 16)])
def test_sharded_search_matches_jax_id_for_id(ints, jax_shards, case, n_data, k):
    jidx = jax_shards[case]
    s = jidx.n_shards
    q = _queries(ints, case, jidx, np.random.default_rng(3))
    jmesh = jax_make_mesh(n_shards=s, n_data=n_data)
    ji, jd = (np.asarray(a) for a in jax_search(jax_shard_to_mesh(jidx, jmesh), q, jmesh,
                                                search_width=32, k=k))
    tmesh = make_mesh(n_shards=s, n_data=n_data, devices=["cpu"] * (s * n_data))
    stats: dict = {}
    ti, td = sharded_search(sharded_index_from_jax(jidx, device="cpu"), q, tmesh,
                            search_width=32, k=k, stats=stats)
    ti, td = ti.numpy(), td.numpy()
    assert ti.shape == (len(q), k)
    assert np.array_equal(ti, ji)
    assert np.array_equal(np.isinf(td), np.isinf(jd))
    fin = np.isfinite(jd)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=1e-5)
    assert (np.diff(td, axis=1) >= 0).all() and stats["rounds"] > 0
    if case == "pad":
        assert (ti >= 0).all(), "pad rows leaked into merged results"
        assert ti[0, 0] == int(np.asarray(jidx.global_ids)[0, 0])
    if case == "tiny":
        assert (ti[:, 0] == np.arange(5)).all()


def _flat_operands(case, clustered_data):
    """(vectors [S, Ns, D] f32, global ids [S, Ns], n_data, k, queries,
    points): "perm" is the JAX test's 4 x 500 permutation; "pad" and
    "tiny" the float rows of the JAX build's partitions (1995 / 4, 100 / 8),
    pad rows holding their wrap-around source's vector."""
    from diskrag_tpu_torch.parallel.sharded import partition

    rng = np.random.default_rng(4)
    n, s, n_data, k = {"perm": (2000, 4, 2, 10), "pad": (1995, 4, 2, 8),
                       "tiny": (100, 8, 1, 16)}[case]
    pts = clustered_data[:n]
    if case == "perm":
        shard_gids, valid = rng.permutation(n).reshape(s, -1).astype(np.int32), True
    else:
        shard_gids, valid = partition(n, s, 0)
    gids = np.where(valid, shard_gids, -1).astype(np.int32)
    q = pts[rng.integers(0, n, size=33)] + rng.normal(size=(33, pts.shape[1])).astype(
        np.float32) * 0.1
    return pts[shard_gids], gids, n_data, k, q.astype(np.float32), pts


def _assert_equal_outside_near_ties(ti, td, ji, jd):
    diff = ti != ji
    scale = np.maximum(np.abs(jd), np.abs(td))
    assert (np.abs(td - jd)[diff] <= 1e-5 * scale[diff]).all(), "ids differ away from a near-tie"
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5 * np.abs(jd).max())


@pytest.mark.parametrize("case", ["perm", "pad", "tiny"])
def test_sharded_flat_matches_jax(clustered_data, case):
    vecs, gids, n_data, k, q, pts = _flat_operands(case, clustered_data)
    s = gids.shape[0]
    norms = (vecs.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    jmesh = jax_make_mesh(n_shards=s, n_data=n_data)
    ji, jd = (np.asarray(a) for a in jax_flat(
        _jput(jmesh, vecs, jnp.bfloat16), _jput(jmesh, norms), _jput(jmesh, gids), q, jmesh, k=k))
    tmesh = make_mesh(n_shards=s, n_data=n_data, devices=["cpu"] * (s * n_data))
    ti, td = sharded_flat_search(torch.as_tensor(vecs).to(torch.bfloat16), norms, gids, q, tmesh,
                                 k=k)
    ti, td = ti.numpy(), td.numpy()
    assert ti.shape == ji.shape == (len(q), k)
    _assert_equal_outside_near_ties(ti, td, ji, jd)
    gt = ground_truth(pts, q, k, device="cpu")
    assert recall_at_k(ti, gt, k) == recall_at_k(ji, gt, k)
    for row in ti:  # every valid id once
        assert len(set(row[row >= 0])) == (row >= 0).sum()


def test_sharded_build_wave_matches_jax(clustered_data, jax_shards):
    """One wave per shard on the JAX shards' graphs (float vectors: any
    graph will do), each shard's rows held as sets to >= 99%."""
    jidx = jax_shards["full"]
    gids = np.asarray(jidx.global_ids)
    vecs = clustered_data[gids]
    adj = np.asarray(jidx.adjacency)
    meds = np.asarray(jidx.medoids)
    rng = np.random.default_rng(2)
    waves = np.stack([rng.choice(adj.shape[1], size=128, replace=False) for _ in range(4)]).astype(
        np.int32)
    kw = dict(build_width=32, max_incoming=16, chunk=128 * adj.shape[2], metric="l2")
    jmesh = jax_make_mesh(n_shards=4, n_data=2)
    want = np.asarray(jax_build_wave(
        _jput(jmesh, vecs), _jput(jmesh, adj), _jput(jmesh, meds), _jput(jmesh, waves), 1.2,
        mesh=jmesh, **kw))
    tmesh = make_mesh(n_shards=4, n_data=2, devices=["cpu"] * 8)
    got = sharded_build_wave(vecs, adj, meds, waves, 1.2, mesh=tmesh, **kw)
    assert got.shape == adj.shape
    got = got.numpy()
    assert np.array_equal(adj, np.asarray(jidx.adjacency))  # the input is left as it was
    for s in range(4):
        same = np.mean([set(a[a >= 0]) == set(b[b >= 0]) for a, b in zip(got[s], want[s])])
        assert same >= 0.99, (s, same)


@pytest.mark.parametrize("build_method", ["knn", "wave"])
def test_port_built_sharded_search_recall(clustered_data, build_method):
    """The JAX `test_sharded_search_recall` on port-built shards: every
    point in one shard, recall@10 >= 0.9 over a 2 x 4 mesh, merged
    distances ascending. (The port's wave build keeps entry points too:
    see `graph/build.py`.)"""
    pts = clustered_data
    rng = np.random.default_rng(3)
    sharded = build_sharded(pts, 4, degree_bound=24, build_width=48, wave_size=128,
                            build_method=build_method, device="cpu")
    assert sharded.entry_points is not None
    gids = sharded.global_ids
    assert len(np.unique(gids[gids >= 0])) == len(pts)
    mesh = make_mesh(n_shards=4, n_data=2, devices=["cpu"] * 8)
    qi = rng.integers(0, len(pts), size=64)
    q = pts[qi] + rng.normal(size=(64, pts.shape[1])).astype(np.float32) * 0.1
    ids, dists = sharded_search(shard_to_mesh(sharded, mesh), q, mesh, search_width=48, k=10)
    gt = ground_truth(pts, q, 10, device="cpu")
    assert recall_at_k(ids.numpy(), gt, 10) >= 0.9
    assert (np.diff(dists.numpy(), axis=1) >= -1e-6).all()


def _arrays(idx):
    def host(a):
        return a.numpy() if hasattr(a, "blocks") else np.asarray(a)

    out = {k: host(getattr(idx, k)) for k in ("vectors", "adjacency", "medoids", "global_ids")}
    out["entry_points"] = None if idx.entry_points is None else host(idx.entry_points)
    return out


def _assert_same_index(a, b):
    for key, v in _arrays(a).items():
        w = _arrays(b)[key]
        assert (v is None) == (w is None), key
        if v is not None:
            assert np.array_equal(v, w), key
    assert a.metric == b.metric


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("entry_points", [True, False])
def test_save_load_roundtrip_both_ways(ints, jax_shards, tmp_path, writer, entry_points):
    import dataclasses

    jidx = jax_shards["full"]
    if not entry_points:
        jidx = dataclasses.replace(jidx, entry_points=None)
    d = tmp_path / "sharded"
    if writer == "port":
        save_sharded_index(sharded_index_from_jax(jidx, device="cpu"), d)
    else:
        jax_save(jidx, d)
    assert not list(d.glob("*.tmp"))
    meta = json.loads((d / "sharded_meta.json").read_text())
    assert meta["format"] == "tpu-sharded-1" and meta["has_entry_points"] == entry_points
    host = load_sharded_index(d)  # no mesh: memory-mapped host arrays
    assert isinstance(host.vectors, np.memmap) and host.mesh is None
    _assert_same_index(host, jidx)
    _assert_same_index(jax_load(d), jidx)
    mesh = make_mesh(n_shards=4, n_data=2, devices=["cpu"] * 8)
    placed = load_sharded_index(d, mesh=mesh)
    assert placed.mesh == mesh and placed.n_shards == 4
    _assert_same_index(placed, jidx)
    q = ints[np.random.default_rng(9).integers(0, len(ints), size=16)]
    i0, d0 = sharded_search(sharded_index_from_jax(jidx, device="cpu"), q, mesh,
                            search_width=32, k=10)
    i1, d1 = sharded_search(placed, q, mesh, search_width=32, k=10)
    assert torch.equal(i0, i1) and torch.equal(d0, d1)


def test_load_sharded_index_bad_format(tmp_path):
    d = tmp_path / "sharded"
    d.mkdir()
    (d / "sharded_meta.json").write_text(json.dumps({"format": "bogus"}))
    for load in (load_sharded_index, jax_load):
        with pytest.raises(ValueError, match="unsupported sharded index format"):
            load(d)


def test_placement_shares_one_copy_per_device(jax_shards):
    """Two data rows on one device hold one tensor per shard; a placed
    index moved to another mesh is placed anew."""
    idx = sharded_index_from_jax(jax_shards["full"], device="cpu")
    mesh = make_mesh(n_shards=4, n_data=2, devices=["cpu"] * 8)
    placed = shard_to_mesh(idx, mesh)
    assert all(placed.vectors.blocks[0][j] is placed.vectors.blocks[1][j] for j in range(4))
    assert placed.vectors.nbytes_by_device() == {"cpu": int(np.asarray(
        jax_shards["full"].vectors).nbytes)}
    v16 = place(placed.vectors, mesh, torch.bfloat16)
    assert v16.dtype == torch.bfloat16 and v16.shape == placed.vectors.shape
    again = shard_to_mesh(placed, make_mesh(n_shards=4, devices=["cpu"] * 4))
    _assert_same_index(again, jax_shards["full"])
    with pytest.raises(ValueError, match="shard slots"):
        place(np.zeros((3, 5)), mesh)


@pytest.mark.parametrize("n_devices", [8, 4])
def test_dryrun_multichip(n_devices):
    out = dryrun_multichip(["cpu"] * n_devices)
    n_data = 2
    assert out["mesh"] == {"data": n_data, "shard": n_devices // n_data}
    assert out["search"]["shape"] == [8 * n_data, 5] and out["flat"] == [8 * n_data, 5]
    for key in ("pool_bf16", "pool_pq", "pool_residual_pq"):
        assert out[key]["shape"][0] == 8 * n_data and out[key]["rounds"] > 0


def test_sharded_index_holds_host_arrays_until_placed(jax_shards):
    idx = sharded_index_from_jax(jax_shards["pad"], device="cpu",
                                 mesh=make_mesh(n_shards=4, devices=["cpu"] * 4))
    assert isinstance(idx, ShardedIndex) and idx.n_shards == 4
    assert idx.global_ids.shard(3).dtype == torch.int32
    assert int((idx.global_ids.numpy() < 0).sum()) == 1
