"""The port's kNN-based Vamana build held against the JAX package.

The deterministic stages (RobustPrune, the per-block prune, the
reverse-edge grouping, the per-block merge) are held id for id on the same
inputs, made with numpy: the vectors are small integers, so every
distance is exact in f32 in both packages whatever the order of its sums,
and ties are common. A whole build draws other random numbers in the port
(medoid sample, entry points, long-range candidates) and scans with
another kernel, so it is held to quality: the kNN tables to recall of the
JAX tables, the graph to the recall of the JAX-built graph."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # the suite runs several workers: do not let each spin a thread per core

import jax.numpy as jnp

from diskrag_tpu.graph import knn_build as jkb
from diskrag_tpu.graph.prune import robust_prune_batch as jax_prune
from diskrag_tpu.graph.search import beam_search as jax_beam_search
from diskrag_tpu_torch.benchmark import ground_truth, recall_at_k
from diskrag_tpu_torch.graph import knn_build as tkb
from diskrag_tpu_torch.graph.prune import robust_prune_batch
from diskrag_tpu_torch.graph.search import beam_search

N, D, R, K = 600, 12, 10, 20


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def grid():
    """Integer-valued clustered vectors with their exact kNN tables (numpy,
    self excluded, ties to the lower id) and random long-range ids."""
    rng = np.random.default_rng(0)
    centers = rng.integers(-8, 9, size=(8, D))
    pts = (centers[rng.integers(0, 8, size=N)] + rng.integers(-2, 3, size=(N, D))).astype(np.float32)
    d = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    knn_ids = np.argsort(d, axis=1, kind="stable")[:, :K].astype(np.int32)
    knn_dists = np.take_along_axis(d, knn_ids, axis=1).astype(np.float32)
    rand_ids = ((np.arange(N)[:, None] + 1 + rng.integers(0, N - 1, size=(N, 4))) % N).astype(np.int32)
    return pts, knn_ids, knn_dists, rand_ids


def _pools(pts, rng, w=48, c=30):
    """Candidate pools with duplicates, the point's own id and -1 slots."""
    point_ids = rng.choice(N, size=w, replace=False).astype(np.int32)
    cand = rng.integers(0, N, size=(w, c)).astype(np.int32)
    cand[:, 3] = cand[:, 0]                    # a duplicate in every row
    cand[::2, 5] = point_ids[::2]              # self ids
    cand[rng.random(size=cand.shape) < 0.1] = -1
    cand[7] = -1                               # a row with no candidate
    vecs = pts[np.clip(cand, 0, N - 1)]
    dists = ((vecs - pts[point_ids][:, None, :]) ** 2).sum(-1).astype(np.float32)
    return point_ids, cand, vecs, dists


@pytest.mark.parametrize("alpha", [1.0, 1.2])
@pytest.mark.parametrize("block_size", [1, 8])
@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_robust_prune_batch_matches_jax(grid, alpha, block_size, metric, monkeypatch):
    pts = grid[0]
    point_ids, cand, vecs, dists = _pools(pts, np.random.default_rng(1))
    if metric == "dot":
        dists = -(vecs * pts[point_ids][:, None, :]).sum(-1).astype(np.float32)
    want = np.asarray(jax_prune(
        jnp.asarray(point_ids), jnp.asarray(cand), jnp.asarray(vecs), jnp.asarray(dists),
        alpha, degree_bound=R, metric=metric, block_size=block_size))
    from diskrag_tpu_torch.graph import prune as tprune

    for sync_every in (1, 2, 100):  # the "every row done?" check interval changes nothing
        monkeypatch.setattr(tprune, "SYNC_EVERY", sync_every)
        got = robust_prune_batch(
            _t(point_ids), _t(cand), _t(vecs), _t(dists), alpha, degree_bound=R,
            metric=metric, block_size=block_size)
        assert got.shape == (len(point_ids), R)
        assert np.array_equal(got.numpy(), want), sync_every
    assert (want[7] == -1).all()
    for row, pid in zip(want, point_ids):
        valid = row[row >= 0]
        assert pid not in valid and len(set(valid.tolist())) == len(valid)


def test_robust_prune_degree_bound_above_pool(grid):
    pts = grid[0]
    point_ids, cand, vecs, dists = _pools(pts, np.random.default_rng(2), w=8, c=8)
    want = np.asarray(jax_prune(
        jnp.asarray(point_ids), jnp.asarray(cand), jnp.asarray(vecs), jnp.asarray(dists),
        1.2, degree_bound=9, metric="l2"))
    got = robust_prune_batch(_t(point_ids), _t(cand), _t(vecs), _t(dists), 1.2,
                             degree_bound=9, metric="l2")
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("pre_sliced", [False, True])
def test_prune_block_matches_jax(grid, pre_sliced):
    pts, knn_ids, knn_dists, rand_ids = grid
    block = np.arange(100, 228, dtype=np.int32)
    ki, kd = (knn_ids[block], knn_dists[block]) if pre_sliced else (knn_ids, knn_dists)
    j_ids, j_d = jkb._prune_block(
        jnp.asarray(pts), jnp.asarray(block), jnp.asarray(ki), jnp.asarray(kd),
        jnp.asarray(rand_ids), jnp.asarray(1.2, jnp.float32), degree_bound=R, metric="l2",
        pre_sliced=pre_sliced)
    t_ids, t_d = tkb._prune_block(
        _t(pts), _t(block), _t(ki), _t(kd), _t(rand_ids), 1.2, degree_bound=R, metric="l2",
        pre_sliced=pre_sliced)
    assert np.array_equal(t_ids.numpy(), np.asarray(j_ids))
    assert np.array_equal(t_d.numpy(), np.asarray(j_d))  # integer distances: exact
    assert np.isinf(t_d.numpy()[t_ids.numpy() == -1]).all()


@pytest.fixture(scope="module")
def pruned(grid):
    """All rows pruned by the JAX package: the edge tables the reverse and
    merge stages start from."""
    pts, knn_ids, knn_dists, rand_ids = grid
    ids, d = jkb._prune_block(
        jnp.asarray(pts), jnp.arange(N, dtype=jnp.int32), jnp.asarray(knn_ids),
        jnp.asarray(knn_dists), jnp.asarray(rand_ids), jnp.asarray(1.2, jnp.float32),
        degree_bound=R, metric="l2")
    return np.asarray(ids), np.asarray(d)


def test_incoming_tables_match_jax_and_the_host_form(pruned):
    out_ids, out_dists = pruned  # integer distances: many equal (target, dist) pairs
    mi = 5
    j_ids, j_d = jkb._incoming_tables(jnp.asarray(out_ids), jnp.asarray(out_dists), max_incoming=mi, n=N)
    t_ids, t_d = tkb._incoming_tables(_t(out_ids), _t(out_dists), max_incoming=mi, n=N)
    assert t_ids.dtype == torch.int32 and t_ids.shape == (N, mi)
    assert np.array_equal(t_ids.numpy(), np.asarray(j_ids))
    assert np.array_equal(t_d.numpy(), np.asarray(j_d))
    h_ids, h_d = tkb._incoming_tables_host(_t(out_ids), _t(out_dists), max_incoming=mi, n=N)
    assert np.array_equal(h_ids.numpy(), t_ids.numpy())
    assert h_d.dtype == torch.bfloat16  # the host form hands back bf16 distances
    np.testing.assert_allclose(h_d.to(torch.float32).numpy(), t_d.numpy(), rtol=1e-2)
    # random tables with -1 targets, as the JAX package's own test uses
    rng = np.random.default_rng(4)
    ids = rng.integers(-1, 300, size=(300, 8)).astype(np.int32)
    dists = np.where(ids == -1, np.inf, rng.random(size=(300, 8)).astype(np.float32))
    j_ids, _ = jkb._incoming_tables(jnp.asarray(ids), jnp.asarray(dists), max_incoming=6, n=300)
    t_ids, _ = tkb._incoming_tables(_t(ids), _t(dists), max_incoming=6, n=300)
    assert np.array_equal(t_ids.numpy(), np.asarray(j_ids))


def test_merge_block_matches_jax(grid, pruned):
    pts = grid[0]
    out_ids, out_dists = pruned
    inc_ids, inc_dists = (np.asarray(a) for a in jkb._incoming_tables(
        jnp.asarray(out_ids), jnp.asarray(out_dists), max_incoming=8, n=N))
    block = np.arange(0, 256, dtype=np.int32)
    want = np.asarray(jkb._merge_block(
        jnp.asarray(pts), jnp.asarray(block), jnp.asarray(out_ids), jnp.asarray(out_dists),
        jnp.asarray(inc_ids), jnp.asarray(inc_dists), jnp.asarray(1.2, jnp.float32),
        degree_bound=R, metric="l2"))
    got = tkb._merge_block(
        _t(pts), _t(block), _t(out_ids), _t(out_dists), _t(inc_ids), _t(inc_dists), 1.2,
        degree_bound=R, metric="l2")
    assert np.array_equal(got.numpy(), want)
    overflow = ((np.concatenate([out_ids, inc_ids], 1)[block] >= 0).sum(1) > R)
    assert overflow.any() and not overflow.all()  # both branches were taken


@pytest.fixture(scope="module")
def clustered():
    rng = np.random.default_rng(42)
    centers = rng.normal(size=(30, 32)).astype(np.float32) * 5.0
    pts = (centers[:, None, :] + rng.normal(size=(30, 50, 32)).astype(np.float32)).reshape(-1, 32)
    pts = pts[rng.permutation(len(pts))]
    q = pts[rng.integers(0, len(pts), size=60)] + rng.normal(size=(60, 32)).astype(np.float32) * 0.3
    return pts, q.astype(np.float32), ground_truth(pts, q, 10, device="cpu")


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_exact_knn_tables_reach_the_jax_tables(clustered, metric):
    pts = clustered[0]
    j_ids, _ = jkb.exact_knn(jnp.asarray(pts), 16, metric=metric)
    t_ids, t_d = tkb.exact_knn(_t(pts), 16, metric=metric, query_block=512)
    assert t_ids.shape == (len(pts), 16) and t_ids.dtype == torch.int32
    assert bool((torch.diff(t_d, dim=1) >= 0).all())
    assert not bool((t_ids == torch.arange(len(pts))[:, None]).any())  # self excluded
    j_ids, t_ids = np.asarray(j_ids), t_ids.numpy()
    shared = np.mean([len(set(a.tolist()) & set(b.tolist())) / 16 for a, b in zip(j_ids, t_ids)])
    assert shared >= 0.99


def test_compute_entry_points_are_unique_database_ids():
    rng = np.random.default_rng(5)
    pts = _t(rng.normal(size=(3000, 8)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    eps = tkb.compute_entry_points(pts, 40, gen)
    assert eps.dtype == np.int32 and 20 <= len(eps) <= 40
    assert len(np.unique(eps)) == len(eps) and eps.min() >= 0 and eps.max() < 3000
    # from 20,000 seeds up: a plain random sample, the full count
    big = _t(rng.normal(size=(30_000, 4)).astype(np.float32))
    eps = tkb.compute_entry_points(big, 20_000, gen)
    assert len(eps) == 20_000 and len(np.unique(eps)) == 20_000
    assert eps.min() >= 0 and eps.max() < 30_000


def test_random_long_range_ids_never_name_their_own_row():
    gen = torch.Generator().manual_seed(1)
    ids = tkb.random_long_range_ids(50, 6, gen, torch.device("cpu"))
    assert ids.shape == (50, 6) and ids.dtype == torch.int32
    assert int(ids.min()) >= 0 and int(ids.max()) < 50
    assert not bool((ids == torch.arange(50)[:, None]).any())
    assert tkb.random_long_range_ids(50, 0, gen, torch.device("cpu")).shape == (50, 0)


def _graph_recall(adjacency, medoid, eps, pts, q, gt, fn, to):
    res = fn(to(pts), to(adjacency), to(np.asarray(medoid, np.int32)), to(q), search_width=32,
             k=10, entry_points=None if eps is None else to(eps))
    return recall_at_k(np.asarray(res.ids), gt, 10)


@pytest.fixture(scope="module")
def built(clustered):
    pts = clustered[0]
    stages = {}
    tidx = tkb.build_vamana_knn(pts, degree_bound=16, alpha=1.2, seed=7, device="cpu",
                                stage_seconds=stages)
    return tidx, stages


def test_build_vamana_knn_reaches_the_jax_graphs_recall(clustered, built):
    pts, q, gt = clustered
    tidx, stages = built
    jidx = jkb.build_vamana_knn(pts, degree_bound=16, alpha=1.2, seed=7)
    j_rec = _graph_recall(np.asarray(jidx.adjacency), int(jidx.medoid),
                          np.asarray(jidx.entry_points), pts, q, gt, jax_beam_search, jnp.asarray)
    adj = tidx.adjacency.numpy()
    t_rec = _graph_recall(adj, int(tidx.medoid), tidx.entry_points.numpy(), pts, q, gt,
                          beam_search, _t)
    assert t_rec >= j_rec - 0.01 and t_rec >= 0.95
    assert adj.shape == (len(pts), 16) and adj.dtype == np.int32
    assert adj.max() < len(pts) and adj.min() >= -1
    assert not (adj == np.arange(len(pts))[:, None]).any()           # no self edges
    for row in adj[:: 7]:
        valid = row[row >= 0]
        assert len(set(valid.tolist())) == len(valid)                 # no duplicate edges
    assert (tidx.degrees() >= 1).all() and (tidx.degrees() <= 16).all()
    eps = tidx.entry_points.numpy()
    assert len(np.unique(eps)) == len(eps) and int(tidx.medoid) not in eps
    assert sorted(stages) == ["entry_points", "knn", "merge", "prune", "reverse"]
    # the port's graph serves in the JAX package's search too
    cross = _graph_recall(adj, int(tidx.medoid), eps, pts, q, gt, jax_beam_search, jnp.asarray)
    assert abs(cross - t_rec) <= 0.005


def test_build_is_deterministic_in_its_seed(clustered, built):
    pts = clustered[0][:600]
    a = tkb.build_vamana_knn(pts, degree_bound=8, seed=3, device="cpu")
    b = tkb.build_vamana_knn(pts, degree_bound=8, seed=3, device="cpu", checkpoint_dir="ignored")
    c = tkb.build_vamana_knn(pts, degree_bound=8, seed=4, device="cpu")
    assert torch.equal(a.adjacency, b.adjacency) and int(a.medoid) == int(b.medoid)
    assert not torch.equal(a.adjacency, c.adjacency)  # other long-range candidates
    assert not (pts.shape[0] % 2048 == 0)  # a padded tail block was written


def test_host_resident_knn_tables_build_the_identical_graph(clustered, built, monkeypatch):
    """Keeping the kNN tables on the host and slicing them per prune block
    is a pure residency change."""
    pts = clustered[0]
    monkeypatch.setattr(tkb, "_HOST_KNN_BYTES", 0)
    host = tkb.build_vamana_knn(pts, degree_bound=16, alpha=1.2, seed=7, device="cpu")
    assert torch.equal(host.adjacency, built[0].adjacency)
    assert int(host.medoid) == int(built[0].medoid)


def test_huge_build_path_keeps_the_graphs_quality(clustered, built, monkeypatch):
    """Past the edge-count threshold the edge distances are bf16 and the
    reverse edges are grouped on the host: another rounding, the same
    quality."""
    pts, q, gt = clustered
    monkeypatch.setattr(tkb, "_HUGE_EDGES", 0)
    huge = tkb.build_vamana_knn(pts, degree_bound=16, alpha=1.2, seed=7, device="cpu")
    rec = _graph_recall(huge.adjacency.numpy(), int(huge.medoid), huge.entry_points.numpy(),
                        pts, q, gt, beam_search, _t)
    base = _graph_recall(built[0].adjacency.numpy(), int(built[0].medoid),
                         built[0].entry_points.numpy(), pts, q, gt, beam_search, _t)
    assert rec >= base - 0.01
    same_rows = (huge.adjacency == built[0].adjacency).all(dim=1).float().mean()
    assert float(same_rows) >= 0.9
