"""The port's dynamic graph operations (`graph/dynamic.py`) held against
the JAX package: every test of `tests/test_dynamic.py` on the port, then
the JAX package's own functions on the same inputs. `consolidate`'s
stitch is numpy in both packages, so the stitched adjacency and
`old_to_new` are identical before the refinement, and the medoid is
identical below 1024 points (the exact medoid, no draw); after the
refinement (the same numpy order, the port's waves) recall is held within
0.01. `filter_deleted` is identical."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # the suite runs several workers: do not let each spin a thread per core

import jax.numpy as jnp

from diskrag_tpu.graph import build as jbuild
from diskrag_tpu.graph import dynamic as jdyn
from diskrag_tpu_torch.benchmark import ground_truth, recall_at_k
from diskrag_tpu_torch.convert import vamana_index_from_jax
from diskrag_tpu_torch.graph import dynamic as tdyn
from diskrag_tpu_torch.graph.build import build_vamana
from diskrag_tpu_torch.graph.search import beam_search
from diskrag_tpu_torch.ops.medoid import approximate_medoid


def _build(pts, **kw):
    return build_vamana(pts, degree_bound=24, build_width=48, wave_size=256, device="cpu", **kw)


def _search(idx, q, k=10, width=48):
    res = beam_search(idx.vectors, idx.adjacency, idx.medoid, torch.as_tensor(q),
                      search_width=width, k=k, metric=idx.metric)
    return res


@pytest.fixture(scope="module")
def graph_1000(clustered_data):
    return _build(clustered_data[:1000])


@pytest.fixture(scope="module")
def jax_graph_1000(clustered_data):
    """The JAX package's graph over the first 1000 points (numpy arrays)."""
    g = jbuild.build_vamana(clustered_data[:1000], degree_bound=24, build_width=48, wave_size=256)
    return np.asarray(g.vectors), np.asarray(g.adjacency), int(g.medoid)


# --- the tests of tests/test_dynamic.py, on the port -------------------------------


def test_insert_points_searchable(clustered_data):
    pts = clustered_data
    idx2 = tdyn.insert_points(_build(pts[:1800]), pts[1800:], build_width=48)
    assert idx2.n_points == 2000
    res = _search(idx2, pts[1800:1832])
    found_self = np.mean(res.ids.numpy()[:, 0] == 1800 + np.arange(32))
    assert found_self >= 0.9, f"only {found_self:.2f} inserted points find themselves"
    rng = np.random.default_rng(0)
    queries = pts[rng.integers(0, 2000, 64)] + rng.normal(size=(64, pts.shape[1])).astype(np.float32) * 0.1
    gt = ground_truth(pts, queries, 10, device="cpu")
    assert recall_at_k(_search(idx2, queries).ids.numpy(), gt, 10) >= 0.9


def test_delete_and_filter(clustered_data, graph_1000):
    mask = tdyn.delete_points(tdyn.make_deleted_mask(1000, device="cpu"), [3, 77, 500])
    res = _search(graph_1000, clustered_data[[3, 77, 500]], k=20)
    ids, _ = tdyn.filter_deleted(res.ids, res.dists, mask, k=5)
    ids = ids.numpy()
    assert not np.isin(ids, [3, 77, 500]).any(), "tombstoned ids leaked into results"
    assert (ids[:, 0] >= 0).all()


def test_consolidate_keeps_metric_for_medoid(clustered_data):
    rng = np.random.default_rng(2)
    pts = clustered_data[:600] * rng.uniform(0.01, 100.0, size=(600, 1)).astype(np.float32)
    idx = _build(pts, metric="cosine")
    mask = tdyn.delete_points(tdyn.make_deleted_mask(600, device="cpu"), [5, 10])
    new_idx, _ = tdyn.consolidate(idx, mask, refine_fraction=0.0)
    assert new_idx.metric == "cosine"
    assert int(new_idx.medoid) == int(approximate_medoid(new_idx.vectors, metric="cosine"))


def test_consolidate_remaps_and_recalls(clustered_data, graph_1000):
    pts = clustered_data[:1000]
    rng = np.random.default_rng(1)
    dead = rng.choice(1000, size=200, replace=False)
    mask = tdyn.delete_points(tdyn.make_deleted_mask(1000, device="cpu"), dead)
    new_idx, old_to_new = tdyn.consolidate(graph_1000, mask, refine_fraction=0.5)
    assert new_idx.n_points == 800
    assert (old_to_new[dead] == -1).all()
    kept = np.setdiff1d(np.arange(1000), dead)
    assert (old_to_new[kept] >= 0).all()
    np.testing.assert_array_equal(new_idx.vectors[old_to_new[kept[0]]].numpy(), pts[kept[0]])
    queries = pts[rng.choice(kept, 64)] + rng.normal(size=(64, pts.shape[1])).astype(np.float32) * 0.1
    gt = ground_truth(new_idx.vectors, queries, 10, device="cpu")
    rec = recall_at_k(_search(new_idx, queries).ids.numpy(), gt, 10)
    assert rec >= 0.9, f"post-consolidation recall {rec}"


# --- against the JAX package on the same inputs ------------------------------------


def _dead(seed):
    return np.random.default_rng(seed).choice(1000, size=150, replace=False)


def test_consolidate_stitch_matches_jax(jax_graph_1000):
    """refine_fraction 0: the stitched adjacency, old_to_new and (N < 1024,
    the exact medoid) the medoid are the JAX package's."""
    vecs, adj, medoid = jax_graph_1000
    dead = _dead(4)
    jidx = jbuild.VamanaIndex(vectors=jnp.asarray(vecs), adjacency=jnp.asarray(adj),
                              medoid=jnp.int32(medoid))
    j_new, j_map = jdyn.consolidate(jidx, jdyn.delete_points(jdyn.make_deleted_mask(1000), dead),
                                    refine_fraction=0.0)
    t_new, t_map = tdyn.consolidate(
        vamana_index_from_jax(vecs, adj, medoid, device="cpu"),
        tdyn.make_deleted_mask(1000, dead, device="cpu"), refine_fraction=0.0)
    np.testing.assert_array_equal(t_map, j_map)
    np.testing.assert_array_equal(t_new.adjacency.numpy(), np.asarray(j_new.adjacency))
    np.testing.assert_array_equal(t_new.vectors.numpy(), np.asarray(j_new.vectors))
    assert int(t_new.medoid) == int(j_new.medoid)


def test_consolidate_refined_recall_matches_jax(clustered_data, jax_graph_1000):
    vecs, adj, medoid = jax_graph_1000
    dead = _dead(5)
    jidx = jbuild.VamanaIndex(vectors=jnp.asarray(vecs), adjacency=jnp.asarray(adj),
                              medoid=jnp.int32(medoid))
    j_new, _ = jdyn.consolidate(jidx, jdyn.delete_points(jdyn.make_deleted_mask(1000), dead),
                                refine_fraction=0.5, seed=3)
    t_new, _ = tdyn.consolidate(
        vamana_index_from_jax(vecs, adj, medoid, device="cpu"),
        tdyn.make_deleted_mask(1000, dead, device="cpu"), refine_fraction=0.5, seed=3)
    rng = np.random.default_rng(6)
    kept_vecs = t_new.vectors.numpy()
    q = kept_vecs[rng.integers(0, len(kept_vecs), 128)] + rng.normal(
        size=(128, vecs.shape[1])).astype(np.float32) * 0.1
    gt = ground_truth(kept_vecs, q, 10, device="cpu")
    j_port = vamana_index_from_jax(np.asarray(j_new.vectors), np.asarray(j_new.adjacency),
                                   int(j_new.medoid), device="cpu")
    r_jax = recall_at_k(_search(j_port, q).ids.numpy(), gt, 10)
    r_port = recall_at_k(_search(t_new, q).ids.numpy(), gt, 10)
    assert r_jax >= 0.9 and abs(r_port - r_jax) <= 0.01, (r_port, r_jax)


def test_filter_deleted_matches_jax():
    rng = np.random.default_rng(7)
    ids = rng.integers(-1, 300, size=(16, 20)).astype(np.int32)
    dists = rng.random((16, 20)).astype(np.float32)
    dists[:, ::4] = dists[:, 1:2]  # ties
    dists[ids == -1] = np.inf
    dead = rng.choice(300, size=60, replace=False)
    want_i, want_d = jdyn.filter_deleted(
        jnp.asarray(ids), jnp.asarray(dists),
        jdyn.delete_points(jdyn.make_deleted_mask(300), dead), 8)
    got_i, got_d = tdyn.filter_deleted(
        torch.from_numpy(ids), torch.from_numpy(dists),
        tdyn.make_deleted_mask(300, dead, device="cpu"), 8)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


def test_masks_match_jax():
    dead = [3, 9, 9, 40]
    want = np.asarray(jdyn.delete_points(jdyn.make_deleted_mask(50, [1, 2]), dead))
    got = tdyn.delete_points(tdyn.make_deleted_mask(50, [1, 2], device="cpu"), dead).numpy()
    np.testing.assert_array_equal(got, want)


def test_consolidate_random_tenth_loses_recall_in_both_packages():
    """The JAX package's `StreamingIndex.consolidate` refines a random tenth
    of the rows after the stitch (`refine_fraction=0.1`). With 10% of a
    degree-48 graph over `make_dataset`'s 8192 x 128 points deleted, nearly
    every row loses a neighbour, and the stitch fills a row from its
    deleted neighbour's out-edges in column order, truncating the rest: the
    JAX tier and the port's `dynamic.consolidate(refine_fraction=0.1)` both
    lose more than 0.01 of recall@10 (L = 32). The port's tier refines
    every row that lost a neighbour, and holds recall within 0.01."""
    from diskrag_tpu.index import streaming as jstream
    from diskrag_tpu_torch.benchmark import make_dataset
    from diskrag_tpu_torch.graph.knn_build import build_vamana_knn
    from diskrag_tpu_torch.index.streaming import StreamingIndex

    n = 8192
    pts, q = make_dataset(n, 128, 200, seed=42)
    g = build_vamana_knn(pts, degree_bound=48, alpha=1.2, seed=0, device="cpu")
    dead = np.random.default_rng(0).choice(n, size=n // 10, replace=False)
    live = np.setdiff1d(np.arange(n), dead)
    gt_live = live[ground_truth(pts[live], q, 10, device="cpu")]

    def recall(ids):
        ids = np.asarray(ids)
        assert not np.isin(ids, dead).any(), "a tombstoned id was served"
        return recall_at_k(ids, gt_live, 10)

    ref, _ = tdyn.consolidate(g, tdyn.make_deleted_mask(n, dead, device="cpu"),
                              refine_fraction=0.1, seed=0)
    res = beam_search(ref.vectors, ref.adjacency, ref.medoid, torch.from_numpy(q),
                      search_width=32, k=10, expand_width=8, entry_points=ref.entry_points)
    after = {"port_random_tenth": recall(live[res.ids.numpy()])}

    jg = jbuild.VamanaIndex(vectors=jnp.asarray(pts), adjacency=jnp.asarray(g.adjacency.numpy()),
                            medoid=jnp.int32(int(g.medoid)),
                            entry_points=jnp.asarray(g.entry_points.numpy()))
    tiers = {"jax": jstream.StreamingIndex(jg), "port": StreamingIndex(g)}
    before = recall_at_k(np.asarray(tiers["port"].search(q, k=10, search_width=32)[0]),
                         ground_truth(pts, q, 10, device="cpu"), 10)
    for name, s in tiers.items():
        s.delete(dead)
        s.consolidate()
        assert s.n_graph == len(live), name
        after[name] = recall(s.search(q, k=10, search_width=32)[0])
    print("recall@10 before", before, "after", after)
    assert before - after["jax"] > 0.01, (before, after)
    assert before - after["port_random_tenth"] > 0.01, (before, after)
    assert before - after["port"] <= 0.01, (before, after)
