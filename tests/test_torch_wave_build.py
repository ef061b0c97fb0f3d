"""The port's wave-insertion build (`graph/build.py`) held against the JAX
package on the seeded `clustered_data` points.

`_reverse_edges` on the same adjacency, wave and pruned rows gives the
JAX package's adjacency exactly with the int8 codes (L2: every distance
is bit-identical, `test_torch_prune_int8.py`), and the same rows as sets
for at least 99% of the rows with f32 vectors (an f32 near-tie can order
two candidates the other way). `wave_step` on the same adjacency and wave
is held to 99% of rows equal as sets: its beam search can swap a near-tie's
expansion. A whole build draws its initial links and permutations from a
`torch.Generator`, not from `jax.random`, so it is held by recall."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # the suite runs several workers: do not let each spin a thread per core

import jax
import jax.numpy as jnp

from diskrag_tpu.graph import build as jbuild
from diskrag_tpu.ops.flat_scan_pallas import quantize_int8 as jax_quantize_int8
from diskrag_tpu_torch.benchmark import ground_truth, recall_at_k
from diskrag_tpu_torch.convert import vamana_index_from_jax
from diskrag_tpu_torch.graph import build as tbuild
from diskrag_tpu_torch.graph.search import beam_search

R, L, W = 24, 48, 256


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def jax_graph(clustered_data):
    """The JAX package's wave-built graph over all 2000 points."""
    return jbuild.build_vamana(clustered_data, degree_bound=R, build_width=L, wave_size=W)


def _rows_equal_as_sets(a, b):
    return np.mean([set(x[x >= 0]) == set(y[y >= 0]) for x, y in zip(a, b)])


def _wave_and_pruned(adj, seed):
    """A wave of distinct points and, for each, R new out-edges (rows of
    other points' adjacency, about a fifth -1, some pointing back at the
    wave point itself)."""
    rng = np.random.default_rng(seed)
    n = len(adj)
    wave = rng.choice(n, size=W, replace=False).astype(np.int32)
    pruned = adj[rng.integers(0, n, size=W)].copy()
    pruned[rng.random(pruned.shape) < 0.2] = -1
    pruned[::5, 0] = wave[::5]
    return wave, pruned


def _jax_reverse(vectors, adj, wave, pruned, *, chunk, codes=None, scales=None):
    fn = jax.jit(jbuild._reverse_edges, static_argnames=("max_incoming", "chunk", "metric"))
    return np.asarray(fn(
        jnp.asarray(vectors), jnp.asarray(adj), jnp.asarray(wave), jnp.asarray(pruned),
        jnp.float32(1.2), max_incoming=16, chunk=chunk, metric="l2",
        codes=None if codes is None else jnp.asarray(codes),
        code_scales=None if scales is None else jnp.asarray(scales)))


@pytest.mark.parametrize("with_codes", [True, False])
def test_reverse_edges_match_jax(clustered_data, jax_graph, with_codes):
    adj = np.asarray(jax_graph.adjacency)
    wave, pruned = _wave_and_pruned(adj, seed=1)
    codes = scales = None
    if with_codes:
        c, s = jax_quantize_int8(jnp.asarray(clustered_data))
        codes, scales = np.asarray(c), np.asarray(s)
    # a chunk of 512 targets: the live targets span several chunks
    want = _jax_reverse(clustered_data, adj, wave, pruned, chunk=512, codes=codes, scales=scales)
    got = tbuild._reverse_edges(
        _t(clustered_data), _t(adj), _t(wave), _t(pruned), 1.2, max_incoming=16, chunk=512,
        metric="l2", codes=None if codes is None else _t(codes),
        code_scales=None if scales is None else _t(scales)).numpy()
    assert (got != adj).any(axis=1).sum() > 500  # the pass rewrote many rows
    if with_codes:
        np.testing.assert_array_equal(got, want)
    else:
        assert _rows_equal_as_sets(got, want) >= 0.99


def test_wave_step_matches_jax(clustered_data, jax_graph):
    adj = np.asarray(jax_graph.adjacency)
    rng = np.random.default_rng(2)
    wave = rng.choice(len(adj), size=W, replace=False).astype(np.int32)
    medoid = int(jax_graph.medoid)
    want = np.asarray(jbuild.wave_step(
        jnp.asarray(clustered_data), jnp.asarray(adj.copy()), jnp.int32(medoid),
        jnp.asarray(wave), jnp.float32(1.2), build_width=L, max_incoming=16,
        chunk=min(16384, W * R), metric="l2"))
    got = tbuild.wave_step(
        _t(clustered_data), _t(adj), torch.tensor(medoid, dtype=torch.int32), _t(wave), 1.2,
        build_width=L, max_incoming=16, chunk=min(16384, W * R), metric="l2").numpy()
    assert _rows_equal_as_sets(got, want) >= 0.99


def test_random_regular_init():
    gen = torch.Generator().manual_seed(0)
    adj = tbuild.random_regular_init(gen, 500, 12).numpy()
    assert adj.shape == (500, 12) and adj.dtype == np.int32
    assert adj.min() >= 0 and adj.max() < 500
    assert not (adj == np.arange(500)[:, None]).any()  # no self-loops


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_build_vamana_recall_matches_jax(clustered_data, jax_graph, metric):
    """Exact-traversal recall of the port-built graph within 0.01 of the
    JAX-built one at the same R, L and alpha (other random draws)."""
    pts = clustered_data
    rng = np.random.default_rng(3)
    q = (pts[rng.integers(0, len(pts), 128)]
         + rng.normal(size=(128, pts.shape[1])).astype(np.float32) * 0.1)
    gt = ground_truth(pts, q, 10, metric=metric, device="cpu")
    jg = jax_graph if metric == "l2" else jbuild.build_vamana(
        pts, degree_bound=R, build_width=L, wave_size=W, metric=metric)
    tg = tbuild.build_vamana(pts, degree_bound=R, build_width=L, wave_size=W, metric=metric,
                             device="cpu")
    assert tg.adjacency.shape == (len(pts), R) and int(tg.adjacency.max()) < len(pts)
    jv = vamana_index_from_jax(np.asarray(jg.vectors), np.asarray(jg.adjacency), int(jg.medoid),
                               metric=metric, device="cpu")
    recalls = []
    for g in (tg, jv):
        res = beam_search(g.vectors, g.adjacency, g.medoid, torch.from_numpy(q), search_width=L,
                          k=10, metric=metric)
        recalls.append(recall_at_k(res.ids.numpy(), gt, 10))
    assert recalls[1] >= 0.95, recalls
    assert abs(recalls[0] - recalls[1]) <= 0.01, recalls


def test_medoid_only_wave_build_collapses_in_both_packages(monkeypatch):
    """On `make_dataset`'s clustered points (16 clusters at 4096 x 128), a
    wave build whose searches all start at the medoid leaves whole clusters
    out of reach: the JAX package's `build_vamana` does, and so does the
    port's with its entry points taken away. The port's build, which
    starts every wave's search at min(65536, N/64) k-means entry points
    and stores them on the index, reaches them. Exact traversal, L = 48."""
    from diskrag_tpu_torch.benchmark import make_dataset
    from diskrag_tpu_torch.graph import knn_build

    pts, q = make_dataset(4096, 128, 200, seed=42)
    gt = ground_truth(pts, q, 10, device="cpu")

    def recall(g):
        res = beam_search(g.vectors, g.adjacency, g.medoid, torch.from_numpy(q), search_width=48,
                          k=10, expand_width=8, entry_points=g.entry_points)
        return recall_at_k(res.ids.numpy(), gt, 10)

    jg = jbuild.build_vamana(pts, degree_bound=20, build_width=48)
    got = {"jax": recall(vamana_index_from_jax(np.asarray(jg.vectors), np.asarray(jg.adjacency),
                                               int(jg.medoid), device="cpu"))}
    tg = tbuild.build_vamana(pts, degree_bound=20, build_width=48, device="cpu")
    assert tg.entry_points is not None and len(tg.entry_points) > 1
    got["port"] = recall(tg)
    monkeypatch.setattr(knn_build, "compute_entry_points", lambda *a, **k: np.zeros(0, np.int32))
    tm = tbuild.build_vamana(pts, degree_bound=20, build_width=48, device="cpu")
    assert tm.entry_points is None
    got["port_medoid_only"] = recall(tm)
    print("recall@10", got)
    assert got["jax"] < 0.8 and got["port_medoid_only"] < 0.8, got
    assert got["port"] >= 0.98, got
