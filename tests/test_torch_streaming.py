"""The port's streaming tier (`index/streaming.py`) held against the JAX
package on the seeded `clustered_data` points.

First every test of `tests/test_streaming.py`, on the port. Then:
  - `_knn_forward_rows` and `_reverse_pass` on the JAX package's inputs
    (its int8 codes, exact candidate ids and distances, the same placed
    rows): identical adjacency under L2;
  - a stream begun in the JAX package (graph, buffered inserts, deletes)
    carried into the port by `convert.streaming_from_jax` and searched in
    both: identical ids for buffered hits, >= 99% identical (query, rank)
    slots, recall equal within 0.002;
  - a whole stream (inserts past several merges, deletes, `consolidate`)
    run in each package from the same base graph: recall within 0.01, and
    no tombstoned id ever returned.
A whole merge is held by recall, not by ids: the JAX package's CPU merge
takes its XLA scan branch (an approximate top-k), where the port takes the
fused scan's plain versions; the merge's id-deterministic steps are held
id for id at the function level above.

The capacity bucket pads even an 1800-row base to 65,536 rows, so each
base graph is built once per module (fixtures)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # the suite runs several workers: do not let each spin a thread per core

import jax
import jax.numpy as jnp

from diskrag_tpu.graph import build as jbuild
from diskrag_tpu.index import streaming as jstream
from diskrag_tpu.ops.flat_scan_pallas import quantize_int8 as jax_quantize_int8
from diskrag_tpu_torch.benchmark import ground_truth, recall_at_k
from diskrag_tpu_torch.convert import streaming_from_jax, vamana_index_from_jax
from diskrag_tpu_torch.graph.build import build_vamana
from diskrag_tpu_torch.index import streaming as tstream
from diskrag_tpu_torch.index.streaming import StreamingIndex, auto_buffer_capacity


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def graphs(clustered_data):
    """The port's wave-built graphs over the first 1500 / 1600 / 1800 points."""
    return {n: build_vamana(clustered_data[:n], degree_bound=24, build_width=48, wave_size=256,
                            device="cpu") for n in (1500, 1600, 1800)}


@pytest.fixture(scope="module")
def jax_graphs(clustered_data):
    """The JAX package's graphs over the first 1500 / 1800 points."""
    return {n: jbuild.build_vamana(clustered_data[:n], degree_bound=24, build_width=48,
                                   wave_size=256) for n in (1500, 1800)}


def _ids(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _make(graphs, n, **kw):
    return StreamingIndex(graphs[n], **kw)


def _queries(pts, rng, b):
    return pts[rng.integers(0, len(pts), b)] + rng.normal(size=(b, pts.shape[1])).astype(np.float32) * 0.05


# --- the tests of tests/test_streaming.py, on the port ---------------------------------


def test_auto_buffer_capacity(graphs):
    assert auto_buffer_capacity(200_000) == 32_768
    assert auto_buffer_capacity(1_000_000) == 32_768
    assert auto_buffer_capacity(131_072) == 32_768
    assert auto_buffer_capacity(50_000) == 16_384
    assert auto_buffer_capacity(2_000) == 4_096
    assert _make(graphs, 1800).capacity == 4_096
    assert _make(graphs, 1800, buffer_capacity=256).capacity == 256


def test_insert_immediately_searchable(clustered_data, graphs):
    extra = clustered_data[1800:]
    s = _make(graphs, 1800)
    ids = s.insert(extra)
    assert list(ids) == list(range(1800, 2000))
    assert s.n_buffered == 200
    got, dists = s.search(extra[:32], k=1, search_width=32)
    assert np.mean(_ids(got)[:, 0] == ids[:32]) == 1.0
    assert float(dists[:, 0].max()) < 1e-3


def test_search_merges_tiers(clustered_data, graphs):
    rng = np.random.default_rng(1234)
    s = _make(graphs, 1600)
    s.insert(clustered_data[1600:])
    q = _queries(clustered_data, rng, 64)
    got, _ = s.search(q, k=10, search_width=48)
    gt = ground_truth(clustered_data, q, 10, device="cpu")
    rec = recall_at_k(_ids(got), gt, 10)
    assert rec >= 0.95, f"merged-tier recall {rec:.3f}"


def test_delete_both_tiers(clustered_data, graphs):
    base, extra = clustered_data[:1800], clustered_data[1800:]
    s = _make(graphs, 1800)
    ids = s.insert(extra)
    s.delete([int(ids[0]), 7])
    got = _ids(s.search(np.stack([extra[0], base[7]]), k=5, search_width=48)[0])
    assert int(ids[0]) not in got[0]
    assert 7 not in got[1]


@pytest.mark.parametrize("mm", ["knn", "wave"])
def test_merge_insert_wave_path(clustered_data, graphs, mm):
    extra = clustered_data[1800:]
    s = _make(graphs, 1800, merge_insert_max_fraction=0.5, merge_method=mm)
    ids = s.insert(extra)
    s.merge()
    assert s.n_buffered == 0 and s.n_merges == 1
    assert s.n_graph == 2000
    got, _ = s.search(extra[:32], k=1, search_width=48)
    frac = np.mean(_ids(got)[:, 0] == ids[:32])
    assert frac >= 0.9, f"post-merge self-retrieval {frac:.2f}"


def test_merge_rebuild_path(clustered_data, graphs):
    base, extra = clustered_data[:1600], clustered_data[1600:]
    s = _make(graphs, 1600, merge_insert_max_fraction=0.01)  # force rebuild
    ids = s.insert(extra)
    s.delete([3, 5])
    s.merge()
    assert s.n_graph == 1600 + 400 - 2
    got, _ = s.search(extra[:32], k=1, search_width=48)
    frac = np.mean(_ids(got)[:, 0] == ids[:32])
    assert frac >= 0.9, f"post-rebuild self-retrieval {frac:.2f}"
    got = _ids(s.search(np.stack([base[3], base[5]]), k=5, search_width=48)[0])
    assert 3 not in got[0] and 5 not in got[1]


def test_auto_merge_on_overflow(clustered_data, graphs):
    s = _make(graphs, 1600, buffer_capacity=256, merge_insert_max_fraction=0.5)
    for lo in range(1600, 2000, 100):
        s.insert(clustered_data[lo : lo + 100])
    assert s.n_merges >= 1
    assert s.n_graph + s.n_buffered == 2000
    got, _ = s.search(clustered_data[1900:1932], k=1, search_width=48)
    assert np.mean(_ids(got)[:, 0] == np.arange(1900, 1932)) >= 0.9


def test_oversized_batch_goes_straight_to_graph(clustered_data, graphs):
    extra = clustered_data[1500:]
    s = _make(graphs, 1500, buffer_capacity=128, merge_insert_max_fraction=0.5)
    ids = s.insert(extra)  # 500 > capacity
    assert s.n_buffered == 0
    assert s.n_graph == 2000
    got, _ = s.search(extra[:32], k=1, search_width=48)
    assert np.mean(_ids(got)[:, 0] == ids[:32]) >= 0.9


def test_consolidate_compacts_tombstones(clustered_data, graphs):
    base = clustered_data[:1800]
    s = _make(graphs, 1800, merge_insert_max_fraction=0.5)
    s.insert(clustered_data[1800:])
    s.delete(list(range(0, 100)))
    s.consolidate()
    assert s.n_graph == 1900
    assert s._n_deleted == 0
    got, _ = s.search(base[150:182], k=1, search_width=48)
    assert np.mean(_ids(got)[:, 0] == np.arange(150, 182)) >= 0.9
    got, _ = s.search(base[:8], k=3, search_width=48)
    assert not np.isin(_ids(got), np.arange(100)).any()


@pytest.mark.parametrize("mm", ["knn", "wave"])
def test_recall_holds_during_ingest(clustered_data, graphs, mm):
    rng = np.random.default_rng(1234)
    s = _make(graphs, 1500, buffer_capacity=128, merge_insert_max_fraction=0.3, merge_method=mm)
    q = _queries(clustered_data, rng, 48)
    recs = []
    for lo in range(1500, 2000, 100):
        s.insert(clustered_data[lo : lo + 100])
        got, _ = s.search(q, k=10, search_width=48)
        gt = ground_truth(clustered_data[: lo + 100], q, 10, device="cpu")
        recs.append(recall_at_k(_ids(got), gt, 10))
    assert min(recs) >= 0.95, f"ingest recall dipped to {min(recs):.3f}"


def test_knn_merge_cosine_masks_pad_rows(clustered_data):
    data = clustered_data / np.linalg.norm(clustered_data, axis=1, keepdims=True)
    idx = build_vamana(data[:1800], degree_bound=24, build_width=48, wave_size=256,
                       metric="cosine", device="cpu")
    s = StreamingIndex(idx, merge_insert_max_fraction=0.5, merge_method="knn")
    ids = s.insert(data[1800:])
    s.merge()
    adj = s.index.adjacency[: s.n_graph].numpy()
    assert adj.max() < s.n_graph, "merge linked into capacity-pad rows"
    got, _ = s.search(data[1800:1816], k=1, search_width=48)
    assert np.mean(_ids(got)[:, 0] == ids[:16]) >= 0.9


def test_delete_idempotent_and_live_count(clustered_data, graphs):
    s = _make(graphs, 1800)
    ids = s.insert(clustered_data[1800:])
    n0 = s.n_total_live
    assert n0 == 2000
    s.delete([int(ids[0]), 7])
    assert s.n_total_live == n0 - 2
    s.delete([int(ids[0]), 7])
    assert s.n_total_live == n0 - 2
    with pytest.raises(KeyError):
        s.delete([999_999])
    s.delete([int(ids[1])])
    s.merge()
    assert s.n_total_live == n0 - 3
    assert s.n_buffered == 0
    s.delete([int(ids[0]), int(ids[1])])
    assert s.n_total_live == n0 - 3
    s.consolidate()
    assert s.n_total_live == n0 - 3
    assert s.n_graph == n0 - 3


def test_reserve_inserts_prevents_growth(clustered_data, graphs):
    extra = clustered_data[1800:]
    s = _make(graphs, 1800, buffer_capacity=64, reserve_inserts=len(extra))
    cap0 = s._graph_capacity
    assert cap0 >= s.n_graph + 64 + len(extra)
    for off in range(0, len(extra), 32):
        s.insert(extra[off : off + 32])
    s.merge()
    assert s._graph_capacity == cap0, "growth event fired despite reserve"
    assert s.n_graph == 2000
    s2 = _make(graphs, 1800, buffer_capacity=64)
    s2.reserve(len(extra))
    cap1 = s2._graph_capacity
    for off in range(0, len(extra), 32):
        s2.insert(extra[off : off + 32])
    s2.merge()
    assert s2._graph_capacity == cap1


def test_delete_batch_with_unknown_id_is_side_effect_free(clustered_data, graphs):
    base, extra = clustered_data[:1800], clustered_data[1800:]
    s = _make(graphs, 1800)
    ids = s.insert(extra)
    n0 = s.n_total_live
    with pytest.raises(KeyError):
        s.delete([int(ids[0]), 7, 999_999])
    assert s.n_total_live == n0
    got = _ids(s.search(np.stack([extra[0], base[7]]), k=1, search_width=48)[0])
    assert got[0, 0] == int(ids[0]) and got[1, 0] == 7
    assert s.delete([int(ids[0]), 7]) == 2
    assert s.n_total_live == n0 - 2


def test_delete_returns_newly_tombstoned_count(clustered_data, graphs):
    s = _make(graphs, 1800)
    ids = s.insert(clustered_data[1800:])
    assert s.delete([int(ids[0]), 7]) == 2
    assert s.delete([int(ids[0]), 7]) == 0
    assert s.delete([int(ids[0]), 9]) == 1


def test_rows_compacted_flag(clustered_data, graphs):
    extra = clustered_data[1600:]
    s = _make(graphs, 1600, merge_insert_max_fraction=0.01)
    s.insert(extra)
    s.merge()
    assert not s.rows_compacted
    s = _make(graphs, 1600, merge_insert_max_fraction=0.01)
    s.insert(extra)
    s.delete([3, 5])
    s.merge()
    assert s._n_deleted == 0
    assert s.rows_compacted
    s2 = _make(graphs, 1600, merge_insert_max_fraction=0.5)
    s2.insert(extra)
    s2.delete([3])
    s2.consolidate()
    assert s2._n_deleted == 0
    assert s2.rows_compacted


# --- against the JAX package ------------------------------------------------------------


def _merge_inputs(clustered_data, jax_graphs, cap=4096):
    """The state a kNN merge of 200 rows over the JAX 1800-row graph sees:
    padded vectors (pads at 1e15) and adjacency with the new rows' random
    links, the JAX package's int8 codes, and each new row's exact top-65
    candidates over the padded table (self and pad rows included, as the
    fused scan returns them), ascending, ties to the lower id."""
    g = jax_graphs[1800]
    n0, m = 1800, 200
    rng = np.random.default_rng(11)
    vecs = np.full((cap, clustered_data.shape[1]), 1e15, np.float32)
    vecs[:2000] = clustered_data
    adj = np.full((cap, 24), -1, np.int32)
    adj[:n0] = np.asarray(g.adjacency)
    adj[n0 : n0 + m] = rng.integers(0, n0, size=(m, 24))
    codes, scales = (np.asarray(x) for x in jax_quantize_int8(jnp.asarray(vecs)))
    q = vecs[n0 : n0 + m].astype(np.float64)
    d = ((q[:, None, :] - vecs[None, :2100].astype(np.float64)) ** 2).sum(-1)  # 100 pad rows in reach
    cand = np.argsort(d, axis=1, kind="stable")[:, :65].astype(np.int32)
    cand[::7, -1] = 2050  # a pad row among the candidates
    cd = np.take_along_axis(d, cand.astype(np.int64), 1).astype(np.float32)
    return vecs, adj, codes, scales, np.arange(n0, n0 + m, dtype=np.int32), cand, cd


def test_knn_forward_and_reverse_match_jax(clustered_data, jax_graphs):
    vecs, adj, codes, scales, wave, cand, cd = _merge_inputs(clustered_data, jax_graphs)
    n_used = 2000
    fwd = jax.jit(jstream._knn_forward_rows, static_argnames=("metric",))
    j_adj, j_pruned = fwd(jnp.asarray(vecs), jnp.asarray(adj), jnp.asarray(wave),
                          jnp.asarray(cand), jnp.asarray(cd), jnp.int32(n_used), jnp.float32(1.2),
                          metric="l2", codes=jnp.asarray(codes), code_scales=jnp.asarray(scales))
    t_adj, t_pruned = tstream._knn_forward_rows(
        _t(vecs), _t(adj), _t(wave), _t(cand), _t(cd), n_used, 1.2, metric="l2",
        codes=_t(codes), code_scales=_t(scales))
    np.testing.assert_array_equal(t_pruned.numpy(), np.asarray(j_pruned))
    np.testing.assert_array_equal(t_adj.numpy(), np.asarray(j_adj))
    assert t_pruned.numpy().max() < n_used  # no link to a pad row

    j_adj2 = jstream._reverse_pass(
        jnp.asarray(vecs), j_adj, jnp.asarray(wave), j_pruned, jnp.float32(1.2),
        max_incoming=16, chunk=min(8192, 200 * 24), metric="l2",
        codes=jnp.asarray(codes), code_scales=jnp.asarray(scales))
    t_adj2 = tstream._reverse_pass(
        _t(vecs), t_adj, _t(wave), t_pruned, 1.2, max_incoming=16, chunk=min(8192, 200 * 24),
        metric="l2", codes=_t(codes), code_scales=_t(scales))
    np.testing.assert_array_equal(t_adj2.numpy(), np.asarray(j_adj2))


@pytest.fixture(scope="module")
def jax_stream(clustered_data, jax_graphs):
    """A JAX stream over the 1800-row graph: 200 buffered inserts, three
    deletes (two graph rows, one buffered)."""
    s = jstream.StreamingIndex(jax_graphs[1800])
    s.insert(clustered_data[1800:])
    s.delete([5, 11, 1850])
    return s


def test_carried_stream_search_matches_jax(clustered_data, jax_stream):
    s = streaming_from_jax(jax_stream, device="cpu")
    assert (s.n_graph, s.n_buffered, s.n_total_live, s.capacity) == (
        jax_stream.n_graph, jax_stream.n_buffered, jax_stream.n_total_live, jax_stream.capacity)
    rng = np.random.default_rng(8)
    q = np.concatenate([clustered_data[1800:1864], _queries(clustered_data, rng, 128)])
    want, _ = jax_stream.search(q, k=10, search_width=48)
    got, _ = s.search(q, k=10, search_width=48)
    want, got = np.asarray(want), _ids(got)
    # buffered hits: the buffer scan is exact, so their ids are identical
    buffered = got >= 1800
    np.testing.assert_array_equal(got[:64, 0], want[:64, 0])
    np.testing.assert_array_equal(got[buffered], want[buffered])
    assert np.mean(got == want) >= 0.99
    live = np.ones(2000, bool)
    live[[5, 11, 1850]] = False
    gt_rows = ground_truth(clustered_data[live], q, 10, device="cpu")
    gt = np.flatnonzero(live)[gt_rows]
    r_port, r_jax = recall_at_k(got, gt, 10), recall_at_k(want, gt, 10)
    assert abs(r_port - r_jax) <= 0.002, (r_port, r_jax)
    assert not np.isin(got, [5, 11, 1850]).any()
    # the carried stream goes on in the port: its next insert takes the next id
    assert int(s.insert(clustered_data[:1])[0]) == 2000


def test_whole_stream_recall_matches_jax(clustered_data, jax_graphs):
    """From the same base graph, both packages take 500 inserts (past
    several merges), deletes and a consolidate."""
    g = jax_graphs[1500]
    kw = dict(buffer_capacity=128, merge_insert_max_fraction=0.3)
    js = jstream.StreamingIndex(g, **kw)
    ts = StreamingIndex(vamana_index_from_jax(np.asarray(g.vectors), np.asarray(g.adjacency),
                                              int(g.medoid), device="cpu"), **kw)
    rng = np.random.default_rng(9)
    q = _queries(clustered_data, rng, 64)
    dead = np.array([2, 40, 700, 1510, 1777, 1990])
    recs = {"jax": [], "port": []}
    gone = np.zeros(0, np.int64)
    for lo in range(1500, 2000, 100):
        batch = clustered_data[lo : lo + 100]
        js.insert(batch)
        ts.insert(batch)
        if lo == 1700:  # graph rows and buffered rows
            gone = dead[dead < 1800]
            js.delete(gone)
            ts.delete(gone)
        live = np.ones(lo + 100, bool)
        live[gone] = False
        gt = np.flatnonzero(live)[ground_truth(clustered_data[: lo + 100][live], q, 10, device="cpu")]
        for name, s in (("jax", js), ("port", ts)):
            got = _ids(s.search(q, k=10, search_width=48)[0])
            assert not np.isin(got, gone).any(), name
            recs[name].append(recall_at_k(got, gt, 10))
    assert ts.n_merges == js.n_merges >= 2
    js.delete(dead[dead >= 1800])
    ts.delete(dead[dead >= 1800])
    js.consolidate()
    ts.consolidate()
    assert ts.n_graph == js.n_graph == 2000 - len(dead)
    live = np.ones(2000, bool)
    live[dead] = False
    gt = np.flatnonzero(live)[ground_truth(clustered_data[live], q, 10, device="cpu")]
    for name, s in (("jax", js), ("port", ts)):
        got = _ids(s.search(q, k=10, search_width=48)[0])
        assert not np.isin(got, dead).any(), name
        recs[name].append(recall_at_k(got, gt, 10))
    assert min(recs["jax"]) >= 0.95, recs
    assert max(abs(a - b) for a, b in zip(recs["jax"], recs["port"])) <= 0.01, recs
