"""The port's graph search held against the JAX package on one graph,
built once by the JAX package and carried across
(`convert.vamana_index_from_jax`).

Exact traversal is held id for id (ids, visited log, n_expanded, n_steps):
for L2 and dot the vectors are small integers, so every product and sum
is exact in f32 whatever its order, distances tie often, and the only
thing that can differ is the tie rule; cosine runs on +-1 vectors, whose
norms (4 at D = 16) and normalised products are exact too.
PQ-guided traversal sums its table entries in another order than XLA, so
it is held on >= 99% of (query, rank) slots and to equal recall."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # the suite runs several workers: do not let each spin a thread per core

import jax.numpy as jnp

from diskrag_tpu.graph import search as jsearch
from diskrag_tpu.graph.knn_build import build_vamana_knn as jax_build
from diskrag_tpu.ops import topk as jtopk
from diskrag_tpu.pq import ProductQuantizer as JaxPQ, ResidualPQ as JaxRPQ
from diskrag_tpu_torch.benchmark import ground_truth, recall_at_k
from diskrag_tpu_torch.convert import pq_from_jax, vamana_index_from_jax
from diskrag_tpu_torch.graph import search as tsearch
from diskrag_tpu_torch.ops import topk as ttopk

N, D, R, B = 1200, 16, 12, 24


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def graph():
    """(integer-valued vectors, float vectors, JAX index, port index,
    queries for each). The graph is built on the integer vectors; the
    float set reuses its adjacency (any graph will do to compare two
    traversals of it)."""
    rng = np.random.default_rng(0)
    centers = rng.integers(-6, 7, size=(10, D))
    ints = (centers[rng.integers(0, 10, size=N)] + rng.integers(-2, 3, size=(N, D))).astype(np.float32)
    floats = (ints + rng.normal(size=(N, D)) * 0.37).astype(np.float32)
    jidx = jax_build(ints, degree_bound=R, alpha=1.2, seed=0)
    adj = np.asarray(jidx.adjacency)
    eps = np.asarray(jidx.entry_points)
    med = int(jidx.medoid)
    q_int = ints[rng.integers(0, N, size=B)] + rng.integers(-1, 2, size=(B, D)).astype(np.float32)
    q_int[5] = q_int[0]            # a duplicated query
    q_int[6] = ints[17]            # a query that is a database point
    q_flt = (floats[rng.integers(0, N, size=B)] + rng.normal(size=(B, D)) * 0.3).astype(np.float32)
    q_flt[5] = q_flt[0]
    signs = np.where(floats >= 0, 1.0, -1.0).astype(np.float32)
    q_sgn = signs[rng.integers(0, N, size=B)] * np.where(rng.random(size=(B, D)) < 0.1, -1.0, 1.0)
    q_sgn[5] = q_sgn[0]
    return {"ints": ints, "floats": floats, "signs": signs, "adj": adj, "eps": eps, "med": med,
            "q_int": q_int.astype(np.float32), "q_flt": q_flt, "q_sgn": q_sgn.astype(np.float32)}


def _both_exact(g, metric, *, width, e, seeds, k=5, fn="beam_search", max_steps=None):
    vecs = g["signs"] if metric == "cosine" else g["ints"]
    q = g["q_sgn"] if metric == "cosine" else g["q_int"]
    eps = g["eps"] if seeds else None
    jargs = (jnp.asarray(vecs), jnp.asarray(g["adj"]), jnp.asarray(g["med"], jnp.int32), jnp.asarray(q))
    jkw = dict(search_width=width, k=k, metric=metric, expand_width=e, max_steps=max_steps,
               entry_points=None if eps is None else jnp.asarray(eps))
    tidx = vamana_index_from_jax(vecs, g["adj"], g["med"], metric=metric,
                                 entry_points=eps, device="cpu")
    targs = (tidx.vectors, tidx.adjacency, tidx.medoid, _t(q))
    tkw = dict(search_width=width, k=k, metric=metric, expand_width=e, max_steps=max_steps,
               entry_points=tidx.entry_points)
    if fn == "beam_search_reranked":
        jargs = (jargs[0].astype(jnp.bfloat16),) + jargs
        targs = (targs[0].to(torch.bfloat16),) + targs
    return getattr(jsearch, fn)(*jargs, **jkw), getattr(tsearch, fn)(*targs, **tkw)


def _assert_same_traversal(jres, tres):
    assert np.array_equal(tres.ids.numpy(), np.asarray(jres.ids))
    assert np.array_equal(tres.visited_ids.numpy(), np.asarray(jres.visited_ids))
    assert np.array_equal(tres.n_expanded.numpy(), np.asarray(jres.n_expanded))
    assert int(tres.n_steps) == int(jres.n_steps)
    jd, td = np.asarray(jres.dists), tres.dists.numpy()
    assert np.array_equal(np.isinf(jd), np.isinf(td))
    fin = np.isfinite(jd)
    # L2 expansions and dot products are summed in another order: rtol
    # 1e-5 of the largest distance
    np.testing.assert_allclose(td[fin], jd[fin], rtol=1e-5, atol=1e-5 * np.abs(jd[fin]).max())
    jv, tv = np.asarray(jres.visited_dists), tres.visited_dists.numpy()
    assert np.array_equal(np.isinf(jv), np.isinf(tv))


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
@pytest.mark.parametrize("e", [1, 4])
@pytest.mark.parametrize("seeds,width", [(True, 8), (True, 32), (False, 16)])
def test_beam_search_matches_jax_id_for_id(graph, metric, e, seeds, width):
    # 19 seeds (medoid + 18 entry points): width 8 takes the S >= L branch,
    # width 32 the padded one
    assert len(graph["eps"]) + 1 > 8 and len(graph["eps"]) + 1 < 32
    jres, tres = _both_exact(graph, metric, width=width, e=e, seeds=seeds)
    _assert_same_traversal(jres, tres)
    assert np.array_equal(tres.ids[0].numpy(), tres.ids[5].numpy())  # duplicated query


@pytest.mark.parametrize("e", [1, 2, 4])
def test_loop_stops_at_convergence(graph, e):
    """The host-steered loop ends on the round the JAX `while_loop` ends
    on, before the `max_steps` cap of ceil(2L / E)."""
    jres, tres = _both_exact(graph, "l2", width=16, e=e, seeds=True)
    _assert_same_traversal(jres, tres)
    assert 0 < int(tres.n_steps) < -(-32 // e)


def test_max_steps_cap_and_k_guard(graph):
    jres, tres = _both_exact(graph, "l2", width=16, e=1, seeds=False, max_steps=3)
    _assert_same_traversal(jres, tres)
    assert int(tres.n_steps) == 3 and tres.visited_ids.shape == (B, 3)
    with pytest.raises(ValueError, match="search_width"):
        _both_exact(graph, "l2", width=4, e=1, seeds=False, k=5)


@pytest.mark.parametrize("e", [1, 4, 8])
@pytest.mark.parametrize("width", [16, 32])
@pytest.mark.parametrize("seeds", [True, False])
def test_batch_search_is_each_query_searched_alone(graph, e, width, seeds):
    """What G1 (`ops/traverse.py`, a block a query that stops on its own)
    rests on: a query with no active selection never changes state in the
    batch loop, so the batch's ids, distances, visited log and n_expanded
    are each query's searched alone, and its n_steps their largest."""
    tidx = vamana_index_from_jax(graph["ints"], graph["adj"], graph["med"], metric="l2",
                                 entry_points=graph["eps"] if seeds else None, device="cpu")
    q = _t(graph["q_int"])
    kw = dict(search_width=width, k=width, expand_width=e, entry_points=tidx.entry_points)
    batch = tsearch.beam_search(tidx.vectors, tidx.adjacency, tidx.medoid, q, **kw)
    steps = []
    for i in range(B):
        one = tsearch.beam_search(tidx.vectors, tidx.adjacency, tidx.medoid, q[i : i + 1], **kw)
        for field in ("ids", "dists", "visited_ids", "visited_dists", "n_expanded"):
            assert torch.equal(getattr(batch, field)[i], getattr(one, field)[0]), (i, field)
        steps.append(int(one.n_steps))
    assert int(batch.n_steps) == max(steps)
    # the queries stop at different rounds, unless the cap of ceil(2L / E) stops them all
    assert min(steps) < max(steps) or min(steps) == -(-2 * width // e)


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_beam_search_reranked_matches_jax(graph, metric):
    """bf16 traversal + f32 rerank: small integers are exact in bf16, so
    the traversal and the reranked ids are the JAX package's."""
    jres, tres = _both_exact(graph, metric, width=16, e=2, seeds=True, fn="beam_search_reranked")
    _assert_same_traversal(jres, tres)


def test_gathered_distance_bf16_accumulates_in_f32():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(4, 64)).astype(np.float32)
    v = rng.normal(size=(4, 7, 64)).astype(np.float32)
    for metric in ("l2", "cosine", "dot"):
        want = np.asarray(jsearch._gathered_distance(
            jnp.asarray(q), jnp.asarray(v).astype(jnp.bfloat16), metric))
        got = tsearch._gathered_distance(_t(q), _t(v).to(torch.bfloat16), metric)
        assert got.dtype == torch.float32
        # bf16 inputs, f32 sums in another order: 1e-5 of the scale
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def quantizers(graph):
    pts = graph["floats"]
    jpq = JaxPQ(n_subvectors=4).fit(pts, seed=0, max_iter=5)
    jrpq = JaxRPQ(n_subvectors=4, n_coarse=16).fit(pts, seed=0, max_iter=5, coarse_iters=5)
    return jpq, jrpq


@pytest.mark.parametrize("kind", ["plain", "residual"])
@pytest.mark.parametrize("rerank", [True, False])
def test_beam_search_pq_matches_jax(graph, quantizers, kind, rerank):
    pts, q = graph["floats"], graph["q_flt"]
    jpq = quantizers[0] if kind == "plain" else quantizers[1]
    eps = graph["eps"]
    jkw = dict(search_width=24, k=5, rerank=rerank, vectors=jnp.asarray(pts),
               queries=jnp.asarray(q), expand_width=2, entry_points=jnp.asarray(eps),
               use_pallas_adc=True)
    tidx = vamana_index_from_jax(pts, graph["adj"], graph["med"], entry_points=eps, device="cpu")
    tkw = dict(search_width=24, k=5, rerank=rerank, vectors=tidx.vectors, queries=_t(q),
               expand_width=2, entry_points=tidx.entry_points)
    if kind == "plain":
        jcodes = np.asarray(jpq.encode(pts))
        pq, codes_t, _, _ = pq_from_jax(jpq.to_arrays(), jcodes, device="cpu")
        jtables, ttables = jpq.compute_distance_tables(q), pq.compute_distance_tables(q)
    else:
        jcodes, jcid = (np.asarray(a) for a in jpq.encode(pts))
        jbias = np.asarray(jpq.point_bias(jcodes, jcid))
        pq, codes_t, cells_t, bias_t = pq_from_jax(jpq.to_arrays(), jcodes, jcid, jbias, device="cpu")
        jtables, ttables = jpq.inner_tables(q), pq.inner_tables(q)
        jkw.update(point_cell=jnp.asarray(jcid), point_bias=jnp.asarray(jbias),
                   cell_tables=jpq.cell_tables(q))
        tkw.update(point_cell=cells_t, point_bias=bias_t, cell_tables=pq.cell_tables(q))
    # the JAX side runs its Pallas kernel; interpret mode is what a CPU
    # backend gives pallas_call
    import functools
    from unittest import mock

    from diskrag_tpu.ops import pq_scan as jpqs

    interp = functools.partial(jpqs.adc_lookup_gathered_pallas, interpret=True)
    with mock.patch.object(jpqs, "adc_lookup_gathered_pallas", interp):
        jres = jsearch.beam_search_pq.__wrapped__(
            jnp.asarray(jcodes), jtables, jnp.asarray(graph["adj"]),
            jnp.asarray(graph["med"], jnp.int32), **jkw)
    tres = tsearch.beam_search_pq(codes_t, ttables, tidx.adjacency, tidx.medoid, **tkw)
    ji, ti = np.asarray(jres.ids), tres.ids.numpy()
    assert ti.shape == ji.shape == (B, 5)
    assert (ti == ji).mean() >= 0.99
    gt = ground_truth(pts, q, 5, device="cpu")
    assert abs(recall_at_k(ti, gt, 5) - recall_at_k(ji, gt, 5)) <= 0.002
    assert abs(int(tres.n_steps) - int(jres.n_steps)) <= 1
    if not rerank:
        with pytest.raises(ValueError, match="requires vectors"):
            tsearch.beam_search_pq(codes_t, ttables, tidx.adjacency, tidx.medoid,
                                   search_width=8, k=4, rerank=True)
    if kind == "residual":
        with pytest.raises(ValueError, match="together"):
            tsearch.beam_search_pq(codes_t, ttables, tidx.adjacency, tidx.medoid,
                                   search_width=8, k=4, rerank=False, point_cell=cells_t)


@pytest.mark.parametrize("kind", ["plain", "residual"])
def test_beam_search_pq_makes_one_lookup_call_per_round(graph, quantizers, kind, monkeypatch):
    """A round's whole distance step is one call of B5's by-id wrapper (on
    the card: one launch a round), with the residual operands where the
    quantizer has them; the gathered wrapper is not called."""
    from diskrag_tpu_torch.ops import pq_scan

    pts, q = graph["floats"], graph["q_flt"]
    jpq = quantizers[0] if kind == "plain" else quantizers[1]
    tidx = vamana_index_from_jax(pts, graph["adj"], graph["med"], entry_points=graph["eps"],
                                 device="cpu")
    if kind == "plain":
        pq, codes_t, _, _ = pq_from_jax(jpq.to_arrays(), np.asarray(jpq.encode(pts)), device="cpu")
        tables, aux = pq.compute_distance_tables(q), {}
    else:
        jcodes, jcid = (np.asarray(a) for a in jpq.encode(pts))
        pq, codes_t, cells_t, bias_t = pq_from_jax(
            jpq.to_arrays(), jcodes, jcid, np.asarray(jpq.point_bias(jcodes, jcid)), device="cpu")
        tables = pq.inner_tables(q)
        aux = {"point_cell": cells_t, "point_bias": bias_t, "cell_tables": pq.cell_tables(q)}
    calls = []
    real = pq_scan.adc_lookup_ids_kernel

    def spy(*a, **k):
        calls.append(sorted(k))
        return real(*a, **k)

    def never(*a, **k):
        raise AssertionError("the gathered wrapper was called")

    monkeypatch.setattr(pq_scan, "adc_lookup_ids_kernel", spy)
    monkeypatch.setattr(pq_scan, "adc_lookup_gathered_kernel", never)
    res = tsearch.beam_search_pq(codes_t, tables, tidx.adjacency, tidx.medoid, search_width=24,
                                 k=5, rerank=False, expand_width=2,
                                 entry_points=tidx.entry_points, **aux)
    assert int(res.n_steps) > 1 and len(calls) == int(res.n_steps)
    assert all(c == sorted(aux) for c in calls)


def test_seed_scoring_is_chunked_past_4096_seeds():
    """More entry points than one tile of the shared seed lookup: the
    tiled scores equal the untiled ones."""
    rng = np.random.default_rng(8)
    n = 5000
    adj = _t(rng.integers(0, n, size=(n, 4)).astype(np.int32))
    codes = _t(rng.integers(0, 256, size=(n, 4)).astype(np.uint8))
    tables = _t(rng.random(size=(3, 4, 256)).astype(np.float32))
    eps = _t(np.arange(1, 4500, dtype=np.int32))
    res = tsearch.beam_search_pq(codes, tables, adj, torch.tensor(0), search_width=6, k=6,
                                 rerank=False, entry_points=eps, max_steps=1)
    from diskrag_tpu_torch.pq.product_quantizer import adc_lookup

    d0 = adc_lookup(tables, codes[:4500])
    want = torch.sort(d0, dim=1, stable=True).values[:, 0]
    # after one round the best seed is still on the beam or was beaten
    assert bool((res.dists[:, 0] <= want).all())


def test_exact_rerank_with_invalid_and_duplicate_pool_ids(graph):
    pts, q = graph["ints"], graph["q_int"][:6]
    rng = np.random.default_rng(3)
    ids = rng.integers(0, N, size=(6, 8)).astype(np.int32)
    vis = rng.integers(0, N, size=(6, 10)).astype(np.int32)
    ids[:, 2] = -1
    vis[:, 4] = ids[:, 0]     # the same id on the beam and in the log
    vis[:, 7:] = -1
    vis[3] = -1
    ids[3, 1:] = -1           # fewer valid ids than k: -1 / inf padded
    z = np.zeros((6,), np.int32)
    jres = jsearch.SearchResult(
        ids=jnp.asarray(ids), dists=jnp.zeros((6, 8)), visited_ids=jnp.asarray(vis),
        visited_dists=jnp.zeros((6, 10)), n_expanded=jnp.asarray(z), n_steps=jnp.asarray(0))
    tres = tsearch.SearchResult(
        ids=_t(ids), dists=torch.zeros((6, 8)), visited_ids=_t(vis),
        visited_dists=torch.zeros((6, 10)), n_expanded=_t(z), n_steps=torch.tensor(0))
    for metric in ("l2", "dot"):
        want = jsearch.exact_rerank(jnp.asarray(pts), jnp.asarray(q), jres, 5, metric)
        got = tsearch.exact_rerank(_t(pts), _t(q), tres, 5, metric)
        assert np.array_equal(got.ids.numpy(), np.asarray(want.ids))
        assert np.array_equal(got.dists.numpy(), np.asarray(want.dists))  # integers: exact
        assert (got.ids[3, 1:] == -1).all() and torch.isinf(got.dists[3, 1:]).all()
        for row in got.ids.numpy():
            valid = row[row >= 0]
            assert len(set(valid.tolist())) == len(valid)


def test_topk_primitives_break_ties_as_jax():
    rng = np.random.default_rng(5)
    ids = rng.integers(-1, 12, size=(40, 30)).astype(np.int32)     # many duplicates, some -1
    dists = rng.integers(0, 4, size=(40, 30)).astype(np.float32)   # many equal distances
    dists[rng.random(size=dists.shape) < 0.15] = np.inf
    got = ttopk.mask_duplicates(_t(ids), _t(dists))
    assert np.array_equal(got.numpy(), np.asarray(jtopk.mask_duplicates(jnp.asarray(ids), jnp.asarray(dists))))
    for k in (1, 7, 30):
        want = jtopk.sort_topk_unique(jnp.asarray(ids), jnp.asarray(dists), k)
        have = ttopk.sort_topk_unique(_t(ids), _t(dists), k)
        for w, h in zip(want, have):
            assert np.array_equal(h.numpy(), np.asarray(w))
        wv, wi = jtopk.topk_smallest(jnp.asarray(dists), k)
        hv, hi = ttopk.topk_smallest(_t(dists), k)
        assert np.array_equal(hv.numpy(), np.asarray(wv)) and np.array_equal(hi.numpy(), np.asarray(wi))
    want = jtopk.merge_topk(jnp.asarray(ids[:, :18]), jnp.asarray(dists[:, :18]),
                            jnp.asarray(ids[:, 18:]), jnp.asarray(dists[:, 18:]), 9)
    have = ttopk.merge_topk(_t(ids[:, :18]), _t(dists[:, :18]), _t(ids[:, 18:]), _t(dists[:, 18:]), 9)
    for w, h in zip(want, have):
        assert np.array_equal(h.numpy(), np.asarray(w))


def test_mask_duplicates_row_chunks_agree(monkeypatch):
    rng = np.random.default_rng(6)
    ids = _t(rng.integers(-1, 20, size=(50, 40)).astype(np.int32))
    dists = _t(rng.integers(0, 5, size=(50, 40)).astype(np.float32))
    whole = ttopk.mask_duplicates(ids, dists)
    monkeypatch.setattr(ttopk, "_PAIR_ELEMS", 40 * 40 * 7)  # 7 rows a chunk
    assert torch.equal(ttopk.mask_duplicates(ids, dists), whole)
