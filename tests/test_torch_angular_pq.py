"""The angular deployment at ann-benchmarks `glove-100-angular`'s widths
(D 100, normalize then L2, residual PQ with m = 50 sub-vectors) served
through the engine's PQ-guided path on the CPU at a small size, held
against the plain reference `tests/plain_angular_pq.py`; the engine's
expand width taken from the index meta; the spans and counters of the
PQ-guided search. The test marked `cuda` holds B5 at m = 50 (its
byte-load path, m % 4 != 0) bit-identical to its plain version on a card.

Sizes: 4,000 points in 40 clusters, D 100, m 50, 64 coarse cells, R 16,
L 32, E 4, 64 queries, all seeded."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # the suite runs several workers: do not let each spin a thread per core

from plain_angular_pq import angular_l2sq, cosine_topk, residual_pq_l2sq

from diskrag_tpu_torch.benchmark import make_dataset, recall_at_k
from diskrag_tpu_torch.data.collection import CollectionManager
from diskrag_tpu_torch.engine import SearchEngine
from diskrag_tpu_torch.graph.knn_build import build_vamana_knn
from diskrag_tpu_torch.graph.search import beam_search_iq, beam_search_pq, exact_rerank
from diskrag_tpu_torch.index.persist import save_index
from diskrag_tpu_torch.ops import pq_scan
from diskrag_tpu_torch.pq.intq import IntQuantizer
from diskrag_tpu_torch.pq.residual import ResidualPQ
from diskrag_tpu_torch.utils import profiling

N, D, M, CELLS, R, L, E, B, K = 4000, 100, 50, 64, 16, 32, 4, 64, 10
# the float32 norm expansion q.q + v.v - 2 q.v of unit vectors rounds at
# ~1e-7 of its terms (q.q + v.v = 2); 1e-5 of them leaves that room
# nearly a hundredfold, and a bf16 rerank (~4e-3 a product) exceeds it
DIST_TOL = 1e-5 * 2.0


@pytest.fixture(scope="module")
def data():
    """(raw points, raw queries, unit points f32, unit queries f32)."""
    raw, raw_q = make_dataset(N, D, B, seed=22, n_clusters=40)
    unit = lambda x: (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)  # noqa: E731
    return raw, raw_q, unit(raw), unit(raw_q)


@pytest.fixture(scope="module")
def built(data, tmp_path_factory):
    """The graph, the residual PQ and the iq8 quantizer over the unit
    points, and collections that serve them: "rpq" / "iq" without an
    expand width in the meta, "rpq_e4" / "iq_e4" with E 4."""
    pts = data[2]
    index = build_vamana_knn(pts, degree_bound=R, alpha=1.2, seed=0, device="cpu")
    # Lloyd's 4 rounds after the k-means++ seeding: the test needs codes, not the best ones
    rpq = ResidualPQ(n_subvectors=M, n_coarse=CELLS, device="cpu").fit(pts, seed=0, max_iter=4)
    codes, cells = rpq.encode(pts)
    iq = IntQuantizer(bits=8, device="cpu").fit(pts, seed=0)
    quantizers = {"rpq": {"pq": rpq, "pq_codes": codes, "pq_coarse_ids": cells},
                  "iq": {"pq": iq, "pq_codes": iq.encode(pts)}}
    base = tmp_path_factory.mktemp("angular_pq")
    mgr = CollectionManager(base)
    texts = [f"word {i}" for i in range(N)]
    for kind, kwargs in quantizers.items():
        for name, meta in ((kind, {}), (f"{kind}_e4", {"recommended_expand_width": E})):
            mgr.create_collection(name, D)
            mgr.update_collection(name, pts, texts, [{"i": i} for i in range(N)])
            save_index(mgr.get_index_dir(name), index, host_vectors=pts,
                       meta_extra={"recommended_search_L": L, **meta}, **kwargs)
    return {"base": base, "index": index, "rpq": rpq, "codes": codes, "cells": cells}


def _engine(built, name):
    return SearchEngine(name, base_dir=str(built["base"]), run_diagnostics=False, device="cpu")


def test_pq_accelerated_answers_are_the_angular_reference(data, built):
    """Each distance is 2 - 2 cos of its id (squared, as the engine takes
    the root of L2); recall@10 against the cosine top-10 of the raw
    vectors; a bf16 rerank of the same traversal misses the width."""
    raw, raw_q, _, q = data
    eng = _engine(built, "rpq_e4")
    dists, ids, stats = eng.search_batch(q, k=K, l_search=L)
    assert stats["search_type"] == "pq_accelerated" and stats["expand_width"] == E
    want = angular_l2sq(raw, raw_q, ids)
    assert np.abs(dists**2 - want).max() <= DIST_TOL
    gt, _ = cosine_topk(raw, raw_q, K)
    assert recall_at_k(ids, gt, K) >= 0.9

    qt = torch.from_numpy(q)
    g = eng.guide
    index = eng.index
    res = beam_search_pq(g.codes, g.pq.inner_tables(qt), index.adjacency, index.medoid,
                         search_width=L, k=L, rerank=False, expand_width=E,
                         entry_points=index.entry_points, point_cell=g.cells, point_bias=g.bias,
                         cell_tables=g.pq.cell_tables(qt))
    f32 = exact_rerank(eng.index.vectors, qt, res, K)
    assert np.array_equal(f32.ids.numpy(), ids)
    bf16 = exact_rerank(eng.index.vectors.to(torch.bfloat16), qt, res, K)
    err = np.abs(bf16.dists.numpy() - angular_l2sq(raw, raw_q, bf16.ids.numpy())).max()
    assert err > DIST_TOL


def test_adc_distances_at_m50_are_the_decoded_residual_pq_distances(data, built):
    """The traversal's per-candidate ADC distances (the plain version of
    B5 by id, with the cell term and bias): the beam's and the visited
    log's, against ||q - c - e||^2 by decoding, within 1e-4 relative and
    2e-6 absolute: float32 sums of 50 table entries, a cell term and a
    bias, whose magnitudes (q.q ~ 1, -2 q.c ~ -2, c.c + 2 c.e ~ 1) round
    at ~1e-7 each, however small the distance they cancel down to."""
    q = data[3]
    rpq = built["rpq"]
    assert rpq.pq.rotation is None and rpq.n_subvectors == M and rpq.n_coarse == CELLS
    qt = torch.from_numpy(q)
    index = built["index"]
    res = beam_search_pq(
        built["codes"], rpq.inner_tables(qt), index.adjacency, index.medoid,
        search_width=L, k=L, rerank=False, expand_width=E, entry_points=index.entry_points,
        point_cell=built["cells"], point_bias=rpq.point_bias(built["codes"], built["cells"]),
        cell_tables=rpq.cell_tables(qt))
    ids = torch.cat([res.ids, res.visited_ids], 1).numpy()
    got = torch.cat([res.dists, res.visited_dists], 1).numpy()
    valid = ids >= 0
    assert valid.sum() > B * L
    arrays = rpq.to_arrays()
    want = residual_pq_l2sq(q, np.where(valid, ids, 0),
                            coarse_centroids=arrays["coarse_centroids"],
                            codebooks=arrays["codebooks"], codes=built["codes"].numpy(),
                            coarse_ids=built["cells"].numpy())
    np.testing.assert_allclose(got[valid], want[valid], rtol=1e-4, atol=2e-6)


@pytest.mark.cuda
def test_b5_by_id_at_m50_matches_its_plain_version_on_card(built, data):
    """Run with `pytest -m cuda` on a machine with a card: B5 by id with
    the residual operands at m = 50 (the byte-load path), on one round's
    candidates of the angular index, bit-identical to its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the B5 kernel is compiled and run only on one")
    dev = torch.device("cuda", 0)
    rpq, index = built["rpq"], built["index"]
    q = torch.from_numpy(data[3])
    tables = rpq.inner_tables(q).contiguous().to(dev)
    aux = {"point_cell": built["cells"].to(torch.int32).to(dev),
           "point_bias": rpq.point_bias(built["codes"], built["cells"]).to(dev),
           "cell_tables": rpq.cell_tables(q).to(dev)}
    code_table = built["codes"].to(dev)
    rows = torch.randint(0, N, (B, E), generator=torch.Generator().manual_seed(5))
    ids = index.adjacency[rows].reshape(B, E * R).clamp_min(0).long().to(dev)
    pq_scan.reset_launch_counts()
    for a in ({}, aux):
        got = pq_scan.adc_lookup_ids_kernel(tables, code_table, ids, **a)
        want = pq_scan.adc_lookup_ids_ref(tables, code_table, ids, **a)
        torch.cuda.synchronize()
        assert torch.equal(got, want), bool(a)
    assert pq_scan.adc_lookup_gathered_kernel.launches == 2


@pytest.mark.parametrize("kind", ["rpq", "iq"])
def test_engine_serves_the_expand_width_of_the_index(data, built, kind):
    q = data[3]
    _, ids1, st1 = _engine(built, kind).search_batch(q, k=K, l_search=L)
    _, ids4, st4 = _engine(built, f"{kind}_e4").search_batch(q, k=K, l_search=L)
    assert (st1["expand_width"], st4["expand_width"]) == (1, E)
    assert st1["search_type"] == st4["search_type"] == f"{kind}_accelerated".replace("rpq", "pq")
    assert 0 < st4["rounds"] < st1["rounds"]


@pytest.mark.parametrize("kind", ["rpq", "iq"])
def test_an_index_without_an_expand_width_is_served_as_before(data, built, kind):
    """Without the meta key the engine expands one candidate a round:
    the ids of the traversal called as the engine called it before it
    read the key, with no expand width."""
    q = torch.from_numpy(data[3])
    eng = _engine(built, kind)
    dists, ids, stats = eng.search_batch(q.numpy(), k=K, l_search=L)
    index = eng.index
    common = dict(search_width=L, k=K, rerank=True, vectors=index.vectors, queries=q,
                  metric=index.metric, entry_points=index.entry_points)
    g, pq = eng.guide, eng.guide.pq
    if kind == "rpq":
        res = beam_search_pq(g.codes, pq.inner_tables(q), index.adjacency, index.medoid,
                             **common, point_cell=g.cells, point_bias=g.bias,
                             cell_tables=pq.cell_tables(q))
    else:
        res = beam_search_iq(g.codes, pq.query_tables(q), index.adjacency, index.medoid,
                             dim=pq.dim, bits=pq.bits, n_cells=pq.n_cells, **common)
    assert stats["expand_width"] == 1
    assert np.array_equal(ids, res.ids.numpy())
    assert stats["rounds"] == int(res.n_steps)
    want = np.sqrt(np.maximum(res.dists.numpy().astype(np.float64), 0.0))
    np.testing.assert_array_equal(dists, want)


def test_pq_guided_search_spans_and_counters(data, built):
    """A request records one `engine.pq_tables` (m, cells) and one
    `graph.rerank` (pool); B5 is called once a round executed, on B x E
    x R candidates a call; the rerank pool is B x (L + the visited log);
    the answers are those of an untraced request."""
    q = data[3]
    eng = _engine(built, "rpq_e4")
    lut = {f"q{i}": q[i] for i in range(B)}
    batches = [list(lut)[:B], list(lut)[: B // 2], list(lut)[B // 2 :]]
    off = [eng.search_many(t, k=K, embedding_fn=lut.__getitem__, l_search=L)["results"]
           for t in batches]
    profiling.drain()
    profiling.counters(reset=True)
    try:
        with profiling.tracing():
            on = [eng.search_many(t, k=K, embedding_fn=lut.__getitem__, l_search=L)
                  for t in batches]
        records, counters = profiling.drain(), profiling.counters(reset=True)
    finally:
        profiling.disable()
    assert [o["results"] for o in on] == off
    by_request: dict = {}
    for r in records:
        by_request.setdefault(r.request, []).append(r)
    assert len(by_request) == len(batches)
    pools = 0
    for recs, texts in zip(by_request.values(), batches):
        names = [r.name for r in recs]
        assert names.count("engine.pq_tables") == names.count("graph.rerank") == 1
        tables = next(r for r in recs if r.name == "engine.pq_tables")
        assert tables.attrs == {"m": M, "cells": CELLS}
        rerank = next(r for r in recs if r.name == "graph.rerank")
        assert rerank.attrs == {"pool": L + E * (-(-2 * L // E))}
        pools += len(texts) * rerank.attrs["pool"]
    rounds = sum(o["stats"]["rounds"] for o in on)
    assert counters["graph.rounds"] == counters["pq.adc_launches"] == rounds > 0
    per_round = [len(t) * E * R for t in batches]
    assert counters["pq.adc_ids"] == sum(
        o["stats"]["rounds"] * c for o, c in zip(on, per_round))
    assert counters["graph.rerank_pool"] == pools
