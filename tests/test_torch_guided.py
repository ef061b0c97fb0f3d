"""The guided traversal (`diskrag_tpu_torch/graph/guided.py`) on the CPU,
over plain PQ, residual PQ and int8 rows whose state is carried across
from the JAX package's quantizers.

A batch's tables taken by rows (`GuideTables.take`, the split the sharded
host tier makes over its data rows) equal the tables of those rows: the
whole batch's, sliced, bit for bit, and the tables built on the rows
alone, by the port and by the JAX package, within f32 rounding. A search
through `Guide.search` is bit-identical to the direct call of
`beam_search_pq` / `beam_search_iq` on the same operands."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # the suite runs several workers: do not let each spin a thread per core

from diskrag_tpu.pq import IntQuantizer as JaxIQ, ProductQuantizer as JaxPQ, ResidualPQ as JaxRPQ
from diskrag_tpu_torch.convert import iq_from_jax, pq_from_jax
from diskrag_tpu_torch.graph.build import random_regular_init
from diskrag_tpu_torch.graph.guided import Guide
from diskrag_tpu_torch.graph.search import beam_search_iq, beam_search_pq


@pytest.fixture(scope="module")
def data(clustered_data):
    pts = clustered_data
    rng = np.random.default_rng(5)
    q = pts[rng.integers(0, len(pts), size=12)] + 0.3 * rng.normal(size=(12, pts.shape[1]))
    adj = random_regular_init(torch.Generator().manual_seed(0), len(pts), 16)
    return pts, q.astype(np.float32), adj


@pytest.fixture(scope="module", params=["pq", "rpq", "iq8"])
def guides(request, data):
    """(kind, the JAX quantizer, the port's guide over its carried state)"""
    pts = data[0]
    kind = request.param
    if kind == "pq":
        jq = JaxPQ(n_subvectors=8).fit(pts, seed=0, max_iter=5)
        tq, codes, _, _ = pq_from_jax(jq.to_arrays(), np.asarray(jq.encode(pts)), device="cpu")
        return kind, jq, Guide(tq, codes)
    if kind == "rpq":
        jq = JaxRPQ(n_subvectors=8, n_coarse=16).fit(pts, seed=0, max_iter=5, coarse_iters=5)
        codes, cid = (np.asarray(a) for a in jq.encode(pts))
        tq, *arrays = pq_from_jax(jq.to_arrays(), codes, cid, np.asarray(jq.point_bias(codes, cid)),
                                  device="cpu")
        return kind, jq, Guide(tq, *arrays)
    jq = JaxIQ(bits=8).fit(pts, seed=0)
    rows = torch.as_tensor(np.asarray(jq.encode(pts)))
    return kind, jq, Guide(iq_from_jax(jq, device="cpu"), rows)


def _fields(t) -> list:
    """The tensors of a `GuideTables` (or of the JAX package's tables), in
    one order: the ADC tables or qw, qn, cell_t, bias_lo, bias_scale, then
    the cell tables."""
    main = t[0]
    if hasattr(main, "qw"):
        main = [main.qw, main.qn, main.cell_t, main.bias_lo, main.bias_scale]
    else:
        main = [main]
    return [x for x in [*main, t[1]] if x is not None]


def _jax_tables(kind, jq, q) -> tuple:
    if kind == "pq":
        return jq.compute_distance_tables(q), None
    if kind == "rpq":
        return jq.inner_tables(q), jq.cell_tables(q)
    return jq.query_tables(q), None


@pytest.mark.parametrize("rows", [slice(0, 5), slice(5, 12)])
def test_tables_taken_by_rows_are_the_tables_of_those_rows(data, guides, rows):
    kind, jq, guide = guides
    q = torch.from_numpy(data[1])
    whole = guide.tables(q)
    taken = whole.take(rows, torch.device("cpu"))
    got = _fields((taken.main, taken.cells))
    # the split by hand: each query's rows, a batch-wide scalar whole
    for g, full in zip(got, _fields((whole.main, whole.cells)), strict=True):
        assert torch.equal(g, full if full.ndim == 0 else full[rows])
    # the tables built on those rows alone, by the port and by the JAX package
    alone = guide.tables(q[rows])
    for g, own, theirs in zip(got, _fields((alone.main, alone.cells)),
                              _fields(_jax_tables(kind, jq, data[1][rows])), strict=True):
        np.testing.assert_allclose(g.numpy(), own.numpy(), rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("rerank", [True, False])
def test_guided_search_is_the_direct_traversal(data, guides, rerank):
    kind, _, guide = guides
    pts, q, adj = data
    qt = torch.from_numpy(q)
    medoid = torch.tensor(0, dtype=torch.int32)
    kw = dict(search_width=24, k=5, rerank=rerank, vectors=torch.from_numpy(pts), queries=qt,
              expand_width=2, entry_points=torch.arange(1, 60, 7, dtype=torch.int32))
    got = guide.search(guide.tables(qt), adj, medoid, **kw)
    pq = guide.pq
    if kind == "iq8":
        want = beam_search_iq(guide.codes, pq.query_tables(qt), adj, medoid, dim=pq.dim,
                              bits=pq.bits, n_cells=pq.n_cells, **kw)
    elif kind == "rpq":
        want = beam_search_pq(guide.codes, pq.inner_tables(qt), adj, medoid,
                              point_cell=guide.cells, point_bias=guide.bias,
                              cell_tables=pq.cell_tables(qt), **kw)
    else:
        want = beam_search_pq(guide.codes, pq.compute_distance_tables(qt), adj, medoid, **kw)
    assert int(got.n_steps) > 1
    for name in ("ids", "dists", "visited_ids", "visited_dists", "n_expanded", "n_steps"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
