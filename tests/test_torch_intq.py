"""The port's int quantizer (`diskrag_tpu_torch/pq/intq.py`) and
`beam_search_iq` against the JAX package's, on the CPU, on the cases of
`tests/test_intq.py`.

Carried state (`convert.iq_from_jax`) must encode the same rows: the z
and cell-id lanes bit for bit, the bias lanes within one 16-bit step (the
squared norm they quantize is an f32 sum taken in another order). A
port-fit quantizer is held bit for bit where `fit` is deterministic (no
cells, at most 262,144 points) and to quality where it draws from a
generator (the cells' k-means). Scores agree within rtol 1e-5; the
traversal on carried rows, graph and tables returns the JAX package's
ids, the same nodes expanded in each round and the same round count."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)  # the suite runs several workers: do not let each spin a thread per core

from diskrag_tpu.graph import beam_search_iq as jax_beam_search_iq
from diskrag_tpu.graph.knn_build import build_vamana_knn as jax_build_vamana_knn
from diskrag_tpu.pq.intq import (
    IntQuantizer as JaxIQ,
    _unpack_rows as jax_unpack_rows,
    iq_score_gathered as jax_score_gathered,
    iq_score_shared as jax_score_shared,
)

from diskrag_tpu_torch.convert import iq_from_jax, vamana_index_from_jax
from diskrag_tpu_torch.graph import beam_search_iq
from diskrag_tpu_torch.pq import IntQuantizer, IQTables, default_iq_cells, pq_from_arrays
from diskrag_tpu_torch.pq.intq import (
    _unpack_rows,
    iq_score_gathered,
    iq_score_shared,
    pad_rows_for_gather,
)

KINDS = [(8, 0), (4, 64), (8, 64), (4, 0)]


def _data(n=4096, dim=32, nq=16, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(16, dim)).astype(np.float32) * 4.0
    pts = centers[rng.integers(0, 16, size=n)] + rng.normal(size=(n, dim)).astype(np.float32)
    q = pts[rng.integers(0, n, size=nq)] + 0.3 * rng.normal(size=(nq, dim)).astype(np.float32)
    return pts, q


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module")
def fitted(data):
    """{(bits, n_cells): (JAX quantizer, the port's carrying its state)}"""
    pts = data[0]
    out = {}
    for bits, cells in KINDS:
        jq = JaxIQ(bits=bits, n_cells=cells).fit(pts, seed=0)
        out[bits, cells] = jq, iq_from_jax(jq, device="cpu")
    return out


def _bias_units(rows: np.ndarray) -> np.ndarray:
    hi = rows[:, -2].astype(np.int32) + 128
    lo = rows[:, -1].astype(np.int32) + 128
    return hi * 256 + lo


@pytest.mark.parametrize("bits,n_cells", KINDS)
def test_encode_on_carried_state_matches_jax(bits, n_cells, data, fitted):
    pts = data[0]
    jq, tq = fitted[bits, n_cells]
    want = np.asarray(jq.encode(pts))
    got = tq.encode(pts)
    assert got.dtype == np.int8 and got.shape == want.shape == (len(pts), tq.row_width)
    assert tq.row_width == jq.row_width
    # z lanes and cell-id lanes bit for bit
    np.testing.assert_array_equal(got[:, :-2], want[:, :-2])
    # bias lanes: one 16-bit step at most (an f32 sum in another order)
    moved = np.abs(_bias_units(got) - _bias_units(want))
    assert moved.max() <= 1, f"bias lanes moved by up to {moved.max()}"
    assert np.count_nonzero(moved) <= len(pts) // 100, f"{np.count_nonzero(moved)} bias lanes moved"
    # the dequantized points agree
    np.testing.assert_allclose(tq.decode(got).numpy(), np.asarray(jq.decode(want)), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("bits", [8, 4])
def test_fit_without_cells_matches_jax_bit_for_bit(bits, data):
    pts = data[0]
    jq = JaxIQ(bits=bits, n_cells=0).fit(pts, seed=0)
    tq = IntQuantizer(bits=bits, n_cells=0, device="cpu").fit(pts, seed=0)
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    assert tq.bias_lo == pytest.approx(jq.bias_lo, rel=1e-6)
    assert tq.bias_scale == pytest.approx(jq.bias_scale, rel=1e-6)


@pytest.mark.parametrize("bits,n_cells", [(4, 64), (8, 64)])
def test_fit_with_cells_holds_the_jax_quality(bits, n_cells, data, fitted):
    """The cells' k-means draws from a torch.Generator: held to quality,
    reconstruction error within 5% of the JAX package's."""
    pts = data[0]
    jq = fitted[bits, n_cells][0]
    tq = IntQuantizer(bits=bits, n_cells=n_cells, device="cpu").fit(pts, seed=0)
    assert tq.n_cells == jq.n_cells
    assert tq.reconstruction_error(pts) <= 1.05 * jq.reconstruction_error(pts)


def test_pack_unpack_int4_exact():
    """Nibble packing round-trips every value in [-8, 7], as the JAX
    unpacker reads it."""
    pts, _ = _data(n=512, dim=16)
    iq = IntQuantizer(bits=4, n_cells=0, device="cpu").fit(pts, seed=0)
    rows = iq.encode(pts)
    z = np.clip(np.round(pts / iq.scales.numpy()), -8, 7)
    got, cid, _ = _unpack_rows(torch.as_tensor(rows), iq.dim, 4, 0)
    assert cid is None
    np.testing.assert_array_equal(got.numpy(), z)
    want, _, _ = jax_unpack_rows(jnp.asarray(rows), iq.dim, 4, 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _carried_tables(jq, q) -> IQTables:
    t = jq.query_tables(q)
    return IQTables(
        qw=torch.as_tensor(np.asarray(t.qw)), qn=torch.as_tensor(np.asarray(t.qn)),
        cell_t=None if t.cell_t is None else torch.as_tensor(np.asarray(t.cell_t)),
        bias_lo=torch.as_tensor(np.asarray(t.bias_lo)),
        bias_scale=torch.as_tensor(np.asarray(t.bias_scale)),
    )


@pytest.mark.parametrize("bits,n_cells", KINDS)
def test_scores_match_jax(bits, n_cells, data, fitted):
    pts, q = data
    jq, tq = fitted[bits, n_cells]
    rows = np.asarray(jq.encode(pts))
    geo = dict(dim=tq.dim, bits=bits, n_cells=tq.n_cells)
    jt = jq.query_tables(q)
    tt = tq.query_tables(q)
    np.testing.assert_allclose(tt.qw.numpy(), np.asarray(jt.qw), rtol=1e-6)
    if n_cells:
        np.testing.assert_allclose(tt.cell_t.numpy(), np.asarray(jt.cell_t), rtol=1e-5, atol=1e-3)
    want = np.asarray(jax_score_shared(jt, jnp.asarray(rows), **geo))
    got = iq_score_shared(tt, torch.as_tensor(rows), **geo).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    ids = np.random.default_rng(1).integers(0, len(pts), size=(len(q), 37))
    # the port gathers the cell term; the JAX package's one-hot reduce in
    # its place gives the same values
    got = iq_score_gathered(tt, torch.as_tensor(rows[ids]), **geo)
    for onehot in (True, False):
        want = np.asarray(jax_score_gathered(jt, jnp.asarray(rows)[jnp.asarray(ids)],
                                             onehot_cells=onehot, **geo))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)
    # the dense oracle path of the quantizer itself
    np.testing.assert_allclose(
        tq.asymmetric_distance_sq(tt, rows).numpy(),
        np.asarray(jq.asymmetric_distance_sq(jt, rows)), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("bits,n_cells", [(8, 0), (4, 64)])
def test_to_arrays_round_trip_both_ways(bits, n_cells, data, fitted, tmp_path):
    pts = data[0]
    jq, _ = fitted[bits, n_cells]
    # JAX -> port through a persisted npz, as an index directory holds it
    np.savez(tmp_path / "jax.npz", **jq.to_arrays())
    tq = pq_from_arrays(dict(np.load(tmp_path / "jax.npz")), device="cpu")
    assert isinstance(tq, IntQuantizer) and (tq.bits, tq.n_cells) == (bits, jq.n_cells)
    # port -> JAX
    np.savez(tmp_path / "torch.npz", **tq.to_arrays())
    back = JaxIQ.from_arrays(dict(np.load(tmp_path / "torch.npz")))
    for k, v in jq.to_arrays().items():
        np.testing.assert_array_equal(np.load(tmp_path / "torch.npz")[k], v)
    assert back.bias_scale == jq.bias_scale and back.bias_lo == jq.bias_lo
    np.testing.assert_array_equal(np.asarray(back.encode(pts[:200])), np.asarray(jq.encode(pts[:200])))
    assert tq.estimate_selectivity(1000) == jq.estimate_selectivity(1000)


def test_default_iq_cells_matches_jax():
    from diskrag_tpu.pq import default_iq_cells as jax_default

    for n in (100, 2_000, 200_000, 10_000_000):
        for bits in (4, 8):
            assert default_iq_cells(n, bits) == jax_default(n, bits)


@pytest.fixture(scope="module")
def graph():
    pts, q = _data(n=4096, dim=32, nq=32, seed=3)
    jidx = jax_build_vamana_knn(pts, degree_bound=24, alpha=1.2, seed=0)
    tidx = vamana_index_from_jax(
        np.asarray(jidx.vectors), np.asarray(jidx.adjacency), int(jidx.medoid),
        entry_points=np.asarray(jidx.entry_points), device="cpu")
    d = (q ** 2).sum(1)[:, None] - 2.0 * q @ pts.T + (pts ** 2).sum(1)[None, :]
    return pts, q, jidx, tidx, np.argsort(d, axis=1)[:, :10]


@pytest.mark.parametrize("bits,n_cells", [(8, 0), (4, 64)])
@pytest.mark.parametrize("rerank", [False, True])
def test_beam_search_iq_on_carried_state_matches_jax(bits, n_cells, rerank, graph):
    pts, q, jidx, tidx, _ = graph
    jq = JaxIQ(bits=bits, n_cells=n_cells).fit(pts, seed=0)
    rows = np.asarray(jq.encode(pts))
    kw = dict(dim=jq.dim, bits=bits, n_cells=jq.n_cells, search_width=32, k=10,
              rerank=rerank, expand_width=4)
    want = jax_beam_search_iq(
        jnp.asarray(rows), jq.query_tables(q), jidx.adjacency, jidx.medoid,
        vectors=jidx.vectors, queries=jnp.asarray(q), entry_points=jidx.entry_points, **kw)
    got = beam_search_iq(
        torch.as_tensor(rows), _carried_tables(jq, q), tidx.adjacency, tidx.medoid,
        vectors=tidx.vectors, queries=torch.as_tensor(q), entry_points=tidx.entry_points, **kw)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    # the visited log round by round: the E nodes a round expands are one
    # set (expanded together); their order inside the round follows the
    # approximate score, whose last bits move with the order of an f32 sum
    # (XLA's own fused loop and a standalone call of its scorer differ by
    # 2e-6 relative on this data, enough to swap a near-tie)
    def rounds(v):
        return np.sort(np.asarray(v).reshape(len(q), -1, 4), axis=-1)

    np.testing.assert_array_equal(rounds(got.visited_ids.numpy()), rounds(want.visited_ids))
    assert int(got.n_steps) == int(want.n_steps)
    np.testing.assert_array_equal(got.n_expanded.numpy(), np.asarray(want.n_expanded))
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("bits,n_cells", [(8, 0), (4, 64)])
def test_port_fit_traversal_recall_within_001_of_jax(bits, n_cells, graph):
    """A quantizer the port fits itself is held to quality: traversal +
    rerank recall within 0.01 of the JAX-fit one's, and >= 0.9 as in the
    JAX test."""
    pts, q, jidx, tidx, gt = graph
    jq = JaxIQ(bits=bits, n_cells=n_cells).fit(pts, seed=0)
    tq = IntQuantizer(bits=bits, n_cells=n_cells, device="cpu").fit(pts, seed=0)
    kw = dict(search_width=32, k=10, rerank=True, expand_width=4)
    want = jax_beam_search_iq(
        jnp.asarray(jq.encode(pts)), jq.query_tables(q), jidx.adjacency, jidx.medoid,
        dim=jq.dim, bits=bits, n_cells=jq.n_cells, vectors=jidx.vectors,
        queries=jnp.asarray(q), entry_points=jidx.entry_points, **kw)
    got = beam_search_iq(
        torch.as_tensor(tq.encode(pts)), tq.query_tables(q), tidx.adjacency, tidx.medoid,
        dim=tq.dim, bits=bits, n_cells=tq.n_cells, vectors=tidx.vectors,
        queries=torch.as_tensor(q), entry_points=tidx.entry_points, **kw)

    def recall(ids):
        return np.mean([len(set(ids[i]) & set(gt[i])) / 10 for i in range(len(q))])

    r_t, r_j = recall(got.ids.numpy()), recall(np.asarray(want.ids))
    assert r_t >= 0.9 and r_t >= r_j - 0.01, (r_t, r_j)


@pytest.mark.parametrize("bits,n_cells", [(8, 0), (4, 64)])
def test_gather_pad_scores_identical(bits, n_cells):
    """The 256-byte pad is a layout change only: scores over padded rows
    equal the unpadded ones bit for bit, in both scoring forms."""
    pts, q = _data(n=1024, dim=32, nq=8, seed=5)
    iq = IntQuantizer(bits=bits, n_cells=n_cells, device="cpu").fit(pts, seed=0)
    rows = iq.encode(pts)
    padded = pad_rows_for_gather(rows)
    assert padded.shape[1] == 256 and rows.shape[1] < 256
    assert pad_rows_for_gather(padded) is not None and pad_rows_for_gather(padded).shape[1] == 256
    t = iq.query_tables(q)
    geo = dict(dim=iq.dim, bits=bits, n_cells=iq.n_cells)
    s0 = iq_score_shared(t, torch.as_tensor(rows), **geo)
    s1 = iq_score_shared(t, torch.as_tensor(padded), **geo)
    assert torch.equal(s0, s1)
    ids = np.random.default_rng(2).integers(0, len(pts), size=(len(q), 40))
    g0 = iq_score_gathered(t, torch.as_tensor(rows[ids]), **geo)
    g1 = iq_score_gathered(t, torch.as_tensor(padded[ids]), **geo)
    assert torch.equal(g0, g1)
