"""The plain reference against a NumPy brute force, and the control."""

import numpy as np
import pytest
import torch
from conftest import TINY, TINY_TRAFFIC

from cudabench import harness, reference


def _data(n=2000, d=16, q=50, seed=3):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(20, d)) * 4)[rng.integers(0, 20, n)] + rng.normal(size=(n, d))
    qs = pts[rng.integers(0, n, q)] + 0.3 * rng.normal(size=(q, d))
    return pts.astype(np.float32), qs.astype(np.float32)


def test_exact_topk_equals_numpy_brute_force():
    pts, qs = _data()
    d = np.sqrt(((qs[:, None, :].astype(np.float64) - pts[None].astype(np.float64)) ** 2).sum(-1))
    order = np.lexsort((np.broadcast_to(np.arange(len(pts)), d.shape), d), axis=1)[:, :10]
    ids, dists = reference.exact_topk(torch.as_tensor(pts), torch.as_tensor(qs), 10)
    np.testing.assert_array_equal(ids, order)
    np.testing.assert_allclose(dists, np.take_along_axis(d, order, 1), rtol=1e-12)


def test_pair_distances_and_recall():
    pts, qs = _data()
    qidx = np.array([0, 3, 7])
    ids = np.array([[1, 2, -1], [5, 1999, 2000], [0, 0, 4]])
    got = reference.pair_distances(torch.as_tensor(pts), torch.as_tensor(qs), qidx, ids, block=2)
    for i, q in enumerate(qidx):
        for j, p in enumerate(ids[i]):
            if 0 <= p < len(pts):
                want = np.sqrt(((qs[q].astype(np.float64) - pts[p]) ** 2).sum())
                assert abs(got[i, j] - want) <= 1e-12 * want
            else:
                assert np.isnan(got[i, j])
    truth = np.array([[1, 2, 3], [4, 5, 6]])
    np.testing.assert_allclose(reference.recall(np.array([[3, 2, 9], [-1, -1, 6]]), truth),
                               [2 / 3, 1 / 3])


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.randn(10000) * 1000
    r = reference.round_to_tf32(x)
    rel = ((r - x) / x).abs()
    assert 0 < float(rel.max()) <= 2.0**-11
    assert torch.all((r.view(torch.int32) & 0x1FFF) == 0)


def test_control_is_not_correct():
    """The reference at TF32 in the program's place fails the comparison,
    by its distances."""
    for seed in (11, 12, 13):
        _, line = harness.measure("sift1m-exact-b512", seed, 0.5, False, device="cpu",
                                  overrides=TINY, traffic_overrides=TINY_TRAFFIC, control=True)
        assert line["correct"] is False
        c = line["checks"]["dist_rel_err"]
        assert c["value"] > 3 * c["limit"], c


@pytest.mark.cuda
def test_control_is_not_correct_on_the_card(card):
    """The same with the card's own TF32 products, at a size a test run holds."""
    _, line = harness.measure("sift1m-exact-b512", 5, 2.0, False, device=card,
                              overrides={"n": 200_000, "n_clusters": 200, "query_pool": 2000},
                              traffic_overrides=TINY_TRAFFIC, control=True)
    assert line["correct"] is False
    assert line["checks"]["dist_rel_err"]["value"] > line["checks"]["dist_rel_err"]["limit"]
