"""The port's int8 prune held against the JAX package: the int8 distances
(`gathered_distance_int8`, `_pairwise_within_int8`) bit for bit under L2
and dot (every partial sum of the int8 cross term is an integer below
2^24, so the f32 `bmm` is exact in any order) and within rtol 1e-6 under
cosine (`rsqrt`); `robust_prune_batch` with `cand_scales` to identical ids
on identical int8 inputs. The inputs are the scan's quantized copy of the
seeded `clustered_data` points, made with numpy; a D = 1536 case takes
the column-chunked cross term."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # the suite runs several workers: do not let each spin a thread per core

import jax.numpy as jnp

from diskrag_tpu.graph import prune as jprune
from diskrag_tpu.ops.flat_scan_pallas import quantize_int8 as jax_quantize_int8
from diskrag_tpu_torch.graph import prune as tprune

W, C = 24, 40


def _t(a):
    return torch.from_numpy(np.array(a))


def _codes(x):
    """The JAX package's int8 codes and scales of rows `x` (numpy)."""
    c, s = jax_quantize_int8(jnp.asarray(x))
    return np.asarray(c), np.asarray(s)


def _gathered(points, rng):
    """Per-row gathered candidates of W query rows, with self ids, -1-free."""
    n = len(points)
    q_ids = rng.choice(n, size=W, replace=False)
    cand = rng.integers(0, n, size=(W, C))
    cand[::3, 2] = q_ids[::3]
    codes, scales = _codes(points)
    return codes[q_ids], scales[q_ids], codes[cand], scales[cand], q_ids, cand


def _wide_points(rng, n=300, d=1536):
    centers = rng.normal(size=(6, d)).astype(np.float32) * 4
    return (centers[rng.integers(0, 6, n)] + rng.normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("metric", ["l2", "dot", "cosine"])
@pytest.mark.parametrize("dim", [64, 1536])
def test_int8_distances_match_jax(clustered_data, metric, dim):
    rng = np.random.default_rng(dim)
    points = clustered_data if dim == 64 else _wide_points(rng)
    qc, qs, cc, cs, _, _ = _gathered(points, rng)
    want_g = np.asarray(jprune.gathered_distance_int8(
        jnp.asarray(qc), jnp.asarray(qs), jnp.asarray(cc), jnp.asarray(cs), metric))
    got_g = tprune.gathered_distance_int8(_t(qc), _t(qs), _t(cc), _t(cs), metric).numpy()
    want_p = np.asarray(jprune._pairwise_within_int8(jnp.asarray(cc), jnp.asarray(cs), metric))
    got_p = tprune._pairwise_within_int8(_t(cc), _t(cs), metric).numpy()
    if metric == "cosine":
        # 1 - cos: an ulp of rsqrt; self pairs sit at ~0, where one ulp of
        # 1.0 (1.2e-7) is the absolute floor
        np.testing.assert_allclose(got_g, want_g, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_p, want_p, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got_g, want_g)
        np.testing.assert_array_equal(got_p, want_p)


def test_int8_cross_term_is_exact_past_the_f32_limit():
    """At D = 1536 with every code at +-127 a single f32 sum would pass
    2^24; the chunked cross term stays the exact integer."""
    rng = np.random.default_rng(3)
    codes = np.where(rng.random((2, 5, 1536)) < 0.5, -127, 127).astype(np.int8)
    want = np.einsum("wcd,wed->wce", codes.astype(np.int64), codes.astype(np.int64))
    got = tprune._int8_bmm(_t(codes), _t(codes)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.abs(want).max() > 2**24


@pytest.mark.parametrize("alpha", [1.0, 1.2])
def test_robust_prune_int8_ids_match_jax(clustered_data, alpha):
    rng = np.random.default_rng(7)
    qc, qs, cc, cs, q_ids, cand = _gathered(clustered_data, rng)
    cand = cand.astype(np.int32)
    cand[:, 5] = cand[:, 1]                   # duplicates
    cand[rng.random(cand.shape) < 0.1] = -1  # invalid slots
    dists = np.asarray(jprune.gathered_distance_int8(
        jnp.asarray(qc), jnp.asarray(qs), jnp.asarray(cc), jnp.asarray(cs), "l2"))
    dists = np.where(cand == -1, np.inf, dists).astype(np.float32)
    want = np.asarray(jprune.robust_prune_batch(
        jnp.asarray(q_ids, jnp.int32), jnp.asarray(cand), jnp.asarray(cc), jnp.asarray(dists),
        alpha, degree_bound=16, metric="l2", cand_scales=jnp.asarray(cs)))
    got = tprune.robust_prune_batch(
        _t(q_ids.astype(np.int32)), _t(cand), _t(cc), _t(dists), alpha, degree_bound=16,
        metric="l2", cand_scales=_t(cs)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).sum() > W  # the prune kept real edges
