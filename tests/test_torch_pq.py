"""The port's PQ tier (k-means, ProductQuantizer, ResidualPQ, adaptive
parameters) held against the JAX package. Codebooks are trained once by
the JAX package and carried across (`convert.pq_from_jax`), so every
deterministic stage runs on the same model in both; training itself draws
other random numbers in the port and is held to quality."""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # the suite runs several workers: do not let each spin a thread per core

import jax
import jax.numpy as jnp

from diskrag_tpu.pq import ProductQuantizer as JaxPQ, ResidualPQ as JaxRPQ
from diskrag_tpu.pq import kmeans as jkm
from diskrag_tpu.pq.adaptive import calculate_adaptive_pq_params as jax_adaptive
from diskrag_tpu.pq.product_quantizer import adc_lookup as jax_adc_lookup
from diskrag_tpu.pq.residual import pq_from_arrays as jax_pq_from_arrays
from diskrag_tpu.pq.residual import rpq_lookup_gathered as jax_rpq_gathered
from diskrag_tpu_torch.convert import pq_from_jax
from diskrag_tpu_torch.pq import ProductQuantizer, ResidualPQ, pq_from_arrays
from diskrag_tpu_torch.pq import kmeans as tkm
from diskrag_tpu_torch.pq.adaptive import calculate_adaptive_pq_params
from diskrag_tpu_torch.pq.product_quantizer import adc_lookup
from diskrag_tpu_torch.pq.residual import RPQTables, rpq_lookup_gathered

N, D, M = 1500, 32, 8


def _clustered(n, d, seed, n_clusters=12):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32) * 4.0
    pts = centers[rng.integers(0, n_clusters, size=n)] + rng.normal(size=(n, d)).astype(np.float32)
    return pts.astype(np.float32)


def _close(got, want, rtol):
    """rtol against the array's scale: sums and L2 expansions are taken in
    another order by XLA and PyTorch, so entries near zero agree to the
    rounding of the terms they cancel from, not of themselves."""
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def data():
    pts = _clustered(N, D, seed=0)
    rng = np.random.default_rng(1)
    q = pts[rng.integers(0, N, size=20)] + rng.normal(size=(20, D)).astype(np.float32) * 0.3
    return pts, q.astype(np.float32)


@pytest.fixture(scope="module")
def jax_pq(data):
    return JaxPQ(n_subvectors=M).fit(data[0], seed=0, max_iter=6)


@pytest.fixture(scope="module")
def jax_rpq(data):
    return JaxRPQ(n_subvectors=M, n_coarse=24).fit(data[0], seed=0, max_iter=6, coarse_iters=6)


def test_plain_pq_on_carried_codebooks(data, jax_pq):
    pts, q = data
    pq, _, _, _ = pq_from_jax(jax_pq.to_arrays(), device="cpu")
    jcodes = np.asarray(jax_pq.encode(pts))
    tcodes = pq.encode(pts)
    assert tcodes.dtype == torch.uint8 and tcodes.shape == (N, M)
    # an argmin flips only where the two nearest centroids are within
    # rounding of each other
    assert (tcodes.numpy() == jcodes).mean() >= 0.999
    assert np.array_equal(pq.decode(jcodes).numpy(), np.asarray(jax_pq.decode(jcodes)))
    jt = jax_pq.compute_distance_tables(q)
    tt = pq.compute_distance_tables(q)
    _close(tt, jt, 1e-5)
    _close(adc_lookup(tt, torch.from_numpy(jcodes)), jax_adc_lookup(jt, jnp.asarray(jcodes)), 1e-5)
    _close(pq.asymmetric_distance_sq(tt, jcodes), jax_pq.asymmetric_distance_sq(jt, jnp.asarray(jcodes)), 1e-5)
    _close(pq.symmetric_distance_tables(), jax_pq.symmetric_distance_tables(), 1e-5)
    _close(pq.symmetric_distance_sq(jcodes[:7], jcodes[7:30]),
           jax_pq.symmetric_distance_sq(jcodes[:7], jcodes[7:30]), 1e-5)
    assert pq.estimate_selectivity(N) == jax_pq.estimate_selectivity(N)
    assert abs(pq.reconstruction_error(pts) - jax_pq.reconstruction_error(pts)) <= 1e-3 * jax_pq.reconstruction_error(pts)


def test_residual_pq_on_carried_codebooks(data, jax_rpq):
    pts, q = data
    jcodes, jcid = (np.asarray(a) for a in jax_rpq.encode(pts))
    jbias = np.asarray(jax_rpq.point_bias(jcodes, jcid))
    rpq, codes_t, cells_t, bias_t = pq_from_jax(
        jax_rpq.to_arrays(), jcodes, jcid, jbias, device="cpu")
    assert isinstance(rpq, ResidualPQ) and rpq.n_coarse == jax_rpq.n_coarse
    assert codes_t.dtype == torch.uint8 and cells_t.dtype == torch.int32
    assert (rpq.coarse_assign(pts).numpy() == jcid).mean() >= 0.999
    tcodes, tcid = rpq.encode(pts)
    same_cell = tcid.numpy() == jcid
    assert same_cell.mean() >= 0.999
    assert (tcodes.numpy()[same_cell] == jcodes[same_cell]).mean() >= 0.999
    assert np.array_equal(rpq.decode(jcodes, jcid).numpy(), np.asarray(jax_rpq.decode(jcodes, jcid)))
    _close(rpq.inner_tables(q), jax_rpq.inner_tables(q), 1e-5)
    _close(rpq.cell_tables(q), jax_rpq.cell_tables(q), 1e-5)
    _close(rpq.point_bias(jcodes, jcid), jbias, 1e-5)
    _close(rpq.point_bias(jcodes, jcid, chunk=400), jbias, 1e-5)
    _close(rpq.t2_flat, jax_rpq.t2_flat, 1e-5)
    jt = jax_rpq.compute_query_tables(q)
    tt = rpq.compute_query_tables(q)
    assert isinstance(tt, RPQTables)
    _close(tt.t1, jt.t1, 1e-5)
    _close(tt.term0, jt.term0, 1e-5)
    full_j = np.asarray(jax_rpq.asymmetric_distance_sq(jt, jnp.asarray(jcodes), jcid))
    full_t = rpq.asymmetric_distance_sq(tt, jcodes, jcid)
    _close(full_t, full_j, 1e-5)
    pick = np.random.default_rng(2).integers(0, N, size=(20, 9))
    _close(
        rpq_lookup_gathered(tt, rpq.t2_flat, codes_t[pick], cells_t[torch.from_numpy(pick)]),
        jax_rpq_gathered(jt, jax_rpq.t2_flat, jnp.asarray(jcodes[pick]), jnp.asarray(jcid[pick])),
        1e-5,
    )
    # the serving decomposition (inner tables + cell term + point bias)
    # equals the three-term ADC up to the order of its sums: rtol 1e-4
    serving = (adc_lookup(rpq.inner_tables(q), codes_t)
               + rpq.cell_tables(q)[:, cells_t.long()] + bias_t[None, :])
    _close(serving, full_j, 1e-4)
    assert rpq.estimate_selectivity(N) == jax_rpq.estimate_selectivity(N)


@pytest.mark.parametrize("init", ["kmeans++", "d2"])
def test_kmeans_same_initial_centres_same_result(init):
    rng = np.random.default_rng(4)
    data = np.stack([_clustered(700, 6, seed=s, n_clusters=9) for s in (1, 2, 3)])
    k = 16
    key = jax.random.key(7)
    init_fn = jkm._kmeanspp_init if init == "kmeans++" else jkm._d2_init
    centres0 = np.asarray(init_fn(key, jnp.asarray(data), k))
    # chunk 256 leaves a ragged last tile of 188 rows on both sides
    jc, ja = jkm.kmeans_fit(key, jnp.asarray(data), k, max_iter=7, chunk=256, init=init)
    tc, ta = tkm.kmeans_fit(None, torch.from_numpy(data), k, max_iter=7, chunk=256,
                            init_centers=torch.from_numpy(centres0))
    assert ta.dtype == torch.int32 and ta.shape == (3, 700)
    assert (ta.numpy() == np.asarray(ja)).mean() >= 0.999
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-4)
    del rng


def test_kmeans_empty_clusters_keep_their_centroid():
    data = torch.zeros((1, 40, 2))
    data[0, 20:] = 1.0
    far = torch.tensor([[[0.0, 0.0], [1.0, 1.0], [50.0, 50.0]]])
    centers, assign = tkm.kmeans_fit(None, data, 3, max_iter=3, init_centers=far)
    assert torch.equal(centers[0, 2], far[0, 2])  # never assigned, never moved
    assert set(assign[0].tolist()) == {0, 1}


@pytest.mark.parametrize("init", ["kmeans++", "d2"])
def test_kmeans_seeding_draws_from_the_generator(init):
    data = torch.from_numpy(np.stack([_clustered(600, 5, seed=9, n_clusters=8)]))
    runs = [
        tkm.kmeans_fit(tkm.make_generator(s, "cpu"), data, 8, max_iter=10, init=init)[0]
        for s in (0, 0, 1)
    ]
    assert torch.equal(runs[0], runs[1])        # one seed, one result
    assert not torch.equal(runs[0], runs[2])    # another seed, other draws
    # every centre is a mean of data: inside the data's bounding box
    assert bool((runs[0] >= data.amin(1, keepdim=True) - 1e-4).all())
    assert bool((runs[0] <= data.amax(1, keepdim=True) + 1e-4).all())
    first = tkm._kmeanspp_init if init == "kmeans++" else tkm._d2_init
    seeds = first(tkm.make_generator(3, "cpu"), data, 8)
    flat = data[0].tolist()
    assert all(row in flat for row in seeds[0].tolist())  # seeds are data points
    assert len({tuple(r) for r in seeds[0].tolist()}) == 8


def test_port_trained_quantizers_reach_the_reference_quality(data, jax_pq, jax_rpq):
    pts, _ = data
    pq = ProductQuantizer(n_subvectors=M, device="cpu").fit(pts, seed=0, max_iter=6)
    assert pq.codebooks.shape == (M, 256, D // M) and pq.rotation is None
    assert pq.reconstruction_error(pts) <= 1.05 * jax_pq.reconstruction_error(pts)
    rpq = ResidualPQ(n_subvectors=M, n_coarse=24, device="cpu").fit(
        pts, seed=0, max_iter=6, coarse_iters=6)
    assert rpq.coarse_centroids.shape == (24, D)
    assert rpq.reconstruction_error(pts) <= 1.05 * jax_rpq.reconstruction_error(pts)
    # the training subsample: codebooks from half the points still serve all
    sub = ProductQuantizer(n_subvectors=M, device="cpu").fit(
        pts, seed=0, max_iter=6, max_train_points=750)
    assert sub.reconstruction_error(pts) <= 1.4 * jax_pq.reconstruction_error(pts)
    with pytest.raises(ValueError, match="divisible"):
        ProductQuantizer(n_subvectors=5, device="cpu").fit(pts)
    with pytest.raises(ValueError, match="256"):
        ProductQuantizer(n_subvectors=M, device="cpu").fit(pts[:100])
    with pytest.raises(RuntimeError, match="not fitted"):
        ProductQuantizer(n_subvectors=M, device="cpu").encode(pts)


def test_opq_rotation_is_orthogonal_and_round_trips(data):
    pts, q = data
    pq = ProductQuantizer(n_subvectors=M, device="cpu").fit(pts, seed=0, max_iter=4, opq_iters=2)
    rot = pq.rotation
    assert rot is not None and rot.shape == (D, D)
    np.testing.assert_allclose((rot @ rot.T).numpy(), np.eye(D), atol=1e-4)
    # one OPQ iteration never rotates: no identity is stored
    assert ProductQuantizer(n_subvectors=M, device="cpu").fit(
        pts, seed=0, max_iter=2, opq_iters=1).rotation is None
    # the JAX package reads the rotated model and computes the same on it
    jpq = jax_pq_from_arrays(pq.to_arrays())
    jcodes = np.asarray(jpq.encode(pts))
    assert (pq.encode(pts).numpy() == jcodes).mean() >= 0.999
    _close(pq.decode(jcodes), jpq.decode(jcodes), 1e-5)
    _close(pq.compute_distance_tables(q), jpq.compute_distance_tables(q), 1e-5)


def test_to_arrays_round_trips_through_the_other_package(data, jax_pq, jax_rpq):
    pts, _ = data
    for jmodel in (jax_pq, jax_rpq):
        arrays = jmodel.to_arrays()
        tmodel = pq_from_arrays(arrays, device="cpu")           # JAX -> port
        back = tmodel.to_arrays()
        assert sorted(back) == sorted(arrays)
        for key in arrays:
            assert np.array_equal(np.asarray(back[key]), np.asarray(arrays[key])), key
            assert np.asarray(back[key]).dtype == np.asarray(arrays[key]).dtype, key
        again = jax_pq_from_arrays(back)                        # port -> JAX
        assert type(again) is type(jmodel)
        assert np.array_equal(np.asarray(again.pq.codebooks if hasattr(again, "pq") else again.codebooks),
                              np.asarray(jmodel.pq.codebooks if hasattr(jmodel, "pq") else jmodel.codebooks))
    with pytest.raises(ValueError, match="codebook shape"):
        ProductQuantizer.from_arrays(
            {"codebooks": np.zeros((3, 256, 4), np.float32), "n_subvectors": np.asarray(4)},
            device="cpu")


def test_adaptive_pq_params_equal_over_a_grid():
    for n in (500, 1000, 9_999, 50_000, 50_001, 200_000, 500_001, 2_000_000, 5_000_000):
        for dim in (50, 64, 127, 128, 384, 768, 1536):
            for target in ("balanced", "high_accuracy", "space_saving"):
                assert dataclasses.asdict(calculate_adaptive_pq_params(n, dim, target)) == \
                    dataclasses.asdict(jax_adaptive(n, dim, target))
    assert calculate_adaptive_pq_params(200_000, 128).n_subvectors == 16
