"""The port's `diskrag_tpu_torch.ops` package against the JAX package's
`diskrag_tpu.ops`: the same exported names, and `query_point_distance`
equal to the JAX function on the same inputs. On the CPU."""

import numpy as np
import pytest
import torch

import diskrag_tpu.ops as jax_ops
from diskrag_tpu.ops.distance import query_point_distance as jax_query_point_distance

import diskrag_tpu_torch.ops as torch_ops
from diskrag_tpu_torch.ops.distance import query_point_distance


def test_ops_exports_the_jax_packages_names():
    assert torch_ops.__all__ == jax_ops.__all__
    for name in torch_ops.__all__:
        assert callable(getattr(torch_ops, name)), name
    assert torch_ops.query_point_distance is query_point_distance


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_query_point_distance_matches_jax(metric):
    rng = np.random.default_rng(11)
    query = rng.normal(size=(48,)).astype(np.float32)
    points = rng.normal(size=(300, 48)).astype(np.float32) * 3.0
    got = query_point_distance(torch.from_numpy(query), torch.from_numpy(points), metric)
    want = np.asarray(jax_query_point_distance(query, points, metric))
    assert got.shape == (300,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    # the same as one row of the pairwise distances
    row = torch_ops.pairwise_distance(torch.from_numpy(query)[None], torch.from_numpy(points), metric)
    np.testing.assert_array_equal(got.numpy(), row[0].numpy())
