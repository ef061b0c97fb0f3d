"""The port's gathered ADC lookup (B5) held against the JAX package on the
same inputs, made by numpy from a seed. The JAX side runs its Pallas
kernel in interpret mode; the port's side runs the plain PyTorch version
(the tensors lie on the CPU). Both add the m table entries of a
candidate in subspace order, one f32 rounding per add, so on finite
tables they agree bit for bit. A last test, marked `cuda`, holds the CUDA
kernel against the plain version on a card."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # the suite runs several workers: do not let each spin a thread per core

import jax.numpy as jnp

from diskrag_tpu.ops.pq_scan import adc_lookup_gathered_pallas
from diskrag_tpu.pq.product_quantizer import adc_lookup_gathered as jax_gathered
from diskrag_tpu_torch.ops import pq_scan
from diskrag_tpu_torch.pq.product_quantizer import adc_lookup_gathered as torch_gathered


def _inputs(b, m, c, seed):
    rng = np.random.default_rng(seed)
    tables = (rng.normal(size=(b, m, 256)) * 3.0).astype(np.float32)
    codes = rng.integers(0, 256, size=(b, c, m)).astype(np.uint8)
    return tables, codes


@pytest.mark.parametrize(
    "b,m,c", [(5, 8, 37), (1, 8, 37), (5, 8, 1), (3, 32, 20), (9, 6, 130), (1, 4, 1)]
)
def test_plain_b5_is_bit_identical_to_the_pallas_kernel(b, m, c):
    tables, codes = _inputs(b, m, c, seed=b * 100 + m + c)
    want = np.asarray(
        adc_lookup_gathered_pallas(jnp.asarray(tables), jnp.asarray(codes), interpret=True)
    )
    got = pq_scan.adc_lookup_gathered_kernel(torch.from_numpy(tables), torch.from_numpy(codes))
    assert got.dtype == torch.float32 and got.shape == (b, c)
    assert np.array_equal(got.numpy(), want)


def test_plain_b5_keeps_subspace_order_where_order_changes_the_sum():
    """Entries of very different size: any other order of the m adds
    rounds differently, and both sides still agree bit for bit."""
    rng = np.random.default_rng(3)
    tables = (rng.normal(size=(4, 16, 256)) * 10.0 ** rng.integers(-6, 7, size=(4, 16, 1))
              ).astype(np.float32)
    codes = rng.integers(0, 256, size=(4, 50, 16)).astype(np.uint8)
    want = np.asarray(
        adc_lookup_gathered_pallas(jnp.asarray(tables), jnp.asarray(codes), interpret=True)
    )
    got = pq_scan.adc_lookup_gathered_ref(torch.from_numpy(tables), torch.from_numpy(codes))
    assert np.array_equal(got.numpy(), want)
    backwards = pq_scan.adc_lookup_gathered_ref(
        torch.from_numpy(tables[:, ::-1].copy()), torch.from_numpy(codes[:, :, ::-1].copy()))
    assert not np.array_equal(backwards.numpy(), want)  # the order does matter here


@pytest.mark.parametrize("b,m,c", [(5, 8, 37), (2, 32, 64)])
def test_plain_b5_matches_the_gather_formulations(b, m, c):
    """Against `adc_lookup_gathered` of both packages, whose sum over m has
    no defined order: rtol 1e-6 of the row's largest |entry| * m."""
    tables, codes = _inputs(b, m, c, seed=11)
    got = pq_scan.adc_lookup_gathered_ref(torch.from_numpy(tables), torch.from_numpy(codes))
    atol = 1e-6 * float(np.abs(tables).max()) * m
    for other in (
        np.asarray(jax_gathered(jnp.asarray(tables), jnp.asarray(codes))),
        torch_gathered(torch.from_numpy(tables), torch.from_numpy(codes)).numpy(),
    ):
        np.testing.assert_allclose(got.numpy(), other, rtol=1e-6, atol=atol)


def test_int_codes_and_launch_count_on_the_cpu():
    tables, codes = _inputs(3, 4, 9, seed=5)
    pq_scan.reset_launch_counts()
    a = pq_scan.adc_lookup_gathered_kernel(torch.from_numpy(tables), torch.from_numpy(codes))
    b = pq_scan.adc_lookup_gathered_ref(
        torch.from_numpy(tables), torch.from_numpy(codes.astype(np.int64)))
    assert torch.equal(a, b)
    assert pq_scan.adc_lookup_gathered_kernel.launches == 0  # no kernel on CPU tensors


@pytest.mark.cuda
def test_b5_kernel_matches_plain_version_on_card():
    """Run with `pytest -m cuda` on a machine with a card: B5's wrapper on
    CUDA tensors (the kernel) against the plain version, bit-identical,
    at ragged and main-path shapes; m = 64 needs the opt-in shared-memory
    limit; a table past a block's shared memory and codes of another type
    are refused."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the B5 kernel is compiled and run only on one")
    dev = torch.device("cuda", 0)
    pq_scan.reset_launch_counts()
    shapes = [(250, 32, 192), (1000, 16, 24), (1, 64, 48), (37, 8, 5), (3, 6, 300), (2, 4, 1)]
    for b, m, c in shapes:
        tables, codes = _inputs(b, m, c, seed=m)
        t, cd = torch.from_numpy(tables).to(dev), torch.from_numpy(codes).to(dev)
        got = pq_scan.adc_lookup_gathered_kernel(t, cd)
        want = pq_scan.adc_lookup_gathered_ref(t, cd)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (b, m, c)
    assert pq_scan.adc_lookup_gathered_kernel.launches == len(shapes)
    with pytest.raises(RuntimeError, match="shared memory"):
        pq_scan.adc_lookup_gathered_kernel(
            torch.zeros((1, 228, 256), device=dev), torch.zeros((1, 2, 228), dtype=torch.uint8, device=dev))
    with pytest.raises(TypeError):
        pq_scan.adc_lookup_gathered_kernel(
            torch.zeros((1, 4, 256), device=dev), torch.zeros((1, 2, 4), dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        pq_scan.adc_lookup_gathered_kernel(
            torch.zeros((1, 4, 256), device=dev),
            torch.zeros((1, 4, 2), dtype=torch.uint8, device=dev).transpose(1, 2))
