"""The port's gathered ADC lookup (B5) held against the JAX package on the
same inputs, made by numpy from a seed. The JAX side runs its Pallas
kernel in interpret mode; the port's side runs the plain PyTorch version
(the tensors lie on the CPU). Both add the m table entries of a
candidate in subspace order, one f32 rounding per add, so on finite
tables they agree bit for bit. The by-id form (codes read from the code
table by candidate id, residual terms added after the lookup) is held
against the JAX package's composition of the same steps in
`beam_search_pq`'s `expand`, and against numpy. The tests marked `cuda`
hold the CUDA kernel against the plain version on a card."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # the suite runs several workers: do not let each spin a thread per core

import jax.numpy as jnp

import jax

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


def _id_inputs(b, m, c, n, n_cells, seed):
    """Tables, a code table, ids (some outside [0, n): the kernel clamps,
    as the JAX package's `expand` does) and residual operands."""
    rng = np.random.default_rng(seed)
    tables = (rng.normal(size=(b, m, 256)) * 3.0).astype(np.float32)
    code_table = rng.integers(0, 256, size=(n, m)).astype(np.uint8)
    ids = rng.integers(-2, n + 2, size=(b, c)).astype(np.int64)
    cells = rng.integers(0, n_cells, size=n).astype(np.int32)
    bias = (rng.normal(size=n) * 50.0).astype(np.float32)
    cell_tables = (rng.normal(size=(b, n_cells)) * 20.0).astype(np.float32)
    return tables, code_table, ids, cells, bias, cell_tables


@jax.jit
def _jax_expand(tables, codes, ids, point_cell, point_bias, cell_tables):
    """The JAX package's `beam_search_pq` distance step
    (diskrag_tpu/graph/search.py, `expand`), its Pallas kernel in interpret
    mode: codes[clip(ids)], the lookup, then the cell term and the bias."""
    safe = jnp.clip(ids, 0, codes.shape[0] - 1)
    d = adc_lookup_gathered_pallas(tables, codes[safe], interpret=True)
    if point_cell is not None:
        d = d + jnp.take_along_axis(cell_tables, point_cell[safe], axis=1) + point_bias[safe]
    return d


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("m,c", [(8, 37), (16, 24), (32, 5), (16, 1), (8, 130)])
def test_plain_b5_by_id_is_bit_identical_to_the_jax_composition(m, c, residual):
    """Adds in the same order on both sides ((lookup + cell) + bias, one
    rounding each), so the two agree bit for bit."""
    tables, code_table, ids, cells, bias, cell_tables = _id_inputs(
        3, m, c, 501, 13, seed=m * 1000 + c)
    aux = (cells, bias, cell_tables) if residual else (None, None, None)
    want = np.asarray(_jax_expand(*(None if a is None else jnp.asarray(a)
                                    for a in (tables, code_table, ids, *aux))))
    taux = ({"point_cell": torch.from_numpy(cells), "point_bias": torch.from_numpy(bias),
             "cell_tables": torch.from_numpy(cell_tables)} if residual else {})
    pq_scan.reset_launch_counts()
    got = pq_scan.adc_lookup_ids_kernel(torch.from_numpy(tables), torch.from_numpy(code_table),
                                        torch.from_numpy(ids), **taux)
    assert got.dtype == torch.float32 and got.shape == (3, c)
    assert np.array_equal(got.numpy(), want)
    assert pq_scan.adc_lookup_gathered_kernel.launches == 0  # the plain version on CPU tensors


def test_plain_b5_by_id_equals_the_gathered_form_and_refuses_partial_residual_operands():
    tables, code_table, ids, cells, bias, cell_tables = _id_inputs(2, 16, 9, 40, 4, seed=2)
    t, ct, i = (torch.from_numpy(a) for a in (tables, code_table, ids))
    want = pq_scan.adc_lookup_gathered_ref(t, ct[i.clamp(0, 39)])
    assert torch.equal(pq_scan.adc_lookup_ids_kernel(t, ct, i), want)
    with pytest.raises(ValueError, match="together"):
        pq_scan.adc_lookup_ids_kernel(t, ct, i, point_cell=torch.from_numpy(cells))


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("m", [3, 4, 6, 20, 48, 64, 228])
def test_plain_b5_by_id_equals_numpy_in_subspace_order(m, residual):
    """At widths the kernel loads its code rows by differently (bytes, 4-byte
    words, 16-byte vectors; more than one chunk of 16 subspaces; a table
    past a block's shared memory at m = 228), the plain by-id version
    equals numpy's f32 adds in subspace order, then the cell term, then the
    bias, bit for bit."""
    tables, code_table, ids, cells, bias, cell_tables = _id_inputs(
        4, m, 11, 97, 7, seed=m + 17 * residual)
    safe = np.clip(ids, 0, 96)
    want = np.zeros(ids.shape, np.float32)
    rows = np.arange(4)[:, None]
    for j in range(m):
        want = want + tables[rows, j, code_table[safe, j]]
    aux = {}
    if residual:
        want = want + cell_tables[rows, cells[safe]]
        want = want + bias[safe]
        aux = {"point_cell": torch.from_numpy(cells), "point_bias": torch.from_numpy(bias),
               "cell_tables": torch.from_numpy(cell_tables)}
    got = pq_scan.adc_lookup_ids_kernel(torch.from_numpy(tables), torch.from_numpy(code_table),
                                        torch.from_numpy(ids), **aux)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)


@pytest.mark.cuda
def test_b5_kernel_matches_plain_version_on_card():
    """Run with `pytest -m cuda` on a machine with a card: B5's wrapper on
    CUDA tensors (the kernel) against the plain version, bit-identical,
    at ragged and main-path shapes, a table past a block's shared memory
    (m = 228) among them; codes of another type or layout are refused."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the B5 kernel is compiled and run only on one")
    dev = torch.device("cuda", 0)
    pq_scan.reset_launch_counts()
    shapes = [(250, 32, 192), (1000, 16, 24), (1, 64, 48), (37, 8, 5), (3, 6, 300), (2, 4, 1),
              (1, 228, 2)]
    for b, m, c in shapes:
        tables, codes = _inputs(b, m, c, seed=m)
        t, cd = torch.from_numpy(tables).to(dev), torch.from_numpy(codes).to(dev)
        got = pq_scan.adc_lookup_gathered_kernel(t, cd)
        want = pq_scan.adc_lookup_gathered_ref(t, cd)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (b, m, c)
    assert pq_scan.adc_lookup_gathered_kernel.launches == len(shapes)
    with pytest.raises(TypeError):
        pq_scan.adc_lookup_gathered_kernel(
            torch.zeros((1, 4, 256), device=dev), torch.zeros((1, 2, 4), dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        pq_scan.adc_lookup_gathered_kernel(
            torch.zeros((1, 4, 256), device=dev),
            torch.zeros((1, 4, 2), dtype=torch.uint8, device=dev).transpose(1, 2))


@pytest.mark.cuda
def test_b5_by_id_kernel_matches_plain_version_on_card():
    """Run with `pytest -m cuda` on a machine with a card: the by-id form,
    with and without the residual operands, against its plain version,
    bit-identical; one launch a call, counted under B5; operands of
    another type refused."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the B5 kernel is compiled and run only on one")
    dev = torch.device("cuda", 0)
    pq_scan.reset_launch_counts()
    calls = 0
    for b, m, c in [(1000, 16, 24), (250, 32, 192), (37, 8, 5), (3, 6, 300), (2, 4, 1)]:
        arrays = _id_inputs(b, m, c, 5003, 64, seed=m + c)
        t, ct, i, cells, bias, cell_tables = (torch.from_numpy(a).to(dev) for a in arrays)
        for aux in ({}, {"point_cell": cells, "point_bias": bias, "cell_tables": cell_tables}):
            want = pq_scan.adc_lookup_ids_ref(t, ct, i, **aux)
            got = pq_scan.adc_lookup_ids_kernel(t, ct, i, **aux)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (b, m, c, bool(aux))
            calls += 1
    assert pq_scan.adc_lookup_gathered_kernel.launches == calls
    with pytest.raises(TypeError):
        pq_scan.adc_lookup_ids_kernel(t, ct, i.to(torch.int32))
    with pytest.raises(TypeError):
        pq_scan.adc_lookup_ids_kernel(t, ct, i, point_cell=cells.long(), point_bias=bias,
                                      cell_tables=cell_tables)
