"""The port's matmul-only probe (M1) held against the TPU kernel it
replaces, on the same inputs, made by numpy from a seed.

The TPU kernel `_mm_only` is a closure inside `main()` of
`benchmarks/fused_scan_micro.py` and cannot be imported, so this file
keeps a transcription of it and of its caller `mm_only` (that script's
lines 164-199, without the TPU compiler parameters) and runs it with
`interpret=True`. The port's side runs the plain PyTorch version (the
tensors lie on the CPU). Everything is int32 arithmetic: tolerance 0.
Both are also held to the closed form in int64 numpy, and the port's
second output (the wrapping row sum over all columns of every tile) to
q . colsum(db) mod 2^32. The kernel's grid (`plan_mm_probe`) is replayed in
numpy, block by block with the kernel's mask at `tile`, and held to the
closed form. The last tests, marked `cuda`, hold the CUDA kernel against
the plain version on a card (also where every column sum wraps), and build
a deliberately broken copy of the kernel (one that multiplies only the
kept columns) to show that the row sum catches it."""

import shutil

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # the suite runs several workers: do not let each spin a thread per core

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from diskrag_tpu_torch.ops import mm_probe as mp


def _mm_only(q_ref, db_ref, acc_ref):
    t_idx = pl.program_id(1)

    @pl.when(t_idx == 0)
    def _init():
        acc_ref[...] = jnp.zeros_like(acc_ref)

    cross = jax.lax.dot_general(
        q_ref[...], db_ref[...], (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    acc_ref[...] += cross[:, : acc_ref.shape[1]]


def pallas_mm_only(gq, gcodes, tile, nb_out=512, qb=1024):
    n, d = gcodes.shape
    dbp = jnp.pad(gcodes, ((0, (-n) % tile), (0, 0)))
    b = gq.shape[0]
    qb = min(qb, max(128, -(-b // 128) * 128))
    qp = jnp.pad(gq, ((0, (-b) % qb), (0, 0)))
    return pl.pallas_call(
        _mm_only,
        grid=(qp.shape[0] // qb, dbp.shape[0] // tile),
        in_specs=[
            pl.BlockSpec((qb, d), lambda i, j: (i, 0)),
            pl.BlockSpec((tile, d), lambda i, j: (j, 0)),
        ],
        out_specs=pl.BlockSpec((qb, nb_out), lambda i, j: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((qp.shape[0], nb_out), jnp.int32),
        interpret=True,
    )(qp, dbp)


def closed_form(q, db, tile, nb_out, qb):
    """out[b, c] = sum_t q[b] . db[t * tile + c] and the row sum over all
    rows, in int64 numpy, wrapped to int32."""
    b, _ = q.shape
    n = db.shape[0]
    bpad = mp.padded_queries(b, qb)
    dbp = np.zeros((-(-n // tile) * tile, db.shape[1]), np.int64)
    dbp[:n] = db
    cross = q.astype(np.int64) @ dbp.T
    out = np.zeros((bpad, nb_out), np.int64)
    out[:b] = cross.reshape(b, -1, tile)[:, :, :nb_out].sum(1)
    rowsum = np.zeros((bpad,), np.int64)
    rowsum[:b] = cross.sum(1)
    wrap = lambda x: ((x + 2**31) % 2**32 - 2**31).astype(np.int32)  # noqa: E731
    return wrap(out), wrap(rowsum)


def _inputs(b, d, n, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, size=(b, d)).astype(np.int8)
    db = rng.integers(-127, 128, size=(n, d)).astype(np.int8)
    return q, db


@pytest.mark.parametrize(
    "b,d,n,tile,nb_out,qb",
    [
        (200, 32, 1000, 256, 128, 1024),   # one query block of 256, a ragged last tile
        (300, 16, 1500, 512, 128, 128),    # three query blocks
        (37, 48, 700, 128, 128, 1024),     # tile == nb_out: every column kept
        (5, 128, 256, 256, 256, 1024),     # one tile exactly
        (130, 64, 4096, 1024, 512, 256),   # a pad that is most of a query block
    ],
)
def test_plain_m1_is_bit_identical_to_the_pallas_kernel(b, d, n, tile, nb_out, qb):
    q, db = _inputs(b, d, n, seed=b + n)
    want = np.asarray(pallas_mm_only(jnp.asarray(q), jnp.asarray(db), tile, nb_out, qb))
    out, rowsum = mp.mm_probe(torch.from_numpy(q), torch.from_numpy(db),
                              tile=tile, nb_out=nb_out, qb=qb)
    assert out.dtype == torch.int32 and rowsum.dtype == torch.int32
    assert out.shape == want.shape == (mp.padded_queries(b, qb), nb_out)
    assert np.array_equal(out.numpy(), want)
    cf_out, cf_rowsum = closed_form(q, db, tile, nb_out, qb)
    assert np.array_equal(want, cf_out)
    assert np.array_equal(rowsum.numpy(), cf_rowsum)
    assert not out[b:].any() and not rowsum[b:].any()  # the query pad's rows are zero


def test_plain_m1_wraps_like_int32():
    """Extreme codes, many tiles: the column sums pass 2^31 and the plain
    version wraps as the kernel's int32 accumulator does."""
    b, d, n, tile, nb_out = 4, 192, 64 * 2048, 64, 64
    q = np.full((b, d), 127, np.int8)
    db = np.full((n, d), 127, np.int8)
    exact = 127 * 127 * d * (n // tile)
    assert exact > 2**31
    out, rowsum = mp.mm_probe_ref(torch.from_numpy(q), torch.from_numpy(db),
                                  tile=tile, nb_out=nb_out)
    cf_out, cf_rowsum = closed_form(q, db, tile, nb_out, 1024)
    assert np.array_equal(out.numpy(), cf_out) and np.array_equal(rowsum.numpy(), cf_rowsum)
    assert int(out[0, 0]) == (exact + 2**31) % 2**32 - 2**31 != exact


def replay_grid(q, db, tile, nb_out, qb, plan, mask=True):
    """The kernel's blocks in numpy: block (x, y, z) multiplies queries
    [64x, +64) by rows [t * tile + 64y, +64) of every tile t of part z,
    summing over the tiles, then adds columns c0 + j < tile (all of them
    with mask=False) into out (j < nb_out) and rowsum. Also returns how
    often each (query tile, column, tile) was multiplied."""
    b = q.shape[0]
    n = db.shape[0]
    bpad = mp.padded_queries(b, qb)
    out = np.zeros((bpad, nb_out), np.int64)
    rowsum = np.zeros((bpad,), np.int64)
    seen = np.zeros((plan.q_tiles, plan.col_blocks * 64, plan.n_tiles), np.int64)
    dbz = np.zeros((plan.n_tiles * tile + 64, db.shape[1]), np.int64)
    dbz[:n] = db  # rows at or past n are TMA's zero fill
    for x in range(plan.q_tiles):
        qx = q[64 * x: 64 * x + 64].astype(np.int64)
        for y in range(plan.col_blocks):
            c0 = 64 * y
            for z in range(plan.n_parts):
                tiles = range(z * plan.tiles_per_part,
                              min(plan.n_tiles, (z + 1) * plan.tiles_per_part))
                acc = np.zeros((qx.shape[0], 64), np.int64)
                for t in tiles:
                    acc += qx @ dbz[t * tile + c0: t * tile + c0 + 64].T
                    seen[x, c0: c0 + 64, t] += 1
                cols = c0 + np.arange(64)
                keep = cols < tile if mask else np.ones(64, bool)
                rowsum[64 * x: 64 * x + qx.shape[0]] += acc[:, keep].sum(1)
                kept = keep & (cols < nb_out)
                out[64 * x: 64 * x + qx.shape[0], cols[kept]] += acc[:, kept]
    wrap = lambda v: ((v + 2**31) % 2**32 - 2**31).astype(np.int32)  # noqa: E731
    return wrap(out), wrap(rowsum), seen


@pytest.mark.parametrize(
    "b,d,n,tile,nb_out",
    [(37, 44, 5003, 272, 100),    # ragged tile: the last column block reaches the next tile
     (70, 48, 9000, 2048, 512),   # two query tiles, tiles in parts
     (1, 16, 300, 64, 64),        # one column block, a ragged last tile
     (130, 32, 20000, 4096, 512), # more tiles than one part
     (5, 128, 2000, 16, 16)],     # tiles smaller than a column block
)
def test_plan_mm_probe_covers_every_query_column_tile_once(b, d, n, tile, nb_out):
    plan = mp.plan_mm_probe(b, tile, n, sms=2)
    assert plan.q_tiles == -(-b // 64) and plan.col_blocks == -(-tile // 64)
    assert plan.n_tiles == -(-n // tile)
    assert (plan.n_parts - 1) * plan.tiles_per_part < plan.n_tiles <= plan.n_parts * plan.tiles_per_part
    q, db = _inputs(b, d, n, seed=tile + b)
    out, rowsum, seen = replay_grid(q, db, tile, nb_out, 1024, plan)
    # every (query tile, column of the tile, tile) once; the column blocks'
    # overhang past the tile is multiplied too, and masked
    assert (seen[:, :tile] == 1).all()
    cf_out, cf_rowsum = closed_form(q, db, tile, nb_out, 1024)
    assert np.array_equal(out, cf_out) and np.array_equal(rowsum, cf_rowsum)
    if tile % 64 and plan.n_tiles > 1:  # without the mask the overhang counts twice
        _, unmasked, _ = replay_grid(q, db, tile, nb_out, 1024, plan, mask=False)
        assert not np.array_equal(unmasked, cf_rowsum)


def test_plan_mm_probe_fills_the_card():
    # 1000 x 1M rows, tile 2048: 512 query x column blocks, 489 tiles, three
    # blocks an SM on 132 SMs: three parts (1536 blocks, 3.9 waves)
    plan = mp.plan_mm_probe(1000, 2048, 1_000_000, sms=132)
    assert (plan.q_tiles, plan.col_blocks, plan.n_tiles) == (16, 32, 489)
    assert (plan.tiles_per_part, plan.n_parts) == (163, 3)
    assert mp.plan_mm_probe(1, 64, 64, sms=132).n_parts == 1
    with pytest.raises(ValueError):
        mp.plan_mm_probe(0, 64, 64, sms=132)


def test_m1_rejects_what_the_probe_does_not_take_and_counts_no_launch_on_the_cpu():
    q, db = _inputs(8, 16, 64, seed=1)
    tq, tdb = torch.from_numpy(q), torch.from_numpy(db)
    mp.reset_launch_counts()
    mp.mm_probe(tq, tdb, tile=32, nb_out=16)
    assert mp.mm_probe.launches == 0  # no kernel on CPU tensors
    with pytest.raises(ValueError, match="nb_out"):
        mp.mm_probe(tq, tdb, tile=16, nb_out=32)
    with pytest.raises(TypeError, match="int8"):
        mp.mm_probe(tq.to(torch.int32), tdb, tile=32, nb_out=16)
    with pytest.raises(ValueError, match=r"\[B, D\]"):
        mp.mm_probe(tq, tdb[:, :8], tile=32, nb_out=16)
    assert mp.padded_queries(1000) == 1024 and mp.padded_queries(200) == 256
    assert mp.padded_queries(300, 128) == 384 and mp.padded_queries(1) == 128


@pytest.mark.cuda
def test_m1_kernel_matches_plain_version_on_card():
    """Run with `pytest -m cuda` on a machine with a card: M1's wrapper on
    CUDA tensors (the kernel) against the plain version, both outputs
    bit-identical, at ragged shapes (tile 272: a column block across two
    tiles), at tiles 2048 and 4096 with B = 1, 37 and 1000, and at every row
    width class (16 to 192 bytes)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the M1 kernel is compiled and run only on one")
    dev = torch.device("cuda", 0)
    mp.reset_launch_counts()
    shapes = [(1000, 128, 200_000, 2048, 512, 1024), (37, 44, 5003, 256, 100, 1024),
              (300, 16, 1500, 512, 128, 128), (5, 192, 100, 4096, 512, 1024),
              (1, 128, 17, 16, 16, 1024), (37, 44, 5003, 272, 100, 1024),
              (1000, 128, 20_011, 272, 256, 1024), (1, 128, 30_000, 2048, 512, 1024),
              (37, 128, 30_000, 2048, 512, 1024), (1, 128, 70_001, 4096, 512, 1024),
              (37, 160, 70_001, 4096, 512, 1024), (1000, 128, 100_000, 4096, 512, 1024)]
    for b, d, n, tile, nb_out, qb in shapes:
        q, db = _inputs(b, d, n, seed=d)
        tq, tdb = torch.from_numpy(q).to(dev), torch.from_numpy(db).to(dev)
        got = mp.mm_probe(tq, tdb, tile=tile, nb_out=nb_out, qb=qb)
        want = mp.mm_probe_ref(tq, tdb, tile=tile, nb_out=nb_out, qb=qb)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (b, d, n, tile)
    assert mp.mm_probe.launches == len(shapes)
    with pytest.raises(ValueError, match="multiple of 16"):
        mp.mm_probe(tq, tdb, tile=24, nb_out=16)
    with pytest.raises(ValueError, match="caps D"):
        mp.mm_probe(torch.zeros((2, 208), dtype=torch.int8, device=dev),
                    torch.zeros((4, 208), dtype=torch.int8, device=dev), tile=16, nb_out=16)


@pytest.mark.cuda
def test_m1_kernel_wraps_like_int32_on_card():
    """Operands that overflow: every code -128, D = 128, tile 64 and 1100
    tiles, so each column's sum (1100 * 128 * 2^14) and every row sum pass
    2^31. The s32 accumulators (no .satfinite) and the atomics must wrap as
    the plain version does, and the plain version shows that it wraps."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the M1 kernel is compiled and run only on one")
    dev = torch.device("cuda", 0)
    b, d, tile, n_tiles = 37, 128, 64, 1100
    q = torch.full((b, d), -128, dtype=torch.int8, device=dev)
    db = torch.full((tile * n_tiles, d), -128, dtype=torch.int8, device=dev)
    got = mp.mm_probe(q, db, tile=tile, nb_out=64)
    want = mp.mm_probe_ref(q, db, tile=tile, nb_out=64)
    torch.cuda.synchronize()
    exact_col = n_tiles * d * 128 * 128
    exact_row = tile * exact_col
    assert exact_col > 2**31 and exact_row > 2**31
    assert int(want[0][0, 0]) == (exact_col + 2**31) % 2**32 - 2**31 != exact_col
    assert int(want[1][0]) == (exact_row + 2**31) % 2**32 - 2**31 != exact_row
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_m1_row_sum_catches_a_probe_that_skips_the_unkept_columns(tmp_path, monkeypatch):
    """The check that keeps every product alive is itself checked: a copy
    of the kernel's source in which the blocks of the columns at or past
    nb_out return at once (what a port that stores only the kept columns
    amounts to) still gets `out` right, and its row sum wrong."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the M1 kernel is compiled and run only on one")
    from diskrag_tpu_torch.kernels import _build

    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    text = (src / "mm_probe.cu").read_text()
    # the whole block leaves (producer too) before its barriers exist
    guard = "  const Smem m = setup_smem<kBoxes>(smem_raw);"
    assert text.count(guard) == 1
    (src / "mm_probe.cu").write_text(text.replace(
        guard, "  if (blockIdx.y * kLanes >= nb_out) return;  // broken on purpose\n" + guard))
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    dev = torch.device("cuda", 0)
    q, db = _inputs(100, 64, 6000, seed=9)
    tq, tdb = torch.from_numpy(q).to(dev), torch.from_numpy(db).to(dev)
    got = mp.mm_probe(tq, tdb, tile=1024, nb_out=256)
    want = mp.mm_probe_ref(tq, tdb, tile=1024, nb_out=256)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])      # the kept columns are still right
    assert not torch.equal(got[1], want[1])  # the row sum shows the products that did not run
