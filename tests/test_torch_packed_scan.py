"""The port's packed folds (B2, B3, B6), their fused cut and the packed
branch of the fused search held against the JAX package on the same
inputs, made by numpy from a seed. The JAX side runs its Pallas kernels in
interpret mode; the port's side runs the plain PyTorch versions (the
tensors lie on the CPU). The tests marked `cuda` hold the CUDA kernels
against the plain versions on a card, and check that B6 refuses a build
whose registers differ from what its `setmaxnreg` split assumes.

Kernel-level tests carry the JAX-built table across and demand bit
identity: after one f32 product (nf * 1/q_scale) the folds are integer
arithmetic. A table built by the port is held to less, and the test that
does so says why."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diskrag_tpu.ops import flat_scan_pallas as jfs
from diskrag_tpu_torch.ops import flat_scan as tfs


def _t(a):
    return torch.from_numpy(np.array(a))


def _data(n, d, b, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, d)).astype(np.float32) * 2.0
    q = pts[rng.integers(0, n, size=b)] + rng.normal(size=(b, d)).astype(np.float32) * 0.3
    return pts, q.astype(np.float32)


def _both(fn_name, pts, q, *, table, **kw):
    """One packed wrapper of both packages on one JAX-quantized database:
    (JAX scores, JAX ids, port scores, port ids) as numpy (scores None with
    cut_kk). `table` carries the JAX pre-padded table across; otherwise the
    unpadded contract (rows, norms, scale)."""
    v = jnp.asarray(pts)
    qc, qs = jfs.quantize_int8_global(jnp.asarray(q))
    if table:
        codes, nf, scale, n = jfs.build_packed_scan_table(v)
        jargs, extra = (qc, qs, codes, nf, scale), dict(n_valid=n)
    else:
        codes, scale = jfs.quantize_int8_global(v)
        jargs, extra = (qc, qs, codes, jnp.sum(jnp.square(v), -1), scale), {}
    js, ji = getattr(jfs, fn_name)(*jargs, interpret=True, **extra, **kw)
    ts, ti = getattr(tfs, fn_name)(*[_t(a) for a in jargs], **extra, **kw)
    np_ = lambda a: None if a is None else np.asarray(a)  # noqa: E731
    return np_(js), np_(ji), None if ts is None else ts.numpy(), ti.numpy()


def _same(js, ji, ts, ti):
    assert ti.dtype == np.int32 and ti.shape == ji.shape
    assert np.array_equal(ji, ti)
    if js is not None:
        assert ts.dtype == np.float32
        assert np.array_equal(js, ts)  # -inf == -inf holds; no NaN arises


def test_quantize_int8_global_bit_identical():
    x, _ = _data(500, 48, 1, seed=1)
    x[9, 3] = 1e-30
    for a in (x, np.zeros((4, 8), np.float32), x[:3] * 1e-3):
        jc, js = jfs.quantize_int8_global(jnp.asarray(a))
        tc, ts = tfs.quantize_int8_global(_t(a))
        assert np.array_equal(np.asarray(jc), tc.numpy())
        assert np.asarray(js) == ts.numpy() and ts.dtype == torch.float32


def test_build_packed_scan_table_matches():
    x, _ = _data(5000, 32, 1, seed=2)
    jc, jnf, js, jn = jfs.build_packed_scan_table(jnp.asarray(x))
    tc, tnf, ts, tn = tfs.build_packed_scan_table(_t(x))
    assert jn == tn == 5000 and tc.shape == (8192, 32) and tnf.shape == (1, 8192)
    assert np.array_equal(np.asarray(jc), tc.numpy())
    assert np.asarray(js) == ts.numpy()
    assert np.isinf(tnf.numpy()[0, 5000:]).all()
    # nf = sum(x*x) / scale: both sum in f32, XLA and PyTorch in another
    # order, so the row agrees to f32 rounding, not bit for bit. nf/q_scale
    # reaches ~2e6, where one ulp is 0.125-0.25, so nint can move by 1 on a
    # share of rows: bit parity of the folds needs the table carried across
    np.testing.assert_allclose(tnf.numpy()[0, :5000], np.asarray(jnf)[0, :5000], rtol=1e-6)


@pytest.mark.parametrize(
    "n,d,nb,table",
    [(5000, 48, 512, True), (5000, 48, 512, False), (3000, 32, 256, False),
     (9000, 64, 1024, True), (200, 16, 512, False),
     (40_000, 8, 128, False)],  # past 256 * 128 rows: the widen loop makes NB 256
)
def test_packed_scan_matches_jax(n, d, nb, table):
    pts, q = _data(n, d, 11, seed=3)
    js, ji, ts, ti = _both("scan_bucketed_topk_packed", pts, q, table=table, n_buckets=nb)
    _same(js, ji, ts, ti)
    assert ti.max() < n and ti.min() >= -1
    if n == 40_000:
        assert ti.shape == (11, 256)


@pytest.mark.parametrize(
    "n,d,nb,tile,table",
    [(9000, 64, 512, 2048, False), (3000, 64, 256, 512, False),
     (40_000, 64, 512, 1024, True), (5000, 48, 512, 2048, True),
     (40_000, 8, 128, 2048, False),  # 313 segments: a partial second super-tile
     (70_000, 8, 128, 512, True)],  # three super-tiles, the table's pads in the last
)
def test_hier_scan_matches_jax(n, d, nb, tile, table):
    pts, q = _data(n, d, 9, seed=4)
    js, ji, ts, ti = _both("scan_bucketed_topk_hier", pts, q, table=table,
                           n_buckets=nb, db_tile=tile)
    _same(js, ji, ts, ti)
    assert ti.shape == (9, nb)  # the segment budget does not widen NB


def test_hier_scan_ties_prefer_larger_segment_then_earlier_super_tile():
    # identical rows everywhere: inside a super-tile the packed max keeps the
    # largest segment, across super-tiles the strict '>' keeps the first
    n, nb = 128 * 600, 128
    pts = np.tile(np.array([[1.0, -2.0, 0.5, 3.0]], np.float32), (n, 1))
    q = pts[:3] * np.array([[1.0], [0.5], [-1.0]], np.float32)
    js, ji, ts, ti = _both("scan_bucketed_topk_hier", pts, q, table=False, n_buckets=nb)
    _same(js, ji, ts, ti)
    assert (ti == 255 * nb + np.arange(nb)[None, :]).all()
    js, ji, ts, ti = _both("scan_bucketed_topk_packed", pts[: nb * 200], q, table=False,
                           n_buckets=nb)
    _same(js, ji, ts, ti)
    assert (ti == 199 * nb + np.arange(nb)[None, :]).all()


@pytest.mark.parametrize("n,nb", [(9000, 512), (40_000, 128)])
def test_pipelined_hier_equals_plain_hier(n, nb):
    pts, q = _data(n, 32, 7, seed=5)
    _, _, ts, ti = _both("scan_bucketed_topk_hier", pts, q, table=True, n_buckets=nb)
    js, ji, ps, pi = _both("scan_bucketed_topk_hier", pts, q, table=True, n_buckets=nb,
                           pipelined=True)
    _same(js, ji, ps, pi)  # the JAX pipelined kernel
    _same(ts, ti, ps, pi)  # B6's plain path is B3's
    with pytest.raises(ValueError, match="pipelined"):
        tfs.scan_bucketed_topk_hier(
            _t(q).to(torch.int8), torch.tensor(1.0), _t(pts).to(torch.int8),
            torch.ones(n), torch.tensor(1.0), pipelined=True, cut_kk=8)


@pytest.mark.parametrize("d", [8, 40, 64, 100, 128, 160, 192])
def test_pipelined_hier_matches_jax_at_b6_row_widths(d):
    """Over the row widths of B6's three partial-kernel instantiations
    (rows of up to 64, 128 and 192 bytes), the port's pipelined path
    equals the JAX pipelined kernel bit for bit."""
    pts, q = _data(5000, d, 5, seed=d)
    js, ji, ps, pi = _both("scan_bucketed_topk_hier", pts, q, table=True, n_buckets=128,
                           pipelined=True)
    _same(js, ji, ps, pi)


@pytest.mark.parametrize("fn", ["scan_bucketed_topk_packed", "scan_bucketed_topk_hier"])
@pytest.mark.parametrize(
    "n,nb,kk,table",
    [(6000, 256, 20, False), (5000, 512, 40, True),
     (188, 128, 128, False),  # -1 inside rows (see below)
     (300, 256, 64, False)],
)
def test_fused_cut_matches_jax(fn, n, nb, kk, table):
    pts, q = _data(n, 32, 13, seed=6)
    pts[n // 2 :] = pts[: n - n // 2]  # duplicate rows: exact score ties
    kw = {}
    if n == 188:
        # Tiny queries make 1/q_scale huge, so every nint clips to 2^21 like a
        # pad's and a row with a negative cross product loses to a pad. With a
        # 128-row tile, lanes 60..127 hold one real row and one pad, lanes
        # 0..59 two real rows: a lane won by its pad (id >= n_valid, so -1)
        # ranks above a lane whose two real rows both score below zero
        q = q * 1e-4
        kw = dict(db_tile=128)
    _, ji, _, ti = _both(fn, pts, q, table=table, n_buckets=nb, cut_kk=kk, **kw)
    assert ti.shape == (13, kk)
    assert np.array_equal(ji, ti)
    if n == 188:
        assert ti.max() < n
        assert any((r == -1).any() and r[np.argmax(r == -1):].max() >= 0 for r in ti)


def test_epilogue_cut_ids_ref_orders_by_value_then_lowest_lane():
    state = torch.tensor([[5 * 256 + 3, 7 * 256 + 1, 7 * 256 + 1, tfs._INT32_MIN],
                          [tfs._INT32_MIN] * 4], dtype=torch.int32)
    ids = tfs.epilogue_cut_ids_ref(state, 6, tfs._INT32_MIN, n_valid=14)
    # lanes 1, 2 tie (lane 1 first): ids 1*4+1, 1*4+2; lane 0: 3*4+0 = 12;
    # then exhausted. With n_valid 14 nothing is masked; with 6 id 12 is
    assert ids.tolist() == [[5, 6, 12, -1, -1, -1], [-1] * 6]
    ids = tfs.epilogue_cut_ids_ref(state, 3, tfs._INT32_MIN, n_valid=6)
    assert ids.tolist() == [[5, -1, -1], [-1, -1, -1]]  # id 6 masked inside the row
    gseg = torch.tensor([[300, 2, 1, -1], [-1] * 4], dtype=torch.int32)
    vals = torch.tensor([[9, 9, 4, tfs._EMPTY_HIER], [tfs._EMPTY_HIER] * 4], dtype=torch.int32)
    ids = tfs.epilogue_cut_ids_ref(vals, 4, tfs._EMPTY_HIER, n_valid=10_000, gseg=gseg)
    assert ids.tolist() == [[1200, 9, 6, -1], [-1] * 4]


def test_negative_packed_values_shift_and_mask_as_floor():
    # the plain versions rely on these for negative ints
    p = torch.tensor([-1, -256, -257, -(1 << 31) + 5], dtype=torch.int32)
    assert torch.bitwise_right_shift(p, 8).tolist() == [-1, -1, -2, -(1 << 23)]
    assert torch.bitwise_and(p, 255).tolist() == [255, 0, 255, 5]
    assert torch.remainder(p, 256).tolist() == [255, 0, 255, 5]


def _fused_pair(pts, q, metric, k, *, table, **kw):
    """JAX flat_search_fused (interpret) and the port's on one
    JAX-quantized packed database."""
    src = pts / np.linalg.norm(pts, axis=1, keepdims=True) if metric == "cosine" else pts
    v = jnp.asarray(src)
    if table:
        codes, nf, scale, n = jfs.build_packed_scan_table(v)
        extra = dict(db_nf=nf, n_valid=n)
    else:
        codes, scale = jfs.quantize_int8_global(v)
        extra = {}
    norms = jnp.sum(jnp.square(v), -1)
    jd, ji = jfs.flat_search_fused(
        jnp.asarray(q), codes, norms, jnp.asarray(pts), k=k, metric=metric,
        interpret=True, db_scale_global=scale, **extra, **kw)
    textra = {key: (_t(val) if key == "db_nf" else val) for key, val in extra.items()}
    td, ti = tfs.flat_search_fused(
        _t(q), _t(codes), _t(norms), _t(pts), k=k, metric=metric,
        db_scale_global=_t(scale), **textra, **kw)
    return np.asarray(jd), np.asarray(ji), td.numpy(), ti.numpy()


@pytest.mark.parametrize(
    "metric,n,k,table,kw",
    [("l2", 5000, 10, True, {}), ("cosine", 5000, 10, True, {}),
     ("l2", 4000, 10, False, {}), ("cosine", 4000, 5, False, {"rerank_width": 12}),
     ("l2", 5000, 10, True, {"rerank_width": 24}),
     ("l2", 20, 10, False, {"rerank_width": 32}),  # exhausted rows: -1 candidates
     ("l2", 40_000, 10, False, {"n_buckets": 128})],  # B2's widen loop on the path
)
def test_flat_search_fused_packed_matches_jax(metric, n, k, table, kw):
    d = 8 if n == 40_000 else 32
    pts, q = _data(n, d, 16, seed=7)
    jd, ji, td, ti = _fused_pair(pts, q, metric, k, table=table, **kw)
    assert np.array_equal(ji, ti)
    # the rerank is f32 in both, summed in another order
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)
    assert (np.diff(td, axis=1) >= -1e-6).all()


def test_flat_search_fused_packed_wide_cut_goes_through_b4():
    # kk = 80 > 64: two-stage cut on the f32-cast packed scores. Casting
    # int32 above 2^24 to f32 can make two lanes collide, and the reference
    # cuts with approx_max_k there, so ids are held only where a row's
    # scores are distinct; the final top-k is held in full.
    pts, q = _data(6000, 32, 16, seed=8)
    jd, ji, td, ti = _fused_pair(pts, q, "l2", 20, table=True)
    v = jnp.asarray(pts)
    codes, nf, scale, n = jfs.build_packed_scan_table(v)
    qc, qs = jfs.quantize_int8_global(jnp.asarray(q))
    scores, _ = jfs.scan_bucketed_topk_packed(qc, qs, codes, nf, scale, n_buckets=1024,
                                              interpret=True, n_valid=n)
    scores = np.asarray(scores)
    distinct = [len(np.unique(r[np.isfinite(r)])) == np.isfinite(r).sum() for r in scores]
    assert np.array_equal(ji[distinct], ti[distinct])
    np.testing.assert_allclose(td[distinct], jd[distinct], rtol=1e-5, atol=1e-5)
    assert np.mean(ji == ti) >= 0.99


def test_flat_search_fused_packed_counts_no_b4_when_cut_is_fused(monkeypatch):
    pts, q = _data(3000, 32, 8, seed=9)

    def no_b4(*a, **kw):
        raise AssertionError("kk <= 64 fuses the cut: B4 must not run")

    monkeypatch.setattr(tfs, "topk_lanes", no_b4)
    jd, ji, td, ti = _fused_pair(pts, q, "l2", 10, table=True)
    assert np.array_equal(ji, ti)


def test_packed_rejects_dot_and_missing_nf():
    pts, q = _data(300, 16, 4, seed=10)
    codes, nf, scale, n = tfs.build_packed_scan_table(_t(pts))
    with pytest.raises(ValueError, match="l2/cosine only"):
        tfs.flat_search_fused(_t(q), codes, nf, _t(pts), k=5, metric="dot",
                              db_scale_global=scale, db_nf=nf, n_valid=n)
    with pytest.raises(ValueError, match="db_nf"):
        tfs.flat_search_fused(_t(q), codes, nf, _t(pts), k=5, db_scale_global=scale, n_valid=n)


@pytest.mark.parametrize("fn", ["scan_bucketed_topk_packed", "scan_bucketed_topk_hier"])
def test_packed_folds_refuse_wide_rows(fn):
    pts, q = _data(300, 256, 4, seed=11)
    codes, scale = tfs.quantize_int8_global(_t(pts))
    qc, qs = tfs.quantize_int8_global(_t(q))
    with pytest.raises(ValueError, match="caps D at 192"):
        getattr(tfs, fn)(qc, qs, codes, torch.sum(_t(pts) ** 2, -1), scale)
    # through the fused search the reference catches that and serves exactly
    jd, ji, td, ti = _fused_pair(pts, q, "l2", 5, table=False)
    assert np.array_equal(ji, ti)


# --- routing: pure integer arithmetic against the reference's layout --------


def _jax_route(n_phys, n, d, b, n_buckets, kk):
    """The reference's routing (`flat_scan_pallas.py:1142-1218`) spelled
    with its own helpers."""
    db_tile = max(2048, n_buckets)
    fit = jfs._fit_query_block(1024, db_tile, n_buckets, d, state_bytes=4, itemsize=1,
                               norm_rows=1, batch=b)
    if fit == 0:
        return ("brute",)
    qb = max(8, fit)
    cut = kk if kk <= 64 else None
    cut_rb = 0 if cut is None else max(128, -(-cut // 128) * 128) * 4
    nb_flat, _, qb_flat, pad = jfs._packed_layout(n_phys, d, n_buckets, qb, db_tile, batch=b,
                                                  scratch_row_bytes=cut_rb)
    if qb_flat == 0 or qb_flat < min(b, qb):
        return ("hier", 1 << max(7, (n_buckets - 1).bit_length()), cut)
    return ("packed", nb_flat, n_phys + pad, cut)


@pytest.mark.parametrize(
    "n,b,kk,want",
    [(200_000, 1000, 40, ("packed", 1024)),  # the 200k bench point
     (200_000, 2048, 40, ("hier", 512)),     # two query blocks starve the flat fold
     (200_000, 2048, 20, ("hier", 512)),     # the bench's B = 2048 headline point
     (1_000_000, 1000, 40, ("hier", 512)),   # flat layout NB = 4096, qb 288 < 1000
     (1_000_000, 1000, 80, ("hier", 512)),
     (200_000, 1000, 20, ("packed", 1024)),
     (5000, 16, 40, ("packed", 512)),
     (300_000, 8, 40, ("packed", 2048))],
)
def test_plan_packed_search_routes_like_the_reference(n, b, kk, want):
    n_phys = n + (-n) % 4096
    plan = tfs.plan_packed_search(n_phys, n, 128, b, 512, kk)
    ref = _jax_route(n_phys, n, 128, b, 512, kk)
    assert (plan.fold, plan.nb) == want
    assert plan.fold == ref[0] and plan.nb == ref[1]
    assert plan.cut_kk == (kk if kk <= 64 else None) == ref[-1]
    assert plan.n_scan % plan.nb == 0 and plan.n_scan >= n_phys
    if plan.fold == "packed":
        assert plan.n_scan == ref[2] and plan.n_scan <= 256 * plan.nb


@pytest.mark.parametrize(
    "n,d,nb,qb,tile,b,rb",
    [(1_000_000, 128, 512, 1024, 2048, None, 0), (4_000_000, 128, 1024, 1024, 2048, None, 0),
     (262_145, 128, 512, 1024, 2048, 1000, 512), (10_000_000, 128, 1024, 1024, 2048, None, 0),
     (200_704, 128, 512, 1024, 2048, 2048, 512), (150, 16, 512, 64, 8192, 4, 0)],
)
def test_packed_layout_matches_the_reference(n, d, nb, qb, tile, b, rb):
    assert tfs._packed_layout(n, d, nb, qb, tile, batch=b, scratch_row_bytes=rb) == \
        jfs._packed_layout(n, d, nb, qb, tile, batch=b, scratch_row_bytes=rb)
    assert tfs._fit_query_block(qb, tile, nb, d, state_bytes=8, itemsize=1, batch=b,
                                scratch_row_bytes=rb) == \
        jfs._fit_query_block(qb, tile, nb, d, state_bytes=8, itemsize=1, batch=b,
                             scratch_row_bytes=rb)


def test_plan_serves_brute_force_where_no_block_fits():
    # NB = 8192 (k = 100) at D = 1024: the int8 input tiles alone overflow the
    # reference's VMEM budget, whatever the query block
    assert tfs.plan_packed_search(8192, 5000, 1024, 4, 8192, 400).fold == "brute"
    assert tfs.plan_packed_search(4096, 300, 256, 4, 512, 40).fold == "brute"  # D > 192


# --- a table built by the port ------------------------------------------------


def test_port_built_table_serves_the_same_results():
    """The port's own table differs from the JAX one only in nf (f32 sums in
    another order, rtol 1e-6), which can move nint by 1 and with it a
    near-tie winner. So the final top-k after the exact rerank is held to
    equality on >= 99% of (query, rank) slots and recall within 0.002."""
    from diskrag_tpu.ops.distance import brute_force_topk

    pts, q = _data(20_000, 64, 64, seed=12)
    v = jnp.asarray(pts)
    jc, jnf, js, n = jfs.build_packed_scan_table(v)
    jd, ji = jfs.flat_search_fused(
        jnp.asarray(q), jc, jnp.sum(jnp.square(v), -1), v, k=10, interpret=True,
        db_scale_global=js, db_nf=jnf, n_valid=n)
    tc, tnf, ts, tn = tfs.build_packed_scan_table(_t(pts))
    td, ti = tfs.flat_search_fused(
        _t(q), tc, torch.sum(_t(pts) ** 2, -1), _t(pts), k=10,
        db_scale_global=ts, db_nf=tnf, n_valid=tn)
    ji, ti = np.asarray(ji), ti.numpy()
    assert np.mean(ji == ti) >= 0.99
    _, gt = brute_force_topk(jnp.asarray(q), v, k=10)
    gt = np.asarray(gt)

    def recall(ids):
        return np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, gt)])

    assert abs(recall(ji) - recall(ti)) <= 0.002
    assert recall(ti) >= 0.97


@pytest.mark.parametrize("scan", ["rowscan", "packed", "hier", "hier_cut"])
def test_rows_aligned_ahead_give_the_same_scan(scan):
    # FlatIndex widens the table rows to 16 bytes once (zero columns); the
    # wrappers widen the query codes to match, and every rule that depends
    # on D (NB, pad rows, which fold) goes on taking the queries' D
    pts, q = _data(3000, 36, 7, seed=15)
    if scan == "rowscan":
        codes, block, _, n = tfs.build_rowscan_table(_t(pts))
        qc, qs = tfs.quantize_int8(_t(q))
        run = lambda db: tfs.scan_bucketed_topk(  # noqa: E731
            qc, db, block, n_buckets=256, q_scales=qs, n_valid=n)
    else:
        codes, nf, scale, n = tfs.build_packed_scan_table(_t(pts))
        qc, qs = tfs.quantize_int8_global(_t(q))
        fn = tfs.scan_bucketed_topk_packed if scan == "packed" else tfs.scan_bucketed_topk_hier
        cut = 20 if scan == "hier_cut" else None
        run = lambda db: fn(qc, qs, db, nf, scale, n_buckets=256, n_valid=n,  # noqa: E731
                            cut_kk=cut)
    wide = tfs.align_code_rows(codes)
    assert wide.shape == (codes.shape[0], 48) and not wide[:, 36:].any()
    assert tfs.align_code_rows(wide) is wide
    (s0, i0), (s1, i1) = run(codes), run(wide)
    assert torch.equal(i0, i1) and (s0 is None or torch.equal(s0, s1))
    with pytest.raises(ValueError, match="wider"):
        run(codes[:, :32])


@pytest.mark.cuda
def test_packed_kernels_match_plain_versions_on_card():
    """Run with `pytest -m cuda` on a machine with a card: B2, B3, B6 and
    both fused cuts are bit-identical to their plain versions, at row widths
    of one and two K boxes (16 to 192 bytes), at batches that leave a
    warpgroup partly empty, and over 70,000 rows, which B3 at NB 128 walks
    in 547 segments (a ragged third super-tile)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    for n, d, b in ((20_000, 128, 200), (5000, 44, 33), (70_000, 16, 1), (70_000, 48, 37),
                    (70_000, 64, 65), (70_000, 144, 193), (70_000, 192, 64)):
        pts, q = _data(n, d, b, seed=13)
        pts[n // 2 :] = pts[: n - n // 2]
        codes, nf, scale, nv = tfs.build_packed_scan_table(_t(pts).to(dev))
        qc, qs = tfs.quantize_int8_global(_t(q).to(dev))
        for nb in (128, 512):
            for cut in (None, 20, 40):
                kw = dict(n_buckets=nb, query_block=1024, db_tile=2048, n_valid=nv, cut_kk=cut)
                sk, ik = tfs.scan_bucketed_topk_packed(qc, qs, codes, nf, scale, **kw)
                sr, ir = tfs.scan_bucketed_topk_packed_ref(
                    *tfs._packed_fold_operands(qc, qs, codes, nf, scale, **kw))
                assert torch.equal(ik, ir) and (cut is not None or torch.equal(sk, sr))
                sk, ik = tfs.scan_bucketed_topk_hier(qc, qs, codes, nf, scale, **kw)
                sr, ir = tfs.scan_bucketed_topk_hier_ref(
                    *tfs._hier_fold_operands(qc, qs, codes, nf, scale, pipelined=False, **kw))
                assert torch.equal(ik, ir) and (cut is not None or torch.equal(sk, sr))
                if cut is None:
                    sp, ip = tfs.scan_bucketed_topk_hier(qc, qs, codes, nf, scale, n_buckets=nb,
                                                         n_valid=nv, pipelined=True)
                    assert torch.equal(sp, sk) and torch.equal(ip, ik)


@pytest.mark.cuda
def test_pipelined_kernel_matches_b3_and_plain_version_on_card():
    """Run with `pytest -m cuda` on a machine with a card: B6's ping-pong
    kernel against B3 (an independent partial kernel, the same tile) and
    against its plain version, bit-identical, at row widths of one and two
    K boxes, at batches that leave its second consumer warpgroup empty or
    partly filled, and over 70,000 rows (547 segments at NB 128); one
    launch a call, counted as B6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    tfs.reset_launch_counts()
    calls = 0
    for n, d, b in ((70_000, 16, 1), (70_000, 48, 65), (70_000, 128, 129), (20_000, 144, 1000),
                    (70_000, 192, 37)):
        pts, q = _data(n, d, b, seed=29)
        pts[n // 2 :] = pts[: n - n // 2]
        codes, nf, scale, nv = tfs.build_packed_scan_table(_t(pts).to(dev))
        qc, qs = tfs.quantize_int8_global(_t(q).to(dev))
        for nb in (128, 512):
            kw = dict(n_buckets=nb, db_tile=min(2048, 2 * nb), n_valid=nv)
            sp, ip = tfs.scan_bucketed_topk_hier(qc, qs, codes, nf, scale, pipelined=True, **kw)
            calls += 1
            s3, i3 = tfs.scan_bucketed_topk_hier(qc, qs, codes, nf, scale, **kw)
            sr, ir = tfs.scan_bucketed_topk_hier_ref(
                *tfs._hier_fold_operands(qc, qs, codes, nf, scale, query_block=1024,
                                         pipelined=True, cut_kk=None, **kw))
            assert torch.equal(sp, s3) and torch.equal(ip, i3), (n, d, b, nb)
            assert torch.equal(sp, sr) and torch.equal(ip, ir), (n, d, b, nb)
    assert tfs.scan_bucketed_topk_hier.launches_pipelined == calls


@pytest.mark.cuda
def test_b6_refuses_a_build_whose_registers_differ_from_its_split(tmp_path, monkeypatch):
    """Run with `pytest -m cuda` on a machine with a card: every
    instantiation of B6's partial kernel has the registers a thread that
    its `setmaxnreg` split assumes at launch; a build whose split assumes
    8 more (`-DPINGPONG_LAUNCH_REGS`) is refused before anything is
    launched, with an error that names both counts, where its consumers'
    `setmaxnreg.inc` would otherwise wait forever."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; kernels have no CPU mode")
    import ctypes
    import subprocess

    from diskrag_tpu_torch.kernels import _build

    lib = _build.load("hier_scan")
    want = lib.hier_scan_pipelined_launch_regs()
    assert [lib.hier_scan_pipelined_kernel_regs(rb) for rb in (64, 128, 192)] == [want] * 3
    so = tmp_path / "hier_scan.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-DPINGPONG_LAUNCH_REGS={want + 8}",
                    "-o", str(so), str(_build.CSRC / "hier_scan.cu")],
                   check=True, capture_output=True, timeout=600)
    variant = ctypes.CDLL(str(so))
    assert variant.hier_scan_pipelined_kernel_regs(128) == want
    monkeypatch.setitem(_build._libs, "hier_scan", variant)
    monkeypatch.setattr(tfs, "_c_functions", {})
    dev = torch.device("cuda", 0)
    pts, q = _data(20_000, 128, 65, seed=31)
    codes, nf, scale, nv = tfs.build_packed_scan_table(_t(pts).to(dev))
    qc, qs = tfs.quantize_int8_global(_t(q).to(dev))
    kw = dict(n_buckets=128, db_tile=256, n_valid=nv)
    with pytest.raises(RuntimeError, match=f"built with {want} registers.*assumes {want + 8}"):
        tfs.scan_bucketed_topk_hier(qc, qs, codes, nf, scale, pipelined=True, **kw)
    torch.cuda.synchronize()
    # B3, from the same library, still runs
    tfs.scan_bucketed_topk_hier(qc, qs, codes, nf, scale, **kw)
    torch.cuda.synchronize()
