"""The port's scan (B1), cut (B4) and per-row fused search held against
the JAX package on the same inputs, made by numpy from a seed. The JAX
side runs its Pallas kernels in interpret mode; the port's side runs the
plain PyTorch versions (the tensors lie on the CPU). A last test, marked
`cuda`, holds the CUDA kernels against the plain versions on a card."""

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


def test_quantize_int8_bit_identical():
    x, _ = _data(500, 48, 1, seed=1)
    x[7] = 0.0  # zero rows take scale 0 and codes 0
    x[9, 3] = 1e-30
    jc, js = jfs.quantize_int8(jnp.asarray(x))
    tc, ts = tfs.quantize_int8(_t(x))
    assert np.array_equal(np.asarray(jc), tc.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_build_rowscan_table_matches(metric):
    x, _ = _data(5000, 32, 1, seed=2)
    jc, jb, js, jn = jfs.build_rowscan_table(jnp.asarray(x), metric=metric)
    tc, tb, ts, tn = tfs.build_rowscan_table(_t(x), metric=metric)
    assert jn == tn == 5000 and tc.shape == (8192, 32) and tb.shape == (2, 8192)
    assert np.array_equal(np.asarray(jc), tc.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())
    jb, tb = np.asarray(jb), tb.numpy()
    assert np.array_equal(jb[1], tb[1])  # scales (doubled for L2), 0 pads
    assert np.isinf(tb[0, 5000:]).all()
    # row-0 norms: both sum x*x in f32, XLA and PyTorch in another order,
    # so they agree to f32 rounding (a few ulp), not bit for bit
    np.testing.assert_allclose(tb[0, :5000], jb[0, :5000], rtol=1e-6)


def _scan_inputs(n, d, b, metric, seed):
    """JAX-built table + query codes, as numpy, shared by both sides."""
    pts, q = _data(n, d, b, seed)
    if metric == "cosine":
        pts = pts / np.linalg.norm(pts, axis=1, keepdims=True)
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    codes, block, scales, nv = jfs.build_rowscan_table(jnp.asarray(pts), metric=metric)
    qc, qs = jfs.quantize_int8(jnp.asarray(q))
    return [np.asarray(a) for a in (codes, block, scales, qc, qs)] + [nv, pts]


@pytest.mark.parametrize(
    "metric,n,nb,table",
    [("l2", 3000, 256, True), ("cosine", 3000, 256, True), ("dot", 3000, 256, True),
     ("l2", 2500, 512, False), ("dot", 150, 512, False)],
)
def test_scan_int8_matches_jax(metric, n, nb, table):
    codes, block, scales, qc, qs, nv, pts = _scan_inputs(n, 32, 24, metric, seed=3)
    use_norms = metric == "l2"
    if table:
        args = dict(db=codes, norms=block, extra=dict(n_valid=nv))
    else:  # the unpadded contract: rows, [N] norms and [N] scales
        norms = np.sum(pts * pts, -1).astype(np.float32)
        args = dict(db=codes[:n], norms=norms, extra=dict(db_scales=scales))
    jv, ji = jfs.scan_bucketed_topk(
        jnp.asarray(qc), jnp.asarray(args["db"]), jnp.asarray(args["norms"]),
        n_buckets=nb, use_norms=use_norms, interpret=True, q_scales=jnp.asarray(qs),
        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in args["extra"].items()},
    )
    tv, ti = tfs.scan_bucketed_topk(
        _t(qc), _t(args["db"]), _t(args["norms"]), n_buckets=nb,
        use_norms=use_norms, q_scales=_t(qs),
        **{k: (_t(v) if isinstance(v, np.ndarray) else v)
           for k, v in args["extra"].items()},
    )
    jv, ji = np.asarray(jv), np.asarray(ji)
    assert ti.shape == ji.shape
    assert np.array_equal(ji, ti.numpy())
    # XLA's CPU backend may contract cross*qs*ds - norm into FMAs; the
    # port rounds after every operation (as its CUDA kernel does). That
    # moves a score by an ulp of its operands, not of the (cancelled)
    # result: 1e-6 relative to the largest operand
    norms = np.asarray(args["norms"])
    norms = norms[0] if norms.ndim == 2 else norms
    scale = max(np.abs(jv[np.isfinite(jv)]).max(), norms[np.isfinite(norms)].max())
    np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-6, atol=1e-6 * scale)


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_scan_bf16_matches_jax(metric):
    pts, q = _data(3000, 32, 24, seed=4)
    if metric == "cosine":
        pts = pts / np.linalg.norm(pts, axis=1, keepdims=True)
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    norms = np.sum(pts * pts, -1).astype(np.float32)
    jq, jdb = jnp.asarray(q, jnp.bfloat16), jnp.asarray(pts, jnp.bfloat16)
    use_norms = metric == "l2"
    jv, ji = jfs.scan_bucketed_topk(
        jq, jdb, jnp.asarray(norms), n_buckets=256, use_norms=use_norms, interpret=True,
    )
    tq, tdb = _t(q).to(torch.bfloat16), _t(pts).to(torch.bfloat16)
    tv, ti = tfs.scan_bucketed_topk(tq, tdb, _t(norms), n_buckets=256, use_norms=use_norms)
    jv, ji, tv, ti = np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy()
    np.testing.assert_allclose(tv, jv, rtol=1e-2, atol=1e-2)
    # ids agree except where the two winners' exact scores tie closely
    qf, dbf = tq.float().numpy().astype(np.float64), tdb.float().numpy().astype(np.float64)

    def score(b, i):
        c = (2.0 if use_norms else 1.0) * qf[b] @ dbf[i]
        return c - norms[i] if use_norms else c

    bad = np.argwhere(ji != ti)
    assert len(bad) <= 0.01 * ji.size
    for b, lane in bad:
        s1, s2 = score(b, ji[b, lane]), score(b, ti[b, lane])
        assert abs(s1 - s2) <= 1e-3 * max(1.0, abs(s1)), (b, lane, s1, s2)


def test_topk_lanes_matches_jax():
    rng = np.random.default_rng(5)
    s = rng.normal(size=(40, 512)).astype(np.float32)
    s[:10] = rng.integers(0, 4, size=(10, 512))  # heavy ties
    s[10:20, 30:] = -np.inf  # rows with 30 finite lanes: sentinel after
    s[20] = -np.inf  # exhausted from the start
    s[21, ::2] = -np.inf
    for kk, block in ((40, s), (5, s[:, :128]), (64, s)):
        j = np.asarray(jfs.topk_lanes_pallas(jnp.asarray(block), kk, interpret=True))
        t = tfs.topk_lanes(_t(block), kk).numpy()
        assert np.array_equal(j, t), kk
    assert (t[20] == 512).all() and (t[10, 30:] == 512).all()


def _fused_pair(pts, q, metric, k, **kw):
    """JAX flat_search_fused (interpret) and the port's on one JAX-built
    int8 table."""
    src = pts / np.linalg.norm(pts, axis=1, keepdims=True) if metric == "cosine" else pts
    codes, block, scales, nv = jfs.build_rowscan_table(jnp.asarray(src), metric=metric)
    jd, ji = jfs.flat_search_fused(
        jnp.asarray(q), codes, block, jnp.asarray(pts), k=k, metric=metric,
        interpret=True, db_scales=scales, n_valid=nv, **kw,
    )
    td, ti = tfs.flat_search_fused(
        _t(q), _t(codes), _t(block), _t(pts), k=k, metric=metric,
        db_scales=_t(scales), n_valid=nv, **kw,
    )
    return np.asarray(jd), np.asarray(ji), td.numpy(), ti.numpy()


@pytest.mark.parametrize(
    "metric,n,k,kw",
    [("l2", 4000, 10, {}), ("cosine", 4000, 10, {}), ("dot", 4000, 10, {}),
     ("l2", 4000, 5, {"rerank_width": 12}),
     ("l2", 6000, 20, {})],  # k=20 widens NB to 1024 and cuts kk=80 lanes
)
def test_flat_search_fused_matches_jax(metric, n, k, kw):
    pts, q = _data(n, 32, 16, seed=6)
    jd, ji, td, ti = _fused_pair(pts, q, metric, k, **kw)
    assert np.array_equal(ji, ti)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["k_over_effective_nb", "no_tpu_block_fits"])
def test_flat_search_fused_brute_force_fallbacks(case, monkeypatch):
    # k > effective NB: 150 rows shrink NB to 128 < k = 130.
    # No VMEM fit: k = 100 widens NB to 8192, whose int8 input tiles at
    # D = 1024 overflow a TPU's scoped VMEM at every query block.
    n, d, k = (150, 16, 130) if case == "k_over_effective_nb" else (5000, 1024, 100)
    pts, q = _data(n, d, 4, seed=7)

    def no_scan(*a, **kw):
        raise AssertionError("the brute-force rule should have served this")

    monkeypatch.setattr(tfs, "scan_bucketed_topk", no_scan)
    jd, ji, td, ti = _fused_pair(pts, q, "l2", k)
    assert np.array_equal(ji, ti)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-3)


def _lexsort_cut(s, kk):
    """An independent cut: per row, lanes by (value desc, lane asc) through
    np.lexsort, the -inf lanes replaced by the sentinel NB, padded with NB
    to kk places. -0.0 and +0.0 compare equal here as in the kernels."""
    b, nb = s.shape
    out = np.full((b, kk), nb, dtype=np.int32)
    for r in range(b):
        v = s[r].astype(np.float64) + 0.0  # -0.0 + 0.0 == +0.0
        order = np.lexsort((np.arange(nb), -v))[: min(kk, nb)]
        order = np.where(np.isneginf(v[order]), nb, order)
        out[r, : order.shape[0]] = order
    return out


def _cut_block(case, rng):
    if case == "build_shape":  # the graph build's NB and kk, fewer rows
        return rng.normal(size=(6, 4096)).astype(np.float32), 260
    if case == "kk_over_nb":
        s = rng.normal(size=(5, 512)).astype(np.float32)
        s[1, 100:] = -np.inf
        return s, 700
    if case == "ties":
        return rng.integers(0, 3, size=(6, 1024)).astype(np.float32), 300
    if case == "signed_zeros":
        s = rng.integers(-1, 2, size=(6, 512)).astype(np.float32) * 0.0  # +-0.0
        s[:, ::5] = -0.0
        s[2, 50:] = -np.inf
        return s, 40
    s = rng.normal(size=(4, 512)).astype(np.float32)  # "all_neg_inf"
    s[[0, 2]] = -np.inf
    return s, 64


@pytest.mark.parametrize("case", ["build_shape", "kk_over_nb", "ties", "signed_zeros", "all_neg_inf"])
def test_topk_lanes_ref_matches_lexsort(case):
    s, kk = _cut_block(case, np.random.default_rng(11))
    got = tfs.topk_lanes_ref(_t(s), kk).numpy()
    assert got.shape == (s.shape[0], kk)
    assert np.array_equal(got, _lexsort_cut(s, kk))
    if case == "all_neg_inf":
        assert (got[0] == 512).all() and (got[2] == 512).all()


@pytest.mark.parametrize(
    "b,nb,rows,row_bytes",
    [(1000, 512, 1_003_520, 128), (4096, 4096, 200_704, 128), (1, 512, 1_003_520, 128),
     (37, 128, 3000, 48), (130, 512, 4000, 1536), (100, 128, 2000, 3072), (64, 200, 4097, 16),
     # bf16 rows (2 * D bytes): D = 128 at 1M and 200k, D = 36 (80-byte aligned rows),
     # D = 768, D = 1536 (query boxes streamed)
     (1000, 512, 1_000_000, 256), (1000, 512, 200_000, 256), (37, 128, 3000, 80),
     (70, 512, 5000, 1536), (130, 512, 4001, 3072)],
)
def test_plan_rowscan_covers_every_query_lane_segment_once(b, nb, rows, row_bytes):
    plan = tfs.plan_rowscan(b, nb, rows, row_bytes, sms=132)
    n_kb = -(-row_bytes // 128)
    fits = [c for c in range(1, min(3, -(-b // 64)) + 1)
            if tfs._rowscan_smem_bytes(c, n_kb, False) <= 227 * 1024]
    # the most warpgroups the batch fills whose query boxes stay resident;
    # streamed only where not even one warpgroup's fit
    assert (plan.n_cons, plan.streamed) == ((max(fits), False) if fits else (plan.n_cons, True))
    assert tfs._rowscan_smem_bytes(plan.n_cons, n_kb, plan.streamed) <= 227 * 1024
    n_seg = -(-rows // nb)
    assert plan.n_seg == n_seg
    # the splits: contiguous, in segment order, non-empty, covering all
    splits = [(z * plan.seg_per_split, min(n_seg, (z + 1) * plan.seg_per_split))
              for z in range(plan.n_split)]
    assert splits[0][0] == 0 and splits[-1][1] == n_seg
    assert all(lo < hi for lo, hi in splits)
    assert all(a[1] == b_[0] for a, b_ in zip(splits, splits[1:]))
    # every (query, lane) pair is owned by exactly one (query tile, lane tile)
    bq = plan.block_queries
    qcount = np.zeros(b, dtype=np.int64)
    for x in range(plan.q_tiles):
        qcount[x * bq: min(b, (x + 1) * bq)] += 1
    lcount = np.zeros(nb, dtype=np.int64)
    for y in range(plan.lane_tiles):
        lcount[y * 64: min(nb, (y + 1) * 64)] += 1
    scount = np.zeros(n_seg, dtype=np.int64)
    for lo, hi in splits:
        scount[lo:hi] += 1
    assert (qcount == 1).all() and (lcount == 1).all() and (scount == 1).all()
    assert plan.q_tiles * bq - b < bq and plan.lane_tiles * 64 - nb < 64


@pytest.mark.parametrize(
    "nb,kk,threads,indirect",
    [(512, 40, 128, False), (1024, 40, 128, False), (4096, 260, 256, False),
     (32768, 1316, 512, False), (32768, 40_000, 512, True), (20000, 9000, 512, False)],
)
def test_plan_cut_variant(nb, kk, threads, indirect):
    plan = tfs.plan_cut(nb, kk)
    assert (plan.threads, plan.indirect) == (threads, indirect)
    places = 1 << max(0, min(kk, nb) - 1).bit_length()
    assert plan.smem == 2048 + 4 * (nb + nb % 2) + (2 if indirect else 8) * places
    assert plan.smem <= 226 * 1024


def test_plan_cut_refuses_rows_past_shared_memory():
    with pytest.raises(ValueError):
        tfs.plan_cut(60000, 40000)


def test_tma_norm_rows_widen_unaligned_blocks():
    blk = torch.arange(2 * 4097, dtype=torch.float32).reshape(2, 4097)
    wide = tfs._tma_norm_rows(blk)
    assert wide.shape == (2, 4100) and wide.stride(0) % 4 == 0
    assert torch.equal(wide[:, :4097], blk)
    padded = torch.zeros((2, 4096))
    assert tfs._tma_norm_rows(padded) is padded


def _card_b1_case(d, n, b, nb, metric, seed):
    dev = torch.device("cuda", 0)
    pts, q = _data(n, d, b, seed=seed)
    pts[7] = 0.0  # a zero row: scale 0, so -0.0 cross products
    if metric == "cosine":
        pts = pts / np.maximum(np.linalg.norm(pts, axis=1, keepdims=True), 1e-12)
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    codes, block, _, nv = tfs.build_rowscan_table(_t(pts).to(dev), metric=metric)
    qc, qs = tfs.quantize_int8(_t(q).to(dev))
    kw = dict(n_buckets=nb, use_norms=metric == "l2", q_scales=qs, n_valid=nv)
    vk, ik = tfs.scan_bucketed_topk(qc, codes, block, **kw)
    vr, ir = tfs.scan_bucketed_topk_ref(
        *tfs._scan_operands(qc, codes, block, db_scales=None, **kw))
    torch.cuda.synchronize()
    assert torch.equal(vk, vr) and torch.equal(ik, ir), (d, n, b, nb, metric)
    return vk


def _card_b4_block(case):
    rng = np.random.default_rng(12)
    if case == "ties_zeros_neginf":
        s = rng.integers(-2, 3, size=(64, 512)).astype(np.float32)
        s[s == 0] = -0.0
        s[:, ::7] = 0.0
        s[::3, 100:] = -np.inf
        s[5] = -np.inf
        return s, 40
    if case == "nb32768_kk1316":
        return rng.normal(size=(8, 32768)).astype(np.float32), 1316
    if case == "kk_over_nb":
        s = rng.normal(size=(16, 512)).astype(np.float32)
        s[3, 200:] = -np.inf
        return s, 700
    return rng.normal(size=(4, 32768)).astype(np.float32), 40_000  # "indirect_sort"


@pytest.mark.cuda
@pytest.mark.parametrize("d,n,b,nb", [(36, 3000, 37, 128), (128, 30011, 1000, 512),
                                      (768, 5000, 70, 512)])
def test_b1_bf16_kernel_matches_plain_version_on_card(d, n, b, nb):
    """Run with `pytest -m cuda` on a machine with a card: B1's bf16 form
    (wgmma m64n64k16 bf16, f32 sums in the tensor cores' order) against
    its plain version for all three metrics at D = 36 (rows zero-padded to
    80 bytes), 128 and 768: scores within 1e-5 of the block's largest
    |score|, the same finite entries, ids equal except where two segments
    tie within that tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    for i, metric in enumerate(("l2", "cosine", "dot")):
        pts, q = _data(n, d, b, seed=40 + i)
        if metric == "cosine":
            pts = pts / np.linalg.norm(pts, axis=1, keepdims=True)
            q = q / np.linalg.norm(q, axis=1, keepdims=True)
        tq = _t(q).to(dev).to(torch.bfloat16)
        tdb = _t(pts).to(dev).to(torch.bfloat16)
        norms = _t(np.sum(pts * pts, -1).astype(np.float32)).to(dev)
        kw = dict(n_buckets=nb, use_norms=metric == "l2")
        launches = tfs.scan_bucketed_topk.launches
        vk, ik = tfs.scan_bucketed_topk(tq, tdb, norms, **kw)
        assert tfs.scan_bucketed_topk.launches == launches + 1
        vr, ir = tfs.scan_bucketed_topk_ref(
            *tfs._scan_operands(tq, tdb, norms, q_scales=None, db_scales=None, n_valid=None,
                                **kw))
        torch.cuda.synchronize()
        fin = torch.isfinite(vr)
        assert torch.equal(fin, torch.isfinite(vk)), (d, metric)
        tol = 1e-5 * float(vr[fin].abs().max())
        assert float((vk[fin] - vr[fin]).abs().max()) <= tol, (d, metric)
        near = (vk - vr).abs() <= tol
        assert bool(((ik == ir) | near).all()), (d, metric)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case",
    ["b1:36:3000:37:128", "b1:128:20000:1:512", "b1:128:20000:37:4096",
     "b1:128:30011:1000:512", "b1:128:9000:4096:4096", "b1:128:30000:200:8192",
     "b1:960:5000:70:512", "b1:1536:4000:130:512", "b1:3072:1500:100:128",
     "b4:ties_zeros_neginf", "b4:nb32768_kk1316", "b4:kk_over_nb", "b4:indirect_sort"],
)
def test_kernels_match_plain_versions_on_card(case):
    """Run with `pytest -m cuda` on a machine with a card: B1's wrapper
    (int8, all three metrics) bit-identical to its plain version at row
    widths 36 (zero-padded to 48 bytes), 128, 960, 1536 and 3072 (query
    boxes streamed), ragged batches, tables and NB, with B4 cut from its
    blocks; B4 alone on blocks of ties, signed zeros and -inf rows, at
    NB = 32768 with kk = 1316, with kk > NB, and on its 16-bit sort."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; kernels have no CPU mode")
    kind, *spec = case.split(":")
    if kind == "b1":
        d, n, b, nb = map(int, spec)
        for i, metric in enumerate(("l2", "cosine", "dot")):
            vals = _card_b1_case(d, n, b, nb, metric, seed=20 + i)
            kk = min(260 if nb >= 4096 else 40, nb)
            assert torch.equal(tfs.topk_lanes(vals, kk), tfs.topk_lanes_ref(vals, kk))
        return
    s, kk = _card_b4_block(spec[0])
    sd = _t(s).to("cuda")
    got = tfs.topk_lanes(sd, kk)
    assert torch.equal(got, tfs.topk_lanes_ref(sd, kk))
    assert np.array_equal(got.cpu().numpy(), _lexsort_cut(s, kk))
