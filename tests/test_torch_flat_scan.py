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


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    """Run with `pytest -m cuda` on a machine with a card: B1's wrapper
    (int8) and B4 are bit-identical to their plain versions on the
    operands the wrapper builds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    pts, q = _data(20_000, 128, 200, seed=8)
    for metric in ("l2", "cosine", "dot"):
        codes, block, _, n = tfs.build_rowscan_table(_t(pts).to(dev), metric=metric)
        qc, qs = tfs.quantize_int8(_t(q).to(dev))
        kw = dict(n_buckets=512, use_norms=metric == "l2", q_scales=qs, n_valid=n)
        vk, ik = tfs.scan_bucketed_topk(qc, codes, block, **kw)
        vr, ir = tfs.scan_bucketed_topk_ref(
            *tfs._scan_operands(qc, codes, block, db_scales=None, **kw))
        assert torch.equal(vk, vr) and torch.equal(ik, ir)
        assert torch.equal(tfs.topk_lanes(vk, 40), tfs.topk_lanes_ref(vr, 40))
