"""`FlatIndex(use_fused=False)`, the port's counterpart of the JAX
package's XLA path (`flat_search` over `vectors_bf16`, in query blocks),
and `sweep_flat`'s big-batch point, against the JAX package on the CPU."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # the suite runs several workers: do not let each spin a thread per core

import jax.numpy as jnp

from diskrag_tpu.ops.flat import FlatIndex as JaxFlat

from diskrag_tpu_torch.benchmark import ground_truth, make_dataset, recall_at_k, sweep_flat
from diskrag_tpu_torch.ops import flat as tflat
from diskrag_tpu_torch.ops.flat import FlatIndex


def _bits(x) -> np.ndarray:
    """A bf16 array's bits as uint16, from either package."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _assert_same_results(td, ti, jd, ji):
    """Distances within rtol 1e-5 (atol 1e-5 covers cosine's 1 - cos near
    0, a few ulps of 1.0, as the fused path's parity tests allow) and ids
    equal at every rank whose JAX distance is not within that tolerance
    of a neighbouring rank's: the two packages' f32 reranks sum in other
    orders, so a near-tie may be listed the other way round."""
    td, ti, jd, ji = td.numpy(), ti.numpy(), np.asarray(jd), np.asarray(ji)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)
    tol = 1e-5 + 1e-5 * np.abs(jd)
    tied = (np.diff(jd, axis=1, prepend=-np.inf) <= tol) | (
        np.diff(jd, axis=1, append=np.inf) <= tol)
    np.testing.assert_array_equal(ti[~tied], ji[~tied])
    assert ((ti == ji) | tied).all()


@pytest.mark.parametrize("rerank_width", [None, 24])
@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
@pytest.mark.parametrize("dim", [32, 128])
def test_unfused_search_matches_the_jax_xla_path(dim, metric, rerank_width):
    pts, q = make_dataset(3000, dim, 40, seed=21)
    jidx = JaxFlat(pts, metric=metric, use_fused=False, rerank_width=rerank_width)
    tidx = FlatIndex(pts, metric=metric, use_fused=False, rerank_width=rerank_width,
                     device="cpu")
    assert not jidx.use_fused and not tidx.use_fused
    _assert_same_results(*tidx.search(q, k=10), *jidx.search(jnp.asarray(q), k=10))
    # the chunked path of both packages, on the same index
    _assert_same_results(*tidx.search(q, k=10, chunk=700),
                         *jidx.search(jnp.asarray(q), k=10, chunk=700))


@pytest.mark.parametrize("precision,metric,dim", [("int8", "l2", 32), ("bf16", "l2", 36),
                                                  ("bf16", "cosine", 32), (None, "dot", 36)])
def test_vectors_bf16_is_the_jax_copy_built_at_first_use(precision, metric, dim):
    pts, _ = make_dataset(1000, dim, 4, seed=22)
    kw = {"use_fused": False} if precision is None else {"fused_precision": precision}
    jidx = JaxFlat(pts, metric=metric, use_fused=precision is not None,
                   **({} if precision is None else {"fused_precision": precision}))
    tidx = FlatIndex(pts, metric=metric, device="cpu", **kw)
    shared = precision == "bf16" and metric != "cosine"
    # as in the JAX package, only a non-cosine bf16 scan copy is shared
    assert (tidx._vectors_bf16 is not None) == shared == (jidx._vectors_bf16 is not None)
    got = tidx.vectors_bf16
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == pts.shape
    np.testing.assert_array_equal(_bits(got), _bits(jidx.vectors_bf16))
    assert tidx.vectors_bf16 is got  # built once, then kept
    if shared:  # a view of the aligned scan copy (D = 36 has zero columns appended)
        assert got.data_ptr() == tidx._fused_db.data_ptr()
        assert tidx._fused_db.shape[1] == (40 if dim == 36 else dim)


def test_chunked_search_reuses_the_cached_copy(monkeypatch):
    pts, q = make_dataset(2000, 32, 8, seed=23)
    tidx = FlatIndex(pts, device="cpu")
    assert tidx._vectors_bf16 is None
    seen = []
    real = tflat.flat_search

    def spy(queries, vectors_bf16, *a, **kw):
        seen.append(vectors_bf16)
        return real(queries, vectors_bf16, *a, **kw)

    monkeypatch.setattr(tflat, "flat_search", spy)
    first = tidx.search(q, k=5, chunk=512)
    second = tidx.search(q, k=5, chunk=512)
    assert len(seen) == 2 and seen[0] is seen[1] is tidx.vectors_bf16
    assert torch.equal(first[1], second[1])


def test_unfused_index_builds_no_table_and_reaches_no_fused_scan(monkeypatch):
    from diskrag_tpu_torch.kernels.launches import launch_counts, reset_launch_counts
    from diskrag_tpu_torch.ops import flat_scan

    def refuse(*a, **kw):
        raise AssertionError("flat_search_fused reached")

    monkeypatch.setattr(flat_scan, "flat_search_fused", refuse)
    reset_launch_counts()
    pts, q = make_dataset(2000, 32, 8, seed=24)
    tidx = FlatIndex(pts, use_fused=False, fused_precision="int8_packed", device="cpu")
    assert tidx._fused_db is None and tidx._fused_nf is None and tidx._vectors_bf16 is None
    d, ids = tidx.search(q, k=5)
    assert ids.shape == (8, 5) and bool(torch.isfinite(d).all())
    assert not any(launch_counts().values())
    # the default stays fused on every device
    assert FlatIndex(pts, device="cpu").use_fused
    assert FlatIndex(pts, use_fused=None, device="cpu")._fused_db is not None


def test_query_blocks_follow_the_jax_rule_and_concatenate(monkeypatch):
    # q_block = max(16, min(b, 2**29 // n)), as `diskrag_tpu/ops/flat.py:275`
    assert tflat.bf16_query_block(1000, 1_000_000) == 536
    assert tflat.bf16_query_block(1000, 200_000) == 1000
    assert tflat.bf16_query_block(2048, 10**9) == 16
    pts, q = make_dataset(2000, 32, 40, seed=25)
    tidx = FlatIndex(pts, use_fused=False, device="cpu")
    whole = tidx.search(q, k=10)
    monkeypatch.setattr(tflat, "bf16_query_block", lambda b, n: 16)
    blocked = tidx.search(q, k=10)  # blocks of 16, 16 and 8 queries
    assert torch.equal(whole[1], blocked[1]) and torch.equal(whole[0], blocked[0])


def test_sweep_flat_big_batch_point(monkeypatch):
    pts, q = make_dataset(3000, 32, 64, seed=26)
    gt = ground_truth(pts, q, 10, device="cpu")
    calls = []
    real = FlatIndex.search

    def spy(self, queries, k=10, chunk=None):
        out = real(self, queries, k=k, chunk=chunk)
        calls.append((self.rerank_width, self._fused_nf is not None, len(queries), out[1]))
        return out

    monkeypatch.setattr(FlatIndex, "search", spy)
    points = sweep_flat(pts, q, gt, k=10, big_batch=256, min_seconds=0.01, device="cpu")
    modes = [p.mode for p in points]
    assert modes[:5] == ["flat", "flat-rr24", "flat-packed", "flat-packed-rr24",
                         "flat-packed-b256"]
    assert modes[5].startswith("flat-packed-rr") and modes[5].endswith("-auto")
    big = [c for c in calls if c[2] == 256]
    assert big and all(rw == 20 and packed for rw, packed, _, _ in big)
    monkeypatch.undo()
    tiled = q[np.arange(256) % len(q)]
    direct = FlatIndex(pts, fused_precision="int8_packed", rerank_width=20, device="cpu")
    _, ids = direct.search(tiled, k=10)
    assert all(torch.equal(c[3], ids) for c in big)
    point = points[4]
    assert point.recall == recall_at_k(ids[: len(q)].numpy(), gt, 10)
    # a dot-metric sweep has no packed points, so no big-batch point either
    dot = sweep_flat(pts, q, ground_truth(pts, q, 10, "dot", device="cpu"), k=10, metric="dot",
                     big_batch=256, min_seconds=0.01, device="cpu")
    assert [p.mode for p in dot] == ["flat", "flat-rr24"]
