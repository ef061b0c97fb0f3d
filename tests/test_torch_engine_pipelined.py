"""`SearchEngine.search_pipelined` of the port against the JAX engine's, on
the CPU: every serving mode on one directory served by both packages, each
pipelined batch against the port's own `search_many`, the JAX contract's
errors, the packed result transfer, `benchmark.best_qps_at_recall`, and
`search_many` called from several threads at once.

The queries are database points moved by unit noise, so a query's
neighbours lie at distances of the order of the data's spread: the two
packages' f32 distance sums round apart by ~1e-6 relative there, inside
the JAX engine test's tolerance (rtol 1e-5, atol 1e-6)."""

import sys
import threading

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # the suite runs several workers: do not let each spin a thread per core

from diskrag_tpu.benchmark import SweepPoint as JaxSweepPoint
from diskrag_tpu.benchmark import best_qps_at_recall as jax_best_qps_at_recall
from diskrag_tpu.engine import SearchEngine as JaxEngine

from diskrag_tpu_torch.benchmark import SweepPoint, best_qps_at_recall, make_dataset
from diskrag_tpu_torch.build_index import build_index_from_vectors
from diskrag_tpu_torch.data.collection import CollectionManager
from diskrag_tpu_torch.engine import SearchEngine, _decode_packed, _enqueue_packed

N, D, K = 2000, 32, 5
MESH = ["cpu"] * 8
# mode -> (collection, serving_mode, use_pq_search, search_type)
MODES = {
    "flat": ("flat", "auto", True, "flat"),
    "vamana_pq": ("vamana", "auto", True, "pq_accelerated"),
    "exact": ("vamana", "auto", False, "exact"),
    "ivf": ("ivf", "auto", True, "ivf"),
    "host_tier": ("vamana", "host_tier", True, "host_tier"),
    "streaming": ("vamana", "streaming", True, "streaming"),
    "sharded": ("sharded", "auto", True, "sharded"),
    "sharded_flat": ("sharded", "sharded_flat", True, "sharded_flat"),
}
BUILDS = {
    "flat": dict(index_type="flat"),
    # residual PQ and the record file: served "pq_accelerated", exact,
    # host tier and streaming
    "vamana": dict(force_pq=True, write_compat=True),
    "ivf": dict(index_type="ivf"),
    "sharded": dict(index_type="sharded", n_shards=4),
}


@pytest.fixture(scope="module")
def data():
    """(points, {text: query vector}, text batches of 3, 2 and 4 rows)."""
    pts, _ = make_dataset(N, D, 1, seed=21)
    rng = np.random.default_rng(5)
    q = pts[rng.integers(0, N, 9)] + rng.normal(size=(9, D)).astype(np.float32)
    texts = [f"query {i}" for i in range(9)]
    return pts, dict(zip(texts, q)), [texts[:3], texts[3:5], texts[5:]]


@pytest.fixture(scope="module")
def built(data, tmp_path_factory):
    """{collection kind: collections base} built by the port, one
    collection "c" (texts "text i") under each."""
    pts = data[0]
    out = {}
    for kind, kw in BUILDS.items():
        base = tmp_path_factory.mktemp(kind)
        mgr = CollectionManager(base)
        mgr.create_collection("c", dimension=D)
        mgr.update_collection("c", pts, [f"text {i}" for i in range(N)],
                              [{"i": i} for i in range(N)])
        build_index_from_vectors(pts, mgr.get_index_dir("c"), device="cpu", **kw)
        out[kind] = base
    return out


def _engine(built, mode, package="port"):
    kind, serving_mode, _, _ = MODES[mode]
    if package == "jax":
        return JaxEngine("c", base_dir=str(built[kind]), serving_mode=serving_mode,
                         run_diagnostics=False)
    return SearchEngine("c", base_dir=str(built[kind]), serving_mode=serving_mode,
                        device="cpu", run_diagnostics=False,
                        mesh_devices=MESH if kind == "sharded" else None)


def _ids_dists(out: dict):
    ids = [[r["metadata"]["vector_index"] for r in row] for row in out["results"]]
    dists = [[r["distance"] for r in row] for row in out["results"]]
    return np.asarray(ids), np.asarray(dists)


@pytest.mark.parametrize("mode", list(MODES))
def test_search_pipelined_matches_jax(built, data, mode):
    _, lut, batches = data
    use_pq = MODES[mode][2]
    ours = _engine(built, mode).search_pipelined(
        batches, k=K, embedding_fn=lut.__getitem__, use_pq_search=use_pq)
    theirs = _engine(built, mode, "jax").search_pipelined(
        batches, k=K, embedding_fn=lut.__getitem__, use_pq_search=use_pq)
    assert len(ours) == len(theirs) == len(batches)
    for texts, got, want in zip(batches, ours, theirs):
        gi, gd = _ids_dists(got)
        wi, wd = _ids_dists(want)
        assert gi.shape == (len(texts), K)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-6)
        assert [r["text"] for r in got["results"][0]] == [f"text {i}" for i in gi[0]]
        assert got["stats"]["search_type"] == want["stats"]["search_type"] == MODES[mode][3]
        assert set(got["timing"]) == set(want["timing"])


@pytest.mark.parametrize("max_in_flight", [1, 2, 8])
@pytest.mark.parametrize("mode", list(MODES))
def test_pipelined_batches_equal_search_many(built, data, mode, max_in_flight):
    _, lut, batches = data
    use_pq = MODES[mode][2]
    eng = _engine(built, mode)
    piped = eng.search_pipelined(batches, k=K, embedding_fn=lut.__getitem__,
                                 use_pq_search=use_pq, max_in_flight=max_in_flight)
    for texts, got in zip(batches, piped):
        want = eng.search_many(texts, k=K, embedding_fn=lut.__getitem__, use_pq_search=use_pq)
        assert got["results"] == want["results"]
        for key in ("search_type", "nodes_visited", "k", "L_search", "rounds"):
            assert got["stats"].get(key) == want["stats"].get(key), key
    # each query counted once by each call
    assert eng.get_search_statistics()["total_searches"] == 2 * sum(map(len, batches))


def test_errors_of_the_jax_contract(built, data):
    _, lut, batches = data
    ours, theirs = _engine(built, "flat"), _engine(built, "flat", "jax")
    wrong_dim = {"q": np.zeros(D + 1, np.float32)}
    for kwargs in (
        dict(query_batches=batches),                                    # no embedding_fn
        dict(query_batches=[], embedding_fn=lut.__getitem__),           # no batch
        dict(query_batches=[batches[0], []], embedding_fn=lut.__getitem__),  # an empty batch
        dict(query_batches=[["q"]], embedding_fn=wrong_dim.__getitem__),  # the dimension
    ):
        for eng in (ours, theirs):
            with pytest.raises(ValueError):
                eng.search_pipelined(k=K, **kwargs)


def test_a_cuda_engine_never_runs_on_the_cpu(built, data):
    """An engine whose device is the card uploads through pinned memory:
    without a card that raises, it does not fall back."""
    _, lut, batches = data
    eng = _engine(built, "flat")
    eng.device = torch.device("cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        eng.search_pipelined(batches, k=K, embedding_fn=lut.__getitem__)


def test_pack_round_trips_ids_distance_bits_and_counters():
    ids = torch.tensor([[2**31 - 1, -1, 0], [7, 2**31 - 2, -1]], dtype=torch.int64)
    dists = torch.tensor([[-0.0, float("inf"), float("nan")],
                          [1.5, -float("inf"), 3.4028235e38]], dtype=torch.float32)
    n_expanded = torch.tensor([5, 9], dtype=torch.int32)
    buf, event = _enqueue_packed(dists, ids, n_expanded, torch.tensor(4, dtype=torch.int32))
    assert event is None and buf.dtype == torch.int32 and buf.shape == (2, 2 * 3 + 2)
    got_d, got_i, counter, n_steps = _decode_packed(buf.numpy(), 3)
    assert got_i.dtype == np.int32
    np.testing.assert_array_equal(got_i, ids.numpy())
    # every distance's bits come back (signed zero, infinities, NaN)
    assert got_d.dtype == np.float64
    assert got_d.astype(np.float32).tobytes() == dists.numpy().tobytes()
    assert (counter, n_steps) == (14, 4)
    # no traversal: both counters 0
    buf, _ = _enqueue_packed(dists, ids)
    assert _decode_packed(buf.numpy(), 3)[2:] == (0, 0)


def test_ids_past_int32_are_refused(built, data):
    _, lut, batches = data
    eng = _engine(built, "flat")
    eng.info.num_vectors = 2**31
    with pytest.raises(OverflowError):
        eng.search_many(batches[0], k=K, embedding_fn=lut.__getitem__)


def test_attach_texts_of_one_row_matches_jax(built):
    ids, dists = np.array([7, -1, 3], np.int32), np.array([0.5, np.inf, 1.25])
    ours = _engine(built, "flat")._attach_texts(ids, dists)
    assert ours == _engine(built, "flat", "jax")._attach_texts(ids, dists)
    assert [r["text"] for r in ours] == ["text 7", "text 3"]


def test_best_qps_at_recall_matches_jax():
    rows = [(16, 0.91, 900.0, "a"), (32, 0.95, 700.0, "b"), (64, 0.99, 400.0, "c"),
            (128, 0.995, 750.0, "d")]
    ours = [SweepPoint(w, r, qps, 1e3 / qps, m) for w, r, qps, m in rows]
    theirs = [JaxSweepPoint(w, r, qps, 1e3 / qps, m) for w, r, qps, m in rows]
    for min_recall in (0.0, 0.95, 0.99, 0.999):
        got = best_qps_at_recall(ours, min_recall)
        want = jax_best_qps_at_recall(theirs, min_recall)
        if want is None:
            assert got is None
        else:
            assert (got.search_width, got.recall, got.qps, got.mode) == (
                want.search_width, want.recall, want.qps, want.mode)
    assert best_qps_at_recall([], 0.5) is None


@pytest.mark.parametrize("mode", ["flat", "vamana_pq"])
def test_search_many_from_four_threads(built, data, mode):
    _, lut, batches = data
    eng = _engine(built, mode)
    want = [eng.search_many(b, k=K, embedding_fn=lut.__getitem__) for b in batches]
    n_before = eng.get_search_statistics()["total_searches"]
    got: dict = {}
    errors: list = []

    def worker(t: int) -> None:
        try:
            for _ in range(3):
                for i, b in enumerate(batches):
                    got[t, i] = eng.search_many(b, k=K, embedding_fn=lut.__getitem__)
        except Exception as e:  # noqa: BLE001 — re-raised below in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # switch threads often, so a lost stats update would show
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    for (t, i), out in got.items():
        assert out["results"] == want[i]["results"], (t, i)
    stats = eng.get_search_statistics()
    assert stats["total_searches"] - n_before == 4 * 3 * sum(map(len, batches))
