"""The port's span recorder (`diskrag_tpu_torch/utils/profiling.py`) and
the spans at its layer boundaries, on the CPU: nothing recorded while it
is off, the same answers on and off, one request id through the engine,
the traversal's rounds, the host tier's worker thread, the collector's
pauses, the collection update and the engine's load."""

import collections
import contextvars
import gc
import json
import threading

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # the suite runs several workers: do not let each spin a thread per core

from diskrag_tpu_torch.benchmark import make_dataset
from diskrag_tpu_torch.build_index import build_index_from_vectors
from diskrag_tpu_torch.data.collection import CollectionManager
from diskrag_tpu_torch.engine import SearchEngine
from diskrag_tpu_torch.index.host_tier import HostTierIndex
from diskrag_tpu_torch.utils import profiling

N, D, K = 2000, 32, 5
TIME_KEYS = ("search_time", "fetch_time", "stage_ms", "cache")


@pytest.fixture(autouse=True)
def _off_and_empty():
    profiling.disable()
    profiling.drain()
    profiling.counters(reset=True)
    yield
    profiling.disable()
    profiling.drain()
    profiling.counters(reset=True)


@pytest.fixture(scope="module")
def data():
    """(points, {text: query vector}): 12 queries, database points moved by noise."""
    pts, _ = make_dataset(N, D, 1, seed=31)
    rng = np.random.default_rng(3)
    q = pts[rng.integers(0, N, 12)] + rng.normal(size=(12, D)).astype(np.float32)
    return pts, {f"query {i}": q[i] for i in range(12)}


@pytest.fixture(scope="module")
def base(data, tmp_path_factory):
    """A collection "c" with a Vamana index, int8 rows and the record
    file: served exact, "iq_accelerated" and from the host tier."""
    pts = data[0]
    out = tmp_path_factory.mktemp("tracing")
    mgr = CollectionManager(out)
    mgr.create_collection("c", dimension=D)
    mgr.update_collection("c", pts, [f"text {i}" for i in range(N)], [{"i": i} for i in range(N)])
    build_index_from_vectors(pts, mgr.get_index_dir("c"), device="cpu", force_pq=True,
                             pq_kind="int8", write_compat=True)
    return out


def _engine(base, mode="auto"):
    return SearchEngine("c", base_dir=str(base), serving_mode=mode, device="cpu")


def _plain(stats):
    return {k: v for k, v in stats.items() if k not in TIME_KEYS}


def _tree(records):
    by_id = {r.id: r for r in records}

    def ancestors(r):
        out = []
        while r.parent is not None:
            r = by_id[r.parent]
            out.append(r.name)
        return out

    return by_id, ancestors


def test_off_records_nothing_and_hands_out_one_shared_noop(base, data):
    assert not profiling.enabled()
    s = profiling.span("graph.round", step=3)
    assert s is profiling.span("engine.join") is profiling.request("engine.request", batch=1)
    with s as inside:
        assert inside is None
    profiling.count("graph.rounds", 5)
    eng = _engine(base)
    lut = data[1]
    eng.search_many(list(lut)[:3], k=K, embedding_fn=lut.__getitem__, use_pq_search=False)
    assert profiling.drain() == [] and profiling.counters() == {}


@pytest.mark.parametrize("use_pq", [False, True], ids=["exact", "iq"])
def test_search_many_answers_the_same_on_and_off(base, data, use_pq):
    eng = _engine(base)
    lut = data[1]
    texts = list(lut)

    def run():
        out = eng.search_many(texts, k=K, embedding_fn=lut.__getitem__, l_search=24,
                              use_pq_search=use_pq)
        return out["results"], _plain(out["stats"])

    off = run()
    with profiling.tracing():
        on = run()
    assert on == off
    assert profiling.drain()


def test_host_tier_pipelined_answers_the_same_on_and_off(base, data):
    tier = HostTierIndex.from_store(CollectionManager(base).get_index_dir("c"), device="cpu")
    q = np.stack(list(data[1].values()))
    off = tier.search_pipelined(q, search_width=24, k=K, chunk=5, expand_width=4)
    with profiling.tracing():
        on = tier.search_pipelined(q, search_width=24, k=K, chunk=5, expand_width=4)
    np.testing.assert_array_equal(on[0], off[0])
    np.testing.assert_array_equal(on[1], off[1])
    assert _plain(on[2]) == _plain(off[2]) and on[2]["pipelined_chunks"] == 3
    names = collections.Counter(r.name for r in profiling.drain())
    assert names["host_tier.traverse"] == names["host_tier.rerank"] == 3
    assert names["host_tier.pool_copy"] == 3 and names["host_tier.rerank_wait"] == 1
    for piece in ("unique", "gather", "products", "select"):
        assert names[f"host_tier.rerank.{piece}"] == 3
    assert profiling.counters()["host_tier.vectors_fetched"] == on[2]["host_vectors_fetched"]


def test_one_request_root_per_request_and_its_spans_inside_it(base, data):
    eng = _engine(base)
    lut = data[1]
    texts = list(lut)
    with profiling.tracing():
        for i in range(3):
            eng.search_many(texts[4 * i : 4 * i + 4], k=K, embedding_fn=lut.__getitem__,
                            use_pq_search=False)
    recs = profiling.drain()
    roots = [r for r in recs if r.name == "engine.request"]
    assert len(roots) == 3 and all(r.parent is None for r in roots)
    assert len({r.request for r in roots}) == 3
    assert all(r.attrs == {"batch": 4, "mode": "auto"} for r in roots)
    by_id, ancestors = _tree(recs)
    for r in recs:
        assert r.request in {x.request for x in roots}
        if r.name != "engine.request":
            assert by_id[r.parent].request == r.request and ancestors(r)[-1] == "engine.request"
    children = {by_id[r.id].name for r in recs if r.parent == roots[0].id and r.name != "gc"}
    assert children == {"engine.embed", "engine.prep", "engine.dispatch", "engine.fetch",
                        "engine.join"}
    join = next(r for r in recs if r.name == "engine.join" and r.request == roots[0].request)
    assert {r.name for r in recs if r.parent == join.id} >= {"engine.join.lookup",
                                                             "engine.join.build"}


def test_rounds_equal_the_loop_iterations_with_one_sync_each(base, data):
    eng = _engine(base)
    lut = data[1]
    with profiling.tracing():
        out = eng.search_many(list(lut), k=K, embedding_fn=lut.__getitem__, l_search=24,
                              use_pq_search=False)
    recs = profiling.drain()
    n = profiling.counters()
    rounds = [r for r in recs if r.name == "graph.round"]
    assert len(rounds) == n["graph.iterations"] and n["graph.rounds"] == out["stats"]["rounds"]
    # the last iteration stops at its sync: one more iteration than rounds
    assert n["graph.iterations"] == n["graph.rounds"] + 1
    assert [r.attrs["step"] for r in rounds] == list(range(len(rounds)))
    per_round = collections.Counter(r.parent for r in recs if r.name == "graph.round.sync")
    assert all(per_round[r.id] == 1 for r in rounds) and len(per_round) == len(rounds)
    dispatch = next(r for r in recs if r.name == "engine.dispatch")
    seed = [r for r in recs if r.name == "graph.seed"]
    assert len(seed) == 1 and seed[0].parent == dispatch.id
    assert all(r.parent == dispatch.id for r in rounds)
    assert sum(r.end_ns - r.start_ns for r in rounds) <= dispatch.end_ns - dispatch.start_ns


def test_rerank_worker_spans_carry_the_request(base, data):
    eng = _engine(base, "host_tier")
    eng.host_tier_pipeline_chunk = 4  # 12 queries: pipelined in two chunks of 6
    lut = data[1]
    with profiling.tracing():
        out = eng.search_many(list(lut), k=K, embedding_fn=lut.__getitem__, l_search=24)
    assert out["stats"]["pipelined_chunks"] == 2
    recs = profiling.drain()
    root = next(r for r in recs if r.name == "engine.request")
    by_id, _ = _tree(recs)
    main = root.thread
    reranks = [r for r in recs if r.name == "host_tier.rerank"]
    assert [r.attrs["chunk"] for r in reranks] == [0, 1]
    assert all(r.thread != main and r.request == root.request for r in reranks)
    pieces = [r for r in recs if r.name.startswith("host_tier.rerank.")]
    assert len(pieces) == 8
    for r in pieces:
        assert r.thread != main and r.request == root.request
        assert by_id[r.parent].name == "host_tier.rerank"
    trav = [r for r in recs if r.name == "host_tier.traverse"]
    assert [r.attrs["chunk"] for r in trav] == [0, 1] and all(r.thread == main for r in trav)


def test_a_collection_inside_the_join_is_a_gc_span_under_it(base, data, monkeypatch):
    eng = _engine(base)
    lut = data[1]
    lookup = eng.manager.get_texts_by_indices

    def collecting(*a, **kw):
        gc.collect()
        return lookup(*a, **kw)

    monkeypatch.setattr(eng.manager, "get_texts_by_indices", collecting)
    with profiling.tracing():
        eng.search_many(list(lut)[:2], k=K, embedding_fn=lut.__getitem__, use_pq_search=False)
    recs = profiling.drain()
    _, ancestors = _tree(recs)
    forced = [r for r in recs if r.name == "gc" and r.attrs["generation"] == 2]
    assert forced and all("engine.join" in ancestors(r) for r in forced)
    root = next(r for r in recs if r.name == "engine.request")
    assert all(r.request == root.request for r in forced)
    s = profiling.summary(recs)
    look = next(r for r in recs if r.name == "engine.join.lookup")
    gc_ms = sum(r.end_ns - r.start_ns for r in forced) / 1e6
    assert s["engine.join.lookup"]["self_ms"] == pytest.approx(
        (look.end_ns - look.start_ns) / 1e6 - gc_ms, abs=1e-6)


def test_update_collection_records_one_rows_span_and_the_row_counters(tmp_path, data):
    pts = data[0][:50]
    mgr = CollectionManager(tmp_path)
    mgr.create_collection("u", dimension=D)
    mgr.update_collection("u", pts[:20], [f"t {i}" for i in range(20)], [{}] * 20)
    with profiling.tracing():
        info = mgr.update_collection("u", pts[10:50], [f"t {i}" for i in range(10, 50)],
                                     [{"i": i} for i in range(40)])
    assert info.num_vectors == 50
    recs = profiling.drain()
    names = collections.Counter(r.name for r in recs if r.name != "gc")
    assert names == {"collection.update": 1, "collection.rows": 1,
                     "collection.vectors_write": 1, "collection.metadata_write": 1,
                     "collection.info_write": 1}
    top = next(r for r in recs if r.name == "collection.update")
    assert all(r.parent == top.id for r in recs if r.name.startswith("collection.")
               and r is not top)
    assert profiling.counters() == {"collection.rows_added": 30,
                                    "collection.rows_duplicate": 10}


def test_engine_load_spans(base):
    with profiling.tracing():
        _engine(base)
    recs = profiling.drain()
    load = [r for r in recs if r.name == "engine.load"]
    assert len(load) == 1 and load[0].parent is None and load[0].request is None
    kids = {r.name for r in recs if r.parent == load[0].id and r.name != "gc"}
    assert kids == {"engine.load_artifacts", "engine.diagnostic"}
    # the diagnostic's self-check search runs its traversal inside it
    diag = next(r for r in recs if r.name == "engine.diagnostic")
    _, ancestors = _tree(recs)
    assert any(r.name == "graph.round" and diag.name in ancestors(r) for r in recs)


def test_pipelined_batches_are_requests_whose_drain_carries_their_id(base, data):
    eng = _engine(base)
    lut = data[1]
    texts = list(lut)
    batches = [texts[:3], texts[3:7], texts[7:]]
    with profiling.tracing():
        out = eng.search_pipelined(batches, k=K, embedding_fn=lut.__getitem__,
                                   use_pq_search=False, max_in_flight=2)
    assert [len(o["results"]) for o in out] == [3, 4, 5]
    recs = profiling.drain()
    roots = [r for r in recs if r.name == "engine.request"]
    assert [r.attrs["batch"] for r in roots] == [3, 4, 5] and len({r.request for r in roots}) == 3
    for root in roots:
        kids = {r.name for r in recs if r.parent == root.id and r.name != "gc"}
        assert kids == {"engine.embed", "engine.prep", "engine.dispatch", "engine.fetch",
                        "engine.join"}
        fetch = next(r for r in recs if r.name == "engine.fetch" and r.parent == root.id)
        assert fetch.thread != root.thread


def test_summary_drain_counters_and_the_buffer_bound(monkeypatch):
    with profiling.tracing():
        with profiling.request("outer", tag=1):
            with profiling.span("inner"):
                pass
            with profiling.span("inner"):
                pass
        profiling.count("c")
        profiling.count("c", 4)
    s = profiling.summary()
    assert s["inner"]["count"] == 2 and s["outer"]["count"] == 1
    assert s["outer"]["self_ms"] == pytest.approx(
        s["outer"]["total_ms"] - s["inner"]["total_ms"], abs=1e-6)
    assert profiling.counters() == {"c": 5}
    recs = profiling.drain()
    assert [r.name for r in recs] == ["inner", "inner", "outer"] and profiling.drain() == []
    assert recs[2].attrs == {"tag": 1} and recs[0].parent == recs[2].id
    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=3))
    with profiling.tracing():
        for _ in range(5):
            with profiling.span("x"):
                pass
    assert profiling.dropped() == 2 and len(profiling.drain()) == 3
    assert profiling.dropped() == 0


def test_spans_ride_the_profilers_timeline_and_the_chrome_trace(base, data, tmp_path):

    eng = _engine(base)
    lut = data[1]
    with profiling.tracing():
        with profiling.device_trace(str(tmp_path / "t"), device="cpu"):
            eng.search_many(list(lut)[:2], k=K, embedding_fn=lut.__getitem__,
                            use_pq_search=False)
    names = {e.get("name") for e in json.loads((tmp_path / "t" / "trace.json").read_text())
             ["traceEvents"]}
    assert {"diskrag.engine.request", "diskrag.graph.round", "diskrag.graph.round.sync",
            "diskrag.engine.join"} <= names
    # a thread handed the context records under the span that handed it over
    def work():
        with profiling.span("w"):
            pass

    profiling.drain()
    with profiling.tracing():
        with profiling.request("engine.request"):
            t = threading.Thread(target=contextvars.copy_context().run, args=(work,))
            t.start()
            t.join()
    w, outer = profiling.drain()
    assert w.name == "w" and w.thread != outer.thread
    assert (w.parent, w.request) == (outer.id, outer.request) and outer.request is not None


def test_spans_and_counters_are_exact_under_threads():
    """16 threads recording spans and counts at once, with the
    interpreter switching threads as often as it can: no record and no
    count is lost, every id is unique and every parent is the thread's own."""
    import sys

    n_threads, n_spans = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_spans):
                with profiling.request("r"):
                    with profiling.span("s"):
                        profiling.count("c")

        with profiling.tracing():
            threads = [threading.Thread(target=work, daemon=True) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert profiling.dropped() == 0
    every = profiling.drain()
    assert len({r.id for r in every}) == len(every)
    recs = [r for r in every if r.name != "gc"]  # the collector's pauses, recorded too
    assert len(recs) == 2 * n_threads * n_spans
    assert profiling.counters() == {"c": n_threads * n_spans}
    by_id = {r.id: r for r in recs}
    roots = [r for r in recs if r.name == "r"]
    assert len({r.request for r in roots}) == len(roots)
    for r in recs:
        if r.name == "s":
            p = by_id[r.parent]
            assert p.name == "r" and p.thread == r.thread and p.request == r.request
