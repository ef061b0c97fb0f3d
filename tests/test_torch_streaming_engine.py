"""The port's engine in serving mode "streaming" on a tiny collection (the
JAX package's `tests/test_engine.py` streaming tests, on the port), its
HTTP `/insert` and `/delete` and the CLI's `--serving-mode streaming`, and
the flushed index loaded by both packages' engines in both directions.
Vectors are made from a seed with numpy; texts are embedded by the mock
embedder (dimension 128), whose vectors are a function of the text, so a
text searched for finds itself at rank 1."""

import asyncio
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # the suite runs several workers: do not let each spin a thread per core

from diskrag_tpu.engine import SearchEngine as JaxEngine

from diskrag_tpu_torch.api import AppState, create_app
from diskrag_tpu_torch.build_index import build_index_from_vectors
from diskrag_tpu_torch.cli import main as cli_main
from diskrag_tpu_torch.data import EmbeddingConfig, EmbeddingGenerator, PreprocessingConfig, save_config
from diskrag_tpu_torch.data.collection import CollectionManager
from diskrag_tpu_torch.engine import SearchEngine, ServingConfigError

DIM, N0 = 128, 64
MOCK = EmbeddingConfig(provider="mock", model="mock", dimension=DIM)


def _collection(base, *, n_extra_unindexed=0, **build_kw):
    """Collection "c" under `base`: N0 rows t0.. with seeded vectors, a
    vamana index over them, then `n_extra_unindexed` rows u0.. appended
    without a rebuild. Returns the base vectors and the extra ones."""
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(N0, DIM)).astype(np.float32)
    mgr = CollectionManager(base)
    mgr.create_collection("c", DIM)
    mgr.update_collection("c", vecs, [f"t{i}" for i in range(N0)], [{"i": i} for i in range(N0)])
    build_index_from_vectors(vecs, mgr.get_index_dir("c"), device="cpu", **build_kw)
    extra = rng.normal(size=(max(n_extra_unindexed, 8), DIM)).astype(np.float32)
    if n_extra_unindexed:
        mgr.update_collection("c", extra[:n_extra_unindexed],
                              [f"u{i}" for i in range(n_extra_unindexed)],
                              [{} for _ in range(n_extra_unindexed)])
    return vecs, extra


def _engine(base, mode="streaming", **kw):
    return SearchEngine("c", base_dir=str(base), serving_mode=mode, device="cpu", **kw)


def test_insert_texts_returns_new_row_ids(tmp_path):
    _, extra = _collection(tmp_path)
    eng = _engine(tmp_path)
    assert eng.diagnostics is not None and eng.diagnostics["passed"]
    texts = [f"new {i}" for i in range(6)]
    ids = eng.insert_texts(texts, metadata_list=[{"live": i} for i in range(6)],
                           vectors=extra[:6])
    np.testing.assert_array_equal(ids, np.arange(N0, N0 + 6))
    assert eng.info.num_vectors == N0 + 6 and eng.streaming.n_total_live == N0 + 6
    assert len(eng.insert_texts(texts[:3], vectors=extra[:3])) == 0  # duplicates skipped
    _, got, stats = eng.search_batch(extra[:6], k=3)
    np.testing.assert_array_equal(got[:, 0], np.arange(N0, N0 + 6))
    assert stats["search_type"] == "streaming"
    by_text = dict(zip(texts, extra[:6]))
    out = eng.search("new 4", k=3, embedding_fn=by_text.__getitem__)
    assert out["results"][0]["text"] == "new 4"


def test_delete_ids_counts_new_tombstones_and_unknown_ids_raise_first(tmp_path):
    vecs, extra = _collection(tmp_path)
    eng = _engine(tmp_path, run_diagnostics=False)
    eng.insert_texts(["a", "b"], vectors=extra[:2])
    live = eng.streaming.n_total_live
    assert eng.delete_ids([3, N0]) == 2          # a graph row and a buffered row
    assert eng.delete_ids([3, N0]) == 0          # idempotent
    with pytest.raises(KeyError):
        eng.delete_ids([5, 999_999])             # 5 must stay live
    assert eng.streaming.n_total_live == live - 2
    _, got, _ = eng.search_batch(np.stack([vecs[3], extra[0], vecs[5]]), k=3)
    assert 3 not in got[0] and N0 not in got[1] and got[2, 0] == 5


def test_flush_refuses_with_tombstones_and_after_compaction(tmp_path):
    _, extra = _collection(tmp_path)
    eng = _engine(tmp_path, run_diagnostics=False)
    eng.delete_ids([7])
    with pytest.raises(ServingConfigError, match="tombstone"):
        eng.flush_index()
    eng = _engine(tmp_path, run_diagnostics=False)
    assert eng.delete_ids([3, 5]) == 2
    eng.streaming.merge_insert_max_fraction = 0.0  # every merge takes the rebuild path
    eng.insert_texts([f"x{i}" for i in range(4)], vectors=extra[:4])
    eng.streaming.merge()
    assert eng.streaming._n_deleted == 0 and eng.streaming.rows_compacted
    with pytest.raises(ServingConfigError, match="compacted"):
        eng.flush_index()


def test_rows_past_the_watermark_are_adopted(tmp_path):
    _, extra = _collection(tmp_path, n_extra_unindexed=8)
    eng = _engine(tmp_path, run_diagnostics=False)
    assert eng.streaming.n_total_live == N0 + 8 and eng.streaming.n_buffered == 8
    _, got, _ = eng.search_batch(extra[:8], k=1)
    np.testing.assert_array_equal(got[:, 0], np.arange(N0, N0 + 8))


@pytest.mark.parametrize("pq", ["none", "int8"])
def test_flush_then_both_packages_serve_the_inserted_rows(tmp_path, pq):
    """A port flush persists the grown index (PQ codes re-encoded, derived
    meta keys recomputed); an engine in mode "auto" of either package
    serves the inserted rows from it."""
    build_kw = {} if pq == "none" else {"force_pq": True, "pq_kind": "int8"}
    _, extra = _collection(tmp_path, **build_kw)
    eng = _engine(tmp_path, run_diagnostics=False)
    eng.insert_texts([f"x{i}" for i in range(6)], vectors=extra[:6])
    eng.meta["medoid_idx"] = 9_999  # stale derived values must not survive a flush
    eng.meta["num_points"] = 1
    assert eng.flush_index() == {"n_points": N0 + 6, "n_buffered_before": 6}
    meta = json.loads((eng.manager.get_index_dir("c") / "meta.json").read_text())
    assert meta["num_points"] == N0 + 6 and meta["medoid_idx"] < N0 + 6
    port = _engine(tmp_path, mode="auto", run_diagnostics=False)
    jax = JaxEngine("c", base_dir=str(tmp_path), run_diagnostics=False)
    for e in (port, jax):
        _, got, stats = e.search_batch(extra[:6], k=1, use_pq_search=False)
        np.testing.assert_array_equal(got[:, 0], np.arange(N0, N0 + 6))
    if pq == "int8":
        assert port.guide.codes.shape[0] == N0 + 6 and port.search_batch(extra[:2], k=1)[2][
            "search_type"] == "iq_accelerated"


def test_jax_flush_is_served_by_the_port(tmp_path):
    _, extra = _collection(tmp_path)
    jeng = JaxEngine("c", base_dir=str(tmp_path), serving_mode="streaming", run_diagnostics=False)
    jeng.insert_texts([f"x{i}" for i in range(5)], vectors=extra[:5])
    assert jeng.flush_index()["n_points"] == N0 + 5
    port = _engine(tmp_path, mode="auto", run_diagnostics=False)
    _, got, _ = port.search_batch(extra[:5], k=1)
    np.testing.assert_array_equal(got[:, 0], np.arange(N0, N0 + 5))
    # and the port's streaming mode goes on from the flushed index
    eng = _engine(tmp_path, run_diagnostics=False)
    assert eng.streaming.n_graph == N0 + 5 and eng.streaming.n_buffered == 0


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def test_api_insert_and_delete_answer_200_under_streaming(tmp_path):
    _collection(tmp_path)
    state = AppState(base_dir=str(tmp_path), embedding_config=MOCK, serving_mode="streaming",
                     device="cpu")

    async def flow():
        from aiohttp.test_utils import TestClient, TestServer

        texts = [f"即時插入的新文件 {i}" for i in range(4)]
        async with TestClient(TestServer(create_app(state))) as client:
            async def post(path, payload):
                resp = await client.post(path, json=payload)
                return resp.status, await resp.json()

            status, data = await post("/insert", {"collection": "c", "texts": texts,
                                                  "metadata": [{"type": "live"}] * 4})
            assert status == 200, data
            assert data["ids"] == list(range(N0, N0 + 4)) and data["inserted"] == 4
            status, data2 = await post("/insert", {"collection": "c", "texts": texts[:2]})
            assert status == 200 and data2["inserted"] == 0
            status, out = await post("/search", {"collection": "c", "query": texts[1], "top_k": 3})
            assert status == 200 and out["results"][0]["text"] == texts[1]
            assert out["stats"]["search_type"] == "streaming"
            status, d = await post("/delete", {"collection": "c", "ids": [data["ids"][1]]})
            assert status == 200 and d["deleted"] == 1 and d["n_total_live"] == N0 + 3
            status, d = await post("/delete", {"collection": "c", "ids": [data["ids"][1]]})
            assert status == 200 and d["deleted"] == 0
            status, out = await post("/search", {"collection": "c", "query": texts[1], "top_k": 3})
            assert all(r["text"] != texts[1] for r in out["results"])
            status, _ = await post("/delete", {"collection": "c", "ids": [999_999]})
            assert status == 404

    _run(flow())


def test_cli_serves_streaming_mode(tmp_path, monkeypatch, capsys):
    _collection(tmp_path / "collections")
    monkeypatch.chdir(tmp_path)
    save_config(PreprocessingConfig(collection="c", embedding=MOCK), tmp_path / "config.yaml")
    # the collection's rows are seeded vectors, not the mock embedder's; a
    # text inserted through the engine is then found by the CLI's search
    eng = SearchEngine("c", base_dir=str(tmp_path / "collections"), serving_mode="streaming",
                       device="cpu", run_diagnostics=False)
    vec = EmbeddingGenerator(MOCK).generate("新的串流文件")
    eng.insert_texts(["新的串流文件"], vectors=vec[None, :])
    eng.flush_index()
    assert cli_main(["--device", "cpu", "search", "c", "新的串流文件", "-k", "2",
                     "--serving-mode", "streaming"]) == 0
    assert "新的串流文件" in capsys.readouterr().out
