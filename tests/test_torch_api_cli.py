"""The port's CLI and HTTP API on the CPU (`--device cpu`, mock providers
throughout), mirroring `tests/test_api_cli.py`, and both packages' apps
held against each other: one collection processed with the mock embedder,
one index directory, the same `/search`, `/faq-search` and `/search-batch`
requests — equal ids, distances within rtol 1e-5 (f32 sums taken in
another order; an absolute floor of 1e-6 on the squared distance where a
query matches a stored text exactly) — for a flat per-row index and for a vamana index built by
the JAX package and served "exact" by both."""

import asyncio

import numpy as np
import pandas as pd
import pytest
import torch

torch.set_num_threads(2)  # the suite runs several workers: do not let each spin a thread per core

from diskrag_tpu.api import AppState as JaxAppState, create_app as jax_create_app
from diskrag_tpu.cli import DiskRAG as JaxRAG

from diskrag_tpu_torch.api import AppState, create_app
from diskrag_tpu_torch.cli import DiskRAG, build_parser, main as cli_main
from diskrag_tpu_torch.data import (
    EmbeddingConfig,
    PreprocessingConfig,
    QuestionGenerationConfig,
    save_config,
)

MOCK = dict(provider="mock", model="mock", dimension=128)
CPU = ["--device", "cpu"]


@pytest.fixture()
def workspace(tmp_path, monkeypatch):
    """A config + FAQ CSV workspace using mock providers."""
    monkeypatch.chdir(tmp_path)
    cfg = PreprocessingConfig(
        collection="faq",
        embedding=EmbeddingConfig(**MOCK),
        question_generation=QuestionGenerationConfig(enabled=False),
    )
    save_config(cfg, tmp_path / "config.yaml")
    rows = [
        {"id": f"q{i}", "question": f"如何使用功能{i}？", "answer": f"功能{i}的答案。"}
        for i in range(20)
    ]
    pd.DataFrame(rows).to_csv(tmp_path / "faq.csv", index=False)
    return tmp_path


def test_cli_process_index_search_list_delete(workspace, capsys):
    assert cli_main([*CPU, "process", "faq.csv", "--collection", "faq"]) == 0
    assert "done — now run: diskrag-tpu-torch index faq" in capsys.readouterr().out
    assert cli_main([*CPU, "index", "faq"]) == 0
    assert "index built: type=vamana N=20" in capsys.readouterr().out

    assert cli_main([*CPU, "search", "faq", "如何使用功能3?", "-k", "3"]) == 0
    assert "功能3" in capsys.readouterr().out

    assert cli_main([*CPU, "list"]) == 0
    assert "faq: 20 vectors" in capsys.readouterr().out

    assert cli_main([*CPU, "delete", "faq"]) == 0
    assert "deleted" in capsys.readouterr().out


def test_cli_merge_and_doctor(workspace, capsys):
    rag = DiskRAG("config.yaml", device="cpu")
    rag.process("faq.csv", "a")
    rag.process("faq.csv", "b")
    info = rag.merge_collections(["a", "b"], "m")
    assert info.num_vectors == 20  # same content -> dedup leaves 20

    rag.build_index("m")
    assert rag.doctor("m")["status"] == "ok"

    # self-contained index types report healthy, not "no index"
    rag.build_index("m", index_type="flat", force_rebuild=True)
    report = rag.doctor("m")
    assert report["status"] == "ok"
    assert any("flat index present" in a for a in report["actions"])
    capsys.readouterr()

    # the same through the command line, with the JAX CLI's output lines
    assert cli_main([*CPU, "merge", "a", "b", "-t", "m2"]) == 0
    assert capsys.readouterr().out.strip() == "merged into m2: 20 vectors"
    assert cli_main([*CPU, "doctor", "m"]) == 0
    assert capsys.readouterr().out.strip() == str(report)
    assert report == JaxRAG("config.yaml").doctor("m")


def test_cli_process_dir(workspace, capsys):
    src = workspace / "incoming"
    src.mkdir()
    (workspace / "faq.csv").rename(src / "one.csv")
    rows = [{"id": f"r{i}", "question": f"如何設定選項{i}？", "answer": f"選項{i}的說明。"}
            for i in range(18)]
    pd.DataFrame(rows).to_csv(src / "two.csv", index=False)
    (src / "notes.txt").write_text("skipped: not a csv or markdown file")
    (src / "short.csv").write_text("id,question,answer\nx,太短？,少。\n")  # 1 row: index refuses
    assert cli_main([*CPU, "process-dir", str(src), "--prefix", "d"]) == 0
    assert capsys.readouterr().out.strip() == "processed 2 collections: d_one, d_two"
    rag = DiskRAG("config.yaml", device="cpu")
    assert {i.name for i in rag.list_collections()} >= {"d_one", "d_two"}
    assert (rag.manager.get_index_dir("d_two") / "meta.json").exists()
    out = rag.search("d_two", "如何設定選項4?", k=2)
    assert "選項4" in out["results"][0]["text"]


def test_cli_serving_mode_choices():
    args = build_parser().parse_args(["search", "c", "q", "--serving-mode", "auto"])
    assert args.serving_mode == "auto" and args.device == "cuda"
    args = build_parser().parse_args(["search", "c", "q", "--serving-mode", "host_tier"])
    assert args.serving_mode == "host_tier"
    args = build_parser().parse_args(["search", "c", "q", "--serving-mode", "streaming"])
    assert args.serving_mode == "streaming"
    args = build_parser().parse_args(["search", "c", "q", "--serving-mode", "sharded_flat"])
    assert args.serving_mode == "sharded_flat"
    with pytest.raises(SystemExit):  # not a mode of either package
        build_parser().parse_args(["search", "c", "q", "--serving-mode", "sharded_host_tier"])


def test_cli_process_article_csv_and_markdown(workspace, capsys):
    rows = [
        {"id": "a1", "title": "安裝指南",
         "paragraph_text": "本章介紹完整的安裝流程，包括前置需求與步驟說明。" * 4,
         "section": "第一章"},
    ]
    pd.DataFrame(rows).to_csv("articles.csv", index=False)
    assert cli_main([*CPU, "process", "articles.csv", "-c", "arts"]) == 0
    rag = DiskRAG("config.yaml", device="cpu")
    info = rag.manager.get_collection_info("arts")
    assert info is not None and info.num_vectors >= 1
    text, meta = rag.manager.get_text_by_index("arts", 0)
    assert meta["type"] == "article" and meta["title"] == "安裝指南"

    md = "# 使用\n" + "這一段說明如何日常使用產品，內容足夠長以通過最小長度檢查。" * 3 + "\n"
    with open("manual.md", "w") as f:
        f.write(md)
    assert cli_main([*CPU, "process", "manual.md", "-c", "docs"]) == 0
    info = rag.manager.get_collection_info("docs")
    assert info is not None and info.num_vectors >= 1


def _state(cls, **kw):
    return cls(base_dir="collections", embedding_config=EmbeddingConfig(**MOCK),
               llm_fn=lambda system, prompt: "這是模擬回答。", **kw)


@pytest.fixture()
def api_client(workspace):
    """App factory over a prepared collection (fresh app per event loop)."""
    rag = DiskRAG("config.yaml", device="cpu")
    rag.process("faq.csv", "faq")
    rag.build_index("faq")
    return lambda: create_app(_state(AppState, device="cpu"))


async def _request(app, method, path, payload=None):
    from aiohttp.test_utils import TestClient, TestServer

    async with TestClient(TestServer(app)) as client:
        if method == "GET":
            resp = await client.get(path)
        else:
            resp = await client.post(path, json=payload)
        return resp.status, await resp.json()


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def test_api_search(api_client):
    status, data = _run(
        _request(api_client(), "POST", "/search",
                 {"collection": "faq", "query": "如何使用功能5?", "top_k": 3})
    )
    assert status == 200
    assert data["results"] and "功能5" in data["results"][0]["text"]
    assert "timing" in data and "stats" in data


def test_api_faq_search_and_validation(api_client):
    status, data = _run(
        _request(api_client(), "POST", "/faq-search",
                 {"collection": "faq", "query": "功能7怎麼用", "top_k": 2})
    )
    assert status == 200
    qa_ids = [r["metadata"]["qa_id"] for r in data["results"]]
    assert len(qa_ids) == len(set(qa_ids))

    status, _ = _run(  # validation error -> 422
        _request(api_client(), "POST", "/search", {"collection": "faq", "query": ""})
    )
    assert status == 422
    status, data = _run(  # an unknown collection is the server's 500, with the reason
        _request(api_client(), "POST", "/search", {"collection": "nope", "query": "x"})
    )
    assert status == 500 and "not found" in data["detail"]


def test_api_collections_and_health(api_client):
    status, data = _run(_request(api_client(), "GET", "/collections"))
    assert status == 200
    entry = next(e for e in data if e["name"] == "faq")
    assert entry["status"] == "ready"

    status, data = _run(_request(api_client(), "GET", "/health"))
    assert status == 200
    assert data["checks"]["collections_dir_exists"]
    assert data["checks"]["embedding_provider"] == "mock"
    assert data["device"] == {"platform": "cpu", "kind": None, "count": 0}


def test_api_ask(api_client):
    status, data = _run(
        _request(api_client(), "POST", "/ask",
                 {"collection": "faq", "question": "功能2怎麼用?", "top_k": 2})
    )
    assert status == 200
    assert data["answer"] == "這是模擬回答。"
    assert data["timing"]["total_time"] > 0


def test_api_ask_normalizes_refusals_and_llm_failures(api_client, workspace):
    def failing(system, prompt):
        raise RuntimeError("upstream down")

    for llm_fn, want in ((lambda s, p: "我不知道。", "抱歉，我無法根據現有資料回答這個問題。"),
                         (failing, "抱歉，系統處理您的問題時發生錯誤。")):
        state = AppState(base_dir="collections", embedding_config=EmbeddingConfig(**MOCK),
                         llm_fn=llm_fn, device="cpu")
        status, data = _run(_request(create_app(state), "POST", "/ask",
                                     {"collection": "faq", "question": "功能2怎麼用?"}))
        assert status == 200 and data["answer"] == want


def test_api_search_batch(api_client):
    """One device batch per request, per-query result lists in order."""
    status, data = _run(
        _request(api_client(), "POST", "/search-batch",
                 {"collection": "faq",
                  "queries": ["如何使用功能5?", "如何使用功能2?"],
                  "top_k": 2})
    )
    assert status == 200
    assert len(data["results"]) == 2
    assert "功能5" in data["results"][0][0]["text"]
    assert "功能2" in data["results"][1][0]["text"]

    status, _ = _run(
        _request(api_client(), "POST", "/search-batch", {"collection": "faq", "queries": []})
    )
    assert status == 422


@pytest.mark.parametrize("path,payload,what", [
    ("/insert", {"collection": "faq", "texts": ["x"]}, "insert_texts"),
    ("/delete", {"collection": "faq", "ids": [3]}, "delete_ids"),
])
def test_api_insert_and_delete_require_streaming_mode(api_client, path, payload, what):
    """A non-streaming server answers /insert and /delete with 409 (serving
    configuration), not 500 — the reference's answer, word for word."""
    status, data = _run(_request(api_client(), "POST", path, payload))
    assert status == 409
    assert data["detail"] == f"{what} requires serving_mode='streaming'"
    jax_status, jax_data = _run(
        _request(jax_create_app(_state(JaxAppState)), "POST", path, payload))
    assert (jax_status, jax_data) == (status, data)


def test_api_insert_validates_metadata_length(api_client):
    status, data = _run(_request(api_client(), "POST", "/insert",
                                 {"collection": "faq", "texts": ["x"], "metadata": [{}, {}]}))
    assert status == 422 and data["detail"] == "metadata length != texts length"


REQUESTS = [
    ("/search", {"collection": "faq", "query": "如何使用功能5?", "top_k": 5}),
    ("/search", {"collection": "faq", "query": "功能11的用法", "top_k": 3, "use_faq_search": True}),
    ("/faq-search", {"collection": "faq", "query": "功能7怎麼用", "top_k": 4}),
    ("/search-batch", {"collection": "faq", "top_k": 4,
                       "queries": [f"如何使用功能{i}?" for i in (1, 9, 14, 3, 18)]}),
]


def _rows(data):
    """A response's result lists, one per query."""
    single = not (data["results"] and isinstance(data["results"][0], list))
    return [data["results"]] if single else data["results"]


def _without_distance(data):
    return [[{k: v for k, v in r.items() if k != "distance"} for r in row] for row in _rows(data)]


def _hits(data):
    """(vector ids, distances) of a response, one row per query."""
    rows = _rows(data)
    ids = [[r["metadata"]["vector_index"] for r in row] for row in rows]
    dists = [[r["distance"] for r in row] for row in rows]
    return ids, dists


@pytest.mark.parametrize("index_type", ["flat", "vamana", "ivf"])
def test_both_packages_apps_answer_alike(workspace, index_type):
    """One collection, one index directory (built by the JAX package), both
    apps: the flat per-row index, a carried vamana index that both serve by
    exact traversal (20 points train no PQ), and an IVF index."""
    rag = JaxRAG("config.yaml")
    rag.process("faq.csv", "faq")
    meta = rag.build_index("faq", index_type=index_type)
    assert meta["index_type"] == index_type and not meta["use_pq"]
    want_type = {"vamana": "exact"}.get(index_type, index_type)

    async def answers(app):  # one app, one event loop, the requests one after the other
        from aiohttp.test_utils import TestClient, TestServer

        out = []
        async with TestClient(TestServer(app)) as client:
            for path, payload in REQUESTS:
                resp = await client.post(path, json=payload)
                out.append((resp.status, await resp.json()))
            resp = await client.get("/collections")
            out.append((resp.status, await resp.json()))
        return out

    ours = _run(answers(create_app(_state(AppState, device="cpu"))))
    theirs = _run(answers(jax_create_app(_state(JaxAppState))))
    assert ours[-1] == theirs[-1] and ours[-1][0] == 200  # /collections
    for (path, _), (status, data), (jax_status, jax_data) in zip(REQUESTS, ours, theirs):
        assert status == jax_status == 200
        assert data["stats"]["search_type"] == jax_data["stats"]["search_type"] == want_type
        ids, dists = _hits(data)
        jax_ids, jax_dists = _hits(jax_data)
        assert ids == jax_ids and all(ids), (path, ids, jax_ids)
        # rtol 1e-5 on the distances; a query that is a stored text has
        # distance 0 up to the cancellation in |q|^2 + |v|^2 - 2 q.v (unit
        # vectors: a few f32 ulps of 1), which the sqrt at the API's edge
        # magnifies, so the floor is taken on the squared distances
        for row, jax_row in zip(dists, jax_dists):
            np.testing.assert_allclose(np.square(row), np.square(jax_row), rtol=2e-5, atol=1e-6)
        assert _without_distance(data) == _without_distance(jax_data)  # texts and metadata too
