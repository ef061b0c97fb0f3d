"""HTTP API — counterpart of `diskrag_tpu/api.py`, serving the same
endpoints with the same request / response schemas on one device:

    POST /search        {collection, query, top_k, use_faq_search}
    POST /search-batch  {collection, queries, top_k}
    POST /faq-search    {collection, query, top_k}
    GET  /collections   per-collection file-integrity report
    GET  /health        directory / env checks, and the device served from
    POST /ask           {collection, question, top_k} -> RAG answer
    POST /insert        {collection, texts, metadata}   (streaming mode only)
    POST /delete        {collection, ids}               (streaming mode only)

    python -m diskrag_tpu_torch.api [--device cpu] [--host H] [--port P]

On aiohttp, with pydantic request models; both are imported inside
`create_app` / `main`, so importing this module needs neither. Engines are
cached per collection. `/insert` and `/delete` work when the server runs
in streaming mode (`DISKRAG_SERVING_MODE=streaming`, or `serving_mode=`
of `AppState`) and answer 409 otherwise.

Threads. Handlers run the engine in worker threads
(`asyncio.to_thread`). PyTorch's current CUDA device and stream are per
thread; the engine's tensors carry their device and every kernel wrapper
launches on `torch.cuda.current_stream(<the tensors' device>)`, so a
worker thread launches on the engine's device whatever its own current
device is. The kernel launch counters (`kernels/launches.py`) are not
locked: they are exact for requests sent one after the other and can lose
counts under concurrent requests.

Kernels are built before the server listens (`AppState.prepare`): the
first request does not wait for `nvcc`, and a kernel that does not build
stops the server rather than leaving it to answer from a plain version.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import pathlib
import threading
import time
from typing import Any, Optional

from diskrag_tpu_torch.data import CollectionManager, EmbeddingConfig, EmbeddingGenerator
from diskrag_tpu_torch.device import resolve_device
from diskrag_tpu_torch.engine import SearchEngine, ServingConfigError

logger = logging.getLogger(__name__)

OPENAI_CHAT_URL = "https://api.openai.com/v1/chat/completions"
REFUSAL_KEYWORDS = ["無法回答", "不知道", "沒有相關資訊", "找不到"]
REFUSAL_ANSWER = "抱歉，我無法根據現有資料回答這個問題。"


class RequestError(ValueError):
    """A request that validates field by field but not as a whole: 422."""


def _request_models() -> dict:
    """The pydantic request models, built on first use (pydantic is a
    card-side package the serving path itself does not need)."""
    from typing import Annotated

    from pydantic import BaseModel, Field

    class SearchRequest(BaseModel):
        collection: str = Field(...)
        query: str = Field(..., min_length=1, max_length=500)
        top_k: int = Field(5, ge=1, le=20)
        use_faq_search: bool = False

    class BatchSearchRequest(BaseModel):
        collection: str = Field(...)
        # same per-query constraints as SearchRequest.query
        queries: list[Annotated[str, Field(min_length=1, max_length=500)]] = (
            Field(..., min_length=1, max_length=1024)
        )
        top_k: int = Field(5, ge=1, le=20)

    class InsertRequest(BaseModel):
        collection: str = Field(...)
        texts: list[Annotated[str, Field(min_length=1, max_length=5000)]] = (
            Field(..., min_length=1, max_length=1024)
        )
        metadata: Optional[list[dict]] = None

    class DeleteRequest(BaseModel):
        collection: str = Field(...)
        ids: list[int] = Field(..., min_length=1, max_length=65536)

    class AskRequest(BaseModel):
        collection: str = Field(...)
        question: str = Field(..., min_length=1, max_length=500)
        top_k: int = Field(2, ge=1, le=5)

    return {"search": SearchRequest, "batch": BatchSearchRequest, "insert": InsertRequest,
            "delete": DeleteRequest, "ask": AskRequest}


class AppState:
    """Engine + embedding caches shared across requests, on one device."""

    def __init__(
        self,
        base_dir: str = "collections",
        embedding_config: Optional[EmbeddingConfig] = None,
        llm_fn=None,
        serving_mode: Optional[str] = None,
        *,
        device: str = "cuda",
        mesh_devices: Optional[list] = None,
    ):
        """`serving_mode` None reads DISKRAG_SERVING_MODE (default "auto").
        `device` is resolved here, so a server meant for the card fails at
        start when none is visible. `mesh_devices` is the engines' mesh for
        a sharded collection (default: every visible card, or the CPU)."""
        self.device = resolve_device(device)
        self.mesh_devices = mesh_devices
        self.serving_mode = serving_mode or os.environ.get("DISKRAG_SERVING_MODE", "auto")
        self.base_dir = base_dir
        self.manager = CollectionManager(base_dir)
        self.engines: dict[str, SearchEngine] = {}
        self._engines_lock = threading.Lock()  # handlers bring engines up from worker threads
        if embedding_config is None:
            provider = "openai" if os.environ.get("OPENAI_API_KEY") else "mock"
            embedding_config = EmbeddingConfig(provider=provider)
        self.embedder = EmbeddingGenerator(embedding_config)
        self.llm_fn = llm_fn  # injectable for tests; default = OpenAI REST

    def prepare(self) -> None:
        """Build and load every CUDA kernel now (a no-op on the CPU, where
        the wrappers take their plain versions). A build failure raises."""
        if self.device.type == "cuda":
            from diskrag_tpu_torch.kernels import _build

            for stem in _build.build_all():
                _build.load(stem)

    def get_engine(self, collection: str) -> SearchEngine:
        with self._engines_lock:
            if collection not in self.engines:
                self.engines[collection] = SearchEngine(
                    collection, base_dir=self.base_dir,
                    serving_mode=self.serving_mode, device=str(self.device),
                    mesh_devices=self.mesh_devices,
                )
            return self.engines[collection]

    def embed(self, text: str):
        return self.embedder.generate(text)

    def device_report(self) -> dict:
        """What `/health` says about the device: platform, the card's name,
        the count of visible cards."""
        if self.device.type != "cuda":
            return {"platform": "cpu", "kind": None, "count": 0}
        import torch

        return {"platform": "gpu", "kind": torch.cuda.get_device_name(self.device),
                "count": torch.cuda.device_count(), "index": self.device.index}

    def chat(self, system: str, prompt: str) -> str:
        if self.llm_fn is not None:
            return self.llm_fn(system, prompt)
        import httpx

        api_key = os.environ.get("OPENAI_API_KEY")
        if not api_key:
            raise RuntimeError("OPENAI_API_KEY not set for /ask")
        resp = httpx.post(
            OPENAI_CHAT_URL,
            headers={"Authorization": f"Bearer {api_key}"},
            json={
                "model": "gpt-4o-mini",
                "messages": [
                    {"role": "system", "content": system},
                    {"role": "user", "content": prompt},
                ],
                "temperature": 0.3,
                "max_tokens": 500,
            },
            timeout=60.0,
        )
        resp.raise_for_status()
        return resp.json()["choices"][0]["message"]["content"].strip()


def _build_context(results: list[dict]) -> str:
    """FAQ-aware context assembly."""
    parts = []
    for i, r in enumerate(results, 1):
        meta = r.get("metadata", {})
        q = meta.get("original_question") or meta.get("question", "")
        a = meta.get("answer", "")
        if meta.get("type") == "faq" and q and a:
            parts.append(f"FAQ {i}:\n問題：{q}\n答案：{a}")
        else:
            text = r.get("text", "")
            if text:
                parts.append(f"來源 {i}:\n{text}")
    return "\n\n".join(parts)


_ASK_SYSTEM = (
    "你是一個專業的客服助手，根據提供的 FAQ 資料回答問題。回答要簡潔明確，"
    "直接給出解決方案。如果資料不足以回答，請直接說不知道。"
)

_ASK_PROMPT = """你是一個專業的客服助手，請根據以下參考資料回答使用者的問題。
如果參考資料不足以回答問題，或問題與參考資料無關，請直接回答「抱歉，我無法根據現有資料回答這個問題」。

參考資料：
{context}

使用者問題：{question}

請注意：
1. 如果參考資料是 FAQ 格式，請特別注意問題和答案的對應關係
2. 回答時要簡潔明確，直接給出解決方案
3. 如果有多個相關答案，請整合成一個完整的回答
4. 不需要包含「根據參考資料」等開場白
5. 如果參考資料不足以回答問題，請直接說不知道"""


def _collection_entry(manager: CollectionManager, info) -> dict[str, Any]:
    """One collection's integrity report: the files its index type needs."""
    name = info.name
    index_dir = manager.get_index_dir(name)
    entry: dict[str, Any] = {
        "name": name,
        "num_vectors": info.num_vectors,
        "dimension": info.dimension,
        "updated_at": info.updated_at,
    }
    if not index_dir.exists():
        entry["status"] = "no_index"
        entry["missing_files"] = ["index directory"]
        return entry
    meta_path = index_dir / "meta.json"
    if not meta_path.exists():
        entry["status"] = "incomplete"
        entry["missing_files"] = ["index/meta.json"]
        return entry
    try:
        meta = json.loads(meta_path.read_text())
    except ValueError:
        meta = {}
    required = {
        "vectors.npy": manager.get_vectors_path(name),
        "metadata.parquet": manager.get_metadata_path(name),
        "index/meta.json": meta_path,
    }
    # per-index-type artifact sets: reporting adjacency.npy as missing for
    # a flat index would be a false "incomplete"
    itype = meta.get("index_type", "vamana")
    if itype == "flat":
        required["index/vectors.npy"] = index_dir / "vectors.npy"
    elif itype == "ivf":
        for f in ("vectors.npy", "ivf_centroids.npy", "ivf_tile_ids.npy"):
            required[f"index/{f}"] = index_dir / f
    elif itype == "sharded":
        for f in ("sharded_meta.json", "vectors.npy", "adjacency.npy", "medoids.npy",
                  "global_ids.npy"):
            required[f"index/sharded/{f}"] = index_dir / "sharded" / f
        if meta.get("write_compat"):
            required["index/index.dat"] = index_dir / "index.dat"
    else:
        required["index/vectors.npy"] = index_dir / "vectors.npy"
        required["index/adjacency.npy"] = index_dir / "adjacency.npy"
    if meta.get("use_pq"):
        required["index/pq_model.npz"] = index_dir / "pq_model.npz"
        required["index/pq_codes.npy"] = index_dir / "pq_codes.npy"
    missing = [k for k, p in required.items() if not p.exists()]
    entry["status"] = "ready" if not missing else "incomplete"
    if missing:
        entry["missing_files"] = missing
    entry["use_pq"] = meta.get("use_pq")
    entry["num_points"] = meta.get("num_points")
    return entry


def create_app(state: Optional[AppState] = None):
    """Build the aiohttp application. Without a `state` it makes its own
    (on the card) and builds the kernels before returning."""
    from aiohttp import web
    from pydantic import ValidationError

    if state is None:
        state = AppState()
        state.prepare()
    models = _request_models()
    app = web.Application()
    app["state"] = state

    def json_error(status: int, detail: str):
        return web.json_response({"detail": detail}, status=status)

    def endpoint(model_key: str, what: str):
        """Wrap `work(req) -> dict` as a handler: 422 on a request that does
        not validate; the blocking work (engine bring-up, embedding, device
        launches) in a worker thread, so one slow call does not stall the
        event loop; 422 / 409 / 404 / 500 as the reference maps them."""

        def wrap(work):
            async def handler(request):
                try:
                    req = models[model_key](**await request.json())
                except (ValidationError, ValueError) as e:
                    return json_error(422, str(e))
                try:
                    return web.json_response(await asyncio.to_thread(work, req))
                except RequestError as e:
                    return json_error(422, str(e))
                except ServingConfigError as e:
                    return json_error(409, str(e))
                except Exception as e:  # noqa: BLE001 — a server keeps answering
                    if model_key == "delete" and isinstance(e, KeyError):
                        return json_error(404, f"unknown id: {e}")
                    logger.exception("%s failed", what)
                    return json_error(500, str(e))

            return handler

        return wrap

    @endpoint("search", "search")
    def search(req):
        engine = state.get_engine(req.collection)
        fn = engine.faq_search if req.use_faq_search else engine.search
        return fn(req.query, k=req.top_k, embedding_fn=state.embed)

    @endpoint("batch", "search_batch")
    def search_batch(req):
        """One device batch for the whole list."""
        engine = state.get_engine(req.collection)
        return engine.search_many(req.queries, k=req.top_k, embedding_fn=state.embed)

    @endpoint("search", "faq_search")
    def faq_search(req):
        engine = state.get_engine(req.collection)
        return engine.faq_search(req.query, k=req.top_k, embedding_fn=state.embed)

    @endpoint("insert", "insert")
    def insert(req):
        """Live ingest (streaming mode only): embed -> dedup-append to the
        collection -> insert into the serving tier."""
        if req.metadata is not None and len(req.metadata) != len(req.texts):
            raise RequestError("metadata length != texts length")
        engine = state.get_engine(req.collection)
        ids = engine.insert_texts(req.texts, metadata_list=req.metadata,
                                  embedding_fn=state.embed)
        return {
            "inserted": len(ids),
            "skipped_duplicates": len(req.texts) - len(ids),
            "ids": [int(i) for i in ids],
            "n_total_live": int(engine.streaming.n_total_live),
        }

    @endpoint("delete", "delete")
    def delete(req):
        """Tombstone rows by vector id (streaming mode only; idempotent)."""
        engine = state.get_engine(req.collection)
        n_new = engine.delete_ids(req.ids)
        return {
            "deleted": n_new,
            "requested": len(req.ids),
            "n_total_live": int(engine.streaming.n_total_live),
        }

    async def collections(request):
        """Per-collection integrity report."""
        def work():
            return [_collection_entry(state.manager, info)
                    for info in state.manager.list_collections()]

        return web.json_response(await asyncio.to_thread(work))

    async def health(request):
        """Directory / env checks, and the device this server runs on."""
        base = pathlib.Path(state.base_dir)
        writable = False
        if base.exists():
            probe = base / ".write_probe"
            try:
                probe.write_text("ok")
                probe.unlink()
                writable = True
            except OSError:
                writable = False
        checks = {
            "collections_dir_exists": base.exists(),
            "collections_dir_writable": writable,
            "openai_api_key_set": bool(os.environ.get("OPENAI_API_KEY")),
            "embedding_provider": state.embedder.provider,
        }
        status = "ok" if base.exists() and writable else "degraded"
        return web.json_response(
            {"status": status, "checks": checks, "device": state.device_report()})

    async def ask(request):
        """Full RAG: search -> context -> LLM answer."""
        try:
            req = models["ask"](**await request.json())
        except (ValidationError, ValueError) as e:
            return json_error(422, str(e))
        t_total = time.perf_counter()
        try:
            engine = await asyncio.to_thread(state.get_engine, req.collection)
            t_emb = time.perf_counter()
            embedding = await asyncio.to_thread(state.embed, req.question)
            embedding_time = time.perf_counter() - t_emb
            t_search = time.perf_counter()
            results = await asyncio.to_thread(
                lambda: engine.search(
                    req.question, k=req.top_k, embedding_fn=lambda _t: embedding,
                )
            )
            diskann_time = time.perf_counter() - t_search
            search_time = time.perf_counter() - t_total
            timing = {
                "embedding_time": embedding_time,
                "diskann_time": diskann_time,
                "search_time": search_time,
            }
            if not results.get("results"):
                return web.json_response({
                    "answer": REFUSAL_ANSWER,
                    "timing": {**timing, "llm_time": 0, "total_time": search_time},
                })
            context = _build_context(results["results"])
            t_llm = time.perf_counter()
            try:
                answer = await asyncio.to_thread(
                    state.chat, _ASK_SYSTEM,
                    _ASK_PROMPT.format(context=context, question=req.question),
                )
                if any(k in answer.lower() for k in REFUSAL_KEYWORDS):
                    answer = REFUSAL_ANSWER
            except Exception:  # noqa: BLE001 — the answer says so, the log has the trace
                logger.exception("LLM call failed")
                answer = "抱歉，系統處理您的問題時發生錯誤。"
            return web.json_response({
                "answer": answer,
                "timing": {**timing, "llm_time": time.perf_counter() - t_llm,
                           "total_time": time.perf_counter() - t_total},
            })
        except Exception as e:  # noqa: BLE001 — a server keeps answering
            logger.exception("ask failed")
            return json_error(500, str(e))

    app.router.add_post("/search", search)
    app.router.add_post("/search-batch", search_batch)
    app.router.add_post("/insert", insert)
    app.router.add_post("/delete", delete)
    app.router.add_post("/faq-search", faq_search)
    app.router.add_get("/collections", collections)
    app.router.add_get("/health", health)
    app.router.add_post("/ask", ask)
    return app


def main(
    host: str = "0.0.0.0", port: int = 8000, config: str = "config.yaml",
    *, device: str = "cuda", base_dir: str = "collections",
) -> None:
    from aiohttp import web

    resolve_device(device)  # no card: stop before logging to a file or reading a config
    # stream + app.log file logging, like the reference
    logging.basicConfig(
        level=logging.INFO,
        handlers=[logging.StreamHandler(), logging.FileHandler("app.log")],
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    # honor ./config.yaml like the CLI does (embedding provider / model /
    # dimension: a mock fallback defaults to 1536-d and mismatches any
    # other collection). Only the embedding: block matters here, so a
    # serving-only config.yaml without a `collection` key works
    embedding_config = None
    if pathlib.Path(config).exists():
        import yaml

        with open(config, encoding="utf-8") as f:
            emb = (yaml.safe_load(f) or {}).get("embedding")
        # no embedding: block and no key -> the mock provider, as with no
        # config at all (EmbeddingConfig defaults to openai, which needs it)
        if emb is not None or os.environ.get("OPENAI_API_KEY"):
            embedding_config = EmbeddingConfig(**(emb or {}))
    state = AppState(base_dir=base_dir, embedding_config=embedding_config, device=device)
    state.prepare()  # kernels built and loaded before the server listens
    web.run_app(create_app(state), host=host, port=port)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="diskrag_tpu_torch HTTP API")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--config", default="config.yaml")
    ap.add_argument("--base-dir", default="collections")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    a = ap.parse_args()
    main(host=a.host, port=a.port, config=a.config, device=a.device, base_dir=a.base_dir)
