"""Engine-level and HTTP-level serving throughput (counterpart of
`benchmarks/serving_bench.py`): what a user gets from
`SearchEngine.search_many` (embedder lookup, one device batch, the packed
result copy, the text join), from the pipelined stream
`SearchEngine.search_pipelined`, and from `POST /search-batch` (request
parse and JSON assembly on top), in each explicit serving mode.

Protocol, as the JAX script's: a collection over the benchmark points
(texts and metadata appended in chunks of 100,000 rows), a mock embedder
that looks each query text up in a dict, one full-shape warm-up before
every timed call, the best of `repeats` timed calls. Modes in the JAX
order: "flat" (with "flat_pipelined"), "vamana" at `l_search=16`
("http_vamana" beside it when `http`), "streaming" at `l_search=16`, then
"host_tier" last (iq8 rows and the record file persisted over the vamana
index, `recommended_search_L` 24, E 8), because it rewrites the index
meta.

    python -m diskrag_tpu_torch.tools.serving_bench [--n 200000] [--batches 64 512 1024]
        [--repeats 5] [--no-http] [--device cuda]

prints one JSON record (`bench_cuda.py` calls `measure_serving` in process).
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time


def make_collection(base_dir, pts, name: str = "bench"):
    """A collection over the benchmark points: texts, metadata and
    vectors.npy, appended in chunks of 100,000 rows (bounds the parquet
    concat's peak memory). An existing collection of the same size is
    reused. Returns the `CollectionManager`."""
    from diskrag_tpu_torch.data.collection import CollectionManager

    mgr = CollectionManager(base_dir)
    info = mgr.get_collection_info(name)
    if info is not None and info.num_vectors == len(pts):
        return mgr
    mgr.create_collection(name, int(pts.shape[1]))
    chunk = 100_000
    for lo in range(0, len(pts), chunk):
        hi = min(lo + chunk, len(pts))
        mgr.update_collection(
            name, pts[lo:hi], [f"doc {i}" for i in range(lo, hi)], [{"i": i} for i in range(lo, hi)],
        )
    return mgr


def _time_calls(fn, warm_args, timed_args, repeats: int) -> float:
    """Best-of-`repeats` wall seconds after one full-shape warm-up. Engine
    calls return host results, so the wall clock closes on finished work."""
    fn(*warm_args)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*timed_args)
        best = min(best, time.perf_counter() - t0)
    return best


def measure_engine_qps(
    engine, queries, *, batch: int, k: int = 10, repeats: int = 5,
    l_search: int | None = None,
) -> dict:
    """`search_many` QPS at one batch size, with the stages of the best
    timed call in ms: `embed` (the dict lookups), `search` (`search_batch`:
    upload, dispatch, the wait for the batch's event and the decode),
    `fetch` (that wait and decode alone, the engine's `fetch_time`),
    `text_join` (the rest of the call) and `text_join_cold` (the warm-up
    call's join, which pays the column store's first decode of the rows);
    `tier`, the host tier's own stage split, where the engine reports one."""
    qtexts = [f"q{i}" for i in range(batch)]
    lut = {f"q{i}": queries[i % len(queries)] for i in range(batch)}

    def call(texts):
        return engine.search_many(texts, k=k, embedding_fn=lut.__getitem__, l_search=l_search)

    def join_ms(res):
        t = res["timing"]
        return (t["total_time"] - t["embedding_time"] - t["search_time"]) * 1e3

    warm = call(qtexts)
    cold_join = join_ms(warm)
    best_dt, best = float("inf"), warm
    for _ in range(repeats):
        t0 = time.perf_counter()
        res = call(qtexts)
        dt = time.perf_counter() - t0
        if dt < best_dt:
            best_dt, best = dt, res
    t = best["timing"]
    out = {
        "qps": batch / best_dt,
        "batch": batch,
        "latency_ms": best_dt * 1e3,
        "search_type": best["stats"]["search_type"],
        "stage_ms": {
            "embed": round(t["embedding_time"] * 1e3, 2),
            "search": round(t["search_time"] * 1e3, 2),
            "fetch": round(best["stats"]["fetch_time"] * 1e3, 2),
            "text_join": round(join_ms(best), 2),
            "text_join_cold": round(cold_join, 2),
        },
    }
    if "stage_ms" in best["stats"]:
        out["stage_ms"]["tier"] = {kk: round(vv, 1) for kk, vv in best["stats"]["stage_ms"].items()}
    return out


def measure_pipelined_qps(
    engine, queries, *, batch: int, n_batches: int = 16, k: int = 10,
    repeats: int = 3, l_search: int | None = None, max_in_flight: int = 8,
) -> dict:
    """Sustained QPS of `search_pipelined` over `n_batches` batches of
    `batch` texts, `max_in_flight` in flight; best of `repeats`."""
    batches = [[f"q{i}" for i in range(batch)] for _ in range(n_batches)]
    lut = {f"q{i}": queries[i % len(queries)] for i in range(batch)}

    def call(bs):
        return engine.search_pipelined(bs, k=k, embedding_fn=lut.__getitem__,
                                       l_search=l_search, max_in_flight=max_in_flight)

    dt = _time_calls(call, (batches,), (batches,), repeats)
    return {
        "qps": batch * n_batches / dt,
        "batch": batch,
        "n_batches": n_batches,
        "max_in_flight": max_in_flight,
        "latency_ms_per_batch": dt / n_batches * 1e3,
    }


def measure_http_qps(
    base_dir, queries, *, batch: int, k: int = 10, repeats: int = 5,
    collection: str = "bench", device: str = "cuda",
) -> dict:
    """`POST /search-batch` through the port's aiohttp app on a local test
    server: mean wall ms of `repeats` requests after one warm-up."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from diskrag_tpu_torch.api import AppState, create_app

    state = AppState(base_dir=str(base_dir), device=device)
    lut = {f"q{i}": queries[i % len(queries)] for i in range(batch)}
    state.embed = lut.__getitem__
    app = create_app(state)
    payload = {"collection": collection, "queries": [f"q{i}" for i in range(batch)], "top_k": k}

    async def run():
        async with TestClient(TestServer(app)) as client:
            r = await client.post("/search-batch", json=payload)
            if r.status != 200:
                raise RuntimeError(f"/search-batch answered {r.status}: {await r.text()}")
            t0 = time.perf_counter()
            for _ in range(repeats):
                r = await client.post("/search-batch", json=payload)
                await r.json()
            return (time.perf_counter() - t0) / repeats

    dt = asyncio.run(run())
    return {"qps": batch / dt, "batch": batch, "latency_ms": dt * 1e3}


def measure_serving(
    pts,
    queries,
    *,
    index=None,
    batches=(512,),
    k: int = 10,
    repeats: int = 5,
    http: bool = True,
    tmp_dir: str | None = None,
    modes=("flat", "vamana", "streaming", "host_tier"),
    device: str = "cuda",
) -> dict:
    """Build a collection over `pts` and measure its serving in `modes`.
    `index`: a `VamanaIndex` over `pts` already built (else the vamana
    modes build one: degree 48, alpha 1.2, seed 0). `tmp_dir` None works
    in a temporary directory removed at the end. Returns {mode: [row per
    batch]}, with "flat_pipelined", "http_vamana" and
    "host_tier_prep_seconds" beside the modes that make them."""
    from diskrag_tpu_torch.build_index import build_index_from_vectors
    from diskrag_tpu_torch.device import resolve_device
    from diskrag_tpu_torch.engine import SearchEngine
    from diskrag_tpu_torch.index.persist import save_index

    device = str(resolve_device(device))  # raise before any file is written
    own_tmp = tmp_dir is None
    base = tmp_dir or tempfile.mkdtemp(prefix="diskrag_serving_")
    out: dict = {}

    def engine(mode: str = "auto"):
        return SearchEngine("bench", base_dir=base, run_diagnostics=False, serving_mode=mode,
                            device=device)

    def rows(eng, l_search=None):
        return [measure_engine_qps(eng, queries, batch=b, k=k, repeats=repeats, l_search=l_search)
                for b in batches]

    try:
        index_dir = make_collection(base, pts).get_index_dir("bench")
        if "flat" in modes:
            build_index_from_vectors(pts, index_dir, index_type="flat", force_rebuild=True,
                                     device=device)
            eng = engine()
            out["flat"] = rows(eng)
            out["flat_pipelined"] = [
                measure_pipelined_qps(eng, queries, batch=b, k=k, repeats=max(2, repeats - 2))
                for b in batches
            ]
            del eng
        if {"vamana", "streaming", "host_tier"} & set(modes):
            if index is None:
                from diskrag_tpu_torch.graph.knn_build import build_vamana_knn

                index = build_vamana_knn(pts, degree_bound=48, alpha=1.2, seed=0, device=device)
            save_index(index_dir, index, host_vectors=pts)
        if "vamana" in modes:
            out["vamana"] = rows(engine(), l_search=16)
            if http:
                out["http_vamana"] = [
                    measure_http_qps(base, queries, batch=b, k=k, repeats=repeats, device=device)
                    for b in batches
                ]
        if "streaming" in modes:
            out["streaming"] = rows(engine("streaming"), l_search=16)
        if "host_tier" in modes:
            from diskrag_tpu_torch.pq.intq import IntQuantizer

            t0 = time.perf_counter()
            iq8 = IntQuantizer(bits=8, device=device).fit(pts, seed=0)
            save_index(
                index_dir, index, pq=iq8, pq_codes=iq8.encode(pts),
                meta_extra={"recommended_search_L": 24, "recommended_expand_width": 8},
                write_compat=True, host_vectors=pts,
            )
            prep_s = time.perf_counter() - t0
            out["host_tier"] = rows(engine("host_tier"))
            out["host_tier_prep_seconds"] = round(prep_s, 1)
    finally:
        if own_tmp:
            shutil.rmtree(base, ignore_errors=True)
    return out


def main(argv: list[str] | None = None) -> int:
    from diskrag_tpu_torch.benchmark import make_dataset

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--batches", type=int, nargs="+", default=[64, 512, 1024])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--no-http", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    pts, queries = make_dataset(args.n, args.dim, 1024)
    t0 = time.perf_counter()
    out = measure_serving(pts, queries, batches=tuple(args.batches), repeats=args.repeats,
                          http=not args.no_http, device=args.device)
    print(json.dumps({"n": args.n, "dim": args.dim, "device": args.device,
                      "wall_seconds": round(time.perf_counter() - t0, 1), "results": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
