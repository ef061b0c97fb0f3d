"""The sharded index through the port's entry points, on the CPU, mirroring
`tests/test_engine.py:219-366`: `build_index_from_vectors(index_type=
"sharded")`, `SearchEngine` in modes "auto", "sharded_flat" and
"host_tier" over `mesh_devices=["cpu"] * 8` (2 x 4), skip-if-exists, the
configuration errors, both packages serving each other's directories, the
CLI (`--index-type sharded --shards N`, `--serving-mode sharded_flat`), the
HTTP API's `/search` and `tools.verify_index`."""

import asyncio
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

torch.set_num_threads(2)  # the suite runs several workers: do not let each spin a thread per core

from diskrag_tpu.build_index import build_index_from_vectors as jax_build
from diskrag_tpu.engine import SearchEngine as JaxEngine

from diskrag_tpu_torch.build_index import build_index_from_vectors
from diskrag_tpu_torch.data import (
    EmbeddingConfig,
    PreprocessingConfig,
    QuestionGenerationConfig,
    save_config,
)
from diskrag_tpu_torch.data.collection import CollectionManager
from diskrag_tpu_torch.engine import SearchEngine, ServingConfigError

MESH = ["cpu"] * 8
MODES = {"auto": "sharded", "sharded_flat": "sharded_flat", "host_tier": "sharded_host_tier"}


def _collection(base, vecs):
    mgr = CollectionManager(base)
    mgr.create_collection("c", dimension=vecs.shape[1])
    mgr.update_collection("c", vecs, [f"text {i}" for i in range(len(vecs))],
                          [{"i": i} for i in range(len(vecs))])
    return mgr.get_index_dir("c")


@pytest.fixture(scope="module")
def built(clustered_data, tmp_path_factory):
    """{builder: collections base} of a 1200-point sharded index (4 shards,
    residual PQ, record file) built by each package."""
    vecs = clustered_data[:1200]
    out = {}
    for who, build in (("port", build_index_from_vectors), ("jax", jax_build)):
        base = tmp_path_factory.mktemp(f"sharded_{who}")
        kw = {"device": "cpu"} if who == "port" else {}
        meta = build(vecs, _collection(base, vecs), index_type="sharded", n_shards=4,
                     write_compat=True, **kw)
        assert meta["index_type"] == "sharded" and meta["n_shards"] == 4
        out[who] = base
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_serves_sharded_index(built, clustered_data, mode):
    vecs = clustered_data[:1200]
    eng = SearchEngine("c", base_dir=built["port"], serving_mode=mode, device="cpu",
                       mesh_devices=MESH)
    assert eng.mesh.shape == {"data": 2, "shard": 4}
    d = eng.diagnostics
    assert d["serving_mode"] == ("sharded" if mode == "auto" else mode)
    assert d["passed"] and d["self_retrieval_rate"] >= 0.8, d
    out = eng.search("q", k=3, l_search=48, embedding_fn=lambda t: vecs[42])
    assert out["stats"]["search_type"] == MODES[mode]
    assert out["results"][0]["text"] == "text 42"
    # B = 5 pads the data axis
    dists, ids, stats = eng.search_batch(vecs[[10, 20, 30, 40, 50]], k=5, l_search=48)
    assert ids.shape == (5, 5)
    np.testing.assert_array_equal(ids[:, 0], [10, 20, 30, 40, 50])
    assert (np.diff(dists, axis=1) >= -1e-6).all()
    if mode != "sharded_flat":
        assert stats["rounds"] > 0 and stats["n_shards"] == 4
    if mode == "host_tier":
        assert stats["mode"] == "pq" and out["results"][0]["distance"] < 1e-3
        assert eng.host_tier.guide.cells is not None  # the default build's residual PQ
    assert eng.get_search_statistics()["total_searches"] == 6


@pytest.mark.parametrize("mode", list(MODES))
def test_both_packages_serve_each_others_sharded_directory(built, clustered_data, mode):
    """The JAX engine (emulated 2 x 4 mesh) and the port's on one
    directory built by the other package: the same top-1 on self-queries
    and >= 90% equal result slots."""
    vecs = clustered_data[:1200]
    q = vecs[np.random.default_rng(5).integers(0, 1200, size=16)]
    for who in ("port", "jax"):
        ours = SearchEngine("c", base_dir=built[who], serving_mode=mode, device="cpu",
                            mesh_devices=MESH, run_diagnostics=False)
        theirs = JaxEngine("c", base_dir=str(built[who]), serving_mode=mode,
                           run_diagnostics=False)
        _, ti, ts = ours.search_batch(q, k=5, l_search=48)
        _, ji, js = theirs.search_batch(q, k=5, l_search=48)
        assert ts["search_type"] == js["search_type"] == MODES[mode]
        assert np.array_equal(ti[:, 0], ji[:, 0])
        assert (np.asarray(ti) == np.asarray(ji)).mean() >= 0.9


def test_skip_if_exists_and_shard_count_warning(built, clustered_data, caplog):
    vecs = clustered_data[:1200]
    index_dir = CollectionManager(built["port"]).get_index_dir("c")
    meta = build_index_from_vectors(vecs, index_dir, index_type="sharded", n_shards=4,
                                    device="cpu")
    again = build_index_from_vectors(vecs, index_dir, index_type="sharded", n_shards=2,
                                     device="cpu")
    assert again["build_seconds"] == meta["build_seconds"] and again["n_shards"] == 4
    assert "existing sharded index has 4 shards, requested 2" in caplog.text
    assert len(meta["build_shards"]) == 4
    assert sum(s["rows"] for s in meta["build_shards"]) == 1200


def test_shard_count_must_divide_the_mesh(clustered_data, tmp_path):
    """A 3-shard index on the CPU's one default device (or on 4 mesh slots)
    is a configuration error, in mode "auto" and under host_tier; on 3
    slots it is served."""
    vecs = clustered_data[:600]
    build_index_from_vectors(vecs, _collection(tmp_path, vecs), index_type="sharded",
                             n_shards=3, write_compat=True, device="cpu")
    for mode in ("auto", "host_tier", "sharded_flat"):
        with pytest.raises(ServingConfigError, match="3 shards"):
            SearchEngine("c", base_dir=tmp_path, serving_mode=mode, device="cpu")
        with pytest.raises(ServingConfigError, match="mesh_devices"):
            SearchEngine("c", base_dir=tmp_path, serving_mode=mode, device="cpu",
                         mesh_devices=["cpu"] * 4)
    eng = SearchEngine("c", base_dir=tmp_path, device="cpu", mesh_devices=["cpu"] * 3)
    assert eng.mesh.shape == {"data": 1, "shard": 3} and not eng.brute_force_mode


def test_configuration_errors(clustered_data, tmp_path):
    vecs = clustered_data[:1200]
    index_dir = _collection(tmp_path / "s", vecs)
    build_index_from_vectors(vecs, index_dir, index_type="sharded", n_shards=4, device="cpu")
    # no record file: host_tier refuses (never a brute-force load of the f32 set)
    with pytest.raises(ServingConfigError, match="packed record file"):
        SearchEngine("c", base_dir=tmp_path / "s", serving_mode="host_tier", device="cpu",
                     mesh_devices=MESH)
    # streaming wraps one vamana graph
    with pytest.raises(ServingConfigError, match="streaming serving needs a loaded vamana"):
        SearchEngine("c", base_dir=tmp_path / "s", serving_mode="streaming", device="cpu",
                     mesh_devices=MESH)
    # a missing shard directory: brute force in mode "auto", an error otherwise
    shutil.rmtree(index_dir / "sharded")
    eng = SearchEngine("c", base_dir=tmp_path / "s", device="cpu", mesh_devices=MESH)
    assert eng.brute_force_mode
    assert eng.search_batch(vecs[:2], k=3)[2]["search_type"] == "brute_force"
    with pytest.raises(ServingConfigError, match="could not load"):
        SearchEngine("c", base_dir=tmp_path / "s", serving_mode="sharded_flat", device="cpu",
                     mesh_devices=MESH)
    # sharded_flat on an index that is not sharded
    flat_dir = _collection(tmp_path / "f", vecs[:100])
    build_index_from_vectors(vecs[:100], flat_dir, index_type="flat", device="cpu")
    with pytest.raises(ServingConfigError, match="needs a sharded index"):
        SearchEngine("c", base_dir=tmp_path / "f", serving_mode="sharded_flat", device="cpu")


def test_verify_index_checks_the_sharded_files(built):
    from diskrag_tpu_torch.tools.verify_index import verify_index

    index_dir = CollectionManager(built["port"]).get_index_dir("c")
    report = verify_index(index_dir, device="cpu")
    assert report["ok"] and report["index_type"] == "sharded", report
    for name in ("sharded_format", "n_shards", "entry_points_exists", "vectors_shape",
                 "global_ids_cover_points", "record_file_size"):
        assert report["checks"][name]["passed"], name
    jax_dir = CollectionManager(built["jax"]).get_index_dir("c")
    assert verify_index(jax_dir, device="cpu")["ok"]


def test_verify_index_reports_a_broken_sharded_directory(built, tmp_path):
    from diskrag_tpu_torch.tools.verify_index import verify_index

    src = CollectionManager(built["port"]).get_index_dir("c")
    d = tmp_path / "index"
    shutil.copytree(src, d)
    g = np.load(d / "sharded" / "global_ids.npy")
    g[0, 0] = g[0, 1]  # one point twice, one missing
    np.save(d / "sharded" / "global_ids.npy", g)
    (d / "sharded" / "entry_points.npy").unlink()
    report = verify_index(d, device="cpu")
    assert not report["ok"]
    assert not report["checks"]["entry_points_exists"]["passed"]


MOCK = dict(provider="mock", model="mock", dimension=128)
CPU = ["--device", "cpu"]


@pytest.fixture()
def workspace(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    save_config(PreprocessingConfig(collection="faq", embedding=EmbeddingConfig(**MOCK),
                                    question_generation=QuestionGenerationConfig(enabled=False)),
                tmp_path / "config.yaml")
    rows = [{"id": f"q{i}", "question": f"如何使用功能{i}？", "answer": f"功能{i}的答案。"}
            for i in range(40)]
    pd.DataFrame(rows).to_csv(tmp_path / "faq.csv", index=False)
    return tmp_path


def test_cli_builds_and_serves_sharded(workspace, capsys):
    from diskrag_tpu_torch.cli import main as cli_main

    assert cli_main([*CPU, "process", "faq.csv", "--collection", "faq"]) == 0
    assert cli_main([*CPU, "index", "faq", "--index-type", "sharded", "--shards", "4"]) == 0
    assert "index built: type=sharded N=40" in capsys.readouterr().out
    # four shards on the CLI's one CPU device: the configuration error
    with pytest.raises(ServingConfigError, match="4 shards"):
        cli_main([*CPU, "search", "faq", "如何使用功能3?", "-k", "3"])
    assert cli_main([*CPU, "index", "faq", "--index-type", "sharded", "--shards", "1",
                     "--force-rebuild"]) == 0
    capsys.readouterr()
    for mode in ("auto", "sharded_flat"):
        assert cli_main([*CPU, "search", "faq", "如何使用功能3?", "-k", "3",
                         "--serving-mode", mode]) == 0
        assert "功能3" in capsys.readouterr().out
    # host_tier needs the record file (the config's index.write_compat)
    with pytest.raises(ServingConfigError, match="packed record file"):
        cli_main([*CPU, "search", "faq", "q", "--serving-mode", "host_tier"])


def test_cli_serves_sharded_host_tier(workspace, capsys):
    from diskrag_tpu_torch.cli import DiskRAG, main as cli_main

    rag = DiskRAG("config.yaml", device="cpu")
    rag.process("faq.csv", "faq")
    rag.config.index.write_compat = True
    meta = rag.build_index("faq", index_type="sharded", n_shards=1)
    assert meta["write_compat"] and meta["n_shards"] == 1
    out = rag.search("faq", "如何使用功能7?", k=3, serving_mode="host_tier")
    assert out["stats"]["search_type"] == "sharded_host_tier"
    assert "功能7" in out["results"][0]["text"]


@pytest.mark.parametrize("mode", list(MODES))
def test_api_search_on_sharded_collection(workspace, mode):
    from aiohttp.test_utils import TestClient, TestServer

    from diskrag_tpu_torch.api import AppState, create_app
    from diskrag_tpu_torch.cli import DiskRAG

    rag = DiskRAG("config.yaml", device="cpu")
    rag.process("faq.csv", "faq")
    rag.config.index.write_compat = True
    rag.build_index("faq", index_type="sharded", n_shards=4)
    state = AppState(base_dir="collections", embedding_config=EmbeddingConfig(**MOCK),
                     serving_mode=mode, device="cpu", mesh_devices=["cpu"] * 4)

    async def go():
        async with TestClient(TestServer(create_app(state))) as client:
            resp = await client.post("/search", json={"collection": "faq",
                                                      "query": "如何使用功能5?", "top_k": 3})
            listing = await client.get("/collections")
            return resp.status, await resp.json(), await listing.json()

    loop = asyncio.new_event_loop()
    try:
        status, data, listing = loop.run_until_complete(go())
    finally:
        loop.close()
    assert status == 200, data
    assert data["stats"]["search_type"] == MODES[mode]
    assert "功能5" in data["results"][0]["text"]
    entry = next(c for c in listing if c["name"] == "faq")
    assert entry["status"] == "ready", entry
