"""The port's index, engine and CLI against the JAX package: an index
carried across with `convert.flat_state_from_jax` computes what the JAX
index computes, an index persisted by either package is served by the
other with the same results, and the two CLIs agree end to end on a
mock-embedded FAQ collection. All on the CPU (`device="cpu"`)."""

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from diskrag_tpu.build_index import build_index_from_vectors as jax_build
from diskrag_tpu.cli import main as jax_cli
from diskrag_tpu.data import (
    EmbeddingConfig,
    PreprocessingConfig,
    QuestionGenerationConfig,
    save_config,
)
from diskrag_tpu.data.collection import CollectionManager as JaxManager
from diskrag_tpu.data.config import CollectionInfo as JaxInfo, IndexConfig
from diskrag_tpu.engine import SearchEngine as JaxEngine
from diskrag_tpu.ops.flat import FlatIndex as JaxFlat
from diskrag_tpu.ops.flat_scan_pallas import flat_search_fused as jax_fused

from diskrag_tpu_torch.benchmark import make_dataset
from diskrag_tpu_torch.build_index import build_index_from_vectors as torch_build
from diskrag_tpu_torch.cli import main as torch_cli
from diskrag_tpu_torch.convert import flat_state_from_jax
from diskrag_tpu_torch.engine import SearchEngine as TorchEngine


def test_make_dataset_byte_identical():
    from diskrag_tpu.benchmark import make_dataset as jax_make

    for a, b in zip(make_dataset(3000, 24, 50, seed=9), jax_make(3000, 24, 50, seed=9)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_ground_truth_matches_jax():
    from diskrag_tpu.benchmark import ground_truth as jax_gt
    from diskrag_tpu_torch.benchmark import ground_truth, recall_at_k

    pts, q = make_dataset(5000, 32, 40, seed=10)
    got = ground_truth(pts, q, 10, device="cpu")
    want = jax_gt(pts, q, 10)
    assert recall_at_k(got, want, 10) == 1.0


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_flat_state_from_jax_gives_the_jax_results(metric):
    pts, q = make_dataset(3000, 32, 16, seed=11)
    jidx = JaxFlat(pts, metric=metric, use_fused=True)
    arrays = {
        name: np.asarray(getattr(jidx, name))
        for name in ("vectors", "_fused_db", "_fused_db_norms", "_fused_db_scales")
    }
    arrays["_fused_n_valid"] = jidx._fused_n_valid
    tidx = flat_state_from_jax(arrays, metric=metric, device="cpu")
    td, ti = tidx.search(q, k=10)
    # the CPU backend runs the JAX index's fused route only interpreted
    jd, ji = jax_fused(
        jnp.asarray(q), jidx._fused_db, jidx._fused_db_norms, jidx.vectors,
        k=10, metric=metric, db_scales=jidx._fused_db_scales,
        n_valid=jidx._fused_n_valid, interpret=True,
    )
    assert np.array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    assert torch.equal(tidx._fused_db, torch.from_numpy(arrays["_fused_db"].copy()))


def _collection(base, name, pts):
    """A collection directory (collection_info.json + vectors.npy)."""
    mgr = JaxManager(base)
    (base / name).mkdir(parents=True)
    np.save(mgr.get_vectors_path(name), pts)
    mgr.save_collection_info(JaxInfo(
        name=name, config={}, dimension=pts.shape[1], num_vectors=len(pts),
        created_at="", updated_at="", source_files=[],
    ))
    return mgr.get_index_dir(name)


@pytest.mark.parametrize("builder", ["jax", "torch"])
@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_index_built_by_either_package_serves_in_the_other(builder, metric, tmp_path):
    # 120 rows: NB shrinks to 128, one row per bucket, so both engines'
    # flat paths are exact and their answers comparable id for id
    pts, q = make_dataset(120, 16, 12, seed=12)
    index_dir = _collection(tmp_path, "c", pts)
    build = jax_build if builder == "jax" else torch_build
    kw = {} if builder == "jax" else {"device": "cpu"}
    meta = build(pts, index_dir, index_type="flat", metric=metric, **kw)
    assert meta["index_type"] == "flat" and meta["format_version"] == "tpu-1"
    je = JaxEngine("c", base_dir=str(tmp_path))
    te = TorchEngine("c", base_dir=str(tmp_path), device="cpu")
    assert not te.brute_force_mode and te.index_type == "flat"
    assert te.diagnostics["passed"] and te.diagnostics["self_retrieval_rate"] == 1.0
    jd, ji, js = je.search_batch(q, k=5)
    td, ti, ts = te.search_batch(q, k=5)
    assert np.array_equal(ji, ti)
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-5)
    assert ts["search_type"] == js["search_type"] == "flat"
    stats = te.get_search_statistics()
    assert stats["total_searches"] == 12 and stats["total_nodes_visited"] == 12 * 120


def test_engine_brute_force_mode_without_an_index(tmp_path):
    pts, q = make_dataset(120, 16, 6, seed=13)
    _collection(tmp_path, "c", pts)
    te = TorchEngine("c", base_dir=str(tmp_path), device="cpu")
    je = JaxEngine("c", base_dir=str(tmp_path))
    assert te.brute_force_mode and je.brute_force_mode
    _, ti, ts = te.search_batch(q, k=5)
    _, ji, _ = je.search_batch(q, k=5)
    assert ts["search_type"] == "brute_force"
    assert np.array_equal(ti, ji)


@pytest.fixture()
def faq_dirs(tmp_path):
    cfg = PreprocessingConfig(
        collection="faq",
        embedding=EmbeddingConfig(provider="mock", model="mock", dimension=64),
        question_generation=QuestionGenerationConfig(enabled=False),
        index=IndexConfig(type="flat"),
    )
    rows = [
        {"id": f"q{i}", "question": f"如何使用功能{i}？", "answer": f"功能{i}的答案。"}
        for i in range(24)
    ]
    dirs = []
    for sub in ("jax", "torch"):
        d = tmp_path / sub
        d.mkdir()
        save_config(cfg, d / "config.yaml")
        pd.DataFrame(rows).to_csv(d / "faq.csv", index=False)
        dirs.append(d)
    return dirs


def _results(out: str) -> list[str]:
    return [ln for ln in out.splitlines() if ln.startswith(("#", "  Q:", "  A:"))]


def test_cli_process_index_search_matches_jax(faq_dirs, monkeypatch, capsys):
    jdir, tdir = faq_dirs
    monkeypatch.chdir(jdir)
    assert jax_cli(["process", "faq.csv", "-c", "faq"]) == 0
    assert jax_cli(["index", "faq", "--index-type", "flat"]) == 0
    capsys.readouterr()
    assert jax_cli(["search", "faq", "如何使用功能3?", "-k", "4", "--faq"]) == 0
    jax_out = _results(capsys.readouterr().out)

    monkeypatch.chdir(tdir)
    assert torch_cli(["process", "faq.csv", "-c", "faq"]) == 0
    assert torch_cli(["--device", "cpu", "index", "faq", "--type", "flat"]) == 0
    assert "type=flat N=24" in capsys.readouterr().out
    assert torch_cli(["--device", "cpu", "search", "faq", "如何使用功能3?", "-k", "4",
                      "--faq"]) == 0
    torch_out = _results(capsys.readouterr().out)
    assert torch_cli(["--device", "cpu", "list"]) == 0
    assert "faq: 24 vectors" in capsys.readouterr().out

    # the mock embedder is byte-identical, so are the collections
    jv = np.load(jdir / "collections" / "faq" / "vectors.npy")
    tv = np.load(tdir / "collections" / "faq" / "vectors.npy")
    assert jv.tobytes() == tv.tobytes()
    assert len(torch_out) == len(jax_out) > 0
    assert torch_out == jax_out
    assert "功能3" in torch_out[1]

    assert torch_cli(["delete", "faq"]) == 0
    assert "deleted" in capsys.readouterr().out
