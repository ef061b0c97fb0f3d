"""The packed-int8 flat path (`flat_precision: int8_packed`) of the port
from the index down: `FlatIndex` (with its downgrades to per-row int8),
a packed JAX index carried across, build -> save -> load ->
`SearchEngine.search_batch`, the CLI, and the flat sweep — on the CPU
(`device="cpu"`, the plain versions of B2 / B3), against the JAX package
on the same numpy inputs."""

import json

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from diskrag_tpu.build_index import build_index_from_vectors as jax_build
from diskrag_tpu.data import (
    EmbeddingConfig,
    PreprocessingConfig,
    QuestionGenerationConfig,
    save_config,
)
from diskrag_tpu.data.collection import CollectionManager as JaxManager
from diskrag_tpu.data.config import CollectionInfo as JaxInfo, IndexConfig
from diskrag_tpu.ops.flat import FlatIndex as JaxFlat
from diskrag_tpu.ops.flat_scan_pallas import flat_search_fused as jax_fused

from diskrag_tpu_torch import benchmark as tbench
from diskrag_tpu_torch.benchmark import ground_truth, make_dataset, recall_at_k
from diskrag_tpu_torch.build_index import build_index_from_vectors as torch_build
from diskrag_tpu_torch.cli import main as torch_cli
from diskrag_tpu_torch.convert import flat_state_from_jax
from diskrag_tpu_torch.engine import SearchEngine as TorchEngine
from diskrag_tpu_torch.ops import flat_scan as tfs
from diskrag_tpu_torch.ops.distance import rerank_exact_topk
from diskrag_tpu_torch.ops.flat import FlatIndex


def _jax_packed_search(jidx, q, k, **kw):
    # the CPU backend runs the JAX index's fused route only interpreted
    jd, ji = jax_fused(
        jnp.asarray(q), jidx._fused_db, jidx.norms_sq, jidx.vectors, k=k,
        metric=jidx.metric, db_scale_global=jidx._fused_db_scale_global,
        db_nf=jidx._fused_nf, n_valid=jidx._fused_n_valid, interpret=True, **kw)
    return np.asarray(jd), np.asarray(ji)


@pytest.mark.parametrize("metric,rw", [("l2", None), ("cosine", None), ("l2", 20)])
def test_packed_flat_state_from_jax_gives_the_jax_results(metric, rw):
    pts, q = make_dataset(5000, 32, 16, seed=21)
    jidx = JaxFlat(pts, metric=metric, use_fused=True, fused_precision="int8_packed")
    assert jidx._fused_db_scale_global is not None
    arrays = {
        name: np.asarray(getattr(jidx, name))
        for name in ("vectors", "norms_sq", "_fused_db", "_fused_nf", "_fused_db_scale_global")
    }
    arrays["_fused_n_valid"] = jidx._fused_n_valid
    tidx = flat_state_from_jax(arrays, metric=metric, rerank_width=rw, device="cpu")
    assert tidx._fused_nf.shape == (1, 8192) and tidx._fused_n_valid == 5000
    td, ti = tidx.search(q, k=10)
    jd, ji = _jax_packed_search(jidx, q, 10, rerank_width=rw)
    assert np.array_equal(ji, ti.numpy())
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-5, atol=1e-5)


def test_flat_index_packed_builds_the_jax_table():
    pts, _ = make_dataset(5000, 32, 4, seed=22)
    for metric in ("l2", "cosine"):
        jidx = JaxFlat(pts, metric=metric, use_fused=True, fused_precision="int8_packed")
        tidx = FlatIndex(pts, metric=metric, fused_precision="int8_packed", device="cpu")
        assert tidx._fused_n_valid == jidx._fused_n_valid == 5000
        assert tidx._fused_db_scales is None and tidx._fused_db_norms is None
        if metric == "l2":  # the cosine copy is normalized with another rsqrt
            assert np.asarray(jidx._fused_db_scale_global) == tidx._fused_db_scale_global.numpy()
            assert np.array_equal(np.asarray(jidx._fused_db), tidx._fused_db.numpy())
        np.testing.assert_allclose(tidx._fused_db_scale_global.numpy(),
                                   np.asarray(jidx._fused_db_scale_global), rtol=1e-6)
        np.testing.assert_allclose(tidx._fused_nf.numpy()[0, :5000],
                                   np.asarray(jidx._fused_nf)[0, :5000], rtol=1e-5)


@pytest.mark.parametrize("precision", ["int8", "int8_packed", "bf16"])
def test_flat_index_aligns_the_scan_rows_once(precision):
    # D = 36: the scan copy's rows are widened to 16 bytes where the index is
    # built, so no search copies the table; results are the JAX index's
    pts, q = make_dataset(5000, 36, 16, seed=27)
    tidx = FlatIndex(pts, fused_precision=precision, device="cpu")
    width = 40 if precision == "bf16" else 48
    assert tidx._fused_db.shape[1] == width and tidx.vectors.shape[1] == 36
    td, ti = tidx.search(q, k=10)
    jidx = JaxFlat(pts, use_fused=True, fused_precision=precision)
    if precision == "int8_packed":
        jd, ji = _jax_packed_search(jidx, q, 10)
    else:
        jd, ji = jax_fused(
            jnp.asarray(q), jidx._fused_db, jidx._fused_db_norms
            if precision == "int8" else jidx.norms_sq, jidx.vectors, k=10,
            db_scales=jidx._fused_db_scales, n_valid=jidx._fused_n_valid, interpret=True)
        jd, ji = np.asarray(jd), np.asarray(ji)
    # a table built here: nf and the norms agree with XLA's to f32 rounding
    # only, so near-ties may move (the 99% rule of the port-built table)
    assert (ji == ti.numpy()).mean() >= 0.99
    assert tidx.search(q, k=10)[1].equal(ti)


@pytest.mark.parametrize("why", ["dot", "wide_rows", "no_layout_fits"])
def test_flat_index_packed_downgrades_to_per_row_int8(why, monkeypatch):
    rng = np.random.default_rng(0)
    d = 256 if why == "wide_rows" else 16
    pts = rng.normal(size=(300, d)).astype(np.float32)
    if why == "no_layout_fits":
        # past ~8M rows the reference's packed layout fits no TPU block
        assert tfs._packed_layout(10_000_000, 128, 1024, 1024, 2048)[2] == 0
        monkeypatch.setattr(tfs, "_packed_layout", lambda *a, **kw: (65536, 65536, 0, 0))
    idx = FlatIndex(pts, metric="dot" if why == "dot" else "l2",
                    fused_precision="int8_packed", device="cpu")
    assert idx._fused_db_scale_global is None and idx._fused_nf is None
    assert idx._fused_db_scales is not None and idx._fused_db_norms.shape[0] == 2
    _, ids = idx.search(pts[:4], k=3)
    want = np.argmax(pts[:4] @ pts.T, axis=1) if why == "dot" else np.arange(4)
    assert ids[:, 0].tolist() == want.tolist()


def test_unknown_precision_is_refused(tmp_path):
    pts = np.zeros((32, 8), np.float32)
    with pytest.raises(ValueError, match="fused_precision"):
        FlatIndex(pts, fused_precision="int4", device="cpu")
    with pytest.raises(ValueError, match="flat_precision"):
        torch_build(pts, tmp_path / "i", flat_precision="int4", device="cpu")


def test_rerank_handles_minus_one_inside_a_row():
    rng = np.random.default_rng(1)
    vecs = torch.as_tensor(rng.normal(size=(50, 8)).astype(np.float32))
    q = vecs[[3, 7]] + 0.01
    cand = torch.tensor([[9, -1, 3, -1, 12, 40], [-1, -1, 7, 1, -1, -1]], dtype=torch.int32)
    d, ids = rerank_exact_topk(q, vecs, cand, 4, "l2")
    assert ids[:, 0].tolist() == [3, 7]
    assert ids[0].tolist().count(-1) == 0 and sorted(ids[0].tolist()) == [3, 9, 12, 40]
    assert ids[1].tolist()[:2] == [7, 1] and ids[1].tolist()[2:] == [-1, -1]
    assert torch.isinf(d[1, 2:]).all() and torch.isfinite(d[0]).all()
    assert (d[:, 1:] >= d[:, :-1]).all()  # ascending, the +inf of a -1 slot last


def _collection(base, name, pts):
    mgr = JaxManager(base)
    (base / name).mkdir(parents=True)
    np.save(mgr.get_vectors_path(name), pts)
    mgr.save_collection_info(JaxInfo(
        name=name, config={}, dimension=pts.shape[1], num_vectors=len(pts),
        created_at="", updated_at="", source_files=[],
    ))
    return mgr.get_index_dir(name)


@pytest.mark.parametrize("built_by", ["jax", "torch"])
@pytest.mark.parametrize("metric,rw", [("l2", None), ("cosine", 20)])
def test_packed_index_builds_saves_loads_and_serves(built_by, metric, rw, tmp_path):
    """Either package's persisted packed index serves in the port. The
    port builds its own table at load, so its results are held to the JAX
    packed search by the port-built-table tolerance: equal ids on >= 99% of
    (query, rank) slots (nf differs in the last f32 bit, which can move a
    near-tie), recall within 0.002."""
    pts, q = make_dataset(6000, 32, 32, seed=23)
    index_dir = _collection(tmp_path, "c", pts)
    if built_by == "jax":
        meta = jax_build(pts, index_dir, index_type="flat", metric=metric,
                         flat_precision="int8_packed", flat_rerank_width=rw)
    else:
        meta = torch_build(pts, index_dir, index_type="flat", metric=metric,
                           flat_precision="int8_packed", flat_rerank_width=rw, device="cpu")
    assert meta["flat_precision"] == "int8_packed" and meta["flat_rerank_width"] == rw
    assert json.loads((index_dir / "meta.json").read_text())["flat_precision"] == "int8_packed"
    te = TorchEngine("c", base_dir=str(tmp_path), device="cpu")
    assert te.index_type == "flat" and not te.brute_force_mode
    assert te.flat._fused_db_scale_global is not None and te.flat.rerank_width == rw
    assert te.diagnostics["passed"]
    td, ti, ts = te.search_batch(q, k=10)
    assert ts["search_type"] == "flat" and ti.shape == (32, 10)
    assert np.isfinite(td).all() and (np.diff(td, axis=1) >= -1e-6).all()
    jidx = JaxFlat(pts, metric=metric, use_fused=True, fused_precision="int8_packed")
    jd, ji = _jax_packed_search(jidx, q, 10, rerank_width=rw)
    assert np.mean(ji == ti) >= 0.99
    gt = ground_truth(pts, q, 10, metric, device="cpu")
    assert abs(recall_at_k(ti, gt, 10) - recall_at_k(ji, gt, 10)) <= 0.002
    assert recall_at_k(ti, gt, 10) >= 0.9


def test_cli_indexes_and_searches_a_packed_collection(tmp_path, monkeypatch, capsys):
    cfg = PreprocessingConfig(
        collection="faq",
        embedding=EmbeddingConfig(provider="mock", model="mock", dimension=64),
        question_generation=QuestionGenerationConfig(enabled=False),
        index=IndexConfig(type="flat", flat_precision="int8_packed", flat_rerank_width=16),
    )
    rows = [{"id": f"q{i}", "question": f"如何使用功能{i}？", "answer": f"功能{i}的答案。"}
            for i in range(24)]
    save_config(cfg, tmp_path / "config.yaml")
    pd.DataFrame(rows).to_csv(tmp_path / "faq.csv", index=False)
    monkeypatch.chdir(tmp_path)
    assert torch_cli(["process", "faq.csv", "-c", "faq"]) == 0
    assert torch_cli(["--device", "cpu", "index", "faq"]) == 0
    assert "precision=int8_packed" in capsys.readouterr().out
    meta = json.loads((tmp_path / "collections" / "faq" / "index" / "meta.json").read_text())
    assert meta["flat_precision"] == "int8_packed" and meta["flat_rerank_width"] == 16
    tfs.reset_launch_counts()
    assert torch_cli(["--device", "cpu", "search", "faq", "如何使用功能3?", "-k", "3", "--faq"]) == 0
    assert "功能3" in capsys.readouterr().out
    assert tfs.scan_bucketed_topk_packed.launches == 0  # CPU tensors launch nothing


def test_sweep_flat_and_adaptive_point_on_cpu():
    pts, q = make_dataset(4000, 32, 32, seed=24)
    gt = ground_truth(pts, q, 10, device="cpu")
    points = tbench.sweep_flat(pts, q, gt, k=10, repeats=1, min_seconds=0.0, device="cpu")
    modes = [p.mode for p in points]
    assert modes[:4] == ["flat", "flat-rr24", "flat-packed", "flat-packed-rr24"]
    assert modes[4].startswith("flat-packed-rr") and modes[4].endswith("-auto")
    auto = points[4]
    assert 10 <= auto.search_width <= 48 and auto.recall >= 0.95
    assert all(p.qps > 0 and p.mean_latency_ms > 0 for p in points)
    by = {p.mode: p for p in points}
    assert by["flat"].recall >= 0.98 and by["flat-packed"].recall >= 0.97
    assert by["flat-packed-rr24"].recall <= by["flat-packed"].recall + 1e-9
    # dot has no packed fold: only the per-row points
    dot = tbench.sweep_flat(pts, q, ground_truth(pts, q, 10, "dot", device="cpu"), k=10,
                            metric="dot", repeats=1, min_seconds=0.0, device="cpu")
    assert [p.mode for p in dot] == ["flat", "flat-rr24"]
    # an unreachable target gives no adaptive point
    assert tbench.adaptive_flat_point(pts, q, gt, k=10, target_recall=1.01, repeats=1,
                                      min_seconds=0.0, device="cpu") is None
