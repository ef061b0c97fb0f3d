"""The port's Vamana slice end to end against the JAX package: persistence,
the engine's "pq_accelerated" and "exact" modes on indexes built by either
package (no PQ, plain PQ, residual PQ), torn artifact sets, the build
defaults' meta, the CLI and the graph sweeps. All on the CPU.

Each package builds each kind of index once per module; every test reuses
those directories (a torn-artifact test works on a copy)."""

import json
import logging
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

torch.set_num_threads(2)  # the suite runs several workers: do not let each spin a thread per core

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
from diskrag_tpu.index.persist import load_index as jax_load_index

from diskrag_tpu_torch.benchmark import ground_truth, make_dataset, recall_at_k, sweep_exact, sweep_pq
from diskrag_tpu_torch.build_index import (
    attach_pq,
    build_index_from_vectors as torch_build,
    calculate_adaptive_build_params,
    calculate_adaptive_search_L,
)
from diskrag_tpu_torch.cli import main as torch_cli
from diskrag_tpu_torch.engine import SearchEngine as TorchEngine
from diskrag_tpu_torch.index.persist import IndexStore, load_index, load_pq_aux, save_index
from diskrag_tpu_torch.pq import ProductQuantizer, ResidualPQ

N, D, B, K = 2000, 32, 40, 10
KINDS = {
    "none": dict(force_pq=False),
    "plain": dict(force_pq=True, pq_kind="plain"),
    "residual": dict(force_pq=True),  # pq_kind "auto": residual on an l2 index
}


def _collection(base, name, pts):
    mgr = JaxManager(base)
    (base / name).mkdir(parents=True)
    np.save(mgr.get_vectors_path(name), pts)
    mgr.save_collection_info(JaxInfo(
        name=name, config={}, dimension=pts.shape[1], num_vectors=len(pts),
        created_at="", updated_at="", source_files=[],
    ))
    return mgr.get_index_dir(name)


@pytest.fixture(scope="module")
def data():
    pts, q = make_dataset(N, D, B, seed=21)
    return pts, q, ground_truth(pts, q, K, device="cpu")


@pytest.fixture(scope="module")
def built(data, tmp_path_factory):
    """{(package, kind): (base dir, meta)} — collection "c" under each."""
    pts = data[0]
    out = {}
    for package in ("jax", "torch"):
        for kind, kw in KINDS.items():
            base = tmp_path_factory.mktemp(f"{package}_{kind}")
            index_dir = _collection(base, "c", pts)
            if package == "jax":
                meta = jax_build(pts, index_dir, **kw)
            else:
                meta = torch_build(pts, index_dir, device="cpu", **kw)
            out[package, kind] = (base, meta)
    return out


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("package", ["jax", "torch"])
def test_index_built_by_either_package_serves_in_the_other(data, built, package, kind):
    _, q, gt = data
    base, meta = built[package, kind]
    assert meta["index_type"] == "vamana" and meta["use_pq"] == (kind != "none")
    je = JaxEngine("c", base_dir=str(base))
    te = TorchEngine("c", base_dir=str(base), device="cpu")
    assert not te.brute_force_mode and te.index_type == "vamana"
    assert te.use_pq == je.use_pq == (kind != "none")
    assert te.diagnostics["passed"], te.diagnostics
    assert te.diagnostics["serving_mode"] == je.diagnostics["serving_mode"] == "vamana"
    if kind != "none":
        # both read the same artifacts: the correlation differs by rounding
        assert abs(te.diagnostics["pq_exact_correlation"]
                   - je.diagnostics["pq_exact_correlation"]) < 1e-3
        assert te.diagnostics["pq_ratio_band_fraction"] >= 0.9
    assert (te.guide is not None and te.guide.cells is not None) == (kind == "residual")
    want_type = "exact" if kind == "none" else "pq_accelerated"
    for l_search in (None, 24):
        jd, ji, js = je.search_batch(q, k=K, l_search=l_search)
        td, ti, ts = te.search_batch(q, k=K, l_search=l_search)
        assert ts["search_type"] == js["search_type"] == want_type
        assert ts["L_search"] == js["L_search"] and ts["k"] == js["k"] == K
        # exact traversal differs by f32 rounding only; the ADC sums are
        # taken in another order: >= 99% of (query, rank) slots
        assert (ti == ji).mean() >= 0.99
        same = ti == ji
        np.testing.assert_allclose(td[same], jd[same], rtol=1e-4, atol=1e-4)
        assert abs(recall_at_k(ti, gt, K) - recall_at_k(ji, gt, K)) <= 0.005
        assert abs(ts["nodes_visited"] - js["nodes_visited"]) <= 0.01 * js["nodes_visited"]
    if kind != "none":
        _, _, ts = te.search_batch(q, k=K, use_pq_search=False)
        assert ts["search_type"] == "exact"
    if kind != "plain":  # plain-PQ ordering is weak on clustered data, in both packages
        assert recall_at_k(ti, gt, K) >= 0.9


@pytest.mark.parametrize("kind", list(KINDS))
def test_stats_counts_follow_the_reference_formulas(data, built, kind):
    _, q, _ = data
    base, meta = built["jax", kind]
    te = TorchEngine("c", base_dir=str(base), device="cpu", run_diagnostics=False)
    je = JaxEngine("c", base_dir=str(base), run_diagnostics=False)
    _, _, ts = te.search_batch(q, k=K, l_search=16)
    je.search_batch(q, k=K, l_search=16)
    st, sj = te.get_search_statistics(), je.get_search_statistics()
    nv, deg = st["total_nodes_visited"], meta["R"]
    assert st["total_searches"] == sj["total_searches"] == B
    assert nv == ts["nodes_visited"] > 0
    if kind == "none":
        assert (st["total_exact_computations"], st["total_pq_computations"]) == (nv * deg, 0)
        # the same traversal: a count can move only where f32 rounding flips a near-tie
        assert abs(nv - sj["total_nodes_visited"]) <= 0.005 * sj["total_nodes_visited"]
    else:
        # pool of the exact rerank: L on the beam + 2L rounds of the log
        assert st["total_exact_computations"] == sj["total_exact_computations"] == B * (16 + 32)
        assert st["total_pq_computations"] == nv * deg
        assert abs(nv - sj["total_nodes_visited"]) <= 0.01 * sj["total_nodes_visited"]
        assert 0 < st["computation_reduction_rate"] < 1


def test_save_and_load_index_round_trip(data, built, tmp_path):
    base, _ = built["torch", "residual"]
    src = JaxManager(base).get_index_dir("c")
    index, pq, codes, meta = load_index(src, device="cpu")
    assert isinstance(pq, ResidualPQ) and codes.dtype == np.uint8 and codes.shape == (N, pq.n_subvectors)
    assert index.vectors.dtype == torch.float32 and index.adjacency.dtype == torch.int32
    assert index.entry_points.dtype == torch.int32 and index.medoid.ndim == 0
    cells, bias = load_pq_aux(IndexStore(src), expect_n=N)
    meta2 = save_index(tmp_path / "copy", index, pq=pq, pq_codes=codes, pq_coarse_ids=cells,
                       meta_extra={"L": meta["L"]})
    again, pq2, codes2, _ = load_index(tmp_path / "copy", to_device=False, device="cpu")
    assert again.vectors.device.type == "cpu"
    assert torch.equal(again.vectors, index.vectors) and torch.equal(again.adjacency, index.adjacency)
    assert torch.equal(again.entry_points, index.entry_points) and int(again.medoid) == int(index.medoid)
    assert np.array_equal(codes2, codes) and torch.equal(pq2.pq.codebooks, pq.pq.codebooks)
    cells2, bias2 = load_pq_aux(IndexStore(tmp_path / "copy"))
    assert np.array_equal(cells2, cells)
    np.testing.assert_allclose(bias2, bias, rtol=1e-6, atol=1e-4)
    for key in ("format_version", "index_type", "dimension", "R", "num_points", "medoid_idx",
                "distance_metric", "use_pq", "entry_points", "n_subvectors", "pq_centroids",
                "pq_kind", "pq_n_coarse"):
        assert meta2[key] == meta[key], key
    # the JAX package loads what the port saved
    jidx, jpq, jcodes, jmeta = jax_load_index(tmp_path / "copy")
    assert np.array_equal(np.asarray(jidx.adjacency), index.adjacency.numpy())
    assert np.array_equal(jcodes, codes) and type(jpq).__name__ == "ResidualPQ"
    with pytest.raises(ValueError, match="coarse_ids"):
        save_index(tmp_path / "bad", index, pq=pq, pq_codes=codes)
    with pytest.raises(ValueError, match="without pq_codes"):
        save_index(tmp_path / "bad", index, pq=pq)
    with pytest.raises(ValueError, match="host_vectors"):
        save_index(tmp_path / "bad", index, host_vectors=np.zeros((3, D), np.float32))
    with pytest.raises(FileNotFoundError):
        load_index(tmp_path / "nothing", device="cpu")


def _copy(built, key, tmp_path):
    base, _ = built[key]
    shutil.copytree(base, tmp_path / "b")
    return tmp_path / "b", JaxManager(tmp_path / "b").get_index_dir("c")


def test_missing_codes_serve_without_pq_with_a_warning(data, built, tmp_path, caplog):
    base, index_dir = _copy(built, ("jax", "plain"), tmp_path)
    (index_dir / "pq_codes.npy").unlink()
    with caplog.at_level(logging.WARNING):
        te = TorchEngine("c", base_dir=str(base), device="cpu")
    assert "pq_codes.npy is missing" in caplog.text
    assert not te.use_pq and not te.brute_force_mode
    _, ti, ts = te.search_batch(data[1], k=K)
    assert ts["search_type"] == "exact" and recall_at_k(ti, data[2], K) >= 0.9


@pytest.mark.parametrize("tear", ["stale", "missing"])
def test_torn_residual_aux_is_recomputed(data, built, tmp_path, caplog, tear):
    base, index_dir = _copy(built, ("jax", "residual"), tmp_path)
    cells, bias = load_pq_aux(IndexStore(index_dir))
    if tear == "stale":
        np.savez(index_dir / "pq_aux.npz", point_cell=cells[:-5], point_bias=bias[:-5])
        with pytest.raises(ValueError, match="stale"):
            load_pq_aux(IndexStore(index_dir), expect_n=N)
    else:
        (index_dir / "pq_aux.npz").unlink()
        assert load_pq_aux(IndexStore(index_dir)) == (None, None)
    with caplog.at_level(logging.WARNING):
        te = TorchEngine("c", base_dir=str(base), device="cpu")
    assert "recomputing residual-PQ serving arrays" in caplog.text
    assert (te.guide.cells.numpy() == cells).mean() >= 0.999
    same = te.guide.cells.numpy() == cells
    np.testing.assert_allclose(te.guide.bias.numpy()[same], bias[same], rtol=1e-4, atol=1e-3)
    _, _, ts = te.search_batch(data[1], k=K)
    assert ts["search_type"] == "pq_accelerated"


def test_unloadable_graph_degrades_to_brute_force(data, built, tmp_path, caplog):
    base, index_dir = _copy(built, ("torch", "none"), tmp_path)
    (index_dir / "adjacency.npy").unlink()
    with caplog.at_level(logging.WARNING):
        te = TorchEngine("c", base_dir=str(base), device="cpu")
    assert te.brute_force_mode and "brute-force mode" in caplog.text
    _, ti, ts = te.search_batch(data[1], k=K)
    assert ts["search_type"] == "brute_force" and recall_at_k(ti, data[2], K) >= 0.99


def test_cosine_index_with_pq_falls_through_to_exact(data, tmp_path):
    pts, q, _ = data
    index_dir = _collection(tmp_path, "c", pts[:1200])
    meta = torch_build(pts[:1200], index_dir, metric="cosine", force_pq=True, device="cpu")
    assert meta["use_pq"] and meta["pq_kind"] == "plain"  # "auto" off l2: plain PQ
    te = TorchEngine("c", base_dir=str(tmp_path), device="cpu")
    je = JaxEngine("c", base_dir=str(tmp_path))
    assert te.use_pq and isinstance(te.guide.pq, ProductQuantizer)
    td, ti, ts = te.search_batch(q, k=K)
    jd, ji, js = je.search_batch(q, k=K)
    assert ts["search_type"] == js["search_type"] == "exact"  # ADC ranks by L2 only
    assert (ti == ji).mean() >= 0.99
    assert float(td.max()) <= 2.0 + 1e-5  # cosine distances, no sqrt taken


def test_build_defaults_write_the_reference_meta(data, built):
    _, jmeta = built["jax", "residual"]
    _, tmeta = built["torch", "residual"]
    assert sorted(tmeta) == sorted(jmeta)
    for key in ("format_version", "index_type", "dimension", "R", "L", "alpha", "num_points",
                "distance_metric", "use_pq", "n_subvectors", "pq_centroids", "pq_kind",
                "pq_n_coarse", "target_quality", "target_recall", "recommended_search_L",
                "build_method"):
        assert tmeta[key] == jmeta[key], key
    assert (tmeta["R"], tmeta["L"], tmeta["n_subvectors"], tmeta["pq_kind"]) == (16, 32, 8, "residual")
    assert sorted(tmeta["pq_validation"]) == sorted(jmeta["pq_validation"])
    assert tmeta["pq_validation"]["passed"] and tmeta["pq_validation"]["encode_consistent"]
    assert sorted(tmeta["vector_stats"]) == sorted(jmeta["vector_stats"])
    eps = tmeta["entry_points"]
    assert isinstance(eps, list) and len(set(eps)) == len(eps) and tmeta["medoid_idx"] not in eps
    base, _ = built["torch", "residual"]
    index_dir = JaxManager(base).get_index_dir("c")
    assert sorted(p.name for p in index_dir.iterdir()) == [
        "adjacency.npy", "meta.json", "pq_aux.npz", "pq_codes.npy", "pq_model.npz", "vectors.npy"]
    assert json.loads((index_dir / "meta.json").read_text()) == tmeta
    # an existing index is kept; asking for another type says so
    assert torch_build(data[0], index_dir, device="cpu") == tmeta


def test_auto_picks_vamana_from_100k_points_and_schedules_match():
    from diskrag_tpu.build_index import (
        calculate_adaptive_build_params as jax_params,
        calculate_adaptive_search_L as jax_search_l,
    )

    for n in (500, 10_000, 10_001, 50_000, 200_000, 200_001, 5_000_000):
        for quality in ("fast", "balanced", "high"):
            assert calculate_adaptive_build_params(n, quality) == jax_params(n, quality)
        for recall in (0.7, 0.85, 0.95):
            assert calculate_adaptive_search_L(n, recall) == jax_search_l(n, recall)
    assert calculate_adaptive_search_L(200_000, 0.85) == 538


def test_attach_pq_kinds(data):
    pts = data[0]
    assert attach_pq(pts[:500], device="cpu") == (None, None, None)  # tuner: brute force
    pq, codes, val = attach_pq(pts, n_subvectors=4, device="cpu")
    assert isinstance(pq, ProductQuantizer) and codes.shape == (N, 4) and val["passed"]
    rpq, codes, val = attach_pq(pts, n_subvectors=4, pq_kind="residual", device="cpu")
    assert isinstance(rpq, ResidualPQ) and val["coarse_ids"].shape == (N,)
    iq, rows, val = attach_pq(pts, n_subvectors=4, pq_kind="int8", device="cpu")
    assert iq.bits == 8 and rows.shape == (N, D + 2) and rows.dtype == np.int8
    assert val["passed"] and val["encode_consistent"]


def test_search_with_debug_reports_both_traversals(data, built):
    base, _ = built["torch", "residual"]
    te = TorchEngine("c", base_dir=str(base), device="cpu", run_diagnostics=False)
    embed = lambda text: data[1][3]  # noqa: E731
    out = te.search_with_debug("q", k=5, embedding_fn=embed, debug_mode=True)
    assert out["diagnostic_passed"] and len(out["exact_results"]) == len(out["pq_results"]) == 5
    assert out["exact_stats"]["search_type"] == "exact"
    assert out["pq_stats"]["search_type"] == "pq_accelerated"
    assert out["exact_pq_overlap"] >= 0.8
    with pytest.raises(ValueError, match="embedding_fn"):
        te.search_with_debug("q", debug_mode=True)


def test_graph_sweeps_run_on_the_cpu(data, built):
    _, q, gt = data
    base, _ = built["torch", "residual"]
    index_dir = JaxManager(base).get_index_dir("c")
    index, rpq, codes, _ = load_index(index_dir, device="cpu")
    cells, _ = load_pq_aux(IndexStore(index_dir))
    kw = dict(k=K, widths=(16, 32), repeats=1, min_seconds=0.0)
    exact = sweep_exact(index, q, gt, expand_widths=(1, 4), **kw)
    assert [(p.search_width, p.expand_width, p.mode) for p in exact] == [
        (16, 1, "exact"), (16, 4, "exact"), (32, 1, "exact"), (32, 4, "exact")]
    assert exact[-1].recall >= 0.95 and all(p.qps > 0 for p in exact)
    assert sweep_exact(index, q, gt, bf16=True, **kw)[1].mode == "exact-bf16"
    res = sweep_pq(index, rpq, codes, q, gt, coarse_ids=cells, expand_widths=(4,), **kw)
    assert res[0].mode == "rpq8+rerank" and res[1].recall >= 0.9
    # rounds of one pass over the 4 chunks (at most ceil(2L / E) each), and
    # the passes made: one warm-up and one timed
    assert all(4 <= p.rounds <= 4 * -(-2 * p.search_width // 4) for p in res)
    assert all(p.passes == 2 for p in exact + res)
    plain = ProductQuantizer(4, device="cpu").fit(data[0], max_iter=4)
    pts_codes = plain.encode(data[0])
    assert sweep_pq(index, plain, pts_codes, q, gt, **kw)[0].mode == "pq+rerank"


@pytest.fixture()
def faq_dirs(tmp_path):
    cfg = PreprocessingConfig(
        collection="faq",
        embedding=EmbeddingConfig(provider="mock", model="mock", dimension=64),
        question_generation=QuestionGenerationConfig(enabled=False),
        index=IndexConfig(type="vamana", R=6, alpha=1.1),
    )
    rows = [
        {"id": f"q{i}", "question": f"如何使用功能{i}？", "answer": f"功能{i}的答案。"}
        for i in range(40)
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


def test_cli_process_index_search_on_a_vamana_config(faq_dirs, monkeypatch, capsys):
    jdir, tdir = faq_dirs
    monkeypatch.chdir(jdir)
    assert jax_cli(["process", "faq.csv", "-c", "faq"]) == 0
    assert jax_cli(["index", "faq"]) == 0
    jax_index_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert jax_cli(["search", "faq", "如何使用功能3?", "-k", "4", "--faq"]) == 0
    jax_out = _results(capsys.readouterr().out)

    monkeypatch.chdir(tdir)
    assert torch_cli(["process", "faq.csv", "-c", "faq"]) == 0
    assert torch_cli(["--device", "cpu", "index", "faq"]) == 0
    torch_index_line = capsys.readouterr().out.strip().splitlines()[-1]
    # the config's index block reached the build: R and alpha overridden
    assert "type=vamana N=40 R=6 L=32 use_pq=False" in torch_index_line
    assert torch_index_line.split("(")[0] == jax_index_line.split("(")[0]
    meta = json.loads((tdir / "collections" / "faq" / "index" / "meta.json").read_text())
    assert (meta["R"], meta["alpha"], meta["build_method"]) == (6, 1.1, "knn")
    assert torch_cli(["--device", "cpu", "search", "faq", "如何使用功能3?", "-k", "4", "--faq"]) == 0
    torch_out = _results(capsys.readouterr().out)
    # 40 points under a beam of 20: both graphs are searched through, so
    # the two CLIs print the same answers in the same shape
    assert len(torch_out) == len(jax_out) > 0
    assert torch_out == jax_out
    assert "功能3" in torch_out[1]
    # --index-type now offers vamana; the existing index is kept
    assert torch_cli(["--device", "cpu", "index", "faq", "--index-type", "vamana"]) == 0
