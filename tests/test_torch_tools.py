"""The port's tools, profiling utilities and `doctor`, on the CPU
(`device="cpu"`), mirroring `tests/test_tools.py` and holding the port
against the JAX package where both can run: `verify_index` gives the same
verdict on a sound and on a corrupted directory, `doctor` reports the same
actions on a grown collection, and the micro script's fused stages reach
the recall of the original script's functions on the same data."""

import json
import shutil

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # the suite runs several workers: do not let each spin a thread per core

import jax.numpy as jnp

from diskrag_tpu.build_index import build_index_from_vectors as jax_build
from diskrag_tpu.cli import DiskRAG as JaxRAG
from diskrag_tpu.ops.flat_scan_pallas import (
    build_packed_scan_table as jax_packed_table,
    flat_search_fused as jax_fused,
    quantize_int8 as jax_quantize_int8,
    quantize_int8_global as jax_quantize_global,
)
from diskrag_tpu.tools.verify_index import verify_index as jax_verify_index

from diskrag_tpu_torch.benchmark import ground_truth, make_dataset, recall_at_k
from diskrag_tpu_torch.build_index import build_index_from_vectors as torch_build
from diskrag_tpu_torch.cli import DiskRAG as TorchRAG
from diskrag_tpu_torch.data import CollectionManager
from diskrag_tpu_torch.engine import SearchEngine
from diskrag_tpu_torch.tools import dataset_benchmark, fused_scan_micro
from diskrag_tpu_torch.tools.perf_test import performance_test_search_engine
from diskrag_tpu_torch.tools.verify_index import main as verify_index_main, verify_index
from diskrag_tpu_torch.tools.verify_installation import verify_installation
from diskrag_tpu_torch.utils.profiling import device_trace


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path / "trace"), device="cpu") as log_dir:
        torch.sum(torch.ones(64) * 3)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert log_dir == str(tmp_path / "trace") and trace["traceEvents"]


def test_verify_installation():
    report = verify_installation(device="cpu")
    assert report["packages"]["torch"] and report["torch"] == torch.__version__
    assert report["diskrag_tpu_torch"] == "0.1.0"
    assert report["device"] == {"platform": "cpu", "kind": None, "count": 0}
    # no card: the CUDA parts are reported as not checked, not as failed
    assert report["nvcc"] == "not checked" and report["kernels"] == "not checked"
    assert "jax" not in report["packages"]


@pytest.mark.parametrize("built_by", ["jax", "torch"])
def test_verify_index_ok_in_both_packages(built_by, tmp_path, clustered_data):
    pts = clustered_data[:500]
    kw = dict(params_override={"R": 16, "L": 32, "alpha": 1.2})
    if built_by == "jax":  # with the packed record file, which only the JAX package writes
        jax_build(pts, tmp_path / "idx", write_compat=True, **kw)
    else:
        torch_build(pts, tmp_path / "idx", device="cpu", **kw)
    ours = verify_index(tmp_path / "idx", device="cpu")
    theirs = jax_verify_index(tmp_path / "idx")
    failed = {k: v for k, v in ours["checks"].items() if not v["passed"]}
    assert ours["ok"], f"failed checks: {failed}"
    assert theirs["ok"] and ours["index_type"] == theirs["index_type"] == "vamana"
    assert {k: v["passed"] for k, v in ours["checks"].items()} == {
        k: v["passed"] for k, v in theirs["checks"].items()}
    assert ("record_file_size" in ours["checks"]) == (built_by == "jax")
    assert verify_index_main([str(tmp_path / "idx"), "--device", "cpu"]) == 0


@pytest.mark.parametrize("damage", ["truncated_records", "self_loop", "missing_adjacency"])
def test_verify_index_detects_corruption_as_the_jax_package_does(damage, tmp_path, clustered_data):
    pts = clustered_data[:500]
    d = tmp_path / "idx"
    jax_build(pts, d, write_compat=True, params_override={"R": 16, "L": 32, "alpha": 1.2})
    if damage == "truncated_records":  # the size check must fail
        data = (d / "index.dat").read_bytes()
        (d / "index.dat").write_bytes(data[: len(data) // 2])
        failing = "record_file_size"
    elif damage == "self_loop":
        adj = np.load(d / "adjacency.npy")
        adj[7, 0] = 7
        np.save(d / "adjacency.npy", adj)
        failing = "no_self_loops"
    else:
        (d / "adjacency.npy").unlink()
        failing = "adjacency_exists"
    ours = verify_index(d, device="cpu")
    theirs = jax_verify_index(d)
    assert not ours["ok"] and not theirs["ok"]
    assert not ours["checks"][failing]["passed"] and not theirs["checks"][failing]["passed"]
    passed = lambda r: {k: v["passed"] for k, v in r["checks"].items()}  # noqa: E731
    assert passed(ours) == passed(theirs)
    assert verify_index_main([str(d), "--device", "cpu"]) == 1


@pytest.mark.parametrize("itype", ["flat", "ivf"])
def test_verify_index_non_vamana_types(itype, tmp_path):
    """A structured report for flat / ivf index dirs (their metas have no R
    key); the ivf directory is the JAX package's."""
    vecs = np.random.default_rng(0).normal(size=(1200, 64)).astype(np.float32)
    d = tmp_path / itype
    if itype == "flat":
        torch_build(vecs, d, index_type="flat", device="cpu")
    else:
        jax_build(vecs, d, index_type="ivf")
    report = verify_index(d, device="cpu")
    assert report["index_type"] == itype
    assert report["ok"], report
    assert report == jax_verify_index(d)
    assert not verify_index(tmp_path / "nowhere", device="cpu")["ok"]


def _collection(base, name, vecs):
    mgr = CollectionManager(base)
    mgr.create_collection(name, dimension=vecs.shape[1])
    mgr.update_collection(name, vecs, [f"t{i}" for i in range(len(vecs))],
                          [{"i": i} for i in range(len(vecs))])
    return mgr


def test_performance_test_search_engine(tmp_path, clustered_data):
    pts = clustered_data[:300].astype(np.float32)
    mgr = _collection(tmp_path / "c", "p", pts)
    torch_build(pts, mgr.get_index_dir("p"), params_override={"R": 8, "L": 16, "alpha": 1.2},
                device="cpu")
    eng = SearchEngine("p", base_dir=tmp_path / "c", device="cpu")
    report = performance_test_search_engine(eng, pts[:8], k=3, n_threads=2)
    assert report["n_queries"] == 8 and report["device"] == "cpu"
    assert report["sequential_qps"] > 0
    assert report["concurrent_qps"] > 0
    assert report["batched_qps"] > 0


def test_dataset_benchmark_cosine_cli(capsys):
    """--metric cosine runs the full sweep path and skips the L2-only PQ
    sweep with a note; --build-method wave builds the graph by wave
    insertion."""
    argv = ["--n", "2000", "--dim", "16", "--n-queries", "32", "--metric", "cosine",
            "--widths", "16", "--expand", "2", "--pq-m", "4", "--json", "--device", "cpu"]
    assert dataset_benchmark.main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert "--pq-m skipped" in out[0]
    result = json.loads(out[-1])
    assert result["metric"] == "cosine" and result["device"] == "cpu"
    assert all(p["mode"] != "pq" for p in result["sweep"])
    assert max(p["recall"] for p in result["sweep"]) >= 0.95
    argv = ["--n", "600", "--dim", "16", "--n-queries", "16", "--widths", "32", "--expand", "4",
            "--R", "12", "--L-build", "32", "--json", "--device", "cpu", "--build-method", "wave"]
    assert dataset_benchmark.main(argv) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["build_method"] == "wave"
    assert max(p["recall"] for p in result["sweep"]) >= 0.9


def test_dataset_benchmark_pq_sweep(capsys):
    argv = ["--n", "1500", "--dim", "16", "--n-queries", "16", "--widths", "32", "--expand", "2",
            "--pq-m", "4", "--json", "--device", "cpu"]
    assert dataset_benchmark.main(argv) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    modes = {p["mode"] for p in result["sweep"]}
    assert modes == {"exact", "pq+rerank"}
    assert all(p["recall"] >= 0.9 for p in result["sweep"])


def test_config_index_block_honored(tmp_path):
    """config.yaml index: {target_quality, force_pq} drive the build when
    the CLI flag is absent; an explicit argument still wins."""
    import yaml

    cfg = {
        "collection": "c",
        "embedding": {"provider": "mock", "model": "mock", "dimension": 64},
        "index": {"target_quality": "high", "force_pq": False, "R": 8, "L": 16},
    }
    cfg_path = tmp_path / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    vecs = np.random.default_rng(0).normal(size=(1200, 64)).astype(np.float32)
    _collection(tmp_path / "collections", "c", vecs)
    rag = TorchRAG(str(cfg_path), base_dir=str(tmp_path / "collections"), device="cpu")
    meta = rag.build_index("c")
    assert meta["target_quality"] == "high"
    assert meta["use_pq"] is False  # force_pq: false suppressed PQ
    meta2 = rag.build_index("c", target_quality="fast", force_rebuild=True)
    assert meta2["target_quality"] == "fast"


def _grown_collection(tmp_path):
    """A 1500 x 64 collection indexed by the port (residual PQ), then grown
    by 200 rows past its index."""
    base = tmp_path / "collections"
    rng = np.random.default_rng(2)
    vecs = rng.normal(size=(1500, 64)).astype(np.float32)
    mgr = _collection(base, "c", vecs)
    rag = TorchRAG(str(tmp_path / "nonexistent.yaml"), base_dir=str(base), device="cpu")
    rag.build_index("c")
    more = rng.normal(size=(200, 64)).astype(np.float32)
    mgr.update_collection("c", more, [f"extra{i}" for i in range(200)],
                          [{"i": 1500 + i} for i in range(200)])
    return base, mgr, rag


def test_doctor_on_grown_collection_reports_what_the_jax_package_reports(tmp_path):
    """doctor trains PQ on the INDEX's own rows when the collection has
    grown since the build, and both packages say the same about it."""
    base, mgr, rag = _grown_collection(tmp_path)
    (mgr.get_index_dir("c") / "pq_model.npz").unlink()  # something to repair
    shutil.copytree(base, tmp_path / "jax_copy")
    report = rag.doctor("c")
    assert report["status"] == "ok"
    assert any("repair covers the indexed rows" in a for a in report["actions"])
    theirs = JaxRAG(str(tmp_path / "nonexistent.yaml"),
                    base_dir=str(tmp_path / "jax_copy")).doctor("c")
    assert report == theirs
    # the repaired index still loads with PQ intact (not brute force)
    eng = SearchEngine("c", base_dir=base, device="cpu")
    assert not eng.brute_force_mode and eng.use_pq


def test_doctor_preserves_pq_kind(tmp_path):
    """doctor's retrain recreates the quantizer kind the meta records and
    refreshes the pq_kind key: no silent downgrade residual -> plain."""
    base, mgr, rag = _grown_collection(tmp_path)
    index_dir = mgr.get_index_dir("c")
    assert json.loads((index_dir / "meta.json").read_text())["pq_kind"] == "residual"
    (index_dir / "pq_codes.npy").unlink()
    report = rag.doctor("c")
    assert report["status"] == "ok"
    assert any("kind=residual" in a for a in report["actions"])
    assert json.loads((index_dir / "meta.json").read_text())["pq_kind"] == "residual"
    assert (index_dir / "pq_aux.npz").exists()
    eng = SearchEngine("c", base_dir=base, device="cpu")
    assert eng.use_pq and eng.guide.cells is not None


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_doctor_refuses_quantizer_kinds_the_port_cannot_retrain(kind, tmp_path):
    """The int kinds are retrained now, as their own kind (never repaired
    as another one); the index then serves "iq_accelerated"."""
    from diskrag_tpu_torch.pq import IntQuantizer

    base, mgr, rag = _grown_collection(tmp_path)
    meta_path = mgr.get_index_dir("c") / "meta.json"
    meta = json.loads(meta_path.read_text())
    meta["pq_kind"] = kind
    meta_path.write_text(json.dumps(meta))
    (mgr.get_index_dir("c") / "pq_codes.npy").unlink()
    report = rag.doctor("c")
    assert f"retrained PQ (kind={kind})" in report["actions"]
    meta = json.loads(meta_path.read_text())
    assert meta["pq_kind"] == kind and meta["iq_n_cells"] == (0 if kind == "int8" else 23)
    assert not (mgr.get_index_dir("c") / "pq_aux.npz").exists()
    eng = SearchEngine("c", base_dir=base, device="cpu")
    assert (isinstance(eng.guide.pq, IntQuantizer)
            and eng.guide.codes.shape == (1500, meta["iq_row_width"]))
    q = np.random.default_rng(3).normal(size=(4, 64)).astype(np.float32)
    assert eng.search_batch(q, k=5)[2]["search_type"] == "iq_accelerated"


def test_doctor_healthy_flat_and_missing_cases(tmp_path):
    base = tmp_path / "collections"
    vecs = np.random.default_rng(5).normal(size=(64, 32)).astype(np.float32)
    mgr = _collection(base, "f", vecs)
    rag = TorchRAG(str(tmp_path / "none.yaml"), base_dir=str(base), device="cpu")
    assert any("no index yet" in a for a in rag.doctor("f")["actions"])
    rag.build_index("f", index_type="flat")
    report = rag.doctor("f")
    assert report["status"] == "ok" and any("flat index present" in a for a in report["actions"])
    mgr.get_vectors_path("f").unlink()  # recovered from the index's copy
    assert "recovered vectors.npy from index" in rag.doctor("f")["actions"]
    assert np.array_equal(np.load(mgr.get_vectors_path("f")), vecs)


MICRO_STAGES = [
    "scan_only_int8", "scan_only_bf16", "fused_full_int8", "scan_only_packed",
    "fused_full_packed", "scan_only_hier_plain_nb512_t2048", "scan_only_hier_plain_nb1024_t2048",
    "scan_only_hier_pipe_nb512_t2048", "scan_only_hier_pipe_nb1024_t2048",
    "rerank_cut_only_topk_lanes", "rerank_full", "scan_mm_only_t2048", "scan_mm_only_t4096",
    "tail_cut_topk_lanes_nb512_kk20", "tail_gather_exact_kk20", "tail_cut_topk_lanes_nb512_kk40",
    "tail_gather_exact_kk40", "scan_only_packed_table", "scan_only_hier_table",
    "fused_full_table_rrdef", "fused_full_table_rr20", "packed_no_rerank_topk_smallest",
]


def test_micro_script_prints_every_stage_with_the_original_functions_recall(capsys):
    """`--n 2000 --queries 64 --device cpu`: every stage printed, no kernel
    launched on the CPU, and the fused stages' recall within 0.002 of the
    JAX functions the original script times, on the same data (Pallas in
    interpret mode)."""
    assert fused_scan_micro.main(["--n", "2000", "--queries", "64", "--device", "cpu",
                                  "--min-seconds", "0.01", "--repeats", "1"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert [ln["stage"] for ln in lines] == MICRO_STAGES
    assert all(ln["launches"] == {} and ln["device"] == "cpu" and ln["batch_ms"] > 0
               for ln in lines)
    got = {ln["stage"]: ln["recall"] for ln in lines if "recall" in ln}

    pts, queries = make_dataset(2000, 128, 64)
    gt = ground_truth(pts, queries, 10, device="cpu")
    v, q = jnp.asarray(pts), jnp.asarray(queries)
    norms = jnp.sum(jnp.square(v), axis=-1)
    codes, scales = jax_quantize_int8(v)
    gcodes, gscale = jax_quantize_global(v)
    tcodes, tnf, tscale, tn = jax_packed_table(v)
    want = {
        "fused_full_int8": jax_fused(q, codes, norms, v, k=10, db_scales=scales, interpret=True),
        "fused_full_packed": jax_fused(q, gcodes, norms, v, k=10, db_scale_global=gscale,
                                       interpret=True),
        "fused_full_table_rrdef": jax_fused(q, tcodes, norms, v, k=10, db_scale_global=tscale,
                                            db_nf=tnf, n_valid=tn, interpret=True),
        "fused_full_table_rr20": jax_fused(q, tcodes, norms, v, k=10, db_scale_global=tscale,
                                           db_nf=tnf, n_valid=tn, rerank_width=20,
                                           interpret=True),
    }
    for stage, (_, ids) in want.items():
        assert abs(got[stage] - recall_at_k(np.asarray(ids), gt, 10)) <= 0.002, stage


def test_micro_script_only_and_sweep(capsys):
    lines = fused_scan_micro.run(n=1000, dim=32, queries=16, device="cpu", min_seconds=0.0,
                                 repeats=1, sweep=True, only=("scan_mm_only", "sweep"),
                                 emit=lambda line: None)
    names = [ln["stage"] for ln in lines]
    assert names == ["scan_mm_only_t2048", "scan_mm_only_t4096"] + ["sweep"] * 9 + [
        "sweep_scan_hier"] * 8
    assert {(ln["fold"], ln["n_buckets"]) for ln in lines if ln["stage"] == "sweep"} == {
        (f, b) for f in ("int8", "bf16", "packed") for b in (512, 1024, 2048)}
    assert capsys.readouterr().out == ""
