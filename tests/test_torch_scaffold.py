"""The PyTorch/CUDA port's scaffolding: it imports no jax and nothing of
the JAX package, resolves devices explicitly (raising rather than
dropping to the CPU), and routes CPU tensors to the plain versions
without counting a kernel launch."""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import json, sys
import diskrag_tpu_torch
import diskrag_tpu_torch.benchmark, diskrag_tpu_torch.build_index
import diskrag_tpu_torch.cli, diskrag_tpu_torch.convert, diskrag_tpu_torch.engine
import diskrag_tpu_torch.data, diskrag_tpu_torch.index.persist
import diskrag_tpu_torch.kernels._build, diskrag_tpu_torch.ops.flat_scan
import diskrag_tpu_torch.ops.flat, diskrag_tpu_torch.ops.topk, diskrag_tpu_torch.ops.medoid
import diskrag_tpu_torch.ops.pq_scan, diskrag_tpu_torch.ops.mm_probe
import diskrag_tpu_torch.api, diskrag_tpu_torch.utils.profiling, diskrag_tpu_torch.kernels.launches
import diskrag_tpu_torch.tools.fused_scan_micro, diskrag_tpu_torch.tools.verify_installation
import diskrag_tpu_torch.tools.verify_index, diskrag_tpu_torch.tools.perf_test
import diskrag_tpu_torch.tools.dataset_benchmark
import diskrag_tpu_torch.graph, diskrag_tpu_torch.graph.types, diskrag_tpu_torch.graph.search
import diskrag_tpu_torch.graph.prune, diskrag_tpu_torch.graph.knn_build
import diskrag_tpu_torch.pq, diskrag_tpu_torch.pq.kmeans, diskrag_tpu_torch.pq.adaptive
import diskrag_tpu_torch.pq.product_quantizer, diskrag_tpu_torch.pq.residual
from diskrag_tpu_torch.graph import (
    VamanaIndex, beam_search, beam_search_pq, beam_search_reranked, build_vamana_knn,
    robust_prune_batch,
)
from diskrag_tpu_torch.pq import ProductQuantizer, ResidualPQ, pq_from_arrays
from diskrag_tpu_torch.ops.pq_scan import adc_lookup_gathered_kernel, adc_lookup_gathered_ref
from diskrag_tpu_torch.convert import pq_from_jax, vamana_index_from_jax
from diskrag_tpu_torch.ops.flat_scan import (
    build_packed_scan_table, epilogue_cut_ids_ref, plan_packed_search,
    quantize_int8_global, scan_bucketed_topk_hier, scan_bucketed_topk_hier_ref,
    scan_bucketed_topk_packed, scan_bucketed_topk_packed_ref,
)
from diskrag_tpu_torch.benchmark import (
    SweepPoint, adaptive_flat_point, sweep_exact, sweep_flat, sweep_pq,
)
from diskrag_tpu_torch.api import AppState, create_app
from diskrag_tpu_torch.ops.mm_probe import mm_probe, mm_probe_ref
from diskrag_tpu_torch.utils.profiling import PhaseTimer, block_and_time, device_trace
from diskrag_tpu_torch.kernels.launches import launch_counts
assert set(launch_counts()) == {"B1", "B4", "B2", "B3", "B6", "B5", "M1"}
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "diskrag_tpu."))
             or m == "diskrag_tpu")
lazy = sorted(m for m in ("pandas", "yaml", "pyarrow", "httpx", "aiohttp", "pydantic")
              if m in sys.modules)
print(json.dumps({"bad": bad, "lazy": lazy}))
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
        text=True, timeout=120, check=True,
    ).stdout.strip().splitlines()[-1]
    got = json.loads(out)
    assert got["bad"] == []
    # the serving path needs none of these; they are imported lazily
    assert got["lazy"] == []


def test_port_source_never_names_jax_modules():
    for path in (REPO / "diskrag_tpu_torch").rglob("*.py"):
        for line in path.read_text(encoding="utf-8").splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert not s.split()[1].startswith(("jax", "diskrag_tpu.")), (path, s)
                assert s.split()[1] != "diskrag_tpu", (path, s)


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_device_defaults_to_cuda_and_raises_without_a_card(monkeypatch, tmp_path):
    from diskrag_tpu_torch.build_index import build_index_from_vectors
    from diskrag_tpu_torch.device import resolve_device
    from diskrag_tpu_torch.ops.flat import FlatIndex

    _no_card(monkeypatch)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(ValueError):
        resolve_device("mps")
    pts = np.random.default_rng(0).normal(size=(32, 8)).astype(np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FlatIndex(pts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_index_from_vectors(pts, tmp_path / "idx")
    assert not (tmp_path / "idx").exists()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_engine_and_cli_raise_without_a_card(monkeypatch, tmp_path):
    from diskrag_tpu_torch.cli import main
    from diskrag_tpu_torch.engine import SearchEngine

    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SearchEngine("missing", base_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--base-dir", str(tmp_path), "search", "missing", "q"])


def test_api_tools_and_profiling_raise_without_a_card(monkeypatch, tmp_path):
    """Every new entry point runs on the card unless asked for the CPU:
    with no card visible it raises, and leaves nothing behind."""
    from diskrag_tpu_torch import api
    from diskrag_tpu_torch.cli import main
    from diskrag_tpu_torch.tools import (
        dataset_benchmark, fused_scan_micro, verify_index, verify_installation,
    )
    from diskrag_tpu_torch.utils.profiling import block_and_time, device_trace

    _no_card(monkeypatch)
    monkeypatch.chdir(tmp_path)

    def no_card():
        return pytest.raises(RuntimeError, match="no CUDA device")

    with no_card():
        api.AppState(base_dir=str(tmp_path / "collections"))
    with no_card():
        api.main(port=0)
    with no_card():
        api.create_app()
    with no_card():
        fused_scan_micro.main(["--n", "100", "--queries", "4"])
    with no_card():
        fused_scan_micro.run(n=100, queries=4)
    with no_card():
        verify_installation.main([])
    with no_card():
        verify_index.main([str(tmp_path / "idx")])
    with no_card():
        dataset_benchmark.main(["--n", "100"])
    with no_card():
        block_and_time(lambda: torch.ones(2))
    with no_card():
        with device_trace(str(tmp_path / "trace")):
            pass
    with no_card():
        main(["--base-dir", str(tmp_path / "c"), "doctor", "missing"])
    with no_card():
        main(["--base-dir", str(tmp_path / "c"), "process-dir", str(tmp_path)])
    assert not (tmp_path / "app.log").exists() and not (tmp_path / "trace").exists()
    # asked for the CPU, the same entry points run
    assert api.AppState(base_dir=str(tmp_path / "collections"), device="cpu").device.type == "cpu"
    assert verify_installation.main(["--device", "cpu"]) == 0


def test_cpu_tensors_take_the_plain_versions_without_counting_launches():
    from diskrag_tpu_torch.ops import flat_scan as fs
    from diskrag_tpu_torch.ops import pq_scan

    fs.reset_launch_counts()
    pq_scan.reset_launch_counts()
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=(300, 16)).astype(np.float32))
    codes, block, _, n = fs.build_rowscan_table(x)
    qc, qs = fs.quantize_int8(x[:5])
    vals, ids = fs.scan_bucketed_topk(qc, codes, block, q_scales=qs, n_valid=n)
    assert vals.shape == ids.shape == (5, 256)  # NB 512 halves below N
    lanes = fs.topk_lanes(vals, 8)
    assert lanes.shape == (5, 8)
    codes, nf, scale, n = fs.build_packed_scan_table(x)
    qc, qs = fs.quantize_int8_global(x[:5])
    for scan in (fs.scan_bucketed_topk_packed, fs.scan_bucketed_topk_hier):
        vals, ids = scan(qc, qs, codes, nf, scale, n_valid=n)
        assert vals.shape == ids.shape and ids.shape[0] == 5
        assert scan(qc, qs, codes, nf, scale, n_valid=n, cut_kk=8)[1].shape == (5, 8)
    fs.scan_bucketed_topk_hier(qc, qs, codes, nf, scale, n_valid=n, pipelined=True)
    assert fs.scan_bucketed_topk.launches == 0
    assert fs.topk_lanes.launches == 0
    assert fs.scan_bucketed_topk_packed.launches == 0
    assert fs.scan_bucketed_topk_hier.launches == 0
    assert fs.scan_bucketed_topk_hier.launches_pipelined == 0
    # B5: the gathered ADC lookup, alone and inside the PQ-guided search
    tables = torch.as_tensor(rng.normal(size=(5, 4, 256)).astype(np.float32))
    gathered = torch.as_tensor(rng.integers(0, 256, size=(5, 7, 4)).astype(np.uint8))
    out = pq_scan.adc_lookup_gathered_kernel(tables, gathered)
    assert out.shape == (5, 7)
    assert torch.equal(out, pq_scan.adc_lookup_gathered_ref(tables, gathered))
    from diskrag_tpu_torch.graph.search import beam_search_pq

    adj = torch.as_tensor(rng.integers(0, 300, size=(300, 6)).astype(np.int32))
    codes = torch.as_tensor(rng.integers(0, 256, size=(300, 4)).astype(np.uint8))
    res = beam_search_pq(codes, tables, adj, torch.tensor(0), search_width=8, k=4, rerank=False)
    assert res.ids.shape == (5, 4) and int(res.n_steps) > 0
    assert pq_scan.adc_lookup_gathered_kernel.launches == 0
    # M1: the matmul-only probe
    from diskrag_tpu_torch.kernels.launches import launch_counts
    from diskrag_tpu_torch.ops import mm_probe as mp

    mp.reset_launch_counts()
    rows, _ = fs.quantize_int8_global(x)
    out, rowsum = mp.mm_probe(qc, rows, tile=64, nb_out=32)
    assert out.shape == (128, 32) and rowsum.shape == (128,)
    assert not any(launch_counts().values())


def test_kernel_build_is_keyed_by_source_hash():
    from diskrag_tpu_torch.kernels import _build

    srcs = sorted(_build.CSRC.glob("*.cu"))
    assert [s.stem for s in srcs] == [
        "adc_lookup", "flat_scan", "hier_scan", "mm_probe", "packed_scan", "topk_lanes"]
    paths = {_build._lib_path(s) for s in srcs}
    assert len(paths) == 6
    assert all(p.parent == _build.BUILD_DIR for p in paths)
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    with pytest.raises(RuntimeError, match="CUDA error 7"):
        _build.check(7, "x")


def test_kernel_build_hash_covers_shared_headers(tmp_path, monkeypatch):
    from diskrag_tpu_torch.kernels import _build

    assert [h.name for h in _build.CSRC.glob("*.cuh")] == ["packed_common.cuh"]
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._lib_path(tmp_path / "a.cu")
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build._lib_path(tmp_path / "a.cu") != before  # an edited header rebuilds


def _tiny_collection(tmp_path, pts, meta: dict | None):
    """A collection `c` under tmp_path holding `pts`, with `meta` written
    as its index's meta.json (no other index file)."""
    from diskrag_tpu_torch.data.collection import CollectionManager
    from diskrag_tpu_torch.data.config import CollectionInfo

    mgr = CollectionManager(tmp_path)
    (tmp_path / "c").mkdir()
    np.save(mgr.get_vectors_path("c"), pts)
    mgr.save_collection_info(CollectionInfo(
        name="c", config={}, dimension=pts.shape[1], num_vectors=len(pts), created_at="",
        updated_at="", source_files=[],
    ))
    if meta is not None:
        idx = mgr.get_index_dir("c")
        idx.mkdir()
        (idx / "meta.json").write_text(json.dumps(meta))


@pytest.mark.parametrize("cut", ["fused_precision", "build", "engine"])
def test_unported_options_raise_not_implemented(cut, tmp_path):
    from diskrag_tpu_torch.build_index import build_index_from_vectors
    from diskrag_tpu_torch.ops.flat import FlatIndex

    pts = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    if cut == "fused_precision":
        # every precision of the reference is served now; an unknown one is
        # refused rather than served as something else
        assert FlatIndex(pts, fused_precision="int8_packed",
                         device="cpu")._fused_db_scale_global is not None
        with pytest.raises(ValueError, match="fused_precision"):
            FlatIndex(pts, fused_precision="int4_packed", device="cpu")
    elif cut == "build":
        for kw in (dict(index_type="ivf"), dict(index_type="sharded"),
                   dict(index_type="vamana", build_method="wave"),
                   dict(index_type="vamana", write_compat=True),
                   dict(index_type="vamana", force_pq=True, pq_kind="int8"),
                   dict(index_type="vamana", force_pq=True, pq_kind="int4")):
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                build_index_from_vectors(pts, tmp_path / "i", device="cpu", **kw)
            assert not (tmp_path / "i").exists()
        with pytest.raises(ValueError, match="index_type"):
            build_index_from_vectors(pts, tmp_path / "i", index_type="hnsw", device="cpu")
    else:
        from diskrag_tpu_torch.engine import SearchEngine

        _tiny_collection(tmp_path, pts, {"index_type": "ivf"})
        # never served by brute force in place of the requested index
        with pytest.raises(NotImplementedError, match="ivf"):
            SearchEngine("c", base_dir=str(tmp_path), device="cpu")
        for mode in ("host_tier", "sharded_flat", "streaming"):
            with pytest.raises(NotImplementedError, match=mode):
                SearchEngine("c", base_dir=str(tmp_path), device="cpu", serving_mode=mode)
        with pytest.raises(ValueError, match="serving_mode"):
            SearchEngine("c", base_dir=str(tmp_path), device="cpu", serving_mode="nope")


@pytest.mark.parametrize("what", ["sharded_meta", "knn_backend", "int8_prune", "iq", "compat"])
def test_unported_graph_options_raise_not_implemented(what, tmp_path):
    """The parts of the graph slice that wait for a later one say so,
    naming ROADMAP.md, instead of running something else."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(64, 8)).astype(np.float32)
    if what == "sharded_meta":
        from diskrag_tpu_torch.engine import SearchEngine

        _tiny_collection(tmp_path, pts, {"index_type": "sharded"})
        with pytest.raises(NotImplementedError, match="sharded"):
            SearchEngine("c", base_dir=str(tmp_path), device="cpu")
    elif what == "knn_backend":
        from diskrag_tpu_torch.graph.knn_build import build_vamana_knn

        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_vamana_knn(pts, degree_bound=4, knn_backend="ivf", device="cpu")
        with pytest.raises(ValueError, match="knn_backend"):
            build_vamana_knn(pts, degree_bound=4, knn_backend="hnsw", device="cpu")
    elif what == "int8_prune":
        from diskrag_tpu_torch.graph import prune

        ids = torch.zeros((2, 4), dtype=torch.int32)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            prune.robust_prune_batch(
                torch.arange(2), ids, torch.zeros((2, 4, 8), dtype=torch.int8),
                torch.zeros((2, 4)), 1.2, degree_bound=2, cand_scales=torch.ones((2, 4)))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            prune.gathered_distance_int8(None, None, None, None, "l2")
    elif what == "iq":
        from diskrag_tpu_torch.graph.search import beam_search_iq
        from diskrag_tpu_torch.pq import pq_from_arrays

        with pytest.raises(NotImplementedError, match="ROADMAP"):
            beam_search_iq(None, None, None, None)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            pq_from_arrays({"iq_meta": np.zeros(3)}, device="cpu")
    else:
        from diskrag_tpu_torch.graph.types import VamanaIndex
        from diskrag_tpu_torch.index.persist import save_index

        index = VamanaIndex.from_numpy(pts, np.zeros((64, 2), np.int32), 0, device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            save_index(tmp_path / "i", index, write_compat=True)
        assert not (tmp_path / "i").exists()


def test_f32_products_stay_full_precision():
    """Importing the port pins float32 matrix products to full f32: the
    k-means, prune and table products are the JAX package's
    Precision.HIGHEST ones."""
    import diskrag_tpu_torch.pq.kmeans  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
