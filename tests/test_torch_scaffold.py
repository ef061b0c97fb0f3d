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
import diskrag_tpu_torch.pq.intq, diskrag_tpu_torch.native, diskrag_tpu_torch.index.host_tier
import diskrag_tpu_torch.index.ivf, diskrag_tpu_torch.graph.checkpoint
import diskrag_tpu_torch.graph.build, diskrag_tpu_torch.graph.dynamic
import diskrag_tpu_torch.index.streaming, diskrag_tpu_torch.tools.streaming_bench
import diskrag_tpu_torch.parallel, diskrag_tpu_torch.parallel.mesh, diskrag_tpu_torch.parallel.sharded
import diskrag_tpu_torch.parallel.host_tier, diskrag_tpu_torch.parallel.multihost
import diskrag_tpu_torch.parallel.dryrun, diskrag_tpu_torch.tools.multihost_check
import diskrag_tpu_torch.tools.serving_bench, diskrag_tpu_torch.tools.angular_bench
import importlib.util
_spec = importlib.util.spec_from_file_location("bench_cuda", "bench_cuda.py")
bench_cuda = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench_cuda)
from diskrag_tpu_torch.tools.serving_bench import (
    make_collection, measure_engine_qps, measure_http_qps, measure_pipelined_qps, measure_serving,
)
from diskrag_tpu_torch.ops.flat import bf16_query_block
from diskrag_tpu_torch.convert import sharded_host_tier_from_jax, sharded_index_from_jax
from diskrag_tpu_torch.index import StreamingIndex
from diskrag_tpu_torch.graph import build_vamana, random_regular_init
from diskrag_tpu_torch.convert import streaming_from_jax
from diskrag_tpu_torch.index.ivf import IVFIndex, assign_cells, build_ivf, tiles_from_ids
from diskrag_tpu_torch.graph.checkpoint import BuildCheckpoint, dataset_fingerprint, pack_bf16
from diskrag_tpu_torch.graph.knn_build import approx_knn_ivf
from diskrag_tpu_torch.index.persist import load_ivf_index, save_ivf_index
from diskrag_tpu_torch.convert import ivf_from_jax
from diskrag_tpu_torch.graph import (
    VamanaIndex, beam_search, beam_search_pq, beam_search_reranked, build_vamana_knn,
    robust_prune_batch,
)
from diskrag_tpu_torch.pq import IntQuantizer, ProductQuantizer, ResidualPQ, pq_from_arrays
from diskrag_tpu_torch.index.host_tier import HostTierIndex, exact_rerank_pool
from diskrag_tpu_torch.native import RecordReader
from diskrag_tpu_torch.convert import iq_from_jax
from diskrag_tpu_torch.ops.pq_scan import (
    adc_lookup_gathered_kernel, adc_lookup_gathered_ref, adc_lookup_ids_kernel, adc_lookup_ids_ref,
)
from diskrag_tpu_torch.convert import pq_from_jax, vamana_index_from_jax
from diskrag_tpu_torch.ops.flat_scan import (
    build_packed_scan_table, epilogue_cut_ids_ref, plan_packed_search, plan_pipelined_scan,
    quantize_int8_global, scan_bucketed_topk_hier, scan_bucketed_topk_hier_ref,
    scan_bucketed_topk_packed, scan_bucketed_topk_packed_ref,
)
from diskrag_tpu_torch.benchmark import (
    SweepPoint, adaptive_flat_point, sweep_exact, sweep_flat, sweep_host_tier, sweep_iq, sweep_ivf,
    sweep_pq,
)
from diskrag_tpu_torch.api import AppState, create_app
from diskrag_tpu_torch.ops.mm_probe import mm_probe, mm_probe_ref
from diskrag_tpu_torch.utils.profiling import device_trace, drain, span, summary, tracing
from diskrag_tpu_torch.kernels.launches import launch_counts
assert set(launch_counts()) == {"B1", "B4", "B2", "B3", "B6", "B5", "M1", "G1", "G2"}
from diskrag_tpu_torch.ops import (
    Metric, approximate_medoid, brute_force_topk, mask_duplicates, merge_topk,
    pairwise_cosine_distance, pairwise_distance, pairwise_l2_sq, query_point_distance,
    squared_norms, topk_smallest,
)
from diskrag_tpu_torch.index.persist import replace_pq_artifacts
import diskrag_tpu_torch.kernels._build as kernel_build
assert not kernel_build._libs  # importing the package built and loaded no kernel
bad = sorted(m for m in sys.modules
             if m in ("jax", "ml_dtypes") or m.startswith(("jax.", "jaxlib", "diskrag_tpu."))
             or m in ("diskrag_tpu", "benchmarks", "bench") or m.startswith("benchmarks."))
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
    for path in [*(REPO / "diskrag_tpu_torch").rglob("*.py"), REPO / "bench_cuda.py"]:
        for line in path.read_text(encoding="utf-8").splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert not s.split()[1].startswith(("jax", "diskrag_tpu.")), (path, s)
                assert s.split()[1] != "diskrag_tpu", (path, s)
                assert s.split()[1].split(".")[0] not in ("benchmarks", "bench"), (path, s)


def test_bench_cuda_imports_torch_numpy_and_the_port_only():
    import ast

    tree = ast.parse((REPO / "bench_cuda.py").read_text(encoding="utf-8"))
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    third_party = {m.split(".")[0] for m in names} - set(sys.stdlib_module_names)
    assert third_party == {"torch", "numpy", "diskrag_tpu_torch"}


def test_bench_cuda_raises_without_a_card_unless_asked_for_the_cpu(monkeypatch, capsys,
                                                                   tmp_path):
    import importlib.util

    spec = importlib.util.spec_from_file_location("bench_cuda", REPO / "bench_cuda.py")
    bench_cuda = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench_cuda)
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_cuda.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_cuda.main(["--device", "cuda"])
    with pytest.raises(SystemExit):
        bench_cuda.main(["--device", "tpu"])
    assert capsys.readouterr().out == ""  # no line printed
    from diskrag_tpu_torch.tools import serving_bench

    pts = np.zeros((16, 8), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving_bench.measure_serving(pts, pts, tmp_dir=str(tmp_path / "s"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving_bench.main(["--n", "100"])
    assert not (tmp_path / "s").exists()


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
    from diskrag_tpu_torch.utils.profiling import device_trace

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
        "adc_lookup", "beam_seed", "beam_traverse", "flat_scan", "hier_scan", "mm_probe",
        "packed_scan", "topk_lanes"]
    paths = {_build._lib_path(s) for s in srcs}
    assert len(paths) == 8
    assert all(p.parent == _build.BUILD_DIR for p in paths)
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    with pytest.raises(RuntimeError, match="CUDA error 7"):
        _build.check(7, "x")


def test_kernel_build_hash_covers_shared_headers(tmp_path, monkeypatch):
    from diskrag_tpu_torch.kernels import _build

    headers = sorted(h.name for h in _build.CSRC.glob("*.cuh"))
    assert headers == ["packed_common.cuh", "packed_wgmma.cuh", "pingpong_wgmma.cuh",
                       "wgmma_common.cuh"]
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
        # write_compat, pq_kind int8 / int4, the ivf index, the wave build
        # and the sharded index are ported (the host tier, the int-quantized
        # rows, the IVF, streaming and parallel slices)
        meta = build_index_from_vectors(pts, tmp_path / "ivf", index_type="ivf", device="cpu")
        assert meta["index_type"] == "ivf" and meta["tile_precision"] == "int8"
        meta = build_index_from_vectors(pts, tmp_path / "wave", index_type="vamana",
                                        build_method="wave", device="cpu")
        assert meta["build_method"] == "wave" and meta["num_points"] == 64
        for i, kw in enumerate((dict(index_type="sharded"),
                                dict(index_type="sharded", write_compat=True, n_shards=2))):
            meta = build_index_from_vectors(pts, tmp_path / f"i{i}", device="cpu", **kw)
            assert meta["index_type"] == "sharded" and meta["n_shards"] == i + 1
            assert (tmp_path / f"i{i}" / "sharded" / "sharded_meta.json").exists()
            assert (tmp_path / f"i{i}" / "index.dat").exists() == bool(i)
        with pytest.raises(ValueError, match="index_type"):
            build_index_from_vectors(pts, tmp_path / "i", index_type="hnsw", device="cpu")
    else:
        from diskrag_tpu_torch.build_index import build_index_from_vectors
        from diskrag_tpu_torch.data.collection import CollectionManager
        from diskrag_tpu_torch.engine import SearchEngine, ServingConfigError

        _tiny_collection(tmp_path, pts, None)
        build_index_from_vectors(pts, CollectionManager(tmp_path).get_index_dir("c"),
                                 index_type="ivf", device="cpu")
        # the ivf index is served (ported), not by brute force
        engine = SearchEngine("c", base_dir=str(tmp_path), device="cpu")
        assert engine.ivf is not None and not engine.brute_force_mode
        assert engine.search_batch(pts[:3], k=4)[2]["search_type"] == "ivf"
        # host_tier and streaming are served on a vamana (or sharded) index
        # only, sharded_flat on a sharded one (the JAX package's
        # ServingConfigErrors)
        with pytest.raises(ServingConfigError, match="vamana or sharded index, got ivf"):
            SearchEngine("c", base_dir=str(tmp_path), device="cpu", serving_mode="host_tier")
        with pytest.raises(ServingConfigError, match="streaming serving needs a loaded vamana"):
            SearchEngine("c", base_dir=str(tmp_path), device="cpu", serving_mode="streaming")
        with pytest.raises(ServingConfigError, match="sharded_flat serving needs a sharded index"):
            SearchEngine("c", base_dir=str(tmp_path), device="cpu", serving_mode="sharded_flat")
        with pytest.raises(ValueError, match="serving_mode"):
            SearchEngine("c", base_dir=str(tmp_path), device="cpu", serving_mode="nope")


@pytest.mark.parametrize("what", ["sharded_meta", "knn_backend", "int8_prune", "iq", "compat"])
def test_unported_graph_options_raise_not_implemented(what, tmp_path):
    """The parts of the graph slice that wait for a later one say so,
    naming ROADMAP.md, instead of running something else."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(64, 8)).astype(np.float32)
    if what == "sharded_meta":
        # the sharded index is served (the parallel slice); a meta without
        # its artifacts degrades mode "auto" to brute force, as any torn
        # index does, and fails the other modes
        from diskrag_tpu_torch.engine import SearchEngine, ServingConfigError

        _tiny_collection(tmp_path, pts, {"index_type": "sharded", "n_shards": 1})
        engine = SearchEngine("c", base_dir=str(tmp_path), device="cpu")
        assert engine.brute_force_mode and engine.sharded is None
        with pytest.raises(ServingConfigError, match="sharded_flat serving could not load"):
            SearchEngine("c", base_dir=str(tmp_path), device="cpu", serving_mode="sharded_flat")
    elif what == "knn_backend":
        from diskrag_tpu_torch.graph.knn_build import build_vamana_knn

        # the ivf backend is ported: it builds a graph (its kNN pass probes
        # an IVF instead of scanning)
        index = build_vamana_knn(pts, degree_bound=4, knn_backend="ivf", device="cpu")
        assert index.adjacency.shape == (64, 4) and int(index.adjacency.max()) < 64
        with pytest.raises(ValueError, match="knn_backend"):
            build_vamana_knn(pts, degree_bound=4, knn_backend="hnsw", device="cpu")
    elif what == "int8_prune":
        # the int8 prune is ported (the streaming slice): on int8 codes it
        # keeps what the f32 prune keeps on their dequantized rows here
        from diskrag_tpu_torch.graph import prune
        from diskrag_tpu_torch.ops.flat_scan import quantize_int8

        codes, scales = quantize_int8(torch.from_numpy(pts))
        ids = torch.from_numpy(rng.integers(0, 64, size=(6, 12)).astype(np.int32))
        point_ids = torch.arange(6, dtype=torch.int32)
        d8 = prune.gathered_distance_int8(codes[:6], scales[:6], codes[ids.long()],
                                          scales[ids.long()], "l2")
        deq = codes.to(torch.float32) * scales[:, None]
        d32 = ((deq[ids.long()] - deq[:6, None, :]) ** 2).sum(-1)
        torch.testing.assert_close(d8, d32, rtol=1e-4, atol=1e-3)
        got = prune.robust_prune_batch(point_ids, ids, codes[ids.long()], d8, 1.2, degree_bound=4,
                                       cand_scales=scales[ids.long()])
        assert got.shape == (6, 4) and bool((got[:, 0] >= 0).all())
        assert not bool((got == point_ids[:, None]).any())  # self-edges removed
    elif what == "iq":
        # the int-quantized rows are ported, and so is the host tier over a
        # sharded index (the parallel slice): without its record file it
        # refuses, as the JAX package does
        from diskrag_tpu_torch.engine import SearchEngine, ServingConfigError
        from diskrag_tpu_torch.pq import IntQuantizer, pq_from_arrays

        iq = IntQuantizer(device="cpu").fit(pts)
        assert isinstance(pq_from_arrays(iq.to_arrays(), device="cpu"), IntQuantizer)
        _tiny_collection(tmp_path, pts, {"index_type": "sharded", "n_shards": 1})
        with pytest.raises(ServingConfigError, match="packed record file"):
            SearchEngine("c", base_dir=str(tmp_path), device="cpu", serving_mode="host_tier")
    else:
        # the packed record file is written, by a vamana build and (the
        # parallel slice) by a sharded one: vector-only records, R = 0
        from diskrag_tpu_torch.build_index import build_index_from_vectors
        from diskrag_tpu_torch.graph.types import VamanaIndex
        from diskrag_tpu_torch.index.persist import read_compat_records, save_index

        adj = np.zeros((64, 2), np.int32)
        index = VamanaIndex.from_numpy(pts, adj, 0, device="cpu")
        save_index(tmp_path / "i", index, write_compat=True)
        vecs, back = read_compat_records(tmp_path / "i" / "index.dat", 64, 8, 2)
        assert np.array_equal(vecs, pts) and np.array_equal(back, adj)
        meta = build_index_from_vectors(pts, tmp_path / "s", index_type="sharded",
                                        write_compat=True, device="cpu")
        assert meta["compat_R"] == 0 and meta["write_compat"]
        vecs, back = read_compat_records(tmp_path / "s" / "index.dat", 64, 8, 0)
        assert np.array_equal(vecs, pts) and back.shape == (64, 0)


def test_f32_products_stay_full_precision():
    """Importing the port pins float32 matrix products to full f32: the
    k-means, prune and table products are the JAX package's
    Precision.HIGHEST ones."""
    import diskrag_tpu_torch.pq.kmeans  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
