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
import diskrag_tpu_torch.ops.flat
from diskrag_tpu_torch.ops.flat_scan import (
    build_packed_scan_table, epilogue_cut_ids_ref, plan_packed_search,
    quantize_int8_global, scan_bucketed_topk_hier, scan_bucketed_topk_hier_ref,
    scan_bucketed_topk_packed, scan_bucketed_topk_packed_ref,
)
from diskrag_tpu_torch.benchmark import SweepPoint, adaptive_flat_point, sweep_flat
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "diskrag_tpu."))
             or m == "diskrag_tpu")
lazy = sorted(m for m in ("pandas", "yaml", "pyarrow", "httpx") if m in sys.modules)
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


def test_cpu_tensors_take_the_plain_versions_without_counting_launches():
    from diskrag_tpu_torch.ops import flat_scan as fs

    fs.reset_launch_counts()
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


def test_kernel_build_is_keyed_by_source_hash():
    from diskrag_tpu_torch.kernels import _build

    srcs = sorted(_build.CSRC.glob("*.cu"))
    assert [s.stem for s in srcs] == ["flat_scan", "hier_scan", "packed_scan", "topk_lanes"]
    paths = {_build._lib_path(s) for s in srcs}
    assert len(paths) == 4
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
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_index_from_vectors(pts, tmp_path, index_type="vamana", device="cpu")
        big = np.zeros((100_000, 2), np.float32)
        with pytest.raises(NotImplementedError, match="vamana"):
            build_index_from_vectors(big, tmp_path, index_type="auto", device="cpu")
    else:
        from diskrag_tpu_torch.data.collection import CollectionManager
        from diskrag_tpu_torch.data.config import CollectionInfo
        from diskrag_tpu_torch.engine import SearchEngine

        mgr = CollectionManager(tmp_path)
        (tmp_path / "c").mkdir()
        np.save(mgr.get_vectors_path("c"), pts)
        mgr.save_collection_info(CollectionInfo(
            name="c", config={}, dimension=8, num_vectors=64, created_at="",
            updated_at="", source_files=[],
        ))
        idx = mgr.get_index_dir("c")
        idx.mkdir()
        (idx / "meta.json").write_text(json.dumps({"index_type": "vamana"}))
        # never served by brute force in place of the requested index
        with pytest.raises(NotImplementedError, match="vamana"):
            SearchEngine("c", base_dir=str(tmp_path), device="cpu")
        with pytest.raises(NotImplementedError, match="host_tier"):
            SearchEngine("c", base_dir=str(tmp_path), device="cpu",
                         serving_mode="host_tier")
