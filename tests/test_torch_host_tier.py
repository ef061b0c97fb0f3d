"""The port's host tier (`diskrag_tpu_torch/index/host_tier.py`) against
the JAX package's, on the CPU: the host rerank bit for bit, the search in
all three modes on JAX-built index directories (equal ids; also over the
capacity ladder's quantizers, swapped in by the JAX package: a residual PQ
at m = 64 and int4 rows with cells), the quantizer swap of the port's
`persist.replace_pq_artifacts` opened by both packages, the pipelined
search against the sequential one, the guards, the engine's "host_tier"
and "iq_accelerated" modes, cross-loading both ways, the CLI, the
dataset benchmark's `--host-tier` sweep and the launch counters' lock."""

import json
import shutil
import sys
import threading

import numpy as np
import pandas as pd
import pytest
import torch

torch.set_num_threads(2)  # the suite runs several workers: do not let each spin a thread per core

from diskrag_tpu.build_index import build_index_from_vectors as jax_build
from diskrag_tpu.data.collection import CollectionManager as JaxManager
from diskrag_tpu.data.config import CollectionInfo as JaxInfo
from diskrag_tpu.engine import ServingConfigError as JaxServingConfigError
from diskrag_tpu.engine import SearchEngine as JaxEngine
from diskrag_tpu.index.host_tier import HostTierIndex as JaxHostTier
from diskrag_tpu.index.host_tier import exact_rerank_pool as jax_exact_rerank_pool
from diskrag_tpu.native import RecordReader as JaxRecordReader

from diskrag_tpu_torch.benchmark import recall_at_k
from diskrag_tpu_torch.build_index import build_index_from_vectors as torch_build
from diskrag_tpu_torch.engine import SearchEngine, ServingConfigError
from diskrag_tpu_torch.index.host_tier import HostTierIndex, exact_rerank_pool
from diskrag_tpu_torch.native import RecordReader

PARAMS = {"R": 32, "L": 64, "alpha": 1.2}
# "iq" / "pq": built by the JAX package with that pq_kind. "rpq64" / "iq4c":
# the capacity ladder's residual PQ at m = 64 and int4 rows with cells
# (`benchmarks/host_tier_multi.py`), swapped by the JAX package into a copy
# of the "iq" index, the cell count scaled to the fixture as the JAX
# package scales it (`default_iq_cells`)
KINDS = {"iq": dict(pq_kind="int8"), "pq": dict(pq_kind="residual"),
         "rpq64": dict(swap="rpq64"), "iq4c": dict(swap="iq4c")}
MODES = {"iq": "iq", "pq": "pq", "bf16": "bf16", "rpq64": "pq", "iq4c": "iq"}


def _collection(base, name, pts):
    mgr = JaxManager(base)
    (base / name).mkdir(parents=True)
    np.save(mgr.get_vectors_path(name), pts)
    mgr.save_collection_info(JaxInfo(
        name=name, config={}, dimension=pts.shape[1], num_vectors=len(pts),
        created_at="", updated_at="", source_files=[],
    ))
    return mgr.get_index_dir(name)


def _pq_family_removed(meta: dict) -> dict:
    return {k: v for k, v in meta.items()
            if not k.startswith(("pq_", "iq_")) and k not in ("n_subvectors", "use_pq")}


def _jax_swap(index_dir, tag: str, pts) -> None:
    """The JAX package trains `tag`'s quantizer and swaps it into the index
    directory as its host-tier bench does (`host_tier_multi.py::
    train_quantizer`): the artifacts, then the pq family's meta keys
    replaced, not merged."""
    from diskrag_tpu.index.persist import IndexStore, save_pq_artifacts
    from diskrag_tpu.pq import IntQuantizer, ResidualPQ, default_iq_cells

    store = IndexStore(index_dir)
    if tag == "rpq64":
        quant = ResidualPQ(n_subvectors=64).fit(pts, seed=0)
        codes, cids = quant.encode(pts)
        extra = save_pq_artifacts(store, quant, np.asarray(codes), coarse_ids=np.asarray(cids))
    else:
        quant = IntQuantizer(bits=4, n_cells=default_iq_cells(len(pts), 4)).fit(pts, seed=0)
        extra = save_pq_artifacts(store, quant, np.asarray(quant.encode(pts)))
    meta = _pq_family_removed(json.loads(store.meta_path.read_text()))
    store.meta_path.write_text(json.dumps({**meta, **extra}))


@pytest.fixture(scope="module")
def jax_dirs(clustered_data, tmp_path_factory):
    """{kind: (collections base, index dir)} built by the JAX package with
    the record file: int8 rows ("iq"), a residual PQ ("pq"), and copies of
    the int8 index with the ladder's quantizers swapped in ("rpq64",
    "iq4c")."""
    out = {}
    for kind, kw in KINDS.items():
        base = tmp_path_factory.mktemp(f"jax_{kind}")
        if "swap" in kw:
            shutil.copytree(out["iq"][0] / "c", base / "c")
            index_dir = base / "c" / "index"
            _jax_swap(index_dir, kw["swap"], clustered_data)
        else:
            index_dir = _collection(base, "c", clustered_data)
            jax_build(clustered_data, index_dir, write_compat=True, force_pq=True,
                      params_override=PARAMS, **kw)
        out[kind] = base, index_dir
    return out


@pytest.fixture(scope="module")
def queries(clustered_data):
    rng = np.random.default_rng(9)
    qi = rng.integers(0, len(clustered_data), size=50)
    return clustered_data[qi] + rng.normal(size=(50, clustered_data.shape[1])).astype(np.float32) * 0.1


@pytest.fixture(scope="module")
def gt(clustered_data, queries):
    d = ((queries[:, None, :] - clustered_data[None, :, :]) ** 2).sum(-1)
    return np.argsort(d, axis=1)[:, :10]


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_exact_rerank_pool_matches_jax_bit_for_bit(metric, jax_dirs, clustered_data, queries):
    index_dir = jax_dirs["iq"][1]
    n, d = clustered_data.shape
    rng = np.random.default_rng(3)
    pool = rng.integers(-1, n, size=(len(queries), 40)).astype(np.int32)
    pool[:, 5] = pool[:, 2]  # duplicates inside a row
    path = index_dir / "index.dat"
    ours = exact_rerank_pool(queries, pool, RecordReader(path, n, d, PARAMS["R"]), metric=metric, k=10)
    theirs = jax_exact_rerank_pool(queries, pool, JaxRecordReader(path, n, d, PARAMS["R"]),
                                   metric=metric, k=10)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    # a pool narrower than k keeps the [B, k] contract
    d_small, i_small, _ = exact_rerank_pool(queries, pool[:, :4], RecordReader(path, n, d, 32),
                                            metric=metric, k=10)
    assert i_small.shape == (len(queries), 10) and (i_small[:, 4:] == -1).all()


@pytest.mark.parametrize("mode", ["iq", "pq", "bf16", "rpq64", "iq4c"])
def test_search_on_a_jax_built_index_matches_jax(mode, jax_dirs, queries, gt):
    index_dir = jax_dirs["pq" if mode == "bf16" else mode][1]
    kw = dict(search_width=48, k=10, expand_width=4)
    ours = HostTierIndex.from_store(index_dir, mode=None if mode != "bf16" else mode, device="cpu")
    theirs = JaxHostTier.from_store(index_dir, mode=None if mode != "bf16" else mode)
    kind, mode = mode, MODES[mode]
    if kind == "rpq64":
        assert ours.guide.codes.shape[1] == 64 and ours.guide.cells is not None
    if kind == "iq4c":
        assert (ours.guide.pq.bits == theirs.pq.bits == 4
                and ours.guide.pq.n_cells == theirs.pq.n_cells > 0)
    assert ours.mode == theirs.mode == mode and ours.reader.is_native
    d1, i1, s1 = ours.search(queries, **kw)
    d2, i2, s2 = theirs.search(queries, **kw)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-5, atol=1e-5)
    for key in ("search_type", "mode", "nodes_visited", "host_vectors_fetched"):
        assert s1[key] == s2[key], key
    assert s1["rounds"] > 0 and set(s1["stage_ms"]) == set(s2["stage_ms"])
    assert recall_at_k(i1, gt, 10) >= 0.85
    if mode == "iq":  # the 256-byte gather pad, as the JAX tier holds it
        assert ours.guide.codes.shape[1] == np.asarray(theirs.codes).shape[1] == 256
    assert ours.device_bytes() > 0


def test_quantizer_swap_opens_in_both_packages(jax_dirs, clustered_data, queries, tmp_path):
    """The port's swap (`persist.replace_pq_artifacts`) retrains a JAX-built
    int8 index as the capacity ladder does, iq8 -> rpq64 -> iq8: each time
    both packages open it in the same mode (auto-detected from the meta)
    with equal ids, no key of the previous kind is left, and the meta's
    keys are those the JAX package's own swap leaves."""
    from diskrag_tpu_torch.index.persist import replace_pq_artifacts
    from diskrag_tpu_torch.pq import IntQuantizer, ResidualPQ

    index_dir = _copy(jax_dirs["iq"][1], tmp_path / "swap")
    kw = dict(search_width=48, k=10, expand_width=4)
    rpq = ResidualPQ(n_subvectors=64, device="cpu").fit(clustered_data, seed=0)
    codes, cids = rpq.encode(clustered_data)
    iq8 = IntQuantizer(bits=8, device="cpu").fit(clustered_data, seed=0)
    for quant, args, mode, jax_dir in ((rpq, (codes, cids), "pq", jax_dirs["rpq64"][1]),
                                       (iq8, (iq8.encode(clustered_data), None), "iq", None)):
        meta = replace_pq_artifacts(index_dir, quant, args[0], coarse_ids=args[1])
        assert meta == json.loads((index_dir / "meta.json").read_text())
        stale = {"iq_row_width", "iq_n_cells"} if mode == "pq" else {"n_subvectors", "pq_n_coarse"}
        assert not stale & set(meta) and "use_pq" not in meta
        assert (index_dir / "pq_aux.npz").exists() == (mode == "pq")
        if jax_dir is not None:
            assert set(meta) == set(json.loads((jax_dir / "meta.json").read_text()))
        ours = HostTierIndex.from_store(index_dir, device="cpu")
        theirs = JaxHostTier.from_store(index_dir)
        assert ours.mode == theirs.mode == mode
        np.testing.assert_array_equal(ours.search(queries, **kw)[1], theirs.search(queries, **kw)[1])


@pytest.mark.parametrize("mode", ["iq", "bf16"])
def test_search_pipelined_matches_search(mode, jax_dirs, queries):
    ht = HostTierIndex.from_store(jax_dirs["iq"][1], mode=mode, device="cpu")
    kw = dict(search_width=48, k=10, expand_width=4)
    d_seq, i_seq, s_seq = ht.search(queries, **kw)
    d_pip, i_pip, stats = ht.search_pipelined(queries, chunk=16, **kw)  # 4 chunks, the last short
    assert stats["pipelined_chunks"] == 4
    np.testing.assert_array_equal(i_pip, i_seq)
    np.testing.assert_array_equal(d_pip, d_seq)
    assert stats["nodes_visited"] == s_seq["nodes_visited"]
    assert set(stats["stage_ms"]) == {"traverse", "gather_rerank_select", "rerank_wait", "wall"}
    d1, i1, s1 = ht.search_pipelined(queries[:8], chunk=16, **kw)  # one chunk: search()
    assert "pipelined_chunks" not in s1
    np.testing.assert_array_equal(i1, i_seq[:8])


def _copy(src, dst):
    shutil.copytree(src, dst)
    return dst


def _raised(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value).__name__, str(e.value)


def test_guards_raise_as_in_jax(jax_dirs, tmp_path):
    iq_dir, pq_dir = jax_dirs["iq"][1], jax_dirs["pq"][1]
    no_compat = _copy(iq_dir, tmp_path / "no_compat")
    (no_compat / "index.dat").unlink()
    no_aux = _copy(pq_dir, tmp_path / "no_aux")
    (no_aux / "pq_aux.npz").unlink()
    stale = _copy(pq_dir, tmp_path / "stale")
    with np.load(stale / "pq_aux.npz") as z:
        cells, bias = z["point_cell"], z["point_bias"]
    np.savez(stale / "pq_aux.npz", point_cell=cells[:100], point_bias=bias[:100])
    no_vectors = _copy(pq_dir, tmp_path / "no_vectors")
    (no_vectors / "vectors.npy").unlink()
    cosine = _copy(iq_dir, tmp_path / "cosine")
    meta = json.loads((cosine / "meta.json").read_text())
    (cosine / "meta.json").write_text(json.dumps({**meta, "distance_metric": "cosine"}))
    cases = [
        (iq_dir, "pq", "cannot score"), (pq_dir, "iq", "needs IntQuantizer"),
        (no_compat, None, "packed record file"), (no_aux, "pq", "pq_aux"),
        (stale, "pq", "stale"), (no_vectors, "bf16", "vectors.npy"),
        (cosine, "iq", "L2-only"), (iq_dir, "hnsw", "unknown host-tier mode"),
    ]
    for index_dir, mode, what in cases:
        ours = _raised(lambda: HostTierIndex.from_store(index_dir, mode=mode, device="cpu"))
        theirs = _raised(lambda: JaxHostTier.from_store(index_dir, mode=mode))
        assert ours == theirs, (mode, ours, theirs)
        assert what in ours[1]
    # mode None on a non-L2 index serves bf16, never a quantized traversal
    assert HostTierIndex.from_store(cosine, device="cpu").mode == "bf16"


def test_engine_host_tier_matches_jax(jax_dirs, queries):
    base = jax_dirs["iq"][0]
    ours = SearchEngine("c", base_dir=str(base), serving_mode="host_tier", device="cpu")
    theirs = JaxEngine("c", base_dir=str(base), serving_mode="host_tier")
    assert ours.diagnostics["passed"] and ours.diagnostics["serving_mode"] == "host_tier"
    assert ours.host_tier.mode == "iq" and ours.index is None
    d1, i1, s1 = ours.search_batch(queries, k=10, l_search=48)
    d2, i2, s2 = theirs.search_batch(queries, k=10, l_search=48)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-5)
    assert s1["search_type"] == s2["search_type"] == "host_tier"
    assert s1["nodes_visited"] == s2["nodes_visited"] and s1["rounds"] > 0
    assert set(s1["stage_ms"]) == set(s2["stage_ms"]) and s1["expand_width"] == 4
    # a batch over the pipeline chunk: max(256, ceil(B / 2)) -> 2 chunks
    big = np.concatenate([queries] * 6)  # 300 queries
    _, i_big, s_big = ours.search_batch(big, k=10, l_search=48)
    assert s_big["pipelined_chunks"] == 2
    np.testing.assert_array_equal(i_big[:50], i1)


def test_engine_auto_mode_serves_int_rows_iq_accelerated(jax_dirs, queries):
    base = jax_dirs["iq"][0]
    ours = SearchEngine("c", base_dir=str(base), device="cpu")
    theirs = JaxEngine("c", base_dir=str(base))
    d1, i1, s1 = ours.search_batch(queries, k=10, l_search=48)
    d2, i2, s2 = theirs.search_batch(queries, k=10, l_search=48)
    assert s1["search_type"] == s2["search_type"] == "iq_accelerated"
    np.testing.assert_array_equal(i1, i2)
    # the in-memory rerank expands |q|^2 + |x|^2 - 2 q.x in f32 on the
    # device, with |x|^2 ~ 1.7e3 on this data: the two packages' sums
    # round apart by ~1e-2 in the squared distance, ~1e-3 after the sqrt
    np.testing.assert_allclose(d1, d2, rtol=1e-5, atol=2e-3)
    assert ours.diagnostics["passed"] and ours.diagnostics["pq_exact_correlation"] > 0.9


def test_engine_refuses_without_the_record_file(jax_dirs, tmp_path):
    base = _copy(jax_dirs["iq"][0], tmp_path / "base")
    (base / "c" / "index" / "index.dat").unlink()
    with pytest.raises(ServingConfigError, match="packed record file"):
        SearchEngine("c", base_dir=str(base), serving_mode="host_tier", device="cpu")
    with pytest.raises(JaxServingConfigError, match="packed record file"):
        JaxEngine("c", base_dir=str(base), serving_mode="host_tier")
    # a flat index has no graph to traverse
    pts = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    flat_dir = _collection(tmp_path / "flat", "f", pts)
    torch_build(pts, flat_dir, index_type="flat", device="cpu")
    with pytest.raises(ServingConfigError, match="vamana"):
        SearchEngine("f", base_dir=str(tmp_path / "flat"), serving_mode="host_tier", device="cpu")


def test_port_written_index_opens_in_the_jax_host_tier(clustered_data, queries, tmp_path):
    from diskrag_tpu_torch.benchmark import sweep_iq
    from diskrag_tpu_torch.index.persist import load_index

    meta = torch_build(clustered_data, tmp_path / "idx", write_compat=True, force_pq=True,
                       pq_kind="int8", params_override=PARAMS, device="cpu")
    assert meta["pq_kind"] == "int8" and meta["iq_row_width"] == 66 and meta["iq_n_cells"] == 0
    assert meta["pq_validation"]["passed"]
    ours = HostTierIndex.from_store(tmp_path / "idx", device="cpu")
    theirs = JaxHostTier.from_store(tmp_path / "idx")
    assert ours.mode == theirs.mode == "iq"
    kw = dict(search_width=48, k=10, expand_width=4)
    np.testing.assert_array_equal(ours.search(queries, **kw)[1], theirs.search(queries, **kw)[1])
    # the in-memory int-quantized sweep over the same artifacts
    index, iq, rows, _ = load_index(tmp_path / "idx", device="cpu")
    d = ((queries[:, None, :] - clustered_data[None, :, :]) ** 2).sum(-1)
    gt = np.argsort(d, axis=1)[:, :10]
    (pt,) = sweep_iq(index, iq, rows, queries, gt, k=10, widths=(32,), expand_widths=(4,),
                     repeats=1, min_seconds=0.0)
    assert pt.mode == "iq8" and pt.recall >= 0.85 and pt.rounds > 0


def test_cli_serving_mode_host_tier(tmp_path, monkeypatch, capsys):
    from diskrag_tpu_torch.cli import DiskRAG, main as cli_main
    from diskrag_tpu_torch.data import (
        EmbeddingConfig, PreprocessingConfig, QuestionGenerationConfig, save_config,
    )
    from diskrag_tpu_torch.data.config import IndexConfig

    monkeypatch.chdir(tmp_path)
    save_config(PreprocessingConfig(
        collection="faq", embedding=EmbeddingConfig(provider="mock", model="mock", dimension=128),
        question_generation=QuestionGenerationConfig(enabled=False),
        index=IndexConfig(force_pq=True, pq_kind="int8", write_compat=True),
    ), tmp_path / "config.yaml")
    rows = [{"id": f"q{i}", "question": f"如何使用功能{i}？", "answer": f"功能{i}的答案。"}
            for i in range(40)]
    pd.DataFrame(rows).to_csv("faq.csv", index=False)
    cpu = ["--device", "cpu"]
    assert cli_main([*cpu, "process", "faq.csv", "--collection", "faq"]) == 0
    assert cli_main([*cpu, "index", "faq"]) == 0
    index_dir = tmp_path / "collections" / "faq" / "index"
    meta = json.loads((index_dir / "meta.json").read_text())
    assert meta["pq_kind"] == "int8" and (index_dir / "index.dat").exists()
    capsys.readouterr()
    assert cli_main([*cpu, "search", "faq", "如何使用功能7?", "-k", "3",
                     "--serving-mode", "host_tier"]) == 0
    assert "功能7" in capsys.readouterr().out
    out = DiskRAG("config.yaml", device="cpu").search("faq", "如何使用功能7?", k=3,
                                                      serving_mode="host_tier")
    assert out["stats"]["search_type"] == "host_tier" and out["stats"]["mode"] == "iq"


def test_dataset_benchmark_host_tier_sweep(capsys):
    from diskrag_tpu_torch.tools import dataset_benchmark

    argv = ["--n", "1500", "--dim", "16", "--n-queries", "16", "--widths", "32", "--expand", "4",
            "--host-tier", "--json", "--device", "cpu"]
    assert dataset_benchmark.main(argv) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ht = [p for p in result["sweep"] if p["mode"] == "host-tier"]
    assert [p["L"] for p in ht] == [24, 32, 48, 64] and all(p["E"] == 4 for p in ht)
    assert max(p["recall"] for p in ht) >= 0.9


def test_launch_counters_are_exact_under_threads():
    """The HTTP handlers and the pipelined host tier count launches from
    several threads: every increment lands."""
    from diskrag_tpu_torch.kernels.launches import count, launch_counts, reset_launch_counts
    from diskrag_tpu_torch.ops import flat_scan as fs
    from diskrag_tpu_torch.ops import pq_scan

    reset_launch_counts()
    per_thread, n_threads = 10_000, 16  # more threads than cores

    def work():
        for _ in range(per_thread):
            count(pq_scan.adc_lookup_gathered_kernel)
            count(fs.scan_bucketed_topk_hier, "launches_pipelined")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter allows
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    got = launch_counts()
    reset_launch_counts()
    assert got["B5"] == got["B6"] == per_thread * n_threads
    assert not any(launch_counts().values())
