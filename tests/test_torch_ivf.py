"""The port's IVF-Flat index held against the JAX package.

On carried state (`convert.ivf_from_jax`: the JAX index's centroids, tile
layout, vectors, metric and tile precision; the tiles rebuilt) the int8
search returns the JAX package's ids, with distances within rtol 1e-5
(cosine: plus an absolute 1e-6, since 1 - cos cancels to an ulp of 1
where the JAX package's norm and the port's are taken in another order);
the bf16 search, whose f32 sums run in another order, is held to recall
within 0.005 and 99% of equal (query, rank) slots. The assignment given
the JAX package's centroids returns its `tile_ids` exactly: the scores
are f32 products of another summation order, so a point whose two cell
scores lay within an ulp could swap choices, but none does on these
sets. A port-built index draws its k-means seeding from another
generator, so it is held to quality: recall within 0.01 of the JAX one's.
The JAX package's own IVF cases (`tests/test_flat_ivf.py`) are mirrored;
directories written by either package load in the other; the engine, the
CLI and doctor serve and report an IVF collection as the JAX ones do."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # the suite runs several workers: do not let each spin a thread per core

import jax.numpy as jnp

from diskrag_tpu.index import ivf as jivf
from diskrag_tpu.index.persist import load_ivf_index as jax_load_ivf, save_ivf_index as jax_save_ivf
from diskrag_tpu_torch.benchmark import ground_truth, make_dataset, recall_at_k
from diskrag_tpu_torch.convert import ivf_from_jax
from diskrag_tpu_torch.index import ivf as tivf
from diskrag_tpu_torch.index.persist import load_ivf_index, save_ivf_index

N, D, NQ, K = 12_000, 32, 200, 10


@pytest.fixture(scope="module")
def data():
    pts, q = make_dataset(N, D, NQ, seed=3)
    return pts, q


@pytest.fixture(scope="module")
def jax_indexes(data):
    pts, _ = data
    out = {}
    for metric, prec in (("l2", "int8"), ("cosine", "int8"), ("dot", "int8"), ("l2", "bf16")):
        out[metric, prec] = jivf.build_ivf(pts, 48, metric=metric, seed=0, tile_precision=prec)
    return out


def _bits(t):
    a = t.view(torch.int16).numpy() if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16 \
        else (t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t))
    return a.view(np.uint8) if a.dtype == np.int8 else a.view(np.uint16)


@pytest.mark.parametrize("metric,prec", [("l2", "int8"), ("cosine", "int8"), ("dot", "int8"),
                                         ("l2", "bf16")])
def test_search_on_carried_state(data, jax_indexes, metric, prec):
    pts, q = data
    j = jax_indexes[metric, prec]
    p = ivf_from_jax(j, device="cpu")
    assert p.tile_precision == prec and p.metric == metric
    # the rebuilt tiles, norms and scales are the JAX package's bits
    assert np.array_equal(_bits(p.tiles), _bits(j.tiles))
    assert np.array_equal(p.tile_norms.numpy(), np.asarray(j.tile_norms))
    assert (p.tile_scales is None) == (j.tile_scales is None)
    if prec == "int8":
        assert np.array_equal(p.tile_scales.numpy(), np.asarray(j.tile_scales))
    for n_probe in (4, 8):
        jd, ji = (np.asarray(a) for a in j.search(jnp.asarray(q), k=K, n_probe=n_probe))
        pd, pi = p.search(q, k=K, n_probe=n_probe)
        assert pi.dtype == torch.int32 and pi.shape == (NQ, K)
        if prec == "int8":
            assert np.array_equal(pi.numpy(), ji)
            np.testing.assert_allclose(pd.numpy(), jd, rtol=1e-5,
                                       atol=1e-6 if metric == "cosine" else 0)
        else:
            gt = ground_truth(pts, q, K, metric=metric, device="cpu")
            assert abs(recall_at_k(pi.numpy(), gt, K) - recall_at_k(ji, gt, K)) <= 0.005
            assert np.mean(pi.numpy() == ji) >= 0.99


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_assignment_given_jax_centroids(data, jax_indexes, metric):
    pts, _ = data
    j = jax_indexes[metric, "int8"]
    cap = int(j.tile_ids.shape[1])
    stages = {}
    tile_ids = tivf.assign_cells(pts, torch.as_tensor(np.array(j.centroids)), cap,
                                 metric=metric, stage_seconds=stages)
    assert tile_ids.dtype == np.int32
    assert np.array_equal(tile_ids, np.asarray(j.tile_ids))
    assert set(stages) == {"assign", "place"}


def test_assignment_spills_and_places_stragglers_as_jax():
    """Heavy spill pressure (cap factor 1.0 on clustered data): the
    placement rounds and the straggler pass run, and still match."""
    rng = np.random.default_rng(5)
    centers = rng.normal(size=(6, 16)).astype(np.float32) * 5
    pts = centers[rng.integers(0, 6, size=3000)] + rng.normal(size=(3000, 16)).astype(np.float32)
    j = jivf.build_ivf(pts, 40, cap_factor=1.0, seed=0)
    cap = int(j.tile_ids.shape[1])
    tile_ids = tivf.assign_cells(pts, torch.as_tensor(np.array(j.centroids)), cap)
    assert np.array_equal(tile_ids, np.asarray(j.tile_ids))
    placed = tile_ids[tile_ids >= 0]
    assert len(placed) == len(pts) == len(np.unique(placed))


def test_int8_cross_is_exact_past_2_24():
    """D = 1536 with codes of +-127: each dot product reaches 127^2 * 1536
    > 2^24, where one f32 product would round; the chunked one sums in
    int32 exactly."""
    rng = np.random.default_rng(0)
    d = 1536
    q = rng.choice(np.array([-127, 127], np.int8), size=(3, d))
    q[0] = 127
    tiles = rng.choice(np.array([-127, 127], np.int8), size=(3, 5, d))
    tiles[0, 0] = 127  # the largest sum: 127 * 127 * 1536 = 24,772,608
    tiles[1, 1] = -q[1]
    got = tivf.int8_cross(torch.as_tensor(q), torch.as_tensor(tiles))
    want = np.einsum("bd,bcd->bc", q.astype(np.int64), tiles.astype(np.int64))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert want[0, 0] == 127 * 127 * d > 2**24
    # the JAX package's int32 einsum gives the same
    jax_cross = jnp.einsum("bd,bcd->bc", jnp.asarray(q), jnp.asarray(tiles),
                           preferred_element_type=jnp.int32)
    assert np.array_equal(np.asarray(jax_cross), want)


def test_port_built_ivf_recall_close_to_jax(data, jax_indexes):
    """Recall of the port's own builds within 0.01 of the JAX package's,
    each averaged over four seeds: one build's recall moves by up to 0.02
    with the k-means seeding in either package (a draw that splits a
    cluster), so one seed against another measures the draw."""
    pts, q = data
    gt = ground_truth(pts, q, K, device="cpu")
    stages = {}
    p = tivf.build_ivf(pts, 48, seed=0, device="cpu", stage_seconds=stages)
    assert set(stages) == {"fit", "assign", "place", "tiles"}
    j = jax_indexes["l2", "int8"]
    assert p.tiles.shape == tuple(j.tiles.shape) and p.tiles.dtype == torch.int8
    placed = p.tile_ids.numpy()[p.tile_ids.numpy() >= 0]
    assert len(placed) == N == len(np.unique(placed))
    ours, theirs = {4: [], 8: []}, {4: [], 8: []}
    for seed in range(4):
        p = tivf.build_ivf(pts, 48, seed=seed, device="cpu")
        j = jax_indexes["l2", "int8"] if seed == 0 else jivf.build_ivf(pts, 48, seed=seed)
        for n_probe in (4, 8):
            ours[n_probe].append(recall_at_k(p.search(q, k=K, n_probe=n_probe)[1].numpy(), gt, K))
            theirs[n_probe].append(recall_at_k(
                np.asarray(j.search(jnp.asarray(q), k=K, n_probe=n_probe)[1]), gt, K))
    for n_probe in (4, 8):
        assert abs(np.mean(ours[n_probe]) - np.mean(theirs[n_probe])) <= 0.01, (
            n_probe, ours[n_probe], theirs[n_probe])
    # the JAX package's defaults: cell count and capacity
    d = tivf.build_ivf(pts, device="cpu")
    assert d.n_cells == tivf.default_n_cells(N) == int(max(16, min(4 * np.sqrt(N), N // 8)))
    assert d.tiles.shape[1] == int(np.ceil(2.0 * N / d.n_cells))


def test_large_k_narrow_probe(clustered_data):
    """k above cap * n_probe: the candidate width never falls below k; the
    slots past the probed points are -1 with +inf, never duplicates."""
    idx = tivf.build_ivf(clustered_data, 64, seed=0, device="cpu")
    cap = int(idx.tiles.shape[1])
    d, ids = idx.search(clustered_data[:4], k=cap + 10, n_probe=1)
    assert ids.shape == (4, cap + 10)
    for row, drow in zip(ids.numpy(), d.numpy()):
        real = row[row >= 0]
        assert len(np.unique(real)) == len(real)
        assert np.isinf(drow[row < 0]).all()


def test_spill_points_stay_findable(clustered_data):
    pts = clustered_data
    idx = tivf.build_ivf(pts, 64, cap_factor=1.5, seed=0, device="cpu")
    tids = idx.tile_ids.numpy()
    placed = tids[tids >= 0]
    assert len(placed) == len(pts) and len(np.unique(placed)) == len(pts)
    _, ids = idx.search(pts[::7], k=1, n_probe=16)
    hit = float(np.mean(ids.numpy()[:, 0] == np.arange(0, len(pts), 7)))
    assert hit >= 0.99, hit


def test_tile_precision_persisted(clustered_data, tmp_path):
    for prec, dtype in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        idx = tivf.build_ivf(clustered_data, 32, seed=0, tile_precision=prec, device="cpu")
        assert idx.tiles.dtype == dtype
        save_ivf_index(tmp_path / prec, idx)
        loaded, meta = load_ivf_index(tmp_path / prec, device="cpu")
        assert meta["tile_precision"] == prec and loaded.tiles.dtype == dtype
        assert (loaded.tile_scales is None) == (prec == "bf16")
        assert torch.equal(loaded.tiles.view(torch.int8) if prec == "int8" else loaded.tiles.view(torch.int16),
                           idx.tiles.view(torch.int8) if prec == "int8" else idx.tiles.view(torch.int16))
    with pytest.raises(ValueError, match="tile_precision"):
        tivf.build_ivf(clustered_data, 32, tile_precision="fp8", device="cpu")


def test_cap_factor_below_one_refused(clustered_data):
    with pytest.raises(ValueError, match="cap_factor"):
        tivf.build_ivf(clustered_data, 32, cap_factor=0.9, device="cpu")


def test_cosine_recall_clustered():
    """Cosine cells are assigned by dot, the score the probe ranks them by."""
    pts, q = make_dataset(20_000, 64, 64)
    idx = tivf.build_ivf(pts, 64, metric="cosine", seed=0, cap_factor=3.0, device="cpu")
    _, ids = idx.search(q, k=10, n_probe=8)
    gt = ground_truth(pts, q, 10, metric="cosine", device="cpu")
    assert recall_at_k(ids.numpy(), gt, 10) >= 0.95


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_load_both_ways(data, jax_indexes, tmp_path, writer):
    """A directory written by either package loads in the other and
    searches to the same ids."""
    pts, q = data
    if writer == "port":
        src = tivf.build_ivf(pts, 48, seed=1, device="cpu")
        meta = save_ivf_index(tmp_path, src)
        jax_idx, jmeta = jax_load_ivf(tmp_path)
        ours = src.search(q, k=K, n_probe=8)[1].numpy()
        ours_loaded = load_ivf_index(tmp_path, device="cpu")[0].search(q, k=K, n_probe=8)[1].numpy()
        assert np.array_equal(ours, ours_loaded)
    else:
        jax_idx = jax_indexes["l2", "int8"]
        jmeta = jax_save_ivf(tmp_path, jax_idx)
        loaded, meta = load_ivf_index(tmp_path, device="cpu")
        ours = loaded.search(q, k=K, n_probe=8)[1].numpy()
    assert meta == jmeta
    assert {"index_type", "n_cells", "cell_capacity", "tile_precision"} <= set(meta)
    theirs = np.asarray(jax_idx.search(jnp.asarray(q), k=K, n_probe=8)[1])
    assert np.array_equal(ours, theirs)


def _collection(base, name, pts):
    from diskrag_tpu_torch.data.collection import CollectionManager

    mgr = CollectionManager(base)
    mgr.create_collection(name, dimension=pts.shape[1])
    mgr.update_collection(name, pts, [f"t{i}" for i in range(len(pts))],
                          [{"i": i} for i in range(len(pts))])
    return mgr


def test_engine_serves_ivf_as_jax(data, tmp_path):
    """An IVF collection built by the port, served by both engines: the
    probe count from l_search, the same ids, stats and search type."""
    from diskrag_tpu.engine import SearchEngine as JaxEngine
    from diskrag_tpu.engine import ServingConfigError as JaxServingConfigError
    from diskrag_tpu_torch.build_index import build_index_from_vectors
    from diskrag_tpu_torch.engine import SearchEngine, ServingConfigError

    pts, q = data
    mgr = _collection(tmp_path, "c", pts)
    meta = build_index_from_vectors(pts, mgr.get_index_dir("c"), index_type="ivf",
                                    ivf_n_cells=40, ivf_cap_factor=2.5, device="cpu")
    assert meta["index_type"] == "ivf" and meta["n_cells"] == 40
    assert meta["cell_capacity"] == int(np.ceil(2.5 * N / 40)) and "build_seconds" in meta
    ours = SearchEngine("c", base_dir=str(tmp_path), device="cpu")
    theirs = JaxEngine("c", base_dir=str(tmp_path))
    assert ours.diagnostics["passed"] and ours.diagnostics["serving_mode"] == "ivf"
    assert ours.diagnostics["self_retrieval_rate"] == theirs.diagnostics["self_retrieval_rate"]
    for l_search in (None, 16, 32, 200):
        d, ids, st = ours.search_batch(q, k=K, l_search=l_search)
        jd, jids, jst = theirs.search_batch(q, k=K, l_search=l_search)
        assert np.array_equal(ids, np.asarray(jids))
        np.testing.assert_allclose(d, jd, rtol=1e-5)
        assert st["search_type"] == jst["search_type"] == "ivf"
        assert st["nodes_visited"] == jst["nodes_visited"]
    stats = ours.get_search_statistics()
    assert stats == {k: v for k, v in theirs.get_search_statistics().items() if k in stats} | {
        "total_search_time": stats["total_search_time"], "avg_search_time": stats["avg_search_time"]}
    # host_tier on an IVF index: the JAX package's exception and message
    with pytest.raises(ServingConfigError) as ours_err:
        SearchEngine("c", base_dir=str(tmp_path), device="cpu", serving_mode="host_tier")
    with pytest.raises(JaxServingConfigError) as jax_err:
        JaxEngine("c", base_dir=str(tmp_path), serving_mode="host_tier")
    assert str(ours_err.value) == str(jax_err.value)


def test_cli_builds_searches_and_doctors_ivf(tmp_path, monkeypatch, capsys):
    import pandas as pd

    from diskrag_tpu.cli import DiskRAG as JaxRAG
    from diskrag_tpu_torch.cli import DiskRAG, main as cli_main
    from diskrag_tpu_torch.data import (
        EmbeddingConfig, PreprocessingConfig, QuestionGenerationConfig, save_config,
    )

    monkeypatch.chdir(tmp_path)
    save_config(PreprocessingConfig(
        collection="faq", embedding=EmbeddingConfig(provider="mock", model="mock", dimension=64),
        question_generation=QuestionGenerationConfig(enabled=False),
    ), tmp_path / "config.yaml")
    pd.DataFrame([{"id": f"q{i}", "question": f"如何使用功能{i}？", "answer": f"功能{i}的答案。"}
                  for i in range(40)]).to_csv(tmp_path / "faq.csv", index=False)
    cpu = ["--device", "cpu"]
    assert cli_main([*cpu, "process", "faq.csv", "-c", "faq"]) == 0
    capsys.readouterr()
    assert cli_main([*cpu, "index", "faq", "--index-type", "ivf"]) == 0
    assert capsys.readouterr().out.startswith("index built: type=ivf N=40 R=- L=- use_pq=False (")
    assert cli_main([*cpu, "search", "faq", "如何使用功能7?", "-k", "3"]) == 0
    assert "功能7" in capsys.readouterr().out
    ours = DiskRAG("config.yaml", device="cpu").search("faq", "如何使用功能12?", k=5)
    theirs = JaxRAG("config.yaml").search("faq", "如何使用功能12?", k=5)
    assert ours["stats"]["search_type"] == theirs["stats"]["search_type"] == "ivf"
    assert [r["text"] for r in ours["results"]] == [r["text"] for r in theirs["results"]]
    report = DiskRAG("config.yaml", device="cpu").doctor("faq")
    assert report["status"] == "ok" and any("ivf index present" in a for a in report["actions"])
    assert report == JaxRAG("config.yaml").doctor("faq")
    assert cli_main([*cpu, "doctor", "faq"]) == 0
    assert capsys.readouterr().out.strip() == str(report)


def test_sweep_ivf(data):
    from diskrag_tpu_torch.benchmark import sweep_ivf

    pts, q = data
    gt = ground_truth(pts, q, K, device="cpu")
    points, (cold, warm) = sweep_ivf(pts, q, gt, k=K, n_cells=48, n_probes=(8, 16, 32, 64),
                                     repeats=1, min_seconds=0.0, device="cpu")
    assert [p.search_width for p in points] == [8, 16, 32]  # 64 > 48 cells: skipped
    assert cold > 0 and warm > 0 and all(p.mode == "ivf-int8" for p in points)
    recalls = [p.recall for p in points]
    assert recalls == sorted(recalls) and recalls[-1] >= 0.99
