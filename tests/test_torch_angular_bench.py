"""The port's angular bench (`diskrag_tpu_torch/tools/angular_bench.py`)
against the JAX package's protocol (`benchmarks/angular_bench.py`), on
the CPU. The JAX protocol is run here step for step through the JAX
package's own functions (never the script's `main()`, which writes under
`benchmarks/`), with its sweeps' timed window cut to 10 ms.

Port-built graphs and codebooks draw from `torch.Generator`, so the run
is held to quality: the same rows and keys, recall within 0.01 on the
exact and iq8 rows and within 0.03 on the residual PQ rows (`RPQ_TOL`).
Carried JAX state (`convert.vamana_index_from_jax`, `convert.pq_from_jax`)
is held to JAX's ids. Also: the native-cosine build against JAX's and
against the port's own L2-on-normalized build, and the share of points
no edge points to in both packages' kNN builds."""

import contextlib
import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # the suite runs several workers: do not let each spin a thread per core

import jax.numpy as jnp

import diskrag_tpu.benchmark as jbench
from diskrag_tpu.graph import search as jsearch
from diskrag_tpu.graph.knn_build import build_vamana_knn as jax_build
from diskrag_tpu.pq import IntQuantizer as JaxIQ
from diskrag_tpu.pq import ResidualPQ as JaxRPQ

from diskrag_tpu_torch.benchmark import ground_truth, make_dataset, sweep_exact, sweep_pq
from diskrag_tpu_torch.convert import pq_from_jax, vamana_index_from_jax
from diskrag_tpu_torch.graph import search as tsearch
from diskrag_tpu_torch.graph.knn_build import build_vamana_knn
from diskrag_tpu_torch.tools import angular_bench

K = 10
RUN_N, RUN_D, RUN_Q = 4000, 32, 64
EXACT_TOL = 0.01  # exact and iq8 rows: port-built graph against JAX-built
RPQ_TOL = 0.03    # residual PQ rows: port-built codebooks too (ADC on unit vectors)
COSINE_TOL = 0.01  # native cosine against JAX's and against L2 on normalized
IN_EDGE_TOL = 0.005  # the port's share of points without an in-edge over JAX's


@contextlib.contextmanager
def _short_jax_windows():
    """The JAX sweeps' timed window cut from 1.5 s to 10 ms (recall does
    not depend on it)."""
    real = jbench._measure
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbench, "_measure", functools.partial(real, min_seconds=0.01))
        yield


def _jax_angular_dataset(n, dim, n_queries):
    """`benchmarks/angular_bench.py:62-64`."""
    pts, queries = jbench.make_dataset(n, dim, n_queries)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    return pts, queries


def _jax_protocol(n, dim, n_queries):
    """`benchmarks/angular_bench.py::main` through the JAX package's
    functions, with the port's rule for D < 64 (a residual PQ takes
    min(m, D) subvectors). Returns (result dict, the JAX graph)."""
    import time

    pts, queries = _jax_angular_dataset(n, dim, n_queries)
    gt = jbench.ground_truth(pts, queries, K)
    t0 = time.perf_counter()
    index = jax_build(pts, degree_bound=32, alpha=1.2, seed=0)
    build_s = time.perf_counter() - t0
    with _short_jax_windows():
        points = jbench.sweep_exact(index, queries, gt, k=K, widths=(16, 32), expand_widths=(8,))
        iq8 = JaxIQ(bits=8).fit(pts, seed=0)
        points += jbench.sweep_iq(index, iq8, iq8.encode(pts), queries, gt, k=K,
                                  widths=(16, 32), expand_widths=(8,))
        rpq = JaxRPQ(n_subvectors=min(32, dim)).fit(pts, seed=0)
        codes, cids = rpq.encode(pts)
        points += jbench.sweep_pq(index, rpq, np.asarray(codes), queries, gt, k=K,
                                  widths=(32, 64), expand_widths=(4,), coarse_ids=np.asarray(cids))
        rpq64 = JaxRPQ(n_subvectors=min(64, dim), n_coarse=2048).fit(pts, seed=0)
        codes64, cids64 = rpq64.encode(pts)
        points += jbench.sweep_pq(index, rpq64, np.asarray(codes64), queries, gt, k=K,
                                  widths=(64, 96), expand_widths=(4,),
                                  coarse_ids=np.asarray(cids64))
    out = {
        "config": f"angular-normalized-{n}",
        "build_seconds": round(build_s, 1),
        "measured": time.strftime("%Y-%m-%d"),
        "sweep": [{"mode": p.mode, "L": p.search_width, "E": p.expand_width,
                   "recall": round(p.recall, 4), "qps": round(p.qps, 1)} for p in points],
    }
    return out, index


@pytest.fixture(scope="module")
def runs():
    keep: dict = {}
    port = angular_bench.run(n=RUN_N, dim=RUN_D, n_queries=RUN_Q, device="cpu",
                             min_seconds=0.01, keep=keep)
    jax_out, jax_index = _jax_protocol(RUN_N, RUN_D, RUN_Q)
    return {"port": port, "keep": keep, "jax": jax_out, "jax_index": jax_index}


def test_make_angular_dataset_equals_the_jax_protocols_arrays():
    pts, q = angular_bench.make_angular_dataset(3000, 32, 50)
    jpts, jq = _jax_angular_dataset(3000, 32, 50)
    assert pts.dtype == q.dtype == np.float32
    assert np.array_equal(pts.view(np.uint32), jpts.view(np.uint32))
    assert np.array_equal(q.view(np.uint32), jq.view(np.uint32))


def test_run_has_the_jax_protocols_rows_keys_and_recall(runs):
    port, jax_out = runs["port"], runs["jax"]
    assert set(port) == set(jax_out) | {"stage_seconds"}
    assert port["config"] == jax_out["config"] == f"angular-normalized-{RUN_N}"
    assert {"entry_points", "knn", "prune", "reverse", "merge"} <= set(port["stage_seconds"])
    assert "peak_device_bytes" not in port["stage_seconds"]  # CUDA only
    assert [(r["mode"], r["L"], r["E"]) for r in port["sweep"]] == \
        [(r["mode"], r["L"], r["E"]) for r in jax_out["sweep"]]
    assert [r["mode"] for r in port["sweep"]] == (
        ["exact"] * 2 + ["iq8"] * 2 + [f"rpq{min(32, RUN_D)}+rerank"] * 2
        + [f"rpq{min(64, RUN_D)}+rerank"] * 2)
    for got, want in zip(port["sweep"], jax_out["sweep"]):
        assert set(got) == set(want) == {"mode", "L", "E", "recall", "qps"}
        tol = RPQ_TOL if got["mode"].startswith("rpq") else EXACT_TOL
        assert abs(got["recall"] - want["recall"]) <= tol, (got, want)
        assert got["recall"] == round(got["recall"], 4) and got["qps"] > 0
    # each sweep ran on the CPU: no kernel was launched
    assert not any(v for st in runs["keep"]["launches"].values() for v in st.values())


def test_run_writes_only_out_path_and_cli_needs_a_card(tmp_path, monkeypatch, capsys):
    import json

    monkeypatch.chdir(tmp_path)
    out = tmp_path / "angular.json"
    assert angular_bench.main(["--n", "600", "--dim", "32", "--device", "cpu",
                               "--min-seconds", "0.001", "--out", str(out)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert json.loads(out.read_text()) == line
    assert sorted(p.name for p in tmp_path.iterdir()) == ["angular.json"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            angular_bench.run(n=600, dim=32, n_queries=8)


# carried state: n large enough for more than 1024 coarse cells (n // 4 =
# 1100 of the 2048 asked for), D = 64 so that m = 64 divides it
CARRY_N, CARRY_D, CARRY_Q = 4400, 64, 48


@pytest.fixture(scope="module")
def carried():
    pts, q = _jax_angular_dataset(CARRY_N, CARRY_D, CARRY_Q)
    jidx = jax_build(pts, degree_bound=32, alpha=1.2, seed=0)
    gt = ground_truth(pts, q, K, device="cpu")
    return pts, q, gt, jidx


@pytest.mark.parametrize("m,n_coarse,widths", [(32, 1024, (32, 64)), (64, 2048, (64, 96))])
def test_sweep_pq_on_carried_jax_state_gives_jax_ids(carried, m, n_coarse, widths):
    pts, q, gt, jidx = carried
    jrpq = JaxRPQ(n_subvectors=m, n_coarse=n_coarse).fit(pts, seed=0)
    assert jrpq.n_coarse == min(n_coarse, CARRY_N // 4)
    if m == 64:
        assert jrpq.n_coarse > 1024
    jcodes, jcid = (np.asarray(a) for a in jrpq.encode(pts))
    jbias = np.asarray(jrpq.point_bias(jcodes, jcid))
    tidx = vamana_index_from_jax(pts, np.asarray(jidx.adjacency), int(jidx.medoid),
                                 entry_points=np.asarray(jidx.entry_points), device="cpu")
    pq, codes_t, cells_t, bias_t = pq_from_jax(jrpq.to_arrays(), jcodes, jcid, jbias, device="cpu")
    assert pq.n_coarse == jrpq.n_coarse
    # the JAX sweep's recall and the port's sweep on the carried state
    with _short_jax_windows():
        jpoints = jbench.sweep_pq(jidx, jrpq, jcodes, q, gt, k=K, widths=widths,
                                  expand_widths=(4,), coarse_ids=jcid)
    tpoints = sweep_pq(tidx, pq, codes_t, q, gt, k=K, widths=widths, expand_widths=(4,),
                       coarse_ids=cells_t, min_seconds=0.01)
    for jp, tp in zip(jpoints, tpoints):
        assert (tp.mode, tp.search_width) == (jp.mode, jp.search_width)
        assert tp.recall == pytest.approx(jp.recall, abs=1e-12), (tp, jp)
    # ids, query by query, as one chunk of the sweep computes them
    qt = torch.as_tensor(q)
    for w in widths:
        jres = jsearch.beam_search_pq(
            jnp.asarray(jcodes), jrpq.inner_tables(q), jidx.adjacency, jidx.medoid,
            search_width=w, k=K, rerank=True, vectors=jidx.vectors, queries=jnp.asarray(q),
            expand_width=4, entry_points=jidx.entry_points, point_cell=jnp.asarray(jcid),
            point_bias=jnp.asarray(jbias), cell_tables=jrpq.cell_tables(q))
        tres = tsearch.beam_search_pq(
            codes_t, pq.inner_tables(qt), tidx.adjacency, tidx.medoid, search_width=w, k=K,
            rerank=True, vectors=tidx.vectors, queries=qt, expand_width=4,
            entry_points=tidx.entry_points, point_cell=cells_t, point_bias=bias_t,
            cell_tables=pq.cell_tables(qt))
        ji, ti = np.asarray(jres.ids), tres.ids.numpy()
        assert all(set(a) == set(b) for a, b in zip(ji, ti)), w


@pytest.fixture(scope="module")
def cosine_builds(runs):
    pts, q, gt = (runs["keep"][key] for key in ("points", "queries", "gt"))
    jcos = jax_build(pts, degree_bound=32, alpha=1.2, seed=0, metric="cosine")
    tcos = build_vamana_knn(pts, degree_bound=32, alpha=1.2, seed=0, metric="cosine",
                            device="cpu")
    return pts, q, gt, jcos, tcos


@pytest.mark.parametrize("width", [10, 16])
def test_native_cosine_build_matches_jax_and_l2_on_normalized(runs, cosine_builds, width):
    pts, q, gt, jcos, tcos = cosine_builds
    assert tcos.metric == "cosine"
    kw = dict(k=K, widths=(width,), expand_widths=(8,), min_seconds=0.01)
    port_cos = sweep_exact(tcos, q, gt, **kw)[0].recall
    port_l2 = sweep_exact(runs["keep"]["index"], q, gt, **kw)[0].recall
    jcos_t = vamana_index_from_jax(pts, np.asarray(jcos.adjacency), int(jcos.medoid),
                                   metric="cosine", entry_points=np.asarray(jcos.entry_points),
                                   device="cpu")
    with _short_jax_windows():
        jax_cos = jbench.sweep_exact(jcos, q, gt, k=K, widths=(width,), expand_widths=(8,))[0].recall
    assert abs(port_cos - jax_cos) <= COSINE_TOL, (port_cos, jax_cos)
    assert abs(port_cos - port_l2) <= COSINE_TOL, (port_cos, port_l2)
    # the port's search on JAX's cosine graph reads JAX's recall
    assert sweep_exact(jcos_t, q, gt, **kw)[0].recall == pytest.approx(jax_cos, abs=1e-12)


@pytest.fixture(scope="module")
def default_build_set():
    """The 6000-point R = 24 set of `test_torch_default_build.py`."""
    pts, _ = make_dataset(6000, 128, 200, seed=42)
    return pts


@pytest.mark.parametrize("which", ["default-6000-R24", "angular-4000-R32"])
def test_points_without_an_in_edge_no_more_than_jax(request, which):
    if which == "default-6000-R24":
        pts = request.getfixturevalue("default_build_set")
        jidx = jax_build(pts, degree_bound=24, alpha=1.2, seed=0)
        tidx = build_vamana_knn(pts, degree_bound=24, alpha=1.2, seed=0, device="cpu")
    else:
        runs = request.getfixturevalue("runs")
        pts, jidx, tidx = runs["keep"]["points"], runs["jax_index"], runs["keep"]["index"]
    jshare = vamana_index_from_jax(pts, np.asarray(jidx.adjacency), int(jidx.medoid),
                                   device="cpu").no_in_edge_share()
    tshare = tidx.no_in_edge_share()
    assert 0.0 <= tshare <= jshare + IN_EDGE_TOL, (which, tshare, jshare)


def test_no_in_edge_share_counts_nodes_no_edge_points_to():
    adj = np.array([[1, 2, -1], [2, -1, -1], [1, -1, -1], [0, 1, -1]], np.int32)
    idx = vamana_index_from_jax(np.zeros((4, 2), np.float32), adj, 0, device="cpu")
    assert idx.no_in_edge_share() == 0.25  # node 3
