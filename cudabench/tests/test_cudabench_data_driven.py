"""A configuration, a traffic mix, a cell and a per-layer metric added as
new files and new BENCHMARK.json entries, and found by name: no file
that is there is edited. Done in a copy of the benchmark's files."""

import hashlib
import json
import shutil

import pytest
import torch
from conftest import ROOT, TINY, TINY_TRAFFIC

from cudabench import datagen, harness


def _copy(tmp_path):
    """A copy of BENCHMARK.json and the benchmark's files; the bytes of
    every file in it."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "cudabench", tmp_path / "cudabench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    return {p.relative_to(tmp_path): p.read_bytes()
            for p in (tmp_path / "cudabench").rglob("*") if p.is_file()}


def _add(tmp_path, cfg, mix, metric_name, metric_src, metric_entry):
    """The configuration, mix and metric as new files, and their entries
    with a cell `tiny.cell` appended to the copy's BENCHMARK.json."""
    (tmp_path / f"cudabench/configs/{cfg['name']}.json").write_text(json.dumps(cfg))
    (tmp_path / f"cudabench/traffic/{mix['name']}.json").write_text(json.dumps(mix))
    (tmp_path / f"cudabench/metrics/{metric_name}.py").write_text(metric_src)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": cfg["name"], "source": "a test",
                            "file": f"cudabench/configs/{cfg['name']}.json", "reduced": ["n"],
                            "why": "a test"})
    spec["workloads"].append({"name": "tiny.cell", "config": cfg["name"],
                              "traffic": mix["name"], "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": metric_name, "better": "lower", "moves": "recall_at_10",
                              "workloads": ["tiny.cell"], **metric_entry})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))


def _unchanged(tmp_path, before):
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data, rel


def _base_config(name, **keys):
    cfg = json.loads((ROOT / "cudabench/configs/sift1m-r48-hbm.json").read_text())
    cfg.update({"name": name, "degree_bound": 24, **TINY, **keys})
    return cfg


def test_new_files_are_found_by_name(tmp_path):
    before = _copy(tmp_path)
    _add(tmp_path, _base_config("tiny-r24"),
         {"name": "closed-b7-l20", "loop": "closed", "batch": 7, "l_search": 20,
          "warmup_requests": 1, "profile_requests": 4, "why": "a test mix"},
         "graph.visited.b7",
         "def read(run):\n"
         "    v = [r['stats']['nodes_visited'] for r in run.answered]\n"
         "    return sum(v) / len(v) if v else None\n",
         {"unit": "nodes/req", "source": "program_counter",
          "layer": "Graph search (graph/search.py)"})

    _, line = harness.measure("tiny.cell", 99, 0.5, True, device="cpu", root=tmp_path)
    assert line["correct"] is True, line["checks"]
    assert line["metrics"]["graph.visited.b7"]["value"] > 0
    assert line["metrics"]["graph.visited.b7"]["unit"] == "nodes/req"
    _unchanged(tmp_path, before)


def test_a_normalized_residual_pq_configuration_is_new_files_only(tmp_path):
    """Unit-normalized rows, ResidualPQ traversal codes at E 4, served
    `pq_accelerated`, and a metric that reads the program's own counters
    (`run.program`) of the traced run."""
    before = _copy(tmp_path)
    _add(tmp_path,
         _base_config("tiny-angular-rpq16", normalize=True, traversal_codes="rpq",
                      pq_subvectors=16, pq_cells=16, expand_width=4,
                      search_type="pq_accelerated", recommended_search_L=96),
         # L 96: at this size the engine's PQ-guided rounds (E 1) reach
         # recall@10 0.95-0.97 at L 64 and 0.996-0.998 at L 96
         {"name": "closed-b7-l96", "loop": "closed", "batch": 7, "l_search": 96,
          "warmup_requests": 1, "profile_requests": 2, "why": "a test mix"},
         "graph.traced_rounds.b7",
         "def read(run):\n"
         "    p = run.program or {}\n"
         "    rounds = (p.get('counters') or {}).get('graph.rounds')\n"
         "    return rounds / len(p['stats']) if rounds else None\n",
         {"unit": "rounds/req", "source": "program_counter",
          "layer": "Graph search (graph/search.py)"})

    run, line = harness.measure("tiny.cell", 2**31 + 99, 0.5, True, device="cpu", root=tmp_path)
    assert line["correct"] is True, line["checks"]
    assert line["checks"]["wrong_path"]["value"] == 0
    assert {r["search_type"] for r in run.answered} == {"pq_accelerated"}
    assert line["metrics"]["graph.traced_rounds.b7"]["value"] > 0
    assert len(run.program["stats"]) == harness.SPAN_REQUESTS
    _unchanged(tmp_path, before)


# make_points of a configuration without `normalize`, as the harness drew
# them before that key existed: sha256 of the points' and queries' bytes
SMALL = {"n": 500, "dim": 16, "n_clusters": 7, "center_sigma": 4.0, "noise_sigma": 1.0,
         "query_pool": 40, "query_noise_sigma": 0.3}
FROZEN = {3: "664697dedf60ba525f1f3025d682d241ce9e681bdea9ff296b413bff6a4fbedf",
          2**31 + 11: "22b1ab0d8d888da512229eaee2a8853fa43b20cb0264f17720c10b21c259c0d2"}


@pytest.mark.parametrize("seed", list(FROZEN))
def test_points_without_normalize_are_the_same_bytes(seed):
    for cfg in (SMALL, {**SMALL, "normalize": False}):
        p, q = datagen.make_points(cfg, seed, torch.device("cpu"))
        assert hashlib.sha256(p.numpy().tobytes() + q.numpy().tobytes()).hexdigest() == \
            FROZEN[seed]


def test_normalized_points_are_the_same_draws_on_the_unit_sphere():
    p0, q0 = datagen.make_points(SMALL, 3, torch.device("cpu"))
    p, q = datagen.make_points({**SMALL, "normalize": True}, 3, torch.device("cpu"))
    assert p.dtype == q.dtype == torch.float32
    for x in (p, q):
        assert float((torch.linalg.vector_norm(x.double(), dim=1) - 1).abs().max()) <= 1e-6
    torch.testing.assert_close(p * torch.linalg.vector_norm(p0, dim=1, keepdim=True), p0)
    torch.testing.assert_close(q * torch.linalg.vector_norm(q0, dim=1, keepdim=True), q0)


@pytest.mark.parametrize("keys, named", [
    ({"metric": "cosine"}, "metric"),
    ({"traversal_codes": "pq"}, "traversal_codes"),
    ({"traversal_codes": "rpq", "pq_cells": 16}, "pq_subvectors"),
    ({"traversal_codes": "rpq", "pq_subvectors": 16}, "pq_cells"),
])
def test_a_configuration_the_harness_cannot_judge_is_refused_before_set_up(
        monkeypatch, keys, named):
    def no_set_up(*a, **kw):
        raise AssertionError("set-up began")

    monkeypatch.setattr(datagen, "make_points", no_set_up)
    with pytest.raises(ValueError, match=named):
        harness.measure("sift1m-exact-b1", 1, 0.5, False, device="cpu",
                        overrides={**TINY, **keys}, traffic_overrides=TINY_TRAFFIC)
