"""A configuration, a traffic mix, a cell and a per-layer metric added as
new files and new BENCHMARK.json entries, and found by name: no file
that is there is edited. Done in a copy of the benchmark's files."""

import json
import shutil

from conftest import ROOT, TINY

from cudabench import harness


def test_new_files_are_found_by_name(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "cudabench", tmp_path / "cudabench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "cudabench").rglob("*") if p.is_file()}

    cfg = json.loads((tmp_path / "cudabench/configs/sift1m-r48-hbm.json").read_text())
    cfg.update({"name": "tiny-r24", "degree_bound": 24, **TINY})
    (tmp_path / "cudabench/configs/tiny-r24.json").write_text(json.dumps(cfg))
    (tmp_path / "cudabench/traffic/closed-b7-l20.json").write_text(json.dumps({
        "loop": "closed", "batch": 7, "l_search": 20,
        "warmup_requests": 1, "profile_requests": 4, "why": "a test mix"}))
    (tmp_path / "cudabench/metrics/graph.visited.b7.py").write_text(
        "def read(run):\n"
        "    v = [r['stats']['nodes_visited'] for r in run.answered]\n"
        "    return sum(v) / len(v) if v else None\n")

    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-r24", "source": "a test",
                            "file": "cudabench/configs/tiny-r24.json", "reduced": ["n"],
                            "why": "a test"})
    spec["workloads"].append({"name": "tiny.b7", "config": "tiny-r24",
                              "traffic": "closed-b7-l20", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "graph.visited.b7", "unit": "nodes/req",
                              "better": "lower", "source": "program_counter",
                              "layer": "Graph search (graph/search.py)", "moves": "qps",
                              "workloads": ["tiny.b7"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    line = harness.run_cell("tiny.b7", 99, 0.5, True, device="cpu", root=tmp_path)
    assert line["correct"] is True, line["checks"]
    assert line["metrics"]["graph.visited.b7"]["value"] > 0
    assert line["metrics"]["graph.visited.b7"]["unit"] == "nodes/req"
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data, rel
