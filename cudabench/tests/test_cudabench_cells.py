"""Each cell of BENCHMARK.json run once on the CPU at a tiny size through
the port's plain paths: the whole run (set-up, window, reference,
comparison, result line) as the card runs it."""

import json

import pytest
from conftest import ROOT, TINY, TINY_TRAFFIC

from cudabench import harness

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def _run(cell, traced=False, seed=2**31 + 7):
    return harness.measure(cell, seed, 0.5, traced, device="cpu", overrides=TINY,
                           traffic_overrides=TINY_TRAFFIC)[1]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_cpu(cell):
    line = _run(cell)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    want = {m["name"] for m in harness.cell_metrics(SPEC, cell, per_layer=False)}
    assert set(line["metrics"]) == want
    assert want >= {"recall_at_10", "build_s", "setup_s"}
    assert list(line)[-1] == "checks"
    assert {"dist_rel_err", "recall_at_10", "bad_rows", "join_mismatch", "wrong_path",
            "failed"} <= set(line["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_host_metrics(cell):
    """Without a card the profiler is not run: the device metrics are left
    out, every metric read from the program's own spans and counters is
    there."""
    line = _run(cell, traced=True)
    assert line["correct"] is True
    listed = {m["name"]: m for m in harness.cell_metrics(SPEC, cell, per_layer=True)}
    host = {n for n, m in listed.items() if m["source"] != "device_trace"}
    assert host <= set(line["metrics"])
    assert not set(line["metrics"]) - set(listed)
    assert "breakdown" not in line


def test_every_cell_reports_each_metric_it_is_listed_for():
    for cell in CELLS:
        e2e = {m["name"] for m in harness.cell_metrics(SPEC, cell, per_layer=False)}
        per_layer = harness.cell_metrics(SPEC, cell, per_layer=True)
        assert per_layer, cell
        assert "setup_s" in e2e and len(e2e) >= 2
        for m in per_layer:
            assert m["moves"] in e2e, (cell, m["name"])
