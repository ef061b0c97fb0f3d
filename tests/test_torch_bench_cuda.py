"""`bench_cuda.py`, the port's bench, end to end on the CPU at a pipeline
smoke's size (`--device cpu`, every stage through the kernels' plain
versions) in a subprocess: one JSON line, the headline group last with
`metric` leading it, within the 1800-character head, and no module of the
JAX package or of `benchmarks/` loaded."""

import json
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

# runs the script as `python3 bench_cuda.py --device cpu` would, then
# reports on stderr the modules the run loaded that it must not
_RUN = """
import json, runpy, sys
sys.argv = ["bench_cuda.py", "--device", "cpu"]
code = 0
try:
    runpy.run_path("bench_cuda.py", run_name="__main__")
except SystemExit as e:
    code = e.code or 0
bad = sorted(m for m in sys.modules
             if m in ("jax", "diskrag_tpu", "benchmarks", "bench")
             or m.startswith(("jax.", "jaxlib", "diskrag_tpu.", "benchmarks.")))
print("CHECK " + json.dumps({"code": code, "bad": bad}), file=sys.stderr)
"""


def _record_stamp():
    path = REPO / "chiprun_out" / "last_bench_cuda.json"
    return path.stat().st_mtime_ns if path.exists() else None


def test_bench_cuda_cpu_smoke(tmp_path):
    stamp = _record_stamp()
    env = {**os.environ, "BENCH_N": "2000", "BENCH_QUERIES": "64", "BENCH_1M_N": "4000",
           "BENCH_HT_DIR": str(tmp_path / "ht"),
           "TMPDIR": str(tmp_path), "OMP_NUM_THREADS": "2"}
    proc = subprocess.run([sys.executable, "-c", _RUN], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)
    check = [ln for ln in proc.stderr.splitlines() if ln.startswith("CHECK ")]
    assert check, proc.stderr[-3000:]
    report = json.loads(check[-1][len("CHECK "):])
    assert report == {"code": 0, "bad": []}, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    line = lines[0]
    rec = json.loads(line)
    keys = list(rec)
    head = keys[keys.index("metric"):]
    assert head[:6] == ["metric", "value", "unit", "recall", "search_width", "mode"]
    assert head[-1] == "bench_wall_seconds"
    assert {"sweep", "sweep_1m", "serving", "stage_wall_seconds"} <= set(keys[:keys.index("metric")])
    assert len(line) - line.index('"metric"') <= 1800
    assert rec["metric"] == "qps_per_chip_at_recall10>=0.95_sift-like-2k"
    assert rec["device"] == "cpu" and rec["vs_baseline"] is None
    assert rec["kernel_build_seconds"] is None
    assert not any(k.endswith("error") for k in rec) and "budget_skipped" not in rec
    # every stage ran: the big-batch point, the 1M (here 4000-point) stage,
    # the host tier at L 32 / 48 and the four serving modes
    assert "flat-packed-b2048" in {p["mode"] for p in rec["sweep"]}
    assert {"qps_at_recall0.95", "recall", "mode", "build_seconds_cold"} <= set(rec["1m"])
    assert [p["L"] for p in rec["host_tier"]["points"]] == [32, 48]
    assert set(rec["serving_qps_b512"]) == {"flat", "flat_pipelined", "vamana", "streaming",
                                             "host_tier"}
    assert set(rec["launches"]) == {"B1", "B2", "B3", "B4", "B5", "B6", "M1", "G1", "G2"}
    assert not any(rec["launches"].values())  # the CPU runs the plain versions
    assert rec["recall"] >= 0.95 and rec["value"] > 0
    # a smoke-scale run leaves the full-protocol record alone
    assert _record_stamp() == stamp
