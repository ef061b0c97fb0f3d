"""What the command loads: never JAX, Flax or the JAX package (compared by
whole top-level name: `diskrag_tpu_torch` begins with `diskrag_tpu`);
and the runs that must print no result."""

import json
import shutil
import subprocess
import sys

import pytest
from conftest import ROOT, TINY, TINY_TRAFFIC

LOAD_ALL = r"""
import importlib, pathlib, sys
root = pathlib.Path(sys.argv[1])
sys.path.insert(0, str(root))
import cudabench.run, cudabench.harness
from cudabench import harness
spec = harness.load_spec(root)
for m in spec["end_to_end"] + spec["per_layer"]:
    harness.reader(m["name"], root)
for mod in ("diskrag_tpu_torch.engine", "diskrag_tpu_torch.graph.knn_build",
            "diskrag_tpu_torch.index.persist", "diskrag_tpu_torch.index.host_tier",
            "diskrag_tpu_torch.kernels.launches", "diskrag_tpu_torch.kernels._build",
            "diskrag_tpu_torch.native", "diskrag_tpu_torch.pq.intq",
            "diskrag_tpu_torch.data.collection", "pandas", "pyarrow"):
    importlib.import_module(mod)
print(sorted({m.split(".")[0] for m in sys.modules}))
"""


def test_nothing_the_command_runs_loads_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", LOAD_ALL, str(ROOT)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    top = set(json.loads(out.strip().splitlines()[-1].replace("'", '"')))
    assert "diskrag_tpu_torch" in top and "cudabench" in top
    assert not top & {"jax", "jaxlib", "flax", "diskrag_tpu"}


FAKE_JAX = r"""
import pathlib, sys, types
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(2)
sys.modules["jax"] = types.ModuleType("jax")
from cudabench import harness
_, line = harness.measure("sift1m-exact-b1", 1, 0.3, False, device="cpu",
                         overrides=%r, traffic_overrides=%r)
print("RESULT", line)
""" % (TINY, TINY_TRAFFIC)

# jax loaded only once the window has closed, in the traced run's span stretch
JAX_AFTER_THE_WINDOW = r"""
import pathlib, sys, types
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(2)
from cudabench import harness, program_spans
harness.SPAN_REQUESTS = 2
stretch = program_spans.span_stretch

def loads_jax(*a, **kw):
    sys.modules["jax"] = types.ModuleType("jax")
    return stretch(*a, **kw)

program_spans.span_stretch = loads_jax
_, line = harness.measure("sift1m-exact-b1", 1, 0.3, True, device="cpu",
                         overrides=%r, traffic_overrides=%r)
print("RESULT", line)
""" % (TINY, TINY_TRAFFIC)


@pytest.mark.parametrize("script", [FAKE_JAX, JAX_AFTER_THE_WINDOW],
                         ids=["before-the-window", "in-the-span-stretch"])
def test_a_run_that_loaded_jax_exits_without_a_result(script):
    p = subprocess.run([sys.executable, "-c", script, str(ROOT)], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 3
    assert "RESULT" not in p.stdout and '"workload"' not in p.stdout
    assert "jax" in p.stderr


def test_without_a_card_the_command_exits_without_a_result():
    p = subprocess.run([sys.executable, "cudabench/run.py", "--workload", "sift1m-exact-b512",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_beside_only_its_own_files_the_command_exits_without_a_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "cudabench", tmp_path / "cudabench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    p = subprocess.run([sys.executable, "cudabench/run.py", "--workload", "sift1m-exact-b1",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
