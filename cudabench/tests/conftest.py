"""The benchmark's own tests: the harness on the CPU at tiny sizes (a test
entry, not a measurement), the reference, the yardstick, and the rules a
later change relies on. Tests marked `cuda` need the card and skip here."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a size the CPU runs in seconds: 3000 points in 30 clusters, 200 pool queries
TINY = {"n": 3000, "n_clusters": 30, "query_pool": 200}
TINY_TRAFFIC = {"warmup_requests": 1}


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _short_span_stretch(monkeypatch):
    """A traced CPU run's span stretch of 4 requests, not the card's 64."""
    from cudabench import harness

    monkeypatch.setattr(harness, "SPAN_REQUESTS", 4)


@pytest.fixture
def card():
    """The CUDA device, decided when the test runs; skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
