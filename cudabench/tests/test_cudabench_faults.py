"""The whole of a run (no look for a card) with the timed path broken
underneath: each fault a serving cell can have must make `correct`
false. The faults are planted in the program's classes for the length of
one run."""

import numpy as np
import pytest
from conftest import TINY, TINY_TRAFFIC

from cudabench import harness


def _alter_id(dists, ids, stats):
    ids = ids.copy()
    ids[0, 0] = (ids[0, 0] + 1) % TINY["n"]
    return dists, ids, stats


def _alter_distance(dists, ids, stats):
    dists = dists.copy()
    dists[-1, -1] *= 1.01
    return dists, ids, stats


def _drop_half(dists, ids, stats):
    ids = ids.copy()
    ids[ids.shape[0] // 2:] = -1
    return dists, ids, stats


FAULTS = {"an id altered": _alter_id, "a distance altered": _alter_distance,
          "half of the batch left out": _drop_half}


@pytest.mark.parametrize("cell", ["sift1m-exact-b512", "sift1m-hosttier-b512", "sift1m-exact-b1"])
@pytest.mark.parametrize("fault", list(FAULTS) + ["a text altered in the join"])
def test_a_fault_in_the_timed_path_is_not_correct(monkeypatch, cell, fault):
    from diskrag_tpu_torch.data.collection import CollectionManager
    from diskrag_tpu_torch.engine import SearchEngine

    if fault in FAULTS:
        finish = SearchEngine._finish_search
        monkeypatch.setattr(SearchEngine, "_finish_search",
                            lambda self, *a, **kw: FAULTS[fault](*finish(self, *a, **kw)))
    else:
        lookup = CollectionManager.get_texts_by_indices

        def altered(self, name, indices):
            out = lookup(self, name, indices)
            text, meta = out[0]
            out[0] = (text[::-1] + "x", meta)
            return out

        monkeypatch.setattr(CollectionManager, "get_texts_by_indices", altered)
    _, line = harness.measure(cell, 17, 0.5, False, device="cpu", overrides=TINY,
                              traffic_overrides=TINY_TRAFFIC)
    assert line["correct"] is False
    failing = {k for k, c in line["checks"].items()
               if not (c["value"] <= c["limit"] if k != "recall_at_10" else c["value"] >= c["limit"])}
    assert failing, line["checks"]
    assert np.isfinite(line["checks"]["dist_rel_err"]["value"])
