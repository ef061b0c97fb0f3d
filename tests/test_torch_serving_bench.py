"""`diskrag_tpu_torch/tools/serving_bench.py` on the CPU: `measure_serving`
in all four modes reports the keys the JAX script's function reports
(that function run on the port's engine), and every search it timed
returned the ids of the engine's own `search_many` in that mode."""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # the suite runs several workers: do not let each spin a thread per core

from diskrag_tpu_torch.benchmark import make_dataset
from diskrag_tpu_torch.build_index import build_index_from_vectors
from diskrag_tpu_torch.engine import SearchEngine
from diskrag_tpu_torch.graph.knn_build import build_vamana_knn
from diskrag_tpu_torch.index.persist import save_index
from diskrag_tpu_torch.pq.intq import IntQuantizer
from diskrag_tpu_torch.tools import serving_bench as sb

REPO = pathlib.Path(__file__).resolve().parent.parent
MODES = ("flat", "vamana", "streaming", "host_tier")
BATCH = 64


def _jax_serving_bench():
    """The JAX script's module, loaded from its file (`benchmarks/` is not
    a package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_serving_bench", REPO / "benchmarks" / "serving_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ids(results) -> np.ndarray:
    return np.array([[item["metadata"]["i"] for item in row] for row in results])


@pytest.fixture(scope="module")
def data():
    pts, q = make_dataset(2000, 32, BATCH, seed=31)
    index = build_vamana_knn(pts, degree_bound=16, alpha=1.2, seed=0, device="cpu")
    return pts, q, index


def _reference_ids(base, pts, q, index) -> dict:
    """Each mode's `search_many` ids on engines set up as the protocol sets
    them up, in its order (host_tier last: it rewrites the meta)."""
    index_dir = sb.make_collection(base, pts).get_index_dir("bench")
    texts = [f"q{i}" for i in range(BATCH)]
    lut = {t: q[i] for i, t in enumerate(texts)}

    def ids(mode, l_search=None):
        eng = SearchEngine("bench", base_dir=str(base), run_diagnostics=False,
                           serving_mode=mode, device="cpu")
        return _ids(eng.search_many(texts, k=10, embedding_fn=lut.__getitem__,
                                    l_search=l_search)["results"])

    build_index_from_vectors(pts, index_dir, index_type="flat", force_rebuild=True, device="cpu")
    out = {"flat": ids("auto")}
    save_index(index_dir, index, host_vectors=pts)
    out["vamana"] = ids("auto", 16)
    out["streaming"] = ids("streaming", 16)
    iq8 = IntQuantizer(bits=8, device="cpu").fit(pts, seed=0)
    save_index(index_dir, index, pq=iq8, pq_codes=iq8.encode(pts),
               meta_extra={"recommended_search_L": 24, "recommended_expand_width": 8},
               write_compat=True, host_vectors=pts)
    out["host_tier"] = ids("host_tier")
    return out


def test_measure_serving_keys_and_ids(data, tmp_path, monkeypatch):
    pts, q, index = data
    seen: dict = {m: [] for m in ("auto", "streaming", "host_tier")}
    search_many, search_pipelined = SearchEngine.search_many, SearchEngine.search_pipelined

    def spy_many(self, *a, **kw):
        out = search_many(self, *a, **kw)
        seen[self.serving_mode].append((self.flat is not None, _ids(out["results"])))
        return out

    def spy_pipelined(self, *a, **kw):
        outs = search_pipelined(self, *a, **kw)
        seen[self.serving_mode] += [(self.flat is not None, _ids(o["results"])) for o in outs]
        return outs

    monkeypatch.setattr(SearchEngine, "search_many", spy_many)
    monkeypatch.setattr(SearchEngine, "search_pipelined", spy_pipelined)
    monkeypatch.setattr(sb, "measure_pipelined_qps",
                        functools.partial(sb.measure_pipelined_qps, n_batches=2))
    kw = dict(index=index, batches=(BATCH,), k=10, repeats=2, http=False, modes=MODES)
    got = sb.measure_serving(pts, q, tmp_dir=str(tmp_path / "port"), device="cpu", **kw)
    monkeypatch.undo()

    # the JAX script's function, on the port's engine, builds and quantizer
    import diskrag_tpu.build_index
    import diskrag_tpu.engine
    import diskrag_tpu.index.persist
    import diskrag_tpu.pq.intq

    jsb = _jax_serving_bench()
    monkeypatch.setattr(diskrag_tpu.build_index, "build_index_from_vectors",
                        functools.partial(build_index_from_vectors, device="cpu"))
    monkeypatch.setattr(diskrag_tpu.engine, "SearchEngine",
                        functools.partial(SearchEngine, device="cpu"))
    monkeypatch.setattr(diskrag_tpu.index.persist, "save_index", save_index)
    monkeypatch.setattr(diskrag_tpu.pq.intq, "IntQuantizer",
                        functools.partial(IntQuantizer, device="cpu"))
    monkeypatch.setattr(jsb, "measure_pipelined_qps",
                        functools.partial(jsb.measure_pipelined_qps, n_batches=2))
    want = jsb.measure_serving(pts, q, tmp_dir=str(tmp_path / "jax"), **kw)

    assert list(got) == list(want) == ["flat", "flat_pipelined", "vamana", "streaming",
                                       "host_tier", "host_tier_prep_seconds"]
    for mode in ("flat", "flat_pipelined", *MODES[1:]):
        (g,), (w,) = got[mode], want[mode]
        assert list(g) == list(w), mode
        assert g["batch"] == BATCH and g["qps"] > 0
        if mode != "flat_pipelined":
            assert g["search_type"] == w["search_type"]
            # the JAX tunnel's `fetch_rpc` has no counterpart: the port
            # reports its engine's own wait-and-decode as `fetch`
            assert set(g["stage_ms"]) == set(w["stage_ms"]) - {"fetch_rpc"} | {"fetch"}
    assert got["flat_pipelined"][0]["n_batches"] == 2
    assert got["host_tier"][0]["stage_ms"]["tier"]

    ref = _reference_ids(tmp_path / "ref", pts, q, index)
    by_mode = {"flat": [i for flat, i in seen["auto"] if flat],
               "vamana": [i for flat, i in seen["auto"] if not flat],
               "streaming": [i for _, i in seen["streaming"]],
               "host_tier": [i for _, i in seen["host_tier"]]}
    # search_many: a warm-up and 2 timed calls a mode; flat also 3 x 2 pipelined batches
    assert [len(v) for v in by_mode.values()] == [3 + 6, 3, 3, 3]
    for mode, calls in by_mode.items():
        for ids in calls:
            np.testing.assert_array_equal(ids, ref[mode], err_msg=mode)
