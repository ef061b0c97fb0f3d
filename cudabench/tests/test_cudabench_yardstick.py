"""The copied bound arithmetic and the readers that turn runs into metrics."""

import importlib.util
import inspect

import pytest
from conftest import ROOT

from cudabench import readers, roofline, trace
from cudabench.harness import GcWatch, Run


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_bounds", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the kernel table's shapes: serving, 200k build, streaming merge, 1M and 1.2M builds
B1_SHAPES = [(1000, 1_000_000, 128, 512), (4096, 200_000, 128, 4096), (4096, 393_216, 128, 4096),
             (4096, 1_000_000, 128, 4096), (576, 1_000_000, 128, 4096), (4096, 1_200_000, 128, 4096)]
B4_SHAPES = [(1000, 512, 40), (4096, 4096, 260), (576, 4096, 260)]


def test_bounds_equal_chip_smokes():
    cs = _chip_smoke()
    for shape in B1_SHAPES:
        assert roofline.b1_bound_ms(*shape) == cs.b1_bound_ms(*shape)
    for shape in B4_SHAPES:
        assert roofline.b4_bound_ms(*shape) == cs.b4_bound_ms(*shape)
    assert (roofline.PEAK_INT8_OPS, roofline.PEAK_BYTES) == (cs.PEAK_INT8_OPS, cs.PEAK_BYTES)


def test_knn_pass_shapes_follow_the_build():
    from diskrag_tpu_torch.graph import knn_build

    assert knn_build._KNN_BUCKETS == roofline.KNN_BUCKETS
    params = inspect.signature(knn_build.build_vamana_knn).parameters
    assert params["query_block"].default == roofline.KNN_QUERY_BLOCK
    rows, knn_k, kk = roofline.knn_params(1_000_000, 48)
    assert (len(rows), rows[0], rows[-1], knn_k, kk) == (245, 4096, 576, 64, 260)


def _run(**kw):
    run = Run({"name": "x"}, {"n": 1_000_000, "dim": 128, "degree_bound": 48}, {})
    for key, v in kw.items():
        setattr(run, key, v)
    return run


def _knn(launches, us, events):
    return _run(knn_profile={"launches": {"B1": launches},
                             "kernels": {"B1": {"us": us, "events": events}}})


def test_roofline_share_scales_for_dropped_events_and_refuses_what_it_cannot_read():
    rows, _, _ = roofline.knn_params(1_000_000, 48)
    bound = sum(roofline.b1_bound_ms(b, 1_000_000, 128, roofline.KNN_BUCKETS)[0] for b in rows)
    assert readers.roofline_share(_knn(245, bound * 5e3, 245), "B1") == pytest.approx(20.0)
    # 200 of 245 events recorded: their mean stands for all 245
    assert readers.roofline_share(_knn(245, bound * 5e3 * 200 / 245, 200), "B1") == \
        pytest.approx(20.0)
    assert readers.roofline_share(_knn(245, 1.0, 100), "B1") is None
    assert readers.roofline_share(_knn(246, 1.0, 246), "B1") is None
    assert readers.roofline_share(_run(), "B1") is None


def test_stretch_busy_idle_and_gap_names():
    host = [("cudabench.request", 0.0, 100.0), ("cudabench.search_batch", 0.0, 60.0),
            ("aten::item", 10.0, 30.0), ("cudaLaunchKernel", 40.0, 41.0),
            ("cudabench.join", 60.0, 100.0)]
    dev = [("k1", 5.0, 10.0), ("k2", 41.0, 50.0), ("k1", 45.0, 55.0), ("Memcpy DtoH", 150.0, 160.0)]
    st = trace.stretch(dev, host)
    assert st["window_s"] == pytest.approx(100e-6)
    assert st["busy_s"] == pytest.approx(19e-6)
    assert st["device_ops"][0] == ["k1", pytest.approx(15e-6)]
    gaps = dict(st["idle_gaps"])
    # idle 0..5 (no host op), 10..41 (aten::item covers the middle), 55..100
    assert gaps == {"search_batch": pytest.approx(5e-6),
                    "search_batch:aten::item": pytest.approx(31e-6),
                    "join": pytest.approx(45e-6)}
    assert (st["kernels"], st["launch_calls"]) == (2 + 1, 1)
    assert trace.complete(st)
    assert readers.idle_pct(_run(stretch=st)) == pytest.approx(81.0)
    assert trace.stretch(dev, [("aten::item", 0.0, 1.0)]) is None


def test_request_readers():
    reqs = [{"error": None, "qidx": [0] * 4, "latency_s": 0.1 * (i + 1),
             "timing": {"total_time": 0.1, "search_time": 0.06, "embedding_time": 0.01},
             "stats": {"search_time": 0.06, "fetch_time": 0.01, "rounds": 10,
                       "stage_ms": {"traverse": 5.0}}} for i in range(20)]
    reqs.append({"error": "boom", "qidx": [0] * 4, "latency_s": 3.0})
    run = _run(requests=reqs, window_s=2.0)
    assert readers.qps(run) == pytest.approx(80 / 2.0)
    assert readers.p95_ms(run) == pytest.approx(2000.0)  # the failed request counts
    assert readers.join_ms(run) == pytest.approx(30.0)
    assert readers.round_ms(run) == pytest.approx(5.0)
    assert readers.rounds(run) == pytest.approx(10.0)
    assert readers.stage_ms(run, "traverse") == pytest.approx(5.0)
    assert readers.stage_ms(run, "gather_rerank_select") is None
    assert readers.gc_share(run) is None
    run.gc = GcWatch()
    run.gc.seconds = [0.1, 0.2, 0.7]
    assert readers.gc_share(run) == pytest.approx(50.0)
