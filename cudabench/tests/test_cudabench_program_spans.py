"""The readers of the program's spans (`cudabench/program_spans.py`) on
synthetic span records and profiler rows, and the span stretch over a
stand-in for the engine."""

import pytest
from conftest import ROOT  # noqa: F401  (puts the checkout on the path)

from cudabench import program_spans as ps
from diskrag_tpu_torch.utils.profiling import SpanRecord

MS = 1_000_000  # ns


def _rec(name, id_, parent, start_ms, end_ms, request=1, thread=1, **attrs):
    return SpanRecord(name, id_, parent, request, thread, int(start_ms * MS), int(end_ms * MS),
                      attrs)


def _rounds_program():
    """Two requests; three rounds (2 executed in the first request, its
    last iteration stopping at its sync; 1 in the second)."""
    recs = [
        _rec("graph.round.sync", 3, 2, 1.0, 1.5), _rec("graph.round", 2, 1, 0.0, 2.0),
        _rec("graph.round.sync", 5, 4, 2.5, 2.6), _rec("graph.round", 4, 1, 2.0, 3.0),
        _rec("graph.round.sync", 7, 6, 3.0, 3.2), _rec("graph.round", 6, 1, 3.0, 3.3),
        _rec("engine.request", 1, None, 0.0, 4.0),
        _rec("graph.round.sync", 12, 11, 10.0, 10.4, request=2),
        _rec("graph.round", 11, 10, 10.0, 11.0, request=2),
        _rec("engine.request", 10, None, 10.0, 12.0, request=2),
    ]
    return {"records": recs, "counters": {"graph.rounds": 3, "graph.iterations": 4},
            "stats": [{"search_time": 0.0035, "fetch_time": 0.0005},
                      {"search_time": 0.0015, "fetch_time": 0.0005}]}


def test_dispatch_is_the_round_less_its_sync():
    prog = _rounds_program()
    # rounds 2.0 + 1.0 + 0.3 + 1.0 ms, syncs 0.5 + 0.1 + 0.2 + 0.4, over 3 executed rounds
    assert ps.dispatch_ms(prog) == pytest.approx((4.3 - 1.2) / 3)
    assert ps.sync_wait_ms(prog) == pytest.approx(1.2 / 3)
    assert ps.round_cover(prog) == (pytest.approx(1.0), pytest.approx(3.3 / 3.0))


def test_join_self_time_leaves_out_only_the_collections_inside_the_join():
    recs = [
        _rec("gc", 9, 2, 1.0, 1.5, generation=2),    # inside the first join
        _rec("gc", 8, 3, 3.5, 4.5, generation=0),    # half inside it
        _rec("gc", 7, 1, 6.0, 7.0, generation=2),    # outside every join
        _rec("engine.join", 2, 1, 0.0, 4.0), _rec("engine.request", 1, None, 0.0, 8.0),
        _rec("engine.join", 12, 11, 20.0, 22.0, request=2),
        _rec("engine.request", 11, None, 20.0, 23.0, request=2),
    ]
    # (4 - 0.5 - 0.5) + 2 over two requests
    assert ps.join_self_ms({"records": recs, "counters": {}}) == pytest.approx(2.5)


def test_host_tier_readers_are_means_a_request():
    recs = [_rec("host_tier.rerank.gather", 3, 2, 0.0, 4.0, thread=2),
            _rec("host_tier.rerank.gather", 5, 4, 5.0, 7.0, thread=2),
            _rec("host_tier.rerank_wait", 6, 1, 6.0, 9.0),
            _rec("engine.request", 1, None, 0.0, 10.0),
            _rec("engine.request", 11, None, 20.0, 21.0, request=2)]
    prog = {"records": recs, "counters": {}}
    assert ps.rerank_gather_ms(prog) == pytest.approx(3.0)
    assert ps.rerank_exposed_ms(prog) == pytest.approx(1.5)
    assert ps.collection_update_s({"setup": [_rec("collection.update", 1, None, 0, 2500)]}) == \
        pytest.approx(2.5)


def test_launches_are_counted_only_inside_rounds():
    host = [("diskrag.graph.round", 0.0, 10.0), ("diskrag.graph.round.select", 1.0, 4.0),
            ("cudaLaunchKernel", 2.0, 2.1), ("cudaLaunchKernel", 5.0, 5.1),
            ("cuLaunchKernelEx", 9.9, 10.5),
            ("diskrag.graph.round", 20.0, 30.0), ("cudaLaunchKernel", 21.0, 21.1),
            ("cudaLaunchKernel", 15.0, 15.1),          # between the rounds
            ("cudaMemcpyAsync", 22.0, 22.1), ("aten::empty", 23.0, 23.1)]
    assert ps.launches_per_round(host) == pytest.approx(4 / 2)
    assert ps.launches_per_round([("cudaLaunchKernel", 1.0, 2.0)]) is None


def test_gaps_are_named_by_the_innermost_program_span():
    host = [("cudabench.request", 0.0, 100.0),
            ("diskrag.engine.request", 0.0, 100.0), ("diskrag.engine.dispatch", 0.0, 60.0),
            ("diskrag.graph.round", 0.0, 30.0), ("diskrag.graph.round.sync", 10.0, 30.0),
            ("aten::item", 12.0, 28.0), ("diskrag.engine.join", 60.0, 90.0)]
    dev = [("k1", 0.0, 10.0), ("k2", 30.0, 60.0), ("k3", 90.0, 92.0)]
    gaps = dict(ps.idle_gaps_by_span(dev, host))
    # idle 10..30 (the sync), 60..90 (the join), 92..100 (the request alone)
    assert gaps == {"graph.round.sync": pytest.approx(20e-6), "engine.join": pytest.approx(30e-6),
                    "engine.request": pytest.approx(8e-6)}
    assert ps.idle_gaps_by_span(dev, [("aten::item", 0.0, 1.0)]) is None


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    monkeypatch.setattr(ps, "recorder", lambda: None)
    assert ps.span_stretch(None, None, 0, 4) is None
    assert ps.profiled_span_stretch(None, None, 0, 4) is None
    assert all(fn({}) is None for fn in ps.READERS.values())
    assert all(fn(None) is None for fn in ps.READERS.values())


def test_span_stretch_records_only_its_traced_sends():
    from diskrag_tpu_torch.utils import profiling

    class Stream:
        def texts(self, i):
            return [f"q{i}"]

    seen = []

    def call(texts):
        seen.append((texts[0], profiling.enabled()))
        with profiling.request("engine.request", batch=1):
            with profiling.span("graph.round", step=0):
                with profiling.span("graph.round.sync"):
                    profiling.count("graph.rounds")
        return {"stats": {"search_time": 0.001, "fetch_time": 0.0}}

    out = ps.span_stretch(call, Stream(), 10, 3)
    assert seen == [("q10", False), ("q10", True), ("q11", True), ("q11", False),
                    ("q12", False), ("q12", True)]
    assert out["counters"] == {"graph.rounds": 3} and out["summary"]["engine.request"]["count"] == 3
    assert len(out["stats"]) == 3 and out["overhead"] > 0 and not profiling.enabled()
    assert ps.dispatch_ms(out) is not None and ps.sync_wait_ms(out) is not None
    cost = ps.span_cost_ns(reps=1000)
    assert cost["on"] > cost["off"] > 0 and not profiling.enabled() and profiling.drain() == []


def test_both_stretches_over_a_tiny_host_tier_cell(tmp_path):
    """The host-tier cell's program at the CPU size, pipelined in chunks:
    the span stretch reads every metric of the cell but the device's, and
    the profiled span stretch (host only here) names its rounds."""
    import json

    import numpy as np
    import torch
    from conftest import TINY

    from cudabench import datagen, harness, traffic

    spec = harness.load_spec()
    cell = harness.find(spec["workloads"], "sift1m-hosttier-b512", "workload")
    entry = harness.find(spec["configs"], cell["config"], "config")
    cfg = {**json.loads((ROOT / entry["file"]).read_text()), **TINY}
    mix = {**traffic.load(ROOT / "cudabench" / "traffic" / f"{cell['traffic']}.json"),
           "batch": 48}
    dev = torch.device("cpu")
    pts, queries = (t.numpy() for t in datagen.make_points(cfg, 5, dev))
    texts = datagen.make_texts(cfg, 5)
    run = harness.Run(cell, cfg, mix)
    engine = harness._program(cfg, pts, texts, tmp_path, dev, run, harness.Spans())
    engine.host_tier_pipeline_chunk = 16  # 48 queries in two chunks of 24
    lut = {f"q{j}": queries[j] for j in range(queries.shape[0])}

    def call(qtexts):
        return engine.search_many(qtexts, k=10, embedding_fn=lut.__getitem__, l_search=32)

    stream = traffic.RequestStream(mix, queries.shape[0], 5)
    prog = ps.span_stretch(call, stream, 0, 4)
    assert prog["dropped"] == 0 and prog["counters"]["graph.rounds"] > 0
    for name in ("graph.dispatch_ms", "graph.sync_wait_ms", "engine.join_self_ms",
                 "host_tier.rerank_exposed_ms", "host_tier.rerank_gather_ms"):
        assert ps.READERS[name](prog) > 0, name
    lo, hi = ps.round_cover(prog)
    assert 0 < lo <= hi <= 1
    prog["profiled"] = ps.profiled_span_stretch(call, stream, 8, 2)
    assert np.isfinite(ps.READERS["graph.launches_per_round"](prog))
    # no device events on the CPU: one gap, the whole stretch, never complete
    assert not prog["profiled"]["complete"] and len(prog["profiled"]["idle_gaps_by_span"]) == 1
