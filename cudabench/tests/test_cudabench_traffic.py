"""The general generator: the request stream and both loop kinds."""

import time

import numpy as np

from cudabench import traffic

OPEN = {"loop": "open", "rate": 200.0, "burst_every_s": 0.1, "burst_size": 5,
        "concurrency": 2, "batch": 3, "l_search": 8, "warmup_requests": 0,
        "profile_requests": 1}


def test_stream_is_the_seeded_pool_order_cycled():
    s = traffic.RequestStream({"batch": 4}, 10, seed=5)
    assert sorted(np.concatenate([s.pool_ids(i) for i in range(5)]).tolist()) == sorted(
        list(range(10)) * 2)
    assert s.texts(1) == [f"q{j}" for j in s.pool_ids(1)]
    assert traffic.RequestStream({"batch": 4}, 10, seed=5).pool_ids(3).tolist() == \
        s.pool_ids(3).tolist()


def test_open_loop_arrivals_change_order_not_load_with_the_seed():
    a, b = traffic.due_times(OPEN, 2.0, 1), traffic.due_times(OPEN, 2.0, 2)
    assert a.size == b.size and not np.array_equal(a, b)
    assert np.all(np.diff(a) >= 0) and a[-1] < 2.0
    assert np.sum(np.isin(np.round(np.arange(0.1, 2.0, 0.1), 9), np.round(a, 9))) >= 18


def _fake(seconds_each):
    def call(texts):
        time.sleep(seconds_each)
        return {"n": len(texts)}
    return call


def test_closed_loop_sends_one_after_another():
    stream = traffic.RequestStream({"batch": 3}, 50, seed=1)
    seen = []
    recs, window = traffic.drive(_fake(0.01), stream, {"loop": "closed"}, 0.2, 7, 1,
                                 lambda r, out: seen.append((r["i"], out["n"])))
    assert [r["i"] for r in recs] == list(range(7, 7 + len(recs)))
    assert seen == [(r["i"], 3) for r in recs]
    assert all(a["t_end"] <= b["t_start"] for a, b in zip(recs, recs[1:]))
    assert window >= 0.2 and 10 <= len(recs) <= 21


def test_open_loop_times_requests_from_when_they_fell_due():
    stream = traffic.RequestStream({"batch": 3}, 50, seed=1)
    seen = []
    recs, window = traffic.drive(_fake(0.02), stream, OPEN, 0.3, 0, 4,
                                 lambda r, out: seen.append(r["i"]))
    assert len(recs) == traffic.due_times(OPEN, 0.3, 4).size
    assert seen == sorted(seen)
    for r in recs:
        assert r["latency_s"] >= r["t_end"] - r["t_start"] >= 0.02
        assert r["lateness_s"] >= 0
    # 2 callers of 20 ms requests cannot keep up with ~300 a second: a queue grows
    assert max(r["lateness_s"] for r in recs) > 0.05
