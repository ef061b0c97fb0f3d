"""Engine concurrency microbenchmark (counterpart of
`diskrag_tpu/tools/perf_test.py`): sequential vs
ThreadPoolExecutor-concurrent one-query-at-a-time throughput against a
SearchEngine, plus the batched path.

The concurrent leg calls `search_batch` from worker threads. PyTorch's
current CUDA device and stream are per thread; the engine's tensors carry
their device and every kernel wrapper launches on
`torch.cuda.current_stream(<the tensors' device>)`, so a worker thread
launches on the engine's device whatever its own current device is. All
threads share the default stream, so their launches serialize on the card;
the kernel launch counters are not locked and can lose counts here.
"""

from __future__ import annotations

import concurrent.futures
import time

import numpy as np


def performance_test_search_engine(
    engine,
    query_vectors: np.ndarray,
    *,
    k: int = 5,
    n_threads: int = 8,
) -> dict:
    nq = len(query_vectors)

    # sequential one-at-a-time
    t0 = time.perf_counter()
    for qv in query_vectors:
        engine.search_batch(qv[None, :], k=k)
    seq_s = time.perf_counter() - t0

    # thread-concurrent one-at-a-time; list() reads every future's result,
    # so a worker's exception is raised here
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=n_threads) as ex:
        list(ex.map(lambda qv: engine.search_batch(qv[None, :], k=k), query_vectors))
    conc_s = time.perf_counter() - t0

    # one device batch
    t0 = time.perf_counter()
    engine.search_batch(query_vectors, k=k)
    batch_s = time.perf_counter() - t0

    return {
        "n_queries": nq,
        "sequential_qps": nq / seq_s,
        "concurrent_qps": nq / conc_s,
        "batched_qps": nq / batch_s,
        "n_threads": n_threads,
        "batch_speedup_vs_sequential": seq_s / batch_s,
        "device": str(engine.device),
    }
