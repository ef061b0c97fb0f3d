"""The launch counters of every kernel wrapper, by kernel id.

Each wrapper adds one to its own counter where it launches its kernel and
nowhere else (`count`); `launch_counts` and `reset_launch_counts` read
and zero all of them, for the scripts that show which kernel a path went
through (`chip_smoke.py`, `tools/fused_scan_micro.py`). The counters are
attributes of the wrapper functions, updated under one lock: the HTTP
server runs the engine in worker threads and the host tier's pipelined
search reranks in a thread of its own, so increments can race.
"""

from __future__ import annotations

import threading

_LOCK = threading.Lock()


def count(wrapper, attr: str = "launches") -> None:
    """Add one launch to `wrapper.<attr>`."""
    with _LOCK:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)


def launch_counts() -> dict[str, int]:
    """{kernel id: launches since the last reset}."""
    from diskrag_tpu_torch.ops import flat_scan as fs
    from diskrag_tpu_torch.ops import mm_probe, pq_scan

    with _LOCK:
        return {
            "B1": fs.scan_bucketed_topk.launches,
            "B4": fs.topk_lanes.launches,
            "B2": fs.scan_bucketed_topk_packed.launches,
            "B3": fs.scan_bucketed_topk_hier.launches,
            "B6": fs.scan_bucketed_topk_hier.launches_pipelined,
            "B5": pq_scan.adc_lookup_gathered_kernel.launches,
            "M1": mm_probe.mm_probe.launches,
        }


def reset_launch_counts() -> None:
    from diskrag_tpu_torch.ops import flat_scan as fs
    from diskrag_tpu_torch.ops import mm_probe, pq_scan

    with _LOCK:
        fs.reset_launch_counts()
        pq_scan.reset_launch_counts()
        mm_probe.reset_launch_counts()
