"""The launch counters of every kernel wrapper, by kernel id.

Each wrapper adds one to its own counter where it launches its kernel and
nowhere else; these two functions read and zero all of them, for the
scripts that show which kernel a path went through (`chip_smoke.py`,
`tools/fused_scan_micro.py`). The counters are bare `+= 1` on function
attributes: exact for launches made one after the other, as those scripts
make them; concurrent requests of a server can lose counts.
"""

from __future__ import annotations


def launch_counts() -> dict[str, int]:
    """{kernel id: launches since the last reset}."""
    from diskrag_tpu_torch.ops import flat_scan as fs
    from diskrag_tpu_torch.ops import mm_probe, pq_scan

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

    fs.reset_launch_counts()
    pq_scan.reset_launch_counts()
    mm_probe.reset_launch_counts()
