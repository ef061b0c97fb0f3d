"""Mean device ms a request of the per-request PQ tables (inner tables [B, m, 256], cell terms [B, cells]): the kernels launched inside the `engine.pq_tables` spans of the profiled span stretch, wherever on the device they ran after the span closed."""


def read(run):
    p = (run.program or {}).get("profiled") or {}
    ms = (p.get("device_ms_by_span") or {}).get("engine.pq_tables")
    requests = (p.get("stretch") or {}).get("requests")
    return ms / requests if ms and requests else None
