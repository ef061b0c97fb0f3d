"""Mean device ms a request of the exact rerank of beam and visited log: the kernels launched inside the `graph.rerank` spans of the profiled span stretch, wherever on the device they ran after the span closed."""


def read(run):
    p = (run.program or {}).get("profiled") or {}
    ms = (p.get("device_ms_by_span") or {}).get("graph.rerank")
    requests = (p.get("stretch") or {}).get("requests")
    return ms / requests if ms and requests else None
