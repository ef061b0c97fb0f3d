"""95th percentile of request latency over every request of the window."""
from cudabench.readers import p95_ms as read  # noqa: F401
