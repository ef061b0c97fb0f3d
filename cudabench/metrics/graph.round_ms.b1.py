"""Host ms a traversal round at B = 1: (search - fetch time) over rounds, summed."""
from cudabench.readers import round_ms as read  # noqa: F401
