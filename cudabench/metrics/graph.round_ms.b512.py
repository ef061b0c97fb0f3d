"""Host ms a traversal round at B = 512: (search - fetch time) over rounds, summed."""
from cudabench.readers import round_ms as read  # noqa: F401
