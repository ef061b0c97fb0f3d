"""Mean ms a request of the engine's text join (total - search - embedding time)."""
from cudabench.readers import join_ms as read  # noqa: F401
