"""Queries answered in the window over its seconds (every request, stalls included)."""
from cudabench.readers import qps as read  # noqa: F401
