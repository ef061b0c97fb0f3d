"""Queries answered in the unprofiled window over its seconds, at B = 512 (every request, stalls included)."""
from cudabench.readers import qps as read  # noqa: F401
