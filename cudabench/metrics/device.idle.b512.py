"""Percent of a traced stretch of B = 512 requests with no operation on the device."""
from cudabench.readers import idle_pct as read  # noqa: F401
