"""Mean traversal rounds a request of 512 queries."""
from cudabench.readers import rounds as read  # noqa: F401
