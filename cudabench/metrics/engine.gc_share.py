"""Percent of the window the interpreter's garbage collector ran (gc.callbacks, all generations)."""
from cudabench.readers import gc_share as read  # noqa: F401
