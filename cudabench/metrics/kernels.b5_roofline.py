"""Percent of B5's byte bound (the shapes' part of it, `cudabench/roofline_b5.py`) in B5's device time, a request each."""
from cudabench.roofline_b5 import share as read  # noqa: F401
