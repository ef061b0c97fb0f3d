"""Percent of B4's bound (bytes at 3.35 TB/s) in the build's kNN pass."""
from cudabench.readers import roofline_share


def read(run):
    return roofline_share(run, "B4")
