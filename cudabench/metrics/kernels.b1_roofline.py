"""Percent of B1's bound (int8 products at 1,979 TOP/s, or bytes at 3.35 TB/s) in the build's kNN pass."""
from cudabench.readers import roofline_share


def read(run):
    return roofline_share(run, "B1")
