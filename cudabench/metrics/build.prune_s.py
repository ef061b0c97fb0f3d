"""Seconds of the build's alpha-prune stage (its stage_seconds; laps synchronize)."""
from cudabench.readers import build_stage_s


def read(run):
    return build_stage_s(run, "prune")
