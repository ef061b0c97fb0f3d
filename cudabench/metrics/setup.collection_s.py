"""Host-clock seconds of the set-up's collection stage (update_collection; no tracing in set-up)."""
from cudabench.readers import setup_stage_s


def read(run):
    return setup_stage_s(run, "collection")
