"""Mean ms a request of the engine's text join less the collector's pauses inside it (span stretch)."""
from cudabench.readers import program


def read(run):
    return program(run, "engine.join_self_ms")
