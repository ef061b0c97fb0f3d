"""Ms a traversal round of the plain loop waits on the device (span stretch)."""
from cudabench.readers import program


def read(run):
    return program(run, "graph.sync_wait_ms")
