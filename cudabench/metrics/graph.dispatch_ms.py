"""Host ms a traversal round of the plain loop outside its wait on the device (span stretch)."""
from cudabench.readers import program


def read(run):
    return program(run, "graph.dispatch_ms")
