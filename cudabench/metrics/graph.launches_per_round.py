"""Kernel launches inside a traversal round of the plain loop (profiled span stretch)."""
from cudabench.readers import program


def read(run):
    return program(run, "graph.launches_per_round")
