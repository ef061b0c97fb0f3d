"""Mean ms a B = 1 request of the traversal's seeding, its graph.seed spans (span stretch)."""
from cudabench.readers import program


def read(run):
    return program(run, "graph.seed_ms")
