"""Mean device ms a B = 512 request of the kernels the traversal's seeding launched (profiled span stretch)."""
from cudabench.readers import program


def read(run):
    return program(run, "graph.seed_device_ms")
