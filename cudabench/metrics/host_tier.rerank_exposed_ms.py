"""Mean ms a request waits for the host tier's reranks after its last traversal (span stretch)."""
from cudabench.readers import program


def read(run):
    return program(run, "host_tier.rerank_exposed_ms")
