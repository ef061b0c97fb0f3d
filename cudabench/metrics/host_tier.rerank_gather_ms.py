"""Mean ms a request of the host tier's record reads for its reranks (span stretch)."""
from cudabench.readers import program


def read(run):
    return program(run, "host_tier.rerank_gather_ms")
