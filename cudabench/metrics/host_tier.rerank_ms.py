"""Mean ms a request of the host tier's gather, exact rerank and select (its stage_ms)."""
from cudabench.readers import stage_ms


def read(run):
    return stage_ms(run, "gather_rerank_select")
