"""Mean ms a request of the host tier's traversals on the device (its stage_ms)."""
from cudabench.readers import stage_ms


def read(run):
    return stage_ms(run, "traverse")
