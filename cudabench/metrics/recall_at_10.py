"""Mean recall@10 of every query answered in the window against the exact top-10."""


def read(run):
    return run.recall
