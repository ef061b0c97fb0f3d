"""Seconds from the process start to the window: data, collection, build, engine, warm-up."""


def read(run):
    return run.setup_s
