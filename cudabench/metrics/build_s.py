"""Wall seconds of the index build in set-up: host vectors to the index persisted."""


def read(run):
    return run.build_s
