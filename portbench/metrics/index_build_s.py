"""Seconds of the port's index build, its device arrays and their move to
the card, ending in a sync (the benchmark's span, host clock)."""


def read(run):
    return run.index_build_s
