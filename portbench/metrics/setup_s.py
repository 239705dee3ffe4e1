"""Seconds from the process's start to the first timed batch: the genome,
the index build, the move to the card, the traffic pool, warm-up and the
graphs' capture (host clock)."""


def read(run):
    return run.setup_s
