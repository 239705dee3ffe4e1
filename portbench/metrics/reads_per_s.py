"""Reads mapped and pseudoaligned in the window, from FASTQ text in host
memory to results on the host, over the window's seconds (host clock
around the whole window)."""


def read(run):
    return run.work / run.window_s if run.window_s else None
