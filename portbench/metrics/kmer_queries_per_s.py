"""k-mer lookups answered in the window over the window's seconds (host
clock around the whole window)."""


def read(run):
    return run.work / run.window_s if run.window_s else None
