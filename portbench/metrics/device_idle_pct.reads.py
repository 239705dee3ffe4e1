"""Percent of a batch's time in which no operation ran on the device: one
less the device's busy seconds a batch in the traced batches (the union of
their kernels', copies' and sets' intervals, from the profiler's trace)
over the seconds a batch of the untraced window that ran just before them
(host clock). The profiler slows the host's launches, so the traced
window's own length would count that slowing as idle time; the untraced
window's does not."""

from portbench.trace import busy_s


def read(run):
    if run.trace is None or not run.batches or not run.trace.batches:
        return None
    return 100.0 * (1.0 - (busy_s(run.trace) / run.trace.batches) / (run.window_s / run.batches))
