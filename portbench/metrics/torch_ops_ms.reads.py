"""Device milliseconds a batch in every kernel but the port's hand-written
probe kernels (``*_probe_kernel``): the plain torch ops of the two-phase
query, projection and compaction (and, for reads, k-merisation and colors),
from the profiler's trace."""

from portbench.trace import kernel_ns


def read(run):
    if run.trace is None:
        return None
    ns, n = kernel_ns(run.trace, exclude="_probe_kernel")
    return ns * 1e-6 / run.trace.batches if n else None
