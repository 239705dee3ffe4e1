"""Device milliseconds a batch in the ragged phase 2's kernel
(``occ_csr_kernel``, all three of its stages) in the traced batches, from
the profiler's trace."""

from portbench.trace import kernel_ns


def read(run):
    if run.trace is None or not run.trace.batches:
        return None
    ns, n = kernel_ns(run.trace, part="occ_csr_kernel")
    return ns * 1e-6 / run.trace.batches if n else None
