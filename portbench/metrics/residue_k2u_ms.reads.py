"""Device milliseconds a batch in the ragged phase 2's residue K2U kernel
(``residue_k2u_kernel``) in the traced batches, from the profiler's trace;
none where the program has no such kernel."""

from portbench.trace import kernel_ns


def read(run):
    if run.trace is None or not run.trace.batches:
        return None
    ns, n = kernel_ns(run.trace, part="residue_k2u_kernel")
    return ns * 1e-6 / run.trace.batches if n else None
