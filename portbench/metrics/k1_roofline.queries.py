"""K1's share of its memory roofline: the bytes a launch must move at the
card's peak rate (``portbench.roofline``) over ``mono2_probe_kernel``'s
mean time in the trace."""

from portbench.roofline import k1_bytes, share_pct
from portbench.trace import kernel_ns


def read(run):
    if run.trace is None:
        return None
    ns, n = kernel_ns(run.trace, part="mono2_probe_kernel")
    return share_pct(k1_bytes(run.probe_lanes), ns * 1e-9 / n) if n else None
