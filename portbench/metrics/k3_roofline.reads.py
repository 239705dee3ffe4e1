"""K3's share of its memory roofline: the bytes a launch must move at least
(``portbench.k3_bytes``, a chunk's lanes) at the card's peak rate
(``portbench.roofline``) over ``capacity_probe_kernel``'s mean time in the
trace."""

from portbench.k3_bytes import k3_bytes
from portbench.roofline import share_pct
from portbench.trace import kernel_ns


def read(run):
    if run.trace is None:
        return None
    ns, n = kernel_ns(run.trace, part="capacity_probe_kernel")
    return share_pct(k3_bytes(run.probe_lanes), ns * 1e-9 / n) if n else None
