"""The ragged phase 2's share of its memory roofline: the bytes its kernel
must move at least over the traced batches (``portbench.occ_csr_bytes``,
from each batch's phase-2 lanes and occurrences, which the traffic records
in ``traffic.genome_reads.CALLS``) at the card's peak rate
(``portbench.roofline``) over ``occ_csr_kernel``'s time in the trace."""

from portbench.occ_csr_bytes import occ_csr_bytes
from portbench.roofline import share_pct
from portbench.trace import kernel_ns


def read(run):
    if run.trace is None or not run.trace.batches:
        return None
    from portbench.traffic import genome_reads

    calls = genome_reads.CALLS[-run.trace.batches:]
    ns, n = kernel_ns(run.trace, part="occ_csr_kernel")
    if not n or len(calls) != run.trace.batches:
        return None
    n_bytes = sum(occ_csr_bytes(lanes, occs) for lanes, occs, _ in calls)
    return share_pct(n_bytes, ns * 1e-9)
