"""Milliseconds a batch in ``io.native.fastq_pack``, the host's parse and
2-bit pack of the FASTQ text (the benchmark's span, host clock), averaged
over the batches of the untraced window."""


def read(run):
    return 1e3 * sum(run.pack_s) / len(run.pack_s) if run.pack_s else None
