"""Host k-merization of reads (``kmerize_reads`` of
``mazu_tpu.index.streaming``; the streaming index itself is not ported
yet): the oracle of ``io.reads.kmerize_device``."""

from __future__ import annotations

import numpy as np


def kmerize_reads(reads: list[str], k: int):
    """(k-mer words u64 [R, L], valid bool [R, L], positions int64 [R, L]):
    each read's all-ACGT windows from the left of its row, L the longest
    read's window count (at least 1)."""
    from .validate import valid_kmer_windows

    R = len(reads)
    L = max((len(r) - k + 1 for r in reads), default=0)
    L = max(L, 1)
    kms = np.zeros((R, L), dtype=np.uint64)
    valid = np.zeros((R, L), dtype=bool)
    positions = np.zeros((R, L), dtype=np.int64)
    for i, read in enumerate(reads):
        pos, words = valid_kmer_windows(read, k)
        kms[i, : len(words)] = words
        valid[i, : len(words)] = True
        positions[i, : len(words)] = pos
    return kms, valid, positions
