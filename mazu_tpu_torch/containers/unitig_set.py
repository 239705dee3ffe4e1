"""UnitigSet: concatenated 2-bit unitigs (host; counterpart of
``mazu_tpu.containers.unitig_set:24-110``).

``useq`` is the packed concatenation and ``accum`` the int64 prefix of
unitig lengths. The query path needs no boundary bitvector: position ->
unitig id is a binary search over ``accum``.
"""

from __future__ import annotations

import numpy as np

from ..bits.seqvector import SeqVector
from ..pytree import meta


class UnitigSet:
    def __init__(self, k: int, useq: SeqVector, accum: np.ndarray):
        self.k = int(k)
        self.useq = useq
        self.accum = np.asarray(accum, dtype=np.int64)

    @classmethod
    def from_seqs(cls, seqs: list[str], k: int) -> "UnitigSet":
        lens = np.array([len(s) for s in seqs], dtype=np.int64)
        accum = np.concatenate([[0], np.cumsum(lens)])
        return cls(k, SeqVector.from_str("".join(seqs)), accum)

    @property
    def n_unitigs(self) -> int:
        return len(self.accum) - 1

    @property
    def total_len(self) -> int:
        return int(self.accum[-1])

    @property
    def n_kmers(self) -> int:
        return self.total_len - self.k * self.n_unitigs + self.n_unitigs

    def unitig_len(self, i) -> np.ndarray:
        i = np.asarray(i)
        return self.accum[i + 1] - self.accum[i]

    def pos_to_id(self, pos) -> np.ndarray:
        """Unitig id of useq position(s) ``pos``."""
        return np.searchsorted(self.accum, pos, side="right") - 1

    def get_kmer_u64(self, pos) -> np.ndarray:
        return self.useq.get_kmer_u64(pos, self.k)

    def kmer_start_positions(self) -> np.ndarray:
        """Global useq positions of all valid k-mers, in unitig order."""
        starts = self.accum[:-1]
        counts = self.accum[1:] - self.k + 1 - starts
        offsets = np.concatenate([[0], np.cumsum(counts)])
        within = np.arange(offsets[-1], dtype=np.int64) - np.repeat(offsets[:-1], counts)
        return np.repeat(starts, counts) + within

    def device_arrays(self) -> dict:
        return {
            "useq": self.useq.device_arrays(),
            "accum": self.accum,
            "meta": meta(k=self.k, n_unitigs=self.n_unitigs, total_len=self.total_len),
        }
