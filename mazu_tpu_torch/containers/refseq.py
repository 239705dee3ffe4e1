"""RefSeqCollection: reference sequences, or only their lengths (host;
counterpart of ``mazu_tpu.containers.refseq``)."""

from __future__ import annotations

import numpy as np

from ..bits.seqvector import SeqVector
from ..pytree import meta


class RefSeqCollection:
    def __init__(self, seq: SeqVector | None, prefix_sum: np.ndarray, names: list[str] | None = None):
        self.seq = seq
        self.prefix_sum = np.asarray(prefix_sum, dtype=np.int64)
        self.names = names or []

    @classmethod
    def from_lens(cls, ref_lens, names=None) -> "RefSeqCollection":
        lens = np.asarray(ref_lens, dtype=np.int64)
        return cls(None, np.concatenate([[0], np.cumsum(lens)]), names)

    @property
    def has_seq(self) -> bool:
        return self.seq is not None

    @property
    def n_refs(self) -> int:
        return len(self.prefix_sum) - 1

    def ref_kmers(self, i: int, k: int) -> np.ndarray:
        """All forward k-mer words of reference ``i``."""
        if self.seq is None:
            raise ValueError("collection holds lengths only")
        s, e = int(self.prefix_sum[i]), int(self.prefix_sum[i + 1])
        return self.seq.get_kmer_u64(np.arange(s, e - k + 1, dtype=np.int64), k)

    def device_arrays(self) -> dict:
        d = {
            "prefix_sum": self.prefix_sum,
            "meta": meta(n_refs=self.n_refs, has_seq=self.has_seq),
        }
        if self.seq is not None:
            d["seq"] = self.seq.device_arrays()
        return d
