"""RefSeqCollection: reference sequences, or only their lengths (host;
counterpart of ``mazu_tpu.containers.refseq``)."""

from __future__ import annotations

import numpy as np

from ..bits.seqvector import SeqVector
from ..kmer import seq_to_codes
from ..pytree import meta


class RefSeqCollection:
    def __init__(self, seq: SeqVector | None, prefix_sum: np.ndarray, names: list[str] | None = None):
        self.seq = seq
        self.prefix_sum = np.asarray(prefix_sum, dtype=np.int64)
        self.names = names or []

    @classmethod
    def from_fasta(cls, path: str, min_len: int = 0) -> "RefSeqCollection":
        """The records of a FASTA file at least ``min_len`` long, upper-cased,
        with every non-ACGT base stored as A."""
        from ..io.fasta import read_fasta

        names, lens, code_chunks = [], [], []
        for name, seq in read_fasta(path):
            if len(seq) < min_len:
                continue
            codes = seq_to_codes(seq.upper())
            codes = np.where(codes == 255, 0, codes)
            names.append(name)
            lens.append(len(codes))
            code_chunks.append(codes)
        prefix_sum = np.concatenate([[0], np.cumsum(np.array(lens, dtype=np.int64))])
        sv = SeqVector.from_codes(
            np.concatenate(code_chunks) if code_chunks else np.zeros(0, dtype=np.uint8)
        )
        return cls(sv, prefix_sum, names)

    @classmethod
    def dummy(cls) -> "RefSeqCollection":
        """An empty collection: no references, no sequence."""
        return cls(None, np.zeros(1, dtype=np.int64), [])

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

    @property
    def total_len(self) -> int:
        return int(self.prefix_sum[-1])

    def ref_len(self, i) -> np.ndarray:
        i = np.asarray(i)
        return self.prefix_sum[i + 1] - self.prefix_sum[i]

    def ref_seq_str(self, i: int) -> str:
        if self.seq is None:
            raise ValueError("collection holds lengths only")
        return self.seq.to_str(int(self.prefix_sum[i]), int(self.prefix_sum[i + 1]))

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
