"""2-bit packed DNA sequence (host; counterpart of
``mazu_tpu.bits.seqvector``): base ``i`` at bits ``[2i, 2i+2)`` of an
LSB-first uint64 word stream with one zero guard word."""

from __future__ import annotations

import numpy as np
import torch

from .._words import read_window as read_window_t
from ..kmer import seq_to_codes

U64 = np.uint64
_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)  # the letter of each 2-bit code


def read_window(words: np.ndarray, pos: np.ndarray, width: int) -> np.ndarray:
    """``width``-bit windows at bit offsets ``pos`` of a padded word array
    (``mazu_tpu.bits.bitvector._read_window``)."""
    wi = pos >> 6
    off = (pos & 63).astype(U64)
    lo = words[wi] >> off
    hi = words[wi + 1] << ((U64(64) - off) & U64(63))
    hi = np.where(off == 0, U64(0), hi)
    m = U64((1 << int(width)) - 1) if int(width) < 64 else U64(0xFFFFFFFFFFFFFFFF)
    return (lo | hi) & m


class SeqVector:
    def __init__(self, words: np.ndarray, length: int):
        nw = (2 * length + 63) // 64
        w = np.zeros(nw + 1, dtype=np.uint64)
        w[:nw] = words[:nw]
        self.words = w
        self.length = int(length)

    @classmethod
    def from_codes(cls, codes: np.ndarray) -> "SeqVector":
        codes = np.asarray(codes, dtype=np.uint8)
        if not (codes < 4).all():
            raise ValueError("invalid base code")
        n = len(codes)
        c = np.zeros(n + (-n) % 32, dtype=np.uint64)
        c[:n] = codes
        shifts = (np.arange(32, dtype=np.uint64) * U64(2))[None, :]
        words = np.bitwise_or.reduce(c.reshape(-1, 32) << shifts, axis=1)
        return cls(words, n)

    @classmethod
    def from_str(cls, seq: str | bytes) -> "SeqVector":
        return cls.from_codes(seq_to_codes(seq))

    def get_base(self, pos) -> np.ndarray:
        """2-bit code(s) of base(s) ``pos``."""
        pos = np.asarray(pos, dtype=np.int64)
        return ((self.words[pos >> 5] >> ((pos.astype(U64) & U64(31)) * U64(2))) & U64(3)).astype(
            np.uint8)

    def to_str(self, start: int = 0, end: int | None = None) -> str:
        """Bases [start, end) as an ACGT string."""
        end = self.length if end is None else end
        return _BASES[self.get_base(np.arange(start, end, dtype=np.int64))].tobytes().decode()

    def __len__(self) -> int:
        return self.length

    def get_kmer_u64(self, pos, k: int) -> np.ndarray:
        """k-mer word(s) at base position(s) ``pos`` (may cross two words)."""
        pos = np.asarray(pos, dtype=np.int64)
        return read_window(self.words, pos * 2, 2 * int(k))

    def device_arrays(self) -> dict:
        from ..pytree import meta

        return {"words": self.words, "meta": meta(length=self.length)}


def sv_get_kmer(words: torch.Tensor, pos: torch.Tensor, k: int) -> torch.Tensor:
    """k-mer word(s) at base position(s) ``pos`` of a SeqVector's words
    (device form of ``SeqVector.get_kmer_u64``)."""
    return read_window_t(words, pos * 2, 2 * int(k))
