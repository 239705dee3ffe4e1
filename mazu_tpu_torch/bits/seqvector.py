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
    def from_codes(cls, codes: np.ndarray, chunk: int = 1 << 26) -> "SeqVector":
        """Pack 2-bit base codes, ``chunk`` bases at a time: four bases a
        byte, bytes in little-endian order a word (base i at bits
        [2i, 2i+2)), so a genome of billions of bases needs no wide
        temporaries."""
        codes = np.asarray(codes, dtype=np.uint8)
        n = len(codes)
        words = np.zeros((n + 31) // 32, dtype=np.uint64)
        step = max(32, int(chunk) // 32 * 32)
        for a in range(0, n, step):
            c = codes[a : a + step]
            if not (c < 4).all():
                raise ValueError("invalid base code")
            if len(c) % 32:
                c = np.concatenate([c, np.zeros(-len(c) % 32, dtype=np.uint8)])
            b = c[0::4] | (c[1::4] << 2) | (c[2::4] << 4) | (c[3::4] << 6)
            words[a // 32 : a // 32 + len(b) // 8] = b.view("<u8")
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

    def num_bits(self) -> int:
        return 64 * len(self.words)

    def device_arrays(self) -> dict:
        from ..pytree import meta

        return {"words": self.words, "meta": meta(length=self.length)}


def sv_get_kmer(words: torch.Tensor, pos: torch.Tensor, k: int) -> torch.Tensor:
    """k-mer word(s) at base position(s) ``pos`` of a SeqVector's words
    (device form of ``SeqVector.get_kmer_u64``)."""
    return read_window_t(words, pos * 2, 2 * int(k))
