"""Rank/select bitvector over uint64 words (counterpart of
``mazu_tpu.bits.bitvector``): ``rank(i)`` counts the ones in ``[0, i)``,
``select(r)`` is the position of the r-th one (0-based).

Host layout: ``words`` uint64[nw+1] (at least two words, so a two-word
window read never runs past the end) and ``blocks`` uint32[nw+1], the
exclusive prefix popcount per word. The device functions take the
``device_arrays()`` dict as tensors (int64/int32 bit patterns).
"""

from __future__ import annotations

import numpy as np
import torch

from .._words import popcount64, read_window, srl
from .seqvector import read_window as read_window_np

U64 = np.uint64


def popcount_np(x: np.ndarray) -> np.ndarray:
    """Set bits of each uint64 (SWAR; ``np.bitwise_count`` needs NumPy 2)."""
    x = np.asarray(x, dtype=np.uint64)
    x = x - ((x >> U64(1)) & U64(0x5555555555555555))
    x = (x & U64(0x3333333333333333)) + ((x >> U64(2)) & U64(0x3333333333333333))
    x = (x + (x >> U64(4))) & U64(0x0F0F0F0F0F0F0F0F)
    return ((x * U64(0x0101010101010101)) >> U64(56)).astype(np.uint32)


class BitVector:
    def __init__(self, words: np.ndarray, n_bits: int):
        nw = (n_bits + 63) // 64
        if len(words) < nw:
            raise ValueError(f"{len(words)} words hold fewer than {n_bits} bits")
        self.n_bits = int(n_bits)
        w = np.zeros(max(nw + 1, 2), dtype=np.uint64)
        w[:nw] = words[:nw]
        tail = n_bits % 64
        if nw > 0 and tail:
            w[nw - 1] &= U64((1 << tail) - 1)
        self.words = w
        self.blocks = np.zeros(nw + 1, dtype=np.uint32)
        np.cumsum(popcount_np(w[:nw]), out=self.blocks[1:])
        self.n_ones = int(self.blocks[nw])

    @classmethod
    def from_bools(cls, bits: np.ndarray) -> "BitVector":
        """Bit i set where ``bits[i]``."""
        bits = np.asarray(bits, dtype=bool)
        n = len(bits)
        b = np.concatenate([bits, np.zeros((-n) % 64, dtype=bool)])
        return cls(np.packbits(b.reshape(-1, 8)[:, ::-1]).view(np.uint64), n)

    @classmethod
    def from_set_positions(cls, positions: np.ndarray, n_bits: int) -> "BitVector":
        positions = np.asarray(positions, dtype=np.int64)
        words = np.zeros((n_bits + 63) // 64, dtype=np.uint64)
        np.bitwise_or.at(words, positions >> 6, U64(1) << (positions.astype(U64) & U64(63)))
        return cls(words, n_bits)

    def get_bit(self, pos) -> np.ndarray:
        """Bit ``pos`` (bool)."""
        pos = np.asarray(pos, dtype=np.int64)
        return ((self.words[pos >> 6] >> (pos.astype(U64) & U64(63))) & U64(1)) != 0

    def rank(self, pos) -> np.ndarray:
        """Ones in [0, pos)."""
        pos = np.asarray(pos, dtype=np.int64)
        wi = pos >> 6
        off = pos.astype(U64) & U64(63)
        mask = np.where(off == 0, U64(0), ~U64(0) >> ((U64(64) - off) & U64(63)))
        return self.blocks[wi].astype(np.int64) + popcount_np(self.words[wi] & mask).astype(np.int64)

    def select(self, r) -> np.ndarray:
        """Position of the r-th one (0-based): the word from the block
        counts, then a bisection inside it."""
        r = np.asarray(r, dtype=np.int64)
        wi = np.searchsorted(self.blocks, r, side="right") - 1
        rem = r - self.blocks[wi].astype(np.int64)
        word = self.words[wi]
        pos = wi * 64
        for shift in (32, 16, 8, 4, 2, 1):
            c = popcount_np(word & U64((1 << shift) - 1)).astype(np.int64)
            go = rem >= c
            rem = np.where(go, rem - c, rem)
            pos = np.where(go, pos + shift, pos)
            word = np.where(go, word >> U64(shift), word)
        return pos

    def count_ones(self) -> int:
        return self.n_ones

    def num_bits(self) -> int:
        return 64 * len(self.words) + 32 * len(self.blocks)

    def read_window(self, pos, width: int) -> np.ndarray:
        """Raw ``width``-bit window at bit offset(s) ``pos``."""
        return read_window_np(self.words, np.asarray(pos, dtype=np.int64), width)

    def device_arrays(self) -> dict:
        from ..pytree import meta

        return {
            "words": self.words,
            "blocks": self.blocks,
            "meta": meta(n_bits=self.n_bits, n_ones=self.n_ones),
        }


def rank_in_word(word: torch.Tensor, block: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``block`` (the ones before ``word``) plus the ones of ``word`` below
    bit ``pos & 63``."""
    off = pos & 63
    below = torch.where(off == 0, 0, word & ((1 << off) - 1))
    return block + popcount64(below)


def bv_rank(bv: dict, pos: torch.Tensor) -> torch.Tensor:
    """Ones in [0, pos): one word, one block count and a popcount."""
    wi = pos >> 6
    return rank_in_word(bv["words"][wi], bv["blocks"][wi].to(torch.int64) & 0xFFFFFFFF, pos)


def bv_get_bit(bv: dict, pos: torch.Tensor) -> torch.Tensor:
    """Bit ``pos`` as a bool."""
    return ((bv["words"][pos >> 6] >> (pos & 63)) & 1) != 0


def bv_select(bv: dict, r: torch.Tensor) -> torch.Tensor:
    """Position(s) of the r-th one: the word from a search of the block
    counts (int64, as torch has no unsigned ``searchsorted``), then a
    bisection inside it with logical shifts."""
    blocks = bv["blocks"].to(torch.int64) & 0xFFFFFFFF
    wi = torch.searchsorted(blocks, r + 1, side="left") - 1
    rem = r - blocks[wi]
    word = bv["words"][wi]
    pos = wi * 64
    for shift in (32, 16, 8, 4, 2, 1):
        c = popcount64(word & ((1 << shift) - 1))
        go = rem >= c
        rem = torch.where(go, rem - c, rem)
        pos = torch.where(go, pos + shift, pos)
        word = torch.where(go, srl(word, shift), word)
    return pos


def bv_read_window(bv: dict, pos: torch.Tensor, width: int) -> torch.Tensor:
    """Raw ``width``-bit window(s) at bit offset(s) ``pos``."""
    return read_window(bv["words"], pos, width)
