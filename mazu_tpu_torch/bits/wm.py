"""Wavelet matrix over byte symbols, at most 8 levels (counterpart of
``mazu_tpu.bits.wm``; the reference's ``src/wm.rs``, the extended wavelet
matrix with its alpha-offsets array C).

The build is host NumPy: per level, the bit plane of the symbols' next
bit from the top, then a stable sort of the symbols by that bit. access,
rank and select are batched torch functions that walk the level stack
with the bitvector's rank and select on int64 bit patterns; select of a
zero searches each level's ``zero_blocks`` (the zeros before each word,
monotone). ``WaveletMatrixSlice`` is the reference's window view: rank
and select rebased by the rank at the window's start.
"""

from __future__ import annotations

import numpy as np
import torch

from .._words import popcount64, srl
from ..pytree import meta
from .bitvector import BitVector, bv_get_bit, bv_rank, bv_select

NO_SYM = -1  # alpha offset of a symbol the sequence lacks


def _host(fn, d: dict, *args) -> np.ndarray:
    """``fn`` of the CPU tensors ``d`` and of host arguments, the result as
    NumPy."""
    t = [torch.as_tensor(np.asarray(a, dtype=np.int64)) for a in args]
    return fn(d, *t).numpy()


class WaveletMatrix:
    def __init__(self, levels, zeros, alpha_offsets, length: int, alpha_size: int):
        self.levels: list[BitVector] = levels
        self.zeros = np.asarray(zeros, dtype=np.int64)
        self.alpha_offsets = np.asarray(alpha_offsets, dtype=np.int64)  # NO_SYM: absent
        self.length = int(length)
        self.alpha_size = int(alpha_size)
        self.n_levels = len(levels)
        self._cpu = None  # device_arrays() as CPU tensors, made on first use

    @classmethod
    def build(cls, seq: np.ndarray, alpha_size: int) -> "WaveletMatrix":
        if alpha_size <= 1:
            raise AssertionError("alpha_size must be at least 2")
        seq = np.asarray(seq, dtype=np.uint8)
        if not (seq < alpha_size).all():
            raise AssertionError("a symbol is not below alpha_size")
        n_levels = max(1, int(alpha_size - 1).bit_length())
        if n_levels > 8:
            raise AssertionError("byte symbols: at most 8 levels")
        levels, zeros = [], []
        cur = seq.copy()
        for lev in range(n_levels):
            bits = (cur & np.uint8(1 << (n_levels - 1 - lev))) > 0
            levels.append(BitVector.from_bools(bits))
            zeros.append(int((~bits).sum()))
            cur = cur[np.argsort(bits, kind="stable")]
        alpha_offsets = np.full(alpha_size, NO_SYM, dtype=np.int64)
        if len(cur):
            change = np.concatenate([[True], cur[1:] != cur[:-1]])
            alpha_offsets[cur[change]] = np.flatnonzero(change)
        return cls(levels, zeros, alpha_offsets, len(seq), alpha_size)

    def has_symbol(self, a) -> np.ndarray:
        return self.alpha_offsets[np.asarray(a, dtype=np.int64)] != NO_SYM

    def access(self, i) -> np.ndarray:
        return _host(wm_access, self._cpu_arrays(), i)

    def rank(self, a, i) -> np.ndarray:
        a, i = np.broadcast_arrays(np.asarray(a), np.asarray(i))
        return _host(wm_rank, self._cpu_arrays(), a, i)

    def select(self, a, r) -> np.ndarray:
        """Position of the r-th occurrence of a (-1 if the symbol is absent)."""
        a, r = np.broadcast_arrays(np.asarray(a), np.asarray(r))
        return _host(wm_select, self._cpu_arrays(), a, r)

    def _cpu_arrays(self) -> dict:
        """The host methods' arrays: ``device_arrays()`` on the CPU, built
        once."""
        if self._cpu is None:
            from ..convert import arrays_from_numpy

            self._cpu = arrays_from_numpy(self.device_arrays(), "cpu")
        return self._cpu

    def __len__(self) -> int:
        return self.length

    def num_bits(self) -> int:
        return sum(lv.num_bits() for lv in self.levels) + 64 * (
            len(self.zeros) + len(self.alpha_offsets))

    def device_arrays(self) -> dict:
        d = {
            "zeros": self.zeros,
            "alpha_offsets": self.alpha_offsets,
            "meta": meta(n_levels=self.n_levels, length=self.length,
                         alpha_size=self.alpha_size),
        }
        for lev, bv in enumerate(self.levels):
            lv = bv.device_arrays()
            nw = len(bv.blocks) - 1
            # the zeros before each word: monotone, so select of a zero
            # searches it
            lv["zero_blocks"] = np.arange(nw + 1, dtype=np.int64) * 64 - bv.blocks.astype(np.int64)
            d[f"level{lev}"] = lv
        return d


class WaveletMatrixSlice:
    """Window view ``S[start:end]`` of a WaveletMatrix (the reference's
    ``src/wm.rs:13-44``): rank in the window is ``rank(a, start + i) -
    rank(a, start)``; select rebases the occurrence rank by
    ``rank(a, start)``. No data is copied."""

    def __init__(self, wm: WaveletMatrix, start: int, end: int):
        if not 0 <= start <= end <= len(wm):
            raise AssertionError("the window must lie in the sequence")
        self.wm = wm
        self.start = int(start)
        self.len = int(end - start)

    def __len__(self) -> int:
        return self.len

    def is_empty(self) -> bool:
        return self.len == 0

    def access(self, i) -> np.ndarray:
        i = np.asarray(i)
        if not (i < self.len).all():
            raise AssertionError("index past the window")
        return self.wm.access(self.start + i)

    def rank(self, a, i) -> np.ndarray:
        i = np.asarray(i)
        if not (i <= self.len).all():
            raise AssertionError("index past the window")
        return self.wm.rank(a, self.start + i) - self.wm.rank(a, self.start)

    def select(self, a, r) -> np.ndarray:
        """Window position of the r-th in-window occurrence of ``a``, as the
        reference computes it: ``wm.select(a, base + r) - start`` with base
        = rank(a, start), which may lie past the window's end when it holds
        fewer than r + 1; -1 only when the sequence holds no (base + r +
        1)-th occurrence at all (the reference's None)."""
        r = np.asarray(r)
        base = self.wm.rank(a, self.start)
        n_total = self.wm.rank(a, len(self.wm))
        s = self.wm.select(a, base + r) - self.start
        return np.where(base + r < n_total, s, -1)


def wm_slice_access(d: dict, start: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return wm_access(d, start + i)


def wm_slice_rank(d: dict, a: torch.Tensor, start: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return wm_rank(d, a, start + i) - wm_rank(d, a, start)


def wm_slice_select(d: dict, a: torch.Tensor, start: torch.Tensor,
                    r: torch.Tensor) -> torch.Tensor:
    """Batched ``WaveletMatrixSlice.select``: -1 where the sequence has no
    (rank(a, start) + r + 1)-th occurrence of ``a``."""
    base = wm_rank(d, a, start)
    s = wm_select(d, a, base + r)
    n_total = wm_rank(d, a, torch.full_like(start, d["meta"].length))
    return torch.where(base + r < n_total, s - start, -1)


def _bv_select_zero(lv: dict, r: torch.Tensor) -> torch.Tensor:
    """Position of the r-th zero bit: the word from a search of
    ``zero_blocks``, then a bisection inside the word's complement."""
    zb = lv["zero_blocks"]
    wi = torch.searchsorted(zb, r + 1, side="left") - 1
    rem = r - zb[wi]
    word = ~lv["words"][wi]
    pos = wi * 64
    for shift in (32, 16, 8, 4, 2, 1):
        c = popcount64(word & ((1 << shift) - 1))
        go = rem >= c
        rem = torch.where(go, rem - c, rem)
        pos = torch.where(go, pos + shift, pos)
        word = torch.where(go, srl(word, shift), word)
    return pos


def wm_access(d: dict, i: torch.Tensor) -> torch.Tensor:
    """access(i), the symbol at i (the reference's ``src/wm.rs:223-240``)."""
    m = d["meta"]
    j = i
    alpha = torch.zeros_like(j)
    for lev in range(m.n_levels):
        lv = d[f"level{lev}"]
        bit = bv_get_bit(lv, j)
        r = bv_rank(lv, j)
        j = torch.where(bit, d["zeros"][lev] + r, j - r)
        alpha = alpha | torch.where(bit, 1 << (m.n_levels - 1 - lev), 0)
    return alpha


def wm_rank(d: dict, a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """rank(a, i), the occurrences of a in S[0, i) (the reference's
    ``src/wm.rs:242-269``); 0 for a symbol the sequence lacks."""
    m = d["meta"]
    j = i
    for lev in range(m.n_levels):
        lv = d[f"level{lev}"]
        abit = (a & (1 << (m.n_levels - 1 - lev))) > 0
        r = bv_rank(lv, j)
        j = torch.where(abit, d["zeros"][lev] + r, j - r)
    off = d["alpha_offsets"][torch.clamp(a, 0, m.alpha_size - 1)]
    return torch.where(off == NO_SYM, 0, j - off)


def wm_select(d: dict, a: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """select(a, r), the position of the r-th occurrence of a (the
    reference's ``src/wm.rs:271-291``); -1 for a symbol the sequence lacks."""
    m = d["meta"]
    off = d["alpha_offsets"][torch.clamp(a, 0, m.alpha_size - 1)]
    has = off != NO_SYM
    j = torch.where(has, off, 0) + r
    for lev in range(m.n_levels - 1, -1, -1):
        lv = d[f"level{lev}"]
        abit = (a & (1 << (m.n_levels - 1 - lev))) > 0
        j1 = bv_select(lv, torch.clamp(j - d["zeros"][lev], min=0))
        j0 = _bv_select_zero(lv, j)
        j = torch.where(abit, j1, j0)
    return torch.where(has, j, -1)
