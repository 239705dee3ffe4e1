"""Fixed-width packed integer vector (counterpart of
``mazu_tpu.bits.intvector``): ``len`` integers of ``width`` <= 58 bits
packed LSB-first into uint64 words, with at least two words of padding
past the data. ``iv_get`` is the device read; ``IntVector.from_tensor``
packs on the values' device (``pack_words``), bit for bit as
``from_array`` packs on the host."""

from __future__ import annotations

import numpy as np
import torch

from .._words import M32
from .._words import read_window as read_window_t
from .seqvector import read_window

U64 = np.uint64


class IntVector:
    def __init__(self, words: np.ndarray, length: int, width: int):
        if not (0 < width <= 58 or length == 0):
            raise ValueError(f"width {width} unsupported")
        nw = (length * width + 63) // 64
        w = np.zeros(max(nw + 1, 2), dtype=np.uint64)
        w[:nw] = words[:nw]
        self.words = w
        self.length = int(length)
        self.width = int(width)
        self.values = None  # the unpacked values, where kept (``keep_values``)

    @classmethod
    def from_array(cls, values: np.ndarray, width: int | None = None) -> "IntVector":
        """Pack ``values`` at the minimal (or the given) bit width."""
        values = np.asarray(values, dtype=np.uint64)
        n = len(values)
        if width is None:
            width = max(1, (int(values.max()) if n else 0).bit_length())
        width = int(width)
        if n == 0:
            return cls(np.zeros(0, dtype=np.uint64), 0, width)
        if width > 58:
            raise ValueError(f"width {width} unsupported")
        nw = (n * width + 63) // 64
        bit_pos = np.arange(n, dtype=np.int64) * width
        wi = bit_pos >> 6
        off = (bit_pos & 63).astype(U64)
        words = np.zeros(nw + 1, dtype=np.uint64)
        v = values & U64((1 << width) - 1)
        # word indices never decrease, so each word's share is one OR-reduce
        # over a run of elements
        first = np.flatnonzero(np.concatenate([[True], wi[1:] != wi[:-1]]))
        words[wi[first]] = np.bitwise_or.reduceat(v << off, first)
        # an element that crosses a word boundary spills into the next word
        hi = np.where(off == 0, U64(0), v >> ((U64(64) - off) & U64(63)))
        words[wi[first] + 1] |= np.bitwise_or.reduceat(hi, first)
        return cls(words[:nw], n, width)

    @classmethod
    def from_tensor(cls, values: torch.Tensor, width: int | None = None) -> "IntVector":
        """``from_array`` of int64 ``values`` (non-negative), packed on their
        device by ``pack_words``; the words come back to the host."""
        n = values.shape[0]
        if width is None:
            width = max(1, (int(values.max()) if n else 0).bit_length())
        width = int(width)
        if n == 0:
            return cls(np.zeros(0, dtype=np.uint64), 0, width)
        if width > 58:
            raise ValueError(f"width {width} unsupported")
        return cls(pack_words(values, width).cpu().numpy().view(np.uint64), n, width)

    def get(self, i) -> np.ndarray:
        i = np.asarray(i, dtype=np.int64)
        return read_window(self.words, i * self.width, self.width)

    def to_array(self, chunk: int = 1 << 24) -> np.ndarray:
        """Every value as u64: the values the vector was packed from where it
        keeps them (``keep_values``, read-only), else unpacked ``chunk`` at a
        time (so the unpacking's temporaries stay the size of a chunk)."""
        if self.values is not None:
            return self.values
        out = np.empty(self.length, dtype=np.uint64)
        for a in range(0, self.length, chunk):
            out[a : a + chunk] = self.get(np.arange(a, min(a + chunk, self.length), dtype=np.int64))
        return out

    def keep_values(self, values: np.ndarray) -> "IntVector":
        """Keep ``values`` (the u64 values this vector packs) for
        ``to_array``, read-only: a table read whole more than once is then
        unpacked never."""
        values = np.asarray(values, dtype=np.uint64)
        if len(values) != self.length:
            raise ValueError(f"{len(values)} values for a vector of {self.length}")
        values.flags.writeable = False
        self.values = values
        return self

    def __len__(self) -> int:
        return self.length

    def num_bits(self) -> int:
        return 64 * len(self.words)

    def device_arrays(self) -> dict:
        from ..pytree import meta

        return {"words": self.words, "meta": meta(width=self.width, length=self.length)}


def pack_words(values: torch.Tensor, width: int, chunk: int = 1 << 24) -> torch.Tensor:
    """The ``(n * width + 63) // 64`` data words (int64 bit patterns) of
    ``values`` packed LSB-first at ``width`` (<= 58) bits, on their device.

    Each value is split into 32-bit halves, shifted to its bit offset
    within a 32-bit word and added into that word and the next two: the
    parts of distinct values hold distinct bits, so every sum is an OR below
    2^32 and no add carries or overflows. A chunk starts on a 64-bit word
    (its first element's bit offset is a multiple of 64) and ORs its words
    into the result; its last word may be the next chunk's first."""
    n, width = values.shape[0], int(width)
    nw = (n * width + 63) // 64
    dev = values.device
    out = torch.zeros(nw + 1, dtype=torch.int64, device=dev)
    step = max(64, int(chunk) // 64 * 64)
    for s in range(0, n, step):
        e = min(s + step, n)
        v = values[s:e] & ((1 << width) - 1)
        b = torch.arange(e - s, dtype=torch.int64, device=dev) * width
        j, off = b >> 5, b & 31
        lo = (v & M32) << off
        hi = (v >> 32) << off
        acc = torch.zeros(((e - s) * width + 31) // 32 + 4 & ~1, dtype=torch.int64, device=dev)
        acc.index_add_(0, j, lo & M32)
        acc.index_add_(0, j + 1, (lo >> 32) + (hi & M32))
        acc.index_add_(0, j + 2, hi >> 32)
        w64 = acc[0::2] | (acc[1::2] << 32)
        ws = s * width // 64
        m = min(w64.shape[0], nw + 1 - ws)
        out[ws : ws + m] |= w64[:m]
    return out[:nw]


def iv_get(iv: dict, i: torch.Tensor) -> torch.Tensor:
    """Element(s) ``i`` of a packed IntVector (device arrays): one
    ``width``-bit window read at bit ``i * width``."""
    width = int(iv["meta"].width)
    return read_window_t(iv["words"], i * width, width)
