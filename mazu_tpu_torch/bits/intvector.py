"""Fixed-width packed integer vector (counterpart of
``mazu_tpu.bits.intvector``): ``len`` integers of ``width`` <= 58 bits
packed LSB-first into uint64 words, with at least two words of padding
past the data. ``iv_get`` is the device read."""

from __future__ import annotations

import numpy as np
import torch

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

    def get(self, i) -> np.ndarray:
        i = np.asarray(i, dtype=np.int64)
        return read_window(self.words, i * self.width, self.width)

    def to_array(self) -> np.ndarray:
        return self.get(np.arange(self.length, dtype=np.int64))

    def __len__(self) -> int:
        return self.length

    def num_bits(self) -> int:
        return 64 * len(self.words)

    def device_arrays(self) -> dict:
        from ..pytree import meta

        return {"words": self.words, "meta": meta(width=self.width, length=self.length)}


def iv_get(iv: dict, i: torch.Tensor) -> torch.Tensor:
    """Element(s) ``i`` of a packed IntVector (device arrays): one
    ``width``-bit window read at bit ``i * width``."""
    width = int(iv["meta"].width)
    return read_window_t(iv["words"], i * width, width)
