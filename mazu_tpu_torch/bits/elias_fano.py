"""Elias-Fano coded monotone sequence (counterpart of
``mazu_tpu.bits.elias_fano``).

The low ``l = max(1, msb(u / n))`` bits of each element are packed in an
IntVector; the high bits are unary gap coded in a BitVector of ``n + (u >>
l)`` bits, one set bit per element at ``i + (x_i >> l)``. So ``get(i) =
((select(i) - i) << l) | low[i]``, and ``ef_get`` runs it on tensors with
``bits.bitvector.bv_select``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..err import EFEmpty, EFNotMonotone
from .bitvector import BitVector, bv_select
from .intvector import IntVector, iv_get

U64 = np.uint64


def _msb(n: int) -> int:
    """Index of the most significant bit; msb(0) == 0."""
    return max(0, int(n).bit_length() - 1)


class EFVector:
    def __init__(self, u: int, l: int, high_bits: BitVector, low_bits: IntVector):
        self.u = int(u)
        self.l = int(l)
        self.high_bits = high_bits
        self.low_bits = low_bits

    @classmethod
    def from_array(cls, xs: np.ndarray, u: int | None = None) -> "EFVector":
        """Code the non-decreasing ``xs`` (universe ``u``, its last element
        by default). ``l`` is at least 1, as the reference codes it."""
        xs = np.asarray(xs, dtype=np.uint64)
        n = len(xs)
        if n == 0:
            raise EFEmpty("EFVector of empty sequence")
        if np.any(xs[1:] < xs[:-1]):
            raise EFNotMonotone("sequence not monotone")
        u = int(xs[-1]) if u is None else int(u)
        l = max(1, _msb(u // n))
        low = IntVector.from_array(xs & U64((1 << l) - 1), width=l)
        set_pos = np.arange(n, dtype=np.int64) + (xs >> U64(l)).astype(np.int64)
        return cls(u, l, BitVector.from_set_positions(set_pos, n + (u >> l)), low)

    def __len__(self) -> int:
        return len(self.low_bits)

    def get(self, i) -> np.ndarray:
        i = np.asarray(i, dtype=np.int64)
        high = self.high_bits.select(i) - i
        return (high.astype(U64) << U64(self.l)) | self.low_bits.get(i)

    def to_array(self) -> np.ndarray:
        return self.get(np.arange(len(self), dtype=np.int64))

    def num_bits(self) -> int:
        return 64 * 3 + self.high_bits.num_bits() + self.low_bits.num_bits()

    def device_arrays(self) -> dict:
        from ..pytree import meta

        return {
            "high": self.high_bits.device_arrays(),
            "low": self.low_bits.device_arrays(),
            "meta": meta(l=self.l, length=len(self)),
        }


def ef_get(ef: dict, i: torch.Tensor) -> torch.Tensor:
    """Element(s) ``i`` of an EFVector's device arrays (int64)."""
    high = bv_select(ef["high"], i) - i
    return (high << int(ef["meta"].l)) | iv_get(ef["low"], i)
