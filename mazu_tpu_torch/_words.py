"""Unsigned words carried as signed bit patterns.

torch on the CPU has no ``>>``, ``<`` or ``minimum`` for uint64/uint32, so
u64 words travel as int64 and u32 table rows as int32 with the same bits.
``&``, ``|``, ``^``, ``~``, ``<<``, ``==`` and wrapping ``*``/``+`` are
bit-exact on the signed types; right shifts and order compares are not, and
go through the helpers here. u16 arrays travel as int16 for the same
reason (torch has few ops for uint16).
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF


def srl(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by a constant ``n``."""
    n = int(n)
    if n == 0:
        return x
    return (x >> n) & ((1 << (64 - n)) - 1)


def srl_var(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by per-element amounts
    ``n`` in [0, 63]. The mask keeps the low 64 - n bits; it is built as
    ((1 << (63 - n)) << 1) - 1 so that n == 0 wraps to all ones."""
    return (x >> n) & (((1 << (63 - n)) << 1) - 1)


_B1 = 0x5555555555555555
_B2 = 0x3333333333333333
_B4 = 0x0F0F0F0F0F0F0F0F
_BYTES = 0x0101010101010101


def popcount64(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 bit pattern (SWAR; torch has no popcount).
    The byte-sum multiply wraps mod 2^64, and the final shift is logical."""
    x = x - (srl(x, 1) & _B1)
    x = (x & _B2) + (srl(x, 2) & _B2)
    x = (x + srl(x, 4)) & _B4
    return srl(x * _BYTES, 56)


def read_window(words: torch.Tensor, pos: torch.Tensor, width: int) -> torch.Tensor:
    """``width``-bit windows (width < 64) at bit offsets ``pos`` of a padded
    int64 word array: the device form of ``bits.seqvector.read_window``."""
    wi = pos >> 6
    off = pos & 63
    lo = srl_var(words[wi], off)
    hi = torch.where(off == 0, 0, words[wi + 1] << ((64 - off) & 63))
    return (lo | hi) & ((1 << int(width)) - 1)


_SIGN = -(1 << 63)


def ule(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned ``a <= b`` of int64 bit patterns: flipping the sign bit
    maps unsigned order onto signed order."""
    return (a ^ _SIGN) <= (b ^ _SIGN)


def umin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned minimum of int64 bit patterns."""
    return torch.where(ule(a, b), a, b)


def mask32(x: torch.Tensor) -> torch.Tensor:
    """Zero-extend u32 bit patterns (int32, or int64 holding garbage above
    bit 31) to int64 values in [0, 2^32)."""
    return x.to(torch.int64) & M32


_VIEW = {
    np.dtype(np.uint64): np.int64,
    np.dtype(np.uint32): np.int32,
    np.dtype(np.uint16): np.int16,
}


def from_numpy(arr: np.ndarray, device) -> torch.Tensor:
    """NumPy array -> tensor on ``device``: u64/u32/u16 become int64/int32/
    int16 views with the same bits; other dtypes are kept. Zero-copy on the
    CPU for contiguous arrays."""
    arr = np.ascontiguousarray(arr)
    view = _VIEW.get(arr.dtype)
    if view is not None:
        arr = arr.view(view)
    return torch.from_numpy(arr).to(device)
