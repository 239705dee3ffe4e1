"""Unsigned words carried as signed bit patterns.

torch on the CPU has no ``>>``, ``<`` or ``minimum`` for uint64/uint32, so
u64 words travel as int64 and u32 table rows as int32 with the same bits.
``&``, ``|``, ``^``, ``~``, ``<<``, ``==`` and wrapping ``*``/``+`` are
bit-exact on the signed types; right shifts and order compares are not, and
go through the helpers here.
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


_VIEW = {np.dtype(np.uint64): np.int64, np.dtype(np.uint32): np.int32}


def from_numpy(arr: np.ndarray, device) -> torch.Tensor:
    """NumPy array -> tensor on ``device``: u64/u32 become int64/int32 views
    with the same bits; other dtypes are kept. Zero-copy on the CPU for
    contiguous arrays."""
    arr = np.ascontiguousarray(arr)
    view = _VIEW.get(arr.dtype)
    if view is not None:
        arr = arr.view(view)
    return torch.from_numpy(arr).to(device)
