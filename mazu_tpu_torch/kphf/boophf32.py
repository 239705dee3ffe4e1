"""32-bit key hashes (counterpart of ``mazu_tpu.kphf.boophf32:33-54``).

murmur3 fmix32 and the two u64 -> u32 folds that address KCDict buckets.
The torch forms take int64 values (or u64 bit patterns for the folds) and
keep every intermediate in [0, 2^32) by masking after each multiply and
add. The ``*_np`` forms are the host builders'.
"""

from __future__ import annotations

import numpy as np
import torch

from .._words import M32, srl

_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLD = 0x9E3779B9


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on int64 tensors holding u32 values."""
    x = x ^ (x >> 16)
    x = (x * _C1) & M32
    x = x ^ (x >> 13)
    x = (x * _C2) & M32
    return x ^ (x >> 16)


def fold_hash32(keys: torch.Tensor) -> torch.Tensor:
    """u64 key (int64 bits) -> u32 hash in int64; the bucket-table hash."""
    lo = keys & M32
    hi = srl(keys, 32)
    return mix32(lo ^ _GOLD) ^ mix32((hi + _C2) & M32)


def fold_hash32b(keys: torch.Tensor, salt: int = 0) -> torch.Tensor:
    """Independent second fold for two-choice tables."""
    lo = keys & M32
    hi = srl(keys, 32)
    s = int(salt) & M32
    return mix32((lo + (_C1 ^ s)) & M32) ^ mix32(hi ^ ((_GOLD + s) & M32))


U32 = np.uint32
U64 = np.uint64


def mix32_np(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> U32(16))
    x = x * U32(_C1)
    x = x ^ (x >> U32(13))
    x = x * U32(_C2)
    return x ^ (x >> U32(16))


def fold_hash32_np(keys: np.ndarray) -> np.ndarray:
    lo = (keys & U64(M32)).astype(U32)
    hi = (keys >> U64(32)).astype(U32)
    return mix32_np(lo ^ U32(_GOLD)) ^ mix32_np(hi + U32(_C2))


def fold_hash32b_np(keys: np.ndarray, salt: int = 0) -> np.ndarray:
    lo = (keys & U64(M32)).astype(U32)
    hi = (keys >> U64(32)).astype(U32)
    s = U32(salt & M32)
    return mix32_np(lo + (U32(_C1) ^ s)) ^ mix32_np(hi ^ (U32(_GOLD) + s))
