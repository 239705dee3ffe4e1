"""k-mer word math (counterpart of ``mazu_tpu.kmer``).

Same LSB-first encoding: base codes A=0, C=1, G=2, T=3; base ``i`` of a
k-mer sits at bits ``[2i, 2i+2)``; k <= 31, so a k-mer fits 62 bits.

Torch functions take int64 bit patterns of u64 words. ``reverse_groups(~x)``
has bit 63 set, so ``revcomp``'s final shift is logical, and compares are
unsigned, as in the reference, for any 64-bit input. The ``*_np`` twins
are the host builders' NumPy forms.
"""

from __future__ import annotations

import numpy as np
import torch

from ._words import srl, ule

_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F
_M8 = 0x00FF00FF00FF00FF
_M16 = 0x0000FFFF0000FFFF

_BASE_TO_CODE = np.full(256, 255, dtype=np.uint8)
for _b, _c in zip(b"ACGT", range(4)):
    _BASE_TO_CODE[_b] = _c
for _b, _c in zip(b"acgt", range(4)):
    _BASE_TO_CODE[_b] = _c


def mask2k(k: int) -> int:
    """Mask of the low 2k bits, as an int64-representable Python int."""
    k = int(k)
    return -1 if k >= 32 else (1 << (2 * k)) - 1


def seq_to_codes(seq: bytes | str) -> np.ndarray:
    """ASCII DNA -> uint8 base codes (255 for non-ACGT). Host-side."""
    if isinstance(seq, str):
        seq = seq.encode()
    return _BASE_TO_CODE[np.frombuffer(seq, dtype=np.uint8)]


def reverse_groups(x: torch.Tensor) -> torch.Tensor:
    """Reverse the order of the 32 2-bit groups of each int64 word. The
    masks clear the sign bits an arithmetic shift drags in, except in the
    last step, which needs a logical shift."""
    x = ((x >> 2) & _M2) | ((x & _M2) << 2)
    x = ((x >> 4) & _M4) | ((x & _M4) << 4)
    x = ((x >> 8) & _M8) | ((x & _M8) << 8)
    x = ((x >> 16) & _M16) | ((x & _M16) << 16)
    return srl(x, 32) | (x << 32)


def revcomp(x: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of k-mer words (int64 bit patterns)."""
    return srl(reverse_groups(~x), 64 - 2 * int(k))


def canonicalize(x: torch.Tensor, k: int):
    """(canonical word, is_fw, rc word); ties go to the forward word."""
    rc = revcomp(x, k)
    is_fw = ule(x, rc)
    return torch.where(is_fw, x, rc), is_fw, rc


def reverse_groups_np(x: np.ndarray) -> np.ndarray:
    u = np.uint64
    x = ((x >> u(2)) & u(_M2)) | ((x & u(_M2)) << u(2))
    x = ((x >> u(4)) & u(_M4)) | ((x & u(_M4)) << u(4))
    x = ((x >> u(8)) & u(_M8)) | ((x & u(_M8)) << u(8))
    x = ((x >> u(16)) & u(_M16)) | ((x & u(_M16)) << u(16))
    return (x >> u(32)) | (x << u(32))


def revcomp_np(x: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement of uint64 k-mer words (host)."""
    return reverse_groups_np(~np.asarray(x, dtype=np.uint64)) >> np.uint64(
        64 - 2 * int(k)
    )
