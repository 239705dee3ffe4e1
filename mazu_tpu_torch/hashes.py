"""64-bit hashes of the pufferfish BooPHF chain, and wyhash (counterpart of
``mazu_tpu.hashes``).

- ``simplehash64`` and the ``multihash_*`` chain (level 0 and 1 hashes,
  then xorshift128+ steps) address the levels of the 64-bit BooPHF, bit for
  bit with the C++ BooPHF.hpp; ``fast_range_64`` maps a hash into [0, p)
  by the high 64 bits of a 128-bit product (``mulhi64``).
- ``wyhash_u64`` is the wyhash-v1 digest of a word's 8 little-endian bytes,
  as ``mazu_tpu`` reconstructs it, and ``wyhash_bytes`` its scalar oracle
  over any byte buffer.

The torch forms take u64 words as int64 bit patterns: ``+``, ``*``, ``^``,
``~`` and ``<<`` wrap mod 2^64 there as on u64, right shifts go through the
logical ``_words.srl``, and ``mulhi64`` builds the high word from 32-bit
limbs whose products are taken as u64 bit patterns, their carries shifted
out logically. Scalars (seeds, ranges) are Python ints in [0, 2^64). The
``*_np`` forms of the BooPHF chain run on NumPy uint64 for the host
builder.
"""

from __future__ import annotations

import numpy as np
import torch

from ._words import M32, srl

M64 = (1 << 64) - 1

# the BooPHF single/multi hasher seed pair
BOOPHF_SEED0 = 0xAAAAAAAA55555555
BOOPHF_SEED1 = 0x33333333CCCCCCCC

_WYP0 = 0xA0761D6478BD642F
_WYP1 = 0xE7037ED1A0B428DB
_WYP2 = 0x8EBC6AF09C88C6E3
_WYP3 = 0x589965CC75374CC3
_WYP4 = 0x1D8E4E27C47D124F


def s64(x: int) -> int:
    """The int64 with the bits of u64 ``x``."""
    x &= M64
    return x - (1 << 64) if x >> 63 else x


# ---------------------------------------------------------------- torch


def simplehash64(key: torch.Tensor, seed: int) -> torch.Tensor:
    """SingleHashFunctor<uint64_t>: the BooPHF key mix, all mod 2^64."""
    h = int(seed) & M64
    init = s64(h << 7) ^ (key * s64(h >> 3)) ^ ~(s64(h << 11) + (key ^ s64(h >> 5)))
    h = init ^ s64(h)
    h = ~h + (h << 21)
    h = h ^ srl(h, 24)
    h = (h + (h << 3)) + (h << 8)
    h = h ^ srl(h, 14)
    h = (h + (h << 2)) + (h << 4)
    h = h ^ srl(h, 28)
    return h + (h << 31)


def multihash_h0(key: torch.Tensor):
    """Level-0 hash; returns (hash, state0, state1)."""
    h = simplehash64(key, BOOPHF_SEED0)
    return h, h, torch.full_like(h, s64(BOOPHF_SEED1))


def multihash_h1(state0: torch.Tensor, state1: torch.Tensor, key: torch.Tensor):
    h = simplehash64(key, BOOPHF_SEED1)
    return h, state0, h


def multihash_next(state0: torch.Tensor, state1: torch.Tensor):
    """One xorshift128+ step of the chain: (hash, state0', state1')."""
    s1, s0 = state0, state1
    s1 = s1 ^ (s1 << 23)
    s1 = s1 ^ s0 ^ srl(s1, 17) ^ srl(s0, 26)
    return s1 + s0, s0, s1


def mulhi64(a: torch.Tensor, b) -> torch.Tensor:
    """High 64 bits of the 128-bit product ``a * b`` (``b`` a tensor or a
    Python int), from 32-bit limbs."""
    a_lo, a_hi = a & M32, srl(a, 32)
    if isinstance(b, torch.Tensor):
        b_lo, b_hi = b & M32, srl(b, 32)
    else:
        b = int(b) & M64
        b_lo, b_hi = b & M32, b >> 32
    lo_lo = a_lo * b_lo
    hi_lo = a_hi * b_lo
    lo_hi = a_lo * b_hi
    cross = srl(lo_lo, 32) + (hi_lo & M32) + (lo_hi & M32)
    return a_hi * b_hi + srl(hi_lo, 32) + srl(lo_hi, 32) + srl(cross, 32)


def fast_range_64(word: torch.Tensor, p) -> torch.Tensor:
    """Map ``word`` into [0, p) multiplicatively (Lemire's fast range)."""
    return mulhi64(word, p)


def _wymum(a: torch.Tensor, b: int) -> torch.Tensor:
    """The 128-bit product folded to 64 bits: low word ^ high word."""
    return (a * s64(b)) ^ mulhi64(a, b)


def wyhash_u64(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """wyhash-v1 digest of the 8 little-endian bytes of each word: its tail
    reads the word as two 4-byte halves, a 32-bit rotation."""
    s = (int(seed) ^ _WYP0) & M64
    v = (x << 32) | srl(x, 32)
    return _wymum(_wymum(v ^ s64(s), s ^ _WYP1) ^ 8, _WYP4)


# ---------------------------------------------------------------- NumPy

U64 = np.uint64


def simplehash64_np(key: np.ndarray, seed: int) -> np.ndarray:
    h = U64(seed)
    key = np.asarray(key, dtype=np.uint64)
    init = (h << U64(7)) ^ (key * (h >> U64(3))) ^ (~((h << U64(11)) + (key ^ (h >> U64(5)))))
    h = h ^ init
    h = (~h) + (h << U64(21))
    h = h ^ (h >> U64(24))
    h = (h + (h << U64(3))) + (h << U64(8))
    h = h ^ (h >> U64(14))
    h = (h + (h << U64(2))) + (h << U64(4))
    h = h ^ (h >> U64(28))
    return h + (h << U64(31))


def multihash_h0_np(key: np.ndarray):
    h = simplehash64_np(key, BOOPHF_SEED0)
    return h, h, np.full_like(h, BOOPHF_SEED1)


def multihash_h1_np(state0: np.ndarray, state1: np.ndarray, key: np.ndarray):
    h = simplehash64_np(key, BOOPHF_SEED1)
    return h, state0, h


def multihash_next_np(state0: np.ndarray, state1: np.ndarray):
    s1, s0 = state0, state1
    s1 = s1 ^ (s1 << U64(23))
    s1 = s1 ^ s0 ^ (s1 >> U64(17)) ^ (s0 >> U64(26))
    return s1 + s0, s0, s1


def mulhi64_np(a: np.ndarray, b) -> np.ndarray:
    m = U64(M32)
    b = U64(int(b) & M64) if isinstance(b, int) else np.asarray(b, dtype=np.uint64)
    a_lo, a_hi = a & m, a >> U64(32)
    b_lo, b_hi = b & m, b >> U64(32)
    lo_lo = a_lo * b_lo
    hi_lo = a_hi * b_lo
    lo_hi = a_lo * b_hi
    cross = (lo_lo >> U64(32)) + (hi_lo & m) + (lo_hi & m)
    return a_hi * b_hi + (hi_lo >> U64(32)) + (lo_hi >> U64(32)) + (cross >> U64(32))


def fast_range_64_np(word: np.ndarray, p) -> np.ndarray:
    return mulhi64_np(word, p)


def wyhash_bytes(data: bytes, seed: int = 0) -> int:
    """Scalar wyhash-v1 over a byte buffer (a host oracle; the index only
    hashes 8-byte words)."""
    P0, P1, P2, P3, P4 = _WYP0, _WYP1, _WYP2, _WYP3, _WYP4

    def mum(a, b):
        r = (a & M64) * (b & M64)
        return ((r >> 64) ^ r) & M64

    def r4(b):
        return int.from_bytes(b[:4], "little")

    def r8(b):
        return int.from_bytes(b[:8], "little")

    n = len(data)
    s = seed & M64
    i = 0
    while i + 32 <= n:
        c = data[i : i + 32]
        s = mum(s ^ P0, mum(r8(c) ^ P1, r8(c[8:]) ^ P2) ^ mum(r8(c[16:]) ^ P3, r8(c[24:]) ^ P4))
        i += 32
    s ^= P0
    rest = n & 31
    if rest:
        t = data[n - rest :]
        if rest < 4:
            v = (t[0] << 16) | (t[rest >> 1] << 8) | t[rest - 1]
            s = mum(v ^ s, s ^ P1)
        elif rest <= 8:
            v = (r4(t) << 32) | r4(t[rest - 4 :])
            s = mum(v ^ s, s ^ P1)
        else:
            raise NotImplementedError("wyhash-v1 tails over 8 bytes are not reconstructed; "
                                      "the index only hashes 8-byte words")
    return mum(s ^ n, P4)
