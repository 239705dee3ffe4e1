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

from ._words import M32, srl, ule
from .kphf.boophf32 import mix32

_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F
_M8 = 0x00FF00FF00FF00FF
_M16 = 0x0000FFFF0000FFFF

_BASE_TO_CODE = np.full(256, 255, dtype=np.uint8)
for _b, _c in zip(b"ACGT", range(4)):
    _BASE_TO_CODE[_b] = _c
for _b, _c in zip(b"acgt", range(4)):
    _BASE_TO_CODE[_b] = _c
_CODE_TO_BASE = np.frombuffer(b"ACGT", dtype=np.uint8)


def mask2k(k: int) -> int:
    """Mask of the low 2k bits, as an int64-representable Python int."""
    k = int(k)
    return -1 if k >= 32 else (1 << (2 * k)) - 1


def seq_to_codes(seq: bytes | str) -> np.ndarray:
    """ASCII DNA -> uint8 base codes (255 for non-ACGT). Host-side."""
    if isinstance(seq, str):
        seq = seq.encode()
    return _BASE_TO_CODE[np.frombuffer(seq, dtype=np.uint8)]


def codes_to_seq(codes: np.ndarray) -> str:
    """2-bit base codes -> ASCII ACGT string. Host-side."""
    return _CODE_TO_BASE[np.asarray(codes, dtype=np.uint8)].tobytes().decode()


def kmer_from_str(s: str) -> np.uint64:
    """Pack an ASCII k-mer into a u64 word (first base in the low bits)."""
    codes = seq_to_codes(s)
    assert (codes < 4).all(), f"invalid base in {s!r}"
    w = 0
    for i, c in enumerate(codes):
        w |= int(c) << (2 * i)
    return np.uint64(w)


def kmer_to_str(w, k: int) -> str:
    """The k bases of a k-mer word (a u64 or its int64 bit pattern)."""
    w = int(w) & ((1 << 64) - 1)
    return "".join("ACGT"[(w >> (2 * i)) & 3] for i in range(int(k)))


def reverse_match_type(mt: torch.Tensor) -> torch.Tensor:
    """Swap identity and twin, keep no-match: the match type of the same
    hit seen from the reverse-complement query."""
    return torch.where(mt == 0, mt, mt ^ 3)


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


def word_equivalency(fw: torch.Tensor, rc: torch.Tensor, target: torch.Tensor, k: int) -> torch.Tensor:
    """Match type (uint8) of queries (fw, rc) against target words: 1 when
    fw equals the target's low 2k bits, else 2 when rc does, else 0."""
    t = target & mask2k(k)
    return torch.where(fw == t, 1, torch.where(rc == t, 2, 0)).to(torch.uint8)


_SPLIT_C1 = -0x40A7B892E31B1A47  # 0xBF58476D1CE4E5B9
_SPLIT_C2 = -0x6B2FB644ECCEEE15  # 0x94D049BB133111EB


def mix64(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """The seeded splitmix64-style finalizer of the ``mix64`` ordering
    (``mazu_tpu.kmer.mix64``), on int64 bit patterns: products wrap mod
    2^64 and every right shift is logical."""
    s = (int(seed) * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = x ^ (s - (1 << 64) if s >> 63 else s)
    z = (z ^ srl(z, 30)) * _SPLIT_C1
    z = (z ^ srl(z, 27)) * _SPLIT_C2
    return z ^ srl(z, 31)


ORDERINGS = ("mix32", "mix64", "wyhash")


def canonical_minimizer_batch(words: torch.Tensor, k: int, w: int, seed: int = 0,
                              ordering: str = "mix32"):
    """Canonical minimizer of each k-mer word (``mazu_tpu.kmer:182-249``).

    Over the k-w+1 w-mer windows of c = canonical(word), the minimizer
    minimizes the ordering's score, strictly, so the leftmost window wins
    ties: ``mix32`` scores mix32(low 32 bits of the window ^ seed), an
    unsigned u32 compare on masked int64; ``mix64`` scores
    ``mix64(window, seed)`` and ``wyhash`` ``hashes.wyhash_u64(window,
    seed)``, both compared as unsigned 64-bit words. ``offset`` is the
    window's position in the queried orientation: j if c is the forward
    word, else k - w - j.

    Returns (minimizer int64, offset int32, is_fw bool, canon int64)."""
    if ordering not in ORDERINGS:
        raise ValueError(f"unknown minimizer ordering {ordering!r}")
    k, w = int(k), int(w)
    canon, is_fw, _ = canonicalize(words, k)
    mw = mask2k(w)
    if ordering == "mix32":
        seed32 = int(seed) & M32

        def score(mv):
            return mix32((mv & M32) ^ seed32)
    elif ordering == "mix64":
        def score(mv):
            return mix64(mv, seed)
    else:
        from .hashes import wyhash_u64

        def score(mv):
            return wyhash_u64(mv, seed)
    best_val = best_score = best_j = None
    for j in range(k - w + 1):
        mv = srl(canon, 2 * j) & mw
        sc = score(mv)
        if best_val is None:
            best_val, best_score = mv, sc
            best_j = torch.zeros(sc.shape, dtype=torch.int32, device=sc.device)
        else:
            # mix32 scores lie in [0, 2^32): a signed compare is unsigned there
            better = (sc < best_score) if ordering == "mix32" else ~ule(best_score, sc)
            best_val = torch.where(better, mv, best_val)
            best_j = torch.where(better, j, best_j)
            best_score = torch.where(better, sc, best_score)
    offset = torch.where(is_fw, best_j, (k - w) - best_j).to(torch.int32)
    return best_val, offset, is_fw, canon


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
