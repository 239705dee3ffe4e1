"""k-mer words in plain PyTorch: the encoding that the benchmark's inputs
and its reference share.

A sequence is packed two bits a base (A, C, G, T = 0..3), 32 bases to an
int64 word, base i of the sequence at bits [2i, 2i + 2) of word i // 32,
with one zero guard word at the end. The word of the k-mer at base p holds
base p + j at bits [2j, 2j + 2), so a k-mer of k <= 31 bases is a
non-negative int64. Its reverse complement reads the complement bases in
the other order; its canonical form is the smaller of the two.
"""

from __future__ import annotations

import torch

_PAIRS = 0x3333333333333333
_NIBBLES = 0x0F0F0F0F0F0F0F0F
_BYTES = 0x00FF00FF00FF00FF
_HALVES = 0x0000FFFF0000FFFF
_LOW32 = 0x00000000FFFFFFFF


def mask(k: int) -> int:
    """The low 2k bits of a word."""
    return (1 << (2 * int(k))) - 1


def srl(x: torch.Tensor, s) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by ``s`` (an int or a
    tensor of shifts in 0..63)."""
    if isinstance(s, int):
        return x if s == 0 else (x >> s) & ((1 << (64 - s)) - 1)
    keep = torch.where(s == 0, -1, (torch.ones_like(x) << (64 - s).clamp(max=63)) - 1)
    return (x >> s) & keep


def revcomp(x: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complements of k-mer words."""
    x = ~x
    x = ((x >> 2) & _PAIRS) | ((x & _PAIRS) << 2)
    x = ((x >> 4) & _NIBBLES) | ((x & _NIBBLES) << 4)
    x = ((x >> 8) & _BYTES) | ((x & _BYTES) << 8)
    x = ((x >> 16) & _HALVES) | ((x & _HALVES) << 16)
    x = ((x >> 32) & _LOW32) | (x << 32)
    return srl(x, 64 - 2 * int(k)) & mask(k)


def canonical(x: torch.Tensor, k: int) -> torch.Tensor:
    """The smaller of each word and its reverse complement."""
    return torch.minimum(x, revcomp(x, k))


def kmer_at(words: torch.Tensor, pos: torch.Tensor, k: int) -> torch.Tensor:
    """The k-mer words at base positions ``pos`` of a packed sequence."""
    wi = pos >> 5
    sh = (pos & 31) * 2
    lo = srl(words[wi], sh)
    hi = torch.where(sh == 0, 0, words[wi + 1] << ((64 - sh) & 63))
    return (lo | hi) & mask(k)


def bases_at(words: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The 2-bit codes of the bases at ``pos``."""
    return srl(words[pos >> 5], (pos & 31) * 2) & 3


def words_of_codes(codes: torch.Tensor, k: int) -> torch.Tensor:
    """[R, L - k + 1] k-mer words of [R, L] rows of 2-bit codes."""
    L = codes.shape[1]
    out = torch.zeros(codes.shape[0], L - k + 1, dtype=torch.int64, device=codes.device)
    c = codes.to(torch.int64)
    for j in range(k):
        out |= c[:, j : j + L - k + 1] << (2 * j)
    return out
