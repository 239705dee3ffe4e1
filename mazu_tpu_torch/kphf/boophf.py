"""The 64-bit BBHash minimal perfect hash, BooPHF (counterpart of
``mazu_tpu.kphf.boophf``).

Levels of singleton bitmaps, each ``max(64, ceil(gamma * remaining / 64) *
64)`` bits wide, addressed by the 64-bit ``hashes.multihash_*`` chain and
``fast_range_64``; a u64 rank per 512 bits carries the ones of all earlier
levels, so a placed key's value is its level's block rank plus the ones
before its bit in the block. Keys no level places go to a sorted final
table. The same structure as pufferfish's ``mphf.bin`` (``from_pf1``), and
the same values for its keys.

``BooPHF.build`` is the NumPy level loop of the reference; ``lookup`` runs
the torch ``boophf_lookup`` on a device in chunks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._words import popcount64
from ..hashes import (
    fast_range_64, fast_range_64_np, multihash_h0, multihash_h0_np, multihash_h1,
    multihash_h1_np, multihash_next, multihash_next_np,
)
from ..io.pf1 import RawBooPHF, read_boophf
from .boophf32 import level_offsets

_BLOCK_BITS = 512  # a rank sample every 8 u64 words
_SIGN = -(1 << 63)
LOOKUP_CHUNK = 1 << 22  # keys per chunk of a host-side lookup


def _chain(li: int, keys, s0, s1, h0, h1, step):
    """Level ``li``'s hash and the chain state after it."""
    if li == 0:
        return h0(keys)
    if li == 1:
        return h1(s0, s1, keys)
    return step(s0, s1)


@dataclass
class BooPHF:
    """Host-side BooPHF (``mazu_tpu.kphf.boophf.BooPHF``)."""

    n_elem: int
    last_bitset_rank: int
    levels: list  # [(n_bits, words u64[], ranks u64[] with the global offset)]
    fh_keys: np.ndarray  # sorted u64
    fh_vals: np.ndarray  # u64, already offset by last_bitset_rank
    gamma: float = 1.7

    @classmethod
    def from_raw(cls, raw: RawBooPHF) -> "BooPHF":
        items = sorted(raw.final_hash.items())
        return cls(
            n_elem=raw.n_elem,
            last_bitset_rank=raw.last_bitset_rank,
            levels=[(int(n), w, r) for (n, w, r) in raw.levels],
            fh_keys=np.array([k for k, _ in items], dtype=np.uint64),
            fh_vals=np.array([v + raw.last_bitset_rank for _, v in items], dtype=np.uint64),
            gamma=raw.gamma,
        )

    @classmethod
    def from_pf1(cls, path: str) -> "BooPHF":
        return cls.from_raw(read_boophf(path))

    @classmethod
    def build(cls, keys: np.ndarray, gamma: float = 1.7, max_levels: int = 16) -> "BooPHF":
        """Level by level over distinct u64 keys: each remaining key hashes
        to one bit of the level; keys alone on their bit stay there, the
        rest go on. Keys left after ``max_levels`` take the final table, in
        sorted order."""
        keys = np.asarray(keys, dtype=np.uint64)
        n = len(keys)
        rem = keys
        s0 = s1 = None
        levels = []
        for li in range(max_levels):
            if len(rem) == 0:
                break
            h, s0, s1 = _chain(li, rem, s0, s1, multihash_h0_np, multihash_h1_np,
                               multihash_next_np)
            n_bits = max(64, -(-int(gamma * len(rem)) // 64) * 64)
            pos = fast_range_64_np(h, n_bits).astype(np.int64)
            singleton = np.bincount(pos, minlength=n_bits)[pos] == 1
            bits = np.zeros(n_bits, dtype=bool)
            bits[pos[singleton]] = True
            # bit i of word i >> 6 at position i & 63 (little-endian bytes)
            words = np.packbits(bits.reshape(-1, 8)[:, ::-1]).view(np.uint64)
            levels.append((n_bits, words))
            keep = ~singleton
            rem, s0, s1 = rem[keep], s0[keep], s1[keep]

        from ..bits.bitvector import popcount_np

        out_levels = []
        offset = 0
        wpb = _BLOCK_BITS // 64
        for n_bits, words in levels:
            pc = popcount_np(words).astype(np.int64)
            blk = np.add.reduceat(pc, np.arange(0, len(pc), wpb))
            ranks = (offset + np.concatenate([[0], np.cumsum(blk[:-1])])).astype(np.uint64)
            out_levels.append((n_bits, words, ranks))
            offset += int(pc.sum())
        if offset + len(rem) != n:
            raise ValueError("BooPHF keys must be distinct")
        fh_keys = np.sort(rem)
        fh_vals = np.arange(len(rem), dtype=np.uint64) + np.uint64(offset)
        return cls(n, offset, out_levels, fh_keys, fh_vals, gamma)

    def lookup(self, keys: np.ndarray, device=None, chunk: int = LOOKUP_CHUNK) -> np.ndarray:
        """int64 values of ``keys`` (-1 for a definite miss): the torch
        ``boophf_lookup`` on ``device`` (the card by default), ``chunk``
        keys at a time."""
        from ..convert import arrays_from_numpy, resolve_device

        device = resolve_device(device)
        d = arrays_from_numpy(self.device_arrays(), device)
        keys = np.ascontiguousarray(keys, dtype=np.uint64).view(np.int64)
        out = np.empty(len(keys), dtype=np.int64)
        for s in range(0, len(keys), chunk):
            kt = torch.from_numpy(keys[s : s + chunk]).to(device)
            out[s : s + chunk] = boophf_lookup(d, kt).cpu().numpy()
        return out

    def num_bits(self) -> int:
        nb = sum(64 * len(w) + 64 * len(r) for (_, w, r) in self.levels)
        return nb + 128 * len(self.fh_keys)

    def device_arrays(self) -> dict:
        """``words`` (each level padded to whole 512-bit blocks, so the
        in-block scan stays inside its level), ``ranks`` (one u64 per
        block), ``fh_keys``/``fh_vals`` (one pad key 2^64-1 when the final
        table is empty) and the meta ``n_bits``/``word_offsets``/
        ``rank_offsets`` per level."""
        from ..pytree import meta

        def padded(n_bits, w):
            out = np.zeros(-(-n_bits // _BLOCK_BITS) * 8, dtype=np.uint64)
            out[: len(w)] = w
            return out

        empty = np.zeros(0, dtype=np.uint64)
        words = np.concatenate([padded(n, w) for (n, w, _) in self.levels]) if self.levels else empty
        ranks = np.concatenate([r for (_, _, r) in self.levels]) if self.levels else empty
        if len(self.fh_keys) == 0:
            fh_keys = np.array([0xFFFFFFFFFFFFFFFF], dtype=np.uint64)
            fh_vals = np.array([0], dtype=np.uint64)
        else:
            fh_keys, fh_vals = self.fh_keys, self.fh_vals
        nb = tuple(int(n) for (n, _, _) in self.levels)
        blocks = [-(-n // _BLOCK_BITS) for n in nb]
        return {
            "words": words,
            "ranks": ranks,
            "fh_keys": fh_keys,
            "fh_vals": fh_vals,
            "meta": meta(
                kind="boophf",
                n_bits=nb,
                word_offsets=tuple(int(x) for x in np.cumsum([0] + [8 * b for b in blocks])[:-1]),
                rank_offsets=tuple(int(x) for x in np.cumsum([0] + [len(r) for (_, _, r)
                                                                     in self.levels])[:-1]),
            ),
        }


def _level_rank(d: dict, wo, ro, pos: torch.Tensor) -> torch.Tensor:
    """Global rank of bit ``pos`` of the level whose words start at ``wo``
    and block ranks at ``ro`` (ints or per-lane tensors): the block's rank,
    the ones of the words before ``pos``'s in its block (at most 7), and
    the ones below ``pos`` in its word. The in-word mask is
    ``(1 << off) - 1``, 0 at off == 0."""
    words = d["words"]
    word_idx = pos >> 6
    block_start = (pos >> 9) << 3
    r = d["ranks"][ro + (pos >> 9)]
    for i in range(7):
        wid = block_start + i
        r = r + torch.where(wid < word_idx, popcount64(words[wo + wid]), 0)
    return r + popcount64(words[wo + word_idx] & ((1 << (pos & 63)) - 1))


def boophf_lookup(d: dict, keys: torch.Tensor) -> torch.Tensor:
    """Batched lookup (plain torch): int64 values, -1 for a definite miss
    (no level bit set and not in the final table). A foreign key may get
    any in-range value.

    Every level is tested for every key (one bit test each); the rank runs
    once, at the first level that placed the key. Keys no level placed are
    searched in the final table, in unsigned order (``fh_keys ^ 2^63`` is
    sorted in signed order), so the empty table's pad key 2^64-1 is found
    only for the key 2^64-1 itself."""
    m = d["meta"]
    n_levels = len(m.n_bits)
    words = d["words"]
    hit_level = torch.full(keys.shape, -1, dtype=torch.int64, device=keys.device)
    hit_pos = torch.zeros_like(hit_level)
    s0 = s1 = None
    for li in range(n_levels):
        h, s0, s1 = _chain(li, keys, s0, s1, multihash_h0, multihash_h1, multihash_next)
        pos = fast_range_64(h, m.n_bits[li])
        bit = ((words[m.word_offsets[li] + (pos >> 6)] >> (pos & 63)) & 1) != 0
        newly = bit & (hit_level < 0)
        hit_level = torch.where(newly, li, hit_level)
        hit_pos = torch.where(newly, pos, hit_pos)
    res = torch.full(keys.shape, -1, dtype=torch.int64, device=keys.device)
    if n_levels:
        lvl = torch.clamp(hit_level, 0, n_levels - 1)
        offsets = level_offsets(d)
        wo, ro = offsets[0][lvl], offsets[1][lvl]
        res = torch.where(hit_level >= 0, _level_rank(d, wo, ro, hit_pos), res)
    fhk = d["fh_keys"]
    idx = torch.clamp(torch.searchsorted(fhk ^ _SIGN, keys ^ _SIGN), 0, fhk.shape[0] - 1)
    fh_hit = (fhk[idx] == keys) & (hit_level < 0)
    return torch.where(fh_hit, d["fh_vals"][idx], res)
