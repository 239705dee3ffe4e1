"""32-bit key hashes and the BooPHF32 minimal perfect hash (counterpart of
``mazu_tpu.kphf.boophf32``).

murmur3 fmix32 and the two u64 -> u32 folds that address bucket tables,
and BooPHF32: levels of singleton bitmaps, each a power of two bits wide,
addressed by a 32-bit xorshift chain over a state folded from the u64
key, with a u32 block rank per 256 bits (or, in the ``mrows`` layout, each
word paired with its rank); keys no level places go to a sorted final
table. The torch forms take int64 values (or u64 bit patterns for the
folds) and keep every intermediate in [0, 2^32) by masking after each
multiply, add and left shift. ``BooPHF32.build`` runs its level loop on
the device; the ``*_np`` hashes are the host builders'.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._words import M32, mask32, popcount64, srl
from ..ops.derived import derived

_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLD = 0x9E3779B9
_BLOCK_BITS = 256  # a rank sample every 8 u32 words
_SIGN = -(1 << 63)
LOOKUP_CHUNK = 1 << 22  # keys per chunk of a host-side lookup


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


def key_fold32(keys: torch.Tensor):
    """u64 key (int64 bits) -> (s0, s1), the u32 chain state."""
    lo = keys & M32
    hi = srl(keys, 32)
    return mix32(lo ^ _GOLD), mix32(hi ^ _C1) ^ lo


def chain_next(s0: torch.Tensor, s1: torch.Tensor):
    """One xorshift step of the chain: (hash, s0', s1'), all u32 in int64."""
    t = s1 ^ ((s1 << 13) & M32)
    t = t ^ (t >> 17)
    t = t ^ s0 ^ (s0 >> 5)
    return (t + s0) & M32, s1, t


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as int32 tensors with the same low 32 bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


U32 = np.uint32
U64 = np.uint64


def mix32_np(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> U32(16))
    x = x * U32(_C1)
    x = x ^ (x >> U32(13))
    x = x * U32(_C2)
    return x ^ (x >> U32(16))


def unmix32_np(x: np.ndarray) -> np.ndarray:
    """The inverse of ``mix32_np``: the u32 words that mix to ``x``."""
    x = x ^ (x >> U32(16))
    x = x * U32(pow(_C2, -1, 1 << 32))
    x = x ^ (x >> U32(13)) ^ (x >> U32(26))
    x = x * U32(pow(_C1, -1, 1 << 32))
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


@dataclass
class BooPHF32:
    """Host-side BooPHF32 (``mazu_tpu.kphf.boophf32.BooPHF32``)."""

    n_elem: int
    last_bitset_rank: int
    levels: list  # [(n_bits, words u32[], ranks u32[] with the global offset)]
    fh_keys: np.ndarray  # sorted u64
    fh_vals: np.ndarray  # u32, already offset
    gamma: float = 1.7

    @classmethod
    def build(cls, keys, gamma: float = 1.7, max_levels: int = 12, device=None,
              chunk: int = 1 << 26) -> "BooPHF32":
        """Level by level, on ``device`` (the card by default; ``keys`` may
        be an int64 tensor, which stays on its own device unless ``device``
        is given): each remaining key hashes to one bit of a
        2^ceil(log2(gamma * remaining)) bit level; keys alone on their bit
        stay there, the rest go on. Keys left after ``max_levels`` levels
        take the final table. The reference's level loop, ``chunk`` keys at
        a time: the chain state is kept as u32 in int32, the bit counts in
        int32 (a level of 2^31 bits takes 8.6 GB), and a singleton's bit is
        added into its word, which equals an OR since singleton bits are
        distinct. Returns the host arrays."""
        from ..convert import resolve_device

        if isinstance(keys, torch.Tensor):
            dev = keys.device if device is None else resolve_device(device)
            rem = keys.to(dev)
        else:
            dev = resolve_device(device)
            rem = torch.from_numpy(
                np.ascontiguousarray(keys, dtype=np.uint64).view(np.int64)).to(dev)
        n = rem.shape[0]
        spans = [(a, min(a + chunk, n)) for a in range(0, n, chunk)]
        s0 = torch.empty(n, dtype=torch.int32, device=dev)
        s1 = torch.empty(n, dtype=torch.int32, device=dev)
        for a, b in spans:
            f0, f1 = key_fold32(rem[a:b])
            s0[a:b], s1[a:b] = _as_i32(f0), _as_i32(f1)
        levels = []
        for _ in range(max_levels):
            m = rem.shape[0]
            if m == 0:
                break
            n_bits = 1 << max(5, int(np.ceil(np.log2(max(gamma * m, 32)))))
            spans = [(a, min(a + chunk, m)) for a in range(0, m, chunk)]
            pos = torch.empty(m, dtype=torch.int32 if n_bits <= 1 << 31 else torch.int64,
                              device=dev)
            counts = torch.zeros(n_bits, dtype=torch.int32, device=dev)
            for a, b in spans:
                h, t0, t1 = chain_next(mask32(s0[a:b]), mask32(s1[a:b]))
                s0[a:b], s1[a:b] = _as_i32(t0), _as_i32(t1)
                p = h & (n_bits - 1)
                pos[a:b] = p
                counts.index_add_(0, p, torch.ones(b - a, dtype=torch.int32, device=dev))
            words = torch.zeros(n_bits // 32, dtype=torch.int64, device=dev)
            keep = torch.empty(m, dtype=torch.bool, device=dev)
            for a, b in spans:
                p = pos[a:b].to(torch.int64)
                single = counts[p] == 1
                sp = p[single]
                words.index_add_(0, sp >> 5, 1 << (sp & 31))
                keep[a:b] = ~single
            del pos, counts
            levels.append((n_bits, words))
            rem, s0, s1 = rem[keep], s0[keep], s1[keep]

        out_levels = []
        offset = 0
        for n_bits, words in levels:
            pc = popcount64(words & M32)
            blk = torch.nn.functional.pad(pc, (0, -pc.shape[0] % 8)).view(-1, 8).sum(1)
            ranks = offset + torch.cumsum(blk, 0) - blk
            out_levels.append((n_bits, (words & M32).cpu().numpy().astype(np.uint32),
                               ranks.cpu().numpy().astype(np.uint32)))
            offset += int(pc.sum())
        fh_keys = np.sort(rem.cpu().numpy().view(np.uint64))
        # a key's copies collide on every level, so they all reach this table
        if (fh_keys[1:] == fh_keys[:-1]).any():
            raise ValueError("BooPHF32 keys must be distinct")
        fh_vals = (np.arange(len(fh_keys)) + offset).astype(np.uint32)
        return cls(n, offset, out_levels, fh_keys, fh_vals, gamma)

    def lookup(self, keys: np.ndarray, device=None, chunk: int = LOOKUP_CHUNK) -> np.ndarray:
        """int32 values of ``keys`` (-1 for a definite miss): the torch
        ``boophf32_lookup`` on ``device`` (the card by default),
        ``chunk`` keys at a time."""
        from ..convert import arrays_from_numpy, resolve_device

        device = resolve_device(device)
        d = arrays_from_numpy(self.device_arrays(), device)
        keys = np.ascontiguousarray(keys, dtype=np.uint64).view(np.int64)
        out = np.empty(len(keys), dtype=np.int32)
        for s in range(0, len(keys), chunk):
            kt = torch.from_numpy(keys[s : s + chunk]).to(device)
            out[s : s + chunk] = boophf32_lookup(d, kt).cpu().numpy()
        return out

    def num_bits(self) -> int:
        nb = sum(32 * len(w) + 32 * len(r) for (_, w, r) in self.levels)
        return nb + 96 * len(self.fh_keys)

    def device_arrays(self, mrows: bool = False) -> dict:
        """The lean layout: ``words`` (each level padded to whole 256-bit
        blocks), ``ranks`` (one u32 per block), ``fh_keys``/``fh_vals``
        (one pad key 2^64-1 when the final table is empty) and the meta
        ``n_bits``/``word_offsets``/``rank_offsets`` per level. ``mrows``:
        the paired layout instead, u64 ``mrows[i] = words[i] | (ones in
        words[:i]) << 32``, a word with its global rank (the padding words
        are zero, so the running count over all levels is each level's rank
        offset plus its in-level rank); ``words`` and ``ranks`` are dropped."""
        from ..bits.bitvector import popcount_np
        from ..pytree import meta

        def padded(n_bits, w):
            out = np.zeros(-(-n_bits // _BLOCK_BITS) * 8, dtype=np.uint32)
            out[: len(w)] = w
            return out

        empty = np.zeros(0, dtype=np.uint32)
        words = np.concatenate([padded(n, w) for (n, w, _) in self.levels]) if self.levels else empty
        ranks = np.concatenate([r for (_, _, r) in self.levels]) if self.levels else empty
        if len(self.fh_keys) == 0:
            fh_keys = np.array([0xFFFFFFFFFFFFFFFF], dtype=np.uint64)
            fh_vals = np.array([0], dtype=np.uint32)
        else:
            fh_keys, fh_vals = self.fh_keys, self.fh_vals
        nb = tuple(int(n) for (n, _, _) in self.levels)
        blocks = [-(-n // _BLOCK_BITS) for n in nb]
        if mrows:
            pc = popcount_np(words).astype(np.uint64)
            below = np.concatenate([[0], np.cumsum(pc)[:-1]]).astype(np.uint64)
            d = {"mrows": words.astype(np.uint64) | (below << U64(32))}
        else:
            d = {"words": words, "ranks": ranks}
        d.update(fh_keys=fh_keys, fh_vals=fh_vals, meta=meta(
            kind="boophf32",
            n_bits=nb,
            word_offsets=tuple(int(x) for x in np.cumsum([0] + [8 * b for b in blocks])[:-1]),
            rank_offsets=tuple(int(x) for x in np.cumsum([0] + blocks)[:-1]),
        ))
        return d


def level_offsets(d: dict) -> torch.Tensor:
    """int64 [2, levels] on the words' device: each level's first word
    (``meta.word_offsets``) and first block rank (``meta.rank_offsets``) of
    a BooPHF (either width). Made once per words tensor (``derived``), so a
    lookup copies nothing from the host."""
    m = d["meta"]
    words = d["words"]
    return derived(words, "level offsets", lambda: torch.tensor(
        [m.word_offsets, m.rank_offsets], dtype=torch.int64, device=words.device))


def boophf32_lookup(d: dict, keys: torch.Tensor, level_limit: int | None = None):
    """Batched lookup (plain torch): int32 values, -1 for a definite miss.

    Each level costs one bit test; the hit level's value is its block rank
    plus the popcounts of the words before the hit bit in its block; on the
    ``mrows`` layout, the hit row's rank plus the popcount below the bit.
    Keys no level places are searched in the final table, in unsigned order.

    ``level_limit``: test only the first ``level_limit`` levels and skip
    the final table. Returns ``(values, unresolved)``: lanes no tested
    level placed are -1 and unresolved (deeper, in the final table, or a
    miss); a caller re-runs them through the full lookup."""
    m = d["meta"]
    n_levels = len(m.n_bits)
    n_test = n_levels if level_limit is None else min(max(int(level_limit), 1), n_levels)
    mrows = d.get("mrows")
    words = d["words"] if mrows is None else mrows
    hit_level = torch.full(keys.shape, -1, dtype=torch.int64, device=keys.device)
    hit_pos = torch.zeros_like(hit_level)
    hit_rank = torch.zeros_like(hit_level)
    s0, s1 = key_fold32(keys)
    for li in range(n_test):
        h, s0, s1 = chain_next(s0, s1)
        pos = h & (m.n_bits[li] - 1)
        word = words[m.word_offsets[li] + (pos >> 5)]
        bit = ((mask32(word) >> (pos & 31)) & 1) != 0
        newly = bit & (hit_level < 0)
        hit_level = torch.where(newly, li, hit_level)
        hit_pos = torch.where(newly, pos, hit_pos)
        if mrows is not None:  # the row carries the rank below its word
            off = pos & 31
            below = torch.where(off == 0, 0, mask32(word) & ((1 << off) - 1))
            hit_rank = torch.where(newly, srl(word, 32) + popcount64(below), hit_rank)
    res = torch.full(keys.shape, -1, dtype=torch.int32, device=keys.device)
    if mrows is not None:
        res = torch.where(hit_level >= 0, hit_rank, res).to(torch.int32)
    elif n_levels:
        lvl = torch.clamp(hit_level, 0, n_levels - 1)
        offsets = level_offsets(d)
        wo, ro = offsets[0][lvl], offsets[1][lvl]
        word_idx = hit_pos >> 5
        block_start = (hit_pos >> 8) << 3
        r = mask32(d["ranks"][ro + (hit_pos >> 8)])
        for i in range(7):
            wid = block_start + i
            r = r + torch.where(wid < word_idx, popcount64(mask32(words[wo + wid])), 0)
        off = hit_pos & 31
        below = torch.where(off == 0, 0, mask32(words[wo + word_idx]) & ((1 << off) - 1))
        r = r + popcount64(below)
        res = torch.where(hit_level >= 0, r, res).to(torch.int32)
    if level_limit is not None:
        return res, hit_level < 0
    fhk = d["fh_keys"]
    idx = torch.clamp(torch.searchsorted(fhk ^ _SIGN, keys ^ _SIGN), 0, fhk.shape[0] - 1)
    fh_hit = (fhk[idx] == keys) & (hit_level < 0)
    return torch.where(fh_hit, d["fh_vals"][idx], res)
