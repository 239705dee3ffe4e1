"""Synthetic index and queries from a seed (host; counterpart of
``bench.py::build_synthetic``).

A random genome is cut into 10 kb unitigs, each its own reference. Every
16th unitig also occurs twice more, in mixed orientation, on other
references, so it has 3 occurrences: more than the 2 a mono2 row carries,
and queries on it take the padded phase 2. Occurrence positions lie inside
the reference lengths, so the packed occurrence words stay below 2^32 and
the dictionary keeps its occ32 layout.
"""

from __future__ import annotations

import numpy as np

from .bits.seqvector import SeqVector
from .containers.refseq import RefSeqCollection
from .containers.unitig_set import UnitigSet
from .index.modindex import ModIndex
from .index.spt import SPT
from .kmer import revcomp_np
from .kphf.kcdict import KCDict

K = 31
PIECE = 10_000  # unitig (and reference) length
EXTRA_EVERY = 16  # every 16th unitig gets 2 extra occurrences
LOAD = 0.25  # keys per slot of the mono2 bucket table
RC_SHARE = 0.5  # queries reverse-complemented
FOREIGN_SHARE = 0.05  # queries replaced by random 62-bit words


def build_synthetic(n_bases: int, seed: int = 0):
    """(UnitigSet, RefSeqCollection, PiscemUnitigTable) of a random genome."""
    rng = np.random.default_rng(seed)
    sv = SeqVector.from_codes(rng.integers(0, 4, n_bases, dtype=np.uint8))
    n = n_bases // PIECE
    if n < 3:
        raise ValueError(f"need at least 3 unitigs of {PIECE} bases")
    accum = np.arange(n + 1, dtype=np.int64) * PIECE
    unitigs = UnitigSet(K, sv, accum)
    names = [f"r{i}" for i in range(n)]
    multi = np.repeat(np.arange(0, n, EXTRA_EVERY, dtype=np.int64), 2)
    j = np.arange(len(multi), dtype=np.int64) % 2
    spt = SPT(
        unitigs,
        names,
        np.concatenate([np.arange(n), multi]),
        np.concatenate([np.arange(n), (multi + 1 + j) % n]),
        np.concatenate([np.zeros(n, dtype=np.int64), rng.integers(0, PIECE, len(multi))]),
        np.concatenate([np.ones(n, dtype=np.int64), j]),
        np.full(n, PIECE, dtype=np.int64),
    )
    return unitigs, RefSeqCollection(sv, accum, names), spt.piscem_table()


def build_index(n_bases: int, seed: int = 0) -> ModIndex:
    """The mono2-occ32 KCDict index over ``build_synthetic``."""
    unitigs, refs, u2pos = build_synthetic(n_bases, seed)
    k2u = KCDict.from_unitig_set(unitigs, u2pos, load=LOAD)
    return ModIndex(k2u, u2pos, refs, index_type="Piscem-synth")


def sample_queries(unitigs: UnitigSet, n: int, seed: int) -> np.ndarray:
    """uint64 k-mer words: uniform (unitig, offset) samples over the whole
    index, a ``RC_SHARE`` reverse-complemented, and a ``FOREIGN_SHARE``
    replaced by random 62-bit words (misses)."""
    rng = np.random.default_rng(seed)
    k = unitigs.k
    uid = rng.integers(0, unitigs.n_unitigs, n)
    off = rng.integers(0, unitigs.unitig_len(uid) - k + 1)
    words = unitigs.get_kmer_u64(unitigs.accum[uid] + off)
    flip = rng.random(n) < RC_SHARE
    words[flip] = revcomp_np(words[flip], k)
    foreign = rng.random(n) < FOREIGN_SHARE
    words[foreign] = rng.integers(0, 1 << 62, int(foreign.sum()), dtype=np.uint64)
    return words
