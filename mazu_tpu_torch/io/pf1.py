"""Readers for pufferfish (C++) serialized index files, the "pf1" format
(counterpart of ``mazu_tpu.io.pf1``; host, NumPy).

Layouts, all integers little-endian:
- sdsl "compact" int vector: ``static_flag u64, width u64, len u64,
  capacity u64``, then the packed u64 words (LSB first);
- cereal archives: a u64 count, then the elements (a string is a u64
  length and its bytes; u32 and u64 elements are raw);
- BooPHF: ``gamma f64, nb_levels i32, last_bitset_rank u64, n_elem u64``;
  per level ``n_bits u64, n_words u64, words u64[n_words], ranks_size u64,
  ranks u64[ranks_size]`` (a rank per 512 bits, offset by the ones of the
  levels before); then ``final_hash_size u64`` and that many (key u64,
  value u64) pairs.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from ..bits.bitvector import BitVector
from ..bits.intvector import IntVector
from ..bits.seqvector import SeqVector
from ..err import TruncatedFile

# file names of a pufferfish index directory
FP = dict(
    COMPLETE_REF_LENS="complete_ref_lens.bin",
    CTABLE="ctable.bin",
    CTG_OFFSETS="ctg_offsets.bin",
    DUPLICATE_CLUSTERS_TSV="duplicate_clusters.tsv",
    INFO_JSON="info.json",
    MPHF="mphf.bin",
    POS="pos.bin",
    SAMPLE_POS="sample_pos.bin",
    PRESENCE="presence.bin",
    EXTENSION_LENGTHS="extensionSize.bin",
    EXTENSION_BASES="extension.bin",
    DIRECTION="direction.bin",
    CANONICAL="canonical.bin",
    RANK="rank.bin",
    REF_ACCUM_LENS="refAccumLengths.bin",
    REF_INDEXING_LOG="ref_indexing.log",
    REF_LENS="reflengths.bin",
    REF_SEQ="refseq.bin",
    SEQ="seq.bin",
)


class PF1FilePaths:
    """Paths of the pufferfish index files in a directory, as attributes
    named by the lower-cased keys of ``FP``."""

    def __init__(self, dirname: str):
        self.prefix = dirname
        for attr, fname in FP.items():
            setattr(self, attr.lower(), os.path.join(dirname, fname))


def _read_exact(f, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise TruncatedFile(f"expected {n} bytes, got {len(b)}")
    return b


def read_u64(f) -> int:
    return int.from_bytes(_read_exact(f, 8), "little")


def read_i32(f) -> int:
    return int.from_bytes(_read_exact(f, 4), "little", signed=True)


def read_f64(f) -> float:
    return np.frombuffer(_read_exact(f, 8), dtype="<f8")[0]


def read_u64_array(f, n: int) -> np.ndarray:
    return np.frombuffer(_read_exact(f, 8 * n), dtype="<u8").copy()


def read_compact_int_vector(path: str) -> IntVector:
    """sdsl compact int vector file -> IntVector."""
    with open(path, "rb") as f:
        read_u64(f)  # static flag
        width = read_u64(f)
        if width == 0:
            raise ValueError(f"{path}: int vector of width 0")
        length = read_u64(f)
        read_u64(f)  # capacity
        words = np.frombuffer(f.read(), dtype="<u8").copy()
    return IntVector(words, length, width)


def read_compact_bit_vector(path: str) -> BitVector:
    iv = read_compact_int_vector(path)
    return BitVector(iv.words, iv.length * iv.width)


def read_compact_seq_vector(path: str) -> SeqVector:
    iv = read_compact_int_vector(path)
    if iv.width != 2:
        raise ValueError(f"{path}: sequence width {iv.width} != 2")
    return SeqVector(iv.words, iv.length)


def get_bits_per_element(path: str) -> int:
    """The element width a compact int vector file records (its second
    u64)."""
    with open(path, "rb") as f:
        read_u64(f)
        return read_u64(f)


def read_cereal_string_vec(f) -> list[str]:
    n = read_u64(f)
    return [_read_exact(f, read_u64(f)).decode() for _ in range(n)]


def read_cereal_u32_vec(f) -> np.ndarray:
    n = read_u64(f)
    return np.frombuffer(_read_exact(f, 4 * n), dtype="<u4").copy()


def read_cereal_u64_vec(f) -> np.ndarray:
    return read_u64_array(f, read_u64(f))


@dataclass
class RawBooPHF:
    """A parsed BooPHF.hpp serialization."""

    gamma: float
    last_bitset_rank: int
    n_elem: int
    # per level: (n_bits, words u64[], ranks u64[]); ranks sampled every
    # 512 bits, offset by the ones of the preceding levels
    levels: list = field(default_factory=list)
    final_hash: dict = field(default_factory=dict)


def read_boophf(path: str) -> RawBooPHF:
    with open(path, "rb") as f:
        gamma = read_f64(f)
        nb_levels = read_i32(f)
        last_bitset_rank = read_u64(f)
        n_elem = read_u64(f)
        levels = []
        for _ in range(nb_levels):
            n_bits = read_u64(f)
            n_words = read_u64(f)
            # C++ allocates n_bits/64 + 1 words; keep ceil(n_bits/64)
            words = read_u64_array(f, n_words)[: (n_bits + 63) // 64]
            ranks = read_u64_array(f, read_u64(f))
            levels.append((n_bits, words, ranks))
        final_hash = {}
        for _ in range(read_u64(f)):
            k = read_u64(f)
            v = read_u64(f)
            if k in final_hash:
                raise ValueError(f"{path}: final-hash key {k} twice")
            final_hash[k] = v
    return RawBooPHF(gamma, last_bitset_rank, n_elem, levels, final_hash)


def load_info_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def read_ctable(path: str):
    """ctable.bin: three cereal archives (ref_names, ref_exts, ctable u64)."""
    with open(path, "rb") as f:
        ref_names = read_cereal_string_vec(f)
        ref_exts = read_cereal_u32_vec(f)
        ctable = read_cereal_u64_vec(f)
        if f.read() != b"":
            raise ValueError(f"{path}: trailing bytes")
    return ref_names, ref_exts, ctable


def read_ref_accum_lens(path: str) -> np.ndarray:
    """refAccumLengths.bin -> the prefix sum with a leading 0."""
    with open(path, "rb") as f:
        v = read_cereal_u64_vec(f)
    return np.concatenate([[0], v]).astype(np.int64)
