"""U2Pos occurrence table: unitig id -> encoded reference occurrences
(counterpart of ``mazu_tpu.index.unitig_table``).

Encodings (same words as the reference package):
- pf1: ``|1b orientation|31b pos|32b ref_id|``
- piscem: ``ref_id << ref_shift | pos << 1 | is_fw`` at minimal widths

``ctable`` holds the encoded occurrences grouped by unitig and ``offsets``
the int64 prefix per unitig: ``DenseUnitigTable`` (pf1 words, pufferfish's
table) or ``PiscemUnitigTable`` (packed). The host tables and encoders are
NumPy; the decoders and ``fetch_occ_block`` are torch on int64 bit
patterns.
"""

from __future__ import annotations

import numpy as np
import torch

from .._words import M32, mask32, srl
from ..bits.intvector import IntVector, iv_get
from ..pytree import meta

U64 = np.uint64


def encode_pf1(ref_id, pos, o) -> np.ndarray:
    word = np.asarray(pos, dtype=np.uint64) | (np.asarray(o, dtype=np.uint64) << U64(31))
    return (word << U64(32)) | np.asarray(ref_id, dtype=np.uint64)


def required_num_bits(longest_ref: int, num_refs: int) -> tuple[int, int, int]:
    """(pos_bits, ref_bits, total) of the piscem packing."""
    pos_bits = max(1, int(longest_ref).bit_length())
    ref_bits = max(1, int(num_refs).bit_length())
    total = pos_bits + ref_bits + 1
    if total > 58:
        raise ValueError("piscem occurrence does not fit a packed word")
    return pos_bits, ref_bits, total


def encode_piscem(ref_id, pos, o, ref_shift: int) -> np.ndarray:
    e = np.asarray(ref_id, dtype=np.uint64) << U64(ref_shift)
    e = e | (np.asarray(pos, dtype=np.uint64) << U64(1))
    return e | np.asarray(o, dtype=np.uint64)


def decode_piscem(word: torch.Tensor, ref_shift: int, pos_mask: int):
    """(ref_id int64, pos int64, o int32) of piscem words."""
    ref_id = srl(word, ref_shift)
    pos = srl(word, 1) & int(pos_mask)
    return ref_id, pos, (word & 1).to(torch.int32)


def decode_pf1(word: torch.Tensor):
    """(ref_id int64, pos int64, o int32) of pf1 words."""
    posw = srl(word, 32)
    return word & M32, posw & 0x7FFFFFFF, (srl(posw, 31) & 1).to(torch.int32)


def _pair_rows(words: np.ndarray) -> np.ndarray:
    """``ctable2[i]`` = (word i, word i+1) as four u32: one row per pair of
    occurrences on the query path."""
    c = np.concatenate([np.asarray(words, dtype=np.uint64), np.zeros(1, dtype=np.uint64)])
    pair = np.ascontiguousarray(np.stack([c[:-1], c[1:]], axis=1))
    return pair.view(np.uint32).reshape(len(c) - 1, 4)


class DenseUnitigTable:
    """u64 occurrence table in the pf1 encoding (host), as pufferfish
    indexes store it."""

    def __init__(self, ctable: np.ndarray, offsets: np.ndarray, ref_names=None, ref_exts=None):
        self.ctable = np.asarray(ctable, dtype=np.uint64)
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.ref_names = ref_names or []
        self.ref_exts = ref_exts

    @property
    def n_unitigs(self) -> int:
        return len(self.offsets) - 1

    def max_occs(self) -> int:
        return int(np.max(np.diff(self.offsets))) if self.n_unitigs else 0

    def device_arrays(self) -> dict:
        return {
            "ctable": self.ctable,
            "offsets": self.offsets,
            "meta": meta(enc="pf1", n_occs=len(self.ctable)),
            "ctable2": _pair_rows(self.ctable),
        }


class PiscemUnitigTable:
    """Packed minimal-width occurrence table (host)."""

    def __init__(self, ctable: IntVector, offsets: np.ndarray, ref_shift: int, pos_mask: int, ref_names=None):
        self.ctable = ctable
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.ref_shift = int(ref_shift)
        self.pos_mask = int(pos_mask)
        self.ref_names = ref_names or []

    @property
    def n_unitigs(self) -> int:
        return len(self.offsets) - 1

    def max_occs(self) -> int:
        return int(np.max(np.diff(self.offsets))) if self.n_unitigs else 0

    def device_arrays(self) -> dict:
        return {
            "ctable": self.ctable.device_arrays(),
            "offsets": self.offsets,
            "meta": meta(
                enc="piscem",
                ref_shift=self.ref_shift,
                pos_mask=self.pos_mask,
                n_occs=len(self.ctable),
            ),
            "ctable2": _pair_rows(self.ctable.to_array()),
        }


def decode_words(u2pos: dict, words: torch.Tensor):
    """Decode already-fetched occurrence words (encoding from the meta)."""
    m = u2pos["meta"]
    if m.enc == "pf1":
        return decode_pf1(words)
    if m.enc == "piscem":
        return decode_piscem(words, m.ref_shift, m.pos_mask)
    raise ValueError(m.enc)


def decode_occs(u2pos: dict, occ_idx: torch.Tensor):
    """Decode the occurrences at flat table indices ``occ_idx``."""
    m = u2pos["meta"]
    if m.enc == "pf1":
        return decode_pf1(u2pos["ctable"][occ_idx])
    if m.enc == "piscem":
        return decode_piscem(iv_get(u2pos["ctable"], occ_idx), m.ref_shift, m.pos_mask)
    raise ValueError(f"the port has no {m.enc!r} occurrence table yet (ROADMAP A2)")


def fetch_occ_block(u2pos: dict, start: torch.Tensor, max_occs: int):
    """Decode ``max_occs`` consecutive occurrences from ``start`` per query,
    one ``ctable2`` pair row per two occurrences. Indices past the table
    clip to its last occurrence (callers mask by count)."""
    n_occs = u2pos["meta"].n_occs
    n_pairs = (max_occs + 1) // 2
    jj = torch.arange(n_pairs, dtype=start.dtype, device=start.device) * 2
    pair_idx = torch.clamp(start[:, None] + jj[None, :], 0, max(n_occs - 1, 0))
    r32 = u2pos["ctable2"][pair_idx]  # [N, n_pairs, 4] u32 bit patterns
    words = mask32(r32[..., 0::2]) | (mask32(r32[..., 1::2]) << 32)
    return decode_words(u2pos, words.reshape(r32.shape[0], 2 * n_pairs)[:, :max_occs])
