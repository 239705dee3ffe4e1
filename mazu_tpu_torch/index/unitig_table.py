"""U2Pos occurrence table: unitig id -> encoded reference occurrences
(counterpart of ``mazu_tpu.index.unitig_table``).

Encodings (same words as the reference package):
- pf1: ``|1b orientation|31b pos|32b ref_id|``
- piscem: ``ref_id << ref_shift | pos << 1 | is_fw`` at minimal widths

``ctable`` holds the encoded occurrences grouped by unitig and ``offsets``
the int64 prefix per unitig: ``DenseUnitigTable`` (pf1 words, pufferfish's
table) or ``PiscemUnitigTable`` (packed); ``WMUnitigTable`` keeps the
piscem words as byte-plane wavelet matrices. The host tables and encoders
are NumPy; the decoders and ``fetch_occ_block`` are torch on int64 bit
patterns.
"""

from __future__ import annotations

import numpy as np
import torch

from .._words import M32, mask32, srl
from ..bits.intvector import IntVector, iv_get
from ..bits.wm import WaveletMatrix, WaveletMatrixSlice, wm_access
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
    c = np.asarray(words, dtype=np.uint64)
    pair = np.zeros((len(c), 2), dtype=np.uint64)
    pair[:, 0] = c
    pair[:-1, 1] = c[1:]
    return pair.view(np.uint32).reshape(len(c), 4)


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

    def num_bits(self) -> int:
        return 8 * (self.ctable.nbytes + self.offsets.nbytes)

    @property
    def n_total_occs(self) -> int:
        return len(self.ctable)

    def occs(self, uid: int):
        """(ref_id, pos, o) NumPy arrays of unitig ``uid``'s occurrences."""
        s, e = int(self.offsets[uid]), int(self.offsets[uid + 1])
        w = torch.from_numpy(np.ascontiguousarray(self.ctable[s:e]).view(np.int64))
        return tuple(x.numpy() for x in decode_pf1(w))

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

    def num_bits(self) -> int:
        return self.ctable.num_bits() + 8 * self.offsets.nbytes

    @property
    def n_total_occs(self) -> int:
        return len(self.ctable)

    def occs(self, uid: int):
        """(ref_id, pos, o) NumPy arrays of unitig ``uid``'s occurrences."""
        s, e = int(self.offsets[uid]), int(self.offsets[uid + 1])
        return _decoded(self.ctable.to_array()[s:e], self.ref_shift, self.pos_mask)

    @classmethod
    def from_dense(cls, dense: DenseUnitigTable, ref_lens=None) -> "PiscemUnitigTable":
        """Re-encode a pf1 table at the minimal piscem widths: the same
        occurrences, fewer bits (u32 words when the reference set is small
        enough, which a mono2 KCDict's occ32 slots need). The widths come
        from ``ref_lens`` when given, else from the occurrences."""
        words = np.asarray(dense.ctable, dtype=np.uint64)
        ref_id = (words & U64(M32)).astype(np.int64)
        posw = words >> U64(32)
        pos = (posw & U64(0x7FFFFFFF)).astype(np.int64)
        o = ((posw >> U64(31)) & U64(1)).astype(np.int64)
        if ref_lens is not None and len(ref_lens):
            longest, num_refs = int(np.max(ref_lens)), len(ref_lens)
        else:
            longest = int(pos.max()) + 1 if len(pos) else 1
            num_refs = int(ref_id.max()) + 1 if len(ref_id) else 1
        pos_bits, _ref_bits, total = required_num_bits(longest, num_refs)
        packed = encode_piscem(ref_id, pos, o, pos_bits + 1)
        return cls(IntVector.from_array(packed, width=total), dense.offsets, pos_bits + 1,
                   (1 << pos_bits) - 1, ref_names=dense.ref_names)

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


def _decoded(words: np.ndarray, ref_shift: int, pos_mask: int):
    """``decode_piscem`` of u64 NumPy words, as NumPy arrays."""
    w = torch.from_numpy(np.ascontiguousarray(words, dtype=np.uint64).view(np.int64))
    return tuple(x.numpy() for x in decode_piscem(w, ref_shift, pos_mask))


class WMUnitigTable:
    """The piscem occurrence words stored as byte-plane wavelet matrices
    (``mazu_tpu``'s ``WMUnitigTable``, the occurrence-table compression
    the reference keeps its wavelet matrix for): plane b holds byte b of
    every word, over an alphabet of its largest byte + 1, so a plane with
    few distinct bytes stores fewer levels. Decoding is one ``wm_access``
    a plane; ``unitig_slice`` is a window over one unitig's occurrences for
    symbol rank and select."""

    def __init__(self, planes, offsets, ref_shift: int, pos_mask: int, ref_names=None):
        self.planes = list(planes)
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.ref_shift = int(ref_shift)
        self.pos_mask = int(pos_mask)
        self.ref_names = ref_names or []

    @classmethod
    def from_piscem(cls, t: PiscemUnitigTable) -> "WMUnitigTable":
        words = t.ctable.to_array()
        planes = []
        for b in range(max(1, -(-t.ctable.width // 8))):
            plane = ((words >> U64(8 * b)) & U64(0xFF)).astype(np.uint8)
            alpha = max(2, int(plane.max()) + 1) if len(plane) else 2
            planes.append(WaveletMatrix.build(plane, alpha))
        return cls(planes, t.offsets, t.ref_shift, t.pos_mask, ref_names=t.ref_names)

    @property
    def n_unitigs(self) -> int:
        return len(self.offsets) - 1

    @property
    def n_total_occs(self) -> int:
        return len(self.planes[0]) if self.planes else 0

    def max_occs(self) -> int:
        return int(np.max(self.offsets[1:] - self.offsets[:-1])) if self.n_unitigs else 0

    def num_bits(self) -> int:
        return sum(p.num_bits() for p in self.planes) + 64 * len(self.offsets)

    def _words(self, idx: np.ndarray) -> np.ndarray:
        w = np.zeros(len(idx), dtype=np.uint64)
        for b, p in enumerate(self.planes):
            w |= p.access(idx).astype(np.uint64) << U64(8 * b)
        return w

    def occs(self, uid: int):
        """(ref_id, pos, o) NumPy arrays of unitig ``uid``'s occurrences."""
        s, e = int(self.offsets[uid]), int(self.offsets[uid + 1])
        return _decoded(self._words(np.arange(s, e)), self.ref_shift, self.pos_mask)

    def unitig_slice(self, uid: int, plane: int = 0):
        """The ``WaveletMatrixSlice`` of byte plane ``plane`` over unitig
        ``uid``'s occurrences."""
        return WaveletMatrixSlice(self.planes[plane], int(self.offsets[uid]),
                                  int(self.offsets[uid + 1]))

    def device_arrays(self, paired: bool = False) -> dict:
        """The planes' arrays (``wm0``...) and the offsets; ``paired`` is
        taken for the other tables' signature and changes nothing: the
        table has no pair rows, so the projection decodes through
        ``decode_occs``."""
        d = {
            "offsets": self.offsets,
            "meta": meta(enc="wm", n_planes=len(self.planes), ref_shift=self.ref_shift,
                         pos_mask=self.pos_mask, n_occs=self.n_total_occs),
        }
        for b, p in enumerate(self.planes):
            d[f"wm{b}"] = p.device_arrays()
        return d


def needs_ctable(u2pos, what: str) -> None:
    """Raise by name where ``what`` reads a table's ``ctable``, which a
    ``WMUnitigTable`` does not hold (the reference fails there too, with an
    ``AttributeError``)."""
    if isinstance(u2pos, WMUnitigTable):
        raise ValueError(f"{what} reads the occurrence words of a ctable: a WMUnitigTable "
                         "holds byte-plane wavelet matrices")


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
    if m.enc == "wm":
        words = torch.zeros_like(occ_idx)
        for b in range(m.n_planes):
            words = words | (wm_access(u2pos[f"wm{b}"], occ_idx) << (8 * b))
        return decode_piscem(words, m.ref_shift, m.pos_mask)
    raise ValueError(m.enc)


def fetch_occ_block(u2pos: dict, start: torch.Tensor, max_occs: int):
    """Decode ``max_occs`` consecutive occurrences from ``start`` per query,
    one ``ctable2`` pair row per two occurrences (without pair rows, a
    wavelet-matrix table, through ``decode_occs``). Indices past the table
    clip to its last occurrence (callers mask by count)."""
    n_occs = u2pos["meta"].n_occs
    if "ctable2" not in u2pos:
        j = torch.arange(max_occs, dtype=start.dtype, device=start.device)
        return decode_occs(u2pos, torch.clamp(start[:, None] + j[None, :], 0, max(n_occs - 1, 0)))
    n_pairs = (max_occs + 1) // 2
    jj = torch.arange(n_pairs, dtype=start.dtype, device=start.device) * 2
    pair_idx = torch.clamp(start[:, None] + jj[None, :], 0, max(n_occs - 1, 0))
    r32 = u2pos["ctable2"][pair_idx]  # [N, n_pairs, 4] u32 bit patterns
    words = mask32(r32[..., 0::2]) | (mask32(r32[..., 1::2]) << 32)
    return decode_words(u2pos, words.reshape(r32.shape[0], 2 * n_pairs)[:, :max_occs])
