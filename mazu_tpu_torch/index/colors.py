"""Color classes: unitig -> its deduplicated set of reference ids
(counterpart of ``mazu_tpu.index.colors``).

A unitig's color set is the set of distinct references it occurs on;
identical sets share one class. Host arrays: ``u2c`` int32 [n_unitigs]
class ids, ``offsets`` int64 [n_classes + 1] CSR bounds, ``refs`` int32
sorted reference ids a class. A query is the K2U, one ``u2c`` read, the
class's CSR window and one padded row of its references.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..convert import arrays_from_numpy
from ..pytree import meta
from .modindex import k2u_batch

_HASH_SEED = 0x5EED  # the row hashes' multipliers; a collision is caught, never trusted


def _occ_refs(table) -> np.ndarray:
    """int64 reference id of every occurrence of an occurrence table, in
    table order: from its words where it holds them (piscem or pf1), else
    decoded through ``unitig_table.decode_occs``."""
    from .unitig_table import DenseUnitigTable, PiscemUnitigTable, decode_occs

    if isinstance(table, PiscemUnitigTable):
        return (table.ctable.to_array() >> np.uint64(table.ref_shift)).astype(np.int64)
    if isinstance(table, DenseUnitigTable):
        return (table.ctable & np.uint64(0xFFFFFFFF)).astype(np.int64)
    total = int(np.asarray(table.offsets)[-1])
    d = arrays_from_numpy(table.device_arrays(), "cpu")
    return decode_occs(d, torch.arange(total, dtype=torch.int64))[0].numpy()


def _class_rows(cbits: np.ndarray):
    """(offsets, sorted reference ids) of the classes whose sets of up to
    64 references are the u64 words ``cbits``."""
    r = np.arange(64, dtype=np.uint64)
    member = ((cbits[:, None] >> r) & np.uint64(1)).astype(bool)
    coff = np.zeros(len(cbits) + 1, dtype=np.int64)
    np.cumsum(member.sum(axis=1), out=coff[1:])
    return coff, np.nonzero(member)[1].astype(np.int32)


def _bitset_classes(ref_id: np.ndarray, lens: np.ndarray, device):
    """(int32 class of each unitig, u64 reference set of each class) on
    ``device``: each unitig's set of up to 64 references (its distinct
    (unitig, reference) pairs, each adding its one bit), the distinct sets,
    numbered in the order of their first unitig."""
    dev = torch.device(device)
    n = len(lens)
    uid = torch.repeat_interleave(torch.arange(n, device=dev),
                                  torch.from_numpy(lens).to(dev))
    key = torch.unique(uid * 64 + torch.from_numpy(ref_id).to(dev))
    del uid
    bits = torch.zeros(n, dtype=torch.int64, device=dev)
    bits.index_add_(0, key >> 6, torch.ones_like(key) << (key & 63))
    del key
    vals, inv = torch.unique(bits, return_inverse=True)
    first = torch.full((vals.shape[0],), n, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, inv, torch.arange(n, device=dev), "amin")
    order = torch.argsort(first)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=dev)
    return (rank[inv].to(torch.int32).cpu().numpy(),
            vals[order].cpu().numpy().view(np.uint64))


def _group_rows(vals: np.ndarray, bounds: np.ndarray):
    """Group the rows ``vals[bounds[u]:bounds[u + 1]]``: (int32 group of each
    row, numbered in the order of each group's first row; that first row of
    each group). Rows are grouped by their length and two 64-bit hashes of
    their values, then every row is compared with its group's first row,
    value by value; where a hash collides, the rows are grouped one by one
    by their bytes instead."""
    n = len(bounds) - 1
    lens = np.diff(bounds)
    if n == 0:
        return np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int64)
    at = np.arange(len(vals), dtype=np.int64) - np.repeat(bounds[:-1], lens)
    rng = np.random.default_rng(_HASH_SEED)
    mult = rng.integers(1, 2**63, (2, int(lens.max(initial=0)) + 1), dtype=np.int64) | 1
    v = vals.astype(np.int64) + 1
    sig = np.empty((n, 3), dtype=np.int64)
    sig[:, 0] = lens
    with np.errstate(over="ignore"):
        for i in range(2):
            terms = v * mult[i][at]
            if len(terms):
                sig[:, 1 + i] = np.add.reduceat(terms, np.minimum(bounds[:-1], len(terms) - 1))
    sig[lens == 0, 1:] = 0
    by = np.lexsort((sig[:, 2], sig[:, 1], sig[:, 0]))  # stable: a run's first is its least row
    new = np.ones(n, dtype=bool)
    new[1:] = (sig[by][1:] != sig[by][:-1]).any(axis=1)
    first = by[new]  # each group's first row, groups in signature order
    group = np.empty(n, dtype=np.int64)
    group[by] = np.cumsum(new) - 1
    row_of = np.repeat(np.arange(n, dtype=np.int64), lens)
    if not (vals == vals[bounds[first[group]][row_of] + at]).all():
        return _group_rows_by_bytes(vals, bounds)
    order = np.argsort(first, kind="stable")  # groups by their first row
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return rank[group].astype(np.int32), first[order]


def _group_rows_by_bytes(vals: np.ndarray, bounds: np.ndarray):
    """``_group_rows`` one row at a time, keyed by the row's bytes."""
    seen: dict[bytes, int] = {}
    group = np.zeros(len(bounds) - 1, dtype=np.int32)
    first = []
    for u in range(len(bounds) - 1):
        key = vals[bounds[u] : bounds[u + 1]].tobytes()
        g = seen.setdefault(key, len(first))
        if g == len(first):
            first.append(u)
        group[u] = g
    return group, np.array(first, dtype=np.int64)


class ColorClasses:
    def __init__(self, u2c, offsets, refs, n_refs: int):
        self.u2c = np.asarray(u2c, dtype=np.int32)
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.refs = np.asarray(refs, dtype=np.int32)
        self.n_refs = int(n_refs)

    @classmethod
    def from_u2pos(cls, table, device=None) -> "ColorClasses":
        """Host build from an occurrence table: every occurrence's reference
        (``_occ_refs``), each unitig's row of distinct references in
        ascending order, and the unitigs grouped by their rows: a class a
        distinct row, numbered in the order of its first unitig. Up to 64
        references, a row is one 64-bit set of them, made and grouped on
        ``device`` (the host by default; ``_bitset_classes``); past that,
        the distinct (unitig, reference) pairs are sorted and the rows
        grouped by ``_group_rows``."""
        n = table.n_unitigs
        offsets = np.asarray(table.offsets, dtype=np.int64)
        total = int(offsets[-1])
        with trace.span("colors.build", unitigs=n, occurrences=total):
            ref_id = _occ_refs(table)
            n_refs = int(ref_id.max()) + 1 if total else 0
            lens = np.diff(offsets)
            if 0 < n_refs <= 64:
                u2c, cbits = _bitset_classes(ref_id, lens, device or "cpu")
                return cls(u2c, *_class_rows(cbits), n_refs)
            uid = np.repeat(np.arange(n, dtype=np.int64), lens)
            key = np.unique(uid * np.int64(max(n_refs, 1)) + ref_id)
            p_uid = key // max(n_refs, 1)
            p_ref = (key % max(n_refs, 1)).astype(np.int32)
            bounds = np.searchsorted(p_uid, np.arange(n + 1, dtype=np.int64))
            u2c, first = _group_rows(p_ref, bounds)
            rl = np.diff(bounds)[first]
            coff = np.zeros(len(first) + 1, dtype=np.int64)
            np.cumsum(rl, out=coff[1:])
            rows = np.repeat(bounds[first] - coff[:-1], rl) + np.arange(coff[-1])
            return cls(u2c, coff, p_ref[rows], n_refs)

    @property
    def n_classes(self) -> int:
        return len(self.offsets) - 1

    @property
    def n_unitigs(self) -> int:
        return len(self.u2c)

    def class_of(self, uid) -> np.ndarray:
        return self.u2c[np.asarray(uid, dtype=np.int64)]

    def refs_of_class(self, cid: int) -> np.ndarray:
        s, e = int(self.offsets[cid]), int(self.offsets[cid + 1])
        return self.refs[s:e]

    def max_class_size(self) -> int:
        if self.n_classes == 0:
            return 0
        return int(np.max(self.offsets[1:] - self.offsets[:-1]))

    def num_bits(self) -> int:
        return 8 * (self.u2c.nbytes + self.offsets.nbytes + self.refs.nbytes)

    def print_stats(self, log=print) -> None:
        log(f"color classes: {self.n_classes} over {self.n_unitigs} unitigs")
        log(f"  total class-refs: {len(self.refs)}")
        log(f"  bits/unitig: {self.num_bits() / max(1, self.n_unitigs):.2f}")

    def device_arrays(self) -> dict:
        """NumPy arrays for ``colors_lookup`` (``refs`` with one pad entry
        for clipped windows)."""
        return {
            "u2c": self.u2c,
            "offsets": self.offsets,
            "refs": np.concatenate([self.refs, np.zeros(1, dtype=np.int32)]),
            "meta": meta(
                n_classes=self.n_classes,
                n_unitigs=self.n_unitigs,
                n_refs=self.n_refs,
                max_class_size=self.max_class_size(),
            ),
        }

    def save(self, path: str) -> None:
        np.savez_compressed(path, u2c=self.u2c, offsets=self.offsets, refs=self.refs,
                            n_refs=np.int64(self.n_refs))

    @classmethod
    def load(cls, path: str) -> "ColorClasses":
        z = np.load(path)
        return cls(z["u2c"], z["offsets"], z["refs"], int(z["n_refs"]))


def colors_lookup(cc: dict, uid: torch.Tensor, max_refs: int):
    """(class id, reference ids padded to ``max_refs`` with 0, their valid
    mask, the class size) of unitig ids ``uid``; ``cc`` is
    ``ColorClasses.device_arrays()`` as tensors."""
    cid = cc["u2c"][uid].to(torch.int64)
    start = cc["offsets"][cid]
    cnt = cc["offsets"][cid + 1] - start
    j = torch.arange(max_refs, dtype=torch.int64, device=uid.device)
    idx = torch.clamp(start[:, None] + j[None, :], 0, cc["refs"].shape[0] - 1)
    refs = cc["refs"][idx]
    valid = j[None, :] < cnt[:, None]
    return cid, torch.where(valid, refs, 0), valid, cnt


def colors_batch(index_arrays: dict, cc: dict, fw: torch.Tensor, max_refs: int) -> dict:
    """k-mer words -> colors: the exact K2U, then ``colors_from_k2u``."""
    return colors_from_k2u(cc, k2u_batch(index_arrays, fw), max_refs)


def colors_from_k2u(cc: dict, r: dict, max_refs: int) -> dict:
    """Colors of per-lane K2U fields (``unitig_id``, ``mt``): a miss has
    class -1, no references and n_refs 0."""
    hit = r["mt"] > 0
    uid = torch.where(hit, r["unitig_id"], 0)
    cid, refs, valid, cnt = colors_lookup(cc, uid, max_refs)
    return {
        "mt": r["mt"],
        "unitig_id": r["unitig_id"],
        "class_id": torch.where(hit, cid, -1),
        "refs": torch.where(hit[:, None], refs, 0),
        "valid": valid & hit[:, None],
        "n_refs": torch.where(hit, cnt, 0),
    }
