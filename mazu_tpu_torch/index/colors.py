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

from ..convert import arrays_from_numpy
from ..pytree import meta
from .modindex import k2u_batch


class ColorClasses:
    def __init__(self, u2c, offsets, refs, n_refs: int):
        self.u2c = np.asarray(u2c, dtype=np.int32)
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.refs = np.asarray(refs, dtype=np.int32)
        self.n_refs = int(n_refs)

    @classmethod
    def from_u2pos(cls, table) -> "ColorClasses":
        """Host build from an occurrence table: every occurrence decoded
        (``unitig_table.decode_occs``), the distinct (unitig, reference)
        pairs sorted, and each unitig's reference row looked up by its
        bytes (a Python loop over the unitigs)."""
        from .unitig_table import decode_occs

        n = table.n_unitigs
        offsets = np.asarray(table.offsets, dtype=np.int64)
        total = int(offsets[-1])
        d = arrays_from_numpy(table.device_arrays(), "cpu")
        ref_id = decode_occs(d, torch.arange(total, dtype=torch.int64))[0].numpy()
        uid = np.searchsorted(offsets, np.arange(total, dtype=np.int64), side="right") - 1
        n_refs = int(ref_id.max()) + 1 if total else 0
        key = np.unique(uid * np.int64(max(n_refs, 1)) + ref_id)
        p_uid = key // max(n_refs, 1)
        p_ref = (key % max(n_refs, 1)).astype(np.int32)
        bounds = np.searchsorted(p_uid, np.arange(n + 1, dtype=np.int64))
        classes: dict[bytes, int] = {}
        u2c = np.zeros(n, dtype=np.int32)
        class_rows: list[np.ndarray] = []
        for u in range(n):
            row = p_ref[bounds[u] : bounds[u + 1]]
            bkey = row.tobytes()
            cid = classes.get(bkey)
            if cid is None:
                cid = len(class_rows)
                classes[bkey] = cid
                class_rows.append(row)
            u2c[u] = cid
        lens = np.array([len(r) for r in class_rows], dtype=np.int64)
        coff = np.zeros(len(class_rows) + 1, dtype=np.int64)
        np.cumsum(lens, out=coff[1:])
        refs = np.concatenate(class_rows) if class_rows else np.zeros(0, dtype=np.int32)
        return cls(u2c, coff, refs, n_refs)

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
