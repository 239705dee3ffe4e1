"""Spectrum-preserving tiling: reference occurrences of each unitig (host;
counterpart of ``mazu_tpu.index.spt``).

``SPT.from_cf`` reads cuttlefish output. A reference is a sequence of
tiles: consecutive unitigs overlap by k - 1 bases, and a polyN gap of n
bases advances the cursor by n, plus k - 1 when the tile before it was a
unitig.
"""

from __future__ import annotations

import numpy as np

from ..bits.intvector import IntVector
from ..containers.refseq import RefSeqCollection
from ..containers.unitig_set import UnitigSet
from .unitig_table import (
    DenseUnitigTable, PiscemUnitigTable, encode_pf1, encode_piscem, required_num_bits,
)


class SPT:
    def __init__(self, unitigs: UnitigSet, ref_names, occ_uid, occ_ref, occ_pos, occ_o, ref_lens):
        self.unitigs = unitigs
        self.ref_names = list(ref_names)
        # occurrences grouped by unitig id, in tiling order within a unitig
        order = np.argsort(occ_uid, kind="stable")
        self.occ_uid = occ_uid[order]
        self.occ_ref = occ_ref[order]
        self.occ_pos = occ_pos[order]
        self.occ_o = occ_o[order]
        self.ref_lens = np.asarray(ref_lens, dtype=np.int64)
        self.offsets = np.concatenate(
            [[0], np.cumsum(np.bincount(occ_uid, minlength=unitigs.n_unitigs))]
        ).astype(np.int64)

    @classmethod
    def from_cf(cls, cf_files) -> "SPT":
        """The unitigs and tilings of cuttlefish output
        (``io.cuttlefish.CfFiles``)."""
        from ..io.cuttlefish import iter_tiling

        unitigs, cfid2uid = UnitigSet.from_cf(cf_files)
        k = unitigs.k
        ref_names, ref_lens = [], []
        uids, refs, poss, os_ = [], [], [], []
        for ref_id, (name, tokens) in enumerate(iter_tiling(cf_files)):
            ref_names.append(name)
            pos = 0
            prev_was_unitig = False
            for t in tokens:
                if not t.is_unitig:
                    pos += t.n + (k - 1 if prev_was_unitig else 0)
                    prev_was_unitig = False
                else:
                    uid = cfid2uid[t.id]
                    uids.append(uid)
                    refs.append(ref_id)
                    poss.append(pos)
                    os_.append(t.o)
                    pos += int(unitigs.unitig_len(uid)) - k + 1
                    prev_was_unitig = True
            ref_lens.append(pos + k - 1 if prev_was_unitig else pos)
        arrays = (np.array(a, dtype=np.int64) for a in (uids, refs, poss, os_))
        return cls(unitigs, ref_names, *arrays, ref_lens)

    @property
    def n_total_occs(self) -> int:
        return len(self.occ_uid)

    @property
    def k(self) -> int:
        return self.unitigs.k

    @property
    def num_refs(self) -> int:
        return len(self.ref_lens)

    def get_occ(self, uid: int, i: int) -> tuple:
        """(ref_id, pos, o) of occurrence ``i`` of unitig ``uid``."""
        p = int(self.offsets[uid]) + i
        return (int(self.occ_ref[p]), int(self.occ_pos[p]), int(self.occ_o[p]))

    def ref_seq_collection(self) -> RefSeqCollection:
        """The references' lengths and names (no sequence)."""
        return RefSeqCollection.from_lens(self.ref_lens, self.ref_names)

    def dense_table(self) -> DenseUnitigTable:
        """pf1-encoded u64 occurrence table (pufferfish's dense index)."""
        ctable = encode_pf1(self.occ_ref, self.occ_pos, self.occ_o)
        return DenseUnitigTable(ctable, self.offsets, self.ref_names)

    def piscem_table(self) -> PiscemUnitigTable:
        """Minimal-width packed occurrence table."""
        max_ref_len = int(self.ref_lens.max()) if len(self.ref_lens) else 1
        pos_bits, _ref_bits, total = required_num_bits(max_ref_len, self.num_refs)
        ref_shift = pos_bits + 1
        words = encode_piscem(self.occ_ref, self.occ_pos, self.occ_o, ref_shift)
        return PiscemUnitigTable(
            IntVector.from_array(words, width=total),
            self.offsets,
            ref_shift,
            (1 << pos_bits) - 1,
            self.ref_names,
        )
