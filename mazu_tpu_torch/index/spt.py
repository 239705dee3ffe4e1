"""Spectrum-preserving tiling: reference occurrences of each unitig (host;
counterpart of ``mazu_tpu.index.spt:28-41,99-112``)."""

from __future__ import annotations

import numpy as np

from ..bits.intvector import IntVector
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

    @property
    def num_refs(self) -> int:
        return len(self.ref_lens)

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
