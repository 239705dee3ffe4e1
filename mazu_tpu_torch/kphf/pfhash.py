"""PFHash: pufferfish's dense k-mer dictionary (counterpart of
``mazu_tpu.kphf.pfhash``).

An MPHF over every canonical k-mer and a packed vector of useq positions
in MPHF order. A query hashes its canonical word, reads the position,
fetches the k-mer there and checks it against the query in both
orientations; the position's unitig comes from the boundary bitvector.
The build is NumPy except the MPHF lookup of every k-mer, which runs on a
device; ``pfhash_k2u`` is plain torch.
"""

from __future__ import annotations

import numpy as np
import torch

from .._words import umin
from ..bits.bitvector import bv_rank
from ..bits.intvector import IntVector, iv_get
from ..containers.unitig_set import us_get_kmer
from ..kmer import revcomp, revcomp_np, word_equivalency
from ..pytree import meta
from .boophf import BooPHF


class PFHash:
    def __init__(self, unitigs, mphf: BooPHF, pos: IntVector):
        self.unitigs = unitigs
        self.mphf = mphf
        self.pos = pos

    @classmethod
    def from_unitig_set(cls, unitigs, gamma: float = 1.7, device=None) -> "PFHash":
        """A 64-bit BooPHF over all canonical k-mers, then each k-mer's
        global start position scattered to its MPHF value. The lookup of
        every k-mer runs on ``device``, the card by default."""
        kpos = unitigs.kmer_start_positions()
        words = unitigs.get_kmer_u64(kpos)
        canon = np.minimum(words, revcomp_np(words, unitigs.k))
        del words
        mphf = BooPHF.build(canon, gamma=gamma)
        h = mphf.lookup(canon, device=device)
        if (h < 0).any():
            raise RuntimeError("the k-mer MPHF misses one of its own keys")
        posv = np.zeros(len(kpos), dtype=np.uint64)
        posv[h] = kpos.astype(np.uint64)
        return cls(unitigs, mphf, IntVector.from_array(posv))

    @property
    def k(self) -> int:
        return self.unitigs.k

    @property
    def n_kmers(self) -> int:
        return self.unitigs.n_kmers

    def num_bits(self) -> int:
        return self.unitigs.num_bits() + self.mphf.num_bits() + self.pos.num_bits()

    def device_arrays(self) -> dict:
        return {
            "us": self.unitigs.device_arrays(),
            "mphf": self.mphf.device_arrays(),
            "pos": self.pos.device_arrays(),
            "meta": meta(kind="pfhash", k=self.unitigs.k),
        }


def pfhash_k2u(d: dict, fw: torch.Tensor) -> dict:
    """Batched K2U (plain torch). ``fw``: int64 bit patterns of forward
    k-mer words. Returns int64 unitig_id, unitig_len, pos (on the unitig)
    and uint8 mt (0 miss, 1 identity, 2 twin)."""
    from .sshash import mphf_lookup

    us = d["us"]
    k = d["meta"].k
    rc = revcomp(fw, k)
    h = mphf_lookup(d["mphf"], umin(fw, rc)).to(torch.int64)
    hc = torch.clamp(h, 0, d["pos"]["meta"].length - 1)
    km_pos = torch.clamp(iv_get(d["pos"], hc), 0, us["meta"].total_len - k)
    mt = word_equivalency(fw, rc, us_get_kmer(us, km_pos), k)
    mt = torch.where(h < 0, 0, mt)
    uid = bv_rank(us["bv"], km_pos)
    start = us["accum"][uid]
    return {"unitig_id": uid, "unitig_len": us["accum"][uid + 1] - start,
            "pos": km_pos - start, "mt": mt}
