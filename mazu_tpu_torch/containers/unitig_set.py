"""UnitigSet: concatenated 2-bit unitigs (counterpart of
``mazu_tpu.containers.unitig_set``).

``useq`` is the packed concatenation, ``accum`` the int64 prefix of unitig
lengths, and ``bv`` the boundary bitvector with a 1 on the last base of
each unitig. On the host, position -> unitig id is a binary search over
``accum``; the device functions (``us_*``) rank the boundary bitvector.
``kmer_position_chunks`` gives the builders every k-mer's position on the
device, a chunk at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from .._words import srl_var
from ..bits.bitvector import BitVector, bv_rank, bv_read_window, rank_in_word
from ..bits.seqvector import SeqVector, sv_get_kmer
from ..kmer import mask2k, revcomp_np
from ..pytree import meta


class UnitigSet:
    def __init__(self, k: int, useq: SeqVector, accum: np.ndarray, bv: BitVector | None = None):
        self.k = int(k)
        self.useq = useq
        self.accum = np.asarray(accum, dtype=np.int64)
        if bv is None:
            bv = BitVector.from_set_positions(self.accum[1:] - 1, int(self.accum[-1]))
        self.bv = bv

    @classmethod
    def from_seqs(cls, seqs: list[str], k: int) -> "UnitigSet":
        lens = np.array([len(s) for s in seqs], dtype=np.int64)
        accum = np.concatenate([[0], np.cumsum(lens)])
        return cls(k, SeqVector.from_str("".join(seqs)), accum)

    @classmethod
    def from_cf(cls, cf_files) -> tuple["UnitigSet", dict]:
        """The unitigs of cuttlefish output (``io.cuttlefish.CfFiles``) in
        file order, and the map from cuttlefish id to that order."""
        from ..io.cuttlefish import CfInfo, iter_segs

        info = CfInfo.from_path(cf_files.json)
        seqs = []
        cfid2uid = {}
        for i, (cfid, seq) in enumerate(iter_segs(cf_files)):
            cfid2uid[cfid] = i
            seqs.append(seq)
        return cls.from_seqs(seqs, info.k), cfid2uid

    @property
    def n_unitigs(self) -> int:
        return len(self.accum) - 1

    @property
    def total_len(self) -> int:
        return int(self.accum[-1])

    @property
    def n_kmers(self) -> int:
        return self.total_len - self.k * self.n_unitigs + self.n_unitigs

    def unitig_len(self, i) -> np.ndarray:
        i = np.asarray(i)
        return self.accum[i + 1] - self.accum[i]

    def pos_to_id(self, pos) -> np.ndarray:
        """Unitig id of useq position(s) ``pos``."""
        return np.searchsorted(self.accum, pos, side="right") - 1

    def unitig_seq_str(self, i: int) -> str:
        return self.useq.to_str(int(self.accum[i]), int(self.accum[i + 1]))

    def get_kmer_u64(self, pos) -> np.ndarray:
        return self.useq.get_kmer_u64(pos, self.k)

    def is_valid_useq_pos(self, pos) -> np.ndarray:
        """No unitig boundary inside the k-mer window at ``pos``."""
        pos = np.asarray(pos, dtype=np.int64)
        in_range = pos <= self.total_len - self.k
        w = self.bv.read_window(np.clip(pos, 0, self.total_len - self.k), self.k - 1)
        return in_range & (w == 0)

    def kmer_start_positions(self) -> np.ndarray:
        """Global useq positions of all valid k-mers, in unitig order."""
        starts = self.accum[:-1]
        counts = self.accum[1:] - self.k + 1 - starts
        offsets = np.concatenate([[0], np.cumsum(counts)])
        within = np.arange(offsets[-1], dtype=np.int64) - np.repeat(offsets[:-1], counts)
        return np.repeat(starts, counts) + within

    def kmer_position_chunks(self, chunk: int, device):
        """``kmer_start_positions`` ``chunk`` k-mers at a time, as int64
        tensors on ``device``: k-mer ordinal o lies in the unitig found by a
        search of the running valid-k-mer counts, so no array of every
        position is made. Ordinals and positions are int64: both pass 2^31
        on a unitig set of 2^31 bases or more."""
        accum = torch.from_numpy(self.accum).to(device)
        counts = torch.clamp(accum[1:] - accum[:-1] - (self.k - 1), min=0)
        kcum = torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                          torch.cumsum(counts, 0)])
        total = int(kcum[-1])
        for s in range(0, total, int(chunk)):
            o = torch.arange(s, min(s + int(chunk), total), dtype=torch.int64, device=device)
            u = torch.searchsorted(kcum, o, right=True) - 1
            yield accum[u] + (o - kcum[u])

    def all_canonical_kmers(self) -> np.ndarray:
        """Canonical u64 word of every k-mer, in unitig order."""
        fw = self.get_kmer_u64(self.kmer_start_positions())
        return np.minimum(fw, revcomp_np(fw, self.k))

    def ef_accum_lens(self):
        """``accum`` as an Elias-Fano ``EFVector``."""
        from ..bits.elias_fano import EFVector

        return EFVector.from_array(self.accum.astype(np.uint64))

    def num_bits(self) -> int:
        """Size in bits, as the reference counts it: the packed sequence,
        the Elias-Fano code of ``accum`` and the boundary bitvector."""
        return 64 + self.useq.num_bits() + self.ef_accum_lens().num_bits() + self.bv.num_bits()

    def print_stats(self, log=print):
        """Size accounting, in the reference's lines."""
        nk, tl = self.n_kmers, self.total_len
        log(f"{self.num_bits() / nk:.5f} bits per kmer")
        log(f"seq: {self.useq.num_bits() / tl:.5f} bits per nuc")
        log(f"bv: {self.bv.num_bits() / tl:.5f} bits per nuc")
        log(f"accum_lens: {self.ef_accum_lens().num_bits() / nk:.5f} bits per km")

    def device_arrays(self, paired: bool = False) -> dict:
        """``paired=True`` adds the pair-packed views the capacity probes
        read with one gather each: ``useq.words2[i] = (words[i],
        words[i+1])``, ``bv.wb2[i] = (words[i], blocks[i])`` and
        ``accum2[u] = (start, end)``."""
        d = {
            "useq": self.useq.device_arrays(),
            "bv": self.bv.device_arrays(),
            "accum": self.accum,
            "meta": meta(k=self.k, n_unitigs=self.n_unitigs, total_len=self.total_len,
                         paired=paired),
        }
        if paired:
            w = self.useq.words
            d["useq"]["words2"] = np.stack([w, np.concatenate([w[1:], np.zeros(1, np.uint64)])],
                                           axis=1)
            d["bv"]["wb2"] = np.stack([self.bv.words, self.bv.blocks.astype(np.uint64)], axis=1)
            d["accum2"] = np.stack([self.accum[:-1], self.accum[1:]], axis=1)
        return d


def us_rank(us: dict, pos: torch.Tensor) -> torch.Tensor:
    """Unitig id of useq position(s) ``pos``: the boundary ones before it.
    The paired layout reads the word and its block count in one row."""
    if "wb2" in us["bv"]:
        pair = us["bv"]["wb2"][pos >> 6]
        return rank_in_word(pair[..., 0], pair[..., 1], pos)
    return bv_rank(us["bv"], pos)


us_pos_to_id = us_rank  # the reference's name for the same rank


def us_extent(us: dict, uid: torch.Tensor):
    """(start, end) of unitig(s) ``uid``."""
    if "accum2" in us:
        pair = us["accum2"][uid]
        return pair[..., 0], pair[..., 1]
    return us["accum"][uid], us["accum"][uid + 1]


def us_is_valid_pos(us: dict, pos: torch.Tensor) -> torch.Tensor:
    """A k-mer fits at ``pos``: in range, and no unitig boundary among its
    first k-1 bases."""
    m = us["meta"]
    last = max(0, m.total_len - m.k)
    in_range = (pos >= 0) & (pos <= m.total_len - m.k)
    return in_range & (bv_read_window(us["bv"], torch.clamp(pos, 0, last), m.k - 1) == 0)


def us_get_kmer(us: dict, pos: torch.Tensor) -> torch.Tensor:
    """k-mer word(s) at useq position(s) ``pos``; the paired layout reads
    both words in one ``words2`` row."""
    k = us["meta"].k
    if "words2" not in us["useq"]:
        return sv_get_kmer(us["useq"]["words"], pos, k)
    bit = pos * 2
    off = bit & 63
    pair = us["useq"]["words2"][bit >> 6]
    hi = torch.where(off == 0, 0, pair[..., 1] << ((64 - off) & 63))
    return (srl_var(pair[..., 0], off) | hi) & mask2k(k)


def us_validate_rank(us: dict, pos: torch.Tensor):
    """``us_is_valid_pos`` and ``us_rank`` from one ``wb2`` row and the
    next: validity reads the (k-1)-bit boundary window at ``pos`` (at most
    two words), the rank reads the word's block count and its bits below
    ``pos``. Returns ``(valid, uid)``; ``uid`` is the rank of the position
    clipped into [0, total_len - k]. Needs the paired layout."""
    m = us["meta"]
    in_range = (pos >= 0) & (pos <= m.total_len - m.k)
    p = torch.clamp(pos, 0, max(0, m.total_len - m.k))
    wi = p >> 6
    off = p & 63
    wb2 = us["bv"]["wb2"]
    pair0 = wb2[wi]
    word0, word1 = pair0[..., 0], wb2[torch.clamp(wi + 1, 0, wb2.shape[0] - 1)][..., 0]
    uid = rank_in_word(word0, pair0[..., 1], p)
    hi = torch.where(off == 0, 0, word1 << ((64 - off) & 63))
    win = (srl_var(word0, off) | hi) & ((1 << (m.k - 1)) - 1)
    return in_range & (win == 0), uid
