"""SampledPFHash: pufferfish's sparse k-mer dictionary (counterpart of
``mazu_tpu.kphf.sampled``).

Only sampled k-mers store a position. An unsampled k-mer stores up to
``extension_size`` bases that walk it to a sampled k-mer: the query
appends or prepends them, looks the walked k-mer up, and shifts its
position back by the steps taken. The walk is a static
``extension_size``-step predicated loop, so a batch stays one pass.

``from_unitig_set`` builds the structure the query walk reads (NumPy,
byte-identical to the reference's; the MPHF lookup of every k-mer runs on
a device); ``sampled_k2u`` is plain torch.
"""

from __future__ import annotations

import numpy as np
import torch

from .._words import srl, ule, umin
from ..bits.bitvector import BitVector, bv_get_bit, bv_rank
from ..bits.intvector import IntVector, iv_get
from ..containers.unitig_set import us_get_kmer, us_is_valid_pos
from ..kmer import mask2k, revcomp, revcomp_np, word_equivalency
from ..pytree import meta
from .boophf import BooPHF, boophf_lookup


class SampledPFHash:
    def __init__(self, unitigs, mphf: BooPHF, sampled_pos: IntVector, sampled_vec: BitVector,
                 canonical_vec: BitVector, direction_vec: BitVector, ext_sizes: IntVector,
                 ext_bases: IntVector, sample_size: int, extension_size: int):
        self.unitigs = unitigs
        self.mphf = mphf
        self.sampled_pos = sampled_pos
        self.sampled_vec = sampled_vec
        self.canonical_vec = canonical_vec
        self.direction_vec = direction_vec
        self.ext_sizes = ext_sizes
        self.ext_bases = ext_bases
        self.sample_size = int(sample_size)
        self.extension_size = int(extension_size)

    @property
    def k(self) -> int:
        return self.unitigs.k

    @property
    def n_kmers(self) -> int:
        return self.unitigs.n_kmers

    @classmethod
    def from_unitig_set(cls, unitigs, sample_size: int = 9, extension_size: int = 4,
                        gamma: float = 1.7, device=None) -> "SampledPFHash":
        """Sample the k-mers at unitig offsets ``lp % sample_size == 0``,
        and each unitig's last k-mer when its phase exceeds
        ``extension_size``. With ``sample_size <= 2 * extension_size + 1``
        every other k-mer is at most ``extension_size`` steps from a sample:
        phase <= E walks back, phase > E walks forward (to the next
        multiple, or the tail sample). The MPHF lookup of every k-mer runs
        on ``device``, the card by default."""
        k, s, E = unitigs.k, int(sample_size), int(extension_size)
        if not 1 <= s <= 2 * E + 1:
            raise ValueError("unsampled k-mers must lie within one walk of a sample")
        n = unitigs.n_kmers
        starts = unitigs.accum[:-1]
        npos = (unitigs.accum[1:] - starts) - k + 1  # k-mers per unitig
        p = unitigs.kmer_start_positions().astype(np.int64)
        uid = np.repeat(np.arange(unitigs.n_unitigs, dtype=np.int64), npos)
        lp = p - starts[uid]
        last = npos[uid] - 1
        del uid
        ph = lp % s
        sampled = (ph == 0) | ((lp == last) & (last % s > E))

        # signed useq distance to the walk's target (0 for sampled k-mers)
        target = np.where(ph > E, np.minimum(lp - ph + s, last), lp - ph)
        delta = np.where(sampled, 0, target - lp)
        steps = np.abs(delta)
        del lp, last, ph, target
        if int(steps.max(initial=0)) > E:
            raise AssertionError("a walk longer than extension_size")

        fw = unitigs.get_kmer_u64(p)
        rc = revcomp_np(fw, k)
        canon = np.minimum(fw, rc)
        mphf = BooPHF.build(canon, gamma=gamma)
        h = mphf.lookup(canon, device=device)
        del canon
        if (h < 0).any() or np.bincount(h, minlength=n).max(initial=0) > 1:
            raise RuntimeError("the k-mer MPHF is not a bijection onto its keys")

        bits = np.zeros(n, dtype=bool)
        bits[h[sampled]] = True
        rank_excl = np.cumsum(bits) - bits  # ones strictly before each slot

        n_sampled = int(sampled.sum())
        pos_by_rank = np.zeros(n_sampled, dtype=np.int64)
        pos_by_rank[rank_excl[h[sampled]]] = p[sampled]

        uns = ~sampled
        e_idx = h[uns] - rank_excl[h[uns]]  # index among the unsampled
        n_uns = n - n_sampled
        canonical_arr = np.zeros(n_uns, dtype=bool)
        direction_arr = np.zeros(n_uns, dtype=bool)
        sizes_arr = np.zeros(n_uns, dtype=np.int64)
        bases_arr = np.zeros(n_uns, dtype=np.uint64)
        if n_uns:
            canonical_arr[e_idx] = (fw <= rc)[uns]
            fwd = delta[uns] > 0
            direction_arr[e_idx] = fwd
            su = steps[uns]
            sizes_arr[e_idx] = su - 1
            # step j's base code at shift 2 * (E - 1 - j): a forward walk
            # appends bases p+k+j, a backward one prepends p-1-j
            word = np.zeros(n_uns, dtype=np.uint64)
            pu = p[uns]
            for j in range(E):
                bp = np.clip(np.where(fwd, pu + k + j, pu - 1 - j), 0, unitigs.total_len - 1)
                code = unitigs.useq.get_base(bp).astype(np.uint64) * (j < su)
                word += code << np.uint64(2 * (E - 1 - j))
            bases_arr[e_idx] = word

        return cls(
            unitigs,
            mphf,
            sampled_pos=IntVector.from_array(pos_by_rank.astype(np.uint64)),
            sampled_vec=BitVector.from_bools(bits),
            canonical_vec=BitVector.from_bools(canonical_arr),
            direction_vec=BitVector.from_bools(direction_arr),
            ext_sizes=IntVector.from_array(sizes_arr.astype(np.uint64),
                                           width=max(1, (E - 1).bit_length())),
            ext_bases=IntVector.from_array(bases_arr, width=2 * E),
            sample_size=s,
            extension_size=E,
        )

    def print_stats(self, log=print) -> None:
        n = max(1, self.n_kmers)
        log(f"sampled_pos: {self.sampled_pos.length} entries")
        log(f"sample_size: {self.sample_size}  extension_size: {self.extension_size}")
        log(f"total: {self.num_bits() / n:.2f} bits per kmer")

    def num_bits(self) -> int:
        """Size in bits, as the reference counts it: whole words of every
        packed vector."""
        vecs = (self.sampled_pos, self.sampled_vec, self.canonical_vec, self.direction_vec,
                self.ext_sizes, self.ext_bases)
        return (self.unitigs.num_bits() + self.mphf.num_bits()
                + sum(64 * len(v.words) for v in vecs))

    def device_arrays(self) -> dict:
        return {
            "us": self.unitigs.device_arrays(),
            "mphf": self.mphf.device_arrays(),
            "sampled_pos": self.sampled_pos.device_arrays(),
            "sampled_vec": self.sampled_vec.device_arrays(),
            "canonical_vec": self.canonical_vec.device_arrays(),
            "direction_vec": self.direction_vec.device_arrays(),
            "ext_sizes": self.ext_sizes.device_arrays(),
            "ext_bases": self.ext_bases.device_arrays(),
            "meta": meta(kind="sampled", k=self.unitigs.k, sample_size=self.sample_size,
                         extension_size=self.extension_size),
        }


def _append_base(fw, rc, code, k: int):
    """Drop the first base and append ``code`` at the end (the high bits)."""
    m = mask2k(k)
    return (srl(fw, 2) | (code << 2 * (k - 1))) & m, ((rc << 2) | (code ^ 3)) & m


def _prepend_base(fw, rc, code, k: int):
    m = mask2k(k)
    return ((fw << 2) | code) & m, (srl(rc, 2) | ((code ^ 3) << 2 * (k - 1))) & m


def _verify_at(d: dict, fw, rc, pos) -> dict:
    """The k-mer at ``pos`` (clipped into the useq) against the query, and
    the unitig that holds it."""
    us = d["us"]
    k = d["meta"].k
    pos_c = torch.clamp(pos, 0, max(us["meta"].total_len - k, 0))
    mt = word_equivalency(fw, rc, us_get_kmer(us, pos_c), k)
    uid = bv_rank(us["bv"], pos_c)
    start = us["accum"][uid]
    return {"unitig_id": uid, "unitig_len": us["accum"][uid + 1] - start,
            "pos": pos_c - start, "mt": mt}


def _sample_pos(d: dict, h: torch.Tensor):
    """(sampled, rank, position) of MPHF values ``h`` (-1 for a miss): the
    presence bit, the ones before it, and the stored position of the
    sample it ranks to."""
    hc = torch.clamp(h, min=0)
    rank = bv_rank(d["sampled_vec"], hc)
    last = max(d["sampled_pos"]["meta"].length - 1, 0)
    pos = iv_get(d["sampled_pos"], torch.clamp(rank, 0, last))
    return bv_get_bit(d["sampled_vec"], hc), rank, pos


def sampled_k2u(d: dict, fw: torch.Tensor) -> dict:
    """Batched K2U (plain torch); the outputs of ``pfhash_k2u``."""
    m = d["meta"]
    k, ext_n = m.k, m.extension_size
    rc = revcomp(fw, k)
    h = boophf_lookup(d["mphf"], umin(fw, rc))
    is_sampled, rank_h, pos_sampled = _sample_pos(d, h)

    # an unsampled k-mer walks its stored bases toward its sample
    last_ext = max(d["ext_sizes"]["meta"].length - 1, 0)
    ext_pos = torch.clamp(torch.clamp(h, min=0) - rank_h, 0, last_ext)
    ext_word = iv_get(d["ext_bases"], ext_pos)
    ext_size = iv_get(d["ext_sizes"], ext_pos)
    canonical_bit = bv_get_bit(d["canonical_vec"], ext_pos)
    shift_fw = bv_get_bit(d["direction_vec"], ext_pos)

    # orientation: the stored canonical flag against the query's own
    do_swap = (~canonical_bit) ^ (~ule(fw, rc))
    wfw = torch.where(do_swap, rc, fw)
    wrc = torch.where(do_swap, fw, rc)
    llimit = ext_n - (ext_size + 1)
    shift = torch.zeros_like(fw)
    step = torch.where(shift_fw, -1, 1)
    for i in range(ext_n, 0, -1):
        apply = (i > llimit) & ~is_sampled
        code = srl(ext_word, 2 * (i - 1)) & 3
        afw, arc = _append_base(wfw, wrc, code, k)
        pfw, prc = _prepend_base(wfw, wrc, code, k)
        wfw = torch.where(apply, torch.where(shift_fw, afw, pfw), wfw)
        wrc = torch.where(apply, torch.where(shift_fw, arc, prc), wrc)
        shift = shift + torch.where(apply, step, 0)

    h2 = boophf_lookup(d["mphf"], umin(wfw, wrc))
    sampled2, _, pos2 = _sample_pos(d, h2)
    pos_unsampled = pos2 + shift
    pos_ok = sampled2 & (h2 >= 0) & us_is_valid_pos(d["us"], pos_unsampled)

    r = _verify_at(d, fw, rc, torch.where(is_sampled, pos_sampled, pos_unsampled))
    ok = (h >= 0) & (is_sampled | pos_ok)
    r["mt"] = torch.where(ok, r["mt"], 0)
    return r
