"""Synthetic indexes and queries from a seed (host; counterpart of
``bench.py::build_synthetic`` and ``bench.py::_emit_capacity_tier``).

A random genome is cut into 10 kb unitigs, each its own reference. Every
16th unitig also occurs twice more, in mixed orientation, on other
references, so it has 3 occurrences: more than the 2 a mono2 row (or a
window record) carries, and queries on it take a compacted phase.
Occurrence positions lie inside the reference lengths, so the packed
occurrence words stay below 2^32 and a KCDict keeps its occ32 layout.

Six indexes: ``build_index``, the mono2-occ32 KCDict of the speed tier;
``build_speed_index``, the SSHash direct engine of ``bench.py``'s read
paths over the same genome (w=15, skew 4, load 0.25), laid out in the
SSHash speed tier's fused inline2 rows (``SPEED_LAYOUT``);
``build_capacity_index``, the SSHash direct engine of the capacity tier
(w=15, skew 64, load 0.5, as the reference's 300 Mbp capacity build);
``build_mphf_index``, the SSHash fast32 engine of the MPHF capacity tier
(w=19, skew 64, gamma 1.7, as the reference's human-scale build); and
``build_pf1_dense_index``/``build_pf1_sparse_index``, pufferfish's dense
and sparse dictionaries over the speed tier's genome. A random
genome has no bucket deeper than the skew threshold, so the capacity
genomes plant one w-mer that the mix32 ordering ranks low at
``HEAVY_SITES`` places: its bucket is a skew bucket, as repeats make them
in real genomes.
"""

from __future__ import annotations

import numpy as np

from .bits.seqvector import SeqVector
from .containers.refseq import RefSeqCollection
from .containers.unitig_set import UnitigSet
from .index.modindex import ModIndex
from .index.spt import SPT
from .kmer import revcomp_np
from .kphf.boophf32 import mix32_np
from .kphf.kcdict import KCDict
from .kphf.pfhash import PFHash
from .kphf.sampled import SampledPFHash
from .kphf.sshash import SSHash

K = 31
PIECE = 10_000  # unitig (and reference) length
EXTRA_EVERY = 16  # every 16th unitig gets 2 extra occurrences
LOAD = 0.25  # keys per slot of the mono2 bucket table
RC_SHARE = 0.5  # queries reverse-complemented
FOREIGN_SHARE = 0.05  # queries replaced by random 62-bit words

# the capacity tier: the reference's 300 Mbp direct-engine build settings
CAP_W = 15
CAP_SKEW = 64
CAP_LOAD = 0.5
HEAVY_SITES = 4096  # places of the planted w-mer: one bucket far past CAP_SKEW
TAG = 6  # bases of each site tag (4^6 = HEAVY_SITES numbers)
CAPACITY_LAYOUT = dict(prefix_kind="grouped16", pos_kind="packed", bucket_inline=True,
                       useqrec=True)

# the SSHash speed tier: bench.py's direct build of its reads and
# reads1graph paths (w=15, skew 4 at bench.py:543-546, load 0.25 at its
# synthetic default, bench.py:95), laid out as its reads1graph pass and
# tuned_query_config's speed tier lay it out (bench.py:964, :987)
SPEED_W = 15
SPEED_SKEW = 4
SPEED_LOAD = 0.25
SPEED_LAYOUT = dict(fused=True, pos_kind="inline2")

# the MPHF capacity tier: the reference's fast32 engine at human scale
# (w=19, skew 64, gamma 1.7), queried with deferred validation and a
# truncated MPHF chain
MPHF_W = 19
MPHF_GAMMA = 1.7
MPHF_LAYOUT = dict(prefix_kind="grouped16", pos_kind="packed", uproj=True)
MPHF_QUERY = dict(probe_limit=2, defer_valid=True, mphf_level_limit=4, probe_limit2=4)

# the serve traffic: bench.py::run_serve's batch (MAZU_BENCH_READS,
# MAZU_BENCH_CHUNKS, 150-base reads), drawn over the whole genome. The N
# and foreign shares are not taken from a read set: they make the pass run
# its graph with non-ACGT bases and its miss lanes
SERVE_READS = 2048
SERVE_CHUNKS = 8
READ_LEN = 150
N_SHARE = 0.01  # reads with one N
FOREIGN_READS = 0.05  # reads of random sequence

# the pufferfish indexes: pufferfish's defaults
PF1_GAMMA = 1.7
PF1_SAMPLE = 9
PF1_EXTENSION = 4


def _plant(codes: np.ndarray, rng, w: int, sites: int, tag: bool = False) -> None:
    """Write one w-mer, the lowest-ranked of 2^16 random ones under the
    mix32 ordering, at ``sites`` random places (in place). The places lie
    at least 4w bases apart, so no k-mer (k < 3w) spans parts of two.

    The k-mers that hold the w-mer differ only in their k - w flank bases,
    so at w=19 (12 flank bases) thousands of sites repeat some of them.
    ``tag`` writes the site's number in base 4 into the 6 bases on each side
    of the w-mer: every k-mer that overlaps it then holds a whole tag (for
    k - w >= 11), and the k-mers around the sites stay distinct."""
    cand = rng.integers(0, 1 << (2 * w), 1 << 16, dtype=np.uint64)
    wmer = int(cand[np.argmin(mix32_np(cand.astype(np.uint32)))])
    bases = np.array([(wmer >> (2 * j)) & 3 for j in range(w)], dtype=np.uint8)
    at = rng.choice(len(codes) // (4 * w), sites, replace=False) * (4 * w)
    if tag:
        if sites > 4**TAG or 4 * w < w + 2 * TAG:
            raise ValueError(f"{sites} sites do not fit {TAG}-base tags")
        at = at + TAG
        digits = (np.arange(sites)[:, None] >> (2 * np.arange(TAG))) & 3
        codes[at[:, None] - TAG + np.arange(TAG)] = digits
        codes[at[:, None] + w + np.arange(TAG)] = digits
    codes[at[:, None] + np.arange(w)] = bases


def build_synthetic(n_bases: int, seed: int = 0, heavy_sites: int = 0, w: int = CAP_W,
                    tag_sites: bool = False):
    """(UnitigSet, RefSeqCollection, PiscemUnitigTable) of ``synthetic_spt``."""
    unitigs, refs, spt = synthetic_spt(n_bases, seed, heavy_sites, w, tag_sites)
    return unitigs, refs, spt.piscem_table()


def synthetic_spt(n_bases: int, seed: int = 0, heavy_sites: int = 0, w: int = CAP_W,
                  tag_sites: bool = False):
    """(UnitigSet, RefSeqCollection, SPT) of a random genome, with one
    low-ranked w-mer planted at ``heavy_sites`` places (tagged with their
    numbers with ``tag_sites``; see ``_plant``)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n_bases, dtype=np.uint8)
    if heavy_sites:
        _plant(codes, rng, w, heavy_sites, tag=tag_sites)
    sv = SeqVector.from_codes(codes)
    del codes
    n = n_bases // PIECE
    if n < 3:
        raise ValueError(f"need at least 3 unitigs of {PIECE} bases")
    accum = np.arange(n + 1, dtype=np.int64) * PIECE
    unitigs = UnitigSet(K, sv, accum)
    names = [f"r{i}" for i in range(n)]
    multi = np.repeat(np.arange(0, n, EXTRA_EVERY, dtype=np.int64), 2)
    j = np.arange(len(multi), dtype=np.int64) % 2
    spt = SPT(
        unitigs,
        names,
        np.concatenate([np.arange(n), multi]),
        np.concatenate([np.arange(n), (multi + 1 + j) % n]),
        np.concatenate([np.zeros(n, dtype=np.int64), rng.integers(0, PIECE, len(multi))]),
        np.concatenate([np.ones(n, dtype=np.int64), j]),
        np.full(n, PIECE, dtype=np.int64),
    )
    return unitigs, RefSeqCollection(sv, accum, names), spt


def build_index(n_bases: int, seed: int = 0, genome=None) -> ModIndex:
    """The mono2-occ32 KCDict index over ``synthetic_spt`` (or ``genome``,
    that function's result for these arguments)."""
    unitigs, refs, spt = genome or synthetic_spt(n_bases, seed)
    u2pos = spt.piscem_table()
    k2u = KCDict.from_unitig_set(unitigs, load=LOAD, occ_table=u2pos, scheme="mono2")
    return ModIndex(k2u, u2pos, refs, index_type="Piscem-synth")


def build_pf1_dense_index(n_bases: int, seed: int = 0, device=None, genome=None) -> ModIndex:
    """Pufferfish's dense index (PFHash: a 64-bit BooPHF over every
    canonical k-mer, gamma 1.7, and their positions) over the genome of
    ``build_index``, with the pf1 occurrence table. The MPHF lookup of
    every k-mer runs on ``device``, the card by default."""
    unitigs, refs, spt = genome or synthetic_spt(n_bases, seed)
    k2u = PFHash.from_unitig_set(unitigs, gamma=PF1_GAMMA, device=device)
    return ModIndex(k2u, spt.dense_table(), refs, index_type="PF1Dense-synth")


def build_pf1_sparse_index(n_bases: int, seed: int = 0, device=None, genome=None) -> ModIndex:
    """Pufferfish's sparse index (SampledPFHash: sample 9, extension 4,
    gamma 1.7) over the genome of ``build_index``, with the pf1
    occurrence table; the MPHF lookup runs on ``device``."""
    unitigs, refs, spt = genome or synthetic_spt(n_bases, seed)
    k2u = SampledPFHash.from_unitig_set(unitigs, sample_size=PF1_SAMPLE,
                                        extension_size=PF1_EXTENSION, gamma=PF1_GAMMA,
                                        device=device)
    return ModIndex(k2u, spt.dense_table(), refs, index_type="PF1Sparse-synth")


def build_capacity_index(n_bases: int, seed: int = 0, device=None, chunk: int = 1 << 22,
                         heavy_sites: int = HEAVY_SITES) -> ModIndex:
    """The direct-engine SSHash index over ``build_synthetic`` with a planted
    skew bucket; its minimizer occurrences are collected on ``device`` (the
    card by default). Its query arrays are
    ``index.device_arrays(**CAPACITY_LAYOUT)``."""
    unitigs, refs, u2pos = build_synthetic(n_bases, seed, heavy_sites=heavy_sites)
    k2u = SSHash.from_unitig_set(unitigs, w=CAP_W, skew_param=CAP_SKEW, engine="direct",
                                 bucket_load=CAP_LOAD, chunk=chunk, device=device)
    return ModIndex(k2u, u2pos, refs, index_type="Piscem-synth")


def build_speed_index(n_bases: int, seed: int = 0, device=None, chunk: int = 1 << 22,
                      genome=None) -> ModIndex:
    """The direct-engine SSHash of the speed tier over ``synthetic_spt`` (or
    ``genome``, that function's result for these arguments: the genome of
    ``build_index``); its minimizer occurrences are collected on ``device``
    (the card by default). Its query arrays are
    ``index.device_arrays(**SPEED_LAYOUT)``."""
    unitigs, refs, spt = genome or synthetic_spt(n_bases, seed)
    k2u = SSHash.from_unitig_set(unitigs, w=SPEED_W, skew_param=SPEED_SKEW, engine="direct",
                                 bucket_load=SPEED_LOAD, chunk=chunk, device=device)
    return ModIndex(k2u, spt.piscem_table(), refs, index_type="Piscem-synth")


def build_mphf_index(n_bases: int, seed: int = 0, device=None, chunk: int = 1 << 22,
                     heavy_sites: int = HEAVY_SITES, genome=None) -> ModIndex:
    """The fast32 SSHash index over ``build_synthetic`` (or ``genome``, that
    function's result for these arguments: ``mphf_genome``) with a planted,
    tagged 19-mer: one minimizer with about ``heavy_sites`` occurrences, a
    skew minimizer. Its build runs on ``device`` (the card by default; see
    ``SSHash._from_unitig_set_mphf``). Its query arrays are
    ``index.device_arrays(**MPHF_LAYOUT)``."""
    unitigs, refs, u2pos = genome or mphf_genome(n_bases, seed, heavy_sites)
    k2u = SSHash.from_unitig_set(unitigs, w=MPHF_W, skew_param=CAP_SKEW, gamma=MPHF_GAMMA,
                                 engine="fast32", chunk=chunk, device=device)
    return ModIndex(k2u, u2pos, refs, index_type="Piscem-synth")


def mphf_genome(n_bases: int, seed: int = 0, heavy_sites: int = HEAVY_SITES):
    """``build_synthetic``'s genome of ``build_mphf_index``: the planted
    19-mer tagged at ``heavy_sites`` places."""
    return build_synthetic(n_bases, seed, heavy_sites=heavy_sites, w=MPHF_W, tag_sites=True)


def sample_capacity_queries(unitigs: UnitigSet, n: int, seed: int):
    """(words, uid, upos): uniform (unitig, offset) draws, half reverse-
    complemented, no foreign words, so each lane's true unitig and offset
    are known. The sampler of ``bench.py:368-374``."""
    rng = np.random.default_rng(seed)
    k = unitigs.k
    upos = rng.integers(0, PIECE - k + 1, n)
    uid = rng.integers(0, unitigs.n_unitigs, n)
    words = unitigs.get_kmer_u64(unitigs.accum[uid] + upos)
    flip = rng.random(n) < RC_SHARE
    words[flip] = revcomp_np(words[flip], k)
    return words, uid, upos


def sample_boundary_queries(unitigs: UnitigSet, n: int, seed: int) -> np.ndarray:
    """uint64 k-mer words read across a unitig boundary (one of the last
    k-1 start positions of a unitig), half reverse-complemented: the useq
    spells them but no unitig holds them, so a probe that validates only
    its winner finds them and then rejects them."""
    rng = np.random.default_rng(seed)
    k = unitigs.k
    ends = np.asarray(unitigs.accum[1:-1], dtype=np.int64)
    words = unitigs.get_kmer_u64(ends[rng.integers(0, len(ends), n)] - rng.integers(1, k, n))
    flip = rng.random(n) < RC_SHARE
    words[flip] = revcomp_np(words[flip], k)
    return words


def sample_queries(unitigs: UnitigSet, n: int, seed: int) -> np.ndarray:
    """uint64 k-mer words: uniform (unitig, offset) samples over the whole
    index, a ``RC_SHARE`` reverse-complemented, and a ``FOREIGN_SHARE``
    replaced by random 62-bit words (misses)."""
    return sample_queries_truth(unitigs, n, seed)[0]


def sample_queries_truth(unitigs: UnitigSet, n: int, seed: int):
    """(words, uid, offset, foreign): ``sample_queries``'s words with each
    lane's sampled unitig and offset, and whether it was replaced by a
    foreign word."""
    rng = np.random.default_rng(seed)
    k = unitigs.k
    uid = rng.integers(0, unitigs.n_unitigs, n)
    off = rng.integers(0, unitigs.unitig_len(uid) - k + 1)
    words = unitigs.get_kmer_u64(unitigs.accum[uid] + off)
    flip = rng.random(n) < RC_SHARE
    words[flip] = revcomp_np(words[flip], k)
    foreign = rng.random(n) < FOREIGN_SHARE
    words[foreign] = rng.integers(0, 1 << 62, int(foreign.sum()), dtype=np.uint64)
    return words, uid, off, foreign


def serve_reads(refs: RefSeqCollection, n: int, seed: int = 1, n_share: float = N_SHARE,
                foreign_share: float = FOREIGN_READS) -> list:
    """``n`` reads of ``READ_LEN`` bases: uniform starts over the whole
    concatenated reference, a ``RC_SHARE`` reverse-complemented, a
    ``foreign_share`` replaced by random sequence, and a ``n_share`` with
    one base turned to N."""
    return serve_reads_truth(refs, n, seed, n_share, foreign_share)[0]


def serve_reads_truth(refs: RefSeqCollection, n: int, seed: int = 1, n_share: float = N_SHARE,
                      foreign_share: float = FOREIGN_READS):
    """(reads, start, rc, foreign, with_n) of ``serve_reads``: each read's
    start in the concatenated reference and whether it was reverse-
    complemented, replaced by random sequence or given an N."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, int(refs.prefix_sum[-1]) - READ_LEN + 1, n)
    codes = refs.seq.get_base(starts[:, None] + np.arange(READ_LEN))
    rc = rng.random(n) < RC_SHARE
    codes[rc] = 3 - codes[rc, ::-1]
    foreign = rng.random(n) < foreign_share
    codes[foreign] = rng.integers(0, 4, (int(foreign.sum()), READ_LEN), dtype=np.uint8)
    with_n = np.flatnonzero(rng.random(n) < n_share)
    codes[with_n, rng.integers(0, READ_LEN, len(with_n))] = 4
    text = np.frombuffer(b"ACGTN", dtype=np.uint8)[codes]
    n_mask = np.zeros(n, dtype=bool)
    n_mask[with_n] = True
    return [row.tobytes().decode() for row in text], starts, rc, foreign, n_mask


def write_cf(prefix: str, n_bases: int, seed: int = 0, fasta: str | None = None,
             genome=None) -> None:
    """The genome of ``synthetic_spt(n_bases, seed)`` as cuttlefish output:
    ``prefix.cf_seg`` (unitig i, cuttlefish id i), ``prefix.cf_seq`` and
    ``prefix.json`` (k = ``K``). Reference i (i < n, the unitig count)
    tiles unitig i forward; the two extra occurrences of every
    ``EXTRA_EVERY``-th unitig u are references of their own, u reverse then
    u forward, so u has 3 occurrences, as in ``synthetic_spt``, and no
    reference holds a k-mer outside the unitigs. ``fasta``: also write the
    references' sequences there (record i is reference i). ``genome``:
    ``synthetic_spt``'s result for these arguments, if it is at hand."""
    import json

    unitigs, _, _ = genome or synthetic_spt(n_bases, seed)
    n = unitigs.n_unitigs
    tiles = [(i, 1) for i in range(n)]
    tiles += [(int(u), o) for u in range(0, n, EXTRA_EVERY) for o in (0, 1)]
    seqs = [unitigs.useq.to_str(int(unitigs.accum[i]), int(unitigs.accum[i + 1]))
            for i in range(n)]
    with open(prefix + ".cf_seg", "w") as f:
        f.writelines(f"{i}\t{s}\n" for i, s in enumerate(seqs))
    with open(prefix + ".cf_seq", "w") as f:
        f.writelines(f"r{j}\t{u}{'+' if o else '-'}\n" for j, (u, o) in enumerate(tiles))
    with open(prefix + ".json", "w") as f:
        json.dump({"parameters info": {"k": K},
                   "contigs info": {"maximal unitig count": n,
                                    "sum maximal unitig length": unitigs.total_len}}, f)
    if fasta is not None:
        comp = str.maketrans("ACGT", "TGCA")
        with open(fasta, "w") as f:
            for j, (u, o) in enumerate(tiles):
                f.write(f">r{j}\n{seqs[u] if o else seqs[u].translate(comp)[::-1]}\n")


def write_fastq(path: str, reads: list) -> None:
    """A FASTQ file of ``reads`` (records r0, r1, ...; quality all I),
    gzipped when ``path`` ends in ``.gz``."""
    import gzip

    with (gzip.open(path, "wt") if str(path).endswith(".gz") else open(path, "w")) as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
