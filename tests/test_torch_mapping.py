"""The port's read mapper against mazu_tpu's, with tolerance 0:
``ReadMapper.map_reads``, ``map_fasta`` and ``map_file`` (``read_pos``,
``hits``, ``n_hit``, ``n_kmers``, ``csr()``) on the mono2 KCDict, the
direct SSHash and the fast32 SSHash pairs and the pufferfish dense and
sparse pairs; ``CompactQuery.get_ref_pos_batch`` (the capacity tier, taken
under a small ``MAZU_HBM_BUDGET``), with the re-run at the full budget when
a phase overflows N // 4; ``ReadHits``' lazy decoding.

Both mappers answer these small SSHashes with the speed tier,
``TwoPhaseIndexQuery`` on fused inline rows, and on the direct pair they
are compared so. On the fast32 pair the reference's speed tier reports
skew lanes' hits with no occurrences (its phase 2 gives ``n_occs`` 0 where
the exact padded query finds three; C10): a reference fault the port does
not mirror. So there the reference's mapper is given its capacity-tier
``CompactQuery``, which answers exactly."""

import numpy as np
import pytest

from mazu_tpu.index.mapping import CompactQuery as MCompactQuery
from mazu_tpu.index.mapping import ReadMapper as MReadMapper
from mazu_tpu.index.tuning import QueryConfig
from mazu_tpu.kmer import revcomp as m_revcomp

from mazu_tpu_torch.index import mapping
from mazu_tpu_torch.index.mapping import CompactQuery, PaddedQuery, ReadMapper
from mazu_tpu_torch.index.twophase import TwoPhaseIndexQuery
from mazu_tpu_torch.synth import write_fastq

from torch_fixtures import (
    build_capacity_pair, build_mphf_pair, build_pair, build_pf1_pair, toy_recipe, write_fasta,
)

COMP = str.maketrans("ACGT", "TGCA")
CAPACITY = {  # the reference's capacity-tier settings of each SSHash engine
    "direct": QueryConfig(tier="capacity", pos_kind="packed", prefix_kind="grouped16",
                          useqrec=True, bucket_inline=True, probe_limit=2, probe_limit2=4),
    "fast32": QueryConfig(tier="capacity", pos_kind="packed", prefix_kind="grouped16",
                          uproj=True, probe_limit=2, defer_valid=True, mphf_level_limit=4),
}
DRIVER = {"mono2": TwoPhaseIndexQuery, "direct": TwoPhaseIndexQuery,
          "fast32": TwoPhaseIndexQuery, "pf1_dense": PaddedQuery, "pf1_sparse": PaddedQuery}
SMALL_BUDGET = "1"  # byte: no speed layout fits, the capacity tier answers
_PAIRS = {}


def pair(name):
    if name not in _PAIRS:
        recipe = toy_recipe()
        if name == "mono2":
            p = build_pair(recipe)
        elif name == "direct":
            p = build_capacity_pair(recipe)
        elif name == "fast32":
            p = build_mphf_pair(recipe)
        else:
            dense, sparse = build_pf1_pair(recipe)
            p = dense if name == "pf1_dense" else sparse
        _PAIRS[name] = (*p, recipe[0])
    return _PAIRS[name]


def reads_of(seqs, k, seed=3):
    """90-base pieces of every unitig, half reverse-complemented, and
    reads with an N restart, all N, foreign, shorter than k and empty."""
    rng = np.random.default_rng(seed)
    reads = []
    for s in seqs:
        a = int(rng.integers(0, len(s) - 90))
        r = s[a : a + 90]
        reads.append(r.translate(COMP)[::-1] if rng.random() < 0.5 else r)
    s = seqs[1]
    return reads + [s[:50] + "N" + s[51:130], "N" * 40, "GATTACA" * 12, s[: k - 2], ""]


_MAPPERS = {}


def reference_mapper(name):
    """The reference's mapper of a pair, made once (its jitted query then
    compiles once a shape)."""
    if name not in _MAPPERS:
        ref = pair(name)[0]
        m = MReadMapper(ref)
        if name == "fast32":  # C10: the reference's speed tier drops occurrences
            m.tp = MCompactQuery(ref, CAPACITY[name])
        _MAPPERS[name] = m
    return _MAPPERS[name]


def same_reads(got, want, csr: bool):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.read_pos, w.read_pos, err_msg=f"read {i}")
        assert g.read_pos.dtype == w.read_pos.dtype
        assert g.n_kmers == w.n_kmers and g.n_hit == w.n_hit, f"read {i}"
        assert g.hits == w.hits, f"read {i}"
        if csr:
            for a, b in zip(g.csr(), w.csr()):
                np.testing.assert_array_equal(a, b, err_msg=f"read {i} csr")


def csr_matches_hits(reads):
    """A port read's CSR view holds its hit lists, in order."""
    for r in reads:
        offs, rid, rpo, orn = r.csr()
        assert offs[0] == 0 and int(offs[-1]) == len(rid)
        for j, h in enumerate(r.hits):
            got = list(zip(rid[offs[j] : offs[j + 1]].tolist(), rpo[offs[j] : offs[j + 1]].tolist(),
                           orn[offs[j] : offs[j + 1]].tolist()))
            assert got == (h or []), j


NAMES = ["mono2", "direct", "fast32", "pf1_dense", "pf1_sparse"]


@pytest.mark.parametrize("name", NAMES)
def test_map_reads(name):
    ref, port, seqs = pair(name)
    reads = reads_of(seqs, port.k)
    m = ReadMapper(port, device="cpu")
    assert type(m.tp) is DRIVER[name]
    got = m.map_reads(reads)
    # the array path: nothing decoded until asked for
    assert got[0]._hits is None and got[0].n_hit > 0 and got[0]._hits is None
    same_reads(got, reference_mapper(name).map_reads(reads), csr=name in CAPACITY)
    csr_matches_hits(got)
    assert got[-1].n_kmers == 0 and got[-3].n_hit == 0


@pytest.mark.parametrize("name", ["mono2", "direct", "fast32"])
def test_map_fasta(name, tmp_path):
    ref, port, seqs = pair(name)
    reads = reads_of(seqs, port.k)[:-1]  # a FASTA record with no bases is dropped
    fa = tmp_path / "reads.fa"
    write_fasta(fa, reads, width=37)
    got = ReadMapper(port, device="cpu").map_fasta(str(fa))
    same_reads(got, reference_mapper(name).map_fasta(str(fa)), csr=name in CAPACITY)


@pytest.mark.parametrize("suffix", [".fastq", ".fastq.gz"])
@pytest.mark.parametrize("name", ["mono2", "direct", "fast32"])
def test_map_file(name, suffix, tmp_path):
    ref, port, seqs = pair(name)
    reads = [r for r in reads_of(seqs, port.k) if r]
    fq = str(tmp_path / ("reads" + suffix))
    write_fastq(fq, reads)
    got = ReadMapper(port, batch=300, device="cpu").map_file(fq)
    same_reads(got, reference_mapper(name).map_file(fq), csr=name in CAPACITY)


def words_of(name, n, seed, multi_only=False):
    """k-mer words of the pair's unitigs, half reverse-complemented, one in
    ten foreign; with ``multi_only`` only of the unitigs with three
    occurrences, so every lane overflows the main phase."""
    ref = pair(name)[0]
    us = ref.k2u.unitigs
    rng = np.random.default_rng(seed)
    counts = np.diff(np.asarray(ref.u2pos.offsets))
    uids = np.flatnonzero(counts > 2) if multi_only else np.arange(us.n_unitigs)
    uid = uids[rng.integers(0, len(uids), n)]
    off = rng.integers(0, us.unitig_len(uid) - ref.k + 1)
    w = np.asarray(us.get_kmer_u64(np.asarray(us.accum)[uid] + off), dtype=np.uint64)
    flip = rng.random(n) < 0.5
    w[flip] = m_revcomp(w[flip], ref.k)
    if not multi_only:
        m = rng.random(n) < 0.1
        w[m] = rng.integers(0, 1 << 62, int(m.sum()), dtype=np.uint64)
    return w


def same_batch(got, want):
    for key in ("mt", "offsets", "ref_id", "ref_pos", "orient"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)


@pytest.mark.parametrize("name", ["direct", "fast32"])
def test_compact_query_batch(name, monkeypatch):
    ref, port, _ = pair(name)
    words = words_of(name, 3000, seed=5)
    monkeypatch.setenv("MAZU_HBM_BUDGET", SMALL_BUDGET)
    cq = mapping.query_driver(port, "cpu")
    assert isinstance(cq, CompactQuery)
    got = cq.get_ref_pos_batch(words)
    same_batch(got, MCompactQuery(ref, CAPACITY[name]).get_ref_pos_batch(words))
    same_batch(got, reference_mapper(name).tp.get_ref_pos_batch(words))
    assert got.to_lists()[:64] == ref.get_ref_pos_eager(words[:64])


@pytest.mark.parametrize("name", ["direct", "fast32"])
def test_compact_query_over_budget_reruns(name, monkeypatch):
    """A batch of 2,048 lanes that all overflow the main phase passes the
    first budget (1,024 slots): the batch runs again with 2,048 slots a
    phase, and the answer equals the reference's."""
    ref, port, _ = pair(name)
    words = words_of(name, 2048, seed=7, multi_only=True)
    monkeypatch.setenv("MAZU_HBM_BUDGET", SMALL_BUDGET)
    cq = mapping.query_driver(port, "cpu")
    budgets = []
    run = cq._run

    def spy(fw, m2, m2c):
        out = run(fw, m2, m2c)
        budgets.append((m2, m2c, bool(out["over_budget"])))
        return out

    monkeypatch.setattr(cq, "_run", spy)
    got = cq.get_ref_pos_batch(words)
    assert budgets == [(1024, None, True), (2048, 2048, False)]
    same_batch(got, reference_mapper(name).tp.get_ref_pos_batch(words))
    assert all(len(h) == 3 for h in got.to_lists())
