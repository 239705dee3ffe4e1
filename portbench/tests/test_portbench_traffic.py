"""The benchmark's generators at small sizes: the transcript set against
its gene models and the unitigs against a brute-force graph of the
transcripts, the traffic against the shares of ``mazu_tpu_torch.synth``'s
generators, and the k-mer words against the port's encoding."""

import numpy as np
import pytest
import torch

from mazu_tpu_torch import synth
from portbench.genomes import transcripts as GT
from mazu_tpu_torch.bits.seqvector import SeqVector
from mazu_tpu_torch.io.native import fastq_pack
from mazu_tpu_torch.io.reads import pack_reads
from mazu_tpu_torch.kmer import revcomp_np
from portbench import genome as G
from portbench.reference import kmers as K
from portbench.reference.lookup import Layout, locate
from portbench.traffic import kmers as TK
from portbench.traffic import reads as TR
from portbench.tests.small import small_spec

CPU = torch.device("cpu")


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """Packed words of 2-bit base codes, with the guard word."""
    n = codes.shape[0]
    c = torch.zeros(-(-n // 32) * 32, dtype=torch.int64)
    c[:n] = codes.to(torch.int64)
    words = (c.reshape(-1, 32) << (2 * torch.arange(32))).sum(dim=1)
    return torch.cat([words, torch.zeros(1, dtype=torch.int64)])


def test_kmer_words_match_the_port():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, 5000, dtype=np.uint8)
    sv = SeqVector.from_codes(codes)
    words = pack_codes(torch.from_numpy(codes))
    assert np.array_equal(words.numpy().view(np.uint64)[: len(sv.words) - 1], sv.words[:-1])
    pos = rng.integers(0, 5000 - 31, 2000)
    km = K.kmer_at(words, torch.from_numpy(pos), 31)
    assert np.array_equal(km.numpy().view(np.uint64), sv.get_kmer_u64(pos, 31))
    assert np.array_equal(K.revcomp(km, 31).numpy().view(np.uint64),
                          revcomp_np(km.numpy().view(np.uint64), 31))
    can = K.canonical(km, 31).numpy().view(np.uint64)
    assert np.array_equal(can, np.minimum(km.numpy().view(np.uint64),
                                          revcomp_np(km.numpy().view(np.uint64), 31)))
    assert np.array_equal(K.bases_at(words, torch.from_numpy(pos)).numpy(), codes[pos])
    rows = torch.from_numpy(codes[:1500].reshape(10, 150))
    w = K.words_of_codes(rows, 31)
    start = (np.arange(10)[:, None] * 150 + np.arange(120)).reshape(-1)
    assert np.array_equal(w.reshape(-1).numpy().view(np.uint64), sv.get_kmer_u64(start, 31))


def _seq(words: np.ndarray, start: int, n: int) -> np.ndarray:
    return K.bases_at(torch.from_numpy(words.view(np.int64)),
                      torch.arange(start, start + n)).numpy()


def test_transcripts_follow_the_gene_models():
    cfg = small_spec("tx50-mono2.kmers", n_genes=400)["config"]
    m = GT.transcripts(cfg, 3)
    t = np.bincount(GT.quantiles(400, cfg["transcripts_per_gene"]))
    assert m["n_tx"] == sum(i * c for i, c in enumerate(t)) == len(np.unique(m["te_tx"]))
    assert abs(m["n_tx"] / 400 - cfg["transcripts_per_gene"]) < 0.1
    assert m["exon_len"].min() >= cfg["k"] and m["exon_len"].max() <= cfg["exon_len_max"]
    assert abs(m["exon_len"].mean() - cfg["exon_len_mean"]) < 15
    per_tx = np.bincount(m["te_tx"])
    per_exon = np.bincount(m["te_exon"], minlength=len(m["exon_len"]))
    assert (per_exon >= 1).all() and 5.5 < per_tx.mean() < 7.5 and 1.9 < per_exon.mean() < 2.6
    # each transcript's exons in the gene's order, no transcript twice in a gene
    same = m["te_tx"][1:] == m["te_tx"][:-1]
    assert (m["te_exon"][1:][same] > m["te_exon"][:-1][same]).all()
    # the same gene models for every seed, in another order
    other = GT.transcripts(cfg, 2**40 + 9)
    assert other["n_tx"] == m["n_tx"] and not np.array_equal(other["te_exon"], m["te_exon"])
    assert np.array_equal(np.sort(other["exon_len"]), np.sort(m["exon_len"]))
    assert np.array_equal(np.sort(np.bincount(other["te_exon"])), np.sort(per_exon))
    assert np.array_equal(np.sort(np.bincount(other["te_tx"])), np.sort(per_tx))


@pytest.mark.parametrize("seed", [17, 2**40 + 3])
def test_unitigs_tile_the_transcripts_and_are_maximal(seed):
    cfg = small_spec("tx50-mono2.kmers", n_genes=25)["config"]
    g = G.make(cfg, seed, CPU)
    k = g.k
    refs = [_seq(g.ref_host_words, int(g.ref_accum[r]), int(g.ref_lens[r]))
            for r in range(len(g.ref_lens))]
    uni = [_seq(g.host_words, int(g.accum[u]), int(g.accum[u + 1] - g.accum[u]))
           for u in range(g.n_unitigs)]
    uid = np.repeat(np.arange(g.n_unitigs), np.diff(g.offsets))
    assert np.array_equal(uid, g.occ_uid) and (g.occ_o == 1).all()
    # each occurrence is its unitig's bases, and a reference's occurrences
    # tile it with overlaps of k - 1
    for r, seq in enumerate(refs):
        on = np.flatnonzero(g.occ_ref == r)
        on = on[np.argsort(g.occ_pos[on])]
        at = 0
        for i in on:
            u, p = int(g.occ_uid[i]), int(g.occ_pos[i])
            assert p == at and np.array_equal(seq[p : p + len(uni[u])], uni[u])
            at = p + len(uni[u]) - k + 1
        assert at == len(seq) - k + 1
    # the unitigs are the maximal ones: within a unitig each k-mer has one
    # successor, which has one predecessor; at its ends that fails or a
    # transcript starts or ends there
    kmer = lambda a, i: a[i : i + k].tobytes()  # noqa: E731
    succ, pred, firsts, lasts = {}, {}, set(), set()
    for seq in refs:
        firsts.add(kmer(seq, 0))
        lasts.add(kmer(seq, len(seq) - k))
        for i in range(len(seq) - k):
            succ.setdefault(kmer(seq, i), set()).add(kmer(seq, i + 1))
            pred.setdefault(kmer(seq, i + 1), set()).add(kmer(seq, i))

    def joined(x, y):
        return (succ.get(x) == {y} and pred.get(y) == {x} and x not in lasts
                and y not in firsts)

    seen = set()
    for u in uni:
        ks = [kmer(u, i) for i in range(len(u) - k + 1)]
        assert not seen & set(ks)
        seen |= set(ks)
        assert all(joined(x, y) for x, y in zip(ks, ks[1:]))
        assert not any(joined(ks[-1], y) for y in succ.get(ks[-1], ()))
        assert not any(joined(x, ks[0]) for x in pred.get(ks[0], ()))
    assert seen == set(succ) | set(pred) | firsts | lasts


def test_queries_are_uniform_over_the_reference_positions():
    n, k = 1 << 15, 31
    spec = small_spec("tx50-mono2.kmers")
    g = G.make(spec["config"], 21, CPU)
    mine = TK.sample(g, n, spec["mix"], G.torch_generator(np.random.default_rng(1), CPU))
    loc = locate(Layout(g, CPU), mine)
    found = (loc.count > 0).float().mean().item()
    assert abs(found - (1 - synth.FOREIGN_SHARE)) < 0.01 and spec["mix"]["foreign_share"] == 0.05
    hit = loc.count > 0
    fw = K.kmer_at(torch.from_numpy(g.host_words.view(np.int64)), loc.first[hit], k)
    rc_share = (mine[hit] != fw).float().mean().item()
    assert abs(rc_share - synth.RC_SHARE) < 0.02
    assert (mine >= 0).all() and (mine < 1 << 62).all()
    # a unitig is drawn as often as the references hold its k-mers
    uid = torch.searchsorted(torch.from_numpy(g.accum), loc.first[hit], right=True) - 1
    occ = torch.from_numpy(np.diff(g.offsets))[uid].float().mean().item()
    span = np.diff(g.accum) - k + 1
    per_kmer = (np.diff(g.offsets) * span).sum() / span.sum()
    assert per_kmer > 1.5 and abs(occ - (np.diff(g.offsets) ** 2 * span).sum()
                                  / (np.diff(g.offsets) * span).sum()) < 0.1 * occ


def test_reads_follow_serve_reads_truth():
    spec = small_spec("tx50-mono2.reads")
    mix = spec["mix"]
    g = G.make(spec["config"], 8, CPU)
    codes = TR.sample_codes(g, 20000, mix, np.random.default_rng(2))
    assert codes.shape == (20000, synth.READ_LEN)
    with_n = (codes == 4).any(axis=1).mean()
    assert abs(with_n - synth.N_SHARE) < 0.004 and mix["n_share"] == synth.N_SHARE
    assert mix["foreign_share"] == synth.FOREIGN_READS and mix["rc_share"] == synth.RC_SHARE
    clean = torch.from_numpy(np.where(codes > 3, 0, codes))[:2000]
    loc = locate(Layout(g, CPU), K.words_of_codes(clean, 31))
    per_read = (loc.count.reshape(2000, -1) > 0).any(dim=1).float().mean().item()
    assert abs(per_read - (1 - synth.FOREIGN_READS)) < 0.02
    # a read lies on one reference: all its k-mers but those with an N hit
    hits = (loc.count.reshape(2000, -1) > 0).sum(dim=1)
    full = hits == codes.shape[1] - 30
    assert full.float().mean().item() > 1 - synth.FOREIGN_READS - synth.N_SHARE - 0.02


def test_fastq_text_packs_as_the_port_packs_its_reads():
    spec = small_spec("tx50-mono2.reads")
    g = G.make(spec["config"], 9, CPU)
    codes = TR.sample_codes(g, 600, spec["mix"], np.random.default_rng(5))
    text = TR.fastq_text(codes, 1000)
    assert np.array_equal(TR.parse_codes(text), codes)
    reads = [bytes(np.frombuffer(b"ACGTN", np.uint8)[c]).decode() for c in codes]
    got, want = fastq_pack(text, 31), pack_reads(reads, 31)
    assert got["meta"] == want["meta"] and got["meta"].has_bad
    for key in ("words", "lengths", "bad"):
        assert np.array_equal(got[key], want[key])
    assert text.startswith(b"@00001000\n") and text.count(b"\n") == 4 * 600


@pytest.mark.parametrize("seed", [0, 2**31 + 7, 2**40 + 1])
def test_same_seed_same_inputs(seed):
    spec = small_spec("tx50-mono2.reads")
    a, b = (G.make(spec["config"], seed, CPU) for _ in range(2))
    assert np.array_equal(a.host_words, b.host_words) and np.array_equal(a.occ_pos, b.occ_pos)
    assert np.array_equal(a.ref_host_words, b.ref_host_words)
    ta, tb = (TR.Traffic(spec, a, seed, CPU).text for _ in range(2))
    assert ta == tb
