"""The port's readers and read k-merization against mazu_tpu's, with
tolerance 0: the k-mer text helpers; FASTA and FASTQ (multi-line, gzipped,
malformed: the same exception classes and messages); ``read_seqs``'
sniffing; ``RefSeqCollection.from_fasta``; the cuttlefish files and
``UnitigSet.from_cf``; ``pack_reads``/``pack_fastq`` (byte for byte) and
``kmerize_device`` (equal to both packages' host ``kmerize_reads``) on
reads shorter than, equal to and longer than k, with N at the first, the
last and word-boundary bases, windows that start at bits 62 and 63 of a
word, and the empty batch; ``pad_reads`` against the reference's packing
of the same batch with a longer read added."""

import gzip
import json

import numpy as np
import pytest
import torch

import mazu_tpu.kmer as mk
from mazu_tpu import err as merr
from mazu_tpu.containers.refseq import RefSeqCollection as MRefs
from mazu_tpu.containers.unitig_set import UnitigSet as MUnitigs
from mazu_tpu.index.streaming import kmerize_reads as m_kmerize_reads
from mazu_tpu.io import cuttlefish as mcf
from mazu_tpu.io.fasta import open_binary as m_open_binary
from mazu_tpu.io.fasta import read_fasta as m_read_fasta
from mazu_tpu.io.fastq import read_fastq as m_read_fastq
from mazu_tpu.io.fastq import read_seqs as m_read_seqs
from mazu_tpu.io.reads import kmerize_device as m_kmerize_device
from mazu_tpu.io.reads import pack_fastq as m_pack_fastq
from mazu_tpu.io.reads import pack_reads as m_pack_reads

import mazu_tpu_torch.kmer as pk
from mazu_tpu_torch import err as perr
from mazu_tpu_torch.containers.refseq import RefSeqCollection
from mazu_tpu_torch.containers.unitig_set import UnitigSet
from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index.streaming import kmerize_reads
from mazu_tpu_torch.io import cuttlefish as pcf
from mazu_tpu_torch.io.fasta import open_binary, read_fasta
from mazu_tpu_torch.io.fastq import read_fastq, read_seqs
from mazu_tpu_torch.io.reads import kmerize_device, pack_fastq, pack_reads, pad_reads
from mazu_tpu_torch.synth import write_fastq

from torch_fixtures import assert_same, same_tree

K = 31
RNG = np.random.default_rng(21)


def _seq(n: int) -> str:
    return "".join(RNG.choice(list("ACGT"), n))


def _with_n(s: str, at: int) -> str:
    return s[:at] + "N" + s[at + 1 :]


# ------------------------------------------------------------ k-mer text


def test_kmer_text_helpers():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, 100, dtype=np.uint8)
    assert pk.codes_to_seq(codes) == mk.codes_to_seq(codes)
    for s in ("A", "ACGT", _seq(31), "acgtT"):
        w = pk.kmer_from_str(s)
        assert w == mk.kmer_from_str(s) and type(w) is type(mk.kmer_from_str(s))
        assert pk.kmer_to_str(w, len(s)) == mk.kmer_to_str(w, len(s)) == s.upper()
    with pytest.raises(AssertionError, match="invalid base"):
        pk.kmer_from_str("ACNT")
    # a word with bit 63 set read as an int64 bit pattern
    w = np.uint64(0xC000000000000001)
    assert pk.kmer_to_str(np.array(w).view(np.int64), 32) == mk.kmer_to_str(w, 32)
    mt = np.array([0, 1, 2, 1, 0, 2], dtype=np.uint8)
    assert_same(pk.reverse_match_type(torch.from_numpy(mt)), mk.reverse_match_type(mt))


# ------------------------------------------------------------ FASTA / FASTQ


@pytest.mark.parametrize("gz", [False, True])
def test_read_fasta(tmp_path, gz):
    text = ">r1 first ref\nACGTAC\nGTNNac\n>r2\n\n>r3\nTTTT\nGG"
    p = str(tmp_path / ("refs.fa" + (".gz" if gz else "")))
    with (gzip.open(p, "wt") if gz else open(p, "w")) as f:
        f.write(text)
    assert list(read_fasta(p)) == list(m_read_fasta(p)) == [
        ("r1 first ref", "ACGTACGTNNac"), ("r2", ""), ("r3", "TTTTGG")]
    assert list(read_seqs(p)) == list(m_read_seqs(p))
    with open_binary(p) as f, m_open_binary(p) as g:
        assert f.read() == g.read() == text.encode()


FASTQ_OK = {
    "basic": "@r1 comment\nACGTACGT\n+\nIIIIIIII\n@r3\nTTTT\n+\n@@@@\n",
    "multi-line": "@r2\nACGT\nACGT\n+r2\nIIII\nIIII\n@r4\nA\n+\n#",
    "blank lines": "\n@a\nACGTAC\n+\n!!!!!!\n\n",
}
FASTQ_BAD = {
    "fasta header": ">r1\nACGT\n+\nIIII\n",
    "short quality": "@r1\nACGTACGT\n+\nII\n",
    "long quality": "@r1\nACGTACGT\n+\nIIIIIIIIII\n",
    "no plus": "@r1\nACGTACGT\n",
}


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("name", list(FASTQ_OK))
def test_read_fastq(tmp_path, name, gz):
    p = str(tmp_path / ("r.fastq" + (".gz" if gz else "")))
    with (gzip.open(p, "wt") if gz else open(p, "w")) as f:
        f.write(FASTQ_OK[name])
    want = list(m_read_fastq(p))
    assert want and list(read_fastq(p)) == want
    # a leading blank line makes both sniff FASTA
    assert list(read_seqs(p)) == list(m_read_seqs(p))


@pytest.mark.parametrize("name", list(FASTQ_BAD))
def test_read_fastq_malformed(tmp_path, name):
    p = str(tmp_path / "bad.fastq")
    with open(p, "w") as f:
        f.write(FASTQ_BAD[name])
    with pytest.raises(merr.InvalidData) as want:
        list(m_read_fastq(p))
    with pytest.raises(perr.InvalidData) as got:
        list(read_fastq(p))
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError) and isinstance(got.value, perr.MazuError)


def test_refseq_from_fasta(tmp_path):
    p = str(tmp_path / "refs.fa.gz")
    with gzip.open(p, "wt") as f:
        f.write(">a\nacgtNNRY\nACGT\n>short\nAC\n>c\n" + _seq(100) + "\n")
    for min_len in (0, 5):
        got, want = RefSeqCollection.from_fasta(p, min_len), MRefs.from_fasta(p, min_len)
        assert got.names == want.names
        np.testing.assert_array_equal(got.prefix_sum, want.prefix_sum)
        np.testing.assert_array_equal(got.seq.words, want.seq.words)
        same_tree(got.device_arrays(), want.device_arrays())
    empty = str(tmp_path / "empty.fa")
    open(empty, "w").close()
    assert RefSeqCollection.from_fasta(empty).n_refs == MRefs.from_fasta(empty).n_refs == 0


# ------------------------------------------------------------ cuttlefish


def _write_cf(prefix, segs, tiling, k):
    with open(prefix + ".cf_seg", "w") as f:
        f.write("".join(f"{cfid}\t{s}\n" for cfid, s in segs) + "\n")
    with open(prefix + ".cf_seq", "w") as f:
        f.write("".join(f"{name}\t{' '.join(toks)}\n" for name, toks in tiling))
    with open(prefix + ".json", "w") as f:
        json.dump({"parameters info": {"k": k},
                   "contigs info": {"maximal unitig count": len(segs),
                                    "sum maximal unitig length": sum(len(s) for _, s in segs)}},
                  f)


def test_from_cf(tmp_path):
    prefix = str(tmp_path / "g")
    segs = [(17, _seq(40)), (3, _seq(31)), (250, _seq(77))]
    tiling = [("chrA", ["17+", "N12", "3-"]), ("chrB", ["250-", "17-", "N1"])]
    _write_cf(prefix, segs, tiling, K)
    cf, mcf_ = pcf.CfFiles(prefix), mcf.CfFiles(prefix)
    info, minfo = pcf.CfInfo.from_path(cf.json), mcf.CfInfo.from_path(mcf_.json)
    assert (info.k, info.n_unitigs, info.total_len) == (minfo.k, minfo.n_unitigs, minfo.total_len)
    assert list(pcf.iter_segs(cf)) == list(mcf.iter_segs(mcf_))
    got = [(n, [(t.is_unitig, t.n, t.id, t.o) for t in toks]) for n, toks in pcf.iter_tiling(cf)]
    want = [(n, [(t.is_unitig, t.n, t.id, t.o) for t in toks])
            for n, toks in mcf.iter_tiling(mcf_)]
    assert got == want
    us, ids = UnitigSet.from_cf(cf)
    mus, mids = MUnitigs.from_cf(mcf_)
    assert ids == mids == {17: 0, 3: 1, 250: 2}
    assert us.k == mus.k == K
    np.testing.assert_array_equal(us.accum, mus.accum)
    np.testing.assert_array_equal(us.useq.words, mus.useq.words)
    np.testing.assert_array_equal(us.bv.words, mus.bv.words)


@pytest.mark.parametrize("token", ["X+", "", "N", "+", "Nx"])
def test_cf_token_errors(token):
    with pytest.raises(merr.CfSeqTokenParseError) as want:
        mcf.CfSeqToken.parse(token)
    with pytest.raises(perr.CfSeqTokenParseError) as got:
        pcf.CfSeqToken.parse(token)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ packing


def _read_sets() -> dict:
    s150 = _seq(150)
    return {
        "empty": [],
        "shorter than k": ["ACG", _seq(K - 1)],
        "exactly k": [_seq(K), _seq(K)],
        "31/32/33/150": [_seq(31), _seq(32), _seq(33), s150],
        "N first": [_with_n(_seq(60), 0)],
        "N last": [_with_n(_seq(60), 59), _with_n(_seq(K), K - 1)],
        # base 31 is the last of the first word (bits 62-63), base 63 of the
        # bad mask's first word is bit 63
        "N at word bounds": [_with_n(s150, 31), _with_n(s150, 32), _with_n(s150, 63),
                             _with_n(s150, 64), _with_n(_with_n(s150, 63), 127)],
        "all N and IUPAC": ["N" * 40, "NRN" + _seq(70), "acgt" * 10, ""],
        "mixed lengths": [_seq(int(n)) for n in RNG.integers(0, 160, 37)],
    }


READ_SETS = _read_sets()


@pytest.mark.parametrize("name", list(READ_SETS))
def test_pack_reads(name):
    reads = READ_SETS[name]
    same_tree(pack_reads(reads, K), m_pack_reads(reads, K))


@pytest.mark.parametrize("name", list(READ_SETS))
def test_kmerize_device(name):
    reads = READ_SETS[name]
    want_km, want_v = m_kmerize_device(m_pack_reads(reads, K), np)
    km, v = kmerize_device(arrays_from_numpy(pack_reads(reads, K), "cpu"))
    assert_same(km, want_km, "kms")
    assert_same(v, want_v, "valid")
    host_km, host_v, host_pos = kmerize_reads(reads, K)
    m_km, m_v, m_pos = m_kmerize_reads(reads, K)
    np.testing.assert_array_equal(host_km, m_km)
    np.testing.assert_array_equal(host_v, m_v)
    np.testing.assert_array_equal(host_pos, m_pos)
    np.testing.assert_array_equal(host_km, want_km)
    np.testing.assert_array_equal(host_v, want_v)


@pytest.mark.parametrize("name", list(READ_SETS))
def test_pad_reads(name):
    """A batch padded to 200 bases is, row for row, the reference's packing
    of it with a 200-base read added, and k-merizes the same."""
    reads, pad = READ_SETS[name], 200
    R = len(reads)
    got = pad_reads(pack_reads(reads, K), pad)
    want = m_pack_reads(reads + [_seq(pad)], K)
    m, wm = got["meta"], want["meta"]
    assert (m.R, m.stride, m.L, m.k, m.has_bad) == (R, wm.stride, wm.L, K, wm.has_bad)
    np.testing.assert_array_equal(got["words"][:-1], want["words"][: R * m.stride // 32])
    assert got["words"][-1] == 0 and len(got["words"]) == R * m.stride // 32 + 1
    np.testing.assert_array_equal(got["lengths"], want["lengths"][:R])
    if m.has_bad:
        nb = R * m.stride // 8
        bad, want_bad = got["bad"].view(np.uint8), want["bad"].view(np.uint8)
        np.testing.assert_array_equal(bad[:nb], want_bad[:nb])
        assert not bad[nb:].any() and len(bad) >= nb + 8
    if R:
        want_km, want_v = m_kmerize_device(want, np, 0, R)
        km, v = kmerize_device(arrays_from_numpy(got, "cpu"))
        assert_same(km, want_km, "kms")
        assert_same(v, want_v, "valid")


def test_pad_reads_bounds():
    packed = pack_reads([_seq(150), _seq(90)], K)
    assert pad_reads(packed, 150) is packed
    m = pad_reads(packed, 151)["meta"]
    assert (m.stride, m.L) == (160, 121)
    with pytest.raises(ValueError, match="a read of 150 bases; the batch is padded to 149"):
        pad_reads(packed, 149)


def test_windows_start_on_word_bits_62_and_63():
    """A read's k-mer at base 31 starts at bit 62 of its first word; its
    bad-mask window at base 63 starts at bit 63: both straddle two words,
    and the last window reads the pad word."""
    s = _seq(150)
    reads = [s, _with_n(s, 70), _seq(128)]
    packed = pack_reads(reads, K)
    km, v = kmerize_device(arrays_from_numpy(packed, "cpu"))
    want = [pk.kmer_from_str(s[i : i + K]) for i in (31, 63, 150 - K)]
    got = km[0, [31, 63, 150 - K]].numpy().view(np.uint64)
    np.testing.assert_array_equal(got, want)
    # the N at base 70 ends the windows starting at 40..70; the rest move left
    assert int(v[1].sum()) == 150 - K + 1 - K
    assert pk.kmer_from_str(s[71 : 71 + K]) == km[1, 40].numpy().view(np.uint64)
    assert bool(v[2, 128 - K]) and not bool(v[2, 128 - K + 1])


def test_kmerize_device_row_window():
    reads = [_seq(int(n)) for n in RNG.integers(20, 150, 12)]
    reads[5] = _with_n(reads[5], 3)
    packed = pack_reads(reads, K)
    d = arrays_from_numpy(packed, "cpu")
    for start, rows in ((0, 12), (4, 4), (11, 1)):
        want_km, want_v = m_kmerize_device(packed, np, start, rows)
        km, v = kmerize_device(d, start, rows)
        assert_same(km, want_km, f"{start}:{rows}")
        assert_same(v, want_v, f"{start}:{rows}")


@pytest.mark.parametrize("suffix", [".fastq", ".fastq.gz"])
def test_pack_fastq(tmp_path, suffix):
    reads = [_seq(int(n)) for n in RNG.integers(40, 180, 33)]
    reads[3] = _with_n(reads[3], 7)
    reads[6] = reads[6].lower()
    path = str(tmp_path / ("reads" + suffix))
    write_fastq(path, reads)
    same_tree(pack_fastq(path, K), m_pack_fastq(path, K))
    bad = str(tmp_path / "bad.fastq")
    with open(bad, "w") as f:
        f.write("@r\nACGT\n+\nII\n")
    with pytest.raises(perr.InvalidData):
        pack_fastq(bad, K)
