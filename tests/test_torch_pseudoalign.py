"""Pseudo-alignment of the port against mazu_tpu's, with tolerance 0:
the halving-tree reduction against ``np.bitwise_and``/``or.reduce`` on
rows with bit 63 set, at every L up to 17 and at 120; ``pseudoalign_from_k2u``
and ``pseudoalign_batch`` (intersect, union), ``tau_q32``,
``pseudoalign_threshold_batch`` over several taus, ``classify_kmers``, the
host threshold count, and ``PseudoAligner.map_reads``/``map_file`` in all
three policies (threshold counted on the device and on the host), on reads
with misses, non-ACGT bases and a read with no hit."""

import numpy as np
import pytest
import torch

from mazu_tpu.index import pseudoalign as mp
from mazu_tpu.index.modindex import k2u_batch as m_k2u_batch
from mazu_tpu.index.streaming import kmerize_reads

from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index import pseudoalign as pp
from mazu_tpu_torch.index.modindex import k2u_batch
from mazu_tpu_torch.synth import serve_reads, write_fastq

from torch_fixtures import (
    assert_same, build_pair, seq_recipe, tensor, with_refs, write_fasta,
)

TAUS = (0.25, 0.5, 0.7, 1.0, 1e-9)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    recipe, seqs = seq_recipe(n_refs=70, length=200, every=3)
    fasta = tmp_path_factory.mktemp("pseudoalign") / "refs.fa"
    write_fasta(fasta, seqs)
    ref, port = with_refs(build_pair(recipe), fasta)
    reads = serve_reads(port.refs, 48, seed=2, n_share=0.2, foreign_share=0.1)
    reads += ["GATTACA" * 15, "ACGT", ""]  # no hit; shorter than k; empty
    reads[3] = reads[3][:40]
    kmat, valid, _ = kmerize_reads(reads, ref.k)
    mcb = mp.color_bitsets(ref.color_classes())
    cb = arrays_from_numpy(pp.color_bitsets(port.color_classes()), "cpu")
    host = ref.device_arrays()
    d = arrays_from_numpy(port.device_arrays(), "cpu")
    return ref, port, reads, kmat, valid, mcb, cb, host, d


@pytest.mark.parametrize("L", list(range(1, 18)) + [120])
def test_reduce_rows(L):
    rng = np.random.default_rng(L)
    rows = rng.integers(0, 1 << 64, (5, L, 3), dtype=np.uint64) | np.uint64(1 << 63)
    rows[0] = np.uint64((1 << 64) - 1)
    for op, red in ((torch.bitwise_and, np.bitwise_and), (torch.bitwise_or, np.bitwise_or)):
        got = pp._reduce_rows(tensor(rows.reshape(-1)).reshape(rows.shape), op)
        assert_same(got, red.reduce(rows, axis=1))


@pytest.mark.parametrize("policy", ["intersect", "union"])
def test_pseudoalign_batch(case, policy):
    ref, port, reads, kmat, valid, mcb, cb, host, d = case
    want = mp.pseudoalign_batch(host, mcb, kmat, valid, np, policy)
    got = pp.pseudoalign_batch(d, cb, tensor(kmat.reshape(-1)).reshape(kmat.shape),
                               torch.from_numpy(valid), policy)
    for g, w in zip(got, want):
        assert_same(g, w)
    assert int(got[1][-3]) == 0 and not bool(got[0][-3].any())  # the read with no hit
    r = k2u_batch(d, tensor(kmat.reshape(-1)))
    got2 = pp.pseudoalign_from_k2u(cb, r, torch.from_numpy(valid), policy)
    want2 = mp.pseudoalign_from_k2u(mcb, m_k2u_batch(host, kmat.reshape(-1), np),
                                    valid, np, policy)
    for g, w in zip(got2, want2):
        assert_same(g, w)


@pytest.mark.parametrize("tau", TAUS + (0.1, 0.3333333))
def test_tau_q32(tau):
    assert pp.tau_q32(tau) == mp.tau_q32(tau)


@pytest.mark.parametrize("tau", TAUS)
def test_threshold_batch(case, tau):
    ref, port, reads, kmat, valid, mcb, cb, host, d = case
    num = mp.tau_q32(tau)
    want = mp.pseudoalign_threshold_batch(host, mcb, kmat, valid, np, num)
    got = pp.pseudoalign_threshold_batch(d, cb, tensor(kmat.reshape(-1)).reshape(kmat.shape),
                                         torch.from_numpy(valid), num)
    for g, w in zip(got, want):
        assert_same(g, w)


def test_classify_and_host_count(case):
    ref, port, reads, kmat, valid, mcb, cb, host, d = case
    want = mp.classify_kmers(host, mcb, kmat, valid, np)
    got = pp.classify_kmers(d, cb, tensor(kmat.reshape(-1)).reshape(kmat.shape),
                            torch.from_numpy(valid))
    for g, w in zip(got, want):
        assert_same(g, w)
    # the host count equals the device count for every tau
    cc = port.color_classes()
    cid, hit = (t.numpy() for t in got)
    for tau in TAUS:
        num = pp.tau_q32(tau)
        bits, _, _ = pp.pseudoalign_threshold_batch(
            d, cb, tensor(kmat.reshape(-1)).reshape(kmat.shape), torch.from_numpy(valid), num)
        unpacked = np.unpackbits(bits.numpy().view(np.uint8), bitorder="little", axis=1)
        for i, (refs, n_hit, n_k) in enumerate(pp.count_threshold_host(cc, cid, hit, valid,
                                                                        num)):
            np.testing.assert_array_equal(refs, np.flatnonzero(unpacked[i][: cc.n_refs]))


@pytest.mark.parametrize("policy,on", [("intersect", "device"), ("union", "device"),
                                       ("threshold", "device"), ("threshold", "host")])
def test_pseudoaligner(case, policy, on, tmp_path):
    ref, port, reads, kmat, valid, mcb, cb, host, d = case
    want = mp.PseudoAligner(ref, use_jit=False, policy=policy, tau=0.7,
                            threshold_on=on).map_reads(reads)
    pa = pp.PseudoAligner(port, policy=policy, tau=0.7, threshold_on=on, device="cpu")
    got = pa.map_reads(reads)
    assert len(got) == len(want)
    for (gr, gh, gk), (wr, wh, wk) in zip(got, want):
        np.testing.assert_array_equal(gr, wr)
        assert (gh, gk) == (wh, wk)
    assert any(len(r) > 1 for r, _, _ in want) and want[-3][1] == 0
    path = str(tmp_path / "reads.fastq.gz")
    write_fastq(path, reads)
    for (gr, gh, gk), (wr, wh, wk) in zip(pa.map_file(path), want):
        np.testing.assert_array_equal(gr, wr)
        assert (gh, gk) == (wh, wk)
