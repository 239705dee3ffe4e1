"""The host accessors of ``mazu_tpu`` that the port took last: each against
the reference's result on the same data (``UnitigSet``,
``RefSeqCollection``, ``SPT``, ``DenseUnitigTable``, ``SSHash``,
``BitVector``, ``io.pf1``)."""

import struct

import numpy as np
import pytest

from mazu_tpu.bits.bitvector import BitVector as MBitVector
from mazu_tpu.containers.refseq import RefSeqCollection as MRefs
from mazu_tpu.containers.unitig_set import UnitigSet as MUnitigs
from mazu_tpu.index.spt import SPT as MSPT

from mazu_tpu_torch.bits.bitvector import BitVector
from mazu_tpu_torch.containers.refseq import RefSeqCollection
from mazu_tpu_torch.containers.unitig_set import UnitigSet
from mazu_tpu_torch.index.spt import SPT

from torch_fixtures import build_capacity_pair, build_mphf_pair, seq_recipe, toy_recipe


@pytest.fixture(scope="module")
def sets():
    (seqs, k, occ, lens), ref_seqs = seq_recipe()
    names = [f"r{i}" for i in range(len(lens))]
    mus, pus = MUnitigs.from_seqs(seqs, k), UnitigSet.from_seqs(seqs, k)
    return {"m_us": mus, "p_us": pus, "m_spt": MSPT(mus, names, *occ, lens),
            "p_spt": SPT(pus, names, *occ, lens), "ref_seqs": ref_seqs, "names": names}


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_unitig_set_accessors(sets):
    m, p = sets["m_us"], sets["p_us"]
    for i in (0, 5, m.n_unitigs - 1):
        assert p.unitig_seq_str(i) == m.unitig_seq_str(i)
    _same(p.all_canonical_kmers(), m.all_canonical_kmers())
    ep, em = p.ef_accum_lens(), m.ef_accum_lens()
    assert ep.num_bits() == em.num_bits()
    _same(ep.to_array(), em.to_array())
    lp, lm = [], []
    p.print_stats(lp.append)
    m.print_stats(lm.append)
    assert lp == lm


def test_refseq_accessors(sets, tmp_path):
    from torch_fixtures import write_fasta

    path = str(tmp_path / "r.fa")
    write_fasta(path, sets["ref_seqs"])
    m, p = MRefs.from_fasta(path), RefSeqCollection.from_fasta(path)
    assert p.total_len == m.total_len
    _same(p.ref_len(np.arange(3)), m.ref_len(np.arange(3)))
    assert p.ref_len(2) == m.ref_len(2)
    for i in (0, 7):
        assert p.ref_seq_str(i) == m.ref_seq_str(i)
    dm, dp = MRefs.dummy(), RefSeqCollection.dummy()
    assert (dp.n_refs, dp.total_len, dp.has_seq, dp.names) == (dm.n_refs, dm.total_len,
                                                                dm.has_seq, dm.names)
    _same(dp.prefix_sum, dm.prefix_sum)
    lens = RefSeqCollection.from_lens([5, 7])
    assert lens.total_len == 12
    with pytest.raises(ValueError):
        lens.ref_seq_str(0)


def test_spt_accessors(sets):
    m, p = sets["m_spt"], sets["p_spt"]
    assert (p.n_total_occs, p.k) == (m.n_total_occs, m.k)
    for uid in range(m.unitigs.n_unitigs):
        n = int(m.offsets[uid + 1] - m.offsets[uid])
        for i in range(n):
            assert p.get_occ(uid, i) == m.get_occ(uid, i)


def test_dense_unitig_table_accessors(sets):
    m, p = sets["m_spt"].dense_table(), sets["p_spt"].dense_table()
    assert p.n_total_occs == m.n_total_occs
    for uid in range(m.n_unitigs):
        for a, b in zip(p.occs(uid), m.occs(uid)):
            _same(a, b)


@pytest.mark.parametrize("build", [build_capacity_pair, build_mphf_pair],
                         ids=["direct", "fast32"])
def test_sshash_ef_occs_prefix_sum(build):
    ref, port = build(toy_recipe())
    ep, em = port.k2u.ef_occs_prefix_sum(), ref.k2u.ef_occs_prefix_sum()
    assert ep.num_bits() == em.num_bits()
    _same(ep.to_array(), em.to_array())
    assert port.k2u.num_bits() == ref.k2u.num_bits()


def test_bitvector_get_bit():
    rng = np.random.default_rng(3)
    bits = rng.random(1000) < 0.3
    pos = np.flatnonzero(bits)
    m, p = MBitVector.from_set_positions(pos, 1000), BitVector.from_set_positions(pos, 1000)
    q = rng.integers(0, 1000, 300)
    _same(p.get_bit(q), m.get_bit(q))
    assert bool(p.get_bit(int(pos[0]))) and p.get_bit(q).tolist() == bits[q].tolist()


def test_pf1_get_bits_per_element(tmp_path):
    from mazu_tpu.io.pf1 import get_bits_per_element as m_bits
    from mazu_tpu_torch.io.pf1 import get_bits_per_element

    path = tmp_path / "v.bin"
    path.write_bytes(struct.pack("<QQQ", 0, 27, 5) + b"\0" * 32)
    assert get_bits_per_element(str(path)) == m_bits(str(path)) == 27
    path.write_bytes(b"\0" * 10)  # the port reads whole words or raises
    from mazu_tpu_torch.err import TruncatedFile

    with pytest.raises(TruncatedFile, match="expected 8 bytes, got 2"):
        get_bits_per_element(str(path))
