"""The port's NumPy builders give arrays byte-identical to mazu_tpu's."""

import numpy as np
import pytest

from torch_fixtures import build_pair, mono2_recipe, toy_recipe


@pytest.fixture(scope="module")
def toy():
    import __graft_entry__ as g

    return g._toy_index()


@pytest.fixture(scope="module", params=["mono2_dict", "toy"])
def pair(request):
    if request.param == "mono2_dict":
        return build_pair(mono2_recipe())
    return build_pair(toy_recipe(request.getfixturevalue("toy")))


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("key", ["table", "side"])
def test_kcdict_tables(pair, key):
    ref, port = pair
    want, got = ref.device_arrays(fused=True)["k2u"], port.device_arrays()["k2u"]
    assert (key in want) == (key in got)
    if key in want:
        _same(got[key], want[key], key)


def test_kcdict_meta(pair):
    ref, port = pair
    want = ref.device_arrays(fused=True)["k2u"]["meta"]
    got = port.device_arrays()["k2u"]["meta"]
    assert got.kv == want.kv
    assert got.side_t > 0, "fixture lost its side table"
    assert got.occ32 and got.scheme == "mono2"


def test_u2pos_arrays(pair):
    ref, port = pair
    want, got = ref.u2pos.device_arrays(), port.u2pos.device_arrays()
    _same(got["offsets"], want["offsets"], "offsets")
    _same(got["ctable2"], want["ctable2"], "ctable2")
    _same(got["ctable"]["words"], want["ctable"]["words"], "ctable words")
    assert got["ctable"]["meta"].kv == want["ctable"]["meta"].kv
    assert got["meta"].kv == want["meta"].kv
    assert port.max_occs() == ref.max_occs()


def test_unitig_set(pair):
    ref, port = pair
    mu, pu = ref.k2u.unitigs, port.k2u.unitigs
    _same(pu.useq.words, mu.useq.words, "useq words")
    _same(pu.accum, mu.accum, "accum")
    kpos = pu.kmer_start_positions()
    _same(kpos, mu.kmer_start_positions(), "kmer_start_positions")
    _same(pu.get_kmer_u64(kpos), mu.get_kmer_u64(kpos), "get_kmer_u64")
    _same(pu.pos_to_id(kpos), mu.pos_to_id(kpos), "pos_to_id")
    assert pu.n_kmers == mu.n_kmers


def test_toy_rekey_is_the_literal_rekey(toy):
    """Rebuilding the toy from its own unitigs and occurrences gives the
    same dictionary as re-keying the toy index in place."""
    from mazu_tpu.kphf.kcdict import KCDict

    direct = KCDict.from_unitig_set(
        toy.k2u.unitigs, occ_table=toy.u2pos, scheme="mono2", load=0.25
    ).device_arrays()
    ref, _ = build_pair(toy_recipe(toy))
    rebuilt = ref.k2u.device_arrays()
    _same(rebuilt["table"], direct["table"], "table")
    _same(rebuilt["side"], direct["side"], "side")


@pytest.mark.parametrize("width", [None, 7, 28, 58])
def test_intvector(width):
    from mazu_tpu.bits.intvector import IntVector as MIV
    from mazu_tpu_torch.bits.intvector import IntVector

    rng = np.random.default_rng(width or 1)
    hi = 1 << (width or 20)
    v = rng.integers(0, hi, 1000, dtype=np.uint64)
    got, want = IntVector.from_array(v, width), MIV.from_array(v, width)
    _same(got.words, want.words, "words")
    assert (got.width, got.length) == (want.width, want.length)
    np.testing.assert_array_equal(got.to_array(), v)


def test_seqvector_from_codes():
    from mazu_tpu.bits.seqvector import SeqVector as MSV
    from mazu_tpu_torch.bits.seqvector import SeqVector

    for n in (0, 1, 31, 32, 33, 1000):
        codes = np.random.default_rng(n).integers(0, 4, n, dtype=np.uint8)
        _same(SeqVector.from_codes(codes).words, MSV.from_codes(codes).words, f"n={n}")


def test_synth_index_matches_reference_builder():
    """``synth.build_index`` equals the reference builders fed the same
    genome and occurrences (at a small size)."""
    from mazu_tpu.bits.seqvector import SeqVector as MSV
    from mazu_tpu.containers.unitig_set import UnitigSet as MUnitigs
    from mazu_tpu.index.spt import SPT as MSPT
    from mazu_tpu.kphf.kcdict import KCDict as MKCDict

    from mazu_tpu_torch import synth

    n_bases = 40 * synth.PIECE
    unitigs, _, u2pos = synth.build_synthetic(n_bases, seed=0)
    port = synth.build_index(n_bases, seed=0)
    mus = MUnitigs(31, MSV(unitigs.useq.words, n_bases), unitigs.accum)
    n = unitigs.n_unitigs
    # the synthetic occurrence lists, decoded from the port's table
    words = u2pos.ctable.to_array()
    uid = np.repeat(np.arange(n), np.diff(u2pos.offsets))
    rid = (words >> np.uint64(u2pos.ref_shift)).astype(np.int64)
    pos = ((words >> np.uint64(1)) & np.uint64(u2pos.pos_mask)).astype(np.int64)
    o = (words & np.uint64(1)).astype(np.int64)
    assert np.bincount(uid, minlength=n).max() == 3
    mu2 = MSPT(mus, [f"r{i}" for i in range(n)], uid, rid, pos, o,
               np.full(n, synth.PIECE)).piscem_table()
    mkc = MKCDict.from_unitig_set(mus, occ_table=mu2, scheme="mono2", load=0.25)
    want, got = mkc.device_arrays(), port.k2u.device_arrays()
    assert got["meta"].kv == want["meta"].kv
    _same(got["table"], want["table"], "table")
    _same(got["side"], want["side"], "side")
    _same(port.u2pos.device_arrays()["ctable2"], mu2.device_arrays()["ctable2"], "ctable2")


@pytest.mark.parametrize("i", [0, 1, 4])
def test_refseq_collection(i):
    from mazu_tpu.bits.seqvector import SeqVector as MSV
    from mazu_tpu.containers.refseq import RefSeqCollection as MRefs
    from mazu_tpu_torch.bits.seqvector import SeqVector
    from mazu_tpu_torch.containers.refseq import RefSeqCollection

    rng = np.random.default_rng(i)
    lens = rng.integers(40, 90, 5)
    seq = "".join(rng.choice(list("ACGT"), int(lens.sum())))
    prefix = np.concatenate([[0], np.cumsum(lens)])
    got = RefSeqCollection(SeqVector.from_str(seq), prefix, [f"r{j}" for j in range(5)])
    want = MRefs(MSV.from_str(seq), prefix, [f"r{j}" for j in range(5)])
    assert got.n_refs == want.n_refs == 5
    _same(got.ref_kmers(i, 21), want.ref_kmers(i, 21), "ref_kmers")
    gd, wd = got.device_arrays(), want.device_arrays()
    _same(gd["prefix_sum"], wd["prefix_sum"], "prefix_sum")
    _same(gd["seq"]["words"], wd["seq"]["words"], "seq words")
    assert gd["meta"].kv == wd["meta"].kv
    lens_only = RefSeqCollection.from_lens(lens)
    _same(lens_only.prefix_sum, MRefs.from_lens(lens).prefix_sum, "from_lens")
    assert not lens_only.has_seq
