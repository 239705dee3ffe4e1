"""Checkpoints cross between the packages: ``mazu_tpu`` writes and
``mazu_tpu_torch`` reads, and the reverse, for every K2U the port has (the
KCDict's mono, mono2-occ32 and mono2 layouts, the SSHash's parity, fast32
and direct engines with either skew table, PFHash, SampledPFHash), whole
indexes and bare K2Us. After each crossing, the file the reader writes back
holds the same keys and the same bytes as the one it read, the loaded
index's arrays equal those the writer's package loads from the same file,
and a query on them equals the reference's. A cuckoo KCDict crosses in
both directions."""

import numpy as np
import pytest
import torch

import mazu_tpu.io.checkpoint as mck
import mazu_tpu.kphf.sshash as msshash
from mazu_tpu.containers.refseq import RefSeqCollection as MRefs
from mazu_tpu.containers.unitig_set import UnitigSet as MUnitigs
from mazu_tpu.index.modindex import ModIndex as MModIndex
from mazu_tpu.index.modindex import k2u_batch as m_k2u_batch
from mazu_tpu.index.spt import SPT as MSPT
from mazu_tpu.kphf.kcdict import KCDict as MKCDict

import mazu_tpu_torch.io.checkpoint as pck
import mazu_tpu_torch.kphf.sshash as psshash
from mazu_tpu_torch.containers.refseq import RefSeqCollection
from mazu_tpu_torch.containers.unitig_set import UnitigSet
from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.err import IndexLoad
from mazu_tpu_torch.index.modindex import ModIndex, k2u_batch
from mazu_tpu_torch.index.spt import SPT
from mazu_tpu_torch.kphf.kcdict import KCDict

from torch_fixtures import (
    assert_same, build_capacity_pair, build_mphf_pair, build_pair, build_parity_pair,
    build_pf1_pair, capacity_queries, same_tree, seq_recipe, toy_recipe,
)


def _kcdict_pair(scheme: str, with_occs: bool = True):
    (seqs, k, occ, lens), _ = seq_recipe()
    names = [f"r{i}" for i in range(len(lens))]
    mus, pus = MUnitigs.from_seqs(seqs, k), UnitigSet.from_seqs(seqs, k)
    mu2, pu2 = (MSPT(mus, names, *occ, lens).piscem_table(),
                SPT(pus, names, *occ, lens).piscem_table())
    ref = MModIndex(MKCDict.from_unitig_set(mus, occ_table=mu2 if with_occs else None,
                                            scheme=scheme, load=0.25), mu2,
                    MRefs.from_lens(lens, names), index_type="t")
    port = ModIndex(KCDict.from_unitig_set(pus, occ_table=pu2 if with_occs else None,
                                           load=0.25, scheme=scheme), pu2,
                    RefSeqCollection.from_lens(lens, names), index_type="t")
    return ref, port


def _bucket_pair():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (msshash, psshash):
            mp.setattr(mod.SSHash, "_place_skew_cuckoo", staticmethod(lambda *a, **kw: None))
        return build_capacity_pair(toy_recipe(), skew=2)


PAIRS = {
    "mono2_occ32": lambda: build_pair(toy_recipe()),
    "mono": lambda: _kcdict_pair("mono"),
    "mono2_no_occs": lambda: _kcdict_pair("mono2", with_occs=False),
    "parity": lambda: build_parity_pair(seq_recipe()[0], skew=2),
    "parity_wyhash_noskew": lambda: build_parity_pair(seq_recipe()[0], skew=None,
                                                      minimizer_hash="wyhash"),
    "fast32": lambda: build_mphf_pair(toy_recipe()),
    "direct_cuckoo": lambda: build_capacity_pair(toy_recipe()),
    "direct_bucket": _bucket_pair,
    "pfhash": lambda: build_pf1_pair(toy_recipe())[0],
    "sampled": lambda: build_pf1_pair(toy_recipe())[1],
}
_CACHE = {}


def pair(name):
    if name not in _CACHE:
        _CACHE[name] = PAIRS[name]()
    return _CACHE[name]


def _npz(path) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _same_files(got_path, want_path):
    got, want = _npz(got_path), _npz(want_path)
    assert set(got) == set(want), set(got) ^ set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        assert got[key].tobytes() == want[key].tobytes(), key


def _query_same(ref_k2u, port_k2u):
    work = capacity_queries(ref_k2u.unitigs, 512, seed=2)
    want = m_k2u_batch({"k2u": ref_k2u.device_arrays()}, work, np)
    got = k2u_batch({"k2u": arrays_from_numpy(port_k2u.device_arrays(), "cpu")},
                    torch.from_numpy(work.view(np.int64)))
    for key in ("unitig_id", "unitig_len", "pos", "mt"):
        assert_same(got[key], want[key], key)
    assert (np.asarray(want["mt"]) > 0).any()


@pytest.mark.parametrize("name", list(PAIRS))
def test_reference_writes_port_reads(name, tmp_path):
    ref, port = pair(name)
    a, b = str(tmp_path / "ref.npz"), str(tmp_path / "back.npz")
    mck.save_index(ref, a)
    got = pck.load_index(a)
    pck.save_index(got, b)
    _same_files(b, a)
    want = mck.load_index(a)
    same_tree(got.device_arrays(), want.device_arrays())
    assert (got.index_type, got.version, got.metadata) == (want.index_type, want.version,
                                                           want.metadata)
    assert got.ref_names == want.ref_names and got.n_refs == want.n_refs
    assert got.k2u.num_bits() == want.k2u.num_bits()
    assert got.u2pos.num_bits() == want.u2pos.num_bits()
    _query_same(want.k2u, got.k2u)


@pytest.mark.parametrize("name", list(PAIRS))
def test_port_writes_reference_reads(name, tmp_path):
    ref, port = pair(name)
    a, b = str(tmp_path / "port.npz"), str(tmp_path / "back.npz")
    pck.save_index(port, a)
    want = mck.load_index(a)
    mck.save_index(want, b)
    _same_files(b, a)
    got = pck.load_index(a)
    same_tree(got.device_arrays(), want.device_arrays())
    _query_same(want.k2u, got.k2u)
    # the port's own build and the reference's write the same index
    c = str(tmp_path / "ref.npz")
    mck.save_index(ref, c)
    d = _npz(c)
    for key, v in _npz(a).items():
        if key not in ("version",):
            assert v.tobytes() == d[key].tobytes() and v.dtype == d[key].dtype, key


@pytest.mark.parametrize("name", ["mono", "parity", "direct_cuckoo", "sampled"])
def test_bare_k2u_both_ways(name, tmp_path):
    ref, port = pair(name)
    a, b = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    mck.save_k2u(ref.k2u, a)
    pck.save_k2u(port.k2u, b)
    _same_files(b, a)
    got, want = pck.load_k2u(a), mck.load_k2u(b)
    same_tree(got.device_arrays(), want.device_arrays())
    _query_same(want, got)


def test_max_bucket_from_the_prefix(tmp_path):
    """The file keeps no probe depth: the loaded SSHash takes it from the
    bucket prefix, as the reference does."""
    ref, port = pair("parity")
    a = str(tmp_path / "p.npz")
    pck.save_k2u(port.k2u, a)
    got = pck.load_k2u(a)
    assert got.max_bucket() == port.k2u.max_bucket() == mck.load_k2u(a).max_bucket()
    assert got.probe_bound() == port.k2u.probe_bound()


def test_cuckoo_skew_pos_is_both_arrays(tmp_path):
    ref, port = pair("direct_cuckoo")
    a = str(tmp_path / "d.npz")
    mck.save_index(ref, a)
    sd = pck.load_index(a).k2u.skew_direct
    assert sd["kind"] == "cuckoo"
    np.testing.assert_array_equal(sd["slot_pos"], sd["pos"])
    np.testing.assert_array_equal(sd["pos"], ref.k2u.skew_direct["pos"])


def test_unicode_scalars_and_no_pickle(tmp_path):
    ref, port = pair("parity")
    a = str(tmp_path / "p.npz")
    pck.save_index(port, a)
    flat = _npz(a)
    for key in ("index_type", "version", "metadata_json", "k2u/kind", "u2pos/kind"):
        assert flat[key].dtype.kind == "U" and flat[key].ndim == 0, key
    tree = pck._unflatten(flat)
    assert tree["index_type"] == "t" and isinstance(tree["k2u"]["kind"], str)
    assert all(v.dtype != object for v in flat.values())


def test_cuckoo_kcdict_raises_by_name(tmp_path):
    """A cuckoo KCDict, which once raised by name, crosses in both
    directions: the same bytes back, and a query equal to the reference's.
    (The name is kept from when the port refused the scheme.)"""
    (seqs, k, occ, lens), _ = seq_recipe()
    mus, pus = MUnitigs.from_seqs(seqs, k), UnitigSet.from_seqs(seqs, k)
    a, b, c = (str(tmp_path / f"{x}.npz") for x in "abc")
    mck.save_k2u(MKCDict.from_unitig_set(mus), a)
    loaded = pck.load_k2u(a)
    assert loaded.scheme == "cuckoo" and loaded.salt == int(_npz(a)["k2u/salt"])
    pck.save_k2u(loaded, b)
    pck.save_k2u(KCDict.from_unitig_set(pus), c)
    fa, fb, fc = _npz(a), _npz(b), _npz(c)
    for f in (fb, fc):
        assert set(f) == set(fa)
        for key in fa:
            if key != "version":
                assert f[key].tobytes() == fa[key].tobytes(), key
    back = mck.load_k2u(c)
    work = capacity_queries(mus, 512, seed=3)
    want = m_k2u_batch({"k2u": back.device_arrays()}, work, np)
    got = k2u_batch({"k2u": arrays_from_numpy(loaded.device_arrays(), "cpu")},
                    torch.from_numpy(work.view(np.int64)))
    for key in want:
        assert_same(got[key], want[key], key)


def test_format_version_checked(tmp_path):
    ref, port = pair("pfhash")
    a = str(tmp_path / "p.npz")
    pck.save_index(port, a)
    flat = _npz(a)
    flat["format_version"] = np.int64(2)
    np.savez(a, **flat)
    with pytest.raises(IndexLoad, match="format version 2"):
        pck.load_index(a)


@pytest.mark.parametrize("name", ["mono", "mono2_no_occs"])
@pytest.mark.parametrize("mode", ["main", "full"])
def test_kcdict_layouts_query(name, mode):
    """The KCDict layouts the CLI builds besides mono2-occ32 (``index build
    piscem --engine mono``, ``kphf build mono2``: 9-word slot rows) answer
    as the reference's, in both modes."""
    from mazu_tpu.kphf.kcdict import kcdict_k2u as m_kcdict_k2u
    from mazu_tpu_torch.kphf.kcdict import kcdict_k2u

    ref, port = pair(name)
    host = ref.k2u.device_arrays()
    d = arrays_from_numpy(port.k2u.device_arrays(), "cpu")
    assert d["table"].shape[1] == host["table"].shape[1]
    work = capacity_queries(ref.k2u.unitigs, 1024, seed=5)
    want = m_kcdict_k2u(host, work, np, mode=mode)
    got = kcdict_k2u(d, torch.from_numpy(work.view(np.int64)), mode)
    assert set(got) == set(want)
    for key in want:
        assert_same(got[key], want[key], key)
