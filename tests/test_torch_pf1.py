"""The port's pufferfish indexes against mazu_tpu's, with tolerance 0:
``DenseUnitigTable`` (pf1 words, pair rows, ``decode_occs``), the PFHash
and SampledPFHash builds byte for byte, ``pfhash_k2u`` and ``sampled_k2u``
on sampled, foreign and unitig-boundary k-mers, ``get_ref_pos_padded`` on
both indexes, the loaders on index directories written here, and the
synthetic pf1 indexes against their sampled truth."""

import numpy as np
import pytest
import torch

import mazu_tpu.index.modindex as mmod
import mazu_tpu.index.unitig_table as mut
import mazu_tpu.io.pf1_index as mload
from mazu_tpu.kmer import revcomp
from mazu_tpu.kphf.pfhash import pfhash_k2u as mpfhash_k2u
from mazu_tpu.kphf.sampled import sampled_k2u as msampled_k2u

from mazu_tpu_torch import synth
from mazu_tpu_torch.bits.bitvector import BitVector, bv_get_bit
from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index.modindex import QueryIndex, get_ref_pos_padded
from mazu_tpu_torch.index.unitig_table import decode_occs
from mazu_tpu_torch.io.pf1_index import load_dense_index, load_sparse_index
from mazu_tpu_torch.kphf.pfhash import pfhash_k2u
from mazu_tpu_torch.kphf.sampled import sampled_k2u

from torch_fixtures import (
    assert_same, build_pf1_pair, capacity_queries, mono2_recipe, same_tree, tensor, toy_recipe,
    write_pf1_index,
)

K2U = {"dense": (pfhash_k2u, mpfhash_k2u), "sparse": (sampled_k2u, msampled_k2u)}
LOAD = {"dense": (load_dense_index, mload.load_dense_index),
        "sparse": (load_sparse_index, mload.load_sparse_index)}


@pytest.fixture(scope="module", params=["mono2", "toy"])
def case(request):
    recipe = mono2_recipe() if request.param == "mono2" else toy_recipe()
    dense, sparse = build_pf1_pair(recipe)
    return recipe, {"dense": dense, "sparse": sparse}


def boundary_queries(unitigs, seed: int) -> np.ndarray:
    """Every k-mer read across a unitig boundary (its start one of the last
    k-1 positions of a unitig), half reverse-complemented."""
    k = unitigs.k
    ends = np.asarray(unitigs.accum[1:-1], dtype=np.int64)
    pos = (ends[:, None] - np.arange(1, k)[None, :]).reshape(-1)
    words = unitigs.get_kmer_u64(pos)
    flip = np.random.default_rng(seed).random(len(words)) < 0.5
    words[flip] = revcomp(words[flip], k)
    return words


def query_sets(unitigs) -> dict:
    return {
        "sampled": capacity_queries(unitigs, 3000, seed=1, miss=0.0),
        "foreign": capacity_queries(unitigs, 3000, seed=2, miss=0.5),
        "boundary": boundary_queries(unitigs, seed=3),
    }


def test_dense_unitig_table(case):
    _, idx = case
    ref, port = idx["dense"]
    same_tree(port.u2pos.device_arrays(), ref.u2pos.device_arrays())
    host = ref.u2pos.device_arrays()
    occ_idx = np.arange(len(ref.u2pos.ctable), dtype=np.int64)
    want = mut.decode_occs(host, occ_idx, np)
    got = decode_occs(arrays_from_numpy(host, "cpu"), torch.from_numpy(occ_idx))
    for g, w, what in zip(got, want, ("ref_id", "pos", "orient")):
        assert_same(g, w, what)
    assert port.max_occs() == ref.max_occs()


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_build_arrays(case, kind):
    _, idx = case
    ref, port = idx[kind]
    same_tree(port.device_arrays(), ref.device_arrays())


@pytest.mark.parametrize("qset", ["sampled", "foreign", "boundary"])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_k2u(case, kind, qset):
    _, idx = case
    ref, port = idx[kind]
    words = query_sets(ref.k2u.unitigs)[qset]
    want = K2U[kind][1](ref.k2u.device_arrays(), words, np)
    got = K2U[kind][0](arrays_from_numpy(port.k2u.device_arrays(), "cpu"), tensor(words))
    assert set(got) == set(want)
    for key in want:
        assert_same(got[key], want[key], f"{kind} {qset} {key}")
    hits = int((np.asarray(want["mt"]) > 0).sum())
    if qset == "sampled":
        assert hits == len(words)
    elif qset == "foreign":
        assert 0 < hits < len(words)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_get_ref_pos_padded(case, kind):
    _, idx = case
    ref, port = idx[kind]
    words = np.concatenate(list(query_sets(ref.k2u.unitigs).values()))
    max_occs = max(1, ref.max_occs())
    want = mmod.get_ref_pos_padded(ref.device_arrays(), words, np, max_occs)
    qi = QueryIndex(arrays_from_numpy(port.device_arrays(), "cpu"))
    assert qi.max_occs == max_occs
    got = get_ref_pos_padded(qi.arrays(), tensor(words), max_occs)
    assert set(got) == set(want)
    for key in want:
        assert_same(got[key], want[key], f"{kind} {key}")


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_loaders(case, kind, tmp_path):
    """An index directory in pufferfish's file layouts, written from the
    port's build and read by both packages: the same arrays as the build's,
    and the same query answers."""
    recipe, idx = case
    ref, port = idx[kind]
    write_pf1_index(str(tmp_path), port, recipe[3])
    loaded, mloaded = LOAD[kind][0](str(tmp_path)), LOAD[kind][1](str(tmp_path))
    assert loaded.index_type == mloaded.index_type and loaded.metadata == mloaded.metadata
    same_tree(loaded.device_arrays(), mloaded.device_arrays())
    want = port.device_arrays()
    same_tree(loaded.device_arrays()["k2u"], want["k2u"])
    same_tree(loaded.device_arrays()["u2pos"], want["u2pos"])
    words = query_sets(ref.k2u.unitigs)["sampled"]
    max_occs = max(1, ref.max_occs())
    got = get_ref_pos_padded(arrays_from_numpy(loaded.device_arrays(), "cpu"), tensor(words),
                             max_occs)
    exp = mmod.get_ref_pos_padded(ref.device_arrays(), words, np, max_occs)
    for key in exp:
        assert_same(got[key], exp[key], f"loaded {kind} {key}")


def test_bitvector_from_bools_select_get_bit():
    from mazu_tpu.bits.bitvector import BitVector as MBitVector, bv_get_bit as mget

    for n in (0, 1, 63, 64, 65, 1000):
        bits = np.random.default_rng(n).random(n) < 0.3
        bv, mbv = BitVector.from_bools(bits), MBitVector.from_bools(bits)
        same_tree(bv.device_arrays(), mbv.device_arrays())
        assert bv.count_ones() == mbv.count_ones() == int(bits.sum())
        r = np.arange(bv.count_ones())
        np.testing.assert_array_equal(bv.select(r), mbv.select(r))
        np.testing.assert_array_equal(bv.select(r), np.flatnonzero(bits))
        pos = np.arange(n, dtype=np.int64)
        got = bv_get_bit(arrays_from_numpy(bv.device_arrays(), "cpu"), torch.from_numpy(pos))
        assert_same(got, mget(mbv.device_arrays(), pos, np))


@pytest.fixture(scope="module")
def synth_pf1():
    genome = synth.synthetic_spt(6 * synth.PIECE, seed=0)
    return genome, {
        "dense": synth.build_pf1_dense_index(0, device="cpu", genome=genome),
        "sparse": synth.build_pf1_sparse_index(0, device="cpu", genome=genome),
    }


def test_synth_pf1_indexes(synth_pf1):
    """Every sampled (unitig, offset) lane is found there, foreign lanes
    miss, and the dense and sparse indexes give the same padded answers on
    the lanes they find (a miss's other fields are the dictionary's own)."""
    genome, idx = synth_pf1
    words, uid, off, foreign = synth.sample_queries_truth(genome[0], 4000, seed=1)
    outs = {}
    for kind, index in idx.items():
        qi = QueryIndex(arrays_from_numpy(index.device_arrays(), "cpu"))
        assert qi.max_occs == 3
        out = get_ref_pos_padded(qi.arrays(), tensor(words), qi.max_occs)
        hit = out["mt"].numpy() > 0
        assert hit[~foreign].all() and not hit[foreign].any()
        np.testing.assert_array_equal(out["unitig_id"].numpy()[~foreign], uid[~foreign])
        np.testing.assert_array_equal(out["pos"].numpy()[~foreign], off[~foreign])
        outs[kind] = out
    hit = ~torch.from_numpy(foreign)
    for key in outs["dense"]:
        assert torch.equal(outs["dense"][key][hit], outs["sparse"][key][hit]), key


def test_pf1_builds_default_to_the_card(monkeypatch):
    """Without a card, a pf1 build that was not asked for the host raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synth.build_pf1_dense_index(3 * synth.PIECE)
