"""The SSHash build on the device (the MPHF tier at 2^31 bases and more)
against mazu_tpu's host build, with tolerance 0, on CPU tensors: the
minimizer occurrences (``SSHash._collect_minimizer_occs``: the scan, the
per-strand dedup across chunks, the stable sort and run bounds) for the
three engines' orderings at chunk sizes 1, 7, 4,096 and one whole chunk,
on genomes whose chunk bounds fall inside runs of equal (minimizer,
position) pairs on both strands, with and without a planted minimizer
over the skew threshold, also against the port's host collection before
it moved (``host_collection``); the k-mer positions by chunk; the device
pack of ``IntVector``; whole builds of the three engines at small chunks;
the MPHF path's projections of positions and occurrences at and past 2^31
and 2^32; and the ``mrows`` BooPHF32 in an SSHash's arrays and its
queries."""

import numpy as np
import pytest
import torch

import mazu_tpu.bits.intvector as miv
import mazu_tpu.index.modindex as mmi
import mazu_tpu.index.twophase as mtp
import mazu_tpu.kphf.sshash as msshash
from mazu_tpu.containers.unitig_set import UnitigSet as MUnitigs
from mazu_tpu.index.spt import SPT as MSPT

from mazu_tpu_torch import synth
from mazu_tpu_torch.bits.intvector import IntVector, iv_get, pack_words
from mazu_tpu_torch.containers.unitig_set import UnitigSet
from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index import modindex as pmi, twophase
from mazu_tpu_torch.index.spt import SPT
from mazu_tpu_torch.kmer import canonical_minimizer_batch
from mazu_tpu_torch.kphf.sshash import SSHash, sshash_k2u
from mazu_tpu_torch.ops import capacity_probe
from mazu_tpu_torch.pytree import meta

from torch_fixtures import (
    assert_same, build_capacity_pair, build_mphf_pair, build_parity_pair, capacity_queries,
    same_tree, tensor,
)

K, W = 31, 19
ORDERINGS = {"fast32": "mix32", "parity": "mix64", "direct": "mix32"}


def _seqs(unitigs) -> list:
    return [unitigs.useq.to_str(int(unitigs.accum[i]), int(unitigs.accum[i + 1]))
            for i in range(unitigs.n_unitigs)]


def _genome(name: str):
    """(port UnitigSet, reference UnitigSet) of a small genome. ``repeat``:
    a unitig of a 13-mer repeated 80 times (runs of one minimizer on both
    strands, and a minimizer with more occurrences than the skew threshold
    64 under any ordering) and a random one; ``random``: two random
    unitigs (no minimizer over 64); ``planted``: synth's MPHF genome,
    60 kb with its 19-mer planted at 96 tagged places (over 64 under the
    mix32 ordering)."""
    rng = np.random.default_rng(11)

    def rand(n):
        return "".join(rng.choice(list("ACGT"), n))

    if name == "planted":
        us, _, _ = synth.mphf_genome(60_000, seed=3, heavy_sites=96)
        seqs = _seqs(us)
    elif name == "repeat":
        seqs = ["ACGTTGCAGGCTA" * 80, rand(400)]
    else:
        seqs = [rand(500), rand(300)]
    return UnitigSet.from_seqs(seqs, K), MUnitigs.from_seqs(seqs, K)


GENOMES = {name: _genome(name) for name in ("repeat", "random", "planted")}
COLLECTIONS = [(g, e, c) for g in ("repeat", "random") for e in ORDERINGS
               for c in (1, 7, 4096, 1 << 30)]
COLLECTIONS += [("planted", e, c) for e in ORDERINGS for c in (4096, 1 << 30)]


def host_collection(unitigs, w: int, seed: int, ordering: str):
    """The port's collection before it moved to the device: every k-mer's
    position on the host, the scan in chunks, then NumPy dedup, stable
    argsort and run bounds."""
    k = unitigs.k
    kpos = np.concatenate([unitigs.accum[i] + np.arange(max(0, int(n) - k + 1))
                           for i, n in enumerate(np.diff(unitigs.accum))]).astype(np.int64)
    words = unitigs.get_kmer_u64(kpos)
    mm, off, is_fw, _ = canonical_minimizer_batch(tensor(words), k, w, seed, ordering)
    mm = mm.numpy().view(np.uint64)
    pos = kpos + off.numpy().astype(np.int64)
    is_fw = is_fw.numpy()

    def dedup(mask):
        idx = np.flatnonzero(mask)
        keep = np.ones(len(idx), dtype=bool)
        keep[1:] = (mm[idx][1:] != mm[idx][:-1]) | (pos[idx][1:] != pos[idx][:-1])
        return idx[keep]

    sel = np.concatenate([dedup(is_fw), dedup(~is_fw)])
    order = np.argsort(mm[sel], kind="stable")
    mms, mps = mm[sel][order], pos[sel][order]
    first = np.concatenate([[True], mms[1:] != mms[:-1]]) if len(mms) else np.zeros(0, bool)
    starts = np.flatnonzero(first)
    return mms[starts], np.diff(np.append(starts, len(mms))), starts, mps


@pytest.mark.parametrize("genome,engine,chunk", COLLECTIONS)
def test_collection_equals_reference(genome, engine, chunk):
    pus, mus_ = GENOMES[genome]
    ordering = ORDERINGS[engine]
    got = SSHash._collect_minimizer_occs(pus, W, 0, chunk, "cpu", ordering)
    want = msshash.SSHash._collect_minimizer_occs(mus_, W, 0, engine != "parity", 1 << 20,
                                                  ordering=ordering)
    before = host_collection(pus, W, 0, ordering)
    for name, g, w, b in zip(("mm_set", "mm_occs", "ranges_start", "positions"), got, want,
                             before):
        np.testing.assert_array_equal(g, w, err_msg=name)
        np.testing.assert_array_equal(g, b, err_msg=name)
    assert got[0].dtype == np.uint64 and all(a.dtype == np.int64 for a in got[1:])
    over = got[1].max() > 64
    assert over == (genome == "repeat") or (genome == "planted" and over == (ordering == "mix32"))


@pytest.mark.parametrize("genome", list(GENOMES))
def test_chunk_bounds_fall_inside_dedup_runs(genome):
    """The fixture holds what the test above needs: a dedup that forgets
    each chunk's predecessor keeps more on both strands at chunk 7."""
    pus, _ = GENOMES[genome]
    kp = torch.cat(list(pus.kmer_position_chunks(1 << 30, "cpu")))
    words = torch.from_numpy(pus.get_kmer_u64(kp.numpy()).view(np.int64))
    mm, off, is_fw, _ = canonical_minimizer_batch(words, K, W, 0, "mix32")
    pos = kp + off
    for sel in (is_fw, ~is_fw):
        idx = torch.nonzero(sel).flatten()
        same = (mm[idx][1:] == mm[idx][:-1]) & (pos[idx][1:] == pos[idx][:-1])
        # a run of equal pairs that a chunk bound of size 7 cuts
        cut = (idx[1:] // 7) != (idx[:-1] // 7)
        assert bool((same & cut).any())


def test_kmer_position_chunks():
    pus, _ = GENOMES["planted"]
    want = pus.kmer_start_positions()
    for chunk in (1, 7, 4096, 1 << 30):
        got = torch.cat(list(pus.kmer_position_chunks(chunk, "cpu")))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
    # a unitig shorter than k has no k-mer
    us = UnitigSet.from_seqs(["ACGT" * 10, "ACGTACGTAC", "TTGCA" * 9], K)
    got = torch.cat(list(us.kmer_position_chunks(5, "cpu")))
    np.testing.assert_array_equal(got.numpy(),
                                  np.concatenate([np.arange(10), 50 + np.arange(15)]))


@pytest.mark.parametrize("width", list(range(1, 59)))
def test_device_pack(width):
    rng = np.random.default_rng(width)
    v = rng.integers(0, 1 << width, 777, dtype=np.uint64)
    if width > 32:
        v[:4] = [1 << 32, (1 << 32) + 1, (1 << width) - 1, 1 << (width - 1)]
    want = miv.IntVector.from_array(v)
    host = IntVector.from_array(v)
    got = IntVector.from_tensor(tensor(v))
    assert got.width == want.width == host.width == width
    np.testing.assert_array_equal(got.words, want.words)
    np.testing.assert_array_equal(got.words, host.words)
    nw = (len(v) * width + 63) // 64
    for chunk in (64, 128, 4096):
        np.testing.assert_array_equal(
            pack_words(tensor(v), width, chunk).numpy().view(np.uint64), want.words[:nw])
    # a given wider width; values read back through iv_get
    wide = IntVector.from_tensor(tensor(v), 58)
    np.testing.assert_array_equal(wide.words, miv.IntVector.from_array(v, 58).words)
    idx = torch.arange(len(v))
    back = iv_get({"words": tensor(got.words), "meta": meta(width=width)}, idx)
    np.testing.assert_array_equal(back.numpy().view(np.uint64), v)


def test_codes_pack_in_chunks():
    """``SeqVector.from_codes`` a chunk at a time equals the reference's
    pack, across chunk bounds and at ragged ends."""
    from mazu_tpu.bits.seqvector import SeqVector as MSeqVector
    from mazu_tpu_torch.bits.seqvector import SeqVector

    rng = np.random.default_rng(9)
    for n in (0, 1, 31, 32, 33, 1000, 4099):
        codes = rng.integers(0, 4, n, dtype=np.uint8)
        want = MSeqVector.from_codes(codes)
        for chunk in (32, 96, 1 << 26):
            got = SeqVector.from_codes(codes, chunk)
            assert got.length == want.length
            np.testing.assert_array_equal(got.words, want.words)
    with pytest.raises(ValueError, match="invalid base code"):
        SeqVector.from_codes(np.array([0, 1, 4], np.uint8), 32)


def test_device_pack_edges():
    assert IntVector.from_tensor(torch.zeros(0, dtype=torch.int64)).length == 0
    one = IntVector.from_tensor(torch.tensor([5]))
    np.testing.assert_array_equal(one.words, miv.IntVector.from_array(np.array([5], np.uint64)).words)
    with pytest.raises(ValueError, match="width 59 unsupported"):
        IntVector.from_tensor(torch.tensor([1 << 58]))


def _recipe(genome: str):
    pus, _ = GENOMES[genome]
    seqs = _seqs(pus)
    n = len(seqs)
    occ = (np.arange(n, dtype=np.int64), np.arange(n, dtype=np.int64),
           np.zeros(n, dtype=np.int64), np.ones(n, dtype=np.int64))
    return seqs, K, occ, np.array([len(s) for s in seqs], dtype=np.int64)


@pytest.mark.parametrize("genome,chunk", [("repeat", 7), ("planted", 4096)])
@pytest.mark.parametrize("engine", list(ORDERINGS))
def test_whole_build_at_small_chunks(engine, genome, chunk, monkeypatch):
    """``SSHash.from_unitig_set`` of each engine, its minimizer scan in
    chunks of ``chunk`` k-mers, byte for byte against mazu_tpu's build."""
    orig = SSHash.from_unitig_set.__func__

    def small_chunks(cls, unitigs, w, *a, **kw):
        kw["chunk"] = chunk
        return orig(cls, unitigs, w, *a, **kw)

    monkeypatch.setattr(SSHash, "from_unitig_set", classmethod(small_chunks))
    pair = {"fast32": build_mphf_pair, "parity": build_parity_pair,
            "direct": build_capacity_pair}[engine]
    ref, port = pair(_recipe(genome), w=W, skew=64)
    layout = (dict(prefix_kind="grouped16", pos_kind="packed") if engine != "parity"
              else dict(prefix_kind="ef", pos_kind="packed"))
    same_tree(port.k2u.device_arrays(**layout), ref.k2u.device_arrays(**layout), engine)
    np.testing.assert_array_equal(port.k2u.occs_prefix_sum, ref.k2u.occs_prefix_sum)
    if engine != "direct":
        assert set(port.k2u.build_seconds) >= {"scan", "dedup", "sort and runs", "mphf build",
                                               "mphf lookup", "scatter", "pack", "skew"}


def _projection_case():
    """Both packages' piscem tables over references of 2^33 bases, with
    occurrences at and past 2^31 and 2^32, and K2U outputs of lanes whose
    useq positions lie at and past 2^31 and 2^32: read from a packed
    IntVector and made unitig offsets against crafted ``uproj`` records."""
    rng = np.random.default_rng(5)
    n_u = 6
    seqs = ["".join(rng.choice(list("ACGT"), 60)) for _ in range(n_u)]
    occ_uid = np.array([0, 1, 1, 2, 3, 3, 3, 4, 5, 5], np.int64)
    occ_ref = np.array([0, 1, 0, 2, 1, 2, 0, 3, 3, 1], np.int64)
    occ_pos = np.array([(1 << 31) - 1, 1 << 31, (1 << 32) - 30, 1 << 32, (1 << 32) + 7,
                        (1 << 31) + 3, 5, (1 << 33) - 100, 12, (1 << 32) + (1 << 31)], np.int64)
    occ_o = np.array([1, 0, 1, 0, 1, 1, 0, 0, 1, 0], np.int64)
    lens = np.full(4, 1 << 33, np.int64)
    names = [f"r{i}" for i in range(4)]
    ref_u2 = MSPT(MUnitigs.from_seqs(seqs, K), names, occ_uid, occ_ref, occ_pos, occ_o,
                  lens).piscem_table()
    port_u2 = SPT(UnitigSet.from_seqs(seqs, K), names, occ_uid, occ_ref, occ_pos, occ_o,
                  lens).piscem_table()
    # lanes: useq positions around 2^31 and 2^32 through a packed vector,
    # each in a unitig whose crafted uproj start lies below it
    n = 64
    uid = rng.integers(0, n_u, n)
    kpos = rng.integers(0, 60 - K + 1, n)
    base = np.array([(1 << 31) - 20, 1 << 31, (1 << 32) - 10, 1 << 32, (1 << 33) + 3,
                     (1 << 31) + (1 << 30)], np.int64)
    ustart = base[rng.integers(0, len(base), n)]
    packed = IntVector.from_array((ustart + kpos).astype(np.uint64))
    assert packed.width >= 33
    useq_pos = iv_get(arrays_from_numpy(packed.device_arrays(), "cpu"), torch.arange(n))
    np.testing.assert_array_equal(useq_pos.numpy(), ustart + kpos)
    np.testing.assert_array_equal(
        miv.IntVector.from_array((ustart + kpos).astype(np.uint64)).get(np.arange(n)),
        (ustart + kpos).astype(np.uint64))
    off = port_u2.offsets
    words = port_u2.ctable.to_array()
    cnt = off[uid + 1] - off[uid]
    second = words[np.minimum(off[uid] + 1, len(words) - 1)] * (cnt >= 2)
    r = {
        "unitig_id": uid, "unitig_len": np.full(n, 60, np.int64),
        "pos": useq_pos.numpy() - ustart, "mt": rng.integers(0, 3, n).astype(np.int64),
        "occ_word": words[off[uid]], "occ_word2": second, "occ_cnt": cnt,
        "occ_start": off[uid], "use_skew": rng.random(n) < 0.1,
    }
    return ref_u2, port_u2, r


def test_projection_past_2_31_and_2_32():
    from types import SimpleNamespace

    ref_u2, port_u2, r = _projection_case()
    want_arrays = {"u2pos": ref_u2.device_arrays(), "meta": SimpleNamespace(k=K)}
    got_arrays = {"u2pos": arrays_from_numpy(port_u2.device_arrays(), "cpu"), "meta": meta(k=K)}
    rt = {kk: (tensor(v) if v.dtype == np.uint64 else torch.from_numpy(v)) for kk, v in r.items()}
    want = mtp._project_fused(want_arrays, r, np)
    got = twophase._project_fused(got_arrays, rt)
    for kk in want:
        np.testing.assert_array_equal(got[kk].numpy(), np.asarray(want[kk]), err_msg=kk)
    assert (np.asarray(want["ref_pos"])[np.asarray(want["valid"])] >= 1 << 31).any()
    assert (np.asarray(want["ref_pos"])[np.asarray(want["valid"])] >= 1 << 32).any()
    for with_start in (True, False):
        rr = {kk: v for kk, v in r.items() if with_start or kk != "occ_start"}
        rrt = {kk: v for kk, v in rt.items() if with_start or kk != "occ_start"}
        want = mmi._occ_projection_wide(want_arrays, rr, np, 3)
        got = pmi._occ_projection_wide(got_arrays, rrt, 3)
        for kk in want:
            np.testing.assert_array_equal(got[kk].numpy(), np.asarray(want[kk]), err_msg=kk)


@pytest.fixture(scope="module")
def mrows_pair():
    return build_mphf_pair(_recipe("planted"), w=W, skew=64)


LAYOUT = dict(prefix_kind="grouped16", pos_kind="packed", uproj=True)


def test_mrows_arrays_equal_reference(mrows_pair):
    ref, port = mrows_pair
    want = ref.device_arrays(mphf_rows=True, **LAYOUT)
    got = port.device_arrays(mphf_rows=True, **LAYOUT)
    same_tree(got, want)
    assert "mrows" in got["k2u"]["mphf"] and "words" not in got["k2u"]["mphf"]
    assert "words" in got["k2u"]["skew_mphf"]


@pytest.mark.parametrize("mlim", [None, 1, 2, 4])
def test_mrows_sshash_k2u(mrows_pair, mlim):
    """``sshash_k2u`` on the mrows layout equals the reference's on its
    mrows arrays and the port's on the lean ones."""
    ref, port = mrows_pair
    host = ref.device_arrays(mphf_rows=True, **LAYOUT)
    d = arrays_from_numpy(port.device_arrays(mphf_rows=True, **LAYOUT), "cpu")
    lean = arrays_from_numpy(port.device_arrays(**LAYOUT), "cpu")
    words = capacity_queries(ref.k2u.unitigs, 1500, seed=4)
    kw = dict(mode="main", probe_limit=2, defer_valid=True, mphf_level_limit=mlim)
    got = sshash_k2u(d["k2u"], tensor(words), **kw)
    same = sshash_k2u(lean["k2u"], tensor(words), **kw)
    want = msshash.sshash_k2u(host["k2u"], words, np, **kw)
    assert set(got) == set(want)
    for kk in want:
        assert_same(got[kk], want[kk], kk)
        assert torch.equal(got[kk], same[kk]), kk


def test_mrows_never_reaches_k3(mrows_pair, monkeypatch):
    """K3's layout check refuses an mrows MPHF by name, and the main-phase
    route sends it to the plain probe."""
    _, port = mrows_pair
    d = arrays_from_numpy(port.device_arrays(mphf_rows=True, **LAYOUT), "cpu")
    lean = arrays_from_numpy(port.device_arrays(**LAYOUT), "cpu")
    words = tensor(capacity_queries(port.k2u.unitigs, 1000, seed=6))
    with pytest.raises(ValueError, match="lean BooPHF32 layout"):
        capacity_probe.check_layout(d["k2u"], words, 2)
    seen = []
    real = twophase.capacity_k2u
    monkeypatch.setattr(twophase, "capacity_k2u",
                        lambda *a, **kw: (seen.append(1), real(*a, **kw))[1])
    qi = pmi.QueryIndex(d)
    kw = dict(probe_limit=2, defer_valid=True, mphf_level_limit=4, probe_limit2=4,
              m2b=1024, m2c=1024)
    got = pmi.get_ref_pos_compact(d, words, qi.max_occs, merge=True, m2=1024, **kw)
    assert not seen
    want = pmi.get_ref_pos_compact(lean, words, qi.max_occs, merge=True, m2=1024, **kw)
    assert seen
    for kk in want:
        assert torch.equal(got[kk], want[kk]), kk
