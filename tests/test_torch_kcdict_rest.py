"""The KCDict's cuckoo scheme, wide slots and ``bucket_range`` against
``mazu_tpu``: tables byte for byte, ``kcdict_k2u`` equal to the
reference's NumPy query on hits, reverse complements and misses (main and
full mode), the wide-slot dictionary kept off K1, the single-hash table's
bucket shards (exact zeros off a shard's lanes, side hits from the main
hash's owner only), ``index build piscem --engine cuckoo`` and a cuckoo
index crossing between the packages' checkpoints."""

import numpy as np
import pytest
import torch

import mazu_tpu.io.checkpoint as mck
from mazu_tpu.bits.seqvector import SeqVector as MSeqVector
from mazu_tpu.containers.refseq import RefSeqCollection as MRefs
from mazu_tpu.containers.unitig_set import UnitigSet as MUnitigs
from mazu_tpu.index.modindex import ModIndex as MModIndex
from mazu_tpu.index.modindex import get_ref_pos_compact as m_compact
from mazu_tpu.index.spt import SPT as MSPT
from mazu_tpu.kphf.kcdict import KCDict as MKCDict
from mazu_tpu.kphf.kcdict import kcdict_k2u as m_k2u

import mazu_tpu_torch.io.checkpoint as pck
from mazu_tpu_torch.bits.seqvector import SeqVector
from mazu_tpu_torch.containers.refseq import RefSeqCollection
from mazu_tpu_torch.containers.unitig_set import UnitigSet
from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index import twophase
from mazu_tpu_torch.index.modindex import ModIndex, get_ref_pos_compact
from mazu_tpu_torch.index.spt import SPT
from mazu_tpu_torch.kphf.kcdict import KCDict, kcdict_k2u
from mazu_tpu_torch.ops.mono2_probe import card_table

from torch_fixtures import (
    assert_same, capacity_queries, mono2_recipe, same_tree, seq_recipe, tensor, toy_recipe,
)

RECIPES = {"mono2_dict": mono2_recipe, "toy": toy_recipe, "seq": lambda: seq_recipe()[0]}


def _pair(recipe, scheme: str, load: float, occs: bool = True):
    seqs, k, occ, lens = recipe
    names = [f"r{i}" for i in range(len(lens))]
    mus, pus = MUnitigs.from_seqs(seqs, k), UnitigSet.from_seqs(seqs, k)
    mu2 = MSPT(mus, names, *occ, lens).piscem_table()
    pu2 = SPT(pus, names, *occ, lens).piscem_table()
    ref = MModIndex(MKCDict.from_unitig_set(mus, load, mu2 if occs else None, scheme), mu2,
                    MRefs.from_lens(lens, names), index_type="t")
    port = ModIndex(KCDict.from_unitig_set(pus, load, pu2 if occs else None, scheme), pu2,
                    RefSeqCollection.from_lens(lens, names), index_type="t")
    return ref, port


@pytest.fixture(scope="module", params=[(r, occs) for r in RECIPES for occs in (True, False)],
                ids=lambda p: f"{p[0]}-{'occs' if p[1] else 'bare'}")
def cuckoo(request):
    name, occs = request.param
    return _pair(RECIPES[name](), "cuckoo", 0.65, occs)


def test_cuckoo_default_signature():
    """The reference's signature and defaults: (unitigs, load=0.65,
    occ_table=None, scheme="cuckoo"), positionally too."""
    seqs, k, _, _ = mono2_recipe()
    kc = KCDict.from_unitig_set(UnitigSet.from_seqs(seqs, k))
    ref = MKCDict.from_unitig_set(MUnitigs.from_seqs(seqs, k))
    assert kc.scheme == ref.scheme == "cuckoo" and kc.T == ref.T and kc.salt == ref.salt
    same_tree(kc.device_arrays(), ref.device_arrays())


def test_cuckoo_tables_byte_for_byte(cuckoo):
    ref, port = cuckoo
    assert port.k2u.scheme == "cuckoo" and port.k2u.side is None
    assert (port.k2u.T, port.k2u.salt) == (ref.k2u.T, ref.k2u.salt)
    same_tree(port.k2u.device_arrays(), ref.k2u.device_arrays())
    assert port.k2u.num_bits() == ref.k2u.num_bits()


@pytest.mark.parametrize("mode", ["main", "full"])
def test_cuckoo_query(cuckoo, mode):
    ref, port = cuckoo
    work = capacity_queries(ref.k2u.unitigs, 1000, seed=7)
    want = m_k2u(ref.k2u.device_arrays(), work, np, mode=mode)
    got = kcdict_k2u(arrays_from_numpy(port.k2u.device_arrays(), "cpu"), tensor(work), mode)
    assert set(got) == set(want)
    for key in want:
        assert_same(got[key], want[key], key)
    assert (want["mt"] == 1).any() and (want["mt"] == 2).any() and (want["mt"] == 0).any()
    if mode == "main":
        assert not got["unresolved"].any() and not got["use_skew"].any()


def test_cuckoo_compact_query(cuckoo):
    """The two-phase query of a cuckoo index (its main probe plain torch)
    equals the reference's."""
    ref, port = cuckoo
    work = capacity_queries(ref.k2u.unitigs, 512, seed=9)
    mo = max(1, ref.max_occs())
    want = m_compact(ref.device_arrays(fused=True), work, np, mo, m2=512)
    got = get_ref_pos_compact(arrays_from_numpy(port.device_arrays(fused=True), "cpu"),
                              tensor(work), mo, m2=512)
    for key in ("unitig_id", "unitig_len", "pos", "mt", "n_occs", "valid"):
        assert_same(got[key], want[key], key)
    v = want["valid"]
    for key in ("ref_id", "ref_pos", "orient"):
        assert_same(torch.where(got["valid"], got[key], 0), np.where(v, want[key], 0), key)


def test_cuckoo_placement_keeps_numpys_sort():
    """Ties in a placement round (same bucket, same priority) decide the
    slot; the builder keeps NumPy's own (unstable) argsort, so duplicate
    canonical k-mers land as the reference puts them."""
    seqs, k, occ, lens = mono2_recipe()
    seqs = seqs + seqs[:3]  # each k-mer of three unitigs twice
    mus, pus = MUnitigs.from_seqs(seqs, k), UnitigSet.from_seqs(seqs, k)
    ref = MKCDict.from_unitig_set(mus)
    port = KCDict.from_unitig_set(pus)
    same_tree(port.device_arrays(), ref.device_arrays())


# ------------------------------------------------------------ wide slots
@pytest.fixture(scope="module")
def wide():
    """One unitig set for both packages: a 2^24-base unitig (the shortest
    that needs wide slots) and six of 200 bases, each its own reference,
    the long one also reverse on a seventh; mono2 dictionaries at load 1."""
    rng = np.random.default_rng(5)
    L = 1 << 24
    codes = rng.integers(0, 4, L + 6 * 200).astype(np.uint8)
    accum = np.concatenate([[0, L], L + 200 * np.arange(1, 7)]).astype(np.int64)
    occ = (np.array([0, 0, 1, 2, 3, 4, 5, 6]), np.array([0, 7, 1, 2, 3, 4, 5, 6]),
           np.array([0, 9, 0, 0, 0, 0, 0, 0]), np.array([1, 0, 1, 1, 1, 1, 1, 1]))
    lens = np.array([L] + [200] * 6 + [L + 9])
    names = [f"r{i}" for i in range(8)]
    mus = MUnitigs(31, MSeqVector.from_codes(codes), accum)
    pus = UnitigSet(31, SeqVector.from_codes(codes), accum)
    mu2 = MSPT(mus, names, *occ, lens).piscem_table()
    pu2 = SPT(pus, names, *occ, lens).piscem_table()
    ref = MModIndex(MKCDict.from_unitig_set(mus, 1.0, mu2, "mono2"), mu2,
                    MRefs.from_lens(lens, names), index_type="t")
    port = ModIndex(KCDict.from_unitig_set(pus, 1.0, pu2, "mono2"), pu2,
                    RefSeqCollection.from_lens(lens, names), index_type="t")
    pos = np.concatenate([rng.integers(0, L - 31, 1500), accum[1] + rng.integers(0, 1200, 300)])
    work = pus.get_kmer_u64(np.sort(pos))
    flip = rng.random(len(work)) < 0.5
    from mazu_tpu_torch.kmer import revcomp_np

    work[flip] = revcomp_np(work[flip], 31)
    work[rng.random(len(work)) < 0.1] = rng.integers(0, 1 << 62, 1, dtype=np.uint64)
    return ref, port, work


def test_wide_mono2_byte_for_byte(wide):
    ref, port, _ = wide
    assert port.k2u.slot_words == ref.k2u.slot_words == 10 and not port.k2u.occ32
    same_tree(port.k2u.device_arrays(), ref.k2u.device_arrays())


@pytest.mark.parametrize("scheme", ["mono2", "mono"])
@pytest.mark.parametrize("mode", ["main", "full"])
def test_wide_query(wide, scheme, mode):
    """The wide mono2 query, and the wide mono layout (8-word slots, the
    cuckoo's too): the mono2 table without its second-occurrence columns,
    which is the mono dictionary of the same keys at the same load."""
    ref, port, work = wide
    host = ref.k2u.device_arrays()
    if scheme == "mono":
        t = ref.k2u.table.reshape(ref.k2u.T, 2, 10)[:, :, :8].reshape(ref.k2u.T, 16)
        s = ref.k2u.side.reshape(-1, 2, 10)[:, :, :8].reshape(-1, 16)
        host = {**host, "table": t, "side": s,
                "meta": host["meta"].replace(scheme="mono", sw=8, split=False)}
    want = m_k2u(host, work, np, mode=mode)
    got = kcdict_k2u(arrays_from_numpy(host, "cpu"), tensor(work), mode)
    assert set(got) == set(want)
    for key in want:
        assert_same(got[key], want[key], key)
    assert (want["unitig_len"] == 1 << 24).any() and (want["pos"] >= 1 << 23).any()


def test_wide_mono2_stays_off_k1(wide, monkeypatch):
    """A wide mono2 dictionary is not occ32: the main probe takes the plain
    query, never ``mono2_k2u``, and its table goes to the card as it is."""
    ref, port, work = wide

    def k1(*a, **kw):
        raise AssertionError("K1 saw a wide dictionary")

    monkeypatch.setattr(twophase, "mono2_k2u", k1)
    d = arrays_from_numpy(port.device_arrays(fused=True), "cpu")
    assert card_table(d["k2u"]["meta"], d["k2u"]["table"]) is d["k2u"]["table"]
    mo = max(1, ref.max_occs())
    want = m_compact(ref.device_arrays(fused=True), work, np, mo, m2=len(work))
    got = get_ref_pos_compact(d, tensor(work), mo, m2=len(work))
    for key in ("unitig_id", "unitig_len", "pos", "mt", "n_occs", "ref_pos", "valid"):
        assert_same(got[key], want[key], key)


# ---------------------------------------------------------- bucket_range
@pytest.fixture(scope="module", params=[("mono", 4.0, True), ("mono2", 0.25, True),
                                        ("mono2", 4.0, False)],
                ids=lambda p: f"{p[0]}-{p[1]}-{'occ32' if p[2] else 'slot-rows'}")
def single_hash(request):
    scheme, load, occs = request.param
    ref, port = _pair(seq_recipe()[0], scheme, load, occs)
    work = capacity_queries(ref.k2u.unitigs, 1024, seed=13)
    return ref, port, work


@pytest.mark.parametrize("mode", ["main", "full"])
@pytest.mark.parametrize("n_shards", [1, 4])
def test_bucket_range(single_hash, mode, n_shards):
    """Each shard's answer equals the reference's; off its lanes every
    field is exact zero; the shards' sum is the unsharded answer; a
    side-table hit comes from one shard only."""
    ref, port, work = single_hash
    host_ref, host_port = ref.k2u.device_arrays(), port.k2u.device_arrays()
    T, rf = ref.k2u.T, host_ref["table"].shape[0] // ref.k2u.T
    bt = T // n_shards
    whole = kcdict_k2u(arrays_from_numpy(host_port, "cpu"), tensor(work), mode)
    total = {key: torch.zeros_like(v, dtype=torch.int64) for key, v in whole.items()}
    owners = torch.zeros(len(work), dtype=torch.int64)
    for s in range(n_shards):
        blo, bhi = s * bt, (s + 1) * bt
        local_ref = {**host_ref, "table": host_ref["table"][blo * rf: bhi * rf]}
        local = arrays_from_numpy({**host_port, "table": host_port["table"][blo * rf: bhi * rf]},
                                  "cpu")
        want = m_k2u(local_ref, work, np, mode=mode, bucket_range=(blo, bhi))
        got = kcdict_k2u(local, tensor(work), mode, bucket_range=(blo, bhi))
        assert set(got) == set(want)
        for key in want:
            assert_same(got[key], want[key], f"shard {s} {key}")
        mine = got["mt"] > 0
        if mode == "main":
            mine = mine | got["unresolved"]
        owners += mine.to(torch.int64)
        for key, v in got.items():
            total[key] += v.to(torch.int64)
    for key, v in whole.items():
        assert torch.equal(total[key], v.to(torch.int64)), key
    assert int(owners.max()) <= 1
    if mode == "main":  # every lane has one owner: a hit, or unresolved there
        assert bool((owners == 1).all())
    if mode == "full" and port.k2u.side is not None:
        main = kcdict_k2u(arrays_from_numpy(host_port, "cpu"), tensor(work), "main")
        assert ((whole["mt"] > 0) & main["unresolved"]).any(), "no side-table hit in the batch"


def test_bucket_range_refuses_cuckoo(cuckoo):
    _, port = cuckoo
    d = arrays_from_numpy(port.k2u.device_arrays(), "cpu")
    with pytest.raises(ValueError, match="single-hash"):
        kcdict_k2u(d, torch.zeros(4, dtype=torch.int64), bucket_range=(0, 1))


# ------------------------------------------------------- build and files
def test_piscem_cuckoo_engine_and_checkpoint(tmp_path):
    """``piscem_index_from_spt(engine="cuckoo")`` is the reference's index
    byte for byte, and its checkpoint crosses in both directions."""
    from mazu_tpu.index.piscem_index import piscem_index_from_spt as m_piscem
    from mazu_tpu_torch.index.piscem_index import piscem_index_from_spt

    seqs, k, occ, lens = seq_recipe()[0]
    names = [f"r{i}" for i in range(len(lens))]
    mspt = MSPT(MUnitigs.from_seqs(seqs, k), names, *occ, lens)
    pspt = SPT(UnitigSet.from_seqs(seqs, k), names, *occ, lens)
    ref = m_piscem(mspt, 15, 64, engine="cuckoo")
    port = piscem_index_from_spt(pspt, 15, 64, engine="cuckoo", device="cpu")
    same_tree(port.device_arrays(), ref.device_arrays())
    a, b = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    mck.save_index(ref, a)
    pck.save_index(port, b)
    back_port, back_ref = pck.load_index(a), mck.load_index(b)
    same_tree(back_port.device_arrays(), ref.device_arrays())
    same_tree(back_ref.device_arrays(), port.device_arrays())
    work = capacity_queries(ref.k2u.unitigs, 256, seed=2)
    mo = max(1, ref.max_occs())
    want = m_compact(back_ref.device_arrays(fused=True), work, np, mo, m2=256)
    got = get_ref_pos_compact(arrays_from_numpy(back_port.device_arrays(fused=True), "cpu"),
                              tensor(work), mo, m2=256)
    for key in ("unitig_id", "pos", "mt", "n_occs", "valid"):
        assert_same(got[key], want[key], key)


# --------------------------------------------------------------- C16
@pytest.mark.parametrize("budget_div", [1, 4, 256])
def test_compact_budget_div(budget_div):
    """``get_ref_pos_compact``'s phase-2 capacity is max(64, N //
    budget_div) unless ``m2`` names it, as the reference's."""
    from torch_fixtures import build_pair

    ref, port = build_pair(toy_recipe())
    work = capacity_queries(ref.k2u.unitigs, 2048, seed=17)
    mo = max(1, ref.max_occs())
    want = m_compact(ref.device_arrays(fused=True), work, np, mo, budget_div=budget_div,
                     merge=False)
    got = get_ref_pos_compact(arrays_from_numpy(port.device_arrays(fused=True), "cpu"),
                              tensor(work), mo, budget_div=budget_div, merge=False)
    M = max(64, 2048 // budget_div)
    assert got["lanes"].shape == (M,) == np.asarray(want["lanes"]).shape
    assert bool(got["over_budget"]) == bool(want["over_budget"])
    assert int(got["n_ovf"]) == int(want["n_ovf"])
    sr = np.asarray(want["slot_real"])
    assert_same(got["slot_real"], sr)
    assert_same(torch.where(got["slot_real"], got["lanes"], 0), np.where(sr, want["lanes"], 0))
    for key in ("unitig_id", "mt", "n_occs"):
        assert_same(got["main"][key], want["main"][key], key)


def test_compact_positional_budget_div():
    """The reference's positional order after max_occs: budget_div, merge,
    probe_limit, m2. ``(d, fw, mo, 8)`` sets budget_div in both packages."""
    from torch_fixtures import build_pair

    ref, port = build_pair(toy_recipe())
    work = capacity_queries(ref.k2u.unitigs, 1024, seed=19)
    mo = max(1, ref.max_occs())
    want = m_compact(ref.device_arrays(fused=True), work, np, mo, 8)
    got = get_ref_pos_compact(arrays_from_numpy(port.device_arrays(fused=True), "cpu"),
                              tensor(work), mo, 8)
    assert "ref_id" in got and "ref_id" in want  # merged: merge stays True
    for key in ("unitig_id", "pos", "mt", "n_occs", "valid", "over_budget"):
        assert_same(got[key], want[key], key)
    pieces = get_ref_pos_compact(arrays_from_numpy(port.device_arrays(fused=True), "cpu"),
                                 tensor(work), mo, 8, False, None, 128)
    assert pieces["lanes"].shape == (128,)
