"""The parity SSHash of ``mazu_tpu_torch`` (the reference's default engine:
mix64 or wyhash minimizer ordering, 64-bit BooPHF minimizer MPHF,
Elias-Fano bucket bounds over packed positions) against ``mazu_tpu``'s,
at tolerance 0: the orderings, the build byte for byte with and without a
heavy bucket, ``sshash_k2u`` in full and main mode, and the drivers
(``get_ref_pos_compact``, ``TwoPhaseIndexQuery`` in both tiers, the tier
rule, the read mapper). ``test_parity_capacity_main_phase`` holds the
fault the parity engine met in the port: ``_main_phase`` sent any packed
SSHash with deferred validation to kernel K3, whose layout check raises
on a mix64 ordering."""

import jax
import numpy as np
import pytest
import torch

import mazu_tpu.index.modindex as mmi
import mazu_tpu.index.twophase as mtp
import mazu_tpu.kmer as mkmer
import mazu_tpu.kphf.sshash as msshash

from mazu_tpu_torch import kmer as pkmer, synth
from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index import mapping as pmapping, modindex as pmi, twophase as ptp
from mazu_tpu_torch.index.tuning import query_tier, speed_bytes
from mazu_tpu_torch.kphf import sshash as psshash

from torch_fixtures import (
    assert_same, build_parity_pair, capacity_queries, same_tree, seq_recipe, tensor,
)

N = 2048
W = 15
PACKED = dict(prefix_kind="grouped16", pos_kind="packed")


def _low_wmer(w: int, seed: int) -> str:
    """The w-mer, of 2^14 random ones, whose larger mix64 score over its
    two strands is the lowest: it is the minimizer of almost every k-mer
    that holds it, on either strand."""
    rng = np.random.default_rng(seed)
    cand = rng.integers(0, 1 << (2 * w), 1 << 14, dtype=np.uint64)
    rc = mkmer.revcomp(cand, w)
    score = np.maximum(mkmer.mix64(cand), mkmer.mix64(rc))
    return mkmer.kmer_to_str(cand[np.argmin(score)], w)


def heavy_recipe(sites: int = 40):
    """``seq_recipe``'s references with one low-ranked 15-mer planted at
    ``sites`` places (one a reference, the first 1000 bases of 40 2 kb
    references): its bucket holds ``sites`` occurrences, past a skew
    threshold of 8."""
    (seqs, k, occ, lens), _ = seq_recipe(n_refs=40, length=2000, seed=5)
    wmer = _low_wmer(W, 9)
    rng = np.random.default_rng(2)
    seqs = list(seqs)
    for i in range(sites):
        at = int(rng.integers(0, 1000))
        seqs[i] = seqs[i][:at] + wmer + seqs[i][at + W:]
    return seqs, k, occ, lens


RECIPES = {
    "plain": lambda: seq_recipe(n_refs=40, length=2000, seed=5)[0],
    "heavy": heavy_recipe,
}
PAIRS = {  # name: (recipe, skew, minimizer_hash)
    "plain": ("plain", 8, None),
    "heavy": ("heavy", 8, None),
    "heavy_noskew": ("heavy", None, None),
    "heavy_wyhash": ("heavy", 8, "wyhash"),
}
_CACHE = {}


def pair(name):
    if name not in _CACHE:
        recipe, skew, mh = PAIRS[name]
        _CACHE[name] = build_parity_pair(RECIPES[recipe](), w=W, skew=skew, minimizer_hash=mh)
    return _CACHE[name]


# ------------------------------------------------------------- orderings


def _words(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    w[:8] = [0, 1, (1 << 63), (1 << 64) - 1, (1 << 63) - 1, 0x9E3779B97F4A7C15, 5, 1 << 62]
    return w


@pytest.mark.parametrize("seed", [0, 1, 7, (1 << 63) + 5])
def test_mix64(seed):
    x = _words(20000, 1)
    want = mkmer.mix64(x, np.uint64(seed))
    got = pkmer.mix64(tensor(x), seed).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, want)
    assert (want >> np.uint64(63)).any(), "no score with bit 63 set"


@pytest.mark.parametrize("ordering", ["mix64", "wyhash", "mix32"])
@pytest.mark.parametrize("k, w", [(31, 15), (31, 19), (21, 11), (31, 31)])
def test_minimizer_orderings(ordering, k, w):
    rng = np.random.default_rng(k * w)
    words = rng.integers(0, 1 << (2 * k), 20000, dtype=np.uint64)
    for seed in (0, 3):
        want = mkmer.canonical_minimizer_batch(np, words, k, w, seed, ordering=ordering)
        got = pkmer.canonical_minimizer_batch(tensor(words), k, w, seed, ordering)
        np.testing.assert_array_equal(got[0].numpy().view(np.uint64), want[0])
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        np.testing.assert_array_equal(got[2].numpy(), want[2])
        np.testing.assert_array_equal(got[3].numpy().view(np.uint64), want[3])


def test_unsigned_score_compare():
    """mix64 scores of the windows of these k-mers straddle bit 63: a signed
    compare picks another minimizer for some of them."""
    rng = np.random.default_rng(11)
    words = rng.integers(0, 1 << 62, 5000, dtype=np.uint64)
    canon = np.minimum(words, mkmer.revcomp(words, 31))
    mv = (canon[:, None] >> (2 * np.arange(17, dtype=np.uint64))[None, :]) & np.uint64(
        (1 << 30) - 1)
    sc = mkmer.mix64(mv)
    assert ((sc >> np.uint64(63)) == 1).any(axis=1).sum() > 1000
    want = mkmer.canonical_minimizer_batch(np, words, 31, 15, 0, ordering="mix64")[0]
    got = pkmer.canonical_minimizer_batch(tensor(words), 31, 15, 0, "mix64")[0]
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    signed = np.argmin(sc.view(np.int64), axis=1)
    assert (mv[np.arange(len(mv)), signed] != want).sum() > 1000


def test_unknown_ordering_raises():
    with pytest.raises(ValueError, match="unknown minimizer ordering"):
        pkmer.canonical_minimizer_batch(tensor(_words(16, 0)), 31, 15, 0, "mix16")


# ----------------------------------------------------------------- build


@pytest.mark.parametrize("name", list(PAIRS))
def test_build_byte_for_byte(name):
    ref, port = pair(name)
    mss, pss = ref.k2u, port.k2u
    assert pss.ordering == mss.ordering and not pss.hash32
    np.testing.assert_array_equal(pss.occs_prefix_sum, mss.occs_prefix_sum)
    np.testing.assert_array_equal(pss.pos.words, mss.pos.words)
    assert pss.pos.width == mss.pos.width
    for a, b in ((pss.mphf, mss.mphf), (pss.skew_mphf, mss.skew_mphf)):
        if b is None:
            assert a is None
            continue
        assert (a.n_elem, a.last_bitset_rank, len(a.levels)) == (
            b.n_elem, b.last_bitset_rank, len(b.levels))
        for (na, wa, ra), (nb, wb, rb) in zip(a.levels, b.levels):
            assert na == nb
            np.testing.assert_array_equal(wa, wb)
            np.testing.assert_array_equal(ra, rb)
        np.testing.assert_array_equal(a.fh_keys, b.fh_keys)
        np.testing.assert_array_equal(a.fh_vals, b.fh_vals)
    if mss.skew_pos is not None:
        np.testing.assert_array_equal(pss.skew_pos.words, mss.skew_pos.words)
    assert pss.max_bucket() == mss.max_bucket()
    assert pss.probe_bound() == mss.probe_bound()
    assert pss.n_kmers_in_skew_index == mss.n_kmers_in_skew_index
    assert pss.n_minimizers == mss.n_minimizers
    assert pss.num_bits() == mss.num_bits()
    same_tree(pss.device_arrays(), mss.device_arrays())
    lines_w, lines_g = [], []
    mss.print_stats(log=lines_w.append)
    pss.print_stats(log=lines_g.append)
    assert lines_g == lines_w


def test_heavy_bucket_and_dummy_skew_index():
    """The heavy recipe has a bucket past the skew threshold, whose k-mers
    go to the skew MPHF; without one the skew MPHF holds the one key 0."""
    ref, port = pair("heavy")
    assert port.k2u.max_bucket() > 8 and port.k2u.n_kmers_in_skew_index > 100
    plain_ref, plain = pair("plain")
    assert plain.k2u.max_bucket() <= 8
    assert plain.k2u.skew_mphf.n_elem == 1 and plain.k2u.n_kmers_in_skew_index == 1
    assert plain.k2u.skew_mphf.lookup(np.zeros(1, np.uint64), device="cpu")[0] == 0
    assert pair("heavy_noskew")[1].k2u.skew_mphf is None


def test_no_skew_index_builder():
    ref, port = pair("heavy_noskew")
    ss = psshash.SSHash.from_unitig_set_no_skew_index(port.k2u.unitigs, W, device="cpu")
    np.testing.assert_array_equal(ss.pos.words, port.k2u.pos.words)
    assert ss.skew_param is None and ss.probe_bound() == ss.max_bucket()


def test_default_layout_follows_the_engine():
    ref, port = pair("plain")
    m = port.k2u.device_arrays()["meta"]
    assert (m.pos_kind, m.prefix_kind, m.ordering, m.hash32) == ("packed", "ef", "mix64", False)
    for kw in (dict(pos_kind="packed", prefix_kind="grouped16"),
               dict(pos_kind="inline2"), dict(pos_kind="inline", prefix_kind="flat32")):
        same_tree(port.k2u.device_arrays(**kw), ref.k2u.device_arrays(**kw))
    with pytest.raises(ValueError, match="minimizer_hash is a parity-engine option"):
        psshash.SSHash.from_unitig_set(port.k2u.unitigs, W, engine="fast32",
                                       minimizer_hash="wyhash", device="cpu")


# ----------------------------------------------------------------- query


KINDS = {
    "ef": {},
    "grouped16": PACKED,
    "inline2_ef": dict(pos_kind="inline2"),
}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("name", list(PAIRS))
def test_sshash_k2u(name, kind):
    ref, port = pair(name)
    want_d = ref.k2u.device_arrays(**KINDS[kind])
    d = arrays_from_numpy(port.k2u.device_arrays(**KINDS[kind]), "cpu")
    work = capacity_queries(ref.k2u.unitigs, N, seed=4)
    fw = tensor(work)
    for kw in (dict(mode="full"), dict(mode="main"), dict(mode="main", probe_limit=1),
               dict(mode="main", probe_limit=2, defer_valid=True),
               dict(mode="main", probe_limit=2, mphf_level_limit=2)):
        if kind == "inline2_ef" and kw.get("defer_valid"):
            continue
        want = msshash.sshash_k2u(want_d, work, np, **kw)
        got = psshash.sshash_k2u(d, fw, **kw)
        assert set(got) == set(want), kw
        for key in want:
            assert_same(got[key], want[key], f"{kw} {key}")
    full = psshash.sshash_k2u(d, fw)
    assert (full["mt"].numpy() > 0).mean() > 0.8


@pytest.mark.parametrize("name", ["plain", "heavy"])
def test_ref_pos_compact(name):
    ref, port = pair(name)
    for layout in ({}, dict(PACKED, uproj=True)):
        host = ref.device_arrays(**layout)
        d = arrays_from_numpy(port.device_arrays(**layout), "cpu")
        work = capacity_queries(ref.k2u.unitigs, N, seed=5)
        mo = max(1, ref.max_occs())
        for kw in (dict(probe_limit=2), dict(probe_limit=2, defer_valid=True, m2b=N),
                   dict(probe_limit=2, defer_valid=True, mphf_level_limit=4, m2b=N,
                        probe_limit2=4, m2c=N)):
            want = mmi.get_ref_pos_compact(host, work, np, mo, merge=True, m2=N, **kw)
            got = pmi.get_ref_pos_compact(d, tensor(work), mo, merge=True, m2=N, **kw)
            v = np.asarray(want["valid"])
            for key in ("unitig_id", "unitig_len", "pos", "mt", "n_occs", "valid"):
                assert_same(got[key], want[key], f"{kw} {key}")
            for key in ("ref_id", "ref_pos", "orient"):
                assert_same(torch.where(got["valid"], got[key], 0), np.where(v, want[key], 0), key)


def test_parity_capacity_main_phase(monkeypatch):
    """A parity SSHash in the capacity tier's MPHF layout takes the plain
    main probe with deferred validation, as the reference runs it; kernel
    K3 is not asked (the parent routed it there, and K3's layout check
    raised on the mix64 ordering)."""
    ref, port = pair("heavy")
    layout = synth.MPHF_LAYOUT
    host = ref.device_arrays(**layout)
    d = arrays_from_numpy(port.device_arrays(**layout), "cpu")
    work = capacity_queries(ref.k2u.unitigs, N, seed=6)

    from mazu_tpu_torch.ops import capacity_probe

    with pytest.raises(ValueError, match="mix32 minimizer ordering"):
        capacity_probe.check_layout(d["k2u"], tensor(work), 2, 4)

    def k3(*a, **kw):
        raise AssertionError("a parity SSHash reached kernel K3")

    monkeypatch.setattr(ptp, "capacity_k2u", k3)
    for kw in (dict(probe_limit=2, defer_valid=True, mphf_level_limit=4),
               dict(probe_limit=2, defer_valid=True)):
        want = msshash.sshash_k2u(host["k2u"], work, np, mode="main", **kw)
        got, _ = ptp._main_probe(d, tensor(work), **kw)
        assert set(got) == set(want)
        for key in want:
            assert_same(got[key], want[key], f"{kw} {key}")
        assert np.asarray(want["use_skew"]).any()
        p = ptp._main_phase(d, tensor(work), 2, **kw)
        assert bool(p["overflow"].any()) and not bool(p["overflow"].all())


def test_fast32_capacity_still_takes_k3(monkeypatch):
    """The route to K3 still holds for a 32-bit engine's capacity layout."""
    from torch_fixtures import build_mphf_pair

    _, port = build_mphf_pair(seq_recipe()[0])
    d = arrays_from_numpy(port.device_arrays(**synth.MPHF_LAYOUT), "cpu")
    seen = []
    real = ptp.capacity_k2u
    monkeypatch.setattr(ptp, "capacity_k2u", lambda *a, **kw: seen.append(1) or real(*a, **kw))
    ptp._main_phase(d, tensor(capacity_queries(port.k2u.unitigs, 64, seed=1)), 2,
                    probe_limit=2, defer_valid=True)
    assert seen


# --------------------------------------------------------------- drivers


@pytest.mark.parametrize("name", ["plain", "heavy"])
def test_twophase_default(name):
    """Both classes' default on a parity SSHash: unfused, packed positions
    with Elias-Fano bounds."""
    ref, port = pair(name)
    want_tp = mtp.TwoPhaseIndexQuery(ref)
    got_tp = ptp.TwoPhaseIndexQuery(port, device="cpu")
    m = got_tp.index.arrays()["k2u"]["meta"]
    assert (m.pos_kind, m.prefix_kind) == ("packed", "ef")
    work = capacity_queries(ref.k2u.unitigs, N, seed=7)
    r_w, lanes_w, s_w = want_tp.query(work)
    r_g, lanes_g, s_g = got_tp.query(work)
    for key in r_w:
        assert_same(torch.from_numpy(r_g[key]), r_w[key], f"main {key}")
    np.testing.assert_array_equal(lanes_g, lanes_w)
    for key in s_w:
        assert_same(torch.from_numpy(s_g[key]), s_w[key], f"overflow {key}")
    if name == "plain":  # the reference's checksum graphs compile slowly on the CPU
        assert got_tp.checksum_query(tensor(work)) == want_tp.checksum_query(
            jax.numpy.asarray(work), work)


def test_twophase_capacity_layout():
    ref, port = pair("heavy")
    layout = dict(PACKED, uproj=True)
    want_tp = mtp.TwoPhaseIndexQuery(ref, probe_limit=2)
    want_tp.arrays = jax.device_put(ref.device_arrays(**layout))
    got_tp = ptp.TwoPhaseIndexQuery(port, probe_limit=2, device="cpu", **layout)
    work = capacity_queries(ref.k2u.unitigs, N, seed=8)
    assert got_tp.get_ref_pos_eager(work) == want_tp.get_ref_pos_eager(work)


def test_tier_rule_and_speed_bytes(monkeypatch):
    ref, port = pair("heavy")
    monkeypatch.delenv("MAZU_HBM_BUDGET", raising=False)
    got = speed_bytes(port)
    host = port.device_arrays()
    n = sum(v.nbytes for v in _leaves(host))
    assert got == n
    assert query_tier(port, budget=10 * n) == "speed"
    assert query_tier(port, budget=n // 2) == "capacity"


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        elif isinstance(v, np.ndarray):
            yield v


@pytest.mark.parametrize("tier", ["speed", "capacity"])
def test_read_mapper(tier, monkeypatch):
    """The mapper in both tiers on a parity SSHash: the same hits as the
    exact padded query, read by read."""
    ref, port = pair("heavy")
    if tier == "capacity":
        monkeypatch.setenv("MAZU_HBM_BUDGET", "1")
    mapper = pmapping.ReadMapper(port, device="cpu")
    held = mapper.tp.index.arrays()["k2u"]["meta"]
    assert pmapping.layout_tier(held) == tier
    rng = np.random.default_rng(3)
    seqs = [port.k2u.unitigs.useq.to_str(int(s), int(s) + 120)
            for s in rng.integers(0, port.k2u.unitigs.total_len - 121, 64)]
    got = mapper.map_reads(seqs)
    from mazu_tpu_torch.index.validate import valid_kmer_windows

    for s, r in zip(seqs, got):
        words = valid_kmer_windows(s, port.k)[1]
        assert r.hits == port.get_ref_pos_eager(words)
    other = "capacity" if tier == "speed" else "speed"
    with pytest.raises(ValueError, match="tier's layout"):
        pmapping.query_driver(port, query_index=mapper.tp.index, tier=other)
