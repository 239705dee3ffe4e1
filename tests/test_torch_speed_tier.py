"""The port's SSHash speed tier against mazu_tpu's, with tolerance 0: the
inline and inline2 row layouts with flat32 bounds, plain and fused
(``ModIndex.device_arrays(fused=True)``), byte for byte, on a direct SSHash
with a cuckoo skew table (skew 8), one with a bounded-bucket skew table
(skew 2, the cuckoo placement patched away in both packages) and a fast32
SSHash (skew 8); ``sshash_k2u`` on them in main mode at probe limits None,
1, 2 and 3 and in full mode from rows 0 and 2 (the reference with
``xp=np``); ``get_ref_pos_compact`` on fused rows with and without the
type-split heavy phase; ``TwoPhaseIndexQuery``'s default (the reference's
jitted on the CPU); the tier rule of ``ReadMapper``; ``StreamingIndex`` and
``validate_self`` with no layout.

The reference fault C10: on a fused fast32 SSHash the reference's full
mode reports its skew lanes with the probe's empty occurrence fields, so
its two-phase query gives them no occurrences. The port's full mode gives
a fast32 index's lanes no fused fields and projects them through the
offsets table: it equals the exact padded query on the capacity layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mazu_tpu.kphf.sshash as msshash
import mazu_tpu.index.modindex as mmi
import mazu_tpu.index.twophase as mtp
from mazu_tpu.index.streaming import StreamingIndex as MStreamingIndex
from mazu_tpu.index.streaming import kmerize_reads as m_kmerize_reads
from mazu_tpu.index.validate import validate_self as m_validate_self

import mazu_tpu_torch.kphf.sshash as psshash
from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index import mapping, modindex as pmi, twophase as ptp
from mazu_tpu_torch.index.modindex import QueryIndex
from mazu_tpu_torch.index.streaming import StreamingIndex, kmerize_reads
from mazu_tpu_torch.index.tuning import (
    SPEED_MAX_PROBE_BOUND, arrays_budget, query_tier, speed_bytes,
)
from mazu_tpu_torch.index.validate import validate_self

from torch_fixtures import (
    assert_same, build_capacity_pair, build_mphf_pair, capacity_queries, same_tree, seq_recipe,
    tensor, toy_recipe, with_refs, write_fasta,
)

N = 1024
PAIRS = ("direct", "bucket", "fast32")
LAYOUTS = [(kind, fused) for kind in ("inline", "inline2") for fused in (False, True)]
OCC_KEYS = ("occ_word", "occ_cnt", "occ_start", "occ_word2")
PACKED = dict(prefix_kind="grouped16", pos_kind="packed")
_PAIRS = {}


def pair(name):
    """(reference ModIndex, port ModIndex, queries) of a pair, built once."""
    if name not in _PAIRS:
        recipe = toy_recipe()
        if name == "fast32":
            ref, port = build_mphf_pair(recipe)
        elif name == "direct":
            ref, port = build_capacity_pair(recipe)
        else:
            with pytest.MonkeyPatch.context() as mp:
                for mod in (msshash, psshash):
                    mp.setattr(mod.SSHash, "_place_skew_cuckoo",
                               staticmethod(lambda *a, **kw: None))
                ref, port = build_capacity_pair(recipe, skew=2)
        _PAIRS[name] = ref, port, capacity_queries(ref.k2u.unitigs, N, seed=3)
    return _PAIRS[name]


def arrays(name, kind, fused):
    """(reference arrays, port arrays as tensors) of a pair's layout."""
    ref, port, _ = pair(name)
    want = ref.device_arrays(fused=fused, pos_kind=kind)
    return want, arrays_from_numpy(port.device_arrays(fused=fused, pos_kind=kind), "cpu")


@pytest.mark.parametrize("kind,fused", LAYOUTS)
@pytest.mark.parametrize("name", PAIRS)
def test_device_arrays(name, kind, fused):
    """Rows, skew rows and bounds byte for byte. The reference's direct
    build emits only ``flat2`` where its native library loads, ``flat`` and
    ``flat2`` where it does not; the port's direct build emits ``flat2``
    alone and its fast32 build both, as the reference's does."""
    ref, port, _ = pair(name)
    want = ref.device_arrays(fused=fused, pos_kind=kind)
    got = port.device_arrays(fused=fused, pos_kind=kind)
    wp, gp = want["k2u"].pop("prefix"), got["k2u"].pop("prefix")
    np.testing.assert_array_equal(gp["flat2"], wp["flat2"])
    assert gp["flat2"].dtype == wp["flat2"].dtype == np.int32
    if name == "fast32":
        assert set(gp) == set(wp) == {"flat", "flat2"}
        np.testing.assert_array_equal(gp["flat"], wp["flat"])
    else:
        assert set(gp) == {"flat2"} and set(wp) <= {"flat", "flat2"}
    same_tree(got, want)
    width = {"inline": 10, "inline2": 8}[kind]
    if fused:  # the first occurrence word, count, occ_start; inline2's second word
        width += 4 if kind == "inline" else 6
    assert got["k2u"]["pos"]["inline"].shape[1] == width
    if name != "fast32":
        skew = want["k2u"]["meta"].skew_kind
        assert skew == ("bucket" if name == "bucket" else "cuckoo")
        assert got["k2u"]["skew_inline"].shape[1] == 8 + 4 * fused


@pytest.mark.parametrize("name", PAIRS)
def test_default_layout(name):
    """``SSHash.device_arrays()`` with no argument is the reference's
    default, inline rows with flat32 bounds; the capacity tier still takes
    its knobs, and the rest of the reference's layouts (records, fixedcap,
    fixedcap2 and flat32 positions, grouped32 and flat bounds) equal its
    arrays, the fixedcap rows on the direct engine only and fixedcap2's at a
    probe bound of 7 at most, as there; fusion refuses a layout without
    inline rows."""
    ref, port, _ = pair(name)
    want, got = ref.k2u.device_arrays(), port.k2u.device_arrays()
    assert got["meta"].pos_kind == "inline" and got["meta"].prefix_kind == "flat32"
    wp, gp = want.pop("prefix"), got.pop("prefix")
    np.testing.assert_array_equal(gp["flat2"], wp["flat2"])
    same_tree(got, want)
    same_tree(port.k2u.device_arrays(**PACKED), ref.k2u.device_arrays(**PACKED))
    for kw in (dict(pos_kind="records"), dict(pos_kind="fixedcap"), dict(pos_kind="fixedcap2"),
               dict(pos_kind="flat32"), dict(pos_kind="inline", prefix_kind="grouped32"),
               dict(pos_kind="inline", prefix_kind="flat")):
        refusal = ("engine='direct'" if kw["pos_kind"].startswith("fixedcap") and
                   name == "fast32" else "cnt rides in 3 uid bits"
                   if kw["pos_kind"] == "fixedcap2" and port.k2u.probe_bound() > 7 else None)
        if refusal:  # both packages assert
            for ss in (ref.k2u, port.k2u):
                with pytest.raises(AssertionError, match=refusal):
                    ss.device_arrays(**kw)
            continue
        want, got = ref.k2u.device_arrays(**kw), port.k2u.device_arrays(**kw)
        if "flat2" in got["prefix"] and name != "fast32":
            # the reference's direct build may keep its flat prefix beside
            np.testing.assert_array_equal(got["prefix"].pop("flat2"), want["prefix"].pop("flat2"))
            want["prefix"].pop("flat", None)
        same_tree(got, want)
    with pytest.raises(ValueError, match="inline row layout"):
        port.device_arrays(fused=True, **PACKED)
    with pytest.raises(ValueError, match="inline row layout"):
        port.device_arrays(fused=True, pos_kind="records")


def test_inline_rows_need_u32_positions(monkeypatch):
    """Both row kinds refuse a unitig set of 2^31 bases or more."""
    _, port, _ = pair("direct")
    monkeypatch.setattr(type(port.k2u.unitigs), "total_len", property(lambda self: 1 << 31))
    for kind in ("inline", "inline2"):
        with pytest.raises(AssertionError, match="2\\^31"):
            port.k2u.device_arrays(pos_kind=kind)


def _same_k2u(got: dict, want: dict, what: str, occ_dropped: bool = False):
    keys = set(want) - set(OCC_KEYS) if occ_dropped else set(want)
    assert set(got) == keys, f"{what}: keys {set(got) ^ keys}"
    for key in keys:
        assert_same(got[key], np.asarray(want[key]), f"{what} {key}")


@pytest.mark.parametrize("kind,fused", LAYOUTS)
@pytest.mark.parametrize("name", PAIRS)
def test_k2u(name, kind, fused):
    """Main mode at probe limits None, 1, 2, 3 and from row 2; full mode
    from rows 0 and 2. On a fused fast32 index full mode gives no fused
    fields (C10; ``test_c10``)."""
    want_d, got_d = arrays(name, kind, fused)
    work = pair(name)[2]
    fw = tensor(work)
    runs = [("main", plim, 0) for plim in (None, 1, 2, 3)] + [("main", 4, 2), ("full", None, 0),
                                                               ("full", None, 2)]
    for mode, plim, start in runs:
        want = msshash.sshash_k2u(want_d["k2u"], work, np, mode=mode, probe_limit=plim,
                                  probe_start=start)
        got = psshash.sshash_k2u(got_d["k2u"], fw, mode=mode, probe_limit=plim,
                                 probe_start=start)
        drop = fused and mode == "full" and name == "fast32"
        _same_k2u(got, want, f"{mode} plim={plim} start={start}", occ_dropped=drop)
    r = psshash.sshash_k2u(got_d["k2u"], fw, mode="main", probe_limit=1)
    assert bool(r["use_skew"].any()) and bool(r["unresolved"].any()) and bool((r["mt"] > 0).any())


@pytest.mark.parametrize("kind", ["inline", "inline2"])
@pytest.mark.parametrize("name", ["direct", "bucket"])
@pytest.mark.parametrize("split", [False, True])
def test_compact_query_on_fused_rows(name, kind, split):
    """``get_ref_pos_compact`` (merged) on fused rows at probe limit 2: the
    compacted phase alone, and type-split (type-A lanes read the fused
    ``occ_start``); equal to the reference's and to the exact padded
    query."""
    want_d, got_d = arrays(name, kind, True)
    ref, _, work = pair(name)
    mo = max(1, ref.max_occs())
    kw = dict(merge=True, m2=N, probe_limit=2, m2b=N if split else None)
    want = mmi.get_ref_pos_compact(want_d, work, np, mo, **kw)
    got = pmi.get_ref_pos_compact(got_d, tensor(work), mo, **kw)
    assert not bool(got["over_budget"])
    for key in want:
        assert_same(got[key], np.asarray(want[key]), key)
    pad = pmi.get_ref_pos_padded(got_d, tensor(work), mo)
    for key in ("mt", "n_occs", "unitig_id", "pos"):
        assert torch.equal(got[key], pad[key]), key
    if split:
        r = psshash.sshash_k2u(got_d["k2u"], tensor(work), mode="main", probe_limit=2)
        assert "occ_start" in r and bool(((r["occ_cnt"] > 2) & (r["mt"] > 0)).any())


@pytest.mark.parametrize("name", ["direct", "bucket"])
def test_twophase_default(name):
    """``TwoPhaseIndexQuery(index)`` takes fused inline rows on an SSHash,
    as the reference's does: checksum_query, query and the CSR batch equal
    the reference class's, jitted on the CPU."""
    ref, port, work = pair(name)
    want_tp = mtp.TwoPhaseIndexQuery(ref)
    got_tp = ptp.TwoPhaseIndexQuery(port, device="cpu")
    assert got_tp.index.arrays()["k2u"]["pos"]["inline"].shape[1] == 14
    assert got_tp.checksum_query(tensor(work)) == want_tp.checksum_query(jnp.asarray(work), work)
    (r_w, l_w, s_w), (r_g, l_g, s_g) = want_tp.query(work), got_tp.query(work)
    np.testing.assert_array_equal(l_g, l_w)
    for key in r_w:
        np.testing.assert_array_equal(r_g[key], np.asarray(r_w[key]).astype(r_g[key].dtype), key)
        assert r_g[key].shape == np.asarray(r_w[key]).shape, key
    for key in s_w:
        np.testing.assert_array_equal(s_g[key], np.asarray(s_w[key]).astype(s_g[key].dtype), key)
    got, want = got_tp.get_ref_pos_batch(work), want_tp.get_ref_pos_batch(work)
    for key in ("mt", "offsets", "ref_id", "ref_pos", "orient"):
        np.testing.assert_array_equal(getattr(got, key), np.asarray(getattr(want, key)), key)
    # an inline2 QueryIndex queried where it lies; a QueryIndex takes no layout
    qi = QueryIndex(arrays_from_numpy(port.device_arrays(fused=True, pos_kind="inline2"), "cpu"))
    assert ptp.TwoPhaseIndexQuery(qi).get_ref_pos_eager(work) == got_tp.get_ref_pos_eager(work)
    with pytest.raises(ValueError, match="layout and device"):
        ptp.TwoPhaseIndexQuery(qi, fused=True)


def test_c10():
    """C10 on the fused fast32 pair: the reference's two-phase query gives
    skew lanes that hit ``n_occs`` 0 where the exact padded query on the
    capacity layout finds their occurrences; the port's equals the padded
    query, lane for lane."""
    ref, port, work = pair("fast32")
    mo = max(1, ref.max_occs())
    truth = mmi.get_ref_pos_padded(ref.device_arrays(**PACKED), work, np, mo)
    main = msshash.sshash_k2u(ref.device_arrays(fused=True)["k2u"], work, np, mode="main")
    skew_hit = np.asarray(main["use_skew"]) & (truth["mt"] > 0)
    assert skew_hit.sum() > 0

    want_tp = mtp.TwoPhaseIndexQuery(ref)
    r, lanes, s = want_tp.query(work)
    at = np.searchsorted(lanes, np.flatnonzero(skew_hit))
    assert (np.asarray(s["mt"])[at] > 0).all()
    assert (np.asarray(s["n_occs"])[at] == 0).all() and (truth["n_occs"][skew_hit] > 0).all()

    got_tp = ptp.TwoPhaseIndexQuery(port, device="cpu")
    r, lanes, s = got_tp.query(work)
    np.testing.assert_array_equal(s["n_occs"], truth["n_occs"][lanes])
    v = s["valid"]
    for key in ("ref_id", "ref_pos", "orient"):
        np.testing.assert_array_equal(np.where(v, s[key], 0), np.where(v, truth[key][lanes], 0))
    ok = ~r["overflow"]
    np.testing.assert_array_equal(r["n_occs"][ok], truth["n_occs"][ok])
    assert got_tp.get_ref_pos_eager(work) == ref.get_ref_pos_eager(work)


def test_speed_bytes_counts_the_layout():
    """``speed_bytes`` is the byte count of the fused inline2 arrays, and
    the fused inline arrays hold the same."""
    for name in PAIRS:
        _, port, _ = pair(name)

        def nbytes(tree):
            if isinstance(tree, dict):
                return sum(nbytes(v) for v in tree.values())
            return tree.nbytes if isinstance(tree, np.ndarray) else 0

        n = speed_bytes(port)
        assert n == nbytes(port.device_arrays(fused=True, pos_kind="inline2")), name
        assert n == nbytes(port.device_arrays(fused=True)), name


@pytest.mark.parametrize("name", ["direct", "fast32"])
def test_tier_rule(name, monkeypatch):
    """``ReadMapper`` takes the speed tier (``TwoPhaseIndexQuery`` on fused
    inline rows) while the speed layout fits the budget's array share and
    the probe bound is at most ``SPEED_MAX_PROBE_BOUND``, and the capacity
    tier's ``CompactQuery`` otherwise; ``MAZU_HBM_BUDGET`` sets the budget,
    as in the reference. A ``tier`` argument overrides the rule, and a
    ``query_index`` in the other tier's layout raises."""
    _, port, work = pair(name)
    need = speed_bytes(port)
    fits = need + max(int(0.25 * need), int(2e9)) + 1
    assert port.k2u.probe_bound() <= SPEED_MAX_PROBE_BOUND
    assert arrays_budget(fits) >= need and query_tier(port, fits) == "speed"
    assert query_tier(port, need) == "capacity"
    monkeypatch.setenv("MAZU_HBM_BUDGET", str(fits))
    speed = mapping.ReadMapper(port, device="cpu").tp
    assert isinstance(speed, ptp.TwoPhaseIndexQuery)
    assert speed.index.arrays()["k2u"]["pos"]["inline"].shape[1] == 14
    forced = mapping.ReadMapper(port, device="cpu", tier="capacity").tp
    assert isinstance(forced, mapping.CompactQuery)
    with pytest.raises(ValueError, match="the capacity tier's layout"):
        mapping.ReadMapper(port, query_index=forced.index)
    with pytest.raises(ValueError, match="the speed tier's layout"):
        mapping.ReadMapper(port, query_index=speed.index, tier="capacity")
    with monkeypatch.context() as mp:
        mp.setattr(type(port.k2u), "probe_bound", lambda self: SPEED_MAX_PROBE_BOUND + 1)
        assert query_tier(port, fits) == "capacity"
        assert isinstance(mapping.ReadMapper(port, device="cpu").tp, mapping.CompactQuery)
    monkeypatch.setenv("MAZU_HBM_BUDGET", str(need))
    cap = mapping.ReadMapper(port, device="cpu").tp
    assert isinstance(cap, mapping.CompactQuery)
    assert isinstance(mapping.ReadMapper(port, device="cpu", tier="speed").tp,
                      ptp.TwoPhaseIndexQuery)
    assert speed.get_ref_pos_batch(work).to_lists() == cap.get_ref_pos_batch(work).to_lists()


@pytest.mark.parametrize("name", ["direct", "fast32"])
def test_streaming_default_layout(name):
    """``StreamingIndex`` on an SSHash with no layout (inline rows, flat32
    bounds) equals the reference's with its default, in flat mode."""
    ref, port, _ = pair(name)
    seqs = toy_recipe()[0]
    rng = np.random.default_rng(5)
    reads = []
    for s in seqs:
        a = int(rng.integers(0, len(s) - 80))
        reads.append(s[a : a + 80])
    kms, valid, _ = m_kmerize_reads(reads, ref.k)
    m = MStreamingIndex(ref, mode="flat")
    want = m.get_ref_pos_reads(kms, valid)
    si = StreamingIndex(port, mode="flat", device="cpu")
    assert si.index.arrays()["k2u"]["meta"].pos_kind == "inline"
    got = si.get_ref_pos_reads(*kmerize_reads(reads, port.k)[:2])
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), key)
    assert si.last_cold_fraction == m.last_cold_fraction


@pytest.mark.parametrize("build", [build_capacity_pair, build_mphf_pair])
def test_validate_self_default_layout(build, tmp_path):
    """``validate_self`` with no query on an SSHash whose references carry
    sequence passes in both packages, and the port's default query (the
    padded query on inline rows) equals the reference's."""
    recipe, seqs = seq_recipe(n_refs=12, length=300)
    fa = tmp_path / "refs.fa"
    write_fasta(fa, seqs)
    ref, port = with_refs(build(recipe), fa)
    m_validate_self(ref)
    validate_self(port, chunk=1000, device="cpu")
    qi, fn = port.make_query_fn(device="cpu")
    assert qi.arrays()["k2u"]["meta"].pos_kind == "inline"
    work = capacity_queries(ref.k2u.unitigs, 512, seed=4)
    want = mmi.get_ref_pos_padded(ref.device_arrays(), work, np, max(1, ref.max_occs()))
    got = fn(tensor(work))
    for key in want:
        assert_same(got[key], np.asarray(want[key]), key)
