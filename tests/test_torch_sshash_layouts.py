"""The port's SSHash device layouts against mazu_tpu's, with tolerance 0:
every (engine, pos_kind, prefix_kind) the reference's ``device_arrays``
takes, as the same array tree and as the same ``sshash_k2u`` outputs in
full mode (from rows 0 and 1) and in main mode (probe limits None, 1 and
2, and deferred validation), the reference run with ``xp=np``. The direct
pairs plant repeated 40-base motifs, so buckets hold 4 to 7 occurrences
(fixedcap2's slot 0 then carries its count in uid bit 31) and 15 (a heavy
bucket); their tables have T >= 2048 buckets, and grouped32's bounds are
held at every bucket, group edges and i == T included. Then: the padded
and compact queries on the unfused layouts; fused fixedcap and fixedcap2
rows through ``get_ref_pos_padded``,
``get_ref_pos_compact`` and ``OneGraphIndexQuery``; ``TwoPhaseSSHash``;
``bucket_range`` on the shards of ``shard_fused_arrays``; the layouts'
refusals; and C15, the reference's ``TwoPhaseIndexQuery`` dropping its
``pos_kind``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mazu_tpu.index.modindex as mmi
import mazu_tpu.index.twophase as mtp
import mazu_tpu.kphf.sshash as msshash
from mazu_tpu.index.pipeline import OneGraphIndexQuery as MOneGraph
from mazu_tpu.parallel.sharding import shard_fused_arrays

import mazu_tpu_torch.kphf.sshash as psshash
from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index import modindex as pmi, twophase as ptp
from mazu_tpu_torch.index.modindex import QueryIndex
from mazu_tpu_torch.index.pipeline import OneGraphIndexQuery

from torch_fixtures import (
    assert_same, build_capacity_pair, build_mphf_pair, build_parity_pair, capacity_queries,
    same_tree, seq_recipe, tensor, toy_recipe,
)

N = 2048
POS = psshash.POS_KINDS
PREFIX = psshash.PREFIX_KINDS
ENGINES = ("direct4", "direct7", "fast32", "parity")
MOTIF_COPIES = (4, 5, 6, 7, 15)
_PAIRS = {}


def motif_recipe():
    """``seq_recipe``'s 64 references of 300 bases (every 4th unitig on
    three references), with 40-base motifs planted in 4, 5, 6, 7 and 15
    unitigs: each motif's minimizers have that many occurrences."""
    recipe, seqs = seq_recipe(n_refs=64, length=300, seed=5)
    rng = np.random.default_rng(6)
    seqs = [list(s) for s in seqs]
    for m, copies in enumerate(MOTIF_COPIES):
        motif = list(rng.choice(list("ACGT"), 40))
        for u in rng.choice(len(seqs), copies, replace=False):
            seqs[u][55 * m : 55 * m + 40] = motif
    return (["".join(s) for s in seqs], *recipe[1:])


def pair(name):
    """(reference ModIndex, port ModIndex, queries) of an engine, built once."""
    if name not in _PAIRS:
        if name.startswith("direct"):
            ref, port = build_capacity_pair(motif_recipe(), skew=int(name[-1]))
        elif name == "fast32":
            ref, port = build_mphf_pair(toy_recipe())
        else:
            ref, port = build_parity_pair(toy_recipe())
        _PAIRS[name] = ref, port, capacity_queries(ref.k2u.unitigs, N, seed=4)
    return _PAIRS[name]


def layouts(name, pos_kind):
    """The (prefix_kind, reference arrays, port arrays) the reference takes
    for ``pos_kind`` on an engine."""
    ref, port, _ = pair(name)
    out = []
    for prefix_kind in PREFIX:
        want = ref.k2u.device_arrays(prefix_kind=prefix_kind, pos_kind=pos_kind)
        out.append((prefix_kind, want, port.k2u.device_arrays(prefix_kind=prefix_kind,
                                                             pos_kind=pos_kind)))
    return out


def same_arrays(name, got, want):
    """``same_tree``, where the reference's direct build may also carry the
    ``flat`` prefix beside ``flat2`` (it does where its native library does
    not load) and the port's carries ``flat2`` alone."""
    if name.startswith("direct") and "flat2" in want["prefix"]:
        wp, gp = dict(want["prefix"]), got["prefix"]
        assert set(gp) == {"flat2"} and set(wp) <= {"flat", "flat2"}
        np.testing.assert_array_equal(gp["flat2"], wp["flat2"])
        want, got = {**want, "prefix": {}}, {**got, "prefix": {}}
    same_tree(got, want)


@pytest.mark.parametrize("pos_kind", POS)
@pytest.mark.parametrize("name", ENGINES)
def test_device_arrays(name, pos_kind):
    """Every bucket-bounds kind with every position layout, byte for byte;
    the fixedcap layouts only on the direct engine (both packages assert)."""
    ref, port, _ = pair(name)
    if pos_kind.startswith("fixedcap") and not name.startswith("direct"):
        for ss in (ref.k2u, port.k2u):
            with pytest.raises(AssertionError, match="engine='direct'"):
                ss.device_arrays(pos_kind=pos_kind)
        return
    for prefix_kind, want, got in layouts(name, pos_kind):
        same_arrays(name, got, want)
        assert got["meta"].prefix_kind == prefix_kind and got["meta"].pos_kind == pos_kind
    default = port.k2u.device_arrays(pos_kind=pos_kind)
    same_arrays(name, default, ref.k2u.device_arrays(pos_kind=pos_kind))
    if pos_kind.startswith("fixedcap"):
        assert default["meta"].prefix_kind == "none"
        rows = default["pos"]["inline"]
        cap = default["meta"].cap
        assert rows.shape[0] == default["meta"].direct_t * cap
        assert cap == port.k2u.probe_bound() == int(name[-1])
        assert (rows[:, 1] == 0xFFFFFFFE).any(), "no heavy bucket"
        if pos_kind == "fixedcap2":
            # buckets of 4-7 kept occurrences: slot 0's uid has bit 31 set
            assert (rows[:, 1] >> 31)[rows[:, 1] < 0xFFFFFFFE].any()


def _same_k2u(got: dict, want: dict, what: str):
    assert set(got) == set(want), f"{what}: keys {set(got) ^ set(want)}"
    for key in want:
        assert_same(got[key], np.asarray(want[key]), f"{what} {key}")


@pytest.mark.parametrize("name,pos_kind", [
    (name, pos) for name in ENGINES for pos in POS
    if name.startswith("direct") or not pos.startswith("fixedcap")])
def test_k2u(name, pos_kind):
    """``sshash_k2u`` on every layout: full mode from rows 0 and 1, main
    mode at probe limits None, 1 and 2 and with deferred validation."""
    work = pair(name)[2]
    fw = tensor(work)
    runs = [dict(mode="full"), dict(mode="full", probe_start=1)] + [
        dict(mode="main", probe_limit=plim) for plim in (None, 1, 2)] + [
        dict(mode="main", probe_limit=2, defer_valid=True)]
    for prefix_kind, want_d, got_d in layouts(name, pos_kind):
        got_d = arrays_from_numpy(got_d, "cpu")
        for kw in runs:
            want = msshash.sshash_k2u(want_d, work, np, **kw)
            got = psshash.sshash_k2u(got_d, fw, **kw)
            _same_k2u(got, want, f"{prefix_kind} {kw}")
        r = psshash.sshash_k2u(got_d, fw, mode="main", probe_limit=1)
        assert bool((r["mt"] > 0).any()) and bool(r["unresolved"].any())
        if name.startswith("direct"):
            assert bool(r["use_skew"].any())


@pytest.mark.parametrize("name", ["direct4", "direct7"])
def test_grouped32_bounds_everywhere(name):
    """grouped32's ``_prefix_get`` at every i in [0, T] (i == T reads the
    high half of ``gd2[T - 1]``) and ``_prefix_pair`` at every bucket (the
    next group's base where bucket i + 1 starts a group), on a table of
    T >= 2048 buckets whose group edges hold occurrences."""
    ref, port, _ = pair(name)
    want = ref.k2u.device_arrays(prefix_kind="grouped32", pos_kind="packed")
    got = arrays_from_numpy(port.k2u.device_arrays(prefix_kind="grouped32", pos_kind="packed"),
                            "cpu")
    T = got["meta"].direct_t
    assert T >= 2048
    p = port.k2u.occs_prefix_sum
    edges = np.arange(1023, T, 1024)
    assert (p[edges + 1] > p[edges]).any(), "no occupied bucket at a group edge"
    i = np.arange(T + 1, dtype=np.int64)
    assert_same(psshash._prefix_get(got, torch.from_numpy(i)), msshash._prefix_get(want, i, np))
    assert_same(psshash._prefix_get(got, torch.from_numpy(i)), p)
    ps, pe = psshash._prefix_pair(got, torch.from_numpy(i[:-1]))
    wps, wpe = msshash._prefix_pair(want, i[:-1], np)
    assert_same(ps, wps)
    assert_same(pe, wpe)
    assert_same(pe, p[1:])


@pytest.mark.parametrize("name,layout", [
    (name, layout) for name in ("direct4", "fast32") for layout in (
        dict(pos_kind="records"), dict(pos_kind="flat32"), dict(pos_kind="fixedcap"),
        dict(pos_kind="packed", prefix_kind="grouped32"),
        dict(pos_kind="packed", prefix_kind="flat32"), dict(pos_kind="packed", prefix_kind="flat"))
    if name == "direct4" or layout["pos_kind"] != "fixedcap"])
def test_queries_on_unfused_layouts(name, layout):
    """``get_ref_pos_padded`` and ``get_ref_pos_compact`` (probe limit 2,
    with and without deferred validation) on the unfused layouts equal
    the reference's; packed positions with grouped32 or flat32 bounds take
    the plain probe, never K3's layout check."""
    ref, port, work = pair(name)
    want_d = ref.device_arrays(**layout)
    got_d = arrays_from_numpy(port.device_arrays(**layout), "cpu")
    fw = tensor(work)
    mo = max(1, ref.max_occs())
    want = mmi.get_ref_pos_padded(want_d, work, np, mo)
    got = pmi.get_ref_pos_padded(got_d, fw, mo)
    for key in want:
        assert_same(got[key], np.asarray(want[key]), f"padded {key}")
    for dv in (False, True):
        kw = dict(merge=True, m2=N, probe_limit=2, defer_valid=dv)
        want = mmi.get_ref_pos_compact(want_d, work, np, mo, **kw)
        got = pmi.get_ref_pos_compact(got_d, fw, mo, **kw)
        assert set(got) == set(want)
        for key in want:
            assert_same(got[key], np.asarray(want[key]), f"compact dv={dv} {key}")


@pytest.mark.parametrize("kind", ["fixedcap", "fixedcap2"])
@pytest.mark.parametrize("name", ["direct4", "direct7"])
def test_fused_fixedcap(name, kind):
    """Fused fixedcap rows byte for byte (the fusion pass reads the row's
    uid, masked to 29 bits on fixedcap2), then ``get_ref_pos_padded`` and
    ``get_ref_pos_compact`` (merged and not, probe limit 2, the type split
    too) equal to the reference's; fixedcap2's compact output equals
    inline2's (``tests/test_compact.py::test_fixedcap2_matches_inline2``)."""
    ref, port, work = pair(name)
    want_d = ref.device_arrays(fused=True, pos_kind=kind)
    got_h = port.device_arrays(fused=True, pos_kind=kind)
    same_tree(got_h, want_d)
    assert got_h["k2u"]["pos"]["inline"].shape[1] == 14
    got_d = arrays_from_numpy(got_h, "cpu")
    fw = tensor(work)
    mo = max(1, ref.max_occs())
    want = mmi.get_ref_pos_padded(want_d, work, np, mo)
    got = pmi.get_ref_pos_padded(got_d, fw, mo)
    for key in want:
        assert_same(got[key], np.asarray(want[key]), f"padded {key}")
    for kw in (dict(merge=True, m2=N, probe_limit=2),
               dict(merge=True, m2=N, probe_limit=2, m2b=N),
               dict(merge=True, m2=N, probe_limit=None)):
        want = mmi.get_ref_pos_compact(want_d, work, np, mo, **kw)
        got = pmi.get_ref_pos_compact(got_d, fw, mo, **kw)
        assert set(got) == set(want), kw
        for key in want:
            assert_same(got[key], np.asarray(want[key]), f"compact {kw} {key}")
    # unmerged: the main phase whole, the compacted phase on its real slots
    kw = dict(merge=False, m2=N, probe_limit=2)
    want = mmi.get_ref_pos_compact(want_d, work, np, mo, **kw)
    got = pmi.get_ref_pos_compact(got_d, fw, mo, **kw)
    for key in want["main"]:
        assert_same(got["main"][key], np.asarray(want["main"][key]), f"main {key}")
    for key in ("overflow", "n_ovf", "slot_real"):
        assert_same(got[key], np.asarray(want[key]), key)
    real = np.asarray(want["slot_real"])
    assert_same(got["lanes"][real], np.asarray(want["lanes"])[real], "lanes")
    for key, v in want["phase2"].items():
        assert_same(got["phase2"][key][real], np.asarray(v)[real], f"phase2 {key}")
    if kind == "fixedcap2":
        kw = dict(merge=False, m2=N, probe_limit=2)
        a = pmi.get_ref_pos_compact(arrays_from_numpy(port.device_arrays(
            fused=True, pos_kind="inline2"), "cpu"), fw, mo, **kw)
        b = pmi.get_ref_pos_compact(got_d, fw, mo, **kw)
        for key in ("unitig_id", "unitig_len", "pos", "mt", "n_occs", "valid"):
            assert torch.equal(a["main"][key], b["main"][key]), key
        assert torch.equal(a["overflow"], b["overflow"]) and int(a["n_ovf"]) == int(b["n_ovf"])


@pytest.mark.parametrize("kind", ["fixedcap", "fixedcap2"])
def test_one_graph_on_fixedcap(kind):
    """``OneGraphIndexQuery`` on fused fixedcap rows (``bench.py``'s 1graph
    mode with ``MAZU_BENCH_POS``), eager on the CPU: its checksum over two
    chunks equals the sum of the reference's checksums of the chunks."""
    ref, port, work = pair("direct4")
    mo = max(1, ref.max_occs())
    want_d = ref.device_arrays(fused=True, pos_kind=kind)
    qi = QueryIndex(arrays_from_numpy(port.device_arrays(fused=True, pos_kind=kind), "cpu"))
    stack = np.stack([work, np.roll(work, 77)])
    want = sum(int(MOneGraph.checksum(mmi.get_ref_pos_compact(
        want_d, c, np, mo, merge=False, probe_limit=2, m2=1024), np)) for c in stack)
    og = OneGraphIndexQuery(qi, N, n_chunks=2, m2=1024, probe_limit=2)
    got, worst = og.checksum_pass(torch.from_numpy(stack.view(np.int64)))
    assert got == want and worst <= 1024


def test_records_and_fixedcap_refusals():
    """The reference's refusals: fusion of records (no inline rows); 3 uid
    bits of count on fixedcap2 (skew 8 gives a probe bound of 8); fixedcap
    rows with ``bucket_range``; ``bucket_range`` on an MPHF engine."""
    ref, port, work = pair("direct4")
    with pytest.raises(AssertionError, match="fused layout requires an inline row layout"):
        ref.device_arrays(fused=True, pos_kind="records")
    with pytest.raises(ValueError, match="fused layout requires an inline row layout"):
        port.device_arrays(fused=True, pos_kind="records")
    deep_ref, deep = build_capacity_pair(motif_recipe(), skew=8)
    assert deep.k2u.probe_bound() == 8
    for ss in (deep_ref.k2u, deep.k2u):
        with pytest.raises(AssertionError, match="cnt rides in 3 uid bits"):
            ss.device_arrays(pos_kind="fixedcap2")
    same_tree(deep.k2u.device_arrays(pos_kind="fixedcap"),
              deep_ref.k2u.device_arrays(pos_kind="fixedcap"))
    d = arrays_from_numpy(port.k2u.device_arrays(pos_kind="fixedcap", prefix_kind="flat32"), "cpu")
    for pkg, dd, w in ((msshash, ref.k2u.device_arrays(pos_kind="fixedcap",
                                                       prefix_kind="flat32"), work),
                       (psshash, d, tensor(work))):
        with pytest.raises(AssertionError, match="bucket_range requires"):
            pkg.sshash_k2u(dd, w, *([np] if pkg is msshash else []), bucket_range=(0, 64))
    fref, fport, fwork = pair("fast32")
    with pytest.raises(AssertionError, match="engine='direct'"):
        psshash.sshash_k2u(arrays_from_numpy(fport.k2u.device_arrays(), "cpu"), tensor(fwork),
                           bucket_range=(0, 64))


@pytest.mark.parametrize("layout", [{}, dict(pos_kind="fixedcap2"), dict(pos_kind="records")])
@pytest.mark.parametrize("name", ["direct4", "direct7"])
def test_twophase_sshash(name, layout):
    """``TwoPhaseSSHash`` (``bench.py``'s 2phase mode) on the default
    layout: equal to the reference's class (JAX on the CPU) field for
    field, its four K2U fields equal to one full-mode call's. On the other
    layouts, the split it rests on: the main probe flags some lanes
    ``use_skew``, and on every other lane its four K2U fields equal full
    mode's."""
    ref, port, work = pair(name)
    fw = tensor(work)
    if layout:
        d = arrays_from_numpy(port.k2u.device_arrays(**layout), "cpu")
        main, full = psshash.sshash_k2u(d, fw, mode="main"), psshash.sshash_k2u(d, fw)
        light = ~main["use_skew"]
        assert main["use_skew"].any() and light.any()
        for key in ("unitig_id", "unitig_len", "pos", "mt"):
            assert torch.equal(main[key][light], full[key][light]), key
        return
    tp = psshash.TwoPhaseSSHash(port.k2u, device="cpu")
    got = tp.k2u(work)
    full = psshash.sshash_k2u(tp.d, fw)
    for key in ("unitig_id", "unitig_len", "pos", "mt"):
        assert_same(full[key], got[key], key)
    assert tp.main(fw)["use_skew"].any()
    want = msshash.TwoPhaseSSHash(ref.k2u).k2u(work)
    assert set(got) == set(want)
    for key in want:
        assert_same(torch.from_numpy(got[key]), want[key], key)


def _onehot(results: list) -> dict:
    out = {}
    for key in results[0]:
        vs = [torch.as_tensor(np.asarray(r[key])) if not isinstance(r[key], torch.Tensor)
              else r[key] for r in results]
        if vs[0].dtype == torch.bool:
            out[key] = torch.stack(vs).any(dim=0)
        else:
            out[key] = torch.stack([v.to(torch.int64) for v in vs]).sum(dim=0).to(vs[0].dtype)
    return out


@pytest.mark.parametrize("kind", ["inline", "inline2"])
@pytest.mark.parametrize("name", ["direct4", "direct7"])
def test_bucket_range(name, kind):
    """``bucket_range`` on four shards, laid out by ``shard_arrays`` as the
    reference's ``shard_fused_arrays`` lays them out (held byte for byte):
    each shard's main (probe limit 2) and full outputs equal the
    reference's, non-owner lanes are exact zeros, and the one-hot sum over
    the shards equals the unsharded answer."""
    ref, port, work = pair(name)
    n = 4
    shared, stacked = shard_fused_arrays(ref, n, pos_kind=kind)
    fused = port.device_arrays(fused=True, pos_kind=kind)["k2u"]
    shards = psshash.shard_arrays(fused, port.k2u.occs_prefix_sum, n)
    fw = tensor(work)
    whole = {mode: psshash.sshash_k2u(arrays_from_numpy(fused, "cpu"), fw, mode=mode,
                                      probe_limit=2 if mode == "main" else None)
             for mode in ("main", "full")}
    per = {"main": [], "full": []}
    for s, (local, lo, hi) in enumerate(shards):
        assert (lo, hi) == (int(stacked["blo"][s, 0]), int(stacked["bhi"][s, 0]))
        same_tree(local["prefix"]["flat2"], stacked["flat2"][s])
        same_tree(local["pos"]["inline"], stacked["inline"][s])
        want_d = dict(shared["k2u"])
        want_d["prefix"] = {"flat2": stacked["flat2"][s]}
        want_d["pos"] = {"inline": stacked["inline"][s], "meta": shared["pos_meta"]}
        same_tree({kk: v for kk, v in local.items() if kk not in ("prefix", "pos")},
                  shared["k2u"])
        got_d = arrays_from_numpy(local, "cpu")
        for mode in ("main", "full"):
            kw = dict(mode=mode, probe_limit=2 if mode == "main" else None, bucket_range=(lo, hi))
            want = msshash.sshash_k2u(want_d, work, np, **kw)
            got = psshash.sshash_k2u(got_d, fw, **kw)
            _same_k2u(got, want, f"shard {s} {mode}")
            off = ~got["mine"]
            for key, v in got.items():
                if key != "mine":
                    assert not bool(torch.where(off, v.to(torch.int64), 0).any()), key
            per[mode].append(got)
    for mode in ("main", "full"):
        merged = _onehot(per[mode])
        assert bool(merged.pop("mine").all())
        _same_k2u(merged, {kk: v.numpy() for kk, v in whole[mode].items()}, f"one-hot {mode}")


def test_twophase_index_query_fixedcap_and_c15():
    """``TwoPhaseIndexQuery(index, pos_kind=...)`` takes that layout, fused
    by default on fixedcap and fixedcap2; the reference's drops its
    ``pos_kind`` (C15: ``mazu_tpu/index/twophase.py:216``) and keeps its
    default inline rows. Both answer the same."""
    ref, port, work = pair("direct4")
    for kind in ("fixedcap", "fixedcap2"):
        want = mtp.TwoPhaseIndexQuery(ref, probe_limit=2, pos_kind=kind)
        assert want.arrays["k2u"]["meta"].pos_kind == "inline"
        got = ptp.TwoPhaseIndexQuery(port, probe_limit=2, device="cpu", pos_kind=kind)
        assert got.index.arrays()["k2u"]["meta"].pos_kind == kind
        assert got.index.arrays()["k2u"]["pos"]["inline"].shape[1] == 14
        chk, n_ovf = got.checksum_query(tensor(work))
        want_chk, want_ovf = want.checksum_query(jnp.asarray(work), work)
        # fixedcap gives every bucket B occurrences: its misses overflow
        assert chk == want_chk and (n_ovf > want_ovf if kind == "fixedcap" else
                                    n_ovf == want_ovf)
        assert got.get_ref_pos_eager(work) == want.get_ref_pos_eager(work)
    unfused = ptp.TwoPhaseIndexQuery(port, probe_limit=2, device="cpu", pos_kind="records")
    assert unfused.index.arrays()["k2u"]["pos"]["records"].shape[1] == 4
    assert unfused.get_ref_pos_eager(work) == got.get_ref_pos_eager(work)
