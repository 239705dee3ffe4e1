"""The MPHF capacity path of the port against mazu_tpu's, with tolerance 0:
the fast32 SSHash build (BooPHF32 minimizer MPHF, skew MPHF and positions;
with heavy minimizers, with none, and with no skew index) byte for byte,
its last bucket group, ``us_validate_rank`` and the paired ``us_get_kmer``,
``sshash_k2u`` in main mode (probe limits 2 and 3, deferred validation on
and off, MPHF level limit None and 2, with and without ``uproj``) and in
full mode with ``uproj`` on the fast32 and direct layouts, kernel K3's
plain version against the Pallas kernel in interpret mode, the wrapper's
layout checks, ``get_ref_pos_compact`` and ``OneGraphIndexQuery`` with the
MPHF settings, and the synthetic MPHF index against its sampled ground
truth."""

import numpy as np
import pytest
import torch

import mazu_tpu.containers.unitig_set as mus
import mazu_tpu.index.modindex as mmi
import mazu_tpu.kphf.sshash as msshash
from mazu_tpu.index.pipeline import OneGraphIndexQuery as MOneGraph

import mazu_tpu_torch.kphf.sshash as psshash
from mazu_tpu_torch import synth
from mazu_tpu_torch.containers.unitig_set import us_get_kmer, us_validate_rank
from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index import modindex as pmi
from mazu_tpu_torch.index.modindex import QueryIndex
from mazu_tpu_torch.index.pipeline import ROLL_STEP, OneGraphIndexQuery
from mazu_tpu_torch.kmer import mask2k
from mazu_tpu_torch.ops import capacity_probe

from torch_fixtures import (
    assert_same, build_capacity_pair, build_mphf_pair, capacity_queries, mono2_recipe,
    same_tree, tensor, toy_recipe,
)

LAYOUT = dict(prefix_kind="grouped16", pos_kind="packed")
N = 2048
KEYS_UPROJ = ("unitig_id", "unitig_len", "pos", "mt", "use_skew", "unresolved",
              "occ_word", "occ_word2", "occ_cnt", "occ_start")


@pytest.fixture(scope="module")
def toy():
    import __graft_entry__ as g

    return g._toy_index()


BUILDS = {
    # (recipe, skew threshold): heavy minimizers, none, and no skew index
    "toy": ("toy", 8),
    "no_heavy": ("mono2", 8),
    "no_skew_index": ("toy", None),
}


@pytest.fixture(scope="module", params=list(BUILDS))
def build(request, toy):
    recipe, skew = BUILDS[request.param]
    rec = toy_recipe(toy) if recipe == "toy" else mono2_recipe()
    ref, port = build_mphf_pair(rec, skew=skew)
    return request.param, ref, port


@pytest.mark.parametrize("key", ["us", "meta", "pos", "prefix", "mphf", "skew_mphf", "skew_pos"])
def test_fast32_build_arrays(build, key):
    name, ref, port = build
    want = ref.k2u.device_arrays(**LAYOUT)
    got = port.k2u.device_arrays(**LAYOUT)
    assert (key in got) == (key in want)
    if key in want:
        same_tree(got[key], want[key], key)


def test_fast32_build_host_fields(build):
    name, ref, port = build
    np.testing.assert_array_equal(port.k2u.occs_prefix_sum, ref.k2u.occs_prefix_sum)
    assert port.k2u.max_bucket() == ref.k2u.max_bucket()
    assert port.k2u.probe_bound() == ref.k2u.probe_bound()
    assert port.k2u.n_kmers_in_skew_index == ref.k2u.n_kmers_in_skew_index
    if name == "toy":
        assert ref.k2u.n_kmers_in_skew_index > 1
    elif name == "no_heavy":  # the one-key skew table
        assert ref.k2u.n_kmers_in_skew_index == 1 and ref.k2u.max_bucket() <= 8
        np.testing.assert_array_equal(port.k2u.skew_mphf.fh_keys, ref.k2u.skew_mphf.fh_keys)
    else:
        assert port.k2u.skew_mphf is None and ref.k2u.skew_mphf is None


def test_last_group_bounds(build):
    """Bucket T-1's bounds, where T (the minimizer count) is no power of two
    and the last 1024-bucket group is partial."""
    name, ref, port = build
    d = arrays_from_numpy(port.k2u.device_arrays(**LAYOUT), "cpu")
    p = ref.k2u.occs_prefix_sum
    t = len(p) - 1
    assert t & (t - 1), "T is a power of two"
    h = torch.tensor([0, t // 2, t - 1])
    ps, pe = psshash._prefix_pair(d, h)
    np.testing.assert_array_equal(ps.numpy(), p[h.numpy()])
    np.testing.assert_array_equal(pe.numpy(), p[h.numpy() + 1])


def test_us_validate_rank_and_get_kmer(toy):
    from mazu_tpu_torch.containers.unitig_set import UnitigSet

    seqs, k, _, _ = toy_recipe(toy)
    ref = mus.UnitigSet.from_seqs(seqs, k)
    host = ref.device_arrays(paired=True)
    us = arrays_from_numpy(UnitigSet.from_seqs(seqs, k).device_arrays(paired=True), "cpu")
    same_tree(us, host)
    rng = np.random.default_rng(3)
    last = ref.total_len - k
    pos = np.concatenate([rng.integers(0, last + 1, 4000), np.arange(64),
                          last - np.arange(64), [-5, -1, last + 1, last + 40]])
    pos = np.concatenate([pos, (ref.accum[1:-1, None] - np.arange(1, k)).ravel()])
    want = mus.us_validate_rank(host, pos, np)
    got = us_validate_rank(us, torch.from_numpy(pos))
    assert_same(got[0], want[0], "valid")
    assert_same(got[1], want[1], "uid")
    assert not bool(got[0].all()) and bool(got[0].any())
    inr = np.clip(pos, 0, last)
    assert_same(us_get_kmer(us, torch.from_numpy(inr)), mus.us_get_kmer(host, inr, np), "kmer")


@pytest.fixture(scope="module", params=["fast32", "direct"])
def lay(request, toy):
    """(name, reference arrays with uproj, port arrays with uproj, queries):
    the toy recipe's fast32 or direct SSHash on the grouped16 + packed +
    paired layout. The queries mix indexed k-mers (half reverse-
    complemented), foreign words (bit 63 set on some), boundary-crossing
    k-mers and the all-T word."""
    rec = toy_recipe(toy)
    ref, port = (build_mphf_pair if request.param == "fast32" else build_capacity_pair)(rec)
    want = ref.device_arrays(uproj=True, **LAYOUT)["k2u"]
    got = arrays_from_numpy(port.device_arrays(uproj=True, **LAYOUT)["k2u"], "cpu")
    us = ref.k2u.unitigs
    work = np.concatenate([capacity_queries(us, 2600, seed=3),
                           synth.sample_boundary_queries(us, 400, seed=4),
                           np.array([mask2k(us.k)], np.uint64)])
    return request.param, want, got, work


def _strip(d: dict, uproj: bool) -> dict:
    return d if uproj else {**d, "us": {kk: v for kk, v in d["us"].items() if kk != "uproj"}}


MAIN = [dict(probe_limit=p, defer_valid=dv, mphf_level_limit=ml)
        for p in (2, 3) for dv in (False, True) for ml in (None, 2)]


@pytest.mark.parametrize("uproj", [True, False], ids=["uproj", "extent"])
@pytest.mark.parametrize("kw", MAIN, ids=[f"p{k['probe_limit']}_dv{int(k['defer_valid'])}_ml"
                                          f"{k['mphf_level_limit']}" for k in MAIN])
def test_sshash_k2u_main(lay, kw, uproj):
    name, want_d, got_d, work = lay
    want = msshash.sshash_k2u(_strip(want_d, uproj), work, np, mode="main", **kw)
    got = psshash.sshash_k2u(_strip(got_d, uproj), tensor(work), mode="main", **kw)
    assert set(got) == set(want)
    for key in want:
        assert_same(got[key], want[key], key)
    assert np.asarray(want["use_skew"]).any() and np.asarray(want["unresolved"]).any()
    assert (np.asarray(want["mt"]) > 0).any()


@pytest.mark.parametrize("probe_start", [0, 2])
def test_sshash_k2u_full_uproj(lay, probe_start):
    name, want_d, got_d, work = lay
    want = msshash.sshash_k2u(want_d, work, np, probe_start=probe_start)
    got = psshash.sshash_k2u(got_d, tensor(work), probe_start=probe_start)
    assert set(got) == set(want) == set(KEYS_UPROJ) - {"use_skew", "unresolved"}
    for key in want:
        assert_same(got[key], want[key], key)


def test_deferred_validation_fails_boundary_winners(lay):
    """Boundary-crossing k-mers spell the query in the useq: with deferred
    validation some winners fail and their lanes are left unresolved."""
    name, _, got_d, work = lay
    fw = tensor(work)
    on = psshash.sshash_k2u(got_d, fw, mode="main", probe_limit=2, defer_valid=True)
    off = psshash.sshash_k2u(got_d, fw, mode="main", probe_limit=2)
    failed = on["unresolved"] & ~off["unresolved"]
    assert bool(failed.any()) and bool((on["mt"][failed] == 0).all())
    assert bool(torch.equal(on["mt"][~failed], off["mt"][~failed]))


K3 = [(p, ml) for p in (1, 2, 3) for ml in (None, 2, 4)]


@pytest.mark.parametrize("plim,mlim", K3, ids=[f"p{p}_ml{m}" for p, m in K3])
def test_k3_plain_matches_pallas_interpret(lay, plim, mlim):
    """K3's plain version (the wrapper on CPU tensors) against the Pallas
    kernel run by the TPU interpreter, on all ten fields."""
    import jax.numpy as jnp

    from mazu_tpu.ops.pallas_capacity import pallas_capacity_k2u

    name, want_d, got_d, work = lay
    want = pallas_capacity_k2u(want_d, jnp.asarray(work), plim, interpret=True,
                               mphf_level_limit=mlim)
    got = capacity_probe.capacity_k2u(got_d, tensor(work), plim, mphf_level_limit=mlim)
    assert set(got) == set(KEYS_UPROJ)
    for key in KEYS_UPROJ:
        g, w = got[key].numpy(), np.asarray(want[key])
        if w.dtype == np.uint64:
            g = g.view(np.uint64)
        np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=key)
    assert got["use_skew"].any() and got["unresolved"].any() and (got["mt"] > 0).any()


def test_k3_plain_matches_pallas_interpret_extent(lay):
    """Without uproj records the tail maps the winner by its extent."""
    import jax.numpy as jnp

    from mazu_tpu.ops.pallas_capacity import pallas_capacity_k2u

    name, want_d, got_d, work = lay
    want = pallas_capacity_k2u(_strip(want_d, False), jnp.asarray(work), 3, interpret=True)
    got = capacity_probe.capacity_k2u(_strip(got_d, False), tensor(work), 3)
    assert set(got) == set(KEYS_UPROJ[:6])
    for key in got:
        np.testing.assert_array_equal(got[key].numpy().astype(np.asarray(want[key]).dtype),
                                      np.asarray(want[key]), err_msg=key)


def test_k3_wrapper_checks_layout(lay):
    name, _, got_d, work = lay
    d, fw = got_d, tensor(work)
    s = capacity_probe.check_layout(d, fw, 2, mphf_level_limit=4)
    assert s["bound"] == min(2, d["meta"].probe_bound) and s["n_up"] == d["us"]["uproj"].shape[0]
    if name == "fast32":
        assert s["n_test"] == 4 and not s["full_chain"] and s["tmask"] == 0
        assert capacity_probe.check_layout(d, fw, 2)["full_chain"] == 1
        with pytest.raises(ValueError, match="lean BooPHF32"):
            capacity_probe.check_layout({**d, "mphf": {**d["mphf"], "mrows": d["mphf"]["words"]}},
                                        fw, 2)
    # a unitig set of 2^31 bases or more is the tier's purpose: taken
    big = {**d, "us": {**d["us"], "meta": d["us"]["meta"].replace(total_len=1 << 33)}}
    assert capacity_probe.check_layout(big, fw, 2)["last_km"] == (1 << 33) - d["meta"].k
    with pytest.raises(ValueError, match="useqrec"):
        capacity_probe.check_layout({**d, "us": {**d["us"], "useqrec": d["us"]["uproj"]}}, fw, 2)
    with pytest.raises(ValueError, match="paired"):
        us = {**d["us"], "useq": {kk: v for kk, v in d["us"]["useq"].items() if kk != "words2"}}
        capacity_probe.check_layout({**d, "us": us}, fw, 2)
    with pytest.raises(ValueError, match="gdelta"):
        pre = {**d["prefix"], "gdelta": d["prefix"]["gdelta"].to(torch.int32)}
        capacity_probe.check_layout({**d, "prefix": pre}, fw, 2)
    with pytest.raises(ValueError, match="probe_limit"):
        capacity_probe.check_layout(d, fw, 0)
    with pytest.raises(ValueError, match="no capacity probe"):
        capacity_probe.capacity_k2u(d, fw.to("meta"), 2)


@pytest.fixture(scope="module")
def case(toy):
    ref, port = build_mphf_pair(toy_recipe(toy))
    host = ref.device_arrays(uproj=True, **LAYOUT)
    d = arrays_from_numpy(port.device_arrays(uproj=True, **LAYOUT), "cpu")
    us = ref.k2u.unitigs
    work = np.concatenate([capacity_queries(us, N - 256, seed=9),
                           synth.sample_boundary_queries(us, 256, seed=10)])
    return ref, port, host, d, work


def test_mphf_device_arrays(case):
    ref, port, host, d, _ = case
    same_tree(d, host)


SETTINGS = {
    "p2_ml4_mid4": dict(probe_limit=2, m2b=N, defer_valid=True, mphf_level_limit=4,
                        probe_limit2=4, m2c=N),
    "p2_ml2_mid4": dict(probe_limit=2, m2b=N, defer_valid=True, mphf_level_limit=2,
                        probe_limit2=4, m2c=N),
    "p3_ml2_split": dict(probe_limit=3, m2b=N, defer_valid=True, mphf_level_limit=2),
    "p2_ml4": dict(probe_limit=2, defer_valid=True, mphf_level_limit=4),
}
MERGED = ("unitig_id", "unitig_len", "pos", "mt", "n_occs", "valid")
PROJECTED = ("ref_id", "ref_pos", "orient")


@pytest.mark.parametrize("name", list(SETTINGS))
def test_compact_merged(case, monkeypatch, name):
    ref, port, host, d, work = case
    kw = SETTINGS[name]
    calls = []
    monkeypatch.setattr(pmi, "capacity_k2u",
                        lambda *a, **k: calls.append(k) or capacity_probe.capacity_k2u(*a, **k))
    mo = max(1, ref.max_occs())
    want = mmi.get_ref_pos_compact(host, work, np, mo, merge=True, m2=N, **kw)
    got = pmi.get_ref_pos_compact(d, tensor(work), QueryIndex(d).max_occs, merge=True, m2=N, **kw)
    assert calls == [dict(mphf_level_limit=kw["mphf_level_limit"])], "the main probe is not K3's"
    assert not bool(want["over_budget"]) and not bool(got["over_budget"])
    for key in MERGED:
        assert_same(got[key], want[key], key)
    v = np.asarray(want["valid"])
    for key in PROJECTED:
        assert_same(torch.where(got["valid"], got[key], 0), np.where(v, want[key], 0), key)
    padded = pmi.get_ref_pos_padded(d, tensor(work), mo)
    for key in ("unitig_id", "pos", "mt", "n_occs"):
        assert torch.equal(got[key], padded[key]), key


@pytest.mark.parametrize("name", ["p2_ml4_mid4", "p3_ml2_split"])
def test_compact_pieces(case, name):
    """merge=False: every piece equals the reference's on its real slots."""
    ref, port, host, d, work = case
    kw = SETTINGS[name]
    mo = max(1, ref.max_occs())
    want = mmi.get_ref_pos_compact(host, work, np, mo, merge=False, m2=N, **kw)
    got = pmi.get_ref_pos_compact(d, tensor(work), mo, merge=False, m2=N, **kw)
    assert set(got) == set(want)
    for key in want["main"]:
        assert_same(got["main"][key], want["main"][key], f"main/{key}")
    for key in ("overflow", "n_ovf", "n_ovf_b", "over_budget") + (
            ("over_budget_c",) if "probe_limit2" in kw else ()):
        assert_same(got[key], want[key], key)
    for pk, lk, sk in (("phase2", "lanes", "slot_real"), ("phase2b", "lanes_b", "slot_real_b")):
        real = np.asarray(want[sk])
        assert_same(got[sk], real, sk)
        assert real.any(), f"{pk} has no real slots"
        np.testing.assert_array_equal(got[lk].numpy()[real], np.asarray(want[lk])[real])
        assert set(got[pk]) == set(want[pk])
        for key in want[pk]:
            np.testing.assert_array_equal(got[pk][key].numpy()[real], np.asarray(want[pk][key])[real],
                                          err_msg=f"{pk}/{key}")
    got_k2u = pmi.merge_compact_k2u(got)
    want_k2u = mmi.merge_compact_k2u(want, np)
    for key in want_k2u:
        assert_same(got_k2u[key], want_k2u[key], key)


def test_main_projection_needs_records(case):
    ref, port, host, d, work = case
    bare = {**d, "k2u": _strip(d["k2u"], False)}
    with pytest.raises(ValueError, match="_project_offsets"):
        pmi.get_ref_pos_compact(bare, tensor(work), 3, probe_limit=2, defer_valid=True)


def test_onegraph_checksum(case):
    ref, port, host, d, work = case
    kw = SETTINGS["p2_ml4_mid4"]
    CH = 3
    want_og = MOneGraph(ref, N, n_chunks=CH, m2=N, host_arrays=host, **kw)
    want = want_og.checksum_host(np.stack([np.roll(work, i * ROLL_STEP) for i in range(CH)]))
    og = OneGraphIndexQuery(QueryIndex(d), N, n_chunks=CH, m2=N, **kw)
    got, worst = og.checksum_pass_rolled(tensor(work))
    assert got == want
    one = pmi.get_ref_pos_compact(d, tensor(work), og.max_occs, merge=False, m2=N, **kw)
    assert worst == (int(one["n_ovf"]), int(one["n_ovf_b"]))


@pytest.fixture(scope="module")
def synth_case():
    index = synth.build_mphf_index(60 * synth.PIECE, seed=0, heavy_sites=512, device="cpu")
    host = index.device_arrays(**synth.MPHF_LAYOUT)
    return index, QueryIndex(arrays_from_numpy(host, "cpu"))


def test_synth_mphf_index(synth_case):
    index, qi = synth_case
    d = qi.arrays()["k2u"]
    m = d["meta"]
    assert m.direct_t == 0 and m.w == synth.MPHF_W and m.skew_param == synth.CAP_SKEW
    assert m.probe_bound == synth.CAP_SKEW and index.k2u.n_kmers_in_skew_index > 1
    assert len(d["mphf"]["meta"].n_bits) > 4 and "uproj" in d["us"] and qi.max_occs == 3


def test_synth_mphf_path_hits_ground_truth(synth_case):
    """The MPHF path on the synthetic index: every sampled lane is hit at
    its sampled unitig and offset, through all compacted phases."""
    index, qi = synth_case
    words, uid, upos = synth.sample_capacity_queries(index.k2u.unitigs, 4096, seed=1)
    kw = dict(synth.MPHF_QUERY, m2=4096, m2b=4096, m2c=4096)
    out = pmi.get_ref_pos_compact(qi.arrays(), tensor(words), qi.max_occs, merge=False, **kw)
    assert not bool(out["over_budget"])
    assert int(out["n_ovf"]) > 0 and int(out["n_ovf_b"]) > 0
    merged = pmi.merge_compact_k2u(out)
    assert bool((merged["mt"] > 0).all())
    np.testing.assert_array_equal(merged["unitig_id"].numpy(), uid)
    np.testing.assert_array_equal(merged["pos"].numpy(), upos)
