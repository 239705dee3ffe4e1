"""The capacity path of the port against mazu_tpu's, with tolerance 0: the
window records and projection records (``build_useqrec``, ``build_uproj``),
``ModIndex.device_arrays`` with the capacity layout, ``get_ref_pos_compact``
with the capacity settings (bpos + useqrec main phase, type-split heavy
phase, middle phase; merged, and as pieces compared on their real slots),
``merge_compact_k2u``, the ``OneGraphIndexQuery`` checksum against the
reference's ``checksum_host``, the capacity checks that raise, and the
synthetic capacity index of ``synth`` end to end against its sampled
ground truth."""

import numpy as np
import pytest
import torch

import mazu_tpu.index.modindex as mmi
from mazu_tpu.index.pipeline import OneGraphIndexQuery as MOneGraph

from mazu_tpu_torch import synth
from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index import modindex as pmi
from mazu_tpu_torch.index.modindex import QueryIndex
from mazu_tpu_torch.index.pipeline import ROLL_STEP, OneGraphIndexQuery

from torch_fixtures import assert_same, build_capacity_pair, capacity_queries, same_tree, tensor, toy_recipe

LAYOUT = dict(prefix_kind="grouped16", pos_kind="packed", bucket_inline=True, useqrec=True)
N = 2048
MERGED = ("unitig_id", "unitig_len", "pos", "mt", "n_occs", "valid")
PROJECTED = ("ref_id", "ref_pos", "orient")


@pytest.fixture(scope="module")
def case():
    import __graft_entry__ as g

    ref, port = build_capacity_pair(toy_recipe(g._toy_index()))
    host = ref.device_arrays(**LAYOUT)
    d = arrays_from_numpy(port.device_arrays(**LAYOUT), "cpu")
    work = capacity_queries(ref.k2u.unitigs, N, seed=9)
    return ref, port, host, d, work


def test_projection_records(case):
    ref, port, *_ = case
    np.testing.assert_array_equal(pmi.build_uproj(port.u2pos, port.k2u.unitigs),
                                  mmi.build_uproj(ref.u2pos, ref.k2u.unitigs))
    rec = pmi.build_useqrec(port.u2pos, port.k2u.unitigs)
    assert rec.tobytes() == mmi.build_useqrec(ref.u2pos, ref.k2u.unitigs).tobytes()


@pytest.mark.parametrize("part", ["k2u", "u2pos", "refs", "meta"])
def test_capacity_device_arrays(case, part):
    ref, port, host, _, _ = case
    same_tree(port.device_arrays(**LAYOUT)[part], host[part], part)


SETTINGS = {
    "p2_mid4": dict(probe_limit=2, m2b=N, defer_valid=True, probe_limit2=4, m2c=N),
    "p1_mid4": dict(probe_limit=1, m2b=N, defer_valid=True, probe_limit2=4, m2c=N),
    "p3_mid6": dict(probe_limit=3, m2b=N, probe_limit2=6, m2c=N),
    "p2_split": dict(probe_limit=2, m2b=N),
    "p2": dict(probe_limit=2),
}


@pytest.mark.parametrize("name", list(SETTINGS))
def test_compact_merged(case, name):
    ref, port, host, d, work = case
    kw = SETTINGS[name]
    mo = max(1, ref.max_occs())
    want = mmi.get_ref_pos_compact(host, work, np, mo, merge=True, m2=N, **kw)
    got = pmi.get_ref_pos_compact(d, tensor(work), QueryIndex(d).max_occs, merge=True, m2=N, **kw)
    assert not bool(want["over_budget"]) and not bool(got["over_budget"])
    for key in MERGED:
        assert_same(got[key], want[key], key)
    v = np.asarray(want["valid"])
    for key in PROJECTED:
        assert_same(torch.where(got["valid"], got[key], 0), np.where(v, want[key], 0), key)
    # and it equals the exact padded query
    padded = pmi.get_ref_pos_padded(d, tensor(work), mo)
    for key in ("unitig_id", "pos", "mt", "n_occs"):
        assert torch.equal(got[key], padded[key]), key


@pytest.mark.parametrize("name", ["p2_mid4", "p2_split"])
def test_compact_pieces(case, name):
    """merge=False: every piece equals the reference's on its real slots
    (fake-slot contents are unspecified in both packages)."""
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


def test_onegraph_checksum(case):
    ref, port, host, d, work = case
    kw = SETTINGS["p2_mid4"]
    CH = 3
    want_og = MOneGraph(ref, N, n_chunks=CH, m2=N, host_arrays=host, **kw)
    want = want_og.checksum_host(np.stack([np.roll(work, i * ROLL_STEP) for i in range(CH)]))
    og = OneGraphIndexQuery(QueryIndex(d), N, n_chunks=CH, m2=N, **kw)
    got, worst = og.checksum_pass_rolled(tensor(work))
    assert got == want
    one = pmi.get_ref_pos_compact(d, tensor(work), og.max_occs, merge=False, m2=N, **kw)
    assert worst == (int(one["n_ovf"]), int(one["n_ovf_b"]))
    assert got == CH * og.checksum_host(QueryIndex(d), tensor(work)[None])


def test_onegraph_m2c_exceeded_raises(case):
    ref, port, host, d, work = case
    kw = dict(SETTINGS["p2_mid4"], m2c=1)
    want = mmi.get_ref_pos_compact(host, work, np, max(1, ref.max_occs()), merge=False, m2=N, **kw)
    assert bool(want["over_budget_c"]), "fixture residue fits one lane"
    og = OneGraphIndexQuery(QueryIndex(d), N, n_chunks=2, m2=N, **kw)
    with pytest.raises(RuntimeError, match="m2c"):
        og.checksum_pass_rolled(tensor(work))


def test_onegraph_m2b_exceeded_raises(case):
    ref, port, host, d, work = case
    kw = dict(SETTINGS["p2_mid4"], m2b=4)
    og = OneGraphIndexQuery(QueryIndex(d), N, n_chunks=2, m2=N, **kw)
    with pytest.raises(RuntimeError, match="capacity"):
        og.checksum_pass_rolled(tensor(work))


@pytest.fixture(scope="module")
def synth_case():
    index = synth.build_capacity_index(60 * synth.PIECE, seed=0, heavy_sites=512,
                                       device="cpu")
    host = index.device_arrays(**synth.CAPACITY_LAYOUT)
    return index, QueryIndex(arrays_from_numpy(host, "cpu"))


def test_synth_capacity_index(synth_case):
    index, qi = synth_case
    m = qi.arrays()["k2u"]["meta"]
    assert m.skew_kind == "cuckoo" and index.k2u.n_kmers_in_skew_index > 0
    assert m.probe_bound == synth.CAP_SKEW and m.w == synth.CAP_W
    assert qi.max_occs == 3


def test_synth_capacity_path_hits_ground_truth(synth_case):
    """The capacity path on the synthetic index: every sampled lane is hit
    at its sampled unitig and offset, through all compacted phases."""
    index, qi = synth_case
    words, uid, upos = synth.sample_capacity_queries(index.k2u.unitigs, 4096, seed=1)
    kw = dict(probe_limit=2, m2=4096, m2b=4096, defer_valid=True, probe_limit2=4, m2c=4096)
    out = pmi.get_ref_pos_compact(qi.arrays(), tensor(words), qi.max_occs, merge=False, **kw)
    assert not bool(out["over_budget"])
    assert int(out["n_ovf"]) > 0 and int(out["n_ovf_b"]) > 0
    assert bool(out["main"]["mt"].eq(0).logical_and(~out["overflow"]).logical_not().all())
    merged = pmi.merge_compact_k2u(out)
    assert bool((merged["mt"] > 0).all())
    np.testing.assert_array_equal(merged["unitig_id"].numpy(), uid)
    np.testing.assert_array_equal(merged["pos"].numpy(), upos)
