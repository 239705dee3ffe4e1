"""The two-phase layer of the port against mazu_tpu's, with tolerance 0:
``_main_phase`` and ``_project_offsets`` on the mono2 KCDict, the direct
SSHash with and without window records and the fast32 SSHash with and
without ``uproj`` records; ``get_ref_pos_compact`` on a direct SSHash
without records (the main projection through the offsets table);
``TwoPhaseIndexQuery``'s ``query``, ``checksum_query``,
``get_ref_pos_eager`` and ``get_ref_pos_batch`` against the reference
class (jitted on the CPU) on the mono2 index and on the capacity layouts;
and ``BatchHits``."""

import jax
import numpy as np
import pytest
import torch

import mazu_tpu.index.modindex as mmi
import mazu_tpu.index.twophase as mtp
import mazu_tpu.kphf.sshash as msshash
from mazu_tpu.index.mapping import BatchHits as MBatchHits

from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index import modindex as pmi, twophase as ptp
from mazu_tpu_torch.index.mapping import BatchHits
from mazu_tpu_torch.index.modindex import QueryIndex
from mazu_tpu_torch.kphf import sshash as psshash

from torch_fixtures import (
    assert_same, build_capacity_pair, build_mphf_pair, build_pair, capacity_queries, queries,
    tensor, toy_recipe,
)

N = 1024
PACKED = dict(prefix_kind="grouped16", pos_kind="packed")
LAYOUTS = {  # name: (pair builder, device_arrays keywords)
    "mono2": (build_pair, {}),
    "direct_records": (build_capacity_pair, dict(PACKED, bucket_inline=True, useqrec=True)),
    "direct_bare": (build_capacity_pair, PACKED),
    "fast32_uproj": (build_mphf_pair, dict(PACKED, uproj=True)),
    "fast32_bare": (build_mphf_pair, PACKED),
}


@pytest.fixture(scope="module")
def toy():
    import __graft_entry__ as g

    return g._toy_index()


@pytest.fixture(scope="module", params=list(LAYOUTS))
def case(request, toy):
    build, layout = LAYOUTS[request.param]
    ref, port = build(toy_recipe(toy))
    host = ref.device_arrays(**layout) if layout else ref.device_arrays(fused=True)
    d = arrays_from_numpy(port.device_arrays(**layout), "cpu")
    us = ref.k2u.unitigs
    work = queries(us, N, seed=3) if build is build_pair else capacity_queries(us, N, seed=3)
    return request.param, ref, port, host, d, work


def _same(got: dict, want: dict, what: str = ""):
    assert set(got) == set(want), f"{what}: {sorted(got)} != {sorted(want)}"
    for key in want:
        g = got[key]
        assert_same(torch.from_numpy(g) if isinstance(g, np.ndarray) else g, want[key],
                    f"{what}{key}")


@pytest.mark.parametrize("probe_limit", [1, 2, 3])
def test_main_phase(case, probe_limit):
    name, ref, port, host, d, work = case
    want = mtp._main_phase(host, work, np, 2, probe_limit)
    got = ptp._main_phase(d, tensor(work), 2, probe_limit)
    _same(got, want)
    ov = np.asarray(want["overflow"])
    assert ov.any() and not ov.all(), name


@pytest.mark.parametrize("small_occs", [1, 2, 3])
def test_project_offsets(case, small_occs):
    """``_project_offsets`` on the same main probe results: every layout
    gives the unitig, so the offsets table serves each of them."""
    name, ref, port, host, d, work = case
    if name == "mono2":
        from mazu_tpu.kphf.kcdict import kcdict_k2u as mk2u
        from mazu_tpu_torch.kphf.kcdict import kcdict_k2u as pk2u

        r_ref = mk2u(host["k2u"], work, np, mode="main")
        r_port = pk2u(d["k2u"], tensor(work), "main")
    else:
        r_ref = msshash.sshash_k2u(host["k2u"], work, np, mode="main", probe_limit=2)
        r_port = psshash.sshash_k2u(d["k2u"], tensor(work), mode="main", probe_limit=2)
    want = mtp._project_offsets(host, r_ref, np, small_occs)
    got = ptp._project_offsets(d, r_port, small_occs)
    _same(got, want)
    assert np.asarray(want["valid"]).any()


COMPACT = {
    "p2": dict(probe_limit=2),
    "p2_defer": dict(probe_limit=2, defer_valid=True),
    "p2_split": dict(probe_limit=2, m2b=N),
    "p2_mid4": dict(probe_limit=2, m2b=N, defer_valid=True, probe_limit2=4, m2c=N),
}


@pytest.mark.parametrize("name", list(COMPACT))
def test_compact_direct_without_records(toy, name):
    """``get_ref_pos_compact`` on a direct SSHash without ``uproj`` or
    ``useqrec`` records (it raised before ``_project_offsets``), merged
    and in pieces."""
    ref, port = build_capacity_pair(toy_recipe(toy))
    host = ref.device_arrays(**PACKED)
    d = arrays_from_numpy(port.device_arrays(**PACKED), "cpu")
    work = capacity_queries(ref.k2u.unitigs, N, seed=4)
    kw = COMPACT[name]
    mo = max(1, ref.max_occs())
    want = mmi.get_ref_pos_compact(host, work, np, mo, merge=True, m2=N, **kw)
    got = pmi.get_ref_pos_compact(d, tensor(work), mo, merge=True, m2=N, **kw)
    assert not bool(want["over_budget"]) and not bool(got["over_budget"])
    v = np.asarray(want["valid"])
    for key in ("unitig_id", "unitig_len", "pos", "mt", "n_occs", "valid"):
        assert_same(got[key], want[key], key)
    for key in ("ref_id", "ref_pos", "orient"):
        assert_same(torch.where(got["valid"], got[key], 0), np.where(v, want[key], 0), key)
    pieces_w = mmi.get_ref_pos_compact(host, work, np, mo, merge=False, m2=N, **kw)
    pieces_g = pmi.get_ref_pos_compact(d, tensor(work), mo, merge=False, m2=N, **kw)
    _same(pieces_g["main"], pieces_w["main"], "main/")
    assert_same(pieces_g["overflow"], pieces_w["overflow"], "overflow")


def test_compact_unsplit_reprobes_from_row0(toy):
    """Without the type split, the heavy phase holds lanes that the main
    probe found (unitigs with more than two occurrences) beside lanes it
    left unsettled, so it re-probes from row 0. The port once passed
    ``probe_start`` there and missed the found lanes' rows."""
    ref, port = build_mphf_pair(toy_recipe(toy))
    layout = LAYOUTS["fast32_uproj"][1]
    host = ref.device_arrays(**layout)
    d = arrays_from_numpy(port.device_arrays(**layout), "cpu")
    work = capacity_queries(ref.k2u.unitigs, N, seed=4)
    mo = max(1, ref.max_occs())
    want = mmi.get_ref_pos_compact(host, work, np, mo, merge=True, m2=N, probe_limit=2)
    got = pmi.get_ref_pos_compact(d, tensor(work), mo, merge=True, m2=N, probe_limit=2)
    padded = pmi.get_ref_pos_padded(d, tensor(work), mo)
    for key in ("unitig_id", "unitig_len", "pos", "mt", "n_occs", "valid"):
        assert_same(got[key], want[key], key)
        assert torch.equal(got[key], padded[key]), key
    assert (np.asarray(want["n_occs"]) == 3).any()


# ------------------------------------------------------- TwoPhaseIndexQuery


@pytest.fixture(scope="module", params=["mono2", "direct_records", "direct_bare"])
def twophase(request, toy):
    """(name, reference TwoPhaseIndexQuery, port TwoPhaseIndexQuery, work):
    the reference class over the same arrays as the port's (its own
    default SSHash layout is the inline rows that the port lacks)."""
    build, layout = LAYOUTS[request.param]
    ref, port = build(toy_recipe(toy))
    want_tp = mtp.TwoPhaseIndexQuery(ref, probe_limit=2, fused=False)
    if layout:
        want_tp.arrays = jax.device_put(ref.device_arrays(**layout))
        got_tp = ptp.TwoPhaseIndexQuery(port, probe_limit=2, device="cpu", fused=False, **layout)
    else:
        got_tp = ptp.TwoPhaseIndexQuery(port, probe_limit=2, device="cpu")
    us = ref.k2u.unitigs
    work = queries(us, N, seed=6) if build is build_pair else capacity_queries(us, N, seed=6)
    return request.param, ref, want_tp, got_tp, work


def test_twophase_query(twophase):
    name, ref, want_tp, got_tp, work = twophase
    r_w, lanes_w, s_w = want_tp.query(work)
    r_g, lanes_g, s_g = got_tp.query(work)
    _same(r_g, r_w, "main/")
    np.testing.assert_array_equal(lanes_g, lanes_w)
    assert lanes_w.dtype == lanes_g.dtype and len(lanes_w) > 0
    _same(s_g, s_w, "overflow/")


def test_twophase_checksum_query(twophase):
    name, ref, want_tp, got_tp, work = twophase
    want = want_tp.checksum_query(jax.numpy.asarray(work), work)
    got = got_tp.checksum_query(tensor(work), work)
    assert got == want and want[1] > 0


def test_twophase_eager_lists(twophase):
    name, ref, want_tp, got_tp, work = twophase
    got = got_tp.get_ref_pos_eager(work)
    assert got == want_tp.get_ref_pos_eager(work)
    assert got == ref.get_ref_pos_eager(work)  # the exact one-phase answer
    assert any(h is None for h in got) and any(h is not None and len(h) == 3 for h in got)


def test_twophase_batch_hits(twophase):
    name, ref, want_tp, got_tp, work = twophase
    want = want_tp.get_ref_pos_batch(work)
    got = got_tp.get_ref_pos_batch(work)
    assert isinstance(got, BatchHits) and len(got) == len(want)
    for field in ("mt", "offsets", "ref_id", "ref_pos", "orient"):
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert g.dtype.itemsize == w.dtype.itemsize, field
        np.testing.assert_array_equal(g.view(w.dtype) if g.dtype != w.dtype else g, w, field)
    assert got.to_lists() == want.to_lists() == got_tp.get_ref_pos_eager(work)


def test_twophase_takes_a_query_index(toy):
    """A QueryIndex is queried where it lies; fused=True on an SSHash and
    an SSHash ModIndex by default (fused, as the reference) raise by name."""
    ref, port = build_capacity_pair(toy_recipe(toy))
    layout = LAYOUTS["direct_records"][1]
    qi = QueryIndex(arrays_from_numpy(port.device_arrays(**layout), "cpu"))
    work = capacity_queries(ref.k2u.unitigs, 256, seed=2)
    a = ptp.TwoPhaseIndexQuery(qi, probe_limit=2).get_ref_pos_eager(work)
    b = ptp.TwoPhaseIndexQuery(port, probe_limit=2, device="cpu", fused=False,
                               **layout).get_ref_pos_eager(work)
    assert a == b
    with pytest.raises(ValueError, match="inline row layout"):
        ptp.TwoPhaseIndexQuery(port, device="cpu", **layout)
    with pytest.raises(ValueError, match="inline row layout"):
        ptp.TwoPhaseIndexQuery(qi, fused=True)
    with pytest.raises(ValueError, match="layout and device"):
        ptp.TwoPhaseIndexQuery(qi, device="cpu")


# ---------------------------------------------------------------- BatchHits


def test_batch_hits_from_padded_and_concat(toy):
    ref, port = build_pair(toy_recipe(toy))
    d = arrays_from_numpy(port.device_arrays(), "cpu")
    host = ref.device_arrays(fused=True)
    parts_w, parts_g = [], []
    for seed in (1, 2, 3):
        work = queries(ref.k2u.unitigs, 300, seed=seed)
        out_w = mmi.get_ref_pos_padded(host, work, np, ref.max_occs())
        out_g = pmi.get_ref_pos_padded(d, tensor(work), ref.max_occs())
        parts_w.append(MBatchHits.from_padded(out_w))
        parts_g.append(BatchHits.from_padded({kk: v.numpy() for kk, v in out_g.items()}))
    for got, want in ((parts_g[0], parts_w[0]),
                      (BatchHits.concat(parts_g), MBatchHits.concat(parts_w))):
        for field in ("mt", "offsets", "ref_id", "ref_pos", "orient"):
            g, w = getattr(got, field), np.asarray(getattr(want, field))
            np.testing.assert_array_equal(g.view(w.dtype) if g.dtype != w.dtype else g, w, field)
        assert got.lane_lists(5, 77) == want.lane_lists(5, 77)
        assert got.to_lists() == want.to_lists()
