"""The slice as a whole: padded and compact queries, their merge, and the
rolled whole-pass checksum, port against mazu_tpu on the same index.

The index is the toy index re-keyed to mono2 (unitigs with 3 occurrences,
so the padded phase 2 runs) and the mono2_dict recipe. The port's arrays
come either from its own builders or carried across from the reference's
arrays with ``convert.arrays_from_numpy``."""

import numpy as np
import pytest
import torch

from mazu_tpu.index import modindex as mmi
from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index import modindex as mi
from mazu_tpu_torch.index.modindex import QueryIndex
from mazu_tpu_torch.index.pipeline import ROLL_STEP, OneGraphIndexQuery
from torch_fixtures import assert_same, build_pair, mono2_recipe, queries, tensor, toy_recipe

N = 600


@pytest.fixture(scope="module", params=["toy", "mono2_dict"])
def pair(request):
    return build_pair(toy_recipe() if request.param == "toy" else mono2_recipe())


@pytest.fixture(scope="module", params=["port_builder", "carried"])
def case(request, pair):
    ref, port = pair
    host = ref.device_arrays(fused=True)
    src = port.device_arrays() if request.param == "port_builder" else host
    d = arrays_from_numpy(src, "cpu")
    work = queries(ref.k2u.unitigs, N, seed=5)
    return ref, host, d, work


def _same_dict(got, want, prefix=""):
    assert set(got) == set(want), prefix
    for key in want:
        if isinstance(want[key], dict):
            _same_dict(got[key], want[key], f"{prefix}{key}.")
        else:
            assert_same(got[key], want[key], prefix + key)


def test_get_ref_pos_padded(case):
    ref, host, d, work = case
    mo = ref.max_occs()
    want = mmi.get_ref_pos_padded(host, work, np, mo)
    got = mi.get_ref_pos_padded(d, tensor(work), mo)
    _same_dict(got, want)
    assert (np.asarray(want["n_occs"]) == 3).any() == (mo == 3)


@pytest.mark.parametrize("m2", [64, 256])
def test_get_ref_pos_compact_merged(case, m2):
    ref, host, d, work = case
    mo = ref.max_occs()
    want = mmi.get_ref_pos_compact(host, work, np, mo, merge=True, m2=m2)
    got = mi.get_ref_pos_compact(d, tensor(work), mo, merge=True, m2=m2)
    _same_dict(got, want)
    if not bool(want["over_budget"]):  # then it is the exact query
        padded = mi.get_ref_pos_padded(d, tensor(work), mo)
        v = padded["valid"]
        for key in ("unitig_id", "pos", "mt", "n_occs"):
            assert torch.equal(got[key], padded[key]), key
        for key in ("ref_id", "ref_pos", "orient"):
            assert torch.equal(torch.where(v, got[key][:, : v.shape[1]], 0), torch.where(v, padded[key], 0))


@pytest.mark.parametrize("m2", [64, 256])
def test_get_ref_pos_compact_pieces(case, m2):
    ref, host, d, work = case
    mo = ref.max_occs()
    want = mmi.get_ref_pos_compact(host, work, np, mo, merge=False, m2=m2)
    got = mi.get_ref_pos_compact(d, tensor(work), mo, merge=False, m2=m2)
    assert set(got) == set(want)
    _same_dict(got["main"], want["main"], "main.")
    for key in ("overflow", "n_ovf", "slot_real", "over_budget"):
        assert_same(got[key], want[key], key)
    real = np.asarray(want["slot_real"])
    assert_same(got["lanes"][torch.from_numpy(real)], np.asarray(want["lanes"])[real], "lanes")
    for key, w in want["phase2"].items():
        assert_same(got["phase2"][key][torch.from_numpy(real)], np.asarray(w)[real], f"phase2.{key}")
    # merged per-lane K2U fields
    _same_dict(mi.merge_compact_k2u(got), mmi.merge_compact_k2u(want, np), "merge_compact_k2u.")


def test_onegraph_rolled_checksum_matches_jax(case):
    import jax
    import jax.numpy as jnp

    from mazu_tpu.index.pipeline import OneGraphIndexQuery as RefOneGraph

    ref, host, d, work = case
    CH, m2 = 3, 256
    want_og = RefOneGraph(ref, batch=N, n_chunks=CH, m2=m2, host_arrays=host)
    want, want_worst = want_og.checksum_pass_rolled(jax.device_put(jnp.asarray(work)))

    og = OneGraphIndexQuery(QueryIndex(d), batch=N, n_chunks=CH, m2=m2)
    got, worst = og.checksum_pass_rolled(tensor(work))
    assert (got, worst) == (want, want_worst)
    stack = torch.stack([torch.roll(tensor(work), i * ROLL_STEP) for i in range(CH)])
    assert og.checksum_pass(stack) == (got, worst)
    assert got == CH * og.checksum_host(QueryIndex(d), tensor(work)[None])
    assert got == CH * want_og.checksum_host(work[None, :])


def test_roll_direction_matches_jnp():
    import jax.numpy as jnp

    x = np.arange(1000, dtype=np.int64)
    for shift in (1, ROLL_STEP, 3 * ROLL_STEP):
        np.testing.assert_array_equal(torch.roll(torch.from_numpy(x), shift).numpy(), np.asarray(jnp.roll(x, shift)))


def test_onegraph_over_budget_raises(case):
    ref, host, d, work = case
    want = mmi.get_ref_pos_compact(host, work, np, ref.max_occs(), merge=False, m2=8)
    assert int(want["n_ovf"]) > 8
    og = OneGraphIndexQuery(QueryIndex(d), batch=N, n_chunks=2, m2=8)
    with pytest.raises(RuntimeError, match="capacity"):
        og.checksum_pass_rolled(tensor(work))
    with pytest.raises(RuntimeError, match="capacity"):
        og.checksum_host(QueryIndex(d), tensor(work)[None])


def test_query_index_buffers(case):
    ref, host, d, work = case
    qi = QueryIndex(d)
    assert qi.max_occs == max(1, ref.max_occs())
    a = qi.to("cpu").arrays()
    assert a["k2u"]["meta"] == d["k2u"]["meta"]
    assert torch.equal(a["k2u"]["table"], d["k2u"]["table"])
    names = dict(qi.named_buffers())
    assert "k2u__table" in names and "u2pos__ctable2" in names
    assert qi.nbytes() == sum(b.numel() * b.element_size() for b in names.values())
