"""KCDict mono2-occ32 queries: the port's torch ``kcdict_k2u`` and the
probe wrapper's CPU path against mazu_tpu's NumPy path and its Pallas
kernel in interpret mode. Integer outputs: exact equality."""

import numpy as np
import pytest
import torch

from mazu_tpu.kphf.kcdict import kcdict_k2u as ref_k2u
from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.kphf.kcdict import kcdict_k2u
from mazu_tpu_torch.ops import mono2_probe
from torch_fixtures import assert_same, build_pair, mono2_recipe, queries, tensor, toy_recipe

N = 600  # not a multiple of the Pallas block (512)


@pytest.fixture(scope="module", params=["mono2_dict", "toy"])
def case(request):
    recipe = mono2_recipe() if request.param == "mono2_dict" else toy_recipe()
    ref, port = build_pair(recipe)
    work = queries(ref.k2u.unitigs, N, seed=11)
    # lead with the side table's keys, so the batch surely holds them
    side = ref.k2u.side.reshape(-1, 7)
    side = side[side[:, 0] != 0xFFFFFFFF][:64]
    work[: len(side)] = side[:, 0].astype(np.uint64) | (
        (side[:, 1] & np.uint32(0x7FFFFFFF)).astype(np.uint64) << np.uint64(32)
    )
    return ref.k2u.device_arrays(), port.k2u.device_arrays(), work


@pytest.mark.parametrize("mode", ["main", "full"])
def test_kcdict_k2u_matches_numpy(case, mode):
    host_ref, host_port, work = case
    want = ref_k2u(host_ref, work, np, mode=mode)
    got = kcdict_k2u(arrays_from_numpy(host_port, "cpu"), tensor(work), mode=mode)
    assert set(got) == set(want)
    for key in want:
        assert_same(got[key], want[key], key)
    if mode == "full":  # the batch really hits side-table keys
        main = ref_k2u(host_ref, work, np, mode="main")
        assert (main["unresolved"] & (want["mt"] > 0)).any()


def test_state_carried_from_reference_arrays(case):
    """The reference's own arrays, carried across, answer identically."""
    host_ref, _, work = case
    d = arrays_from_numpy(host_ref, "cpu")
    for mode in ("main", "full"):
        want = ref_k2u(host_ref, work, np, mode=mode)
        got = kcdict_k2u(d, tensor(work), mode=mode)
        for key in want:
            assert_same(got[key], want[key], f"{mode}:{key}")


def test_mono2_probe_cpu_matches_pallas_interpret(case):
    """The wrapper's CPU path against K1 itself, run by the TPU
    interpreter as tests/test_pallas_query.py runs it."""
    import jax.numpy as jnp

    from mazu_tpu.ops.pallas_query import pallas_mono2_k2u

    host_ref, host_port, work = case
    want = pallas_mono2_k2u(host_ref, jnp.asarray(work), interpret=True)
    launches = mono2_probe.LAUNCHES
    got = mono2_probe.mono2_k2u(arrays_from_numpy(host_port, "cpu"), tensor(work))
    assert mono2_probe.LAUNCHES == launches, "a CPU call must not count a kernel launch"
    assert set(got) == set(want)
    for key in want:
        assert_same(got[key], np.asarray(want[key]), key)
    # displaced keys surface as unresolved with mt 0, never as a wrong hit
    unres = got["unresolved"].numpy()
    assert unres.any() and (got["mt"].numpy()[unres] == 0).all()


def test_edge_words(case):
    """All-A, all-T and a key stored in slot 1 of its bucket."""
    host_ref, host_port, _ = case
    table = host_ref["table"]
    k = host_ref["meta"].k
    row = table[np.flatnonzero(table[:, 7] != 0xFFFFFFFF)[0]]
    key1 = np.uint64(int(row[7]) | ((int(row[8]) & 0x7FFFFFFF) << 32))
    from mazu_tpu.kmer import revcomp

    words = np.array([0, (1 << (2 * k)) - 1, key1, revcomp(key1, k)], dtype=np.uint64)
    d = arrays_from_numpy(host_port, "cpu")
    for mode in ("main", "full"):
        want = ref_k2u(host_ref, words, np, mode=mode)
        got = kcdict_k2u(d, tensor(words), mode=mode)
        for key in want:
            assert_same(got[key], want[key], f"{mode}:{key}")
    got = mono2_probe.mono2_k2u(d, tensor(words))
    assert sorted(got["mt"][2:].tolist()) == [1, 2]


def test_mono2_probe_rejects_other_devices(case):
    _, host_port, work = case
    d = arrays_from_numpy(host_port, "cpu")
    with pytest.raises(ValueError):
        mono2_probe.mono2_k2u(d, tensor(work).to("meta"))


def test_kcdict_k2u_rejects_other_layouts(case):
    _, host_port, work = case
    d = arrays_from_numpy(host_port, "cpu")
    d["meta"] = d["meta"].replace(occ32=False)
    with pytest.raises(ValueError):
        kcdict_k2u(d, tensor(work))


def test_empty_batch(case):
    _, host_port, _ = case
    got = mono2_probe.mono2_k2u(arrays_from_numpy(host_port, "cpu"), torch.zeros(0, dtype=torch.int64))
    assert all(v.shape == (0,) for v in got.values())
