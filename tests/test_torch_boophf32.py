"""The port's BooPHF32 against mazu_tpu's, with tolerance 0: the chain
state fold and step on random u64 keys (bit 63 set on half), the level
build's device arrays byte for byte (a one-key table, tables with and
without final-hash keys; the level loop on CPU tensors), the host lookup,
and the torch lookup, full and with a level limit, on members and
non-members, on the lean and the ``mrows`` layouts."""

import numpy as np
import pytest
import torch

import mazu_tpu.kphf.boophf32 as mb
import mazu_tpu_torch.kphf.boophf32 as pb
from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.kphf.sshash import mphf_lookup

from torch_fixtures import assert_same, same_tree, tensor


def _keys(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    x[: n // 2] >>= np.uint64(1)  # half below 2^63, half (about) with bit 63 set
    return x


def test_key_fold32_and_chain_next():
    x = _keys(20_000, 1)
    x[:3] = [0, (1 << 64) - 1, 1 << 63]
    w0, w1 = mb.key_fold32(x)
    g0, g1 = pb.key_fold32(tensor(x))
    assert_same(g0, w0.astype(np.int64), "s0")
    assert_same(g1, w1.astype(np.int64), "s1")
    for step in range(4):
        wh, w0, w1 = mb.chain_next(w0, w1)
        gh, g0, g1 = pb.chain_next(g0, g1)
        for g, w, what in ((gh, wh, "h"), (g0, w0, "s0"), (g1, w1, "s1")):
            assert_same(g, w.astype(np.int64), f"step {step} {what}")


CASES = {
    # (n keys, max_levels): a one-key table, a table the levels place
    # whole, and one whose keys left after two levels go to the final table
    "one_key": (1, 12),
    "levels_only": (3000, 12),
    "final_table": (3000, 2),
}


@pytest.fixture(scope="module", params=list(CASES))
def tables(request):
    n, max_levels = CASES[request.param]
    keys = np.unique(_keys(n, 7 + n))
    ref = mb.BooPHF32.build(keys, gamma=1.7, max_levels=max_levels)
    port = pb.BooPHF32.build(keys, gamma=1.7, max_levels=max_levels, device="cpu")
    return request.param, keys, ref, port


def test_build_device_arrays(tables):
    name, keys, ref, port = tables
    want = ref.device_arrays()
    same_tree(port.device_arrays(), want, name)
    assert port.n_elem == ref.n_elem == len(keys)
    assert port.last_bitset_rank == ref.last_bitset_rank
    if name == "final_table":
        assert len(ref.fh_keys) > 0
    else:
        assert len(ref.fh_keys) == 0 and int(want["fh_keys"][0]) == (1 << 64) - 1


def test_host_lookup_is_a_bijection(tables):
    name, keys, ref, port = tables
    got = port.lookup(keys, device="cpu", chunk=1000)
    np.testing.assert_array_equal(got, ref.lookup(keys).astype(np.int32))
    assert sorted(got.tolist()) == list(range(len(keys)))


@pytest.mark.parametrize("level_limit", [None, 1, 2, 4])
def test_lookup(tables, level_limit):
    """Members and non-members (random keys, bit 63 set on half), through
    both packages' lookups on the same arrays."""
    name, keys, ref, port = tables
    host = ref.device_arrays()
    probe = np.concatenate([keys, _keys(2000, 99), np.array([0, (1 << 64) - 1], np.uint64)])
    d = arrays_from_numpy(port.device_arrays(), "cpu")
    want = mb.boophf32_lookup(host, probe, np, level_limit=level_limit)
    got = mphf_lookup(d, tensor(probe), level_limit=level_limit)
    if level_limit is None:
        assert_same(got, want, "values")
        assert (got[: len(keys)] >= 0).all()
    else:
        assert_same(got[0], want[0], "values")
        assert_same(got[1], want[1], "unresolved")
        # a placed key gets its exact value
        full = mb.boophf32_lookup(host, probe, np)
        placed = ~np.asarray(want[1])
        np.testing.assert_array_equal(np.asarray(want[0])[placed], full[placed])
    # the port reads the reference's arrays too
    got2 = pb.boophf32_lookup(arrays_from_numpy(host, "cpu"), tensor(probe), level_limit=level_limit)
    for g, w in zip(got2 if level_limit else (got2,), want if level_limit else (want,)):
        assert_same(g, w)


def test_lookup_takes_no_mrows(tables):
    """The ``mrows`` layout (ported since the lean-only port): the port's
    paired rows equal the reference's byte for byte, and the lookup on them
    equals the reference's at every level limit, on members and
    non-members; the lean arrays are gone from it."""
    name, keys, ref, port = tables
    want = ref.device_arrays(mrows=True)
    got = port.device_arrays(mrows=True)
    same_tree(got, want, name)
    assert "words" not in got and "ranks" not in got
    probe = np.concatenate([keys, _keys(2000, 98), np.array([0, (1 << 64) - 1], np.uint64)])
    d = arrays_from_numpy(got, "cpu")
    for level_limit in (None, 1, 2, 4):
        w = mb.boophf32_lookup(want, probe, np, level_limit=level_limit)
        g = pb.boophf32_lookup(d, tensor(probe), level_limit=level_limit)
        for gg, ww in zip(g if level_limit else (g,), w if level_limit else (w,)):
            assert_same(gg, ww, f"{name} level_limit={level_limit}")


def test_mphf_lookup_refuses_the_64bit_booPHF():
    """``mphf_lookup`` dispatches the 64-bit BooPHF (its chain always runs
    in full: a level limit leaves nothing unresolved) and refuses only an
    MPHF kind it does not know."""
    from mazu_tpu.kphf.boophf import BooPHF as MBooPHF, boophf_lookup as mlookup
    from mazu_tpu_torch.pytree import meta

    keys = np.random.default_rng(4).integers(0, 1 << 64, 300, dtype=np.uint64)
    host = MBooPHF.build(keys).device_arrays()
    d = arrays_from_numpy(host, "cpu")
    want = mlookup(host, keys, np)
    np.testing.assert_array_equal(mphf_lookup(d, tensor(keys)).numpy(), want)
    got, unresolved = mphf_lookup(d, tensor(keys), level_limit=2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not bool(unresolved.any())
    with pytest.raises(ValueError, match="no MPHF lookup"):
        mphf_lookup({"meta": meta(kind="wyhash")}, torch.zeros(1, dtype=torch.int64))


BUILDS32 = {
    # (keys, max_levels): none, one, 33, keys with bit 63 set, and a set
    # that leaves a final table
    "empty": (np.zeros(0, np.uint64), 12),
    "one": (np.array([(1 << 64) - 5], np.uint64), 12),
    "33": (np.unique(_keys(33, 21)), 12),
    "bit63": (np.unique(_keys(5000, 22) | np.uint64(1 << 63)), 12),
    "final_table": (np.unique(_keys(5000, 23)), 3),
}


@pytest.mark.parametrize("chunk", [7, 1 << 26])
@pytest.mark.parametrize("name", list(BUILDS32))
def test_build_on_cpu_tensors(name, chunk):
    """The level loop on CPU tensors, from a NumPy array and from an int64
    tensor, ``chunk`` keys at a time: every level's words and ranks, the
    final table and the counts equal the reference's build."""
    keys, max_levels = BUILDS32[name]
    ref = mb.BooPHF32.build(keys, gamma=1.7, max_levels=max_levels)
    for src in (keys, tensor(keys)):
        port = pb.BooPHF32.build(src, gamma=1.7, max_levels=max_levels, device="cpu",
                                 chunk=chunk)
        assert (port.n_elem, port.last_bitset_rank) == (ref.n_elem, ref.last_bitset_rank)
        assert len(port.levels) == len(ref.levels)
        for (n_a, w_a, r_a), (n_b, w_b, r_b) in zip(port.levels, ref.levels):
            assert n_a == n_b
            np.testing.assert_array_equal(w_a, w_b)
            np.testing.assert_array_equal(r_a, r_b)
            assert w_a.dtype == w_b.dtype and r_a.dtype == r_b.dtype
        np.testing.assert_array_equal(port.fh_keys, ref.fh_keys)
        np.testing.assert_array_equal(port.fh_vals, ref.fh_vals)
        assert port.fh_keys.dtype == np.uint64 and port.fh_vals.dtype == np.uint32
    if name == "final_table":
        assert len(ref.fh_keys) > 0


def test_build_refuses_duplicates():
    """A key's copies collide on every level and all reach the final table,
    where the port's build finds them. The reference's distinctness
    assertion counts placed plus remaining keys, which always sum to the
    input, so its build keeps both copies in its final table (ROADMAP C14)."""
    keys = np.concatenate([np.unique(_keys(200, 24)), np.array([7, 7], np.uint64)])
    with pytest.raises(ValueError, match="BooPHF32 keys must be distinct"):
        pb.BooPHF32.build(keys, device="cpu")
    ref = mb.BooPHF32.build(keys)
    assert (ref.fh_keys == 7).sum() == 2


def test_build_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pb.BooPHF32.build(_keys(10, 1))
