"""The port's 64-bit BooPHF against mazu_tpu's, with tolerance 0: the level
build's device arrays byte for byte (0, 1, 10, 10^4 and 10^5 keys, with and
without a final table), the torch lookup on members and foreign keys (bit
63 set on half), the empty final table's pad key, and a pufferfish
``mphf.bin`` written here and read back by both packages."""

import numpy as np
import pytest

import mazu_tpu.kphf.boophf as mb
import mazu_tpu_torch.kphf.boophf as pb
from mazu_tpu.io.pf1 import read_boophf as mread_boophf
from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.err import TruncatedFile
from mazu_tpu_torch.io.pf1 import read_boophf

from torch_fixtures import assert_same, same_tree, tensor, write_boophf

CASES = {"0": (0, 16), "1": (1, 16), "10": (10, 16), "1e4": (10_000, 16),
         "1e5": (100_000, 16), "final_table": (5_000, 2)}


def _keys(n: int, seed: int) -> np.ndarray:
    x = np.unique(np.random.default_rng(seed).integers(0, 1 << 64, n, dtype=np.uint64))
    np.random.default_rng(seed + 1).shuffle(x)
    x[: len(x) // 2] >>= np.uint64(1)  # half below 2^63
    return np.unique(x)


@pytest.fixture(scope="module", params=list(CASES))
def tables(request):
    n, max_levels = CASES[request.param]
    keys = _keys(n, 7)
    ref = mb.BooPHF.build(keys, gamma=1.7, max_levels=max_levels)
    port = pb.BooPHF.build(keys, gamma=1.7, max_levels=max_levels)
    return request.param, keys, ref, port


def test_build_arrays(tables):
    name, keys, ref, port = tables
    want = ref.device_arrays()
    same_tree(port.device_arrays(), want)
    assert (port.n_elem, port.last_bitset_rank) == (ref.n_elem, ref.last_bitset_rank)
    if name == "final_table":
        assert len(ref.fh_keys) > 0
    else:
        assert len(ref.fh_keys) == 0 and int(want["fh_keys"][0]) == (1 << 64) - 1


def test_lookup_members_and_foreign(tables):
    name, keys, ref, port = tables
    foreign = np.random.default_rng(9).integers(0, 1 << 64, 3000, dtype=np.uint64)
    edge = np.array([0, (1 << 64) - 1, 1 << 63], dtype=np.uint64)
    probe = np.concatenate([keys, foreign, edge])
    if len(keys) == 0:
        # no levels and an empty final table (the reference's NumPy lookup
        # indexes its empty rank array here): every key misses but the pad
        # key 2^64-1, which finds the pad's value 0, as in the reference
        got = pb.boophf_lookup(arrays_from_numpy(port.device_arrays(), "cpu"), tensor(probe))
        np.testing.assert_array_equal(got.numpy(), np.where(probe == edge[1], 0, -1))
        return
    host = ref.device_arrays()
    want = mb.boophf_lookup(host, probe, np)
    assert_same(pb.boophf_lookup(arrays_from_numpy(host, "cpu"), tensor(probe)), want)
    assert_same(pb.boophf_lookup(arrays_from_numpy(port.device_arrays(), "cpu"), tensor(probe)),
                want)
    got = port.lookup(keys, device="cpu", chunk=777)
    assert sorted(got.tolist()) == list(range(len(keys)))


def test_empty_final_table_pad_key():
    """A table with no final keys carries the pad key 2^64-1; only that key
    itself may match it, and it is not a member."""
    keys = _keys(200, 3)
    port = pb.BooPHF.build(keys)
    d = arrays_from_numpy(port.device_arrays(), "cpu")
    probe = np.array([(1 << 64) - 1, (1 << 64) - 2, 1 << 63], dtype=np.uint64)
    want = mb.boophf_lookup(mb.BooPHF.build(keys).device_arrays(), probe, np)
    assert_same(pb.boophf_lookup(d, tensor(probe)), want)


@pytest.mark.parametrize("max_levels", [16, 2], ids=["levels", "final_table"])
def test_read_boophf_round_trip(tmp_path, max_levels):
    keys = _keys(3000, 5)
    ref = mb.BooPHF.build(keys, max_levels=max_levels)
    path = str(tmp_path / "mphf.bin")
    write_boophf(path, ref)
    raw, mraw = read_boophf(path), mread_boophf(path)
    assert (raw.gamma, raw.last_bitset_rank, raw.n_elem) == (mraw.gamma, mraw.last_bitset_rank,
                                                             mraw.n_elem)
    assert raw.final_hash == mraw.final_hash
    port, want = pb.BooPHF.from_pf1(path), mb.BooPHF.from_pf1(path)
    same_tree(port.device_arrays(), want.device_arrays())
    same_tree(port.device_arrays(), ref.device_arrays())
    got = pb.boophf_lookup(arrays_from_numpy(port.device_arrays(), "cpu"), tensor(keys))
    assert_same(got, mb.boophf_lookup(ref.device_arrays(), keys, np))
    # a file cut short raises
    data = open(path, "rb").read()
    (tmp_path / "cut.bin").write_bytes(data[: len(data) - 5])
    with pytest.raises(TruncatedFile):
        read_boophf(str(tmp_path / "cut.bin"))
