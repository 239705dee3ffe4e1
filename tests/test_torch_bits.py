"""The port's succinct primitives against mazu_tpu's, exactly: the word
helpers (variable logical shift, SWAR popcount, window read), the host
BitVector (words, blocks, rank, windows), ``iv_get``, the unitig set's
boundary bitvector and paired arrays, and the device functions
``us_rank``, ``us_extent`` and ``us_is_valid_pos`` on both layouts."""

import numpy as np
import pytest
import torch

from mazu_tpu.bits.bitvector import BitVector as MBitVector
from mazu_tpu.bits.bitvector import bv_rank as m_bv_rank
from mazu_tpu.bits.bitvector import bv_read_window as m_bv_read_window
from mazu_tpu.bits.intvector import IntVector as MIntVector
from mazu_tpu.bits.intvector import iv_get as m_iv_get
from mazu_tpu.containers import unitig_set as mus

from mazu_tpu_torch._words import popcount64, read_window, srl_var
from mazu_tpu_torch.bits.bitvector import BitVector, bv_rank, bv_read_window, popcount_np
from mazu_tpu_torch.bits.intvector import IntVector, iv_get
from mazu_tpu_torch.containers import unitig_set as pus
from mazu_tpu_torch.convert import arrays_from_numpy

from torch_fixtures import assert_same, same_tree, tensor


def _words(n, seed):
    return np.random.default_rng(seed).integers(0, 1 << 64, n, dtype=np.uint64)


def test_srl_var_and_popcount_on_bit63_words():
    x = _words(4000, 1)
    x[:64] = np.uint64(1) << np.arange(64, dtype=np.uint64)
    n = np.random.default_rng(2).integers(0, 64, len(x))
    assert_same(srl_var(tensor(x), torch.from_numpy(n)), x >> n.astype(np.uint64), "srl_var")
    want = np.bitwise_count(x).astype(np.int64)
    assert_same(popcount64(tensor(x)), want, "popcount64")
    np.testing.assert_array_equal(popcount_np(x), want.astype(np.uint32))


@pytest.mark.parametrize("width", [1, 13, 30, 58, 63])
def test_read_window(width):
    from mazu_tpu.bits.bitvector import _read_window

    w = _words(300, width)
    pos = np.random.default_rng(width).integers(0, 298 * 64, 2000)
    assert_same(read_window(tensor(w), torch.from_numpy(pos), width),
                _read_window(w, pos, width, np), f"width {width}")


@pytest.mark.parametrize("n_bits,n_set", [(1, 1), (64, 3), (1000, 17), (70_000, 5000)])
def test_bitvector(n_bits, n_set):
    rng = np.random.default_rng(n_bits)
    positions = rng.choice(n_bits, n_set, replace=False)
    want = MBitVector.from_set_positions(positions, n_bits)
    got = BitVector.from_set_positions(positions, n_bits)
    same_tree(got.device_arrays(), want.device_arrays())
    q = rng.integers(0, n_bits + 1, 3000)
    np.testing.assert_array_equal(got.rank(q), want.rank(q))
    qb = rng.integers(0, n_bits, 300)
    for width in (1, 30):
        np.testing.assert_array_equal(got.read_window(qb, width), want.read_window(qb, width))
    d = arrays_from_numpy(got.device_arrays(), "cpu")
    assert_same(bv_rank(d, torch.from_numpy(q)), m_bv_rank(want.device_arrays(), q, np), "bv_rank")
    assert_same(bv_read_window(d, torch.from_numpy(qb), 30),
                m_bv_read_window(want.device_arrays(), qb, 30, np), "bv_read_window")


@pytest.mark.parametrize("width", [3, 29, 58])
def test_iv_get(width):
    rng = np.random.default_rng(width)
    v = rng.integers(0, 1 << width, 5000, dtype=np.uint64)
    want = MIntVector.from_array(v)
    got = IntVector.from_array(v)
    same_tree(got.device_arrays(), want.device_arrays())
    i = rng.integers(0, len(v), 4000)
    d = arrays_from_numpy(got.device_arrays(), "cpu")
    assert_same(iv_get(d, torch.from_numpy(i)), m_iv_get(want.device_arrays(), i, np), "iv_get")


@pytest.fixture(scope="module")
def unitigs():
    rng = np.random.default_rng(5)
    lens = rng.integers(31, 400, 60)
    seqs = ["".join(rng.choice(list("ACGT"), n)) for n in lens]
    return mus.UnitigSet.from_seqs(seqs, 31), pus.UnitigSet.from_seqs(seqs, 31)


@pytest.mark.parametrize("paired", [False, True])
def test_unitig_set_arrays(unitigs, paired):
    ref, port = unitigs
    same_tree(port.device_arrays(paired=paired), ref.device_arrays(paired=paired))
    pos = np.arange(-3, ref.total_len + 3)
    np.testing.assert_array_equal(port.is_valid_useq_pos(pos), ref.is_valid_useq_pos(pos))


@pytest.mark.parametrize("paired", [False, True])
def test_us_device_functions(unitigs, paired):
    ref, port = unitigs
    want_d = ref.device_arrays(paired=paired)
    d = arrays_from_numpy(port.device_arrays(paired=paired), "cpu")
    pos = np.arange(0, ref.total_len)
    assert_same(pus.us_rank(d, torch.from_numpy(pos)), mus.us_rank(want_d, pos, np), "us_rank")
    uid = np.arange(ref.n_unitigs)
    for g, w, what in zip(pus.us_extent(d, torch.from_numpy(uid)), mus.us_extent(want_d, uid, np),
                          ("start", "end")):
        assert_same(g, w, what)
    q = np.arange(-40, ref.total_len + 40)
    assert_same(pus.us_is_valid_pos(d, torch.from_numpy(q)), mus.us_is_valid_pos(want_d, q, np),
                "us_is_valid_pos")
