"""The Elias-Fano vector and ``bv_select`` of ``mazu_tpu_torch`` against
``mazu_tpu``'s, at tolerance 0: the same words, the same values, the same
error texts."""

import numpy as np
import pytest
import torch

from mazu_tpu import err as merr
from mazu_tpu.bits.bitvector import BitVector as MBitVector
from mazu_tpu.bits.bitvector import bv_select as m_bv_select
from mazu_tpu.bits.elias_fano import EFVector as MEF
from mazu_tpu.bits.elias_fano import ef_get as m_ef_get

from mazu_tpu_torch import err as perr
from mazu_tpu_torch.bits.bitvector import BitVector, bv_select
from mazu_tpu_torch.bits.elias_fano import EFVector, ef_get
from mazu_tpu_torch.convert import arrays_from_numpy


def _sequences():
    rng = np.random.default_rng(3)
    return {
        "one element": np.array([5]),
        "one zero": np.array([0]),
        "all equal": np.full(40, 7),
        "l = 1": np.arange(100) * 2,
        "dense": np.arange(1000),
        "u = 2^40": np.sort(rng.integers(0, 1 << 40, 1000)),
        "ends at 2^40": np.array([0, 3, 1 << 40]),
        "runs": np.repeat(np.arange(0, 5000, 37), 5),
        "bucket prefix": np.concatenate([[0], np.cumsum(rng.integers(0, 4, 3000))]),
    }


SEQS = _sequences()


@pytest.mark.parametrize("name", list(SEQS))
def test_ef_words_and_get(name):
    xs = SEQS[name].astype(np.uint64)
    want, got = MEF.from_array(xs), EFVector.from_array(xs)
    assert (got.u, got.l) == (want.u, want.l)
    assert got.l >= 1
    np.testing.assert_array_equal(got.high_bits.words, want.high_bits.words)
    np.testing.assert_array_equal(got.high_bits.blocks, want.high_bits.blocks)
    np.testing.assert_array_equal(got.low_bits.words, want.low_bits.words)
    assert got.high_bits.n_bits == len(xs) + (int(xs[-1]) >> got.l)
    assert got.num_bits() == want.num_bits()
    np.testing.assert_array_equal(got.to_array(), xs)
    i = np.arange(len(xs), dtype=np.int64)
    d = arrays_from_numpy(got.device_arrays(), "cpu")
    g = ef_get(d, torch.from_numpy(i)).numpy().view(np.uint64)
    np.testing.assert_array_equal(g, m_ef_get(want.device_arrays(), i, np))
    np.testing.assert_array_equal(g, xs)


def test_ef_explicit_universe():
    xs = np.array([1, 4, 9], dtype=np.uint64)
    want, got = MEF.from_array(xs, u=1 << 20), EFVector.from_array(xs, u=1 << 20)
    assert (got.u, got.l) == (want.u, want.l)
    np.testing.assert_array_equal(got.high_bits.words, want.high_bits.words)
    np.testing.assert_array_equal(got.to_array(), xs)


@pytest.mark.parametrize("xs, exc", [(np.zeros(0), "EFEmpty"), (np.array([3, 2]), "EFNotMonotone")])
def test_ef_errors(xs, exc):
    with pytest.raises(getattr(merr, exc)) as want:
        MEF.from_array(xs.astype(np.uint64))
    with pytest.raises(getattr(perr, exc)) as got:
        EFVector.from_array(xs.astype(np.uint64))
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, perr.MazuError) and isinstance(got.value, ValueError)


@pytest.mark.parametrize("density", [0.01, 0.5, 0.99])
def test_bv_select(density):
    rng = np.random.default_rng(int(density * 100))
    bits = rng.random(5000) < density
    bits[-1] = True  # a one in the last word
    want, got = MBitVector.from_bools(bits), BitVector.from_bools(bits)
    np.testing.assert_array_equal(got.words, want.words)
    r = np.arange(want.n_ones, dtype=np.int64)
    d = arrays_from_numpy(got.device_arrays(), "cpu")
    g = bv_select(d, torch.from_numpy(r)).numpy()
    np.testing.assert_array_equal(g, m_bv_select(want.device_arrays(), r, np))
    np.testing.assert_array_equal(g, np.flatnonzero(bits))
    np.testing.assert_array_equal(got.select(r), g)


def test_bv_select_bit_63():
    """Ones at bit 63 of each word: the in-word bisection's shifts are
    logical on the int64 bit patterns."""
    pos = np.arange(63, 64 * 20, 64)
    bv = BitVector.from_set_positions(pos, 64 * 20)
    d = arrays_from_numpy(bv.device_arrays(), "cpu")
    g = bv_select(d, torch.arange(len(pos))).numpy()
    np.testing.assert_array_equal(g, pos)
    assert (bv.words[:20].view(np.int64) < 0).all()
