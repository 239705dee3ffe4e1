"""k-mer and hash word math: mazu_tpu_torch against mazu_tpu, exactly."""

import numpy as np
import pytest
import torch

from mazu_tpu import kmer as mkmer
from mazu_tpu.kphf import boophf32 as mb32
from mazu_tpu_torch import _words, kmer
from mazu_tpu_torch.kphf import boophf32 as b32
from torch_fixtures import assert_same, tensor


def _words_for(k: int, seed: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << (2 * k), 4096, dtype=np.uint64)
    all_a, all_t = np.uint64(0), np.uint64((1 << (2 * k)) - 1)
    return np.concatenate([w, np.array([all_a, all_t], dtype=np.uint64)])


def _any_words(seed: int = 5) -> np.ndarray:
    # full 64-bit patterns, bit 63 included
    rng = np.random.default_rng(seed)
    w = rng.integers(0, np.iinfo(np.uint64).max, 4096, dtype=np.uint64, endpoint=True)
    return np.concatenate([w, np.array([0, 2**63, 2**64 - 1], dtype=np.uint64)])


@pytest.mark.parametrize("k", [21, 31])
def test_revcomp(k):
    w = _words_for(k)
    assert_same(kmer.revcomp(tensor(w), k), mkmer.revcomp(w, k), "revcomp")
    assert_same(kmer.reverse_groups(tensor(w)), mkmer.reverse_groups(w), "reverse_groups")
    np.testing.assert_array_equal(kmer.revcomp_np(w, k), mkmer.revcomp(w, k))


@pytest.mark.parametrize("k", [21, 31])
def test_canonicalize(k):
    w = _words_for(k)
    canon, is_fw, rc = kmer.canonicalize(tensor(w), k)
    mc, mf, mrc = mkmer.canonicalize(w, k)
    assert_same(canon, mc, "canon")
    assert_same(is_fw, mf, "is_fw")
    assert_same(rc, mrc, "rc")


def test_revcomp_bit63_words():
    # revcomp's shift must be logical whatever the input's high bits
    w = _any_words()
    for k in (21, 31, 32):
        assert_same(kmer.revcomp(tensor(w), k), mkmer.revcomp(w, k), f"k={k}")


@pytest.mark.parametrize("k", [21, 31])
def test_mask2k(k):
    assert kmer.mask2k(k) == int(mkmer.mask2k(k))
    assert kmer.mask2k(32) & (2**64 - 1) == int(mkmer.mask2k(32))


def test_mix32():
    rng = np.random.default_rng(9)
    x = np.concatenate([
        rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32),
        np.array([0, 1, 0xFFFFFFFF, 0x80000000], dtype=np.uint32),
    ])
    want = mb32.mix32(x)
    got = b32.mix32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(b32.mix32_np(x), want)


@pytest.mark.parametrize("k", [21, 31])
def test_fold_hash32(k):
    w = _words_for(k)
    want = mb32.fold_hash32(w)
    np.testing.assert_array_equal(b32.fold_hash32(tensor(w)).numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(b32.fold_hash32_np(w), want)


@pytest.mark.parametrize("salt", [0, 1, 3, 0xFFFFFFFF])
@pytest.mark.parametrize("k", [21, 31])
def test_fold_hash32b(k, salt):
    w = _words_for(k)
    want = mb32.fold_hash32b(w, salt)
    np.testing.assert_array_equal(b32.fold_hash32b(tensor(w), salt).numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(b32.fold_hash32b_np(w, salt), want)


def test_fold_hash32_bit63_keys():
    w = _any_words()
    np.testing.assert_array_equal(
        b32.fold_hash32(tensor(w)).numpy(), mb32.fold_hash32(w).astype(np.int64)
    )


@pytest.mark.parametrize("n", [1, 13, 31, 32, 63])
def test_srl_and_unsigned_order(n):
    w = _any_words()
    v = np.random.default_rng(n).permutation(w)
    assert_same(_words.srl(tensor(w), n), w >> np.uint64(n), "srl")
    assert_same(_words.umin(tensor(w), tensor(v)), np.minimum(w, v), "umin")
    np.testing.assert_array_equal(_words.ule(tensor(w), tensor(v)).numpy(), w <= v)


def test_mask32_and_from_numpy():
    x = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], dtype=np.uint32)
    t = _words.from_numpy(x, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(_words.mask32(t).numpy(), x.astype(np.int64))
    w = _any_words()
    t64 = _words.from_numpy(w, "cpu")
    assert t64.dtype == torch.int64
    np.testing.assert_array_equal(t64.numpy().view(np.uint64), w)
    b = _words.from_numpy(np.array([True, False]), "cpu")
    assert b.dtype == torch.bool
