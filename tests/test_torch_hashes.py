"""The port's 64-bit hashes against mazu_tpu's, with tolerance 0: the
BooPHF chain (simplehash64, the multihash level 0/1 and xorshift steps),
mulhi64 and fast_range_64 on random u64 words with and without bit 63, the
C++ golden constants of the BooPHF chain, and wyhash-v1 (frozen vectors and
the scalar oracle). The BooPHF chain's NumPy forms are checked too."""

import numpy as np
import pytest

import mazu_tpu.hashes as mh
import mazu_tpu_torch.hashes as ph

from torch_fixtures import assert_same, tensor

SEEDS = [ph.BOOPHF_SEED0, ph.BOOPHF_SEED1, 0, 1, (1 << 64) - 1, 0x123456789ABCDEF]


def _words(n: int, seed: int, top: bool) -> np.ndarray:
    """Random u64 words: all below 2^63, or all with bit 63 set."""
    x = np.random.default_rng(seed).integers(0, 1 << 63, n, dtype=np.uint64)
    return x | np.uint64(1 << 63) if top else x


@pytest.mark.parametrize("top", [False, True], ids=["low", "bit63"])
@pytest.mark.parametrize("seed", SEEDS)
def test_simplehash64(seed, top):
    x = _words(5000, 1, top)
    want = mh.simplehash64(x, np.uint64(seed))
    assert_same(ph.simplehash64(tensor(x), seed), want)
    np.testing.assert_array_equal(ph.simplehash64_np(x, seed), want)


@pytest.mark.parametrize("top", [False, True], ids=["low", "bit63"])
def test_multihash_chain(top):
    x = _words(5000, 2, top)
    h, s0, s1 = mh.multihash_h0(x)
    g, t0, t1 = ph.multihash_h0(tensor(x))
    n0, n1 = ph.multihash_h0_np(x)[1:]
    for step in range(12):
        assert_same(g, h, f"hash {step}")
        assert_same(t0, s0, f"state0 {step}")
        assert_same(t1, s1, f"state1 {step}")
        np.testing.assert_array_equal(n0, s0)
        np.testing.assert_array_equal(n1, s1)
        if step == 0:
            h, s0, s1 = mh.multihash_h1(s0, s1, x)
            g, t0, t1 = ph.multihash_h1(t0, t1, tensor(x))
            _, n0, n1 = ph.multihash_h1_np(n0, n1, x)
        else:
            h, s0, s1 = mh.multihash_next(s0, s1)
            g, t0, t1 = ph.multihash_next(t0, t1)
            _, n0, n1 = ph.multihash_next_np(n0, n1)


@pytest.mark.parametrize("top", [False, True], ids=["low", "bit63"])
def test_mulhi64_and_fast_range(top):
    a = _words(5000, 3, top)
    b = np.random.default_rng(4).integers(0, 1 << 64, 5000, dtype=np.uint64)
    want = mh.mulhi64(a, b)
    assert_same(ph.mulhi64(tensor(a), tensor(b)), want)
    np.testing.assert_array_equal(ph.mulhi64_np(a, b), want)
    for p in (1, 7, 64, 1000, 1 << 40, (1 << 63) + 5, (1 << 64) - 1):
        want = mh.fast_range_64(a, np.uint64(p))
        assert_same(ph.fast_range_64(tensor(a), p), want, f"p={p}")
        np.testing.assert_array_equal(ph.fast_range_64_np(a, p), want)
        exact = np.array([(int(w) * p) >> 64 for w in a[:64]], dtype=np.uint64)
        assert_same(ph.fast_range_64(tensor(a[:64]), p), exact, f"p={p}, 128-bit")


def test_golden_simplehash():
    """C++-verified constants of SingleHashFunctor (``tests/test_boophf.py``)."""
    true_hashes = [
        0x6E1BCCDB7AA2BC25, 0x54676A7B01425B7, 0x5C9BE323E5AD1BE1, 0x9567829F5E948F83,
        0xCF71E329165C79B5, 0x9F1219F1BCD9D206, 0x6BD828B35DBA940E, 0xF55B08C3340017C3,
        0xD178AE94742FA575, 0x5DC299D49318DC6B,
    ]
    keys = np.arange(10, dtype=np.uint64)
    want = np.array(true_hashes, dtype=np.uint64)
    assert_same(ph.simplehash64(tensor(keys), ph.BOOPHF_SEED0), want)
    np.testing.assert_array_equal(ph.simplehash64_np(keys, ph.BOOPHF_SEED0), want)


def test_golden_multihash():
    """The C++ chain's first five hashes of key 0."""
    true_hashes = [7934160411570650149, 4031181471818755726, 7802733314557663513,
                   5772550616205298107, 3882642898705877381]
    key = tensor(np.zeros(1, dtype=np.uint64))
    h, s0, s1 = ph.multihash_h0(key)
    got = [h]
    h, s0, s1 = ph.multihash_h1(s0, s1, key)
    got.append(h)
    for _ in range(3):
        h, s0, s1 = ph.multihash_next(s0, s1)
        got.append(h)
    assert [int(g.numpy().view(np.uint64)[0]) for g in got] == true_hashes


# frozen wyhash-v1 vectors of ``tests/test_wyhash.py``: (x, seed, digest)
WY_VECTORS = [
    (0x0000000000000000, 0, 0x758026CCFDD6ED2D),
    (0x0000000000000001, 0, 0xA4D7B15CEEBADBE3),
    (0x0000000000000000, 7, 0x7434B06AC31B53BB),
    (0x0000000000000001, 7, 0x0EC1EFE73CBA212A),
    (0xDEADBEEFCAFEF00D, 7, 0xAA2C1F31B14687D8),
    (0xFFFFFFFFFFFFFFFF, 7, 0x92314B615760858C),
]


@pytest.mark.parametrize("x,seed,want", WY_VECTORS)
def test_wyhash_frozen_vectors(x, seed, want):
    w = np.array([x], dtype=np.uint64)
    assert int(ph.wyhash_u64(tensor(w), seed).numpy().view(np.uint64)[0]) == want
    assert ph.wyhash_bytes(x.to_bytes(8, "little"), seed) == want


@pytest.mark.parametrize("seed", [0, 1, 0x123456789])
def test_wyhash_matches_reference_and_oracle(seed):
    x = np.random.default_rng(11).integers(0, 1 << 64, 2000, dtype=np.uint64)
    want = mh.wyhash_u64(x, seed)
    assert_same(ph.wyhash_u64(tensor(x), seed), want)
    for v, w in zip(x[:50], want[:50]):
        assert ph.wyhash_bytes(int(v).to_bytes(8, "little"), seed) == int(w)


def test_wyhash_bytes_buffers():
    for n in (0, 1, 3, 4, 7, 8, 32, 40):
        data = bytes(range(n))
        assert ph.wyhash_bytes(data, 3) == mh.wyhash_bytes(data, 3), n
    with pytest.raises(NotImplementedError):
        ph.wyhash_bytes(bytes(9), 0)
