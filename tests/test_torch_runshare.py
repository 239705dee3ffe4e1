"""The port's run-sharing read query against mazu_tpu's, with tolerance 0:
``sshash_k2u_reads_runshare`` on a direct SSHash's inline rows (plain and
fused; a cuckoo and a bounded-bucket skew table) against the reference's
run with ``jnp`` on the CPU, over reads that cross buckets, begin and end
mid-batch and are padded with one-lane runs; ``_forward_fill`` at its edges;
the run slots (a lane each; the reference's N / 2 overflow); ``ReadBatchQuery``'s checksum against
``TwoPhaseIndexQuery``'s and the reference class's; the layouts it
refuses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mazu_tpu.index.twophase as mtp
import mazu_tpu.kphf.sshash as msshash
from mazu_tpu.kphf.runshare import _forward_fill as m_forward_fill
from mazu_tpu.kphf.runshare import sshash_k2u_reads_runshare as m_runshare

import mazu_tpu_torch.kphf.sshash as psshash
from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index import twophase as ptp
from mazu_tpu_torch.index.modindex import QueryIndex
from mazu_tpu_torch.index.validate import valid_kmer_windows
from mazu_tpu_torch.kphf.runshare import _forward_fill, run_starts, sshash_k2u_reads_runshare

from torch_fixtures import assert_same, build_capacity_pair, build_mphf_pair, tensor, toy_recipe

COMP = str.maketrans("ACGT", "TGCA")
N = 4096
_PAIRS = {}


def pair(name):
    if name not in _PAIRS:
        recipe = toy_recipe()
        if name == "bucket":
            with pytest.MonkeyPatch.context() as mp:
                for mod in (msshash, psshash):
                    mp.setattr(mod.SSHash, "_place_skew_cuckoo",
                               staticmethod(lambda *a, **kw: None))
                _PAIRS[name] = build_capacity_pair(recipe, skew=2)
        else:
            _PAIRS[name] = build_capacity_pair(recipe)
    return _PAIRS[name]


def read_batch(seqs, k, n=N, seed=1, pad=0, pad_runs=True):
    """(words, new_read) of ``n`` lanes: the k-mers of reads of 40 to 150
    bases from the unitigs, half reverse-complemented, one in 20 with an N,
    laid end to end; the batch starts inside a read (lane 0 is no read
    start) and ends inside one, and the last ``pad`` lanes are zero words,
    each its own run as a power-of-two padding makes them (``pad_runs``),
    or one run."""
    rng = np.random.default_rng(seed)
    words, flags = [], []
    total = 0
    while total < n - pad + 200:
        s = seqs[int(rng.integers(len(seqs)))]
        ln = int(rng.integers(40, min(150, len(s)) + 1))
        a = int(rng.integers(0, len(s) - ln + 1))
        r = s[a : a + ln]
        if rng.random() < 0.5:
            r = r.translate(COMP)[::-1]
        if rng.random() < 0.05:
            r = r[:20] + "N" + r[21:]
        _, w = valid_kmer_windows(r, k)
        if len(w) == 0:
            continue
        f = np.zeros(len(w), dtype=bool)
        f[0] = True
        words.append(w)
        flags.append(f)
        total += len(w)
    w = np.concatenate(words)[13 : 13 + n - pad]
    f = np.concatenate(flags)[13 : 13 + n - pad]
    assert not f[0]
    w = np.concatenate([w, np.zeros(pad, dtype=np.uint64)])
    f = np.concatenate([f, np.full(pad, pad_runs)])
    return w, f


@pytest.mark.parametrize("ref_budget_div", [1, 2])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", ["direct", "bucket"])
def test_runshare_matches_reference(name, fused, ref_budget_div):
    """The port has a run slot a lane, so this read batch (~0.55 runs a
    k-mer: ``run_starts``) never overflows it, and its lanes equal the main
    probe's at full depth. The reference at that budget (``budget_div=1``)
    gives the same, key for key; at its own default, N / 2 slots, it
    overflows (C11)."""
    ref, port = pair(name)
    words, nr = read_batch(toy_recipe()[0], ref.k, pad=300)
    host = ref.device_arrays(fused=fused)
    want = m_runshare(jax.device_put(host["k2u"]), jnp.asarray(words), jnp.asarray(nr), jnp,
                      budget_div=ref_budget_div)
    d = arrays_from_numpy(port.device_arrays(fused=fused), "cpu")
    fw, nrt = tensor(words), torch.from_numpy(nr)
    got = sshash_k2u_reads_runshare(d["k2u"], fw, nrt)
    assert set(got) == set(want)
    n_runs = int(run_starts(d["k2u"], fw, nrt)[0].sum())
    assert n_runs > N // 2
    assert not bool(got["run_overflow"])
    assert bool(want["run_overflow"]) == (ref_budget_div == 2)
    if ref_budget_div == 1:
        for key in want:
            assert_same(got[key], np.asarray(want[key]), key)
    main = psshash.sshash_k2u(d["k2u"], fw, mode="main")
    for key in ("unitig_id", "unitig_len", "pos", "mt", "use_skew"):
        assert torch.equal(got[key], main[key]), key
    assert bool(got["use_skew"].any()) and int((got["mt"] > 0).sum()) > N // 2


def _fill_cases():
    rng = np.random.default_rng(2)
    data = rng.integers(-(1 << 31), 1 << 31, (40, 5)).astype(np.int32)
    rand = rng.random(40) < 0.3
    first_off = rand.copy()
    first_off[0] = False
    one = np.zeros(40, dtype=bool)
    one[0] = True
    return data, {"lane 0 invalid": first_off, "all valid": np.ones(40, bool), "one run": one,
                  "none valid": np.zeros(40, bool), "random": rand | one}


@pytest.mark.parametrize("case", ["lane 0 invalid", "all valid", "one run", "none valid",
                                  "random"])
def test_forward_fill_edges(case):
    data, cases = _fill_cases()
    valid = cases[case]
    want = m_forward_fill(jnp, jnp.asarray(valid), jnp.asarray(data))
    got = _forward_fill(torch.from_numpy(valid), torch.from_numpy(data))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_run_overflow_raises():
    """Random words, each lane its own read, make a run a lane: more than
    the reference's N / 2 run slots, so its ``ReadBatchQuery`` raises. The
    port has a slot a lane: no overflow, and its checksum equals
    ``TwoPhaseIndexQuery``'s."""
    ref, port = pair("direct")
    rng = np.random.default_rng(3)
    words = rng.integers(0, 1 << 62, 512, dtype=np.uint64)
    nr = np.ones(512, dtype=bool)
    want = m_runshare(jax.device_put(ref.device_arrays(fused=True)["k2u"]), jnp.asarray(words),
                      jnp.asarray(nr), jnp)
    assert bool(want["run_overflow"])
    with pytest.raises(AssertionError, match="run budget exceeded"):
        mtp.ReadBatchQuery(ref).checksum_query(jnp.asarray(words), words, jnp.asarray(nr))
    d = arrays_from_numpy(port.device_arrays(fused=True), "cpu")
    r = sshash_k2u_reads_runshare(d["k2u"], tensor(words), torch.from_numpy(nr))
    assert not bool(r["run_overflow"])
    got = ptp.ReadBatchQuery(port, device="cpu").checksum_query(tensor(words), words,
                                                                 torch.from_numpy(nr))
    assert got == ptp.TwoPhaseIndexQuery(port, device="cpu").checksum_query(tensor(words))


@pytest.mark.parametrize("name", ["direct", "bucket"])
def test_read_batch_query_checksum(name):
    """``ReadBatchQuery.checksum_query`` equals the reference's and the
    port's ``TwoPhaseIndexQuery``'s on a read batch whose 800 padding lanes
    make one run (so the reference's N / 2 run slots suffice), and on a
    power-of-two padded batch, past the reference's run slots."""
    ref, port = pair(name)
    words, nr = read_batch(toy_recipe()[0], ref.k, pad=800, seed=4, pad_runs=False)
    got = ptp.ReadBatchQuery(port, device="cpu").checksum_query(
        tensor(words), words, torch.from_numpy(nr))
    want = mtp.ReadBatchQuery(ref).checksum_query(jnp.asarray(words), words, jnp.asarray(nr))
    assert got == want
    assert got == ptp.TwoPhaseIndexQuery(port, device="cpu").checksum_query(tensor(words))
    assert got[1] > 0
    words, nr = read_batch(toy_recipe()[0], ref.k, pad=300, seed=5)
    got = ptp.ReadBatchQuery(port, device="cpu").checksum_query(
        tensor(words), words, torch.from_numpy(nr))
    assert got == ptp.TwoPhaseIndexQuery(port, device="cpu").checksum_query(tensor(words))


def test_refused_layouts():
    """Run sharing reads a direct SSHash's inline or fixedcap rows, as the
    reference's asserts: fixedcap rows equal the reference's run sharing
    (at a budget it does not overflow); fixedcap2 rows raise by name, as
    do inline2 rows and a fast32 index."""
    ref, port = pair("direct")
    words, nr = read_batch(toy_recipe()[0], port.k, n=256)
    fw, nrt = tensor(words), torch.from_numpy(nr)
    host = ref.device_arrays(fused=True, pos_kind="fixedcap")["k2u"]
    want = m_runshare(jax.device_put(host), jnp.asarray(words), jnp.asarray(nr), jnp,
                      budget_div=1)
    got = sshash_k2u_reads_runshare(
        arrays_from_numpy(port.device_arrays(fused=True, pos_kind="fixedcap"), "cpu")["k2u"],
        fw, nrt)
    assert set(got) == set(want)
    for key in want:
        assert_same(got[key], np.asarray(want[key]), key)
    _, shallow = pair("bucket")  # skew 2: fixedcap2's count fits its 3 bits
    d = arrays_from_numpy(shallow.device_arrays(fused=True, pos_kind="fixedcap2"), "cpu")["k2u"]
    with pytest.raises(ValueError, match="fixedcap2"):
        sshash_k2u_reads_runshare(d, fw, nrt)
    d2 = arrays_from_numpy(port.device_arrays(pos_kind="inline2"), "cpu")["k2u"]
    with pytest.raises(ValueError, match="inline rows"):
        sshash_k2u_reads_runshare(d2, fw, nrt)
    _, fast = build_mphf_pair(toy_recipe())
    d3 = arrays_from_numpy(fast.device_arrays(), "cpu")["k2u"]
    with pytest.raises(ValueError, match="direct-engine"):
        sshash_k2u_reads_runshare(d3, fw, nrt)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", ["direct", "bucket"])
def test_runshare_fixedcap_matches_reference(name, fused):
    """Run sharing on fixedcap rows: each run reads its bucket's B =
    ``meta.cap`` rows and has B occurrences, a heavy bucket is slot 0's
    marker. Equal to the reference's at a budget it does not overflow
    (``budget_div=1``), key for key, and to the main probe's four fields
    and ``use_skew`` on the same rows."""
    ref, port = pair(name)
    words, nr = read_batch(toy_recipe()[0], ref.k, pad=300)
    host = ref.device_arrays(fused=fused, pos_kind="fixedcap")
    want = m_runshare(jax.device_put(host["k2u"]), jnp.asarray(words), jnp.asarray(nr), jnp,
                      budget_div=1)
    d = arrays_from_numpy(port.device_arrays(fused=fused, pos_kind="fixedcap"), "cpu")
    fw, nrt = tensor(words), torch.from_numpy(nr)
    got = sshash_k2u_reads_runshare(d["k2u"], fw, nrt)
    assert not bool(want["run_overflow"]) and set(got) == set(want)
    for key in want:
        assert_same(got[key], np.asarray(want[key]), key)
    main = psshash.sshash_k2u(d["k2u"], fw, mode="main")
    for key in ("unitig_id", "unitig_len", "pos", "mt", "use_skew"):
        assert torch.equal(got[key], main[key]), key
    assert bool(got["use_skew"].any()) and int((got["mt"] > 0).sum()) > N // 2


@pytest.mark.parametrize("name", ["direct", "bucket"])
def test_read_batch_query_fixedcap(name):
    """``ReadBatchQuery`` over a ``QueryIndex`` of fused fixedcap rows; its
    checksum equals ``TwoPhaseIndexQuery``'s on the same layout and on the
    default one."""
    _, port = pair(name)
    words, nr = read_batch(toy_recipe()[0], port.k, pad=300, seed=6)
    fw, nrt = tensor(words), torch.from_numpy(nr)
    rb = ptp.ReadBatchQuery(QueryIndex(arrays_from_numpy(
        port.device_arrays(fused=True, pos_kind="fixedcap"), "cpu")))
    assert rb.index.arrays()["k2u"]["meta"].pos_kind == "fixedcap"
    got = rb.checksum_query(fw, words, nrt)
    tp = ptp.TwoPhaseIndexQuery(port, device="cpu", pos_kind="fixedcap")
    assert got == tp.checksum_query(fw)
    assert got[0] == ptp.TwoPhaseIndexQuery(port, device="cpu").checksum_query(fw)[0]
