"""The port's direct-engine SSHash against mazu_tpu's, with tolerance 0:
the mix32 canonical minimizer (bit-63 words, k in {21, 31}, w in {11, 15}),
the build's device arrays byte for byte (the ``_toy_index`` recipe with its
cuckoo skew table, and the bounded-bucket skew table forced by patching
both packages' cuckoo placement away), ``sshash_k2u`` in main mode (bpos at
probe limits 1-3, and the middle phase's limit 4 without bpos) and full
mode (probe_start 0 and 2), the kernel K2's plain version against the
Pallas kernel in interpret mode, and the kernel wrapper's layout checks."""

import numpy as np
import pytest
import torch

import mazu_tpu.kphf.sshash as msshash
import mazu_tpu_torch.kphf.sshash as psshash
from mazu_tpu.index.modindex import build_useqrec as m_build_useqrec
from mazu_tpu.kmer import canonical_minimizer_batch as m_minimizer
from mazu_tpu.kmer import revcomp as m_revcomp
from mazu_tpu.kmer import word_equivalency as m_word_equivalency

from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index.modindex import build_useqrec
from mazu_tpu_torch.kmer import canonical_minimizer_batch, revcomp, word_equivalency
from mazu_tpu_torch.ops import bpos_probe

from torch_fixtures import assert_same, build_capacity_pair, capacity_queries, same_tree, tensor, toy_recipe

LAYOUT = dict(prefix_kind="grouped16", pos_kind="packed", bucket_inline=True)


@pytest.mark.parametrize("k,w", [(21, 11), (21, 15), (31, 11), (31, 15)])
def test_canonical_minimizer_batch(k, w):
    rng = np.random.default_rng(k * 100 + w)
    x = rng.integers(0, 1 << 64, 20_000, dtype=np.uint64)
    x[:10_000] &= np.uint64((1 << (2 * k)) - 1)  # k-mer words; the rest carry bit 63
    want = m_minimizer(np, x, k, w, 0, ordering="mix32")
    got = canonical_minimizer_batch(tensor(x), k, w, 0)
    for g, wnt, what in zip(got, want, ("mm", "offset", "is_fw", "canon")):
        assert_same(g, wnt, what)


def test_word_equivalency():
    rng = np.random.default_rng(4)
    k = 31
    fw = rng.integers(0, 1 << 62, 3000, dtype=np.uint64)
    rc = m_revcomp(fw, k)
    target = np.where(rng.random(3000) < 0.3, fw, np.where(rng.random(3000) < 0.5, rc, fw ^ 1))
    target[:5] |= np.uint64(3) << np.uint64(62)  # bits above 2k are ignored
    assert_same(revcomp(tensor(fw), k), rc, "revcomp")
    assert_same(word_equivalency(tensor(fw), tensor(rc), tensor(target), k),
                m_word_equivalency(fw, rc, target, k), "mt")


@pytest.fixture(scope="module")
def toy():
    import __graft_entry__ as g

    return g._toy_index()


def _pair(toy, skew_kind, monkeypatch=None):
    if skew_kind == "bucket":
        monkeypatch.setattr(msshash.SSHash, "_place_skew_cuckoo", staticmethod(lambda *a, **kw: None))
        monkeypatch.setattr(psshash.SSHash, "_place_skew_cuckoo", staticmethod(lambda *a, **kw: None))
    return build_capacity_pair(toy_recipe(toy))


@pytest.fixture(scope="module", params=["cuckoo", "bucket"])
def pair(request, toy):
    with pytest.MonkeyPatch.context() as mp:
        ref, port = _pair(toy, request.param, mp)
    want = ref.k2u.device_arrays(**LAYOUT)
    want["us"]["useqrec"] = m_build_useqrec(ref.u2pos, ref.k2u.unitigs)
    got = port.k2u.device_arrays(**LAYOUT)
    got["us"]["useqrec"] = build_useqrec(port.u2pos, port.k2u.unitigs)
    assert want["meta"].skew_kind == request.param
    work = capacity_queries(ref.k2u.unitigs, 3000, seed=3)
    return ref, port, want, got, work


@pytest.mark.parametrize("key", ["us", "meta", "pos", "prefix", "bpos", "skew_inline", "skew_prefix2"])
def test_direct_build_arrays(pair, key):
    ref, port, want, got, _ = pair
    assert (key in got) == (key in want)
    if key in want:
        same_tree(got[key], want[key], key)


def test_direct_build_host_fields(pair):
    ref, port, *_ = pair
    np.testing.assert_array_equal(port.k2u.occs_prefix_sum, ref.k2u.occs_prefix_sum)
    assert port.k2u.direct_T == ref.k2u.direct_T
    assert port.k2u.probe_bound() == ref.k2u.probe_bound()
    assert port.k2u.n_kmers_in_skew_index == ref.k2u.n_kmers_in_skew_index > 0


@pytest.mark.parametrize(
    "kw",
    [dict(mode="main", probe_limit=p) for p in (1, 2, 3, 4)]
    + [dict(mode="full"), dict(mode="full", probe_start=2)],
    ids=["main1", "main2", "main3", "main4", "full", "full_start2"],
)
def test_sshash_k2u(pair, kw):
    ref, port, want_d, got_d, work = pair
    want = msshash.sshash_k2u(want_d, work, np, **kw)
    got = psshash.sshash_k2u(arrays_from_numpy(got_d, "cpu"), tensor(work), **kw)
    assert set(got) == set(want)
    for key in want:
        assert_same(got[key], want[key], key)
    assert (np.asarray(want["mt"]) > 0).any()
    if kw["mode"] == "main":
        assert np.asarray(want["use_skew"]).any() and np.asarray(want["unresolved"]).any()


@pytest.mark.parametrize("budget", [1, 3000, 7000])
@pytest.mark.parametrize("kw", [dict(mode="full"), dict(mode="main", probe_limit=4)],
                         ids=["full", "main4"])
def test_sshash_k2u_row_blocks(pair, monkeypatch, kw, budget):
    """The probe loop gives the same answer whatever its block size: one
    row per block (budget 1), two, or the whole loop at once."""
    ref, port, want_d, got_d, work = pair
    monkeypatch.setattr(psshash, "ROW_BUDGET", budget)
    want = msshash.sshash_k2u(want_d, work, np, **kw)
    got = psshash.sshash_k2u(arrays_from_numpy(got_d, "cpu"), tensor(work), **kw)
    for key in want:
        assert_same(got[key], want[key], key)


def test_full_mode_is_exact(pair):
    """Full mode finds every indexed k-mer at its own unitig and offset."""
    ref, port, _, got_d, _ = pair
    us = ref.k2u.unitigs
    kpos = us.kmer_start_positions()
    words = us.get_kmer_u64(kpos)
    r = psshash.sshash_k2u(arrays_from_numpy(got_d, "cpu"), tensor(m_revcomp(words, us.k)))
    uid = us.pos_to_id(kpos)
    assert (r["mt"].numpy() > 0).all()
    np.testing.assert_array_equal(r["unitig_id"].numpy(), uid)
    np.testing.assert_array_equal(r["pos"].numpy(), kpos - us.accum[uid])


KEYS_USREC = ("unitig_id", "unitig_len", "pos", "mt", "use_skew", "unresolved",
              "occ_word", "occ_word2", "occ_cnt")


@pytest.mark.parametrize("plim", [1, 2, 3])
def test_k2_plain_matches_pallas_interpret(pair, plim):
    """K2's plain version (the wrapper on CPU tensors) against the Pallas
    kernel run by the TPU interpreter, on the committed capacity layout."""
    import jax.numpy as jnp

    from mazu_tpu.ops.pallas_capacity import pallas_bpos_usrec_k2u

    ref, port, want_d, got_d, work = pair
    want = pallas_bpos_usrec_k2u(want_d, jnp.asarray(work), plim, interpret=True)
    got = bpos_probe.bpos_usrec_k2u(arrays_from_numpy(got_d, "cpu"), tensor(work), plim)
    for key in KEYS_USREC:
        g, w = got[key].numpy(), np.asarray(want[key])
        if w.dtype == np.uint64:
            g = g.view(np.uint64)
        np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=key)
    assert got["use_skew"].any() and got["unresolved"].any() and (got["mt"] > 0).any()


def test_k2_wrapper_checks_layout(pair):
    ref, port, _, got_d, work = pair
    d = arrays_from_numpy(got_d, "cpu")
    fw = tensor(work)
    assert bpos_probe.check_layout(d, fw, 2) == min(2, d["meta"].probe_bound)
    with pytest.raises(ValueError, match="probe_limit"):
        bpos_probe.check_layout(d, fw, 4)
    big = {**d, "us": {**d["us"], "meta": d["us"]["meta"].replace(total_len=1 << 31)}}
    with pytest.raises(ValueError, match="2\\^31"):
        bpos_probe.check_layout(big, fw, 2)
    with pytest.raises(ValueError, match="bpos"):
        bpos_probe.check_layout({**d, "bpos": d["bpos"][:, :3].contiguous()}, fw, 2)
    with pytest.raises(ValueError, match="no bpos probe"):
        bpos_probe.bpos_usrec_k2u(d, fw.to("meta"), 2)
    # the kernel's records: each padded to one 64-byte row, made once per
    # records tensor and again after it is written in place
    rec = d["us"]["useqrec"].clone()
    pad = bpos_probe.padded_records(rec)
    assert pad.shape == (rec.shape[0], 8) and pad.data_ptr() % 64 == 0
    assert torch.equal(pad[:, :7], rec) and not bool(pad[:, 7].any())
    assert bpos_probe.padded_records(rec) is pad
    rec[0, 0] += 1
    again = bpos_probe.padded_records(rec)
    assert again is not pad and torch.equal(again[:, :7], rec)


def test_port_layouts_not_ported_raise(pair):
    ref, port, *_ = pair
    with pytest.raises(ValueError, match="the port has no"):
        port.k2u.device_arrays(prefix_kind="flat32", pos_kind="packed")
    with pytest.raises(ValueError, match="the port has no"):
        port.k2u.device_arrays(prefix_kind="grouped16", pos_kind="inline")
    with pytest.raises(ValueError, match="the port has no"):
        psshash.SSHash.from_unitig_set(port.k2u.unitigs, 15, engine="parity", device="cpu")
