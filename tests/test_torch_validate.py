"""The validation oracles of the port against mazu_tpu's, with tolerance 0:
``windows_from_codes``/``valid_kmer_windows``; ``validate_self``,
``validate_ckmers``, ``validate_fasta`` and ``validate_k2u_self`` pass on a
sound index (mono2 KCDict and capacity SSHash, through the exact padded
query and through ``get_ref_pos_compact``) and raise the reference's
``AssertionError`` text on an index with one corrupted occurrence (and,
for the K2U check, a corrupted answer); ``merge_sharded_out``."""

import numpy as np
import pytest
import torch

from mazu_tpu.index import validate as mv
from mazu_tpu.kmer import seq_to_codes

from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index import validate as pv
from mazu_tpu_torch.index.modindex import (
    QueryIndex, get_ref_pos_compact, get_ref_pos_padded, k2u_batch,
)

from torch_fixtures import (
    build_capacity_pair, build_pair, seq_recipe, write_fasta, with_refs,
)

CAP_LAYOUT = dict(prefix_kind="grouped16", pos_kind="packed", bucket_inline=True, useqrec=True)
CORRUPT = 5  # the reference whose own occurrence moves by one base


def _pair(kind, tmp, corrupt: bool):
    recipe, seqs = seq_recipe()
    if corrupt:
        seqs_, k, (uid, ref, pos, o), lens = recipe
        pos = pos.copy()
        pos[CORRUPT] += 1
        recipe = (seqs_, k, (uid, ref, pos, o), lens)
    write_fasta(tmp / "refs.fa", seqs)
    build = build_pair if kind == "mono2" else build_capacity_pair
    return with_refs(build(recipe), tmp / "refs.fa")


def _arrays(port, kind):
    return arrays_from_numpy(port.device_arrays(**({} if kind == "mono2" else CAP_LAYOUT)), "cpu")


def _query_fn(port, kind, query):
    """The compact query, or for the SSHash the padded one on its capacity
    layout (the port has no SSHash default layout yet); None: the default."""
    if query == "padded" and kind == "mono2":
        return None
    d = _arrays(port, kind)
    mo = QueryIndex(d).max_occs
    if query == "padded":
        return lambda w: get_ref_pos_padded(d, w, mo)
    kw = {} if kind == "mono2" else dict(probe_limit=2)
    return lambda w: get_ref_pos_compact(d, w, mo, merge=True, m2=w.shape[0], **kw)


def _k2u_fn(port, kind):
    if kind == "mono2":
        return None
    d = _arrays(port, kind)
    return lambda w: k2u_batch(d, w)


@pytest.fixture(scope="module", params=["mono2", "capacity"])
def sound(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sound")
    return request.param, tmp, _pair(request.param, tmp, False)


@pytest.fixture(scope="module", params=["mono2", "capacity"])
def corrupt(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("corrupt")
    return request.param, tmp, _pair(request.param, tmp, True)


def test_windows():
    rng = np.random.default_rng(3)
    for n in (0, 30, 31, 32, 200):
        s = "".join(rng.choice(list("ACGTN"), n, p=[0.24, 0.24, 0.24, 0.24, 0.04]))
        for k in (21, 31):
            for g, w in zip(pv.valid_kmer_windows(s, k), mv.windows_from_codes(seq_to_codes(s), k)):
                np.testing.assert_array_equal(g, w)
                assert g.dtype == w.dtype
            for g, w in zip(pv.windows_from_codes(seq_to_codes(s), k),
                            mv.valid_kmer_windows(s, k)):
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("query", ["padded", "compact"])
def test_validate_passes(sound, query):
    kind, tmp, (ref, port) = sound
    fn = _query_fn(port, kind, query)
    mv.validate_self(ref)
    pv.validate_self(port, query_fn=fn, device="cpu")
    pv.validate_self(port, query_fn=fn, chunk=1000, device="cpu")
    mv.validate_fasta(ref, str(tmp / "refs.fa"))
    pv.validate_fasta(port, str(tmp / "refs.fa"), query_fn=fn, device="cpu")
    seq = ref.refs.ref_seq_str(3)
    seq = seq[:100] + "N" + seq[101:]
    mv.validate_ckmers(ref, 3, seq)
    pv.validate_ckmers(port, 3, seq, query_fn=fn, chunk=64, device="cpu")


def test_validate_k2u_passes(sound):
    kind, tmp, (ref, port) = sound
    mv.validate_k2u_self(ref.k2u)
    pv.validate_k2u_self(port.k2u, _k2u_fn(port, kind), device="cpu")
    pv.validate_k2u_self(port.k2u, _k2u_fn(port, kind), chunk=999, device="cpu")


def _same_failure(want_call, got_call):
    with pytest.raises(AssertionError) as want:
        want_call()
    with pytest.raises(AssertionError) as got:
        got_call()
    assert str(got.value) == str(want.value)
    return str(got.value)


@pytest.mark.parametrize("query", ["padded", "compact"])
def test_validate_raises_on_corrupt_occurrence(corrupt, query):
    kind, tmp, (ref, port) = corrupt
    fn = _query_fn(port, kind, query)
    msg = _same_failure(lambda: mv.validate_self(ref),
                        lambda: pv.validate_self(port, query_fn=fn, chunk=777, device="cpu"))
    assert msg.startswith(f"validate_self: no matching MappedRefPos for true +ve k-mer in ref "
                          f"{CORRUPT} @ pos 0")
    _same_failure(lambda: mv.validate_fasta(ref, str(tmp / "refs.fa")),
                  lambda: pv.validate_fasta(port, str(tmp / "refs.fa"), query_fn=fn,
                                            device="cpu"))
    seq = ref.refs.ref_seq_str(CORRUPT)
    _same_failure(lambda: mv.validate_ckmers(ref, CORRUPT, seq),
                  lambda: pv.validate_ckmers(port, CORRUPT, seq, query_fn=fn, device="cpu"))


def test_validate_k2u_raises_on_corrupt_answer(sound):
    kind, tmp, (ref, port) = sound
    d = _arrays(port, kind)
    host = ref.k2u.device_arrays()
    from mazu_tpu.index.modindex import k2u_batch as m_k2u_batch

    def bad_port(w):
        r = dict(k2u_batch(d, w))
        r["pos"] = r["pos"].clone()
        r["pos"][w.shape[0] // 2] += 1
        return r

    def bad_ref(w):
        r = {kk: np.asarray(v).copy() for kk, v in m_k2u_batch({"k2u": host}, w, np).items()}
        r["pos"][len(w) // 2] += 1
        return r

    msg = _same_failure(lambda: mv.validate_k2u_self(ref.k2u, bad_ref, chunk=1000),
                        lambda: pv.validate_k2u_self(port.k2u, bad_port, chunk=1000,
                                                     device="cpu"))
    assert msg.startswith("k2u self-validation failed at global kmer 500:")


def test_merge_sharded_out():
    rng = np.random.default_rng(9)
    n_data, per, m2 = 4, 64, 8
    N = n_data * per
    main = {kk: rng.integers(0, 1000, N) for kk in ("unitig_id", "unitig_len", "pos")}
    main["mt"] = rng.integers(0, 3, N).astype(np.uint8)
    lanes = np.concatenate([rng.choice(per, m2, replace=False) for _ in range(n_data)])
    out = {
        "main": main,
        "lanes": lanes,
        "slot_real": rng.random(n_data * m2) < 0.6,
        "n_ovf": rng.integers(0, m2, n_data),
        "phase2": {kk: (rng.integers(0, 1000, n_data * m2) if kk != "mt"
                        else rng.integers(0, 3, n_data * m2).astype(np.uint8))
                   for kk in main},
    }
    want = mv.merge_sharded_out(out)
    got = pv.merge_sharded_out({**out, "main": {kk: torch.from_numpy(v)
                                                for kk, v in main.items()}})
    for kk in want:
        np.testing.assert_array_equal(got[kk], want[kk])
        assert got[kk].dtype == want[kk].dtype
