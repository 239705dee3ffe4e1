"""The rest of the driver layer against mazu_tpu's, with tolerance 0:
``PipelinedIndexQuery.query_batches`` (with a partial final group) and its
``get_ref_pos_eager``; ``get_ref_pos_csr`` with ``total`` above and below
the budget on both occurrence encodings; ``index_metadata`` with and
without decoys and sequences, with ``SeqVector.to_str``; ``ModIndex``'s
host methods: the size properties, ``make_query_fn``, ``unitigs_on_ref``
against ``iter_unitigs_on_ref`` on an index whose unitigs tile its
references, and ``get_ref_pos_eager``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mazu_tpu.index.modindex as mmi
import mazu_tpu.index.pipeline as mpl
from mazu_tpu.bits.seqvector import SeqVector as MSeqVector
from mazu_tpu.containers.refseq import RefSeqCollection as MRefs

from mazu_tpu_torch.bits.seqvector import SeqVector
from mazu_tpu_torch.containers.refseq import RefSeqCollection
from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index import modindex as pmi, pipeline as ppl
from mazu_tpu_torch.index.modindex import QueryIndex
from mazu_tpu_torch.index.unitig_table import decode_occs
from mazu_tpu_torch.pytree import meta

from torch_fixtures import (
    assert_same, build_capacity_pair, build_pair, build_pf1_pair, capacity_queries, queries, tensor,
    toy_recipe,
)

K = 21


def _revcomp(s: str) -> str:
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def tiled_recipe(seed: int = 11):
    """Four unitigs and four references with their sequences: reference 0
    is unitigs 0, 1 and 2 overlapping by k - 1 bases; reference 1 is
    unitig 1 reverse-complemented, reference 2 unitig 3, reference 3
    unitig 1 again (three occurrences)."""
    rng = np.random.default_rng(seed)

    def rand(n):
        return "".join(rng.choice(list("ACGT"), n))

    a = rand(150)
    b = a[-(K - 1):] + rand(110)
    c = b[-(K - 1):] + rand(100)
    d = rand(90)
    refs = [a + b[K - 1:] + c[K - 1:], _revcomp(b), d, b]
    occ = np.array([(0, 0, 0, 1), (1, 0, len(a) - (K - 1), 1),
                    (2, 0, len(a) + len(b) - 2 * (K - 1), 1), (1, 1, 0, 0), (3, 2, 0, 1),
                    (1, 3, 0, 1)], dtype=np.int64)
    return [a, b, c, d], refs, occ


def build_tiled_pair():
    """(mazu_tpu, port) ModIndexes of ``tiled_recipe``: a mono2 KCDict over
    a piscem occurrence table, the references with their sequences."""
    from mazu_tpu.containers.unitig_set import UnitigSet as MUnitigs
    from mazu_tpu.index.spt import SPT as MSPT
    from mazu_tpu.kphf.kcdict import KCDict as MKCDict

    from mazu_tpu_torch.containers.unitig_set import UnitigSet
    from mazu_tpu_torch.index.spt import SPT
    from mazu_tpu_torch.kphf.kcdict import KCDict

    seqs, refs, occ = tiled_recipe()
    lens = np.array([len(r) for r in refs], dtype=np.int64)
    names = [f"chr{i}" for i in range(len(refs))]
    prefix = np.concatenate([[0], np.cumsum(lens)])
    cols = tuple(occ[:, i] for i in range(4))
    mus = MUnitigs.from_seqs(seqs, K)
    mu2 = MSPT(mus, names, *cols, lens).piscem_table()
    ref = mmi.ModIndex(MKCDict.from_unitig_set(mus, occ_table=mu2, scheme="mono2", load=0.25),
                       mu2, MRefs(MSeqVector.from_str("".join(refs)), prefix, names), "t")
    pus = UnitigSet.from_seqs(seqs, K)
    pu2 = SPT(pus, names, *cols, lens).piscem_table()
    port = pmi.ModIndex(KCDict.from_unitig_set(pus, pu2, load=0.25), pu2,
                        RefSeqCollection(SeqVector.from_str("".join(refs)), prefix, names), "t")
    return ref, port


@pytest.fixture(scope="module")
def toy():
    import __graft_entry__ as g

    return g._toy_index()


@pytest.fixture(scope="module")
def tiled():
    return build_tiled_pair()


# ------------------------------------------------------ PipelinedIndexQuery

BATCH, CH = 512, 4


@pytest.fixture(scope="module", params=["mono2", "direct_records"])
def pipelined(request, toy):
    """(reference PipelinedIndexQuery, port PipelinedIndexQuery, batches);
    on the capacity layout the reference runs over the port's layout."""
    if request.param == "mono2":
        ref, port = build_pair(toy_recipe(toy))
        want_pq = mpl.PipelinedIndexQuery(ref, BATCH, n_chunks=CH)
        got_pq = ppl.PipelinedIndexQuery(port, BATCH, n_chunks=CH, device="cpu")
        make = queries
    else:
        ref, port = build_capacity_pair(toy_recipe(toy))
        layout = dict(prefix_kind="grouped16", pos_kind="packed", bucket_inline=True,
                      useqrec=True)
        want_pq = mpl.PipelinedIndexQuery(ref, BATCH, n_chunks=CH)
        want_pq.tp.arrays = jax.device_put(ref.device_arrays(**layout))
        qi = QueryIndex(arrays_from_numpy(port.device_arrays(**layout), "cpu"))
        got_pq = ppl.PipelinedIndexQuery(qi, BATCH, n_chunks=CH)
        make = capacity_queries
    batches = [make(ref.k2u.unitigs, BATCH, seed=s) for s in range(CH + 1)]
    return ref, want_pq, got_pq, batches


def _same_rows(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for key in want:
        assert_same(torch.from_numpy(got[key]), want[key], f"{what}/{key}")


@pytest.mark.parametrize("n_batches", [CH, CH - 1, 1], ids=["full", "partial", "one"])
def test_pipelined_query_batches(pipelined, n_batches):
    ref, want_pq, got_pq, batches = pipelined
    want_m, want_o = want_pq.query_batches(batches[:n_batches])
    got_m, got_o = got_pq.query_batches(batches[:n_batches])
    assert len(got_m) == len(got_o) == n_batches
    for i in range(n_batches):
        _same_rows(got_m[i], want_m[i], f"main {i}")
        (gl, gr), (wl, wr) = got_o[i], want_o[i]
        np.testing.assert_array_equal(gl, wl)
        assert gl.dtype == wl.dtype and len(wl) > 0
        _same_rows(gr, wr, f"overflow {i}")


def test_pipelined_eager_lists(pipelined):
    ref, want_pq, got_pq, batches = pipelined
    got = got_pq.get_ref_pos_eager(batches[-1])
    assert got == want_pq.get_ref_pos_eager(batches[-1]) == ref.get_ref_pos_eager(batches[-1])


def test_pipelined_checks_its_inputs(pipelined):
    ref, want_pq, got_pq, batches = pipelined
    with pytest.raises(ValueError, match="takes"):
        got_pq.query_batches(batches[:1] * (CH + 1))
    with pytest.raises(ValueError, match="hold"):
        got_pq.query_batches([batches[0][:-1]])
    small = ppl.PipelinedIndexQuery(got_pq.tp.index, BATCH, n_chunks=CH, m2=1)
    with pytest.raises(RuntimeError, match="capacity"):
        small.query_batches(batches[:1])


# ----------------------------------------------------------- get_ref_pos_csr


@pytest.fixture(scope="module", params=["piscem", "pf1"])
def csr_case(request, toy):
    if request.param == "piscem":
        ref, port = build_pair(toy_recipe(toy))
        host = ref.device_arrays(fused=True)
    else:
        (ref, port), _ = build_pf1_pair(toy_recipe(toy))
        host = ref.device_arrays()
    d = arrays_from_numpy(port.device_arrays(), "cpu")
    work = queries(ref.k2u.unitigs, 700, seed=12)
    total = int(np.asarray(mmi.get_ref_pos_padded(host, work, np, ref.max_occs())["n_occs"]).sum())
    return host, d, work, total


@pytest.mark.parametrize("extra", [7, 0, -100], ids=["above", "exact", "below"])
def test_get_ref_pos_csr(csr_case, extra):
    host, d, work, total = csr_case
    budget = total + extra
    want = mmi.get_ref_pos_csr(host, work, np, budget)
    got = pmi.get_ref_pos_csr(d, tensor(work), budget)
    assert set(got) == set(want)
    for key in want:
        assert_same(got[key], want[key], key)
    assert int(got["total"]) == total
    assert int(got["valid"].sum()) == min(total, budget)
    if extra > 0:
        assert bool((got["ref_id"][~got["valid"]] == -1).all())


def test_decode_occs_names_missing_tables():
    u2 = {"meta": meta(enc="wm", n_occs=1)}
    with pytest.raises(ValueError, match="wm.*A2"):
        decode_occs(u2, torch.zeros(1, dtype=torch.int64))


# ------------------------------------------------------------ index_metadata


@pytest.mark.parametrize("decoys", [0, 1, 2])
@pytest.mark.parametrize("with_seq", [True, False], ids=["seqs", "lengths"])
def test_index_metadata(tiled, decoys, with_seq):
    ref, port = tiled
    if with_seq:
        mrefs, prefs = ref.refs, port.refs
    else:
        lens = np.diff(port.refs.prefix_sum)
        mrefs = MRefs.from_lens(lens, ref.refs.names)
        prefs = RefSeqCollection.from_lens(lens, port.refs.names)
    for flags in (dict(), dict(have_edge_vec=True, keep_duplicates=True)):
        want = mmi.index_metadata(mrefs, decoys=decoys, **flags)
        got = pmi.index_metadata(prefs, decoys=decoys, **flags)
        assert got == want
    assert (got["decoy_seq_hash"] != "") == (with_seq and decoys > 0)


def test_seqvector_to_str(tiled):
    ref, port = tiled
    n = port.refs.seq.length
    for lo, hi in ((0, None), (0, 31), (5, 77), (n - 40, n), (10, 10)):
        assert port.refs.seq.to_str(lo, hi) == ref.refs.seq.to_str(lo, hi)


# ------------------------------------------------------- ModIndex host methods


def test_modindex_sizes(tiled):
    ref, port = tiled
    for name in ("k", "n_kmers", "n_unitigs", "n_refs", "ref_names"):
        assert getattr(port, name) == getattr(ref, name), name


def test_unitigs_on_ref_equals_walk(tiled):
    ref, port = tiled
    seen_reverse = False
    for ri in range(port.n_refs):
        walk = list(port.iter_unitigs_on_ref(ri))
        assert walk == list(ref.iter_unitigs_on_ref(ri))
        tiles = port.unitigs_on_ref(ri)
        want = ref.unitigs_on_ref(ri)
        assert len(walk) == len(tiles["unitig_id"]) > 0
        for key in ("unitig_id", "unitig_len", "pos", "o"):
            assert [c[key] for c in walk] == tiles[key].tolist(), (ri, key)
            assert tiles[key].tolist() == np.asarray(want[key]).tolist(), (ri, key)
        seen_reverse |= any(c["o"] == 0 for c in walk)
    assert seen_reverse and len(list(port.iter_unitigs_on_ref(0))) == 3


def test_modindex_get_ref_pos_eager(tiled, toy):
    for ref, port in (tiled, build_pair(toy_recipe(toy))):
        work = queries(ref.k2u.unitigs, 400, seed=13)
        got = port.get_ref_pos_eager(work)
        assert got == ref.get_ref_pos_eager(work)
        assert any(h is None for h in got) and any(h is not None and len(h) == 3 for h in got)


def test_make_query_fn(tiled):
    ref, port = tiled
    work = queries(ref.k2u.unitigs, 300, seed=14)
    _, want_fn = ref.make_query_fn()
    qi, fn = port.make_query_fn(device="cpu")
    assert isinstance(qi, QueryIndex)
    want = {kk: np.asarray(v) for kk, v in want_fn(jnp.asarray(work)).items()}
    got = fn(tensor(work))
    assert set(got) == set(want)
    for key in want:
        assert_same(got[key], want[key], key)
