"""The port's streaming index against mazu_tpu's, with tolerance 0:
``StreamingIndex`` in its three modes (``host``, ``scan``, ``flat``; the
port with its CUDA graphs asked for and not, which on CPU tensors both run
eagerly) on the mono2, toy, direct SSHash, fast32 SSHash and pufferfish
dense and sparse pairs, the four k2u fields, the occurrence projection of
``get_ref_pos_reads`` and ``last_cold_fraction``; the bare-K2U form;
``k2u_reads_packed``; ``validate_fasta_streaming`` passing and failing
with the reference's text; and reads at the edges (an N restart, all N,
shorter than k, empty, foreign, reverse-complemented).

The reference's ``StreamingIndex`` runs jitted on JAX's CPU, with its
default layouts; the port's SSHash takes the capacity layouts."""

import numpy as np
import pytest

from mazu_tpu.index.streaming import StreamingIndex as MStreamingIndex
from mazu_tpu.index.streaming import kmerize_reads as m_kmerize_reads
from mazu_tpu.index.streaming import validate_fasta_streaming as m_validate
from mazu_tpu.io.reads import pack_reads as m_pack_reads

from mazu_tpu_torch import synth
from mazu_tpu_torch.index import pipeline, streaming
from mazu_tpu_torch.index.streaming import StreamingIndex, kmerize_reads, validate_fasta_streaming
from mazu_tpu_torch.io.reads import pack_reads

from torch_fixtures import (
    build_capacity_pair, build_mphf_pair, build_pair, build_pf1_pair, mono2_recipe, seq_recipe,
    toy_recipe, with_refs, write_fasta,
)

COMP = str.maketrans("ACGT", "TGCA")
MODES = ("host", "scan", "flat")
PAIRS = ("mono2", "toy", "direct", "fast32", "pf1_dense", "pf1_sparse")
LAYOUT = {"direct": synth.CAPACITY_LAYOUT, "fast32": synth.MPHF_LAYOUT}
GRP_KEYS = ("unitig_id", "unitig_len", "pos", "mt", "n_occs", "ref_id", "ref_pos", "orient",
            "valid")
_PAIRS = {}
_REF = {}


def pair(name):
    """(reference ModIndex, port ModIndex, unitig sequences) of a pair."""
    if name not in _PAIRS:
        recipe = mono2_recipe() if name == "mono2" else toy_recipe()
        if name in ("mono2", "toy"):
            ref, port = build_pair(recipe)
        elif name == "direct":
            ref, port = build_capacity_pair(recipe)
        elif name == "fast32":
            ref, port = build_mphf_pair(recipe)
        else:
            dense, sparse = build_pf1_pair(recipe)
            ref, port = dense if name == "pf1_dense" else sparse
        _PAIRS[name] = ref, port, recipe[0]
    return _PAIRS[name]


def edge_reads(seqs, k):
    """The named edge reads over unitig sequences ``seqs``."""
    s = seqs[1]
    rng = np.random.default_rng(9)
    return {
        "n_restart": s[:50] + "N" + s[51:110],
        "all_n": "N" * 40,
        "shorter_than_k": seqs[2][: k - 2],
        "empty": "",
        "foreign": "".join(rng.choice(list("ACGT"), 90)),
        "revcomp": seqs[3][10:100].translate(COMP)[::-1],
    }


def reads_of(seqs, k, seed=5):
    """A random piece of each unitig (40 to 110 bases, half reverse-
    complemented), a whole unitig forward and reversed, then the edge
    reads."""
    rng = np.random.default_rng(seed)
    reads = []
    for s in seqs:
        n = int(rng.integers(40, 111))
        a = int(rng.integers(0, len(s) - n + 1))
        r = s[a : a + n]
        reads.append(r.translate(COMP)[::-1] if rng.random() < 0.5 else r)
    reads += [seqs[0], seqs[0].translate(COMP)[::-1]]
    return reads + list(edge_reads(seqs, k).values())


def reference(name, mode):
    """The reference's ``get_ref_pos_reads`` and cold fraction on a pair's
    reads, computed once."""
    if (name, mode) not in _REF:
        ref, _, seqs = pair(name)
        kms, valid, _ = m_kmerize_reads(reads_of(seqs, ref.k), ref.k)
        si = MStreamingIndex(ref, mode=mode)
        _REF[name, mode] = si.get_ref_pos_reads(kms, valid), si.last_cold_fraction
    return _REF[name, mode]


def same(got: dict, want: dict, keys, what=""):
    for key in keys:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype and g.shape == w.shape, f"{what} {key}: {g.dtype}{g.shape}"
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {key}")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", PAIRS)
def test_modes_match_reference(name, mode):
    """Each mode of the port equals the same mode of the reference: the
    k2u fields, the projection and the cold fraction, with and without the
    graph flag."""
    ref, port, seqs = pair(name)
    want, want_cold = reference(name, mode)
    kms, valid, _ = kmerize_reads(reads_of(seqs, port.k), port.k)
    for graph in (True, False):
        si = StreamingIndex(port, mode=mode, graph=graph, device="cpu", layout=LAYOUT.get(name))
        got = si.get_ref_pos_reads(kms, valid)
        same(got, want, GRP_KEYS, f"{name} {mode} graph={graph}")
        assert si.last_cold_fraction == want_cold
        got = si.k2u_reads(kms, valid)
        same(got, want, ("unitig_id", "unitig_len", "pos", "mt"), f"{name} {mode} k2u")
        assert si.last_cold_fraction == want_cold
    assert 0 < want_cold < 0.2


@pytest.mark.parametrize("name,mode", [("mono2", "host"), ("mono2", "scan"), ("mono2", "flat"),
                                       ("direct", "flat"), ("pf1_dense", "host")])
def test_bare_k2u(name, mode):
    """The K2U alone (no occurrence table): the reference's StreamingK2U
    form; the projection is refused."""
    ref, port, seqs = pair(name)
    kms, valid, _ = kmerize_reads(reads_of(seqs, port.k), port.k)
    a = MStreamingIndex(ref.k2u, mode=mode)
    want = a.k2u_reads(kms, valid)
    layout = {kk: v for kk, v in LAYOUT.get(name, {}).items()
              if kk in ("prefix_kind", "pos_kind", "bucket_inline")}
    si = StreamingIndex(port.k2u, mode=mode, device="cpu", layout=layout)
    same(si.k2u_reads(kms, valid), want, ("unitig_id", "unitig_len", "pos", "mt"), name)
    assert si.last_cold_fraction == a.last_cold_fraction
    with pytest.raises(ValueError, match="occurrence table"):
        si.get_ref_pos_reads(kms, valid)
    if name == "direct":
        with pytest.raises(ValueError, match="useqrec"):
            StreamingIndex(port.k2u, device="cpu", layout=synth.CAPACITY_LAYOUT)


@pytest.mark.parametrize("name", ["mono2", "toy", "fast32"])
def test_packed_equals_matrix(name):
    """``k2u_reads_packed`` of ``pack_reads`` equals ``k2u_reads`` of the
    host k-merization, in any mode, and the reference's packed path."""
    ref, port, seqs = pair(name)
    reads = reads_of(seqs, port.k)
    kms, valid, _ = kmerize_reads(reads, port.k)
    host = StreamingIndex(port, mode="host", device="cpu", layout=LAYOUT.get(name))
    want = host.k2u_reads(kms, valid)
    got = host.k2u_reads_packed(pack_reads(reads, port.k))
    same(got, want, ("unitig_id", "unitig_len", "pos", "mt"), name)
    cold = host.last_cold_fraction
    m = MStreamingIndex(ref, mode="flat")
    same(got, m.k2u_reads_packed(m_pack_reads(reads, ref.k)),
         ("unitig_id", "unitig_len", "pos", "mt"), f"{name} reference")
    assert cold == m.last_cold_fraction


@pytest.fixture(scope="module")
def fasta_pair(tmp_path_factory):
    """A pair whose references carry sequence, and its FASTA file."""
    recipe, seqs = seq_recipe(n_refs=12, length=300)
    fa = tmp_path_factory.mktemp("stream") / "refs.fa"
    write_fasta(fa, seqs)
    ref, port = with_refs(build_pair(recipe), fa)
    return ref, port, str(fa), seqs


@pytest.mark.parametrize("mode", MODES)
def test_validate_fasta_streaming_passes(fasta_pair, mode):
    """Every k-mer of every record maps back to it, in pieces of 100 bases
    (so records span several lanes) and batches of 5 lanes."""
    ref, port, fa, _ = fasta_pair
    m_validate(ref, fa, lanes=5, window=100)
    si = StreamingIndex(port, mode=mode, device="cpu")
    validate_fasta_streaming(si, fa, lanes=5, window=100)
    if mode == "flat":  # the default: flat mode on the given device
        validate_fasta_streaming(port, fa, lanes=5, window=100, device="cpu")


@pytest.mark.parametrize("mode", ["host", "flat"])
def test_validate_fasta_streaming_fails_alike(fasta_pair, tmp_path, mode):
    """A record with two bases changed fails with the reference's text at
    the same reference and position."""
    ref, port, _, seqs = fasta_pair
    bad = list(seqs)
    s = bad[7]
    flip = {"A": "C", "C": "G", "G": "T", "T": "A"}
    bad[7] = s[:150] + flip[s[150]] + s[151:220] + flip[s[220]] + s[221:]
    fa = tmp_path / "bad.fa"
    write_fasta(fa, bad)
    with pytest.raises(AssertionError) as want:
        m_validate(ref, str(fa), lanes=5, window=100)
    with pytest.raises(AssertionError) as got:
        validate_fasta_streaming(StreamingIndex(port, mode=mode, device="cpu"), str(fa), lanes=5,
                                 window=100)
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("streaming: no matching MRP in ref 7 @ pos ")


@pytest.mark.parametrize("edge", list(edge_reads(["A" * 40] * 4, 21)))
def test_edge_reads(edge):
    """Each edge read beside an ordinary one, in every mode, equals the
    reference's flat pass; an all-N, empty or too-short read is a row of
    zeros with no valid window."""
    ref, port, seqs = pair("mono2")
    reads = [seqs[5][:100], edge_reads(seqs, port.k)[edge]]
    kms, valid, _ = kmerize_reads(reads, port.k)
    a = MStreamingIndex(ref, mode="flat")
    want = a.get_ref_pos_reads(kms, valid)
    for mode in MODES:
        si = StreamingIndex(port, mode=mode, device="cpu")
        same(si.get_ref_pos_reads(kms, valid), want, GRP_KEYS, f"{edge} {mode}")
        assert si.last_cold_fraction == a.last_cold_fraction
    if edge in ("all_n", "empty", "shorter_than_k"):
        assert not valid[1].any() and not want["mt"][1].any()
    if edge == "foreign":
        assert not want["mt"][1].any() and valid[1].any()
    if edge == "revcomp":
        assert (want["mt"][1][valid[1]] == 2).all()
    if edge == "n_restart":
        assert valid[1].sum() == 111 - 2 * port.k  # windows before and after the N


class _StandIn:
    """A captured pass without CUDA: ``replay`` runs the pass again over
    the same input buffer into the same output tensors."""

    def __init__(self, fn, inp, out):
        self.fn, self.inp, self.out = fn, inp, out

    def replay(self):
        new = self.fn(self.inp)
        for o, n in zip(_leaves(self.out), _leaves(new)):
            o.copy_(n)


def _leaves(x):
    if isinstance(x, dict):
        return [v for kk in sorted(x) for v in _leaves(x[kk])]
    if isinstance(x, (tuple, list)):
        return [v for e in x for v in _leaves(e)]
    return [x]


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """Graphs asked for on CPU tensors, captured by a stand-in; returns the
    list of captured input shapes."""
    shapes = []

    def capture(fn, x):
        shapes.append(tuple(x.shape))
        inp = x.clone()
        out = fn(inp)
        return pipeline.Captured(inp, _StandIn(fn, inp, out), out, 0.0, 0)

    monkeypatch.setattr(streaming, "_use_graph", lambda graph, x: graph)
    monkeypatch.setattr(pipeline, "capture", capture)
    return shapes


@pytest.mark.parametrize("mode", ["scan", "flat"])
def test_one_graph_a_kind(stand_in_graphs, mode):
    """Batches of several shapes, matrix and packed, leave at most one
    graph of each kind on the index, give the eager pass's results, and a
    repeated shape is replayed without a capture; the graphs go with the
    object."""
    _, port, seqs = pair("mono2")
    reads = reads_of(seqs, port.k)
    qi = StreamingIndex(port, mode="flat", device="cpu").index
    si = StreamingIndex(qi, mode=mode)
    eager = StreamingIndex(qi, mode=mode, graph=False)

    def mine():
        return [key for key in qi.graphs if key[0][:2] == ("stream", si._key)]

    batches = [reads[:7], [r[:60] for r in reads[:9]], reads[:7], reads[3:12]]
    for i, batch in enumerate(batches):
        kms, valid, _ = kmerize_reads(batch, port.k)
        same(si.k2u_reads(kms, valid), eager.k2u_reads(kms, valid),
             ("unitig_id", "unitig_len", "pos", "mt"), f"matrix {i}")
        assert si.last_cold_fraction == eager.last_cold_fraction
        same(si.k2u_reads_packed(pack_reads(batch, port.k)),
             eager.k2u_reads_packed(pack_reads(batch, port.k)),
             ("unitig_id", "unitig_len", "pos", "mt"), f"packed {i}")
        assert sorted(key[0][2] for key in mine()) == sorted(["packed", mode])
    assert len(stand_in_graphs) == 8  # the third batch repeats the first's shape: captured again
    kms, valid, _ = kmerize_reads(batches[-1], port.k)
    si.k2u_reads(kms, valid)
    assert len(stand_in_graphs) == 8  # the shape of the last batch: replayed
    del si
    assert not [key for key in qi.graphs if key[0][0] == "stream"]


def test_validate_fasta_streaming_captures_once(fasta_pair, stand_in_graphs, tmp_path):
    """Records of many lengths, shorter and longer than a window, are
    checked in batches of one shape: one capture, whatever the pieces."""
    _, port, _, seqs = fasta_pair
    cut = [s[: 30 + 23 * i] for i, s in enumerate(seqs)]
    fa = tmp_path / "cut.fa"
    write_fasta(fa, cut)
    qi = StreamingIndex(port, device="cpu").index
    validate_fasta_streaming(StreamingIndex(qi, mode="flat"), str(fa), lanes=4, window=100)
    assert len(set(stand_in_graphs)) == 1 and len(stand_in_graphs) == 1
