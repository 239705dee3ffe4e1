"""The serve path as a whole against ``bench.py::run_serve``'s host oracle,
with tolerance 0: a seeded gzipped FASTQ file packed by each package
(``pack_fastq``), then per chunk ``kmerize_device``,
``get_ref_pos_compact(merge=False)``, ``OneGraphIndexQuery.checksum``,
``merge_compact_k2u`` and ``pseudoalign_from_k2u`` over
``color_bitsets(index.color_classes())``. The port's ``RunServePass`` runs
eagerly on CPU tensors and must give the reference's (map_chk, pa_chk,
n_ovf) chunk for chunk, on the mono2 KCDict and the capacity SSHash, for a
batch with and without non-ACGT bases. The pass's graph logic runs with a
stand-in for the capture: a pass holds one graph for each of the two kinds
of batch, a batch of shorter reads is padded into the same graph, and the
graphs go with the pass. Its capacity and size checks raise."""

import gc

import numpy as np
import pytest
import torch

import mazu_tpu.index.modindex as mmi
from mazu_tpu.index.pipeline import OneGraphIndexQuery as MOneGraph
from mazu_tpu.index.pseudoalign import color_bitsets as m_color_bitsets
from mazu_tpu.index.pseudoalign import pseudoalign_from_k2u as m_pseudoalign_from_k2u
from mazu_tpu.io.reads import kmerize_device as m_kmerize_device
from mazu_tpu.io.reads import pack_fastq as m_pack_fastq

from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index import pipeline
from mazu_tpu_torch.index.modindex import QueryIndex
from mazu_tpu_torch.index.pipeline import RunServePass, serve_buffer
from mazu_tpu_torch.index.pseudoalign import color_bitsets
from mazu_tpu_torch.io.reads import pack_fastq, pack_reads
from mazu_tpu_torch.synth import READ_LEN, serve_reads, write_fastq

from torch_fixtures import (
    build_capacity_pair, build_pair, same_tree, seq_recipe, tensor, write_fasta, with_refs,
)

N_READS, CH, PLIM = 32, 3, 2
CAP_LAYOUT = dict(prefix_kind="grouped16", pos_kind="packed", bucket_inline=True, useqrec=True)


def _wrap64(x: int) -> int:
    return (x + (1 << 63)) % (1 << 64) - (1 << 63)


def reference_serve(ref, host_arrays, packed, m2: int):
    """``bench.py::run_serve``'s host oracle, chunk by chunk, in mazu_tpu
    with NumPy: (map_chk, pa_chk, n_ovf) lists. pa_chk is the u64 bitset
    sum as int64 plus the hit count, as its device pass gives it."""
    cb = m_color_bitsets(ref.color_classes())
    mo = max(1, ref.max_occs())
    maps, pas, novf = [], [], []
    for ci in range(CH):
        km, v = m_kmerize_device(packed, np, ci * N_READS, N_READS)
        out = mmi.get_ref_pos_compact(host_arrays, km.reshape(-1), np, mo, merge=False,
                                      probe_limit=PLIM, m2=m2)
        assert not bool(out["over_budget"])
        maps.append(int(MOneGraph.checksum(out, np)))
        bits, n_hit, _ = m_pseudoalign_from_k2u(cb, mmi.merge_compact_k2u(out, np), v, np)
        pas.append(_wrap64(int(bits.sum(dtype=np.uint64)) + int(n_hit.sum())))
        novf.append(int(out["n_ovf"]))
    return maps, pas, novf


def _m2_of(ref, host_arrays, packed) -> int:
    """run_serve's M2: chunk 0's overflow count at m2 = max(8192, B0 / 4),
    times 1.4 plus 1024, rounded up to 1024, at least 2048."""
    km, _ = m_kmerize_device(packed, np, 0, N_READS)
    out = mmi.get_ref_pos_compact(host_arrays, km.reshape(-1), np, max(1, ref.max_occs()),
                                  merge=False, probe_limit=PLIM, m2=max(8192, km.size // 4))
    return max(2048, -(-int(int(out["n_ovf"]) * 1.4 + 1024) // 1024) * 1024)


@pytest.fixture(scope="module", params=["mono2", "capacity"])
def served(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"serve_{request.param}")
    recipe, seqs = seq_recipe()
    write_fasta(tmp / "refs.fa", seqs)
    if request.param == "mono2":
        ref, port = with_refs(build_pair(recipe), tmp / "refs.fa")
        host, d = ref.device_arrays(fused=True), port.device_arrays()
    else:
        ref, port = with_refs(build_capacity_pair(recipe), tmp / "refs.fa")
        host, d = ref.device_arrays(**CAP_LAYOUT), port.device_arrays(**CAP_LAYOUT)
    qi = QueryIndex(arrays_from_numpy(d, "cpu"))
    cb = arrays_from_numpy(color_bitsets(port.color_classes()), "cpu")
    return ref, port, host, qi, cb, tmp


def _fastq(port, tmp, with_n: bool) -> str:
    reads = serve_reads(port.refs, CH * N_READS, seed=1, n_share=0.1 if with_n else 0.0)
    path = str(tmp / f"reads_{int(with_n)}.fastq.gz")
    write_fastq(path, reads)
    return path


@pytest.mark.parametrize("with_n", [False, True])
def test_serve_pass_equals_run_serve_oracle(served, with_n):
    ref, port, host, qi, cb, tmp = served
    path = _fastq(port, tmp, with_n)
    want_packed = m_pack_fastq(path, 31)
    packed = pack_fastq(path, 31)
    same_tree(packed, want_packed)
    assert packed["meta"].has_bad == with_n
    m2 = _m2_of(ref, host, want_packed)
    want = reference_serve(ref, host, want_packed, m2)
    got = RunServePass(qi, cb, N_READS, CH, m2, READ_LEN, probe_limit=PLIM,
                       graph=False)(packed)
    assert got == want
    # the traffic takes every path: hits, misses and overflow lanes
    assert all(n > 0 for n in want[2]) and all(p != 0 for p in want[1])


def test_bitset_sum_wraps_as_the_reference_cast():
    """pa_chk's bitset sum: int64 bit patterns summed by torch wrap exactly
    as the reference's u64 sum cast to int64."""
    rng = np.random.default_rng(4)
    words = rng.integers(0, 1 << 64, (2048, 79), dtype=np.uint64) | np.uint64(1 << 63)
    want = np.array(words.sum(dtype=np.uint64)).view(np.int64)
    assert int(words.astype(object).sum()) >= 1 << 64  # the sum does wrap
    assert int(tensor(words.reshape(-1)).sum()) == int(want)


def _stand_in_capture(fn, x):
    inp = x.clone()
    out = fn(inp)

    class Graph:
        replays = 0

        def replay(self):
            out.copy_(fn(inp))
            Graph.replays += 1

    return pipeline.Captured(inp, Graph(), out, 0.0, 0)


def test_serve_graph_a_batch_kind(served, monkeypatch):
    """One graph per pass object and batch kind: the batch with non-ACGT
    bases takes its own, a batch of shorter reads padded to ``read_len``
    the clean batch's; replays equal the eager pass."""
    ref, port, host, qi, cb, tmp = served
    monkeypatch.setattr(pipeline, "_use_graph", lambda graph, x: graph)
    monkeypatch.setattr(pipeline, "capture", _stand_in_capture)
    qi.graphs.clear()
    batches = [pack_fastq(_fastq(port, tmp, with_n), 31) for with_n in (False, True)]
    short = serve_reads(port.refs, CH * N_READS, seed=2, n_share=0.0)
    batches.append(pack_reads([r[: 100 + i % 28] for i, r in enumerate(short)], 31))
    assert batches[2]["meta"].stride < batches[0]["meta"].stride
    m2 = 4096
    graph = RunServePass(qi, cb, N_READS, CH, m2, READ_LEN, probe_limit=PLIM)
    eager = RunServePass(qi, cb, N_READS, CH, m2, READ_LEN, probe_limit=PLIM, graph=False)
    for _ in range(2):
        for packed in batches:
            assert graph(packed) == eager(packed)
    assert len(qi.graphs) == 2
    qi.graphs.clear()


class _NoReplay:
    def replay(self):
        pass


def _capture_holding_nothing(fn, x):
    """A stand-in capture that, as a CUDA graph, keeps no reference to the
    pass it captured."""
    return pipeline.Captured(x.clone(), _NoReplay(), fn(x), 0.0, 0)


def test_serve_pass_drops_its_graphs(served, monkeypatch):
    """A pass's graphs leave ``index.graphs`` when the pass goes; other
    passes' graphs stay."""
    ref, port, host, qi, cb, tmp = served
    monkeypatch.setattr(pipeline, "_use_graph", lambda graph, x: graph)
    monkeypatch.setattr(pipeline, "capture", _capture_holding_nothing)
    qi.graphs.clear()
    other = (("padded", 2), (5,), torch.int64)
    qi.graphs[other] = None
    batches = [pack_fastq(_fastq(port, tmp, with_n), 31) for with_n in (False, True)]
    passes = [RunServePass(qi, cb, N_READS, CH, 4096, READ_LEN, probe_limit=PLIM)
              for _ in range(2)]
    for sp in passes:
        for packed in batches * 2:
            sp(packed)
    assert len(qi.graphs) == 5
    del sp
    passes.pop(0)
    gc.collect()
    assert len(qi.graphs) == 3
    passes.clear()
    assert list(qi.graphs) == [other]
    qi.graphs.clear()


def test_serve_pass_checks(served):
    ref, port, host, qi, cb, tmp = served
    packed = pack_fastq(_fastq(port, tmp, True), 31)
    with pytest.raises(ValueError, match="the pass takes"):
        RunServePass(qi, cb, N_READS + 1, CH, 4096, READ_LEN, graph=False)(packed)
    with pytest.raises(ValueError, match="the batch is padded to 149"):
        RunServePass(qi, cb, N_READS, CH, 4096, READ_LEN - 1, graph=False)(packed)
    sp = RunServePass(qi, cb, N_READS, CH, 4096, READ_LEN + 40, graph=False)
    with pytest.raises(ValueError, match="padded to 190 bases"):
        sp.device_pass(torch.from_numpy(serve_buffer(packed)), packed["meta"])
    with pytest.raises(RuntimeError, match="phase-2 capacity exceeded"):
        RunServePass(qi, cb, N_READS, CH, 16, READ_LEN, probe_limit=PLIM, graph=False)(packed)
    flat = serve_buffer(packed)
    m = packed["meta"]
    assert flat.dtype == np.int64 and len(flat) == len(packed["words"]) + m.R + len(packed["bad"])


def test_synth_serve_reads(tmp_path):
    """The chip check's serve traffic at a small size: whole-genome starts,
    reverse complements, reads with one N and foreign reads, in about the
    stated shares; every other read is the genome's, forward or reverse."""
    from mazu_tpu_torch import synth
    from mazu_tpu_torch.io.fastq import read_fastq

    _, refs, _ = synth.synthetic_spt(6 * synth.PIECE, seed=2)
    reads = synth.serve_reads(refs, 4000, seed=1)
    genome = refs.seq.to_str()
    comp = str.maketrans("ACGT", "TGCA")
    kinds = {"fw": 0, "rc": 0, "n": 0, "foreign": 0}
    for r in reads:
        assert len(r) == synth.READ_LEN
        if "N" in r:
            kinds["n"] += 1
        elif r in genome:
            kinds["fw"] += 1
        elif r.translate(comp)[::-1] in genome:
            kinds["rc"] += 1
        else:
            kinds["foreign"] += 1
    assert 1700 < kinds["fw"] < 2100 and 1700 < kinds["rc"] < 2100
    assert 15 < kinds["n"] < 70 and 140 < kinds["foreign"] < 270
    path = str(tmp_path / "r.fastq.gz")
    synth.write_fastq(path, reads)
    assert [s for _, s in read_fastq(path)] == reads
