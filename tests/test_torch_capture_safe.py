"""What keeps a pass capturable as one CUDA graph, checked on CPU tensors:
one chunk of each ``OneGraphIndexQuery`` path (mono2 KCDict; direct SSHash
with window records, and without records through K3's plain version and
the offsets projection; fast32 SSHash; the direct SSHash's speed tier,
fused inline2 rows), ``ReadBatchQuery``'s run-sharing phase 1 and a chunk
of ``checksum_padded_rolled``
(pufferfish dense and sparse) and of the serve pass (``serve_chunk``, on
a packed batch with and without non-ACGT bases) runs under a
``TorchDispatchMode`` that
records every aten call. Inside the chunk loop nothing may read a value
back to the host (``_local_scalar_dense``, ``item``), size a tensor by its
data (``nonzero``, boolean-mask indexing) or build a tensor from host data
(``lift_fresh``, a host copy that fails under capture). The BooPHF lookups
build their level offsets once per index, not per call. A ``QueryIndex``
drops its graphs when its buffers move, and the replay logic (one input
buffer and one output a graph, captured once per kind and shape) gives
the eager pass's checksums with a stand-in for the capture."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mazu_tpu_torch import synth
from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index import pipeline
from mazu_tpu_torch.index.modindex import QueryIndex
from mazu_tpu_torch.index.pipeline import OneGraphIndexQuery
from mazu_tpu_torch.kphf.boophf import boophf_lookup
from mazu_tpu_torch.kphf.boophf32 import boophf32_lookup, level_offsets

from torch_fixtures import (
    build_capacity_pair, build_mphf_pair, build_pair, build_pf1_pair, capacity_queries, queries,
    tensor, toy_recipe,
)

N = 1024
FORBIDDEN = ("aten._local_scalar_dense", "aten.item", "aten.nonzero", "aten.lift_fresh")
PACKED = dict(prefix_kind="grouped16", pos_kind="packed")


class HostGuard(TorchDispatchMode):
    """Records each aten call; ``bad`` lists those that sync with the host,
    take their size from the data or build a tensor from host data."""

    def __init__(self):
        super().__init__()
        self.ops, self.bad = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        self.ops.append(name)
        if name in FORBIDDEN:
            self.bad.append(name)
        if name in ("aten.index", "aten.index_put", "aten.index_put_"):
            idx = args[1] if len(args) > 1 else ()
            if any(isinstance(t, torch.Tensor) and t.dtype == torch.bool for t in idx or ()):
                self.bad.append(f"{name} with a boolean mask")
        return func(*args, **(kwargs or {}))


def guarded(run):
    """``run()`` once to make the index's derived tensors, then under a
    ``HostGuard``; returns the guard."""
    run()
    with HostGuard() as guard:
        run()
    return guard


@pytest.fixture(scope="module")
def toy():
    import __graft_entry__ as g

    return g._toy_index()


def _compact_case(toy, name):
    if name == "mono2":
        ref, port = build_pair(toy_recipe(toy))
        return QueryIndex(arrays_from_numpy(port.device_arrays(), "cpu")), \
            queries(ref.k2u.unitigs, N, seed=1), {}
    if name == "speed":
        ref, port = build_capacity_pair(toy_recipe(toy))
        qi = QueryIndex(arrays_from_numpy(port.device_arrays(**synth.SPEED_LAYOUT), "cpu"))
        return qi, capacity_queries(ref.k2u.unitigs, N, seed=1), dict(probe_limit=2)
    if name.startswith("direct"):
        ref, port = build_capacity_pair(toy_recipe(toy))
        layout = dict(PACKED, bucket_inline=True, useqrec=True) if name == "direct_records" \
            else PACKED
    else:
        ref, port = build_mphf_pair(toy_recipe(toy))
        layout = dict(PACKED, uproj=True)
    qi = QueryIndex(arrays_from_numpy(port.device_arrays(**layout), "cpu"))
    kw = dict(probe_limit=2, defer_valid=True, probe_limit2=4, m2b=N, m2c=N)
    if name == "fast32":
        kw["mphf_level_limit"] = 4
    return qi, capacity_queries(ref.k2u.unitigs, N, seed=1), kw


@pytest.mark.parametrize("name", ["mono2", "direct_records", "direct_bare", "fast32", "speed"])
def test_compact_chunk_stays_on_device(toy, name):
    qi, work, kw = _compact_case(toy, name)
    og = OneGraphIndexQuery(qi, N, n_chunks=1, m2=N, **kw)
    fw = tensor(work)
    guard = guarded(lambda: og._rolled(fw))
    assert not guard.bad, guard.bad
    assert "aten.roll" in guard.ops and "aten.cumsum" in guard.ops
    # on CPU tensors the graph's default runs the eager pass
    eager = OneGraphIndexQuery(qi, N, n_chunks=1, m2=N, graph=False, **kw)
    assert og.checksum_pass_rolled(fw) == eager.checksum_pass_rolled(fw)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_padded_chunk_stays_on_device(toy, kind):
    dense, sparse = build_pf1_pair(toy_recipe(toy))
    ref, port = dense if kind == "dense" else sparse
    qi = QueryIndex(arrays_from_numpy(port.device_arrays(), "cpu"))
    work = tensor(queries(ref.k2u.unitigs, N, seed=2))
    guard = guarded(lambda: pipeline._padded_pass(qi, work, 1))
    assert not guard.bad, guard.bad
    assert pipeline.checksum_padded_rolled(qi, work, 2) == \
        pipeline.checksum_padded_rolled(qi, work, 2, graph=False)


def test_runshare_main_phase_stays_on_device(toy):
    """``ReadBatchQuery``'s phase 1 (run sharing, the fused projection, the
    checksum and the overflow flags) on a read batch of the speed tier's
    fused inline rows."""
    from mazu_tpu_torch.index.twophase import ReadBatchQuery
    from mazu_tpu_torch.index.validate import valid_kmer_windows

    _, port = build_capacity_pair(toy_recipe(toy))
    rb = ReadBatchQuery(port, device="cpu")
    words, flags = [], []
    for s in toy_recipe(toy)[0]:
        w = valid_kmer_windows(s[:120], port.k)[1]
        words.append(w)
        flags.append(np.arange(len(w)) == 0)
    fw = tensor(np.concatenate(words))
    nr = torch.from_numpy(np.concatenate(flags))
    guard = guarded(lambda: rb.main_chk(fw, nr))
    assert not guard.bad, guard.bad
    assert "aten.cummax" in guard.ops and "aten.scatter_reduce" in guard.ops


def test_boophf_lookups_build_no_host_tensor_per_call(toy):
    """The level offsets are made once per words tensor, with the meta's
    values; later lookups copy nothing from the host."""
    (_, dense), _ = build_pf1_pair(toy_recipe(toy))
    _, mphf = build_mphf_pair(toy_recipe(toy))
    keys = tensor(np.random.default_rng(3).integers(0, 1 << 62, 4096, dtype=np.uint64))
    tables = (
        (boophf_lookup, arrays_from_numpy(dense.k2u.mphf.device_arrays(), "cpu")),
        (boophf32_lookup, arrays_from_numpy(mphf.k2u.mphf.device_arrays(), "cpu")),
    )
    for lookup, d in tables:
        guard = guarded(lambda: lookup(d, keys))
        assert not guard.bad, (lookup.__name__, guard.bad)
        offs = level_offsets(d)
        assert offs.tolist() == [list(d["meta"].word_offsets), list(d["meta"].rank_offsets)]
        assert level_offsets(d) is offs


def test_query_index_drops_graphs_when_it_moves(toy):
    _, port = build_pair(toy_recipe(toy))
    qi = QueryIndex(arrays_from_numpy(port.device_arrays(), "cpu"))
    assert qi.graphs == {}
    qi.graphs["pass"] = object()
    qi.to("cpu")
    assert qi.graphs == {}
    qi.graphs["pass"] = object()
    qi.cpu()
    assert qi.graphs == {}


def test_synth_mono2_pass_stays_on_device():
    """The chip check's mono2 path at a small size: the whole rolled pass
    of two chunks."""
    index = synth.build_index(4 * synth.PIECE, seed=0)
    qi = QueryIndex(arrays_from_numpy(index.device_arrays(), "cpu"))
    work = tensor(synth.sample_queries_truth(index.k2u.unitigs, N, seed=1)[0])
    og = OneGraphIndexQuery(qi, N, n_chunks=2, m2=N)
    guard = guarded(lambda: og._rolled(work))
    assert not guard.bad, guard.bad


class _StandIn:
    """A captured pass without CUDA: ``replay`` runs the pass again over
    the same input buffer and writes the same output tensor."""

    def __init__(self, fn, inp, out):
        self.fn, self.inp, self.out = fn, inp, out
        self.replays = 0

    def replay(self):
        self.out.copy_(self.fn(self.inp))
        self.replays += 1


def _stand_in_capture(fn, x):
    inp = x.clone()
    out = fn(inp)
    return pipeline.Captured(inp, _StandIn(fn, inp, out), out, 0.0, 0)


def test_replay_reuses_one_graph_a_kind(toy, monkeypatch):
    monkeypatch.setattr(pipeline, "_use_graph", lambda graph, x: graph)
    monkeypatch.setattr(pipeline, "capture", _stand_in_capture)
    qi, work, kw = _compact_case(toy, "fast32")
    og = OneGraphIndexQuery(qi, N, n_chunks=2, m2=N, **kw)
    eager = OneGraphIndexQuery(qi, N, n_chunks=2, m2=N, graph=False, **kw)
    rng = np.random.default_rng(5)
    for _ in range(2):
        fw = tensor(rng.permutation(work))
        assert og.checksum_pass_rolled(fw) == eager.checksum_pass_rolled(fw)
        stack = torch.stack([fw, fw.flip(0)])
        assert og.checksum_pass(stack) == eager.checksum_pass(stack)
        assert pipeline.checksum_padded_rolled(qi, fw, 2) == \
            pipeline.checksum_padded_rolled(qi, fw, 2, graph=False)
    graphs = list(qi.graphs.values())
    assert len(graphs) == 3 and all(g.graph.replays == 2 for g in graphs)
    qi.to("cpu")
    assert qi.graphs == {}


@pytest.mark.parametrize("with_n", [False, True])
def test_serve_chunk_stays_on_device(with_n, tmp_path):
    """One chunk of the serve pass on the buffer a graph captures: device
    k-merization (with bad bases, the stable sort that moves the valid
    windows left), the compact query, the checksum, the merge and the
    bitset reduction."""
    from mazu_tpu_torch.index.pseudoalign import color_bitsets
    from mazu_tpu_torch.io.reads import pack_reads

    from mazu_tpu_torch.synth import serve_reads

    from torch_fixtures import seq_recipe, with_refs, write_fasta

    recipe, seqs = seq_recipe()
    write_fasta(tmp_path / "refs.fa", seqs)
    _, port = with_refs(build_pair(recipe), tmp_path / "refs.fa")
    qi = QueryIndex(arrays_from_numpy(port.device_arrays(), "cpu"))
    cb = arrays_from_numpy(color_bitsets(port.color_classes()), "cpu")
    reads = serve_reads(port.refs, 64, seed=3, n_share=0.2 if with_n else 0.0,
                        foreign_share=0.1)
    packed = pack_reads(reads, 31)
    assert packed["meta"].has_bad == with_n
    flat = torch.from_numpy(pipeline.serve_buffer(packed))
    m = packed["meta"]
    guard = guarded(lambda: pipeline.serve_chunk(
        qi.arrays(), cb, pipeline._unserve(flat, m), 32, 32, qi.max_occs, 1024))
    assert not guard.bad, guard.bad
    assert ("aten.sort" in guard.ops) == with_n
