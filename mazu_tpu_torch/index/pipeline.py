"""Whole-pass drivers (counterparts of ``mazu_tpu.index.pipeline``).

``OneGraphIndexQuery`` runs CH query chunks through
``get_ref_pos_compact(merge=False)`` and reduces each with ``checksum``.
The sum and the worst per-chunk counts (overflow, type-B overflow, residue
over capacity) stay on the device until the pass ends: one host sync per
pass.

``checksum_padded_rolled`` is the one-phase pass of ``bench.py``'s full
mode (its lines 625-628): ``get_ref_pos_padded`` per chunk and
``padded_checksum``, the path of the pufferfish indexes.

On a CUDA index each pass is one CUDA graph (``replay``): the reference's
contract of one dispatch and one readback a pass. The first pass of a kind
and shape runs once eagerly on a side stream, which builds the kernels'
libraries, loads their modules and makes the tensors the wrappers derive
from the index (``ops.derived``), then is captured with
``torch.cuda.CUDAGraph``; later passes copy their input into the graph's
buffer and replay it. The graph holds the addresses of the index's buffers,
so it lives in ``QueryIndex.graphs``, which a move of the index empties. A
kernel wrapper's ``LAUNCHES`` counts its Python calls, so the warm-up and
the captured launches count once each and a replay adds nothing. A failed
capture raises; nothing falls back to the eager pass, which stays as the
oracle (``graph=False``) and is what runs on CPU tensors.

``PipelinedIndexQuery`` gives the reference's split results of several
batches: every main phase, then one compacted phase 2 a batch.

``RunServePass`` is the device half of ``bench.py::run_serve``: packed
reads k-merized on the device, mapped exactly, checksummed and
pseudoaligned, chunk by chunk, as one CUDA graph a pass; a pass object
holds at most two graphs (with and without non-ACGT bases) and drops them
when it goes.
"""

from __future__ import annotations

import gc
import weakref

import numpy as np
import torch

from .. import trace
from ..io.reads import kmerize_device, pad_reads, row_shape
from ..ops import occ_csr
from ..ops.compact import flagged_lanes
from .modindex import QueryIndex, get_ref_pos_compact, get_ref_pos_padded, merge_compact_k2u
from .pseudoalign import pseudoalign_from_k2u
from .twophase import TwoPhaseIndexQuery, _host, _merge_lists

ROLL_STEP = 40009  # chunk i of a rolled pass is roll(work, i * ROLL_STEP)


class Captured:
    """One captured pass: its input buffer, its graph, its output tensor,
    and what the capture cost (seconds, and bytes of the graph's memory
    pool as ``torch.cuda.memory_reserved`` grew), both read from its
    ``graph.capture`` span (``span``). A marked pass (``trace.staged``)
    keeps the events its graph records in ``marks``."""

    marks = ()

    def __init__(self, inp, graph, out, capture_s: float, pool_bytes: int, span=None):
        self.inp, self.graph, self.out = inp, graph, out
        self.capture_s, self.pool_bytes = capture_s, pool_bytes
        self.span = span


def capture(fn, x: torch.Tensor) -> Captured:
    """``fn`` (a function of one CUDA tensor returning one tensor) run once
    eagerly on a side stream over a copy of ``x``, then captured over that
    copy. A capture that fails raises with the CUDA error.

    Python's garbage is collected before the capture and the collector is
    off while it runs: a collection inside a capture can destroy a CUDA
    graph or free another CUDA resource, which invalidates the capture, and
    ``torch.cuda.graph`` no longer collects on entry."""
    dev = x.device
    with torch.cuda.device(dev):
        inp = x.clone()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(inp)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        with trace.timed("graph.capture") as sp:
            graph = torch.cuda.CUDAGraph()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph):
                    out = fn(inp)
            finally:
                if collecting:
                    gc.enable()
            torch.cuda.synchronize(dev)
        pool = torch.cuda.memory_reserved(dev) - reserved
        sp.set(seconds=sp.seconds, pool_bytes=pool)
        trace.count("graph.captures")
        return Captured(inp, graph, out, sp.seconds, pool, span=sp)


def _use_graph(graph: bool, x: torch.Tensor) -> bool:
    """A pass runs as a CUDA graph where the caller asks for one and its
    input lies on the card."""
    return graph and x.is_cuda


def _graph_key(key, x: torch.Tensor) -> tuple:
    """A graph's key in ``QueryIndex.graphs``: the caller's ``key``,
    ``x``'s shape and dtype, and a flag where the pass is marked
    (``trace.staged``), whose graph records its device stages."""
    full = (key, tuple(x.shape), x.dtype)
    return full + ("marked",) if trace.staged() else full


def replay(index: QueryIndex, key, x: torch.Tensor, fn) -> torch.Tensor:
    """``fn(x)`` as a CUDA graph over ``index``'s buffers: captured on the
    first call for ``key`` and ``x``'s shape and dtype, replayed after. The
    result is the graph's output tensor, which the next replay overwrites."""
    full = _graph_key(key, x)
    g = index.graphs.get(full)
    if g is None:
        marked = trace.collecting(fn)
        g = index.graphs[full] = capture(marked, x)
        g.marks = getattr(marked, "marks", ())
        if g.span is not None:
            g.span.set(kind=key[0] if isinstance(key, tuple) else key)
    g.inp.copy_(x)
    g.graph.replay()
    trace.launched(g.marks)
    return g.out


def _run_pass(index: QueryIndex, key, x: torch.Tensor, fn, graph: bool) -> torch.Tensor:
    """``fn(x)``: replayed as a CUDA graph where ``_use_graph``, else run
    eagerly (and marked where ``trace.staged``)."""
    if _use_graph(graph, x):
        return replay(index, key, x, fn)
    marked = trace.collecting(fn)
    out = marked(x)
    trace.launched(getattr(marked, "marks", ()))
    return out


def replay_latest(index: QueryIndex, family: tuple, key, x: torch.Tensor, fn) -> torch.Tensor:
    """``replay`` that holds one graph for ``family`` (a prefix of the
    tuple ``key``): a graph of the family captured for another key or shape
    is dropped first, so a caller whose batches change shape holds one
    graph's memory pool, not one a shape, and pays a capture at each change."""
    full = _graph_key(key, x)
    for old in [g for g in index.graphs if g != full and g[0][:len(family)] == family]:
        del index.graphs[old]
    return replay(index, key, x, fn)


class OneGraphIndexQuery:
    """Exact for every lane unless a chunk overflows a capacity (``m2``,
    ``m2b``, the middle phase's residue ``m2c``, or a ragged phase 2's
    ``occ_budget``): then the pass raises, since the lanes past it went
    unresolved.

    ``probe_limit``, ``m2b``, ``defer_valid``, ``mphf_level_limit``,
    ``probe_limit2`` and ``m2c`` are passed to ``get_ref_pos_compact`` (the
    SSHash capacity settings; ``m2c`` also sizes a ragged phase 2's
    residue, whose budget of occurrences is ``occ_csr.budget``'s default);
    a mono2 KCDict ignores ``probe_limit``.
    ``graph``: on a CUDA index, replay each pass as one CUDA graph (see the
    module); False runs it eagerly, the oracle."""

    def __init__(
        self,
        index: QueryIndex,
        batch: int,
        n_chunks: int = 16,
        m2: int | None = None,
        probe_limit: int | None = 2,
        m2b: int | None = None,
        defer_valid: bool = False,
        mphf_level_limit: int | None = None,
        probe_limit2: int | None = None,
        m2c: int | None = None,
        graph: bool = True,
    ):
        self.index = index
        self.graph = bool(graph)
        self.CH = int(n_chunks)
        self.M2 = int(m2 or max(8192, batch // 16))
        self.M2B = int(m2b) if m2b else None
        self.max_occs = index.max_occs
        # the ragged phase 2's budget, where it engages (the unsplit phase)
        self.OCC = (occ_csr.budget(index.arrays(), self.max_occs, self.M2) if self.M2B is None
                    else None)
        self.query_kw = dict(
            merge=False, m2=self.M2, probe_limit=probe_limit, m2b=self.M2B,
            defer_valid=bool(defer_valid), mphf_level_limit=mphf_level_limit,
            probe_limit2=probe_limit2,
            m2c=int(m2c) if m2c else None,
        )

    @staticmethod
    def checksum(out: dict) -> torch.Tensor:
        """int64 sum of ref_pos and ref_id over valid occurrences and of
        unitig_id and pos over resolved lanes, across the main and the
        compacted pieces (``phase2``, and ``phase2b`` when type-split) of a
        ``merge=False`` result. With a ragged ``phase2`` each occurrence
        also adds its orientation and twice its lane's k-mer word, and the
        phase gives its occurrences' share from its flat block
        (``occ_csr.occurrence_sum``)."""
        m_, ov = out["main"], out["overflow"]
        s = (
            torch.where(m_["valid"], m_["ref_pos"], 0).sum()
            + torch.where(m_["valid"], m_["ref_id"], 0).sum()
            + torch.where(~ov, m_["unitig_id"], 0).sum()
            + torch.where(~ov, m_["pos"], 0).sum()
        )
        if "total" in out["phase2"]:
            s = s + torch.where(m_["valid"], m_["orient"] + 2 * out["fw"][:, None], 0).sum()
        blocks = [("phase2", "slot_real")]
        if "phase2b" in out:
            blocks.append(("phase2b", "slot_real_b"))
        for pk, sk in blocks:
            p2, sr = out[pk], out[sk]
            if "total" in p2:
                occs = occ_csr.occurrence_sum(p2, out["fw"][out["lanes"]])
            else:
                v2 = p2["valid"] & sr[:, None]
                occs = torch.where(v2, p2["ref_pos"], 0).sum() + torch.where(v2, p2["ref_id"],
                                                                              0).sum()
            s = s + (
                occs
                + torch.where(sr, p2["unitig_id"], 0).sum()
                + torch.where(sr, p2["pos"], 0).sum()
            )
        return s

    @staticmethod
    def _counts(out: dict) -> torch.Tensor:
        """(n_ovf, n_ovf_b, residue over m2c, a ragged phase 2's occurrence
        total) of one chunk, on the device; 0 where a piece is absent."""
        n = out["n_ovf"]
        zero = torch.zeros_like(n)
        return torch.stack([
            n, out.get("n_ovf_b", zero), out.get("over_budget_c", zero > 0).to(n.dtype),
            out["phase2"].get("total", zero),
        ])

    @staticmethod
    def phase2_counts(out: dict) -> torch.Tensor:
        """int64 [4] of a ``merge=False`` result, on the device: the lanes
        sent to phase 2 (``n_ovf``, plus ``n_ovf_b`` when type-split), the
        phase-2 slots that hold a real occurrence (``valid`` of a real
        slot; a ragged phase 2's ``total``), the real lanes sent on to the
        side table (``side_probes``) and the real residue lanes of a ragged
        phase 2 (``residue``); the last two where a marked pass's result
        holds them, else 0."""
        lanes = out["n_ovf"].to(torch.int64)
        p2 = out["phase2"]
        occs = p2["total"] if "total" in p2 else (p2["valid"] & out["slot_real"][:, None]).sum()
        if "phase2b" in out:
            lanes = lanes + out["n_ovf_b"]
            occs = occs + (out["phase2b"]["valid"] & out["slot_real_b"][:, None]).sum()
        zero = torch.zeros_like(lanes)
        return torch.stack([lanes, occs, out.get("side_probes", zero), out.get("residue", zero)])

    def _run(self, chunks) -> torch.Tensor:
        """int64 [5] on the device: the pass checksum and the worst
        ``_counts`` over ``chunks``; a marked pass
        (``trace.staged``) adds ``phase2_counts`` summed over them."""
        arrays = self.index.arrays()
        staged = trace.staged()
        tot = worst = p2 = 0
        for chunk in chunks:
            out = get_ref_pos_compact(arrays, chunk, self.max_occs, **self.query_kw)
            trace.mark("reduce", chunk)
            tot = tot + self.checksum(out)
            worst = torch.clamp(self._counts(out), min=worst)
            if staged:
                p2 = p2 + self.phase2_counts(out)
        return torch.cat([tot.reshape(1), worst] + ([p2] if staged else []))

    def _rolled(self, work: torch.Tensor) -> torch.Tensor:
        return self._run(torch.roll(work, i * ROLL_STEP) for i in range(self.CH))

    def _pass(self, kind: str, fn, x: torch.Tensor):
        key = (kind, self.CH, self.max_occs, tuple(sorted(self.query_kw.items())))
        with trace.pass_span("query.pass"):
            with trace.span("query.launch"):
                res = _run_pass(self.index, key, x, fn, self.graph)
            with trace.span("query.readback"):
                return self._finish(res)

    def checksum_pass(self, stack: torch.Tensor):
        """One pass over a [CH, batch] stack on the index's device.
        Returns (checksum, worst overflow count), or (checksum, (worst
        type-A, worst type-B)) when the heavy phase is type-split."""
        return self._pass("stack", self._run, stack)

    def checksum_pass_rolled(self, work: torch.Tensor):
        """One pass over CH chunks derived on the device: chunk i is
        ``roll(work, i * ROLL_STEP)``, a permutation of the same multiset.
        Chunk 0 is ``work`` itself, so the pass checksum equals CH times a
        one-chunk oracle's on ``work``. Returns as ``checksum_pass``."""
        return self._pass("rolled", self._rolled, work)

    def _finish(self, res: torch.Tensor):
        vals = res.tolist()
        trace.settle()
        budget = self.OCC
        tot, wa, wb, wc, wo = vals[:5]
        if len(vals) > 5:
            slots = (self.CH * budget if budget
                     else self.CH * (self.M2 + (self.M2B or 0)) * self.max_occs)
            count_phase2(vals[5], vals[6], slots, vals[7], vals[8])
        if budget and wo > budget:
            raise RuntimeError(
                f"occurrence budget exceeded: {wo} occurrences in a chunk (occ_budget={budget}); "
                "the occurrences past it were not written"
            )
        if wc:
            raise RuntimeError(
                "middle-phase residue capacity (m2c) exceeded: results for the lanes past "
                "m2c are unvalidated; rebuild with a larger m2c"
            )
        if wa > self.M2 or (self.M2B is not None and wb > self.M2B):
            raise RuntimeError(
                f"phase-2 capacity exceeded: {wa} overflow lanes (m2={self.M2}), {wb} type-B "
                f"lanes (m2b={self.M2B}); results for the lanes past capacity are unresolved"
            )
        if self.M2B is not None:
            return tot, (wa, wb)
        return tot, wa

    def checksum_host(self, host_index: QueryIndex, stack) -> int:
        """The same computation on a CPU copy of the index (plain torch):
        the parity oracle of a device pass."""
        arrays = host_index.arrays()
        tot = 0
        for chunk in stack:
            out = get_ref_pos_compact(arrays, chunk.cpu(), self.max_occs, **self.query_kw)
            if bool(out["over_budget"]):
                raise RuntimeError("phase-2 capacity exceeded")
            tot += int(self.checksum(out))
        return tot


def count_phase2(lanes: int, occurrences: int, slots: int, side_probes: int,
                 residue: int) -> None:
    """The ``phase2.*`` counters of one marked pass."""
    trace.count("phase2.lanes", lanes)
    trace.count("phase2.occurrences", occurrences)
    trace.count("phase2.slots", slots)
    trace.count("phase2.side_probes", side_probes)
    trace.count("phase2.residue", residue)


def padded_checksum(out: dict) -> torch.Tensor:
    """int64 sum of ref_pos and ref_id over every padded slot and of
    unitig_id and pos over every lane of a ``get_ref_pos_padded`` result
    (``bench.py``'s full-mode checksum)."""
    return out["ref_pos"].sum() + out["ref_id"].sum() + out["unitig_id"].sum() + out["pos"].sum()


def checksum_padded_rolled(index: QueryIndex, work: torch.Tensor, n_chunks: int,
                           graph: bool = True) -> int:
    """One pass of ``n_chunks`` chunks ``roll(work, i * ROLL_STEP)`` through
    ``get_ref_pos_padded`` on the index's device, one host sync at the end
    (on a CUDA index one CUDA graph unless ``graph`` is False; see the
    module). A lane's outputs depend on its word alone, so the pass
    checksum equals ``n_chunks`` times ``padded_checksum`` of ``work``'s
    result."""
    n_chunks = int(n_chunks)

    def run(w: torch.Tensor) -> torch.Tensor:
        return _padded_pass(index, w, n_chunks)

    if _use_graph(graph, work):
        return int(replay(index, ("padded", n_chunks), work, run))
    return int(run(work))


def _padded_pass(index: QueryIndex, work: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """The checksum of ``checksum_padded_rolled``'s chunks, on the device."""
    arrays = index.arrays()
    tot = torch.zeros((), dtype=torch.int64, device=work.device)
    for i in range(n_chunks):
        out = get_ref_pos_padded(arrays, torch.roll(work, i * ROLL_STEP), index.max_occs)
        tot = tot + padded_checksum(out)
    return tot


_PHASE2_FIELDS = ("unitig_id", "unitig_len", "pos", "mt", "n_occs", "ref_id", "ref_pos",
                  "orient", "valid")


class PipelinedIndexQuery:
    """Split two-phase results of up to ``n_chunks`` equal batches
    (``mazu_tpu.index.pipeline.PipelinedIndexQuery``'s results; its
    tunnel-shaped pipelining and delta-coded lane upload are not ported):
    every batch's main phase, the overflow lanes of each compacted on the
    device into ``m2`` slots, the counts read back once, then one phase 2
    a batch. ``index``, ``probe_limit`` and ``device`` are as for
    ``TwoPhaseIndexQuery``: an SSHash comes as a ``QueryIndex`` of the
    layout it is queried in."""

    def __init__(self, index, batch: int, n_chunks: int = 8, m2: int | None = None,
                 probe_limit: int | None = 1, device=None):
        self.batch = int(batch)
        self.CH = int(n_chunks)
        self.M2 = int(m2 or max(8192, -(-batch // 8 // 8192) * 8192))
        self.tp = TwoPhaseIndexQuery(index, probe_limit=probe_limit, device=device)
        self.max_occs = self.tp.max_occs

    def query_batches(self, batches: list):
        """(mains, overflows) of up to ``n_chunks`` batches of ``batch``
        words, host arrays: ``mains[i]`` is batch i's main phase (exact
        where not ``overflow``), ``overflows[i]`` = (its overflow lanes,
        the exact padded rows of those lanes)."""
        if len(batches) > self.CH:
            raise ValueError(f"{len(batches)} batches; the query takes {self.CH}")
        if any(len(b) != self.batch for b in batches):
            raise ValueError(f"every batch must hold {self.batch} words")
        if not batches:
            return [], []
        words = np.ascontiguousarray(np.stack(batches).astype(np.uint64, copy=False))
        stack = torch.from_numpy(words.view(np.int64)).to(self.tp.device)
        arrays = self.tp.index.arrays()
        mains = [self.tp.main(chunk) for chunk in stack]
        compact = [flagged_lanes(m["overflow"], self.M2) for m in mains]
        counts = torch.stack([n for _, n in compact]).tolist()
        if max(counts) > self.M2:
            raise RuntimeError(f"phase-2 capacity exceeded: {max(counts)} overflow lanes in a "
                               f"batch (m2={self.M2}); raise m2")
        overflows = []
        for chunk, (lanes, _), n in zip(stack, compact, counts):
            out = get_ref_pos_padded(arrays, chunk[lanes], self.max_occs)
            rows = _host({kk: out[kk][:n] for kk in _PHASE2_FIELDS})
            overflows.append((lanes[:n].cpu().numpy(), rows))
        return [_host(m) for m in mains], overflows

    def get_ref_pos_eager(self, fw_words: np.ndarray) -> list:
        """Per-query hit lists (None for a miss) of one batch: the answer
        shape of ``ModIndex.get_ref_pos_eager``."""
        if len(fw_words) != self.batch:
            raise ValueError(f"the batch must hold {self.batch} words")
        mains, overflows = self.query_batches([fw_words])
        lanes, rows = overflows[0]
        return _merge_lists(mains[0], lanes, rows, self.batch)


def serve_buffer(packed: dict) -> np.ndarray:
    """A ``pack_reads`` dict as one int64 host buffer: the words, the
    lengths, then the bad-base words when the batch has any (the one input
    tensor of a serve pass)."""
    parts = [packed["words"].view(np.int64), packed["lengths"].astype(np.int64)]
    if packed["meta"].has_bad:
        parts.append(packed["bad"].view(np.int64))
    return np.concatenate(parts)


def _unserve(flat: torch.Tensor, m) -> dict:
    """Views of ``serve_buffer``'s parts in a tensor, as ``kmerize_device``
    takes them (lengths stay int64)."""
    nw = m.R * m.stride // 32 + 1
    packed = {"words": flat[:nw], "lengths": flat[nw : nw + m.R], "meta": m}
    if m.has_bad:
        packed["bad"] = flat[nw + m.R :]
    return packed


def serve_chunk(arrays: dict, cb: dict, packed: dict, row_start: int, rows: int, max_occs: int,
                m2: int, probe_limit: int | None = 2, query: dict | None = None) -> torch.Tensor:
    """int64 [6] of reads ``row_start`` .. ``row_start + rows`` of a packed
    batch on ``arrays``' device: map_chk, pa_chk, then
    ``OneGraphIndexQuery._counts`` (n_ovf, 0, 1 where a ragged phase 2's
    residue passed its capacity, its occurrence total), as
    ``bench.py::run_serve`` computes a chunk: ``kmerize_device``,
    ``get_ref_pos_compact(merge=False)`` at ``probe_limit`` and the other
    settings in ``query`` (``defer_valid``, ``mphf_level_limit``,
    ``occ_budget``: the MPHF path's), ``OneGraphIndexQuery.checksum``,
    ``merge_compact_k2u`` and the intersecting ``pseudoalign_from_k2u``
    over the color bitsets ``cb``. pa_chk sums the bitset words' int64 bit
    patterns, which wraps as the reference's u64 sum cast to int64 does,
    plus the reads' hit counts. A marked pass (``trace.staged``) adds three
    more: the phase-2 slots that hold a real occurrence (a ragged phase
    2's total), the phase-2 lanes sent on to the side table and a ragged
    phase 2's real residue lanes."""
    trace.mark("kmerize", packed["words"])
    km, v = kmerize_device(packed, row_start, rows)
    out = get_ref_pos_compact(arrays, km.reshape(-1), max_occs, merge=False, m2=m2,
                              probe_limit=probe_limit, **(query or {}))
    trace.mark("pseudoalign", km)
    bits, n_hit, _ = pseudoalign_from_k2u(cb, merge_compact_k2u(out), v)
    trace.mark("reduce", km)
    res = [OneGraphIndexQuery.checksum(out).reshape(1), (bits.sum() + n_hit.sum()).reshape(1),
           OneGraphIndexQuery._counts(out).to(torch.int64)]
    if trace.staged():
        res.append(OneGraphIndexQuery.phase2_counts(out)[1:])
    return torch.cat(res)


def _drop_graphs(index: QueryIndex, token, kind: str = "serve") -> None:
    """Remove from ``index.graphs`` the ``kind`` graphs keyed by ``token``."""
    for key in [key for key in index.graphs if key[0][:2] == (kind, token)]:
        del index.graphs[key]


class RunServePass:
    """``bench.py::run_serve``'s device pass over one packed batch of
    ``n_chunks * n_reads`` reads: ``serve_chunk`` on each chunk of
    ``n_reads``, on ``index`` (a mono2 KCDict or an SSHash, queried at
    ``probe_limit`` with ``defer_valid`` and ``mphf_level_limit``, as
    ``get_ref_pos_compact`` takes them) and the color bitsets ``bitsets``
    (tensors on the index's device). Exact unless a chunk overflows ``m2``
    or, where phase 2 is ragged (``ops.occ_csr.engages``), its residue
    (``m2 // 4`` lanes) or its budget of ``occ_budget`` occurrences
    (``occ_csr.budget``'s): then the pass raises. ``occ_totals`` holds the
    last pass's occurrence total of each chunk (0 each where phase 2 is
    padded).

    Every batch is laid out for reads of ``read_len`` bases (``pad_reads``:
    run_serve's reads have a fixed length), so its shape is fixed and only
    whether it holds a non-ACGT base varies. A batch with a longer read is
    rejected; one of shorter reads is padded, and its added windows, invalid,
    are queried as run_serve queries the invalid windows of its batch.
    ``graph``: on a CUDA index each pass is one CUDA graph in ``index.graphs``
    keyed by this object and the batch's Meta, of which only ``has_bad``
    varies, so a pass holds at most two graphs, dropped with the pass; False
    runs it eagerly, the oracle."""

    def __init__(self, index: QueryIndex, bitsets: dict, n_reads: int, n_chunks: int, m2: int,
                 read_len: int, probe_limit: int | None = 2, graph: bool = True,
                 defer_valid: bool = False, mphf_level_limit: int | None = None,
                 occ_budget: int | None = None):
        self.index, self.cb = index, bitsets
        self.n_reads, self.CH, self.M2 = int(n_reads), int(n_chunks), int(m2)
        self.read_len = int(read_len)
        self.probe_limit = probe_limit
        self.graph = bool(graph)
        self.occ_budget = occ_csr.budget(index.arrays(), index.max_occs, self.M2, occ_budget)
        self.ragged = self.occ_budget is not None
        self.query = {"defer_valid": bool(defer_valid), "mphf_level_limit": mphf_level_limit,
                      "occ_budget": self.occ_budget}
        self.occ_totals = []
        self._key = object()  # a graph of this pass reads these bitsets
        weakref.finalize(self, _drop_graphs, index, self._key)

    def _run(self, m, flat: torch.Tensor) -> torch.Tensor:
        packed = _unserve(flat, m)
        arrays = self.index.arrays()
        return torch.stack([
            serve_chunk(arrays, self.cb, packed, ci * self.n_reads, self.n_reads,
                        self.index.max_occs, self.M2, self.probe_limit, self.query)
            for ci in range(self.CH)
        ])

    def device_pass(self, flat: torch.Tensor, m) -> torch.Tensor:
        """int64 [CH, 6] (``serve_chunk``'s columns; [CH, 9] in a marked
        pass) of a batch with Meta ``m`` (``pad_reads``'s, to ``read_len``)
        already on the device as one ``serve_buffer``, with no host read; on
        a CUDA index the graph's output, which the next replay
        overwrites."""
        if m.R != self.n_reads * self.CH:
            raise ValueError(f"{m.R} reads; the pass takes {self.CH} x {self.n_reads}")
        if (m.stride, m.L) != row_shape(self.read_len, m.k):
            raise ValueError(f"a batch of stride {m.stride} and L {m.L}; the pass takes reads "
                             f"padded to {self.read_len} bases")

        def run(x: torch.Tensor) -> torch.Tensor:
            return self._run(m, x)

        key = ("serve", self._key, m, self.CH, self.M2, self.probe_limit,
               tuple(sorted(self.query.items())))
        return _run_pass(self.index, key, flat, run, self.graph)

    def __call__(self, packed: dict):
        """(map_chk, pa_chk, n_ovf) lists, one entry a chunk, of a
        ``pack_reads`` dict: padded to ``read_len``, uploaded as one buffer,
        one host read (which also sets ``occ_totals``)."""
        with trace.pass_span("serve.pass"):
            with trace.span("serve.pad"):
                packed = pad_reads(packed, self.read_len)
            with trace.span("serve.buffer"):
                buf = serve_buffer(packed)
            with trace.span("serve.upload"):
                flat = torch.from_numpy(buf).to(self.cb["bitsets"].device)
            with trace.span("serve.launch"):
                res = self.device_pass(flat, packed["meta"])
            with trace.span("serve.readback"):
                cols = res.T.tolist()
                trace.settle()
                maps, pas, n_ovf, _, over_c, self.occ_totals = cols[:6]
                if len(cols) > 6:
                    slots = self.occ_budget if self.ragged else self.M2 * self.index.max_occs
                    count_phase2(sum(n_ovf), sum(cols[6]), self.CH * slots, sum(cols[7]),
                                 sum(cols[8]))
                if max(n_ovf) > self.M2:
                    raise RuntimeError(f"phase-2 capacity exceeded: {max(n_ovf)} overflow lanes "
                                       f"in a chunk (m2={self.M2}); results for the lanes past "
                                       f"it are unresolved")
                if max(over_c):
                    raise RuntimeError("ragged phase-2 residue capacity (a quarter of m2) "
                                       "exceeded: results for the lanes past it are unresolved")
                if self.ragged and max(self.occ_totals) > self.occ_budget:
                    raise RuntimeError(f"occurrence budget exceeded: {max(self.occ_totals)} "
                                       f"occurrences in a chunk (occ_budget={self.occ_budget}); "
                                       "the occurrences past it were not written")
        return maps, pas, n_ovf
