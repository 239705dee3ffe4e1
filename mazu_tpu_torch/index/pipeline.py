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
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from ..ops.compact import flagged_lanes
from .modindex import QueryIndex, get_ref_pos_compact, get_ref_pos_padded
from .twophase import TwoPhaseIndexQuery, _host, _merge_lists

ROLL_STEP = 40009  # chunk i of a rolled pass is roll(work, i * ROLL_STEP)


class Captured:
    """One captured pass: its input buffer, its graph, its output tensor,
    and what the capture cost (seconds, and bytes of the graph's memory
    pool as ``torch.cuda.memory_reserved`` grew)."""

    def __init__(self, inp, graph, out, capture_s: float, pool_bytes: int):
        self.inp, self.graph, self.out = inp, graph, out
        self.capture_s, self.pool_bytes = capture_s, pool_bytes


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
        t0 = time.perf_counter()
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
        return Captured(inp, graph, out, time.perf_counter() - t0,
                        torch.cuda.memory_reserved(dev) - reserved)


def _use_graph(graph: bool, x: torch.Tensor) -> bool:
    """A pass runs as a CUDA graph where the caller asks for one and its
    input lies on the card."""
    return graph and x.is_cuda


def replay(index: QueryIndex, key, x: torch.Tensor, fn) -> torch.Tensor:
    """``fn(x)`` as a CUDA graph over ``index``'s buffers: captured on the
    first call for ``key`` and ``x``'s shape and dtype, replayed after. The
    result is the graph's output tensor, which the next replay overwrites."""
    key = (key, tuple(x.shape), x.dtype)
    g = index.graphs.get(key)
    if g is None:
        g = index.graphs[key] = capture(fn, x)
    g.inp.copy_(x)
    g.graph.replay()
    return g.out


class OneGraphIndexQuery:
    """Exact for every lane unless a chunk overflows a capacity (``m2``,
    ``m2b``, or the middle phase's residue ``m2c``): then the pass raises,
    since the lanes past it went unresolved.

    ``probe_limit``, ``m2b``, ``defer_valid``, ``mphf_level_limit``,
    ``probe_limit2`` and ``m2c`` are passed to ``get_ref_pos_compact`` (the
    SSHash capacity settings); a mono2 KCDict ignores ``probe_limit``.
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
        ``merge=False`` result."""
        m_, ov = out["main"], out["overflow"]
        s = (
            torch.where(m_["valid"], m_["ref_pos"], 0).sum()
            + torch.where(m_["valid"], m_["ref_id"], 0).sum()
            + torch.where(~ov, m_["unitig_id"], 0).sum()
            + torch.where(~ov, m_["pos"], 0).sum()
        )
        blocks = [("phase2", "slot_real")]
        if "phase2b" in out:
            blocks.append(("phase2b", "slot_real_b"))
        for pk, sk in blocks:
            p2, sr = out[pk], out[sk]
            v2 = p2["valid"] & sr[:, None]
            s = s + (
                torch.where(v2, p2["ref_pos"], 0).sum()
                + torch.where(v2, p2["ref_id"], 0).sum()
                + torch.where(sr, p2["unitig_id"], 0).sum()
                + torch.where(sr, p2["pos"], 0).sum()
            )
        return s

    @staticmethod
    def _counts(out: dict) -> torch.Tensor:
        """(n_ovf, n_ovf_b, residue over m2c) of one chunk, on the device."""
        n = out["n_ovf"]
        zero = torch.zeros_like(n)
        return torch.stack([
            n, out.get("n_ovf_b", zero), out.get("over_budget_c", zero > 0).to(n.dtype)
        ])

    def _run(self, chunks) -> torch.Tensor:
        """int64 [4] on the device: the pass checksum and the worst
        (n_ovf, n_ovf_b, residue over m2c) over ``chunks``."""
        arrays = self.index.arrays()
        tot = worst = 0
        for chunk in chunks:
            out = get_ref_pos_compact(arrays, chunk, self.max_occs, **self.query_kw)
            tot = tot + self.checksum(out)
            worst = torch.clamp(self._counts(out), min=worst)
        return torch.cat([tot.reshape(1), worst])

    def _rolled(self, work: torch.Tensor) -> torch.Tensor:
        return self._run(torch.roll(work, i * ROLL_STEP) for i in range(self.CH))

    def _pass(self, kind: str, fn, x: torch.Tensor):
        if _use_graph(self.graph, x):
            key = (kind, self.CH, self.max_occs, tuple(sorted(self.query_kw.items())))
            return self._finish(replay(self.index, key, x, fn))
        return self._finish(fn(x))

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
        tot, wa, wb, wc = res.tolist()
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
