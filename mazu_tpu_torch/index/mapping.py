"""Read mapping, the serving driver (counterpart of
``mazu_tpu.index.mapping``): reads -> k-merization in the host library
(``io.native.kmerize_batch``) -> a batched exact query on the card -> each
read's k-mer windows with their reference hits.

``BatchHits`` holds the query results of a flat batch in CSR form (host
NumPy arrays); ``ReadHits`` is one read's view of it. ``CompactQuery`` is
the SSHash capacity-tier driver and ``ReadMapper`` the entry point.

Each dictionary's driver is ``query_driver``'s:

- a mono2 KCDict: ``TwoPhaseIndexQuery``, kernel K1 in its main phase
  (the reference answers it with the eager padded query);
- an SSHash in its speed tier (``tuning.query_tier``: the reference's
  rule, its speed layout fits the device, and the port's probe-bound
  limit): ``TwoPhaseIndexQuery`` on its default layout, as the
  reference's mapper takes it (fused inline rows for a 32-bit engine,
  packed positions with Elias-Fano bounds for parity);
- else, in its capacity tier, a direct SSHash: ``CompactQuery`` on
  ``synth.CAPACITY_LAYOUT`` at probe limit 2 with a middle phase at 4,
  kernel K2 in the main phase;
- else an MPHF SSHash: ``CompactQuery`` on ``synth.MPHF_LAYOUT`` with
  ``synth.MPHF_QUERY``, kernel K3 in a fast32 SSHash's main phase and
  the plain probe in a parity SSHash's (the reference's capacity settings
  were measured on a TPU; these are the port's);
- pufferfish's dense and sparse dictionaries: ``PaddedQuery``.

The results are the same whichever driver answers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..convert import words_to
from .twophase import _host


@dataclass
class BatchHits:
    """CSR hits over a flat batch of k-mer queries. ``mt[i] == 0`` marks a
    miss; the hits of query i are ``ref_id``, ``ref_pos`` and ``orient``
    at ``[offsets[i], offsets[i + 1])``."""

    mt: np.ndarray  # uint8[N] match type (0 = miss)
    offsets: np.ndarray  # int64[N + 1] CSR bounds into the hit arrays
    ref_id: np.ndarray
    ref_pos: np.ndarray
    orient: np.ndarray

    def __len__(self) -> int:
        return len(self.mt)

    @classmethod
    def from_padded(cls, out) -> "BatchHits":
        """CSR compaction of a merged padded result (``mt`` and ``n_occs``
        [N]; ``ref_id``, ``ref_pos``, ``orient`` [N, width])."""
        mt = np.asarray(out["mt"]).astype(np.uint8, copy=False)
        hit = mt > 0
        n = np.where(hit, np.asarray(out["n_occs"], dtype=np.int64), 0)
        offsets = np.zeros(len(mt) + 1, dtype=np.int64)
        np.cumsum(n, out=offsets[1:])
        width = np.asarray(out["ref_id"]).shape[1]
        sel = hit[:, None] & (np.arange(width, dtype=np.int64)[None, :] < n[:, None])
        return cls(mt, offsets, np.asarray(out["ref_id"])[sel], np.asarray(out["ref_pos"])[sel],
                   np.asarray(out["orient"])[sel])

    @classmethod
    def from_twophase(cls, r, lanes, s) -> "BatchHits":
        """Merge of a two-phase result: the main rows ``r`` for lanes not in
        ``lanes``, the phase-2 rows ``s`` (None when ``lanes`` is empty) for
        ``lanes``."""
        N = len(r["mt"])
        mt = np.asarray(r["mt"]).astype(np.uint8, copy=True)
        is_ovf = np.zeros(N, dtype=bool)
        is_ovf[lanes] = True
        n = np.where(~is_ovf & (mt > 0), np.asarray(r["n_occs"], dtype=np.int64), 0)
        if s is not None:
            smt = np.asarray(s["mt"]).astype(np.uint8, copy=False)
            mt[lanes] = smt
            n[lanes] = np.where(smt > 0, np.asarray(s["n_occs"], np.int64), 0)
        offsets = np.zeros(N + 1, dtype=np.int64)
        np.cumsum(n, out=offsets[1:])
        cols = ("ref_id", "ref_pos", "orient")
        hits = {c: np.empty(offsets[-1], dtype=np.asarray(r[c]).dtype) for c in cols}
        jr = np.arange(np.asarray(r["ref_id"]).shape[1], dtype=np.int64)[None, :]
        selr = (~is_ovf & (mt > 0))[:, None] & (jr < n[:, None])
        dest = (offsets[:-1, None] + jr)[selr]
        for c in cols:
            hits[c][dest] = np.asarray(r[c])[selr]
        if s is not None and len(lanes):
            js = np.arange(np.asarray(s["ref_id"]).shape[1], dtype=np.int64)[None, :]
            sels = (smt > 0)[:, None] & (js < n[lanes][:, None])
            dests = (offsets[lanes][:, None] + js)[sels]
            for c in cols:
                hits[c][dests] = np.asarray(s[c])[sels]
        return cls(mt, offsets, *(hits[c] for c in cols))

    @classmethod
    def concat(cls, parts: list) -> "BatchHits":
        if len(parts) == 1:
            return parts[0]
        offs = [parts[0].offsets]
        for p in parts[1:]:
            offs.append(p.offsets[1:] + (offs[-1][-1] - p.offsets[0]))
        return cls(
            np.concatenate([p.mt for p in parts]),
            np.concatenate(offs),
            np.concatenate([p.ref_id for p in parts]),
            np.concatenate([p.ref_pos for p in parts]),
            np.concatenate([p.orient for p in parts]),
        )

    def lane_lists(self, lo: int = 0, hi: int | None = None) -> list:
        """Per-query hit lists of lanes [lo, hi): (ref_id, ref_pos, orient)
        tuples, None for a miss."""
        hi = len(self.mt) if hi is None else hi
        o0, o1 = int(self.offsets[lo]), int(self.offsets[hi])
        rid = self.ref_id[o0:o1].tolist()
        rpo = self.ref_pos[o0:o1].tolist()
        orn = self.orient[o0:o1].tolist()
        out = []
        for i in range(lo, hi):
            if self.mt[i] == 0:
                out.append(None)
                continue
            a, b = int(self.offsets[i]) - o0, int(self.offsets[i + 1]) - o0
            out.append(list(zip(rid[a:b], rpo[a:b], orn[a:b])))
        return out

    def to_lists(self) -> list:
        return self.lane_lists()


class ReadHits:
    """The hits of one read: its valid k-mer windows' positions in the read
    (``read_pos``), and their hits, lanes ``lane_lo`` onward of the batch's
    CSR ``BatchHits``. ``hits`` decodes the per-window lists, (ref_id,
    ref_pos, orient) tuples or None for a miss, at first use. (The
    reference also builds one from such lists; the port's mapper never
    does.)"""

    def __init__(self, read_pos, batch: BatchHits, lane_lo: int):
        self.read_pos = read_pos
        self._hits = None
        self._batch = batch
        self._lo = int(lane_lo)

    @property
    def hits(self) -> list:
        if self._hits is None:
            self._hits = self._batch.lane_lists(self._lo, self._lo + len(self.read_pos))
        return self._hits

    def csr(self):
        """(offsets, ref_id, ref_pos, orient) over this read's windows, the
        offsets rebased to 0."""
        b, lo, hi = self._batch, self._lo, self._lo + len(self.read_pos)
        o = b.offsets[lo : hi + 1]
        return o - o[0], b.ref_id[o[0]:o[-1]], b.ref_pos[o[0]:o[-1]], b.orient[o[0]:o[-1]]

    @property
    def n_kmers(self) -> int:
        return len(self.read_pos)

    @property
    def n_hit(self) -> int:
        lo, hi = self._lo, self._lo + len(self.read_pos)
        return int((self._batch.mt[lo:hi] > 0).sum())


class _Driver:
    """An index's query arrays on a device, and its upload of host words.
    ``query_index``: a ``QueryIndex`` of ``index.device_arrays(**layout)``
    already on its device, queried where it lies; else the arrays go to
    ``device``."""

    def __init__(self, index, layout: dict, device, query_index=None):
        from ..convert import arrays_from_numpy, resolve_device
        from .modindex import QueryIndex

        self.max_occs = max(1, index.max_occs())
        if query_index is not None:
            self.index = query_index
            return
        host = index.device_arrays(**layout)
        self.index = QueryIndex(arrays_from_numpy(host, "cpu")).to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return next(self.index.buffers()).device

    def _words(self, fw_words: np.ndarray) -> torch.Tensor:
        return words_to(fw_words, self.device)

    def get_ref_pos_eager(self, fw_words: np.ndarray) -> list:
        return self.get_ref_pos_batch(fw_words).to_lists()


class CompactQuery(_Driver):
    """The capacity tier's driver: ``get_ref_pos_compact`` with its heavy
    phase type-split, on ``index.device_arrays(**layout)`` on ``device``
    (the card by default), with ``query``'s main and middle probe settings
    (``probe_limit``, ``defer_valid``, ``mphf_level_limit``,
    ``probe_limit2``)."""

    def __init__(self, index, layout: dict, query: dict, device=None, query_index=None):
        super().__init__(index, layout, device, query_index)
        self.query = dict(query)

    def _run(self, fw: torch.Tensor, m2: int, m2c: int | None) -> dict:
        from .modindex import get_ref_pos_compact

        return get_ref_pos_compact(self.index.arrays(), fw, self.max_occs, merge=True, m2=m2,
                                   m2b=m2, m2c=m2c, **self.query)

    def get_ref_pos_batch(self, fw_words: np.ndarray) -> BatchHits:
        """The batch's exact hits in CSR form. Each compacted phase first
        gets N // 4 slots (at least 1024; the residue of the middle phase an
        eighth of that), as the reference budgets it; when a phase had more
        lanes (``over_budget``, one host read), the batch runs again with
        every phase at N slots, which always suffices."""
        n = len(fw_words)
        fw = self._words(fw_words)
        out = self._run(fw, max(1024, n // 4), None)
        if bool(out["over_budget"]):
            m2 = max(1024, n)
            out = self._run(fw, m2, m2)
            if bool(out["over_budget"]):
                raise RuntimeError("over budget with a slot for every lane")
        return BatchHits.from_padded(_host(out))


class PaddedQuery(_Driver):
    """The exact one-phase ``get_ref_pos_padded`` (pufferfish's dense and
    sparse dictionaries), padded to the index's maximum occurrence count."""

    def __init__(self, index, device=None, query_index=None):
        super().__init__(index, {}, device, query_index)

    def get_ref_pos_batch(self, fw_words: np.ndarray) -> BatchHits:
        from .modindex import get_ref_pos_padded

        out = get_ref_pos_padded(self.index.arrays(), self._words(fw_words), self.max_occs)
        return BatchHits.from_padded(_host(out))


# a direct SSHash's main and middle probe settings on the card
CAPACITY_QUERY = dict(probe_limit=2, defer_valid=True, probe_limit2=4)


def layout_tier(m) -> str:
    """The tier whose layout an SSHash's arrays (their meta ``m``) hold:
    the speed tier's inline rows, or a parity SSHash's Elias-Fano bounds;
    else the capacity tier's."""
    if m.pos_kind in ("inline", "inline2") or m.prefix_kind == "ef":
        return "speed"
    return "capacity"


def query_driver(index, device=None, query_index=None, tier: str | None = None):
    """The driver ``ReadMapper`` queries ``index`` with on ``device`` (see
    the module): each has ``get_ref_pos_batch``. ``tier``: an SSHash's,
    ``"speed"`` or ``"capacity"``; None takes ``tuning.query_tier``'s.
    ``query_index``: the index's arrays in the driver's layout, already on
    a device (an SSHash's speed tier: ``TwoPhaseIndexQuery``'s default
    layout; its capacity tier: grouped16 packed positions); a layout of
    the other tier raises."""
    from .. import synth
    from .tuning import query_tier
    from .twophase import TwoPhaseIndexQuery

    k2u = index.k2u
    kind = type(k2u).__name__
    if kind != "SSHash":
        if tier is not None:
            raise ValueError(f"a {kind} has no query tier")
        if kind == "KCDict":
            return TwoPhaseIndexQuery(query_index or index,
                                      device=None if query_index else device)
        return PaddedQuery(index, device, query_index)
    if tier is None:
        on = device if query_index is None else next(query_index.buffers()).device
        tier = query_tier(index, device=on)
    if tier not in ("speed", "capacity"):
        raise ValueError(f"tier must be 'speed' or 'capacity', not {tier!r}")
    if query_index is not None:
        held = layout_tier(query_index.arrays()["k2u"]["meta"])
        if held != tier:
            raise ValueError(f"query_index holds the {held} tier's layout; the index's tier is "
                             f"{tier!r}")
    if tier == "speed":
        return TwoPhaseIndexQuery(query_index or index, device=None if query_index else device)
    if k2u.direct_T:
        return CompactQuery(index, synth.CAPACITY_LAYOUT, CAPACITY_QUERY, device, query_index)
    return CompactQuery(index, synth.MPHF_LAYOUT, synth.MPHF_QUERY, device, query_index)


class ReadMapper:
    """Maps reads to their k-mer windows' reference hits: ``map_reads``
    (sequences), ``map_fasta`` and ``map_file`` (FASTA or FASTQ, gzipped or
    not). The windows of all reads are k-merized in one call of the host
    library and queried ``batch`` at a time on ``device`` (the card by
    default) through ``query_driver(index, tier=tier)``; ``query_index``
    lends it the index's arrays already on a device, in that driver's
    layout."""

    def __init__(self, index, batch: int = 1 << 18, device=None, query_index=None,
                 tier: str | None = None):
        self.index = index
        self.k = index.k
        self.batch = int(batch)
        self.tp = query_driver(index, device, query_index, tier)

    def map_reads(self, reads: list) -> list:
        """One ``ReadHits`` a read, views into one CSR batch."""
        from ..io.native import kmerize_batch

        bounds, flat_pos, flat = kmerize_batch(reads, self.k)
        if len(flat) == 0:
            z = np.zeros(0, dtype=np.int64)
            bh = BatchHits(np.zeros(0, np.uint8), np.zeros(1, np.int64), z, z, z)
        else:
            bh = BatchHits.concat([self.tp.get_ref_pos_batch(flat[s : s + self.batch])
                                   for s in range(0, len(flat), self.batch)])
        return [ReadHits(flat_pos[bounds[i] : bounds[i + 1]], bh, bounds[i])
                for i in range(len(reads))]

    def map_fasta(self, path: str) -> list:
        from ..io.fasta import read_fasta

        return self.map_reads([seq for _, seq in read_fasta(path)])

    def map_file(self, path: str) -> list:
        """FASTA or FASTQ, gzipped or not, told apart by the first character."""
        from ..io.fastq import read_seqs

        return self.map_reads([seq for _, seq in read_seqs(path)])
