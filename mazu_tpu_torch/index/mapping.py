"""Query results in CSR form (counterpart of ``BatchHits`` in
``mazu_tpu.index.mapping``): the type that
``TwoPhaseIndexQuery.get_ref_pos_batch`` returns. Host NumPy arrays."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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
