"""Whole-pass checksum drivers.

``OneGraphIndexQuery`` (counterpart of
``mazu_tpu.index.pipeline.OneGraphIndexQuery``) runs CH query chunks
through ``get_ref_pos_compact(merge=False)`` and reduces each with
``checksum``. The sum and the worst per-chunk counts (overflow, type-B
overflow, residue over capacity) stay on the device until the pass ends:
one host sync per pass.

``checksum_padded_rolled`` is the one-phase pass of ``bench.py``'s full
mode (its lines 625-628): ``get_ref_pos_padded`` per chunk and
``padded_checksum``, the path of the pufferfish indexes.
"""

from __future__ import annotations

import torch

from .modindex import QueryIndex, get_ref_pos_compact, get_ref_pos_padded

ROLL_STEP = 40009  # chunk i of a rolled pass is roll(work, i * ROLL_STEP)


class OneGraphIndexQuery:
    """Exact for every lane unless a chunk overflows a capacity (``m2``,
    ``m2b``, or the middle phase's residue ``m2c``): then the pass raises,
    since the lanes past it went unresolved.

    ``probe_limit``, ``m2b``, ``defer_valid``, ``mphf_level_limit``,
    ``probe_limit2`` and ``m2c`` are passed to ``get_ref_pos_compact`` (the
    SSHash capacity settings); a mono2 KCDict ignores ``probe_limit``."""

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
    ):
        self.index = index
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

    def _run(self, arrays: dict, chunks):
        tot = worst = 0
        for chunk in chunks:
            out = get_ref_pos_compact(arrays, chunk, self.max_occs, **self.query_kw)
            tot = tot + self.checksum(out)
            worst = torch.clamp(self._counts(out), min=worst)
        return self._finish(tot, worst)

    def checksum_pass(self, stack: torch.Tensor):
        """One pass over a [CH, batch] stack on the index's device.
        Returns (checksum, worst overflow count), or (checksum, (worst
        type-A, worst type-B)) when the heavy phase is type-split."""
        return self._run(self.index.arrays(), stack)

    def checksum_pass_rolled(self, work: torch.Tensor):
        """One pass over CH chunks derived on the device: chunk i is
        ``roll(work, i * ROLL_STEP)``, a permutation of the same multiset.
        Chunk 0 is ``work`` itself, so the pass checksum equals CH times a
        one-chunk oracle's on ``work``. Returns as ``checksum_pass``."""
        return self._run(
            self.index.arrays(),
            (torch.roll(work, i * ROLL_STEP) for i in range(self.CH)),
        )

    def _finish(self, tot: torch.Tensor, worst: torch.Tensor):
        tot = int(tot)
        wa, wb, wc = (int(v) for v in worst.tolist())
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


def checksum_padded_rolled(index: QueryIndex, work: torch.Tensor, n_chunks: int) -> int:
    """One pass of ``n_chunks`` chunks ``roll(work, i * ROLL_STEP)`` through
    ``get_ref_pos_padded`` on the index's device, one host sync at the end.
    A lane's outputs depend on its word alone, so the pass checksum equals
    ``n_chunks`` times ``padded_checksum`` of ``work``'s result."""
    arrays = index.arrays()
    tot = 0
    for i in range(int(n_chunks)):
        out = get_ref_pos_padded(arrays, torch.roll(work, i * ROLL_STEP), index.max_occs)
        tot = tot + padded_checksum(out)
    return int(tot)
