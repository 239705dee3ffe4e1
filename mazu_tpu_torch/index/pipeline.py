"""OneGraphIndexQuery: the whole-pass checksum driver (counterpart of
``mazu_tpu.index.pipeline.OneGraphIndexQuery``).

A pass runs CH query chunks through ``get_ref_pos_compact(merge=False)``
and reduces each with ``checksum``. The sum and the worst overflow count
stay on the device until the pass ends: one host sync per pass.
"""

from __future__ import annotations

import torch

from .modindex import QueryIndex, get_ref_pos_compact

ROLL_STEP = 40009  # chunk i of a rolled pass is roll(work, i * ROLL_STEP)


class OneGraphIndexQuery:
    """Exact for every lane unless a chunk's overflow count exceeds ``m2``:
    then the pass raises, since the lanes past ``m2`` went unresolved."""

    def __init__(self, index: QueryIndex, batch: int, n_chunks: int = 16, m2: int | None = None):
        self.index = index
        self.CH = int(n_chunks)
        self.M2 = int(m2 or max(8192, batch // 16))
        self.max_occs = index.max_occs

    @staticmethod
    def checksum(out: dict) -> torch.Tensor:
        """int64 sum of ref_pos and ref_id over valid occurrences and of
        unitig_id and pos over resolved lanes, across the main and the
        compacted phase-2 pieces of a ``merge=False`` result."""
        m_, ov, p2, sr = out["main"], out["overflow"], out["phase2"], out["slot_real"]
        v2 = p2["valid"] & sr[:, None]
        return (
            torch.where(m_["valid"], m_["ref_pos"], 0).sum()
            + torch.where(m_["valid"], m_["ref_id"], 0).sum()
            + torch.where(~ov, m_["unitig_id"], 0).sum()
            + torch.where(~ov, m_["pos"], 0).sum()
            + torch.where(v2, p2["ref_pos"], 0).sum()
            + torch.where(v2, p2["ref_id"], 0).sum()
            + torch.where(sr, p2["unitig_id"], 0).sum()
            + torch.where(sr, p2["pos"], 0).sum()
        )

    def _run(self, arrays: dict, chunks) -> tuple[int, int]:
        tot = worst = 0
        for chunk in chunks:
            out = get_ref_pos_compact(arrays, chunk, self.max_occs, merge=False, m2=self.M2)
            tot = tot + self.checksum(out)
            worst = torch.clamp(out["n_ovf"], min=worst)
        return self._finish(tot, worst)

    def checksum_pass(self, stack: torch.Tensor) -> tuple[int, int]:
        """One pass over a [CH, batch] stack on the index's device.
        Returns (checksum, worst overflow count)."""
        return self._run(self.index.arrays(), stack)

    def checksum_pass_rolled(self, work: torch.Tensor) -> tuple[int, int]:
        """One pass over CH chunks derived on the device: chunk i is
        ``roll(work, i * ROLL_STEP)``, a permutation of the same multiset.
        Chunk 0 is ``work`` itself, so the pass checksum equals CH times a
        one-chunk oracle's on ``work``."""
        return self._run(
            self.index.arrays(),
            (torch.roll(work, i * ROLL_STEP) for i in range(self.CH)),
        )

    def _finish(self, tot: torch.Tensor, worst: torch.Tensor) -> tuple[int, int]:
        tot, worst = int(tot), int(worst)
        if worst > self.M2:
            raise RuntimeError(
                f"phase-2 capacity exceeded: {worst} overflow lanes > m2={self.M2}; "
                "results for the lanes past m2 are unresolved — rebuild with a larger m2"
            )
        return tot, worst

    def checksum_host(self, host_index: QueryIndex, stack) -> int:
        """The same computation on a CPU copy of the index (plain torch):
        the parity oracle of a device pass."""
        arrays = host_index.arrays()
        tot = 0
        for chunk in stack:
            out = get_ref_pos_compact(arrays, chunk.cpu(), self.max_occs, merge=False, m2=self.M2)
            if bool(out["over_budget"]):
                raise RuntimeError("phase-2 capacity exceeded")
            tot += int(self.checksum(out))
        return tot
