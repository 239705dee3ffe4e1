"""Lane compaction (contract of ``mazu_tpu.ops.compact.flagged_lanes``).

The reference builds a hierarchical rank-select because scatters are slow
on its TPU; the contract, not that mechanism, is ported: a prefix sum
ranks the flagged lanes and one scatter places them. No value comes back
to the host, so a loop over chunks does not sync per chunk.
"""

from __future__ import annotations

import torch


def flagged_lanes(flags: torch.Tensor, m: int):
    """Indices of the first ``m`` set flags, in order.

    Returns (lanes int64[m], n_set int64 scalar tensor); ``n_set`` is the
    true count even when it exceeds ``m``. ``lanes[s]`` for ``s >= n_set``
    is an in-bounds index with no meaning: callers mask by ``s < n_set``."""
    n = flags.shape[0]
    dev = flags.device
    f = flags.to(torch.int64)
    rank = torch.cumsum(f, 0) - 1
    # unflagged and over-budget lanes all land in the discarded slot m
    dest = torch.where(flags & (rank < m), rank, m)
    lanes = torch.zeros(m + 1, dtype=torch.int64, device=dev)
    lanes.scatter_(0, dest, torch.arange(n, dtype=torch.int64, device=dev))
    return lanes[:m], f.sum()


def flagged_lanes2(flags_a: torch.Tensor, flags_b: torch.Tensor, m_a: int, m_b: int):
    """The first ``m_a`` set ``flags_a`` lanes and the first ``m_b`` set
    ``flags_b`` lanes: two independent compactions, no host sync. Returns
    (lanes_a, n_a, lanes_b, n_b); the counts are true even over budget."""
    lanes_a, n_a = flagged_lanes(flags_a, m_a)
    lanes_b, n_b = flagged_lanes(flags_b, m_b)
    return lanes_a, n_a, lanes_b, n_b
