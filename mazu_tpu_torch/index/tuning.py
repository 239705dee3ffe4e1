"""The query tier rule (counterpart of the tier choice of
``mazu_tpu.index.tuning.tuned_query_config``).

An SSHash is served by its speed tier when that tier's arrays fit the
device's budget and its probe bound is at most ``SPEED_MAX_PROBE_BOUND``,
and by the capacity layouts otherwise. The speed tier of a 32-bit engine
(direct, fast32) is fused inline rows (the reference's ``inline2`` rows at
probe limit 2); that of a parity SSHash is its default layout, packed
positions with Elias-Fano bounds, which the reference's mapper queries
there. The bound is the port's rule, not the reference's (an H100
measurement, below). The reference's other settings
in that module were measured on a TPU and are not carried over: the port's
capacity settings are ``mapping.query_driver``'s.

The budget is the device's memory times 0.97 (``MAZU_HBM_BUDGET``, in
bytes, overrides it, as in the reference); the index's arrays may take it
less min(2 GB, 20%), which the query graph's workspace keeps. The speed
layout's size is counted from the index (``speed_bytes``), where the
reference multiplies the k-mer count by a constant.
"""

from __future__ import annotations

import os

import numpy as np
import torch

GRAPH_WORKSPACE = int(2e9)  # bytes kept for the query graph's workspace

# The speed tier probes in full mode to the index's static probe bound
# (the mapper's main phase, every query's phase 2); the capacity tier stops
# at a middle phase of 4. On an H100 (chip_smoke.py) at bound 64, the 300
# Mbp builds, the speed layout ran 54.5 M queries/s against the capacity
# path's 196.1 (phase 12a; its phase 2 127.0 of the pass's 153.9 ms), and
# the mapper, timed in turns, 39.5 and 26.1 k reads/s against 41.7 and 33.7
# (phases 12b and 17b, direct and fast32) after 24 s of host rows; at bound
# 4 (synth50-speed, phase 8e) the speed tier mapped 43.3 k reads/s against
# the capacity tier's 31.9. Scaled linearly in the bound, phase 2 puts the
# two query paths level near 8.
SPEED_MAX_PROBE_BOUND = 8


def device_budget(device=None) -> int:
    """Bytes of ``device`` (the card by default) the index and its query
    may take: ``MAZU_HBM_BUDGET`` when set, else 0.97 x the card's memory,
    or of the host's on a CPU device."""
    env = os.environ.get("MAZU_HBM_BUDGET")
    if env:
        return int(float(env))
    from ..convert import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        total = torch.cuda.get_device_properties(dev).total_memory
    else:
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return int(total * 0.97)


def arrays_budget(budget: int) -> int:
    """The share of ``budget`` an index's arrays may take."""
    return budget - min(GRAPH_WORKSPACE, int(0.2 * budget))


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.nbytes if isinstance(tree, np.ndarray) else 0


def speed_bytes(index) -> int:
    """Bytes of an SSHash ``index``'s speed layout. A 32-bit engine's is
    ``index.device_arrays(fused=True, pos_kind="inline2")``, counted
    without building its rows and bounds: 56 bytes a fused row, the bucket
    bounds, the skew table, and the unitig set's paired arrays, occurrence
    table and references as they are laid out. A parity SSHash's is its
    default layout, ``index.device_arrays()`` (packed positions, Elias-Fano
    bounds, the 64-bit MPHFs), which the reference's speed tier queries,
    counted from the built arrays."""
    ss = index.k2u
    if not ss.hash32:
        return _nbytes(index.device_arrays())
    n = 56 * len(ss.pos)
    if ss.direct_T:
        n += 8 * ss.direct_T
        sd = ss.skew_direct
        if sd is not None:
            n += 48 * len(sd["pos"]) + (0 if sd.get("kind") == "cuckoo" else 8 * sd["T"])
    else:
        n_b = len(ss.occs_prefix_sum) - 1
        n += 4 * (n_b + 1) + 8 * n_b + _nbytes(ss.mphf.device_arrays())
        if ss.skew_mphf is not None:
            n += _nbytes(ss.skew_mphf.device_arrays()) + _nbytes(ss.skew_pos.device_arrays())
    return (n + _nbytes(ss.unitigs.device_arrays(paired=True))
            + _nbytes(index.u2pos.device_arrays()) + _nbytes(index.refs.device_arrays()))


def query_tier(index, budget: int | None = None, device=None) -> str:
    """``"speed"`` when an SSHash ``index``'s probe bound is at most
    ``SPEED_MAX_PROBE_BOUND`` and its speed layout fits the arrays' share of
    ``budget`` (``device_budget(device)`` by default), else ``"capacity"``."""
    if max(1, index.k2u.probe_bound()) > SPEED_MAX_PROBE_BOUND:
        return "capacity"
    if budget is None:
        budget = device_budget(device)
    return "speed" if speed_bytes(index) <= arrays_budget(budget) else "capacity"
