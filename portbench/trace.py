"""The traced window: the device's operations and the benchmark's host
spans from ``torch.profiler``, and the arithmetic that the per-layer
metrics read from them.

A device operation is a kernel, a copy or a set that ran on the card. The
device is busy over the union of their intervals; the window's idle share
is its length less that union, over its length. An idle gap is named by
the innermost host span of the benchmark (``portbench.<name>``) open at its
middle, ``between`` where none is.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "portbench."


@dataclass
class Trace:
    """``device``: (name, kind, start_ns, end_ns) of every device operation,
    kind one of ``DEVICE_KINDS``; ``host``: (name, start_ns, end_ns) of the
    benchmark's host spans, the ``portbench.`` prefix dropped; ``window``:
    (start_ns, end_ns); ``batches``: the batches run inside it."""

    device: list
    host: list
    window: tuple
    batches: int


def _kind(e) -> str | None:
    """The device kind of a profiler event, or None for a host event."""
    at = e.activity_type() if hasattr(e, "activity_type") else None
    if at is not None:
        return at if at in DEVICE_KINDS else None
    if e.device_type().name != "CUDA" or e.name().startswith(PREFIX):
        return None
    name = e.name()
    return "gpu_memcpy" if name.startswith("Memcpy") else (
        "gpu_memset" if name.startswith("Memset") else "kernel")


def from_profiler(prof, batches: int) -> Trace:
    """The trace of a ``torch.profiler.profile`` whose window is the host
    span ``portbench.window``."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if kind is not None:
            device.append((e.name(), kind, start, end))
        elif e.name().startswith(PREFIX) and e.device_type().name == "CPU":
            host.append((e.name()[len(PREFIX):], start, end))
    windows = [(s, t) for n, s, t in host if n == "window"]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} windows")
    return Trace(device, host, windows[0], batches)


def merged(intervals, lo: int, hi: int) -> list:
    """The union of (start, end) intervals clipped to [lo, hi], as sorted
    disjoint intervals."""
    out = []
    for s, t in sorted((max(s, lo), min(t, hi)) for s, t in intervals):
        if s >= t:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def window_s(tr: Trace) -> float:
    return (tr.window[1] - tr.window[0]) * 1e-9


def busy_s(tr: Trace) -> float:
    """Seconds of the window in which some device operation ran."""
    return sum(t - s for s, t in merged([(s, t) for _, _, s, t in tr.device], *tr.window)) * 1e-9


def idle_pct(tr: Trace) -> float:
    return 100.0 * (1.0 - busy_s(tr) / window_s(tr))


def kernel_ns(tr: Trace, part: str | None = None, exclude: str | None = None) -> tuple:
    """(summed nanoseconds, count) of the window's kernels whose name holds
    ``part`` (any, if None) and not ``exclude``."""
    lo, hi = tr.window
    tot = n = 0
    for name, kind, s, t in tr.device:
        if kind != "kernel" or s < lo or t > hi:
            continue
        if (part is None or part in name) and (exclude is None or exclude not in name):
            tot += t - s
            n += 1
    return tot, n


def top_ops(tr: Trace, n: int = 10) -> list:
    """[name, seconds] of the device operations that took most time."""
    by = defaultdict(int)
    for name, _, s, t in tr.device:
        by[name[:160]] += t - s
    return [[k, v * 1e-9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_by_host(tr: Trace, n: int = 10) -> list:
    """[host span, seconds] of the window's idle time, summed by what the
    host was doing at each gap's middle, longest first."""
    lo, hi = tr.window
    busy = merged([(s, t) for _, _, s, t in tr.device], lo, hi)
    gaps, at = [], lo
    for s, t in busy:
        if s > at:
            gaps.append((at, s))
        at = t
    if at < hi:
        gaps.append((at, hi))
    spans = [(name, s, t) for name, s, t in tr.host if name not in ("window", "batch")]
    by = defaultdict(int)
    for s, t in gaps:
        mid = (s + t) // 2
        open_ = [(t2 - s2, name) for name, s2, t2 in spans if s2 <= mid < t2]
        by[min(open_)[1] if open_ else "between"] += t - s
    return [[k, v * 1e-9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
