"""The program's own instruments as the benchmark reads them: the port's
``mazu.`` ranges in a ``torch.profiler`` trace (``mazu_tpu_torch.trace``
opens one for each of its spans while a profiler records), and its
tracer's ``snapshot()`` (spans, device stages, counters).

Each reader gives None where what it reads is missing (no program range of
the family, no device stage, no counter, no span): it never falls back to
a host-clock number under a device quantity's name. ``portbench/stages.py``
prints them; the per-layer metrics that would read them in ``run.py``'s
traced run need the harness to collect them first (``PERF.md``, open
questions).
"""

from __future__ import annotations

from collections import defaultdict

from .trace import Trace, merged

PREFIX = "mazu."


def program_ranges(prof) -> list:
    """(name, start_ns, end_ns) of the program's host ranges in a
    ``torch.profiler.profile``, the ``mazu.`` prefix dropped, on the same
    clock as ``trace.from_profiler``'s device operations."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(PREFIX) and e.device_type().name == "CPU":
            out.append((e.name()[len(PREFIX):], e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def idle_gaps(tr: Trace) -> list:
    """(start_ns, end_ns) of the window's stretches in which no device
    operation ran."""
    lo, hi = tr.window
    gaps, at = [], lo
    for s, t in merged([(s, t) for _, _, s, t in tr.device], lo, hi):
        if s > at:
            gaps.append((at, s))
        at = t
    if at < hi:
        gaps.append((at, hi))
    return gaps


def _open_at(program: list, t: int) -> list:
    return [(e - s, name) for name, s, e in program if s <= t < e]


def idle_by_program(tr: Trace, program: list) -> list:
    """[program span, seconds] of the window's idle time, summed by the
    innermost program range open at each gap's middle (``outside`` where
    none is), longest first."""
    by = defaultdict(int)
    for s, t in idle_gaps(tr):
        open_ = _open_at(program, (s + t) // 2)
        by[min(open_)[1] if open_ else "outside"] += t - s
    return [[k, v * 1e-9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])]


def pass_idle_ms(tr: Trace, program: list, family: str) -> float | None:
    """Device idle milliseconds a traced batch whose gap's middle lies in a
    program span of ``family`` (``serve`` or ``query``: ``serve.*``
    spans); None where the trace holds no such span."""
    fam = [r for r in program if r[0].startswith(family + ".")]
    if not fam or not tr.batches:
        return None
    ns = sum(t - s for s, t in idle_gaps(tr) if _open_at(fam, (s + t) // 2))
    return ns * 1e-6 / tr.batches


def in_window(tr: Trace, program: list, name: str) -> int:
    """How many program ranges ``name`` overlap the traced window."""
    lo, hi = tr.window
    return sum(1 for n, s, t in program if n == name and s < hi and t > lo)


def stage_ms(snap: dict, batches: int) -> dict | None:
    """{stage: device ms a batch} of a snapshot's device stages over
    ``batches`` batches; None where it holds none."""
    if not snap["device"] or not batches:
        return None
    by = defaultdict(float)
    for d in snap["device"]:
        by[d["stage"]] += d["ms"]
    return {k: v / batches for k, v in by.items()}


def slot_fill(snap: dict) -> float | None:
    """Percent of phase 2's padded occurrence slots that hold a real
    occurrence (``phase2.occurrences`` over ``phase2.slots``)."""
    c = snap["counters"]
    if not c.get("phase2.slots"):
        return None
    return 100.0 * c.get("phase2.occurrences", 0) / c["phase2.slots"]


def span_s(snap: dict, name: str) -> float | None:
    """Seconds in the spans ``name`` (summed); None where there is none."""
    ns = [s["end_ns"] - s["start_ns"] for s in snap["spans"] if s["name"] == name]
    return sum(ns) * 1e-9 if ns else None


def span_table(snap: dict, names) -> dict:
    """{name: (seconds, count)} of the snapshot's spans whose name is in
    ``names`` or starts with one that ends in ``.``."""
    out = {}
    for s in snap["spans"]:
        if any(s["name"] == n or (n.endswith(".") and s["name"].startswith(n)) for n in names):
            sec, k = out.get(s["name"], (0.0, 0))
            out[s["name"]] = (sec + (s["end_ns"] - s["start_ns"]) * 1e-9, k + 1)
    return out
