"""The port's tracer: host spans, counters, and device stages of a pass.

Off by default. Off, ``span`` returns one shared null context (one flag
check and one check whether ``torch.profiler`` is recording), ``count``
and ``mark`` return at once, and every pass runs the graph it runs
without the tracer.

- ``span(name, **attrs)``: a host span. While a profiler records, it is
  also a range ``mazu.<name>`` in the profiler's host timeline, on the
  same clock as the device's operations. It is recorded as an operator
  (``_RecordFunctionFast``), not as ``record_function``'s user
  annotation: the profiler copies a user annotation onto the device
  timeline around the kernels launched inside it, where a reader of
  device operations would count it as device time. While tracing is on,
  it is kept in memory: name, start and end (``time.perf_counter_ns``),
  the span open around it, and the pass it belongs to. ``pass_span`` opens a span
  that starts the next pass (each ``OneGraphIndexQuery`` pass and
  ``RunServePass`` call); ``timed`` is a span that measures its interval
  whether or not tracing is on, for a caller that keeps the seconds.
- ``count(name, n)``: adds ``n`` to a counter while tracing is on.
- ``mark(stage, t)``: a device stage boundary inside a pass. Only while
  tracing is on with device stages (``enable(stages=True)``), inside a
  pass function run through ``collecting``, on a CUDA tensor: it records
  a timing ``torch.cuda.Event`` (``external=True``, so that a capture
  makes it an event node of the graph) on the current stream. After the
  pass's own read-back, ``settle`` turns consecutive marks into device
  stages (stage, ms, pass, chunk): a chunk starts at each mark of the
  pass's first stage. ``staged()`` tells a pass to build its marked
  form, whose graph is keyed apart from the unmarked one.

``enable``, ``disable``, ``reset``, ``snapshot`` and ``dump`` (Chrome
trace JSON: ``X`` events for spans, ``C`` events for counters) act on the
module's one ``Tracer``. A process that never enables it keeps nothing.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

PREFIX = "mazu."
_NULL = contextlib.nullcontext()


class _Marks(list):
    """(stage, event) pairs of one run of a pass function, and the events
    of its previous run, which the next marks take again (so a capture
    records events that its eager warm-up already created)."""

    def __init__(self, spare):
        super().__init__()
        self.spare = spare


class Tracer:
    """What the tracer keeps: ``spans`` (dicts: name, start_ns, end_ns,
    parent (an index into ``spans``), pass, attrs), ``device`` (dicts:
    stage, ms, pass, chunk) and ``counters``."""

    def __init__(self):
        self.on = False
        self.stages = False
        self.pass_id = None
        self.pending = None  # (pass, marks) of the latest launched pass
        # each thread's stack of open spans, and the _Marks of the pass
        # function it is running (None outside one)
        self.local = threading.local()
        self.clear()

    def clear(self) -> None:
        self.spans, self.device, self.counters = [], [], {}
        self.pending = None
        self.next_pass = 0

    def open_spans(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


TRACER = Tracer()


def _profiling() -> bool:
    return _profiler._is_profiler_enabled


class _Span:
    """A span: a profiler range while one records, a record while tracing
    is on, and its own interval (``start_ns``, ``end_ns``) always."""

    __slots__ = ("name", "attrs", "new_pass", "start_ns", "end_ns", "_range", "_rec", "_outer")

    def __init__(self, name: str, attrs: dict, new_pass: bool = False):
        self.name, self.attrs, self.new_pass = name, attrs, new_pass
        self.start_ns = self.end_ns = 0
        self._range = self._rec = self._outer = None

    def __enter__(self):
        tr = TRACER
        if _profiling():
            self._range = _RecordFunctionFast(PREFIX + self.name)
            self._range.__enter__()
        if tr.on:
            if self.new_pass:
                self._outer = tr.pass_id
                tr.pass_id, tr.next_pass = tr.next_pass, tr.next_pass + 1
                count("passes")
            stack = tr.open_spans()
            self._rec = {"name": self.name, "start_ns": 0, "end_ns": 0,
                         "parent": stack[-1] if stack else None, "pass": tr.pass_id,
                         "attrs": self.attrs}
            tr.spans.append(self._rec)
            stack.append(len(tr.spans) - 1)
        self.start_ns = time.perf_counter_ns()
        if self._rec is not None:
            self._rec["start_ns"] = self.start_ns
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._rec is not None:
            self._rec["end_ns"] = self.end_ns
            TRACER.open_spans().pop()
            if self.new_pass:
                TRACER.pass_id = self._outer
        if self._range is not None:
            self._range.__exit__(*exc)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def set(self, **attrs) -> None:
        """Add attributes (also after the span has closed)."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A host span ``name`` (see the module); the shared null context when
    tracing is off and no profiler records."""
    if not TRACER.on and not _profiling():
        return _NULL
    return _Span(name, attrs)


def pass_span(name: str):
    """``span`` that starts the next pass: spans inside it carry its id."""
    if not TRACER.on and not _profiling():
        return _NULL
    return _Span(name, {}, new_pass=True)


def timed(name: str, **attrs) -> _Span:
    """A span that always measures its interval (``.seconds`` once it has
    closed), for a caller that keeps that time itself."""
    return _Span(name, attrs)


def count(name: str, n: int = 1) -> None:
    tr = TRACER
    if tr.on:
        tr.counters[name] = tr.counters.get(name, 0) + int(n)


def staged() -> bool:
    """Whether passes run in their marked form (device stages on)."""
    return TRACER.on and TRACER.stages


def mark(stage: str, t: torch.Tensor) -> None:
    """The device stage ``stage`` starts here (see the module)."""
    marks = getattr(TRACER.local, "marks", None)
    if marks is None or not t.is_cuda:
        return
    e = marks.spare.pop() if marks.spare else torch.cuda.Event(enable_timing=True, external=True)
    e.record()
    marks.append((stage, e))


def collecting(fn):
    """``fn`` (a pass function of one tensor) as it runs in a marked pass:
    the returned function keeps the marks of its latest call in ``.marks``,
    closed by a last mark after ``fn``'s work. ``fn`` itself unless
    ``staged()``."""
    if not staged():
        return fn

    def run(x):
        local = TRACER.local
        outer = getattr(local, "marks", None)
        local.marks = _Marks([e for _, e in reversed(run.marks)])
        try:
            out = fn(x)
            mark("end", x)
        finally:
            run.marks, local.marks = local.marks, outer
        return out

    run.marks = _Marks([])
    return run


def launched(marks) -> None:
    """The pass whose marks are ``marks`` was launched; ``settle`` reads
    them after its read-back."""
    if marks and staged():
        TRACER.pending = (TRACER.pass_id, list(marks))


def settle() -> None:
    """After a pass's read-back (its sync): the device stages of the
    latest launched pass's marks."""
    tr = TRACER
    if tr.pending is None:
        return
    pid, marks = tr.pending
    tr.pending = None
    first, chunk = marks[0][0], -1
    for (stage, e0), (_, e1) in zip(marks, marks[1:]):
        chunk += stage == first
        tr.device.append({"stage": stage, "ms": e0.elapsed_time(e1), "pass": pid,
                          "chunk": chunk})


def enable(stages: bool = False) -> None:
    """Keep spans and counters; with ``stages``, also run passes in their
    marked form and keep their device stages."""
    TRACER.on, TRACER.stages = True, bool(stages)


def disable() -> None:
    TRACER.on = TRACER.stages = False


def reset() -> None:
    """Forget every span, device stage and counter kept so far; pass ids
    start again at 0."""
    TRACER.clear()


def snapshot() -> dict:
    """Copies of what is kept: ``spans``, ``device`` and ``counters``."""
    tr = TRACER
    return {"spans": [dict(s, attrs=dict(s["attrs"])) for s in tr.spans],
            "device": [dict(d) for d in tr.device], "counters": dict(tr.counters)}


def chrome_events(snap: dict) -> list:
    """Chrome trace events of a ``snapshot``: an ``X`` event a host span
    (thread 0), an ``X`` event a device stage (thread 1: only their
    durations are measured, so each pass's stages are laid end to end
    from the start of its first span) and a ``C`` event a counter."""
    spans = snap["spans"]
    t0 = min((s["start_ns"] for s in spans), default=0)
    ev = []
    for s in spans:
        ev.append({"name": s["name"], "ph": "X", "pid": 0, "tid": 0,
                   "ts": (s["start_ns"] - t0) / 1e3, "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                   "args": {**s["attrs"], "pass": s["pass"], "parent": s["parent"]}})
    at = {}
    for s in spans:
        if s["pass"] is not None:
            at.setdefault(s["pass"], (s["start_ns"] - t0) / 1e3)
    for d in snap["device"]:
        ts = at.get(d["pass"], 0.0)
        ev.append({"name": d["stage"], "ph": "X", "pid": 0, "tid": 1, "ts": ts,
                   "dur": d["ms"] * 1e3, "args": {"pass": d["pass"], "chunk": d["chunk"]}})
        at[d["pass"]] = ts + d["ms"] * 1e3
    end = max((s["end_ns"] - t0) / 1e3 for s in spans) if spans else 0.0
    for name, v in snap["counters"].items():
        ev.append({"name": name, "ph": "C", "pid": 0, "ts": end, "args": {name: v}})
    return ev


def dump(path) -> None:
    """Write what is kept as Chrome trace JSON to ``path``."""
    with open(path, "w") as f:
        json.dump({"traceEvents": chrome_events(snapshot()), "displayTimeUnit": "ms"}, f)
