"""The port's tracer (``mazu_tpu_torch.trace``) on the CPU.

Off, it keeps nothing, builds no CUDA event and leaves every pass's graph
as it was; ``enable()`` alone keeps host spans and counters with the same
graphs; only ``enable(stages=True)`` adds the stage flag to a graph's key
and the phase-2 sums to its output. On a small synthetic index, the
``phase2.*`` counters of ``OneGraphIndexQuery`` and ``RunServePass`` equal
counts worked out from ``get_ref_pos_compact(merge=False)`` and the main
probe chunk by chunk, and the passes' results are the same with tracing on and off.
Under a CPU ``torch.profiler`` the program's ``mazu.`` ranges nest inside
the caller's. Device stages are settled from stand-in events."""

import json

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

from mazu_tpu_torch import synth, trace
from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index import pipeline
from mazu_tpu_torch.index.modindex import QueryIndex, get_ref_pos_compact
from mazu_tpu_torch.index.pipeline import OneGraphIndexQuery, RunServePass
from mazu_tpu_torch.index.pseudoalign import color_bitsets
from mazu_tpu_torch.io.reads import kmerize_device, pack_reads, pad_reads
from mazu_tpu_torch.kphf.kcdict import KCDict, kcdict_k2u
from mazu_tpu_torch.synth import READ_LEN

from torch_fixtures import tensor

N, CH, N_READS, M2_SERVE = 1024, 2, 32, 4096


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


@pytest.fixture(scope="module")
def small():
    """A mono2 index on the CPU, a stack of queries and a packed read
    batch with non-ACGT bases."""
    index = synth.build_index(4 * synth.PIECE, seed=0)
    qi = QueryIndex(arrays_from_numpy(index.device_arrays(), "cpu"))
    words = synth.sample_queries_truth(index.k2u.unitigs, CH * N, seed=1)[0]
    stack = tensor(words).reshape(CH, N)
    cb = arrays_from_numpy(color_bitsets(index.color_classes()), "cpu")
    reads = synth.serve_reads(index.refs, CH * N_READS, seed=1, n_share=0.1)
    packed = pack_reads(reads, 31)
    assert packed["meta"].has_bad
    return index, qi, stack, cb, packed


def _query(qi, graph=False):
    return OneGraphIndexQuery(qi, N, n_chunks=CH, m2=N, graph=graph)


def _serve(qi, cb, graph=False):
    return RunServePass(qi, cb, N_READS, CH, M2_SERVE, READ_LEN, probe_limit=2, graph=graph)


class _FakeCuda:
    """Stands for a tensor on the card (``mark`` looks at ``is_cuda``)."""

    is_cuda = True


def _no_event(*args, **kwargs):
    raise AssertionError("a CUDA event was built")


def test_off_keeps_nothing(monkeypatch, small):
    _, qi, stack, cb, packed = small
    monkeypatch.setattr(torch.cuda, "Event", _no_event)
    assert not autograd_profiler._is_profiler_enabled
    assert trace.span("a") is trace.span("b", x=1) is trace.pass_span("c")
    with trace.span("a"):
        trace.count("n", 3)
        trace.mark("main", _FakeCuda())
    fn = trace.collecting(lambda x: x)
    assert not hasattr(fn, "marks")
    trace.launched([("main", None)])
    trace.settle()
    _query(qi).checksum_pass(stack)
    _serve(qi, cb)(packed)
    assert trace.snapshot() == {"spans": [], "device": [], "counters": {}}


def test_enable_without_stages_builds_no_event(monkeypatch, small):
    _, qi, stack, cb, packed = small
    monkeypatch.setattr(torch.cuda, "Event", _no_event)
    trace.enable()
    assert not trace.staged()
    trace.mark("main", _FakeCuda())
    _query(qi).checksum_pass(stack)
    _serve(qi, cb)(packed)
    snap = trace.snapshot()
    assert snap["device"] == []
    assert snap["counters"] == {"passes": 2}  # no phase2.* without the marked pass
    names = [s["name"] for s in snap["spans"]]
    assert names[:3] == ["query.pass", "query.launch", "query.readback"]
    assert names[3:] == ["serve.pass", "serve.pad", "serve.buffer", "serve.upload",
                         "serve.launch", "serve.readback"]
    assert [s["pass"] for s in snap["spans"]] == [0] * 3 + [1] * 6


def test_spans_nest_with_parent_and_pass():
    trace.enable()
    with trace.span("outer", tag="x"):
        with trace.pass_span("p"):
            with trace.span("inner"):
                trace.count("n", 2)
        with trace.pass_span("p"):
            pass
    with trace.span("after"):
        trace.count("n")
    s = trace.snapshot()
    by = {(d["name"], d["pass"]): (i, d) for i, d in enumerate(s["spans"])}
    outer_i, outer = by[("outer", None)]
    p0_i, p0 = by[("p", 0)]
    _, inner = by[("inner", 0)]
    assert outer["parent"] is None and outer["attrs"] == {"tag": "x"}
    assert p0["parent"] == outer_i and inner["parent"] == p0_i
    assert by[("p", 1)][1]["parent"] == outer_i
    assert by[("after", None)][1]["parent"] is None
    assert all(d["start_ns"] <= d["end_ns"] for d in s["spans"])
    assert outer["start_ns"] <= p0["start_ns"] <= inner["start_ns"] <= inner["end_ns"] \
        <= p0["end_ns"] <= outer["end_ns"]
    assert s["counters"] == {"n": 3, "passes": 2}


def test_timed_measures_when_off():
    with trace.timed("t", a=1) as t:
        pass
    assert t.seconds >= 0 and t.end_ns >= t.start_ns
    t.set(b=2)
    assert t.attrs == {"a": 1, "b": 2}
    assert trace.snapshot()["spans"] == []


def test_dump_writes_chrome_trace(tmp_path):
    trace.enable()
    with trace.pass_span("query.pass"):
        with trace.span("query.launch", kind="stack"):
            trace.count("phase2.lanes", 7)
    trace.TRACER.device.append({"stage": "main", "ms": 0.5, "pass": 0, "chunk": 0})
    trace.TRACER.device.append({"stage": "phase2", "ms": 1.5, "pass": 0, "chunk": 0})
    path = tmp_path / "t.json"
    trace.dump(path)
    ev = json.loads(path.read_text())["traceEvents"]
    xs = {e["name"]: e for e in ev if e["ph"] == "X"}
    assert set(xs) == {"query.pass", "query.launch", "main", "phase2"}
    assert xs["query.launch"]["args"]["kind"] == "stack"
    assert xs["query.launch"]["args"]["parent"] == 0
    assert xs["main"]["tid"] == 1 and xs["main"]["dur"] == 500.0
    assert xs["phase2"]["ts"] == xs["main"]["ts"] + 500.0
    cs = {e["name"]: e["args"] for e in ev if e["ph"] == "C"}
    assert cs == {"phase2.lanes": {"phase2.lanes": 7}, "passes": {"passes": 1}}


def test_ranges_nest_in_the_callers_range(small):
    _, qi, stack, cb, packed = small
    q, s = _query(qi), _serve(qi, cb)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller.query"):
            q.checksum_pass(stack)
        with record_function("caller.serve"):
            s(packed)
    assert trace.snapshot()["spans"] == []  # the profiler alone keeps nothing in memory
    # operators, not user annotations, which the profiler would copy onto the device timeline
    kinds = {e.activity_type() for e in prof.profiler.kineto_results.events()
             if e.name().startswith("mazu.")}
    assert kinds == {"cpu_op"}
    ev = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()]

    def ranges(prefix):
        return [(n, a, b) for n, a, b in ev if n.startswith(prefix)]

    for fam in ("query", "serve"):
        (_, lo, hi), = ranges(f"caller.{fam}")
        (_, plo, phi), = ranges(f"mazu.{fam}.pass")
        inner = [r for r in ranges(f"mazu.{fam}.") if r[0] != f"mazu.{fam}.pass"]
        want = {"launch", "readback"} | ({"pad", "buffer", "upload"} if fam == "serve" else set())
        assert {n.split(".")[-1] for n, _, _ in inner} == want
        assert lo <= plo <= phi <= hi
        assert all(plo <= a <= b <= phi for _, a, b in inner)


def _phase2_by_hand(qi, chunks, m2):
    """(lanes sent to phase 2, phase-2 slots holding an occurrence, real
    lanes sent on to the side table) of ``chunks`` through
    ``get_ref_pos_compact(merge=False)``: the first ``n_ovf`` slots (at most
    ``m2``) are real, each real slot's valid columns are its occurrences,
    and a real lane goes on to the side table where the main table does not
    hold its key."""
    arrays = qi.arrays()
    lanes = occs = side = 0
    for chunk in chunks:
        out = get_ref_pos_compact(arrays, chunk, qi.max_occs, merge=False, m2=m2, probe_limit=2)
        n = int(out["n_ovf"])
        real = out["slot_real"].numpy()
        assert real[: min(n, m2)].all() and not real[min(n, m2):].any()
        valid = out["phase2"]["valid"].numpy()
        lanes += n
        occs += int(valid[: min(n, m2)].sum())
        assert occs > 0
        main = kcdict_k2u(arrays["k2u"], chunk[out["lanes"][: min(n, m2)]], mode="main")
        side += int(main["unresolved"].sum())
    assert side > 0
    return lanes, occs, side


def test_phase2_counters_of_the_query(small):
    _, qi, stack, _, _ = small
    off = _query(qi).checksum_pass(stack)
    trace.enable(stages=True)
    on = _query(qi).checksum_pass(stack)
    assert on == off
    lanes, occs, side = _phase2_by_hand(qi, stack, N)
    assert trace.snapshot()["counters"] == {
        "passes": 1, "phase2.lanes": lanes, "phase2.occurrences": occs,
        "phase2.slots": CH * N * qi.max_occs, "phase2.side_probes": side,
        "phase2.residue": 0}
    assert 0 < lanes < CH * N


def test_phase2_counters_of_the_serve_pass(small):
    _, qi, _, cb, packed = small
    off = _serve(qi, cb)(packed)
    trace.enable(stages=True)
    on = _serve(qi, cb)(packed)
    assert on == off
    padded = pad_reads(packed, READ_LEN)
    chunks = [kmerize_device({**padded, "words": torch.from_numpy(padded["words"].view(np.int64)),
                              "lengths": torch.from_numpy(padded["lengths"].astype(np.int64)),
                              "bad": torch.from_numpy(padded["bad"].view(np.int64))},
                             ci * N_READS, N_READS)[0].reshape(-1) for ci in range(CH)]
    lanes, occs, side = _phase2_by_hand(qi, chunks, M2_SERVE)
    assert lanes == sum(off[2])
    c = trace.snapshot()["counters"]
    assert c == {"passes": 1, "phase2.lanes": lanes, "phase2.occurrences": occs,
                 "phase2.slots": CH * M2_SERVE * qi.max_occs, "phase2.side_probes": side,
                 "phase2.residue": 0}


class _StandIn:
    def __init__(self, fn, inp, out):
        self.fn, self.inp, self.out = fn, inp, out

    def replay(self):
        self.out.copy_(self.fn(self.inp))


def _stand_in_capture(fn, x):
    inp = x.clone()
    out = fn(inp)
    return pipeline.Captured(inp, _StandIn(fn, inp, out), out, 0.0, 0)


def test_only_the_stage_flag_joins_the_graph_key(monkeypatch, small):
    _, qi, stack, cb, packed = small
    monkeypatch.setattr(pipeline, "_use_graph", lambda graph, x: graph)
    monkeypatch.setattr(pipeline, "capture", _stand_in_capture)
    qi.graphs.clear()
    q, s = _query(qi, graph=True), _serve(qi, cb, graph=True)
    want = (q.checksum_pass(stack), s(packed))
    keys = list(qi.graphs)
    assert len(keys) == 2
    trace.enable()
    assert (q.checksum_pass(stack), s(packed)) == want
    assert list(qi.graphs) == keys
    trace.enable(stages=True)
    assert (q.checksum_pass(stack), s(packed)) == want
    assert list(qi.graphs) == keys + [k + ("marked",) for k in keys]
    out = {k: qi.graphs[k].out for k in qi.graphs}
    assert [tuple(out[k].shape) for k in keys] == [(5,), (CH, 6)]
    assert [tuple(out[k + ("marked",)].shape) for k in keys] == [(9,), (CH, 9)]
    qi.graphs.clear()


class _Event:
    """A stand-in for ``torch.cuda.Event``: a record takes the next tick."""

    made = 0
    clock = 0.0

    def __init__(self, enable_timing=False, external=False):
        assert enable_timing and external
        _Event.made += 1
        self.t = None

    def record(self):
        _Event.clock += 1.0
        self.t = _Event.clock

    def elapsed_time(self, other):
        return other.t - self.t


def test_marks_settle_into_device_stages(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    _Event.made, _Event.clock = 0, 0.0
    trace.enable(stages=True)
    x = _FakeCuda()

    def chunks(_):
        for _ in range(2):
            trace.mark("main", x)
            trace.mark("phase2", x)
            _Event.clock += 2.0  # the phase-2 stage's own time
            trace.mark("reduce", x)
        return x

    fn = trace.collecting(chunks)
    with trace.pass_span("query.pass"):
        fn(x)
        trace.launched(fn.marks)
        trace.settle()
    with trace.pass_span("query.pass"):
        fn(x)  # the second run takes the first run's events again
        trace.launched(fn.marks)
        trace.settle()
    assert _Event.made == 7
    dev = trace.snapshot()["device"]
    assert [(d["stage"], d["chunk"], d["pass"]) for d in dev[:6]] == [
        ("main", 0, 0), ("phase2", 0, 0), ("reduce", 0, 0),
        ("main", 1, 0), ("phase2", 1, 0), ("reduce", 1, 0)]
    assert [d["ms"] for d in dev[:6]] == [1.0, 3.0, 1.0, 1.0, 3.0, 1.0]
    assert [d["pass"] for d in dev[6:]] == [1] * 6
    trace.settle()  # nothing pending
    assert len(trace.snapshot()["device"]) == 12


def test_kcdict_build_spans():
    unitigs = synth.synthetic_spt(4 * synth.PIECE, seed=0)[0]
    trace.enable()
    KCDict.from_unitig_set(unitigs, load=0.25, scheme="mono2")
    spans = trace.snapshot()["spans"]
    names = [s["name"] for s in spans]
    assert names == ["kcdict.build", "kcdict.keys", "kcdict.place", "kcdict.rows"]
    assert spans[0]["attrs"] == {"scheme": "mono2"}
    assert [s["parent"] for s in spans] == [None, 0, 0, 0]
