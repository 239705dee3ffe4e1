"""The readers of the program's own instruments (``portbench/program.py``)
on hand-built traces and tracer snapshots, and the stage tool
(``portbench/stages.py``) end to end on the host at a small size."""

import pytest

from portbench import program
from portbench.trace import Trace


def _trace():
    # window [0, 1000) ns, 2 batches; busy [100, 300), [500, 600), [900, 1000)
    dev = [("k", "kernel", 100, 300), ("Memcpy HtoD", "gpu_memcpy", 500, 600),
           ("k", "kernel", 900, 1000)]
    host = [("window", 0, 1000), ("batch", 0, 1000), ("pack", 0, 90), ("pass", 300, 900)]
    return Trace(dev, host, (0, 1000), 2)


# the program's ranges: the gap [300, 500) lies in serve.upload inside
# serve.pass, the gap [600, 900) in serve.pass alone, [0, 100) outside both
PROGRAM = [("reads.pack", 0, 90), ("serve.pass", 300, 880), ("serve.upload", 320, 480),
           ("serve.launch", 480, 610), ("serve.readback", 610, 700)]


def test_idle_gaps_by_innermost_program_span():
    tr = _trace()
    assert program.idle_gaps(tr) == [(0, 100), (300, 500), (600, 900)]
    by = dict(program.idle_by_program(tr, PROGRAM))
    # [0, 100) middle 50 -> reads.pack; [300, 500) middle 400 -> serve.upload;
    # [600, 900) middle 750 -> serve.pass
    assert by == pytest.approx({"reads.pack": 100e-9, "serve.upload": 200e-9,
                                "serve.pass": 300e-9})


def test_a_gap_outside_every_program_span():
    tr = _trace()
    by = dict(program.idle_by_program(tr, [("serve.upload", 320, 480)]))
    assert by == pytest.approx({"outside": 400e-9, "serve.upload": 200e-9})
    # only the serve.* gaps count for the serve family, a batch at a time
    assert program.pass_idle_ms(tr, PROGRAM, "serve") == pytest.approx(500e-6 / 2)
    assert program.pass_idle_ms(tr, [("serve.upload", 320, 480)], "serve") == \
        pytest.approx(200e-6 / 2)
    assert program.pass_idle_ms(tr, PROGRAM, "query") is None
    assert program.pass_idle_ms(tr, [], "serve") is None


def test_capture_ranges_in_the_window():
    tr = _trace()
    assert program.in_window(tr, [("graph.capture", -50, -10)], "graph.capture") == 0
    assert program.in_window(tr, [("graph.capture", 990, 1200)], "graph.capture") == 1


def _snap(device=(), counters=None, spans=()):
    return {"spans": list(spans), "device": list(device), "counters": counters or {}}


def test_stage_ms_and_slot_fill():
    dev = [{"stage": "main", "ms": 1.0, "pass": 0, "chunk": 0},
           {"stage": "phase2", "ms": 4.0, "pass": 0, "chunk": 0},
           {"stage": "main", "ms": 1.5, "pass": 0, "chunk": 1},
           {"stage": "phase2", "ms": 3.5, "pass": 1, "chunk": 0}]
    snap = _snap(dev, {"phase2.slots": 400, "phase2.occurrences": 100, "phase2.lanes": 60})
    assert program.stage_ms(snap, 2) == {"main": 1.25, "phase2": 3.75}
    assert program.slot_fill(snap) == 25.0


def test_a_snapshot_without_device_stages_reads_none():
    snap = _snap(counters={"passes": 3})
    assert program.stage_ms(snap, 2) is None
    assert program.slot_fill(snap) is None
    assert program.span_s(snap, "kcdict.place") is None


def test_span_seconds():
    spans = [{"name": "kcdict.build", "start_ns": 0, "end_ns": 5_000_000_000},
             {"name": "kcdict.place", "start_ns": 1_000_000_000, "end_ns": 3_500_000_000},
             {"name": "index.to_device", "start_ns": 0, "end_ns": 1_000}]
    snap = _snap(spans=spans)
    assert program.span_s(snap, "kcdict.place") == pytest.approx(2.5)
    assert program.span_table(snap, ("kcdict.",)) == {"kcdict.build": (5.0, 1),
                                                      "kcdict.place": (2.5, 1)}


@pytest.mark.parametrize("cell", ["tx50-mono2.reads", "tx50-mono2.kmers"])
def test_stage_tool_on_the_host(cell):
    """The stage tool at a small size on the CPU: the set-up spans, the
    program's ranges in the profiled window, the marked passes' counters
    (no device stage on the host) and their results equal to the unmarked."""
    import torch

    from mazu_tpu_torch import trace
    from portbench.stages import measure
    from portbench.tests.small import small_spec

    out = measure(small_spec(cell), 11, 0.2, torch.device("cpu"))
    assert not trace.TRACER.on and trace.snapshot()["spans"] == []
    assert out["kcdict_place_s"] > 0
    assert {"kcdict.build", "kcdict.keys", "kcdict.place", "kcdict.rows",
            "index.device_arrays"} <= set(out["setup_spans"])
    assert out["program_ranges"] > 0 and out["captures_in_window"] == 0
    assert out["stage_ms_a_batch"] == {} and out["device_stages"] == 0
    c = out["counters"]
    assert c["passes"] == 3 and 0 < c["phase2.occurrences"] <= c["phase2.slots"]
    assert 0 < out["slot_fill_pct"] <= 100 and 0 < out["lane_fill_pct"] <= 100
    n, m = out["marked_equals_unmarked"].split(" of ")
    assert n == m and int(n) > 0
