"""Where a cell's time goes inside the program, from the program's own
instruments (``mazu_tpu_torch.trace``). Not a benchmark run: it checks no
result, and ``run.py`` stays the measurement. From the root of a checkout:

    python3 portbench/stages.py --workload <cell> --seed <n> --seconds <s> [--json FILE]

One process, in this order:

1. Set-up as ``run.py`` makes it (the sequence set, the index build, the
   traffic pool, each batch shape run twice), with the tracer on without
   device stages (``trace.enable()``): the build, kernel-build and capture
   spans. The graphs captured are the unmarked ones ``run.py`` replays.
2. The untraced window of ``seconds``, tracing off (ms a batch).
3. ``trace_batches`` batches under ``torch.profiler`` (CUDA and CPU), as
   ``run.py --trace 1`` runs them: the program's ``mazu.`` ranges lie in
   the profiler's timeline, so each idle gap is put down to the innermost
   program span open at its middle.
4. The stage loop: ``trace.enable(stages=True)``, one pass of each graph
   kind the pool holds (the marked graphs' capture), then
   ``trace_batches`` pool batches, each between two CUDA events outside
   its graph: device ms a batch by stage, the ``phase2.*`` counters, and
   whether each batch's result equals the unmarked pass's result of the
   same pool batch.

Prints progress on standard error and one JSON object as the last line of
standard output (also written to ``--json``). Exits 2 without a CUDA card.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SETUP_SPANS = ("kcdict.", "index.", "kernel.build", "host_lib.build", "graph.capture",
               "reads.pack")


def measure(spec: dict, seed: int, seconds: float, device) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from mazu_tpu_torch import trace
    from portbench import genome as genome_mod
    from portbench import program
    from portbench import trace as trace_mod
    from portbench.harness import _free, _sync, log

    cfg, mix = spec["config"], spec["mix"]
    out = {"cell": spec["name"], "seed": seed}
    cuda = device.type == "cuda"

    def no_span(name):
        return contextlib.nullcontext()

    # 1. set-up, host spans and counters on
    trace.reset()
    trace.enable()
    t0 = time.perf_counter()
    genome = genome_mod.make(cfg, seed, device)
    build = importlib.import_module(f"portbench.builds.{cfg['build']}")
    index, qi = build.build(genome, cfg, device)
    _sync(device)
    kind = importlib.import_module(f"portbench.traffic.{mix['kind']}")
    traffic = kind.Traffic(spec, genome, seed, device)
    traffic.attach(index, qi)
    genome.drop_device_copies()
    _free(device)
    for i in traffic.warm_ids():
        traffic.run(i, no_span)
        traffic.run(i, no_span)
    for i in range(1, min(3, len(traffic))):
        traffic.run(i, no_span)
    _sync(device)
    trace.disable()
    setup = trace.snapshot()
    out["setup_s"] = time.perf_counter() - t0
    out["setup_spans"] = {k: [round(s, 6), n] for k, (s, n) in
                          program.span_table(setup, SETUP_SPANS).items()}
    out["setup_counters"] = setup["counters"]
    out["kcdict_place_s"] = program.span_s(setup, "kcdict.place")
    log(f"set-up {out['setup_s']:.2f} s; spans (s, count) {out['setup_spans']}; "
        f"counters {setup['counters']}")
    unmarked = {key for key in qi.graphs}

    # 2. the untraced window
    results = {}
    b, t_w = 0, time.perf_counter()
    while True:
        i = b % len(traffic)
        results[i] = traffic.run(i, no_span)[0]
        b += 1
        if time.perf_counter() - t_w >= seconds:
            break
    window_s = time.perf_counter() - t_w
    out["untraced_ms_a_batch"] = 1e3 * window_s / b
    log(f"untraced window: {b} batches in {window_s:.3f} s, "
        f"{out['untraced_ms_a_batch']:.3f} ms a batch")

    # 3. the profiled batches, the program's ranges in the timeline
    n_tr = int(mix["trace_batches"])

    def bench_span(name):
        return record_function(f"portbench.{name}")

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function("portbench.window"):
            for b in range(n_tr):
                with record_function("portbench.batch"):
                    traffic.run(b % len(traffic), bench_span)
            _sync(device)
    tr = trace_mod.from_profiler(prof, n_tr)
    prog = program.program_ranges(prof)
    del prof
    fam = "serve" if mix["kind"] == "reads" else "query"
    busy = trace_mod.busy_s(tr)
    gaps = trace_mod.idle_by_host(tr)
    pass_gap = dict(gaps).get("pass", 0.0)
    out.update({
        "traced_ms_a_batch": 1e3 * trace_mod.window_s(tr) / n_tr,
        "busy_ms_a_batch": 1e3 * busy / n_tr,
        "idle_gaps_ms_a_batch": {k: 1e3 * v / n_tr for k, v in gaps},
        "idle_by_program_ms_a_batch": {k: 1e3 * v / n_tr
                                       for k, v in program.idle_by_program(tr, prog)},
        "pass_idle_ms": program.pass_idle_ms(tr, prog, fam),
        "pass_gap_ms_a_batch": 1e3 * pass_gap / n_tr,
        "captures_in_window": program.in_window(tr, prog, "graph.capture"),
        "program_ranges": len(prog),
    })
    if pass_gap and out["pass_idle_ms"] is not None:
        out["pass_gap_named_pct"] = 100.0 * out["pass_idle_ms"] * 1e-3 * n_tr / pass_gap
    log(f"profiled {n_tr} batches: {out['traced_ms_a_batch']:.3f} ms a batch, busy "
        f"{out['busy_ms_a_batch']:.3f}; idle by benchmark span (ms a batch) "
        f"{out['idle_gaps_ms_a_batch']}; by program span {out['idle_by_program_ms_a_batch']}; "
        f"{fam}.* idle {out['pass_idle_ms']} ms a batch; mazu.graph.capture ranges in the "
        f"window: {out['captures_in_window']}")
    out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device)) if cuda else 0

    # 4. the stage loop: marked graphs
    trace.reset()
    trace.enable(stages=True)
    t0 = time.perf_counter()
    for i in traffic.warm_ids():
        traffic.run(i, no_span)
    _sync(device)
    out["marked_capture_s"] = time.perf_counter() - t0
    trace.reset()
    outer, same, compared = [], 0, 0
    t0 = time.perf_counter()
    for b in range(n_tr):
        i = b % len(traffic)
        if cuda:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
        res = traffic.run(i, no_span)[0]
        if cuda:
            e1.record()
            e1.synchronize()
            outer.append(e0.elapsed_time(e1))
        if i in results:
            compared += 1
            same += res == results[i]
    loop_s = time.perf_counter() - t0
    snap = trace.snapshot()
    trace.disable()
    trace.reset()
    for key in [k for k in qi.graphs if k not in unmarked]:
        del qi.graphs[key]
    stages = program.stage_ms(snap, n_tr) or {}
    per_pass = {}
    for d in snap["device"]:
        per_pass[d["pass"]] = per_pass.get(d["pass"], 0.0) + d["ms"]
    c = snap["counters"]
    m2 = int(spec["capacity"]["m2"])
    chunks = int(mix["chunks"])
    out.update({
        "stage_loop_ms_a_batch": 1e3 * loop_s / n_tr,
        "stage_ms_a_batch": stages,
        "stage_sum_ms_a_batch": sum(stages.values()),
        "stage_sum_over_busy": (sum(stages.values()) / out["busy_ms_a_batch"]
                                if out["busy_ms_a_batch"] else None),
        "outer_events_ms": outer,
        "stage_sum_ms_by_pass": [per_pass[p] for p in sorted(per_pass)],
        "stage_zero_or_less": sum(1 for d in snap["device"] if d["ms"] <= 0.0),
        "device_stages": len(snap["device"]),
        "counters": c,
        "slot_fill_pct": program.slot_fill(snap),
        "lane_fill_pct": (100.0 * c["phase2.lanes"] / (n_tr * chunks * m2)
                          if "phase2.lanes" in c else None),
        "marked_equals_unmarked": f"{same} of {compared}",
    })
    log(f"stage loop: {n_tr} batches, {out['stage_loop_ms_a_batch']:.3f} ms a batch (untraced "
        f"{out['untraced_ms_a_batch']:.3f}); device ms a batch by stage "
        f"{ {k: round(v, 3) for k, v in stages.items()} }, sum "
        f"{out['stage_sum_ms_a_batch']:.3f} = {out['stage_sum_over_busy']} of the profiled "
        f"busy ms; events around each batch {[round(x, 3) for x in outer]}; stage sums a pass "
        f"{[round(x, 3) for x in out['stage_sum_ms_by_pass']]}; {out['stage_zero_or_less']} of "
        f"{out['device_stages']} stages <= 0 ms; counters {c}; slot fill "
        f"{out['slot_fill_pct']}%, lane fill {out['lane_fill_pct']}%; marked == unmarked "
        f"{out['marked_equals_unmarked']}")
    traffic.release()
    del index, qi
    _free(device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--json", help="also write the result object to this file")
    args = ap.parse_args(argv)
    cache = ROOT / ".portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    sys.path[0] = str(ROOT)

    import torch

    from portbench.harness import cell_spec, log

    if not torch.cuda.is_available():
        print("portbench stages: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = measure(cell_spec(args.workload), args.seed, args.seconds, device)
    out["device"] = torch.cuda.get_device_name(device)
    log(f"stages took {time.perf_counter() - T0:.1f} s")
    line = json.dumps(out)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
