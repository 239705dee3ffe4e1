"""One run of one cell: set-up, the measured (or traced) window, the
reference's check of every batch the window ran, and the metrics.

Everything that belongs to a cell is found by name: the cell in
``BENCHMARK.json``, its phase-2 capacities in ``workloads/<cell>.json``,
its configuration in the file that ``BENCHMARK.json`` names, its traffic
mix in ``traffic/<mix>.json`` with the generator and driver of the mix's
kind in ``traffic/<kind>.py``, the index build of the configuration's kind
in ``builds/<build>.py``, and each metric's reader in
``metrics/<metric>.py``.

Set-up makes the sequence set from the seed, builds the port's index on
the device (the span ``index_build_s``), makes the traffic pool, and runs
each batch shape once, which captures its CUDA graph, and once more. The
window then hands the port one pool batch after another, in pool order,
until ``seconds`` have passed, and keeps each batch's result. With
``trace`` the mix's ``trace_batches`` batches then run under
``torch.profiler``. Once the peak memory is read, the traffic may read the
program once more (``after_window``), the port's objects are dropped, and
the reference works out the right results of every pool batch that ran; a
batch whose result is not among them is wrong.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import genome as genome_mod
from . import trace as trace_mod

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _merge(base: dict, over: dict | None) -> dict:
    out = dict(base)
    out.update(over or {})
    return out


def cell_spec(name: str, overrides: dict | None = None) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic mix, capacities and metrics. ``overrides`` (for tests) replaces
    keys of the ``config``, ``mix`` and ``capacity`` parts."""
    bench = _load(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    over = overrides or {}
    return {
        "name": name,
        "chips": int(w["chips"]),
        "config": _merge(_load(ROOT / conf["file"]), over.get("config")),
        "mix": _merge(_load(PKG / "traffic" / f"{w['traffic']}.json"), over.get("mix")),
        "capacity": _merge(_load(PKG / "workloads" / f"{name}.json")["capacity"],
                           over.get("capacity")),
        "end_to_end": [m for m in bench["end_to_end"] if _applies(m, name)],
        "per_layer": [m for m in bench["per_layer"] if _applies(m, name)],
    }


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Run:
    """What a run measured, as the metric readers read it."""

    setup_s: float = 0.0
    index_build_s: float = 0.0
    window_s: float = 0.0
    work: int = 0
    latencies_ms: list = field(default_factory=list)
    pack_s: list = field(default_factory=list)
    batches: int = 0
    trace: object = None
    probe_lanes: int = 0


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float | None = None) -> dict:
    """One run of the cell ``spec`` (``cell_spec``'s) on ``device``: the
    result line's object, ``checks`` last."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    t_start = time.perf_counter() if t_start is None else t_start
    cfg, mix = spec["config"], spec["mix"]
    run = Run()

    t0 = time.perf_counter()
    genome = genome_mod.make(cfg, seed, device)
    _sync(device)
    log(f"genome: {len(genome.ref_accum) - 1} references of {int(genome.ref_accum[-1])} bases, "
        f"{genome.n_unitigs} unitigs of {genome.n_bases} bases, {len(genome.occ_ref)} "
        f"occurrences (at most {int((genome.offsets[1:] - genome.offsets[:-1]).max())} a "
        f"unitig) in {time.perf_counter() - t0:.2f} s")
    build = importlib.import_module(f"portbench.builds.{cfg['build']}")
    t0 = time.perf_counter()
    index, qi = build.build(genome, cfg, device)
    _sync(device)
    run.index_build_s = time.perf_counter() - t0
    log(f"index: {cfg['build']} built and on {device} in {run.index_build_s:.2f} s, "
        f"{qi.nbytes()} bytes")
    t0 = time.perf_counter()
    kind = importlib.import_module(f"portbench.traffic.{mix['kind']}")
    traffic = kind.Traffic(spec, genome, seed, device)
    traffic.attach(index, qi)
    genome.drop_device_copies()
    _free(device)
    log(f"traffic: a pool of {len(traffic)} batches in {time.perf_counter() - t0:.2f} s")

    def no_span(name):
        return contextlib.nullcontext()

    t0 = time.perf_counter()
    for i in traffic.warm_ids():
        traffic.run(i, no_span)
        traffic.run(i, no_span)
    for i in range(1, min(3, len(traffic))):
        traffic.run(i, no_span)
    _sync(device)
    traffic.pack_s = []
    log(f"warm-up and capture {time.perf_counter() - t0:.2f} s")
    run.setup_s = time.perf_counter() - t_start

    done, failed = [], []
    b = 0
    t_w = time.perf_counter()
    while True:
        i = b % len(traffic)
        if cuda:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
        h0 = time.perf_counter()
        try:
            res, work = traffic.run(i, no_span)
        except RuntimeError as e:
            failed.append((i, str(e)))
            res = work = None
        if cuda:
            e1.record()
            e1.synchronize()
            lat = e0.elapsed_time(e1)
        else:
            lat = 1e3 * (time.perf_counter() - h0)
        if res is not None:
            done.append((i, res, work))
            run.latencies_ms.append(lat)
        b += 1
        if time.perf_counter() - t_w >= seconds:
            break
    run.window_s = time.perf_counter() - t_w
    run.batches = b
    run.work = sum(w for _, _, w in done)
    run.pack_s = list(getattr(traffic, "pack_s", []))
    n_window = len(done) + len(failed)

    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        def span(name):
            return record_function(f"portbench.{name}")

        n_tr = int(mix["trace_batches"])
        traffic.pack_s = []
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            with record_function("portbench.window"):
                for b in range(n_tr):
                    i = b % len(traffic)
                    with record_function("portbench.batch"):
                        done.append((i, *traffic.run(i, span)))
                _sync(device)
        t0 = time.perf_counter()
        run.trace = trace_mod.from_profiler(prof, n_tr)
        del prof
        if cuda and not run.trace.device:
            raise RuntimeError("the profiler recorded no device operation in the window")
        log(f"traced {n_tr} batches in {trace_mod.window_s(run.trace):.3f} s "
            f"({1e3 * trace_mod.window_s(run.trace) / n_tr:.3f} ms a batch, untraced "
            f"{1e3 * run.window_s / max(1, run.batches):.3f}); {len(run.trace.device)} device "
            f"operations read in {time.perf_counter() - t0:.2f} s")
    run.probe_lanes = traffic.probe_lanes()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    diag = traffic.diagnostics()
    log(f"window: {n_window} batches, {len(failed)} failed, {run.window_s:.3f} s; {diag}")
    for i, msg in failed[:3]:
        log(f"failed batch (pool {i}): {msg}")

    ids = sorted({i for i, _, _ in done})
    t0 = time.perf_counter()
    after = traffic.after_window(ids)
    if after:
        log(f"the program's eager path read again over {len(ids)} pool batches in "
            f"{time.perf_counter() - t0:.2f} s")
    traffic.release()
    del index, qi
    _free(device)
    t0 = time.perf_counter()
    right = traffic.expected(ids)
    wrong = sum(not traffic.matches(r, right[i], after.get(i)) for i, r, _ in done)
    log(f"reference: {len(ids)} pool batches worked out in {time.perf_counter() - t0:.2f} s; "
        f"{wrong} of {len(done)} results wrong")

    metrics = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        v = metric_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else device.type,
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    out = {
        "correct": bool(done) and not failed and wrong == 0,
        "attempted": len(done) + len(failed),
        "failed": len(failed),
        "metrics": metrics,
        "device": dev,
    }
    if run.trace is not None:
        dev["busy_s"] = trace_mod.busy_s(run.trace)
        dev["window_s"] = trace_mod.window_s(run.trace)
        out["breakdown"] = {"device_ops": trace_mod.top_ops(run.trace),
                            "idle_gaps": trace_mod.idle_by_host(run.trace)}
    out["checks"] = {
        "wrong_batches": {"value": wrong, "limit": 0},
        "failed_batches": {"value": len(failed), "limit": 0},
    }
    return out
