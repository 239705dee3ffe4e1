"""Gather-rate labs on one CUDA card (counterparts of ``labs/pallas_probe.py``
and ``labs/tpu_dma_lab.py``): ``python -m mazu_tpu_torch.labs.gather_probe``
and ``python -m mazu_tpu_torch.labs.dma_lab``, each with ``cpu`` to run the
plain versions at the labs' CPU sizes."""

from __future__ import annotations

import time

import torch


CLOCK_HZ = 2.0e9  # cycles per second assumed for the queue-filling sleep


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call on the card (CUDA events), after a
    warm-up call. The calls are queued behind a device sleep as long as
    twice their host time, so a kernel shorter than its launch is timed on
    the device and not at the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(min(2 * iters * host_s, 1.0) * CLOCK_HZ))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def lab_device(target: str) -> torch.device:
    """``cpu``, or the card (``gpu``, the default), which must exist."""
    if target == "cpu":
        return torch.device("cpu")
    if target != "gpu":
        raise SystemExit(f"unknown target {target!r}: gpu or cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run with 'cpu' for the plain versions")
    return torch.device("cuda", 0)
