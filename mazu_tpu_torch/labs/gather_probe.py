"""Gather and hash rates on one CUDA card (counterpart of
``labs/pallas_probe.py``): a batched dynamic gather from a table small
enough to stay resident (L1, beside torch's own ``tbl[idx]``, the lab's
``xla_gather``), and u32 hashing throughput inside a kernel (L2).

    python -m mazu_tpu_torch.labs.gather_probe [gpu|cpu]

``gpu`` (the default) checks each kernel against NumPy and prints its
time and rate at the lab's shapes (N = 2^20 indices into a 2^18-word
table); ``cpu`` checks the plain versions at N = 64, M = 256.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import cuda_ms, lab_device
from ..ops import gather_lab

N = 1 << 20
M = 1 << 18  # a 1 MB u32 table
CPU_N, CPU_M = 64, 256


def inputs(n: int, m: int, device, seed: int = 0):
    """(tbl, idx, x) as the lab draws them: int32 tensors holding u32 bits."""
    rng = np.random.default_rng(seed)
    tbl = rng.integers(0, 1 << 31, m, dtype=np.uint32)
    idx = rng.integers(0, m, n, dtype=np.int32)
    x = rng.integers(0, 1 << 31, n, dtype=np.uint32)
    return tuple(torch.from_numpy(a.view(np.int32)).to(device) for a in (tbl, idx, x))


def mix32x8_np(x: np.ndarray) -> np.ndarray:
    z = x.astype(np.uint32)
    for _ in range(8):
        z = (z ^ (z >> np.uint32(16))) * np.uint32(0x85EBCA6B)
    return z


def run(device, n: int = N, m: int = M, log=print) -> dict:
    """Check both kernels (the plain versions on the CPU) against NumPy;
    on the card also time them and ``tbl[idx]``. Returns milliseconds per
    call by name ({} on the CPU)."""
    tbl, idx, x = inputs(n, m, device)
    want = tbl.cpu().numpy()[idx.cpu().numpy()]
    ok_g = np.array_equal(gather_lab.gather_u32(tbl, idx).cpu().numpy(), want)
    want_h = mix32x8_np(x.cpu().numpy().view(np.uint32))
    ok_h = np.array_equal(gather_lab.hash_mix32x8(x).cpu().numpy().view(np.uint32), want_h)
    if not (ok_g and ok_h):
        raise AssertionError(f"gather ok={ok_g}, mix32x8 ok={ok_h}")
    if device.type == "cpu":
        log("gather_u32: CORRECT (plain)")
        log("mix32x8:    CORRECT (plain)")
        return {}
    ms = {
        "gather_u32": cuda_ms(lambda: gather_lab.gather_u32(tbl, idx), 20),
        "xla_gather": cuda_ms(lambda: tbl[idx], 20),
        "hash_mix32x8": cuda_ms(lambda: gather_lab.hash_mix32x8(x), 20),
    }
    log("gather_u32: CORRECT")
    for name, t in ms.items():
        log(f"{name + ':':14s} {t:.4f} ms ({n / t / 1e6:.3f} G/s)")
    return ms


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = lab_device(argv[0] if argv else "gpu")
    if device.type == "cpu":
        run(device, CPU_N, CPU_M)
    else:
        run(device)


if __name__ == "__main__":
    main()
