"""Random 512-byte row-gather rates on one CUDA card (counterpart of
``labs/tpu_dma_lab.py``).

N random (1, 128) i32 rows of an i32[T, 128] table, by four strategies:

- ``vmem_loop`` -> L3 ``xor_rows``: one wave of blocks, a contiguous run
  of indices a warp, four rows a lane in flight in registers, XOR-folded
  through a scratch row a block;
- ``dma_ring`` -> L4 ``xor_rows_ring``: the same, each row through an
  8-deep ring of ``cp.async`` copies a warp into shared memory;
- ``tiled`` -> L5 ``gather_rows``: rows written back to device memory,
  XOR-folded outside the kernel;
- ``xla``: torch's ``tbl[idx]`` and the same fold.

All four return the XOR of the rows as one (1, 128) row.

    python -m mazu_tpu_torch.labs.dma_lab [gpu|cpu]

``gpu`` (the default) runs T = 16384 (an 8 MB table: it fits the H100's
50 MB L2, so the ring's rows come from L2 after the first call) and
N = 2^18; ``cpu`` runs the plain versions at T = 256, N = 64.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import cuda_ms, lab_device
from ..ops import gather_lab

T, N = 16384, 1 << 18
CPU_T, CPU_N = 256, 64
ROW_BYTES = 4 * gather_lab.ROW


def inputs(t: int, n: int, device, seed: int = 0):
    """(tbl, idx) as the lab draws them."""
    rng = np.random.default_rng(seed)
    tbl = rng.integers(0, 1 << 31, size=(t, gather_lab.ROW), dtype=np.int32)
    idx = rng.integers(0, t, size=n, dtype=np.int32)
    return torch.from_numpy(tbl).to(device), torch.from_numpy(idx).to(device)


def fns() -> dict:
    return {
        "vmem_loop": gather_lab.xor_rows,
        "dma_ring": gather_lab.xor_rows_ring,
        "tiled": gather_lab.tiled,
        "xla": lambda idx, tbl: gather_lab.xor_fold(tbl[idx]),
    }


def run(device, t: int = T, n: int = N, log=print) -> dict:
    """Check every strategy against NumPy (the plain versions on the CPU);
    on the card also time each. Returns milliseconds per call by strategy
    ({} on the CPU)."""
    tbl, idx = inputs(t, n, device)
    want = np.bitwise_xor.reduce(tbl.cpu().numpy()[idx.cpu().numpy()], axis=0)[None, :]
    ms = {}
    for name, fn in fns().items():
        ok = np.array_equal(fn(idx, tbl).cpu().numpy(), want)
        if not ok:
            raise AssertionError(f"{name}: the XOR of the rows differs from NumPy's")
        if device.type == "cpu":
            log(f"{name:10s} ok={ok} (plain)")
            continue
        ms[name] = cuda_ms(lambda: fn(idx, tbl), 5)
        rate = n / ms[name] / 1e3  # M rows/s
        log(f"{name:10s} ok={ok} {ms[name]:.4f} ms -> {rate:.1f} M rows/s "
            f"({rate * ROW_BYTES / 1e3:.1f} GB/s of 512B rows)")
    return ms


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = lab_device(argv[0] if argv else "gpu")
    if device.type == "cpu":
        run(device, CPU_T, CPU_N)
    else:
        run(device)


if __name__ == "__main__":
    main()
