"""The gather-rate lab kernels L1-L5: CUDA kernels, build and wrappers
(counterparts of the Pallas kernels of ``labs/pallas_probe.py`` and
``labs/tpu_dma_lab.py``).

Each wrapper has a plain torch version beside it with the same contract.
CPU tensors take the plain version; CUDA tensors launch the kernel of
``csrc/gather_lab.cu`` or raise. u32 values travel as int32 bit patterns.

- ``gather_u32(tbl, idx)``: ``tbl[idx]`` (L1);
- ``hash_mix32x8(x)``: 8 rounds of ``z = (z ^ (z >> 16)) * 0x85EBCA6B``
  mod 2^32 (L2);
- ``xor_rows(idx, tbl)``: the XOR of rows ``tbl[idx]`` as one (1, 128) row
  (L3); ``xor_rows_ring`` computes the same through an async-copy ring (L4);
- ``gather_rows(idx, tbl)``: the rows ``tbl[idx]``, i32[N, 128] (L5);
  ``tiled(idx, tbl)`` folds them with ``xor_fold``, as the lab did outside
  its kernel.

The kernels are compiled on first use (``cuda_build``) and loaded with
``ctypes``. ``LAUNCHES[name]`` counts each kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CSRC, compile_library

SOURCE = CSRC / "gather_lab.cu"
NAMES = ("gather_u32", "hash_mix32x8", "xor_rows", "xor_rows_ring", "gather_rows")
LAUNCHES = dict.fromkeys(NAMES, 0)
ROW = 128  # i32 columns of a lab row (512 bytes)
_C = 0x85EBCA6B
_LIB = None


def _fn(name: str):
    global _LIB
    if _LIB is None:
        path, _ = compile_library(SOURCE)
        lib = ctypes.CDLL(str(path))
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        for nm in NAMES:
            f = getattr(lib, nm)
            f.argtypes = ([p, i64, ctypes.c_int, p] if nm == "hash_mix32x8"
                          else [p, p, p, i64, p])
            f.restype = ctypes.c_int
        _LIB = lib
    return getattr(_LIB, name)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch(name: str, *args):
    """Launch kernel ``name`` on the current stream of the first tensor's
    device; tensors go as their data pointers."""
    err = _fn(name)(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
                    _stream(args[0].device))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _on_card(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (all on one device), False for CPU tensors;
    raises for anything else."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev.type == "cuda"


def _check_1d_i32(name: str, what: str, t: torch.Tensor):
    if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be a contiguous 1-D int32 tensor")


def _check_rows(name: str, idx: torch.Tensor, tbl: torch.Tensor):
    _check_1d_i32(name, "idx", idx)
    if (tbl.dtype != torch.int32 or tbl.dim() != 2 or tbl.shape[1] != ROW
            or not tbl.is_contiguous() or tbl.data_ptr() % 16):
        raise ValueError(f"{name}: tbl must be a contiguous, 16-byte aligned int32 "
                         f"[T, {ROW}] tensor")


# ---------------------------------------------------------------- L1


def gather_u32_plain(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return tbl[idx.to(torch.int64)]


def gather_u32(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``tbl[idx]`` for an int32 (u32 bits) table and int32 indices in
    [0, len(tbl)) (the kernel does not check them)."""
    if not _on_card("gather_u32", tbl, idx):
        return gather_u32_plain(tbl, idx)
    _check_1d_i32("gather_u32", "tbl", tbl)
    _check_1d_i32("gather_u32", "idx", idx)
    out = torch.empty_like(idx)
    if idx.numel():
        _launch("gather_u32", tbl, idx, out, idx.numel())
    return out


# ---------------------------------------------------------------- L2


def hash_mix32x8_plain(x: torch.Tensor) -> torch.Tensor:
    """In int64 masked to 32 bits (int32 ``>>`` is arithmetic)."""
    z = x.to(torch.int64) & 0xFFFFFFFF
    for _ in range(8):
        z = ((z ^ (z >> 16)) * _C) & 0xFFFFFFFF
    return torch.where(z >= 1 << 31, z - (1 << 32), z).to(torch.int32)


def hash_mix32x8(x: torch.Tensor) -> torch.Tensor:
    if not _on_card("hash_mix32x8", x):
        return hash_mix32x8_plain(x)
    _check_1d_i32("hash_mix32x8", "x", x)
    out = torch.empty_like(x)
    if x.numel():
        vec = int(x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
        _launch("hash_mix32x8", x, out, x.numel(), vec)
    return out


# ---------------------------------------------------------------- L3-L5


def xor_fold(rows: torch.Tensor) -> torch.Tensor:
    """XOR of the rows of ``rows`` [N, C] as a (1, C) row: halves folded
    onto each other (torch has no XOR reduction)."""
    x = rows
    if x.shape[0] == 0:
        return torch.zeros(1, x.shape[1], dtype=x.dtype, device=x.device)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        y = x[:h] ^ x[h : 2 * h]
        if x.shape[0] % 2:
            y = torch.cat([y[:1] ^ x[2 * h :], y[1:]])
        x = y
    return x.clone()


def xor_rows_plain(idx: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    return xor_fold(tbl[idx.to(torch.int64)])


def _xor_rows(name: str, idx: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    if not _on_card(name, idx, tbl):
        return xor_rows_plain(idx, tbl)
    _check_rows(name, idx, tbl)
    out = torch.zeros(1, ROW, dtype=torch.int32, device=idx.device)
    if idx.numel():
        _launch(name, tbl, idx, out, idx.numel())
    return out


def xor_rows(idx: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """XOR of the 512-byte rows ``tbl[idx]``, a (1, 128) int32 row (L3)."""
    return _xor_rows("xor_rows", idx, tbl)


def xor_rows_ring(idx: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """``xor_rows``, each row fetched through an 8-deep async-copy ring (L4)."""
    return _xor_rows("xor_rows_ring", idx, tbl)


def gather_rows_plain(idx: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    return tbl[idx.to(torch.int64)]


def gather_rows(idx: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """The rows ``tbl[idx]``, int32 [N, 128] (L5)."""
    if not _on_card("gather_rows", idx, tbl):
        return gather_rows_plain(idx, tbl)
    _check_rows("gather_rows", idx, tbl)
    out = torch.empty(idx.numel(), ROW, dtype=torch.int32, device=idx.device)
    if idx.numel():
        _launch("gather_rows", tbl, idx, out, idx.numel())
    return out


def tiled(idx: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """The lab's ``tiled``: rows gathered by L5, then folded outside it."""
    return xor_fold(gather_rows(idx, tbl))
