"""The gather-rate lab kernels L1-L5: CUDA kernels, build and wrappers
(counterparts of the Pallas kernels of ``labs/pallas_probe.py`` and
``labs/tpu_dma_lab.py``).

Each wrapper has a plain torch version beside it with the same contract.
CPU tensors take the plain version; CUDA tensors launch the kernel of
``csrc/gather_lab.cu`` or raise. u32 values travel as int32 bit patterns.

- ``gather_u32(tbl, idx)``: ``tbl[idx]`` (L1), launched so that a call
  overlaps its launch with the tail of the kernel before it;
- ``hash_mix32x8(x)``: 8 rounds of ``z = (z ^ (z >> 16)) * 0x85EBCA6B``
  mod 2^32 (L2);
- ``xor_rows(idx, tbl)``: the XOR of rows ``tbl[idx]`` as one (1, 128) row
  (L3); ``xor_rows_ring`` computes the same through an async-copy ring (L4).
  Both run one wave of blocks and fold through a ``[blocks, 128]`` scratch
  that the wrapper allocates (``wave_blocks``); the kernel writes the
  whole output, which nothing zero-fills;
- ``gather_rows(idx, tbl)``: the rows ``tbl[idx]``, i32[N, 128] (L5);
  ``tiled(idx, tbl)`` folds them with ``xor_fold``, as the lab did outside
  its kernel;
- ``l2_stream(tbl, reps, random)``: no port of a TPU kernel, the yardstick
  of the L2 floors: every row of an L2-resident table read ``reps`` times
  in one launch with loads that no SM's L1 serves. Not in ``NAMES``;
- ``l2_sectors(tbl, reps)``: the same for random 4-byte words, each a
  32-byte L2 sector: the L2's random-sector rate (L1's ``sector_floor_ms``);
- ``sector_reads(tbl, idx)``: ``tbl[idx]`` by L1's first design (one
  thread a word), frozen: the random-sector yardstick of K2's and K3's floors over a
  1 GB table, and the "before" of L1's A/B. Neither is in ``NAMES``.

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
FOLD_WARPS = 32  # warps a block of xor_rows, xor_rows_ring and l2_stream
_C = 0x85EBCA6B
_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
ARGTYPES = {  # every entry of SOURCE, its parameters in order (the stream last)
    "gather_u32": [_P, _P, _P, _I64, _P],
    "sector_reads": [_P, _P, _P, _I64, _P],
    "hash_mix32x8": [_P, _P, _I64, _INT, _P],
    "xor_rows_blocks": [],
    "xor_rows_ring_blocks": [],
    "l2_stream_blocks": [],
    "l2_sectors_blocks": [],
    "xor_rows": [_P, _P, _P, _P, _I64, _INT, _P],
    "xor_rows_ring": [_P, _P, _P, _P, _I64, _INT, _P],
    "l2_stream": [_P, _INT, _INT, _INT, _P, _INT, _P],
    "l2_sectors": [_P, _INT, _INT, _P, _INT, _P],
    "gather_rows": [_P, _P, _P, _I64, _P],
}
_LIB = None
_WAVE = {}  # (kernel, device index) -> its blocks of one wave


def _fn(name: str):
    global _LIB
    if _LIB is None:
        path, _ = compile_library(SOURCE)
        lib = ctypes.CDLL(str(path))
        for nm, types in ARGTYPES.items():
            f = getattr(lib, nm)
            f.argtypes = types
            f.restype = ctypes.c_int
        _LIB = lib
    return getattr(_LIB, name)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _call(name: str, *args):
    """Call entry ``name`` on the current stream of the first tensor's
    device; tensors go as their data pointers."""
    err = _fn(name)(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
                    _stream(args[0].device))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _launch(name: str, *args):
    """``_call`` a kernel of ``NAMES`` and count the launch."""
    _call(name, *args)
    LAUNCHES[name] += 1


def wave_blocks(name: str, device: torch.device) -> int:
    """Blocks of one wave of kernel ``name`` (``xor_rows``,
    ``xor_rows_ring``, ``l2_stream``, ``l2_sectors``) on the card: its SMs
    times the blocks of the kernel one SM holds, from the C side's occupancy
    query (``<name>_blocks``); asked once a device. The kernel launches that
    many blocks (and the folds have a scratch row for each)."""
    key = (name, device.index)
    if key not in _WAVE:
        blocks = _fn(f"{name}_blocks")()
        if blocks <= 0:
            raise RuntimeError(f"{name}: no block of one wave (the occupancy query gave "
                               f"{blocks}: minus a CUDA error, or no block fits an SM)")
        _WAVE[key] = blocks
    return _WAVE[key]


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


def _check_table(name: str, tbl: torch.Tensor):
    if (tbl.dtype != torch.int32 or tbl.dim() != 2 or tbl.shape[1] != ROW
            or not tbl.is_contiguous() or tbl.data_ptr() % 16):
        raise ValueError(f"{name}: tbl must be a contiguous, 16-byte aligned int32 "
                         f"[T, {ROW}] tensor")


def _check_rows(name: str, idx: torch.Tensor, tbl: torch.Tensor):
    _check_1d_i32(name, "idx", idx)
    _check_table(name, tbl)


# ---------------------------------------------------------------- L1


def gather_u32_plain(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return tbl[idx.to(torch.int64)]


def gather_u32(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``tbl[idx]`` for an int32 (u32 bits) table and int32 indices in
    [0, len(tbl)) (the kernel does not check them); allocates only the
    output."""
    if not _on_card("gather_u32", tbl, idx):
        return gather_u32_plain(tbl, idx)
    _check_1d_i32("gather_u32", "tbl", tbl)
    _check_1d_i32("gather_u32", "idx", idx)
    out = torch.empty_like(idx)
    if idx.numel():
        _launch("gather_u32", tbl, idx, out, idx.numel())
    return out


def sector_reads(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``tbl[idx]`` by L1's frozen first design (one thread a word): a
    yardstick, not counted in ``LAUNCHES``."""
    if not _on_card("sector_reads", tbl, idx):
        return gather_u32_plain(tbl, idx)
    _check_1d_i32("sector_reads", "tbl", tbl)
    _check_1d_i32("sector_reads", "idx", idx)
    out = torch.empty_like(idx)
    if idx.numel():
        _call("sector_reads", tbl, idx, out, idx.numel())
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
    if not idx.numel():
        return xor_fold(tbl[:0])
    blocks = wave_blocks(name, idx.device)
    part = torch.empty(blocks, ROW, dtype=torch.int32, device=idx.device)
    out = torch.empty(1, ROW, dtype=torch.int32, device=idx.device)
    _launch(name, tbl, idx, part, out, idx.numel(), blocks)
    return out


def xor_rows(idx: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """XOR of the 512-byte rows ``tbl[idx]``, a (1, 128) int32 row (L3):
    every row read, kept in registers."""
    return _xor_rows("xor_rows", idx, tbl)


def xor_rows_ring(idx: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """``xor_rows``, each row fetched through an 8-deep async-copy ring a
    warp (L4)."""
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


# ---------------------------------------------------------------- the L2 yardstick


def l2_stream_plain(tbl: torch.Tensor, reps: int) -> torch.Tensor:
    """What ``l2_stream``'s rows fold to: the table's XOR ``reps`` times
    over, i.e. once for odd ``reps``, else zero; as one row."""
    return xor_fold(tbl) if reps % 2 else xor_fold(tbl[:0])


def l2_stream(tbl: torch.Tensor, reps: int, random: bool = False) -> torch.Tensor:
    """Read every row of ``tbl`` (int32 [2^k, 128]) ``reps`` times in one
    launch, each pass in order or, with ``random``, in a fresh permutation
    of the rows; returns the blocks' XORs [blocks, 128], which ``xor_fold``
    to ``l2_stream_plain`` (its one row on the CPU). The card's L2 read
    rate, timed by ``chip_smoke.py``; no TPU kernel, not counted in
    ``LAUNCHES``."""
    if not _on_card("l2_stream", tbl):
        return l2_stream_plain(tbl, reps)
    _check_table("l2_stream", tbl)
    rows = tbl.shape[0]
    if rows & (rows - 1) or not rows or reps <= 0:
        raise ValueError(f"l2_stream: {rows} rows is not a power of two, or reps {reps} < 1")
    blocks = wave_blocks("l2_stream", tbl.device)
    part = torch.empty(blocks, ROW, dtype=torch.int32, device=tbl.device)
    _call("l2_stream", tbl, rows.bit_length() - 1, reps, int(random), part, blocks)
    return part


def l2_sectors_plain(tbl: torch.Tensor, reps: int) -> torch.Tensor:
    """What ``l2_sectors``'s words fold to: the table's XOR once for odd
    ``reps``, else zero; as one word."""
    words = tbl.reshape(-1, 1) if reps % 2 else tbl[:0].reshape(0, 1)
    return xor_fold(words).reshape(1)


def l2_sectors(tbl: torch.Tensor, reps: int) -> torch.Tensor:
    """Read every word of ``tbl`` (int32 [2^k], k >= 3) ``reps`` times in
    one launch, each pass in a fresh random permutation, with 4-byte
    ``ld.global.cg`` loads (one 32-byte L2 sector each, no L1); returns the
    blocks' XORs [blocks], which fold to ``l2_sectors_plain`` (its one word
    on the CPU). The L2's random-sector rate, timed by ``chip_smoke.py``;
    no TPU kernel, not counted in ``LAUNCHES``."""
    if not _on_card("l2_sectors", tbl):
        return l2_sectors_plain(tbl, reps)
    _check_1d_i32("l2_sectors", "tbl", tbl)
    words = tbl.numel()
    if words & (words - 1) or words < 8 or reps <= 0:
        raise ValueError(f"l2_sectors: {words} words is not a power of two >= 8, or reps "
                         f"{reps} < 1")
    blocks = wave_blocks("l2_sectors", tbl.device)
    part = torch.empty(blocks, dtype=torch.int32, device=tbl.device)
    _call("l2_sectors", tbl, words.bit_length() - 1, reps, part, blocks)
    return part
