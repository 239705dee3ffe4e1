"""The mono2-occ32 bucket-row probe (kernel K1): CUDA kernel, its build,
and its wrapper (counterpart of ``mazu_tpu.ops.pallas_query``).

``mono2_k2u(d, fw)`` has the contract of ``kcdict_k2u(d, fw,
mode="main")``, which is its plain torch version. CPU tensors take the
plain version; CUDA tensors launch ``csrc/mono2_probe.cu`` or raise.

The kernel reads each bucket row as one 64-byte block: the card holds the
table as ``padded_table`` rows of 16 words (the reference's 14 and two
zero words). ``card_table`` decides that layout for any index's main table,
and ``QueryIndex.to`` applies it once where the index leaves the host. The
host dict keeps the reference's [T, 14] layout, and the plain version reads
columns 0-13 of either. The kernel is compiled on first use
(``cuda_build``) and loaded with ``ctypes``. ``LAUNCHES`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..kphf.kcdict import SLOTS, SW, kcdict_k2u
from .cuda_build import CSRC, compile_library

LAUNCHES = 0

SOURCE = CSRC / "mono2_probe.cu"
TILE = 256  # kTile: the kernel's queries per block
ROW_WORDS = 16  # kRowWords: u32 words of a row on the card (64 bytes)
_FN = None

# (field, key, dtype) of the outputs, in the kernel's order
_OUTPUTS = (
    ("uid", "unitig_id", torch.int64),
    ("ulen", "unitig_len", torch.int64),
    ("pos", "pos", torch.int64),
    ("cnt", "occ_cnt", torch.int64),
    ("mt", "mt", torch.uint8),
    ("ow", "occ_word", torch.int64),
    ("ow2", "occ_word2", torch.int64),
    ("use_skew", "use_skew", torch.bool),
    ("unresolved", "unresolved", torch.bool),
)


class _Args(ctypes.Structure):
    """The kernel's ``Args`` block: the key and table pointers, the
    outputs, then scalars; every field is 8 bytes."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in ("fw", "table")]
        + [(field, ctypes.c_void_p) for field, _, _ in _OUTPUTS]
        + [(name, ctypes.c_int64) for name in ("n", "tmask", "k")]
    )


def _kernel():
    global _FN
    if _FN is None:
        path, _ = compile_library(SOURCE)
        fn = ctypes.CDLL(str(path)).mono2_probe
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def padded_table(table: torch.Tensor) -> torch.Tensor:
    """``table`` [T, 14] as [T, 16] int32 rows on its device, columns 0-13
    the same and 14-15 zero: one 64-byte block a row."""
    if table.dtype != torch.int32 or table.dim() != 2 or table.shape[1] != SLOTS * SW:
        raise ValueError(f"expected an int32 [T, {SLOTS * SW}] table, got "
                         f"{table.dtype}{tuple(table.shape)}")
    out = torch.zeros(table.shape[0], ROW_WORDS, dtype=torch.int32, device=table.device)
    out[:, : SLOTS * SW] = table
    return out


def card_table(m, table: torch.Tensor) -> torch.Tensor:
    """An index's main table as it goes to the card: a mono2-occ32 KCDict's
    [T, 14] rows as ``padded_table``, anything else as it is (``m``: the
    table's meta)."""
    if (getattr(m, "kind", None) == "kcdict" and m.scheme == "mono2" and m.occ32
            and m.sw == SW and table.dim() == 2 and table.shape[1] == SLOTS * SW):
        return padded_table(table)
    return table


def check_layout(d: dict, fw: torch.Tensor) -> None:
    """Raise unless the kernel can read ``d`` (a mono2-occ32 KCDict) for
    ``fw``: a contiguous [T, 16] int32 table of 64-byte aligned rows on
    fw's device, T a power of two <= 2^32."""
    m = d["meta"]
    table = d["table"]
    if not (m.scheme == "mono2" and m.occ32 and m.sw == SW):
        raise ValueError("mono2_k2u needs the mono2-occ32 layout")
    if fw.dtype != torch.int64 or fw.dim() != 1 or not fw.is_contiguous():
        raise ValueError("fw must be a contiguous 1-D int64 tensor")
    if (
        table.dtype != torch.int32
        or tuple(table.shape) != (m.t, ROW_WORDS)
        or not table.is_contiguous()
        or table.device != fw.device
        or table.data_ptr() % 64
        or m.t & (m.t - 1)
        or m.t > 1 << 32
    ):
        raise ValueError(f"table must be a contiguous, 64-byte aligned int32 [T, {ROW_WORDS}] "
                         "tensor on fw's device (padded_table), T a power of two <= 2^32")


def mono2_k2u(d: dict, fw: torch.Tensor) -> dict:
    """Main-table K2U on a mono2-occ32 KCDict (see ``kcdict_k2u``)."""
    global LAUNCHES
    if fw.device.type == "cpu":
        return kcdict_k2u(d, fw, mode="main")
    if fw.device.type != "cuda":
        raise ValueError(f"no mono2 probe for device {fw.device}")
    check_layout(d, fw)
    n = fw.shape[0]
    out = {key: torch.empty(n, dtype=dt, device=fw.device) for _, key, dt in _OUTPUTS}
    if n == 0:
        return out
    m = d["meta"]
    args = _Args(fw=fw.data_ptr(), table=d["table"].data_ptr(),
                 **{field: out[key].data_ptr() for field, key, _ in _OUTPUTS},
                 n=n, tmask=m.t - 1, k=m.k)
    fn = _kernel()
    with torch.cuda.device(fw.device):
        err = fn(ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mono2_probe launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
