"""The mono2-occ32 bucket-row probe: CUDA kernel, its build, and its
wrapper (counterpart of ``mazu_tpu.ops.pallas_query``).

``mono2_k2u(d, fw)`` has the contract of ``kcdict_k2u(d, fw,
mode="main")``, which is its plain torch version. CPU tensors take the
plain version; CUDA tensors launch ``csrc/mono2_probe.cu`` or raise.

The kernel is compiled on first use (``cuda_build``) and loaded with
``ctypes``. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..kphf.kcdict import SW, kcdict_k2u
from .cuda_build import CSRC, compile_library

LAUNCHES = 0

SOURCE = CSRC / "mono2_probe.cu"
_FN = None

# (key, dtype) of the outputs, in the order the C function takes them
_OUTPUTS = (
    ("unitig_id", torch.int64),
    ("unitig_len", torch.int64),
    ("pos", torch.int64),
    ("occ_cnt", torch.int64),
    ("mt", torch.uint8),
    ("occ_word", torch.int64),
    ("occ_word2", torch.int64),
    ("use_skew", torch.bool),
    ("unresolved", torch.bool),
)


def _kernel():
    global _FN
    if _FN is None:
        path, _ = compile_library(SOURCE)
        fn = ctypes.CDLL(str(path)).mono2_probe
        p = ctypes.c_void_p
        fn.argtypes = [p, p, ctypes.c_uint32, ctypes.c_int, ctypes.c_int64] + [p] * 10
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def mono2_k2u(d: dict, fw: torch.Tensor) -> dict:
    """Main-table K2U on a mono2-occ32 KCDict (see ``kcdict_k2u``)."""
    global LAUNCHES
    if fw.device.type == "cpu":
        return kcdict_k2u(d, fw, mode="main")
    if fw.device.type != "cuda":
        raise ValueError(f"no mono2 probe for device {fw.device}")
    m = d["meta"]
    table = d["table"]
    if not (m.scheme == "mono2" and m.occ32 and m.sw == SW):
        raise ValueError("mono2_k2u needs the mono2-occ32 layout")
    if fw.dtype != torch.int64 or fw.dim() != 1 or not fw.is_contiguous():
        raise ValueError("fw must be a contiguous 1-D int64 tensor")
    if (
        table.dtype != torch.int32
        or tuple(table.shape) != (m.t, 2 * SW)
        or not table.is_contiguous()
        or table.device != fw.device
        or table.data_ptr() % 8
        or m.t & (m.t - 1)
        or m.t > 1 << 32
    ):
        raise ValueError("table must be a contiguous, 8-byte aligned int32 [T, 14] "
                         "tensor on fw's device, T a power of two <= 2^32")
    n = fw.shape[0]
    out = {key: torch.empty(n, dtype=dt, device=fw.device) for key, dt in _OUTPUTS}
    if n == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(fw.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            fw.data_ptr(), table.data_ptr(), m.t - 1, m.k, n,
            *(out[key].data_ptr() for key, _ in _OUTPUTS), stream,
        )
    if err != 0:
        raise RuntimeError(f"mono2_probe launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
