"""The SSHash direct-engine capacity probe (kernel K2): CUDA kernel, build
and wrapper (counterpart of ``mazu_tpu.ops.pallas_capacity``'s
``pallas_bpos_usrec_k2u``).

``bpos_usrec_k2u(d, fw, probe_limit)`` has the contract of
``sshash_k2u(d, fw, mode="main", probe_limit=probe_limit)`` on the direct
layout with ``bpos`` rows and ``useqrec`` records; that function is its
plain torch version. CPU tensors take the plain version; CUDA tensors
launch ``csrc/bpos_probe.cu`` or raise.

The kernel is compiled on first use (``cuda_build``) and loaded with
``ctypes``. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..kphf.sshash import sshash_k2u
from .cuda_build import CSRC, compile_library

LAUNCHES = 0

SOURCE = CSRC / "bpos_probe.cu"
_FN = None

# (key, dtype) of the outputs, in the order the C function takes them
_OUTPUTS = (
    ("unitig_id", torch.int64),
    ("unitig_len", torch.int64),
    ("pos", torch.int64),
    ("mt", torch.uint8),
    ("use_skew", torch.bool),
    ("unresolved", torch.bool),
    ("occ_word", torch.int64),
    ("occ_word2", torch.int64),
    ("occ_cnt", torch.int64),
)
MAX_PLIM = 3  # a bpos row holds the bucket's first three positions


def _kernel():
    global _FN
    if _FN is None:
        path, _ = compile_library(SOURCE)
        fn = ctypes.CDLL(str(path)).bpos_probe
        p, i64, u32, cint = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32, ctypes.c_int
        fn.argtypes = [p, p, p, i64, u32, cint, cint, u32, i64, cint, i64, i64] + [p] * 10
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def check_layout(d: dict, fw: torch.Tensor, probe_limit: int) -> int:
    """Raise unless ``d`` is a direct SSHash with bpos rows and useqrec
    records that the kernel can read for ``fw``. Returns the probe depth
    min(probe_bound, probe_limit)."""
    m = d["meta"]
    if not (m.kind == "sshash" and m.direct_t and "bpos" in d and "useqrec" in d["us"]):
        raise ValueError("bpos_usrec_k2u needs the direct SSHash layout with bpos and useqrec")
    if m.ordering != "mix32":
        raise ValueError(f"bpos_usrec_k2u needs the mix32 minimizer ordering, not {m.ordering!r}")
    if not 0 < int(probe_limit) <= MAX_PLIM:
        raise ValueError(f"probe_limit must be in [1, {MAX_PLIM}], got {probe_limit}")
    if d["us"]["meta"].total_len >= 1 << 31:
        raise ValueError("bpos positions ride in u32: the unitig set must be < 2^31 bases")
    t = m.direct_t
    bpos, rec = d["bpos"], d["us"]["useqrec"]
    if fw.dtype != torch.int64 or fw.dim() != 1 or not fw.is_contiguous():
        raise ValueError("fw must be a contiguous 1-D int64 tensor")
    if (bpos.dtype != torch.int32 or tuple(bpos.shape) != (t, 4) or not bpos.is_contiguous()
            or bpos.device != fw.device or bpos.data_ptr() % 16 or t & (t - 1) or t > 1 << 32):
        raise ValueError("bpos must be a contiguous, 16-byte aligned int32 [T, 4] tensor on "
                         "fw's device, T a power of two <= 2^32")
    if (rec.dtype != torch.int64 or rec.dim() != 2 or rec.shape[1] != 7 or rec.shape[0] < 1
            or not rec.is_contiguous() or rec.device != fw.device or rec.data_ptr() % 8):
        raise ValueError("useqrec must be a contiguous, 8-byte aligned int64 [L, 7] tensor "
                         "on fw's device")
    return min(int(m.probe_bound), int(probe_limit))


def bpos_usrec_k2u(d: dict, fw: torch.Tensor, probe_limit: int) -> dict:
    """Main-phase SSHash K2U through the bpos row and the window records
    (see ``sshash_k2u``)."""
    global LAUNCHES
    if fw.device.type == "cpu":
        return sshash_k2u(d, fw, mode="main", probe_limit=probe_limit)
    if fw.device.type != "cuda":
        raise ValueError(f"no bpos probe for device {fw.device}")
    plim = check_layout(d, fw, probe_limit)
    m = d["meta"]
    rec = d["us"]["useqrec"]
    n = fw.shape[0]
    out = {key: torch.empty(n, dtype=dt, device=fw.device) for key, dt in _OUTPUTS}
    if n == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(fw.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            fw.data_ptr(), d["bpos"].data_ptr(), rec.data_ptr(), rec.shape[0],
            m.direct_t - 1, m.k, m.w, int(m.seed) & 0xFFFFFFFF, int(m.skew_param), plim,
            d["us"]["meta"].total_len - m.k, n,
            *(out[key].data_ptr() for key, _ in _OUTPUTS), stream,
        )
    if err != 0:
        raise RuntimeError(f"bpos_probe launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
