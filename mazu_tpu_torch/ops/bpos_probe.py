"""The SSHash direct-engine capacity probe (kernel K2): CUDA kernel, build
and wrapper (counterpart of ``mazu_tpu.ops.pallas_capacity``'s
``pallas_bpos_usrec_k2u``).

``bpos_usrec_k2u(d, fw, probe_limit)`` has the contract of
``sshash_k2u(d, fw, mode="main", probe_limit=probe_limit)`` on the direct
layout with ``bpos`` rows and ``useqrec`` records; that function is its
plain torch version. CPU tensors take the plain version; CUDA tensors
launch ``csrc/bpos_probe.cu`` or raise.

The kernel reads each window record as one 64-byte block, from a copy of
``useqrec`` padded to 8 words a row that ``padded_records`` makes on the
records' device once per records tensor (14% larger than ``useqrec``,
held beside it). The kernel is compiled on first use (``cuda_build``) and
loaded with ``ctypes``. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..kphf.sshash import sshash_k2u
from .cuda_build import CSRC, compile_library
from .derived import derived

LAUNCHES = 0

SOURCE = CSRC / "bpos_probe.cu"
MAX_PLIM = 3  # kMaxPlim: a bpos row holds the bucket's first three positions
TILE = 256  # kTile: the kernel's lanes per block
REC_WORDS = 8  # kRecWords: u64 words of a padded record
_FN = None

# (field, key, dtype) of the outputs, in the kernel's order
_OUTPUTS = (
    ("uid", "unitig_id", torch.int64),
    ("ulen", "unitig_len", torch.int64),
    ("pos", "pos", torch.int64),
    ("mt", "mt", torch.uint8),
    ("use_skew", "use_skew", torch.bool),
    ("unresolved", "unresolved", torch.bool),
    ("ow", "occ_word", torch.int64),
    ("ow2", "occ_word2", torch.int64),
    ("cnt", "occ_cnt", torch.int64),
)
_SCALARS = ("n", "n_rec", "tmask", "k", "w", "plim", "seed", "skew_param", "last_km")


class _Args(ctypes.Structure):
    """The kernel's ``Args`` block: the key and table pointers, the
    outputs, then scalars; every field is 8 bytes."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in ("fw", "bpos", "rec")]
        + [(field, ctypes.c_void_p) for field, _, _ in _OUTPUTS]
        + [(name, ctypes.c_int64) for name in _SCALARS]
    )


def _kernel():
    global _FN
    if _FN is None:
        path, _ = compile_library(SOURCE)
        fn = ctypes.CDLL(str(path)).bpos_probe
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def padded_records(rec: torch.Tensor) -> torch.Tensor:
    """``rec`` [L, 7] as [L, 8] int64 rows, the eighth word 0, so that each
    record is one 64-byte block. Made on first use and kept while ``rec``
    lives (``derived``); made again after ``rec`` is written in place."""

    def make():
        out = torch.zeros(rec.shape[0], REC_WORDS, dtype=rec.dtype, device=rec.device)
        out[:, : rec.shape[1]] = rec
        if out.data_ptr() % 64:
            raise RuntimeError("the padded records must be 64-byte aligned")
        return out

    return derived(rec, "padded records", make)


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
    out = {key: torch.empty(n, dtype=dt, device=fw.device) for _, key, dt in _OUTPUTS}
    if n == 0:
        return out
    rec = padded_records(rec)
    args = _Args(fw=fw.data_ptr(), bpos=d["bpos"].data_ptr(), rec=rec.data_ptr(),
                 **{field: out[key].data_ptr() for field, key, _ in _OUTPUTS},
                 n=n, n_rec=rec.shape[0], tmask=m.direct_t - 1, k=m.k, w=m.w, plim=plim,
                 seed=int(m.seed) & 0xFFFFFFFF, skew_param=int(m.skew_param),
                 last_km=d["us"]["meta"].total_len - m.k)
    fn = _kernel()
    with torch.cuda.device(fw.device):
        err = fn(ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"bpos_probe launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
