"""The SSHash capacity-tier main probe (kernel K3): CUDA kernel, build and
wrapper (counterpart of ``mazu_tpu.ops.pallas_capacity``'s
``pallas_capacity_k2u``).

``capacity_k2u(d, fw, probe_limit, mphf_level_limit)`` has the contract of
``sshash_k2u(d, fw, mode="main", probe_limit=probe_limit, defer_valid=True,
mphf_level_limit=mphf_level_limit)`` on the grouped16 + packed + paired
layout without window records, with a direct bucket table or a BooPHF32
minimizer MPHF, with or without ``uproj`` records; that function is its
plain torch version. CPU tensors take the plain version; CUDA tensors
launch ``csrc/capacity_probe.cu`` or raise.

The kernel is compiled on first use (``cuda_build``) and loaded with
``ctypes``. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..kphf.sshash import sshash_k2u
from .cuda_build import CSRC, compile_library

LAUNCHES = 0

SOURCE = CSRC / "capacity_probe.cu"
MAX_LEVELS = 32  # kMaxLevels of the kernel's argument block
TILE = 256  # kTile: the kernel's lanes per block
_FN = None

_POINTERS = ("fw", "gdelta", "gbase", "posw", "words2", "wb2", "uproj", "accum2", "mwords",
             "mranks", "fh_keys", "fh_vals")
# (field, key, dtype) of the outputs, in the kernel's order; the last four
# only with uproj records
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
    ("ostart", "occ_start", torch.int64),
)
_SCALARS = ("n", "k", "w", "seed", "skew_param", "bound", "width", "last_km", "n_w2", "n_wb",
            "n_up", "n_unitigs", "tmask", "n_test", "full_chain", "n_fh")


class _Args(ctypes.Structure):
    """The kernel's ``Args`` block: pointers, then scalars, then the MPHF's
    per-level tables; every field is 8 bytes."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in _POINTERS]
        + [(field, ctypes.c_void_p) for field, _, _ in _OUTPUTS]
        + [(name, ctypes.c_int64) for name in _SCALARS]
        + [(name, ctypes.c_int64 * MAX_LEVELS) for name in ("n_bits", "word_off", "rank_off")]
    )


def _kernel():
    global _FN
    if _FN is None:
        path, _ = compile_library(SOURCE)
        fn = ctypes.CDLL(str(path)).capacity_probe
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(t: torch.Tensor, name: str, dtype, dev, cols: int | None = None, align: int = 8):
    """``align``: the alignment that the kernel's widest read of this table
    needs."""
    shape_ok = t.dim() == 1 if cols is None else (t.dim() == 2 and t.shape[1] == cols)
    if (t.dtype != dtype or not shape_ok or t.shape[0] < 1 or not t.is_contiguous()
            or t.device != dev or t.data_ptr() % align):
        want = "[L]" if cols is None else f"[L, {cols}]"
        raise ValueError(f"{name} must be a contiguous, non-empty, {align}-byte aligned {dtype} "
                         f"{want} tensor on fw's device")


def check_layout(d: dict, fw: torch.Tensor, probe_limit: int, mphf_level_limit=None) -> dict:
    """Raise unless ``d`` is a grouped16 + packed + paired SSHash without
    window records that the kernel can read for ``fw``. Returns the scalar
    fields of the kernel's arguments."""
    m = d["meta"]
    us = d["us"]
    if not (m.kind == "sshash" and m.prefix_kind == "grouped16" and m.pos_kind == "packed"):
        raise ValueError("capacity_k2u needs an SSHash with grouped16 bounds and packed positions")
    if m.ordering != "mix32":
        raise ValueError(f"capacity_k2u needs the mix32 minimizer ordering, not {m.ordering!r}")
    if "useqrec" in us:
        raise ValueError("capacity_k2u probes without window records: with useqrec the main "
                         "probe is the records' (bpos_usrec_k2u)")
    if "words2" not in us["useq"] or "wb2" not in us["bv"]:
        raise ValueError("capacity_k2u needs the paired words2 and wb2 arrays")
    if int(probe_limit) < 1:
        raise ValueError(f"probe_limit must be >= 1, got {probe_limit}")
    if fw.dtype != torch.int64 or fw.dim() != 1 or not fw.is_contiguous():
        raise ValueError("fw must be a contiguous 1-D int64 tensor")
    dev = fw.device
    t_plus_1 = d["prefix"]["gdelta"].shape[0]
    _check(d["prefix"]["gdelta"], "gdelta", torch.int16, dev, align=4)
    _check(d["prefix"]["gbase"], "gbase", torch.int64, dev)
    if d["prefix"]["gbase"].shape[0] != (t_plus_1 + 1023) // 1024:
        raise ValueError("gbase must hold one base per 1024 buckets of gdelta")
    _check(d["pos"]["words"], "pos words", torch.int64, dev)
    if not 0 < int(d["pos"]["meta"].width) <= 58:
        raise ValueError("packed positions must be 1 to 58 bits wide")
    _check(us["useq"]["words2"], "words2", torch.int64, dev, 2, align=16)
    _check(us["bv"]["wb2"], "wb2", torch.int64, dev, 2, align=16)
    if "uproj" in us:
        _check(us["uproj"], "uproj", torch.int64, dev, 5)
    else:
        _check(us["accum2"], "accum2", torch.int64, dev, 2)
    n_test, full_chain, n_fh = 0, 0, 0
    if m.direct_t:
        if m.direct_t & (m.direct_t - 1) or t_plus_1 != m.direct_t + 1:
            raise ValueError("the direct table must have T + 1 gdelta entries, T a power of two")
    else:
        mp = d["mphf"]
        mm = mp["meta"]
        if getattr(mm, "kind", None) != "boophf32" or "mrows" in mp:
            raise ValueError("capacity_k2u reads the lean BooPHF32 layout")
        n_levels = len(mm.n_bits)
        if n_levels > MAX_LEVELS:
            raise ValueError(f"the MPHF has {n_levels} levels; the kernel takes {MAX_LEVELS}")
        if n_levels == 0 or t_plus_1 < 2:
            raise ValueError("capacity_k2u needs a non-empty MPHF")
        _check(mp["words"], "mphf words", torch.int32, dev, align=16)
        _check(mp["ranks"], "mphf ranks", torch.int32, dev, align=4)
        _check(mp["fh_keys"], "mphf fh_keys", torch.int64, dev)
        _check(mp["fh_vals"], "mphf fh_vals", torch.int32, dev, align=4)
        full_chain = int(mphf_level_limit is None)
        n_test = n_levels if full_chain else min(max(int(mphf_level_limit), 1), n_levels)
        n_fh = mp["fh_keys"].shape[0]
    um = us["meta"]
    return {
        "n": fw.shape[0], "k": m.k, "w": m.w, "seed": int(m.seed) & 0xFFFFFFFF,
        "skew_param": int(m.skew_param), "bound": min(int(m.probe_bound), int(probe_limit)),
        "width": int(d["pos"]["meta"].width), "last_km": um.total_len - m.k,
        "n_w2": us["useq"]["words2"].shape[0], "n_wb": us["bv"]["wb2"].shape[0],
        "n_up": us["uproj"].shape[0] if "uproj" in us else 0, "n_unitigs": um.n_unitigs,
        "tmask": m.direct_t - 1 if m.direct_t else 0, "n_test": n_test,
        "full_chain": full_chain, "n_fh": n_fh,
    }


def capacity_k2u(d: dict, fw: torch.Tensor, probe_limit: int,
                 mphf_level_limit: int | None = None) -> dict:
    """Main-phase SSHash K2U with deferred validation on the capacity
    layout (see ``sshash_k2u``)."""
    global LAUNCHES
    if fw.device.type == "cpu":
        return sshash_k2u(d, fw, mode="main", probe_limit=probe_limit, defer_valid=True,
                          mphf_level_limit=mphf_level_limit)
    if fw.device.type != "cuda":
        raise ValueError(f"no capacity probe for device {fw.device}")
    scalars = check_layout(d, fw, probe_limit, mphf_level_limit)
    us = d["us"]
    n = fw.shape[0]
    keys = _OUTPUTS if "uproj" in us else _OUTPUTS[:6]
    out = {key: torch.empty(n, dtype=dt, device=fw.device) for _, key, dt in keys}
    if n == 0:
        return out
    mp = d.get("mphf", {}) if not d["meta"].direct_t else {}
    ptrs = {
        "fw": fw, "gdelta": d["prefix"]["gdelta"], "gbase": d["prefix"]["gbase"],
        "posw": d["pos"]["words"], "words2": us["useq"]["words2"], "wb2": us["bv"]["wb2"],
        "uproj": us.get("uproj"), "accum2": us.get("accum2"), "mwords": mp.get("words"),
        "mranks": mp.get("ranks"), "fh_keys": mp.get("fh_keys"), "fh_vals": mp.get("fh_vals"),
    }
    args = _Args(**{key: (t.data_ptr() if t is not None else None) for key, t in ptrs.items()},
                 **{field: (out[key].data_ptr() if key in out else None)
                    for field, key, _ in _OUTPUTS},
                 **scalars)
    if mp:
        mm = mp["meta"]
        for li, nb in enumerate(mm.n_bits):
            args.n_bits[li] = nb
            args.word_off[li] = mm.word_offsets[li]
            args.rank_off[li] = mm.rank_offsets[li]
    fn = _kernel()
    with torch.cuda.device(fw.device):
        err = fn(ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"capacity_probe launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
