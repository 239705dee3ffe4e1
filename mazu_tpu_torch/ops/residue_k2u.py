"""The exact K2U of the ragged phase 2's residue on a fast32 SSHash: CUDA
kernel, its build, its wrapper and its dispatch. It replaces no TPU
kernel: the reference runs this K2U in plain ``jnp`` (``sshash_k2u``'s
full mode).

``residue_k2u(d, fw, r, rest, n_c)`` takes the phase-2 slots' words ``fw``,
their full-depth main probe ``r`` (``index.modindex._ragged_k2u``: K3 at
the probe bound with the whole MPHF chain) and its residue, the slots
``rest`` of which the first ``min(n_c, len(rest))`` are real, and returns
``r``'s K2U fields with each real residue slot's replaced by
``sshash_k2u(d["k2u"], fw[slot])``'s (mode ``"full"``): bit for bit the
plain residue branch of ``_ragged_k2u``, which is the CPU path and the
oracle. On CUDA tensors the kernel (``csrc/residue_k2u.cu``,
``residue_k2u_kernel``) writes the real residue slots into ``r``'s tensors
in place, reading the count on the device: a heavy-bucket lane through the
skew MPHF alone, any other lane through its bucket's rows, validated in the
loop, a warp taking a lane's rows together.

``engages(d, device)`` is the one predicate that ``_ragged_k2u`` asks
before it launches the kernel: an SSHash with the mix32 ordering, grouped16
bounds, packed positions, the paired ``words2``, ``wb2`` and ``accum2``
rows, no window records, a lean BooPHF32 minimizer MPHF (no ``mrows``) and
a lean BooPHF32 ``skew_mphf`` with ``skew_pos``, on a CUDA device. It reads
metas, shapes and dtypes only, so a CPU test may ask it for a CUDA device.
Every other index (the direct engine's skew rows, parity's 64-bit BooPHF,
row layouts and records, any KCDict) and every CPU tensor keeps the plain
residue K2U. The kernel is compiled on first use (``cuda_build``) and
loaded with ``ctypes``; ``LAUNCHES`` counts its launches.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CSRC, compile_library

LAUNCHES = 0

SOURCE = CSRC / "residue_k2u.cu"
MAX_LEVELS = 32  # kMaxLevels of the kernel's argument block
TILE = 256  # kTile: residue slots a block
FIELDS = ("unitig_id", "unitig_len", "pos", "mt")
_FN = None

_POINTERS = ("fw", "rest", "n_c", "use_skew", "gdelta", "gbase", "posw", "words2", "wb2",
             "uproj", "accum2", "mwords", "mranks", "fh_keys", "fh_vals", "swords", "sranks",
             "sfh_keys", "sfh_vals", "spos")
_OUTPUTS = (("uid", "unitig_id"), ("ulen", "unitig_len"), ("pos", "pos"), ("mt", "mt"))
_SCALARS = ("m_c", "k", "w", "seed", "bound", "width", "last_km", "n_w2", "n_wb", "n_up",
            "n_unitigs", "n_levels", "n_fh", "s_levels", "s_n_fh", "s_width", "n_skew")
_LEVELS = ("n_bits", "word_off", "rank_off", "s_n_bits", "s_word_off", "s_rank_off")


class _Args(ctypes.Structure):
    """The kernel's ``Args`` block: pointers, outputs, scalars, then the two
    MPHFs' per-level tables; every field is 8 bytes."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in _POINTERS]
        + [(field, ctypes.c_void_p) for field, _ in _OUTPUTS]
        + [(name, ctypes.c_int64) for name in _SCALARS]
        + [(name, ctypes.c_int64 * MAX_LEVELS) for name in _LEVELS]
    )


def _kernel():
    global _FN
    if _FN is None:
        path, _ = compile_library(SOURCE)
        fn = ctypes.CDLL(str(path)).residue_k2u
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _is(t, dtype, cols: int | None = None) -> bool:
    """``t`` is a non-empty ``dtype`` tensor, 1-D or [L, cols]."""
    if not isinstance(t, torch.Tensor) or t.dtype != dtype or t.shape[0] < 1:
        return False
    return t.dim() == 1 if cols is None else (t.dim() == 2 and t.shape[1] == cols)


def _lean_boophf32(mp) -> bool:
    if not isinstance(mp, dict) or "mrows" in mp:
        return False
    mm = mp.get("meta")
    return (getattr(mm, "kind", None) == "boophf32" and len(mm.n_bits) <= MAX_LEVELS
            and _is(mp.get("words"), torch.int32) and _is(mp.get("ranks"), torch.int32)
            and _is(mp.get("fh_keys"), torch.int64) and _is(mp.get("fh_vals"), torch.int32))


def engages(d: dict, device) -> bool:
    """Whether ``_ragged_k2u`` on the arrays ``d`` runs this kernel for
    slots on ``device`` (see the module)."""
    if torch.device(device).type != "cuda":
        return False
    k2u = d.get("k2u")
    if not isinstance(k2u, dict):
        return False
    m = k2u["meta"]
    if getattr(m, "kind", None) != "sshash":
        return False
    if not (m.ordering == "mix32" and m.hash32 and not m.direct_t
            and m.prefix_kind == "grouped16" and m.pos_kind == "packed"):
        return False
    us = k2u["us"]
    if "useqrec" in us:
        return False
    if not (_lean_boophf32(k2u.get("mphf")) and _lean_boophf32(k2u.get("skew_mphf"))):
        return False
    pos, spos = k2u["pos"], k2u.get("skew_pos")
    if not (isinstance(spos, dict) and _is(spos.get("words"), torch.int64)
            and 0 < int(spos["meta"].width) <= 58 and _is(pos.get("words"), torch.int64)
            and 0 < int(pos["meta"].width) <= 58):
        return False
    pre = k2u["prefix"]
    if not (_is(pre.get("gdelta"), torch.int16) and _is(pre.get("gbase"), torch.int64)):
        return False
    uproj = us.get("uproj")
    return (_is(us["useq"].get("words2"), torch.int64, 2) and _is(us["bv"].get("wb2"),
                                                                   torch.int64, 2)
            and _is(us.get("accum2"), torch.int64, 2)
            and (uproj is None or _is(uproj, torch.int64, 5)))


def _check(d: dict, fw: torch.Tensor, r: dict, rest: torch.Tensor, n_c: torch.Tensor) -> None:
    """Raise unless the kernel can run on these tensors."""
    if not engages(d, fw.device):
        raise ValueError("residue_k2u needs a fast32 SSHash with grouped16 bounds, packed "
                         "positions, paired rows, lean BooPHF32 minimizer and skew MPHFs, "
                         "and CUDA tensors")
    for name, x in (("fw", fw), ("rest", rest)):
        if x.dtype != torch.int64 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int64 tensor")
    if n_c.dtype != torch.int64 or n_c.numel() != 1:
        raise ValueError("n_c must be one int64 value")
    M = fw.shape[0]
    for key, dt in (("unitig_id", torch.int64), ("unitig_len", torch.int64),
                    ("pos", torch.int64), ("mt", torch.uint8), ("use_skew", torch.bool)):
        x = r[key]
        if x.dtype != dt or tuple(x.shape) != (M,) or not x.is_contiguous():
            raise ValueError(f"r[{key!r}] must be a contiguous [{M}] {dt} tensor")
    k2u = d["k2u"]
    us = k2u["us"]
    tensors = [rest, n_c, *(r[key] for key in FIELDS + ("use_skew",)),
               k2u["prefix"]["gdelta"], k2u["prefix"]["gbase"], k2u["pos"]["words"],
               us["useq"]["words2"], us["bv"]["wb2"], us["accum2"], k2u["skew_pos"]["words"]]
    tensors += [k2u[mp][key] for mp in ("mphf", "skew_mphf")
                for key in ("words", "ranks", "fh_keys", "fh_vals")]
    if "uproj" in us:
        tensors.append(us["uproj"])
    for x in tensors:
        if x.device != fw.device or not x.is_contiguous():
            raise ValueError("every input must be contiguous and on fw's device")
    aligned16 = (us["useq"]["words2"], us["bv"]["wb2"], k2u["mphf"]["words"],
                 k2u["skew_mphf"]["words"])
    if any(x.data_ptr() % 16 for x in aligned16) or k2u["prefix"]["gdelta"].data_ptr() % 4:
        raise ValueError("words2, wb2 and the MPHF words must be 16-byte aligned, gdelta 4-byte")


def _args(d: dict, fw: torch.Tensor, r: dict, rest: torch.Tensor, n_c: torch.Tensor) -> _Args:
    """The kernel's argument block; it writes into ``r``'s K2U fields."""
    k2u = d["k2u"]
    m, us = k2u["meta"], k2u["us"]
    mp, sp = k2u["mphf"], k2u["skew_mphf"]
    um = us["meta"]
    uproj = us.get("uproj")
    ptrs = {
        "fw": fw, "rest": rest, "n_c": n_c, "use_skew": r["use_skew"],
        "gdelta": k2u["prefix"]["gdelta"], "gbase": k2u["prefix"]["gbase"],
        "posw": k2u["pos"]["words"], "words2": us["useq"]["words2"], "wb2": us["bv"]["wb2"],
        "uproj": uproj, "accum2": us["accum2"], "mwords": mp["words"], "mranks": mp["ranks"],
        "fh_keys": mp["fh_keys"], "fh_vals": mp["fh_vals"], "swords": sp["words"],
        "sranks": sp["ranks"], "sfh_keys": sp["fh_keys"], "sfh_vals": sp["fh_vals"],
        "spos": k2u["skew_pos"]["words"],
    }
    args = _Args(
        **{key: (t.data_ptr() if t is not None else None) for key, t in ptrs.items()},
        **{field: r[key].data_ptr() for field, key in _OUTPUTS},
        m_c=rest.shape[0], k=m.k, w=m.w, seed=int(m.seed) & 0xFFFFFFFF, bound=int(m.probe_bound),
        width=int(k2u["pos"]["meta"].width), last_km=um.total_len - m.k,
        n_w2=us["useq"]["words2"].shape[0], n_wb=us["bv"]["wb2"].shape[0],
        n_up=uproj.shape[0] if uproj is not None else 0, n_unitigs=um.n_unitigs,
        n_levels=len(mp["meta"].n_bits), n_fh=mp["fh_keys"].shape[0],
        s_levels=len(sp["meta"].n_bits), s_n_fh=sp["fh_keys"].shape[0],
        s_width=int(k2u["skew_pos"]["meta"].width), n_skew=int(k2u["skew_pos"]["meta"].length),
    )
    for prefix, f in (("", mp), ("s_", sp)):
        mm = f["meta"]
        for li, nb in enumerate(mm.n_bits):
            getattr(args, prefix + "n_bits")[li] = nb
            getattr(args, prefix + "word_off")[li] = mm.word_offsets[li]
            getattr(args, prefix + "rank_off")[li] = mm.rank_offsets[li]
    return args


def residue_k2u(d: dict, fw: torch.Tensor, r: dict, rest: torch.Tensor,
                n_c: torch.Tensor) -> dict:
    """The slots' K2U fields with the residue's replaced by the full K2U's
    (see the module): the plain version on the CPU, the kernel, in place in
    ``r``, on a CUDA device."""
    global LAUNCHES
    if fw.device.type == "cpu":
        from ..index.modindex import residue_full_k2u

        return residue_full_k2u(d, fw, r, rest, n_c)
    if fw.device.type != "cuda":
        raise ValueError(f"no residue K2U for device {fw.device}")
    _check(d, fw, r, rest, n_c)
    out = {key: r[key] for key in FIELDS}
    if rest.shape[0] == 0 or fw.shape[0] == 0:
        return out
    args = _args(d, fw, r, rest, n_c)
    fn = _kernel()
    with torch.cuda.device(fw.device):
        err = fn(ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"residue_k2u launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
