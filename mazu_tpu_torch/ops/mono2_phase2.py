"""Phase 2 of the two-phase query on a mono2-occ32 KCDict: CUDA kernel, its
build, its wrapper and its dispatch. It replaces no TPU kernel: the
reference computes this phase in plain ``jnp``.

``mono2_phase2(d, fw, lanes, n_ovf, max_occs)`` has the contract of
``get_ref_pos_padded(d, fw[lanes], max_occs)`` on the real slots ``s <
min(n_ovf, len(lanes))``: every field of that dict, bit for bit, padding
columns included. Slots at or past ``n_ovf`` are not written (their values
mean nothing, as ``flagged_lanes`` says of its lanes there). CPU tensors
take the plain version, ``get_ref_pos_padded`` on the gathered lanes; CUDA
tensors launch ``csrc/mono2_phase2.cu`` or raise.

``engages(d, device)`` is the one predicate that ``get_ref_pos_compact``
asks before it launches the kernel (in its unsplit phase 2: the type-split
phase keeps its plain pieces): a mono2-occ32 KCDict with slim slots and its
main table in K1's 64-byte rows (``mono2_probe.padded_table``), an
occurrence table with ``ctable2`` pair rows in an encoding the kernel
decodes, and lanes on a CUDA device. Every other index and every CPU tensor
runs ``get_ref_pos_padded``.

With ``side_probes`` (an int64 scalar tensor on the card) the kernel adds
to it the real slots whose key the main table did not hold and that it
probed in the side table. The kernel is compiled on first use
(``cuda_build``) and loaded with ``ctypes``. ``LAUNCHES`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..kphf.kcdict import SLOTS, SW
from .cuda_build import CSRC, compile_library
from .mono2_probe import ROW_WORDS

LAUNCHES = 0

SOURCE = CSRC / "mono2_phase2.cu"
TILE = 256  # kTile: slots per block
SIDE_ROW_WORDS = SLOTS * SW  # kSideRowWords: the side table keeps the reference's rows
MAX_OCCS_LIMIT = 1 << 20  # kMaxOccsLimit
ENCODINGS = ("piscem", "pf1")  # occurrence words the kernel decodes
_FN = None

# (field, key, dtype) of the per-slot outputs, in the kernel's order
_SLOT_OUTPUTS = (
    ("uid", "unitig_id", torch.int64),
    ("ulen", "unitig_len", torch.int64),
    ("pos", "pos", torch.int64),
    ("cnt", "occ_cnt", torch.int64),
    ("mt", "mt", torch.uint8),
    ("ow", "occ_word", torch.int64),
    ("ow2", "occ_word2", torch.int64),
    ("n_occs", "n_occs", torch.int64),
)
# (field, dtype) of the [m, max_occs] outputs, in the kernel's order
_CELL_OUTPUTS = (
    ("ref_id", torch.int64),
    ("ref_pos", torch.int64),
    ("orient", torch.int32),
    ("valid", torch.bool),
)
_KEYS = ("unitig_id", "unitig_len", "pos", "occ_cnt", "occ_word", "mt", "occ_word2", "n_occs",
         "ref_id", "ref_pos", "orient", "valid")
_SCALARS = ("m", "max_occs", "tmask", "side_tmask", "side_salt", "k", "occ_last", "pf1",
            "ref_shift", "pos_mask")


class _Args(ctypes.Structure):
    """The kernel's ``Args`` block: the inputs, the outputs, the counter,
    then scalars; every field is 8 bytes."""

    _fields_ = (
        [(name, ctypes.c_void_p)
         for name in ("fw", "lanes", "n_ovf", "table", "side", "offsets", "ctable2")]
        + [(field, ctypes.c_void_p) for field, _, _ in _SLOT_OUTPUTS]
        + [(field, ctypes.c_void_p) for field, _ in _CELL_OUTPUTS]
        + [("side_probes", ctypes.c_void_p)]
        + [(name, ctypes.c_int64) for name in _SCALARS]
    )


def _kernel():
    global _FN
    if _FN is None:
        path, _ = compile_library(SOURCE)
        fn = ctypes.CDLL(str(path)).mono2_phase2
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def engages(d: dict, device) -> bool:
    """Whether phase 2 of ``get_ref_pos_compact`` on the arrays ``d`` runs
    this kernel for lanes on ``device``. Decided from the metas and the
    tensors' shapes and dtypes only, so a CPU test may ask it for a CUDA
    device."""
    if torch.device(device).type != "cuda":
        return False
    k2u, u2 = d.get("k2u"), d.get("u2pos")
    if not isinstance(k2u, dict) or not isinstance(u2, dict):
        return False
    m = k2u["meta"]
    if not (getattr(m, "kind", None) == "kcdict" and m.scheme == "mono2" and m.occ32
            and m.sw == SW):
        return False
    table = k2u["table"]
    if table.dtype != torch.int32 or tuple(table.shape) != (m.t, ROW_WORDS):
        return False
    side = k2u.get("side")
    if side is not None and (side.dtype != torch.int32
                             or tuple(side.shape) != (m.side_t, SIDE_ROW_WORDS)):
        return False
    um = u2["meta"]
    c2 = u2.get("ctable2")
    return (getattr(um, "enc", None) in ENCODINGS and c2 is not None and um.n_occs >= 1
            and c2.dtype == torch.int32 and tuple(c2.shape) == (um.n_occs, 4))


def _check(d: dict, fw: torch.Tensor, lanes: torch.Tensor, n_ovf: torch.Tensor,
           max_occs: int) -> None:
    """Raise unless the kernel can run on these tensors."""
    if not engages(d, fw.device):
        raise ValueError("mono2_phase2 needs a mono2-occ32 KCDict in K1's rows, an occurrence "
                         "table with ctable2 pair rows (piscem or pf1) and CUDA tensors")
    if not 1 <= max_occs <= MAX_OCCS_LIMIT:
        raise ValueError(f"max_occs {max_occs} outside [1, {MAX_OCCS_LIMIT}]")
    for name, x in (("fw", fw), ("lanes", lanes)):
        if x.dtype != torch.int64 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int64 tensor")
    if n_ovf.dtype != torch.int64 or n_ovf.numel() != 1:
        raise ValueError("n_ovf must be one int64 value")
    k2u, u2 = d["k2u"], d["u2pos"]
    tensors = [lanes, n_ovf, k2u["table"], u2["offsets"], u2["ctable2"]]
    if "side" in k2u:
        tensors.append(k2u["side"])
    for x in tensors:
        if x.device != fw.device or not x.is_contiguous():
            raise ValueError("every input must be contiguous and on fw's device")
    if k2u["table"].data_ptr() % 64 or u2["ctable2"].data_ptr() % 16:
        raise ValueError("the main table must be 64-byte and ctable2 16-byte aligned")
    if u2["offsets"].dtype != torch.int64:
        raise ValueError("offsets must be int64")


def mono2_phase2(d: dict, fw: torch.Tensor, lanes: torch.Tensor, n_ovf: torch.Tensor,
                 max_occs: int, side_probes: torch.Tensor | None = None) -> dict:
    """Phase 2 of ``get_ref_pos_compact`` on the slots ``lanes`` of the
    chunk ``fw``: ``get_ref_pos_padded(d, fw[lanes], max_occs)`` on the
    real slots (see the module)."""
    global LAUNCHES
    if fw.device.type == "cpu":
        from ..index.modindex import get_ref_pos_padded

        return get_ref_pos_padded(d, fw[lanes], max_occs)
    if fw.device.type != "cuda":
        raise ValueError(f"no mono2 phase 2 for device {fw.device}")
    max_occs = int(max_occs)
    _check(d, fw, lanes, n_ovf, max_occs)
    m = lanes.shape[0]
    out = outputs(m, max_occs, fw.device)
    if m == 0:
        return out
    args = _args(d, fw, lanes, n_ovf, max_occs, out, side_probes)
    fn = _kernel()
    with torch.cuda.device(fw.device):
        err = fn(ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mono2_phase2 launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def outputs(m: int, max_occs: int, device) -> dict:
    """The kernel's outputs for ``m`` slots, unwritten, in the plain
    version's key order (the K2U's fields, then the projection's)."""
    out = {key: torch.empty(m, dtype=dt, device=device) for _, key, dt in _SLOT_OUTPUTS}
    out.update({key: torch.empty(m, max_occs, dtype=dt, device=device)
                for key, dt in _CELL_OUTPUTS})
    return {key: out[key] for key in _KEYS}


def _args(d: dict, fw: torch.Tensor, lanes: torch.Tensor, n_ovf: torch.Tensor, max_occs: int,
          out: dict, side_probes: torch.Tensor | None) -> _Args:
    """The kernel's argument block for these tensors and ``outputs``."""
    k2u, u2 = d["k2u"], d["u2pos"]
    km, um = k2u["meta"], u2["meta"]
    side = k2u.get("side")
    pf1 = um.enc == "pf1"
    return _Args(
        fw=fw.data_ptr(), lanes=lanes.data_ptr(), n_ovf=n_ovf.data_ptr(),
        table=k2u["table"].data_ptr(), side=side.data_ptr() if side is not None else None,
        offsets=u2["offsets"].data_ptr(), ctable2=u2["ctable2"].data_ptr(),
        **{field: out[key].data_ptr() for field, key, _ in _SLOT_OUTPUTS},
        **{field: out[field].data_ptr() for field, _ in _CELL_OUTPUTS},
        side_probes=side_probes.data_ptr() if side_probes is not None else None,
        m=lanes.shape[0], max_occs=max_occs, tmask=km.t - 1,
        side_tmask=km.side_t - 1 if side is not None else 0,
        side_salt=km.side_salt if side is not None else 0, k=km.k,
        occ_last=um.n_occs - 1, pf1=int(pf1), ref_shift=0 if pf1 else um.ref_shift,
        pos_mask=0 if pf1 else um.pos_mask,
    )
