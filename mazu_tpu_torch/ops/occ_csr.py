"""The ragged (CSR) phase 2 of the two-phase query: CUDA kernel, its build,
its wrapper, its plain version and its dispatch. It replaces no TPU kernel:
the reference's phase 2 is plain ``jnp`` (``get_ref_pos_padded`` over
``[m2, max_occs]``), and its ``get_ref_pos_csr`` lays out the same CSR form
in plain ``jnp``.

``occ_csr(d, r, n_ovf, budget)`` takes the exact K2U fields ``r``
(``unitig_id``, ``unitig_len``, ``pos``, ``mt``) of the ``m`` compacted
phase-2 slots, of which the first ``min(n_ovf, m)`` are real, and returns
every occurrence of every real slot's unitig, projected, in one flat block
of ``budget`` entries: slot order, then occurrence order. Per slot:
``occ_count`` (0 for a miss and a fake slot) and ``occ_start`` (its first
entry: the exclusive prefix of the counts); ``total``, the true count (an
int64 scalar); and per entry ``qid`` (its slot, int32), ``ref_id`` (int32),
``ref_pos`` (int64) and ``orient`` (int8, 1 where the k-mer reads the
reference forward). Entries at or past ``min(total, budget)`` are not
written: the occurrences past the budget are left out and ``total`` says
so; a consumer reads the first ``min(total, budget)``. ``get_ref_pos_csr``
gives the same fields on the real slots' k-mers.

``occ_csr_plain`` is the oracle and the CPU path, and the body of
``index.modindex.get_ref_pos_csr`` (every query real): it also fills the
entries past the total as that function does (``qid`` clipped, ``ref_id``
-1, ``ref_pos`` and ``orient`` 0) and adds ``valid``. CUDA tensors launch
``csrc/occ_csr.cu`` (``occ_csr_kernel``) or raise.

``engages(d, max_occs)`` is the one predicate of the ragged phase: an
index whose padded phase 2 would be wider than ``COLUMNS`` occurrences,
other than a mono2-occ32 KCDict (whose phase 2 is ``ops.mono2_phase2``).
It reads the metas and ``max_occs`` only, so it decides per index, on
every device. ``budget(d, max_occs, m2, occ_budget)`` is the budget of
occurrences a chunk that ``get_ref_pos_compact(merge=False)``,
``OneGraphIndexQuery`` and ``RunServePass`` use where it engages (None
where it does not). The kernel is compiled on first use (``cuda_build``)
and loaded with ``ctypes``; ``LAUNCHES`` counts its calls (three launches
each). ``occurrence_sum`` reads a block's written entries back for a
checksum.
"""

from __future__ import annotations

import ctypes

import torch

from .. import MATCH_IDENTITY
from .cuda_build import CSRC, compile_library

LAUNCHES = 0

SOURCE = CSRC / "occ_csr.cu"
COLUMNS = 64  # the widest padded phase 2 kept: wider engages the ragged phase
TILE = 256  # kTile: slots a block of the count and scan stages
OCC_TILE = 2048  # kOccTile: entries a block of the write stage takes at a time
ENCODINGS = ("piscem", "pf1")  # occurrence words the kernel decodes
_LIB = None

# (field, key, dtype) of the outputs, in the kernel's order
_SLOT_OUTPUTS = (("occ_start", torch.int64), ("occ_count", torch.int64))
_ENTRY_OUTPUTS = (("qid", torch.int32), ("ref_id", torch.int32), ("ref_pos", torch.int64),
                  ("orient", torch.int8))
_SCALARS = ("m", "budget", "k", "pf1", "ref_shift", "pos_mask", "occ_last")


class _Args(ctypes.Structure):
    """The kernel's ``Args`` block: the inputs, the outputs, the scratch,
    then scalars; every field is 8 bytes."""

    _fields_ = (
        [(name, ctypes.c_void_p)
         for name in ("n_ovf", "uid", "ulen", "pos", "mt", "offsets", "ctable2")]
        + [(name, ctypes.c_void_p) for name, _ in _SLOT_OUTPUTS]
        + [("total", ctypes.c_void_p)]
        + [(name, ctypes.c_void_p) for name, _ in _ENTRY_OUTPUTS]
        + [("scratch", ctypes.c_void_p)]
        + [(name, ctypes.c_int64) for name in _SCALARS]
    )


def _library():
    global _LIB
    if _LIB is None:
        path, _ = compile_library(SOURCE)
        lib = ctypes.CDLL(str(path))
        lib.occ_csr.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        lib.occ_csr.restype = ctypes.c_int
        lib.occ_csr_sum.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] + [ctypes.c_void_p] * 2
        lib.occ_csr_sum.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def engages(d: dict, max_occs: int) -> bool:
    """Whether phase 2 of ``get_ref_pos_compact(merge=False)`` on the
    arrays ``d`` is the ragged one: a padded phase 2 wider than
    ``COLUMNS``, on any index but a mono2-occ32 KCDict."""
    k2u = d.get("k2u")
    if not isinstance(k2u, dict) or not isinstance(d.get("u2pos"), dict):
        return False
    m = k2u["meta"]
    if getattr(m, "kind", None) == "kcdict" and m.scheme == "mono2" and m.occ32:
        return False
    return int(max_occs) > COLUMNS


def budget(d: dict, max_occs: int, m2: int, occ_budget: int | None = None) -> int | None:
    """The ragged phase 2's budget of occurrences a chunk of ``m2`` phase-2
    slots on the arrays ``d``: ``occ_budget``, by default ``m2 * COLUMNS``;
    None where the phase is not ragged (``engages``)."""
    if not engages(d, max_occs):
        return None
    return int(occ_budget) if occ_budget else int(m2) * COLUMNS


def occ_csr_plain(d: dict, r: dict, n_ovf: torch.Tensor, budget: int) -> dict:
    """The ragged phase 2 in plain torch (see the module)."""
    from ..index.unitig_table import decode_occs

    u2 = d["u2pos"]
    m = r["mt"].shape[0]
    dev = r["mt"].device
    real = torch.arange(m, device=dev) < torch.clamp(n_ovf, max=m)
    hit = (r["mt"] > 0) & real
    uid = torch.where(hit, r["unitig_id"], 0)
    start = u2["offsets"][uid]
    cnt = torch.where(hit, u2["offsets"][uid + 1] - start, 0)
    occ_start = torch.cumsum(cnt, 0) - cnt
    total = cnt.sum()
    j = torch.arange(int(budget), dtype=torch.int64, device=dev)
    qid = torch.clamp(torch.searchsorted(occ_start, j, right=True) - 1, 0, max(m - 1, 0))
    within = j - occ_start[qid]
    valid = (j < total) & (within < cnt[qid])
    occ_idx = torch.clamp(start[qid] + within, 0, max(u2["meta"].n_occs - 1, 0))
    ref_id, occ_pos, occ_o = decode_occs(u2, occ_idx)
    kpos, ulen = r["pos"][qid], r["unitig_len"][qid]
    fwd = occ_o == 1
    ref_pos = torch.where(fwd, kpos + occ_pos, occ_pos + (ulen - kpos) - d["meta"].k)
    o_match = (r["mt"][qid] == MATCH_IDENTITY).to(torch.int8)
    orient = torch.where(fwd, o_match, 1 - o_match)
    return {
        "occ_start": occ_start,
        "occ_count": cnt,
        "total": total,
        "qid": qid.to(torch.int32),
        "ref_id": torch.where(valid, ref_id, -1).to(torch.int32),
        "ref_pos": torch.where(valid, ref_pos, 0),
        "orient": torch.where(valid, orient, 0).to(torch.int8),
        "valid": valid,
    }


def occurrence_sum(p2: dict, words: torch.Tensor) -> torch.Tensor:
    """int64 sum, over the written entries (the first ``min(total,
    budget)``) of a ragged phase 2, of ``ref_pos + ref_id + orient + 2 *
    words[qid]``: every field the block holds, each entry's slot through
    the k-mer it answers (``words``: each slot's int64 k-mer word). Read
    back from the block: on CUDA by ``occ_csr_sum_kernel``, which reads only those
    entries (a masked torch sum reads the whole budget, several times),
    else in plain torch."""
    ref_id, ref_pos, total = p2["ref_id"], p2["ref_pos"], p2["total"]
    qid, orient = p2["qid"], p2["orient"]
    if ref_pos.device.type != "cuda":
        live = torch.arange(ref_pos.shape[0], device=ref_pos.device) < total
        v = ref_pos + ref_id + orient + 2 * words[qid.to(torch.int64)]
        return torch.where(live, v, 0).sum()
    if words.dtype != torch.int64 or not words.is_contiguous() or words.device != ref_pos.device:
        raise ValueError("words must be a contiguous int64 tensor on the block's device")
    out = torch.empty((), dtype=torch.int64, device=ref_pos.device)
    fn = _library().occ_csr_sum
    with torch.cuda.device(ref_pos.device):
        err = fn(ref_id.data_ptr(), ref_pos.data_ptr(), orient.data_ptr(), qid.data_ptr(),
                 words.data_ptr(), total.data_ptr(), ref_pos.shape[0], out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"occ_csr_sum launch failed: CUDA error {err}")
    return out


def _check(d: dict, r: dict, n_ovf: torch.Tensor, budget: int) -> None:
    """Raise unless the kernel can run on these tensors."""
    u2 = d["u2pos"]
    um = u2["meta"]
    c2 = u2.get("ctable2")
    if getattr(um, "enc", None) not in ENCODINGS or c2 is None or um.n_occs < 1:
        raise ValueError("occ_csr needs an occurrence table with ctable2 pair rows (piscem or "
                         "pf1) on the card")
    if c2.dtype != torch.int32 or tuple(c2.shape) != (um.n_occs, 4) or c2.data_ptr() % 16:
        raise ValueError("ctable2 must be [n_occs, 4] int32 rows, 16-byte aligned")
    if not 0 <= budget < (1 << 31):
        raise ValueError(f"budget {budget} outside [0, 2^31)")
    dev = r["mt"].device
    tensors = [n_ovf, u2["offsets"], c2] + [r[key] for key in ("unitig_id", "unitig_len", "pos",
                                                                "mt")]
    for x in tensors:
        if x.device != dev or not x.is_contiguous():
            raise ValueError("every input must be contiguous and on one device")
    for key in ("unitig_id", "unitig_len", "pos"):
        if r[key].dtype != torch.int64 or r[key].dim() != 1:
            raise ValueError(f"{key} must be a 1-D int64 tensor")
    if r["mt"].dtype != torch.uint8 or u2["offsets"].dtype != torch.int64:
        raise ValueError("mt must be uint8 and the offsets int64")
    if n_ovf.dtype != torch.int64 or n_ovf.numel() != 1:
        raise ValueError("n_ovf must be one int64 value")


def outputs(m: int, budget: int, device) -> dict:
    """The kernel's outputs for ``m`` slots and ``budget`` entries,
    unwritten."""
    out = {key: torch.empty(m, dtype=dt, device=device) for key, dt in _SLOT_OUTPUTS}
    out["total"] = torch.empty((), dtype=torch.int64, device=device)
    out.update({key: torch.empty(budget, dtype=dt, device=device) for key, dt in _ENTRY_OUTPUTS})
    return out


def occ_csr(d: dict, r: dict, n_ovf: torch.Tensor, budget: int) -> dict:
    """The ragged phase 2 of the slots whose K2U is ``r`` (see the
    module): the plain version on the CPU, the kernel on a CUDA device."""
    global LAUNCHES
    dev = r["mt"].device
    budget = int(budget)
    if dev.type == "cpu":
        return occ_csr_plain(d, r, n_ovf, budget)
    if dev.type != "cuda":
        raise ValueError(f"no ragged phase 2 for device {dev}")
    _check(d, r, n_ovf, budget)
    m = r["mt"].shape[0]
    out = outputs(m, budget, dev)
    if m == 0:
        out["total"].zero_()
        return out
    tiles = -(-m // TILE)
    scratch = torch.empty(m + tiles, dtype=torch.int64, device=dev)
    u2 = d["u2pos"]
    um = u2["meta"]
    pf1 = um.enc == "pf1"
    args = _Args(
        n_ovf=n_ovf.data_ptr(), uid=r["unitig_id"].data_ptr(), ulen=r["unitig_len"].data_ptr(),
        pos=r["pos"].data_ptr(), mt=r["mt"].data_ptr(), offsets=u2["offsets"].data_ptr(),
        ctable2=u2["ctable2"].data_ptr(),
        **{key: out[key].data_ptr() for key, _ in _SLOT_OUTPUTS}, total=out["total"].data_ptr(),
        **{key: out[key].data_ptr() for key, _ in _ENTRY_OUTPUTS}, scratch=scratch.data_ptr(),
        m=m, budget=budget, k=d["meta"].k, pf1=int(pf1), ref_shift=0 if pf1 else um.ref_shift,
        pos_mask=0 if pf1 else um.pos_mask, occ_last=um.n_occs - 1,
    )
    fn = _library().occ_csr
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"occ_csr launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
