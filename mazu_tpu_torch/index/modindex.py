"""ModIndex and its batched query (counterpart of
``mazu_tpu.index.modindex``), for the KCDict mono2-occ32 K2U.

    k-mer words [N] -> K2U probe -> occurrence words -> projection
    -> reference positions

``get_ref_pos_padded`` is the exact one-phase query. ``get_ref_pos_compact``
is the main path: the probe kernel plus a zero-gather projection for lanes
whose unitig has at most two occurrences, then a compacted phase 2 that
runs the padded query on the remaining lanes only.
"""

from __future__ import annotations

import torch

from .. import MATCH_IDENTITY
from ..ops.compact import flagged_lanes
from ..ops.mono2_probe import mono2_k2u
from ..pytree import meta
from .twophase import _project_fused
from .unitig_table import fetch_occ_block

_K2U_FIELDS = ("unitig_id", "unitig_len", "pos", "mt")
_MERGE_FIELDS = _K2U_FIELDS + ("n_occs", "ref_id", "ref_pos", "orient", "valid")


def k2u_batch(d: dict, fw: torch.Tensor) -> dict:
    """Full (exact) K2U for the index's dictionary."""
    from ..kphf.kcdict import kcdict_k2u

    kind = d["k2u"]["meta"].kind
    if kind != "kcdict":
        raise ValueError(f"the port has no {kind!r} K2U yet")
    return kcdict_k2u(d["k2u"], fw)


def _occ_projection_wide(d: dict, r: dict, max_occs: int) -> dict:
    """Padded projection of up to ``max_occs`` occurrences per lane, with
    occurrence bounds from the offsets table (reference ``index.rs:193-216``)."""
    u2 = d["u2pos"]
    hit = r["mt"] > 0
    uid = torch.where(hit, r["unitig_id"], 0)
    start = u2["offsets"][uid]
    cnt = torch.where(hit, u2["offsets"][uid + 1] - start, 0)
    j = torch.arange(max_occs, dtype=start.dtype, device=start.device)
    ref_id, occ_pos, occ_o = fetch_occ_block(u2, start, max_occs)
    k = d["meta"].k
    kpos = r["pos"][:, None]
    ulen = r["unitig_len"][:, None]
    fw = occ_o == 1
    o_match = (r["mt"] == MATCH_IDENTITY).to(torch.int32)[:, None]
    return {
        "n_occs": cnt,
        "ref_id": ref_id,
        "ref_pos": torch.where(fw, kpos + occ_pos, occ_pos + (ulen - kpos) - k),
        "orient": torch.where(fw, o_match, 1 - o_match),
        "valid": j[None, :] < cnt[:, None],
    }


def get_ref_pos_padded(d: dict, fw: torch.Tensor, max_occs: int) -> dict:
    """Exact query with occurrence lists padded to ``max_occs``.

    Returns the K2U fields [N] plus ref_id, ref_pos (int64), orient (int32,
    1 = forward) and valid (bool), each [N, max_occs], and n_occs [N]."""
    r = k2u_batch(d, fw)
    return {**r, **_occ_projection_wide(d, r, max_occs)}


def _pad_cols(x: torch.Tensor, w: int) -> torch.Tensor:
    if x.shape[1] == w:
        return x
    z = torch.zeros(x.shape[0], w - x.shape[1], dtype=x.dtype, device=x.device)
    return torch.cat([x, z], dim=1)


def _merge_compact(p: dict, out2: dict, lanes, slot_real, max_occs: int) -> dict:
    """Main-phase results padded to full width with the compacted phase-2
    block scattered back over its lanes; fake slots go to a dummy row."""
    N = p["mt"].shape[0]
    w = max(max_occs, p["ref_id"].shape[1])
    dest = torch.where(slot_real, lanes, N)
    full = {}
    for kk in _MERGE_FIELDS:
        base = _pad_cols(p[kk], w) if p[kk].dim() == 2 else p[kk]
        v = out2[kk]
        base = torch.cat([base, torch.zeros_like(base[:1])])
        base[dest] = _pad_cols(v, w) if v.dim() == 2 else v
        full[kk] = base[:N]
    return full


def merge_compact_k2u(out: dict) -> dict:
    """Per-lane unitig_id, pos and mt of a ``merge=False`` compact result:
    main-phase values with the phase-2 lanes scattered back over them."""
    cols = {kk: out["main"][kk] for kk in ("unitig_id", "pos", "mt")}
    n = cols["mt"].shape[0]
    safe = torch.where(out["slot_real"], out["lanes"], n)  # fakes -> dummy row
    for kk in cols:
        ext = torch.cat([cols[kk], cols[kk][:1]])
        ext[safe] = out["phase2"][kk]
        cols[kk] = ext[:n]
    return cols


def get_ref_pos_compact(
    d: dict,
    fw: torch.Tensor,
    max_occs: int,
    merge: bool = True,
    m2: int | None = None,
) -> dict:
    """Two-phase exact query with an on-device compacted phase 2.

    Main phase: ``mono2_k2u`` (the probe kernel on CUDA) and the fused
    projection of the row's two occurrence words. Lanes not found in the
    main table, or whose unitig has more than two occurrences, are
    compacted into ``M = m2`` (default ``N // 4``) slots and
    resolved by ``get_ref_pos_padded``. Results equal
    ``get_ref_pos_padded``'s unless ``over_budget`` is set: more than M
    lanes overflowed, and the lanes past M were not resolved.

    ``merge=False`` returns the pieces (``main``, ``overflow``, ``lanes``,
    ``slot_real``, ``phase2``, ``n_ovf``, ``over_budget``) without
    materializing merged [N, max_occs] tensors."""
    N = fw.shape[0]
    M = int(m2) if m2 else max(64, N // 4)
    r = mono2_k2u(d["k2u"], fw)
    p = _project_fused(d, r)
    overflow = p["overflow"] | r["unresolved"]
    lanes, n_ovf = flagged_lanes(overflow, M)
    over_budget = n_ovf > M
    out2 = get_ref_pos_padded(d, fw[lanes], max_occs)
    slot_real = torch.arange(M, device=fw.device) < torch.clamp(n_ovf, max=M)
    if not merge:
        return {
            "main": {**{kk: r[kk] for kk in _K2U_FIELDS}, **p},
            "overflow": overflow,
            "lanes": lanes,
            "slot_real": slot_real,
            "phase2": out2,
            "n_ovf": n_ovf,
            "over_budget": over_budget,
        }
    full = _merge_compact(p, out2, lanes, slot_real, max_occs)
    full["over_budget"] = over_budget
    return full


class ModIndex:
    """Host-side index: K2U dictionary + U2Pos occurrence table + refs."""

    def __init__(self, k2u, u2pos, refs, index_type: str = "Custom"):
        self.k2u = k2u
        self.u2pos = u2pos
        self.refs = refs
        self.index_type = index_type

    @property
    def k(self) -> int:
        return self.k2u.k

    def max_occs(self) -> int:
        return self.u2pos.max_occs()

    def device_arrays(self) -> dict:
        """NumPy arrays in the reference's ``device_arrays(fused=True)``
        layout (KCDict rows already carry the fused occurrence words)."""
        return {
            "k2u": self.k2u.device_arrays(),
            "u2pos": self.u2pos.device_arrays(),
            "refs": self.refs.device_arrays(),
            "meta": meta(k=self.k, index_type=self.index_type),
        }


class _Buf:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name


class QueryIndex(torch.nn.Module):
    """An index's query arrays (a dict of tensors, see
    ``convert.arrays_from_numpy``) held as buffers, so ``.to(device)``
    moves them all. ``arrays()`` returns the dict the query functions take.
    """

    def __init__(self, arrays: dict):
        super().__init__()
        self._tree = self._register(arrays, ())
        off = arrays["u2pos"]["offsets"]
        self.max_occs = max(1, int((off[1:] - off[:-1]).max())) if off.numel() > 1 else 1

    def _register(self, node, path):
        if isinstance(node, dict):
            return {k: self._register(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, torch.Tensor):
            name = "__".join(path)
            self.register_buffer(name, node, persistent=False)
            return _Buf(name)
        return node

    def arrays(self) -> dict:
        def build(node):
            if isinstance(node, dict):
                return {k: build(v) for k, v in node.items()}
            if isinstance(node, _Buf):
                return getattr(self, node.name)
            return node

        return build(self._tree)

    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in self.buffers())
