"""Two-phase query driver (counterpart of ``mazu_tpu.index.twophase``).

Phase 1 runs on the whole batch: the dictionary's shallow main probe (a
kernel on CUDA) and an occurrence projection at a small width. Lanes that
hit a heavy bucket, were left unsettled by the shallow probe, or have more
occurrences than that width are flagged ``overflow``. Phase 2 resolves the
flagged lanes, compacted and padded to a power of two, through the exact
``get_ref_pos_padded``. Together they give exactly the one-phase query's
results.

``_main_probe`` is the main-probe dispatch that ``get_ref_pos_compact``
and ``TwoPhaseIndexQuery`` share. ``_project_fused`` projects the
occurrence words the probe carried (zero gathers); ``_project_offsets``
reads them through the offsets table for layouts whose probe carries none.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import MATCH_IDENTITY
from ..convert import words_to
from ..kphf.kcdict import kcdict_k2u
from ..kphf.runshare import sshash_k2u_reads_runshare
from ..kphf.sshash import ROW_KINDS, sshash_k2u
from ..ops.bpos_probe import bpos_usrec_k2u
from ..ops.capacity_probe import capacity_k2u
from ..ops.compact import flagged_lanes
from ..ops.mono2_probe import mono2_k2u
from .modindex import ModIndex, QueryIndex, get_ref_pos_padded
from .unitig_table import decode_words, fetch_occ_block

_K2U_FIELDS = ("unitig_id", "unitig_len", "pos", "mt")


def _main_probe(arrays: dict, fw: torch.Tensor, probe_limit: int | None = None,
                defer_valid: bool = False, mphf_level_limit: int | None = None):
    """The dictionary's main-phase probe: ``(r, probe_start)``.

    On a mono2-occ32 KCDict the probe is ``mono2_k2u`` (kernel K1), on
    another KCDict the plain ``kcdict_k2u`` (the reference has no kernel
    for it).
    On an SSHash
    it is ``sshash_k2u(mode="main")`` at depth ``probe_limit`` (plain torch
    on inline rows: the reference computes that probe in plain ``jnp``), run
    by a kernel on packed positions where one fits: ``bpos_usrec_k2u`` (K2)
    on a direct SSHash with
    the ``bpos`` rows and ``useqrec`` records (``probe_limit`` <= 3;
    ``defer_valid`` changes nothing there, the records carry the extent
    check), and ``capacity_k2u`` (K3) with ``defer_valid`` on a 32-bit
    engine's (mix32 ordering: direct or fast32) grouped16 paired layout
    without records and with a lean MPHF (``mphf_level_limit`` truncates a
    fast32 MPHF chain there; an ``mrows`` MPHF takes the plain probe). Every
    other layout takes the plain probe: the row layouts, records, flat32
    positions, and packed positions with ef, flat, flat32 or grouped32
    bounds; so does a parity SSHash (mix64 or wyhash ordering, 64-bit
    BooPHF) on every layout, as the reference runs it.

    ``probe_start`` is where the heavy phase's full re-probe may start:
    past the rows a shallow probe already proved empty of the key, 0 where
    no such proof holds."""
    k2u = arrays["k2u"]
    m_ = k2u["meta"]
    if m_.kind == "kcdict":
        if m_.scheme == "mono2" and m_.occ32:
            return mono2_k2u(k2u, fw), 0
        return kcdict_k2u(k2u, fw, mode="main"), 0
    if m_.kind != "sshash":
        raise ValueError(f"the port has no {m_.kind!r} main probe yet")
    us = k2u["us"]
    packed = m_.pos_kind == "packed"
    if (packed and m_.direct_t and "bpos" in k2u and "useqrec" in us
            and probe_limit is not None and 0 < probe_limit <= 3):
        r = bpos_usrec_k2u(k2u, fw, probe_limit)
    elif (packed and m_.hash32 and m_.prefix_kind == "grouped16" and probe_limit is not None
          and defer_valid and "useqrec" not in us and "words2" in us["useq"]
          and "wb2" in us["bv"] and "mrows" not in k2u.get("mphf", {})):
        r = capacity_k2u(k2u, fw, probe_limit, mphf_level_limit=mphf_level_limit)
    else:
        r = sshash_k2u(k2u, fw, mode="main", probe_limit=probe_limit,
                       defer_valid=defer_valid, mphf_level_limit=mphf_level_limit)
    probe_start = 0
    if (probe_limit is not None and not defer_valid and mphf_level_limit is None
            and "useqrec" not in us):
        # the heavy phase's lanes never probed (skew) or probed rows
        # [0, probe_limit) and missed: its re-probe may start past them.
        # A failed deferred winner or an unplaced MPHF lane is no such
        # proof, and neither is a record's failed extent check.
        probe_start = min(int(probe_limit), int(m_.probe_bound))
    return r, probe_start


def _project_main(arrays: dict, r: dict, small_occs: int) -> dict:
    """The main phase's projection: from the occurrence words the probe
    carried where it gave them, else through the offsets table at width
    ``small_occs``."""
    if "occ_cnt" in r:
        return _project_fused(arrays, r)
    return _project_offsets(arrays, r, small_occs)


def _main_phase(arrays: dict, fw: torch.Tensor, small_occs: int = 2,
                probe_limit: int | None = None, defer_valid: bool = False,
                mphf_level_limit: int | None = None) -> dict:
    """Main probe and small-width projection of a batch. ``overflow``
    flags every lane that phase 2 must resolve: heavy buckets, lanes the
    shallow probe left unsettled, and unitigs with more occurrences than
    the projection holds."""
    r, _ = _main_probe(arrays, fw, probe_limit, defer_valid, mphf_level_limit)
    p = _project_main(arrays, r, small_occs)
    if "occ_cnt" in r and "unresolved" in r:
        p["overflow"] = p["overflow"] | r["unresolved"]
    return p


def _project_offsets(arrays: dict, r: dict, small_occs: int) -> dict:
    """Small-width projection through the offsets table (two gathers) and
    ``fetch_occ_block``, for layouts whose probe carries no occurrence
    fields.

    ``overflow`` folds in heavy-bucket lanes (``use_skew``), lanes the
    shallow probe left unsettled (``unresolved``) and lanes whose unitig
    has more occurrences than ``small_occs``; the caller's phase 2
    resolves them exactly."""
    u2 = arrays["u2pos"]
    k = arrays["meta"].k
    hit = r["mt"] > 0
    uid = torch.where(hit, r["unitig_id"], 0)
    start = u2["offsets"][uid]
    cnt = torch.where(hit, u2["offsets"][uid + 1] - start, 0)
    overflow = r["use_skew"] | (cnt > small_occs)
    if "unresolved" in r:
        overflow = overflow | r["unresolved"]
    j = torch.arange(small_occs, dtype=start.dtype, device=start.device)
    valid = (j[None, :] < cnt[:, None]) & (~overflow)[:, None]
    ref_id, occ_pos, occ_o = fetch_occ_block(u2, start, small_occs)
    kpos = r["pos"][:, None]
    ulen = r["unitig_len"][:, None]
    fw = occ_o == 1
    o_match = (r["mt"] == MATCH_IDENTITY).to(torch.int32)[:, None]
    return {
        **{kk: r[kk] for kk in _K2U_FIELDS},
        "n_occs": cnt,
        "ref_id": ref_id,
        "ref_pos": torch.where(fw, kpos + occ_pos, occ_pos + (ulen - kpos) - k),
        "orient": torch.where(fw, o_match, 1 - o_match),
        "valid": valid,
        "overflow": overflow,
    }


def _project_fused(arrays: dict, r: dict) -> dict:
    """Project the occurrence words that the K2U row carried: two where it
    gave ``occ_word2`` (a KCDict's rows, inline2 rows, the capacity
    records), else one.

    Lanes whose unitig has more occurrences than the row carries, or that
    need the skew structure, are flagged ``overflow`` for phase 2. The
    projection math follows the reference's ``index.rs:193-216``: a forward
    occurrence maps k-mer offset ``kpos`` to ``occ_pos + kpos``, a reverse
    one to ``occ_pos + (ulen - kpos) - k``."""
    u2 = arrays["u2pos"]
    k = arrays["meta"].k
    hit = r["mt"] > 0
    cnt = torch.where(hit, r["occ_cnt"], 0)
    words = [r["occ_word"], r["occ_word2"]] if "occ_word2" in r else [r["occ_word"]]
    overflow = r["use_skew"] | (cnt > len(words))
    kpos = r["pos"]
    ulen = r["unitig_len"]
    o_match = (r["mt"] == MATCH_IDENTITY).to(torch.int32)

    def proj(word):
        ref_id, occ_pos, occ_o = decode_words(u2, word)
        fw = occ_o == 1
        ref_pos = torch.where(fw, kpos + occ_pos, occ_pos + (ulen - kpos) - k)
        return ref_id, ref_pos, torch.where(fw, o_match, 1 - o_match)

    cols = [proj(wd) for wd in words]
    base_valid = hit & ~overflow
    return {
        **{kk: r[kk] for kk in _K2U_FIELDS},
        "n_occs": cnt,
        "ref_id": torch.stack([c[0] for c in cols], dim=1),
        "ref_pos": torch.stack([c[1] for c in cols], dim=1),
        "orient": torch.stack([c[2] for c in cols], dim=1),
        "valid": torch.stack([base_valid & (cnt > j) for j in range(len(words))], dim=1),
        "overflow": overflow,
    }


def _pow2_slots(n: int) -> int:
    """Phase 2's padded width for ``n`` >= 1 lanes: ``max(64, next power
    of two)``."""
    return 1 << max(6, (n - 1).bit_length())


def _host(out: dict) -> dict:
    """A result dict as NumPy arrays (u8 ``mt``, the rest as the tensors'
    dtypes)."""
    return {kk: v.cpu().numpy() for kk, v in out.items()}


def _padded_checksum(out: dict, n_real: int) -> torch.Tensor:
    """ref_pos and ref_id over the valid occurrences and unitig_id over the
    first ``n_real`` lanes of a padded result: phase 2's share of a
    two-phase checksum."""
    lane_ok = torch.arange(out["mt"].shape[0], device=out["mt"].device) < n_real
    v = out["valid"] & lane_ok[:, None]
    return (torch.where(v, out["ref_pos"], 0).sum() + torch.where(v, out["ref_id"], 0).sum()
            + torch.where(lane_ok, out["unitig_id"], 0).sum())


def _main_checksum(p: dict) -> torch.Tensor:
    """ref_pos and ref_id over the valid main occurrences, unitig_id over
    every main lane: phase 1's share of a two-phase checksum."""
    return (torch.where(p["valid"], p["ref_pos"], 0).sum()
            + torch.where(p["valid"], p["ref_id"], 0).sum() + p["unitig_id"].sum())


class ReadBatchQuery:
    """The read pipeline's two-phase query (``mazu_tpu``'s
    ``ReadBatchQuery``): phase 1 through run sharing
    (``kphf.runshare.sshash_k2u_reads_runshare``: consecutive k-mers that
    share a bucket share its row fetch) on fused inline rows, projected by
    ``_project_fused``; phase 2 the exact padded query on the overflow
    lanes. The results equal ``TwoPhaseIndexQuery``'s.

    ``index``: a direct-engine SSHash ``ModIndex``, whose
    ``device_arrays(fused=True)`` go to ``device`` (the card by default),
    or a ``QueryIndex`` of fused inline or fixedcap rows."""

    def __init__(self, index, device=None):
        self.index = _query_index(index, device, {"fused": True})
        self.max_occs = self.index.max_occs

    def main_chk(self, fw: torch.Tensor, new_read: torch.Tensor):
        """Phase 1 of int64 words ``fw`` with bool ``new_read`` (True where a
        read begins) on the device: (its checksum, its ``overflow`` flags,
        ``run_overflow``), all tensors."""
        arrays = self.index.arrays()
        r = sshash_k2u_reads_runshare(arrays["k2u"], fw, new_read)
        p = _project_fused(arrays, r)
        return _main_checksum(p), p["overflow"], r["run_overflow"]

    def checksum_query(self, fw_words_dev: torch.Tensor, fw_words_host: np.ndarray | None,
                       new_read_dev: torch.Tensor):
        """The whole query reduced on the device: (checksum, number of
        overflow lanes), the checksum as ``TwoPhaseIndexQuery``'s, phase 2
        on the overflow lanes compacted on the device. Raises if the batch
        had more runs than run slots (it has a slot a lane: never).
        ``fw_words_host`` is accepted for the reference's signature and not
        read."""
        chk, overflow, run_ovf = self.main_chk(fw_words_dev, new_read_dev)
        if bool(run_ovf):
            raise RuntimeError("run budget exceeded (not a read batch?)")
        lanes, s2 = _overflow_phase(self.index.arrays(), self.max_occs, fw_words_dev, overflow)
        if s2 is not None:
            chk = chk + _padded_checksum(s2, lanes.shape[0])
        return int(chk), int(lanes.shape[0])


def _overflow_phase(arrays: dict, max_occs: int, fw: torch.Tensor, overflow: torch.Tensor):
    """(lanes [n] on the device, phase 2 over them padded to
    ``_pow2_slots(n)``, or None when no lane overflows): the flagged lanes
    compacted on the device, their count read back once, then
    ``get_ref_pos_padded``."""
    lanes, n = flagged_lanes(overflow, fw.shape[0])
    n = int(n)
    if n == 0:
        return lanes[:0], None
    padded = torch.zeros(_pow2_slots(n), dtype=fw.dtype, device=fw.device)
    padded[:n] = fw[lanes[:n]]
    return lanes[:n], get_ref_pos_padded(arrays, padded, max_occs)


def _query_index(index, device, layout: dict) -> QueryIndex:
    """``index``'s arrays on a device: a ``ModIndex``'s
    ``device_arrays(**layout)`` moved to ``device`` (the card by default),
    or a ``QueryIndex``, which has its layout and device already (a
    ``device`` raises)."""
    from ..convert import arrays_from_numpy, resolve_device

    if isinstance(index, ModIndex):
        host = index.device_arrays(**layout)
        return QueryIndex(arrays_from_numpy(host, "cpu")).to(resolve_device(device))
    if isinstance(index, QueryIndex):
        if device is not None:
            raise ValueError("a QueryIndex has its layout and device already")
        return index
    raise TypeError(f"index must be a ModIndex or a QueryIndex, not {type(index).__name__}")


class TwoPhaseIndexQuery:
    """The two-phase query of one index (``mazu_tpu``'s serving path).

    ``index``: a ``ModIndex``, whose ``device_arrays(fused=fused, **layout)``
    go to ``device`` (the card by default), or a ``QueryIndex``, queried
    where it lies. ``fused=None`` is the reference's default: fused rows on
    a 32-bit (direct or fast32) SSHash laid out in rows (inline, inline2,
    fixedcap or fixedcap2; inline unless ``layout`` names another
    ``pos_kind``), unfused on its other layouts; a parity
    SSHash is not fused (its default layout is packed positions with
    Elias-Fano bounds); a KCDict's rows carry the fused occurrence words
    already.

    ``main(fw)`` is phase 1 (``_main_phase`` at width ``small_occs``) and
    ``full(fw)`` the exact padded query, both on int64 word tensors on the
    index's device. The other methods take and return host arrays."""

    def __init__(self, index, small_occs: int = 2, device=None, fused: bool | None = None,
                 probe_limit: int | None = None, **layout):
        if isinstance(index, QueryIndex) and (layout or fused is not None):
            raise ValueError("a QueryIndex has its layout and device already")
        if isinstance(index, ModIndex) and fused is None:
            fused = getattr(index.k2u, "hash32", False) and layout.get("pos_kind") in (
                None, *ROW_KINDS)
        self.index = _query_index(index, device, dict(layout, fused=bool(fused)))
        self.small_occs = int(small_occs)
        self.max_occs = self.index.max_occs
        self.probe_limit = probe_limit

    @property
    def device(self) -> torch.device:
        return next(self.index.buffers()).device

    def main(self, fw: torch.Tensor) -> dict:
        return _main_phase(self.index.arrays(), fw, self.small_occs, self.probe_limit)

    def full(self, fw: torch.Tensor) -> dict:
        return get_ref_pos_padded(self.index.arrays(), fw, self.max_occs)

    def _words(self, fw_words: np.ndarray) -> torch.Tensor:
        return words_to(fw_words, self.device)

    def checksum_query(self, fw_words_dev: torch.Tensor, fw_words_host: np.ndarray | None = None):
        """The whole two-phase query reduced on the device: (checksum,
        number of overflow lanes). The checksum sums ref_pos and ref_id over
        valid main occurrences and unitig_id over every main lane, then
        ref_pos, ref_id over valid occurrences and unitig_id over the real
        lanes of phase 2. ``fw_words_host`` is accepted for the reference's
        signature and not read: the lanes are compacted on the device."""
        r = self.main(fw_words_dev)
        s = _main_checksum(r)
        lanes, s2 = _overflow_phase(self.index.arrays(), self.max_occs, fw_words_dev,
                                    r["overflow"])
        if s2 is not None:
            s = s + _padded_checksum(s2, lanes.shape[0])
        return int(s), int(lanes.shape[0])

    def query(self, fw_words: np.ndarray):
        """(main_out, overflow_lane_indices, overflow_out), host arrays:
        ``main_out`` is exact for lanes not flagged ``overflow``
        (occurrences padded to ``small_occs``); ``overflow_out`` (None when
        no lane overflows) holds the exact results of the flagged lanes, in
        order, padded to the index's maximum occurrence count."""
        fw = self._words(fw_words)
        r = self.main(fw)
        lanes, s = _overflow_phase(self.index.arrays(), self.max_occs, fw, r["overflow"])
        n = lanes.shape[0]
        return (_host(r), lanes.cpu().numpy(),
                None if s is None else {kk: v[:n] for kk, v in _host(s).items()})

    def get_ref_pos_batch(self, fw_words: np.ndarray):
        """The query as a CSR ``mapping.BatchHits``: the two phases merged
        without per-k-mer Python objects."""
        from .mapping import BatchHits

        r, lanes, s = self.query(fw_words)
        return BatchHits.from_twophase(r, lanes, s)

    def get_ref_pos_eager(self, fw_words: np.ndarray) -> list:
        """Per-query hit lists, (ref_id, ref_pos, orient) tuples, None for a
        miss: the answer shape of ``ModIndex.get_ref_pos_eager``."""
        r, lanes, s = self.query(fw_words)
        return _merge_lists(r, lanes, s, len(fw_words))


def _merge_lists(r: dict, lanes: np.ndarray, s, n: int) -> list:
    """Per-lane hit lists from a main result ``r`` and the phase-2 rows
    ``s`` of ``lanes``; a lane's hits are clipped to its source's width."""
    lane_pos = {int(q): i for i, q in enumerate(lanes)}
    out = []
    for q in range(n):
        src, row = (s, lane_pos[q]) if q in lane_pos else (r, q)
        if src["mt"][row] == 0:
            out.append(None)
            continue
        width = src["ref_id"].shape[1]
        out.append([(int(src["ref_id"][row, j]), int(src["ref_pos"][row, j]),
                     int(src["orient"][row, j]))
                    for j in range(min(int(src["n_occs"][row]), width))])
    return out
