"""ModIndex and its batched query (counterpart of
``mazu_tpu.index.modindex``), for the KCDict mono2-occ32, the SSHash
(direct and fast32 engines) and the pufferfish PFHash and SampledPFHash
K2Us.

    k-mer words [N] -> K2U probe -> occurrence words -> projection
    -> reference positions

``get_ref_pos_padded`` is the exact one-phase query (the pufferfish
indexes' path, over a pf1 ``DenseUnitigTable``). ``get_ref_pos_compact``
is the KCDict and SSHash main path: a shallow probe (a kernel on CUDA)
plus a zero-gather projection for lanes whose unitig has at most two
occurrences, then compacted phases that resolve the remaining lanes
exactly.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .. import MATCH_IDENTITY, trace
from ..ops import mono2_phase2, occ_csr, residue_k2u
from ..ops.compact import flagged_lanes, flagged_lanes2
from ..ops.mono2_probe import card_table
from ..pytree import meta
from .unitig_table import decode_occs, fetch_occ_block, needs_ctable

_K2U_FIELDS = ("unitig_id", "unitig_len", "pos", "mt")
_MERGE_FIELDS = _K2U_FIELDS + ("n_occs", "ref_id", "ref_pos", "orient", "valid")


def build_uproj(u2pos, unitigs) -> np.ndarray:
    """Per-unitig projection record, u64 rows ``[ustart, ulen,
    cnt | occ_start << 32, occ_word1, occ_word2]``: the unitig's extent,
    its occurrence bounds and its first two encoded occurrences."""
    needs_ctable(u2pos, "build_uproj")
    cwords = u2pos.ctable.to_array()
    off = np.asarray(u2pos.offsets, dtype=np.int64)
    accum = np.asarray(unitigs.accum, dtype=np.int64)
    n = len(accum) - 1
    if len(off) != n + 1:
        raise ValueError("offsets and unitig count disagree")
    if off[-1] >= (1 << 32):
        raise ValueError("occ_start rides in 32 bits")
    cnt = off[1:] - off[:-1]
    hi = max(len(cwords) - 1, 0)
    first = np.asarray(cwords[np.clip(off[:-1], 0, hi)], dtype=np.uint64)
    second = np.asarray(cwords[np.clip(off[:-1] + 1, 0, hi)], dtype=np.uint64) * (cnt >= 2)
    rows = np.empty((n, 5), dtype=np.uint64)
    rows[:, 0] = accum[:-1].astype(np.uint64)
    rows[:, 1] = (accum[1:] - accum[:-1]).astype(np.uint64)
    rows[:, 2] = cnt.astype(np.uint64) | (off[:-1].astype(np.uint64) << np.uint64(32))
    rows[:, 3] = first * (cnt >= 1)
    rows[:, 4] = second
    return rows


def build_useqrec(u2pos, unitigs) -> np.ndarray:
    """Per-32-base window record, u64 rows ``[w_i, w_i+1, w_i+2,
    ustart | ulen << 40, uid | cnt << 32, occ_word1, occ_word2]`` (56 B),
    keyed by useq word index i. One row holds a 96-base candidate window
    and, for the unitig that contains base 32 i, its extent, id, occurrence
    count and first two occurrence words."""
    needs_ctable(u2pos, "build_useqrec")
    up = build_uproj(u2pos, unitigs)
    words = np.asarray(unitigs.useq.words, dtype=np.uint64)
    accum = np.asarray(unitigs.accum, dtype=np.int64)
    nw = len(words)
    base = np.arange(nw, dtype=np.int64) * 32
    uid = np.clip(np.searchsorted(accum, base, side="right") - 1, 0, len(accum) - 2)
    ustart, ulen = up[uid, 0], up[uid, 1]
    if int(ustart.max(initial=0)) >= 1 << 40:
        raise ValueError("ustart rides in 40 bits")
    if int(ulen.max(initial=0)) >= 1 << 24:
        raise ValueError("ulen rides in 24 bits")
    if len(accum) - 1 >= 1 << 32:
        raise ValueError("uid rides in 32 bits")
    wp = np.concatenate([words, np.zeros(2, dtype=np.uint64)])
    rec = np.empty((nw, 7), dtype=np.uint64)
    rec[:, 0] = wp[:nw]
    rec[:, 1] = wp[1 : nw + 1]
    rec[:, 2] = wp[2 : nw + 2]
    rec[:, 3] = ustart | (ulen << np.uint64(40))
    rec[:, 4] = uid.astype(np.uint64) | ((up[uid, 2] & np.uint64(0xFFFFFFFF)) << np.uint64(32))
    rec[:, 5] = up[uid, 3]
    rec[:, 6] = up[uid, 4]
    return rec


def k2u_batch(d: dict, fw: torch.Tensor, probe_start: int = 0) -> dict:
    """Full (exact) K2U for the index's dictionary. ``probe_start``
    (SSHash only) skips candidate rows [0, probe_start): see
    ``sshash_k2u``."""
    kind = d["k2u"]["meta"].kind
    if kind == "sshash":
        from ..kphf.sshash import sshash_k2u

        return sshash_k2u(d["k2u"], fw, probe_start=probe_start)
    if probe_start:
        raise ValueError("probe_start is an SSHash-only contract")
    if kind == "kcdict":
        from ..kphf.kcdict import kcdict_k2u

        return kcdict_k2u(d["k2u"], fw)
    if kind == "pfhash":
        from ..kphf.pfhash import pfhash_k2u

        return pfhash_k2u(d["k2u"], fw)
    if kind == "sampled":
        from ..kphf.sampled import sampled_k2u

        return sampled_k2u(d["k2u"], fw)
    raise ValueError(f"the port has no {kind!r} K2U yet")


def _occ_projection_wide(d: dict, r: dict, max_occs: int) -> dict:
    """Padded projection of up to ``max_occs`` occurrences per lane
    (reference ``index.rs:193-216``). The occurrence bounds are the K2U's
    ``occ_start``/``occ_cnt`` where it gives them (the uproj records), else
    they come from the offsets table."""
    u2 = d["u2pos"]
    hit = r["mt"] > 0
    if "occ_start" in r:
        start = r["occ_start"]
        cnt = torch.where(hit, r["occ_cnt"], 0)
    else:
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


def get_ref_pos_padded(d: dict, fw: torch.Tensor, max_occs: int, probe_start: int = 0) -> dict:
    """Exact query with occurrence lists padded to ``max_occs``.

    Returns the K2U fields [N] plus ref_id, ref_pos (int64), orient (int32,
    1 = forward) and valid (bool), each [N, max_occs], and n_occs [N]."""
    r = k2u_batch(d, fw, probe_start=probe_start)
    return {**r, **_occ_projection_wide(d, r, max_occs)}


def _pad_cols(x: torch.Tensor, w: int) -> torch.Tensor:
    if x.shape[1] == w:
        return x
    z = torch.zeros(x.shape[0], w - x.shape[1], dtype=x.dtype, device=x.device)
    return torch.cat([x, z], dim=1)


def _merge_compact(p: dict, pieces, max_occs: int) -> dict:
    """Main-phase results padded to full width, with each compacted block
    of ``pieces`` ((block, lanes, slot_real) triples) scattered back over
    its lanes; fake slots go to a dummy row."""
    N = p["mt"].shape[0]
    w = max(max_occs, p["ref_id"].shape[1])
    full = {kk: _pad_cols(p[kk], w) if p[kk].dim() == 2 else p[kk] for kk in _MERGE_FIELDS}
    for out2, lanes, slot_real in pieces:
        dest = torch.where(slot_real, lanes, N)
        for kk in _MERGE_FIELDS:
            v = out2[kk]
            base = torch.cat([full[kk], torch.zeros_like(full[kk][:1])])
            base[dest] = _pad_cols(v, w) if v.dim() == 2 else v
            full[kk] = base[:N]
    return full


def merge_compact_k2u(out: dict) -> dict:
    """Per-lane unitig_id, pos and mt of a ``merge=False`` compact result:
    main-phase values with the compacted lanes (``phase2``, and
    ``phase2b`` when the heavy phase is type-split) scattered back."""
    cols = {kk: out["main"][kk] for kk in ("unitig_id", "pos", "mt")}
    n = cols["mt"].shape[0]
    blocks = [("phase2", "lanes", "slot_real")]
    if "phase2b" in out:
        blocks.append(("phase2b", "lanes_b", "slot_real_b"))
    for pk, lk, sk in blocks:
        safe = torch.where(out[sk], out[lk], n)  # fakes -> dummy row
        for kk in cols:
            ext = torch.cat([cols[kk], cols[kk][:1]])
            ext[safe] = out[pk][kk]
            cols[kk] = ext[:n]
    return cols


def _compact_split(d, fw, r, p, overflow, m_a, m_b, max_occs, merge, probe_start=0,
                   probe_limit2=None, m_c=None):
    """Type-split heavy phase. Type-A lanes (resolved by the main probe,
    but their unitig has more than two occurrences) need only the wide
    occurrence fetch, from the main probe's occurrence bounds where it gave
    them. Type-B lanes (a skew bucket, rows past the probed depth, a record
    or a deferred winner that failed validation, or a lane the truncated
    MPHF chain did not place) re-run the K2U.

    ``probe_limit2`` inserts a middle phase: type-B lanes first re-probe
    to depth ``probe_limit2`` with the window records, and only the
    residue (skew lanes, deeper buckets, failed extents; at most ``m_c``
    lanes) pays the full-depth padded query."""
    from ..kphf.sshash import sshash_k2u

    type_b = r["use_skew"] | r["unresolved"]
    type_a = overflow & ~type_b
    lanes_a, n_a, lanes_b, n_b = flagged_lanes2(type_a, type_b, m_a, m_b)
    over_budget = (n_a > m_a) | (n_b > m_b)
    rA = {kk: r[kk][lanes_a] for kk in _K2U_FIELDS + (
        ("occ_start", "occ_cnt") if "occ_start" in r else ())}
    outA = {**{kk: rA[kk] for kk in _K2U_FIELDS}, **_occ_projection_wide(d, rA, max_occs)}
    dev = fw.device
    sa = torch.arange(m_a, device=dev) < torch.clamp(n_a, max=m_a)
    sb = torch.arange(m_b, device=dev) < torch.clamp(n_b, max=m_b)
    n_c = None
    if probe_limit2 is None:
        outB = get_ref_pos_padded(d, fw[lanes_b], max_occs, probe_start=probe_start)
    else:
        fwB = fw[lanes_b]
        rM = sshash_k2u(d["k2u"], fwB, mode="main", probe_limit=int(probe_limit2),
                        probe_start=probe_start)
        outB = {**{kk: rM[kk] for kk in _K2U_FIELDS}, **_occ_projection_wide(d, rM, max_occs)}
        # residue; fake type-B slots must not take m_c capacity
        type_c = (rM["use_skew"] | rM["unresolved"]) & sb
        m_c = int(m_c) if m_c else max(64, m_b // 8)
        lanes_c, n_c = flagged_lanes(type_c, m_c)
        over_budget = over_budget | (n_c > m_c)
        # the records' unresolved lanes include failed extent checks on
        # rows < probe_limit2: the residue re-probes from row 0 then
        ps2 = (0 if "useqrec" in d["k2u"]["us"]
               else min(int(probe_limit2), int(d["k2u"]["meta"].probe_bound)))
        outC = get_ref_pos_padded(d, fwB[lanes_c], max_occs, probe_start=ps2)
        sc = torch.arange(m_c, device=dev) < torch.clamp(n_c, max=m_c)
        safe = torch.where(sc, lanes_c, m_b)  # fakes -> dummy row
        for kk in outB:
            ext = torch.cat([outB[kk], torch.zeros_like(outB[kk][:1])])
            ext[safe] = outC[kk]
            outB[kk] = ext[:m_b]
    if not merge:
        out = {
            "main": {**{kk: r[kk] for kk in _K2U_FIELDS}, **p},
            "overflow": overflow,
            "lanes": lanes_a,
            "slot_real": sa,
            "phase2": outA,
            "n_ovf": n_a,
            "lanes_b": lanes_b,
            "slot_real_b": sb,
            "phase2b": outB,
            "n_ovf_b": n_b,
            "over_budget": over_budget,
        }
        if n_c is not None:
            out["over_budget_c"] = n_c > m_c
        return out
    full = _merge_compact(p, [(outA, lanes_a, sa), (outB, lanes_b, sb)], max_occs)
    full["over_budget"] = over_budget
    return full


def residue_full_k2u(d: dict, fw: torch.Tensor, r: dict, rest: torch.Tensor,
                     n_c: torch.Tensor) -> dict:
    """``r``'s K2U fields with each real residue slot ``rest[i]`` (``i <
    min(n_c, len(rest))``) replaced by its full K2U: the plain residue K2U
    of ``_ragged_k2u``, and the CPU path and oracle of ``ops.residue_k2u``."""
    full = k2u_batch(d, fw[rest])
    M = fw.shape[0]
    m_c = rest.shape[0]
    safe = torch.where(torch.arange(m_c, device=fw.device) < n_c, rest, M)  # fakes -> dummy row
    out = {}
    for kk in _K2U_FIELDS:
        ext = torch.cat([r[kk], torch.zeros_like(r[kk][:1])])
        ext[safe] = full[kk]
        out[kk] = ext[:M]
    return out


def _ragged_k2u(d: dict, fw: torch.Tensor, real: torch.Tensor, m_c: int):
    """(the exact K2U fields of the phase-2 slots ``fw``, the residue's
    count) for the ragged phase 2; ``real`` flags the slots that hold a
    lane. On an SSHash the main probe runs again at full depth with the
    whole MPHF chain (``twophase._main_probe``: K3 where it fits), and only
    the real lanes it leaves (heavy buckets, a deferred winner that failed
    validation) take the full K2U, compacted into ``m_c`` slots: lanes past
    ``m_c`` stay unresolved, and the count says so. Where
    ``ops.residue_k2u.engages`` (a fast32 SSHash in K3's layout with a lean
    skew MPHF, on the card) that K2U is the kernel's, else the plain
    ``residue_full_k2u``. Other dictionaries take the full K2U of every
    slot (residue 0)."""
    from .twophase import _main_probe

    m_ = d["k2u"]["meta"]
    if m_.kind != "sshash":
        r = k2u_batch(d, fw)
        return {kk: r[kk] for kk in _K2U_FIELDS}, torch.zeros((), dtype=torch.int64,
                                                                 device=fw.device)
    r, _ = _main_probe(d, fw, int(m_.probe_bound), True, None)
    rest, n_c = flagged_lanes((r["use_skew"] | r["unresolved"]) & real, m_c)
    if residue_k2u.engages(d, fw.device):
        return residue_k2u.residue_k2u(d, fw, r, rest, n_c), n_c
    return residue_full_k2u(d, fw, r, rest, n_c), n_c


def get_ref_pos_compact(
    d: dict,
    fw: torch.Tensor,
    max_occs: int,
    budget_div: int = 4,
    merge: bool = True,
    probe_limit: int | None = None,
    m2: int | None = None,
    m2b: int | None = None,
    defer_valid: bool = False,
    mphf_level_limit: int | None = None,
    probe_limit2: int | None = None,
    m2c: int | None = None,
    occ_budget: int | None = None,
) -> dict:
    """Two-phase exact query with on-device compacted heavy phases.

    Main phase: the dictionary's shallow probe (``twophase._main_probe``:
    kernel K1 on a mono2 KCDict; on an SSHash ``sshash_k2u(mode="main")``
    at depth ``probe_limit``, run by K2 or K3 where one fits, with
    ``defer_valid`` and ``mphf_level_limit`` as that function takes them)
    and the projection of the (up to two) occurrence words it carries, or,
    on a layout whose probe carries none, of the first two through the
    offsets table (``twophase._project_offsets``).

    Lanes the main phase does not settle are compacted into ``M = m2``
    (default ``max(64, N // budget_div)``) slots and resolved by ``get_ref_pos_padded`` on
    ``fw[lanes]``, or, where ``ops.mono2_phase2.engages`` (a mono2-occ32
    KCDict on the card), by that kernel, which writes only the real slots. With
    ``m2b`` the heavy phase is type-split (see ``_compact_split``), and
    ``probe_limit2``/``m2c`` add its middle phase. Results equal
    ``get_ref_pos_padded``'s unless ``over_budget`` is set: some block got
    more lanes than its capacity, and the lanes past it were not resolved.

    Where ``ops.occ_csr.engages`` (an index whose padded phase 2 would be
    wider than ``occ_csr.COLUMNS``; never a mono2-occ32 KCDict), the unsplit
    ``merge=False`` phase 2 is ragged: the slots' exact K2U
    (``_ragged_k2u``: on an SSHash the main probe again at full depth, then
    the full K2U of at most ``m2c`` residue lanes, by default ``M // 4``),
    then ``occ_csr.occ_csr`` (the kernel on CUDA), which writes their
    occurrences to a flat block of ``occ_csr.budget`` entries (``occ_budget``,
    by default ``M * occ_csr.COLUMNS``); ``phase2`` then holds the slots'
    K2U fields and that CSR form (``occ_start``, ``occ_count``, ``total``,
    ``qid``, ``ref_id``, ``ref_pos``, ``orient``), the result also holds
    ``fw`` (for its checksum), ``over_budget_c`` tells a residue past
    ``m2c``, and ``over_budget`` also a total past the budget.

    ``merge=False`` returns the pieces (``main``, ``overflow``, ``lanes``,
    ``slot_real``, ``phase2``, ``n_ovf``, ``over_budget``; with ``m2b`` also
    ``lanes_b``, ``slot_real_b``, ``phase2b``, ``n_ovf_b``, and with
    ``probe_limit2`` ``over_budget_c``) without materializing merged
    [N, max_occs] tensors. In a marked pass (``trace.staged``) an unsplit
    result also holds ``side_probes``: the real phase-2 lanes whose key the
    main table did not hold, sent on to a mono or mono2 KCDict's side table
    (0 on other dictionaries), and ``residue``: the real residue lanes that
    a ragged phase 2's full K2U resolved (at most ``m2c``; 0 elsewhere)."""
    from .twophase import _main_probe, _project_main

    N = fw.shape[0]
    M = int(m2) if m2 else max(64, N // budget_div)
    m_ = d["k2u"]["meta"]
    trace.mark("main", fw)
    r, probe_start = _main_probe(d, fw, probe_limit, defer_valid, mphf_level_limit)
    p = _project_main(d, r, 2)
    overflow = p["overflow"] | r["unresolved"]
    trace.mark("phase2", fw)
    if m2b is not None:
        if probe_limit2 is not None and m_.kind != "sshash":
            raise ValueError("probe_limit2 is an SSHash-only middle phase")
        return _compact_split(d, fw, r, p, overflow, M, int(m2b), max_occs, merge,
                              probe_start=probe_start, probe_limit2=probe_limit2, m_c=m2c)
    lanes, n_ovf = flagged_lanes(overflow, M)
    over_budget = n_ovf > M
    slot_real = torch.arange(M, device=fw.device) < torch.clamp(n_ovf, max=M)
    # a marked pass counts the real lanes sent on to the side table and
    # the residue lanes that the full K2U resolved
    side = torch.zeros((), dtype=torch.int64, device=fw.device) if trace.staged() else None
    residue = None
    # these lanes include ones the main probe found (more occurrences than
    # it projects): the re-probe starts at row 0, not at probe_start
    budget = None if merge else occ_csr.budget(d, max_occs, M, occ_budget)
    over_c = None
    if budget is not None:
        m_c = int(m2c) if m2c else max(64, M // 4)
        r2, n_c = _ragged_k2u(d, fw[lanes], slot_real, m_c)
        out2 = {**r2, **occ_csr.occ_csr(d, r2, n_ovf, budget)}
        over_c = n_c > m_c
        over_budget = over_budget | over_c | (out2["total"] > budget)
        if side is not None:
            residue = torch.clamp(n_c, max=m_c)
    elif mono2_phase2.engages(d, fw.device):
        out2 = mono2_phase2.mono2_phase2(d, fw, lanes, n_ovf, max_occs, side_probes=side)
    else:
        out2 = get_ref_pos_padded(d, fw[lanes], max_occs)
        if side is not None and m_.kind == "kcdict" and "side" in d["k2u"]:
            side = (r["unresolved"][lanes] & slot_real).sum()
    if not merge:
        out = {
            "main": {**{kk: r[kk] for kk in _K2U_FIELDS}, **p},
            "overflow": overflow,
            "lanes": lanes,
            "slot_real": slot_real,
            "phase2": out2,
            "n_ovf": n_ovf,
            "over_budget": over_budget,
        }
        if side is not None:
            out.update(side_probes=side,
                       residue=torch.zeros_like(side) if residue is None else residue)
        if over_c is not None:
            out.update(over_budget_c=over_c, fw=fw)
        return out
    full = _merge_compact(p, [(out2, lanes, slot_real)], max_occs)
    full["over_budget"] = over_budget
    return full


def get_ref_pos_csr(d: dict, fw: torch.Tensor, budget: int) -> dict:
    """Exact query with the occurrences in CSR form: the K2U fields and
    ``occ_start``/``occ_count`` per query, and flat ``qid``, ``ref_id``,
    ``ref_pos``, ``orient`` and ``valid`` of length ``budget`` holding the
    occurrences of all queries in query order. ``total`` is the true count.
    Slots at or past it are invalid (``ref_id`` -1, ``ref_pos`` and
    ``orient`` 0); when it exceeds ``budget`` the occurrences past the
    budget are left out, and the caller runs again with a larger one."""
    r = k2u_batch(d, fw)
    out = occ_csr.occ_csr_plain(d, r, torch.tensor(fw.shape[0], device=fw.device), budget)
    return {**r, **out, "qid": out["qid"].to(torch.int64), "ref_id": out["ref_id"].to(torch.int64),
            "orient": out["orient"].to(torch.int32)}


def index_metadata(refs, decoys: int = 0, have_edge_vec: bool = False,
                   keep_duplicates: bool = False) -> dict:
    """Provenance record (the reference's IndexMetadata,
    ``src/index.rs:266-278``): SHA-256 and SHA-512 over the reference names
    (each followed by a zero byte) and over the 2-bit sequence words when
    the collection holds sequences; SHA-256 over the trailing ``decoys``
    references' names and their decoded sequence; the decoy count and
    first decoy index; the two build flags. The same bytes as
    ``mazu_tpu``'s, so the same hex strings."""

    def hash_names(names, algo):
        h = hashlib.new(algo)
        for name in names:
            h.update(name.encode())
            h.update(b"\0")
        return h.hexdigest()

    def hash_bytes(data, algo):
        return hashlib.new(algo, data).hexdigest()

    n_refs = len(refs.names)
    first_decoy = n_refs - int(decoys)
    seq_bytes = np.ascontiguousarray(refs.seq.words).tobytes() if refs.has_seq else None
    md = {
        "have_edge_vec": bool(have_edge_vec),
        "sha256_names": hash_names(refs.names, "sha256"),
        "sha256_seqs": hash_bytes(seq_bytes, "sha256") if seq_bytes else None,
        "name_hash_512": hash_names(refs.names, "sha512"),
        "seq_hash_512": hash_bytes(seq_bytes, "sha512") if seq_bytes else None,
        "decoy_name_hash": hash_names(refs.names[first_decoy:], "sha256") if decoys else "",
        "decoy_seq_hash": "",
        "num_decoys": int(decoys),
        "first_decoy_index": int(first_decoy),
        "keep_duplicates": bool(keep_duplicates),
    }
    if decoys and refs.has_seq:
        lo, hi = int(refs.prefix_sum[first_decoy]), int(refs.prefix_sum[n_refs])
        md["decoy_seq_hash"] = hash_bytes(refs.seq.to_str(lo, hi).encode(), "sha256")
    return md


class ModIndex:
    """Host-side index: K2U dictionary + U2Pos occurrence table + refs."""

    def __init__(self, k2u, u2pos, refs, index_type: str = "Custom", metadata: dict | None = None):
        from .. import __version__

        self.k2u = k2u
        self.u2pos = u2pos
        self.refs = refs
        self.index_type = index_type
        self.metadata = metadata or {}
        self.version = __version__

    @property
    def k(self) -> int:
        return self.k2u.k

    @property
    def n_kmers(self) -> int:
        return self.k2u.unitigs.n_kmers

    @property
    def n_unitigs(self) -> int:
        return self.k2u.unitigs.n_unitigs

    @property
    def n_refs(self) -> int:
        return self.refs.n_refs

    @property
    def ref_names(self) -> list:
        """The occurrence table's reference names, else the collection's."""
        return self.u2pos.ref_names or self.refs.names

    def max_occs(self) -> int:
        return self.u2pos.max_occs()

    def device_arrays(self, fused: bool = False, pos_kind: str | None = None,
                      prefix_kind: str | None = None, bucket_inline: bool = False,
                      uproj: bool = False, useqrec: bool = False,
                      mphf_rows: bool = False) -> dict:
        """NumPy arrays in the reference's layout. A KCDict takes no knobs
        (its rows already carry the fused occurrence words: ``fused=True``
        returns them unchanged). ``pos_kind``, ``prefix_kind`` and
        ``bucket_inline`` are SSHash layout knobs (an SSHash with none takes
        its engine's default: inline rows with flat32 bounds, or parity's
        packed positions with Elias-Fano bounds), as is ``mphf_rows`` (a
        BooPHF32 in its ``mrows`` layout); ``uproj`` adds the per-unitig
        projection records (``build_uproj``) and ``useqrec`` the window
        records (``build_useqrec``) to the SSHash unitig set.

        ``fused=True`` runs the fusion pass on an SSHash's row layout
        (inline, inline2, fixedcap or fixedcap2; others raise): each row
        gets its unitig's first occurrence word (two u32 columns), its
        occurrence count and its first occurrence index (``occ_start``), and
        an inline2 or fixedcap2 row also the second occurrence word (zero
        for a unitig with one), so a lane whose unitig has at most that many
        occurrences projects with no further read. The direct engine's skew
        rows get the first three the same way. The occurrence table must
        hold a ctable (not a ``WMUnitigTable``)."""
        with trace.span("index.device_arrays"):
            if pos_kind is not None or prefix_kind is not None or bucket_inline or mphf_rows:
                k2u = self.k2u.device_arrays(prefix_kind=prefix_kind, pos_kind=pos_kind,
                                             bucket_inline=bucket_inline, mphf_rows=mphf_rows)
            else:
                k2u = self.k2u.device_arrays()
            d = {
                "k2u": k2u,
                "u2pos": self.u2pos.device_arrays(),
                "refs": self.refs.device_arrays(),
                "meta": meta(k=self.k, index_type=self.index_type),
            }
            if (uproj or useqrec) and not hasattr(self.k2u, "pos"):
                raise ValueError("uproj and useqrec records need an SSHash K2U")
            if uproj:
                d["k2u"]["us"]["uproj"] = build_uproj(self.u2pos, self.k2u.unitigs)
            if useqrec:
                d["k2u"]["us"]["useqrec"] = build_useqrec(self.u2pos, self.k2u.unitigs)
            if fused and d["k2u"]["meta"].kind != "kcdict":
                self.fuse(d["k2u"])
            return d

    def fuse(self, k2u: dict) -> None:
        """The fusion pass over the rows and skew rows of an SSHash's arrays
        ``k2u`` (from ``device_arrays``), in place: see
        ``device_arrays(fused=True)``. A row's unitig is its own uid column,
        so direct-addressed fixedcap rows fuse as occurrence-ordered ones do."""
        pos_d = k2u.get("pos", {})
        if "inline" not in pos_d:
            raise ValueError("fused layout requires an inline row layout")
        needs_ctable(self.u2pos, "the fusion pass")
        ct = self.u2pos.ctable
        cwords = ct.to_array() if hasattr(ct, "to_array") else np.asarray(ct)
        off = np.asarray(self.u2pos.offsets, dtype=np.int64)
        hi = max(len(cwords) - 1, 0)
        us = self.k2u.unitigs

        def occ_cols(uid, second: bool) -> list:
            first = cwords[np.clip(off[uid], 0, hi)]
            cnt = (off[uid + 1] - off[uid]).astype(np.uint64)
            cols = [first & np.uint64(0xFFFFFFFF), first >> np.uint64(32), cnt, off[uid]]
            if second:
                w2 = cwords[np.clip(off[uid] + 1, 0, hi)] * (cnt >= 2)
                cols += [w2 & np.uint64(0xFFFFFFFF), w2 >> np.uint64(32)]
            return [c.astype(np.uint32)[:, None] for c in cols]

        def appended(rows: np.ndarray, uid: torch.Tensor, second: bool) -> np.ndarray:
            # the columns are a function of the unitig: made once a unitig,
            # gathered a row (in torch's threads: fixedcap tables hold 2^28
            # rows and more)
            tab = np.concatenate(occ_cols(every, second), axis=1)
            out = torch.cat([torch.from_numpy(rows.view(np.int32)),
                             torch.from_numpy(tab.view(np.int32))[uid]], dim=1)
            return out.numpy().view(np.uint32)

        every = np.arange(us.n_unitigs, dtype=np.int64)
        rows = pos_d["inline"]
        # a row's unitig is its own uid column (fixedcap rows: sentinel
        # rows clip to the last unitig, and fixedcap2's slot 0 carries the
        # bucket's count in uid bits 29-31)
        uid = torch.from_numpy(rows.view(np.int32)[:, 1]).to(torch.int64) & 0xFFFFFFFF
        if k2u["meta"].pos_kind == "fixedcap2":
            uid &= (1 << 29) - 1
        pos_d["inline"] = appended(rows, uid.clamp_(max=us.n_unitigs - 1), rows.shape[1] == 8)
        del uid
        if "skew_inline" in k2u:
            spos = self.k2u.skew_direct["pos"]
            suid = us.pos_to_id(np.where(spos >= 0, spos, 0))  # cuckoo empties: unitig 0
            k2u["skew_inline"] = appended(k2u["skew_inline"],
                                          torch.from_numpy(suid.astype(np.int64)), False)

    def _host_arrays(self) -> dict:
        from ..convert import arrays_from_numpy

        return arrays_from_numpy(self.device_arrays(), "cpu")

    def make_query_fn(self, max_occs: int | None = None, device=None):
        """(the ``QueryIndex`` of ``device_arrays()`` on ``device``, the card
        by default; a function of int64 k-mer word tensors on that device
        returning ``get_ref_pos_padded``'s dict)."""
        from ..convert import arrays_from_numpy, resolve_device

        mo = max(1, self.max_occs()) if max_occs is None else int(max_occs)
        qi = QueryIndex(arrays_from_numpy(self.device_arrays(), "cpu"))
        qi = qi.to(resolve_device(device))

        def query(kms: torch.Tensor) -> dict:
            return get_ref_pos_padded(qi.arrays(), kms, mo)

        return qi, query

    def color_classes(self, device=None):
        """The color classes (unitig -> its set of references) of this
        index's occurrence table (``index.colors``), built on ``device``
        where it gives one."""
        from .colors import ColorClasses

        return ColorClasses.from_u2pos(self.u2pos, device=device)

    def unitigs_on_ref(self, ref_id: int) -> dict:
        """Unitig tiling of reference ``ref_id`` from the occurrence table
        (every occurrence naming the reference, in position order): arrays
        unitig_id, unitig_len, pos and o (1 forward), entry for entry those
        of ``iter_unitigs_on_ref``, with no k-mer query."""
        from ..convert import arrays_from_numpy

        u2 = arrays_from_numpy(self.u2pos.device_arrays(), "cpu")
        idx = torch.arange(int(u2["meta"].n_occs), dtype=torch.int64)
        rid, pos, o = (t.numpy() for t in decode_occs(u2, idx))
        m = rid == ref_id
        uid = np.searchsorted(self.u2pos.offsets, idx.numpy()[m], side="right") - 1
        order = np.argsort(pos[m], kind="stable")
        uid = uid[order]
        return {
            "unitig_id": uid,
            "unitig_len": np.asarray(self.k2u.unitigs.unitig_len(uid)),
            "pos": pos[m][order],
            "o": o[m][order].astype(np.int64),
        }

    def iter_unitigs_on_ref(self, ref_id: int):
        """Walk reference ``ref_id``'s unitig tiling: query the k-mer at each
        tile start and jump ``unitig_len - k + 1`` (the reference's
        RefSeqContigIterator, ``src/index.rs:363-424``). Yields dicts with
        unitig_id, unitig_len, pos and o (1 forward). One query per tile: a
        host oracle for ``unitigs_on_ref``."""
        if not self.refs.has_seq:
            raise ValueError("the reference collection holds lengths only")
        arrays = self._host_arrays()
        k = self.k
        s, e = int(self.refs.prefix_sum[ref_id]), int(self.refs.prefix_sum[ref_id + 1])
        pos = 0
        while pos < (e - s) - k + 1:
            km = self.refs.seq.get_kmer_u64(np.array([s + pos]), k)
            r = k2u_batch(arrays, torch.from_numpy(km.view(np.int64)))
            mt = int(r["mt"][0])
            if mt == 0:
                raise RuntimeError(f"reference walk failed at position {pos}")
            ulen = int(r["unitig_len"][0])
            yield {"unitig_id": int(r["unitig_id"][0]), "unitig_len": ulen, "pos": pos,
                   "o": 1 if mt == MATCH_IDENTITY else 0}
            pos += ulen - k + 1

    def get_ref_pos_eager(self, kms) -> list:
        """Per-query lists of (ref_id, ref_pos, orient), None for a miss,
        from the exact padded query on the host (tests and debugging)."""
        kms = np.ascontiguousarray(np.asarray(kms, dtype=np.uint64))
        out = get_ref_pos_padded(self._host_arrays(), torch.from_numpy(kms.view(np.int64)),
                                 max(1, self.max_occs()))
        out = {kk: out[kk].numpy() for kk in ("mt", "n_occs", "ref_id", "ref_pos", "orient")}
        res = []
        for i in range(len(kms)):
            if out["mt"][i] == 0:
                res.append(None)
                continue
            res.append([(int(out["ref_id"][i, j]), int(out["ref_pos"][i, j]),
                         int(out["orient"][i, j])) for j in range(int(out["n_occs"][i]))])
        return res


class _Buf:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name


class QueryIndex(torch.nn.Module):
    """An index's query arrays (a dict of tensors, see
    ``convert.arrays_from_numpy``) held as buffers, so ``.to(device)``
    moves them all. ``arrays()`` returns the dict the query functions take.

    Off the host, the main table takes the layout its probe kernel reads
    (``ops.mono2_probe.card_table``), laid out before it moves, so the card
    holds that one table; on the host it keeps the reference's rows.

    ``graphs`` holds the CUDA graphs of passes over these buffers
    (``index.pipeline.replay``). A graph keeps the buffers' addresses, so
    any move of the buffers (``to``, ``cuda``, ``cpu``) drops them all.
    """

    def __init__(self, arrays: dict):
        super().__init__()
        self.graphs = {}
        self._tree = self._register(arrays, ())
        # a bare K2U (no occurrence table) has one "occurrence" a k-mer
        off = arrays["u2pos"]["offsets"] if "u2pos" in arrays else None
        self.max_occs = max(1, int((off[1:] - off[:-1]).max())) \
            if off is not None and off.numel() > 1 else 1

    def _register(self, node, path):
        if isinstance(node, dict):
            return {k: self._register(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, torch.Tensor):
            name = "__".join(path)
            self.register_buffer(name, node, persistent=False)
            return _Buf(name)
        return node

    def to(self, device) -> "QueryIndex":
        """Every buffer on ``device``; off the host, the main table in its
        kernel's layout (``card_table``)."""
        with trace.span("index.to_device"):
            k2u = self._tree.get("k2u")
            if torch.device(device).type != "cpu" and isinstance(k2u, dict) \
                    and isinstance(k2u.get("table"), _Buf):
                name = k2u["table"].name
                setattr(self, name, card_table(k2u["meta"], getattr(self, name)))
            return super().to(device)

    def _apply(self, *args, **kwargs):
        self.graphs.clear()
        return super()._apply(*args, **kwargs)

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
