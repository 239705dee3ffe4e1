"""Sharded index queries over a (data, bucket) mesh (counterpart of
``mazu_tpu.parallel.sharding``).

Two ways to spread a query over several devices:

1. A replicated index with the batch split over ``data``
   (``make_data_parallel_query``): no collective on the query path.
2. An index split into ``bucket`` shards by contiguous ranges of its bucket
   (or minimizer-hash) space. Each shard holds its slice of the heavy
   arrays (bucket bounds, positions or rows, the occurrence table's pair
   rows); the unitig set, the MPHF and the skew structures are whole on
   every shard. Every shard sees the data row's whole batch, answers the
   lanes whose bucket it owns with exact zeros elsewhere, and one
   ``psum_bucket`` merges the one-hot answers; the all-to-all variant
   routes each query to its owner instead and routes the answers back.

The host partitioners (``shard_*``) lay out the reference's arrays byte for
byte, with the shard on the leading axis. Each builder writes its
per-shard function once, over one rank's local shard and a ``mesh.Rank``,
and a mesh runs it: ``DistMesh`` one rank a process over
``torch.distributed``, ``SerialMesh`` every rank in turn on one device.
Outputs are the reference's: the data shards' pieces concatenated, phase-2
lane indices local to each data shard.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import MATCH_IDENTITY
from .._words import mask32
from ..convert import arrays_from_numpy
from ..pytree import meta
SENTINEL = -1  # the u64 all-ones word as an int64 bit pattern

_K2U_SHARD_FIELDS = (
    "unitig_id", "unitig_len", "pos", "mt", "occ_word", "occ_cnt", "occ_start", "occ_word2",
    "use_skew", "unresolved",
)
_K2U_FIELDS = ("unitig_id", "unitig_len", "pos", "mt")
BOUND_KEYS = ("lo", "hi", "blo", "bhi", "clo", "chi")  # a shard's ranges, kept as ints


def _local_shard(stacked: dict, s: int, device) -> dict:
    """Shard ``s`` of a host partition (leading axis the shard) on
    ``device``; its range bounds as Python ints."""
    out = {}
    for key, v in stacked.items():
        v = np.asarray(v)[s]
        out[key] = int(v.reshape(-1)[0]) if key in BOUND_KEYS else arrays_from_numpy(
            {"x": v}, device)["x"]
    return out


def place_sharded(shared: dict, stacked: dict, mesh):
    """(replicated arrays on the mesh's device, {bucket rank: local shard}
    for the shards this process holds). A ``pos_meta`` record stays on the
    host side."""
    shared_dev = arrays_from_numpy({k: v for k, v in shared.items() if k != "pos_meta"},
                                   mesh.device)
    return shared_dev, {b: _local_shard(stacked, b, mesh.device) for b in mesh.local_buckets()}


def _words(kms, device) -> torch.Tensor:
    if isinstance(kms, torch.Tensor):
        return kms.to(device)
    from ..convert import words_to

    return words_to(kms, device)


def _merge_k2u(rank, r: dict) -> dict:
    """One-hot sum over the bucket row of a shard's K2U fields (exactly
    one shard reports non-zero fields a lane)."""
    return {kk: rank.psum_bucket(r[kk]) for kk in _K2U_SHARD_FIELDS if kk in r}


def _proj_padded_sharded_occ(rank, ct_local, clo: int, chi: int, r: dict, u2meta: dict, k: int,
                             mo: int) -> dict:
    """The padded occurrence block of ``get_ref_pos_padded``, each shard
    decoding the pair rows [clo, chi) of the occurrence table it holds; a
    one-hot sum reassembles the block."""
    from ..index.unitig_table import decode_words

    hit = r["mt"] > 0
    start = r["occ_start"]
    cnt = torch.where(hit, r["occ_cnt"], 0)
    n_pairs = (mo + 1) // 2
    jj = torch.arange(n_pairs, dtype=start.dtype, device=start.device) * 2
    g = start[:, None] + jj[None, :]
    own = (g >= clo) & (g < chi) & hit[:, None]
    li = torch.clamp(g - clo, 0, ct_local.shape[0] - 1)
    r32 = ct_local[li]  # [M, n_pairs, 4] u32 bit patterns
    words = (mask32(r32[..., 0::2]) | (mask32(r32[..., 1::2]) << 32)).reshape(
        r32.shape[0], 2 * n_pairs)[:, :mo]
    own_w = own.repeat_interleave(2, dim=1)[:, :mo]
    ref_id, occ_pos, occ_o = decode_words(u2meta, words)
    kpos = r["pos"][:, None]
    ulen = r["unitig_len"][:, None]
    fwd = occ_o == 1
    ref_pos = torch.where(fwd, kpos + occ_pos, occ_pos + (ulen - kpos) - k)
    o_match = (r["mt"] == MATCH_IDENTITY).to(torch.int32)[:, None]
    orient = torch.where(fwd, o_match, 1 - o_match)
    return {
        "ref_id": rank.psum_bucket(torch.where(own_w, ref_id, 0)),
        "ref_pos": rank.psum_bucket(torch.where(own_w, ref_pos, 0)),
        "orient": rank.psum_bucket(torch.where(own_w, orient, 0)),
        "valid": torch.arange(mo, dtype=cnt.dtype, device=cnt.device)[None, :] < cnt[:, None],
        "n_occs": cnt,
    }


def _compact_out(rm: dict, p: dict, overflow, lanes, n_ovf, M2: int, out2: dict) -> dict:
    slot_real = torch.arange(M2, device=lanes.device) < torch.clamp(n_ovf, max=M2)
    return {
        "main": {**{kk: rm[kk] for kk in _K2U_FIELDS}, **p},
        "overflow": overflow,
        "lanes": lanes,
        "slot_real": slot_real,
        "phase2": out2,
        "n_ovf": n_ovf[None],
        "over_budget": (n_ovf > M2)[None],
    }


# ------------------------------------------------------------ data parallel
def make_data_parallel_query(index_arrays, query_pipeline, mesh):
    """Replicated index, batch split over ``data``: (the index's arrays on
    the mesh's device, query). ``index_arrays`` is a ``QueryIndex`` or a
    NumPy ``device_arrays()`` dict; ``query_pipeline(arrays,
    kms)`` is any batched query (for example ``get_ref_pos_compact`` under
    ``functools.partial``). ``query(kms)`` returns its outputs, the data
    shards' concatenated."""
    from ..index.modindex import QueryIndex

    if isinstance(index_arrays, QueryIndex):
        on = next(index_arrays.buffers()).device
        # a move drops the index's CUDA graphs: only move one that is elsewhere
        qi = index_arrays if on == mesh.device else index_arrays.to(mesh.device)
    else:
        qi = QueryIndex(arrays_from_numpy(index_arrays, "cpu")).to(mesh.device)
    arrays = qi.arrays()

    def shard_fn(rank, shared, _local, kms):
        return query_pipeline(shared, kms)

    def query(kms):
        return mesh.query(shard_fn, arrays, {b: None for b in mesh.local_buckets()},
                          _words(kms, mesh.device))

    return arrays, query


# --------------------------------------------------- bucket-sharded SSHash
def shard_sshash_buckets(ss, n_shards: int):
    """Host partition of an SSHash into ``n_shards`` bucket shards:
    (shared, stacked), ``shared`` the replicated arrays (unitigs, MPHF,
    skew structures; ``flat`` bounds' layout), ``stacked`` each shard's
    rebased ``prefix`` slice and int64 ``pos`` slice (zero-padded) and its
    bucket range ``lo``/``hi``, the shard on the leading axis."""
    prefix = ss.occs_prefix_sum
    n_min = len(prefix) - 1
    bounds = np.linspace(0, n_min, n_shards + 1).astype(np.int64)
    pos_all = ss.pos.to_array()
    loc_prefix = [prefix[bounds[s]: bounds[s + 1] + 1] - prefix[bounds[s]]
                  for s in range(n_shards)]
    loc_pos = [pos_all[prefix[bounds[s]]: prefix[bounds[s + 1]]] for s in range(n_shards)]

    def pad(a, n):
        out = np.zeros(n, dtype=a.dtype)
        out[: len(a)] = a
        return out

    max_prefix = max(len(p) for p in loc_prefix)
    max_pos = max(len(p) for p in loc_pos)
    stacked = {
        "prefix": np.stack([pad(p, max_prefix) for p in loc_prefix]),
        "pos": np.stack([pad(p, max_pos) for p in loc_pos]).astype(np.int64),
        "lo": bounds[:-1][:, None],
        "hi": bounds[1:][:, None],
    }
    base = ss.device_arrays(prefix_kind="flat")
    shared = {k: v for k, v in base.items() if k not in ("prefix", "pos")}
    return shared, stacked


def _bucket_of(shared: dict, mm: torch.Tensor) -> torch.Tensor:
    from ..kphf.boophf32 import fold_hash32
    from ..kphf.sshash import mphf_lookup

    m = shared["meta"]
    if m.direct_t:
        return fold_hash32(mm) & (m.direct_t - 1)
    return mphf_lookup(shared["mphf"], mm).to(torch.int64)


def _resolve_local(shared: dict, stk: dict, fw: torch.Tensor, owned=None) -> dict:
    """The K2U fields of the lanes whose bucket this shard owns (``owned``
    further limits them), exact zeros elsewhere: the probe over the
    shard's positions, then the skew lanes through the replicated skew
    structures."""
    from ..containers.unitig_set import us_get_kmer
    from ..kmer import canonical_minimizer_batch, revcomp, word_equivalency
    from ..kphf.sshash import _map_hit, skew_resolve

    m = shared["meta"]
    k, w = m.k, m.w
    prefix, posarr = stk["prefix"], stk["pos"]
    rc = revcomp(fw, k)
    mm, offset, _is_fw, canon = canonical_minimizer_batch(fw, k, w, m.seed, ordering=m.ordering)
    offset = offset.to(torch.int64)
    h = _bucket_of(shared, mm)
    mine = (h >= stk["lo"]) & (h < stk["hi"])
    if owned is not None:
        mine = mine & owned
    hl = torch.clamp(h - stk["lo"], 0, prefix.shape[0] - 2)
    ps = prefix[hl].to(torch.int64)
    n_occs = torch.where(mine, prefix[hl + 1].to(torch.int64) - ps, 0)
    use_skew = (n_occs > m.skew_param) if m.skew_param >= 0 else torch.zeros_like(mine)
    last = shared["us"]["meta"].total_len - k
    rc_offset = k - offset - w
    d_map = {"us": shared["us"], "meta": m}
    found = torch.zeros_like(mine)
    z = torch.zeros_like(ps)
    out = {"unitig_id": z, "unitig_len": z, "pos": z, "mt": torch.zeros_like(z, dtype=torch.uint8)}
    bound = min(int(torch.where(use_skew, 0, n_occs).max()) if n_occs.numel() else 0,
                int(m.probe_bound))
    for j in range(bound):
        active = ~found & (j < n_occs) & ~use_skew
        mm_pos = posarr[torch.clamp(ps + j, 0, posarr.shape[0] - 1)]
        for cand_off in (offset, rc_offset):
            km_pos = mm_pos - cand_off
            in_range = (mm_pos >= cand_off) & (km_pos <= last)
            km_pos_c = torch.clamp(km_pos, 0, max(last, 0))
            mt = word_equivalency(fw, rc, us_get_kmer(shared["us"], km_pos_c), k)
            uid, ulen, upos, end_ok = _map_hit(d_map, km_pos_c)
            hit = active & in_range & (mt > 0) & end_ok
            for key, v in (("unitig_id", uid), ("unitig_len", ulen), ("pos", upos), ("mt", mt)):
                out[key] = torch.where(hit, v, out[key])
            found = found | hit
            active = active & ~hit
    if any(kk in shared for kk in ("skew_inline", "skew_prefix2", "skew_mphf")):
        out = skew_resolve(shared, fw, rc, canon, mine & use_skew, out)
    return out


def make_bucket_sharded_query(ss, mesh):
    """Minimizer-bucket-sharded SSHash K2U: the batch split over ``data``
    and whole on every bucket shard; each shard probes its own bucket
    range and one ``psum_bucket`` merges the fields. ``query(kms)`` returns
    unitig_id, unitig_len, pos and mt."""
    return build_bucket_sharded_query(*place_sharded(*shard_sshash_buckets(ss, mesh.n_bucket),
                                                     mesh), mesh)


def build_bucket_sharded_query(shared_dev, stacked_dev, mesh):
    """The query of ``make_bucket_sharded_query`` over placed arrays
    (``place_sharded`` of ``shard_sshash_buckets``)."""

    def shard_fn(rank, sh, stk, kms):
        out = _resolve_local(sh, stk, kms)
        return {kk: rank.psum_bucket(v) for kk, v in out.items()}

    def query(kms):
        return mesh.query(shard_fn, shared_dev, stacked_dev, _words(kms, mesh.device))

    return query


def make_alltoall_sharded_query(ss, mesh, cap_factor: float = 2.0):
    """Minimizer-bucket-sharded SSHash K2U with all-to-all routing: each
    rank takes a 1/(``n_data`` x ``n_bucket``) slice of the batch, sends
    each query to the bucket shard that owns it (``cap = min(n, max(32,
    cap_factor * n / S))`` slots a destination, S the bucket shards, n the
    rank's queries), resolves what it receives and routes the answers
    back. ``routed_ok`` is False where a destination's slots ran out; those
    lanes answer zeros and are not queried again."""
    return build_alltoall_sharded_query(
        *place_sharded(*shard_sshash_buckets(ss, mesh.n_bucket), mesh), mesh,
        len(ss.occs_prefix_sum) - 1, cap_factor=cap_factor)


def build_alltoall_sharded_query(shared_dev, stacked_dev, mesh, n_buckets: int,
                                 cap_factor: float = 2.0):
    """The query of ``make_alltoall_sharded_query`` over placed arrays
    (``place_sharded`` of ``shard_sshash_buckets``) of an SSHash of
    ``n_buckets`` buckets, whose equal ranges route the queries."""
    from ..kmer import canonical_minimizer_batch

    S = mesh.n_bucket
    m = shared_dev["meta"]
    bounds = np.linspace(0, n_buckets, S + 1).astype(np.int64)
    inner = torch.from_numpy(bounds[1:-1].copy()).to(mesh.device)

    def shard_fn(rank, sh, stk, kms):
        n = kms.shape[0]
        cap = min(n, max(32, int(cap_factor * n / S)))
        mm, _off, _is_fw, _canon = canonical_minimizer_batch(kms, m.k, m.w, m.seed,
                                                             ordering=m.ordering)
        h = _bucket_of(sh, mm)
        dest = torch.clamp(torch.searchsorted(inner, h, right=True), 0, S - 1)
        onehot = (dest[:, None] == torch.arange(S, device=kms.device)[None, :]).to(torch.int64)
        slot = torch.gather(torch.cumsum(onehot, 0) - 1, 1, dest[:, None])[:, 0]
        ok = slot < cap
        send = torch.full((S, cap + 1), SENTINEL, dtype=torch.int64, device=kms.device)
        send[dest, torch.clamp(slot, max=cap)] = kms  # lanes past cap land in the dropped column
        recv = rank.all_to_all_bucket(send[:, :cap].contiguous())
        kms_in = recv.reshape(S * cap)
        real = kms_in != SENTINEL
        r = _resolve_local(sh, stk, torch.where(real, kms_in, 0), owned=real)
        packed = torch.stack([r["unitig_id"], r["unitig_len"], r["pos"],
                              r["mt"].to(torch.int64)], dim=-1).reshape(S, cap, 4)
        back = rank.all_to_all_bucket(packed)
        mine_back = back[dest, torch.clamp(slot, 0, cap - 1)]
        return {
            "unitig_id": torch.where(ok, mine_back[:, 0], 0),
            "unitig_len": torch.where(ok, mine_back[:, 1], 0),
            "pos": torch.where(ok, mine_back[:, 2], 0),
            "mt": torch.where(ok, mine_back[:, 3], 0).to(torch.uint8),
            "routed_ok": ok,
        }

    def query(kms):
        return mesh.query(shard_fn, shared_dev, stacked_dev, _words(kms, mesh.device),
                          split="rank")

    return query


# ------------------------------------------------ fused sharded full query
def _ctable_shards(ct2: np.ndarray, n_shards: int):
    """Contiguous pair-row ranges of the occurrence table: (rows [S, max,
    4] zero-padded, range starts, range ends)."""
    n_ct = ct2.shape[0]
    cb = np.linspace(0, n_ct, n_shards + 1).astype(np.int64)
    max_ct = max(1, int((cb[1:] - cb[:-1]).max()))
    ct = np.zeros((n_shards, max_ct, ct2.shape[1]), dtype=ct2.dtype)
    for s in range(n_shards):
        ct[s, : cb[s + 1] - cb[s]] = ct2[cb[s]: cb[s + 1]]
    return ct, cb[:-1][:, None], cb[1:][:, None]


def shard_fused_arrays(index, n_shards: int, pos_kind: str = "inline2"):
    """Host partition of the fused row layout (direct engine, ``flat2``
    bounds) into bucket shards: (shared, stacked). ``stacked`` holds each
    shard's rebased ``flat2`` pairs and rows (``kphf.sshash.shard_arrays``)
    and its pair rows of the occurrence table, with the bucket range
    ``blo``/``bhi`` and pair-row range ``clo``/``chi``; ``shared`` the rest
    of the K2U, the occurrence table's offsets and meta, and ``pos_meta``
    (the local row count)."""
    from ..kphf.sshash import shard_arrays

    base = index.device_arrays(fused=True, pos_kind=pos_kind)
    k2u = base["k2u"]
    if not (k2u["meta"].direct_t and "flat2" in k2u.get("prefix", {})):
        raise ValueError("fused sharding requires engine='direct' with flat2 prefix rows")
    shards = shard_arrays(k2u, index.k2u.occs_prefix_sum, n_shards)
    ct, clo, chi = _ctable_shards(base["u2pos"]["ctable2"], n_shards)
    stacked = {
        "flat2": np.stack([sd["prefix"]["flat2"] for sd, _, _ in shards]),
        "inline": np.stack([sd["pos"]["inline"] for sd, _, _ in shards]),
        "ctable2": ct,
        "blo": np.array([[lo] for _, lo, _ in shards], dtype=np.int64),
        "bhi": np.array([[hi] for _, _, hi in shards], dtype=np.int64),
        "clo": clo,
        "chi": chi,
    }
    shared = {
        "k2u": {k: v for k, v in k2u.items() if k not in ("prefix", "pos")},
        "u2pos": {k: v for k, v in base["u2pos"].items() if k not in ("ctable", "ctable2")},
        "meta": base["meta"],
        "pos_meta": meta(length=stacked["inline"].shape[1]),
    }
    return shared, stacked


def make_fused_sharded_query(index, mesh, m2: int, max_occs: int | None = None,
                             probe_limit: int | None = 2, pos_kind: str = "inline2"):
    """Bucket-sharded full ``get_ref_pos_compact(merge=False)`` over the
    fused rows: the main probe, its zero-gather projection, the compacted
    heavy phase and its padded projection, with the ownership masks and
    one-hot merges of the shards (``build_fused_sharded_query``)."""
    shared, stacked = shard_fused_arrays(index, mesh.n_bucket, pos_kind=pos_kind)
    mo = max(1, index.max_occs()) if max_occs is None else int(max_occs)
    shared_dev, stacked_dev = place_sharded(shared, stacked, mesh)
    return build_fused_sharded_query(shared, shared_dev, stacked_dev, mesh, m2=m2, max_occs=mo,
                                     probe_limit=probe_limit)


def build_fused_sharded_query(shared_host, shared_dev, stacked_dev, mesh, m2: int,
                              max_occs: int, probe_limit: int | None = 2):
    """The query of ``make_fused_sharded_query`` over placed arrays
    (``place_sharded``, or a sharded checkpoint's loader); ``shared_host``
    gives the local row count."""
    from ..index.twophase import _project_fused
    from ..kphf.sshash import sshash_k2u
    from ..ops.compact import flagged_lanes

    mo, plim, M2 = int(max_occs), probe_limit, int(m2)
    k = shared_host["meta"].k
    pos_meta = shared_host["pos_meta"]

    def shard_fn(rank, sh, stk, kms):
        d_local = dict(sh["k2u"])
        d_local["prefix"] = {"flat2": stk["flat2"]}
        d_local["pos"] = {"inline": stk["inline"], "meta": pos_meta}
        br = (stk["blo"], stk["bhi"])
        u2meta = {"meta": sh["u2pos"]["meta"]}
        r = sshash_k2u(d_local, kms, mode="main", probe_limit=plim, bucket_range=br)
        rm = _merge_k2u(rank, r)
        p = _project_fused({"u2pos": u2meta, "meta": sh["meta"]}, rm)
        overflow = p["overflow"] | rm["unresolved"]
        lanes, n_ovf = flagged_lanes(overflow, M2)
        r2m = _merge_k2u(rank, sshash_k2u(d_local, kms[lanes], mode="full", bucket_range=br))
        p2 = _proj_padded_sharded_occ(rank, stk["ctable2"], stk["clo"], stk["chi"], r2m, u2meta,
                                      k, mo)
        return _compact_out(rm, p, overflow, lanes, n_ovf, M2,
                            {**{kk: r2m[kk] for kk in _K2U_FIELDS}, **p2})

    def query(kms):
        return mesh.query(shard_fn, shared_dev, stacked_dev, _words(kms, mesh.device))

    return query


# ------------------------------------------------- mono sharded full query
def shard_mono_arrays(index, n_shards: int):
    """Host partition of a mono or mono2 KCDict index: the single-hash
    table split into ``n_shards`` equal bucket ranges (``table``, with
    ``blo``/``bhi``), the occurrence table's pair rows as in
    ``shard_fused_arrays``; the side table and the offsets whole in
    ``shared``."""
    base = index.device_arrays(fused=True)
    k2u = base["k2u"]
    m = k2u["meta"]
    if not (m.kind == "kcdict" and m.scheme in ("mono", "mono2")):
        raise ValueError("mono sharding requires a mono/mono2 KCDict k2u")
    T = m.t
    nrows = k2u["table"].shape[0]
    row_factor = nrows // T  # 2 for the split slot-row layout, else 1
    if T % n_shards:
        raise ValueError("bucket count must divide the shard count")
    bt = T // n_shards
    table = np.ascontiguousarray(np.asarray(k2u["table"]).reshape(
        n_shards, bt * row_factor, k2u["table"].shape[1]))
    bounds = (np.arange(n_shards + 1) * bt).astype(np.int64)
    ct, clo, chi = _ctable_shards(base["u2pos"]["ctable2"], n_shards)
    stacked = {"table": table, "ctable2": ct, "blo": bounds[:-1][:, None],
               "bhi": bounds[1:][:, None], "clo": clo, "chi": chi}
    shared = {
        "k2u": {kk: v for kk, v in k2u.items() if kk != "table"},
        "u2pos": {kk: v for kk, v in base["u2pos"].items() if kk not in ("ctable", "ctable2")},
        "meta": base["meta"],
    }
    return shared, stacked


def make_mono_sharded_query(index, mesh, m2: int, max_occs: int | None = None):
    """Bucket-sharded full ``get_ref_pos_compact(merge=False)`` over a mono
    or mono2 KCDict: ``kcdict_k2u(bucket_range=)`` on each shard's table,
    the fused projection, the compacted heavy phase (the side table
    answered by the main hash's owner) and its padded projection."""
    shared, stacked = shard_mono_arrays(index, mesh.n_bucket)
    mo = max(1, index.max_occs()) if max_occs is None else int(max_occs)
    shared_dev, stacked_dev = place_sharded(shared, stacked, mesh)
    return build_mono_sharded_query(shared, shared_dev, stacked_dev, mesh, m2=m2, max_occs=mo)


def build_mono_sharded_query(shared_host, shared_dev, stacked_dev, mesh, m2: int,
                             max_occs: int):
    """The query of ``make_mono_sharded_query`` over placed arrays."""
    from ..index.twophase import _project_fused
    from ..kphf.kcdict import kcdict_k2u
    from ..ops.compact import flagged_lanes

    mo, M2 = int(max_occs), int(m2)
    k = shared_host["meta"].k

    def shard_fn(rank, sh, stk, kms):
        d_local = {**sh["k2u"], "table": stk["table"]}
        br = (stk["blo"], stk["bhi"])
        u2meta = {"meta": sh["u2pos"]["meta"]}
        rm = _merge_k2u(rank, kcdict_k2u(d_local, kms, mode="main", bucket_range=br))
        p = _project_fused({"u2pos": u2meta, "meta": sh["meta"]}, rm)
        overflow = p["overflow"] | rm["unresolved"]
        lanes, n_ovf = flagged_lanes(overflow, M2)
        r2m = _merge_k2u(rank, kcdict_k2u(d_local, kms[lanes], mode="full", bucket_range=br))
        uid2 = torch.where(r2m["mt"] > 0, r2m["unitig_id"], 0)
        p2 = _proj_padded_sharded_occ(rank, stk["ctable2"], stk["clo"], stk["chi"],
                                      {**r2m, "occ_start": sh["u2pos"]["offsets"][uid2]},
                                      u2meta, k, mo)
        return _compact_out(rm, p, overflow, lanes, n_ovf, M2,
                            {**{kk: r2m[kk] for kk in _K2U_FIELDS}, **p2})

    def query(kms):
        return mesh.query(shard_fn, shared_dev, stacked_dev, _words(kms, mesh.device))

    return query


# ---------------------------------------------- compact sharded full query
def shard_compact_arrays(index, n_shards: int, bucket_inline: bool = False,
                         useqrec: bool = False):
    """Host partition of the capacity layout (direct engine, packed
    positions, ``flat2`` bounds) into bucket shards: each shard's rebased
    ``flat2`` pairs, its positions re-packed from bit 0 (``pos_words``),
    its occurrence pair rows and its ranges; with ``bucket_inline`` also
    its ``bpos`` rows. The unitig set (with the ``useqrec`` window records
    when asked), the skew structures and the offsets are whole in
    ``shared``, with ``pos_meta`` (width, local length)."""
    from ..bits.intvector import IntVector
    from ..index.modindex import build_useqrec

    ss = index.k2u
    k2u = ss.device_arrays(prefix_kind="flat32", pos_kind="packed", bucket_inline=bucket_inline)
    if not (k2u["meta"].direct_t and "flat2" in k2u.get("prefix", {})):
        raise ValueError("compact sharding requires engine='direct' (flat2 bucket bounds)")
    T = k2u["meta"].direct_t
    prefix = ss.occs_prefix_sum.astype(np.int64)
    bounds = np.linspace(0, T, n_shards + 1).astype(np.int64)
    flat2 = k2u["prefix"]["flat2"]
    row_lo, row_hi = prefix[bounds[:-1]], prefix[bounds[1:]]
    max_T = int((bounds[1:] - bounds[:-1]).max())
    max_rows = max(1, int((row_hi - row_lo).max()))
    f2 = np.zeros((n_shards, max_T, 2), dtype=flat2.dtype)
    pos_vals = ss.pos.to_array()
    width = ss.pos.width
    pw = np.zeros((n_shards, max(2, (max_rows * width + 63) // 64 + 1)), dtype=np.uint64)
    for s in range(n_shards):
        lo, hi = bounds[s], bounds[s + 1]
        f2[s, : hi - lo] = flat2[lo:hi] - flat2.dtype.type(row_lo[s])
        iv = IntVector.from_array(pos_vals[row_lo[s]: row_hi[s]], width=width)
        pw[s, : len(iv.words)] = iv.words
    u2 = index.u2pos.device_arrays()
    ct, clo, chi = _ctable_shards(u2["ctable2"], n_shards)
    stacked = {"flat2": f2, "pos_words": pw, "ctable2": ct, "blo": bounds[:-1][:, None],
               "bhi": bounds[1:][:, None], "clo": clo, "chi": chi}
    shared = {
        "k2u": {kk: v for kk, v in k2u.items() if kk not in ("prefix", "pos", "bpos")},
        "u2pos": {"offsets": u2["offsets"], "meta": u2["meta"]},
        "meta": meta(k=index.k, index_type=index.index_type),
        "pos_meta": meta(width=width, length=max_rows),
    }
    if bucket_inline:
        bp = np.zeros((n_shards, max_T, 4), dtype=np.uint32)
        for s in range(n_shards):
            lo, hi = bounds[s], bounds[s + 1]
            bp[s, : hi - lo] = k2u["bpos"][lo:hi]
        stacked["bpos"] = bp
    if useqrec:
        shared["k2u"]["us"] = dict(shared["k2u"]["us"])
        shared["k2u"]["us"]["useqrec"] = build_useqrec(index.u2pos, ss.unitigs)
    return shared, stacked


def make_compact_sharded_query(index, mesh, m2: int, probe_limit: int | None = 3,
                               defer_valid: bool = True, max_occs: int | None = None,
                               bucket_inline: bool = False, useqrec: bool = False):
    """Bucket-sharded capacity-tier full query (``get_ref_pos_compact``'s
    merge=False pieces): the shallow main probe (``defer_valid``; with
    ``bucket_inline`` one ``bpos`` row, with ``useqrec`` the window records
    that carry the projection), a width-2 sharded projection, the
    compacted full-depth phase 2 and its padded sharded projection."""
    shared, stacked = shard_compact_arrays(index, mesh.n_bucket, bucket_inline=bucket_inline,
                                           useqrec=useqrec)
    mo = max(1, index.max_occs()) if max_occs is None else int(max_occs)
    shared_dev, stacked_dev = place_sharded(shared, stacked, mesh)
    return build_compact_sharded_query(shared, shared_dev, stacked_dev, mesh, m2=m2,
                                       max_occs=mo, probe_limit=probe_limit,
                                       defer_valid=defer_valid)


def build_compact_sharded_query(shared_host, shared_dev, stacked_dev, mesh, m2: int,
                                max_occs: int, probe_limit: int | None = 3,
                                defer_valid: bool = True):
    """The query of ``make_compact_sharded_query`` over placed arrays (a
    ``bpos`` leaf in the shards turns the bucket-inline probe on)."""
    from ..index.twophase import _project_fused
    from ..kphf.sshash import sshash_k2u
    from ..ops.compact import flagged_lanes

    mo, plim, M2, dv = int(max_occs), probe_limit, int(m2), bool(defer_valid)
    k = shared_host["meta"].k
    pos_meta = shared_host["pos_meta"]

    def occ_fields(offsets, rm):
        uid = torch.where(rm["mt"] > 0, rm["unitig_id"], 0)
        start = offsets[uid]
        cnt = torch.where(rm["mt"] > 0, offsets[uid + 1] - start, 0)
        return {**rm, "occ_start": start, "occ_cnt": cnt}

    def shard_fn(rank, sh, stk, kms):
        d_local = dict(sh["k2u"])
        d_local["prefix"] = {"flat2": stk["flat2"]}
        d_local["pos"] = {"words": stk["pos_words"], "meta": pos_meta}
        if "bpos" in stk:
            d_local["bpos"] = stk["bpos"]
        br = (stk["blo"], stk["bhi"])
        u2meta = {"meta": sh["u2pos"]["meta"]}
        offsets = sh["u2pos"]["offsets"]
        rm = _merge_k2u(rank, sshash_k2u(d_local, kms, mode="main", probe_limit=plim,
                                         defer_valid=dv, bucket_range=br))
        if "occ_cnt" in rm:  # the window records carried the projection
            pf = _project_fused({"u2pos": u2meta, "meta": sh["meta"]}, rm)
            overflow = pf["overflow"] | rm["unresolved"]
            p = {kk: pf[kk] for kk in ("ref_id", "ref_pos", "orient", "valid", "n_occs")}
        else:
            rm = occ_fields(offsets, rm)
            overflow = rm["use_skew"] | rm["unresolved"] | (rm["occ_cnt"] > 2)
            p = _proj_padded_sharded_occ(rank, stk["ctable2"], stk["clo"], stk["chi"], rm,
                                         u2meta, k, 2)
        p["valid"] = p["valid"] & (~overflow)[:, None]
        p["overflow"] = overflow
        lanes, n_ovf = flagged_lanes(overflow, M2)
        r2m = occ_fields(offsets, _merge_k2u(rank, sshash_k2u(d_local, kms[lanes], mode="full",
                                                              bucket_range=br)))
        p2 = _proj_padded_sharded_occ(rank, stk["ctable2"], stk["clo"], stk["chi"], r2m, u2meta,
                                      k, mo)
        return _compact_out(rm, p, overflow, lanes, n_ovf, M2,
                            {**{kk: r2m[kk] for kk in _K2U_FIELDS}, **p2})

    def query(kms):
        return mesh.query(shard_fn, shared_dev, stacked_dev, _words(kms, mesh.device))

    return query


BUILDERS = {
    "make_data_parallel_query": make_data_parallel_query,
    "make_bucket_sharded_query": make_bucket_sharded_query,
    "make_alltoall_sharded_query": make_alltoall_sharded_query,
    "make_fused_sharded_query": make_fused_sharded_query,
    "make_mono_sharded_query": make_mono_sharded_query,
    "make_compact_sharded_query": make_compact_sharded_query,
}
