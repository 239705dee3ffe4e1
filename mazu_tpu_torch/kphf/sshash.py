"""SSHash with the direct engine (counterpart of ``mazu_tpu.kphf.sshash``).

A minimizer-bucketed k-mer dictionary. Each k-mer's canonical minimizer
(mix32 ordering, ``kmer.canonical_minimizer_batch``) selects a bucket
``fold_hash32(mm) & (T-1)`` of a power-of-two table; the bucket lists the
useq positions of its minimizer occurrences, and a query verifies the
candidate k-mers at ``mm_pos - offset`` and ``mm_pos - (k - w - offset)``.
Buckets deeper than ``skew_param`` go to a skew table keyed by the
canonical k-mer itself (two-choice cuckoo rows, or bounded buckets).

The build is NumPy (byte-identical to the reference's) except the
minimizer scan, which runs ``canonical_minimizer_batch`` on the given
device in chunks. The ported device layout is the capacity tier's:
packed positions (IntVector), grouped16 bucket bounds, the ``bpos``
bucket-inline rows and the unitig set's paired arrays, with the
``useqrec`` window records that ``index.modindex.build_useqrec`` adds.
``sshash_k2u`` is the plain torch query; on the main path
``ops.bpos_probe.bpos_usrec_k2u`` runs its bpos main probe as a kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from .._words import from_numpy, mask32, srl, srl_var
from ..bits.intvector import IntVector, iv_get
from ..bits.seqvector import sv_get_kmer
from ..containers.unitig_set import us_extent, us_is_valid_pos, us_rank
from ..kmer import canonical_minimizer_batch, mask2k, revcomp, revcomp_np, word_equivalency
from ..pytree import meta
from .boophf32 import fold_hash32, fold_hash32_np, fold_hash32b, fold_hash32b_np, mix32_np

U64 = np.uint64
U32 = np.uint32
# The probe loop evaluates a block of candidate rows for all lanes at
# once; a block holds up to ROW_BUDGET (lane, row) pairs. A small batch
# (the residue phase) runs its whole static loop as one block.
ROW_BUDGET = 1 << 22


def expand_ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenation of [s, s+1, ..., s+c-1] for each (s, c)."""
    starts = np.asarray(starts, dtype=np.int64)
    counts = np.asarray(counts, dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    idx = np.repeat(np.arange(len(counts)), counts)
    return starts[idx] + (np.arange(offsets[-1]) - offsets[:-1][idx])


def _dedup_stream(mm: np.ndarray, pos: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Indices of the elements selected by ``mask`` that differ in (mm, pos)
    from the previous selected element (consecutive dedup)."""
    idx = np.flatnonzero(mask)
    if len(idx) == 0:
        return idx
    m, p = mm[idx], pos[idx]
    keep = np.ones(len(idx), dtype=bool)
    keep[1:] = (m[1:] != m[:-1]) | (p[1:] != p[:-1])
    return idx[keep]


class SSHash:
    """Host-side direct-engine SSHash (``SSHash.from_unitig_set`` with
    ``engine="direct"`` in the reference)."""

    def __init__(self, unitigs, w, pos, skew_param, seed, direct_T, skew_direct,
                 sparse_prefix, max_bucket):
        self.unitigs = unitigs
        self.w = int(w)
        self.pos = pos  # IntVector of minimizer positions, grouped by bucket
        self.skew_param = int(skew_param)
        self.seed = int(seed)
        self.direct_T = int(direct_T)
        self.skew_direct = skew_direct
        self._sparse_prefix = sparse_prefix  # (occupied bucket ids, inclusive totals)
        self._max_bucket = int(max_bucket)
        self._prefix = None

    @property
    def k(self) -> int:
        return self.unitigs.k

    @staticmethod
    def _collect_minimizer_occs(unitigs, w: int, seed: int, chunk: int, device):
        """Canonical minimizer occurrence of every k-mer (scanned on
        ``device`` in chunks), per-strand consecutive dedup, then a stable
        sort by minimizer value. Returns (mm_set, mm_occs, ranges_start,
        positions)."""
        k = unitigs.k
        kpos = unitigs.kmer_start_positions()
        n = len(kpos)
        mm_all = np.empty(n, dtype=np.uint64)
        occ_pos = np.empty(n, dtype=np.int64)
        isfw = np.empty(n, dtype=bool)
        words = from_numpy(unitigs.useq.words, device)
        for s in range(0, n, chunk):
            kp = kpos[s : s + chunk]
            fw = sv_get_kmer(words, torch.from_numpy(kp).to(device), k)
            mm, off, is_fw, _ = canonical_minimizer_batch(fw, k, w, seed)
            mm_all[s : s + chunk] = mm.cpu().numpy().view(np.uint64)
            occ_pos[s : s + chunk] = kp + off.cpu().numpy().astype(np.int64)
            isfw[s : s + chunk] = is_fw.cpu().numpy()
        del kpos, words
        sel = np.concatenate([
            _dedup_stream(mm_all, occ_pos, isfw), _dedup_stream(mm_all, occ_pos, ~isfw)
        ])
        mms, mps = mm_all[sel], occ_pos[sel]
        del mm_all, occ_pos, isfw, sel
        order = np.argsort(mms, kind="stable")
        mms, mps = mms[order], mps[order]
        if len(mms):
            first = np.empty(len(mms), dtype=bool)
            first[0] = True
            np.not_equal(mms[1:], mms[:-1], out=first[1:])
            ranges_start = np.flatnonzero(first)
            mm_set = mms[ranges_start]
            mm_occs = np.diff(np.concatenate([ranges_start, [len(mms)]]))
        else:
            mm_set, ranges_start, mm_occs = mms, np.zeros(0, np.int64), np.zeros(0, np.int64)
        return mm_set, mm_occs, ranges_start, mps

    @classmethod
    def from_unitig_set(cls, unitigs, w: int, skew_param: int | None = 64, seed: int = 0,
                        chunk: int = 1 << 20, engine: str = "direct",
                        bucket_load: float = 0.5, skew_bound_target: int = 4,
                        device="cpu") -> "SSHash":
        """Build with the direct engine: the minimizer -> bucket map is
        ``fold_hash32(mm) & (T-1)``, T the power of two near
        ``n_minimizers / bucket_load``; minimizers that collide share a
        bucket and verification rejects the foreign positions. The k-mers
        around the occurrences of buckets deeper than ``skew_param`` go to
        the skew table."""
        if engine != "direct":
            raise ValueError(f"the port has no {engine!r} SSHash engine yet")
        k = unitigs.k
        if w > k:
            raise ValueError(f"w={w} > k={k}")
        skew_param = 8 if skew_param is None else int(skew_param)
        mm_set, mm_occs, ranges_start, mps = cls._collect_minimizer_occs(
            unitigs, w, seed, chunk, device
        )
        n_min = len(mm_set)
        T = 1 << max(6, int(np.ceil(np.log2(max(n_min / bucket_load, 64)))))
        b = (fold_hash32_np(mm_set) & U32(T - 1)).astype(np.int64)

        # occurrences grouped by bucket, stable in minimizer-value order
        order2 = np.argsort(b, kind="stable")
        occ_counts = mm_occs[order2]
        pos_direct = mps[expand_ranges(ranges_start[order2], occ_counts)]
        b_sorted = b[order2]
        if len(b_sorted):
            bfirst = np.empty(len(b_sorted), dtype=bool)
            bfirst[0] = True
            np.not_equal(b_sorted[1:], b_sorted[:-1], out=bfirst[1:])
            run_start = np.flatnonzero(bfirst)
            occ_cum = np.concatenate([[0], np.cumsum(occ_counts)])
            run_end = np.concatenate([run_start[1:], [len(b_sorted)]])
            ub = b_sorted[run_start]
            seg = occ_cum[run_end] - occ_cum[run_start]
        else:
            ub = np.zeros(0, dtype=np.int64)
            seg = np.zeros(0, dtype=np.int64)
        cum = np.cumsum(seg)

        heavy_sel = seg > skew_param
        skew_direct = None
        if heavy_sel.any():
            mm_positions = pos_direct[expand_ranges((cum - seg)[heavy_sel], seg[heavy_sel])]
            span = k - w + 1
            starts = np.maximum(mm_positions - (k - w), 0)
            cand = np.unique((starts[:, None] + np.arange(span)[None, :]).reshape(-1))
            cand = cand[unitigs.is_valid_useq_pos(cand)]
            words = unitigs.get_kmer_u64(cand)
            cwords = np.minimum(words, revcomp_np(words, k))
            cw_sorted, first_idx = np.unique(cwords, return_index=True)
            kept_pos = cand[first_idx]
            skew_direct = cls._place_skew_cuckoo(cw_sorted, kept_pos)
            if skew_direct is None:  # bounded buckets
                n2 = len(cw_sorted)
                T2 = 1 << max(6, int(np.ceil(np.log2(max(n2 * 2, 64)))))
                for _ in range(8):
                    b2 = (fold_hash32_np(cw_sorted) & U32(T2 - 1)).astype(np.int64)
                    sizes = np.bincount(b2, minlength=T2)
                    if sizes.max() <= skew_bound_target or T2 >= (1 << 28):
                        break
                    T2 <<= 1
                order3 = np.argsort(b2, kind="stable")
                skew_direct = {
                    "kind": "bucket",
                    "T": T2,
                    "bound": int(sizes.max()),
                    "prefix": np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64),
                    "pos": kept_pos[order3].astype(np.int64),
                }
        return cls(
            unitigs, w, IntVector.from_array(pos_direct.astype(np.uint64)), skew_param, seed,
            T, skew_direct, (ub, cum), int(seg.max()) if len(seg) else 0,
        )

    @staticmethod
    def _place_skew_cuckoo(keys: np.ndarray, vals: np.ndarray, load: float = 0.4):
        """Two-choice placement of the skew k-mers, one key per slot, by
        round-randomized parallel walks. Returns the table dict, or None
        when placement fails (the caller then builds bounded buckets)."""
        n = len(keys)
        if n == 0 or n > (1 << 22):
            return None
        T2 = 1 << max(6, int(np.ceil(np.log2(max(n / load, 64)))))
        klo = (keys & U64(0xFFFFFFFF)).astype(U32)
        for salt in range(4):
            h1 = (fold_hash32_np(keys) & U32(T2 - 1)).astype(np.int64)
            h2 = (fold_hash32b_np(keys, salt) & U32(T2 - 1)).astype(np.int64)
            side = np.zeros(n, dtype=bool)
            for rnd in range(512):
                slot = np.where(side, h2, h1)
                prio = mix32_np(klo ^ U32((rnd * 2654435761) % (1 << 32)))
                order = np.argsort((slot.astype(U64) << U64(32)) | prio.astype(U64))
                ss = slot[order]
                first = np.ones(n, dtype=bool)
                first[1:] = ss[1:] != ss[:-1]
                winner = np.zeros(n, dtype=bool)
                winner[order] = first
                losers = ~winner
                if not losers.any():
                    slot_pos = np.full(T2, -1, dtype=np.int64)
                    slot_key = np.zeros(T2, dtype=np.uint64)
                    slot_pos[slot] = vals
                    slot_key[slot] = keys
                    return {"kind": "cuckoo", "T": T2, "salt": salt, "slot_pos": slot_pos,
                            "slot_key": slot_key, "pos": slot_pos}
                flip = losers & ((prio & U32(1)) == 1)
                side = side ^ (flip if flip.any() else losers)
            T2 <<= 1
        return None

    @property
    def occs_prefix_sum(self) -> np.ndarray:
        """int64[T+1]: occurrences in the buckets before each bucket."""
        if self._prefix is None:
            ub, cum = self._sparse_prefix
            dense = np.zeros(self.direct_T + 1, dtype=np.int64)
            dense[1:][ub] = np.diff(np.concatenate([[0], cum]))
            np.cumsum(dense, out=dense)
            self._prefix = dense
        return self._prefix

    def max_bucket(self) -> int:
        return self._max_bucket

    def probe_bound(self) -> int:
        """Static bound of the candidate probe loop."""
        return min(self.skew_param, self.max_bucket())

    @property
    def n_kmers_in_skew_index(self) -> int:
        return 0 if self.skew_direct is None else int((self.skew_direct["pos"] >= 0).sum())

    def device_arrays(self, prefix_kind: str | None = None, pos_kind: str | None = None,
                      bucket_inline: bool = False) -> dict:
        """The capacity-tier layout: ``pos_kind="packed"``,
        ``prefix_kind="grouped16"`` (an int64 base per 1024-bucket group and
        a u16 in-group delta per bucket), and with ``bucket_inline`` the
        ``bpos`` u32[T, 4] rows (first three positions of the bucket, then
        its count). Skew rows are u32[., 8]: pos, uid, start, end and the
        two useq words that hold the k-mer."""
        if pos_kind != "packed":
            raise ValueError(f"the port has no {pos_kind!r} SSHash position layout yet")
        if prefix_kind != "grouped16":
            raise ValueError(f"the port has no {prefix_kind!r} SSHash bucket bounds yet")
        us = self.unitigs
        d = {
            "us": us.device_arrays(paired=True),
            "meta": meta(
                kind="sshash", k=self.k, w=self.w, seed=self.seed, hash32=True,
                ordering="mix32", direct_t=self.direct_T, skew_param=self.skew_param,
                probe_bound=max(1, self.probe_bound()), prefix_kind=prefix_kind,
                pos_kind=pos_kind,
            ),
            "pos": self.pos.device_arrays(),
        }
        p = self.occs_prefix_sum
        base = np.ascontiguousarray(p[::1024]).astype(np.int64)
        delta = p - base[np.arange(len(p), dtype=np.int64) >> 10]
        if int(delta.max(initial=0)) >= (1 << 16):
            raise ValueError("grouped16 prefix overflow: a 1024-bucket group holds >= 2^16 "
                             "occurrences")
        d["prefix"] = {"gbase": base, "gdelta": delta.astype(np.uint16)}
        if bucket_inline:
            if us.total_len >= (1 << 31):
                raise ValueError("bucket_inline positions ride in u32: total_len must be < 2^31")
            posv = self.pos.to_array()
            cnt = p[1:] - p[:-1]
            hi = max(len(posv) - 1, 0)
            bp = np.zeros((len(cnt), 4), dtype=np.uint32)
            for j in range(3):
                bp[:, j] = posv[np.clip(p[:-1] + j, 0, hi)].astype(np.uint32) * (cnt > j)
            bp[:, 3] = np.minimum(cnt, 0xFFFFFFFF).astype(np.uint32)
            d["bpos"] = bp
        if self.skew_direct is not None:
            sd = self.skew_direct
            valid = sd["pos"] >= 0
            spos = np.where(valid, sd["pos"], 0).astype(np.int64)
            uid = us.pos_to_id(spos)
            uid_field = np.where(valid, uid, 0xFFFFFFFF).astype(np.uint64)
            wi = (spos * 2) >> 6
            wp = np.concatenate([us.useq.words, np.zeros(1, dtype=np.uint64)])
            srows = np.stack([
                spos.astype(U64) | (uid_field << U64(32)),
                us.accum[uid].astype(U64) | (us.accum[uid + 1].astype(U64) << U64(32)),
                np.where(valid, wp[wi], U64(0)),
                np.where(valid, wp[wi + 1], U64(0)),
            ], axis=1)
            d["skew_inline"] = np.ascontiguousarray(srows).view(np.uint32).reshape(len(srows), -1)
            if sd["kind"] == "cuckoo":
                d["meta"] = d["meta"].replace(skew_t=sd["T"], skew_bound=2, skew_kind="cuckoo",
                                              skew_salt=sd["salt"])
            else:
                p32 = sd["prefix"].astype(np.int32)
                d["skew_prefix2"] = np.stack([p32[:-1], p32[1:]], axis=1)
                d["meta"] = d["meta"].replace(skew_t=sd["T"], skew_bound=sd["bound"],
                                              skew_kind="bucket")
        return d


# ---------------------------------------------------------------------------
# Batched query (plain torch)
# ---------------------------------------------------------------------------


def _prefix_get(d: dict, i: torch.Tensor) -> torch.Tensor:
    """grouped16 bucket prefix p[i]."""
    pre = d["prefix"]
    return pre["gbase"][i >> 10] + (pre["gdelta"][i].to(torch.int64) & 0xFFFF)


def _prefix_pair(d: dict, i: torch.Tensor):
    """Both bounds (p[i], p[i+1]) of bucket(s) ``i``."""
    return _prefix_get(d, i), _prefix_get(d, i + 1)


def _pos_get(d: dict, i: torch.Tensor) -> torch.Tensor:
    return iv_get(d["pos"], i)


def _pos_window(d: dict, ps: torch.Tensor, n: int) -> list:
    """``[pos[ps + j] for j in range(n)]`` from one multi-word window read:
    the n entries are consecutive in the IntVector. Entries past the end
    are garbage, as with a clipped ``_pos_get``; callers mask with
    ``j < n_occs``."""
    iv = d["pos"]
    width = int(iv["meta"].width)
    words = iv["words"]
    last = words.shape[0] - 1
    bit0 = ps * width
    wi = bit0 >> 6
    woff = bit0 & 63
    nw = (63 + n * width - 1) // 64 + 1
    qs = [words[torch.clamp(wi + t, 0, last)] for t in range(nw)]
    out = []
    for j in range(n):
        dbit = woff + j * width
        sel = dbit >> 6
        r = dbit & 63
        lo, hi = qs[0], qs[1] if nw > 1 else qs[0]
        for t in range(1, nw):
            lo = torch.where(sel == t, qs[t], lo)
            hi = torch.where(sel == t, qs[min(t + 1, nw - 1)], hi)
        hi_bits = torch.where(r == 0, 0, hi << ((64 - r) & 63))
        out.append((srl_var(lo, r) | hi_bits) & ((1 << width) - 1))
    return out


def _map_hit(d: dict, km_pos: torch.Tensor):
    """useq position -> (unitig_id, unitig_len, upos, end_ok)."""
    us = d["us"]
    uid = us_rank(us, km_pos)
    start, end = us_extent(us, uid)
    return uid, end - start, km_pos - start, km_pos + d["meta"].k <= end


def _extract(q0, q1, q2, dbit, k: int) -> torch.Tensor:
    """The k-mer word at bit ``dbit`` (< 128) of the three words q0..q2."""
    s1 = dbit >= 64
    r = dbit & 63
    lo = torch.where(s1, q1, q0)
    hi = torch.where(s1, q2, q1)
    hi = torch.where(r == 0, 0, hi << ((64 - r) & 63))
    return (srl_var(lo, r) | hi) & mask2k(k)


def _first(flags: torch.Tensor):
    """Index of the first set flag along dim 1, and whether there is one."""
    n = flags.shape[1]
    idx = torch.arange(n, device=flags.device)
    first = torch.where(flags, idx, n).amin(dim=1)
    return torch.clamp(first, max=n - 1), first < n


def _take(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(v, 1, idx[:, None])[:, 0]


def sshash_k2u(d: dict, fw: torch.Tensor, mode: str = "full", probe_limit: int | None = None,
               probe_start: int = 0, defer_valid: bool = False) -> dict:
    """Batched SSHash K2U on the direct-engine capacity layout (plain torch;
    ``mazu_tpu.kphf.sshash.sshash_k2u``).

    ``fw``: int64 bit patterns of forward k-mer words. Returns int64
    unitig_id, unitig_len, pos and uint8 mt (0 miss, 1 identity, 2 twin).

    ``mode="full"`` is exact for every key: each bucket's rows up to the
    static ``probe_bound`` (lanes mask rows past their count, so no bound
    comes back to the host; rows go in blocks of up to ``ROW_BUDGET``
    lane-rows, and the first hit in row order wins), each candidate
    checked with ``us_is_valid_pos``, the winner mapped to its unitig by
    rank, and heavy buckets resolved through the skew table.
    ``probe_start`` skips rows [0, probe_start) for every lane (the caller
    guarantees they were probed and missed).

    ``mode="main"`` (needs the ``useqrec`` records) probes the first
    ``min(probe_bound, probe_limit)`` rows of each bucket; with ``bpos`` and
    ``probe_limit <= 3`` the bucket's count and positions come from one
    bpos row. Each probe reads one window record, which carries the
    candidate's words and its unitig's extent, id and first two occurrence
    words. Adds bool ``use_skew`` (a heavy bucket) and ``unresolved`` (rows
    past the probed depth, or a candidate that spelled the query but
    failed the record's extent check: the reference's mt == 3 sentinel),
    and occ_word, occ_word2 (int64 bit patterns) and occ_cnt.
    ``defer_valid`` is accepted there and changes nothing: the records
    check extents inside the probe."""
    m = d["meta"]
    us = d["us"]
    if not m.direct_t or m.pos_kind != "packed" or m.prefix_kind != "grouped16":
        raise ValueError("the port's SSHash query covers the direct engine with packed "
                         "positions and grouped16 bounds")
    usrec = mode == "main" and probe_start == 0 and "useqrec" in us
    if mode == "main" and not usrec:
        raise ValueError("the port's main-mode SSHash probe needs the useqrec records")
    if defer_valid and not usrec:
        raise ValueError("the port has no deferred validation yet")
    k, w = m.k, m.w
    rc = revcomp(fw, k)
    mm, offset, _is_fw, canon = canonical_minimizer_batch(fw, k, w, m.seed, ordering=m.ordering)
    offset = offset.to(torch.int64)
    rc_offset = (k - w) - offset
    use_bpos = (
        "bpos" in d and mode == "main" and probe_start == 0 and probe_limit is not None
        and 0 < probe_limit <= d["bpos"].shape[1] - 1
    )
    hc = fold_hash32(mm) & (m.direct_t - 1)
    if use_bpos:
        brow = mask32(d["bpos"][hc])
        n_occs = brow[:, 3]
        ps = torch.zeros_like(n_occs)
    else:
        ps, pe = _prefix_pair(d, hc)
        n_occs = pe - ps
    if m.skew_param >= 0:
        use_skew = n_occs > m.skew_param
    else:
        use_skew = torch.zeros_like(n_occs, dtype=torch.bool)
    last_km = us["meta"].total_len - k
    bound = m.probe_bound
    if mode == "main" and probe_limit is not None:
        bound = min(bound, int(probe_limit))
    pos_win = None
    if use_bpos:
        pos_win = brow[:, :bound]
    elif probe_start == 0 and 1 < bound <= 8:
        pos_win = torch.stack(_pos_window(d, ps, bound), dim=1)
    n_pos = d["pos"]["meta"].length

    z = torch.zeros_like(fw)
    found = torch.zeros_like(fw, dtype=torch.bool)
    sentinel = torch.zeros_like(found)
    out = {"unitig_id": z, "unitig_len": z, "pos": z, "occ_cnt": z, "occ_word": z,
           "occ_word2": z, "mt": torch.zeros_like(fw, dtype=torch.uint8)}
    block = max(1, min(bound - probe_start, ROW_BUDGET // max(fw.shape[0], 1)))
    for j0 in range(probe_start, bound, block):
        js = torch.arange(j0, min(j0 + block, bound), device=fw.device)
        if pos_win is not None:
            mm_pos = pos_win[:, j0 : j0 + len(js)]
        else:
            mm_pos = _pos_get(d, torch.clamp(ps[:, None] + js, 0, max(n_pos - 1, 0)))
        active = (js[None, :] < n_occs[:, None]) & ~use_skew[:, None]
        base = torch.clamp(mm_pos - (k - w), min=0)
        wi = (base * 2) >> 6
        woff = (base * 2) & 63
        if usrec:
            rec = us["useqrec"][torch.clamp(wi, 0, us["useqrec"].shape[0] - 1)]
            q0, q1, q2 = rec[..., 0], rec[..., 1], rec[..., 2]
            ustart = rec[..., 3] & ((1 << 40) - 1)
            ulen = srl(rec[..., 3], 40)
        else:
            w2 = us["useq"]["words2"]
            p0 = w2[torch.clamp(wi, 0, w2.shape[0] - 1)]
            p1 = w2[torch.clamp(wi + 1, 0, w2.shape[0] - 1)]
            q0, q1, q2 = p0[..., 0], p0[..., 1], p1[..., 1]
        cands = []
        for cand_off in (offset, rc_offset):
            c = cand_off[:, None]
            km_pos = mm_pos - c
            in_range = (mm_pos >= c) & (km_pos <= last_km)
            km_pos_c = torch.clamp(km_pos, 0, max(last_km, 0))
            dbit = woff + 2 * torch.clamp(km_pos_c - base, min=0)
            mt = word_equivalency(fw[:, None], rc[:, None], _extract(q0, q1, q2, dbit, k), k)
            match = active & in_range & (mt > 0)
            if usrec:
                ok = (km_pos_c >= ustart) & (km_pos_c + k <= ustart + ulen)
                cands.append((match & ok, match & ~ok, km_pos_c - ustart, mt))
            else:
                cands.append((match & us_is_valid_pos(us, km_pos_c), None, km_pos_c, mt))

        def flat(i):  # candidate order: row j, then its two offsets
            return torch.stack([cands[0][i], cands[1][i]], dim=2).flatten(1)

        first, any_hit = _first(flat(0))
        take = any_hit & ~found
        row = torch.div(first, 2, rounding_mode="floor")
        new = {"pos": _take(flat(2), first), "mt": _take(flat(3), first)}
        if usrec:
            sentinel = sentinel | flat(1).any(dim=1)
            new["unitig_id"] = _take(rec[..., 4] & 0xFFFFFFFF, row)
            new["unitig_len"] = _take(ulen, row)
            new["occ_cnt"] = _take(srl(rec[..., 4], 32), row)
            new["occ_word"] = _take(rec[..., 5], row)
            new["occ_word2"] = _take(rec[..., 6], row)
        for key, v in new.items():
            out[key] = torch.where(take, v, out[key])
        found = found | any_hit

    if usrec:
        # a candidate spelled the query but its record's extent check
        # failed, and no later candidate hit: phase 2 must re-probe it
        maybe = ~found & sentinel
        return {
            **{key: out[key] for key in ("unitig_id", "unitig_len", "pos", "mt")},
            "use_skew": use_skew,
            "unresolved": (~found & ~use_skew & (n_occs > bound)) | maybe,
            "occ_word": out["occ_word"],
            "occ_word2": out["occ_word2"],
            "occ_cnt": out["occ_cnt"],
        }
    uid, ulen, upos, _ = _map_hit(d, torch.where(found, out["pos"], 0))
    state = (torch.where(found, uid, z), torch.where(found, ulen, z),
             torch.where(found, upos, out["pos"]), out["mt"])
    uid, ulen, pos, mt = skew_resolve(d, fw, rc, canon, use_skew, state)
    return {"unitig_id": uid, "unitig_len": ulen, "pos": pos, "mt": mt}


def _skew_row(d, rows, fw, rc, k):
    """(uid, ulen, upos, mt) of u32 skew rows: the k-mer sits at the row's
    position, within its two words."""
    r32 = mask32(rows)
    kpos = r32[..., 0]
    w0 = r32[..., 4] | (r32[..., 5] << 32)
    w1 = r32[..., 6] | (r32[..., 7] << 32)
    kw = _extract(w0, w1, w1, (kpos * 2) & 63, k)
    start, end = r32[..., 2], r32[..., 3]
    return r32[..., 1], end - start, kpos - start, word_equivalency(fw, rc, kw, k)


def skew_resolve(d: dict, fw, rc, canon, use_skew, state):
    """Resolve heavy-bucket lanes through the skew table: two-choice rows
    (``skew_kind="cuckoo"``) or bounded buckets (``skew_prefix2``).
    ``state`` is (uid, ulen, pos, mt); lanes not in ``use_skew`` pass
    through."""
    m = d["meta"]
    k = m.k
    uid, ulen, pos, mt = state
    if "skew_inline" not in d:
        return state
    srows = d["skew_inline"]
    sfound = torch.zeros_like(use_skew)
    if m.skew_kind == "cuckoo":
        t2m = m.skew_t - 1
        slots = (fold_hash32(canon) & t2m, fold_hash32b(canon, m.skew_salt) & t2m)
        probes = [(srows[s], (srows[s][:, 1] != -1)) for s in slots]
    else:
        b2 = fold_hash32(canon) & (m.skew_t - 1)
        spair = d["skew_prefix2"][b2].to(torch.int64)
        s2, c2 = spair[:, 0], spair[:, 1] - spair[:, 0]
        last = max(srows.shape[0] - 1, 0)
        probes = [(srows[torch.clamp(s2 + j, 0, last)], j < c2) for j in range(m.skew_bound)]
    for rows, ok in probes:
        r_uid, r_ulen, r_pos, r_mt = _skew_row(d, rows, fw, rc, k)
        hit = use_skew & ~sfound & ok & (r_mt > 0)
        uid = torch.where(hit, r_uid, uid)
        ulen = torch.where(hit, r_ulen, ulen)
        pos = torch.where(hit, r_pos, pos)
        mt = torch.where(hit, r_mt, mt)
        sfound = sfound | hit
    return uid, ulen, pos, mt
