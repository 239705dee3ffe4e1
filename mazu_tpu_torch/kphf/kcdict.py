"""KCDict in its mono2-occ32 layout (counterpart of
``mazu_tpu.kphf.kcdict``).

A bucket table addressed by ONE hash of the canonical k-mer. Each bucket
row holds 2 slots of 7 u32 (56 bytes):

    klo, khi | canon_is_useq << 31, uid, upos24 | ulen_lo8 << 24,
    ulen_hi16 | cnt16 << 16, occ_word1, occ_word2

Keys displaced from a full bucket live in a small two-choice side table
with the same slot layout, probed only by the full (phase-2) query. The
"occ32" layout needs unitig lengths < 2^24 and occurrence words < 2^32.

The builder is NumPy and gives the reference builder's arrays byte for
byte. ``kcdict_k2u`` is the plain torch query; on the main path
``ops.mono2_probe.mono2_k2u`` runs its ``mode="main"`` form as a kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from .._words import M32, mask32, srl, umin
from ..kmer import revcomp, revcomp_np
from ..pytree import meta
from .boophf32 import fold_hash32, fold_hash32_np, fold_hash32b, fold_hash32b_np, mix32_np

U64 = np.uint64
U32 = np.uint32
SLOTS = 2  # slots per bucket
SW = 7  # u32 words per occ32 slot


class KCDict:
    def __init__(self, unitigs, table, T, side, side_T, side_salt):
        self.unitigs = unitigs
        self.table = table  # u32 [T, SLOTS * SW]
        self.T = int(T)
        self.side = side  # u32 [side_T, SLOTS * SW] or None
        self.side_T = int(side_T)
        self.side_salt = int(side_salt)

    @property
    def k(self) -> int:
        return self.unitigs.k

    @classmethod
    def from_unitig_set(cls, unitigs, occ_table, load: float = 0.25) -> "KCDict":
        """Host build of the mono2-occ32 dictionary: every canonical k-mer
        with its unitig mapping and the unitig's first two occurrence
        words, placed by one hash; overflow keys go to the side table."""
        k = unitigs.k
        if unitigs.total_len >= 1 << 31:
            raise ValueError("unitig set too long for u32 unitig positions")
        kpos = unitigs.kmer_start_positions()
        words = unitigs.get_kmer_u64(kpos)
        canon = np.minimum(words, revcomp_np(words, k))
        canon_is_useq = canon == words  # stored orientation: bit 31 of khi
        uid = unitigs.pos_to_id(kpos)
        start = unitigs.accum[uid]
        ulen = unitigs.accum[uid + 1] - start
        upos = kpos - start

        n = len(canon)
        n_buckets = 1 << max(6, int(np.ceil(np.log2(max(n / (SLOTS * load), 64)))))
        h1 = (fold_hash32_np(canon) & U32(n_buckets - 1)).astype(np.int64)
        order = np.argsort(h1, kind="stable")
        bs = h1[order]
        run_start = np.ones(n, dtype=bool)
        if n:
            run_start[1:] = bs[1:] != bs[:-1]
        run_id = np.cumsum(run_start) - 1
        within = np.arange(n) - np.flatnonzero(run_start)[run_id]
        win_sorted = within < SLOTS
        win = np.zeros(n, dtype=bool)
        win[order] = win_sorted
        slot = np.zeros(n, dtype=np.int64)
        slot[order] = np.where(win_sorted, within, 0)

        cwords = occ_table.ctable.to_array()
        off = occ_table.offsets
        hi = max(len(cwords) - 1, 0)
        first = cwords[np.clip(off[uid], 0, hi)]
        cnt = (off[uid + 1] - off[uid]).astype(np.uint64)
        second = cwords[np.clip(off[uid] + 1, 0, hi)]
        if not (ulen < (1 << 24)).all():
            raise ValueError("unitig longer than 2^24: not the occ32 layout")
        if not ((first < (1 << 32)).all() and (second < (1 << 32)).all()):
            raise ValueError("occurrence words >= 2^32: not the occ32 layout")
        khi = (canon >> U64(32)).astype(U32) | (canon_is_useq.astype(U32) << U32(31))
        cols = [
            (canon & U64(M32)).astype(U32),
            khi,
            uid.astype(U32),
            (upos.astype(U32) & U32(0xFFFFFF)) | ((ulen.astype(U32) & U32(0xFF)) << U32(24)),
            ((ulen.astype(U32) >> U32(8)) & U32(0xFFFF))
            | (np.minimum(cnt, 0xFFFF).astype(U32) << U32(16)),
            first.astype(U32),
            second.astype(U32),
        ]

        table = _empty_table(n_buckets)
        colw = (slot * SW)[win]
        bw = h1[win]
        for j, c in enumerate(cols):
            table[bw, colw + j] = c[win]

        side_idx = np.flatnonzero(~win)
        ns = len(side_idx)
        side, side_T, ssalt = None, 0, 0
        if ns:
            side_T = 1 << max(6, int(np.ceil(np.log2(max(ns / SLOTS / 0.3, 64)))))
            placed = _place_two_choice(canon[side_idx], side_T)
            while placed is None:
                side_T <<= 1
                placed = _place_two_choice(canon[side_idx], side_T)
            sbucket, sslot, ssalt = placed
            side = _empty_table(side_T)
            scol = sslot * SW
            for j, c in enumerate(cols):
                side[sbucket, scol + j] = c[side_idx]
        return cls(unitigs, table, n_buckets, side, side_T, ssalt)

    def device_arrays(self) -> dict:
        d = {
            "table": self.table,
            "us": self.unitigs.device_arrays(),
            "meta": meta(
                kind="kcdict",
                k=self.k,
                t=self.T,
                salt=0,
                fused=True,
                sw=SW,
                scheme="mono2",
                side_t=self.side_T,
                side_salt=self.side_salt,
                occ32=True,
                split=False,
            ),
        }
        if self.side is not None:
            d["side"] = self.side
        return d


def _empty_table(n_buckets: int) -> np.ndarray:
    # an empty slot (klo = 0xFFFFFFFF, khi & 0x7FFFFFFF = 0x7FFFFFFF) never
    # matches a canonical k-mer for k <= 31
    t = np.zeros((n_buckets, SLOTS * SW), dtype=np.uint32)
    t[:, 0::SW] = U32(M32)
    t[:, 1::SW] = U32(M32)
    return t


def _place_two_choice(keys: np.ndarray, n_buckets: int):
    """Round-randomized parallel two-choice placement with SLOTS slots per
    bucket. Returns (bucket i64[n], slot i64[n], salt) or None."""
    n = len(keys)
    klo = (keys & U64(M32)).astype(U32)
    for salt in range(4):
        h1 = (fold_hash32_np(keys) & U32(n_buckets - 1)).astype(np.int64)
        h2 = (fold_hash32b_np(keys, salt) & U32(n_buckets - 1)).astype(np.int64)
        side = np.zeros(n, dtype=bool)
        for rnd in range(512):
            b = np.where(side, h2, h1)
            prio = mix32_np(klo ^ U32((rnd * 2654435761) % (1 << 32)))
            order = np.argsort((b.astype(U64) << U64(32)) | prio.astype(U64))
            bs = b[order]
            # winners: the first SLOTS entries of each bucket run
            run_start = np.ones(n, dtype=bool)
            run_start[1:] = bs[1:] != bs[:-1]
            run_id = np.cumsum(run_start) - 1
            within = np.arange(n) - np.flatnonzero(run_start)[run_id]
            winner_sorted = within < SLOTS
            winner = np.zeros(n, dtype=bool)
            winner[order] = winner_sorted
            slot = np.zeros(n, dtype=np.int64)
            slot[order] = np.where(winner_sorted, within, 0)
            losers = ~winner
            if not losers.any():
                return np.where(side, h2, h1), slot, salt
            flip = losers & ((prio & U32(1)) == 1)
            if not flip.any():
                flip = losers
            side = side ^ flip
    return None


def kcdict_k2u(d: dict, fw: torch.Tensor, mode: str = "full") -> dict:
    """Batched K2U on a mono2-occ32 KCDict (plain torch).

    ``fw``: int64 bit patterns of forward k-mer words. Returns int64
    unitig_id, unitig_len, pos, occ_cnt; uint8 mt (0 miss, 1 identity,
    2 twin); occ_word, occ_word2 as int64. ``mode="main"`` probes the main
    table only and adds bool use_skew (always False) and unresolved (not
    found there: a side-table key or a true miss). ``mode="full"`` also
    probes the side table, so it is exact for every key."""
    m = d["meta"]
    if not (m.scheme == "mono2" and m.occ32):
        raise ValueError("the port's KCDict query covers the mono2-occ32 layout")
    canon = umin(fw, revcomp(fw, m.k))
    clo = canon & M32
    chi = srl(canon, 32)
    is_fw_canon = fw == canon
    z = torch.zeros_like(fw)
    st = {
        "found": torch.zeros_like(fw, dtype=torch.bool),
        "unitig_id": z, "unitig_len": z, "pos": z, "occ_cnt": z,
        "occ_word": z, "occ_word2": z,
        "mt": torch.zeros_like(fw, dtype=torch.uint8),
    }

    def probe(table, h):
        row = table[h]  # [N, 2 * SW] u32 bit patterns
        for c in (0, SW):
            khi = mask32(row[:, c + 1])
            hit = ~st["found"] & (mask32(row[:, c]) == clo) & ((khi & 0x7FFFFFFF) == chi)
            canon_is_useq = (khi >> 31) != 0
            mt = torch.where(is_fw_canon == canon_is_useq, 1, 2).to(torch.uint8)
            a = mask32(row[:, c + 3])
            b = mask32(row[:, c + 4])
            fields = {
                "unitig_id": mask32(row[:, c + 2]),
                "pos": a & 0xFFFFFF,
                "unitig_len": (a >> 24) | ((b & 0xFFFF) << 8),
                "occ_cnt": b >> 16,
                "occ_word": mask32(row[:, c + 5]),
                "occ_word2": mask32(row[:, c + 6]),
                "mt": mt,
            }
            for key, v in fields.items():
                st[key] = torch.where(hit, v, st[key])
            st["found"] = st["found"] | hit

    probe(d["table"], fold_hash32(canon) & (m.t - 1))
    if mode != "main" and "side" in d:
        sm = m.side_t - 1
        probe(d["side"], fold_hash32(canon) & sm)
        probe(d["side"], fold_hash32b(canon, m.side_salt) & sm)

    found = st.pop("found")
    if mode == "main":
        st["use_skew"] = torch.zeros_like(found)
        st["unresolved"] = ~found
    return st
