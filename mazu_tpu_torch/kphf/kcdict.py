"""KCDict: a bucket table of canonical k-mers, each slot carrying what
the query needs (counterpart of ``mazu_tpu.kphf.kcdict``).

Each bucket holds 2 slots. A slim slot (every unitig shorter than 2^24
bases) starts with five u32:

    klo, khi | canon_is_useq << 31, uid, upos24 | ulen_lo8 << 24,
    ulen_hi16 | cnt16 << 16

then the unitig's occurrence words. A wide slot (a unitig of 2^24 bases
or more) keeps upos and ulen in a u32 each:

    klo, khi | canon_is_useq << 31, uid, upos, ulen, occ_lo, occ_hi, cnt32

Three schemes place the keys:

- ``cuckoo`` (the reference's default): two-choice placement, every key
  in one of the buckets ``fold_hash32(canon)`` and ``fold_hash32b(canon,
  salt)``; the query reads both rows. The first occurrence word rides the
  slot (7 words slim, 8 wide).
- ``mono``: one hash; keys displaced from a full bucket live in a small
  two-choice side table with the same slot layout, probed only by the full
  (phase-2) query. Slots as cuckoo's.
- ``mono2``: as mono, with the unitig's first two occurrence words: one
  u32 each where every word fits ("occ32", 7 words, slim only), or two
  u32 each (9 words slim, 10 wide; such a dictionary ships slot rows, the
  second slot the adjacent row).

The builder is NumPy and gives the reference builder's arrays byte for
byte. ``kcdict_k2u`` is the plain torch query (and of one bucket shard of
a single-hash table, ``bucket_range``); on the main path
``ops.mono2_probe.mono2_k2u`` runs a mono2-occ32 dictionary's
``mode="main"`` form as a kernel, which reads the main table from 64-byte
rows on the card (two zero words after the 14).
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
SW = 7  # u32 words per slot: mono, and mono2 with u32 occurrence words (occ32)
SW2 = 9  # u32 words per mono2 slot with 64-bit occurrence words
SCHEMES = ("cuckoo", "mono", "mono2")
# (scheme, occ32) -> slot widths: slim, then wide
_SLOT_WORDS = {("cuckoo", False): (SW, SW + 1), ("mono", False): (SW, SW + 1),
               ("mono2", True): (SW,), ("mono2", False): (SW2, SW2 + 1)}


class KCDict:
    def __init__(self, unitigs, table, T, salt: int = 0):
        self.unitigs = unitigs
        self.table = table  # u32 [T, SLOTS * sw]
        self.T = int(T)
        self.salt = int(salt)  # cuckoo: the second hash's salt
        self.scheme = "cuckoo"  # "cuckoo" | "mono" | "mono2"
        self.side = None  # mono, mono2: u32 [side_T, SLOTS * sw] or None
        self.side_T = 0
        self.side_salt = 0
        self.occ32 = False  # mono2: occurrence words as one u32 each

    @property
    def k(self) -> int:
        return self.unitigs.k

    @property
    def n_kmers(self) -> int:
        return self.unitigs.n_kmers

    @property
    def slot_words(self) -> int:
        return self.table.shape[1] // SLOTS

    def num_bits(self) -> int:
        side = 0 if self.side is None else self.side.nbytes
        return 64 + self.unitigs.num_bits() + 8 * (self.table.nbytes + side)

    def print_stats(self, log=print):
        log(f"kmers: {self.n_kmers}")
        log(f"buckets: {self.T} x {SLOTS} slots")
        log(f"bits / kmer: {self.num_bits() / self.n_kmers:.3f}")

    @classmethod
    def from_unitig_set(cls, unitigs, load: float = 0.65, occ_table=None,
                        scheme: str = "cuckoo") -> "KCDict":
        """Host build: every canonical k-mer with its unitig mapping and,
        from ``occ_table`` (None: no occurrences), the unitig's first
        occurrence word (cuckoo, mono) or first two (mono2: u32 each where
        they fit, occ32, else 64-bit), placed by two-choice cuckoo
        (``cuckoo``) or by one hash with the overflow keys in a side table
        (``mono``, ``mono2``)."""
        if scheme not in SCHEMES:
            raise ValueError(f"no {scheme!r} KCDict scheme: one of {SCHEMES}")
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
        if scheme == "cuckoo":
            placed = _place_two_choice(canon, n_buckets)
            while placed is None:
                n_buckets <<= 1
                placed = _place_two_choice(canon, n_buckets)
            bucket, slot, salt = placed
            win = None
        else:
            bucket = (fold_hash32_np(canon) & U32(n_buckets - 1)).astype(np.int64)
            order = np.argsort(bucket, kind="stable")
            bs = bucket[order]
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
            salt = 0

        if occ_table is not None:
            from ..index.unitig_table import needs_ctable

            needs_ctable(occ_table, "a KCDict's inline occurrence words")
            ct = occ_table.ctable
            cwords = ct.to_array() if hasattr(ct, "to_array") else np.asarray(ct)
            off = occ_table.offsets
            hi = max(len(cwords) - 1, 0)
            first = cwords[np.clip(off[uid], 0, hi)]
            cnt = (off[uid + 1] - off[uid]).astype(np.uint64)
            second = cwords[np.clip(off[uid] + 1, 0, hi)]
        else:
            first = cnt = second = np.zeros(n, dtype=np.uint64)
        khi = (canon >> U64(32)).astype(U32) | (canon_is_useq.astype(U32) << U32(31))

        def split64(x):
            return [(x & U64(M32)).astype(U32), (x >> U64(32)).astype(U32)]

        cols = [(canon & U64(M32)).astype(U32), khi, uid.astype(U32)]
        slim = bool((ulen < (1 << 24)).all())
        if slim:
            cols += [
                (upos.astype(U32) & U32(0xFFFFFF)) | ((ulen.astype(U32) & U32(0xFF)) << U32(24)),
                ((ulen.astype(U32) >> U32(8)) & U32(0xFFFF))
                | (np.minimum(cnt, 0xFFFF).astype(U32) << U32(16)),
            ] + split64(first)
        else:
            cols += [upos.astype(U32), ulen.astype(U32)] + split64(first) + [
                np.minimum(cnt, M32).astype(U32)]
        occ32 = scheme == "mono2" and slim and occ_table is not None and bool(
            (first < (1 << 32)).all() and (second < (1 << 32)).all())
        if occ32:
            cols = cols[:5] + [first.astype(U32), second.astype(U32)]
        elif scheme == "mono2":
            cols += split64(second)
        sw = len(cols)

        table = _empty_table(n_buckets, sw)
        if win is None:
            col = slot * sw
            for j, c in enumerate(cols):
                table[bucket, col + j] = c
            return cls(unitigs, table, n_buckets, salt)

        colw = (slot * sw)[win]
        bw = bucket[win]
        for j, c in enumerate(cols):
            table[bw, colw + j] = c[win]
        self = cls(unitigs, table, n_buckets, salt)
        self.scheme = scheme
        self.occ32 = occ32
        side_idx = np.flatnonzero(~win)
        ns = len(side_idx)
        if ns:
            side_T = 1 << max(6, int(np.ceil(np.log2(max(ns / SLOTS / 0.3, 64)))))
            placed = _place_two_choice(canon[side_idx], side_T)
            while placed is None:
                side_T <<= 1
                placed = _place_two_choice(canon[side_idx], side_T)
            sbucket, sslot, ssalt = placed
            side = _empty_table(side_T, sw)
            scol = sslot * sw
            for j, c in enumerate(cols):
                side[sbucket, scol + j] = c[side_idx]
            self.side, self.side_T, self.side_salt = side, side_T, ssalt
        return self

    def device_arrays(self) -> dict:
        """A mono2 dictionary without occ32 ships slot rows ([2T, sw]: the
        second slot is the adjacent row), the others bucket rows."""
        sw = self.slot_words
        split = self.scheme == "mono2" and not self.occ32
        d = {
            "table": self.table.reshape(-1, sw) if split else self.table,
            "us": self.unitigs.device_arrays(),
            "meta": meta(
                kind="kcdict",
                k=self.k,
                t=self.T,
                salt=self.salt,
                fused=True,
                sw=sw,
                scheme=self.scheme,
                side_t=self.side_T,
                side_salt=self.side_salt,
                occ32=self.occ32,
                split=split,
            ),
        }
        if self.side is not None:
            d["side"] = self.side.reshape(-1, sw) if split else self.side
        return d


def _empty_table(n_buckets: int, sw: int = SW) -> np.ndarray:
    # an empty slot (klo = 0xFFFFFFFF, khi & 0x7FFFFFFF = 0x7FFFFFFF) never
    # matches a canonical k-mer for k <= 31
    t = np.zeros((n_buckets, SLOTS * sw), dtype=np.uint32)
    t[:, 0::sw] = U32(M32)
    t[:, 1::sw] = U32(M32)
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


def kcdict_k2u(d: dict, fw: torch.Tensor, mode: str = "full", bucket_range=None) -> dict:
    """Batched K2U on a KCDict (plain torch).

    ``fw``: int64 bit patterns of forward k-mer words. Returns int64
    unitig_id, unitig_len, pos, occ_cnt; uint8 mt (0 miss, 1 identity,
    2 twin); occ_word (and on mono2 occ_word2) as int64.

    cuckoo: two bucket reads; every key is in one of its two buckets.
    mono, mono2: one bucket read of the main table; ``mode="full"`` also
    probes the side table, so it is exact for every key. ``mode="main"``
    adds bool use_skew (always False) and unresolved (on mono and mono2:
    not found in the main table, a side-table key or a true miss; on
    cuckoo always False). A bucket is one row of both slots, or
    (``split``, mono2 without occ32) two adjacent slot rows. It reads the
    slots' columns only, so it takes the reference's [T, 14] rows and the
    card's 64-byte rows (``ops.mono2_probe.padded_table``) alike.

    ``bucket_range=(blo, bhi)`` (mono, mono2): ``d["table"]`` holds only
    buckets [blo, bhi), and only lanes whose main hash falls there are
    answered; every field is exact zero on the other lanes, so a one-hot
    sum over the shards gives the whole table's answer. The side table is
    whole on every shard, and only the main hash's owner reports its
    hits."""
    m = d["meta"]
    scheme = m.scheme
    mono = scheme in ("mono", "mono2")
    mono2 = scheme == "mono2"
    sw, split, occ32 = int(m.sw), bool(m.split), bool(m.occ32)
    slim = sw in (SW, SW2) and not occ32
    if sw not in _SLOT_WORDS.get((scheme, occ32), ()):
        raise ValueError(f"no {scheme!r} KCDict layout with {sw}-word slots (occ32={occ32})")
    canon = umin(fw, revcomp(fw, m.k))
    clo = canon & M32
    chi = srl(canon, 32)
    is_fw_canon = fw == canon
    z = torch.zeros_like(fw)
    st = {
        "found": torch.zeros_like(fw, dtype=torch.bool),
        "unitig_id": z, "unitig_len": z, "pos": z, "occ_cnt": z,
        "occ_word": z, "mt": torch.zeros_like(fw, dtype=torch.uint8),
    }
    if mono2:
        st["occ_word2"] = z

    def w64(row, c):
        return mask32(row[:, c]) | (row[:, c + 1].to(torch.int64) << 32)

    def probe(table, h):
        row = table[h]  # [N, width] u32 bit patterns: one bucket, or one slot when split
        for c in ((0,) if split else (0, sw)):
            khi = mask32(row[:, c + 1])
            hit = ~st["found"] & (mask32(row[:, c]) == clo) & ((khi & 0x7FFFFFFF) == chi)
            canon_is_useq = (khi >> 31) != 0
            mt = torch.where(is_fw_canon == canon_is_useq, 1, 2).to(torch.uint8)
            fields = {"unitig_id": mask32(row[:, c + 2]), "mt": mt}
            if slim or occ32:
                a = mask32(row[:, c + 3])
                b = mask32(row[:, c + 4])
                fields.update(pos=a & 0xFFFFFF, unitig_len=(a >> 24) | ((b & 0xFFFF) << 8),
                              occ_cnt=b >> 16)
            else:  # wide slots
                fields.update(pos=mask32(row[:, c + 3]), unitig_len=mask32(row[:, c + 4]),
                              occ_cnt=mask32(row[:, c + 7]))
            if occ32:
                fields.update(occ_word=mask32(row[:, c + 5]), occ_word2=mask32(row[:, c + 6]))
            else:
                fields["occ_word"] = w64(row, c + 5)
                if mono2:
                    fields["occ_word2"] = w64(row, c + (7 if slim else 8))
            for key, v in fields.items():
                st[key] = torch.where(hit, v, st[key])
            st["found"] = st["found"] | hit

    def probe_bucket(table, h):
        if split:
            probe(table, h * 2)
            probe(table, h * 2 + 1)
        else:
            probe(table, h)

    tm = m.t - 1
    h1 = fold_hash32(canon) & tm
    mine = None
    if bucket_range is not None:
        if not mono:
            raise ValueError("bucket_range shards the mono/mono2 single-hash table")
        blo, bhi = bucket_range
        mine = (h1 >= blo) & (h1 < bhi)
        n_local = d["table"].shape[0] // (2 if split else 1)
        h1 = torch.clamp(h1 - blo, 0, n_local - 1)
    probe_bucket(d["table"], h1)
    if not mono:
        probe_bucket(d["table"], fold_hash32b(canon, m.salt) & tm)
    elif mode != "main" and "side" in d:
        sm = m.side_t - 1
        probe_bucket(d["side"], fold_hash32(canon) & sm)
        probe_bucket(d["side"], fold_hash32b(canon, m.side_salt) & sm)

    found = st.pop("found")
    if mode == "main":
        st["use_skew"] = torch.zeros_like(found)
        st["unresolved"] = ~found if mono else torch.zeros_like(found)
    if mine is not None:
        st = {key: torch.where(mine, v, torch.zeros_like(v)) for key, v in st.items()}
    return st
