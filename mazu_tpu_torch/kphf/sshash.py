"""SSHash with its three engines (counterpart of ``mazu_tpu.kphf.sshash``).

A minimizer-bucketed k-mer dictionary. Each k-mer's canonical minimizer
(``kmer.canonical_minimizer_batch``) selects a bucket that lists the useq
positions of its minimizer occurrences, and a query verifies the candidate
k-mers at ``mm_pos - offset`` and ``mm_pos - (k - w - offset)``. Three
engines address the buckets:

- parity (the reference's default): one bucket per minimizer under the
  mix64 ordering (or wyhash), numbered by a 64-bit BooPHF over the
  minimizer set; minimizers with more than ``skew_param`` occurrences send
  their k-mers to a second BooPHF (``skew_mphf``) and its positions
  (``skew_pos``);
- fast32: the same under the mix32 ordering with BooPHF32 MPHFs;
- direct: mix32 ordering, ``fold_hash32(mm) & (T-1)`` into a power-of-two
  table, shared by colliding minimizers; buckets deeper than
  ``skew_param`` go to a skew table keyed by the canonical k-mer
  (two-choice cuckoo rows, or bounded buckets).

The build (byte-identical to the reference's) runs its heavy stages on
the given device: the minimizer occurrences of every engine (the scan in
chunks, the per-strand dedup, the sort and run bounds) and, for the MPHF
engines, BooPHF32's level loop, the MPHF lookup of every minimizer and the
position scatter and pack; the rest is NumPy. ``SSHash.device_arrays``
lays it out in every layout of the reference (all with the unitig set's
paired arrays): positions packed, flat32, as records, or as one row per
occurrence that holds the candidate window's words and its unitig's id
and extent (``inline``, ``inline2``, and the direct engine's
direct-addressed ``fixedcap`` and ``fixedcap2``); bucket bounds as
Elias-Fano, grouped16, grouped32, flat32 or flat; the capacity tier's
``bpos`` rows, ``useqrec`` window records and per-unitig ``uproj``
records (``index.modindex.build_uproj``). ``ModIndex.device_arrays(
fused=True)`` extends the row layouts with occurrence fields.
``sshash_k2u`` is the plain torch query of all of them (and of one bucket
shard, ``bucket_range``); on the capacity tier's main path
``ops.bpos_probe.bpos_usrec_k2u`` (direct, useqrec) and
``ops.capacity_probe.capacity_k2u`` (deferred validation, 32-bit engines,
grouped16) run its main probe as kernels. Every other probe is plain
torch, as the reference's are plain ``jnp``. ``TwoPhaseSSHash`` runs the
main probe and then the heavy-bucket lanes in full mode.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .._words import M32, from_numpy, mask32, srl, srl_var
from ..bits.elias_fano import EFVector, ef_get
from ..bits.intvector import IntVector, iv_get
from ..bits.seqvector import sv_get_kmer
from ..containers.unitig_set import (
    us_extent, us_get_kmer, us_is_valid_pos, us_rank, us_validate_rank,
)
from ..kmer import canonical_minimizer_batch, mask2k, revcomp, revcomp_np, word_equivalency
from ..pytree import meta
from .boophf import BooPHF, boophf_lookup
from .boophf32 import (
    LOOKUP_CHUNK, BooPHF32, boophf32_lookup, fold_hash32, fold_hash32_np, fold_hash32b,
    fold_hash32b_np, mix32_np,
)

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


class _Laps:
    """Seconds of a build by stage: ``lap(name)`` waits for the device and
    adds the time since the last lap to ``name``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds = {}
        self.t = time.perf_counter()

    def lap(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self.t
        self.t = now


class SSHash:
    """Host-side SSHash (``SSHash.from_unitig_set`` in the reference).
    ``direct_T`` is 0 for the MPHF engines (parity, fast32), whose buckets
    are numbered by ``mphf``."""

    def __init__(self, unitigs, w, pos, skew_param, seed, max_bucket, direct_T=0,
                 skew_direct=None, sparse_prefix=None, mphf=None, prefix=None,
                 skew_mphf=None, skew_pos=None, ordering: str = "mix32"):
        self.unitigs = unitigs
        self.w = int(w)
        self.pos = pos  # IntVector of minimizer positions, grouped by bucket
        self.skew_param = None if skew_param is None else int(skew_param)  # None: no skew index
        self.seed = int(seed)
        self.direct_T = int(direct_T)
        self.skew_direct = skew_direct
        self._sparse_prefix = sparse_prefix  # (occupied bucket ids, inclusive totals)
        self._max_bucket = int(max_bucket)
        self._prefix = prefix  # int64[T+1], built from _sparse_prefix when None
        self.mphf = mphf
        self.skew_mphf = skew_mphf
        self.skew_pos = skew_pos
        self.ordering = ordering  # minimizer ordering: mix32, or parity's mix64/wyhash
        self.build_seconds = {}  # seconds by stage of an MPHF engine's build

    @property
    def hash32(self) -> bool:
        """The 32-bit engines' arithmetic (direct, fast32): mix32 ordering."""
        return self.ordering == "mix32"

    @property
    def k(self) -> int:
        return self.unitigs.k

    @property
    def n_kmers(self) -> int:
        return self.unitigs.n_kmers

    @property
    def n_minimizers(self) -> int:
        """Buckets: the direct table's size, else the MPHF's key count."""
        return self.direct_T or len(self.occs_prefix_sum) - 1

    @property
    def n_minimizer_occs(self) -> int:
        return len(self.pos)

    def num_bits(self) -> int:
        """Size in bits, as the reference counts it: the direct table's flat
        int32 prefix, or the Elias-Fano bucket bounds and the MPHF; then the
        unitig set, the positions and the skew structures."""
        if self.direct_T:
            mm_bits = 32 * (self.direct_T + 1)
        else:
            mm_bits = self.ef_occs_prefix_sum().num_bits() + self.mphf.num_bits()
        nb = 64 + self.unitigs.num_bits() + self.pos.num_bits() + mm_bits
        if self.skew_mphf is not None:
            nb += self.skew_mphf.num_bits() + self.skew_pos.num_bits()
        if self.skew_direct is not None:
            sd = self.skew_direct
            nb += 128 * len(sd["pos"])
            if "prefix" in sd:
                nb += 32 * len(sd["prefix"])
        return nb

    def print_stats(self, log=print):
        nk = self.n_kmers
        log(f"kmers: {nk}")
        log(f"n minimizers: {self.n_minimizers}")
        log(f"n minimizer occs: {self.n_minimizer_occs}")
        log(f"positions encoded in {self.pos.width} bit words")
        log(f"unitigs: {self.unitigs.n_unitigs}")
        log(f"bits / kmer: {self.num_bits() / nk:.3f}")

    @staticmethod
    def _collect_minimizer_occs(unitigs, w: int, seed: int, chunk: int, device,
                                ordering: str = "mix32"):
        """``_minimizer_occs`` as NumPy arrays: (mm_set u64, mm_occs,
        ranges_start, positions), each int64 but the first."""
        mm_set, mm_occs, ranges_start, mps = SSHash._minimizer_occs(
            unitigs, w, seed, chunk, device, ordering)
        return (mm_set.cpu().numpy().view(np.uint64), mm_occs.cpu().numpy(),
                ranges_start.cpu().numpy(), mps.cpu().numpy())

    @staticmethod
    def _minimizer_occs(unitigs, w: int, seed: int, chunk: int, device, ordering: str = "mix32",
                        laps=None):
        """Canonical minimizer occurrence of every k-mer under ``ordering``,
        per-strand consecutive dedup, then a stable sort by minimizer value,
        all on ``device`` in chunks of ``chunk`` k-mers (the reference's
        ``_collect_minimizer_occs``). Returns int64 tensors on ``device``:
        (mm_set, mm_occs, ranges_start, positions).

        The dedup keeps a strand's selected element unless it equals the
        one selected before it on that strand, the first of a chunk compared
        with the last of the chunks before, so chunk bounds change nothing.
        The kept elements are all forward-strand selections, then all
        reverse-strand ones, as the reference concatenates them. Minimizers
        are w-mer words below 2^(2w) < 2^63, so the int64 sort is the u64
        order. ``laps`` (a ``_Laps``) gets the seconds of the scan, the
        dedup and the sort with the run bounds."""
        laps = laps or _Laps(device)
        if 2 * w >= 63:
            raise ValueError(f"w={w}: minimizer words must stay below 2^63")
        k = unitigs.k
        words = from_numpy(unitigs.useq.words, device)
        last = [None, None]  # per strand: (mm, pos) of its last selected element
        kept = ([], [])
        for kp in unitigs.kmer_position_chunks(chunk, device):
            mm, off, is_fw, _ = canonical_minimizer_batch(sv_get_kmer(words, kp, k), k, w, seed,
                                                          ordering)
            pos = kp + off
            del kp, off
            laps.lap("scan")
            for strand, sel in enumerate((is_fw, ~is_fw)):
                m, p = mm[sel], pos[sel]
                if m.shape[0] == 0:
                    continue
                prev_m = torch.cat([m[:1] if last[strand] is None else last[strand][0], m[:-1]])
                prev_p = torch.cat([p[:1] - 1 if last[strand] is None else last[strand][1],
                                    p[:-1]])
                keep = (m != prev_m) | (p != prev_p)
                last[strand] = (m[-1:], p[-1:])
                kept[strand].append((m[keep], p[keep]))
            del mm, pos, is_fw
            laps.lap("dedup")
        del words
        parts = kept[0] + kept[1]
        del kept
        empty = torch.zeros(0, dtype=torch.int64, device=device)
        mms = torch.cat([m for m, _ in parts]) if parts else empty
        pos_parts = [p for _, p in parts]
        del parts  # frees the key pieces
        mps = torch.cat(pos_parts) if pos_parts else empty
        del pos_parts
        mms, order = torch.sort(mms, stable=True)
        mps = mps[order]
        del order
        first = torch.ones(mms.shape[0], dtype=torch.bool, device=device)
        first[1:] = mms[1:] != mms[:-1]
        ranges_start = torch.nonzero(first).flatten()
        del first
        mm_set = mms[ranges_start]
        del mms
        mm_occs = torch.diff(ranges_start, append=ranges_start.new_tensor([mps.shape[0]]))
        laps.lap("sort and runs")
        return mm_set, mm_occs, ranges_start, mps

    @classmethod
    def from_unitig_set(cls, unitigs, w: int, skew_param: int | None = 64, seed: int = 0,
                        gamma: float = 1.7, chunk: int = 1 << 20, engine: str = "parity",
                        bucket_load: float = 0.5, skew_bound_target: int = 4,
                        minimizer_hash: str | None = None, device=None) -> "SSHash":
        """Build with one of three engines. ``parity`` (the reference's
        default) and ``fast32`` number the minimizers with an MPHF
        (``_from_unitig_set_mphf``): parity with the 64-bit ``BooPHF`` and
        the ``mix64`` ordering (``minimizer_hash="wyhash"`` orders by
        wyhash), fast32 with ``BooPHF32`` and ``mix32``. ``direct`` maps a
        minimizer to a bucket by ``fold_hash32(mm) & (T-1)``, T the power
        of two near ``n_minimizers / bucket_load``; minimizers that collide
        share a bucket and verification rejects the foreign positions; the
        k-mers around the occurrences of buckets deeper than ``skew_param``
        go to the skew table. The heavy stages run on ``device``, the card
        by default: ``_minimizer_occs`` for every engine, and those listed
        in ``_from_unitig_set_mphf`` for the MPHF engines."""
        from ..convert import resolve_device

        if w > unitigs.k:
            raise ValueError(f"w={w} > k={unitigs.k}")
        if engine not in ("parity", "fast32", "direct"):
            raise ValueError(f"the port has no {engine!r} SSHash engine")
        if minimizer_hash is not None and engine != "parity":
            raise ValueError("minimizer_hash is a parity-engine option (fast32/direct use "
                             "the 32-bit native ordering)")
        device = resolve_device(device)
        if engine != "direct":
            ordering = minimizer_hash or ("mix64" if engine == "parity" else "mix32")
            return cls._from_unitig_set_mphf(unitigs, w, skew_param, seed, gamma, chunk, device,
                                             ordering)
        k = unitigs.k
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
            int(seg.max()) if len(seg) else 0, direct_T=T, skew_direct=skew_direct,
            sparse_prefix=(ub, cum),
        )

    @classmethod
    def from_unitig_set_no_skew_index(cls, unitigs, w, seed=0, gamma=1.7, engine="parity",
                                      device=None) -> "SSHash":
        return cls.from_unitig_set(unitigs, w, skew_param=None, seed=seed, gamma=gamma,
                                   engine=engine, device=device)

    @classmethod
    def _from_unitig_set_mphf(cls, unitigs, w, skew_param, seed, gamma, chunk, device, ordering):
        """The MPHF engines: an MPHF (``BooPHF32`` under the mix32 ordering,
        fast32; else the 64-bit ``BooPHF``, parity) numbers the minimizers,
        bucket h holds the occurrences of the minimizer with value h, and
        buckets lie in that order. The k-mers around the occurrences of
        minimizers with more than ``skew_param`` of them go to a second MPHF
        of the same kind and its positions; with none, that MPHF holds the
        one key 0 (the reference builds it so).

        On ``device``: the minimizer occurrences, BooPHF32's level loop (the
        64-bit BooPHF builds on the host), the MPHF lookup of every
        minimizer, the bucket prefix, the position scatter and its pack.
        The skew part runs on the host over the heavy minimizers' k-mers."""
        from ..convert import arrays_from_numpy

        k = unitigs.k
        laps = _Laps(device)
        mm_set, mm_occs, ranges_start, mps = cls._minimizer_occs(unitigs, w, seed, chunk, device,
                                                                 ordering, laps)
        if ordering == "mix32":
            def build_mphf(keys):
                return BooPHF32.build(keys, gamma=gamma, device=device)
        else:
            def build_mphf(keys):
                keys = keys.cpu().numpy() if isinstance(keys, torch.Tensor) else keys
                return BooPHF.build(keys.view(np.uint64), gamma=gamma)
        mphf = build_mphf(mm_set)
        laps.lap("mphf build")
        d = arrays_from_numpy(mphf.device_arrays(), device)
        h = torch.empty_like(mm_set)
        for a in range(0, h.shape[0], LOOKUP_CHUNK):
            h[a : a + LOOKUP_CHUNK] = mphf_lookup(d, mm_set[a : a + LOOKUP_CHUNK])
        del d, mm_set
        if bool((h < 0).any()):
            raise RuntimeError("the minimizer MPHF misses one of its own keys")
        laps.lap("mphf lookup")
        prefix = torch.zeros(h.shape[0] + 1, dtype=torch.int64, device=device)
        prefix[1:][h] = mm_occs
        prefix.cumsum_(0)
        # each minimizer's run of the value-sorted stream lands at its bucket
        shift = prefix[h] - ranges_start
        del h
        posv = torch.empty_like(mps)
        for a in range(0, mps.shape[0], chunk):
            t = torch.arange(a, min(a + chunk, mps.shape[0]), dtype=torch.int64, device=device)
            run = torch.searchsorted(ranges_start, t, right=True) - 1
            posv[t + shift[run]] = mps[a : a + chunk]
        del shift
        prefix = prefix.cpu().numpy()
        laps.lap("scatter")
        pos_iv = IntVector.from_tensor(posv)
        del posv
        laps.lap("pack")

        skew_mphf = skew_pos = None
        if skew_param is not None:
            heavy = torch.nonzero(mm_occs > skew_param).flatten()
            if heavy.shape[0]:
                cnt = mm_occs[heavy]
                first = torch.cumsum(cnt, 0) - cnt
                occ = torch.repeat_interleave(ranges_start[heavy] - first, cnt)
                occ += torch.arange(occ.shape[0], dtype=torch.int64, device=device)
                mm_positions = mps[occ].cpu().numpy()
                span = k - w + 1
                starts = np.maximum(mm_positions - (k - w), 0)
                cand = (starts[:, None] + np.arange(span)[None, :]).reshape(-1)
                cand = cand[unitigs.is_valid_useq_pos(cand)]
                words = unitigs.get_kmer_u64(cand)
                cwords = np.minimum(words, revcomp_np(words, k))
                cw_sorted, first_idx = np.unique(cwords, return_index=True)
                skew_mphf = build_mphf(cw_sorted)
                sp = np.zeros(len(cw_sorted), dtype=np.uint64)
                sp[skew_mphf.lookup(cw_sorted, device=device)] = cand[first_idx].astype(np.uint64)
                skew_pos = IntVector.from_array(sp)
            else:
                skew_mphf = build_mphf(np.zeros(1, dtype=np.uint64))
                skew_pos = IntVector.from_array(np.zeros(1, dtype=np.uint64))
            laps.lap("skew")
        out = cls(
            unitigs, w, pos_iv, skew_param, seed,
            int(mm_occs.max()) if mm_occs.shape[0] else 0, mphf=mphf, prefix=prefix,
            skew_mphf=skew_mphf, skew_pos=skew_pos, ordering=ordering,
        )
        out.build_seconds.update(laps.seconds)
        return out

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

    def ef_occs_prefix_sum(self) -> EFVector:
        """``occs_prefix_sum`` as an Elias-Fano ``EFVector``."""
        return EFVector.from_array(self.occs_prefix_sum.astype(np.uint64))

    def max_bucket(self) -> int:
        return self._max_bucket

    def probe_bound(self) -> int:
        """Static bound of the candidate probe loop."""
        if self.skew_param is None:
            return self.max_bucket()
        return min(self.skew_param, self.max_bucket())

    @property
    def n_kmers_in_skew_index(self) -> int:
        if self.skew_direct is not None:
            return int((self.skew_direct["pos"] >= 0).sum())
        return 0 if self.skew_pos is None else len(self.skew_pos)

    def device_arrays(self, prefix_kind: str | None = None, pos_kind: str | None = None,
                      bucket_inline: bool = False, mphf_rows: bool = False) -> dict:
        """The reference's device layouts (``SSHash.device_arrays`` in
        ``mazu_tpu``; all with the unitig set's paired arrays). The default
        follows the engine: inline rows with flat32 bounds for the 32-bit
        engines (direct, fast32), packed positions with Elias-Fano bounds
        for parity.

        Positions (``pos_kind``):

        - ``"packed"``: an IntVector (parity's default), with
          ``bucket_inline`` the ``bpos`` u32[T, 4] rows (first three
          positions of the bucket, then its count);
        - ``"flat32"``: int32 positions;
        - ``"records"``: int32 [n, 4] records (mm_pos, uid, start, end) and
          ``useq_quad``, row i the useq words i..i+3 (three zero words pad
          the end), which hold both candidates of any record;
        - the speed tier's rows, one per minimizer occurrence: ``"inline"``
          u32[., 10] (mm_pos, uid, start, end, then the three useq words
          that hold both candidate k-mers) or ``"inline2"`` u32[., 8] (two
          words with the candidate window pre-aligned to bit 0);
        - ``"fixedcap"`` and ``"fixedcap2"`` (direct engine only): the same
          rows direct-addressed, bucket b's at [b B, (b + 1) B) with B =
          ``meta.cap`` = the probe bound; a uid field 0xFFFFFFFF marks an
          empty slot and 0xFFFFFFFE in slot 0 a heavy bucket (the skew
          table's), and fixedcap2's slot 0 carries the bucket's count
          (at most B <= 7) in uid bits 29-31.

        Every layout but ``packed`` needs ``total_len < 2^31``.

        Bucket bounds (``prefix_kind``): ``"ef"`` (an ``EFVector`` of the
        bucket prefix); ``"grouped16"`` (an int64 base per 1024-bucket group
        and a u16 in-group delta per bucket); ``"grouped32"`` (``gd2``, the
        u32 pair of the deltas of buckets i and i + 1, and ``gb2``, the
        [G, 2] pair of the bases of groups g and g + 1); ``"flat32"`` (a
        [T, 2] int32 ``flat2`` pair per bucket; the MPHF engines also keep
        the [T + 1] ``flat`` prefix, as the reference does without its
        native library); ``"flat"`` (the int64 prefix; ``"none"``, the
        fixedcap layouts' default, takes it too).

        The direct engine's skew rows are u32[., 8]: pos, uid, start, end and
        the two useq words that hold the k-mer; the MPHF engines add their
        ``mphf``, ``skew_mphf`` and ``skew_pos``, with ``mphf_rows`` a
        BooPHF32 ``mphf`` in its paired ``mrows`` layout (which the plain
        probe reads and K3 does not). ``ModIndex.device_arrays(fused=True)``
        appends each row's occurrence fields to the row layouts."""
        if pos_kind is None:
            pos_kind = "inline" if self.hash32 else "packed"
        if prefix_kind is None:
            if pos_kind in ("fixedcap", "fixedcap2"):
                prefix_kind = "none"
            else:
                prefix_kind = "flat32" if self.hash32 else "ef"
        if pos_kind not in POS_KINDS:
            raise ValueError(f"no {pos_kind!r} SSHash position layout: one of {POS_KINDS}")
        if prefix_kind not in PREFIX_KINDS:
            raise ValueError(f"no {prefix_kind!r} SSHash bucket bounds: one of {PREFIX_KINDS}")
        us = self.unitigs
        if pos_kind != "packed" and us.total_len >= (1 << 31):
            raise AssertionError(f"{pos_kind} rows carry u32 positions: total_len must be < 2^31")
        if bucket_inline and pos_kind != "packed":
            raise AssertionError(f"bucket_inline requires pos_kind='packed', got {pos_kind!r}")
        d = {
            "us": us.device_arrays(paired=True),
            "meta": meta(
                kind="sshash", k=self.k, w=self.w, seed=self.seed, hash32=self.hash32,
                ordering=self.ordering, direct_t=self.direct_T,
                skew_param=-1 if self.skew_param is None else self.skew_param,
                probe_bound=max(1, self.probe_bound()), prefix_kind=prefix_kind,
                pos_kind=pos_kind,
            ),
        }
        if self.mphf is not None:
            rows = mphf_rows and isinstance(self.mphf, BooPHF32)
            d["mphf"] = self.mphf.device_arrays(mrows=True) if rows else self.mphf.device_arrays()
        if self.skew_mphf is not None:
            d["skew_mphf"] = self.skew_mphf.device_arrays()
            d["skew_pos"] = self.skew_pos.device_arrays()
        n_pos = len(self.pos)
        if pos_kind in ("fixedcap", "fixedcap2"):
            rows, cap = self._fixedcap_rows(pos_kind == "fixedcap2")
            d["pos"] = {"inline": rows, "meta": meta(length=rows.shape[0])}
            d["meta"] = d["meta"].replace(cap=cap)
        elif pos_kind in ("inline", "inline2"):
            pos_arr = self.pos.to_array().astype(np.int64)
            d["pos"] = {"inline": _u32_rows(self._row_words(pos_arr, pos_kind == "inline2")),
                        "meta": meta(length=n_pos)}
        elif pos_kind == "records":
            pos_arr = self.pos.to_array().astype(np.int64)
            uid = us.pos_to_id(pos_arr)
            d["pos"] = {"records": np.stack([pos_arr, uid, us.accum[uid], us.accum[uid + 1]],
                                            axis=1).astype(np.int32),
                        "meta": meta(length=n_pos)}
            wp = np.concatenate([us.useq.words, np.zeros(3, dtype=U64)])
            d["useq_quad"] = np.stack([wp[:-3], wp[1:-2], wp[2:-1], wp[3:]], axis=1)
        elif pos_kind == "flat32":
            d["pos"] = {"flat": self.pos.to_array().astype(np.int32), "meta": meta(length=n_pos)}
        else:
            d["pos"] = self.pos.device_arrays()
        p = self.occs_prefix_sum
        if prefix_kind == "ef":
            d["prefix"] = EFVector.from_array(p.astype(np.uint64)).device_arrays()
        elif prefix_kind == "grouped16":
            base, delta = _group_deltas(p, "grouped16")
            d["prefix"] = {"gbase": base, "gdelta": delta}
        elif prefix_kind == "grouped32":
            base, delta = _group_deltas(p, "grouped32")
            d32 = delta.astype(U32)
            bp = np.concatenate([base, base[-1:]])
            d["prefix"] = {"gd2": d32[:-1] | (d32[1:] << U32(16)),
                           "gb2": np.stack([bp[:-1], bp[1:]], axis=1)}
        elif prefix_kind == "flat32":
            p32 = p.astype(np.int32)
            pairs = np.stack([p32[:-1], p32[1:]], axis=1)
            # the direct build keeps its bounds sparse, as the reference's
            # native pass reads them: flat2 alone; the MPHF engines keep both
            d["prefix"] = ({"flat2": pairs} if self._sparse_prefix is not None
                           else {"flat": p32, "flat2": pairs})
        else:
            d["prefix"] = {"flat": p}
        if bucket_inline:
            if us.total_len >= (1 << 31):
                raise AssertionError("bucket_inline positions ride in u32")
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
            d["skew_inline"] = _u32_rows(srows)
            if sd["kind"] == "cuckoo":
                d["meta"] = d["meta"].replace(skew_t=sd["T"], skew_bound=2, skew_kind="cuckoo",
                                              skew_salt=sd["salt"])
            else:
                p32 = sd["prefix"].astype(np.int32)
                d["skew_prefix2"] = np.stack([p32[:-1], p32[1:]], axis=1)
                d["meta"] = d["meta"].replace(skew_t=sd["T"], skew_bound=sd["bound"],
                                              skew_kind="bucket")
        return d

    def _row_words(self, pos_arr: np.ndarray, aligned: bool, uid_field=None) -> np.ndarray:
        """u64 occurrence rows of the positions ``pos_arr``: mm_pos | uid << 32
        (``uid_field`` in place of the uid where given), start | end << 32,
        then the useq words that hold the candidate window
        [mm_pos - (k - w), mm_pos + k): three words from the window's word
        (``inline``) or two words pre-aligned so the window starts at bit 0
        (``inline2``)."""
        us = self.unitigs
        uid = us.pos_to_id(pos_arr)
        if uid_field is None:
            uid_field = uid.astype(U64)
        base = np.maximum(pos_arr - (self.k - self.w), 0)
        wi = (base * 2) >> 6
        wp = np.concatenate([us.useq.words, np.zeros(2, dtype=U64)])
        cols = [pos_arr.astype(U64) | (uid_field << U64(32)),
                us.accum[uid].astype(U64) | (us.accum[uid + 1].astype(U64) << U64(32))]
        if aligned:
            r = ((base * 2) & 63).astype(U64)
            hs = (U64(64) - r) & U64(63)
            nz = r != 0
            q0, q1, q2 = wp[wi], wp[wi + 1], wp[wi + 2]
            cols += [(q0 >> r) | np.where(nz, q1 << hs, U64(0)),
                     (q1 >> r) | np.where(nz, q2 << hs, U64(0))]
        else:
            cols += [wp[wi], wp[wi + 1], wp[wi + 2]]
        return np.stack(cols, axis=1)

    def _fixedcap_rows(self, aligned: bool) -> tuple[np.ndarray, int]:
        """(u32 rows, B) of the direct-addressed layouts: bucket b's first B
        occurrences at rows [b B, (b + 1) B), B the probe bound, in
        ``inline`` rows (``fixedcap``) or ``inline2`` rows whose slot 0
        carries the bucket's count (at most B) in uid bits 29-31
        (``fixedcap2``); empty slots hold uid 0xFFFFFFFF and a heavy
        bucket's slot 0 uid 0xFFFFFFFE."""
        name = "fixedcap2" if aligned else "fixedcap"
        us = self.unitigs
        if not self.direct_T:
            raise AssertionError(f"{name} requires engine='direct'")
        if aligned and us.n_unitigs >= (1 << 29):
            raise AssertionError("uid field carries cnt bits")
        cap = max(1, self.probe_bound())
        if aligned and cap > 7:
            raise AssertionError("cnt rides in 3 uid bits")
        T = self.direct_T
        p = self.occs_prefix_sum
        cnt_b = p[1:] - p[:-1]
        heavy_b = cnt_b > (self.skew_param or cap)
        pos_arr = self.pos.to_array().astype(np.int64)
        occ_b = np.repeat(np.arange(T, dtype=np.int64), cnt_b)
        within = np.arange(len(pos_arr), dtype=np.int64) - p[:-1][occ_b]
        keep = (within < cap) & ~heavy_b[occ_b]
        uid_field = None
        if aligned:
            uid_field = us.pos_to_id(pos_arr[keep]).astype(U64)
            slot0 = within[keep] == 0
            cnt0 = np.minimum(cnt_b[occ_b[keep][slot0]], cap).astype(U64)
            uid_field[slot0] |= cnt0 << U64(29)
        rows = self._row_words(pos_arr[keep], aligned, uid_field)
        # the T B-row table in torch's threads (int64 bit patterns)
        table = torch.zeros((T * cap, rows.shape[1]), dtype=torch.int64)
        table[:, 0] = -(1 << 32)  # empty slots: uid 0xFFFFFFFF
        table[torch.from_numpy(occ_b[keep] * cap + within[keep])] = torch.from_numpy(
            rows.view(np.int64))
        del rows
        table[torch.from_numpy(np.flatnonzero(heavy_b) * cap), 0] = -(2 << 32)  # 0xFFFFFFFE
        return _u32_rows(table.numpy().view(U64)), cap


POS_KINDS = ("packed", "flat32", "records", "inline", "inline2", "fixedcap", "fixedcap2")
PREFIX_KINDS = ("ef", "grouped16", "grouped32", "flat32", "flat", "none")


def _u32_rows(rows: np.ndarray) -> np.ndarray:
    """u64 rows [n, c] as their u32 halves [n, 2c] (low half first)."""
    return np.ascontiguousarray(rows).view(U32).reshape(len(rows), -1)


def _group_deltas(p: np.ndarray, name: str):
    """(int64 base per 1024-bucket group, u16 delta of each prefix entry
    from its group's base) of a bucket prefix; a delta of 2^16 or more
    raises."""
    base = np.ascontiguousarray(p[::1024]).astype(np.int64)
    delta = np.empty(len(p), dtype=np.uint16)
    step = 1 << 24  # buckets a step, whole groups: no temporary of every bucket
    for a in range(0, len(p), step):
        seg = p[a : a + step] - np.repeat(base[a >> 10 : (a + step) >> 10], 1024)[
            : len(p[a : a + step])]
        if int(seg.max(initial=0)) >= (1 << 16):
            raise ValueError(f"{name} prefix overflow: a 1024-bucket group holds >= 2^16 "
                             "occurrences — use prefix_kind='ef' for this (pathologically "
                             "skewed) minimizer distribution")
        delta[a : a + len(seg)] = seg
    return base, delta


# ---------------------------------------------------------------------------
# Batched query (plain torch)
# ---------------------------------------------------------------------------


def _prefix_get(d: dict, i: torch.Tensor) -> torch.Tensor:
    """Bucket prefix p[i]: an Elias-Fano select, grouped16's base and
    delta, grouped32's (``i == T`` reads the high half of ``gd2[T - 1]``),
    or the ``flat`` prefix."""
    pre = d["prefix"]
    pk = d["meta"].prefix_kind
    if pk == "ef":
        return ef_get(pre, i)
    if pk == "grouped16":
        return pre["gbase"][i >> 10] + (pre["gdelta"][i].to(torch.int64) & 0xFFFF)
    if pk == "grouped32":
        gd2 = pre["gd2"]
        lo = torch.clamp(i, 0, gd2.shape[0] - 1)
        dpair = mask32(gd2[lo])
        return pre["gb2"][i >> 10, 0] + torch.where(i == lo, dpair & 0xFFFF, dpair >> 16)
    return pre["flat"][i].to(torch.int64)


def _prefix_pair(d: dict, i: torch.Tensor):
    """Both bounds (p[i], p[i+1]) of bucket(s) ``i``: one ``flat2`` pair
    where the layout has them; grouped32's delta pair and base pair (the
    next group's base where bucket i + 1 starts a group); else two
    ``_prefix_get`` reads."""
    pre = d["prefix"]
    if "flat2" in pre:
        pair = pre["flat2"][i].to(torch.int64)
        return pair[..., 0], pair[..., 1]
    if d["meta"].prefix_kind == "grouped32":
        dpair = mask32(pre["gd2"][i])
        g = i >> 10
        gb = pre["gb2"][g]
        ps = gb[..., 0] + (dpair & 0xFFFF)
        pe = torch.where(((i + 1) >> 10) != g, gb[..., 1], gb[..., 0]) + (dpair >> 16)
        return ps, pe
    return _prefix_get(d, i), _prefix_get(d, i + 1)


def _pos_get(d: dict, i: torch.Tensor) -> torch.Tensor:
    if d["meta"].pos_kind == "flat32":
        return d["pos"]["flat"][i].to(torch.int64)
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


def _w64(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The u64 bit pattern of two u32 row columns (int32 bit patterns)."""
    return mask32(lo) | (hi.to(torch.int64) << 32)


ALIGNED = ("inline2", "fixedcap2")  # row kinds whose window starts at bit 0
ROW_KINDS = ("inline", "fixedcap") + ALIGNED


def fused_kind(pos_kind: str, width: int) -> tuple[bool, bool]:
    """(fused, fused14) of rows ``width`` u32 wide: whether the rows carry
    the fusion pass's occurrence columns (first occurrence word and count),
    and whether they also carry the unitig's ``occ_start``."""
    aligned = pos_kind in ALIGNED
    fused = width >= (14 if aligned else 13)
    return fused, fused and width >= (12 if aligned else 14)


def _hits(f: dict, active: torch.Tensor, fw: torch.Tensor, rc: torch.Tensor, offsets, k: int):
    """The first hit among candidate rows, each checked at the lane's two
    candidate offsets against the row's own unitig extent. ``f`` holds the
    rows' mm_pos, start, end, base (the window's first position), the
    words q0..q2 that hold the window from bit ``woff``, each [N, J] (rows
    in probe order); ``active`` [N, J] masks rows past a lane's count.
    Returns (any_hit [N], the winning row [N], and the winner's pos and mt)."""
    cands = []
    for off in offsets:
        km_pos = f["mm_pos"] - off[:, None]
        dbit = f["woff"] + 2 * torch.clamp(km_pos - f["base"], min=0)
        mt = word_equivalency(fw[:, None], rc[:, None],
                              _extract(f["q0"], f["q1"], f["q2"], dbit, k), k)
        hit = active & (km_pos >= f["start"]) & (km_pos + k <= f["end"]) & (mt > 0)
        cands.append((hit, km_pos - f["start"], mt))

    def flat(i):  # candidate order: row j, then its two offsets
        return torch.stack([cands[0][i], cands[1][i]], dim=2).flatten(1)

    first, any_hit = _first(flat(0))
    return any_hit, torch.div(first, 2, rounding_mode="floor"), _take(flat(1), first), \
        _take(flat(2), first)


def inline_hits(rows: torch.Tensor, active: torch.Tensor, fw: torch.Tensor, rc: torch.Tensor,
                offsets, k: int, w: int, pos_kind: str, fused: bool, fused14: bool):
    """``_hits`` on u32 rows ``rows`` (int32 [N, J, C]) of a row layout
    (``ROW_KINDS``). Returns (any_hit [N], the winner's fields [N]:
    unitig_id, unitig_len, pos, mt and, on fused rows, occ_word, occ_oc
    (count, with ``occ_start << 32`` when the rows carry it) and on aligned
    (inline2, fixedcap2) rows occ_word2). A fixedcap2 row's uid field
    carries its bucket's count in bits 29-31 on slot 0: the uid is the
    low 29 bits."""
    def col(c):
        return mask32(rows[..., c])

    aligned = pos_kind in ALIGNED
    mm_pos, start, end = col(0), col(2), col(3)
    uid = col(1) & ((1 << 29) - 1) if pos_kind == "fixedcap2" else col(1)
    base = torch.clamp(mm_pos - (k - w), min=0)
    q0, q1 = _w64(rows[..., 4], rows[..., 5]), _w64(rows[..., 6], rows[..., 7])
    if aligned:
        q2, woff = q1, 0
    else:
        q2, woff = _w64(rows[..., 8], rows[..., 9]), (base * 2) & 63
    f = {"mm_pos": mm_pos, "start": start, "end": end, "base": base, "q0": q0, "q1": q1,
         "q2": q2, "woff": woff}
    any_hit, row, pos, mt = _hits(f, active, fw, rc, offsets, k)
    win = {"unitig_id": _take(uid, row), "unitig_len": _take(end - start, row), "pos": pos,
           "mt": mt}
    if fused:
        c = 8 if aligned else 10
        win["occ_word"] = _take(_w64(rows[..., c], rows[..., c + 1]), row)
        oc = col(c + 2)
        if fused14:
            oc = oc | (col(c + 3) << 32)
        win["occ_oc"] = _take(oc, row)
        if aligned:
            win["occ_word2"] = _take(_w64(rows[..., 12], rows[..., 13]), row)
    return any_hit, win


def records_hits(rec: torch.Tensor, quad: torch.Tensor, active: torch.Tensor, fw: torch.Tensor,
                 rc: torch.Tensor, offsets, k: int, w: int):
    """``_hits`` on the records layout: int32 records ``rec`` [N, J, 4]
    (mm_pos, uid, start, end), each with the ``useq_quad`` row of its
    window's first word, which holds both candidates (a valid candidate
    lies in the record's unitig: no rank and no extent read). Returns
    (any_hit, the winner's unitig_id, unitig_len, pos and mt)."""
    r = rec.to(torch.int64)
    mm_pos, start, end = r[..., 0], r[..., 2], r[..., 3]
    base = torch.clamp(mm_pos - (k - w), min=0)
    q = quad[(base * 2) >> 6]
    f = {"mm_pos": mm_pos, "start": start, "end": end, "base": base, "q0": q[..., 0],
         "q1": q[..., 1], "q2": q[..., 2], "woff": (base * 2) & 63}
    any_hit, row, pos, mt = _hits(f, active, fw, rc, offsets, k)
    return any_hit, {"unitig_id": _take(r[..., 1], row), "unitig_len": _take(end - start, row),
                     "pos": pos, "mt": mt}


def occ_fields(out: dict, fused14: bool) -> dict:
    """The fused occurrence outputs of a probe's ``occ_word``/``occ_oc``
    (and ``occ_word2``) state: occ_word, occ_cnt, occ_start (fused14),
    occ_word2 (inline2)."""
    res = {"occ_word": out["occ_word"]}
    if fused14:
        res.update(occ_cnt=out["occ_oc"] & M32, occ_start=srl(out["occ_oc"], 32))
    else:
        res["occ_cnt"] = out["occ_oc"]
    if "occ_word2" in out:
        res["occ_word2"] = out["occ_word2"]
    return res


def _first(flags: torch.Tensor):
    """Index of the first set flag along dim 1, and whether there is one."""
    n = flags.shape[1]
    idx = torch.arange(n, device=flags.device)
    first = torch.where(flags, idx, n).amin(dim=1)
    return torch.clamp(first, max=n - 1), first < n


def _take(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(v, 1, idx[:, None])[:, 0]


def mphf_lookup(d: dict, keys: torch.Tensor, level_limit: int | None = None):
    """Values of ``keys`` under an MPHF: BooPHF32 (meta kind ``boophf32``)
    or the 64-bit BooPHF (kind ``boophf``, or no kind: the reference's
    meta record carries none). With ``level_limit``, ``(values,
    unresolved)``: BooPHF32 truncates its chain (see
    ``boophf32.boophf32_lookup``); the 64-bit chain always runs in full,
    so nothing is left unresolved."""
    kind = getattr(d["meta"], "kind", "boophf")
    if kind == "boophf32":
        return boophf32_lookup(d, keys, level_limit=level_limit)
    if kind != "boophf":
        raise ValueError(f"no MPHF lookup for kind {kind!r}")
    res = boophf_lookup(d, keys)
    if level_limit is not None:
        return res, torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    return res


def sshash_k2u(d: dict, fw: torch.Tensor, mode: str = "full", probe_limit: int | None = None,
               probe_start: int = 0, defer_valid: bool = False,
               mphf_level_limit: int | None = None, bucket_range=None) -> dict:
    """Batched SSHash K2U, any engine and layout (``SSHash.device_arrays``),
    plain torch (``mazu_tpu.kphf.sshash.sshash_k2u``).

    ``fw``: int64 bit patterns of forward k-mer words. Returns int64
    unitig_id, unitig_len, pos and uint8 mt (0 miss, 1 identity, 2 twin).
    A lane's bucket is ``fold_hash32(mm) & (T-1)`` (direct) or the MPHF
    value of its minimizer (fast32's BooPHF32, parity's 64-bit BooPHF; a
    lane the MPHF rejects has no occurrences). Its rows are
    [p[b], p[b + 1]) of the bucket bounds, or on the fixedcap layouts
    [b B, (b + 1) B), B = ``meta.cap``: a lane then has B occurrences
    (fixedcap) or the count in slot 0 (fixedcap2), and a heavy bucket is
    the marker in slot 0, not a count above ``skew_param``.

    ``mode="full"`` is exact for every key: each bucket's rows up to the
    static ``probe_bound`` (lanes mask rows past their count, so no bound
    comes back to the host; rows go in blocks of up to ``ROW_BUDGET``
    lane-rows, and the first hit in row order wins), each candidate
    checked against its unitig's extent, the winner mapped to its unitig,
    and heavy buckets resolved through the skew table. ``probe_start``
    skips rows [0, probe_start) for every lane (the caller guarantees they
    were probed and missed). With the unitig set's ``uproj`` records the
    winner's unitig record also gives occ_word, occ_word2, occ_cnt and
    occ_start.

    ``mode="main"`` probes the first ``min(probe_bound, probe_limit)`` rows
    of each bucket and adds bool ``use_skew`` (a heavy bucket) and
    ``unresolved`` (rows past the probed depth, and the cases below), which
    the caller's compacted phases settle.

    The probe by layout:

    - row layouts (``ROW_KINDS``): each row is one gather that also
      carries the unitig's id and extent, against which the candidates are
      checked; fused rows add occ_word, occ_cnt, occ_start and (aligned
      rows) occ_word2. ``defer_valid`` changes nothing there.
    - records: one record and one ``useq_quad`` row a candidate row.
    - packed or flat32 positions: one ``words2`` row pair a row, each
      candidate checked with ``us_is_valid_pos``; the winner is mapped to
      its unitig after the loop. ``defer_valid`` (main mode) drops the
      in-loop check and validates only the winner, with its rank
      (``us_validate_rank``): a failed winner clears the lane's hit and
      leaves it unresolved. ``mphf_level_limit`` (fast32, main mode) runs
      the truncated MPHF chain: lanes it cannot place are unresolved and
      have no occurrences. With ``uproj``, main mode adds occ_word,
      occ_word2, occ_cnt and occ_start.
    - packed positions with the ``useqrec`` window records (main mode,
      ``probe_start`` 0; and at ``probe_limit <= 3`` the ``bpos`` rows):
      one record per row carries the candidate's words and its unitig's
      extent, id and first two occurrence words. A candidate that spelled
      the query but failed the record's extent check (the reference's
      mt == 3 sentinel) leaves its lane unresolved. Adds occ_word,
      occ_word2 and occ_cnt.

    Unresolved lanes of the records, of ``defer_valid`` or of
    ``mphf_level_limit`` must be re-probed from row 0.

    ``bucket_range=(lo, hi)`` (direct engine with ``flat2`` bounds or
    ``bpos`` rows, not fixedcap) queries one shard of the bucket table: the
    arrays hold buckets [lo, hi) only, their bounds rebased to the shard's
    rows (``shard_arrays``). Lanes whose bucket is not in the range have no
    occurrences, so their outputs are exact zeros and a one-hot sum over
    the shards gives the whole table's answer; bool ``mine`` flags the
    range's lanes."""
    m = d["meta"]
    us = d["us"]
    pk = m.pos_kind
    if pk not in POS_KINDS:
        raise ValueError(f"no {pk!r} SSHash position layout: one of {POS_KINDS}")
    if defer_valid and mode != "main":
        raise ValueError("defer_valid is a main-mode contract: its caller re-probes failed lanes")
    usrec = mode == "main" and probe_start == 0 and pk == "packed" and "useqrec" in us
    k, w = m.k, m.w
    rc = revcomp(fw, k)
    mm, offset, _is_fw, canon = canonical_minimizer_batch(fw, k, w, m.seed, ordering=m.ordering)
    offset = offset.to(torch.int64)
    rc_offset = (k - w) - offset
    use_bpos = (
        "bpos" in d and mode == "main" and pk == "packed" and probe_start == 0
        and probe_limit is not None and 0 < probe_limit <= d["bpos"].shape[1] - 1
    )
    mphf_unres = dead = mine = row0 = None
    if m.direct_t:
        hc = fold_hash32(mm) & (m.direct_t - 1)
        if bucket_range is not None:
            if pk == "fixedcap" or not (use_bpos or "flat2" in d.get("prefix", {})):
                raise AssertionError("bucket_range requires the direct engine with flat2/bpos rows")
            lo, hi = bucket_range
            mine = (hc >= lo) & (hc < hi)
            local_t = d["bpos"].shape[0] if use_bpos else d["prefix"]["flat2"].shape[0]
            hc = torch.clamp(hc - lo, 0, local_t - 1)
    else:
        if bucket_range is not None:
            raise AssertionError("bucket_range requires engine='direct'")
        if mode == "main" and mphf_level_limit is not None:
            h, mphf_unres = mphf_lookup(d["mphf"], mm, level_limit=mphf_level_limit)
        else:
            h = mphf_lookup(d["mphf"], mm)
        h = h.to(torch.int64)
        dead = h < 0
        hc = torch.clamp(h, min=0)
    if use_bpos:
        brow = mask32(d["bpos"][hc])
        n_occs = brow[:, 3]
        ps = torch.zeros_like(n_occs)
    elif m.direct_t and pk in ("fixedcap", "fixedcap2"):
        # direct addressing: no bounds read; slot 0 tells a heavy bucket
        # (and, on fixedcap2, the bucket's count)
        ps = hc * m.cap
        row0 = d["pos"]["inline"][ps]
        if pk == "fixedcap2":
            f0 = mask32(row0[:, 1])
            n_occs = torch.where(f0 >= 0xFFFFFFFE, 0, f0 >> 29)
        else:
            n_occs = torch.full_like(hc, m.cap)
    else:
        ps, pe = _prefix_pair(d, hc)
        n_occs = pe - ps
    if mine is not None and row0 is None:
        n_occs = torch.where(mine, n_occs, 0)
    if dead is not None:
        n_occs = torch.where(dead, 0, n_occs)
    if row0 is not None:
        use_skew = mask32(row0[:, 1]) == 0xFFFFFFFE
    elif m.skew_param >= 0:
        use_skew = n_occs > m.skew_param
    else:
        use_skew = torch.zeros_like(n_occs, dtype=torch.bool)
    bound = m.probe_bound
    if mode == "main" and probe_limit is not None:
        bound = min(bound, int(probe_limit))
    if pk in ROW_KINDS or pk == "records":
        res = _row_k2u(d, fw, rc, canon, (offset, rc_offset), ps, n_occs, use_skew, bound, mode,
                       probe_start, mphf_unres)
    else:
        res = _position_k2u(d, fw, rc, canon, (offset, rc_offset), ps, n_occs, use_skew, bound,
                            mode, probe_start, defer_valid, mphf_unres, usrec,
                            brow[:, :bound] if use_bpos else None)
    if mine is not None:
        res["mine"] = mine
    return res


def _position_k2u(d: dict, fw, rc, canon, offsets, ps, n_occs, use_skew, bound: int, mode: str,
                  probe_start: int, defer_valid: bool, mphf_unres, usrec: bool, pos_win):
    """``sshash_k2u`` on packed or flat32 positions (the reference's
    ``probe_body_generic`` and ``probe_body_usrec``)."""
    m = d["meta"]
    us = d["us"]
    k, w = m.k, m.w
    offset, rc_offset = offsets
    last_km = us["meta"].total_len - k
    if pos_win is None and m.pos_kind == "packed" and probe_start == 0 and 1 < bound <= 8:
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
            elif defer_valid:
                cands.append((match, None, km_pos_c, mt))
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

    unresolved = ~found & ~use_skew & (n_occs > bound)
    if mphf_unres is not None:
        unresolved = unresolved | mphf_unres
    if usrec:
        # a candidate spelled the query but its record's extent check
        # failed, and no later candidate hit: phase 2 must re-probe it
        return {
            **{key: out[key] for key in ("unitig_id", "unitig_len", "pos", "mt")},
            "use_skew": use_skew,
            "unresolved": unresolved | (~found & sentinel),
            "occ_word": out["occ_word"],
            "occ_word2": out["occ_word2"],
            "occ_cnt": out["occ_cnt"],
        }
    pos, mt = out["pos"], out["mt"]
    uid_r = None
    if defer_valid:
        # the winner spelled the query; a boundary inside its window makes
        # it no hit, and it may have hidden a later true one: re-probe
        posw = torch.where(found, pos, 0)
        if "wb2" in us["bv"]:
            vok, uid_r = us_validate_rank(us, posw)
        else:
            vok = us_is_valid_pos(us, posw)
        unresolved = unresolved | (found & ~vok)
        found = found & vok
        mt = torch.where(found, mt, 0)
    posw = torch.where(found, pos, 0)
    uproj = us.get("uproj")
    occ = {}
    if uproj is not None:
        uid = torch.clamp(us_rank(us, posw) if uid_r is None else uid_r, 0, uproj.shape[0] - 1)
        row = uproj[uid]
        ulen = row[:, 1]
        pos = torch.where(found, pos - row[:, 0], pos)
        if mode == "main":
            oc = torch.where(found, row[:, 2], z)
            occ = {"occ_word": torch.where(found, row[:, 3], z),
                   "occ_word2": torch.where(found, row[:, 4], z),
                   "occ_cnt": oc & M32, "occ_start": oc >> 32}
    else:
        if uid_r is None:
            uid, ulen, upos, _ = _map_hit(d, posw)
        else:
            uid = torch.clamp(uid_r, 0, max(us["meta"].n_unitigs - 1, 0))
            start, end = us_extent(us, uid)
            ulen, upos = end - start, posw - start
        pos = torch.where(found, upos, pos)
    uid, ulen = torch.where(found, uid, z), torch.where(found, ulen, z)
    if mode == "main":
        return {"unitig_id": uid, "unitig_len": ulen, "pos": pos, "mt": mt,
                "use_skew": use_skew, "unresolved": unresolved, **occ}
    res = skew_resolve(d, fw, rc, canon, use_skew,
                       {"unitig_id": uid, "unitig_len": ulen, "pos": pos, "mt": mt})
    uid, mt = res["unitig_id"], res["mt"]
    if uproj is not None:
        # one record over the final unitig, skew lanes included
        hit = mt > 0
        rowf = uproj[torch.clamp(uid, 0, uproj.shape[0] - 1)]
        res.update(occ_word=torch.where(hit, rowf[:, 3], z),
                   occ_word2=torch.where(hit, rowf[:, 4], z),
                   occ_cnt=torch.where(hit, rowf[:, 2] & M32, z),
                   occ_start=torch.where(hit, srl(rowf[:, 2], 32), z))
    return res


def _row_k2u(d: dict, fw, rc, canon, offsets, ps, n_occs, use_skew, bound: int, mode: str,
             probe_start: int, mphf_unres) -> dict:
    """``sshash_k2u`` on a row layout or on records (the reference's
    ``probe_body_inline``, ``probe_body_inline2`` and
    ``probe_body_records``): rows [probe_start, bound) of each bucket, a
    block of rows at a time, first hit in row order; then the skew table in
    full mode. Fused rows add their occurrence fields (``occ_fields``),
    except in full mode on a fast32 index: its skew table (``skew_mphf``)
    carries none, so the projection of its skew lanes reads the offsets
    table (the reference reports them with no occurrences, C10)."""
    m = d["meta"]
    records = m.pos_kind == "records"
    rows = d["pos"]["records" if records else "inline"]
    fused, fused14 = (False, False) if records else fused_kind(m.pos_kind, rows.shape[1])
    last = max(rows.shape[0] - 1, 0)
    z = torch.zeros_like(fw)
    found = torch.zeros_like(fw, dtype=torch.bool)
    out = {"unitig_id": z, "unitig_len": z, "pos": z, "mt": torch.zeros_like(fw, dtype=torch.uint8)}
    if fused:
        out.update(occ_word=z, occ_oc=z)
        if m.pos_kind in ALIGNED:
            out["occ_word2"] = z
    block = max(1, min(bound - probe_start, ROW_BUDGET // max(fw.shape[0], 1)))
    for j0 in range(probe_start, bound, block):
        js = torch.arange(j0, min(j0 + block, bound), device=fw.device)
        active = (js[None, :] < n_occs[:, None]) & ~use_skew[:, None]
        block_rows = rows[torch.clamp(ps[:, None] + js, 0, last)]
        if records:
            any_hit, win = records_hits(block_rows, d["useq_quad"], active, fw, rc, offsets, m.k,
                                        m.w)
        else:
            any_hit, win = inline_hits(block_rows, active, fw, rc, offsets, m.k, m.w, m.pos_kind,
                                       fused, fused14)
        take = any_hit & ~found
        for key, v in win.items():
            out[key] = torch.where(take, v, out[key])
        found = found | any_hit
    if mode == "main":
        unresolved = ~found & ~use_skew & (n_occs > bound)
        if mphf_unres is not None:
            unresolved = unresolved | mphf_unres
        res = {kk: out[kk] for kk in ("unitig_id", "unitig_len", "pos", "mt")}
        res.update(use_skew=use_skew, unresolved=unresolved)
    else:
        out = skew_resolve(d, fw, rc, canon, use_skew, out, fused14=fused14)
        res = {kk: out[kk] for kk in ("unitig_id", "unitig_len", "pos", "mt")}
        fused = fused and "skew_mphf" not in d
    if fused:
        res.update(occ_fields(out, fused14))
    return res


def _skew_row(rows, fw, rc, k):
    """(uid, ulen, upos, mt) of u32 skew rows: the k-mer sits at the row's
    position, within its two words."""
    r32 = mask32(rows)
    kpos = r32[..., 0]
    w0 = r32[..., 4] | (r32[..., 5] << 32)
    w1 = r32[..., 6] | (r32[..., 7] << 32)
    kw = _extract(w0, w1, w1, (kpos * 2) & 63, k)
    start, end = r32[..., 2], r32[..., 3]
    return r32[..., 1], end - start, kpos - start, word_equivalency(fw, rc, kw, k)


def skew_resolve(d: dict, fw, rc, canon, use_skew, out: dict, fused14: bool = False) -> dict:
    """Resolve heavy-bucket lanes through the skew table: the direct
    engine's two-choice rows (``skew_kind="cuckoo"``) or bounded buckets
    (``skew_prefix2``), or fast32's ``skew_mphf`` over the canonical k-mer,
    whose value indexes ``skew_pos``. ``out`` holds unitig_id, unitig_len,
    pos and mt, and on fused rows occ_word and occ_oc, which the direct
    engine's fused skew rows set too (occ_oc with occ_start where
    ``fused14``); lanes not in ``use_skew`` pass through. Returns the
    updated dict."""
    m = d["meta"]
    k = m.k
    out = dict(out)
    if "skew_inline" in d:
        srows = d["skew_inline"]
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
        occ = "occ_word" in out and srows.shape[1] >= 11
        sfound = torch.zeros_like(use_skew)
        for rows, ok in probes:
            new = dict(zip(("unitig_id", "unitig_len", "pos", "mt"), _skew_row(rows, fw, rc, k)))
            if occ:
                new["occ_word"] = _w64(rows[:, 8], rows[:, 9])
                oc = mask32(rows[:, 10])
                if fused14 and srows.shape[1] >= 12:
                    oc = oc | (mask32(rows[:, 11]) << 32)
                new["occ_oc"] = oc
            hit = use_skew & ~sfound & ok & (new["mt"] > 0)
            for key, v in new.items():
                out[key] = torch.where(hit, v, out[key])
            sfound = sfound | hit
    elif "skew_mphf" in d:
        h2 = mphf_lookup(d["skew_mphf"], canon).to(torch.int64)
        n_skew = d["skew_pos"]["meta"].length
        sp = iv_get(d["skew_pos"], torch.clamp(h2, 0, max(n_skew - 1, 0)))
        sp = torch.clamp(sp, 0, max(d["us"]["meta"].total_len - k, 0))
        r_mt = word_equivalency(fw, rc, us_get_kmer(d["us"], sp), k)
        r_uid, r_ulen, r_pos, end_ok = _map_hit(d, sp)
        hit = use_skew & (h2 >= 0) & (r_mt > 0) & end_ok
        for key, v in (("unitig_id", r_uid), ("unitig_len", r_ulen), ("pos", r_pos), ("mt", r_mt)):
            out[key] = torch.where(hit, v, out[key])
    return out


def shard_arrays(k2u: dict, prefix: np.ndarray, n_shards: int) -> list:
    """The bucket shards of a direct SSHash's arrays ``k2u`` (host NumPy,
    ``flat2`` bounds and a row layout with its rows in bucket order, fused
    or not), laid out as ``mazu_tpu.parallel.sharding.shard_fused_arrays``
    lays them out: shard s owns buckets [lo, hi) of ``n_shards`` equal
    ranges and holds their ``flat2`` pairs rebased to its first row and
    its rows, both zero-padded to the largest shard's, beside the shared
    arrays. ``prefix`` is the SSHash's ``occs_prefix_sum``. Returns
    [(local arrays, lo, hi)] for ``sshash_k2u(..., bucket_range=(lo, hi))``."""
    m = k2u["meta"]
    if not (m.direct_t and "flat2" in k2u.get("prefix", {}) and "inline" in k2u["pos"]):
        raise ValueError("bucket shards need a direct SSHash with flat2 bounds and row layout")
    T = m.direct_t
    prefix = np.asarray(prefix, dtype=np.int64)
    bounds = np.linspace(0, T, n_shards + 1).astype(np.int64)
    flat2, rows = k2u["prefix"]["flat2"], k2u["pos"]["inline"]
    row_lo, row_hi = prefix[bounds[:-1]], prefix[bounds[1:]]
    max_t = int((bounds[1:] - bounds[:-1]).max())
    max_rows = max(1, int((row_hi - row_lo).max()))
    shared = {key: v for key, v in k2u.items() if key not in ("prefix", "pos")}
    out = []
    for s in range(n_shards):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        f2 = np.zeros((max_t, 2), dtype=flat2.dtype)
        f2[: hi - lo] = flat2[lo:hi] - flat2.dtype.type(row_lo[s])
        local = np.zeros((max_rows, rows.shape[1]), dtype=rows.dtype)
        local[: row_hi[s] - row_lo[s]] = rows[row_lo[s] : row_hi[s]]
        out.append(({**shared, "prefix": {"flat2": f2},
                     "pos": {"inline": local, "meta": meta(length=max_rows)}}, lo, hi))
    return out


class TwoPhaseSSHash:
    """Two-phase query of one SSHash (``mazu_tpu``'s ``TwoPhaseSSHash``,
    ``bench.py``'s ``2phase`` mode): the main probe (no skew reads) over
    the whole batch, then the lanes it flags ``use_skew`` compacted into a
    batch padded to a power of two of at least 64 and run in full mode. The
    results' unitig_id, unitig_len, pos and mt equal one full-mode call's.

    ``ss.device_arrays()`` (the engine's default layout) go to ``device``,
    the card by default. The lane list's count is the one host read of a
    query."""

    def __init__(self, ss: SSHash, device=None):
        from ..convert import arrays_from_numpy, resolve_device

        self.device = resolve_device(device)
        self.d = arrays_from_numpy(ss.device_arrays(), self.device)

    def main(self, fw: torch.Tensor) -> dict:
        return sshash_k2u(self.d, fw, mode="main")

    def full(self, fw: torch.Tensor) -> dict:
        return sshash_k2u(self.d, fw)

    def k2u(self, fw_words: np.ndarray) -> dict:
        """The query of u64 words as NumPy arrays: the main phase's dict
        without ``use_skew``, its skew lanes' four K2U fields from the
        full-mode pass."""
        from ..convert import words_to
        from ..ops.compact import flagged_lanes

        fw = words_to(fw_words, self.device)
        r = self.main(fw)
        lanes, n = flagged_lanes(r.pop("use_skew"), fw.shape[0])
        n = int(n)
        if n:
            lanes = lanes[:n]
            padded = torch.zeros(1 << max(6, (n - 1).bit_length()), dtype=fw.dtype,
                                 device=fw.device)
            padded[:n] = fw[lanes]
            s = self.full(padded)
            for key in ("unitig_id", "unitig_len", "pos", "mt"):
                r[key] = r[key].index_put((lanes,), s[key][:n])
        return {key: v.cpu().numpy() for key, v in r.items()}
