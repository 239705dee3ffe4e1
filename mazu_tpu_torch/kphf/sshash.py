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
position scatter and pack; the rest is NumPy. The device layouts,
all with the unitig set's paired arrays: the speed tier's (the 32-bit
engines' default), one inline row per minimizer occurrence that holds the
candidate window's words and its unitig's id and extent (``inline`` or the
pre-aligned ``inline2``), with flat32 bucket bounds, which
``ModIndex.device_arrays(fused=True)`` extends with occurrence fields;
packed positions (IntVector) with Elias-Fano bucket bounds (parity's
default); and the capacity tier's, packed positions with grouped16 bucket
bounds, and the direct engine's ``bpos`` rows and ``useqrec`` window
records, or the per-unitig ``uproj`` records
(``index.modindex.build_uproj``) for the deferred-validation probe.
``sshash_k2u`` is the plain torch query of all of them; on the capacity
tier's main path ``ops.bpos_probe.bpos_usrec_k2u`` (direct, useqrec) and
``ops.capacity_probe.capacity_k2u`` (deferred validation, 32-bit engines)
run its main probe as kernels. The speed tier's probe and every probe of
a parity SSHash are plain torch, as the reference's are plain ``jnp``.
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
            ef = EFVector.from_array(self.occs_prefix_sum.astype(np.uint64))
            mm_bits = ef.num_bits() + self.mphf.num_bits()
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

        - the speed tier: ``pos_kind="inline"``, one u32[., 10]
          row per minimizer occurrence (mm_pos, uid, start, end, then the
          three useq words that hold both candidate k-mers), or
          ``"inline2"``, u32[., 8] rows whose two words hold the candidate
          window pre-aligned to bit 0; with ``prefix_kind="flat32"`` bounds
          (the 32-bit engines' default), a [T, 2] int32 ``flat2`` pair per
          bucket (fast32 also keeps the [T + 1] ``flat`` prefix, as the
          reference does without its native library), grouped16 bounds, or
          Elias-Fano bounds (parity's default). Both row kinds need
          ``total_len < 2^31``.
        - packed positions (an IntVector): ``pos_kind="packed"`` with
          ``prefix_kind="ef"`` (an ``EFVector`` of the bucket prefix, parity's
          default) or ``"grouped16"`` (an int64 base per 1024-bucket group and
          a u16 in-group delta per bucket, the capacity tier), and with
          ``bucket_inline`` the ``bpos`` u32[T, 4] rows (first three
          positions of the bucket, then its count).

        The direct engine's skew rows are u32[., 8]: pos, uid, start, end and
        the two useq words that hold the k-mer; the MPHF engines add their
        ``mphf``, ``skew_mphf`` and ``skew_pos``, with ``mphf_rows`` a
        BooPHF32 ``mphf`` in its paired ``mrows`` layout (which the plain
        probe reads and K3 does not). ``ModIndex.device_arrays(fused=True)``
        appends each row's occurrence fields."""
        if pos_kind is None:
            pos_kind = "inline" if self.hash32 else "packed"
        if prefix_kind is None:
            prefix_kind = "ef" if not self.hash32 else (
                "grouped16" if pos_kind == "packed" else "flat32")
        if pos_kind not in ("packed", "inline", "inline2"):
            raise ValueError(f"the port has no {pos_kind!r} SSHash position layout yet")
        bounds = ("grouped16", "ef") if pos_kind == "packed" else ("flat32", "grouped16", "ef")
        if prefix_kind not in bounds:
            raise ValueError(f"the port has no {prefix_kind!r} SSHash bucket bounds for "
                             f"{pos_kind!r} positions yet")
        if bucket_inline and pos_kind != "packed":
            raise ValueError(f"bucket_inline requires pos_kind='packed', got {pos_kind!r}")
        us = self.unitigs
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
        if pos_kind == "packed":
            d["pos"] = self.pos.device_arrays()
        else:
            d["pos"] = {"inline": self._inline_rows(pos_kind == "inline2"),
                        "meta": meta(length=len(self.pos))}
        p = self.occs_prefix_sum
        if prefix_kind == "ef":
            d["prefix"] = EFVector.from_array(p.astype(np.uint64)).device_arrays()
        elif prefix_kind == "grouped16":
            base = np.ascontiguousarray(p[::1024]).astype(np.int64)
            delta = np.empty(len(p), dtype=np.uint16)
            step = 1 << 24  # buckets a step, whole groups: no temporary of every bucket
            for a in range(0, len(p), step):
                seg = p[a : a + step] - np.repeat(base[a >> 10 : (a + step) >> 10], 1024)[
                    : len(p[a : a + step])]
                if int(seg.max(initial=0)) >= (1 << 16):
                    raise ValueError("grouped16 prefix overflow: a 1024-bucket group holds >= "
                                     "2^16 occurrences")
                delta[a : a + len(seg)] = seg
            d["prefix"] = {"gbase": base, "gdelta": delta}
        else:
            p32 = p.astype(np.int32)
            pairs = np.stack([p32[:-1], p32[1:]], axis=1)
            # the direct build keeps its bounds sparse, as the reference's
            # native pass reads them: flat2 alone; fast32 keeps both
            d["prefix"] = ({"flat2": pairs} if self._sparse_prefix is not None
                           else {"flat": p32, "flat2": pairs})
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

    def _inline_rows(self, aligned: bool) -> np.ndarray:
        """u32 occurrence rows: (mm_pos, uid, start, end) and the useq words
        that hold the candidate window [mm_pos - (k - w), mm_pos + k), three
        words from the window's word (``inline``, u32[., 10]) or two words
        pre-aligned so the window starts at bit 0 (``inline2``, u32[., 8])."""
        us = self.unitigs
        if us.total_len >= (1 << 31):
            raise AssertionError("inline rows carry u32 positions: total_len must be < 2^31")
        pos_arr = self.pos.to_array().astype(np.int64)
        uid = us.pos_to_id(pos_arr)
        base = np.maximum(pos_arr - (self.k - self.w), 0)
        wi = (base * 2) >> 6
        wp = np.concatenate([us.useq.words, np.zeros(2, dtype=U64)])
        cols = [pos_arr.astype(U64) | (uid.astype(U64) << U64(32)),
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
        rows = np.stack(cols, axis=1)
        return np.ascontiguousarray(rows).view(U32).reshape(len(rows), -1)


# ---------------------------------------------------------------------------
# Batched query (plain torch)
# ---------------------------------------------------------------------------


def _prefix_get(d: dict, i: torch.Tensor) -> torch.Tensor:
    """Bucket prefix p[i]: an Elias-Fano select, or grouped16's base and
    delta."""
    pre = d["prefix"]
    if d["meta"].prefix_kind == "ef":
        return ef_get(pre, i)
    return pre["gbase"][i >> 10] + (pre["gdelta"][i].to(torch.int64) & 0xFFFF)


def _prefix_pair(d: dict, i: torch.Tensor):
    """Both bounds (p[i], p[i+1]) of bucket(s) ``i``: one ``flat2`` pair
    where the layout has them, else two grouped16 reads."""
    if "flat2" in d["prefix"]:
        pair = d["prefix"]["flat2"][i].to(torch.int64)
        return pair[..., 0], pair[..., 1]
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


def _w64(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The u64 bit pattern of two u32 row columns (int32 bit patterns)."""
    return mask32(lo) | (hi.to(torch.int64) << 32)


def fused_kind(pos_kind: str, width: int) -> tuple[bool, bool]:
    """(fused, fused14) of inline rows ``width`` u32 wide: whether the rows
    carry the fusion pass's occurrence columns (first occurrence word and
    count), and whether they also carry the unitig's ``occ_start``."""
    aligned = pos_kind == "inline2"
    fused = width >= (14 if aligned else 13)
    return fused, fused and width >= (12 if aligned else 14)


def inline_hits(rows: torch.Tensor, active: torch.Tensor, fw: torch.Tensor, rc: torch.Tensor,
                offsets, k: int, w: int, aligned: bool, fused: bool, fused14: bool):
    """The first hit among candidate inline rows ``rows`` (int32 [N, J, C],
    rows in probe order), each checked at the lane's two candidate offsets
    against the row's own unitig extent; ``active`` [N, J] masks rows past a
    lane's count. Returns (any_hit [N], the winner's fields [N]: unitig_id,
    unitig_len, pos, mt and, on fused rows, occ_word, occ_oc (count, with
    ``occ_start << 32`` when the rows carry it) and on ``aligned`` (inline2)
    rows occ_word2)."""
    def col(c):
        return mask32(rows[..., c])

    mm_pos, start, end = col(0), col(2), col(3)
    base = torch.clamp(mm_pos - (k - w), min=0)
    q0, q1 = _w64(rows[..., 4], rows[..., 5]), _w64(rows[..., 6], rows[..., 7])
    if aligned:  # the window starts at bit 0 of its two words
        q2, woff = q1, 0
    else:
        q2, woff = _w64(rows[..., 8], rows[..., 9]), (base * 2) & 63
    cands = []
    for off in offsets:
        km_pos = mm_pos - off[:, None]
        dbit = woff + 2 * torch.clamp(km_pos - base, min=0)
        mt = word_equivalency(fw[:, None], rc[:, None], _extract(q0, q1, q2, dbit, k), k)
        hit = active & (km_pos >= start) & (km_pos + k <= end) & (mt > 0)
        cands.append((hit, km_pos - start, mt))

    def flat(i):  # candidate order: row j, then its two offsets
        return torch.stack([cands[0][i], cands[1][i]], dim=2).flatten(1)

    first, any_hit = _first(flat(0))
    row = torch.div(first, 2, rounding_mode="floor")
    win = {"unitig_id": _take(col(1), row), "unitig_len": _take(end - start, row),
           "pos": _take(flat(1), first), "mt": _take(flat(2), first)}
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
               mphf_level_limit: int | None = None) -> dict:
    """Batched SSHash K2U, any engine, on packed positions (grouped16 or
    Elias-Fano bounds) or the speed tier's inline rows (``_inline_k2u``),
    plain torch (``mazu_tpu.kphf.sshash.sshash_k2u``).

    ``fw``: int64 bit patterns of forward k-mer words. Returns int64
    unitig_id, unitig_len, pos and uint8 mt (0 miss, 1 identity, 2 twin).
    A lane's bucket is ``fold_hash32(mm) & (T-1)`` (direct) or the MPHF
    value of its minimizer (fast32's BooPHF32, parity's 64-bit BooPHF; a
    lane the MPHF rejects has no occurrences).

    ``mode="full"`` is exact for every key: each bucket's rows up to the
    static ``probe_bound`` (lanes mask rows past their count, so no bound
    comes back to the host; rows go in blocks of up to ``ROW_BUDGET``
    lane-rows, and the first hit in row order wins), each candidate
    checked with ``us_is_valid_pos``, the winner mapped to its unitig, and
    heavy buckets resolved through the skew table. ``probe_start`` skips
    rows [0, probe_start) for every lane (the caller guarantees they were
    probed and missed). With the unitig set's ``uproj`` records the winner's
    unitig record also gives occ_word, occ_word2, occ_cnt and occ_start.

    ``mode="main"`` probes the first ``min(probe_bound, probe_limit)`` rows
    of each bucket and adds bool ``use_skew`` (a heavy bucket) and
    ``unresolved`` (rows past the probed depth, and the cases below), which
    the caller's compacted phases settle. Two probes:

    - with the ``useqrec`` window records (and, at ``probe_limit <= 3``,
      the ``bpos`` rows): one record per row carries the candidate's words
      and its unitig's extent, id and first two occurrence words. A
      candidate that spelled the query but failed the record's extent check
      (the reference's mt == 3 sentinel) leaves its lane unresolved. Adds
      occ_word, occ_word2 and occ_cnt.
    - otherwise one ``words2`` row pair per row. ``defer_valid`` drops the
      in-loop ``us_is_valid_pos`` and validates only the winner, with its
      rank (``us_validate_rank``): a failed winner clears the lane's hit and
      leaves it unresolved, and its ``pos`` keeps the winner's useq
      position. ``mphf_level_limit`` (fast32) runs the truncated MPHF
      chain: lanes it cannot place are unresolved and have no occurrences.
      With ``uproj``, adds occ_word, occ_word2, occ_cnt and occ_start.

    Unresolved lanes of the records, of ``defer_valid`` or of
    ``mphf_level_limit`` must be re-probed from row 0.

    On inline rows each row is one gather that also carries the unitig's
    id and extent, against which the candidates are checked; fused rows add
    occ_word, occ_cnt, occ_start and (inline2) occ_word2. ``defer_valid``
    changes nothing there."""
    m = d["meta"]
    us = d["us"]
    if m.pos_kind not in ("packed", "inline", "inline2") or \
            m.prefix_kind not in ("grouped16", "flat32", "ef"):
        raise ValueError("the port's SSHash query covers packed, inline and inline2 positions "
                         "with grouped16, flat32 or ef bounds")
    usrec = mode == "main" and probe_start == 0 and "useqrec" in us
    if defer_valid and mode != "main":
        raise ValueError("defer_valid is a main-mode contract: its caller re-probes failed lanes")
    k, w = m.k, m.w
    rc = revcomp(fw, k)
    mm, offset, _is_fw, canon = canonical_minimizer_batch(fw, k, w, m.seed, ordering=m.ordering)
    offset = offset.to(torch.int64)
    rc_offset = (k - w) - offset
    use_bpos = (
        "bpos" in d and mode == "main" and probe_start == 0 and probe_limit is not None
        and 0 < probe_limit <= d["bpos"].shape[1] - 1
    )
    mphf_unres = dead = None
    if m.direct_t:
        hc = fold_hash32(mm) & (m.direct_t - 1)
    else:
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
    else:
        ps, pe = _prefix_pair(d, hc)
        n_occs = pe - ps
    if dead is not None:
        n_occs = torch.where(dead, 0, n_occs)
    if m.skew_param >= 0:
        use_skew = n_occs > m.skew_param
    else:
        use_skew = torch.zeros_like(n_occs, dtype=torch.bool)
    last_km = us["meta"].total_len - k
    bound = m.probe_bound
    if mode == "main" and probe_limit is not None:
        bound = min(bound, int(probe_limit))
    if m.pos_kind != "packed":
        return _inline_k2u(d, fw, rc, canon, (offset, rc_offset), ps, n_occs, use_skew, bound,
                           mode, probe_start, mphf_unres)
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


def _inline_k2u(d: dict, fw, rc, canon, offsets, ps, n_occs, use_skew, bound: int, mode: str,
                probe_start: int, mphf_unres) -> dict:
    """``sshash_k2u`` on inline or inline2 rows (the reference's
    ``probe_body_inline``/``probe_body_inline2``): rows [probe_start, bound)
    of each bucket, a block of rows at a time, first hit in row order; then
    the skew table in full mode. Fused rows add their occurrence fields
    (``occ_fields``), except in full mode on a fast32 index: its skew table
    (``skew_mphf``) carries none, so the projection of its skew lanes reads
    the offsets table (the reference reports them with no occurrences, C10)."""
    m = d["meta"]
    rows = d["pos"]["inline"]
    aligned = m.pos_kind == "inline2"
    fused, fused14 = fused_kind(m.pos_kind, rows.shape[1])
    last = max(rows.shape[0] - 1, 0)
    z = torch.zeros_like(fw)
    found = torch.zeros_like(fw, dtype=torch.bool)
    out = {"unitig_id": z, "unitig_len": z, "pos": z, "mt": torch.zeros_like(fw, dtype=torch.uint8)}
    if fused:
        out.update(occ_word=z, occ_oc=z)
        if aligned:
            out["occ_word2"] = z
    block = max(1, min(bound - probe_start, ROW_BUDGET // max(fw.shape[0], 1)))
    for j0 in range(probe_start, bound, block):
        js = torch.arange(j0, min(j0 + block, bound), device=fw.device)
        active = (js[None, :] < n_occs[:, None]) & ~use_skew[:, None]
        any_hit, win = inline_hits(rows[torch.clamp(ps[:, None] + js, 0, last)], active, fw, rc,
                                   offsets, m.k, m.w, aligned, fused, fused14)
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
