"""Run the port's main paths once on one CUDA card and check them.

    python3 chip_smoke.py [--mbp 50] [--cap-mbp 300] [--mphf-mbp 300]

Phases, each printing its own lines; any failure exits non-zero:

1. card check (fails without CUDA) and the card's name and power limit;
2. build of the four kernel sources from ``mazu_tpu_torch/csrc``, one nvcc
   each, run together (phases 3, 9 and 13 print the reports of the lab,
   second and third sources);
3. the lab kernels L1-L5 (``csrc/gather_lab.cu``) against their plain torch
   versions on the card at the labs' shapes, N=1, a ragged N and all-same
   indices, bit-identical; L1 also on an unaligned index view, all-0 and
   all-(M-1) indices each called twice, ragged tables (M = 37, 2^18 - 1,
   2^18 + 1) and inputs written by the kernels just before it (its
   launch overlaps theirs), and L1's frozen first design (``sector_reads``)
   at the lab's shape; L3 and L4 also on ``xor_cases`` (ragged sizes
   around a 32-index group, fewer rows than warps, 3 x the warps + 5,
   only row 0, only row T - 1, pairs that cancel to zero; each called
   twice in a row); then the two lab entry points
   (``mazu_tpu_torch.labs.gather_probe`` and ``dma_lab``) as their main
   path; each kernel timed beside its plain version, its bound and the
   torch call that computes the same (``tbl[idx]``, ``index_select``), L1
   in turns with ``sector_reads``;
   the rates L1, L3 and L4 reach from L2 on larger batches (L1: 2^24
   random 4-byte reads of the 1 MB table; L3, L4: 2^21 random 512-byte rows
   of the 8 MB table); the card's L2 read rate, from ``l2_stream`` (an 8 MB
   and a 32 MB table read ~2 GB a launch with loads that no L1 serves, in
   order and in random orders), beside torch's ``.sum()`` over stride-0
   views as a cross-check, and L1's, L3's and L4's L2 floors at it, and
   whether any L3/L4 rate of the run exceeds it; the L2's random-sector
   rate, from ``l2_sectors`` (random 4-byte words of a 1 MB and an 8 MB
   table that no L1 serves), and L1's sector floor at it; then the card's
   random-read rates from device memory: ``sector_reads`` over a 1 GB
   table of u32 (2^22 random 4-byte reads: sectors/s; L1 on the same
   beside it) and L5 over a 1 GB table of 512-byte rows (2^18 random
   rows), all bit-identical to their plain versions;
4. the synthetic mono2-occ32 KCDict index (random genome, k=31, 10 kb
   unitigs, every 16th unitig with 3 occurrences, load 0.25), moved to the
   card, where its main table takes K1's 64-byte rows;
5. the mono2 kernel (K1) against its plain torch version on the card, all
   nine fields bit-identical: the adversarial batches of ``k1_cases``
   (ragged sizes around the 256-lane block and 2^20 + 37, foreign words,
   side-table, slot-1 and khi-bit-31 keys, the last occupied row, words
   whose bucket is row T - 1, all-A and all-T), then 2^20 queries (uniform over
   the index, half reverse-complemented, 5% foreign); both timed; the DRAM
   sectors and 64-byte blocks of a lane's row in the reference's 56-byte
   rows and in the card's 64-byte rows, and the floors they give;
6. the mono2 main path: ``OneGraphIndexQuery.checksum_pass_rolled`` over
   16 rolled chunks of that batch, checked against the port's plain path
   on CPU tensors for chunk 0. Before it, ``TwoPhaseIndexQuery``'s
   ``checksum_query`` and ``query`` (K1 in the main phase) and
   ``get_ref_pos_csr`` on the whole batch, each equal to the same on CPU
   tensors. The pass runs as one CUDA graph (its first run: an eager
   warm-up, the capture, a replay; the capture's seconds and memory pool
   printed) and eagerly, the two checksums equal to each other and to 16
   x the oracle, then 7 passes of each timed in turns (median, min, max);
   a tensor derived from the index first asked for inside a capture must
   raise;
6a. the serve pass (``bench.py::run_serve``'s device half,
   ``index.pipeline.RunServePass``) on that index: its color classes and
   bitsets (host seconds, classes, W, bytes on the card); 8 x 2,048 reads
   of 150 bases (``synth.serve_reads``, seed 1: uniform starts over the
   whole genome, half reverse-complemented, 1 in 100 with an N, 1 in 20
   foreign) written to a gzipped FASTQ and packed; the port's plain pass on
   CPU tensors gives every chunk's (map, pa, overflow) and sizes M2 from
   chunk 0 as run_serve does; the pass as one CUDA graph (capture seconds,
   pool bytes, K1's launches) and eagerly, both equal to the oracle chunk
   for chunk, and again with chunks 0 and 1 swapped; 3 passes of each timed
   in turns, end to end (FASTQ parse and pack, upload, pass, read-back)
   and the device pass alone, in read k-mers/s; chunk 0 through the union
   and threshold (tau 0.7) policies and the class ids, card against CPU,
   and the host threshold count against the device count;
6b. the validation oracles on the card: ``validate_self`` over every k-mer
   of the 5,000 references through ``get_ref_pos_compact(merge=True)`` in
   chunks of 2^20 (K1 in the main phase), ``validate_fasta`` on a FASTA of
   the first 64 references, ``validate_k2u_self`` through ``k2u_batch``,
   each timed; then the index leaves the card;
7. the pufferfish dense index (PFHash over a 64-bit BooPHF, the pf1
   occurrence table) over phase 4's genome, its MPHF lookup on the card;
   the 64-bit ``boophf_lookup`` on the card against the CPU on phase 5's
   2^20 canonical words; the padded path (``get_ref_pos_padded`` and
   ``bench.py``'s full-mode checksum) on phase 5's batch: a CPU oracle for
   chunk 0 that must hit every sampled lane at its sampled unitig and
   offset, then 16 rolled chunks on the card, replayed as one CUDA graph
   and run eagerly, both equal to 16 x the oracle, 3 passes of each timed
   in turns;
8. the same for pufferfish's sparse index (SampledPFHash, sample 9,
   extension 4);
9. the bpos probe kernel's (K2) ptxas report;
10. the synthetic capacity index: an SSHash direct engine (w=15, skew 64,
    load 0.5) over a random genome with a planted skew bucket, its
    minimizer scan on the card; grouped16 bounds, packed positions, bpos
    rows and useqrec window records;
11. K2 against its plain torch version on the card, all nine fields
    bit-identical: N=1, N=257 with a foreign word and a skew lane, probe
    limits 1-3, then 2^20 queries; then the adversarial batches of a tiled
    kernel (``tile_cases``) at probe limits 1-3; both timed; its DRAM
    sectors and sector floor;
12. the capacity path: ``OneGraphIndexQuery.checksum_pass_rolled`` over 8
    rolled chunks of 2^20 queries at probe limit 2, middle phase 4; the
    port's plain path on CPU tensors gives chunk 0's oracle, which must hit
    every sampled lane at its sampled unitig and offset; replayed and
    eager as in phase 6, 3 passes of each; then ``TwoPhaseIndexQuery`` (K2
    in the main phase) and ``get_ref_pos_compact`` on these arrays without
    bpos rows and window records (K3 on the direct layout, the main phase
    projected through the offsets table), each equal to CPU tensors';
13. the capacity probe kernel's (K3) ptxas report;
14. K3 on the direct layout: phase 10's arrays on the card without bpos and
    useqrec, plus the per-unitig ``uproj`` records; against its plain
    torch version, all ten fields bit-identical, at probe limits 1-3 on
    N=1, N=257, 2^20 and phase 11's adversarial batches; both timed;
15. the synthetic MPHF index: an SSHash fast32 engine (BooPHF32 minimizer
    MPHF, w=19, skew 64, gamma 1.7) over a random genome with a planted
    skew minimizer, its minimizer scan and MPHF lookup on the card;
    grouped16 bounds, packed positions, paired arrays, uproj records;
16. K3 against its plain version on the MPHF index, all ten fields
    bit-identical, at MPHF level limits None and 4 and probe limits 1-3:
    N=1, N=257 (a skew lane, a foreign word, all-T, k-mers read across
    unitig boundaries) and 2^20; then the adversarial batches, with a tile
    that the one-level chain cannot place and the lanes that reach the
    final-hash table, at level limits None, 4, 2 and 1; both timed, its L2 and
    DRAM sectors and sector floor, and K3 at other level limits;
17. the MPHF path: ``OneGraphIndexQuery.checksum_pass_rolled`` over 8
    rolled chunks of 2^20 queries at probe limit 2, level limit 4,
    deferred validation, middle phase 4, checked against a CPU oracle and
    replayed and eager as in phase 12;
18. one profiled replayed pass and one profiled eager pass of each of the
    paths of phases 6 and 6a (its index moved to the card again; the serve
    pass's device pass alone), 7, 8, 12 and 17: device busy share and the kernels that take the time. It runs last
    because a profiler session slows the host's launches for the rest of
    the process (measured: the MPHF pass took 1.6-2x longer after one).

Each kernel's ``bound_ms`` is the least time the card could take for the
same work: the bytes it must move (each input read once, only the rows a
lane reads; each output written once) over 3.35 TB/s, or its integer
operations over 67 T/s where that is larger. K1's, K2's and K3's
``sector_floor_ms`` is the DRAM sectors their lanes touch over phase 3's
random-sector rate (K1's ``block_floor_ms``: its 64-byte blocks at the
same rate). L1's, L3's and L4's ``large_batch_ms`` is their work at the
rate the same kernel reaches from L2 on phase 3's larger batch: it shows
the launch and tail share, and is no floor, since the kernel's own costs
set it. Their ``l2_floor_ms`` is: the bytes they move through the L2 (a
32-byte sector per random 4-byte read, 512 bytes per row, and the index
and output streams) over the L2 read rate of phase 3, which
``l2_stream`` sets. L1's ``sector_floor_ms`` is its N random reads at the
L2's random-sector rate (``l2_sectors``) plus its 8N bytes of index and
output streams at that read rate; its ``before_ms`` is its frozen first
design's time in the same turns. A kernel's ``launches`` on a path run as a
graph count the eager warm-up's and the captured launches: a replay
adds none; K1's are those of phase 6's and phase 6a's first replayed
passes. The last two lines are the kernels' JSON record and the result
JSON. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

from mazu_tpu_torch._words import mask32, umin
from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index.modindex import (
    QueryIndex, build_uproj, get_ref_pos_compact, get_ref_pos_csr, get_ref_pos_padded,
    k2u_batch, merge_compact_k2u,
)
from mazu_tpu_torch.index.pipeline import (
    OneGraphIndexQuery, RunServePass, checksum_padded_rolled, padded_checksum, serve_buffer,
)
from mazu_tpu_torch.index.pseudoalign import (
    classify_kmers, color_bitsets, count_threshold_host, pseudoalign_batch,
    pseudoalign_threshold_batch, tau_q32,
)
from mazu_tpu_torch.index.validate import validate_fasta, validate_k2u_self, validate_self
from mazu_tpu_torch.io.reads import kmerize_device, pack_fastq, pack_reads
from mazu_tpu_torch.index.twophase import TwoPhaseIndexQuery
from mazu_tpu_torch.ops.derived import derived
from mazu_tpu_torch.kmer import canonical_minimizer_batch, mask2k, revcomp, revcomp_np
from mazu_tpu_torch.kphf.boophf import boophf_lookup
from mazu_tpu_torch.kphf.boophf32 import (
    _C2, _GOLD, chain_next, fold_hash32, fold_hash32_np, key_fold32, mix32_np, unmix32_np,
)
from mazu_tpu_torch.kphf.kcdict import SLOTS, SW, kcdict_k2u
from mazu_tpu_torch.kphf.sshash import _pos_get, _prefix_pair, mphf_lookup, sshash_k2u
from mazu_tpu_torch.labs import cuda_ms, dma_lab, gather_probe
from mazu_tpu_torch.ops import bpos_probe, capacity_probe, gather_lab, mono2_probe
from mazu_tpu_torch.ops.cuda_build import compile_all
from mazu_tpu_torch import synth

BATCH = 1 << 20
CH = 16
PASSES = 7  # timed passes of the mono2 main path
CAP_CH = 8  # rolled chunks per capacity pass (bench.py:366)
PLIM, PLIM2 = 2, 4  # capacity probe limits: main phase, middle phase
FIELDS = ("unitig_id", "unitig_len", "pos", "occ_cnt", "mt", "occ_word", "occ_word2",
          "use_skew", "unresolved")
FIELDS3 = FIELDS + ("occ_start",)  # K3 with uproj records
MLIM = synth.MPHF_QUERY["mphf_level_limit"]  # the MPHF path's main-phase level limit
HBM_BPS = 3.35e12  # H100 SXM device memory, bytes/s
INT_OPS = 67e12  # H100 SXM non-tensor rate (the guide's float32 figure), operations/s
K2U_OUT = 6 * 8 + 3  # bytes of a lane's nine K1/K2 outputs (six int64, three u8/bool)
SERVE_PASSES = 3  # timed serve passes of each kind
TAU = 0.7  # the threshold policy's fraction on chunk 0
VALIDATE_CHUNK = 1 << 20


def log(*a):
    print(*a, flush=True)


def bound(n_bytes: float, n_ops: float = 0.0) -> tuple[float, str]:
    """(milliseconds, what bounds it): the larger of ``n_bytes`` over the
    card's memory rate and ``n_ops`` over its integer rate."""
    t_bytes, t_ops = n_bytes / HBM_BPS * 1e3, n_ops / INT_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def record(name: str, source: str, replaces: str, launches: int, max_err: int, ms: float,
           plain_ms: float, bound_ms: tuple[float, str], library_ms=None, **extra) -> dict:
    """One kernel's entry of the kernels line (``extra``: the floors, K1-K3's
    and L1's ``sector_floor_ms``, K1's ``block_floor_ms``, L1/L3/L4's
    ``large_batch_ms`` and ``l2_floor_ms``, L1's ``before_ms``)."""
    return {
        "name": name, "route": "cuda", "source": f"mazu_tpu_torch/csrc/{source}",
        "replaces": replaces, "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms[0], "bound_by": bound_ms[1],
        "library_ms": library_ms, **extra,
    }


def distinct(ids: torch.Tensor) -> torch.Tensor:
    """The distinct ids >= 0 in each row of ``ids`` [N, m] (-1 pads)."""
    s = torch.sort(ids, dim=1).values
    new = torch.ones_like(s, dtype=torch.bool)
    new[:, 1:] = s[:, 1:] != s[:, :-1]
    return ((s >= 0) & new).sum(dim=1)


def sector_ids(lo: torch.Tensor, n_bytes: int, on: torch.Tensor, size: int = 32) -> list:
    """Ids of the ``size``-byte sectors of the bytes [lo, lo + n_bytes), -1
    where ``on`` is false or past the range's last sector."""
    first, last = lo // size, (lo + n_bytes - 1) // size
    return [torch.where(on & (first + t <= last), first + t, -1)
            for t in range((n_bytes + 2 * size - 2) // size)]


def compare_k2u(d: dict, fw: torch.Tensor, what: str, kernel=None, plain=None,
                fields=FIELDS) -> int:
    """Kernel vs plain version on the same card tensors (by default K1 and
    ``kcdict_k2u``); every field must be bit-identical. Returns the max
    absolute difference (0)."""
    got = (kernel or mono2_probe.mono2_k2u)(d, fw)
    want = (plain or (lambda d_, f_: kcdict_k2u(d_, f_, mode="main")))(d, fw)
    if set(got) != set(want) or not set(fields) <= set(got):
        raise AssertionError(f"{what}: fields {sorted(got)} / {sorted(want)}, expected {fields}")
    err = 0
    for key in fields:
        g, w = got[key], want[key]
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{what}: {key} is {g.dtype}{tuple(g.shape)}, "
                                 f"plain gives {w.dtype}{tuple(w.shape)}")
        diff = int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if g.numel() else 0
        err = max(err, diff)
        if not torch.equal(g, w):
            raise AssertionError(f"{what}: kernel and plain version differ in {key}")
    return err


def tile_cases(work: np.ndarray, skew: torch.Tensor, us, k: int, tile: int) -> dict:
    """Adversarial batches for a tiled kernel (``tile`` lanes a block):
    2^20 + 37 lanes; the tile size -1, exactly and +1; a tile of one key;
    tiles of skew lanes only and of foreign k-mers only; and the 200
    boundary k-mers (deferred winners that fail validation, K2's mt == 3
    sentinel)."""
    skew_words = work[torch.nonzero(skew)[:, 0].cpu().numpy()]
    rng = np.random.default_rng(8)
    return {
        f"N={len(work)}+37": np.concatenate([work, work[:37]]),
        f"N={tile - 1}": work[: tile - 1],
        f"N={tile}": work[:tile],
        f"N={tile + 1}": work[: tile + 1],
        "one key": np.full(tile, work[0]),
        "skew only": np.resize(skew_words, tile),
        "foreign only": rng.integers(0, 1 << (2 * k), tile, dtype=np.uint64),
        "200 boundary": synth.sample_boundary_queries(us, 200, seed=6),
    }


def k1_cases(k2u: dict, work: np.ndarray, tile: int = mono2_probe.TILE, seed: int = 8) -> dict:
    """Adversarial batches for K1 on a host mono2 dict ``k2u`` (NumPy, the
    reference's [T, 14] table): ragged sizes around the ``tile``-lane
    block and 2^20 + 37 lanes; tiles of foreign words, of side-table keys
    (``unresolved`` in main mode), of slot-1 keys, of keys whose slot has
    bit 31 of khi set, of the keys of the last occupied row, and of words
    whose bucket is row T - 1 (its keys where it holds any, then foreign
    words made to hash there), each half reverse-complemented; all-A and
    all-T."""
    table, k, t = k2u["table"], k2u["meta"].k, k2u["meta"].t
    rng = np.random.default_rng(seed)
    u64, u32 = np.uint64, np.uint32

    def keys(tbl, rows, slot):
        c = slot * SW
        return tbl[rows, c].astype(u64) | ((tbl[rows, c + 1] & u32(0x7FFFFFFF)).astype(u64)
                                           << u64(32))

    def row_keys(row):
        return np.concatenate([keys(table, [row], s) for s in range(SLOTS)
                               if table[row, s * SW] != 0xFFFFFFFF] + [np.zeros(0, u64)])

    def both_ways(words):
        words = np.resize(words, tile)
        flip = rng.random(tile) < 0.5
        words[flip] = revcomp_np(words[flip], k)
        return words

    def to_last_row(n):
        # fold_hash32 = mix32(lo ^ GOLD) ^ mix32(hi + C2): pick hi, then the
        # low word whose mix completes the bucket T - 1; keep canonical words
        hi = rng.integers(0, 1 << (2 * k - 32), n, dtype=u64).astype(u32)
        want = (mix32_np(hi + u32(_C2)) ^ u32(t - 1)) & u32(t - 1)
        mixed = (rng.integers(0, 1 << 32, n, dtype=u64).astype(u32) & ~u32(t - 1)) | want
        words = (hi.astype(u64) << u64(32)) | (unmix32_np(mixed) ^ u32(_GOLD)).astype(u64)
        words = words[words <= revcomp_np(words, k)]
        if not (fold_hash32_np(words) & u32(t - 1) == t - 1).all():
            raise AssertionError("words made for row T - 1 hash elsewhere")
        return words

    occ0 = np.flatnonzero(table[:, 0] != 0xFFFFFFFF)
    occ1 = np.flatnonzero(table[:, SW] != 0xFFFFFFFF)
    bit31 = occ0[(table[occ0, 1] >> 31) == 1][:tile]
    last = int(max(occ0[-1], occ1[-1] if len(occ1) else -1))
    cases = {
        "N=1": work[:1],
        f"N={tile - 1}": work[: tile - 1],
        f"N={tile}": work[:tile],
        f"N={tile + 1}": work[: tile + 1],
        f"N={len(work)}+37": np.concatenate([work, work[:37]]),
        "foreign only": rng.integers(0, 1 << (2 * k), tile, dtype=u64),
        "slot-1 keys": both_ways(keys(table, occ1[:tile], 1)),
        "khi bit 31 keys": both_ways(keys(table, bit31, 0)),
        f"row {last} (last occupied)": both_ways(row_keys(last)),
        f"row T - 1 = {t - 1} ({len(row_keys(t - 1))} keys)": both_ways(
            np.concatenate([row_keys(t - 1), to_last_row(tile)])),
        "all-A": np.zeros(tile, dtype=u64),
        "all-T": np.full(tile, mask2k(k), dtype=u64),
    }
    if "side" in k2u:
        side = k2u["side"]
        cases["side-table keys"] = both_ways(np.concatenate(
            [keys(side, np.flatnonzero(side[:, s * SW] != 0xFFFFFFFF), s) for s in range(SLOTS)]))
    return cases


def row_spans(k2u: dict, fw: torch.Tensor, row_bytes: int) -> tuple[int, int]:
    """(32-byte sectors, 64-byte blocks) that the bucket rows of ``fw``
    span, summed over the lanes, for rows of ``row_bytes`` at
    ``h * row_bytes``."""
    m = k2u["meta"]
    lo = (fold_hash32(umin(fw, revcomp(fw, m.k))) & (m.t - 1)) * row_bytes
    hi = lo + row_bytes - 1
    return tuple(int((hi // size - lo // size + 1).sum()) for size in (32, 64))


def compare_cases(tag: str, d: dict, cases: dict, runs, dev) -> int:
    """Every case of ``cases`` through every (label, kernel, plain, fields)
    of ``runs``, bit-identical; returns the max absolute difference (0)."""
    err = 0
    for name, words in cases.items():
        fw = torch.from_numpy(np.ascontiguousarray(words).view(np.int64)).to(dev)
        for label, kern, plain, fields in runs:
            err = max(err, compare_k2u(d, fw, f"{tag} {name} {label}", kern, plain, fields))
    log(f"[{tag}] {'; '.join(cases)} at {', '.join(r[0] for r in runs)}: bit-identical")
    return err


def card() -> tuple[torch.device, str]:
    """The CUDA device, and its name and power limit as nvidia-smi gives
    them; exits without a card."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs only on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    return torch.device("cuda", 0), smi


def reset_launches():
    """Set every kernel's launch count to 0 (just before a main path)."""
    for mod in (mono2_probe, bpos_probe, capacity_probe):
        mod.LAUNCHES = 0
    for name in gather_lab.LAUNCHES:
        gather_lab.LAUNCHES[name] = 0


def kernel_name(mangled: str) -> str:
    """The ``*_kernel`` name inside a mangled symbol (a length-prefixed
    identifier)."""
    for m in re.finditer(r"(?=(\d+))", mangled):
        start = m.start() + len(m.group(1))
        name = mangled[start : start + int(m.group(1))]
        if name.endswith("_kernel"):
            return name
    return mangled


def ptxas_lines(report: str):
    """ptxas's register, shared-memory and spill lines, each after the
    kernel it describes."""
    out = []
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            out.append(f"kernel {kernel_name(m.group(1))}:")
        elif "registers" in ln or "spill" in ln:
            out.append(ln.strip())
    return out


def fit(c) -> int:
    """A capacity covering ``c`` lanes, rounded up (bench.py:377)."""
    return max(1024, -(-(int(c) + 256) // 1024) * 1024)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mbp", type=float, default=50.0, help="mono2 genome size in Mbp")
    ap.add_argument("--cap-mbp", type=float, default=300.0, help="capacity genome size in Mbp")
    ap.add_argument("--mphf-mbp", type=float, default=300.0, help="MPHF genome size in Mbp")
    args = ap.parse_args()

    # 1. card
    dev, smi = card()

    # 2. kernel builds, one nvcc per source, together
    t0 = time.perf_counter()
    (lib, ptxas), (lib2, ptxas2), (lib3, ptxas3), (lib4, ptxas4) = compile_all(
        [mono2_probe.SOURCE, bpos_probe.SOURCE, capacity_probe.SOURCE, gather_lab.SOURCE])
    log(f"[build] {lib.name}, {lib2.name}, {lib3.name} and {lib4.name} in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in ptxas_lines(ptxas):
        log(f"[build] {line}")

    # 3. the lab kernels, and the card's random-read rates from device memory
    labs, sector_rate = lab_kernels(dev, smi, lib4.name, ptxas4)

    # 4. index
    t0 = time.perf_counter()
    n_bases = int(args.mbp * 1e6)
    genome = synth.synthetic_spt(n_bases, seed=0)
    index = synth.build_index(n_bases, seed=0, genome=genome)
    host = index.device_arrays()
    m = host["k2u"]["meta"]
    if not (m.scheme == "mono2" and m.occ32):
        raise AssertionError(f"index is {m.scheme} occ32={m.occ32}, not mono2-occ32")
    t_build = time.perf_counter() - t0
    cpu_index = QueryIndex(arrays_from_numpy(host, "cpu"))
    t0 = time.perf_counter()
    gpu_index = QueryIndex(arrays_from_numpy(host, "cpu")).to(dev)
    torch.cuda.synchronize()
    us = index.k2u.unitigs
    log(f"[index] {us.total_len} bases, {us.n_unitigs} unitigs, {us.n_kmers} k-mers; "
        f"T={m.t} buckets, side T={m.side_t}; max_occs={gpu_index.max_occs}")
    log(f"[index] host build {t_build:.1f} s; to card {time.perf_counter() - t0:.1f} s; "
        f"{gpu_index.nbytes()} bytes on the card")
    d = gpu_index.arrays()
    table = d["k2u"]["table"]
    log(f"[index] main table on the card: {table.dtype} {tuple(table.shape)}, "
        f"{table.numel() * 4} bytes (host: {host['k2u']['table'].shape}, "
        f"{host['k2u']['table'].nbytes} bytes)")

    # 5. kernel vs plain version
    truth = synth.sample_queries_truth(us, BATCH, seed=1)
    work = truth[0]
    fw = torch.from_numpy(work.view(np.int64)).to(dev)
    cases = k1_cases(host["k2u"], work)
    max_err = compare_cases("k1 tiles", d["k2u"], cases, [("main", None, None, FIELDS)], dev)
    # the tiles hold what they name
    last_row = next(n for n in cases if n.endswith("(last occupied)"))
    row_t1 = next(n for n in cases if n.startswith("row T - 1"))
    words = torch.from_numpy(cases[row_t1].view(np.int64)).to(dev)
    if not bool((fold_hash32(umin(words, revcomp(words, m.k))) & (m.t - 1) == m.t - 1).all()):
        raise AssertionError(f"k1 tile {row_t1!r}: a lane's bucket is not row T - 1")
    for name, want_unres in (("foreign only", True), ("side-table keys", True),
                             ("slot-1 keys", False), ("khi bit 31 keys", False),
                             (last_row, False)):
        words = torch.from_numpy(np.ascontiguousarray(cases[name]).view(np.int64)).to(dev)
        r = kcdict_k2u(d["k2u"], words, mode="main")
        if not bool((r["unresolved"] == want_unres).all()):
            raise AssertionError(f"k1 tile {name!r}: not every lane is "
                                 f"{'unresolved' if want_unres else 'resolved'} in main mode")
        if name != last_row and not want_unres and set(r["mt"].tolist()) != {1, 2}:
            raise AssertionError(f"k1 tile {name!r}: mt {sorted(set(r['mt'].tolist()))}")
    max_err = max(max_err, compare_k2u(d["k2u"], fw, f"N={BATCH}"))
    k1_ms = cuda_ms(lambda: mono2_probe.mono2_k2u(d["k2u"], fw), 20)
    plain_ms = cuda_ms(lambda: kcdict_k2u(d["k2u"], fw, mode="main"), 5)
    log(f"[k1] N={BATCH}: bit-identical on all nine fields; kernel {k1_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms ({smi})")
    # the work: the key, one 56-byte row (the reference's two slots, whatever
    # the card's layout) and the nine outputs a lane
    k1_bound = bound(BATCH * (8 + 4 * 2 * SW + K2U_OUT))
    # the floors of the card's layout, the last, go into the kernels line
    for label, row_bytes in (("the reference's", 4 * 2 * SW),
                             ("the card's", 4 * mono2_probe.ROW_WORDS)):
        sec, blk = row_spans(d["k2u"], fw, row_bytes)
        k1_floor, k1_block_floor = sec / sector_rate * 1e3, blk / sector_rate * 1e3
        log(f"[k1] {label} {row_bytes}-byte rows: {sec / BATCH:.4f} DRAM sectors and "
            f"{blk / BATCH:.4f} 64-byte blocks a lane: sector floor {k1_floor:.4f} ms, block "
            f"floor {k1_block_floor:.4f} ms ({smi})")
    log(f"[k1] bound {k1_bound[0]:.4f} ms ({k1_bound[1]}); kernel at {k1_bound[0] / k1_ms:.1%} of "
        f"its bound, {k1_ms / k1_block_floor:.2f}x its block floor; no single torch call "
        f"computes the probe ({smi})")

    # 6. main path
    t0 = time.perf_counter()
    work_cpu = torch.from_numpy(work.view(np.int64))
    # this workload overflows ~13% of lanes (5% foreign, ~6% 3-occurrence
    # unitigs, ~2% side-table keys): size the oracle at N/4
    out0 = get_ref_pos_compact(cpu_index.arrays(), work_cpu, cpu_index.max_occs, merge=False,
                               m2=BATCH // 4)
    if bool(out0["over_budget"]):
        raise AssertionError("CPU oracle over budget")
    host_chk = int(OneGraphIndexQuery.checksum(out0))
    n_ovf = int(out0["n_ovf"])
    M2 = max(1024, -(-(n_ovf + 128) // 256) * 256)
    log(f"[main] CPU oracle {time.perf_counter() - t0:.1f} s: chunk checksum {host_chk}, "
        f"overflow {n_ovf}/{BATCH} = {n_ovf / BATCH:.4f} -> M2={M2}")

    # small-input agreement of the merged two-phase query on the card with
    # the exact padded query on the CPU (padding slots masked by valid)
    got = get_ref_pos_compact(d, fw[:4096], gpu_index.max_occs, merge=True, m2=4096)
    want = get_ref_pos_padded(cpu_index.arrays(), work_cpu[:4096], cpu_index.max_occs)
    for key in ("unitig_id", "unitig_len", "pos", "mt", "n_occs", "valid",
                "ref_id", "ref_pos", "orient"):
        g, w = got[key].cpu(), want[key]
        if g.dim() == 2:
            g, w = torch.where(want["valid"], g, 0), torch.where(want["valid"], w, 0)
        if not torch.equal(g, w):
            raise AssertionError(f"merged compact query on the card differs from padded CPU in {key}")
    log("[main] merged compact query on 4096 lanes equals the padded CPU query")
    del got, want

    # the two-phase and CSR drivers on the card against CPU tensors
    mono2_drivers(cpu_index, gpu_index, work, fw)
    del cpu_index, out0

    og = OneGraphIndexQuery(gpu_index, BATCH, n_chunks=CH, m2=M2)
    og_eager = OneGraphIndexQuery(gpu_index, BATCH, n_chunks=CH, m2=M2, graph=False)
    launches, worst, times = graph_and_eager(
        "main", gpu_index, og.checksum_pass_rolled, og_eager.checksum_pass_rolled, fw,
        CH * host_chk, BATCH * CH, PASSES, mono2_probe, smi)
    if worst > M2:
        raise AssertionError(f"worst overflow {worst} > M2 {M2}")
    derived_capture_raises(dev)
    del og, og_eager

    # 6a-6b. the serve pass and the validation oracles on this index
    with tempfile.TemporaryDirectory() as tmp:
        serve_launches, serve = serve_phase(index, host, gpu_index, dev, smi, tmp)
        validation_phase(index, gpu_index, dev, tmp)
    log(f"[main] mono2_probe launches: {launches} on the main path, {serve_launches} on the "
        f"serve pass")
    k1 = record("mono2_probe", "mono2_probe.cu", "mazu_tpu/ops/pallas_query.py:46",
                launches + serve_launches, max_err, k1_ms, plain_ms, k1_bound,
                sector_floor_ms=k1_floor, block_floor_ms=k1_block_floor)
    # the card's copy of the index goes now; phase 18 builds it again
    profile_mono2 = mono2_profile(host, fw, M2, times, serve)
    del gpu_index, d, table, r
    torch.cuda.empty_cache()

    # 7-8. the pufferfish dense and sparse paths over this genome
    profile_pf1 = [pf1_path(kind, genome, n_bases, truth, dev, smi) for kind in ("dense", "sparse")]
    del genome, index
    torch.cuda.empty_cache()

    # 9. K2 build report
    log(f"[k2 build] {lib2.name}")
    for line in ptxas_lines(ptxas2):
        log(f"[k2 build] {line}")

    k2, profile_cap = capacity(args, dev, smi, lib3.name, ptxas3, sector_rate)
    torch.cuda.empty_cache()
    k3, profile_mphf = mphf(args, dev, smi, sector_rate)

    # 18. profiled passes
    for profile in (profile_mono2, *profile_pf1, profile_cap, profile_mphf):
        profile()
    log(json.dumps({"kernels": [k1, k2, k3, *labs]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


def serve_phase(index, host: dict, gpu_index, dev, smi, tmp: str):
    """Phase 6a: ``bench.py::run_serve``'s device pass on the mono2 index
    over the synth50-serve traffic. Returns the mono2_probe launches of its
    first replayed pass and what phase 18 needs to profile it."""
    k, n_reads, n_ch = synth.K, synth.SERVE_READS, synth.SERVE_CHUNKS
    t0 = time.perf_counter()
    cc = index.color_classes()
    cb_host = color_bitsets(cc)
    cc_s = time.perf_counter() - t0
    cb, cb_cpu = arrays_from_numpy(cb_host, dev), arrays_from_numpy(cb_host, "cpu")
    log(f"[serve] color classes and bitsets in {cc_s:.2f} s on the host: {cc.n_classes} classes "
        f"over {cc.n_unitigs} unitigs and {cc.n_refs} references, W={cb_host['meta'].W}; "
        f"{tree_bytes(cb)} bytes on the card")

    t0 = time.perf_counter()
    reads = synth.serve_reads(index.refs, n_reads * n_ch, seed=1)
    fq = os.path.join(tmp, "reads.fastq.gz")
    synth.write_fastq(fq, reads)
    packed = pack_fastq(fq, k)
    m = packed["meta"]
    nq = sum(max(len(r) - k + 1, 0) for r in reads)
    log(f"[serve] {len(reads)} reads of {synth.READ_LEN} bases ({sum('N' in r for r in reads)} "
        f"with an N) written to a gzipped FASTQ and packed in {time.perf_counter() - t0:.2f} s: "
        f"{nq} read k-mers, has_bad={m.has_bad}, {serve_buffer(packed).nbytes} bytes to upload")

    # the oracle: the port's plain pass on CPU tensors, every chunk; chunk 0
    # sizes M2 as run_serve does (bench.py:209-211)
    t0 = time.perf_counter()
    cpu_index = QueryIndex(arrays_from_numpy(host, "cpu"))
    oracle = RunServePass(cpu_index, cb_cpu, n_reads, n_ch, max(8192, n_reads * m.L // 4),
                          synth.READ_LEN, probe_limit=PLIM, graph=False)(packed)
    M2 = max(2048, -(-int(oracle[2][0] * 1.4 + 1024) // 1024) * 1024)
    log(f"[serve] CPU oracle {time.perf_counter() - t0:.1f} s: chunk 0 map {oracle[0][0]}, pa "
        f"{oracle[1][0]}, overflow {oracle[2][0]} -> M2={M2}; worst overflow {max(oracle[2])}")

    sp = RunServePass(gpu_index, cb, n_reads, n_ch, M2, synth.READ_LEN, probe_limit=PLIM)
    sp_eager = RunServePass(gpu_index, cb, n_reads, n_ch, M2, synth.READ_LEN, probe_limit=PLIM,
                            graph=False)
    reset_launches()
    t0 = time.perf_counter()
    got = sp(packed)
    first_s = time.perf_counter() - t0
    launches = mono2_probe.LAUNCHES
    if launches == 0:
        raise AssertionError("[serve] the replayed pass never launched the mono2_probe kernel")
    cap = list(gpu_index.graphs.values())[-1]
    eager = sp_eager(packed)
    if not got == eager == oracle:
        raise AssertionError(f"[serve] replayed {got}, eager {eager}, CPU oracle {oracle}")
    log(f"[serve] first replayed pass {first_s:.3f} s (capture {cap.capture_s:.3f} s of it; graph "
        f"pool {cap.pool_bytes} bytes): {n_ch} chunks (map, pa, overflow) == eager == CPU oracle, "
        f"chunk for chunk; worst overflow {max(got[2])} <= M2 {M2}; mono2_probe launches "
        f"{launches} (the eager warm-up's and the captured)")
    # the graph reads its input buffer: chunks 0 and 1 swapped
    swapped = pack_reads(reads[n_reads : 2 * n_reads] + reads[:n_reads] + reads[2 * n_reads :], k)
    got2 = sp(swapped)
    if got2 != sp_eager(swapped) or [c[:2] for c in got2] != [[c[1], c[0]] for c in got]:
        raise AssertionError(f"[serve] with chunks 0 and 1 swapped the replayed pass gives {got2}")
    log("[serve] with chunks 0 and 1 swapped, replayed == eager, their results swapped")

    flat = torch.from_numpy(serve_buffer(packed)).to(dev)
    t = {kind: {"e2e": [], "device": []} for kind in ("graph", "eager")}
    for _ in range(SERVE_PASSES):
        for kind, run in (("graph", sp), ("eager", sp_eager)):
            t0 = time.perf_counter()
            res = run(pack_fastq(fq, k))
            t[kind]["e2e"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            dev_res = run.device_pass(flat, m)
            torch.cuda.synchronize()
            t[kind]["device"].append(time.perf_counter() - t0)
            if res != oracle or dev_res.T.tolist() != list(oracle):
                raise AssertionError(f"[serve] a timed {kind} pass differs from the oracle")
    for kind in ("graph", "eager"):
        for what, label in (("e2e", "end to end (FASTQ parse + pack + upload + pass)"),
                            ("device", "device pass alone")):
            rates = sorted(nq / x for x in t[kind][what])
            log(f"[serve] {kind} {label}, {SERVE_PASSES} in turns: median "
                f"{statistics.median(rates):.1f} read-kmers/s (min {rates[0]:.1f}, max "
                f"{rates[-1]:.1f}) ({smi})")

    # other policies on chunk 0, card against CPU
    t0 = time.perf_counter()
    d, d_cpu = gpu_index.arrays(), cpu_index.arrays()
    km, v = kmerize_device(arrays_from_numpy(packed, dev), 0, n_reads)
    km_c, v_c = kmerize_device(arrays_from_numpy(packed, "cpu"), 0, n_reads)
    num = tau_q32(TAU)
    for name, fn in (
        ("union", lambda a, c, x, y: pseudoalign_batch(a, c, x, y, "union")),
        (f"threshold {TAU} (device count)",
         lambda a, c, x, y: pseudoalign_threshold_batch(a, c, x, y, num)),
        ("classify", classify_kmers),
    ):
        g_out, c_out = fn(d, cb, km, v), fn(d_cpu, cb_cpu, km_c, v_c)
        if not all(torch.equal(a.cpu(), b) for a, b in zip(g_out, c_out)):
            raise AssertionError(f"[serve] {name} on chunk 0: the card differs from the CPU")
        if name == "classify":
            cid, hit = (x.cpu().numpy() for x in g_out)
        elif name.startswith("threshold"):
            bits = g_out[0].cpu().numpy().view(np.uint8)
    host_count = count_threshold_host(cc, cid, hit, v_c.numpy(), num)
    unpacked = np.unpackbits(bits, bitorder="little", axis=1)[:, : cc.n_refs]
    if any(not np.array_equal(refs, np.flatnonzero(unpacked[i]))
           for i, (refs, _, _) in enumerate(host_count)):
        raise AssertionError(f"[serve] threshold {TAU}: the host count differs from the device's")
    log(f"[serve] chunk 0 through union, threshold {TAU} (device count) and classify: card == "
        f"CPU; the host count of threshold {TAU} == the device count "
        f"({time.perf_counter() - t0:.1f} s)")
    del cpu_index, sp, sp_eager, run
    if any(key[0][0] == "serve" for key in gpu_index.graphs):
        raise AssertionError("[serve] the pass's graphs outlived it")
    log("[serve] the pass's graphs left the index with it")
    return launches, {"cb": cb, "flat": flat, "meta": m, "m2": M2,
                      "times": {kind: statistics.median(t[kind]["device"]) for kind in t}}


def validation_phase(index, gpu_index, dev, tmp: str):
    """Phase 6b: the validation oracles on the card over the whole index."""
    d, mo = gpu_index.arrays(), gpu_index.max_occs

    def query(w):
        # every k-mer of a unitig with 3 occurrences overflows the main
        # phase: a FASTA record of one such reference overflows whole
        return get_ref_pos_compact(d, w, mo, merge=True, m2=w.shape[0])

    refs = index.refs
    n_kmers = int(np.maximum(np.diff(refs.prefix_sum) - index.k + 1, 0).sum())
    reset_launches()
    t0 = time.perf_counter()
    validate_self(index, query_fn=query, chunk=VALIDATE_CHUNK, device=dev)
    self_s = time.perf_counter() - t0
    if mono2_probe.LAUNCHES == 0:
        raise AssertionError("[validate] validate_self never launched the mono2_probe kernel")
    log(f"[validate] validate_self: {n_kmers} k-mers of {refs.n_refs} references through "
        f"get_ref_pos_compact(merge=True) in chunks of {VALIDATE_CHUNK}, every one at its "
        f"(ref, pos), in {self_s:.1f} s (mono2_probe launches {mono2_probe.LAUNCHES})")
    fa = os.path.join(tmp, "refs64.fa")
    with open(fa, "w") as f:
        for i in range(64):
            s0, s1 = int(refs.prefix_sum[i]), int(refs.prefix_sum[i + 1])
            f.write(f">{refs.names[i]}\n{refs.seq.to_str(s0, s1)}\n")
    t0 = time.perf_counter()
    validate_fasta(index, fa, query_fn=query, device=dev)
    log(f"[validate] validate_fasta on the first 64 references: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    validate_k2u_self(index.k2u, k2u_fn=lambda w: k2u_batch(d, w), chunk=VALIDATE_CHUNK,
                      device=dev)
    log(f"[validate] validate_k2u_self: {index.k2u.unitigs.n_kmers} unitig k-mers, forward and "
        f"reverse, through k2u_batch: {time.perf_counter() - t0:.1f} s")


def same_query(tag: str, got, want):
    """Two ``TwoPhaseIndexQuery.query`` results (main rows, overflow lanes,
    overflow rows) hold the same arrays."""
    (r_g, l_g, s_g), (r_w, l_w, s_w) = got, want
    if not np.array_equal(l_g, l_w) or (s_g is None) != (s_w is None):
        raise AssertionError(f"[{tag}] query: the overflow lanes differ")
    for part, g, w in (("main", r_g, r_w), ("overflow", s_g or {}, s_w or {})):
        if set(g) != set(w) or not all(np.array_equal(g[kk], w[kk]) for kk in w):
            raise AssertionError(f"[{tag}] query: the {part} rows differ")


def twophase_on_card(tag: str, gpu_index, cpu_index, work: np.ndarray, probe, **kw):
    """``TwoPhaseIndexQuery.checksum_query`` and ``.query`` on the card
    (its main phase launching ``probe``'s kernel) against the same on the
    CPU copy of the index."""
    fw = torch.from_numpy(work.view(np.int64))
    tp, tp_cpu = TwoPhaseIndexQuery(gpu_index, **kw), TwoPhaseIndexQuery(cpu_index, **kw)
    tp.checksum_query(fw.to(tp.device))  # warm
    reset_launches()
    t0 = time.perf_counter()
    got = tp.checksum_query(fw.to(tp.device))
    card_s = time.perf_counter() - t0
    if probe.LAUNCHES == 0:
        raise AssertionError(f"[{tag}] checksum_query never launched the {probe.SOURCE.stem} kernel")
    want = tp_cpu.checksum_query(fw)
    if got != want:
        raise AssertionError(f"[{tag}] checksum_query on the card {got}, on the CPU {want}")
    same_query(tag, tp.query(work), tp_cpu.query(work))
    log(f"[{tag}] TwoPhaseIndexQuery on {len(work)} queries: checksum_query (checksum, overflow "
        f"lanes) {got} on the card == CPU, {card_s * 1e3:.1f} ms on the card with "
        f"{probe.SOURCE.stem} launches {probe.LAUNCHES}; query's main and overflow rows == CPU")


def mono2_drivers(cpu_index, gpu_index, work: np.ndarray, fw: torch.Tensor):
    """Phase 6's drivers beside the pass: ``TwoPhaseIndexQuery`` (K1 in its
    main phase) and ``get_ref_pos_csr`` on the whole batch, each against
    the port's path on CPU tensors."""
    twophase_on_card("main twophase", gpu_index, cpu_index, work, mono2_probe)
    work_cpu = torch.from_numpy(work.view(np.int64))
    t0 = time.perf_counter()
    want = get_ref_pos_csr(cpu_index.arrays(), work_cpu, 1)
    total = int(want["total"])
    want = get_ref_pos_csr(cpu_index.arrays(), work_cpu, total)
    cpu_s = time.perf_counter() - t0
    got = get_ref_pos_csr(gpu_index.arrays(), fw, total)
    bad = [kk for kk in want if not torch.equal(got[kk].cpu(), want[kk])]
    if bad or int(got["valid"].sum()) != total:
        raise AssertionError(f"[main csr] get_ref_pos_csr on the card differs from the CPU in {bad}")
    log(f"[main csr] get_ref_pos_csr of {fw.shape[0]} queries, budget = total = {total} "
        f"occurrences: every field on the card == CPU ({cpu_s:.1f} s on the CPU)")


def capacity_drivers(cpu_index, gpu_index, work: np.ndarray, fw: torch.Tensor):
    """Phase 12's drivers beside the pass: ``TwoPhaseIndexQuery`` (K2 in its
    main phase), and ``get_ref_pos_compact`` on the capacity index without
    bpos rows and window records (K3 on the direct layout, the main phase
    projected through the offsets table), each against the port's path on
    CPU tensors."""
    twophase_on_card("cap twophase", gpu_index, cpu_index, work, bpos_probe, probe_limit=PLIM)

    def bare(d):
        k2u = {kk: v for kk, v in d["k2u"].items() if kk != "bpos"}
        k2u["us"] = {kk: v for kk, v in k2u["us"].items() if kk != "useqrec"}
        return {**d, "k2u": k2u}

    kw = dict(merge=False, m2=BATCH // 4, probe_limit=PLIM, m2b=BATCH // 4, defer_valid=True,
              probe_limit2=PLIM2, m2c=BATCH // 16)
    mo = gpu_index.max_occs
    want = get_ref_pos_compact(bare(cpu_index.arrays()), torch.from_numpy(work.view(np.int64)), mo,
                               **kw)
    reset_launches()
    got = get_ref_pos_compact(bare(gpu_index.arrays()), fw, mo, **kw)
    chk, want_chk = int(OneGraphIndexQuery.checksum(got)), int(OneGraphIndexQuery.checksum(want))
    if capacity_probe.LAUNCHES == 0:
        raise AssertionError("[cap offsets] the main phase never launched the capacity_probe kernel")
    if bool(want["over_budget"]) or bool(got["over_budget"]) or chk != want_chk:
        raise AssertionError(f"[cap offsets] checksum on the card {chk}, on the CPU {want_chk}")
    k2u_g, k2u_w = merge_compact_k2u(got), merge_compact_k2u(want)
    for kk in k2u_w:
        if not torch.equal(k2u_g[kk].cpu(), k2u_w[kk]):
            raise AssertionError(f"[cap offsets] merged {kk} on the card differs from the CPU")
    for kk in ("n_occs", "valid", "ref_id", "ref_pos"):
        if not torch.equal(got["main"][kk].cpu(), want["main"][kk]):
            raise AssertionError(f"[cap offsets] main-phase {kk} on the card differs from the CPU")
    log(f"[cap offsets] get_ref_pos_compact without bpos, useqrec or uproj (main phase through "
        f"_project_offsets): checksum {chk} and merged fields on the card == CPU; type-A "
        f"{int(got['n_ovf'])}, type-B {int(got['n_ovf_b'])}; capacity_probe launches "
        f"{capacity_probe.LAUNCHES}")


def n_occs_of(k2u: dict, fw: torch.Tensor) -> torch.Tensor:
    """Occurrence count of each query's minimizer bucket (its bpos row)."""
    m = k2u["meta"]
    mm = canonical_minimizer_batch(fw, m.k, m.w, m.seed)[0]
    return mask32(k2u["bpos"][fold_hash32(mm) & (m.direct_t - 1), 3])


def probed_rows(run, n_occs: torch.Tensor, skew: torch.Tensor, plim: int) -> torch.Tensor:
    """Rows a first-hit probe reads per lane at probe limit ``plim``: j for
    a lane first found at limit j, else min(plim, n_occs); none for a skew
    lane. ``run(j)`` is the plain main probe at limit j (found: mt 1 or 2)."""
    rows = torch.clamp(n_occs, max=plim)
    done = torch.zeros_like(skew)
    for j in range(1, plim + 1):
        mt = run(j)["mt"]
        found = ((mt == 1) | (mt == 2)) & ~done
        rows = torch.where(found, j, rows)
        done = done | found
    return torch.where(skew, 0, rows)


def k3_lane_cost(k2u: dict, fw: torch.Tensor, plim: int, mlim: int) -> tuple[int, int, int, int]:
    """(bytes, L2 sectors, DRAM sectors, DRAM 64-byte blocks) that K3 must
    move on this batch on the MPHF layout with a truncated chain.

    Bytes, each read once and only what a lane reads: its key; one u32 MPHF
    word per level tested up to the first hit (at most ``mlim``); for a
    placed lane its block's u32 rank and the words before the hit word in
    the block; for a placed lane that is not skew, two u16 bucket deltas,
    one or two i64 group bases, and the position bits and three useq words
    of each probed row; for a winner two wb2 words and a count and its
    40-byte uproj row; and 59 bytes of outputs. A deferred winner that
    fails validation counts as a miss.

    Sectors: the distinct 32-byte sectors of those random reads (the key
    and output streams are left out), split into the tables that stay in
    the 50 MB L2 at 300 Mbp (the MPHF words and ranks, gbase, uproj: ~32
    MB) and those that do not (gdelta, the packed positions, words2,
    wb2); the DRAM reads also in distinct 64-byte blocks. Every placed
    lane reads its bucket bounds, skew or not. Both next-row words (q2, the
    next wb2 word) are counted: the kernel skips them where its masks
    discard them, so it touches a little less."""
    m, mp = k2u["meta"], k2u["mphf"]
    mm = canonical_minimizer_batch(fw, m.k, m.w, m.seed)[0]
    mmeta = mp["meta"]
    n_test = min(mlim, len(mmeta.n_bits))
    s0, s1 = key_fold32(mm)
    hit = torch.full_like(fw, -1)
    hit_pos = torch.zeros_like(fw)
    for li in range(n_test):
        h, s0, s1 = chain_next(s0, s1)
        pos = h & (mmeta.n_bits[li] - 1)
        bit = ((mask32(mp["words"][mmeta.word_offsets[li] + (pos >> 5)]) >> (pos & 31)) & 1) != 0
        newly = bit & (hit < 0)
        hit = torch.where(newly, li, hit)
        hit_pos = torch.where(newly, pos, hit_pos)
    placed = hit >= 0
    levels = torch.where(placed, hit + 1, n_test)
    rank = torch.where(placed, 4 + 4 * ((hit_pos >> 5) & 7), 0)
    hc = torch.clamp(mphf_lookup(mp, mm, level_limit=mlim)[0].to(torch.int64), min=0)
    ps, pe = _prefix_pair(k2u, hc)
    n_occs = torch.where(placed, pe - ps, 0)

    def run(j):
        return sshash_k2u(k2u, fw, mode="main", probe_limit=j, defer_valid=True,
                          mphf_level_limit=mlim)

    last = run(plim)
    rows = probed_rows(run, n_occs, last["use_skew"], plim)
    groups = 1 + ((hc >> 10) != ((hc + 1) >> 10)).to(torch.int64)
    width = k2u["pos"]["meta"].width
    bucket = torch.where(placed & ~last["use_skew"],
                         4 + 8 * groups + (rows * width + 7) // 8 + 24 * rows, 0)
    hits = last["mt"] > 0
    tail = torch.where(hits, 24 + 40, 0)
    n_bytes = int((8 + 4 * levels + rank + bucket + tail + 59).sum())

    # L2: a sector per tested level (the hit word's 32-byte block is its
    # sector), the rank, the group bases, the uproj row
    us = k2u["us"]
    uid = last["unitig_id"]
    l2 = (levels + placed.to(torch.int64)
          + distinct(torch.stack(sector_ids(8 * (hc >> 10), 8, placed)
                                 + sector_ids(8 * ((hc + 1) >> 10), 8, placed), 1))
          + distinct(torch.stack(sector_ids(40 * uid, 40, hits), 1)))
    # DRAM: the two deltas, the position words, each probed row's two
    # words2 rows, the winner's two wb2 rows; in 32-byte sectors and in
    # 64-byte blocks
    lo_w = 8 * ((ps * width) >> 6)
    hi_w = 8 * (((ps + rows) * width - 1) >> 6)
    n_w2, n_wb = us["useq"]["words2"].shape[0], us["bv"]["wb2"].shape[0]
    n_pos = int(k2u["pos"]["meta"].length)
    w2_rows = []
    for j in range(plim):
        mm_pos = _pos_get(k2u, torch.clamp(ps + j, 0, n_pos - 1))
        wi = (torch.clamp(mm_pos - (m.k - m.w), min=0) * 2) >> 6
        w2_rows += [(torch.clamp(wi, max=n_w2 - 1), j < rows),
                    (torch.clamp(wi + 1, max=n_w2 - 1), j < rows)]
    bwi = (last["pos"] + us["uproj"][torch.clamp(uid, max=us["uproj"].shape[0] - 1), 0]) >> 6

    def dram(size):
        w2 = [i for r, on in w2_rows for i in sector_ids(16 * r, 16, on, size)]
        return int((distinct(torch.stack(sector_ids(2 * hc, 4, placed, size), 1))
                    + torch.where(rows > 0, hi_w // size - lo_w // size + 1, 0)
                    + distinct(torch.stack(w2, 1))
                    + distinct(torch.stack(
                        sector_ids(16 * bwi, 16, hits, size)
                        + sector_ids(16 * torch.clamp(bwi + 1, max=n_wb - 1), 16, hits, size), 1))
                    ).sum())

    return n_bytes, int(l2.sum()), dram(32), dram(64)


def k2_dram_sectors(k2u: dict, fw: torch.Tensor, rows: torch.Tensor) -> tuple[int, int]:
    """The distinct 32-byte sectors and 64-byte blocks of K2's random reads
    on this batch, all from tables past the L2 (2.1 GB of bpos rows, 0.6
    GB of padded records at 300 Mbp): each lane's 16-byte bpos row and the
    56 bytes of each of its ``rows`` probed rows' records, which the
    kernel reads from 64-byte rows (``bpos_probe.padded_records``; the key
    and output streams are left out)."""
    m = k2u["meta"]
    mm = canonical_minimizer_batch(fw, m.k, m.w, m.seed)[0]
    brow = mask32(k2u["bpos"][fold_hash32(mm) & (m.direct_t - 1)])
    n_rec = k2u["us"]["useqrec"].shape[0]
    lo = [(8 * bpos_probe.REC_WORDS
           * torch.clamp((torch.clamp(brow[:, j] - (m.k - m.w), min=0) * 2) >> 6, max=n_rec - 1),
           j < rows)
          for j in range(int(rows.max()) if rows.numel() else 0)]

    def count(size):
        ids = [i for r, on in lo for i in sector_ids(r, 56, on, size)]
        return fw.shape[0] + (int(distinct(torch.stack(ids, 1)).sum()) if ids else 0)

    return count(32), count(64)


def tree_bytes(d) -> int:
    """Bytes of the tensors of an array dict."""
    if isinstance(d, dict):
        return sum(tree_bytes(v) for v in d.values())
    return d.numel() * d.element_size() if isinstance(d, torch.Tensor) else 0


# (kernel, the TPU kernel body it replaces)
LAB = (
    ("gather_u32", "labs/pallas_probe.py:31"),
    ("hash_mix32x8", "labs/pallas_probe.py:35"),
    ("xor_rows", "labs/tpu_dma_lab.py:44"),
    ("xor_rows_ring", "labs/tpu_dma_lab.py:68"),
    ("gather_rows", "labs/tpu_dma_lab.py:115"),
)


def lab_kernels(dev, smi, lib: str, report: str) -> list:
    """Phase 3; returns the five lab kernels' records for the kernels line."""
    g = gather_lab
    log(f"[lab build] {lib}")
    for line in ptxas_lines(report):
        log(f"[lab build] {line}")
    N, M, T, NR = gather_probe.N, gather_probe.M, dma_lab.T, dma_lab.N
    rng = np.random.default_rng(7)

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a).astype(np.int64).astype(np.int32)).to(dev)

    def u32(shape):
        return i32(rng.integers(-(1 << 31), 1 << 31, shape))

    err = dict.fromkeys((*g.NAMES, "sector_reads"), 0)

    def same(name, got, want):
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"[lab] {name}: {got.dtype}{tuple(got.shape)}, plain gives "
                                 f"{want.dtype}{tuple(want.shape)}")
        diff = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        err[name] = max(err[name], diff)
        if not torch.equal(got, want):
            raise AssertionError(f"[lab] {name}: kernel and plain version differ")

    tbl, rows = u32(M), u32((T, 128))
    for n in (N, 1, (1 << 18) + 37):
        idx = i32(rng.integers(0, M, n))
        for ii in (idx, torch.full_like(idx, M - 1)):
            same("gather_u32", g.gather_u32(tbl, ii), g.gather_u32_plain(tbl, ii))
        same("sector_reads", g.sector_reads(tbl, idx), g.gather_u32_plain(tbl, idx))
        x = u32(n + 1)
        for xx in (x[:n], x[1:]):  # 16-byte aligned, and not
            same("hash_mix32x8", g.hash_mix32x8(xx), g.hash_mix32x8_plain(xx))
    for n in (NR, 1, (1 << 18) + 37):
        idx = i32(rng.integers(0, T, n))
        for ii in (idx, torch.full_like(idx, T - 1)):
            want = g.xor_rows_plain(ii, rows)
            same("xor_rows", g.xor_rows(ii, rows), want)
            same("xor_rows_ring", g.xor_rows_ring(ii, rows), want)
            same("gather_rows", g.gather_rows(ii, rows), g.gather_rows_plain(ii, rows))
    torch.cuda.synchronize()
    log("[lab] L1-L5 at the labs' shapes, N=1, N=2^18+37 and all-same indices (and L2 on an "
        "unaligned view), and sector_reads: bit-identical")
    gather_cases(tbl, M, N, rng, same)
    xor_cases(rows, T, NR, rng, same)

    # the main path: the two lab entry points
    reset_launches()
    gather_probe.run(dev, log=lambda *a: log("[lab gather_probe]", *a))
    dma_lab.run(dev, log=lambda *a: log("[lab dma_lab]", *a))
    launches = dict(g.LAUNCHES)
    log(f"[lab] launches by the lab entry points: {launches}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a lab entry point never launched its kernel: {launches}")

    tblL, idxL, xL = gather_probe.inputs(N, M, dev)
    rowsL, idxR = dma_lab.inputs(T, NR, dev)
    row_b = 4 * g.ROW
    spec = {  # kernel, plain version, one torch call for the same, bound
        "gather_u32": (lambda: g.gather_u32(tblL, idxL), lambda: g.gather_u32_plain(tblL, idxL),
                       lambda: tblL[idxL], bound(4 * (2 * N + M))),
        "hash_mix32x8": (lambda: g.hash_mix32x8(xL), lambda: g.hash_mix32x8_plain(xL), None,
                         bound(8 * N, 24 * N)),
        "xor_rows": (lambda: g.xor_rows(idxR, rowsL), lambda: g.xor_rows_plain(idxR, rowsL),
                     None, bound(4 * NR + row_b * (T + 1))),
        "xor_rows_ring": (lambda: g.xor_rows_ring(idxR, rowsL),
                          lambda: g.xor_rows_plain(idxR, rowsL), None,
                          bound(4 * NR + row_b * (T + 1))),
        "gather_rows": (lambda: g.gather_rows(idxR, rowsL), lambda: g.gather_rows_plain(idxR, rowsL),
                        lambda: torch.index_select(rowsL, 0, idxR),
                        bound(4 * NR + row_b * (T + NR))),
    }
    # the kernels' own rates from L2 on batches where the launch costs
    # little: random 4-byte reads of the 1 MB table, random 512-byte rows of
    # the 8 MB one (what their own code costs stays in these rates)
    idx_w = i32(rng.integers(0, M, L2_WORDS))
    same("gather_u32", g.gather_u32(tblL, idx_w), g.gather_u32_plain(tblL, idx_w))
    words_s = L2_WORDS / cuda_ms(lambda: g.gather_u32(tblL, idx_w), 20) * 1e3
    idx_r = i32(rng.integers(0, T, L2_ROWS))
    rows_s = {}
    for name in ("xor_rows", "xor_rows_ring"):
        kern = getattr(g, name)
        same(name, kern(idx_r, rowsL), g.xor_rows_plain(idx_r, rowsL))
        rows_s[name] = L2_ROWS / cuda_ms(lambda: kern(idx_r, rowsL), 20) * 1e3
    del idx_w, idx_r
    log(f"[lab l2] L1 gather_u32, {L2_WORDS} random 4-byte reads of the {4 * M >> 10} KB table: "
        f"{words_s / 1e9:.3f} G words/s; {L2_ROWS} random 512-byte rows of the "
        f"{row_b * T >> 20} MB table: " + ", ".join(
            f"{name} {r / 1e6:.1f} M rows/s = {row_b * r / 1e12:.3f} TB/s"
            for name, r in rows_s.items()) + f" ({smi})")
    large_batch = {"gather_u32": N / words_s * 1e3,
                   **{name: NR / r * 1e3 for name, r in rows_s.items()}}
    # the L2 floor: the bytes each kernel moves through the L2 (a 32-byte
    # sector per random 4-byte read, 512 bytes per row, the index and
    # output streams) at the L2 read rate of l2_stream; torch's reductions
    # are printed beside it as a cross-check
    l2_rate = l2_stream_rate(dev, smi)
    torch_l2_rate(dev, smi)
    l2_bytes = {"gather_u32": N * (32 + 4 + 4), "xor_rows": NR * (row_b + 4) + row_b,
                "xor_rows_ring": NR * (row_b + 4) + row_b}
    l2_floor = {name: b / l2_rate * 1e3 for name, b in l2_bytes.items()}
    # L1's sector floor: its N random reads at the L2's random-sector rate,
    # its index and output streams at the L2 read rate
    sector_floor = (N / l2_sectors_rate(dev, smi) + 8 * N / l2_rate) * 1e3
    # L1 in turns with its frozen first design on the same inputs
    turns = [(name, cuda_ms(lambda: getattr(g, name)(tblL, idxL), 50))
             for name in ("sector_reads", "gather_u32", "gather_u32", "sector_reads")]
    l1_ms, before_ms = (statistics.mean(t for name, t in turns if name == k)
                        for k in ("gather_u32", "sector_reads"))
    log("[lab] L1 in turns with its frozen first design: "
        + ", ".join(f"{name} {t:.4f}" for name, t in turns)
        + f" ms; {l1_ms:.4f} against {before_ms:.4f} ms ({before_ms / l1_ms:.3f}x) ({smi})")
    out = []
    for name, replaces in LAB:
        kern, plain, library, bnd = spec[name]
        ms = l1_ms if name == "gather_u32" else cuda_ms(kern, 50)
        plain_ms = cuda_ms(plain, 10)
        lib_ms = cuda_ms(library, 50) if library else None
        if name in ("gather_u32", "hash_mix32x8"):
            rate = f"{N / ms / 1e6:.3f} G words/s"
        else:
            rate = f"{NR / ms / 1e3:.1f} M rows/s, {NR * row_b / ms / 1e6:.1f} GB/s of 512B rows"
        lib_txt = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
        extra = ({"large_batch_ms": large_batch[name], "l2_floor_ms": l2_floor[name]}
                 if name in large_batch else {})
        l2_txt = (f", at its large-batch L2 rate {large_batch[name]:.4f} ms, L2 floor "
                  f"{l2_floor[name]:.4f} ms ({l2_floor[name] / ms:.1%} of the kernel's time: "
                  f"{'under' if l2_floor[name] / ms < 0.5 else 'at or over'} half)" if extra else "")
        if name == "gather_u32":
            extra.update(sector_floor_ms=sector_floor, before_ms=before_ms)
            l2_txt += (f", sector floor {sector_floor:.4f} ms ({sector_floor / ms:.1%}), first "
                       f"design in turns {before_ms:.4f} ms")
        log(f"[lab] {name}: kernel {ms:.4f} ms ({rate}), plain {plain_ms:.4f} ms, torch call "
            f"{lib_txt}, bound {bnd[0]:.4f} ms ({bnd[1]}){l2_txt} ({smi})")
        out.append(record(name, "gather_lab.cu", replaces, launches[name], err[name], ms, plain_ms,
                          bnd, lib_ms, **extra))
        if name in rows_s:
            rows_s[f"{name} at N={NR}"] = NR / ms * 1e3
    fastest = max(rows_s, key=rows_s.get)
    top = row_b * rows_s[fastest]
    log(f"[lab l2 floor] the L2 read rate {l2_rate / 1e12:.3f} TB/s is "
        f"{'at or over' if l2_rate >= top else 'UNDER'} the fastest L3/L4 rate of this run, "
        f"{fastest}'s {top / 1e12:.3f} TB/s of rows"
        + ("" if l2_rate >= top else ": the reader is not the ceiling") + f" ({smi})")
    return out, dram_rates(dev, smi, same)


def gather_cases(tbl: torch.Tensor, m: int, n_lab: int, rng, same):
    """L1 against its plain version, bit for bit, on what its launch and
    its one thread a word could get wrong: an index view 4 bytes off 16-byte
    alignment, all-0 and all-(M-1) indices each called twice, ragged tables
    (37, 2^18 - 1, 2^18 + 1 words) and a table and indices written by the
    kernels launched just before each call (the launch may begin before
    they end, and must not read before they do)."""
    g = gather_lab

    def i32(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int64).astype(np.int32)).to(tbl.device)

    def check(t, ii, calls=1):
        for _ in range(calls):
            same("gather_u32", g.gather_u32(t, ii), g.gather_u32_plain(t, ii))

    ii = i32(rng.integers(0, m, n_lab + 1))
    check(tbl, ii[1:])
    for fill in (0, m - 1):
        check(tbl, torch.full_like(ii[:n_lab], fill), calls=2)
    for words in (37, m - 1, m + 1):
        t = i32(rng.integers(-(1 << 31), 1 << 31, words))
        check(t, i32(rng.integers(0, words, n_lab + 37)))
        check(t, torch.full_like(ii[:n_lab], words - 1), calls=2)
    gen = torch.Generator(device=tbl.device)
    gen.manual_seed(17)
    for k in range(8):
        t = tbl * (k + 3)
        check(t, torch.randint(0, m, (n_lab + k,), dtype=torch.int32, device=tbl.device,
                               generator=gen))
    torch.cuda.synchronize()
    log(f"[lab] L1 on idx[1:], all-0 and all-{m - 1} indices (twice each), tables of 37, "
        f"{m - 1} and {m + 1} words, and inputs written just before each of 8 calls: "
        f"bit-identical")


def xor_cases(rows: torch.Tensor, t: int, n_lab: int, rng, same):
    """L3 and L4 against their plain version, bit for bit, on batches made
    to break a grid of contiguous 32-index runs and a ticket fold: ragged
    sizes around a group (2, 31, 32, 33) and the lab's size - 1, fewer rows
    than the grid has warps and 3 x its warps + 5, indices only 0 or only
    T - 1, and pairs that cancel to zero; each called twice in a row, so a
    ticket left non-zero by the first call shows in the second."""
    g = gather_lab

    def i32(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int32)).to(rows.device)

    cases = {f"N={n}": i32(rng.integers(0, t, n)) for n in (2, 31, 32, 33, n_lab - 1)}
    for name in ("xor_rows", "xor_rows_ring"):
        warps = g.wave_blocks(name, rows.device) * g.FOLD_WARPS
        for n in (warps - 3, 3 * warps + 5):
            cases[f"N={n} ({name}: {warps} warps)"] = i32(rng.integers(0, t, n))
    cases["only row 0"] = i32(np.zeros(n_lab))
    cases[f"only row {t - 1}"] = i32(np.full(n_lab, t - 1))
    half = rng.integers(0, t, n_lab // 2)
    cases["pairs that cancel"] = i32(np.concatenate([half, half[::-1]]))
    if bool(g.xor_rows_plain(cases["pairs that cancel"], rows).any()):
        raise AssertionError("[lab] the cancelling batch does not fold to zero")
    for ii in cases.values():
        want = g.xor_rows_plain(ii, rows)
        for name in ("xor_rows", "xor_rows_ring"):
            kern = getattr(g, name)
            first, second = kern(ii, rows), kern(ii, rows)
            same(name, first, want)
            same(name, second, want)
    torch.cuda.synchronize()
    log(f"[lab] L3 and L4 on {'; '.join(cases)}, each called twice in a row: bit-identical")


L2_WORDS, L2_ROWS = 1 << 24, 1 << 21  # random reads of the labs' tables for their L2 rates
L2_READ = 512 << 20  # bytes a timed torch reduction reads from its L2-resident table
L2_STREAM = ((8, 257), (32, 65))  # l2_stream's tables (MB) and passes: ~2 GB a launch
DRAM_WORDS, DRAM_IDX = 1 << 28, 1 << 22  # L1: 2^22 random words of a 1 GB table
DRAM_ROWS, DRAM_NR = 1 << 21, 1 << 18  # L5: 2^18 random rows of a 1 GB table of 512-byte rows


def l2_stream_rate(dev, smi) -> float:
    """The card's L2 read rate (bytes/s) that the L2 floors use:
    ``gather_lab.l2_stream`` over an 8 MB table (the labs' size) and a 32
    MB one, each read R times in one launch (R odd: the blocks' rows fold
    to the table's XOR, checked), in order and in a fresh random order each
    pass. Its 16-byte ``ld.global.cg`` loads are cached in L2 only and no
    warp repeats another's read, so no SM's L1 serves any of it. Returns
    the fastest of the four."""
    g = gather_lab
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    best = 0.0
    for mb, reps in L2_STREAM:
        tbl = torch.randint(-(1 << 31), 1 << 31, ((mb << 20) // (4 * g.ROW), g.ROW),
                            dtype=torch.int32, device=dev, generator=gen)
        want = g.l2_stream_plain(tbl, reps)
        for random in (False, True):
            if not torch.equal(g.xor_fold(g.l2_stream(tbl, reps, random)), want):
                raise AssertionError(f"[lab l2 floor] l2_stream over {mb} MB (random={random}): "
                                     f"its rows do not fold to the table's XOR")
            ms = cuda_ms(lambda: g.l2_stream(tbl, reps, random), 10)
            rate = reps * (mb << 20) / ms * 1e3
            best = max(best, rate)
            log(f"[lab l2 floor] l2_stream: a {mb} MB table read {reps} times in one launch, "
                f"{'a fresh random order' if random else 'in order'} each pass: {ms:.4f} ms = "
                f"{rate / 1e12:.3f} TB/s ({smi})")
        del tbl
    log(f"[lab l2 floor] the card's L2 read rate: {best / 1e12:.3f} TB/s (l2_stream, the fastest "
        f"of the four)")
    return best


L2_SECTORS = ((18, 257), (21, 33))  # l2_sectors' tables (2^k words: 1, 8 MB), passes: ~2^26 reads


def l2_sectors_rate(dev, smi) -> float:
    """The L2's random-sector rate (reads/s) that L1's sector floor uses:
    ``gather_lab.l2_sectors`` over a 1 MB table (the lab's) and an 8 MB
    one, each word read R times in one launch (R odd: the blocks' words
    fold to the table's XOR, checked), a fresh random order each pass. Its
    4-byte ``ld.global.cg`` loads each cost one 32-byte L2 sector and no
    L1 serves a repeat. Returns the faster of the two."""
    g = gather_lab
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    best = 0.0
    for bits, reps in L2_SECTORS:
        tbl = torch.randint(-(1 << 31), 1 << 31, (1 << bits,), dtype=torch.int32, device=dev,
                            generator=gen)
        got = g.xor_fold(g.l2_sectors(tbl, reps).reshape(-1, 1)).reshape(1)
        if not torch.equal(got, g.l2_sectors_plain(tbl, reps)):
            raise AssertionError(f"[lab l2 sectors] l2_sectors over 2^{bits} words: its words do "
                                 f"not fold to the table's XOR")
        ms = cuda_ms(lambda: g.l2_sectors(tbl, reps), 10)
        rate = (reps << bits) / ms * 1e3
        best = max(best, rate)
        log(f"[lab l2 sectors] l2_sectors: a {4 << bits >> 20} MB table's words read {reps} times "
            f"in one launch, a fresh random order each pass: {ms:.4f} ms = {rate / 1e9:.2f} G "
            f"sectors/s = {32 * rate / 1e12:.3f} TB/s of 32-byte sectors ({smi})")
        del tbl
    log(f"[lab l2 sectors] the L2's random-sector rate: {best / 1e9:.2f} G sectors/s (the faster "
        f"of the two)")
    return best


def torch_l2_rate(dev, smi) -> float:
    """A cross-check of ``l2_stream_rate``, no floor: torch's reductions
    over an 8 MB and a 1 MB table, each seen through a stride-0 view that
    repeats it to 512 MB (``t.expand(R, n)``), so that one call reads the
    same table R times; int32, float32 and float64 tables, summed whole
    and row by row. Every row of such a view reads the same addresses, so
    an SM's L1 may serve part of it. Returns the fastest."""
    best = 0.0
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    for mb in (8, 1):
        base = torch.randint(0, 1 << 20, ((mb << 20) // 8,), dtype=torch.int32, device=dev,
                             generator=gen)
        for table in (torch.cat([base, base]), torch.cat([base, base]).to(torch.float32),
                      base.to(torch.float64)):
            n = table.shape[0]
            reps = L2_READ // (table.element_size() * n)
            view = table.expand(reps, n)
            if table.dtype == torch.int32 and int(view.sum()) != reps * int(table.sum()):
                raise AssertionError("the repeated sum differs from reps x the sum")
            for how, fn in (("whole", view.sum), ("row by row", lambda: view.sum(dim=1))):
                ms = cuda_ms(fn, 20)
                rate = L2_READ / ms * 1e3
                best = max(best, rate)
                log(f"[lab l2 floor] {table.dtype} .sum() {how} of a {mb} MB table read "
                    f"{reps} times through a stride-0 view: {ms:.4f} ms = {rate / 1e12:.3f} TB/s "
                    f"({smi})")
    log(f"[lab l2 floor] torch's reductions: {best / 1e12:.3f} TB/s at best (a cross-check, not "
        f"the floor: L1 may serve part of a stride-0 view)")
    return best


def dram_rates(dev, smi, same) -> float:
    """The card's random-read rates from device memory (phase 3): the
    frozen first design of L1 (``sector_reads``) over a 1 GB table of u32 (each
    4-byte read costs one 32-byte sector), L1 itself on the same as a
    cross-check, and L5 over a 1 GB table of 512-byte rows, all far past
    the 50 MB L2 and bit-identical to their plain versions. Returns
    ``sector_reads``' random-sector rate (sectors/s), which the K2 and K3
    sector floors use."""
    g = gather_lab
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)

    def rand(hi, shape):
        return torch.randint(0, hi, shape, dtype=torch.int32, device=dev, generator=gen)

    tbl, idx = rand(1 << 30, (DRAM_WORDS,)), rand(DRAM_WORDS, (DRAM_IDX,))
    want = g.gather_u32_plain(tbl, idx)
    same("sector_reads", g.sector_reads(tbl, idx), want)
    same("gather_u32", g.gather_u32(tbl, idx), want)
    ms = cuda_ms(lambda: g.sector_reads(tbl, idx), 20)
    sec_s = DRAM_IDX / ms * 1e3
    log(f"[lab dram] sector_reads (L1's first design), {DRAM_IDX} random 4-byte reads of a "
        f"{4 * DRAM_WORDS >> 20} MB table: {ms:.4f} ms = {sec_s / 1e9:.3f} G sectors/s = "
        f"{32 * sec_s / 1e9:.1f} GB/s of 32-byte sectors ({4 * sec_s / 1e9:.1f} GB/s of words) "
        f"({smi})")
    ms = cuda_ms(lambda: g.gather_u32(tbl, idx), 20)
    log(f"[lab dram] L1 gather_u32 on the same (a cross-check, not the floors' rate): {ms:.4f} ms "
        f"= {DRAM_IDX / ms / 1e6:.3f} G sectors/s ({smi})")
    del tbl, idx, want
    rows, idx = rand(1 << 30, (DRAM_ROWS, g.ROW)), rand(DRAM_ROWS, (DRAM_NR,))
    same("gather_rows", g.gather_rows(idx, rows), g.gather_rows_plain(idx, rows))
    ms = cuda_ms(lambda: g.gather_rows(idx, rows), 20)
    row_s = DRAM_NR / ms * 1e3
    log(f"[lab dram] L5 gather_rows, {DRAM_NR} random 512-byte rows of a "
        f"{4 * g.ROW * DRAM_ROWS >> 20} MB table: {ms:.4f} ms = {row_s / 1e6:.1f} M rows/s = "
        f"{16 * row_s / 1e9:.3f} G sectors/s = {512 * row_s / 1e9:.1f} GB/s read ({smi})")
    del rows, idx
    torch.cuda.empty_cache()
    return sec_s


def pf1_path(kind: str, genome, n_bases: int, truth, dev, smi):
    """Phases 7 (dense) and 8 (sparse); returns a function that runs one
    profiled pass of the path."""
    tag = f"pf1 {kind}"
    build = synth.build_pf1_dense_index if kind == "dense" else synth.build_pf1_sparse_index
    t0 = time.perf_counter()
    index = build(n_bases, seed=0, device=dev, genome=genome)
    t_build = time.perf_counter() - t0
    host = index.device_arrays()
    cpu_index = QueryIndex(arrays_from_numpy(host, "cpu"))
    gpu_index = QueryIndex(arrays_from_numpy(host, "cpu")).to(dev)
    torch.cuda.synchronize()
    del host
    mp = index.k2u.mphf
    d, cpu = gpu_index.arrays(), cpu_index.arrays()
    k2u = d["k2u"]
    log(f"[{tag}] {index.k2u.n_kmers} k-mers; MPHF levels {len(mp.levels)} "
        f"{[n for n, _, _ in mp.levels]}, {len(mp.fh_keys)} final-hash keys; host build "
        f"{t_build:.1f} s (MPHF lookup on the card); {gpu_index.nbytes()} bytes on the card "
        f"(MPHF {tree_bytes(k2u['mphf'])}, unitig set {tree_bytes(k2u['us'])}, other K2U "
        f"{tree_bytes(k2u) - tree_bytes(k2u['mphf']) - tree_bytes(k2u['us'])}, occurrences "
        f"{tree_bytes(d['u2pos'])})")
    work, uid, off, foreign = truth
    work_cpu = torch.from_numpy(work.view(np.int64))
    fw = work_cpu.to(dev)
    if kind == "dense":
        keys = umin(work_cpu, revcomp(work_cpu, index.k))
        keys_d = keys.to(dev)
        want = boophf_lookup(cpu["k2u"]["mphf"], keys)
        if not torch.equal(boophf_lookup(k2u["mphf"], keys_d).cpu(), want):
            raise AssertionError("64-bit boophf_lookup differs between the card and the CPU")
        ms = cuda_ms(lambda: boophf_lookup(k2u["mphf"], keys_d), 5)
        log(f"[{tag}] 64-bit boophf_lookup of {BATCH} canonical words: the card equals the CPU "
            f"({int((want >= 0).sum())} values >= 0); {ms:.3f} ms on the card ({smi})")
    t0 = time.perf_counter()
    out0 = get_ref_pos_padded(cpu, work_cpu, cpu_index.max_occs)
    host_chk = int(padded_checksum(out0))
    hit = out0["mt"].numpy() > 0
    if not hit[~foreign].all() or hit[foreign].any():
        raise AssertionError(f"[{tag}] CPU oracle: {int((~hit[~foreign]).sum())} sampled lanes "
                             f"missed, {int(hit[foreign].sum())} foreign lanes hit")
    if not (np.array_equal(out0["unitig_id"].numpy()[~foreign], uid[~foreign])
            and np.array_equal(out0["pos"].numpy()[~foreign], off[~foreign])):
        raise AssertionError(f"[{tag}] CPU oracle disagrees with the sampled unitigs and offsets")
    log(f"[{tag}] CPU oracle {time.perf_counter() - t0:.1f} s: chunk checksum {host_chk}; "
        f"{int((~foreign).sum())} sampled lanes hit at their unitig and offset, "
        f"{int(foreign.sum())} foreign lanes missed")
    del cpu_index, cpu, out0
    _, _, times = graph_and_eager(
        tag, gpu_index, lambda x: checksum_padded_rolled(gpu_index, x, CH),
        lambda x: checksum_padded_rolled(gpu_index, x, CH, graph=False), fw, CH * host_chk,
        BATCH * CH, 3, None, smi)
    return lambda: profile_both(
        tag, lambda: checksum_padded_rolled(gpu_index, fw, CH),
        lambda: checksum_padded_rolled(gpu_index, fw, CH, graph=False), times)


def capacity(args, dev, smi, lib3: str, ptxas3: str, sector_rate: float):
    """Phases 10-14; returns K2's record for the kernels line and the
    capacity path's profiled pass. ``sector_rate``: phase 3's random-sector
    rate (sectors/s), for K2's sector floor."""
    # 10. the capacity index
    t0 = time.perf_counter()
    index = synth.build_capacity_index(int(args.cap_mbp * 1e6), seed=0, device=dev, chunk=1 << 24)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = index.device_arrays(**synth.CAPACITY_LAYOUT)
    t_arrays = time.perf_counter() - t0
    cpu_index = QueryIndex(arrays_from_numpy(host, "cpu"))
    t0 = time.perf_counter()
    gpu_index = QueryIndex(arrays_from_numpy(host, "cpu")).to(dev)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    us = index.k2u.unitigs
    d = gpu_index.arrays()
    k2u = d["k2u"]
    m = k2u["meta"]
    log(f"[cap index] {us.total_len} bases, {us.n_unitigs} unitigs, {us.n_kmers} k-mers; "
        f"T={m.direct_t} buckets, probe_bound={m.probe_bound}, max bucket {index.k2u.max_bucket()}, "
        f"{index.k2u.n_kmers_in_skew_index} skew k-mers ({m.skew_kind}, skew_t={m.skew_t}); "
        f"max_occs={gpu_index.max_occs}")
    log(f"[cap index] host build {t_build:.1f} s (minimizer scan on the card), arrays "
        f"{t_arrays:.1f} s, to card {t_card:.1f} s; {gpu_index.nbytes()} bytes on the card "
        f"(bpos {k2u['bpos'].numel() * 4}, useqrec {k2u['us']['useqrec'].numel() * 8})")

    # 11. K2 against its plain version
    work, uid, upos = synth.sample_capacity_queries(us, BATCH, seed=1)
    fw = torch.from_numpy(work.view(np.int64)).to(dev)

    def k2(plim):
        return (lambda d_, f_: bpos_probe.bpos_usrec_k2u(d_, f_, plim),
                lambda d_, f_: sshash_k2u(d_, f_, mode="main", probe_limit=plim))

    want = sshash_k2u(k2u, fw, mode="main", probe_limit=PLIM)
    skew_lane = int(torch.nonzero(want["use_skew"])[0])
    small = work[:257].copy()
    small[0] = work[skew_lane]
    small[1] = np.random.default_rng(5).integers(1 << 63, 1 << 64, dtype=np.uint64)
    small[2] = mask2k(index.k)
    for plim in (1, 2, 3):
        for words in (small[:1], small):
            compare_k2u(k2u, torch.from_numpy(words.view(np.int64)).to(dev),
                        f"plim={plim} N={len(words)}", *k2(plim))
        max_err = compare_k2u(k2u, fw, f"plim={plim} N={BATCH}", *k2(plim))
    log("[k2] N=1, N=257 (a skew lane, a foreign word, all-T) and 2^20 at probe limits 1-3: "
        "bit-identical on all nine fields")
    cases = tile_cases(work, want["use_skew"], us, index.k, bpos_probe.TILE)
    max_err = max(max_err, compare_cases(
        "k2 tiles", k2u, cases, [(f"plim={p}", *k2(p), FIELDS) for p in (1, 2, 3)], dev))
    n_skew = int(want["use_skew"].sum())
    n_unres = int(want["unresolved"].sum())
    # unresolved lanes whose bucket has no row past the probed depth are
    # there only for the mt == 3 sentinel (a lower bound of its count)
    n_mt3 = int((want["unresolved"] & (n_occs_of(k2u, fw) <= PLIM)).sum())
    log(f"[k2] N={BATCH} at probe limit {PLIM}: {n_skew} skew lanes, {n_unres} unresolved, "
        f">= {n_mt3} by the mt==3 sentinel, {int((want['mt'] > 0).sum())} hits")
    if min(n_skew, n_unres, n_mt3) == 0:
        raise AssertionError("the capacity batch lacks skew, unresolved or sentinel lanes")
    kern, plain = k2(PLIM)
    k2_ms = cuda_ms(lambda: kern(k2u, fw), 20)
    k2_plain_ms = cuda_ms(lambda: plain(k2u, fw), 5)
    rows = probed_rows(lambda plim: sshash_k2u(k2u, fw, mode="main", probe_limit=plim),
                       n_occs_of(k2u, fw), want["use_skew"], PLIM)
    # the key, the 16-byte bpos row, a 56-byte record per probed row, the outputs
    k2_bound = bound(BATCH * (8 + 16 + K2U_OUT) + 56 * int(rows.sum()))
    k2_dram, k2_blocks = k2_dram_sectors(k2u, fw, rows)
    k2_floor = k2_dram / sector_rate * 1e3
    log(f"[k2] N={BATCH}: kernel {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms; {int(rows.sum())} "
        f"records read; bound {k2_bound[0]:.4f} ms ({k2_bound[1]}); {k2_dram} DRAM sectors "
        f"({k2_dram / BATCH:.3f} a lane): sector floor {k2_floor:.4f} ms; {k2_blocks} 64-byte "
        f"blocks ({k2_blocks / BATCH:.3f} a lane): {k2_blocks / sector_rate * 1e3:.4f} ms at "
        f"the same rate ({smi})")
    del want

    # 12. the capacity main path
    launches, m2c, profile = sshash_path(
        "cap main", cpu_index, gpu_index, work, uid, upos, fw,
        dict(probe_limit=PLIM, defer_valid=True, probe_limit2=PLIM2), bpos_probe, smi)
    res_ms = cuda_ms(lambda: get_ref_pos_padded(d, fw[:m2c], gpu_index.max_occs), 5)
    log(f"[cap main] residue phase alone (full mode, static loop to probe_bound={m.probe_bound}) "
        f"on {m2c} lanes: {res_ms:.3f} ms ({smi})")
    capacity_drivers(cpu_index, gpu_index, work, fw)

    # 13. K3 build report
    log(f"[k3 build] {lib3}")
    for line in ptxas_lines(ptxas3):
        log(f"[k3 build] {line}")

    # 14. K3 on the direct layout: these arrays without bpos and useqrec,
    # with uproj records
    uproj = torch.from_numpy(build_uproj(index.u2pos, us).view(np.int64)).to(dev)
    k3d = {**{kk: v for kk, v in k2u.items() if kk != "bpos"},
           "us": {**{kk: v for kk, v in k2u["us"].items() if kk != "useqrec"}, "uproj": uproj}}
    for plim in (1, 2, 3):
        for words in (small[:1], small):
            compare_k2u(k3d, torch.from_numpy(words.view(np.int64)).to(dev),
                        f"direct plim={plim} N={len(words)}", *k3(plim), fields=FIELDS3)
        compare_k2u(k3d, fw, f"direct plim={plim} N={BATCH}", *k3(plim), fields=FIELDS3)
    compare_cases("k3 direct tiles", k3d, cases,
                  [(f"plim={p}", *k3(p), FIELDS3) for p in (1, 2, 3)], dev)
    kern, plain = k3(PLIM)
    k3_ms = cuda_ms(lambda: kern(k3d, fw), 20)
    k3_plain_ms = cuda_ms(lambda: plain(k3d, fw), 5)
    log(f"[k3 direct] N=1, N=257 and 2^20 at probe limits 1-3: bit-identical on all ten fields; "
        f"N={BATCH} at probe limit {PLIM}: kernel {k3_ms:.4f} ms, plain {k3_plain_ms:.4f} ms "
        f"({smi})")
    return record("bpos_probe", "bpos_probe.cu", "mazu_tpu/ops/pallas_capacity.py:266",
                  launches, max_err, k2_ms, k2_plain_ms, k2_bound,
                  sector_floor_ms=k2_floor), profile


def sshash_path(tag: str, cpu_index, gpu_index, work, uid, upos, fw, query: dict, probe,
                smi) -> tuple[int, int, object]:
    """Phases 12 and 17: an SSHash main path with the type-split heavy phase
    and its middle phase (``query``: the main and middle probe settings).
    The port's plain path on CPU tensors gives chunk 0's oracle, which must
    hit every sampled lane at its sampled unitig and offset and sizes the
    capacities; the merged query on 4,096 lanes on the card must equal the
    padded CPU query; then ``checksum_pass_rolled`` over CAP_CH chunks must
    equal CAP_CH x the oracle and launch ``probe``'s kernel; 3 timed passes.
    Returns (the kernel's launches in the first pass, m2c, a function that
    runs one profiled pass)."""
    t0 = time.perf_counter()
    cpu = cpu_index.arrays()
    work_cpu = torch.from_numpy(work.view(np.int64))
    rM = sshash_k2u(cpu["k2u"], work_cpu, mode="main", probe_limit=query["probe_limit2"])
    m2c = fit(int((rM["use_skew"] | rM["unresolved"]).sum()) * 1.3)
    kw = dict(query, m2b=max(8192, BATCH // 8), m2c=m2c)
    out0 = get_ref_pos_compact(cpu, work_cpu, cpu_index.max_occs, merge=False,
                               m2=max(8192, BATCH // 8), **kw)
    if bool(out0["over_budget"]):
        raise AssertionError("CPU oracle over budget")
    host_chk = int(OneGraphIndexQuery.checksum(out0))
    merged = merge_compact_k2u(out0)
    if not bool((merged["mt"] > 0).all()):
        raise AssertionError(f"CPU oracle missed {int((merged['mt'] == 0).sum())} sampled lanes")
    if not (np.array_equal(merged["unitig_id"].numpy(), uid)
            and np.array_equal(merged["pos"].numpy(), upos)):
        raise AssertionError("CPU oracle disagrees with the sampled unitigs and offsets")
    n_a, n_b = int(out0["n_ovf"]), int(out0["n_ovf_b"])
    real_b = out0["lanes_b"][out0["slot_real_b"]]
    rB = sshash_k2u(cpu["k2u"], work_cpu[real_b], mode="main", probe_limit=query["probe_limit2"])
    n_c = int((rB["use_skew"] | rB["unresolved"]).sum())
    M2, M2B = fit(n_a * 1.3), fit(n_b * 1.15)
    log(f"[{tag}] CPU oracle {time.perf_counter() - t0:.1f} s: chunk checksum {host_chk}; "
        f"every lane hit at its sampled unitig and offset; type-A {n_a}, type-B {n_b}, residue "
        f"{n_c} of {BATCH} -> m2={M2}, m2b={M2B}, m2c={m2c}")

    d = gpu_index.arrays()
    got = get_ref_pos_compact(d, fw[:4096], gpu_index.max_occs, merge=True, m2=4096,
                              **dict(kw, m2b=4096, m2c=4096))
    want = get_ref_pos_padded(cpu, work_cpu[:4096], cpu_index.max_occs)
    for key in ("unitig_id", "unitig_len", "pos", "mt", "n_occs", "valid",
                "ref_id", "ref_pos", "orient"):
        g, w = got[key].cpu(), want[key]
        if g.dim() == 2:
            g, w = torch.where(want["valid"], g, 0), torch.where(want["valid"], w, 0)
        if not torch.equal(g, w):
            raise AssertionError(f"[{tag}] merged query on the card differs from padded CPU in {key}")
    log(f"[{tag}] merged query on 4096 lanes equals the padded CPU query")

    og = OneGraphIndexQuery(gpu_index, BATCH, n_chunks=CAP_CH, m2=M2, m2b=M2B, **dict(query, m2c=m2c))
    og_eager = OneGraphIndexQuery(gpu_index, BATCH, n_chunks=CAP_CH, m2=M2, m2b=M2B, graph=False,
                                  **dict(query, m2c=m2c))
    launches, worst, times = graph_and_eager(
        tag, gpu_index, og.checksum_pass_rolled, og_eager.checksum_pass_rolled, fw,
        CAP_CH * host_chk, BATCH * CAP_CH, 3, probe, smi)
    log(f"[{tag}] worst (type-A, type-B) {worst} within (m2, m2b)")
    return launches, m2c, lambda: profile_both(
        tag, lambda: og.checksum_pass_rolled(fw), lambda: og_eager.checksum_pass_rolled(fw), times)


def k3(plim, mlim=None):
    """(K3, its plain version) at probe limit ``plim`` and MPHF level limit
    ``mlim``."""
    return (lambda d_, f_: capacity_probe.capacity_k2u(d_, f_, plim, mphf_level_limit=mlim),
            lambda d_, f_: sshash_k2u(d_, f_, mode="main", probe_limit=plim, defer_valid=True,
                                      mphf_level_limit=mlim))


def lane_counts(k2u: dict, fw: torch.Tensor, plim: int, mlim) -> dict:
    """The plain main probe's lane classes: skew, unplaced by the truncated
    MPHF chain, deferred winners that failed validation, hits."""
    m = k2u["meta"]
    on = sshash_k2u(k2u, fw, mode="main", probe_limit=plim, defer_valid=True,
                    mphf_level_limit=mlim)
    off = sshash_k2u(k2u, fw, mode="main", probe_limit=plim, mphf_level_limit=mlim)
    mm = canonical_minimizer_batch(fw, m.k, m.w, m.seed)[0]
    unplaced = mphf_lookup(k2u["mphf"], mm, level_limit=mlim)[1] if mlim else torch.zeros_like(fw)
    return {
        "skew": int(on["use_skew"].sum()),
        "mphf_unresolved": int(unplaced.sum()),
        "deferred_fail": int((on["unresolved"] & ~off["unresolved"]).sum()),
        "unresolved": int(on["unresolved"].sum()),
        "hits": int((on["mt"] > 0).sum()),
    }


def mphf(args, dev, smi, sector_rate: float):
    """Phases 15-17; returns K3's record for the kernels line and the MPHF
    path's profiled pass (``sector_rate`` as for ``capacity``)."""
    # 15. the MPHF index
    t0 = time.perf_counter()
    index = synth.build_mphf_index(int(args.mphf_mbp * 1e6), seed=0, device=dev, chunk=1 << 24)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = index.device_arrays(**synth.MPHF_LAYOUT)
    t_arrays = time.perf_counter() - t0
    cpu_index = QueryIndex(arrays_from_numpy(host, "cpu"))
    t0 = time.perf_counter()
    gpu_index = QueryIndex(arrays_from_numpy(host, "cpu")).to(dev)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    us = index.k2u.unitigs
    d = gpu_index.arrays()
    k2u = d["k2u"]
    m = k2u["meta"]
    n_min = k2u["prefix"]["gdelta"].shape[0] - 1
    mp = index.k2u.mphf
    log(f"[mphf index] {us.total_len} bases, {us.n_unitigs} unitigs, {us.n_kmers} k-mers; "
        f"{n_min} minimizers (T), MPHF levels {len(mp.levels)} {[n for n, _, _ in mp.levels]}, "
        f"{len(mp.fh_keys)} final-hash keys; {index.k2u.n_kmers_in_skew_index} skew k-mers; "
        f"probe_bound={m.probe_bound}, max bucket {index.k2u.max_bucket()}, "
        f"max_occs={gpu_index.max_occs}")
    log(f"[mphf index] host build {t_build:.1f} s (minimizer scan and MPHF lookup on the card), "
        f"arrays {t_arrays:.1f} s, to card {t_card:.1f} s; {gpu_index.nbytes()} bytes on the card "
        f"(gdelta {k2u['prefix']['gdelta'].numel() * 2}, packed positions "
        f"{k2u['pos']['words'].numel() * 8}, MPHF words {k2u['mphf']['words'].numel() * 4}, "
        f"uproj {k2u['us']['uproj'].numel() * 8})")

    # 16. K3 against its plain version
    work, uid, upos = synth.sample_capacity_queries(us, BATCH, seed=1)
    fw = torch.from_numpy(work.view(np.int64)).to(dev)
    want = sshash_k2u(k2u, fw, mode="main", probe_limit=PLIM, defer_valid=True,
                      mphf_level_limit=MLIM)
    skew_lane = int(torch.nonzero(want["use_skew"])[0])
    cases = tile_cases(work, want["use_skew"], us, index.k, capacity_probe.TILE)
    del want
    # a tile the one-level chain cannot place; lanes that reach the final
    # table (the batch's, and foreign k-mers that do)
    n_levels = len(k2u["mphf"]["meta"].n_bits)
    foreign = torch.from_numpy(np.random.default_rng(9).integers(
        0, 1 << (2 * index.k), 1 << 16, dtype=np.uint64).view(np.int64)).to(dev)

    def unplaced(words, limit):
        mm = canonical_minimizer_batch(words, m.k, m.w, m.seed)[0]
        return words[mphf_lookup(k2u["mphf"], mm, level_limit=limit)[1]].cpu().numpy()

    cases["unplaced at level limit 1"] = np.resize(unplaced(fw, 1).view(np.uint64),
                                                   capacity_probe.TILE)
    final_batch, final_foreign = unplaced(fw, n_levels), unplaced(foreign, n_levels)
    cases["final-table lanes"] = np.concatenate([final_batch, final_foreign]).view(np.uint64)
    log(f"[k3 mphf] lanes that reach the final-hash table at level limit None: "
        f"{len(final_batch)} of the {BATCH} batch, {len(final_foreign)} of {foreign.shape[0]} "
        f"foreign k-mers")
    small = work[:257].copy()
    small[0] = work[skew_lane]
    small[1] = np.random.default_rng(5).integers(1 << 63, 1 << 64, dtype=np.uint64)
    small[2] = mask2k(index.k)
    small[3:203] = synth.sample_boundary_queries(us, 200, seed=6)
    small_t = torch.from_numpy(small.view(np.int64)).to(dev)
    max_err = 0
    for mlim in (None, MLIM):
        for plim in (1, 2, 3):
            for words in (small_t[:1], small_t, fw):
                max_err = max(max_err, compare_k2u(
                    k2u, words, f"mphf mlim={mlim} plim={plim} N={len(words)}", *k3(plim, mlim),
                    fields=FIELDS3))
    log("[k3 mphf] N=1, N=257 (a skew lane, a foreign word, all-T, 200 boundary k-mers) and 2^20 "
        "at level limits None and 4, probe limits 1-3: bit-identical on all ten fields")
    max_err = max(max_err, compare_cases(
        "k3 mphf tiles", k2u, cases,
        [(f"mlim={ml} plim={p}", *k3(p, ml), FIELDS3) for ml in (None, MLIM, 2, 1)
         for p in (1, 2, 3)],
        dev))
    c_small = lane_counts(k2u, small_t, PLIM, MLIM)
    c_big = lane_counts(k2u, fw, PLIM, MLIM)
    log(f"[k3 mphf] probe limit {PLIM}, level limit {MLIM}: N=257 {c_small}; N={BATCH} {c_big}")
    if min(c_big["mphf_unresolved"], c_big["skew"], c_big["hits"]) == 0:
        raise AssertionError("the 2^20 batch lacks MPHF-unresolved, skew or hit lanes")
    if c_small["deferred_fail"] == 0:
        raise AssertionError("the N=257 batch has no deferred winner that failed validation")
    kern, plain = k3(PLIM, MLIM)
    k3_ms = cuda_ms(lambda: kern(k2u, fw), 20)
    k3_plain_ms = cuda_ms(lambda: plain(k2u, fw), 5)
    k3_bytes, k3_l2, k3_dram, k3_blocks = k3_lane_cost(k2u, fw, PLIM, MLIM)
    k3_bound = bound(k3_bytes)
    k3_floor = k3_dram / sector_rate * 1e3
    log(f"[k3 mphf] N={BATCH} at probe limit {PLIM}, level limit {MLIM}: kernel {k3_ms:.4f} ms, "
        f"plain {k3_plain_ms:.4f} ms; {k3_bytes} bytes read and written; bound "
        f"{k3_bound[0]:.4f} ms ({k3_bound[1]}); sectors a lane {k3_l2 / BATCH:.3f} in L2, "
        f"{k3_dram / BATCH:.3f} in DRAM: sector floor {k3_floor:.4f} ms; 64-byte DRAM blocks a "
        f"lane {k3_blocks / BATCH:.3f}: {k3_blocks / sector_rate * 1e3:.4f} ms at the same rate "
        f"({smi})")
    for mlim in (1, 2, None):
        kern_l = k3(PLIM, mlim)[0]
        log(f"[k3 mphf] N={BATCH} at probe limit {PLIM}, level limit {mlim}: kernel "
            f"{cuda_ms(lambda: kern_l(k2u, fw), 20):.4f} ms ({smi})")

    # 17. the MPHF main path
    launches, _, profile = sshash_path("mphf main", cpu_index, gpu_index, work, uid, upos, fw,
                                       synth.MPHF_QUERY, capacity_probe, smi)
    return record("capacity_probe", "capacity_probe.cu", "mazu_tpu/ops/pallas_capacity.py:56",
                  launches, max_err, k3_ms, k3_plain_ms, k3_bound,
                  sector_floor_ms=k3_floor), profile


def mono2_profile(host: dict, fw: torch.Tensor, m2: int, times: dict, serve: dict):
    """Phase 18's mono2 passes: the index moved to the card again from its
    host arrays, a replayed and an eager pass of the main path and of the
    serve pass (``serve``: its bitsets, batch buffer, Meta, capacity and
    pass times) to warm it (the first of each captures its graph again),
    each profiled, and the index freed."""
    def run():
        index = QueryIndex(arrays_from_numpy(host, "cpu")).to(fw.device)
        og = OneGraphIndexQuery(index, BATCH, n_chunks=CH, m2=m2)
        og_eager = OneGraphIndexQuery(index, BATCH, n_chunks=CH, m2=m2, graph=False)
        og.checksum_pass_rolled(fw)
        og_eager.checksum_pass_rolled(fw)
        profile_both("mono2 main", lambda: og.checksum_pass_rolled(fw),
                     lambda: og_eager.checksum_pass_rolled(fw), times)
        sp, sp_eager = (RunServePass(index, serve["cb"], synth.SERVE_READS, synth.SERVE_CHUNKS,
                                     serve["m2"], synth.READ_LEN, probe_limit=PLIM, graph=g)
                        for g in (True, False))

        def device_pass(p):
            return lambda: (p.device_pass(serve["flat"], serve["meta"]),
                            torch.cuda.synchronize())

        for p in (sp, sp_eager):
            device_pass(p)()
        profile_both("serve", device_pass(sp), device_pass(sp_eager), serve["times"])
        del og, og_eager, sp, sp_eager, index
        torch.cuda.empty_cache()
    return run


def graph_and_eager(tag: str, index, graph_pass, eager_pass, x: torch.Tensor, want: int,
                    n_queries: int, passes: int, probe, smi):
    """A path's pass over ``x`` as one CUDA graph and eagerly (phases 6, 7,
    8, 12, 17; ``graph_pass`` and ``eager_pass`` take the input and return
    the checksum, or (checksum, worst overflow)). The launch counts are set
    to 0 just before the first replayed pass (the eager warm-up, the
    capture and a replay), which must launch ``probe``'s kernel (the K2U
    kernel of the path; None for the pf1 paths, which have none); the
    graph's capture time and memory pool are read from ``index.graphs``.
    The replayed pass and the eager one must give the same checksum,
    ``want`` (the chunk count times the CPU oracle's), and agree again on
    an input whose lane 0 holds lane 1's word, which the graph must read
    from its input buffer; then ``passes`` passes of each, timed in turns.
    Returns (the kernel's launches, the worst overflow the pass returned,
    the median seconds of a pass of each kind)."""
    def chk_of(res):
        return res[0] if isinstance(res, tuple) else res

    reset_launches()
    t0 = time.perf_counter()
    res = graph_pass(x)
    first_s = time.perf_counter() - t0
    launches = probe.LAUNCHES if probe else None
    if probe and launches == 0:
        raise AssertionError(f"[{tag}] the replayed pass never launched the "
                             f"{probe.SOURCE.stem} kernel")
    chk, worst = res if isinstance(res, tuple) else (res, None)
    cap = list(index.graphs.values())[-1]
    eager_chk = chk_of(eager_pass(x))
    if not chk == eager_chk == want:
        raise AssertionError(f"[{tag}] replayed checksum {chk}, eager {eager_chk}, oracle x chunks "
                             f"{want}")
    other = x.clone()
    other[0] = x[1]
    other_chk = chk_of(graph_pass(other))
    if other_chk != chk_of(eager_pass(other)) or other_chk == want:
        raise AssertionError(f"[{tag}] on a changed input the replayed pass gives {other_chk}, "
                             f"the eager pass {chk_of(eager_pass(other))}")
    name = f", {probe.SOURCE.stem} launches {launches} (the eager warm-up's and the captured)" \
        if probe else ""
    log(f"[{tag}] first replayed pass {first_s:.3f} s (capture {cap.capture_s:.3f} s of it; "
        f"graph pool {cap.pool_bytes} bytes): checksum {chk} == eager == oracle x chunks{name}; "
        f"with lane 0 changed, replayed == eager {other_chk}")
    t = {"graph": [], "eager": []}
    for _ in range(passes):
        for kind, run in (("graph", graph_pass), ("eager", eager_pass)):
            t0 = time.perf_counter()
            out = run(x)
            t[kind].append(time.perf_counter() - t0)
            if chk_of(out) != want:
                raise AssertionError(f"[{tag}] timed {kind} pass checksum differs")
    for kind in ("graph", "eager"):
        rates = sorted(n_queries / s for s in t[kind])
        log(f"[{tag}] {kind} pass, {passes} in turns: median {statistics.median(rates):.1f} "
            f"queries/s (min {rates[0]:.1f}, max {rates[-1]:.1f}) ({smi})")
    return launches, worst, {kind: statistics.median(v) for kind, v in t.items()}


def profile_both(tag: str, run_graph, run_eager, times: dict):
    """Phase 18: one profiled replayed pass and one profiled eager pass."""
    profile_pass(f"{tag} graph", run_graph, times["graph"])
    profile_pass(f"{tag} eager", run_eager, times["eager"])


def derived_capture_raises(dev):
    """A tensor that a wrapper derives from an index, first asked for
    inside a CUDA graph capture, raises rather than come from the graph's
    pool."""
    src = torch.zeros(4, dtype=torch.int64, device=dev)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            derived(src, "a check", lambda: src + 1)
    except RuntimeError as e:
        if "CUDA graph capture" not in str(e):
            raise
        log(f"[graph] a derived tensor first asked for during capture raises: {e}")
    else:
        raise AssertionError("a derived tensor was made inside a CUDA graph capture")
    del graph
    torch.cuda.synchronize()


def profile_pass(tag: str, run, pass_s: float):
    """One profiled pass (``run()``): device busy share, kernel launches,
    the kernels that take the most device time and the probe kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    if not events:
        log(f"[profile {tag}] the profiler gave no per-kernel device records for this pass")
    busy_us = sum(e.self_device_time_total for e in events)
    n_kernels = sum(e.count for e in events)
    log(f"[profile {tag}] profiled pass {wall * 1e3:.1f} ms (unprofiled {pass_s * 1e3:.1f} ms); device "
        f"busy {busy_us / 1e3:.2f} ms = {100 * busy_us / (pass_s * 1e6):.1f}% of an unprofiled "
        f"pass; {n_kernels} device kernels")
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    # the twelve that take the most time, and every probe kernel of the repo
    for e in ranked[:12] + [e for e in ranked[12:] if "_probe_kernel" in e.key]:
        log(f"[profile {tag}] {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d} x  {e.key[:90]}")


if __name__ == "__main__":
    main()
