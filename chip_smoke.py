"""Run the port's main paths once on one CUDA card and check them.

    python3 chip_smoke.py [--mbp 50] [--cap-mbp 300] [--mphf-mbp 300]

Phases, each printing its own lines; any failure exits non-zero:

1. card check (fails without CUDA) and the card's name and power limit;
2. build of the four kernel sources from ``mazu_tpu_torch/csrc``, one nvcc
   each, run together (phases 3, 9 and 13 print the reports of the lab,
   second and third sources);
3. the lab kernels L1-L5 (``csrc/gather_lab.cu``) against their plain torch
   versions on the card at the labs' shapes, N=1, a ragged N and all-same
   indices, bit-identical; then the two lab entry points
   (``mazu_tpu_torch.labs.gather_probe`` and ``dma_lab``) as their main
   path; each kernel timed beside its plain version, its bound and the
   torch call that computes the same (``tbl[idx]``, ``index_select``);
4. the synthetic mono2-occ32 KCDict index (random genome, k=31, 10 kb
   unitigs, every 16th unitig with 3 occurrences, load 0.25), moved to the
   card;
5. the mono2 kernel (K1) against its plain torch version on the card:
   ragged and adversarial small batches, then 2^20 queries (uniform over
   the index, half reverse-complemented, 5% foreign); all nine fields
   bit-identical; both timed;
6. the mono2 main path: ``OneGraphIndexQuery.checksum_pass_rolled`` over
   16 rolled chunks of that batch, checked against the port's plain path
   on CPU tensors for chunk 0, and timed over 3 passes;
7. the pufferfish dense index (PFHash over a 64-bit BooPHF, the pf1
   occurrence table) over phase 4's genome, its MPHF lookup on the card;
   the 64-bit ``boophf_lookup`` on the card against the CPU on phase 5's
   2^20 canonical words; the padded path (``get_ref_pos_padded`` and
   ``bench.py``'s full-mode checksum) on phase 5's batch: a CPU oracle for
   chunk 0 that must hit every sampled lane at its sampled unitig and
   offset, then 16 rolled chunks on the card equal to 16 x the oracle,
   timed over 3 passes;
8. the same for pufferfish's sparse index (SampledPFHash, sample 9,
   extension 4);
9. the bpos probe kernel's (K2) ptxas report;
10. the synthetic capacity index: an SSHash direct engine (w=15, skew 64,
    load 0.5) over a random genome with a planted skew bucket, its
    minimizer scan on the card; grouped16 bounds, packed positions, bpos
    rows and useqrec window records;
11. K2 against its plain torch version on the card, all nine fields
    bit-identical: N=1, N=257 with a foreign word and a skew lane, probe
    limits 1-3, then 2^20 queries; both timed;
12. the capacity path: ``OneGraphIndexQuery.checksum_pass_rolled`` over 8
    rolled chunks of 2^20 queries at probe limit 2, middle phase 4; the
    port's plain path on CPU tensors gives chunk 0's oracle, which must hit
    every sampled lane at its sampled unitig and offset; timed over 3
    passes;
13. the capacity probe kernel's (K3) ptxas report;
14. K3 on the direct layout: phase 10's arrays on the card without bpos and
    useqrec, plus the per-unitig ``uproj`` records; against its plain
    torch version, all ten fields bit-identical, at probe limits 1-3 on
    N=1, N=257 and 2^20; both timed;
15. the synthetic MPHF index: an SSHash fast32 engine (BooPHF32 minimizer
    MPHF, w=19, skew 64, gamma 1.7) over a random genome with a planted
    skew minimizer, its minimizer scan and MPHF lookup on the card;
    grouped16 bounds, packed positions, paired arrays, uproj records;
16. K3 against its plain version on the MPHF index, all ten fields
    bit-identical, at MPHF level limits None and 4 and probe limits 1-3:
    N=1, N=257 (a skew lane, a foreign word, all-T, k-mers read across
    unitig boundaries) and 2^20; both timed, and K3 at other level limits;
17. the MPHF path: ``OneGraphIndexQuery.checksum_pass_rolled`` over 8
    rolled chunks of 2^20 queries at probe limit 2, level limit 4,
    deferred validation, middle phase 4, checked against a CPU oracle as
    in phase 12; timed over 3 passes;
18. one profiled pass of each of the paths of phases 7, 8, 12 and 17:
    device busy share and the kernels that take the time. It runs last
    because a profiler session slows the host's launches for the rest of
    the process (measured: the MPHF pass took 1.6-2x longer after one).

Each kernel's ``bound_ms`` is the least time the card could take for the
same work: the bytes it must move (each input read once, only the rows a
lane reads; each output written once) over 3.35 TB/s, or its integer
operations over 67 T/s where that is larger. The last two lines are the
kernels' JSON record and the result JSON. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import time

import numpy as np
import torch

from mazu_tpu_torch._words import mask32, umin
from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index.modindex import (
    QueryIndex, build_uproj, get_ref_pos_compact, get_ref_pos_padded, merge_compact_k2u,
)
from mazu_tpu_torch.index.pipeline import (
    OneGraphIndexQuery, checksum_padded_rolled, padded_checksum,
)
from mazu_tpu_torch.kmer import canonical_minimizer_batch, mask2k, revcomp, revcomp_np
from mazu_tpu_torch.kphf.boophf import boophf_lookup
from mazu_tpu_torch.kphf.boophf32 import chain_next, fold_hash32, key_fold32
from mazu_tpu_torch.kphf.kcdict import kcdict_k2u
from mazu_tpu_torch.kphf.sshash import _prefix_pair, mphf_lookup, sshash_k2u
from mazu_tpu_torch.labs import cuda_ms, dma_lab, gather_probe
from mazu_tpu_torch.ops import bpos_probe, capacity_probe, gather_lab, mono2_probe
from mazu_tpu_torch.ops.cuda_build import compile_all
from mazu_tpu_torch import synth

BATCH = 1 << 20
CH = 16
CAP_CH = 8  # rolled chunks per capacity pass (bench.py:366)
PLIM, PLIM2 = 2, 4  # capacity probe limits: main phase, middle phase
FIELDS = ("unitig_id", "unitig_len", "pos", "occ_cnt", "mt", "occ_word", "occ_word2",
          "use_skew", "unresolved")
FIELDS3 = FIELDS + ("occ_start",)  # K3 with uproj records
MLIM = synth.MPHF_QUERY["mphf_level_limit"]  # the MPHF path's main-phase level limit
HBM_BPS = 3.35e12  # H100 SXM device memory, bytes/s
INT_OPS = 67e12  # H100 SXM non-tensor rate (the guide's float32 figure), operations/s
K2U_OUT = 6 * 8 + 3  # bytes of a lane's nine K1/K2 outputs (six int64, three u8/bool)


def log(*a):
    print(*a, flush=True)


def bound(n_bytes: float, n_ops: float = 0.0) -> tuple[float, str]:
    """(milliseconds, what bounds it): the larger of ``n_bytes`` over the
    card's memory rate and ``n_ops`` over its integer rate."""
    t_bytes, t_ops = n_bytes / HBM_BPS * 1e3, n_ops / INT_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def record(name: str, source: str, replaces: str, launches: int, max_err: int, ms: float,
           plain_ms: float, bound_ms: tuple[float, str], library_ms=None) -> dict:
    """One kernel's entry of the kernels line."""
    return {
        "name": name, "route": "cuda", "source": f"mazu_tpu_torch/csrc/{source}",
        "replaces": replaces, "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms[0], "bound_by": bound_ms[1],
        "library_ms": library_ms,
    }


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


def slot1_key(table: np.ndarray) -> int:
    """Canonical k-mer stored in slot 1 of the first bucket that uses it."""
    row = table[int(np.flatnonzero(table[:, 7] != 0xFFFFFFFF)[0])]
    return int(row[7]) | ((int(row[8]) & 0x7FFFFFFF) << 32)


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

    # 3. the lab kernels
    labs = lab_kernels(dev, smi, lib4.name, ptxas4)

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

    # 5. kernel vs plain version
    k = index.k
    key1 = slot1_key(host["k2u"]["table"])
    small = synth.sample_queries(us, 513, seed=2)
    small[:4] = [0, mask2k(k), key1, revcomp_np(np.array([key1], np.uint64), k)[0]]
    for words in (small[2:3], small):
        compare_k2u(d["k2u"], torch.from_numpy(words.view(np.int64)).to(dev), f"N={len(words)}")
    r = mono2_probe.mono2_k2u(d["k2u"], torch.from_numpy(small[2:4].view(np.int64)).to(dev))
    if bool(r["unresolved"].any()) or sorted(r["mt"].tolist()) != [1, 2]:
        raise AssertionError(f"slot-1 key and its reverse complement: mt={r['mt'].tolist()}")
    log("[k1] N=1, N=513, all-A, all-T and slot-1 key: bit-identical")

    truth = synth.sample_queries_truth(us, BATCH, seed=1)
    work = truth[0]
    fw = torch.from_numpy(work.view(np.int64)).to(dev)
    max_err = compare_k2u(d["k2u"], fw, f"N={BATCH}")
    k1_ms = cuda_ms(lambda: mono2_probe.mono2_k2u(d["k2u"], fw), 20)
    plain_ms = cuda_ms(lambda: kcdict_k2u(d["k2u"], fw, mode="main"), 5)
    log(f"[k1] N={BATCH}: bit-identical on all nine fields; kernel {k1_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms ({smi})")

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

    og = OneGraphIndexQuery(gpu_index, BATCH, n_chunks=CH, m2=M2)
    reset_launches()
    t0 = time.perf_counter()
    chk, worst = og.checksum_pass_rolled(fw)
    first_s = time.perf_counter() - t0
    launches = mono2_probe.LAUNCHES
    if launches == 0:
        raise AssertionError("the main path never launched the mono2 probe kernel")
    if chk != CH * host_chk or worst > M2:
        raise AssertionError(f"device checksum {chk} vs {CH} x {host_chk}; worst {worst} vs M2 {M2}")
    log(f"[main] first pass {first_s:.3f} s: checksum {chk} == {CH} x oracle, worst overflow "
        f"{worst} <= M2, mono2_probe launches {launches}")
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        chk, _ = og.checksum_pass_rolled(fw)
        if chk != CH * host_chk:
            raise AssertionError(f"timed pass checksum {chk} != {CH} x {host_chk}")
    dt = time.perf_counter() - t0
    log(f"[main] {iters} x {CH} x {BATCH} queries in {dt:.4f} s: {BATCH * CH * iters / dt:.1f} "
        f"queries/s; overflow share {n_ovf / BATCH:.4f} ({smi})")

    # one 56-byte row, the key and the nine outputs per lane
    k1_bound = bound(BATCH * (8 + 4 * table.shape[1] + K2U_OUT))
    log(f"[k1] bound {k1_bound[0]:.4f} ms ({k1_bound[1]}); no single torch call computes the "
        f"probe ({smi})")
    k1 = record("mono2_probe", "mono2_probe.cu", "mazu_tpu/ops/pallas_query.py:46", launches,
                max_err, k1_ms, plain_ms, k1_bound)
    del og, gpu_index, d, fw, r
    torch.cuda.empty_cache()

    # 7-8. the pufferfish dense and sparse paths over this genome
    profile_pf1 = [pf1_path(kind, genome, n_bases, truth, dev, smi) for kind in ("dense", "sparse")]
    del genome, index
    torch.cuda.empty_cache()

    # 9. K2 build report
    log(f"[k2 build] {lib2.name}")
    for line in ptxas_lines(ptxas2):
        log(f"[k2 build] {line}")

    k2, profile_cap = capacity(args, dev, smi, lib3.name, ptxas3)
    torch.cuda.empty_cache()
    k3, profile_mphf = mphf(args, dev, smi)

    # 18. profiled passes
    for profile in (*profile_pf1, profile_cap, profile_mphf):
        profile()
    log(json.dumps({"kernels": [k1, k2, k3, *labs]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


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


def k3_lane_bytes(k2u: dict, fw: torch.Tensor, plim: int, mlim: int) -> int:
    """Bytes K3 must move on this batch, each read once and only what a
    lane reads: its key; one u32 MPHF word per level tested up to the first
    hit (at most ``mlim``); for a placed lane its block's u32 rank and the
    words before the hit word in the block; for a placed lane that is not
    skew, two u16 bucket deltas, one or two i64 group bases, and the
    position bits and three useq words of each probed row; for a winner two
    wb2 words and a count and its 40-byte uproj row; and 59 bytes of
    outputs. A deferred winner that fails validation counts as a miss."""
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
    tail = torch.where(last["mt"] > 0, 24 + 40, 0)
    return int((8 + 4 * levels + rank + bucket + tail + 59).sum())


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

    err = dict.fromkeys(g.NAMES, 0)

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
        "unaligned view): bit-identical")

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
    out = []
    for name, replaces in LAB:
        kern, plain, library, bnd = spec[name]
        ms, plain_ms = cuda_ms(kern, 50), cuda_ms(plain, 10)
        lib_ms = cuda_ms(library, 50) if library else None
        if name in ("gather_u32", "hash_mix32x8"):
            rate = f"{N / ms / 1e6:.3f} G words/s"
        else:
            rate = f"{NR / ms / 1e3:.1f} M rows/s, {NR * row_b / ms / 1e6:.1f} GB/s of 512B rows"
        lib_txt = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
        log(f"[lab] {name}: kernel {ms:.4f} ms ({rate}), plain {plain_ms:.4f} ms, torch call "
            f"{lib_txt}, bound {bnd[0]:.4f} ms ({bnd[1]}) ({smi})")
        out.append(record(name, "gather_lab.cu", replaces, launches[name], err[name], ms, plain_ms,
                          bnd, lib_ms))
    return out


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
    t0 = time.perf_counter()
    chk = checksum_padded_rolled(gpu_index, fw, CH)
    first_s = time.perf_counter() - t0
    if chk != CH * host_chk:
        raise AssertionError(f"[{tag}] device checksum {chk} vs {CH} x {host_chk}")
    log(f"[{tag}] first pass {first_s:.3f} s: checksum {chk} == {CH} x oracle")
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        if checksum_padded_rolled(gpu_index, fw, CH) != CH * host_chk:
            raise AssertionError(f"[{tag}] timed pass checksum differs")
    dt = time.perf_counter() - t0
    log(f"[{tag}] {iters} x {CH} x {BATCH} queries in {dt:.4f} s: {BATCH * CH * iters / dt:.1f} "
        f"queries/s ({smi})")
    return lambda: profile_pass(tag, lambda: checksum_padded_rolled(gpu_index, fw, CH), dt / iters)


def capacity(args, dev, smi, lib3: str, ptxas3: str):
    """Phases 10-14; returns K2's record for the kernels line and the
    capacity path's profiled pass."""
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
    log(f"[k2] N={BATCH}: kernel {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms; {int(rows.sum())} "
        f"records read; bound {k2_bound[0]:.4f} ms ({k2_bound[1]}) ({smi})")
    del want

    # 12. the capacity main path
    launches, m2c, profile = sshash_path(
        "cap main", cpu_index, gpu_index, work, uid, upos, fw,
        dict(probe_limit=PLIM, defer_valid=True, probe_limit2=PLIM2), bpos_probe, smi)
    res_ms = cuda_ms(lambda: get_ref_pos_padded(d, fw[:m2c], gpu_index.max_occs), 5)
    log(f"[cap main] residue phase alone (full mode, static loop to probe_bound={m.probe_bound}) "
        f"on {m2c} lanes: {res_ms:.3f} ms ({smi})")

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
    kern, plain = k3(PLIM)
    k3_ms = cuda_ms(lambda: kern(k3d, fw), 20)
    k3_plain_ms = cuda_ms(lambda: plain(k3d, fw), 5)
    log(f"[k3 direct] N=1, N=257 and 2^20 at probe limits 1-3: bit-identical on all ten fields; "
        f"N={BATCH} at probe limit {PLIM}: kernel {k3_ms:.4f} ms, plain {k3_plain_ms:.4f} ms "
        f"({smi})")
    return record("bpos_probe", "bpos_probe.cu", "mazu_tpu/ops/pallas_capacity.py:266",
                  launches, max_err, k2_ms, k2_plain_ms, k2_bound), profile


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
    name = probe.SOURCE.stem
    reset_launches()
    t0 = time.perf_counter()
    chk, worst = og.checksum_pass_rolled(fw)
    first_s = time.perf_counter() - t0
    launches = probe.LAUNCHES
    if launches == 0:
        raise AssertionError(f"[{tag}] the main path never launched the {name} kernel")
    if chk != CAP_CH * host_chk:
        raise AssertionError(f"[{tag}] device checksum {chk} vs {CAP_CH} x {host_chk}")
    log(f"[{tag}] first pass {first_s:.3f} s: checksum {chk} == {CAP_CH} x oracle, worst "
        f"(type-A, type-B) {worst} within (m2, m2b), {name} launches {launches}")
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        chk, _ = og.checksum_pass_rolled(fw)
        if chk != CAP_CH * host_chk:
            raise AssertionError(f"[{tag}] timed pass checksum {chk} != {CAP_CH} x {host_chk}")
    dt = time.perf_counter() - t0
    log(f"[{tag}] {iters} x {CAP_CH} x {BATCH} queries in {dt:.4f} s: "
        f"{BATCH * CAP_CH * iters / dt:.1f} queries/s ({smi})")
    return launches, m2c, lambda: profile_pass(tag, lambda: og.checksum_pass_rolled(fw), dt / iters)


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


def mphf(args, dev, smi):
    """Phases 15-17; returns K3's record for the kernels line and the MPHF
    path's profiled pass."""
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
    del want
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
    k3_bytes = k3_lane_bytes(k2u, fw, PLIM, MLIM)
    k3_bound = bound(k3_bytes)
    log(f"[k3 mphf] N={BATCH} at probe limit {PLIM}, level limit {MLIM}: kernel {k3_ms:.4f} ms, "
        f"plain {k3_plain_ms:.4f} ms; {k3_bytes} bytes read and written; bound "
        f"{k3_bound[0]:.4f} ms ({k3_bound[1]}) ({smi})")
    for mlim in (1, 2, None):
        kern_l = k3(PLIM, mlim)[0]
        log(f"[k3 mphf] N={BATCH} at probe limit {PLIM}, level limit {mlim}: kernel "
            f"{cuda_ms(lambda: kern_l(k2u, fw), 20):.4f} ms ({smi})")

    # 17. the MPHF main path
    launches, _, profile = sshash_path("mphf main", cpu_index, gpu_index, work, uid, upos, fw,
                                       synth.MPHF_QUERY, capacity_probe, smi)
    return record("capacity_probe", "capacity_probe.cu", "mazu_tpu/ops/pallas_capacity.py:56",
                  launches, max_err, k3_ms, k3_plain_ms, k3_bound), profile


def profile_pass(tag: str, run, pass_s: float):
    """One profiled pass (``run()``): device busy share, kernel launches,
    and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_us = sum(e.self_device_time_total for e in events)
    n_kernels = sum(e.count for e in events)
    log(f"[profile {tag}] profiled pass {wall * 1e3:.1f} ms (unprofiled {pass_s * 1e3:.1f} ms); device "
        f"busy {busy_us / 1e3:.2f} ms = {100 * busy_us / (pass_s * 1e6):.1f}% of an unprofiled "
        f"pass; {n_kernels} device kernels")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[profile {tag}] {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d} x  {e.key[:90]}")


if __name__ == "__main__":
    main()
