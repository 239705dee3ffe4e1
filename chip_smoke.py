"""Run the port's main paths once on one CUDA card and check them.

    python3 chip_smoke.py [--mbp 50] [--cap-mbp 300] [--mphf-mbp 300]

Phases, each printing its own lines; any failure exits non-zero:

1. card check (fails without CUDA) and the card's name and power limit;
2. build of the three kernels from ``mazu_tpu_torch/csrc``, one nvcc each,
   run together (phases 6 and 10 print the second and third kernels'
   reports);
3. the synthetic mono2-occ32 KCDict index (random genome, k=31, 10 kb
   unitigs, every 16th unitig with 3 occurrences, load 0.25), moved to the
   card;
4. the mono2 kernel (K1) against its plain torch version on the card:
   ragged and adversarial small batches, then 2^20 queries (uniform over
   the index, half reverse-complemented, 5% foreign); all nine fields
   bit-identical; both timed;
5. the mono2 main path: ``OneGraphIndexQuery.checksum_pass_rolled`` over
   16 rolled chunks of that batch, checked against the port's plain path
   on CPU tensors for chunk 0, and timed over 3 passes;
6. the bpos probe kernel's (K2) ptxas report;
7. the synthetic capacity index: an SSHash direct engine (w=15, skew 64,
   load 0.5) over a random genome with a planted skew bucket, its
   minimizer scan on the card; grouped16 bounds, packed positions, bpos
   rows and useqrec window records;
8. K2 against its plain torch version on the card, all nine fields
   bit-identical: N=1, N=257 with a foreign word and a skew lane, probe
   limits 1-3, then 2^20 queries; both timed;
9. the capacity path: ``OneGraphIndexQuery.checksum_pass_rolled`` over 8
   rolled chunks of 2^20 queries at probe limit 2, middle phase 4; the
   port's plain path on CPU tensors gives chunk 0's oracle, which must hit
   every sampled lane at its sampled unitig and offset; timed over 3
   passes;
10. the capacity probe kernel's (K3) ptxas report;
11. K3 on the direct layout: phase 7's arrays on the card without bpos and
    useqrec, plus the per-unitig ``uproj`` records; against its plain
    torch version, all ten fields bit-identical, at probe limits 1-3 on
    N=1, N=257 and 2^20; both timed;
12. the synthetic MPHF index: an SSHash fast32 engine (BooPHF32 minimizer
    MPHF, w=19, skew 64, gamma 1.7) over a random genome with a planted
    skew minimizer, its minimizer scan and MPHF lookup on the card;
    grouped16 bounds, packed positions, paired arrays, uproj records;
13. K3 against its plain version on the MPHF index, all ten fields
    bit-identical, at MPHF level limits None and 4 and probe limits 1-3:
    N=1, N=257 (a skew lane, a foreign word, all-T, k-mers read across
    unitig boundaries) and 2^20; both timed, and K3 at other level limits;
14. the MPHF path: ``OneGraphIndexQuery.checksum_pass_rolled`` over 8
    rolled chunks of 2^20 queries at probe limit 2, level limit 4,
    deferred validation, middle phase 4, checked against a CPU oracle as
    in phase 9; timed over 3 passes;
15. one profiled pass of each of the paths of phases 9 and 14: device busy
    share and the kernels that take the time. It runs last because a
    profiler session slows the host's launches for the rest of the process
    (measured: the MPHF pass took 1.6-2x longer after one).

The last two lines are the kernels' JSON record and the result JSON.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from mazu_tpu_torch._words import mask32
from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index.modindex import (
    QueryIndex, build_uproj, get_ref_pos_compact, get_ref_pos_padded, merge_compact_k2u,
)
from mazu_tpu_torch.index.pipeline import OneGraphIndexQuery
from mazu_tpu_torch.kmer import canonical_minimizer_batch, mask2k, revcomp_np
from mazu_tpu_torch.kphf.boophf32 import fold_hash32
from mazu_tpu_torch.kphf.kcdict import kcdict_k2u
from mazu_tpu_torch.kphf.sshash import mphf_lookup, sshash_k2u
from mazu_tpu_torch.ops import bpos_probe, capacity_probe, mono2_probe
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


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call on the card, after a warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def ptxas_lines(report: str):
    return [ln.strip() for ln in report.splitlines() if "registers" in ln or "spill" in ln]


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
    (lib, ptxas), (lib2, ptxas2), (lib3, ptxas3) = compile_all(
        [mono2_probe.SOURCE, bpos_probe.SOURCE, capacity_probe.SOURCE])
    log(f"[build] {lib.name}, {lib2.name} and {lib3.name} in {time.perf_counter() - t0:.2f} s")
    for line in ptxas_lines(ptxas):
        log(f"[build] {line}")

    # 3. index
    t0 = time.perf_counter()
    index = synth.build_index(int(args.mbp * 1e6), seed=0)
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

    # 4. kernel vs plain version
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

    work = synth.sample_queries(us, BATCH, seed=1)
    fw = torch.from_numpy(work.view(np.int64)).to(dev)
    max_err = compare_k2u(d["k2u"], fw, f"N={BATCH}")
    k1_ms = cuda_ms(lambda: mono2_probe.mono2_k2u(d["k2u"], fw), 20)
    plain_ms = cuda_ms(lambda: kcdict_k2u(d["k2u"], fw, mode="main"), 5)
    log(f"[k1] N={BATCH}: bit-identical on all nine fields; kernel {k1_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms ({smi})")

    # 5. main path
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

    k1 = {
        "name": "mono2_probe",
        "route": "cuda",
        "source": "mazu_tpu_torch/csrc/mono2_probe.cu",
        "replaces": "mazu_tpu/ops/pallas_query.py:46",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
    }
    del og, gpu_index, d, fw, r
    torch.cuda.empty_cache()

    # 6. K2 build report
    log(f"[k2 build] {lib2.name}")
    for line in ptxas_lines(ptxas2):
        log(f"[k2 build] {line}")

    k2, profile_cap = capacity(args, dev, smi, lib3.name, ptxas3)
    torch.cuda.empty_cache()
    k3, profile_mphf = mphf(args, dev, smi)

    # 15. profiled passes
    profile_cap()
    profile_mphf()
    log(json.dumps({"kernels": [k1, k2, k3]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


def n_occs_of(k2u: dict, fw: torch.Tensor) -> torch.Tensor:
    """Occurrence count of each query's minimizer bucket (its bpos row)."""
    m = k2u["meta"]
    mm = canonical_minimizer_batch(fw, m.k, m.w, m.seed)[0]
    return mask32(k2u["bpos"][fold_hash32(mm) & (m.direct_t - 1), 3])


def capacity(args, dev, smi, lib3: str, ptxas3: str):
    """Phases 7-11; returns K2's record for the kernels line and the
    capacity path's profiled pass."""
    # 7. the capacity index
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

    # 8. K2 against its plain version
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
    log(f"[k2] N={BATCH}: kernel {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms ({smi})")
    del want

    # 9. the capacity main path
    launches, m2c, profile = sshash_path(
        "cap main", cpu_index, gpu_index, work, uid, upos, fw,
        dict(probe_limit=PLIM, defer_valid=True, probe_limit2=PLIM2), bpos_probe, smi)
    res_ms = cuda_ms(lambda: get_ref_pos_padded(d, fw[:m2c], gpu_index.max_occs), 5)
    log(f"[cap main] residue phase alone (full mode, static loop to probe_bound={m.probe_bound}) "
        f"on {m2c} lanes: {res_ms:.3f} ms ({smi})")

    # 10. K3 build report
    log(f"[k3 build] {lib3}")
    for line in ptxas_lines(ptxas3):
        log(f"[k3 build] {line}")

    # 11. K3 on the direct layout: these arrays without bpos and useqrec,
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
    return {
        "name": "bpos_probe",
        "route": "cuda",
        "source": "mazu_tpu_torch/csrc/bpos_probe.cu",
        "replaces": "mazu_tpu/ops/pallas_capacity.py:266",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k2_ms,
        "plain_ms": k2_plain_ms,
    }, profile


def sshash_path(tag: str, cpu_index, gpu_index, work, uid, upos, fw, query: dict, probe,
                smi) -> tuple[int, int, object]:
    """Phases 9 and 14: an SSHash main path with the type-split heavy phase
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
    return launches, m2c, lambda: profile_pass(tag, og, fw, dt / iters)


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
    """Phases 12-14; returns K3's record for the kernels line and the MPHF
    path's profiled pass."""
    # 12. the MPHF index
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

    # 13. K3 against its plain version
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
    log(f"[k3 mphf] N={BATCH} at probe limit {PLIM}, level limit {MLIM}: kernel {k3_ms:.4f} ms, "
        f"plain {k3_plain_ms:.4f} ms ({smi})")
    for mlim in (1, 2, None):
        kern_l = k3(PLIM, mlim)[0]
        log(f"[k3 mphf] N={BATCH} at probe limit {PLIM}, level limit {mlim}: kernel "
            f"{cuda_ms(lambda: kern_l(k2u, fw), 20):.4f} ms ({smi})")

    # 14. the MPHF main path
    launches, _, profile = sshash_path("mphf main", cpu_index, gpu_index, work, uid, upos, fw,
                                       synth.MPHF_QUERY, capacity_probe, smi)
    return {
        "name": "capacity_probe",
        "route": "cuda",
        "source": "mazu_tpu_torch/csrc/capacity_probe.cu",
        "replaces": "mazu_tpu/ops/pallas_capacity.py:56",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k3_ms,
        "plain_ms": k3_plain_ms,
    }, profile


def profile_pass(tag: str, og, fw, pass_s: float):
    """One profiled capacity pass: device busy share, kernel launches, and
    the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        og.checksum_pass_rolled(fw)
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
