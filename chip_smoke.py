"""Run the port's main path once on one CUDA card and check it.

    python3 chip_smoke.py [--mbp 50]

Phases, each printing its own lines; any failure exits non-zero:

1. card check (fails without CUDA) and the card's name and power limit;
2. build of the mono2 probe kernel from ``mazu_tpu_torch/csrc``;
3. the synthetic mono2-occ32 KCDict index (random genome, k=31, 10 kb
   unitigs, every 16th unitig with 3 occurrences, load 0.25), moved to the
   card;
4. the kernel against its plain torch version on the card: ragged and
   adversarial small batches, then 2^20 queries (uniform over the index,
   half reverse-complemented, 5% foreign); all nine fields bit-identical;
   both timed;
5. the main path: ``OneGraphIndexQuery.checksum_pass_rolled`` over 16
   rolled chunks of that batch, checked against the port's plain path on
   CPU tensors for chunk 0, and timed over 3 passes.

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

from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index.modindex import QueryIndex, get_ref_pos_compact, get_ref_pos_padded
from mazu_tpu_torch.index.pipeline import OneGraphIndexQuery
from mazu_tpu_torch.kmer import mask2k, revcomp_np
from mazu_tpu_torch.kphf.kcdict import kcdict_k2u
from mazu_tpu_torch.ops import mono2_probe
from mazu_tpu_torch import synth

BATCH = 1 << 20
CH = 16
FIELDS = ("unitig_id", "unitig_len", "pos", "occ_cnt", "mt", "occ_word", "occ_word2",
          "use_skew", "unresolved")


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


def compare_k2u(d: dict, fw: torch.Tensor, what: str) -> int:
    """Kernel vs plain version on the same card tensors; every field must
    be bit-identical. Returns the max absolute difference (0)."""
    got = mono2_probe.mono2_k2u(d, fw)
    want = kcdict_k2u(d, fw, mode="main")
    err = 0
    for key in FIELDS:
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mbp", type=float, default=50.0, help="genome size in Mbp")
    args = ap.parse_args()

    # 1. card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs only on the card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # 2. kernel build
    t0 = time.perf_counter()
    lib, ptxas = mono2_probe.compile_library()
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.2f} s")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

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
    mono2_probe.LAUNCHES = 0
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

    log(json.dumps({"kernels": [{
        "name": "mono2_probe",
        "route": "cuda",
        "source": "mazu_tpu_torch/csrc/mono2_probe.cu",
        "replaces": "mazu_tpu/ops/pallas_query.py:46",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
