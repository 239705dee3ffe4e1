"""Phase 2 of the two-phase query on a mono2-occ32 KCDict
(``ops/mono2_phase2``), on the CPU.

- The dispatch: ``mono2_phase2.engages`` is true only for a mono2-occ32
  KCDict in K1's rows with ``ctable2`` pair rows on a CUDA device, and
  false for every other index the port builds and for CPU tensors (asked
  with a device name: no card is needed); and ``get_ref_pos_compact``
  calls the kernel's wrapper exactly where it engages, never in a
  type-split phase 2, with unchanged results.
- The plain contract the kernel is held to: phase 2's real slots equal
  ``get_ref_pos_padded`` on the compacted lanes, on a batch of side-table
  keys, true misses and keys of the unitigs with the most occurrences, at
  n_ovf 0 and at n_ovf of M; a marked pass's ``side_probes`` counts the
  real lanes the main table did not hold.
- The kernel's own logic: ``csrc/mono2_phase2.cu`` built with the host's
  C++ compiler against a stand-in of the CUDA runtime (one thread a GPU
  thread, a block at a time), every field of the real slots against the
  plain version, on those batches, at n_ovf 0, N and past M, at widths
  past a block's threads, and on pf1 words.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from mazu_tpu_torch import synth, trace
from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index import modindex
from mazu_tpu_torch.index.modindex import (
    ModIndex, QueryIndex, get_ref_pos_compact, get_ref_pos_padded,
)
from mazu_tpu_torch.index.unitig_table import WMUnitigTable
from mazu_tpu_torch.kmer import revcomp_np
from mazu_tpu_torch.kphf.kcdict import SLOTS, SW, KCDict, kcdict_k2u
from mazu_tpu_torch.ops import mono2_phase2, mono2_probe

N_BASES = 8 * synth.PIECE
M2 = 512


@pytest.fixture(scope="module")
def genome():
    return synth.synthetic_spt(N_BASES, seed=0)


@pytest.fixture(scope="module")
def mono2(genome):
    return synth.build_index(N_BASES, seed=0, genome=genome)


def on_card(index: ModIndex, **kw) -> dict:
    """The index's arrays as they lie on the card (``QueryIndex.to`` on the
    meta device: shapes and dtypes, no data)."""
    return QueryIndex(arrays_from_numpy(index.device_arrays(**kw), "cpu")).to("meta").arrays()


def card_layout_on_cpu(index: ModIndex) -> dict:
    """The index's arrays on the CPU, its main table in K1's rows."""
    d = arrays_from_numpy(index.device_arrays(), "cpu")
    if "table" in d["k2u"]:
        d["k2u"]["table"] = mono2_probe.card_table(d["k2u"]["meta"], d["k2u"]["table"])
    return d


def kcdict_index(genome, scheme: str, table: str = "piscem") -> ModIndex:
    unitigs, refs, spt = genome
    u2pos = spt.piscem_table() if table == "piscem" else spt.dense_table()
    k2u = KCDict.from_unitig_set(unitigs, load=synth.LOAD, occ_table=u2pos, scheme=scheme)
    return ModIndex(k2u, u2pos, refs, index_type="t")


# every index kind the port builds but the one the kernel takes
OTHER_KINDS = {
    "cuckoo KCDict": lambda g: kcdict_index(g, "cuckoo"),
    "mono KCDict": lambda g: kcdict_index(g, "mono"),
    "mono2 KCDict with 64-bit words": lambda g: kcdict_index(g, "mono2", table="pf1"),
    "mono2 KCDict over a wavelet-matrix table": lambda g: ModIndex(
        kcdict_index(g, "mono2").k2u, WMUnitigTable.from_piscem(g[2].piscem_table()), g[1]),
    "SSHash speed": lambda g: synth.build_speed_index(N_BASES, device="cpu", genome=g),
    "SSHash capacity": lambda g: synth.build_capacity_index(N_BASES, device="cpu",
                                                            heavy_sites=64),
    "SSHash fast32": lambda g: synth.build_mphf_index(N_BASES, device="cpu", heavy_sites=64),
    "pufferfish dense": lambda g: synth.build_pf1_dense_index(N_BASES, device="cpu", genome=g),
    "pufferfish sparse": lambda g: synth.build_pf1_sparse_index(N_BASES, device="cpu", genome=g),
}


def test_engages_on_the_mono2_occ32_card_layout(mono2):
    d = on_card(mono2)
    assert d["k2u"]["meta"].occ32 and "side" in d["k2u"]
    assert mono2_phase2.engages(d, "cuda")
    assert mono2_phase2.engages(d, torch.device("cuda", 0))
    assert not mono2_phase2.engages(d, "cpu")  # CPU tensors
    host = arrays_from_numpy(mono2.device_arrays(), "cpu")  # the reference's 14-word rows
    assert not mono2_phase2.engages(host, "cuda")
    assert mono2_phase2.engages(card_layout_on_cpu(mono2), "cuda")


@pytest.mark.parametrize("kind", sorted(OTHER_KINDS))
def test_engages_on_no_other_index(genome, kind):
    index = OTHER_KINDS[kind](genome)
    d = on_card(index)
    for dev in ("cuda", "cpu"):
        assert not mono2_phase2.engages(d, dev), (kind, dev)


def _queries(index: ModIndex, n: int, seed: int) -> torch.Tensor:
    words = synth.sample_queries_truth(index.k2u.unitigs, n, seed=seed)[0]
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int64))


@pytest.mark.parametrize("kind", ["mono2 KCDict", "mono KCDict", "cuckoo KCDict",
                                  "SSHash speed", "mono2, type-split"])
def test_compact_query_calls_the_kernel_where_it_engages(monkeypatch, genome, mono2, kind):
    """With CPU tensors taken for the card's, ``get_ref_pos_compact`` hands
    phase 2 to the kernel's wrapper only on the mono2-occ32 layout; the
    wrapper's plain version gives the same pieces as before."""
    index = mono2 if kind.startswith("mono2") else OTHER_KINDS[kind](genome)
    d = card_layout_on_cpu(index)
    fw = _queries(index, 2048, seed=4)
    mo = max(1, index.max_occs())
    kw = dict(merge=False, m2=M2, m2b=M2 if kind.endswith("type-split") else None)
    want = get_ref_pos_compact(d, fw, mo, **kw)
    real = mono2_phase2.engages
    calls = []

    def wrapper(d_, fw_, lanes, n_ovf, max_occs, side_probes=None):
        calls.append(int(n_ovf))
        return get_ref_pos_padded(d_, fw_[lanes], max_occs)

    monkeypatch.setattr(mono2_phase2, "engages", lambda d_, device: real(d_, "cuda"))
    monkeypatch.setattr(mono2_phase2, "mono2_phase2", wrapper)
    got = get_ref_pos_compact(d, fw, mo, **kw)
    assert calls == ([int(want["n_ovf"])] if kind == "mono2 KCDict" else [])
    assert set(got) == set(want)
    for key in want:
        if isinstance(want[key], dict):
            for k2 in want[key]:
                assert torch.equal(got[key][k2], want[key][k2]), (key, k2)
        else:
            assert torch.equal(got[key], want[key]), key


def side_keys(host_k2u: dict) -> np.ndarray:
    """The canonical keys of the side table's occupied slots."""
    side = host_k2u["side"]
    keys = []
    for s in range(SLOTS):
        c = s * SW
        rows = np.flatnonzero(side[:, c] != 0xFFFFFFFF)
        keys.append(side[rows, c].astype(np.uint64)
                    | ((side[rows, c + 1] & np.uint32(0x7FFFFFFF)).astype(np.uint64)
                       << np.uint64(32)))
    return np.concatenate(keys)


def max_occ_keys(index: ModIndex, n: int, rng) -> np.ndarray:
    """``n`` k-mers of the unitigs with the index's most occurrences."""
    us = index.k2u.unitigs
    accum = np.asarray(us.accum)
    cnt = np.diff(np.asarray(index.u2pos.offsets))
    u = rng.choice(np.flatnonzero(cnt == cnt.max()), n)
    span = accum[u + 1] - accum[u] - us.k + 1
    return np.asarray(us.get_kmer_u64(accum[u] + (rng.random(n) * span).astype(np.int64)),
                      dtype=np.uint64)


@pytest.fixture(scope="module")
def contract_batch(mono2):
    """Side-table keys, true misses, keys of the most-occurring unitigs and
    uniform queries, shuffled, half of each reverse-complemented."""
    rng = np.random.default_rng(21)
    host = mono2.device_arrays()
    k = mono2.k
    parts = {
        "side": side_keys(host["k2u"])[:300],
        "miss": rng.integers(0, 1 << (2 * k), 300, dtype=np.uint64),
        "max_occs": max_occ_keys(mono2, 300, rng),
        "uniform": synth.sample_queries_truth(mono2.k2u.unitigs, 1200, seed=5)[0],
    }
    words = np.concatenate(list(parts.values()))
    flip = rng.random(len(words)) < 0.5
    words[flip] = revcomp_np(words[flip], k)
    words = words[rng.permutation(len(words))]
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int64)), parts


def _real_slots_hold_the_contract(d, fw, mo, out):
    n = min(int(out["n_ovf"]), out["lanes"].shape[0])
    want = get_ref_pos_padded(d, fw[out["lanes"][:n]], mo)
    assert list(out["phase2"]) == list(want)
    for key, w in want.items():
        assert out["phase2"][key].dtype == w.dtype, key
        assert torch.equal(out["phase2"][key][:n], w), key
    return n, want


@pytest.mark.parametrize("layout", ["card rows", "host rows"])
def test_phase2_real_slots_are_the_padded_query(mono2, contract_batch, layout):
    fw, parts = contract_batch
    d = card_layout_on_cpu(mono2) if layout == "card rows" else \
        arrays_from_numpy(mono2.device_arrays(), "cpu")
    mo = max(1, mono2.max_occs())
    out = get_ref_pos_compact(d, fw, mo, merge=False, m2=fw.shape[0])
    n, want = _real_slots_hold_the_contract(d, fw, mo, out)
    assert n == int(out["n_ovf"]) and not bool(out["over_budget"])
    # the batch holds what it is for, among phase 2's real lanes
    lanes = out["lanes"][:n]
    main = kcdict_k2u(d["k2u"], fw[lanes], mode="main")
    assert (main["unresolved"] & (want["mt"] > 0)).sum() >= 100  # found in the side table
    assert (want["mt"] == 0).sum() >= 100  # true misses
    assert (want["n_occs"] == mo).sum() >= 100 and mo == 3  # unitigs at max_occs
    assert out["slot_real"][:n].all() and not out["slot_real"][n:].any()


def test_phase2_with_no_real_slot(mono2):
    """n_ovf 0: a batch the main phase settles whole."""
    d = card_layout_on_cpu(mono2)
    mo = max(1, mono2.max_occs())
    fw = _queries(mono2, 4096, seed=6)
    p = kcdict_k2u(d["k2u"], fw, mode="main")
    settled = fw[~p["unresolved"] & (p["occ_cnt"] <= 2)]
    out = get_ref_pos_compact(d, settled, mo, merge=False, m2=M2)
    assert int(out["n_ovf"]) == 0 and not out["slot_real"].any()
    _real_slots_hold_the_contract(d, settled, mo, out)


def test_phase2_with_every_slot_real(mono2, contract_batch):
    """n_ovf of M and past it: every slot is real, the lanes past M wait."""
    fw, _ = contract_batch
    d = card_layout_on_cpu(mono2)
    mo = max(1, mono2.max_occs())
    for m2 in (64, 65):
        out = get_ref_pos_compact(d, fw, mo, merge=False, m2=m2)
        assert int(out["n_ovf"]) > m2 and bool(out["over_budget"])
        n, _ = _real_slots_hold_the_contract(d, fw, mo, out)
        assert n == m2 and out["slot_real"].all()


def test_marked_pass_counts_side_probes(mono2, contract_batch):
    fw, _ = contract_batch
    d = card_layout_on_cpu(mono2)
    mo = max(1, mono2.max_occs())
    out = get_ref_pos_compact(d, fw, mo, merge=False, m2=M2)
    assert "side_probes" not in out
    trace.enable(stages=True)
    try:
        marked = get_ref_pos_compact(d, fw, mo, merge=False, m2=M2)
    finally:
        trace.disable()
        trace.reset()
    n = min(int(out["n_ovf"]), M2)
    lanes = out["lanes"][:n]
    want = int(kcdict_k2u(d["k2u"], fw[lanes], mode="main")["unresolved"].sum())
    assert int(marked["side_probes"]) == want > 0


# --- the kernel's logic, built for the host ---------------------------------

STUB = r"""
#pragma once
#include <atomic>
#include <barrier>
#include <cstdint>
#include <mutex>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
struct uint2 { uint32_t x, y; };
struct uint4 { uint32_t x, y, z, w; };
struct dim3s { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3s threadIdx, blockIdx;
inline dim3s blockDim, gridDim;
template <class T> inline T __ldg(const T* p) { return *p; }
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
inline std::atomic<int> g_count{0};
inline std::barrier<>* g_bar = nullptr;
inline std::mutex g_mu;
inline int __syncthreads_count(int p) {
  if (p) g_count.fetch_add(1);
  g_bar->arrive_and_wait();
  int r = g_count.load();
  g_bar->arrive_and_wait();
  return r;
}
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  std::lock_guard<std::mutex> l(g_mu);
  unsigned long long o = *p;
  *p += v;
  return o;
}
template <class K, class A> void stub_launch(K kern, long blocks, int threads, const A& a) {
  blockDim.x = threads;
  gridDim.x = blocks;
  for (long b = 0; b < blocks; ++b) {
    g_count = 0;
    std::barrier<> bar(threads);
    g_bar = &bar;
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, t, b] { threadIdx.x = t; blockIdx.x = b; kern(a); });
    for (auto& th : ts) th.join();
  }
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The kernel's entry, built with the host's C++ compiler against the
    stand-in runtime; its launch runs each block's threads as threads."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel's logic")
    tmp = tmp_path_factory.mktemp("phase2_host")
    (tmp / "cuda_runtime.h").write_text(STUB)
    src = mono2_phase2.SOURCE.read_text()
    src, n = re.subn(r"(\w+)<<<(.+?),\s*(\w+),\s*0,\s*static_cast<cudaStream_t>\(stream\)>>>"
                     r"\(([^;]*)\);", r"stub_launch(\1, \2, \3, \4);", src, flags=re.S)
    assert n == 1
    (tmp / "k.cpp").write_text(src)
    lib = tmp / "libphase2_host.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", f"-I{tmp}",
                    "-o", str(lib), str(tmp / "k.cpp")], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).mono2_phase2
    fn.argtypes = [ctypes.POINTER(mono2_phase2._Args), ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(d, fw, lanes, n_ovf: int, mo: int):
        out = mono2_phase2.outputs(lanes.shape[0], mo, "cpu")
        for v in out.values():  # unwritten slots keep this pattern
            v.view(torch.uint8).fill_(0xA5)
        side = torch.zeros((), dtype=torch.int64)
        nt = torch.tensor(n_ovf)  # the block holds raw pointers: keep every tensor alive
        args = mono2_phase2._args(d, fw, lanes, nt, mo, out, side)
        assert fn(ctypes.byref(args), None) == 0
        return out, int(side)

    return run


def _kernel_holds(run, d, fw, lanes, n_ovf, mo, what):
    got, side = run(d, fw, lanes, n_ovf, mo)
    n = min(n_ovf, lanes.shape[0])
    want = get_ref_pos_padded(d, fw[lanes], mo)
    assert list(got) == list(want), what
    for key, w in want.items():
        assert got[key].dtype == w.dtype and got[key].shape == w.shape, (what, key)
        assert torch.equal(got[key][:n], w[:n]), (what, key)
        assert (got[key][n:].view(torch.uint8) == 0xA5).all(), (what, key)  # fake slots unwritten
    want_side = int(kcdict_k2u(d["k2u"], fw[lanes[:n]], mode="main")["unresolved"].sum()) \
        if "side" in d["k2u"] and n else 0
    assert side == want_side, what


def test_kernel_logic_against_the_plain_version(host_kernel, mono2, contract_batch):
    fw, _ = contract_batch
    d = card_layout_on_cpu(mono2)
    mo = max(1, mono2.max_occs())
    out = get_ref_pos_compact(d, fw, mo, merge=False, m2=fw.shape[0])
    lanes, n = out["lanes"], int(out["n_ovf"])
    for n_ovf in (n, 0, 1, 255, 256, 257, lanes.shape[0], lanes.shape[0] + 9):
        _kernel_holds(host_kernel, d, fw, lanes, n_ovf, mo, f"n_ovf {n_ovf}")
    every = torch.arange(fw.shape[0])
    for width in (1, 2, 7, 300):  # 300 columns: more cells a slot than a block has threads
        _kernel_holds(host_kernel, d, fw, every[:700], 700, width, f"max_occs {width}")


def test_kernel_logic_on_pf1_words(host_kernel, genome, mono2, contract_batch):
    """The same dictionary over a pf1 table of the same occurrences."""
    fw, _ = contract_batch
    d = card_layout_on_cpu(mono2)
    d["u2pos"] = arrays_from_numpy(genome[2].dense_table().device_arrays(), "cpu")
    assert d["u2pos"]["meta"].enc == "pf1" and mono2_phase2.engages(d, "cuda")
    mo = max(1, mono2.max_occs())
    every = torch.arange(fw.shape[0])
    _kernel_holds(host_kernel, d, fw, every, fw.shape[0], mo, "pf1")


def test_wrapper_refuses_what_the_kernel_cannot_read(mono2):
    d = arrays_from_numpy(mono2.device_arrays(), "cpu")  # host rows
    fw = _queries(mono2, 16, seed=2)
    lanes = torch.arange(16)
    with pytest.raises(ValueError, match="mono2_phase2 needs"):
        mono2_phase2._check(d, fw, lanes, torch.tensor(16), 3)
    d = card_layout_on_cpu(mono2)
    with pytest.raises(ValueError, match="CUDA"):  # CPU tensors are no CUDA tensors
        mono2_phase2._check(d, fw, lanes, torch.tensor(16), 3)
    # CPU tensors take the plain version
    got = mono2_phase2.mono2_phase2(d, fw, lanes, torch.tensor(16), 3)
    want = get_ref_pos_padded(d, fw, 3)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert modindex.mono2_phase2 is mono2_phase2
