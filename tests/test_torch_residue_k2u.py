"""The ragged phase 2's residue K2U (``ops/residue_k2u``) on the host: its
one predicate on every layout, its dispatch in ``_ragged_k2u``, its CPU
path against the plain ``_ragged_k2u``, a marked pass's ``residue`` count,
and the kernel's logic, built with the host's C++ compiler against a
stand-in CUDA runtime (each warp's 32 threads as ``std::thread``s, the
warp's shuffles and ballots through a barrier), bit for bit against the
plain residue K2U on ``chip_smoke.residue_cases``: a read chunk of a small
GRCh38-shaped genome, its heavy-bucket lanes alone, deferred winners that
fail validation alone and foreign k-mers in heavy buckets, each at a
residue capacity above, equal to and below its count, and with no real
slot."""

import ctypes
import importlib.util
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from mazu_tpu_torch import trace
from mazu_tpu_torch.containers.unitig_set import UnitigSet
from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index import modindex as mi
from mazu_tpu_torch.index.modindex import _ragged_k2u, get_ref_pos_compact, residue_full_k2u
from mazu_tpu_torch.kphf.sshash import SSHash
from mazu_tpu_torch.ops import occ_csr, residue_k2u
from mazu_tpu_torch.ops.compact import flagged_lanes

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

QUERY = {"probe_limit": 2, "defer_valid": True, "mphf_level_limit": 4}
SCALE = 0.0006  # 1.85 Mbp of chromosomes: heavy buckets in the young repeat families
N_READS = 400  # 48,000 lanes
N_MAX = 3000  # lanes of each adversarial batch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread each, so that six test workers do not oversubscribe
    the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def genome():
    """(fast32 ModIndex, its MPHF-layout arrays on the host, a read chunk)."""
    return chip_smoke.residue_genome("cpu", scale=SCALE, n_reads=N_READS)


@pytest.fixture(scope="module")
def cases(genome):
    _, d, chunk = genome
    return chip_smoke.residue_cases(d, chunk, n_max=N_MAX)


def test_engages_on_the_fast32_layout(genome):
    _, d, _ = genome
    assert residue_k2u.engages(d, "cuda") and residue_k2u.engages(d, torch.device("cuda", 0))
    assert not residue_k2u.engages(d, "cpu")  # the CPU path is the plain residue K2U


def _other_arrays(genome, kind: str) -> dict:
    index, _, _ = genome
    if kind == "inline rows":
        return arrays_from_numpy(index.device_arrays(), "cpu")
    if kind == "window records":
        return arrays_from_numpy(index.device_arrays(prefix_kind="grouped16", pos_kind="packed",
                                                     uproj=True, useqrec=True), "cpu")
    if kind == "mrows MPHF":
        return arrays_from_numpy(index.device_arrays(prefix_kind="grouped16", pos_kind="packed",
                                                     uproj=True, mphf_rows=True), "cpu")
    from mazu_tpu_torch.containers.refseq import RefSeqCollection
    from mazu_tpu_torch.index.modindex import ModIndex
    from mazu_tpu_torch.index.spt import SPT
    from mazu_tpu_torch.kphf.kcdict import KCDict

    from torch_fixtures import seq_recipe

    (seqs, k, occ, ref_lens), _ = seq_recipe()
    names = [f"r{i}" for i in range(len(ref_lens))]
    us = UnitigSet.from_seqs(seqs, k)
    u2 = SPT(us, names, *occ, ref_lens).piscem_table()
    if kind == "mono2 KCDict":
        k2u = KCDict.from_unitig_set(us, occ_table=u2, scheme="mono2", load=0.25)
        layout = {}
    else:
        engine = {"direct engine": dict(engine="direct", bucket_load=0.5), "parity": {}}[kind]
        k2u = SSHash.from_unitig_set(us, 15, skew_param=1, device="cpu", **engine)
        layout = dict(prefix_kind="grouped16", pos_kind="packed", uproj=True)
    index = ModIndex(k2u, u2, RefSeqCollection.from_lens(ref_lens, names), index_type="t")
    return arrays_from_numpy(index.device_arrays(**layout), "cpu")


@pytest.mark.parametrize("kind", ["mono2 KCDict", "direct engine", "parity", "inline rows",
                                  "window records", "mrows MPHF"])
def test_engages_on_no_other_layout(genome, kind):
    d = _other_arrays(genome, kind)
    m = d["k2u"]["meta"]
    if kind == "direct engine":
        assert m.direct_t and m.skew_kind == "cuckoo" and "skew_inline" in d["k2u"]
    if kind == "parity":
        assert m.ordering != "mix32" and m.kind == "sshash"
    assert not residue_k2u.engages(d, "cuda")


def _residue(d, fw, real, m_c):
    r = chip_smoke.residue_probe(d, fw)
    rest, n_c = flagged_lanes((r["use_skew"] | r["unresolved"]) & real, m_c)
    return r, rest, n_c


def _capacities(d, fw):
    """(real, m_c, what): the residue capacity above, equal to and half of
    the residue's count, and no real slot."""
    r = chip_smoke.residue_probe(d, fw)
    n = int((r["use_skew"] | r["unresolved"]).sum())
    assert n > 0
    real = torch.ones(fw.shape[0], dtype=torch.bool)
    return [(real, n + 37, "n_c < m_c"), (real, n, "n_c == m_c"), (real, max(n // 2, 1), "n_c > m_c"),
            (torch.zeros_like(real), 64, "n_c 0")]


CASES = ("the read chunk", "skew lanes", "failed deferred winners",
         "foreign k-mers in heavy buckets")


def test_the_cases_hold_what_they_name(genome, cases):
    _, d, _ = genome
    assert list(cases) == list(CASES)
    census = {}
    for name, fw in cases.items():
        r = chip_smoke.residue_probe(d, fw)
        census[name] = (int(r["use_skew"].sum()), int((r["unresolved"] & ~r["use_skew"]).sum()),
                        fw.shape[0])
    skew, failed, n = census["the read chunk"]
    assert 0 < failed < skew < n  # a chunk's residue holds both kinds
    for name in ("skew lanes", "foreign k-mers in heavy buckets"):
        assert census[name][0] == census[name][2] > 100, name
    skew, failed, n = census["failed deferred winners"]
    assert skew == 0 and failed == n > 100
    # most changed k-mers are in no unitig, and every failed winner has a hit
    foreign = cases["foreign k-mers in heavy buckets"]
    assert int((mi.k2u_batch(d, foreign)["mt"] == 0).sum()) > foreign.shape[0] // 2
    assert (mi.k2u_batch(d, cases["failed deferred winners"])["mt"] > 0).any()


@pytest.mark.parametrize("case", CASES)
def test_cpu_path_is_the_plain_ragged_k2u(genome, cases, case):
    _, d, _ = genome
    fw = cases[case]
    for real, m_c, what in _capacities(d, fw):
        r, rest, n_c = _residue(d, fw, real, m_c)
        got = residue_k2u.residue_k2u(d, fw, r, rest, n_c)
        want, n_want = _ragged_k2u(d, fw, real, m_c)
        assert int(n_c) == int(n_want), what
        for key in residue_k2u.FIELDS:
            assert torch.equal(got[key], want[key]), (what, key)
        if what == "n_c 0":
            assert all(torch.equal(got[key], r[key]) for key in residue_k2u.FIELDS)


def test_dispatch_by_the_predicate(monkeypatch, genome, cases):
    _, d, _ = genome
    fw = cases["the read chunk"]
    real = torch.ones(fw.shape[0], dtype=torch.bool)
    calls = []

    def wrapper(d_, fw_, r, rest, n_c):
        calls.append((rest.shape[0], int(n_c)))
        return residue_full_k2u(d_, fw_, r, rest, n_c)

    monkeypatch.setattr(residue_k2u, "residue_k2u", wrapper)
    want, n_c = _ragged_k2u(d, fw, real, 4096)
    assert calls == []  # the CPU does not engage
    monkeypatch.setattr(residue_k2u, "engages", lambda d_, device: True)
    got, n_got = _ragged_k2u(d, fw, real, 4096)
    assert calls == [(4096, int(n_c))] and int(n_got) == int(n_c)
    assert all(torch.equal(got[key], want[key]) for key in residue_k2u.FIELDS)


def test_marked_pass_counts_the_residue(genome):
    index, d, chunk = genome
    fw = chunk[:12000]
    m2, m2c, mo = 4096, 512, index.max_occs()
    kw = dict(QUERY, merge=False, m2=m2, m2c=m2c)
    assert occ_csr.engages(d, mo)
    plain = get_ref_pos_compact(d, fw, mo, **kw)
    assert "residue" not in plain
    trace.enable(stages=True)
    try:
        out = get_ref_pos_compact(d, fw, mo, **kw)
    finally:
        trace.disable()
        trace.reset()
    n = min(int(out["n_ovf"]), m2)
    r = chip_smoke.residue_probe(d, fw[out["lanes"][:n]])
    want = int((r["use_skew"] | r["unresolved"]).sum())
    assert int(out["residue"]) == min(want, m2c) and 0 < want
    assert int(out["side_probes"]) == 0


# --- the kernel's logic, built for the host ---------------------------------

STUB = r"""
#pragma once
#include <barrier>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __grid_constant__
struct uint4 { uint32_t x, y, z, w; };
struct ulonglong2 { unsigned long long x, y; };
struct dim3s { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3s threadIdx, blockIdx;
inline dim3s blockDim, gridDim;
template <class T> inline T __ldg(const T* p) { return *p; }
inline int __popc(uint32_t x) { return __builtin_popcount(x); }
inline int __popcll(uint64_t x) { return __builtin_popcountll(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(x); }
typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }
inline std::barrier<>* g_bar = nullptr;
inline uint64_t g_slot[32];
template <class T> inline T __shfl_sync(unsigned, T v, int src) {
  uint64_t u = 0;
  std::memcpy(&u, &v, sizeof(T));
  g_slot[threadIdx.x & 31] = u;
  g_bar->arrive_and_wait();
  u = g_slot[src];
  g_bar->arrive_and_wait();
  T r;
  std::memcpy(&r, &u, sizeof(T));
  return r;
}
inline unsigned __ballot_sync(unsigned, int p) {
  g_slot[threadIdx.x & 31] = p ? 1 : 0;
  g_bar->arrive_and_wait();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= static_cast<unsigned>(g_slot[i]) << i;
  g_bar->arrive_and_wait();
  return r;
}
// one warp at a time: the kernel shares nothing across a block's warps
template <class K, class A> void stub_launch(K kern, long blocks, int threads, const A& a) {
  blockDim.x = threads;
  gridDim.x = blocks;
  for (long b = 0; b < blocks; ++b)
    for (int w0 = 0; w0 < threads; w0 += 32) {
      std::barrier<> bar(32);
      g_bar = &bar;
      std::vector<std::thread> ts;
      for (int t = w0; t < w0 + 32; ++t)
        ts.emplace_back([&, t, b] { threadIdx.x = t; blockIdx.x = b; kern(a); });
      for (auto& th : ts) th.join();
    }
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The kernel's entry built for the host; ``run(d, fw, r, rest, n_c)``
    writes the real residue slots into ``r`` as the card's launch does."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel's logic")
    tmp = tmp_path_factory.mktemp("residue_host")
    (tmp / "cuda_runtime.h").write_text(STUB)
    src = residue_k2u.SOURCE.read_text()
    src, n = re.subn(r"(\w+)<<<(.+?),\s*(\w+),\s*0,\s*static_cast<cudaStream_t>\(stream\)>>>"
                     r"\(([^;]*)\);", r"stub_launch(\1, \2, \3, \4);", src, flags=re.S)
    assert n == 1
    (tmp / "k.cpp").write_text(src)
    lib = tmp / "libresidue_host.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", f"-I{tmp}",
                    "-o", str(lib), str(tmp / "k.cpp")], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).residue_k2u
    fn.argtypes = [ctypes.POINTER(residue_k2u._Args), ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(d, fw, r, rest, n_c):
        args = residue_k2u._args(d, fw, r, rest, n_c)  # the caller keeps every tensor alive
        assert fn(ctypes.byref(args), None) == 0
        return {key: r[key] for key in residue_k2u.FIELDS}

    return run


@pytest.mark.parametrize("case", CASES)
def test_kernel_logic_against_the_plain_version(monkeypatch, host_kernel, genome, cases, case):
    """``chip_smoke.compare_residue``, the card's check, with the kernel
    built for the host in place of the card's launch."""
    _, d, _ = genome
    fw = cases[case]
    monkeypatch.setattr(residue_k2u, "engages", lambda d_, device: True)
    monkeypatch.setattr(residue_k2u, "residue_k2u", host_kernel)
    for real, m_c, what in _capacities(d, fw):
        n = chip_smoke.compare_residue(d, fw, real, m_c, f"{case}, {what}")
        assert (n == 0) == (what == "n_c 0")


def test_kernel_logic_on_an_index_without_uproj(host_kernel, genome, cases):
    """The winner mapped through its rank's accum2 extent."""
    index, _, _ = genome
    d = arrays_from_numpy(index.device_arrays(prefix_kind="grouped16", pos_kind="packed"),
                          "cpu")
    assert "uproj" not in d["k2u"]["us"] and residue_k2u.engages(d, "cuda")
    for name in ("failed deferred winners", "skew lanes"):
        fw = cases[name]
        real = torch.ones(fw.shape[0], dtype=torch.bool)
        r, rest, n_c = _residue(d, fw, real, fw.shape[0])
        want = residue_full_k2u(d, fw, r, rest, n_c)
        got = host_kernel(d, fw, {key: v.clone() for key, v in r.items()}, rest, n_c)
        assert int(n_c) > 0
        for key in residue_k2u.FIELDS:
            assert torch.equal(got[key], want[key]), (name, key)


def test_wrapper_refuses_what_the_kernel_cannot_read(genome, cases):
    _, d, _ = genome
    fw = cases["skew lanes"]
    r, rest, n_c = _residue(d, fw, torch.ones(fw.shape[0], dtype=torch.bool), 64)
    with pytest.raises(ValueError, match="CUDA tensors"):  # CPU tensors are no CUDA tensors
        residue_k2u._check(d, fw, r, rest, n_c)
    with pytest.raises(ValueError, match="no residue K2U for device"):
        residue_k2u.residue_k2u(d, fw.to("meta"), r, rest, n_c)
