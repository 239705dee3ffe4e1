// mono2-occ32 KCDict bucket-row probe for Hopper (sm_90a).
//
// Replaces mazu_tpu/ops/pallas_query.py::_kernel (launched by
// _pallas_probe, wrapped by pallas_mono2_k2u). Contract: bit-identical to
// kcdict_k2u(d, fw, mode="main") on a mono2-occ32 dictionary
// (mazu_tpu_torch/kphf/kcdict.py), the kernel's plain torch version.
//
// What bounds it on this card: each query reads one 56-byte bucket row at
// a random index of a table far larger than the 50 MB L2 (about 7.5 GB at
// the 50 Mbp smoke size), so DRAM sectors and latency set the pace, not
// arithmetic.
//
// Design: one thread per query, and the key prep is fused in. A thread
// reads its 8-byte forward word, computes the reverse complement, the
// canonical word and its bucket (fold_hash32 in native u32 arithmetic),
// reads the row as seven 8-byte loads (rows are 8-byte aligned, not 16),
// compares both slots and writes the nine output fields. So each query
// moves only its key in, one row, and its outputs; no canonical words or
// bucket indices round-trip through device memory. The grid covers the
// batch and the last block masks its ragged edge; nothing carries over
// between blocks. Deeper memory-level parallelism (several rows in flight
// per thread, TMA gathers) is left for later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint64_t reverse_groups(uint64_t x) {
  x = ((x >> 2) & 0x3333333333333333ull) | ((x & 0x3333333333333333ull) << 2);
  x = ((x >> 4) & 0x0F0F0F0F0F0F0F0Full) | ((x & 0x0F0F0F0F0F0F0F0Full) << 4);
  x = ((x >> 8) & 0x00FF00FF00FF00FFull) | ((x & 0x00FF00FF00FF00FFull) << 8);
  x = ((x >> 16) & 0x0000FFFF0000FFFFull) | ((x & 0x0000FFFF0000FFFFull) << 16);
  return (x >> 32) | (x << 32);
}

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

constexpr int kSlotWords = 7;  // u32 words per slot; a row holds 2 slots

__global__ void mono2_probe_kernel(
    const uint64_t* __restrict__ fw, const uint64_t* __restrict__ table,
    uint32_t tmask, int rc_shift, int64_t n, int64_t* __restrict__ uid,
    int64_t* __restrict__ ulen, int64_t* __restrict__ pos,
    int64_t* __restrict__ cnt, uint8_t* __restrict__ mt,
    int64_t* __restrict__ ow, int64_t* __restrict__ ow2,
    uint8_t* __restrict__ use_skew, uint8_t* __restrict__ unresolved) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const uint64_t x = fw[i];
  const uint64_t rc = reverse_groups(~x) >> rc_shift;
  const uint64_t canon = x < rc ? x : rc;
  const bool is_fw_canon = x == canon;
  const uint32_t clo = static_cast<uint32_t>(canon);
  const uint32_t chi = static_cast<uint32_t>(canon >> 32);
  const uint32_t h = (mix32(clo ^ 0x9E3779B9u) ^ mix32(chi + 0xC2B2AE35u)) & tmask;

  // 56-byte row = 7 u64 = 14 u32 (little-endian: u32 2j is the low half)
  const uint64_t* row = table + static_cast<size_t>(h) * kSlotWords;
  uint32_t w[2 * kSlotWords];
#pragma unroll
  for (int j = 0; j < kSlotWords; ++j) {
    const uint64_t v = __ldg(row + j);
    w[2 * j] = static_cast<uint32_t>(v);
    w[2 * j + 1] = static_cast<uint32_t>(v >> 32);
  }

  bool found = false;
  uint32_t o_uid = 0, o_pos = 0, o_len = 0, o_cnt = 0, o_ow = 0, o_ow2 = 0;
  uint8_t o_mt = 0;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const uint32_t* c = w + s * kSlotWords;
    const uint32_t khi = c[1];
    if (!found && c[0] == clo && (khi & 0x7FFFFFFFu) == chi) {
      found = true;
      const bool canon_is_useq = (khi >> 31) != 0;
      o_mt = (is_fw_canon == canon_is_useq) ? 1 : 2;
      o_uid = c[2];
      o_pos = c[3] & 0xFFFFFFu;
      o_len = (c[3] >> 24) | ((c[4] & 0xFFFFu) << 8);
      o_cnt = c[4] >> 16;
      o_ow = c[5];
      o_ow2 = c[6];
    }
  }
  uid[i] = o_uid;
  ulen[i] = o_len;
  pos[i] = o_pos;
  cnt[i] = o_cnt;
  mt[i] = o_mt;
  ow[i] = o_ow;
  ow2[i] = o_ow2;
  use_skew[i] = 0;
  unresolved[i] = found ? 0 : 1;
}

}  // namespace

// Launches on ``stream``, allocates nothing, and returns cudaGetLastError()
// (0 on success). ``table`` holds T rows of 14 u32 with T = tmask + 1.
extern "C" int mono2_probe(const void* fw, const void* table, uint32_t tmask,
                           int k, int64_t n, void* uid, void* ulen, void* pos,
                           void* cnt, void* mt, void* ow, void* ow2,
                           void* use_skew, void* unresolved, void* stream) {
  if (n <= 0) return 0;
  constexpr int kThreads = 256;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  mono2_probe_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(fw), static_cast<const uint64_t*>(table),
      tmask, 64 - 2 * k, n, static_cast<int64_t*>(uid),
      static_cast<int64_t*>(ulen), static_cast<int64_t*>(pos),
      static_cast<int64_t*>(cnt), static_cast<uint8_t*>(mt),
      static_cast<int64_t*>(ow), static_cast<int64_t*>(ow2),
      static_cast<uint8_t*>(use_skew), static_cast<uint8_t*>(unresolved));
  return static_cast<int>(cudaGetLastError());
}
