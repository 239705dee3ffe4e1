// mono2-occ32 KCDict bucket-row probe for Hopper (sm_90a).
//
// Replaces mazu_tpu/ops/pallas_query.py::_kernel (launched by
// _pallas_probe, wrapped by pallas_mono2_k2u). Contract: bit-identical to
// kcdict_k2u(d, fw, mode="main") on a mono2-occ32 dictionary
// (mazu_tpu_torch/kphf/kcdict.py), the kernel's plain torch version.
//
// What bounds it on this card: each query reads one bucket row at a random
// index of a table far larger than the 50 MB L2 (8.6 GB at the 50 Mbp
// smoke size), then writes 51 bytes of outputs. Random rows come from
// device memory at the card's rate of random 32-byte sectors (2^20 random
// 64-byte rows alone take 0.0493 ms, 42.5 G sectors a second; the
// reference's 56-byte rows at 8-byte alignment span 2.5 sectors and take
// 0.0644 ms), and the output writes (0.0247 ms alone, with the key prep)
// overlap those reads only in part (variants of this kernel that stop
// after each part, timed in turns on an NVIDIA H100 80GB HBM3 at 700 W;
// PERF.md section 6).
//
// Design: the card holds the table as 64-byte rows, 64-byte aligned
// (ops/mono2_probe.padded_table: the reference's 14 words and two zero
// words, made once where the index goes to the card), so a row is the two
// sectors of one 64-byte block, read as four 16-byte loads. One thread per
// query, and the key prep is fused in: a thread reads its 8-byte forward
// word, computes the reverse complement, the canonical word and its bucket
// (fold_hash32 in native u32 arithmetic), reads the row, compares slot 0
// and then slot 1, and writes the nine output fields from registers in one
// store path. No canonical words or bucket indices round-trip through
// device memory. The grid covers the batch and the last block masks its
// ragged edge; nothing carries over between blocks.
//
// Against other designs (2^20 queries at 50 Mbp, in turns in one run on
// that card; PERF.md section 6): this design 0.0600 ms; the
// reference's 56-byte rows 0.0763; slot 1's sector read only when slot 0
// misses 0.0684 (the second read waits on the first, and a lone sector
// costs as much as a row's two); eight threads a row with warp shuffles
// 0.0601; evict-first loads 0.0679; streaming stores of the outputs
// 0.0600; a grid-stride walk that reads the next lane's row before
// writing this one's 0.0611.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;      // queries per block, one per thread
constexpr int kSlotWords = 7;   // u32 words of a slot; a row holds 2 slots
constexpr int kRowWords = 16;   // u32 words of a row on the card: 2 slots, 2 zero words

// Mirrored field by field by _Args in mazu_tpu_torch/ops/mono2_probe.py
// (tests/test_torch_kernel_abi.py holds the two together): every field is
// 8 bytes, so neither side pads.
struct Args {
  const uint64_t* fw;
  const uint4* table;     // T rows of kRowWords u32, 64-byte aligned, T = tmask + 1
  int64_t* uid;
  int64_t* ulen;
  int64_t* pos;
  int64_t* cnt;
  uint8_t* mt;
  int64_t* ow;
  int64_t* ow2;
  uint8_t* use_skew;
  uint8_t* unresolved;
  int64_t n, tmask, k;
};

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

__global__ void __launch_bounds__(kTile) mono2_probe_kernel(const Args a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.n) return;

  const uint64_t x = a.fw[i];
  const uint64_t rc = reverse_groups(~x) >> (64 - 2 * a.k);
  const uint64_t canon = x < rc ? x : rc;
  const bool is_fw_canon = x == canon;
  const uint32_t clo = static_cast<uint32_t>(canon);
  const uint32_t chi = static_cast<uint32_t>(canon >> 32);
  const uint32_t h = (mix32(clo ^ 0x9E3779B9u) ^ mix32(chi + 0xC2B2AE35u)) &
                     static_cast<uint32_t>(a.tmask);

  const uint4* row = a.table + static_cast<size_t>(h) * (kRowWords / 4);
  uint32_t w[kRowWords];
#pragma unroll
  for (int j = 0; j < kRowWords / 4; ++j) {
    const uint4 v = __ldg(row + j);
    w[4 * j] = v.x;
    w[4 * j + 1] = v.y;
    w[4 * j + 2] = v.z;
    w[4 * j + 3] = v.w;
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
  a.uid[i] = o_uid;
  a.ulen[i] = o_len;
  a.pos[i] = o_pos;
  a.cnt[i] = o_cnt;
  a.mt[i] = o_mt;
  a.ow[i] = o_ow;
  a.ow2[i] = o_ow2;
  a.use_skew[i] = 0;
  a.unresolved[i] = found ? 0 : 1;
}

}  // namespace

// Launches on ``stream``, allocates nothing, and returns cudaGetLastError()
// (0 on success).
extern "C" int mono2_probe(const void* arg_block, void* stream) {
  const Args* a = static_cast<const Args*>(arg_block);
  if (a->n <= 0) return 0;
  const int64_t blocks = (a->n + kTile - 1) / kTile;
  mono2_probe_kernel<<<static_cast<unsigned>(blocks), kTile, 0,
                       static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
