// The ragged (CSR) phase 2 of the two-phase query, for Hopper (sm_90a):
// every occurrence of every phase-2 slot's unitig, projected onto the
// references and written to one flat block of a fixed budget.
//
// Replaces no TPU kernel: the reference computes phase 2 as plain jnp
// (mazu_tpu/index/modindex.py: get_ref_pos_padded over [m2, max_occs]; its
// get_ref_pos_csr lays out this CSR form). Contract
// (mazu_tpu_torch/ops/occ_csr.py, occ_csr_plain): for the slots s <
// min(n_ovf, m) that hit, occ_count[s] is the unitig's occurrence count
// (0 for a miss and a fake slot) and occ_start[s] the exclusive prefix of
// the counts; total is their sum; entry j < min(total, budget) holds slot
// qid[j] = s's occurrence j - occ_start[s], decoded (piscem or pf1) and
// projected: ref_id, ref_pos (occ_pos + pos forward, occ_pos + ulen - pos
// - k reverse) and orient (the orientation match, flipped on a reverse
// occurrence). Entries at or past min(total, budget) are not written.
//
// Why ragged: on a genome with repeats a unitig occurs tens of thousands
// of times, so a padded [m2, max_occs] phase 2 cannot be allocated, while
// the occurrences that a chunk's lanes really hit fit a budget.
//
// Design: one kernel, launched three times (stage):
// - 0, count: one thread a slot reads offsets[uid] and offsets[uid + 1];
//   it writes the count and keeps the unitig's first occurrence index in
//   scratch; a block adds its counts into a tile sum.
// - 1, scan: block b adds the tile sums before it (at most m / kTile of
//   them), scans its tile's counts and writes occ_start; the last block
//   writes the total. The fake slots are read as count 0 and so sit at the
//   end with occ_start = total.
// - 2, write: a grid of a few blocks an SM takes kOccTile entries at a
//   time. Thread 0 finds the first and last slot of the tile by a binary
//   search of occ_start; the tile's slot starts go to shared memory (a
//   search over global memory where they do not fit), and each thread finds
//   its entries' slots there. Consecutive threads write consecutive
//   entries, so every store is coalesced, and a slot of 10^5 occurrences
//   spreads over many blocks: the work a block does is its kOccTile
//   entries, whatever the slots' counts. Each entry reads its occurrence
//   word from the unitig's pair row (ctable2: 16 bytes a row, the word in
//   its first 8), in the order the unitig stores them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;      // slots a block of stages 0 and 1
constexpr int kOccTile = 2048;  // entries a block of stage 2 takes at a time
constexpr int kWindow = 2048;   // slot starts a block of stage 2 keeps in shared memory

// Mirrored field by field by _Args in mazu_tpu_torch/ops/occ_csr.py
// (tests/test_torch_kernel_abi.py holds the two together): every field is
// 8 bytes, so neither side pads.
struct Args {
  const int64_t* n_ovf;     // one value on the device: slots below min(n_ovf, m) are real
  const int64_t* uid;       // [m] the slots' K2U
  const int64_t* ulen;
  const int64_t* pos;
  const uint8_t* mt;        // 0 a miss, 1 forward, 2 reverse
  const int64_t* offsets;   // [n_unitigs + 1] occurrence bounds
  const uint4* ctable2;     // [n_occs] pair rows: word i, word i + 1
  int64_t* occ_start;       // [m] outputs a slot
  int64_t* occ_count;
  int64_t* total;           // one value
  int32_t* qid;             // [budget] outputs an entry
  int32_t* ref_id;
  int64_t* ref_pos;
  int8_t* orient;
  int64_t* scratch;         // [m + tiles]: first occurrence index a slot, then tile sums
  int64_t m, budget, k, pf1, ref_shift, pos_mask, occ_last;
};

__device__ __forceinline__ int64_t block_sum(int64_t v, int64_t* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (kTile / 32) ? red[lane] : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const int64_t out = red[0];
  __syncthreads();
  return out;
}

// The exclusive prefix of v over the block's threads.
__device__ __forceinline__ int64_t block_scan(int64_t v, int64_t* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int64_t y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int64_t w = lane < (kTile / 32) ? red[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t y = __shfl_up_sync(0xFFFFFFFFu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < (kTile / 32)) red[lane] = w;
  }
  __syncthreads();
  const int64_t before = warp > 0 ? red[warp - 1] : 0;
  __syncthreads();
  return before + x - v;
}

// The last index i in [lo, hi) with a[i] <= j (a ascending, a[lo] <= j).
__device__ __forceinline__ int64_t last_at_most(const int64_t* a, int64_t lo, int64_t hi,
                                                int64_t j) {
  while (hi - lo > 1) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (a[mid] <= j) lo = mid; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kTile) occ_csr_kernel(const Args a, int stage) {
  __shared__ int64_t red[kTile / 32];
  __shared__ int64_t win[kWindow];
  __shared__ int64_t span[2];
  const int t = threadIdx.x;
  const int64_t tiles = (a.m + kTile - 1) / kTile;
  int64_t* ustart = a.scratch;
  int64_t* tile_sum = a.scratch + a.m;

  if (stage == 0) {
    const int64_t n_ovf = *a.n_ovf;
    const int64_t n_real = n_ovf < a.m ? n_ovf : a.m;
    const int64_t s = static_cast<int64_t>(blockIdx.x) * kTile + t;
    int64_t cnt = 0;
    if (s < a.m) {
      int64_t first = 0;
      if (s < n_real && a.mt[s] != 0) {
        const int64_t u = a.uid[s];
        first = a.offsets[u];
        cnt = a.offsets[u + 1] - first;
      }
      a.occ_count[s] = cnt;
      ustart[s] = first;
    }
    const int64_t sum = block_sum(cnt, red);
    if (t == 0) tile_sum[blockIdx.x] = sum;
    return;
  }

  if (stage == 1) {
    int64_t before = 0;
    for (int64_t i = t; i < blockIdx.x; i += kTile) before += tile_sum[i];
    before = block_sum(before, red);
    const int64_t s = static_cast<int64_t>(blockIdx.x) * kTile + t;
    const int64_t cnt = s < a.m ? a.occ_count[s] : 0;
    const int64_t ex = block_scan(cnt, red);
    if (s < a.m) a.occ_start[s] = before + ex;
    if (blockIdx.x == tiles - 1 && t == kTile - 1) *a.total = before + ex + cnt;
    return;
  }

  // stage 2: write the entries below min(total, budget)
  const int64_t total = *a.total;
  const int64_t lim = total < a.budget ? total : a.budget;
  for (int64_t j0 = static_cast<int64_t>(blockIdx.x) * kOccTile; j0 < lim;
       j0 += static_cast<int64_t>(gridDim.x) * kOccTile) {
    const int64_t j1 = j0 + kOccTile < lim ? j0 + kOccTile : lim;
    if (t == 0) {
      const int64_t s0 = last_at_most(a.occ_start, 0, a.m, j0);
      span[0] = s0;
      span[1] = last_at_most(a.occ_start, s0, a.m, j1 - 1);
    }
    __syncthreads();
    const int64_t s0 = span[0], n = span[1] - span[0] + 1;
    const bool in_smem = n <= kWindow;
    if (in_smem)
      for (int64_t i = t; i < n; i += kTile) win[i] = a.occ_start[s0 + i];
    __syncthreads();
    for (int64_t j = j0 + t; j < j1; j += kTile) {
      const int64_t s = in_smem ? s0 + last_at_most(win, 0, n, j)
                                : last_at_most(a.occ_start, s0, s0 + n, j);
      const int64_t oi = ustart[s] + (j - a.occ_start[s]);
      const uint4 row = __ldg(a.ctable2 + (oi < a.occ_last ? oi : a.occ_last));
      const uint64_t word = static_cast<uint64_t>(row.x) | (static_cast<uint64_t>(row.y) << 32);
      int64_t rid, opos;
      bool fwd;
      if (a.pf1) {
        rid = static_cast<int64_t>(word & 0xFFFFFFFFull);
        opos = static_cast<int64_t>((word >> 32) & 0x7FFFFFFFull);
        fwd = ((word >> 63) & 1ull) != 0;
      } else {
        rid = static_cast<int64_t>(word >> a.ref_shift);
        opos = static_cast<int64_t>((word >> 1) & static_cast<uint64_t>(a.pos_mask));
        fwd = (word & 1ull) != 0;
      }
      const int64_t kpos = a.pos[s];
      const int8_t match = a.mt[s] == 1 ? 1 : 0;
      a.qid[j] = static_cast<int32_t>(s);
      a.ref_id[j] = static_cast<int32_t>(rid);
      a.ref_pos[j] = fwd ? opos + kpos : opos + (a.ulen[s] - kpos) - a.k;
      a.orient[j] = fwd ? match : static_cast<int8_t>(1 - match);
    }
    __syncthreads();
  }
}

// The sum of ref_pos + ref_id + orient + 2 * words[qid] over the written
// entries j < min(total, budget), read back from memory after stage 2
// wrote them (words: each slot's k-mer, so a wrong slot shows): a block
// sums its share in registers and adds it to *out with one 64-bit atomic,
// whose unsigned wrap is the int64 sum's.
__global__ void __launch_bounds__(kTile) occ_csr_sum_kernel(
    const int32_t* ref_id, const int64_t* ref_pos, const int8_t* orient, const int32_t* qid,
    const int64_t* words, const int64_t* total, int64_t budget, unsigned long long* out) {
  __shared__ int64_t red[kTile / 32];
  const int64_t lim = *total < budget ? *total : budget;
  int64_t acc = 0;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x; j < lim;
       j += static_cast<int64_t>(gridDim.x) * kTile)
    acc += ref_pos[j] + ref_id[j] + orient[j] + 2 * __ldg(words + qid[j]);
  acc = block_sum(acc, red);
  if (threadIdx.x == 0 && acc != 0) atomicAdd(out, static_cast<unsigned long long>(acc));
}

int64_t resident_grid(const void* kernel, int64_t want) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTile, 0);
  const int64_t grid = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  return want < grid ? want : grid;
}

}  // namespace

// ``out`` (one int64 on the device) set to occ_csr_sum_kernel's sum of the
// written entries; returns a cudaError_t.
extern "C" int occ_csr_sum(const void* ref_id, const void* ref_pos, const void* orient,
                           const void* qid, const void* words, const void* total, int64_t budget,
                           void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(out, 0, sizeof(int64_t), st);
  const int64_t grid = resident_grid(reinterpret_cast<const void*>(occ_csr_sum_kernel),
                                     (budget + kTile - 1) / kTile);
  if (grid > 0)
    occ_csr_sum_kernel<<<static_cast<unsigned>(grid), kTile, 0, st>>>(
        static_cast<const int32_t*>(ref_id), static_cast<const int64_t*>(ref_pos),
        static_cast<const int8_t*>(orient), static_cast<const int32_t*>(qid),
        static_cast<const int64_t*>(words), static_cast<const int64_t*>(total), budget,
        static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Launch the three stages on ``stream``; returns a cudaError_t.
extern "C" int occ_csr(const void* arg_block, void* stream) {
  const Args* a = static_cast<const Args*>(arg_block);
  if (a->m <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned tiles = static_cast<unsigned>((a->m + kTile - 1) / kTile);
  occ_csr_kernel<<<tiles, kTile, 0, st>>>(*a, 0);
  occ_csr_kernel<<<tiles, kTile, 0, st>>>(*a, 1);
  const int64_t grid = resident_grid(reinterpret_cast<const void*>(occ_csr_kernel),
                                     (a->budget + kOccTile - 1) / kOccTile);
  if (grid > 0) occ_csr_kernel<<<static_cast<unsigned>(grid), kTile, 0, st>>>(*a, 2);
  return static_cast<int>(cudaGetLastError());
}
