// Random-gather rate lab for Hopper (sm_90a): five small kernels that
// measure how fast this card serves the reads every probe of the engine is
// made of, and three measurement kernels that are no port (l2_stream,
// l2_sectors, sector_reads).
//
// Replaces the TPU lab kernels (all verified in interpret mode only there):
//   gather_u32     <- labs/pallas_probe.py::gather_kernel (pallas_gather)
//   hash_mix32x8   <- labs/pallas_probe.py::hash_kernel (pallas_hash)
//   xor_rows       <- labs/tpu_dma_lab.py::vmem_loop_kernel (vmem_loop)
//   xor_rows_ring  <- labs/tpu_dma_lab.py::dma_ring_kernel (dma_ring)
//   gather_rows    <- labs/tpu_dma_lab.py::tiled_kernel (tiled_gather)
// Contracts: bit-identical to the plain torch versions beside the wrappers
// in mazu_tpu_torch/ops/gather_lab.py.
//
// What bounds them on this card:
// - gather_u32: 2^20 random 4-byte reads from a 1 MB table. The TPU kept
//   the table in VMEM. Here no block's 227 KB of shared memory holds it, so
//   it stays resident in the 50 MB L2 and each read costs a 32-byte L2
//   sector: the L2's random-sector rate (~136 G/s, l2_sectors) bounds it,
//   not the 9 MB it moves. A cluster of 8 blocks can hold the table in
//   their shared memory, but a peer's shared memory serves random words at
//   ~80 G/s, and sorting the reads by owner to fetch them in runs cost more
//   than it saved (PERF.md section 6). So: one thread a word, read-only loads,
//   which keep the L2 at ~93% of that rate, and a programmatic dependent
//   launch that overlaps a launch with the tail of the one before it.
// - hash_mix32x8: elementwise, 8 MB in and out; 24 integer operations a
//   word are far below the ALU rate, so memory bounds it. 16-byte vector
//   loads and stores, a masked tail.
// - xor_rows: N random 512-byte rows of an i32[T,128] table XOR-reduced
//   into one row. The TPU ran one scalar loop over VMEM. At T=16384 the 8
//   MB table stays in L2, and every one of the N rows is read (XOR cancels
//   in pairs, but skipping a row would stop the lab measuring a gather), so
//   the L2's rate for random 512-byte rows bounds it, not the bytes of the
//   distinct rows. The design keeps the L2 busy and adds little else:
//   . one wave: 1024-thread blocks, as many as the SMs hold at once (the
//     wrapper asks xor_rows_blocks), no second wave and no tail of blocks;
//   . each warp takes one contiguous run of the indices, balanced to
//     within one group of 32, loads them 32 at a time with one coalesced
//     load (lane i takes idx[base + i]), the next 32 before the current
//     are used, and hands each out with __shfl_sync: no index load sits
//     in front of a row load;
//   . a lane issues kRowLoads independent 16-byte row loads (one coalesced
//     512-byte row a warp each) before it XORs any of them;
//   . the fold: a block XORs its warps' rows through shared memory into
//     its row of a [blocks, 128] scratch; the last block to take a ticket
//     XORs the blocks' rows into the output and sets the ticket back to 0,
//     so nothing zero-fills the output and no atomics meet on it. The
//     ticket is one per kernel and device: launch each kernel on one
//     stream of a device at a time.
//   What is left is the L2's rate (l2_stream below), a launch and the
//   ticket's round trips at the end (PERF.md section 6).
// - xor_rows_ring: the same result and the same index runs, wave and fold;
//   each warp keeps a kRing-deep ring of 512-byte shared-memory slots,
//   filled by cp.async.cg (16 B a lane) and waited on with commit_group /
//   wait_group<kRing-1>, as the TPU kernel did with DMA semaphores. Each
//   lane reads back only the 16 bytes it copied, so no cross-lane barrier
//   is needed inside the ring. The slots start on 128-byte bounds: 16
//   bytes off, the same ring ran at half the rate. One 512-byte
//   cp.async.bulk a row (one lane, completing on the slot's mbarrier) lost
//   to this fill by 2.5x: the copy engine's cost per copy bounds it at
//   ~2.5 TB/s for rows this small.
// - gather_rows: the rows written back to an i32[N,128] output, one warp
//   per row, 16-byte loads and stores: the 128 MB written bound it.
// - l2_stream (no TPU kernel: the yardstick of the L2 floors that
//   chip_smoke.py reports): reads a [2^bits, 128] table reps times in one
//   launch with 16-byte ld.global.cg loads (cached in L2 only, so no SM's
//   L1 serves a repeat), each pass over the rows in order or in a fresh
//   random permutation, each (pass, row) read by one warp; XORs what it
//   reads into one row a block.
// - l2_sectors (no TPU kernel: L1's sector floor): the same for 4-byte
//   words of a 2^bits-word table, a fresh random permutation a pass, the
//   addresses made in registers, 8 independent ld.global.cg loads a lane in
//   flight; XORs them into one word a block.
// - sector_reads (no TPU kernel): gather_u32's first design, frozen, with a plain
//   launch: the random-sector rate over a 1 GB table that K2's and K3's
//   sector floors use, which no change to gather_u32 may move.
//
// Every entry launches on ``stream``, allocates nothing and returns
// cudaGetLastError() (0 on success); the *_blocks queries return a block
// count, or minus a CUDA error. Row tables and outputs must be 16-byte
// aligned; indices must lie in [0, rows) and are not checked.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowInt4 = 32;  // a 128 x i32 row is 32 int4, one per lane
constexpr int kMaxBlocks = 132 * 16;
constexpr int kFoldWarps = 32;  // xor_rows, xor_rows_ring, l2_stream: 1024-thread blocks
constexpr int kFoldThreads = kFoldWarps * 32;
constexpr int kRowLoads = 4;  // xor_rows: row loads a lane issues before it XORs them
constexpr int kRing = 8;      // xor_rows_ring: 512-byte slots a warp
constexpr int kRingBytes = kFoldWarps * kRing * kRowInt4 * 16;
constexpr int kStreamLoads = 4;  // l2_stream: row loads a lane in flight
constexpr int kSectorLoads = 8;  // l2_sectors: word loads a lane in flight
constexpr unsigned kFullMask = 0xffffffffu;

// Blocks of xor_rows and xor_rows_ring that have stored their row; the
// last block of a launch sets its kernel's count back to 0.
__device__ unsigned g_tickets[2];

// One thread a word (the first design's body). The launch lets the next kernel on
// the stream launch before this one ends (launch_dependents), and the
// kernel waits for the grids before it to end, their writes visible
// (wait), before it reads anything: consecutive launches overlap one's
// tail with the next one's launch, and every read sees what earlier
// kernels wrote.
__global__ void gather_u32_kernel(const uint32_t* __restrict__ tbl,
                                  const int32_t* __restrict__ idx,
                                  uint32_t* __restrict__ out, int64_t n) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __ldg(tbl + __ldg(idx + i));
}

// gather_u32's first design, frozen as sector_reads: one thread a word, a
// plain launch.
__global__ void sector_reads_kernel(const uint32_t* __restrict__ tbl,
                                    const int32_t* __restrict__ idx,
                                    uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __ldg(tbl + __ldg(idx + i));
}

__device__ __forceinline__ uint32_t mix8(uint32_t z) {
#pragma unroll
  for (int r = 0; r < 8; ++r) z = (z ^ (z >> 16)) * 0x85EBCA6Bu;
  return z;
}

// n4 full uint4 vectors, then the n - 4*n4 tail words one per thread.
__global__ void hash_mix32x8_kernel(const uint32_t* __restrict__ x,
                                    uint32_t* __restrict__ out, int64_t n,
                                    int64_t n4) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n4) {
    uint4 v = reinterpret_cast<const uint4*>(x)[i];
    v.x = mix8(v.x);
    v.y = mix8(v.y);
    v.z = mix8(v.z);
    v.w = mix8(v.w);
    reinterpret_cast<uint4*>(out)[i] = v;
  } else {
    const int64_t t = 4 * n4 + (i - n4);
    if (t < n) out[t] = mix8(x[t]);
  }
}

__device__ __forceinline__ int4 xor4(int4 a, int4 b) {
  return make_int4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

// This warp's rows [begin, end): the 32-index groups of [0, n) dealt out as
// one contiguous run a warp, runs differing by at most one group.
__device__ __forceinline__ void warp_rows(int64_t n, int64_t& begin, int64_t& end) {
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kFoldWarps;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kFoldWarps + threadIdx.x / 32;
  const int64_t groups = (n + 31) / 32;
  begin = w * groups / warps * 32;
  end = (w + 1) * groups / warps * 32;
  if (begin > n) begin = n;
  if (end > n) end = n;
}

// One coalesced load of a group: lane i gets idx[base + i], 0 past end.
__device__ __forceinline__ int32_t index_group(const int32_t* __restrict__ idx, int64_t base,
                                               int64_t end) {
  const int64_t i = base + threadIdx.x % 32;
  return i < end ? __ldg(idx + i) : 0;
}

// XOR the block's warp rows into part[blockIdx]. With a ticket, the last
// block to take one XORs all the blocks' rows into out and sets the ticket
// back to 0; without (l2_stream), the rows stay in part.
__device__ __forceinline__ void fold_blocks(int4 acc, int4* __restrict__ part,
                                            int4* __restrict__ out, unsigned* ticket) {
  __shared__ __align__(128) int4 red[kFoldWarps][kRowInt4];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0) {
    int4 v = red[0][lane];
#pragma unroll
    for (int w = 1; w < kFoldWarps; ++w) v = xor4(v, red[w][lane]);
    __stcg(part + static_cast<int64_t>(blockIdx.x) * kRowInt4 + lane, v);
  }
  if (ticket == nullptr) return;
  __syncthreads();
  int last = 0;
  if (threadIdx.x == 0) {
    unsigned t;
    // release: the block's row above is visible to the block that
    // acquires the last ticket
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(t) : "l"(ticket) : "memory");
    last = t == gridDim.x - 1;
  }
  if (!__syncthreads_or(last)) return;
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
  int4 v = make_int4(0, 0, 0, 0);
#pragma unroll 4
  for (int b = warp; b < static_cast<int>(gridDim.x); b += kFoldWarps)
    v = xor4(v, __ldcg(part + static_cast<int64_t>(b) * kRowInt4 + lane));
  red[warp][lane] = v;
  __syncthreads();
  if (warp == 0) {
    int4 o = red[0][lane];
#pragma unroll
    for (int w = 1; w < kFoldWarps; ++w) o = xor4(o, red[w][lane]);
    out[lane] = o;
    if (lane == 0) *ticket = 0;
  }
}

__device__ __forceinline__ int4 row_load(const int4* __restrict__ tbl, int32_t row, int lane) {
  return __ldg(tbl + static_cast<int64_t>(row) * kRowInt4 + lane);
}

__global__ void __launch_bounds__(kFoldThreads) xor_rows_kernel(const int4* __restrict__ tbl,
                                                                const int32_t* __restrict__ idx,
                                                                int4* __restrict__ part,
                                                                int4* __restrict__ out,
                                                                int64_t n) {
  const int lane = threadIdx.x % 32;
  int64_t begin, end;
  warp_rows(n, begin, end);
  int4 acc = make_int4(0, 0, 0, 0);
  int32_t group = index_group(idx, begin, end);
  for (int64_t base = begin; base < end; base += 32) {
    const int32_t next = index_group(idx, base + 32, end);
    if (end - base >= 32) {
#pragma unroll
      for (int j = 0; j < 32; j += kRowLoads) {
        int4 v[kRowLoads];
#pragma unroll
        for (int u = 0; u < kRowLoads; ++u)
          v[u] = row_load(tbl, __shfl_sync(kFullMask, group, j + u), lane);
#pragma unroll
        for (int u = 0; u < kRowLoads; ++u) acc = xor4(acc, v[u]);
      }
    } else {  // the last group of all, ragged
      for (int j = 0; j < end - base; ++j)
        acc = xor4(acc, row_load(tbl, __shfl_sync(kFullMask, group, j), lane));
    }
    group = next;
  }
  fold_blocks(acc, part, out, &g_tickets[0]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 1));
}

__global__ void __launch_bounds__(kFoldThreads) xor_rows_ring_kernel(
    const int4* __restrict__ tbl, const int32_t* __restrict__ idx, int4* __restrict__ part,
    int4* __restrict__ out, int64_t n) {
  extern __shared__ __align__(128) int4 rings[];  // kRingBytes: kRing slots a warp
  const int lane = threadIdx.x % 32;
  int4* ring = rings + (threadIdx.x / 32) * kRing * kRowInt4;
  int64_t begin, end;
  warp_rows(n, begin, end);
  const int64_t m = end - begin;
  // row j's index is lane j % 32 of `group` once row j - kRing is consumed
  int32_t group = index_group(idx, begin, end);
  int32_t next = index_group(idx, begin + 32, end);
  auto fill = [&](int slot, int32_t row) {
    cp_async16(ring + slot * kRowInt4 + lane, tbl + static_cast<int64_t>(row) * kRowInt4 + lane);
  };
  // prime the ring; every step commits one group, empty or not, so
  // wait_group<kRing-1> always means "row j has landed"
#pragma unroll
  for (int s = 0; s < kRing; ++s) {
    if (s < m) fill(s, __shfl_sync(kFullMask, group, s));
    cp_async_commit();
  }
  int4 acc = make_int4(0, 0, 0, 0);
  for (int64_t j = 0; j < m; ++j) {
    const int slot = static_cast<int>(j % kRing);
    cp_async_wait_ring();
    acc = xor4(acc, ring[slot * kRowInt4 + lane]);
    const int64_t nj = j + kRing;
    if (nj < m) {
      const int k = static_cast<int>(nj % 32);
      if (k == 0) {
        group = next;
        next = index_group(idx, begin + nj + 32, end);
      }
      fill(slot, __shfl_sync(kFullMask, group, k));
    }
    cp_async_commit();
  }
  asm volatile("cp.async.wait_all;\n" ::);
  fold_blocks(acc, part, out, &g_tickets[1]);
}

__device__ __forceinline__ uint32_t mix32(uint32_t z) {
  z = (z ^ (z >> 16)) * 0x85EBCA6Bu;
  z = (z ^ (z >> 13)) * 0xC2B2AE35u;
  return z ^ (z >> 16);
}

// A bijection of [0, 2^bits) drawn from the pass number: odd multiplies
// and xor-shifts, each invertible mod 2^bits.
struct PassOrder {
  uint32_t a, b, c, mask;
  int shift;
  __device__ __forceinline__ PassOrder(uint32_t pass, int bits)
      : a(mix32(0x5BD1E995u ^ (pass * 0x9E3779B9u)) | 1u),
        b(mix32(a + 0x632BE5ABu) | 1u),
        c(mix32(b)),
        mask((1u << bits) - 1),
        shift(bits / 2) {}
  __device__ __forceinline__ uint32_t operator()(uint32_t i) const {
    uint32_t x = ((i ^ c) * a) & mask;
    x ^= x >> shift;
    x = (x * b) & mask;
    return x ^ (x >> shift);
  }
};

// Row f of all reps * 2^bits reads is row i = f mod 2^bits of pass f >> bits
// (in a fresh order a pass if ``random``). A warp takes kStreamLoads
// consecutive reads at a time, every warp a different set.
__global__ void __launch_bounds__(kFoldThreads) l2_stream_kernel(const int4* __restrict__ tbl,
                                                                 int bits, int reps, int random,
                                                                 int4* __restrict__ part) {
  const int lane = threadIdx.x % 32;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kFoldWarps;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kFoldWarps + threadIdx.x / 32;
  const uint32_t mask = (1u << bits) - 1;
  const int64_t total = static_cast<int64_t>(reps) << bits;
  int4 acc = make_int4(0, 0, 0, 0);
  for (int64_t f = w * kStreamLoads; f < total; f += warps * kStreamLoads) {
    const PassOrder order(static_cast<uint32_t>(f >> bits), bits);
    int4 v[kStreamLoads];
#pragma unroll
    for (int u = 0; u < kStreamLoads; ++u) {
      const uint32_t i = static_cast<uint32_t>(f + u) & mask;
      const int64_t row = random ? order(i) : i;
      v[u] = __ldcg(tbl + row * kRowInt4 + lane);
    }
#pragma unroll
    for (int u = 0; u < kStreamLoads; ++u) acc = xor4(acc, v[u]);
  }
  fold_blocks(acc, part, nullptr, nullptr);
}

// Word f of all reps * 2^bits reads is word order(f mod 2^bits) of pass
// f >> bits, a fresh permutation a pass; a lane takes kSectorLoads
// consecutive reads (one pass: bits >= 3) at a time and XORs them; a
// block's XOR goes to part[blockIdx].
__global__ void __launch_bounds__(kFoldThreads) l2_sectors_kernel(const uint32_t* __restrict__ tbl,
                                                                  int bits, int reps,
                                                                  uint32_t* __restrict__ part) {
  __shared__ uint32_t red[kFoldWarps];
  const int64_t threads = static_cast<int64_t>(gridDim.x) * kFoldThreads;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kFoldThreads + threadIdx.x;
  const uint32_t mask = (1u << bits) - 1;
  const int64_t total = static_cast<int64_t>(reps) << bits;
  uint32_t acc = 0;
  for (int64_t f = t * kSectorLoads; f < total; f += threads * kSectorLoads) {
    const PassOrder order(static_cast<uint32_t>(f >> bits), bits);
    uint32_t v[kSectorLoads];
#pragma unroll
    for (int u = 0; u < kSectorLoads; ++u)
      v[u] = __ldcg(tbl + order(static_cast<uint32_t>(f + u) & mask));
#pragma unroll
    for (int u = 0; u < kSectorLoads; ++u) acc ^= v[u];
  }
#pragma unroll
  for (int d = 16; d; d >>= 1) acc ^= __shfl_xor_sync(kFullMask, acc, d);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t v = 0;
#pragma unroll
    for (int w = 0; w < kFoldWarps; ++w) v ^= red[w];
    part[blockIdx.x] = v;
  }
}

__global__ void gather_rows_kernel(const int4* __restrict__ tbl,
                                   const int32_t* __restrict__ idx,
                                   int4* __restrict__ out, int64_t n) {
  const int lane = threadIdx.x % 32;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t r = warp; r < n; r += n_warps) {
    const int64_t row = __ldg(idx + r);
    out[r * kRowInt4 + lane] = __ldg(tbl + row * kRowInt4 + lane);
  }
}

unsigned blocks_for(int64_t items, int64_t per_block) {
  int64_t b = (items + per_block - 1) / per_block;
  return static_cast<unsigned>(b < 1 ? 1 : b);
}

unsigned row_blocks(int64_t n) {
  const unsigned b = blocks_for(n, kWarps);
  return b < kMaxBlocks ? b : kMaxBlocks;
}

// Blocks of one wave of ``fn`` on the current device: its SMs times the
// blocks of ``fn`` one SM holds, from ``fn``'s registers and ``smem``.
int one_wave(const void* fn, int smem) {
  int dev = 0, sms = 0, per = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, fn, kFoldThreads, smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return sms * per;
}

// xor_rows_ring's ring is over the 48 KB that a block gets unasked.
cudaError_t ring_smem() {
  return cudaFuncSetAttribute(xor_rows_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kRingBytes);
}

}  // namespace

// gather_u32's frozen first design: the random-sector yardstick of K2's and
// K3's floors (chip_smoke.py's 1 GB table) and the "before" of L1's A/B.
extern "C" int sector_reads(const void* tbl, const void* idx, void* out, int64_t n,
                            void* stream) {
  if (n <= 0) return 0;
  sector_reads_kernel<<<blocks_for(n, kThreads), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tbl), static_cast<const int32_t*>(idx),
      static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// Launched with programmatic stream serialization (see gather_u32_kernel).
extern "C" int gather_u32(const void* tbl, const void* idx, void* out, int64_t n,
                          void* stream) {
  if (n <= 0) return 0;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks_for(n, kThreads));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, gather_u32_kernel, static_cast<const uint32_t*>(tbl),
                         static_cast<const int32_t*>(idx), static_cast<uint32_t*>(out), n);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// ``vec``: x and out are 16-byte aligned, so whole uint4 vectors may be used.
extern "C" int hash_mix32x8(const void* x, void* out, int64_t n, int vec,
                            void* stream) {
  if (n <= 0) return 0;
  const int64_t n4 = vec ? n / 4 : 0;
  const int64_t items = n4 + (n - 4 * n4);
  hash_mix32x8_kernel<<<blocks_for(items, kThreads), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), n, n4);
  return static_cast<int>(cudaGetLastError());
}

// One wave of each kernel on the current device; the wrapper's fold
// scratch has a row for each block.
extern "C" int xor_rows_blocks() {
  return one_wave(reinterpret_cast<const void*>(xor_rows_kernel), 0);
}

extern "C" int xor_rows_ring_blocks() {
  const cudaError_t e = ring_smem();
  if (e != cudaSuccess) return -static_cast<int>(e);
  return one_wave(reinterpret_cast<const void*>(xor_rows_ring_kernel), kRingBytes);
}

extern "C" int l2_sectors_blocks() {
  return one_wave(reinterpret_cast<const void*>(l2_sectors_kernel), 0);
}

extern "C" int l2_stream_blocks() {
  return one_wave(reinterpret_cast<const void*>(l2_stream_kernel), 0);
}

// ``part``: [blocks, 128] int32 scratch (any contents); ``out``: the
// (1, 128) result, written whole by the launch's last block.
extern "C" int xor_rows(const void* tbl, const void* idx, void* part, void* out, int64_t n,
                        int blocks, void* stream) {
  if (n <= 0) return 0;
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  xor_rows_kernel<<<blocks, kFoldThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(tbl), static_cast<const int32_t*>(idx), static_cast<int4*>(part),
      static_cast<int4*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int xor_rows_ring(const void* tbl, const void* idx, void* part, void* out, int64_t n,
                             int blocks, void* stream) {
  if (n <= 0) return 0;
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = ring_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  xor_rows_ring_kernel<<<blocks, kFoldThreads, kRingBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(tbl), static_cast<const int32_t*>(idx), static_cast<int4*>(part),
      static_cast<int4*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// ``tbl``: [2^bits, 128] int32; ``part``: [blocks, 128], one row a block.
extern "C" int l2_stream(const void* tbl, int bits, int reps, int random, void* part,
                         int blocks, void* stream) {
  if (bits < 0 || bits > 30 || reps <= 0 || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  l2_stream_kernel<<<blocks, kFoldThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(tbl), bits, reps, random, static_cast<int4*>(part));
  return static_cast<int>(cudaGetLastError());
}

// ``tbl``: 2^bits words (bits >= 3); ``part``: [blocks] words, one a block.
extern "C" int l2_sectors(const void* tbl, int bits, int reps, void* part, int blocks,
                          void* stream) {
  if (bits < 3 || bits > 30 || reps <= 0 || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  l2_sectors_kernel<<<blocks, kFoldThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tbl), bits, reps, static_cast<uint32_t*>(part));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gather_rows(const void* tbl, const void* idx, void* out, int64_t n,
                           void* stream) {
  if (n <= 0) return 0;
  gather_rows_kernel<<<row_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(tbl), static_cast<const int32_t*>(idx),
      static_cast<int4*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
