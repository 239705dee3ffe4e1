// Random-gather rate lab for Hopper (sm_90a): five small kernels that
// measure how fast this card serves the reads every probe of the engine is
// made of.
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
//   the table in VMEM; here it does not fit a block's 227 KB of shared
//   memory, so it stays resident in the 50 MB L2 and each read costs a
//   32-byte L2 sector. Bytes moved (9 MB) bound it at ~0.003 ms; L2 sector
//   throughput sets the pace. One thread per output, read-only loads.
// - hash_mix32x8: elementwise, 8 MB in and out; 24 integer operations a
//   word are far below the ALU rate, so memory bounds it. 16-byte vector
//   loads and stores, a masked tail.
// - xor_rows: N random 512-byte rows of an i32[T,128] table XOR-reduced
//   into one row. The TPU ran one scalar loop over VMEM; here many blocks
//   run at once, one warp per row (32 lanes x 16 B = one coalesced row
//   read), each warp XORs its rows in registers, the block reduces through
//   shared memory and does one atomicXor per column into the output, which
//   the wrapper zeroes. XOR is associative and commutative, so the result
//   does not depend on the order. At T=16384 the 8 MB table fits L2, so L2
//   bandwidth for 512-byte rows sets the pace.
// - xor_rows_ring: the same result; each warp keeps an 8-deep ring of
//   512-byte shared-memory slots filled by cp.async.cg (16 B a lane) and
//   waits with commit_group / wait_group<RING-1>, as the TPU kernel did
//   with DMA semaphores. Each lane reads back only the 16 bytes it copied,
//   so no cross-lane barrier is needed inside the ring.
// - gather_rows: the rows written back to an i32[N,128] output, one warp
//   per row, 16-byte loads and stores: the 128 MB written bound it.
//
// Every entry launches on ``stream``, allocates nothing and returns
// cudaGetLastError() (0 on success). Row tables and outputs must be 16-byte
// aligned; indices must lie in [0, rows) and are not checked.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowInt4 = 32;  // a 128 x i32 row is 32 int4, one per lane
constexpr int kRing = 8;
constexpr int kMaxBlocks = 132 * 16;

__global__ void gather_u32_kernel(const uint32_t* __restrict__ tbl,
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

// XOR the per-warp rows of a block together and fold the block's row into
// out[128] with one atomicXor per column.
__device__ __forceinline__ void block_fold(int4 acc, int32_t* __restrict__ out) {
  __shared__ int4 part[kWarps][kRowInt4];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  part[warp][lane] = acc;
  __syncthreads();
  if (threadIdx.x < 128) {
    const int c = threadIdx.x;
    const int32_t* p = reinterpret_cast<const int32_t*>(&part[0][0]);
    int32_t v = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v ^= p[w * 128 + c];
    if (v) atomicXor(out + c, v);
  }
}

__global__ void xor_rows_kernel(const int4* __restrict__ tbl,
                                const int32_t* __restrict__ idx,
                                int32_t* __restrict__ out, int64_t n) {
  const int lane = threadIdx.x % 32;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kWarps;
  int4 acc = make_int4(0, 0, 0, 0);
  for (int64_t r = warp; r < n; r += n_warps) {
    const int64_t row = __ldg(idx + r);
    acc = xor4(acc, __ldg(tbl + row * kRowInt4 + lane));
  }
  block_fold(acc, out);
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

__global__ void xor_rows_ring_kernel(const int4* __restrict__ tbl,
                                     const int32_t* __restrict__ idx,
                                     int32_t* __restrict__ out, int64_t n) {
  __shared__ int4 ring[kWarps][kRing][kRowInt4];
  const int lane = threadIdx.x % 32, wib = threadIdx.x / 32;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarps + wib;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kWarps;
  // this warp's rows are r = warp + j * n_warps, j = 0 .. m-1
  const int64_t m = warp < n ? (n - warp + n_warps - 1) / n_warps : 0;
  // prime the ring; every step commits one group, empty or not, so
  // wait_group<RING-1> always means "row j has landed"
#pragma unroll
  for (int s = 0; s < kRing; ++s) {
    if (s < m) {
      const int64_t row = __ldg(idx + warp + s * n_warps);
      cp_async16(&ring[wib][s][lane], tbl + row * kRowInt4 + lane);
    }
    cp_async_commit();
  }
  int4 acc = make_int4(0, 0, 0, 0);
  for (int64_t j = 0; j < m; ++j) {
    const int slot = static_cast<int>(j % kRing);
    cp_async_wait_ring();
    acc = xor4(acc, ring[wib][slot][lane]);
    const int64_t nj = j + kRing;
    if (nj < m) {
      const int64_t row = __ldg(idx + warp + nj * n_warps);
      cp_async16(&ring[wib][slot][lane], tbl + row * kRowInt4 + lane);
    }
    cp_async_commit();
  }
  asm volatile("cp.async.wait_all;\n" ::);
  block_fold(acc, out);
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

}  // namespace

extern "C" int gather_u32(const void* tbl, const void* idx, void* out, int64_t n,
                          void* stream) {
  if (n <= 0) return 0;
  gather_u32_kernel<<<blocks_for(n, kThreads), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tbl), static_cast<const int32_t*>(idx),
      static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
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

extern "C" int xor_rows(const void* tbl, const void* idx, void* out, int64_t n,
                        void* stream) {
  if (n <= 0) return 0;
  xor_rows_kernel<<<row_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(tbl), static_cast<const int32_t*>(idx),
      static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int xor_rows_ring(const void* tbl, const void* idx, void* out, int64_t n,
                             void* stream) {
  if (n <= 0) return 0;
  xor_rows_ring_kernel<<<row_blocks(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(tbl), static_cast<const int32_t*>(idx),
      static_cast<int32_t*>(out), n);
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
