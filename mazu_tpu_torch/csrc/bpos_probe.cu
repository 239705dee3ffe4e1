// SSHash direct-engine capacity probe for Hopper (sm_90a): one bpos bucket
// row, then up to plim useqrec window records per query.
//
// Replaces mazu_tpu/ops/pallas_capacity.py::_kernel_bpos (launched by
// _pallas_bpos_probe, wrapped by pallas_bpos_usrec_k2u). Contract:
// bit-identical to sshash_k2u(d, fw, mode="main", probe_limit=plim) on the
// direct + bpos + useqrec layout (mazu_tpu_torch/kphf/sshash.py), the
// kernel's plain torch version.
//
// What bounds it on this card: random reads from tables far past the 50
// MB L2 (2.1 GB of bpos rows and 0.5 GB of records at 300 Mbp). The
// card serves them as 64-byte blocks: random 4-byte reads of a 1 GB table
// run at 27.96 G a second (chip_smoke.py phase 3), and the previous design
// of this kernel, on the [L, 7] records, moved 4.27 sectors of 32 bytes a
// lane at 1.19x that rate, because a 56-byte record's two or three
// sectors share one or two 64-byte blocks. A lane reads its 16-byte bpos
// row (one block) and a record per probed row: 1.75 blocks on average at
// 56-byte rows.
//
// Design: one lane per thread, the lane's reads in first-hit order (the
// bpos row; then row j's record only after row j-1's candidates missed),
// and the records read from a copy of useqrec padded to 64-byte rows
// (ops/bpos_probe.padded_records makes it once per records tensor), so
// that each record is one 64-byte block: three 16-byte loads and one
// 8-byte load. Both candidates of a row are verified in row order: the
// first that spells the query inside its record's unitig wins, and one
// that spells it outside sets the mt == 3 sentinel, exactly as the
// reference does.
//
// Measured against this design (NVIDIA H100 80GB HBM3, 700 W, 2^20
// queries at probe limit 2, 300 Mbp; one call, in turns): the previous
// design (unpadded records, first-hit order) 0.1348 ms; this one 0.1048
// ms; every probed row's record at once, padded 0.1116 and unpadded
// 0.1319 ms (the rows a first hit makes
// unnecessary cost their blocks); the same staged through cp.async into
// shared memory 0.1271 ms padded and 0.1641 ms unpadded. The kernel is
// bound by the random-block rate, not by latency: issuing more reads at
// once does not help, reading fewer blocks does. kTile lanes a block;
// 256 threads x 4 blocks = 1,024 lanes in flight per SM (64 registers).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;     // lanes per block, one per thread
constexpr int kMinBlocks = 4;  // blocks per SM that the registers must allow
constexpr int kMaxPlim = 3;    // a bpos row holds a bucket's first three positions
constexpr int kRecWords = 8;   // u64 words of a padded record (7 and a pad word)

// Mirrored field by field by _Args in mazu_tpu_torch/ops/bpos_probe.py
// (tests/test_torch_kernel_abi.py holds the two together): every field is
// 8 bytes, so neither side pads.
struct Args {
  const uint64_t* fw;
  const uint4* bpos;      // T rows of (pos0, pos1, pos2, count), u32
  const uint64_t* rec;    // n_rec padded records of kRecWords u64, 64-byte aligned
  int64_t* uid;
  int64_t* ulen;
  int64_t* pos;
  uint8_t* mt;
  uint8_t* use_skew;
  uint8_t* unresolved;
  int64_t* ow;
  int64_t* ow2;
  int64_t* cnt;
  int64_t n, n_rec, tmask, k, w, plim, seed;
  int64_t skew_param;     // < 0: no skew table
  int64_t last_km;        // total_len - k
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

__global__ void __launch_bounds__(kTile, kMinBlocks)
    bpos_probe_kernel(const __grid_constant__ Args p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  if (i >= p.n) return;
  const int k = static_cast<int>(p.k), w = static_cast<int>(p.w), span = k - w;
  const int plim = static_cast<int>(p.plim);
  const uint32_t seed = static_cast<uint32_t>(p.seed);
  const uint64_t m2k = (k >= 32) ? ~0ull : ((1ull << (2 * k)) - 1);
  const uint64_t mw = (1ull << (2 * w)) - 1;

  // key prep: reverse complement, canonical word, the mix32 minimizer
  // (strict <, leftmost window wins ties), its offset and the bucket
  const uint64_t x = __ldg(p.fw + i);
  const uint64_t rc = reverse_groups(~x) >> (64 - 2 * k);
  const bool is_fw = x <= rc;
  const uint64_t canon = is_fw ? x : rc;
  uint64_t mm = canon & mw;
  uint32_t best = mix32(static_cast<uint32_t>(mm) ^ seed);
  int best_j = 0;
  for (int j = 1; j <= span; ++j) {
    const uint64_t mv = (canon >> (2 * j)) & mw;
    const uint32_t sc = mix32(static_cast<uint32_t>(mv) ^ seed);
    if (sc < best) {
      best = sc;
      mm = mv;
      best_j = j;
    }
  }
  const int64_t offset = is_fw ? best_j : span - best_j;
  const int64_t offs[2] = {offset, span - offset};
  const uint32_t h =
      (mix32(static_cast<uint32_t>(mm) ^ 0x9E3779B9u) ^
       mix32(static_cast<uint32_t>(mm >> 32) + 0xC2B2AE35u)) & static_cast<uint32_t>(p.tmask);

  const uint4 row = __ldg(p.bpos + h);
  const uint32_t bp[kMaxPlim] = {row.x, row.y, row.z};
  const int64_t n_occs = row.w;
  const bool skew = p.skew_param >= 0 && n_occs > p.skew_param;

  bool found = false, sentinel = false;
  int64_t o_uid = 0, o_ulen = 0, o_pos = 0, o_cnt = 0;
  uint64_t o_ow = 0, o_ow2 = 0;
  uint8_t o_mt = 0;
  const int depth = skew ? 0 : static_cast<int>(n_occs < plim ? n_occs : plim);
  const int64_t last_c = p.last_km > 0 ? p.last_km : 0;
#pragma unroll
  for (int j = 0; j < kMaxPlim; ++j) {
    if (j >= depth || found) break;
    const int64_t mm_pos = bp[j];
    const int64_t base = mm_pos - span > 0 ? mm_pos - span : 0;
    int64_t wi = (base * 2) >> 6;
    wi = wi < p.n_rec - 1 ? wi : p.n_rec - 1;
    const ulonglong2* r = reinterpret_cast<const ulonglong2*>(p.rec + wi * kRecWords);
    const ulonglong2 v0 = __ldg(r), v1 = __ldg(r + 1), v2 = __ldg(r + 2);
    const uint64_t q[7] = {v0.x, v0.y, v1.x, v1.y, v2.x, v2.y, __ldg(p.rec + wi * kRecWords + 6)};
    const int64_t ustart = static_cast<int64_t>(q[3] & ((1ull << 40) - 1));
    const int64_t ul = static_cast<int64_t>(q[3] >> 40);
    const int woff = static_cast<int>((base * 2) & 63);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int64_t km_pos = mm_pos - offs[c];
      const bool in_range = mm_pos >= offs[c] && km_pos <= p.last_km;
      const int64_t km_pos_c = km_pos < 0 ? 0 : (km_pos > last_c ? last_c : km_pos);
      const int64_t delta = km_pos_c - base > 0 ? km_pos_c - base : 0;
      const int dbit = woff + 2 * static_cast<int>(delta);
      const int rr = dbit & 63;
      const uint64_t lo = dbit >= 64 ? q[1] : q[0];
      const uint64_t hi = dbit >= 64 ? q[2] : q[1];
      const uint64_t kw = ((lo >> rr) | (rr ? hi << (64 - rr) : 0ull)) & m2k;
      const uint8_t m = kw == x ? 1 : (kw == rc ? 2 : 0);
      if (!in_range || m == 0) continue;
      if (km_pos_c >= ustart && km_pos_c + k <= ustart + ul) {
        found = true;
        o_mt = m;
        o_uid = static_cast<int64_t>(q[4] & 0xFFFFFFFFull);
        o_cnt = static_cast<int64_t>(q[4] >> 32);
        o_ulen = ul;
        o_pos = km_pos_c - ustart;
        o_ow = q[5];
        o_ow2 = q[6];
        break;
      }
      // the query's word sits in the window but not inside the record's
      // unitig: the reference's mt == 3 sentinel, settled in phase 2
      sentinel = true;
    }
  }
  p.uid[i] = o_uid;
  p.ulen[i] = o_ulen;
  p.pos[i] = o_pos;
  p.mt[i] = o_mt;
  p.use_skew[i] = skew ? 1 : 0;
  p.unresolved[i] = (!found && !skew && n_occs > plim) || (!found && sentinel) ? 1 : 0;
  p.ow[i] = static_cast<int64_t>(o_ow);
  p.ow2[i] = static_cast<int64_t>(o_ow2);
  p.cnt[i] = o_cnt;
}

}  // namespace

// Launches on ``stream``, allocates nothing, and returns cudaGetLastError()
// (0 on success); 1000 for a probe limit the kernel cannot take.
// ``arg_block`` points at an Args (untyped: Args has internal linkage).
// ``bpos`` holds tmask + 1 rows of 4 u32 (16-byte aligned); ``rec`` holds
// n_rec padded records of 8 u64 (64-byte aligned). Outputs: uid, ulen, pos,
// cnt (int64), mt, use_skew, unresolved (uint8), ow, ow2 (u64 bit patterns).
extern "C" int bpos_probe(const void* arg_block, void* stream) {
  const Args* args = static_cast<const Args*>(arg_block);
  if (args->n <= 0) return 0;
  if (args->plim < 1 || args->plim > kMaxPlim) return 1000;
  const int64_t blocks = (args->n + kTile - 1) / kTile;
  bpos_probe_kernel<<<static_cast<unsigned>(blocks), kTile, 0,
                      static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}
