// SSHash capacity-tier main probe for Hopper (sm_90a): grouped16 bucket
// bounds, packed positions and the paired words2 candidate window, with
// validation deferred to the winner, behind a direct bucket table or a
// BooPHF32 minimizer MPHF.
//
// Replaces mazu_tpu/ops/pallas_capacity.py::_kernel (launched by
// _pallas_capacity_probe, wrapped by pallas_capacity_k2u). The Pallas
// kernel did only the bounds, the position window and the candidate
// verify; its wrapper left the key prep, the MPHF chain and the tail
// (validate+rank, the uproj or extent mapping) to XLA. Here all of it runs
// in this one kernel. Contract: bit-identical to sshash_k2u(d, fw,
// mode="main", probe_limit=plim, defer_valid=True, mphf_level_limit=mlim)
// on the grouped16 + packed + paired layout without window records
// (mazu_tpu_torch/kphf/sshash.py), the kernel's plain torch version.
//
// What bounds it on this card: a chain of dependent random reads per
// query, from tables far past the 50 MB L2 at 300 Mbp (about 0.1 GB of
// gdelta and 0.16 GB of packed positions): up to mlim MPHF level words
// plus one 32-byte rank block, two gdelta and two gbase reads, one or two
// packed words per probed row, two words2 rows per probed row, two wb2
// rows and one uproj row. So DRAM latency sets the pace, not arithmetic.
//
// Design: one thread per query, one launch for the whole main probe. A
// thread reads its 8-byte forward word, computes the reverse complement,
// the canonical word and the 13..17-window mix32 minimizer (strict <, the
// leftmost window wins ties) and its offset; then the bucket: the direct
// table's fold_hash32(mm) & (T-1), or the BooPHF32 chain (one bit test per
// level until a hit, at most n_test levels; the rank of the hit bit from
// its block's u32 count and at most eight words of one 32-byte sector; in
// the full chain only, a binary search of the sorted final-hash keys). A
// skew bucket, or a lane the MPHF did not place, reads nothing more. The
// others read min(bound, n_occs) positions and, per position, the 3-word
// candidate window; the first candidate that spells the query wins,
// unvalidated. The winner alone is validated and ranked from one wb2 row
// and the next, then mapped by one uproj row (or its unitig's extent).
// All position math is 64-bit: positions pass 2^31 on a unitig set of
// 2^31 bases or more. Keeping more reads in flight per thread is later
// work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 32;

// Mirrored field by field by _Args in mazu_tpu_torch/ops/capacity_probe.py:
// every field is 8 bytes, so neither side pads.
struct Args {
  const uint64_t* fw;
  const uint16_t* gdelta;   // T + 1 in-group deltas
  const int64_t* gbase;     // one base per 1024 buckets
  const uint64_t* posw;     // packed positions, width bits each
  const uint64_t* words2;   // n_w2 rows (useq word i, word i + 1)
  const uint64_t* wb2;      // n_wb rows (boundary word i, ones before it)
  const uint64_t* uproj;    // n_up rows of 5, or null
  const int64_t* accum2;    // unitig (start, end) rows, read when uproj is null
  const uint32_t* mwords;   // MPHF level words; null for the direct table
  const uint32_t* mranks;   // one count per 256-bit block
  const uint64_t* fh_keys;  // sorted final-hash keys
  const uint32_t* fh_vals;
  int64_t* uid;
  int64_t* ulen;
  int64_t* pos;
  uint8_t* mt;
  uint8_t* use_skew;
  uint8_t* unresolved;
  int64_t* ow;      // the four occurrence outputs are null without uproj
  int64_t* ow2;
  int64_t* cnt;
  int64_t* ostart;
  int64_t n, k, w, seed, skew_param, bound, width, last_km;
  int64_t n_w2, n_wb, n_up, n_unitigs, tmask;
  int64_t n_test;     // MPHF levels to test
  int64_t full_chain; // 1: search the final table after the levels
  int64_t n_fh;
  int64_t n_bits[kMaxLevels];
  int64_t word_off[kMaxLevels];
  int64_t rank_off[kMaxLevels];
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

// The BooPHF32 value of key (-1: a definite miss, or no tested level
// placed it; then *unplaced says so when the chain is truncated).
__device__ __forceinline__ int64_t mphf_value(const Args& a, uint64_t key, bool* unplaced) {
  const uint32_t lo = static_cast<uint32_t>(key);
  uint32_t s0 = mix32(lo ^ 0x9E3779B9u);
  uint32_t s1 = mix32(static_cast<uint32_t>(key >> 32) ^ 0x85EBCA6Bu) ^ lo;
  for (int li = 0; li < a.n_test; ++li) {
    uint32_t t = s1 ^ (s1 << 13);
    t ^= t >> 17;
    t ^= s0 ^ (s0 >> 5);
    const uint32_t h = t + s0;
    s0 = s1;
    s1 = t;
    const uint32_t p = h & static_cast<uint32_t>(a.n_bits[li] - 1);
    const uint32_t* wl = a.mwords + a.word_off[li];
    if (!((__ldg(wl + (p >> 5)) >> (p & 31)) & 1u)) continue;
    const uint32_t word_idx = p >> 5, block_start = (p >> 8) << 3;
    int32_t r = static_cast<int32_t>(__ldg(a.mranks + a.rank_off[li] + (p >> 8)));
    for (uint32_t i = 0; i < 7; ++i)
      if (block_start + i < word_idx) r += __popc(__ldg(wl + block_start + i));
    const uint32_t off = p & 31;
    r += __popc(__ldg(wl + word_idx) & (off ? 0xFFFFFFFFu >> (32 - off) : 0u));
    return r;
  }
  if (!a.full_chain) {
    *unplaced = true;
    return -1;
  }
  int64_t l = 0, r = a.n_fh;  // lower bound in unsigned order
  while (l < r) {
    const int64_t mid = (l + r) >> 1;
    if (__ldg(a.fh_keys + mid) < key) l = mid + 1; else r = mid;
  }
  const int64_t idx = l < a.n_fh - 1 ? l : a.n_fh - 1;
  return __ldg(a.fh_keys + idx) == key ? static_cast<int32_t>(__ldg(a.fh_vals + idx)) : -1;
}

__global__ void capacity_probe_kernel(const Args a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const int k = static_cast<int>(a.k), w = static_cast<int>(a.w), span = k - w;
  const uint64_t m2k = (k >= 32) ? ~0ull : ((1ull << (2 * k)) - 1);
  const uint64_t mw = (1ull << (2 * w)) - 1;
  const uint32_t seed = static_cast<uint32_t>(a.seed);

  const uint64_t x = __ldg(a.fw + i);
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

  // the bucket and its bounds
  bool dead = false, unplaced = false;
  int64_t hc;
  if (a.mwords == nullptr) {
    hc = (mix32(static_cast<uint32_t>(mm) ^ 0x9E3779B9u) ^
          mix32(static_cast<uint32_t>(mm >> 32) + 0xC2B2AE35u)) & a.tmask;
  } else {
    const int64_t h = mphf_value(a, mm, &unplaced);
    dead = h < 0;
    hc = dead ? 0 : h;
  }
  int64_t n_occs = 0, ps = 0;
  if (!dead) {
    ps = __ldg(a.gbase + (hc >> 10)) + __ldg(a.gdelta + hc);
    n_occs = __ldg(a.gbase + ((hc + 1) >> 10)) + __ldg(a.gdelta + hc + 1) - ps;
  }
  const bool skew = a.skew_param >= 0 && n_occs > a.skew_param;

  // the probe: the first candidate that spells the query wins, unvalidated
  const int64_t depth = skew ? 0 : (n_occs < a.bound ? n_occs : a.bound);
  const int width = static_cast<int>(a.width);
  const uint64_t pmask = (1ull << width) - 1;  // width <= 58
  const int64_t last_c = a.last_km > 0 ? a.last_km : 0;
  bool found = false;
  int64_t o_pos = 0;
  uint8_t o_mt = 0;
  for (int64_t j = 0; j < depth && !found; ++j) {
    const int64_t bit = (ps + j) * width;
    const int64_t pwi = bit >> 6;
    const int pr = static_cast<int>(bit & 63);
    uint64_t v = __ldg(a.posw + pwi) >> pr;
    if (pr + width > 64) v |= __ldg(a.posw + pwi + 1) << (64 - pr);
    const int64_t mm_pos = static_cast<int64_t>(v & pmask);
    const int64_t base = mm_pos - span > 0 ? mm_pos - span : 0;
    const int64_t wi = (base * 2) >> 6;
    const int64_t r0 = wi < a.n_w2 - 1 ? wi : a.n_w2 - 1;
    const int64_t r1 = wi + 1 < a.n_w2 - 1 ? wi + 1 : a.n_w2 - 1;
    const uint64_t q0 = __ldg(a.words2 + 2 * r0), q1 = __ldg(a.words2 + 2 * r0 + 1);
    const uint64_t q2 = __ldg(a.words2 + 2 * r1 + 1);
    const int woff = static_cast<int>((base * 2) & 63);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int64_t km_pos = mm_pos - offs[c];
      const bool in_range = mm_pos >= offs[c] && km_pos <= a.last_km;
      const int64_t km_pos_c = km_pos < 0 ? 0 : (km_pos > last_c ? last_c : km_pos);
      const int64_t delta = km_pos_c - base > 0 ? km_pos_c - base : 0;
      const int dbit = woff + 2 * static_cast<int>(delta);
      const int rr = dbit & 63;
      const uint64_t lo = dbit >= 64 ? q1 : q0;
      const uint64_t hi = dbit >= 64 ? q2 : q1;
      const uint64_t kw = ((lo >> rr) | (rr ? hi << (64 - rr) : 0ull)) & m2k;
      const uint8_t m = kw == x ? 1 : (kw == rc ? 2 : 0);
      if (in_range && m) {
        found = true;
        o_pos = km_pos_c;
        o_mt = m;
        break;
      }
    }
  }

  // the winner alone: valid (no boundary in its first k-1 bases) and its
  // unitig's rank, from one wb2 row and the next
  bool failed = false;
  int64_t uid_r = 0;
  if (found) {
    const int64_t p = o_pos;  // in [0, last_km]: in range by construction
    const int64_t bwi = p >> 6;
    const int off = static_cast<int>(p & 63);
    const uint64_t word0 = __ldg(a.wb2 + 2 * bwi);
    const uint64_t word1 = __ldg(a.wb2 + 2 * (bwi + 1 < a.n_wb - 1 ? bwi + 1 : a.n_wb - 1));
    uid_r = static_cast<int64_t>(__ldg(a.wb2 + 2 * bwi + 1)) +
            __popcll(word0 & (off ? ~0ull >> (64 - off) : 0ull));
    const uint64_t win = ((word0 >> off) | (off ? word1 << (64 - off) : 0ull)) &
                         ((1ull << (k - 1)) - 1);
    failed = win != 0;
    found = !failed;
  }

  int64_t o_uid = 0, o_ulen = 0, pos_out = o_pos;
  if (a.uproj != nullptr) {
    int64_t ow = 0, ow2 = 0, oc = 0;
    if (found) {
      const int64_t u = uid_r < a.n_up - 1 ? uid_r : a.n_up - 1;
      const uint64_t* row = a.uproj + 5 * u;
      o_uid = u;
      o_ulen = static_cast<int64_t>(__ldg(row + 1));
      pos_out = o_pos - static_cast<int64_t>(__ldg(row));
      oc = static_cast<int64_t>(__ldg(row + 2));
      ow = static_cast<int64_t>(__ldg(row + 3));
      ow2 = static_cast<int64_t>(__ldg(row + 4));
    }
    a.ow[i] = ow;
    a.ow2[i] = ow2;
    a.cnt[i] = oc & 0xFFFFFFFFll;
    a.ostart[i] = oc >> 32;
  } else if (found) {
    const int64_t u = uid_r < a.n_unitigs - 1 ? uid_r : (a.n_unitigs > 1 ? a.n_unitigs - 1 : 0);
    const int64_t start = __ldg(a.accum2 + 2 * u), end = __ldg(a.accum2 + 2 * u + 1);
    o_uid = u;
    o_ulen = end - start;
    pos_out = o_pos - start;
  }
  a.uid[i] = o_uid;
  a.ulen[i] = o_ulen;
  a.pos[i] = pos_out;
  a.mt[i] = found ? o_mt : 0;
  a.use_skew[i] = skew ? 1 : 0;
  a.unresolved[i] = (!found && !skew && n_occs > a.bound) || failed || unplaced ? 1 : 0;
}

}  // namespace

// Launches on ``stream``, allocates nothing, and returns cudaGetLastError()
// (0 on success); 1000 for an argument the kernel cannot take. ``arg_block``
// points at an Args (untyped here: Args has internal linkage, and so would a
// function that names it).
extern "C" int capacity_probe(const void* arg_block, void* stream) {
  const Args* args = static_cast<const Args*>(arg_block);
  if (args->n <= 0) return 0;
  if (args->mwords != nullptr && (args->n_test < 0 || args->n_test > kMaxLevels)) return 1000;
  constexpr int kThreads = 256;
  const int64_t blocks = (args->n + kThreads - 1) / kThreads;
  capacity_probe_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}
