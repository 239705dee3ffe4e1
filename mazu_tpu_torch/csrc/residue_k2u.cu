// The exact K2U of the ragged phase 2's residue for Hopper (sm_90a): the
// phase-2 slots that the full-depth main probe (K3 at the probe bound, the
// whole MPHF chain) leaves, on a fast32 SSHash with grouped16 bounds,
// packed positions, the paired words2 and wb2 rows, a lean BooPHF32
// minimizer MPHF and a lean BooPHF32 skew MPHF over canonical k-mers.
//
// Replaces no TPU kernel: the reference runs this K2U as plain jnp
// (mazu_tpu/kphf/sshash.py: sshash_k2u, mode "full"). Contract
// (mazu_tpu_torch/ops/residue_k2u.py; its plain version is the residue
// branch of mazu_tpu_torch/index/modindex.py::_ragged_k2u): for each real
// residue slot i < min(*n_c, m_c), lane s = rest[i] of the chunk gets
// sshash_k2u(fw[s], mode="full")'s unitig_id, unitig_len, pos and mt,
// written into the full-depth probe's outputs at s; nothing else is
// written. use_skew[s] is that probe's heavy-bucket flag, which the full
// K2U computes from the same bucket.
//
// What the plain version did: the 64-row probe of every residue slot (all
// rows masked on a heavy bucket), then the skew table for the heavy ones.
// Of a GRCh38-shaped chunk's ~39,300 residue lanes ~38,500 are heavy-bucket
// lanes, which need no row: one skew MPHF lookup, one skew_pos entry, one
// k-mer word and one extent. The rest (~800) are deferred winners that
// failed validation: they need the rows of their bucket, each candidate
// validated in the loop.
//
// Design: one thread a residue slot, kTile slots a block, whole warps past
// the residue exit at once (the count stays on the device: no host sync).
//   heavy bucket (skew lane): the BooPHF32 skew MPHF over the canonical
//     k-mer, its skew_pos entry (clipped into the k-mer range), the k-mer
//     word there from one words2 row, its unitig's rank from one wb2 row
//     and its accum2 extent; a hit needs the MPHF's value, the spelling and
//     the k-mer inside its unitig. Each read only when the one before it
//     can still lead to a hit.
//   any other lane (row-probe lane): the owning thread finds its bucket
//     (the canonical mix32 minimizer, the minimizer MPHF, the grouped16
//     bounds); then the whole warp takes each of its row-probe lanes in
//     turn, 32 rows at a time, a row a thread: the row's packed position,
//     its words2 row (and q2 only where a candidate reaches into it), the
//     forward-offset candidate before the reverse one, each that spells
//     the query validated (no boundary in its first k - 1 bases, from the
//     wb2 row that also ranks it); the lowest row with a valid hit wins (a
//     ballot), and its thread maps it (uproj, or the accum2 extent) and
//     writes the lane. A thread walking 64 dependent rows alone would set
//     the kernel's time.
// Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 5c: a
// 245,760-slot chunk of the GRCh38-shaped genome at 5% of its size, m_c
// 61,440, 23,617 residue lanes, 22,731 of them heavy-bucket): 0.0217 ms,
// the plain residue K2U 16.30 ms; its sector floor 0.0074 ms (34%). In
// the hg-scale-fast32.reads cell ~0.26 ms a batch of 8 chunks.
// All position math is 64-bit: positions pass 2^31 on a unitig set of
// 2^31 bases or more.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kTile = 256;  // residue slots a block, one a thread
constexpr unsigned kFull = 0xFFFFFFFFu;

// Mirrored field by field by _Args in mazu_tpu_torch/ops/residue_k2u.py
// (tests/test_torch_kernel_abi.py holds the two together): every field is
// 8 bytes, so neither side pads.
struct Args {
  const uint64_t* fw;        // [M] the phase-2 slots' k-mer words
  const int64_t* rest;       // [m_c] the residue's slots, in order
  const int64_t* n_c;        // one value on the device: slots below min(n_c, m_c) are real
  const uint8_t* use_skew;   // [M] the full-depth probe's heavy-bucket flags
  const uint16_t* gdelta;    // T + 1 in-group deltas
  const int64_t* gbase;      // one base per 1024 buckets
  const uint64_t* posw;      // packed positions, width bits each
  const uint64_t* words2;    // n_w2 rows (useq word i, word i + 1)
  const uint64_t* wb2;       // n_wb rows (boundary word i, ones before it)
  const uint64_t* uproj;     // n_up rows of 5, or null
  const int64_t* accum2;     // unitig (start, end) rows
  const uint32_t* mwords;    // minimizer MPHF: level words
  const uint32_t* mranks;    // one count per 256-bit block
  const uint64_t* fh_keys;   // sorted final-hash keys
  const uint32_t* fh_vals;
  const uint32_t* swords;    // skew MPHF over canonical k-mers: the same tables
  const uint32_t* sranks;
  const uint64_t* sfh_keys;
  const uint32_t* sfh_vals;
  const uint64_t* spos;      // skew_pos: packed useq positions, s_width bits each
  int64_t* uid;              // [M] outputs, written at the real slots' lanes
  int64_t* ulen;
  int64_t* pos;
  uint8_t* mt;
  int64_t m_c, k, w, seed, bound, width, last_km;
  int64_t n_w2, n_wb, n_up, n_unitigs;
  int64_t n_levels, n_fh, s_levels, s_n_fh, s_width, n_skew;
  int64_t n_bits[kMaxLevels];
  int64_t word_off[kMaxLevels];
  int64_t rank_off[kMaxLevels];
  int64_t s_n_bits[kMaxLevels];
  int64_t s_word_off[kMaxLevels];
  int64_t s_rank_off[kMaxLevels];
};

// One BooPHF32 in the lean layout, its per-level tables in the argument block.
struct Mphf {
  const uint32_t* words;
  const uint32_t* ranks;
  const uint64_t* fh_keys;
  const uint32_t* fh_vals;
  int64_t n_levels, n_fh;
  const int64_t* n_bits;
  const int64_t* word_off;
  const int64_t* rank_off;
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

// The full-chain BooPHF32 value of key: its rank at the first level whose
// bit is set, else the final table's value, else -1 (a definite miss).
__device__ __forceinline__ int64_t mphf_value(const Mphf& f, uint64_t key) {
  const uint32_t lo = static_cast<uint32_t>(key);
  uint32_t s0 = mix32(lo ^ 0x9E3779B9u);
  uint32_t s1 = mix32(static_cast<uint32_t>(key >> 32) ^ 0x85EBCA6Bu) ^ lo;
  for (int li = 0; li < f.n_levels; ++li) {
    uint32_t t = s1 ^ (s1 << 13);
    t ^= t >> 17;
    t ^= s0 ^ (s0 >> 5);
    const uint32_t h = t + s0;
    s0 = s1;
    s1 = t;
    const uint32_t p = h & static_cast<uint32_t>(f.n_bits[li] - 1);
    const uint32_t word = __ldg(f.words + f.word_off[li] + (p >> 5));
    if ((word >> (p & 31)) & 1u) {
      const uint4* blk = reinterpret_cast<const uint4*>(f.words + f.word_off[li] + ((p >> 8) << 3));
      const uint32_t wi = (p >> 5) & 7, off = p & 31;
      int32_t r = static_cast<int32_t>(__ldg(f.ranks + f.rank_off[li] + (p >> 8)));
      if (wi > 0) {
        const uint4 v = __ldg(blk);
        r += __popc(v.x) + (wi > 1 ? __popc(v.y) : 0) + (wi > 2 ? __popc(v.z) : 0) +
             (wi > 3 ? __popc(v.w) : 0);
      }
      if (wi > 4) {
        const uint4 v = __ldg(blk + 1);
        r += __popc(v.x) + (wi > 5 ? __popc(v.y) : 0) + (wi > 6 ? __popc(v.z) : 0);
      }
      return r + __popc(word & (off ? 0xFFFFFFFFu >> (32 - off) : 0u));
    }
  }
  int64_t l = 0, r = f.n_fh;  // lower bound in unsigned order
  while (l < r) {
    const int64_t mid = (l + r) >> 1;
    if (__ldg(f.fh_keys + mid) < key) l = mid + 1; else r = mid;
  }
  const int64_t idx = l < f.n_fh - 1 ? l : f.n_fh - 1;
  return __ldg(f.fh_keys + idx) == key ? static_cast<int32_t>(__ldg(f.fh_vals + idx)) : -1;
}

// The rank of useq position p (< 64 * n_wb): the ones of wb2 before it.
__device__ __forceinline__ int64_t rank_at(const Args& a, int64_t p, ulonglong2* row) {
  *row = __ldg(reinterpret_cast<const ulonglong2*>(a.wb2 + 2 * (p >> 6)));
  const int off = static_cast<int>(p & 63);
  return static_cast<int64_t>(row->y) + __popcll(row->x & (off ? ~0ull >> (64 - off) : 0ull));
}

__device__ __forceinline__ void put(const Args& a, int64_t s, int64_t uid, int64_t ulen,
                                    int64_t pos, uint8_t mt) {
  a.uid[s] = uid;
  a.ulen[s] = ulen;
  a.pos[s] = pos;
  a.mt[s] = mt;
}

// A heavy-bucket lane through the skew MPHF (sshash.py: skew_resolve).
__device__ __forceinline__ void skew_lane(const Args& a, int64_t s, uint64_t x, uint64_t rc,
                                          uint64_t canon, uint64_t m2k) {
  const Mphf f{a.swords, a.sranks, a.sfh_keys, a.sfh_vals, a.s_levels, a.s_n_fh,
               a.s_n_bits, a.s_word_off, a.s_rank_off};
  const int64_t h2 = mphf_value(f, canon);
  if (h2 < 0) {
    put(a, s, 0, 0, 0, 0);
    return;
  }
  const int64_t idx = h2 < a.n_skew - 1 ? h2 : (a.n_skew > 1 ? a.n_skew - 1 : 0);
  const int64_t bit = idx * a.s_width;
  const int sw = static_cast<int>(a.s_width), sr = static_cast<int>(bit & 63);
  uint64_t v = __ldg(a.spos + (bit >> 6)) >> sr;
  if (sr + sw > 64) v |= __ldg(a.spos + (bit >> 6) + 1) << (64 - sr);
  int64_t sp = static_cast<int64_t>(v & ((1ull << sw) - 1));
  const int64_t last_c = a.last_km > 0 ? a.last_km : 0;
  sp = sp < 0 ? 0 : (sp > last_c ? last_c : sp);
  const int64_t kb = sp * 2;
  const int ko = static_cast<int>(kb & 63);
  const ulonglong2 q = __ldg(reinterpret_cast<const ulonglong2*>(a.words2 + 2 * (kb >> 6)));
  const uint64_t kw = ((q.x >> ko) | (ko ? q.y << (64 - ko) : 0ull)) & m2k;
  const uint8_t m = kw == x ? 1 : (kw == rc ? 2 : 0);
  if (!m) {
    put(a, s, 0, 0, 0, 0);
    return;
  }
  ulonglong2 row;
  int64_t u = rank_at(a, sp, &row);
  u = u < a.n_unitigs - 1 ? u : (a.n_unitigs > 1 ? a.n_unitigs - 1 : 0);
  const int64_t start = __ldg(a.accum2 + 2 * u), end = __ldg(a.accum2 + 2 * u + 1);
  if (sp + a.k <= end) {
    put(a, s, u, end - start, sp - start, m);
  } else {
    put(a, s, 0, 0, 0, 0);
  }
}

// Row ps + j of a row-probe lane: whether it holds a valid candidate
// spelling the query (forward offset first), and that candidate's position,
// match and unitig rank.
__device__ __forceinline__ bool row_hit(const Args& a, uint64_t x, uint64_t rc, int64_t row_i,
                                        int64_t off0, int64_t off1, uint64_t m2k, int64_t* o_pos,
                                        uint8_t* o_mt, int64_t* o_rank) {
  const int k = static_cast<int>(a.k), span = k - static_cast<int>(a.w);
  const int width = static_cast<int>(a.width);
  const int64_t bit = row_i * width;
  const int64_t pwi = bit >> 6;
  const int pr = static_cast<int>(bit & 63);
  uint64_t v = __ldg(a.posw + pwi) >> pr;
  if (pr + width > 64) v |= __ldg(a.posw + pwi + 1) << (64 - pr);
  const int64_t mm_pos = static_cast<int64_t>(v & ((1ull << width) - 1));  // width <= 58
  const int64_t base = mm_pos - span > 0 ? mm_pos - span : 0;
  const int64_t wi = (base * 2) >> 6;
  const int64_t r0 = wi < a.n_w2 - 1 ? wi : a.n_w2 - 1;
  const int64_t r1 = wi + 1 < a.n_w2 - 1 ? wi + 1 : a.n_w2 - 1;
  const int woff = static_cast<int>((base * 2) & 63);
  const int64_t last_c = a.last_km > 0 ? a.last_km : 0;
  const int64_t offs[2] = {off0, off1};
  const ulonglong2 q01 = __ldg(reinterpret_cast<const ulonglong2*>(a.words2 + 2 * r0));
  bool need_q2 = false;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int64_t km_pos = mm_pos - offs[c];
    const int64_t km_pos_c = km_pos < 0 ? 0 : (km_pos > last_c ? last_c : km_pos);
    const int64_t delta = km_pos_c - base > 0 ? km_pos_c - base : 0;
    const int dbit = woff + 2 * static_cast<int>(delta);
    const int rr = dbit & 63;
    need_q2 |= mm_pos >= offs[c] && km_pos <= a.last_km && dbit >= 64 && rr > 0 &&
               rr >= 65 - 2 * k;
  }
  const uint64_t q2 = need_q2 ? __ldg(a.words2 + 2 * r1 + 1) : 0;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int64_t km_pos = mm_pos - offs[c];
    if (!(mm_pos >= offs[c] && km_pos <= a.last_km)) continue;
    const int64_t km_pos_c = km_pos < 0 ? 0 : (km_pos > last_c ? last_c : km_pos);
    const int64_t delta = km_pos_c - base > 0 ? km_pos_c - base : 0;
    const int dbit = woff + 2 * static_cast<int>(delta);
    const int rr = dbit & 63;
    const uint64_t lo = dbit >= 64 ? q01.y : q01.x;
    const uint64_t hi = dbit >= 64 ? q2 : q01.y;
    const uint64_t kw = ((lo >> rr) | (rr ? hi << (64 - rr) : 0ull)) & m2k;
    const uint8_t m = kw == x ? 1 : (kw == rc ? 2 : 0);
    if (!m) continue;
    // valid: no unitig boundary among its first k - 1 bases
    const int64_t p = km_pos_c;
    const int off = static_cast<int>(p & 63);
    ulonglong2 row;
    const int64_t rank = rank_at(a, p, &row);
    const uint64_t word1 =
        off >= 66 - k ? __ldg(a.wb2 + 2 * ((p >> 6) + 1 < a.n_wb - 1 ? (p >> 6) + 1 : a.n_wb - 1))
                      : 0;
    const uint64_t win = ((row.x >> off) | (off ? word1 << (64 - off) : 0ull)) &
                         ((1ull << (k - 1)) - 1);
    if (win == 0) {
      *o_pos = p;
      *o_mt = m;
      *o_rank = rank;
      return true;
    }
  }
  return false;
}

// The winner of a row-probe lane mapped to its unitig, as the plain full
// K2U maps it (uproj, else the rank's accum2 extent).
__device__ __forceinline__ void put_winner(const Args& a, int64_t s, int64_t p, uint8_t m,
                                           int64_t rank) {
  if (a.uproj != nullptr) {
    const int64_t u = rank < a.n_up - 1 ? rank : a.n_up - 1;
    const uint64_t* row = a.uproj + 5 * u;
    put(a, s, u, static_cast<int64_t>(__ldg(row + 1)), p - static_cast<int64_t>(__ldg(row)), m);
  } else {
    const int64_t u = rank < a.n_unitigs - 1 ? rank : (a.n_unitigs > 1 ? a.n_unitigs - 1 : 0);
    const int64_t start = __ldg(a.accum2 + 2 * u), end = __ldg(a.accum2 + 2 * u + 1);
    put(a, s, u, end - start, p - start, m);
  }
}

__global__ void __launch_bounds__(kTile) residue_k2u_kernel(const __grid_constant__ Args a) {
  const int lane = threadIdx.x & 31;
  const int64_t slot = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  const int64_t nc = *a.n_c;
  const int64_t n_real = nc < a.m_c ? nc : a.m_c;
  if (slot - lane >= n_real) return;  // the whole warp is past the residue
  const bool live = slot < n_real;
  const int k = static_cast<int>(a.k), w = static_cast<int>(a.w), span = k - w;
  const uint64_t m2k = (k >= 32) ? ~0ull : ((1ull << (2 * k)) - 1);

  int64_t s = 0;
  uint64_t x = 0;
  bool skew = false;
  if (live) {
    s = __ldg(a.rest + slot);
    x = __ldg(a.fw + s);
    skew = __ldg(a.use_skew + s) != 0;
  }
  const uint64_t rc = reverse_groups(~x) >> (64 - 2 * k);
  const bool is_fw = x <= rc;
  const uint64_t canon = is_fw ? x : rc;
  if (skew) skew_lane(a, s, x, rc, canon, m2k);

  // a row-probe lane's bucket: minimizer, minimizer MPHF, grouped16 bounds
  const bool probe = live && !skew;
  int64_t ps = 0, depth = 0, off0 = 0;
  if (probe) {
    const uint64_t mw = (1ull << (2 * w)) - 1;
    const uint32_t seed = static_cast<uint32_t>(a.seed);
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
    off0 = is_fw ? best_j : span - best_j;
    const Mphf f{a.mwords, a.mranks, a.fh_keys, a.fh_vals, a.n_levels, a.n_fh,
                 a.n_bits, a.word_off, a.rank_off};
    const int64_t hc = mphf_value(f, mm);
    if (hc >= 0) {
      uint32_t d0, d1;
      if (hc & 1) {
        d0 = __ldg(a.gdelta + hc);
        d1 = __ldg(a.gdelta + hc + 1);
      } else {
        const uint32_t v = __ldg(reinterpret_cast<const uint32_t*>(a.gdelta + hc));
        d0 = v & 0xFFFFu;
        d1 = v >> 16;
      }
      ps = __ldg(a.gbase + (hc >> 10)) + d0;
      const int64_t n_occs = __ldg(a.gbase + ((hc + 1) >> 10)) + d1 - ps;
      depth = n_occs < a.bound ? n_occs : a.bound;
    }
  }

  // the warp probes each row-probe lane's rows, 32 at a time
  unsigned todo = __ballot_sync(kFull, probe);
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const int64_t qs = __shfl_sync(kFull, s, src);
    const uint64_t qx = __shfl_sync(kFull, x, src);
    const uint64_t qrc = __shfl_sync(kFull, rc, src);
    const int64_t qps = __shfl_sync(kFull, ps, src);
    const int64_t qdepth = __shfl_sync(kFull, depth, src);
    const int64_t qoff0 = __shfl_sync(kFull, off0, src);
    bool done = false;
    for (int64_t j0 = 0; j0 < qdepth && !done; j0 += 32) {
      int64_t hp = 0, hr = 0;
      uint8_t hm = 0;
      const bool hit = j0 + lane < qdepth &&
                       row_hit(a, qx, qrc, qps + j0 + lane, qoff0, span - qoff0, m2k, &hp, &hm,
                               &hr);
      const unsigned won = __ballot_sync(kFull, hit);
      if (won) {
        done = true;
        if (lane == __ffs(won) - 1) put_winner(a, qs, hp, hm, hr);
      }
    }
    if (!done && lane == src) put(a, qs, 0, 0, 0, 0);
  }
}

}  // namespace

// Launches on ``stream``, allocates nothing, and returns cudaGetLastError()
// (0 on success); 1000 for an argument the kernel cannot take. ``arg_block``
// points at an Args (untyped here: Args has internal linkage). words2, wb2
// and the MPHF words are read in 16-byte pieces and must be 16-byte
// aligned, gdelta 4-byte aligned.
extern "C" int residue_k2u(const void* arg_block, void* stream) {
  const Args* args = static_cast<const Args*>(arg_block);
  if (args->m_c <= 0) return 0;
  if (args->n_levels < 0 || args->n_levels > kMaxLevels || args->s_levels < 0 ||
      args->s_levels > kMaxLevels || args->n_fh < 1 || args->s_n_fh < 1)
    return 1000;
  const unsigned blocks = static_cast<unsigned>((args->m_c + kTile - 1) / kTile);
  residue_k2u_kernel<<<blocks, kTile, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}
