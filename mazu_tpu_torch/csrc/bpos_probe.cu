// SSHash direct-engine capacity probe for Hopper (sm_90a): one bpos bucket
// row, then up to plim useqrec window records per query.
//
// Replaces mazu_tpu/ops/pallas_capacity.py::_kernel_bpos (launched by
// _pallas_bpos_probe, wrapped by pallas_bpos_usrec_k2u). Contract:
// bit-identical to sshash_k2u(d, fw, mode="main", probe_limit=plim) on the
// direct + bpos + useqrec layout (mazu_tpu_torch/kphf/sshash.py), the
// kernel's plain torch version.
//
// What bounds it on this card: two dependent random reads per query, the
// 16-byte bpos row and then the 56-byte record rows it points at, from
// tables far larger than the 50 MB L2 (about 1 GB of bpos and 0.5 GB of
// records at 300 Mbp). So DRAM latency sets the pace, not arithmetic.
//
// Design: one thread per query, with the key prep fused in. A thread reads
// its 8-byte forward word, computes the reverse complement, the canonical
// word, the 17-window mix32 minimizer and its offset, and the bucket
// fold_hash32(mm) & (T-1); reads the bpos row as one 16-byte vector load;
// then, unless the bucket is a skew bucket, reads one record (seven 8-byte
// loads: records are 8-byte aligned) for each of the first min(plim,
// count) positions, and verifies both candidate k-mers in it. Nothing but
// the key, the rows and the outputs moves through device memory, and a
// thread reads no row it cannot use. The grid covers the batch; the last
// block masks its ragged edge. More rows in flight per thread is later
// work.

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

struct Params {
  const uint64_t* fw;
  const uint4* bpos;      // T rows of (pos0, pos1, pos2, count), u32
  const uint64_t* rec;    // n_rec rows of 7 u64
  int64_t n_rec;
  uint32_t tmask;         // T - 1
  int k, w, plim;
  uint32_t seed;
  int64_t skew_param;     // < 0: no skew table
  int64_t last_km;        // total_len - k
  int64_t n;
  int64_t* uid;
  int64_t* ulen;
  int64_t* pos;
  uint8_t* mt;
  uint8_t* use_skew;
  uint8_t* unresolved;
  int64_t* ow;
  int64_t* ow2;
  int64_t* cnt;
};

__global__ void bpos_probe_kernel(const Params p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const int k = p.k, w = p.w, span = k - w;
  const uint64_t m2k = (k >= 32) ? ~0ull : ((1ull << (2 * k)) - 1);
  const uint64_t mw = (1ull << (2 * w)) - 1;

  const uint64_t x = __ldg(p.fw + i);
  const uint64_t rc = reverse_groups(~x) >> (64 - 2 * k);
  const bool is_fw = x <= rc;
  const uint64_t canon = is_fw ? x : rc;

  // minimizer: smallest mix32 score of a window's low 32 bits, leftmost
  // window on ties (strict <)
  uint64_t mm = canon & mw;
  uint32_t best = mix32(static_cast<uint32_t>(mm) ^ p.seed);
  int best_j = 0;
  for (int j = 1; j <= span; ++j) {
    const uint64_t mv = (canon >> (2 * j)) & mw;
    const uint32_t sc = mix32(static_cast<uint32_t>(mv) ^ p.seed);
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
       mix32(static_cast<uint32_t>(mm >> 32) + 0xC2B2AE35u)) & p.tmask;

  const uint4 row = __ldg(p.bpos + h);
  const uint32_t bp[3] = {row.x, row.y, row.z};
  const int64_t n_occs = row.w;
  const bool skew = p.skew_param >= 0 && n_occs > p.skew_param;

  bool found = false, sentinel = false;
  int64_t o_uid = 0, o_ulen = 0, o_pos = 0, o_cnt = 0;
  uint64_t o_ow = 0, o_ow2 = 0;
  uint8_t o_mt = 0;
  const int depth = skew ? 0 : static_cast<int>(n_occs < p.plim ? n_occs : p.plim);
  const int64_t last_c = p.last_km > 0 ? p.last_km : 0;
  for (int j = 0; j < depth && !found; ++j) {
    const int64_t mm_pos = bp[j];
    const int64_t base = mm_pos - span > 0 ? mm_pos - span : 0;
    int64_t wi = (base * 2) >> 6;
    wi = wi < p.n_rec - 1 ? wi : p.n_rec - 1;
    const uint64_t* r = p.rec + wi * 7;
    uint64_t q[7];
#pragma unroll
    for (int t = 0; t < 7; ++t) q[t] = __ldg(r + t);
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
  p.unresolved[i] = (!found && !skew && n_occs > p.plim) || (!found && sentinel) ? 1 : 0;
  p.ow[i] = static_cast<int64_t>(o_ow);
  p.ow2[i] = static_cast<int64_t>(o_ow2);
  p.cnt[i] = o_cnt;
}

}  // namespace

// Launches on ``stream``, allocates nothing, and returns cudaGetLastError()
// (0 on success). ``bpos`` holds tmask + 1 rows of 4 u32 (16-byte aligned);
// ``rec`` holds n_rec rows of 7 u64. Outputs: uid, ulen, pos, cnt (int64),
// mt, use_skew, unresolved (uint8), ow, ow2 (u64 bit patterns).
extern "C" int bpos_probe(const void* fw, const void* bpos, const void* rec,
                          int64_t n_rec, uint32_t tmask, int k, int w,
                          uint32_t seed, int64_t skew_param, int plim,
                          int64_t last_km, int64_t n, void* uid, void* ulen,
                          void* pos, void* mt, void* use_skew,
                          void* unresolved, void* ow, void* ow2, void* cnt,
                          void* stream) {
  if (n <= 0) return 0;
  Params p;
  p.fw = static_cast<const uint64_t*>(fw);
  p.bpos = static_cast<const uint4*>(bpos);
  p.rec = static_cast<const uint64_t*>(rec);
  p.n_rec = n_rec;
  p.tmask = tmask;
  p.k = k;
  p.w = w;
  p.plim = plim;
  p.seed = seed;
  p.skew_param = skew_param;
  p.last_km = last_km;
  p.n = n;
  p.uid = static_cast<int64_t*>(uid);
  p.ulen = static_cast<int64_t*>(ulen);
  p.pos = static_cast<int64_t*>(pos);
  p.mt = static_cast<uint8_t*>(mt);
  p.use_skew = static_cast<uint8_t*>(use_skew);
  p.unresolved = static_cast<uint8_t*>(unresolved);
  p.ow = static_cast<int64_t*>(ow);
  p.ow2 = static_cast<int64_t*>(ow2);
  p.cnt = static_cast<int64_t*>(cnt);
  constexpr int kThreads = 256;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  bpos_probe_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
