// Phase 2 of the two-phase query on a mono2-occ32 KCDict, for Hopper
// (sm_90a): the exact K2U and the padded occurrence projection of the
// lanes the main phase left to it.
//
// Replaces no TPU kernel: the reference runs this phase as plain jnp
// (mazu_tpu/index/modindex.py::get_ref_pos_compact, its compacted
// get_ref_pos_padded). Contract: for every real slot s < min(n_ovf, m) of
// the compacted lanes, every field is bit-identical to
// get_ref_pos_padded(d, fw[lanes], max_occs) at slot s
// (mazu_tpu_torch/index/modindex.py), padding columns included: a column
// past a unitig's count holds what the plain version's clipped pair-row
// fetch decodes there. Slots at or past n_ovf are neither computed nor
// written (every consumer masks them by slot_real).
//
// What bounds it on this card: the padded outputs. A real slot writes 57
// bytes of K2U fields and max_occs x 21 bytes of ref_id, ref_pos, orient
// and valid (378 bytes at the transcript index's 18 columns), against ~135
// bytes of reads: its lane index and forward word, one 64-byte bucket row,
// the two offsets and the occurrence words. The table is far larger than
// the 50 MB L2, so the row is a random read from device memory (two
// sectors, as in K1: csrc/mono2_probe.cu); the forward words, the offsets
// and the pair rows of a transcript index fit in L2. So the floor is the
// output stream at the card's write rate plus the row reads at its
// random-sector rate: on the .kmers chunk of the transcript index (2^20
// slots, 612,505 real, 4.35 occurrences a real slot, max_occs 18) the
// bytes bound 0.1058 ms and that floor 0.1233 ms, against this kernel's
// 0.1534 ms (68.9% and 80.4%; PERF.md section 6).
//
// Design:
// - Fake slots cost nothing: the kernel reads n_ovf from device memory (no
//   host sync, safe inside a CUDA graph), and a block whose slots all lie
//   at or past it exits before any other read.
// - Lane stage, one thread a slot: gather fw[lanes[s]], the reverse
//   complement, the canonical word and fold_hash32 in registers (K1's key
//   prep), read the main bucket's 64-byte row and compare its two slots;
//   only where both miss, probe the side table's two buckets (56-byte rows
//   of the reference's layout, read as seven 8-byte words). It writes the
//   eight per-slot fields, reads offsets[uid] and offsets[uid + 1], and
//   leaves the slot's occurrence start and count, offset, unitig length and
//   orientation match in shared memory. Re-probing the row costs its two
//   sectors; gathering K1's eight outputs back at random lanes would cost
//   about eight.
// - Cell stage: the block's threads sweep its [slots x max_occs] output
//   cells in row-major order, so every store is coalesced and no thread
//   holds a unitig's occurrence list (max_occs is the index's maximum:
//   18 here, hundreds on a genome with repeats). Each cell reads its
//   occurrence word from the unitig's pair rows (ctable2, 16 bytes a row:
//   word i and word i + 1), decodes it (piscem or pf1) and writes its four
//   fields. Consecutive cells of a slot read consecutive words.
// - In a marked pass the block counts its slots sent on to the side table
//   (__syncthreads_count, which is also the barrier between the stages)
//   and adds them to a device counter with one atomic.
//
// Against other designs (that chunk, in turns in one run on an NVIDIA
// H100 80GB HBM3 at 700 W; PERF.md section 6): this design 0.1526 ms;
// 128-slot tiles 0.1517; 512-slot tiles 0.1544; streaming stores of the
// cells 0.1506 (kept plain: the checksum reads the cells right after);
// occurrence words read only below the count 0.1521 (not the contract,
// whose padding columns hold the clipped fetch's words: the pair rows of
// a transcript index lie in L2, so exactness costs ~0.3%). The plain torch
// phase 2 on the same slots took 11.84 ms.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;         // slots per block; one thread a slot in the lane stage
constexpr int kSlotWords = 7;      // u32 words of a slot; a row holds 2 slots
constexpr int kRowWords = 16;      // u32 words of a main-table row on the card
constexpr int kSideRowWords = 14;  // u32 words of a side-table row (the reference's)
constexpr int kMaxOccsLimit = 1048576;  // 2^20, the largest max_occs: a tile's cells stay in u32

// Mirrored field by field by _Args in mazu_tpu_torch/ops/mono2_phase2.py
// (tests/test_torch_kernel_abi.py holds the two together): every field is
// 8 bytes, so neither side pads.
struct Args {
  const uint64_t* fw;       // forward k-mer words of the chunk
  const int64_t* lanes;     // [m] the lane of each slot
  const int64_t* n_ovf;     // one value on the device: slots below min(n_ovf, m) are real
  const uint4* table;       // main table: T rows of kRowWords u32, 64-byte aligned
  const uint2* side;        // side table: side_T rows of kSideRowWords u32, or null
  const int64_t* offsets;   // [n_unitigs + 1] occurrence bounds
  const uint2* ctable2;     // [n_occs] pair rows of 4 u32: word i, word i + 1
  int64_t* uid;             // [m] outputs of the K2U
  int64_t* ulen;
  int64_t* pos;
  int64_t* cnt;
  uint8_t* mt;
  int64_t* ow;
  int64_t* ow2;
  int64_t* n_occs;          // [m] the offsets' count
  int64_t* ref_id;          // [m, max_occs] the projection
  int64_t* ref_pos;
  int32_t* orient;
  uint8_t* valid;
  int64_t* side_probes;     // a device counter, or null
  int64_t m, max_occs, tmask, side_tmask, side_salt, k, occ_last, pf1, ref_shift, pos_mask;
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

// A slot's K2U fields: the first slot matching the key, over the probes in
// order.
struct Found {
  bool hit;
  uint8_t mt;
  uint32_t uid, pos, len, cnt, ow, ow2;
};

// Compare the two slots of one bucket row ``w`` (held in registers by the
// caller) with the key.
__device__ __forceinline__ void match_row(const uint32_t* w, uint32_t clo, uint32_t chi,
                                          bool is_fw_canon, Found& f) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const uint32_t* c = w + s * kSlotWords;
    const uint32_t khi = c[1];
    if (!f.hit && c[0] == clo && (khi & 0x7FFFFFFFu) == chi) {
      f.hit = true;
      f.mt = (is_fw_canon == ((khi >> 31) != 0)) ? 1 : 2;
      f.uid = c[2];
      f.pos = c[3] & 0xFFFFFFu;
      f.len = (c[3] >> 24) | ((c[4] & 0xFFFFu) << 8);
      f.cnt = c[4] >> 16;
      f.ow = c[5];
      f.ow2 = c[6];
    }
  }
}

__device__ __forceinline__ void probe_side(const uint2* side, uint32_t row, uint32_t clo,
                                           uint32_t chi, bool is_fw_canon, Found& f) {
  const uint2* p = side + static_cast<size_t>(row) * (kSideRowWords / 2);
  uint32_t w[kSideRowWords];
#pragma unroll
  for (int j = 0; j < kSideRowWords / 2; ++j) {
    const uint2 v = __ldg(p + j);
    w[2 * j] = v.x;
    w[2 * j + 1] = v.y;
  }
  match_row(w, clo, chi, is_fw_canon, f);
}

__global__ void __launch_bounds__(kTile) mono2_phase2_kernel(const Args a) {
  __shared__ int64_t s_start[kTile];
  __shared__ int64_t s_cnt[kTile];
  __shared__ int32_t s_kpos[kTile];
  __shared__ int32_t s_ulen[kTile];
  __shared__ int32_t s_omatch[kTile];

  const int64_t n_ovf = *a.n_ovf;
  const int64_t n_real = n_ovf < a.m ? n_ovf : a.m;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * kTile;
  if (lo >= n_real) return;  // the whole block is fake slots
  const int rows = static_cast<int>(n_real - lo < kTile ? n_real - lo : kTile);
  const int t = threadIdx.x;

  // lane stage
  bool to_side = false;
  if (t < rows) {
    const int64_t s = lo + t;
    const int64_t lane = __ldg(reinterpret_cast<const long long*>(a.lanes) + s);
    const uint64_t x = __ldg(reinterpret_cast<const unsigned long long*>(a.fw) + lane);
    const uint64_t rc = reverse_groups(~x) >> (64 - 2 * a.k);
    const uint64_t canon = x < rc ? x : rc;
    const bool is_fw_canon = x == canon;
    const uint32_t clo = static_cast<uint32_t>(canon);
    const uint32_t chi = static_cast<uint32_t>(canon >> 32);
    const uint32_t h = mix32(clo ^ 0x9E3779B9u) ^ mix32(chi + 0xC2B2AE35u);

    Found f = {false, 0, 0, 0, 0, 0, 0, 0};
    {
      const uint4* row = a.table + static_cast<size_t>(h & static_cast<uint32_t>(a.tmask)) *
                                       (kRowWords / 4);
      uint32_t w[kRowWords];
#pragma unroll
      for (int j = 0; j < kRowWords / 4; ++j) {
        const uint4 v = __ldg(row + j);
        w[4 * j] = v.x;
        w[4 * j + 1] = v.y;
        w[4 * j + 2] = v.z;
        w[4 * j + 3] = v.w;
      }
      match_row(w, clo, chi, is_fw_canon, f);
    }
    if (!f.hit && a.side != nullptr) {
      to_side = true;
      const uint32_t smask = static_cast<uint32_t>(a.side_tmask);
      const uint32_t salt = static_cast<uint32_t>(a.side_salt);
      probe_side(a.side, h & smask, clo, chi, is_fw_canon, f);
      const uint32_t h2 = mix32(clo + (0x85EBCA6Bu ^ salt)) ^ mix32(chi ^ (0x9E3779B9u + salt));
      probe_side(a.side, h2 & smask, clo, chi, is_fw_canon, f);
    }

    const int64_t u = f.hit ? static_cast<int64_t>(f.uid) : 0;
    const long long* offsets = reinterpret_cast<const long long*>(a.offsets);
    const int64_t start = __ldg(offsets + u);
    const int64_t count = f.hit ? __ldg(offsets + u + 1) - start : 0;
    a.uid[s] = f.uid;
    a.ulen[s] = f.len;
    a.pos[s] = f.pos;
    a.cnt[s] = f.cnt;
    a.mt[s] = f.mt;
    a.ow[s] = f.ow;
    a.ow2[s] = f.ow2;
    a.n_occs[s] = count;
    s_start[t] = start;
    s_cnt[t] = count;
    s_kpos[t] = static_cast<int32_t>(f.pos);
    s_ulen[t] = static_cast<int32_t>(f.len);
    s_omatch[t] = f.mt == 1;
  }
  const int n_side = __syncthreads_count(to_side);
  if (a.side_probes != nullptr && t == 0 && n_side)
    atomicAdd(reinterpret_cast<unsigned long long*>(a.side_probes),
              static_cast<unsigned long long>(n_side));

  // cell stage: cell c of the tile is column j of slot sl, c = sl * max_occs + j
  const uint32_t mo = static_cast<uint32_t>(a.max_occs);
  const uint32_t cells = static_cast<uint32_t>(rows) * mo;
  const uint32_t step_sl = kTile / mo, step_j = kTile % mo;
  uint32_t sl = t / mo, j = t % mo;
  const int64_t base = lo * a.max_occs;
  for (uint32_t c = t; c < cells; c += kTile) {
    const int64_t start = s_start[sl];
    int64_t p = start + static_cast<int64_t>(j & ~1u);
    p = p < a.occ_last ? p : a.occ_last;
    const uint2 v = __ldg(a.ctable2 + 2 * p + (j & 1u));
    const uint64_t word = (static_cast<uint64_t>(v.y) << 32) | v.x;
    int64_t rid, opos;
    int32_t o;
    if (a.pf1) {
      rid = static_cast<int64_t>(word & 0xFFFFFFFFull);
      opos = static_cast<int64_t>((word >> 32) & 0x7FFFFFFFull);
      o = static_cast<int32_t>(word >> 63);
    } else {
      rid = static_cast<int64_t>(word >> a.ref_shift);
      opos = static_cast<int64_t>((word >> 1) & static_cast<uint64_t>(a.pos_mask));
      o = static_cast<int32_t>(word & 1u);
    }
    const int64_t kpos = s_kpos[sl];
    const int32_t om = s_omatch[sl];
    const int64_t e = base + c;
    a.ref_id[e] = rid;
    a.ref_pos[e] = o == 1 ? kpos + opos : opos + (s_ulen[sl] - kpos) - a.k;
    a.orient[e] = o == 1 ? om : 1 - om;
    a.valid[e] = static_cast<int64_t>(j) < s_cnt[sl];
    sl += step_sl;
    j += step_j;
    if (j >= mo) {
      j -= mo;
      ++sl;
    }
  }
}

}  // namespace

// Launches on ``stream``, allocates nothing, and returns cudaGetLastError()
// (0 on success).
extern "C" int mono2_phase2(const void* arg_block, void* stream) {
  const Args* a = static_cast<const Args*>(arg_block);
  if (a->m <= 0) return 0;
  if (a->max_occs < 1 || a->max_occs > kMaxOccsLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (a->m + kTile - 1) / kTile;
  mono2_phase2_kernel<<<static_cast<unsigned>(blocks), kTile, 0,
                        static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
