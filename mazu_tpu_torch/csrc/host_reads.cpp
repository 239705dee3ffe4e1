// Host-side read ingestion for the port: the fused FASTQ parse and pack,
// and the batched k-merization of many reads. Host code, not kernels: it
// builds with the system C++ compiler (ops/cuda_build.compile_host_library)
// and io/native.py binds its entries with ctypes.
//
//   c++ -O3 -fPIC -shared -pthread -std=c++17 -o libhost_reads.so host_reads.cpp
//
// kmerize_batch runs its reads on std::threads, not OpenMP: a C++ compiler
// may come without libgomp, the OpenMP runtime, and the build would fail.
//
// The contracts are those of mazu_tpu's native host library:
// fastq_count/fastq_fill give io/reads.pack_reads' layout (2-bit codes,
// first base in the low bits of a u64, each read at a stride of bases; a
// one-bit-a-base mask of non-ACGT bases; int32 lengths), and kmerize_batch
// gives each read's all-ACGT k-mer windows, a non-ACGT base restarting the
// window, as index/validate.valid_kmer_windows does.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ASCII -> 2-bit code, 255 for anything but ACGT/acgt.
struct CodeTable {
    uint8_t lut[256];
    CodeTable() {
        memset(lut, 255, sizeof lut);
        lut['A'] = lut['a'] = 0;
        lut['C'] = lut['c'] = 1;
        lut['G'] = lut['g'] = 2;
        lut['T'] = lut['t'] = 3;
    }
};
const CodeTable kCodes;

// End of the line starting at i (exclusive; the '\n' is not part of it).
inline int64_t line_end(const char* buf, int64_t n, int64_t i) {
    const char* p = static_cast<const char*>(memchr(buf + i, '\n', static_cast<size_t>(n - i)));
    return p ? static_cast<int64_t>(p - buf) : n;
}

// Start of the line after the one that ends at e.
inline int64_t skip_nl(int64_t n, int64_t e) { return e < n ? e + 1 : n; }

// All windows of k valid bases of one read's codes: (position, k-mer word)
// written from pos_out/word_out[0]; returns how many.
int64_t kmerize(const uint8_t* codes, int64_t n, int k, int64_t* pos_out, uint64_t* word_out) {
    if (n < k) return 0;
    const uint64_t mask = (k >= 32) ? ~0ull : ((1ull << (2 * k)) - 1);
    int64_t out = 0;
    uint64_t word = 0;
    int run = 0;  // valid bases ending at i
    for (int64_t i = 0; i < n; i++) {
        const uint8_t c = codes[i];
        if (c > 3) {
            run = 0;
            word = 0;
            continue;
        }
        word = ((word >> 2) | (static_cast<uint64_t>(c) << (2 * (k - 1)))) & mask;
        if (++run >= k) {
            pos_out[out] = i - k + 1;
            word_out[out] = word;
            out++;
        }
    }
    return out;
}

}  // namespace

// Pass 1 of the fused parse and pack: the number of records, and the
// longest sequence in *out_maxlen. Lines end at '\n', sequence and quality
// may span lines, blank lines between records are skipped: the framing of
// io/fastq.read_fastq. Returns -1 on anything else (a header without '@',
// no '+' line, an empty sequence, a quality block of another length) and
// on any '\r': the Python reader reads text with universal newlines, so a
// '\r' ends its line there, and the caller takes that reader, which also
// raises the errors. (mazu_tpu's pass reads a '\r' as a base.)
extern "C" int64_t fastq_count(const char* buf, int64_t n, int64_t* out_maxlen) {
    if (memchr(buf, '\r', static_cast<size_t>(n))) return -1;
    int64_t i = 0, records = 0, maxlen = 0;
    while (i < n) {
        int64_t e = line_end(buf, n, i);
        if (e == i) {  // blank line
            i = skip_nl(n, e);
            continue;
        }
        if (buf[i] != '@') return -1;
        i = skip_nl(n, e);
        int64_t slen = 0;
        bool plus = false;
        while (i < n) {
            e = line_end(buf, n, i);
            if (e > i && buf[i] == '+') {
                plus = true;
                i = skip_nl(n, e);
                break;
            }
            slen += e - i;
            i = skip_nl(n, e);
        }
        if (!plus || slen == 0) return -1;
        int64_t qlen = 0;
        while (i < n && qlen < slen) {
            e = line_end(buf, n, i);
            qlen += e - i;
            i = skip_nl(n, e);
        }
        if (qlen != slen) return -1;
        if (slen > maxlen) maxlen = slen;
        records++;
    }
    *out_maxlen = maxlen;
    return records;
}

// Pass 2: write the records' bases straight into pack_reads' layout. words
// (R * stride / 32 + 1) and badw (R * stride / 64 + 1) must be zeroed;
// stride is a multiple of 32 at least the longest sequence. Returns 1 when
// some base is not ACGT, 0 when none is, -1 when the text does not frame
// as pass 1 counted it.
extern "C" int64_t fastq_fill(const char* buf, int64_t n, int64_t records, int64_t stride,
                              uint64_t* words, uint64_t* badw, int32_t* lengths) {
    int64_t i = 0, r = 0, has_bad = 0;
    while (i < n) {
        int64_t e = line_end(buf, n, i);
        if (e == i) {
            i = skip_nl(n, e);
            continue;
        }
        if (buf[i] != '@' || r >= records) return -1;
        i = skip_nl(n, e);
        int64_t slen = 0;
        bool plus = false;
        const int64_t base = r * stride;
        while (i < n) {
            e = line_end(buf, n, i);
            if (e > i && buf[i] == '+') {
                plus = true;
                i = skip_nl(n, e);
                break;
            }
            if (slen + (e - i) > stride) return -1;
            for (int64_t j = i; j < e; j++) {
                uint8_t c = kCodes.lut[static_cast<uint8_t>(buf[j])];
                const int64_t idx = base + slen + (j - i);
                if (c == 255) {
                    badw[idx >> 6] |= 1ull << (idx & 63);
                    has_bad = 1;
                    c = 0;
                }
                words[idx >> 5] |= static_cast<uint64_t>(c) << ((idx & 31) * 2);
            }
            slen += e - i;
            i = skip_nl(n, e);
        }
        if (!plus) return -1;
        lengths[r++] = static_cast<int32_t>(slen);
        int64_t qlen = 0;
        while (i < n && qlen < slen) {
            e = line_end(buf, n, i);
            qlen += e - i;
            i = skip_nl(n, e);
        }
        if (qlen != slen) return -1;
    }
    return r == records ? has_bad : -1;
}

// The k-mer windows of many reads in one call, the reads split into one
// contiguous block a thread. codes: the reads' base codes (255 = not ACGT)
// concatenated; read r spans [bounds[r], bounds[r + 1]). Its windows are
// written from cap_off[r] (room for len - k + 1 of them) and counts[r] is
// how many it has. Returns 0. A thread that cannot be started leaves its
// block to the calling thread.
extern "C" int64_t kmerize_batch(const uint8_t* codes, const int64_t* bounds, int64_t n_reads,
                                 int64_t k, const int64_t* cap_off, int64_t* pos_out,
                                 uint64_t* word_out, int64_t* counts) {
    constexpr int64_t kMinReads = 256;  // reads a thread takes at the least
    const int64_t hw = std::max(1u, std::thread::hardware_concurrency());
    const int64_t blocks = std::max<int64_t>(1, std::min(hw, n_reads / kMinReads));
    auto run = [&](int64_t b) {
        for (int64_t r = n_reads * b / blocks; r < n_reads * (b + 1) / blocks; r++) {
            counts[r] = kmerize(codes + bounds[r], bounds[r + 1] - bounds[r],
                                static_cast<int>(k), pos_out + cap_off[r], word_out + cap_off[r]);
        }
    };
    std::vector<std::thread> pool;
    int64_t b = 1;
    try {
        for (; b < blocks; b++) pool.emplace_back(run, b);
    } catch (...) {
    }
    for (int64_t rest = b; rest < blocks; rest++) run(rest);
    run(0);
    for (auto& t : pool) t.join();
    return 0;
}
