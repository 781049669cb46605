// starch3-tpu native host runtime.
//
// The reference keeps its codec layer in native code (bundled patched
// bzip2 1.0.6 + the C++ pipeline, reference makefile:32-43); this module
// is the rebuild's native tier for the host-bound serial residue of the
// block codec — the stages that are not worth a TPU round-trip:
//
//   - bzip2 Huffman code-length construction (weight-packed heap with the
//     format's exact tie-breaking; see starch3_tpu/codec/huffman.py for
//     the behavioral spec — this is a fresh implementation of the same
//     published algorithm, not copied code)
//   - MSB-first bit packing of (value, nbits) field arrays
//   - sequential MTF ranks (the list walk is branchy scalar code; the C
//     loop beats vectorized formulations for host-side use)
//   - RLE1 stream segmentation with libbz2-exact block boundaries
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in this image).
// Every function has a NumPy fallback in Python; the loader
// (runtime/__init__.py) decides per-process.

#ifndef _GNU_SOURCE
#define _GNU_SOURCE 1  // memmem
#endif

#include <algorithm>
#include <mutex>
#include <cstdint>
#include <cstring>
#include <string.h>
#include <vector>

#if defined(__SSSE3__)
#include <immintrin.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Huffman code lengths: bzip2's weight-packed heap construction.
// freq: int64[alpha]; out_lengths: int32[alpha]; returns 0 on success.
// ---------------------------------------------------------------------------
static inline int64_t add_weights(int64_t w1, int64_t w2) {
    int64_t d1 = w1 & 0xff, d2 = w2 & 0xff;
    return ((w1 & ~0xffLL) + (w2 & ~0xffLL)) | (1 + (d1 > d2 ? d1 : d2));
}

int s3_make_code_lengths(const int64_t* freq, int32_t alpha, int32_t max_len,
                         int32_t* out_lengths) {
    if (alpha < 2 || alpha > 258) return -1;
    int64_t weight[2 * 258 + 2];
    int32_t parent[2 * 258 + 2];
    int32_t heap[258 + 2];

    int64_t base[258];
    for (int i = 0; i < alpha; i++)
        base[i] = (freq[i] == 0 ? 1 : freq[i]) << 8;

    for (;;) {
        int n_nodes = alpha;
        int n_heap = 0;
        heap[0] = 0;
        weight[0] = 0;
        parent[0] = -2;
        for (int i = 1; i <= alpha; i++) {
            parent[i] = -1;
            weight[i] = base[i - 1];
            n_heap++;
            heap[n_heap] = i;
            // upheap
            int z = n_heap;
            int tmp = heap[z];
            while (weight[tmp] < weight[heap[z >> 1]]) {
                heap[z] = heap[z >> 1];
                z >>= 1;
            }
            heap[z] = tmp;
        }
        while (n_heap > 1) {
            int n1, n2;
            // pop twice with downheap
            for (int rep = 0; rep < 2; rep++) {
                int& who = rep == 0 ? n1 : n2;
                who = heap[1];
                heap[1] = heap[n_heap];
                n_heap--;
                int z = 1, tmp = heap[z];
                for (;;) {
                    int yy = z << 1;
                    if (yy > n_heap) break;
                    if (yy < n_heap && weight[heap[yy + 1]] < weight[heap[yy]]) yy++;
                    if (weight[tmp] < weight[heap[yy]]) break;
                    heap[z] = heap[yy];
                    z = yy;
                }
                heap[z] = tmp;
            }
            n_nodes++;
            parent[n1] = parent[n2] = n_nodes;
            weight[n_nodes] = add_weights(weight[n1], weight[n2]);
            parent[n_nodes] = -2;
            n_heap++;
            heap[n_heap] = n_nodes;
            int z = n_heap, tmp = heap[z];
            while (weight[tmp] < weight[heap[z >> 1]]) {
                heap[z] = heap[z >> 1];
                z >>= 1;
            }
            heap[z] = tmp;
        }
        bool too_long = false;
        for (int i = 1; i <= alpha; i++) {
            int j = 0, k = i;
            while (parent[k] >= 0) {
                k = parent[k];
                j++;
            }
            out_lengths[i - 1] = j;
            if (j > max_len) too_long = true;
        }
        if (!too_long) return 0;
        for (int i = 0; i < alpha; i++) {
            int64_t j = base[i] >> 8;
            base[i] = (1 + j / 2) << 8;
        }
    }
}

// ---------------------------------------------------------------------------
// MSB-first bit packing.  values: uint64[count] (already masked to nbits),
// nbits: int32[count].  Writes into out (caller-sized: total_bits/8 + 16),
// starting with an accumulator of acc_nbits bits.  Returns the number of
// whole bytes written; *tail/*tail_nbits receive the leftover bits.
// ---------------------------------------------------------------------------
int64_t s3_pack_bits(const uint64_t* values, const int32_t* nbits,
                     int64_t count, uint64_t acc, int32_t acc_nbits,
                     uint8_t* out, uint64_t* tail, int32_t* tail_nbits) {
    uint64_t reg = acc;  // bit accumulator, MSB-first semantics
    int32_t live = acc_nbits;
    int64_t nout = 0;
    for (int64_t i = 0; i < count; i++) {
        int32_t nb = nbits[i];
        reg = (reg << nb) | values[i];
        live += nb;
        while (live >= 8) {
            live -= 8;
            out[nout++] = (uint8_t)(reg >> live);
        }
        reg &= (live == 64) ? ~0ULL : ((1ULL << live) - 1);
    }
    *tail = reg;
    *tail_nbits = live;
    return nout;
}

// ---------------------------------------------------------------------------
// Sequential MTF ranks over a dense alphabet.  seq: int32[n] in [0,n_sym);
// out: int32[n].
// ---------------------------------------------------------------------------
void s3_mtf_ranks(const int32_t* seq, int64_t n, int32_t n_sym, int32_t* out) {
    uint8_t list[256];
    for (int i = 0; i < n_sym; i++) list[i] = (uint8_t)i;
    for (int64_t i = 0; i < n; i++) {
        uint8_t s = (uint8_t)seq[i];
        if (list[0] == s) {
            out[i] = 0;
            continue;
        }
        // walk + shift
        uint8_t prev = list[0];
        int j = 1;
        while (list[j] != s) {
            uint8_t t = list[j];
            list[j] = prev;
            prev = t;
            j++;
        }
        list[j] = prev;
        list[0] = s;
        out[i] = j;
    }
}

// ---------------------------------------------------------------------------
// RLE2 + zero-run coding from MTF ranks (the symbol-stream assembly of
// codec/mtf.py mtf_rle2_from_ranks): zero runs become bijective-base-2
// RUNA/RUNB digits, rank j -> symbol j+1, EOB appended.  Returns the
// symbol count; fills freq[alpha].
// ---------------------------------------------------------------------------
int64_t s3_rle2_from_ranks(const uint8_t* ranks, int64_t n, int32_t n_in_use,
                           uint16_t* out_syms, int64_t* out_freq) {
    const int32_t eob = n_in_use + 1;
    for (int32_t c = 0; c <= eob; c++) out_freq[c] = 0;
    int64_t o = 0;
    int64_t zrun = 0;
    auto flush_zrun = [&]() {
        int64_t m = zrun + 1;
        while (m > 1) {
            uint16_t d = (uint16_t)(m & 1);  // 0 RUNA, 1 RUNB
            out_syms[o++] = d;
            out_freq[d]++;
            m >>= 1;
        }
        zrun = 0;
    };
    for (int64_t i = 0; i < n; i++) {
        uint8_t r = ranks[i];
        if (r == 0) {
            zrun++;
            continue;
        }
        if (zrun) flush_zrun();
        uint16_t sym = (uint16_t)(r + 1);
        out_syms[o++] = sym;
        out_freq[sym]++;
    }
    if (zrun) flush_zrun();
    out_syms[o++] = (uint16_t)eob;
    out_freq[eob]++;
    return o;
}

// ---------------------------------------------------------------------------
// Decimal field parsing: for each field arr[starts[i]:ends[i]) parse a
// (possibly negative) int64.  Returns 0, or -1-i for the first bad field.
// ---------------------------------------------------------------------------
int64_t s3_parse_ints(const uint8_t* arr, const int64_t* starts,
                      const int64_t* ends, int64_t count, int64_t* out) {
    for (int64_t i = 0; i < count; i++) {
        int64_t p = starts[i], e = ends[i];
        if (p >= e) return -1 - i;
        bool neg = arr[p] == '-';
        if (neg) p++;
        if (p >= e || e - p > 19) return -1 - i;
        int64_t v = 0;
        for (; p < e; p++) {
            uint8_t d = arr[p] - '0';
            if (d > 9) return -1 - i;
            v = v * 10 + d;
        }
        out[i] = neg ? -v : v;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Decimal emission: write each vals[i] as ASCII at out[offsets[i]]
// (sign included); lens[i] must equal the decimal length.
// ---------------------------------------------------------------------------
void s3_emit_decimals(uint8_t* out, const int64_t* offsets,
                      const int64_t* vals, const int64_t* lens,
                      int64_t count) {
    for (int64_t i = 0; i < count; i++) {
        int64_t v = vals[i];
        int64_t o = offsets[i];
        int64_t digits_start = o;
        if (v < 0) {
            out[o] = '-';
            v = -v;
            digits_start = o + 1;
        }
        int64_t k = o + lens[i] - 1;
        do {
            out[k] = (uint8_t)('0' + (v % 10));
            v /= 10;
            k--;
        } while (k >= digits_start);
    }
}

// ---------------------------------------------------------------------------
// RLE1 encode of one block's worth of input (no segmentation): writes the
// 4+count form.  Returns output length.  in: bytes[n]; out sized n + n/4.
// ---------------------------------------------------------------------------
// Dense-remap a block's bytes onto its used alphabet and nibble-pack
// two symbols per output byte (the bits==4 device upload format,
// parallel/pipeline._dispatch_chunk).  One pass replaces the NumPy
// bincount/cumsum/fancy-index/pack chain (~4 passes) on the feed
// thread.  Writes the 256-entry used map; returns n_in_use.  When
// n_in_use > 16 the packed output is invalid and the caller takes the
// bits==8 path instead.
int32_t s3_dense_pack4(const uint8_t* in, int64_t n, uint8_t* out,
                       uint8_t* used) {
    uint8_t map[256];
    for (int i = 0; i < 256; i++) used[i] = 0;
    for (int64_t i = 0; i < n; i++) used[in[i]] = 1;
    int32_t n_in_use = 0;
    for (int i = 0; i < 256; i++)
        if (used[i]) map[i] = (uint8_t)n_in_use++;
    if (n_in_use > 16) return n_in_use;
    const int64_t pairs = n / 2;
    for (int64_t i = 0; i < pairs; i++)
        out[i] = (uint8_t)(map[in[2 * i]] | (map[in[2 * i + 1]] << 4));
    if (n & 1) out[pairs] = map[in[n - 1]];
    return n_in_use;
}

// Dense-remap a block's bytes onto its used alphabet and pack
// 30/bits symbols per uint32 word at ``bits`` bits each, low bits
// first (the mid-width device upload format for 17..64-symbol
// alphabets, parallel/pipeline._dispatch_chunk: bits 5 -> 6
// symbols/word, bits 6 -> 5).  Writes the 256-entry used map; returns
// n_in_use (the packed output is only valid when n_in_use <= 1<<bits).
int32_t s3_dense_pack_words(const uint8_t* in, int64_t n, int32_t bits,
                            uint32_t* out, uint8_t* used) {
    uint8_t map[256];
    for (int i = 0; i < 256; i++) used[i] = 0;
    for (int64_t i = 0; i < n; i++) used[in[i]] = 1;
    int32_t n_in_use = 0;
    for (int i = 0; i < 256; i++)
        if (used[i]) map[i] = (uint8_t)n_in_use++;
    if (n_in_use > (1 << bits)) return n_in_use;
    const int32_t spw = 30 / bits;
    const int64_t n_words = (n + spw - 1) / spw;
    for (int64_t w = 0; w < n_words; w++) {
        uint32_t v = 0;
        const int64_t base = w * spw;
        const int k_end = (int)((base + spw <= n) ? spw : (n - base));
        for (int k = 0; k < k_end; k++)
            v |= (uint32_t)map[in[base + k]] << (bits * k);
        out[w] = v;
    }
    return n_in_use;
}

// Batched Huffman length construction for the device-Huffman drain
// (parallel/pipeline._drain_fast_huff): one call covers every
// (block, table) pair of a refinement iteration — the per-pair ctypes
// call overhead was the drain's Amdahl term in the chips-outnumber-
// cores regime.  rfreq int64[b*6*258]; lens int32[b*6*258] (only
// [:alpha] of each active row is written).  Returns 0, or the first
// failing s3_make_code_lengths rc.
int32_t s3_refine_lengths_batch(const int64_t* rfreq, const int64_t* n_groups,
                                const int64_t* alphas, int32_t b,
                                int32_t max_len, int32_t* lens) {
    for (int32_t i = 0; i < b; i++) {
        for (int32_t t = 0; t < (int32_t)n_groups[i]; t++) {
            int rc = s3_make_code_lengths(
                rfreq + ((int64_t)i * 6 + t) * 258, (int32_t)alphas[i],
                max_len, lens + ((int64_t)i * 6 + t) * 258);
            if (rc != 0) return rc;
        }
    }
    return 0;
}

// Selector move-to-front coding (block header emission): the 6-entry
// list walk the Python drain looped per selector.
void s3_selector_mtf(const int32_t* sels, int64_t n, uint8_t* out) {
    uint8_t pos[6] = {0, 1, 2, 3, 4, 5};
    for (int64_t i = 0; i < n; i++) {
        uint8_t s = (uint8_t)sels[i];
        int j = 0;
        while (pos[j] != s) j++;
        out[i] = (uint8_t)j;
        for (; j > 0; j--) pos[j] = pos[j - 1];
        pos[0] = s;
    }
}

int64_t s3_rle1_encode(const uint8_t* in, int64_t n, uint8_t* out) {
    int64_t o = 0;
    int64_t i = 0;
    while (i < n) {
        uint8_t c = in[i];
        int64_t j = i + 1;
        while (j < n && in[j] == c && j - i < 255) j++;
        int64_t run = j - i;
        if (run >= 4) {
            out[o] = out[o + 1] = out[o + 2] = out[o + 3] = c;
            out[o + 4] = (uint8_t)(run - 4);
            o += 5;
        } else {
            for (int64_t k = 0; k < run; k++) out[o++] = c;
        }
        i = j;
    }
    return o;
}

// ---------------------------------------------------------------------------
// RLE1 decode (inverse of the 4+count grammar).  Returns output length or
// -1 on truncated input.  out must be sized for the worst case
// (n/5*259 + 4).
// ---------------------------------------------------------------------------
int64_t s3_rle1_decode(const uint8_t* in, int64_t n, uint8_t* out,
                       int64_t out_cap) {
    int64_t o = 0, i = 0;
    while (i < n) {
        uint8_t c = in[i];
        int64_t j = i + 1;
        while (j < n && j < i + 4 && in[j] == c) j++;
        int64_t run = j - i;
        if (run == 4) {
            if (j >= n) return -1;
            int64_t total = 4 + in[j];
            if (o + total > out_cap) return -2;
            memset(out + o, c, (size_t)total);
            o += total;
            i = j + 1;
        } else {
            if (o + run > out_cap) return -2;
            memset(out + o, c, (size_t)run);
            o += run;
            i = j;
        }
    }
    return o;
}

// ---------------------------------------------------------------------------
// RLE1 stream segmentation with libbz2-exact block boundaries (the
// discipline documented in codec/rle1.py): blocks close when they hold
// >= 100000*level - 19 post-RLE bytes; the pending run carries into the
// next block except at EOF; block CRCs cover flushed original bytes.
//
// Outputs: out_buf receives the concatenated post-RLE1 block bytes;
// block_offsets[i] is the start of block i in out_buf (block_offsets[nb]
// = total); src_bounds[i] is the original-byte boundary ending block i.
// Returns the number of blocks, or -1 on overflow.
// ---------------------------------------------------------------------------
int64_t s3_rle1_split(const uint8_t* in, int64_t n, int32_t level,
                      uint8_t* out_buf, int64_t out_cap,
                      int64_t* block_offsets, int64_t* src_bounds,
                      int32_t max_blocks) {
    const int64_t nblock_max = 100000LL * level - 19;
    int64_t o = 0;          // write cursor in out_buf
    int64_t block_start = 0;  // start of current block in out_buf
    int64_t consumed = 0;
    int32_t nb = 0;
    int pend_ch = -1;
    int64_t pend_len = 0;

    auto flush_pending = [&]() -> bool {
        if (pend_len == 0) return true;
        int64_t need = pend_len >= 4 ? 5 : pend_len;
        if (o + need > out_cap) return false;
        if (pend_len >= 4) {
            out_buf[o] = out_buf[o + 1] = out_buf[o + 2] = out_buf[o + 3] =
                (uint8_t)pend_ch;
            out_buf[o + 4] = (uint8_t)(pend_len - 4);
            o += 5;
        } else {
            for (int64_t k = 0; k < pend_len; k++) out_buf[o++] = (uint8_t)pend_ch;
        }
        pend_len = 0;
        return true;
    };
    auto end_block = [&]() -> bool {
        if (nb >= max_blocks) return false;
        block_offsets[nb] = block_start;
        src_bounds[nb] = consumed - pend_len;
        nb++;
        block_start = o;
        return true;
    };

    int64_t i = 0;
    while (i < n) {
        // Fast path for the dominant shape (BED text: runs are rare):
        // 8 adjacent-distinct bytes are 8 length-1 runs, whose combined
        // effect is "flush incoming pending, emit 7 bytes verbatim,
        // leave the 8th pending" — one XOR-haszero probe + a memcpy
        // instead of 8 state-machine iterations.  Disabled within 16
        // output bytes of a block close so the per-run close checks of
        // the slow path below stay authoritative (their margin: the
        // flush adds <= 5 bytes, the emits 7).
        while (i + 8 < n && (o - block_start) < nblock_max - 16 &&
               o + 12 <= out_cap) {
            uint64_t w, w2;
            memcpy(&w, in + i, 8);
            memcpy(&w2, in + i + 1, 8);
            uint64_t x = w ^ w2;  // zero byte k <=> in[i+k] == in[i+k+1]
            uint64_t z = (x - 0x0101010101010101ULL) & ~x &
                         0x8080808080808080ULL;
            if (z == 0) {
                if (!flush_pending()) return -1;
                memcpy(out_buf + o, in + i, 7);
                o += 7;
                pend_ch = in[i + 7];
                pend_len = 1;
                consumed += 8;
                i += 8;
                continue;
            }
            // singles up to the first adjacent pair, then the slow path
            // takes the run that starts there
#if defined(__GNUC__) || defined(__clang__)
            int k = __builtin_ctzll(z) >> 3;
#else
            int k = 0;
            while (!(z & (0xFFULL << (8 * k)))) k++;
#endif
            if (k == 0) break;  // a run starts right here
            if (!flush_pending()) return -1;
            memcpy(out_buf + o, in + i, (size_t)(k - 1));
            o += k - 1;
            pend_ch = in[i + k - 1];
            pend_len = 1;
            consumed += k;
            i += k;
        }
        if (i >= n) break;
        uint8_t c = in[i];
        int64_t j = i + 1;
        while (j < n && in[j] == c) j++;
        int64_t rem = j - i;
        // first byte of the run flushes the previous pending tail
        if (!flush_pending()) return -1;
        pend_ch = c;
        pend_len = 1;
        rem--;
        consumed++;
        bool more = rem > 0 || j < n;
        if (more && (o - block_start) >= nblock_max) {
            if (!end_block()) return -1;
        }
        while (rem) {
            int64_t take = rem < (255 - pend_len) ? rem : (255 - pend_len);
            pend_len += take;
            rem -= take;
            consumed += take;
            if (rem) {
                if (!flush_pending()) return -1;
                pend_ch = c;
                pend_len = 1;
                rem--;
                consumed++;
                more = rem > 0 || j < n;
                if (more && (o - block_start) >= nblock_max) {
                    if (!end_block()) return -1;
                }
            }
        }
        i = j;
    }
    if (!flush_pending()) return -1;
    if (o > block_start || pend_len) {
        if (!end_block()) return -1;
    }
    block_offsets[nb] = o;
    return nb;
}

// ---------------------------------------------------------------------------
// BWT rotation sort via SA-IS (Nong/Zhang/Chan induced sorting), written
// from scratch.  Rotation order with libbz2's equal-rotation tie order
// (descending start index) falls out of suffix-sorting the doubled block
// with a unique smallest sentinel: equal rotations compare equal until
// the shorter suffix hits the sentinel, which sorts first — so the
// larger start index wins (codec/bwt.py documents the tie evidence).
// ---------------------------------------------------------------------------
extern "C++" {  // template: C++ linkage island inside the C ABI block
namespace {

// Core over a pre-packed array p[i] = (symbol << 1) | s_type: the induce
// loops' random access touches one array (one cache line per probe)
// instead of separate symbol and type arrays, and bucket counts are taken
// once per level.  P is uint16_t while (K << 1) | 1 fits (level 0:
// symbols 0..256), int32_t for large reduced alphabets.
template <typename P>
static void sais_core(const P* p, int32_t* sa, int64_t n, int32_t K) {
    if (n == 1) {
        sa[0] = 0;
        return;
    }
    auto is_lms = [&](int64_t i) {
        return i > 0 && (p[i] & 1) && !(p[i - 1] & 1);
    };
    std::vector<int32_t> cnt((size_t)K, 0), bkt((size_t)K);
    for (int64_t i = 0; i < n; i++) cnt[(size_t)(p[i] >> 1)]++;
    auto bucket_ends = [&]() {
        int32_t sum = 0;
        for (int32_t c = 0; c < K; c++) {
            sum += cnt[(size_t)c];
            bkt[(size_t)c] = sum;  // exclusive end
        }
    };
    auto bucket_starts = [&]() {
        int32_t sum = 0;
        for (int32_t c = 0; c < K; c++) {
            bkt[(size_t)c] = sum;
            sum += cnt[(size_t)c];
        }
    };
    auto induce = [&]() {
        // induce L from sorted LMS/S positions already in sa
        bucket_starts();
        int32_t* b = bkt.data();
        for (int64_t i = 0; i < n; i++) {
            int64_t j = sa[i];
            if (j > 0) {
                P w = p[j - 1];
                if (!(w & 1)) sa[b[w >> 1]++] = (int32_t)(j - 1);
            }
        }
        // induce S
        bucket_ends();
        for (int64_t i = n - 1; i >= 0; i--) {
            int64_t j = sa[i];
            if (j > 0) {
                P w = p[j - 1];
                if (w & 1) sa[--b[w >> 1]] = (int32_t)(j - 1);
            }
        }
    };

    // 2. first pass: place LMS suffixes at bucket ends (arbitrary order)
    memset(sa, 0xFF, (size_t)n * sizeof(int32_t));  // -1
    bucket_ends();
    for (int64_t i = 1; i < n; i++)
        if (is_lms(i)) sa[--bkt[(size_t)(p[i] >> 1)]] = (int32_t)i;
    induce();

    // 3. name LMS substrings in sorted order.  LMS positions are never
    // adjacent, so a pos/2-indexed name table halves the footprint.
    int64_t n_lms = 0;
    std::vector<int32_t> lms_sorted;
    lms_sorted.reserve((size_t)(n / 2 + 1));
    for (int64_t i = 0; i < n; i++)
        if (is_lms(sa[i])) lms_sorted.push_back(sa[i]);
    n_lms = (int64_t)lms_sorted.size();
    std::vector<int32_t> name((size_t)(n / 2 + 1), -1);
    int32_t cur_name = 0;
    int64_t prev = -1;
    for (int64_t k = 0; k < n_lms; k++) {
        int64_t pos = lms_sorted[(size_t)k];
        if (prev == -1) {
            name[(size_t)(pos >> 1)] = cur_name;
        } else {
            // compare LMS substrings at prev and pos (packed compare ==
            // symbol + type compare)
            bool diff = false;
            for (int64_t d = 0;; d++) {
                if (p[prev + d] != p[pos + d]) {
                    diff = true;
                    break;
                }
                if (d > 0 && (is_lms(prev + d) || is_lms(pos + d))) {
                    diff = !(is_lms(prev + d) && is_lms(pos + d));
                    break;
                }
            }
            if (diff) cur_name++;
            name[(size_t)(pos >> 1)] = cur_name;
        }
        prev = pos;
    }
    // collect reduced string in text order
    std::vector<int32_t> red;
    std::vector<int32_t> lms_pos;
    red.reserve((size_t)n_lms);
    lms_pos.reserve((size_t)n_lms);
    for (int64_t i = 1; i < n; i++)
        if (is_lms(i)) {
            red.push_back(name[(size_t)(i >> 1)]);
            lms_pos.push_back((int32_t)i);
        }
    // 4. order LMS suffixes
    std::vector<int32_t> lms_sa((size_t)n_lms);
    if (cur_name + 1 == n_lms) {
        for (int64_t k = 0; k < n_lms; k++)
            lms_sa[(size_t)red[(size_t)k]] = (int32_t)k;
    } else {
        // recurse: pack the reduced string (sentinel = its last symbol,
        // unique smallest by construction)
        int32_t subK = cur_name + 1;
        if ((((int64_t)subK << 1) | 1) <= 0xFFFF) {
            std::vector<uint16_t> sub((size_t)n_lms);
            uint8_t st = 1;
            sub[(size_t)(n_lms - 1)] =
                (uint16_t)((red[(size_t)(n_lms - 1)] << 1) | 1);
            for (int64_t i = n_lms - 2; i >= 0; i--) {
                st = red[(size_t)i] < red[(size_t)(i + 1)] ||
                             (red[(size_t)i] == red[(size_t)(i + 1)] && st)
                         ? 1
                         : 0;
                sub[(size_t)i] = (uint16_t)((red[(size_t)i] << 1) | st);
            }
            sais_core<uint16_t>(sub.data(), lms_sa.data(), n_lms, subK);
        } else {
            std::vector<int32_t> sub((size_t)n_lms);
            uint8_t st = 1;
            sub[(size_t)(n_lms - 1)] = (red[(size_t)(n_lms - 1)] << 1) | 1;
            for (int64_t i = n_lms - 2; i >= 0; i--) {
                st = red[(size_t)i] < red[(size_t)(i + 1)] ||
                             (red[(size_t)i] == red[(size_t)(i + 1)] && st)
                         ? 1
                         : 0;
                sub[(size_t)i] = (red[(size_t)i] << 1) | st;
            }
            sais_core<int32_t>(sub.data(), lms_sa.data(), n_lms, subK);
        }
    }
    // 5. final induce with LMS in sorted order
    memset(sa, 0xFF, (size_t)n * sizeof(int32_t));
    bucket_ends();
    for (int64_t k = n_lms - 1; k >= 0; k--) {
        int32_t pos = lms_pos[(size_t)lms_sa[(size_t)k]];
        sa[--bkt[(size_t)(p[pos] >> 1)]] = pos;
    }
    induce();
}

// ---------------------------------------------------------------------------
// Fast rotation sort: two-byte counting radix into 64K buckets, ternary
// multikey quicksort inside each sub-bucket, and Seward's induced-copy
// step (a fully sorted major bucket [c] derives every [d][c] column by one
// scan over predecessors).  A byte-comparison budget bails out on
// pathological inputs; the caller then reruns the block through the SA-IS
// path, which produces the identical total order (rotation lexicographic,
// equal rotations by descending start index) — so output bytes never
// depend on which sorter ran.
// ---------------------------------------------------------------------------

struct RotPair;

struct RotCtx {
    const uint8_t* db;  // doubled block (2n + 16 bytes; periodic pad)
    int64_t n;
    int64_t budget;     // comparison budget; <0 -> give up
    RotPair* scratch;   // n entries; bucket [lo,hi) uses scratch[lo,hi)
    // packed nibbles when the alphabet fits 4 bits (delta text is ~14
    // distinct bytes): nib[j] = rank(db[2j])<<4 | rank(db[2j+1]).  A key
    // gather becomes one unaligned 8-byte load (+1 byte for odd phase)
    // from an n-sized, cache-resident array and resolves 16 input bytes
    // instead of 8, halving the random-access rounds of the depth
    // recursion.  The rank map is monotone in byte value, so uint64
    // order == byte order.
    const uint8_t* nib = nullptr;  // (2n+16)/2 entries, or null (byte keys)
    int step = 8;                  // bytes resolved per gathered key
};

// 8 bytes of the rotation starting at `a`, from byte `depth` on, as a
// big-endian word — so uint64 order == lexicographic byte order.  The
// doubled buffer is padded with 8 wraparound bytes, making every load
// (a <= n-1, depth <= n-1) in-bounds; bytes past position n are the
// periodic extension of the rotation, so comparisons that spill past the
// rotation length stay order-consistent (and exactly-equal rotations are
// routed to the SA-IS path before this sorter runs — see rot_sort).
static inline uint64_t rot_key(const RotCtx& cx, int32_t a, int64_t depth) {
    uint64_t w;
    memcpy(&w, cx.db + a + depth, 8);
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_BIG_ENDIAN__
    return w;
#else
    return __builtin_bswap64(w);
#endif
}

// full compare of rotations a,b from byte `depth` on; true if rot(a) < rot(b)
static bool rot_less(RotCtx& cx, int32_t a, int32_t b, int64_t depth) {
    int64_t rem = cx.n - depth;
    for (int64_t d = 0; d < rem; d += 8) {
        uint64_t wa = rot_key(cx, a, depth + d);
        uint64_t wb = rot_key(cx, b, depth + d);
        if (wa != wb) {
            cx.budget -= d + 8;
            return wa < wb;
        }
    }
    cx.budget -= rem;
    return a > b;  // equal rotations: descending start index first
}

static void rot_insertion(RotCtx& cx, int32_t* ptr, int64_t lo, int64_t hi,
                          int64_t depth) {
    for (int64_t i = lo + 1; i < hi; i++) {
        int32_t v = ptr[i];
        int64_t j = i;
        while (j > lo && rot_less(cx, v, ptr[j - 1], depth)) {
            ptr[j] = ptr[j - 1];
            j--;
            if (cx.budget < 0) return;
        }
        ptr[j] = v;
    }
}

// Key-gather sort of one bucket: fetch each rotation's 8-byte word at
// `depth` ONCE into a contiguous (key, idx) scratch, sort there, and
// recurse only into equal-key runs 8 bytes deeper.  A ternary quicksort
// re-reads the doubled block on every partition pass (one random cache
// miss per element per pass); this does exactly one random load per
// element per 8 bytes of resolved depth — the sort itself runs over
// contiguous scratch and stays in cache.
struct RotPair {
    uint64_t key;
    int32_t idx;
};

// In-place MSD byte radix ("American flag") sort of pairs by key —
// equal keys end up adjacent (within-run order is arbitrary, resolved
// by the caller's deeper recursion), matching what rot_mkqs needs.
// ~2x std::sort on these skewed text-chunk keys.
static void rp_radix(RotPair* a, int64_t n, int shift) {
    while (n >= 48) {
        int64_t start[257];
        int live = 0;
        {
            int64_t cnt[256] = {0};
            for (int64_t i = 0; i < n; i++)
                cnt[(a[i].key >> shift) & 255]++;
            int64_t s = 0;
            for (int b = 0; b < 256; b++) {
                start[b] = s;
                s += cnt[b];
                live += cnt[b] != 0;
            }
            start[256] = s;
        }
        if (live == 1) {
            // one live byte value: nothing moves; descend in place
            // (common on repetitive text — long shared prefixes)
            if (shift == 0) return;
            shift -= 8;
            continue;
        }
        int64_t next[256];
        memcpy(next, start, sizeof(next));
        for (int b = 0; b < 256; b++) {
            while (next[b] < start[b + 1]) {
                RotPair v = a[next[b]];
                int d;
                while ((d = (int)((v.key >> shift) & 255)) != b) {
                    RotPair t = a[next[d]];
                    a[next[d]++] = v;
                    v = t;
                }
                a[next[b]++] = v;
            }
        }
        if (shift == 0) return;
        shift -= 8;
        // recurse into all but the largest bucket; loop on the largest
        int bmax = 0;
        for (int b = 1; b < 256; b++)
            if (start[b + 1] - start[b] > start[bmax + 1] - start[bmax])
                bmax = b;
        for (int b = 0; b < 256; b++) {
            int64_t sz = start[b + 1] - start[b];
            if (b != bmax && sz > 1) rp_radix(a + start[b], sz, shift);
        }
        a += start[bmax];
        n = start[bmax + 1] - start[bmax];
    }
    // insertion sort small runs by key
    for (int64_t i = 1; i < n; i++) {
        RotPair v = a[i];
        int64_t j = i;
        while (j > 0 && a[j - 1].key > v.key) {
            a[j] = a[j - 1];
            j--;
        }
        a[j] = v;
    }
}

static void rot_mkqs(RotCtx& cx, int32_t* ptr, int64_t lo, int64_t hi,
                     int64_t depth) {
    while (hi - lo > 1) {
        if (cx.budget < 0) return;
        if (hi - lo < 16) {
            rot_insertion(cx, ptr, lo, hi, depth);
            return;
        }
        if (depth >= cx.n) {
            // equal rotations: descending start index
            std::sort(ptr + lo, ptr + hi,
                      [](int32_t a, int32_t b) { return a > b; });
            return;
        }
        RotPair* pr = cx.scratch + lo;
        const int64_t m = hi - lo;
        if (cx.nib) {
            for (int64_t i = 0; i < m; i++) {
                if (i + 16 < m)  // gather is the miss-bound loop
                    __builtin_prefetch(cx.nib + ((ptr[lo + i + 16] + depth) >> 1));
                const int64_t a = ptr[lo + i] + depth;
                uint64_t w;
                memcpy(&w, cx.nib + (a >> 1), 8);
#if !defined(__BYTE_ORDER__) || __BYTE_ORDER__ != __ORDER_BIG_ENDIAN__
                w = __builtin_bswap64(w);
#endif
                // odd phase: shift in the next byte's top nibble
                const uint64_t odd = (uint64_t)(a & 1);
                w = (w << (odd << 2)) |
                    (((uint64_t)(cx.nib[(a >> 1) + 8] >> 4)) & (0ULL - odd));
                pr[i] = RotPair{w, ptr[lo + i]};
            }
        } else {
            for (int64_t i = 0; i < m; i++) {
                if (i + 16 < m)
                    __builtin_prefetch(cx.db + ptr[lo + i + 16] + depth);
                pr[i] = RotPair{rot_key(cx, ptr[lo + i], depth), ptr[lo + i]};
            }
        }
        rp_radix(pr, m, 56);
        cx.budget -= m;
        // write back; recurse into equal-key runs (all but the last —
        // the trailing run continues in this frame, bounding recursion)
        int64_t rs = 0;
        for (int64_t i = 1; i < m; i++) {
            ptr[lo + i - 1] = pr[i - 1].idx;
            if (pr[i].key != pr[i - 1].key) {
                if (i - rs > 1)
                    rot_mkqs(cx, ptr, lo + rs, lo + i, depth + cx.step);
                rs = i;
            }
        }
        ptr[hi - 1] = pr[m - 1].idx;
        lo = lo + rs;
        depth += cx.step;
    }
}

// Returns true on success (ptr[0..n) = sorted rotation starts).
static bool rot_sort(const uint8_t* block, int64_t n, int32_t* ptr) {
    // Exactly periodic blocks have equal rotations, whose descending-index
    // tie order the induced-copy step cannot guarantee (it inherits order
    // across the wraparound).  Non-periodic blocks cannot have equal
    // rotations, making every ordering decision below comparison-driven
    // and provably correct — so gate on the KMP smallest period.
    // doubled block + 8 wraparound bytes so 8-byte word loads at any
    // (start < n, depth < n) stay in bounds (rot_key)
    std::vector<uint8_t> dbv((size_t)(2 * n + 16));
    memcpy(dbv.data(), block, (size_t)n);
    memcpy(dbv.data() + n, block, (size_t)n);
    memcpy(dbv.data() + 2 * n, block, 16);  // n >= 16 on this path
    const uint8_t* db = dbv.data();
    // 2-byte histogram
    std::vector<int64_t> ftab(65537, 0);
    for (int64_t i = 0; i < n; i++)
        ftab[((int32_t)db[i] << 8) | db[i + 1]]++;
    // Periodicity gate: block is exactly periodic iff it matches one of
    // its own non-trivial rotations, i.e. iff `block` occurs in the
    // doubled buffer at an offset in [1, n-1].  The haystack db[1..2n-1)
    // excludes both trivial occurrences (offset 0, and offset n whose
    // last byte db[2n-1] lies past the haystack end).
    // Pre-gate from the histogram just built: a block that is r>=2
    // repetitions of a period has every byte count divisible by r, so if
    // the gcd of the byte counts is 1 the block cannot be periodic and
    // the O(n) substring scan is skipped (the common case on real text).
    int64_t counts[256];
    {
        int64_t g = 0;
        for (int c = 0; c < 256; c++) {
            int64_t cnt = 0;
            const int64_t* row = ftab.data() + ((int64_t)c << 8);
            for (int j = 0; j < 256; j++) cnt += row[j];
            counts[c] = cnt;
            while (cnt) {
                int64_t t = g % cnt;
                g = cnt;
                cnt = t;
            }
        }
        if (g != 1 &&
            memmem(db + 1, (size_t)(2 * n - 2), block, (size_t)n) != nullptr)
            return false;  // periodic -> SA-IS path (equal-rotation ties)
    }
    int64_t sum = 0;
    for (int64_t b = 0; b <= 65536; b++) {
        int64_t t = b < 65536 ? ftab[b] : 0;
        ftab[b] = sum;  // start of bucket b
        sum += t;
    }
    {
        std::vector<int64_t> fill(ftab.begin(), ftab.end() - 1);
        for (int64_t i = 0; i < n; i++)
            ptr[fill[((int32_t)db[i] << 8) | db[i + 1]]++] = (int32_t)i;
    }
    std::vector<RotPair> scratch((size_t)n);
    RotCtx cx{db, n, 12 * n + 65536, scratch.data()};
    // nibble-packed 16-byte keys (see RotCtx::nib) when the alphabet fits
    std::vector<uint8_t> nibv;
    {
        uint8_t rank[256];
        int n_in_use = 0;
        for (int c = 0; c < 256; c++)
            if (counts[c]) rank[c] = (uint8_t)n_in_use++;
        if (n_in_use <= 16) {
            // pack the doubled buffer two ranks per byte; +16 tail bytes so
            // the 8-byte load + odd-phase byte at any a <= 2n-2 is in bounds
            const int64_t nn = (2 * n + 16 + 1) / 2 + 9;
            nibv.resize((size_t)nn, 0);
            uint8_t* nb = nibv.data();
            for (int64_t j = 0; j + 1 < 2 * n + 16; j += 2)
                nb[j >> 1] = (uint8_t)((rank[db[j]] << 4) | rank[db[j + 1]]);
            cx.nib = nb;
            cx.step = 16;
        }
    }
    // process major buckets smallest-total first
    int order[256];
    {
        int64_t tot[256];
        for (int b = 0; b < 256; b++) {
            order[b] = b;
            tot[b] = ftab[(int64_t)(b + 1) << 8] - ftab[(int64_t)b << 8];
        }
        std::sort(order, order + 256,
                  [&](int a, int b2) { return tot[a] < tot[b2]; });
    }
    bool big_done[256] = {false};
    bool small_done[65536] = {false};
    int64_t copy_start[256], copy_end[256];
    for (int bi = 0; bi < 256; bi++) {
        const int ss = order[bi];
        // sort each live sub-bucket [ss][j], j != ss
        for (int j = 0; j < 256; j++) {
            if (j == ss) continue;
            const int64_t sb = ((int64_t)ss << 8) | j;
            if (small_done[sb]) continue;
            int64_t lo = ftab[sb], hi = ftab[sb + 1];
            if (hi - lo > 1) {
                rot_mkqs(cx, ptr, lo, hi, 2);
                if (cx.budget < 0) return false;
            }
            small_done[sb] = true;
        }
        // induced copy: big bucket ss is now fully sorted (the [ss][ss]
        // sub-bucket fills itself during the scans below)
        for (int j = 0; j < 256; j++) {
            copy_start[j] = ftab[((int64_t)j << 8) | ss];
            copy_end[j] = ftab[(((int64_t)j << 8) | ss) + 1] - 1;
        }
        for (int64_t i = ftab[(int64_t)ss << 8]; i < copy_start[ss]; i++) {
            if (i + 16 < copy_start[ss])
                __builtin_prefetch(db + ptr[i + 16]);
            int64_t k = ptr[i] - 1;
            if (k < 0) k += n;
            uint8_t c1 = db[k];
            if (!big_done[c1]) ptr[copy_start[c1]++] = (int32_t)k;
        }
        for (int64_t i = ftab[(int64_t)(ss + 1) << 8] - 1; i > copy_end[ss];
             i--) {
            if (i - 16 > copy_end[ss])
                __builtin_prefetch(db + ptr[i - 16]);
            int64_t k = ptr[i] - 1;
            if (k < 0) k += n;
            uint8_t c1 = db[k];
            if (!big_done[c1]) ptr[copy_end[c1]--] = (int32_t)k;
        }
        for (int j = 0; j < 256; j++)
            small_done[((int64_t)j << 8) | ss] = true;
        big_done[ss] = true;
    }
    return true;
}

}  // namespace
}  // extern "C++"

// BWT of one block: returns orig_ptr, fills last[n].
int64_t s3_bwt(const uint8_t* block, int64_t n, uint8_t* last) {
    if (n <= 0) return -1;
    if (n == 1) {
        last[0] = block[0];
        return 0;
    }
    // fast path: radix + multikey quicksort rotation sort (identical
    // total order; bails to SA-IS on pathological repetitiveness)
    if (n >= 16) {
        std::vector<int32_t> ptr((size_t)n);
        if (rot_sort(block, n, ptr.data())) {
            int64_t orig_ptr = -1;
            for (int64_t i = 0; i < n; i++) {
                int32_t q = ptr[(size_t)i];
                if (q == 0) {
                    orig_ptr = i;
                    last[i] = block[n - 1];
                } else {
                    last[i] = block[q - 1];
                }
            }
            return orig_ptr;
        }
    }
    const int64_t m = 2 * n + 1;
    // packed doubled string: symbol = byte + 1, sentinel 0 at the end
    std::vector<uint16_t> p((size_t)m);
    p[(size_t)(m - 1)] = (0 << 1) | 1;  // sentinel, S-type
    {
        uint8_t st = 0;  // s[m-2] = block[n-1]+1 > 0 = sentinel -> L-type
        p[(size_t)(m - 2)] = (uint16_t)(((int32_t)block[n - 1] + 1) << 1);
        for (int64_t i = m - 3; i >= 0; i--) {
            uint8_t c = block[i < n ? i : i - n];
            uint8_t c1 = block[(i + 1) < n ? (i + 1) : (i + 1 - n)];
            st = c < c1 || (c == c1 && st) ? 1 : 0;
            p[(size_t)i] = (uint16_t)((((int32_t)c + 1) << 1) | st);
        }
    }
    std::vector<int32_t> sa((size_t)m);
    sais_core<uint16_t>(p.data(), sa.data(), m, 257);
    int64_t orig_ptr = -1;
    int64_t o = 0;
    for (int64_t i = 0; i < m; i++) {
        int32_t q = sa[(size_t)i];
        if (q >= n) continue;  // keep suffixes starting in the first copy
        if (q == 0) {
            orig_ptr = o;
            last[o++] = block[n - 1];
        } else {
            last[o++] = block[q - 1];
        }
    }
    return orig_ptr;
}

// ---------------------------------------------------------------------------
// Full bzip2 stream decoder (fresh implementation of the public format —
// the behavioral spec lives in starch3_tpu/codec/decoder.py, validated
// against libbz2).  Returns the decoded length, or:
//   -1 malformed stream   -2 output capacity exceeded   -3 CRC mismatch
// ---------------------------------------------------------------------------
namespace {

struct BitReader {
    const uint8_t* data;
    int64_t nbytes;
    int64_t pos = 0;  // absolute bit position
    bool ok = true;

    // look at the next nbits (<= 24) without consuming; bits past the
    // end read as zero (consumers detect truncation via pos bounds)
    inline uint32_t peek(int nbits) const {
        int64_t byte = pos >> 3;
        int off = (int)(pos & 7);
        uint32_t v = 0;
        for (int k = 0; k < 4; k++)
            v = (v << 8) | (byte + k < nbytes ? data[byte + k] : 0);
        return (v >> (32 - off - nbits)) & ((1u << nbits) - 1);
    }

    inline uint32_t read(int nbits) {
        if ((pos + nbits) > nbytes * 8) {
            ok = false;
            return 0;
        }
        if (nbits <= 24) {
            uint32_t v = peek(nbits);
            pos += nbits;
            return v;
        }
        uint32_t hi = read(16);
        return (hi << (nbits - 16)) | read(nbits - 16);
    }
    inline int bit() {
        if (pos >= nbytes * 8) {
            ok = false;
            return 0;
        }
        int b = (data[pos >> 3] >> (7 - (pos & 7))) & 1;
        pos++;
        return b;
    }
    inline uint64_t read48() {
        return ((uint64_t)read(24) << 24) | read(24);
    }
};

static uint32_t g_crc_table[256];
static uint32_t g_crc_slice[8][256];  // slice-by-8 (s3_crc32)
static std::once_flag g_crc_once;  // parallel decode threads race the init
static void crc_init() {
    std::call_once(g_crc_once, [] {
        for (uint32_t i = 0; i < 256; i++) {
            uint32_t c = i << 24;
            for (int k = 0; k < 8; k++)
                c = (c & 0x80000000u) ? (c << 1) ^ 0x04C11DB7u : (c << 1);
            g_crc_table[i] = c;
            g_crc_slice[0][i] = c;
        }
        for (int t = 1; t < 8; t++)
            for (uint32_t i = 0; i < 256; i++) {
                uint32_t p = g_crc_slice[t - 1][i];
                g_crc_slice[t][i] = (p << 8) ^ g_crc_table[p >> 24];
            }
    });
}

}  // namespace

namespace {

// Legacy block-randomisation table (bzip2 <= 0.9.0; a conforming
// decoder must accept such blocks).  Format constant — the identical
// 512 values every bzip2 decoder carries (behavioral spec:
// decompress.c:545-575 via the bundled reference tarball).
static const uint16_t kRNums[512] = {
    619, 720, 127, 481, 931, 816, 813, 233, 566, 247, 985, 724,
    205, 454, 863, 491, 741, 242, 949, 214, 733, 859, 335, 708,
    621, 574, 73, 654, 730, 472, 419, 436, 278, 496, 867, 210,
    399, 680, 480, 51, 878, 465, 811, 169, 869, 675, 611, 697,
    867, 561, 862, 687, 507, 283, 482, 129, 807, 591, 733, 623,
    150, 238, 59, 379, 684, 877, 625, 169, 643, 105, 170, 607,
    520, 932, 727, 476, 693, 425, 174, 647, 73, 122, 335, 530,
    442, 853, 695, 249, 445, 515, 909, 545, 703, 919, 874, 474,
    882, 500, 594, 612, 641, 801, 220, 162, 819, 984, 589, 513,
    495, 799, 161, 604, 958, 533, 221, 400, 386, 867, 600, 782,
    382, 596, 414, 171, 516, 375, 682, 485, 911, 276, 98, 553,
    163, 354, 666, 933, 424, 341, 533, 870, 227, 730, 475, 186,
    263, 647, 537, 686, 600, 224, 469, 68, 770, 919, 190, 373,
    294, 822, 808, 206, 184, 943, 795, 384, 383, 461, 404, 758,
    839, 887, 715, 67, 618, 276, 204, 918, 873, 777, 604, 560,
    951, 160, 578, 722, 79, 804, 96, 409, 713, 940, 652, 934,
    970, 447, 318, 353, 859, 672, 112, 785, 645, 863, 803, 350,
    139, 93, 354, 99, 820, 908, 609, 772, 154, 274, 580, 184,
    79, 626, 630, 742, 653, 282, 762, 623, 680, 81, 927, 626,
    789, 125, 411, 521, 938, 300, 821, 78, 343, 175, 128, 250,
    170, 774, 972, 275, 999, 639, 495, 78, 352, 126, 857, 956,
    358, 619, 580, 124, 737, 594, 701, 612, 669, 112, 134, 694,
    363, 992, 809, 743, 168, 974, 944, 375, 748, 52, 600, 747,
    642, 182, 862, 81, 344, 805, 988, 739, 511, 655, 814, 334,
    249, 515, 897, 955, 664, 981, 649, 113, 974, 459, 893, 228,
    433, 837, 553, 268, 926, 240, 102, 654, 459, 51, 686, 754,
    806, 760, 493, 403, 415, 394, 687, 700, 946, 670, 656, 610,
    738, 392, 760, 799, 887, 653, 978, 321, 576, 617, 626, 502,
    894, 679, 243, 440, 680, 879, 194, 572, 640, 724, 926, 56,
    204, 700, 707, 151, 457, 449, 797, 195, 791, 558, 945, 679,
    297, 59, 87, 824, 713, 663, 412, 693, 342, 606, 134, 108,
    571, 364, 631, 212, 174, 643, 304, 329, 343, 97, 430, 751,
    497, 314, 983, 374, 822, 928, 140, 206, 73, 263, 980, 736,
    876, 478, 430, 305, 170, 514, 364, 692, 829, 82, 855, 953,
    676, 246, 369, 970, 294, 750, 807, 827, 150, 790, 288, 923,
    804, 378, 215, 828, 592, 281, 565, 555, 710, 82, 896, 831,
    547, 261, 524, 462, 293, 465, 502, 56, 661, 821, 976, 991,
    658, 869, 905, 758, 745, 193, 768, 550, 608, 933, 378, 286,
    215, 979, 792, 961, 61, 688, 793, 644, 986, 403, 106, 366,
    905, 644, 372, 567, 466, 434, 645, 210, 389, 550, 919, 135,
    780, 773, 635, 389, 707, 100, 626, 958, 165, 504, 920, 176,
    193, 713, 857, 265, 203, 50, 668, 108, 645, 990, 626, 197,
    510, 357, 358, 850, 858, 364, 936, 638,
};

// De-randomise the post-inverse-BWT bytes in place: a counter reloads
// from the table (cycling) at zero; the byte where its post-decrement
// value is 1 gets bit 0 flipped.
static void derandomize(uint8_t* p, int64_t n) {
    int32_t rNToGo = 0, rTPos = 0;
    for (int64_t i = 0; i < n; i++) {
        if (rNToGo == 0) {
            rNToGo = kRNums[rTPos];
            rTPos = (rTPos + 1) & 511;
        }
        rNToGo--;
        p[i] ^= (rNToGo == 1) ? 1 : 0;
    }
}

// Everything a block's coded-data loop needs, parsed from the bit
// stream once (headers, symbol map, selectors, canonical tables, and
// the 10-bit fast-decode LUT).  Shared by the full decoder (dec_block)
// and the symbols-only export (s3_read_block_symbols) that feeds the
// device decode pipeline.
struct BlockHead {
    uint32_t block_crc;
    uint32_t orig_ptr;
    bool randomised;
    uint8_t seq_to_byte[256];
    int n_in_use, alpha, n_groups, n_sel;
    uint8_t* sels;  // thread-local buffer owned by parse_block_head
    int32_t limit[6][25], base[6][25], perm[6][258], min_len_t[6];
    static constexpr int kLut = 10;
    uint16_t (*lut)[1 << kLut];  // thread-local [6][1024]
};

// Parse one block's headers (48-bit magic already consumed) up to the
// first coded symbol.  Returns 0, or -1 on malformed input.
static int parse_block_head(BitReader& br, BlockHead& H) {
    H.block_crc = br.read(32);
    H.randomised = br.bit() != 0;  // legacy blocks: de-randomised post-iBWT
    H.orig_ptr = br.read(24);
    // symbol map
    uint16_t gmask = (uint16_t)br.read(16);
    H.n_in_use = 0;
    for (int g = 0; g < 16; g++) {
        if ((gmask >> (15 - g)) & 1) {
            uint16_t bits = (uint16_t)br.read(16);
            for (int b = 0; b < 16; b++)
                if ((bits >> (15 - b)) & 1)
                    H.seq_to_byte[H.n_in_use++] = (uint8_t)(g * 16 + b);
        }
    }
    if (H.n_in_use == 0 || !br.ok) return -1;
    H.alpha = H.n_in_use + 2;
    const int alpha = H.alpha;
    H.n_groups = br.read(3);
    if (H.n_groups < 2 || H.n_groups > 6) return -1;
    H.n_sel = br.read(15);
    if (H.n_sel < 1 || !br.ok) return -1;
    // selectors (MTF-coded unary)
    static thread_local uint8_t* sels = nullptr;
    static thread_local int64_t sels_cap = 0;
    if (sels_cap < H.n_sel) {
        delete[] sels;
        sels = new uint8_t[H.n_sel];
        sels_cap = H.n_sel;
    }
    H.sels = sels;
    {
        uint8_t pos_[6] = {0, 1, 2, 3, 4, 5};
        for (int i = 0; i < H.n_sel; i++) {
            int j = 0;
            while (br.bit()) {
                j++;
                if (j >= H.n_groups || !br.ok) return -1;
            }
            uint8_t s = pos_[j];
            for (int t = j; t > 0; t--) pos_[t] = pos_[t - 1];
            pos_[0] = s;
            sels[i] = s;
        }
    }
    // code lengths -> canonical decode tables
    int32_t len[6][258];
    for (int t = 0; t < H.n_groups; t++) {
        int curr = br.read(5);
        for (int s = 0; s < alpha; s++) {
            for (;;) {
                if (curr < 1 || curr > 23 || !br.ok) return -1;
                if (!br.bit()) break;
                if (br.bit()) curr--; else curr++;
            }
            len[t][s] = curr;
        }
    }
    for (int t = 0; t < H.n_groups; t++) {
        int mn = 32, mx = 0;
        for (int s = 0; s < alpha; s++) {
            if (len[t][s] < mn) mn = len[t][s];
            if (len[t][s] > mx) mx = len[t][s];
        }
        H.min_len_t[t] = mn;
        // corrupt streams may encode incomplete prefix codes whose
        // walk exits past mx; keep base defined there and bounds-
        // check the perm index at use sites
        for (int l = 0; l < 25; l++) H.base[t][l] = 0;
        int pp = 0;
        for (int l = mn; l <= mx; l++)
            for (int s = 0; s < alpha; s++)
                if (len[t][s] == l) H.perm[t][pp++] = s;
        int32_t cnt[25] = {0};
        for (int s = 0; s < alpha; s++) cnt[len[t][s]]++;
        int vec = 0, rank = 0;
        for (int l = mn; l <= mx; l++) {
            H.base[t][l] = vec - rank;
            rank += cnt[l];
            vec += cnt[l];
            H.limit[t][l] = vec - 1;
            vec <<= 1;
        }
        for (int l = mx + 1; l < 25; l++) H.limit[t][l] = 0x7FFFFFFF;
    }
    // fast Huffman decode LUT: a 10-bit window resolves most codes
    // in one lookup (entry = (sym << 5) | len; 0xFFFF = longer code,
    // take the canonical limit/base walk)
    constexpr int kLut = BlockHead::kLut;
    static thread_local uint16_t lut[6][1 << kLut];
    H.lut = lut;
    for (int t = 0; t < H.n_groups; t++) {
        for (int w = 0; w < (1 << kLut); w++) {
            int l = H.min_len_t[t];
            uint16_t e = 0xFFFF;
            while (l <= kLut) {
                int32_t v = w >> (kLut - l);
                if (v <= H.limit[t][l]) {
                    int32_t pi = v - H.base[t][l];
                    if (pi >= 0 && pi < alpha)
                        e = (uint16_t)((H.perm[t][pi] << 5) | l);
                    break;  // out-of-range: leave 0xFFFF -> slow path
                }
                l++;
            }
            lut[t][w] = e;
        }
    }
    return 0;
}

// Decode the next coded symbol of table t, or -1 on malformed input.
static inline int next_symbol(BitReader& br, const BlockHead& H, int t,
                              int64_t total_bits) {
    uint16_t e = H.lut[t][br.peek(BlockHead::kLut)];
    if (e != 0xFFFF) {
        br.pos += e & 31;
        if (br.pos > total_bits) {
            br.ok = false;  // ran past the input: truncation, not data error
            return -1;
        }
        return e >> 5;
    }
    int l = H.min_len_t[t];
    int32_t v = br.read(l);
    while (v > H.limit[t][l]) {
        v = (v << 1) | br.bit();
        l++;
        if (l > 23 || !br.ok) return -1;
    }
    int32_t pi = v - H.base[t][l];
    if (pi < 0 || pi >= H.alpha) return -1;  // incomplete code
    return H.perm[t][pi];
}

// Decode one block whose 48-bit magic has already been consumed; appends
// at out+out_len, returns the appended byte count or -1 (malformed),
// -2 (capacity), -3 (CRC).  *crc_out receives the verified block CRC.
static int64_t dec_block(BitReader& br, int64_t max_block, uint8_t* out,
                         int64_t out_cap, int64_t out_len,
                         uint32_t* crc_out) {
    // scratch for one block (allocated once per thread, reused)
    static thread_local uint8_t* tt = nullptr;      // bwt last column
    static thread_local int32_t* lf = nullptr;      // LF mapping
    static thread_local int64_t tt_cap = 0;
    if (tt_cap < max_block) {
        delete[] tt;
        delete[] lf;
        tt = new uint8_t[max_block];
        lf = new int32_t[max_block];
        tt_cap = max_block;
    }
    const int64_t out_start = out_len;
    {
        BlockHead H;
        if (parse_block_head(br, H) < 0) return -1;
        const uint32_t block_crc = H.block_crc;
        const uint32_t orig_ptr = H.orig_ptr;
        const int n_in_use = H.n_in_use;
        const uint8_t* seq_to_byte = H.seq_to_byte;
        const int n_sel = H.n_sel;
        const uint8_t* sels = H.sels;
        const int64_t total_bits = br.nbytes * 8;
        // symbol loop: inverse RLE2 + MTF straight into tt[]
        int eob = H.alpha - 1;
        uint8_t mtf[256];
        for (int i = 0; i < n_in_use; i++) mtf[i] = seq_to_byte[i];
        int64_t nblock = 0;
        int64_t run = 0, run_w = 1;
        int g = -1, gpos = 0;
        for (;;) {
            if (gpos == 0) {
                g++;
                if (g >= n_sel) return -1;
                gpos = 50;
            }
            gpos--;
            int sym = next_symbol(br, H, sels[g], total_bits);
            if (sym < 0) return -1;
            if (sym == eob) break;
            if (sym <= 1) {  // RUNA/RUNB
                run += run_w << sym;
                run_w <<= 1;
                continue;
            }
            if (run) {
                if (nblock + run > max_block) return -1;
                memset(tt + nblock, mtf[0], (size_t)run);
                nblock += run;
                run = 0;
            }
            run_w = 1;
            int j = sym - 1;
            uint8_t ch = mtf[j];
            memmove(mtf + 1, mtf, (size_t)j);
            mtf[0] = ch;
            if (nblock >= max_block) return -1;
            tt[nblock++] = ch;
        }
        if (run) {
            if (nblock + run > max_block) return -1;
            memset(tt + nblock, mtf[0], (size_t)run);
            nblock += run;
        }
        if ((int64_t)orig_ptr >= nblock) return -1;
        // inverse BWT: LF mapping then backwards walk.  The walk is one
        // dependent random access per step; packing (lf << 8) | symbol
        // into a single word halves the cache lines touched vs separate
        // symbol/lf arrays (nblock < 2^20 so lf fits 24 bits).
        int64_t cnt_b[256] = {0};
        for (int64_t i2 = 0; i2 < nblock; i2++) cnt_b[tt[i2]]++;
        int64_t starts[256];
        int64_t acc = 0;
        for (int c = 0; c < 256; c++) {
            starts[c] = acc;
            acc += cnt_b[c];
        }
        int64_t occ[256] = {0};
        for (int64_t i2 = 0; i2 < nblock; i2++) {
            uint32_t dest = (uint32_t)(starts[tt[i2]] + occ[tt[i2]]++);
            lf[i2] = (int32_t)((dest << 8) | tt[i2]);
        }
        // walk LF from orig_ptr: emits original bytes back-to-front;
        // then RLE1-decode forward.  Decode into a temp (reuse lf? no —
        // emit into a scratch byte buffer).
        static thread_local uint8_t* pre = nullptr;
        static thread_local int64_t pre_cap = 0;
        if (pre_cap < max_block) {
            delete[] pre;
            pre = new uint8_t[max_block];
            pre_cap = max_block;
        }
        {
            uint32_t w = (uint32_t)lf[orig_ptr];
            for (int64_t i2 = nblock - 1; i2 >= 0; i2--) {
                pre[i2] = (uint8_t)w;
                w = (uint32_t)lf[w >> 8];
            }
        }
        if (H.randomised) derandomize(pre, nblock);
        // RLE1 decode + CRC
        uint32_t crc = 0xFFFFFFFFu;
        int64_t i2 = 0;
        while (i2 < nblock) {
            uint8_t c = pre[i2];
            int64_t j2 = i2 + 1;
            while (j2 < nblock && j2 < i2 + 4 && pre[j2] == c) j2++;
            int64_t rep = j2 - i2;
            if (rep == 4) {
                if (j2 >= nblock) return -1;
                rep = 4 + pre[j2];
                i2 = j2 + 1;
            } else {
                i2 = j2;
            }
            if (out_len + rep > out_cap) return -2;
            memset(out + out_len, c, (size_t)rep);
            out_len += rep;
            for (int64_t k = 0; k < rep; k++)
                crc = (crc << 8) ^ g_crc_table[((crc >> 24) ^ c) & 0xFF];
        }
        crc ^= 0xFFFFFFFFu;
        if (crc != block_crc) return -3;
        *crc_out = block_crc;
        return out_len - out_start;
    }
}

}  // namespace

// Whole-input decode with stdlib-bz2.decompress semantics (CPython
// Lib/bz2.py decompress): decode a CONCATENATION of streams; after at
// least one complete stream, trailing data that errors out (bad header,
// bad magic, data/CRC error) is silently ignored, but a stream that is
// merely TRUNCATED (input exhausted before its end-of-stream marker)
// is an error wherever it sits.  Input being fully consumed is thereby
// verified: anything after the last stream's CRC is either another
// stream, ignorable junk, or padding bits.
int64_t s3_bz2_decompress(const uint8_t* in, int64_t in_len, uint8_t* out,
                          int64_t out_cap) {
    crc_init();
    int64_t committed = 0;  // output through the last complete stream
    int64_t stream_at = 0;  // byte offset of the current stream header
    bool first = true;
    for (;;) {
        if (in_len - stream_at < 4 || in[stream_at] != 'B' ||
            in[stream_at + 1] != 'Z' || in[stream_at + 2] != 'h') {
            if (first) return -1;
            return committed;  // trailing junk after a valid stream
        }
        int level = in[stream_at + 3] - '0';
        if (level < 1 || level > 9) {
            if (first) return -1;
            return committed;
        }
        BitReader br{in, in_len};
        br.pos = (stream_at + 4) * 8;
        int64_t out_len = committed;
        uint32_t combined = 0;
        const int64_t max_block = 100000LL * level + 64;
        for (;;) {
            uint64_t magic = br.read48();
            if (!br.ok) return -1;  // truncated: error even in later streams
            if (magic == 0x177245385090ULL) {
                uint32_t stored = br.read(32);
                if (!br.ok) return -1;
                if (stored != combined) {
                    if (first) return -3;
                    return committed;
                }
                committed = out_len;
                break;
            }
            if (magic != 0x314159265359ULL) {
                if (first) return -1;
                return committed;
            }
            uint32_t crc;
            int64_t added = dec_block(br, max_block, out, out_cap, out_len, &crc);
            if (added == -2) return -2;  // output capacity: caller regrows
            if (added < 0) {
                if (first || !br.ok) return added;
                return committed;  // data error in a later stream: ignore it
            }
            out_len += added;
            combined = ((combined << 1) | (combined >> 31)) ^ crc;
        }
        first = false;
        stream_at = (br.pos + 7) / 8;  // padding bits belong to this stream
        if (stream_at >= in_len) return committed;
    }
}

// ---------------------------------------------------------------------------
// Decode a single block at a known absolute bit offset (from the
// archive's per-stream block index, metadata block_bit_offsets — the
// data the reference's patched block-close callback existed to record).
// Returns the decoded byte count; fills *crc_out.  The entry point for
// block-parallel stream decode.
// ---------------------------------------------------------------------------
int64_t s3_bz2_decode_block(const uint8_t* in, int64_t in_len,
                            int64_t bit_offset, uint8_t* out,
                            int64_t out_cap, uint32_t* crc_out) {
    crc_init();
    if (in_len < 14 || in[0] != 'B' || in[1] != 'Z' || in[2] != 'h') return -1;
    int level = in[3] - '0';
    if (level < 1 || level > 9) return -1;
    BitReader br{in, in_len};
    br.pos = bit_offset;
    if (br.read48() != 0x314159265359ULL || !br.ok) return -1;
    const int64_t max_block = 100000LL * level + 64;
    return dec_block(br, max_block, out, out_cap, 0, crc_out);
}

// Parse one block down to its Huffman-decoded RLE2 symbol stream WITHOUT
// inverting RLE2/MTF/BWT — the host-sequential half of device-pipeline
// decode (the inverses run batched on the TPU; behavioral spec:
// starch3_tpu/codec/decoder.py read_block_symbols).  ``bit_offset``
// addresses the block's 48-bit magic inside the whole stream.  Writes
// the symbols (EOB excluded) to syms_out, the 256-entry used-byte map
// to in_use_out, and the bit position just past the coded data (i.e.
// of the next block's magic) to *bitpos_out.  Returns the symbol count,
// -1 on malformed input, -2 if syms_cap is too small.
int64_t s3_read_block_symbols(const uint8_t* in, int64_t in_len,
                              int64_t bit_offset, uint16_t* syms_out,
                              int64_t syms_cap, uint8_t* in_use_out,
                              uint32_t* crc_out, int32_t* ptr_out,
                              int64_t* bitpos_out, uint8_t* rand_out) {
    BitReader br{in, in_len};
    br.pos = bit_offset;
    if (br.read48() != 0x314159265359ULL || !br.ok) return -1;
    BlockHead H;
    if (parse_block_head(br, H) < 0) return -1;
    for (int i = 0; i < 256; i++) in_use_out[i] = 0;
    for (int i = 0; i < H.n_in_use; i++) in_use_out[H.seq_to_byte[i]] = 1;
    *crc_out = H.block_crc;
    *ptr_out = (int32_t)H.orig_ptr;
    *rand_out = H.randomised ? 1 : 0;
    const int64_t total_bits = br.nbytes * 8;
    const int eob = H.alpha - 1;
    int64_t m = 0;
    int g = -1, gpos = 0;
    for (;;) {
        if (gpos == 0) {
            g++;
            if (g >= H.n_sel) return -1;
            gpos = 50;
        }
        gpos--;
        int sym = next_symbol(br, H, H.sels[g], total_bits);
        if (sym < 0) return -1;
        if (sym == eob) break;
        if (m >= syms_cap) return -2;
        syms_out[m++] = (uint16_t)sym;
    }
    *bitpos_out = br.pos;
    return m;
}

// ---------------------------------------------------------------------------
// bzip2's MSB-first CRC-32 of a whole buffer (init 0xFFFFFFFF, final
// inversion), slice-by-8: eight table lookups fold 8 bytes per step.
// Behavioral spec: codec/crc32.crc32_bytes.
// ---------------------------------------------------------------------------
uint32_t s3_crc32(const uint8_t* p, int64_t n) {
    crc_init();
    uint32_t crc = 0xFFFFFFFFu;
    while (n >= 8) {
        uint32_t hi;
        memcpy(&hi, p, 4);
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_BIG_ENDIAN__
        // bytes already arrive MSB-first in the register
#else
        hi = __builtin_bswap32(hi);
#endif
        hi ^= crc;
        crc = g_crc_slice[7][hi >> 24] ^ g_crc_slice[6][(hi >> 16) & 0xFF] ^
              g_crc_slice[5][(hi >> 8) & 0xFF] ^ g_crc_slice[4][hi & 0xFF] ^
              g_crc_slice[3][p[4]] ^ g_crc_slice[2][p[5]] ^
              g_crc_slice[1][p[6]] ^ g_crc_slice[0][p[7]];
        p += 8;
        n -= 8;
    }
    while (n-- > 0)
        crc = (crc << 8) ^ g_crc_table[((crc >> 24) ^ *p++) & 0xFF];
    return ~crc;
}

// ---------------------------------------------------------------------------
// Fused BED parse + Starch delta transform (the native consolidation of
// bed/parser.parse_bed + transform/delta.transform_chrom; behavioral spec
// and reference citations live there).  One pass over the input text
// produces every chromosome's transformed stream plus its metadata
// statistics (line count, non-unique = sum of interval lengths, unique =
// union length).  Returns the number of chromosome groups (contiguous
// runs; the caller checks for duplicate names), -1 on any parse error
// (caller falls back to the NumPy path for exact diagnostics), -2 on
// capacity overflow.
// ---------------------------------------------------------------------------
namespace {

static inline int64_t dec_len_i64(int64_t v) {
    uint64_t m = v < 0 ? (uint64_t)(-v) : (uint64_t)v;
    int64_t d = 1;
    while (m >= 10) {
        m /= 10;
        d++;
    }
    return d + (v < 0 ? 1 : 0);
}

static inline uint8_t* emit_i64(uint8_t* o, int64_t v) {
    if (v < 0) {
        *o++ = '-';
        v = -v;
    }
    char tmp[20];
    int k = 0;
    do {
        tmp[k++] = (char)('0' + (v % 10));
        v /= 10;
    } while (v);
    while (k) *o++ = (uint8_t)tmp[--k];
    return o;
}

}  // namespace

int64_t s3_bed_transform(const uint8_t* data, int64_t n, uint8_t* out,
                         int64_t out_cap, int64_t max_chroms,
                         int64_t* text_offsets, int64_t* name_offsets,
                         int64_t* name_lens, int64_t* line_counts,
                         int64_t* nonuniq, int64_t* uniq) {
    int64_t o = 0;        // write cursor
    int64_t nc = 0;       // chromosome count
    int64_t i = 0;        // read cursor
    // per-chromosome transform state
    int64_t last_stop = 0, last_diff = 0, lines = 0, nuniq_acc = 0;
    int64_t cur_name_off = -1, cur_name_len = 0;
    // union-length state: intervals usually arrive sorted by start; a
    // running max suffices.  On an order violation the chromosome's slice
    // of the input is re-parsed at close (rare; avoids buffering every
    // interval, which matters at the 100M-record stress scale)
    bool sorted_starts = true;
    int64_t run_max = 0, uniq_acc = 0, prev_start = INT64_MIN;
    int64_t chrom_line_end = 0;  // end of the current chromosome's last line

    auto close_chrom = [&]() -> bool {
        if (cur_name_off < 0) return true;
        if (nc >= max_chroms) return false;
        name_offsets[nc] = cur_name_off;
        name_lens[nc] = cur_name_len;
        line_counts[nc] = lines;
        nonuniq[nc] = nuniq_acc;
        if (!sorted_starts) {
            // rare: re-parse this chromosome's lines, stable-sort by
            // start, re-derive the union length
            std::vector<int64_t> ss, ee;
            ss.reserve((size_t)lines);
            ee.reserve((size_t)lines);
            int64_t q = cur_name_off;
            while (q < chrom_line_end) {
                const uint8_t* nl2 = (const uint8_t*)memchr(
                    data + q, '\n', (size_t)(chrom_line_end - q));
                int64_t le2 = nl2 ? (int64_t)(nl2 - data) : chrom_line_end;
                if (le2 > q) {
                    const uint8_t* ta = (const uint8_t*)memchr(
                        data + q, '\t', (size_t)(le2 - q));
                    int64_t a = (int64_t)(ta - data) + 1;
                    int64_t v = 0;
                    bool neg = data[a] == '-';
                    if (neg) a++;
                    while (data[a] != '\t') v = v * 10 + (data[a++] - '0');
                    int64_t s = neg ? -v : v;
                    a++;
                    v = 0;
                    neg = data[a] == '-';
                    if (neg) a++;
                    while (a < le2 && data[a] != '\t')
                        v = v * 10 + (data[a++] - '0');
                    ss.push_back(s);
                    ee.push_back(neg ? -v : v);
                }
                q = le2 + 1;
            }
            std::vector<int64_t> idx(ss.size());
            for (size_t k = 0; k < idx.size(); k++) idx[k] = (int64_t)k;
            std::stable_sort(idx.begin(), idx.end(),
                             [&](int64_t a, int64_t b) {
                                 return ss[(size_t)a] < ss[(size_t)b];
                             });
            int64_t run = ss[(size_t)idx[0]];
            uniq_acc = 0;
            for (size_t k = 0; k < idx.size(); k++) {
                int64_t s = ss[(size_t)idx[k]];
                int64_t e = ee[(size_t)idx[k]];
                int64_t lo = s > run ? s : run;
                if (e > lo) uniq_acc += e - lo;
                if (e > run) run = e;
            }
        }
        uniq[nc] = uniq_acc;
        nc++;
        text_offsets[nc] = o;
        return true;
    };

    text_offsets[0] = 0;
    while (i < n) {
        // line bounds
        const uint8_t* nl =
            (const uint8_t*)memchr(data + i, '\n', (size_t)(n - i));
        int64_t le = nl ? (int64_t)(nl - data) : n;
        if (le == i) {  // empty line
            i = le + 1;
            continue;
        }
        // fields: chrom \t start \t stop [\t remainder]
        const uint8_t* t1 =
            (const uint8_t*)memchr(data + i, '\t', (size_t)(le - i));
        if (!t1) return -1;
        int64_t p1 = (int64_t)(t1 - data);
        if (p1 == i) return -1;  // empty chromosome
        const uint8_t* t2 = (const uint8_t*)memchr(
            data + p1 + 1, '\t', (size_t)(le - p1 - 1));
        if (!t2) return -1;
        int64_t p2 = (int64_t)(t2 - data);
        const uint8_t* t3 = (const uint8_t*)memchr(
            data + p2 + 1, '\t', (size_t)(le - p2 - 1));
        int64_t p3 = t3 ? (int64_t)(t3 - data) : le;
        // parse start/stop
        int64_t start, stop;
        {
            int64_t p = p1 + 1, e = p2;
            if (p >= e) return -1;
            bool neg = data[p] == '-';
            if (neg) p++;
            if (p >= e || e - p > 19) return -1;
            int64_t v = 0;
            for (; p < e; p++) {
                uint8_t d = data[p] - '0';
                if (d > 9) return -1;
                v = v * 10 + d;
            }
            start = neg ? -v : v;
            p = p2 + 1;
            e = p3;
            if (p >= e) return -1;
            neg = data[p] == '-';
            if (neg) p++;
            if (p >= e || e - p > 19) return -1;
            v = 0;
            for (; p < e; p++) {
                uint8_t d = data[p] - '0';
                if (d > 9) return -1;
                v = v * 10 + d;
            }
            stop = neg ? -v : v;
        }
        // chromosome boundary?
        int64_t nm_len = p1 - i;
        if (cur_name_off < 0 || nm_len != cur_name_len ||
            memcmp(data + i, data + cur_name_off, (size_t)nm_len) != 0) {
            if (!close_chrom()) return -2;
            cur_name_off = i;
            cur_name_len = nm_len;
            last_stop = 0;
            last_diff = 0;
            lines = 0;
            nuniq_acc = 0;
            uniq_acc = 0;
            sorted_starts = true;
            prev_start = INT64_MIN;
            run_max = 0;
        }
        // transform this record
        int64_t coord_diff = stop - start;
        int64_t rem_len = p3 < le ? le - (p3 + 1) : 0;
        // capacity: p-line (<=22) + delta (<=21) + tab + rem + nl
        if (o + 46 + rem_len > out_cap) return -2;
        uint8_t* w = out + o;
        if (coord_diff != last_diff) {
            *w++ = 'p';
            w = emit_i64(w, coord_diff);
            *w++ = '\n';
            last_diff = coord_diff;
        }
        w = emit_i64(w, last_stop == 0 ? start : start - last_stop);
        if (rem_len > 0) {
            *w++ = '\t';
            memcpy(w, data + p3 + 1, (size_t)rem_len);
            w += rem_len;
        }
        *w++ = '\n';
        o = (int64_t)(w - out);
        last_stop = stop;
        lines++;
        nuniq_acc += coord_diff;
        // union-length streaming (sorted fast path)
        if (start < prev_start) sorted_starts = false;
        prev_start = start;
        if (sorted_starts) {
            int64_t lo = lines == 1 ? start : (start > run_max ? start : run_max);
            if (stop > lo) uniq_acc += stop - lo;
            if (lines == 1 || stop > run_max) run_max = stop;
        }
        chrom_line_end = le;
        i = le + 1;
    }
    if (!close_chrom()) return -2;
    return nc;
}

// ---------------------------------------------------------------------------
// Fused inverse transform + BED emission (decode-side counterpart of
// s3_bed_transform; behavioral spec in transform/delta.untransform_chrom
// + bed/writer.write_bed_chrom): one pass over a chromosome's
// transformed text reconstructs coordinates from the delta/p-line chain
// (stop_i = stop_{i-1} + delta_i + diff_i, stop_{-1} = 0) and writes
// BED lines directly.  Returns bytes written, -1 on malformed text
// (caller falls back to the NumPy path for exact diagnostics), -2 on
// capacity overflow.  *n_records_out receives the data-line count.
// ---------------------------------------------------------------------------
int64_t s3_untransform_bed(const uint8_t* text, int64_t n,
                           const uint8_t* chrom, int64_t chrom_len,
                           uint8_t* out, int64_t out_cap,
                           int64_t* n_records_out) {
    if (n <= 0 || text[n - 1] != '\n') return -1;
    int64_t i = 0, o = 0, records = 0;
    int64_t stop = 0, diff = 0;
    while (i < n) {
        const uint8_t* nl =
            (const uint8_t*)memchr(text + i, '\n', (size_t)(n - i));
        int64_t le = (int64_t)(nl - text);  // always found (text ends \n)
        if (le == i) return -1;             // empty line
        if (text[i] == 'p') {
            int64_t p = i + 1;
            if (p >= le) return -1;
            bool neg = text[p] == '-';
            if (neg) p++;
            if (p >= le || le - p > 19) return -1;
            int64_t v = 0;
            for (; p < le; p++) {
                uint8_t d = text[p] - '0';
                if (d > 9) return -1;
                v = v * 10 + d;
            }
            diff = neg ? -v : v;
            i = le + 1;
            continue;
        }
        const uint8_t* tb =
            (const uint8_t*)memchr(text + i, '\t', (size_t)(le - i));
        int64_t de = tb ? (int64_t)(tb - text) : le;
        int64_t p = i;
        bool neg = text[p] == '-';
        if (neg) p++;
        if (p >= de || de - p > 19) return -1;
        int64_t v = 0;
        for (; p < de; p++) {
            uint8_t d = text[p] - '0';
            if (d > 9) return -1;
            v = v * 10 + d;
        }
        int64_t delta = neg ? -v : v;
        stop += delta + diff;
        int64_t start = stop - diff;
        int64_t rem_len = tb ? le - (de + 1) : 0;
        // worst case: 2 signed 20-digit coords + 2 tabs + rem tab + nl
        if (o + chrom_len + 46 + rem_len > out_cap) return -2;
        uint8_t* w = out + o;
        memcpy(w, chrom, (size_t)chrom_len);
        w += chrom_len;
        *w++ = '\t';
        w = emit_i64(w, start);
        *w++ = '\t';
        w = emit_i64(w, stop);
        if (rem_len > 0) {
            *w++ = '\t';
            memcpy(w, text + de + 1, (size_t)rem_len);
            w += rem_len;
        }
        *w++ = '\n';
        o = (int64_t)(w - out);
        records++;
        i = le + 1;
    }
    *n_records_out = records;
    return o;
}

// ---------------------------------------------------------------------------
// Full single-block encode: post-RLE1 block bytes -> bzip2 block bitstream
// fragment (unaligned; whole bytes + tail bits, splice-ready for
// codec/bitio.BitWriter.append_writer).  This is the native consolidation
// of codec/encoder.write_block: BWT rotation sort, dense symbol map, MTF,
// RLE2 zero-run coding, the multi-table Huffman refinement of
// codec/huffman.build_plan (the behavioral spec, validated bit-for-bit
// against libbz2), and MSB-first serialization — one C call per block so
// a thread pool over blocks scales without Python in the loop.
// Returns whole bytes written, or -1 (capacity/error).
// ---------------------------------------------------------------------------
namespace {

struct BitW {
    uint8_t* out;
    int64_t cap;
    int64_t n = 0;
    uint64_t reg = 0;
    int live = 0;
    bool ok = true;
    inline void put(uint64_t v, int nb) {
        if (nb == 0) return;
        reg = (reg << nb) | (v & ((1ULL << nb) - 1));
        live += nb;
        while (live >= 8) {
            live -= 8;
            if (n >= cap) {
                ok = false;
                return;
            }
            out[n++] = (uint8_t)(reg >> live);
        }
        reg &= (1ULL << live) - 1;
    }
};

}  // namespace

int64_t s3_encode_tail(const uint16_t* syms, int64_t n_mtf,
                       const int64_t* freq_in, int32_t n_in_use,
                       const uint8_t* in_use_u8, int64_t orig_ptr,
                       uint32_t crc, uint8_t* out, int64_t out_cap,
                       uint64_t* tail, int32_t* tail_nbits);

int64_t s3_encode_block(const uint8_t* block, int64_t n, uint32_t crc,
                        uint8_t* out, int64_t out_cap, uint64_t* tail,
                        int32_t* tail_nbits) {
    if (n <= 0) return -1;
    // --- BWT rotation sort ------------------------------------------------
    std::vector<uint8_t> last((size_t)n);
    int64_t orig_ptr = s3_bwt(block, n, last.data());
    if (orig_ptr < 0) return -1;
    // --- dense symbol map -------------------------------------------------
    uint8_t map[256];
    bool in_use[256] = {false};
    for (int64_t i = 0; i < n; i++) in_use[last[i]] = true;
    int n_in_use = 0;
    for (int c = 0; c < 256; c++)
        if (in_use[c]) map[c] = (uint8_t)n_in_use++;
    // --- MTF ranks (dense alphabet) ----------------------------------------
    // Transformed delta text uses ~14 distinct bytes (digits, tab, newline,
    // 'p', '-'), so the whole MTF list usually fits one 16-byte vector:
    // position = compare+movemask, list update = one pshufb through a
    // per-rank rotate-front permutation.  Larger alphabets (remainder
    // columns) take the find+memmove path.
    std::vector<uint8_t> ranks((size_t)n);
#if defined(__SSSE3__)
    if (n_in_use <= 16) {
        // perm[j]: new[0]=old[j], new[k]=old[k-1] for k<=j, else old[k]
        alignas(16) uint8_t perm[16][16];
        for (int j = 0; j < 16; j++) {
            perm[j][0] = (uint8_t)j;
            for (int k = 1; k < 16; k++)
                perm[j][k] = (uint8_t)(k <= j ? k - 1 : k);
        }
        alignas(16) const uint8_t iota[16] = {0, 1, 2,  3,  4,  5,  6,  7,
                                              8, 9, 10, 11, 12, 13, 14, 15};
        __m128i list = _mm_load_si128((const __m128i*)iota);
        for (int64_t i = 0; i < n; i++) {
            uint8_t s = map[last[i]];
            __m128i needle = _mm_set1_epi8((char)s);
            int m = _mm_movemask_epi8(_mm_cmpeq_epi8(list, needle));
            int j = __builtin_ctz((unsigned)m);  // s is always present
            ranks[i] = (uint8_t)j;
            if (j)
                list = _mm_shuffle_epi8(list, _mm_load_si128((const __m128i*)perm[j]));
        }
    } else
#endif
    {
        uint8_t list[256];
        for (int i = 0; i < n_in_use; i++) list[i] = (uint8_t)i;
        for (int64_t i = 0; i < n; i++) {
            uint8_t s = map[last[i]];
            if (list[0] == s) {
                ranks[i] = 0;
                continue;
            }
            int j = (int)((uint8_t*)memchr(list, s, (size_t)n_in_use) - list);
            memmove(list + 1, list, (size_t)j);
            list[0] = s;
            ranks[i] = (uint8_t)j;
        }
    }
    // --- RLE2 symbol stream ----------------------------------------------
    std::vector<uint16_t> syms((size_t)(n + 2));
    int64_t freq[258];
    int64_t n_mtf =
        s3_rle2_from_ranks(ranks.data(), n, n_in_use, syms.data(), freq);
    uint8_t in_use_u8[256];
    for (int c = 0; c < 256; c++) in_use_u8[c] = in_use[c] ? 1 : 0;
    return s3_encode_tail(syms.data(), n_mtf, freq, n_in_use, in_use_u8,
                          orig_ptr, crc, out, out_cap, tail, tail_nbits);
}

// Block tail from precomputed RLE2 symbols: the Huffman refinement +
// serialization half of s3_encode_block, callable directly with the
// device pipeline's downloads (symbol stream + histogram + used map +
// origPtr) so the host's per-block work in the JAX path runs at native
// speed (the NumPy tail costs ~90 ms per 900 kB block; this runs it in
// a few ms and releases the GIL under the drain thread pool).
int64_t s3_encode_tail(const uint16_t* syms, int64_t n_mtf,
                       const int64_t* freq_in, int32_t n_in_use,
                       const uint8_t* in_use_u8, int64_t orig_ptr,
                       uint32_t crc, uint8_t* out, int64_t out_cap,
                       uint64_t* tail, int32_t* tail_nbits) {
    if (n_mtf <= 0 || n_in_use <= 0 || n_in_use > 256) return -1;
    const int alpha = n_in_use + 2;
    // reject out-of-range symbols up front: this entry takes data from
    // the device pipeline, and a mis-unpacked stream must fail loudly
    // (return -1 -> caller falls back), never index out of bounds
    for (int64_t i = 0; i < n_mtf; i++)
        if (syms[i] >= alpha) return -1;
    bool in_use[256];
    for (int c = 0; c < 256; c++) in_use[c] = in_use_u8[c] != 0;
    int64_t freq[258];
    for (int s = 0; s < 258; s++) freq[s] = s < alpha ? freq_in[s] : 0;
    // --- Huffman plan: initial contiguous frequency-mass split ------------
    int n_groups = n_mtf < 200 ? 2
                 : n_mtf < 600 ? 3
                 : n_mtf < 1200 ? 4
                 : n_mtf < 2400 ? 5
                                : 6;
    int32_t len[6][258];
    {
        int64_t rem_f = n_mtf;
        int gs = 0;
        for (int n_part = n_groups; n_part >= 1; n_part--) {
            int64_t t_freq = rem_f / n_part;
            int ge = gs - 1;
            int64_t a_freq = 0;
            while (a_freq < t_freq && ge < alpha - 1) {
                ge++;
                a_freq += freq[ge];
            }
            if (ge > gs && n_part != n_groups && n_part != 1 &&
                ((n_groups - n_part) % 2 == 1)) {
                a_freq -= freq[ge];
                ge--;
            }
            for (int s = 0; s < alpha; s++)
                len[n_part - 1][s] = (s >= gs && s <= ge) ? 0 : 15;
            gs = ge + 1;
            rem_f -= a_freq;
        }
    }
    // --- 4 refinement iterations -----------------------------------------
    const int64_t n_sel = (n_mtf + 49) / 50;
    std::vector<uint8_t> sels((size_t)n_sel);
    int64_t rfreq[6][258];
#if defined(__SSSE3__)
    // Small alphabets (the delta-text case): materialize each 50-symbol
    // group's frequency histogram once, then every iteration's group cost
    // is four maddubs (u8 counts x s8 lengths) per table instead of a
    // 50-symbol walk, and the winning table's rfreq update is alpha adds
    // instead of 50.  Identical integer sums -> identical selectors.
    const bool use_ghist = alpha <= 64;
    std::vector<uint8_t> ghist;
    if (use_ghist) {
        ghist.assign((size_t)n_sel * 64, 0);
        for (int64_t g = 0; g < n_sel; g++) {
            uint8_t* h = ghist.data() + (size_t)g * 64;
            const int64_t b = g * 50;
            const int64_t e = b + 50 < n_mtf ? b + 50 : n_mtf;
            for (int64_t i = b; i < e; i++) h[syms[(size_t)i]]++;
        }
    }
#endif
    for (int it = 0; it < 4; it++) {
        for (int t = 0; t < n_groups; t++)
            for (int s = 0; s < alpha; s++) rfreq[t][s] = 0;
#if defined(__SSSE3__)
        if (use_ghist) {
            alignas(16) int8_t len8[6][64];
            for (int t = 0; t < n_groups; t++) {
                memset(len8[t], 0, 64);
                for (int s = 0; s < alpha; s++) len8[t][s] = (int8_t)len[t][s];
            }
            const __m128i ones = _mm_set1_epi16(1);
            for (int64_t g = 0; g < n_sel; g++) {
                const uint8_t* h = ghist.data() + (size_t)g * 64;
                __m128i h0 = _mm_loadu_si128((const __m128i*)(h + 0));
                __m128i h1 = _mm_loadu_si128((const __m128i*)(h + 16));
                __m128i h2 = _mm_loadu_si128((const __m128i*)(h + 32));
                __m128i h3 = _mm_loadu_si128((const __m128i*)(h + 48));
                uint32_t cost[6];
                for (int t = 0; t < n_groups; t++) {
                    const __m128i* l = (const __m128i*)len8[t];
                    __m128i acc = _mm_maddubs_epi16(h0, _mm_load_si128(l + 0));
                    acc = _mm_add_epi16(
                        acc, _mm_maddubs_epi16(h1, _mm_load_si128(l + 1)));
                    acc = _mm_add_epi16(
                        acc, _mm_maddubs_epi16(h2, _mm_load_si128(l + 2)));
                    acc = _mm_add_epi16(
                        acc, _mm_maddubs_epi16(h3, _mm_load_si128(l + 3)));
                    // lanes sum to <= 50*17, no i16 overflow; fold to one u32
                    __m128i s32 = _mm_madd_epi16(acc, ones);
                    s32 = _mm_add_epi32(s32, _mm_srli_si128(s32, 8));
                    s32 = _mm_add_epi32(s32, _mm_srli_si128(s32, 4));
                    cost[t] = (uint32_t)_mm_cvtsi128_si32(s32);
                }
                int best = 0;
                for (int t = 1; t < n_groups; t++)
                    if (cost[t] < cost[best]) best = t;
                sels[(size_t)g] = (uint8_t)best;
                int64_t* rf = rfreq[best];
                for (int s = 0; s < alpha; s++) rf[s] += h[s];
            }
        } else
#endif
        {
            // transposed length table: one symbol's table costs live in one
            // 16-byte row, and the fixed 8-lane loop below vectorizes to a
            // single packed uint16 add per symbol (a variable n_groups bound
            // defeats the auto-vectorizer); lanes >= n_groups accumulate
            // zeros and are never read (the argmin scans t < n_groups)
            uint16_t lenT[258][8];
            for (int s = 0; s < alpha; s++) {
                for (int t = 0; t < 8; t++)
                    lenT[s][t] = t < n_groups ? (uint16_t)len[t][s] : 0;
            }
            for (int64_t g = 0; g < n_sel; g++) {
                int64_t b = g * 50;
                int64_t e = b + 50 < n_mtf ? b + 50 : n_mtf;
                uint16_t cost[8] = {0, 0, 0, 0, 0, 0, 0, 0};
                for (int64_t i = b; i < e; i++) {
                    const uint16_t* lt = lenT[syms[(size_t)i]];
                    for (int t = 0; t < 8; t++)
                        cost[t] = (uint16_t)(cost[t] + lt[t]);
                }
                int best = 0;
                for (int t = 1; t < n_groups; t++)
                    if (cost[t] < cost[best]) best = t;
                sels[(size_t)g] = (uint8_t)best;
                int64_t* rf = rfreq[best];
                for (int64_t i = b; i < e; i++) rf[syms[(size_t)i]]++;
            }
        }
        for (int t = 0; t < n_groups; t++)
            if (s3_make_code_lengths(rfreq[t], alpha, 17, len[t]) != 0)
                return -1;
    }
    // --- canonical codes (codeword | length<<24: one load per symbol in
    // the emit loop below) ---------------------------------------------------
    uint32_t codes[6][258];
    for (int t = 0; t < n_groups; t++) {
        int mn = 32, mx = 0;
        for (int s = 0; s < alpha; s++) {
            if (len[t][s] < mn) mn = len[t][s];
            if (len[t][s] > mx) mx = len[t][s];
        }
        uint32_t vec = 0;
        for (int l = mn; l <= mx; l++) {
            for (int s = 0; s < alpha; s++)
                if (len[t][s] == l)
                    codes[t][s] = vec++ | ((uint32_t)l << 24);
            vec <<= 1;
        }
    }
    // --- serialize --------------------------------------------------------
    BitW bw{out, out_cap};
    bw.put(0x314159ULL, 24);
    bw.put(0x265359ULL, 24);
    bw.put(crc, 32);
    bw.put(0, 1);  // randomised: never (1.0.x compressor)
    bw.put((uint64_t)orig_ptr, 24);
    // used-byte map
    uint32_t gmask = 0;
    for (int g = 0; g < 16; g++) {
        bool any = false;
        for (int b = 0; b < 16; b++) any |= in_use[g * 16 + b];
        gmask = (gmask << 1) | (any ? 1 : 0);
    }
    bw.put(gmask, 16);
    for (int g = 0; g < 16; g++) {
        if (!((gmask >> (15 - g)) & 1)) continue;
        uint32_t bits = 0;
        for (int b = 0; b < 16; b++)
            bits = (bits << 1) | (in_use[g * 16 + b] ? 1 : 0);
        bw.put(bits, 16);
    }
    bw.put((uint64_t)n_groups, 3);
    bw.put((uint64_t)n_sel, 15);
    // selectors: MTF then unary
    {
        uint8_t pos[6] = {0, 1, 2, 3, 4, 5};
        for (int64_t i = 0; i < n_sel; i++) {
            uint8_t s = sels[(size_t)i];
            int j = 0;
            while (pos[j] != s) j++;
            for (int t = j; t > 0; t--) pos[t] = pos[t - 1];
            pos[0] = s;
            bw.put((((uint64_t)1 << j) - 1) << 1, j + 1);  // j ones, a zero
        }
    }
    // tables: delta-coded lengths
    for (int t = 0; t < n_groups; t++) {
        int curr = len[t][0];
        bw.put((uint64_t)curr, 5);
        for (int s = 0; s < alpha; s++) {
            while (curr < len[t][s]) {
                bw.put(0b10, 2);
                curr++;
            }
            while (curr > len[t][s]) {
                bw.put(0b11, 2);
                curr--;
            }
            bw.put(0, 1);
        }
    }
    // coded data
    for (int64_t g = 0; g < n_sel; g++) {
        const uint32_t* ct = codes[sels[(size_t)g]];
        const int64_t b = g * 50;
        const int64_t e = b + 50 < n_mtf ? b + 50 : n_mtf;
        for (int64_t i = b; i < e; i++) {
            uint32_t cl = ct[syms[(size_t)i]];
            bw.put(cl & 0xffffff, (int)(cl >> 24));
        }
    }
    if (!bw.ok) return -1;
    *tail = bw.reg;
    *tail_nbits = bw.live;
    return bw.n;
}

// Standalone block-header serializer for the device-Huffman drain: the
// device computed the coded words (ops/bitpack_jax.emit_coded_padded),
// the native heaps the lengths — this writes everything before the
// coded data (magics, CRC, origPtr, used map, selector MTF+unary,
// delta-coded tables) in one GIL-released call.  Python's BitWriter
// header was 82% of the drain's host residue (benchmarks/
// orchestration_ceiling.py huff_residue_rate).  Takes RAW selector ids
// and MTFs them here (same discipline as s3_encode_tail above).
// Returns whole bytes written (+ tail bits out-params), or -1.
int64_t s3_write_block_header(uint32_t crc, int64_t orig_ptr,
                              const uint8_t* in_use_u8, int32_t n_groups,
                              int32_t alpha, const int32_t* lens,
                              const int32_t* sels, int64_t n_sel,
                              uint8_t* out, int64_t out_cap, uint64_t* tail,
                              int32_t* tail_nbits) {
    if (n_groups < 2 || n_groups > 6 || alpha < 3 || alpha > 258 ||
        n_sel <= 0 || n_sel >= (1 << 15) || orig_ptr < 0 ||
        orig_ptr >= (1 << 24))
        return -1;
    for (int64_t i = 0; i < n_sel; i++)
        if (sels[i] < 0 || sels[i] >= n_groups) return -1;
    for (int t = 0; t < n_groups; t++)
        for (int s = 0; s < alpha; s++) {
            int32_t l = lens[(size_t)t * alpha + s];
            if (l < 1 || l > 23) return -1;  // format ceiling on decode
        }
    BitW bw{out, out_cap};
    bw.put(0x314159ULL, 24);
    bw.put(0x265359ULL, 24);
    bw.put(crc, 32);
    bw.put(0, 1);  // randomised: never (1.0.x compressor)
    bw.put((uint64_t)orig_ptr, 24);
    uint32_t gmask = 0;
    for (int g = 0; g < 16; g++) {
        bool any = false;
        for (int b = 0; b < 16; b++) any |= in_use_u8[g * 16 + b] != 0;
        gmask = (gmask << 1) | (any ? 1 : 0);
    }
    bw.put(gmask, 16);
    for (int g = 0; g < 16; g++) {
        if (!((gmask >> (15 - g)) & 1)) continue;
        uint32_t bits = 0;
        for (int b = 0; b < 16; b++)
            bits = (bits << 1) | (in_use_u8[g * 16 + b] ? 1 : 0);
        bw.put(bits, 16);
    }
    bw.put((uint64_t)n_groups, 3);
    bw.put((uint64_t)n_sel, 15);
    {
        uint8_t pos[6] = {0, 1, 2, 3, 4, 5};
        for (int64_t i = 0; i < n_sel; i++) {
            uint8_t s = (uint8_t)sels[(size_t)i];
            int j = 0;
            while (pos[j] != s) j++;
            for (int t = j; t > 0; t--) pos[t] = pos[t - 1];
            pos[0] = s;
            bw.put((((uint64_t)1 << j) - 1) << 1, j + 1);
        }
    }
    for (int t = 0; t < n_groups; t++) {
        int curr = (int)lens[(size_t)t * alpha];
        bw.put((uint64_t)curr, 5);
        for (int s = 0; s < alpha; s++) {
            int want = (int)lens[(size_t)t * alpha + s];
            while (curr < want) {
                bw.put(0b10, 2);
                curr++;
            }
            while (curr > want) {
                bw.put(0b11, 2);
                curr--;
            }
            bw.put(0, 1);
        }
    }
    if (!bw.ok) return -1;
    *tail = bw.reg;
    *tail_nbits = bw.live;
    return bw.n;
}

// Distinct-byte count for feed-time alphabet classing
// (pipeline._split_classify -> _bits_class): replaces a NumPy bincount
// pass per block (~2.2 ns/byte incl. Python glue) with one table
// store per byte.  Four interleaved tables break the store-to-load
// dependence on repeated bytes.
int32_t s3_count_distinct(const uint8_t* p, int64_t n) {
    uint8_t seen[4][256] = {};
    int64_t i = 0;
    for (; i + 4 <= n; i += 4) {
        seen[0][p[i]] = 1;
        seen[1][p[i + 1]] = 1;
        seen[2][p[i + 2]] = 1;
        seen[3][p[i + 3]] = 1;
    }
    for (; i < n; i++) seen[0][p[i]] = 1;
    int32_t c = 0;
    for (int k = 0; k < 256; k++)
        c += (seen[0][k] | seen[1][k] | seen[2][k] | seen[3][k]);
    return c;
}

// Bit-shifted splice for stream assembly: merge a byte stream onto a
// writer whose live bit count is `nbits` (1..7).  out[i] =
// (prev << (8-nbits)) | (src[i] >> nbits) with prev chaining from
// `acc`; returns the new accumulator (src's last byte, masked).  One
// 64-bit-word pass replaces the assembler's multi-pass NumPy shift
// (codec/bitio.append_writer) — fragment concatenation was the
// measured ~3 GB/s serial assembly ceiling (docs/PERF.md
// "Orchestration ceiling"; reference behavior: sequential bsW writes
// in the bundled bzip2's bzlib.c, which never needed a splice because
// it never parallelized block production).
int64_t s3_append_shifted(const uint8_t* src, int64_t n, int32_t nbits,
                          uint64_t acc, uint8_t* out) {
    if (nbits <= 0 || nbits >= 8 || n <= 0) return -1;
    const int L = nbits;
    const uint64_t mask = ((uint64_t)1 << L) - 1;
    uint64_t carry = acc & mask;  // L live bits waiting for their tail
    int64_t i = 0;
    // word loop: treat 8 source bytes as a big-endian u64; the merged
    // word is (carry:L | x>>L) and the new carry is x's low L bits
    for (; i + 8 <= n; i += 8) {
        uint64_t x;
        memcpy(&x, src + i, 8);
        x = __builtin_bswap64(x);
        uint64_t y = (carry << (64 - L)) | (x >> L);
        carry = x & mask;
        y = __builtin_bswap64(y);
        memcpy(out + i, &y, 8);
    }
    for (; i < n; i++) {
        uint8_t x = src[i];
        out[i] = (uint8_t)((carry << (8 - L)) | (x >> L));
        carry = x & mask;
    }
    return (int64_t)carry;
}

}  // extern "C"
