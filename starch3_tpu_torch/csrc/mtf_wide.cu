// Windowed MTF ranks on Hopper (sm_90a), widths 32, 64, 128 and 256: the
// MTF of the bits 5, 6 and 8 tiers.  Width 16 (bits 4) is csrc/mtf_narrow.cu.
//
// Replaces the Pallas kernels of starch3_tpu/ops/mtf_pallas.py:
// _make_mtf_kernel_batch + _mtf_tile (launched by mtf_ranks_pallas_batch,
// widths 128 and 256) and _mtf_kernel (mtf_ranks_pallas, one row at width
// 256, which is this kernel at batch 1), and at widths 32 and 64 the
// kernel of starch3_tpu/ops/mtf_narrow_pallas.py (_make_kernel, launched
// by mtf_ranks_narrow_batch).  Same function: int32[B, n_max] dense
// symbols < W -> int32[B, n_max] MTF ranks, where
// rank(i) = #{s : last[s] > last[seq[i]]}, last[s] is the last occurrence
// of s before i, and unseen symbols start at L0(s) = -1 - s.  A symbol
// outside [0, W), negative ones included, matches no table entry: its
// rank is W and it changes nothing, as in _mtf_tile.  Each row starts
// afresh.
//
// Why not the Pallas layout: the TPU kernels walk a row in grid order and
// carry a last-occurrence table from one grid step to the next in VMEM.
// CUDA blocks run in no order, so the carry is made explicit.  Max is
// associative, so the table at any position is the max of L0 and the
// tables of everything before it:
//
//   pass 1 (chunk_last_kernel): one block per 1024-position chunk writes
//     the chunk's own last-occurrence table, tables[B, T, W]; at W <= 64
//     (chunk_last_warp_kernel) a warp per chunk, window by window.
//   pass 2 (carry_scan_kernel): turns the tables, in place, into each
//     chunk's carry: the exclusive prefix max over the row's chunks,
//     seeded with L0.  A block takes 32 symbols of a row and cuts the
//     row's chunks into 32 segments, a thread for each (symbol, segment),
//     so the work is linear in the number of chunks (880 at n_max =
//     901,120) and a row spreads over W / 32 blocks.
//   pass 3 (mtf_rank_kernel; mtf_rank_reg_kernel at W <= 64): one warp
//     per chunk, 32 positions a step (a window), one lane per position,
//     with no chain between lanes.
//
// Pass 3 in detail, at W = 128 and 256.  The warp keeps the MTF list of its chunk in shared
// memory in both directions: P[s] is the list position of symbol s, L[p]
// the symbol at position p.  At the chunk's start P[s] is the rank of s's
// carry entry (the entries are distinct: positions, or -1 - s), found by
// a bitonic sort of the W entries across the warp, W / 32 per lane.  In a
// window, lane i holds symbol s_i; prev_i is the last lower lane with the
// same symbol (__match_any_sync), or -1.
//   - prev_i >= 0: rank = the number of distinct symbols in the lanes
//     between prev_i and i = #{k in (prev_i, i) : prev_k <= prev_i}, over
//     the lanes k with a symbol in [0, W);
//   - prev_i < 0: rank = |S| + P[s_i] - #{t in S : P[t] < P[s_i]}, where S
//     is the set of symbols of lanes [0, i), each counted at its first lane;
//   - s_i outside [0, W), negatives included: rank W, and it changes
//     nothing, as in _mtf_tile.
// Each lane sends one key, (prev + 1) << 16 | P[s], and counts the keys
// below its own threshold, three instructions for each of the 32 lanes.
// At the window's end the list becomes the window's symbols by last
// occurrence, most recent first, then the other symbols in their old
// order: the list positions that the window's symbols held are flagged in
// a bitmap, a warp prefix sum over W / 32 positions a lane counts the
// flags before each position, and every entry is scattered to its new
// position in P and L.
//
// At W = 32 and 64 the list is one or two positions a lane, so it leaves
// shared memory: mtf_rank_reg_kernel keeps P alone, in registers, and
// builds a window's ranks and flags from two prefix ORs over the lanes
// (see there); L is not needed.
//
// What bounds it: instruction issue.  A window costs each lane about 200
// instructions at W = 256, none waiting on another lane's previous
// position, where a walk of one position at a time spends about 30
// dependent instructions per position.  Device-memory traffic is small
// beside that: the symbols are read twice and the ranks written once (12
// bytes a position), and the tables are W ints per 1024 positions.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int CHUNK = 1024;
constexpr int NEG = -(1 << 30);
constexpr unsigned FULL = 0xffffffffu;
constexpr int LAST_THREADS = 256;  // pass 1: 4 positions a thread
constexpr int SCAN_SYMS = 32, SCAN_SEGS = 32;  // pass 2: symbols x segments a block
constexpr int RANK_WARPS = 4;       // pass 3: chunks per block

template <int W>
__global__ void __launch_bounds__(LAST_THREADS)
chunk_last_kernel(const int* __restrict__ seqs, int* __restrict__ tables, int n_chunks) {
  __shared__ int tab[W];
  const int t = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  for (int s = j; s < W; s += LAST_THREADS) tab[s] = NEG;
  __syncthreads();
  const int base = t * CHUNK + j * 4;
  const int4 x =
      *reinterpret_cast<const int4*>(seqs + (long long)b * n_chunks * CHUNK + base);
  const int v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned s = (unsigned)v[k];
    if (s < W) atomicMax(&tab[s], base + k);
  }
  __syncthreads();
  for (int s = j; s < W; s += LAST_THREADS)
    tables[((long long)b * n_chunks + t) * W + s] = tab[s];
}

// Pass 1 at W <= 64: a warp per chunk, one window of 32 positions at a
// time, and a lane updates the table only where the next lane's symbol
// differs, so a run of one symbol (common in BWT output) costs one shared
// atomic, not one for each of its positions queued on one address.
template <int W>
__global__ void __launch_bounds__(RANK_WARPS * 32)
chunk_last_warp_kernel(const int* __restrict__ seqs, int* __restrict__ tables, int n_chunks) {
  __shared__ int tab[RANK_WARPS][W];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int t = blockIdx.x * RANK_WARPS + wid, b = blockIdx.y;
  if (t >= n_chunks) return;  // the whole warp leaves; no block barrier follows
  int* T = tab[wid];
  for (int s = lane; s < W; s += 32) T[s] = NEG;
  const int* src = seqs + ((long long)b * n_chunks + t) * CHUNK;
  int v[CHUNK / 32];
#pragma unroll
  for (int w = 0; w < CHUNK / 32; ++w) v[w] = src[w * 32 + lane];  // all in flight
  __syncwarp();
#pragma unroll
  for (int w = 0; w < CHUNK / 32; ++w) {
    const int s = v[w];
    const int next = __shfl_down_sync(FULL, s, 1);
    if ((unsigned)s < (unsigned)W && (lane == 31 || next != s))
      atomicMax(&T[s], t * CHUNK + w * 32 + lane);
  }
  __syncwarp();
  for (int s = lane; s < W; s += 32) tables[((long long)b * n_chunks + t) * W + s] = T[s];
}

template <int W>
__global__ void __launch_bounds__(SCAN_SYMS * SCAN_SEGS)
carry_scan_kernel(int* __restrict__ tables, int n_chunks) {
  __shared__ int part[SCAN_SEGS][SCAN_SYMS];
  const int b = blockIdx.y, j = threadIdx.x % SCAN_SYMS, g = threadIdx.x / SCAN_SYMS;
  const int s = blockIdx.x * SCAN_SYMS + j;
  const int per = (n_chunks + SCAN_SEGS - 1) / SCAN_SEGS;
  const int c0 = min(g * per, n_chunks), c1 = min(c0 + per, n_chunks);
  int* tb = tables + (long long)b * n_chunks * W + s;

  // the segment's own max, then the carry into it from the earlier segments
  int m = NEG;
#pragma unroll 8
  for (int c = c0; c < c1; ++c) m = max(m, tb[(long long)c * W]);
  part[g][j] = m;
  __syncthreads();
  int run = -1 - s;
  for (int h = 0; h < g; ++h) run = max(run, part[h][j]);

  // in place: each chunk's table becomes the carry into that chunk
#pragma unroll 8
  for (int c = c0; c < c1; ++c) {
    const int x = tb[(long long)c * W];
    tb[(long long)c * W] = run;
    run = max(run, x);
  }
}

// Sorts the W = 32 * PER values v (element lane * PER + q) descending
// across the warp: a bitonic network, compare-exchanges within a lane for
// distances below PER and with the partner lane (__shfl_xor_sync) above.
template <int PER>
__device__ __forceinline__ void warp_sort_desc(int (&v)[PER], int lane) {
#pragma unroll
  for (int k = 2; k <= 32 * PER; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= PER) {
#pragma unroll
        for (int q = 0; q < PER; ++q) {
          const int o = __shfl_xor_sync(FULL, v[q], j / PER);
          const int e = lane * PER + q;
          const bool keep_max = ((e & j) == 0) == ((e & k) == 0);
          v[q] = keep_max ? max(v[q], o) : min(v[q], o);
        }
      } else {
#pragma unroll
        for (int q = 0; q < PER; ++q) {
          if (q & j) continue;
          const bool up = ((lane * PER + q) & k) == 0;
          const int a = v[q], b = v[q ^ j];
          v[q] = up ? max(a, b) : min(a, b);
          v[q ^ j] = up ? min(a, b) : max(a, b);
        }
      }
    }
  }
}

template <int W>
__global__ void __launch_bounds__(RANK_WARPS * 32)
mtf_rank_kernel(const int* __restrict__ seqs, const int* __restrict__ carry,
                int* __restrict__ out, int n_chunks) {
  constexpr int PER = W / 32;  // list positions per lane
  __shared__ int sP[RANK_WARPS][W];  // symbol -> list position
  __shared__ int sL[RANK_WARPS][W];  // list position -> symbol
  __shared__ unsigned sFlag[RANK_WARPS][PER];  // positions held by the window's symbols
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int t = blockIdx.x * RANK_WARPS + wid, b = blockIdx.y;
  if (t >= n_chunks) return;  // the whole warp leaves; no block barrier follows
  int* P = sP[wid];
  int* L = sL[wid];
  unsigned* flag = sFlag[wid];
  const unsigned lt = (1u << lane) - 1u, gt = ~lt << 1;

  // a. the list at the chunk's start: sort (carry entry, symbol)
  // descending; entries are >= -W and below 2**23, so each pair packs into
  // 31 bits
  {
    const int* cb = carry + ((long long)b * n_chunks + t) * W;
    int v[PER];
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int s = lane * PER + q;
      v[q] = ((cb[s] + W + 1) << 8) | s;
    }
    warp_sort_desc<PER>(v, lane);
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int s = v[q] & 255, pos = lane * PER + q;
      P[s] = pos;
      L[pos] = s;
    }
    __syncwarp();
  }

  const long long off = ((long long)b * n_chunks + t) * CHUNK;
  const int* src = seqs + off;
  int* dst = out + off;
  // b. the windows
  int nxt = src[lane];
  for (int base = 0; base < CHUNK; base += 32) {
    const int s = nxt;
    if (base + 32 < CHUNK) nxt = src[base + 32 + lane];  // the next window, in flight
    const bool valid = (unsigned)s < (unsigned)W;
    const unsigned same = __match_any_sync(FULL, s);
    const unsigned below = same & lt;
    const int prev = below ? 31 - __clz(below) : -1;
    const int pi = valid ? P[s] : 0;
    const unsigned first = __ballot_sync(FULL, valid && prev < 0);

    // seen lanes count keys (prev_k + 1) << 16 below (prev + 2) << 16 in
    // (prev, i); first lanes count keys below P[s], i.e. earlier first
    // lanes ahead of s in the list
    const int key = valid ? ((prev + 1) << 16) | pi : 0x7fffffff;
    const int thr = prev >= 0 ? (prev + 2) << 16 : pi;
    unsigned below_thr = 0;
#pragma unroll
    for (int k = 0; k < 32; ++k)
      if (__shfl_sync(FULL, key, k) < thr) below_thr |= 1u << k;
    const unsigned range = prev >= 0 ? lt & ~((2u << prev) - 1u) : lt;
    const int cnt = __popc(below_thr & range);
    dst[base + lane] = !valid ? W : prev >= 0 ? cnt : __popc(first & lt) + pi - cnt;

    // the window's end: its symbols move to the front, by last occurrence
    const bool is_last = valid && (same & gt) == 0;
    const unsigned lasts = __ballot_sync(FULL, is_last);
    const int d = __popc(lasts);
    if (lane < PER) flag[lane] = 0;
    __syncwarp();
    if (is_last) atomicOr(&flag[pi >> 5], 1u << (pi & 31));
    __syncwarp();
    const int p0 = lane * PER;
    const unsigned mine = (flag[p0 >> 5] >> (p0 & 31)) & ((1u << PER) - 1u);
    int before = __popc(mine);  // flagged positions before p0: a warp scan
#pragma unroll
    for (int dd = 1; dd < 32; dd <<= 1) {
      const int y = __shfl_up_sync(FULL, before, dd);
      if (lane >= dd) before += y;
    }
    before -= __popc(mine);
    int sy[PER];
#pragma unroll
    for (int q = 0; q < PER; ++q) sy[q] = L[p0 + q];
    __syncwarp();
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      if ((mine >> q) & 1u) {
        ++before;
      } else {
        const int np = d + p0 + q - before;
        P[sy[q]] = np;
        L[np] = sy[q];
      }
    }
    if (is_last) {
      const int r = __popc(lasts & gt);
      P[s] = r;
      L[r] = s;
    }
    __syncwarp();
  }
}

// Pass 3 at W <= 64: the list is P alone, in registers (lane l holds the
// positions of symbols l and l + 32), and a window's ranks and flags come
// from two inclusive prefix ORs over the lanes, with no shared-memory
// list, no atomics and no prefix sum.
template <int W>
__global__ void __launch_bounds__(RANK_WARPS * 32)
mtf_rank_reg_kernel(const int* __restrict__ seqs, const int* __restrict__ carry,
                    int* __restrict__ out, int n_chunks) {
  static_assert(W == 32 || W == 64, "one or two list positions a lane");
  constexpr int PER = W / 32;
  using Mask = typename std::conditional<W == 64, unsigned long long, unsigned>::type;
  __shared__ int sR[RANK_WARPS][2][W];  // a window's symbols' new positions, by symbol
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int t = blockIdx.x * RANK_WARPS + wid, b = blockIdx.y;
  if (t >= n_chunks) return;  // the whole warp leaves; no block barrier follows
  const unsigned lt = (1u << lane) - 1u, gt = ~lt << 1;
  int P[PER];  // P[h]: the list position of symbol lane + 32 h

  // a. the list at the chunk's start: sort (carry entry, symbol)
  // descending, as in mtf_rank_kernel, then each position goes to the
  // lane that owns its symbol through shared memory
  {
    const int* cb = carry + ((long long)b * n_chunks + t) * W;
    int v[PER];
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int s = lane * PER + q;
      v[q] = ((cb[s] + W + 1) << 8) | s;
    }
    warp_sort_desc<PER>(v, lane);
#pragma unroll
    for (int q = 0; q < PER; ++q) sR[wid][0][v[q] & 255] = lane * PER + q;
    __syncwarp();
#pragma unroll
    for (int h = 0; h < PER; ++h) P[h] = sR[wid][0][lane + 32 * h];
  }

  // b. the windows.  Lane i: prev = the last lower lane with its symbol.
  //   - prev >= 0: rank = the lanes in (prev, i) that hold the last
  //     occurrence of their symbol in lanes [0, i), i.e. the valid lanes
  //     in (prev, i) that are no lane's prev: x, the OR of the bits
  //     1 << prev over lanes [0, i], marks those that are;
  //   - prev < 0: rank = P[s] + the symbols of lanes [0, i) behind s in
  //     the list: g, the OR of the bits 1 << P[s] over lanes [0, i],
  //     counted above P[s].
  // g at lane 31 flags the list positions of all the window's symbols;
  // a symbol outside them moves down by the flags below its position,
  // and the window's symbols take their rank among the window's last
  // occurrences, written by their last lane (two buffers, so a window's
  // writes never meet the previous window's reads).  __match_any_sync
  // stays: one ballot per bit of the symbol measured slower here.
  const long long off = ((long long)b * n_chunks + t) * CHUNK;
  const int* src = seqs + off;
  int* dst = out + off;
  int nxt = src[lane];
  for (int base = 0; base < CHUNK; base += 32) {
    const int s = nxt;
    if (base + 32 < CHUNK) nxt = src[base + 32 + lane];  // the next window, in flight
    const bool valid = (unsigned)s < (unsigned)W;
    const unsigned vl = __ballot_sync(FULL, valid);
    const unsigned same = __match_any_sync(FULL, s);
    const unsigned below = same & lt;
    const int prev = below ? 31 - __clz(below) : -1;
    int pi = __shfl_sync(FULL, P[0], s & 31);
    if (PER == 2) {
      const int p1 = __shfl_sync(FULL, P[PER - 1], s & 31);
      if (s & 32) pi = p1;
    }
    pi = valid ? pi : 0;
    unsigned x = valid && prev >= 0 ? 1u << prev : 0u;
    Mask g = valid ? Mask(1) << pi : Mask(0);
#pragma unroll
    for (int dd = 1; dd < 32; dd <<= 1) {
      x |= __shfl_up_sync(FULL, x, dd);
      g |= __shfl_up_sync(FULL, g, dd);
    }
    int rank;
    if (!valid) {
      rank = W;
    } else if (prev >= 0) {
      rank = __popc(vl & ~x & lt & ~((2u << prev) - 1u));
    } else if (W == 64) {
      rank = pi + __popcll((unsigned long long)g & ~((2ull << pi) - 1ull));
    } else {
      rank = pi + __popc((unsigned)g & ~((2u << pi) - 1u));
    }
    dst[base + lane] = rank;

    // the window's end
    const Mask flags = __shfl_sync(FULL, g, 31);
    const bool is_last = valid && (same & gt) == 0;
    const unsigned lasts = __ballot_sync(FULL, is_last);
    const int d = __popc(lasts);
    int* R = sR[wid][1 - ((base >> 5) & 1)];
    if (is_last) R[s] = __popc(lasts & gt);
    __syncwarp();
#pragma unroll
    for (int h = 0; h < PER; ++h) {
      const int p = P[h];
      const Mask under = flags & ((Mask(1) << p) - Mask(1));
      const int moved = W == 64 ? __popcll((unsigned long long)under) : __popc((unsigned)under);
      P[h] = (flags >> p) & Mask(1) ? R[lane + 32 * h] : d + p - moved;
    }
  }
}

template <int W>
int launch(const int* seqs, int* out, int* tables, int batch, int n_chunks,
           cudaStream_t stream) {
  const dim3 grid((n_chunks + RANK_WARPS - 1) / RANK_WARPS, batch);
  if constexpr (W <= 64)
    chunk_last_warp_kernel<W><<<grid, RANK_WARPS * 32, 0, stream>>>(seqs, tables, n_chunks);
  else
    chunk_last_kernel<W><<<dim3(n_chunks, batch), LAST_THREADS, 0, stream>>>(
        seqs, tables, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  carry_scan_kernel<W><<<dim3(W / SCAN_SYMS, batch), SCAN_SYMS * SCAN_SEGS, 0, stream>>>(
      tables, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if constexpr (W <= 64)
    mtf_rank_reg_kernel<W><<<grid, RANK_WARPS * 32, 0, stream>>>(seqs, tables, out, n_chunks);
  else
    mtf_rank_kernel<W><<<grid, RANK_WARPS * 32, 0, stream>>>(seqs, tables, out, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// seqs, out: int32[batch, n_chunks * 1024], 16-byte aligned, contiguous;
// tables: int32[batch, n_chunks, width] scratch.  Returns a cudaError_t.
extern "C" int s3t_mtf_wide(const int* seqs, int* out, int* tables, int batch,
                            int n_chunks, int width, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 32: return launch<32>(seqs, out, tables, batch, n_chunks, st);
    case 64: return launch<64>(seqs, out, tables, batch, n_chunks, st);
    case 128: return launch<128>(seqs, out, tables, batch, n_chunks, st);
    case 256: return launch<256>(seqs, out, tables, batch, n_chunks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* s3t_mtf_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
