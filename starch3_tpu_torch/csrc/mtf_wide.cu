// Wide-alphabet MTF ranks on Hopper (sm_90a): the bits==8 tier's MTF.
//
// Replaces the Pallas kernels of starch3_tpu/ops/mtf_pallas.py:
// _make_mtf_kernel_batch + _mtf_tile (launched by mtf_ranks_pallas_batch,
// widths 128 and 256) and _mtf_kernel (mtf_ranks_pallas, one row at width
// 256, which is this kernel at batch 1).  Same function: int32[B, n_max]
// dense symbols < W -> int32[B, n_max] MTF ranks, where
// rank(i) = #{s : last[s] > last[seq[i]]}, last[s] is the last occurrence
// of s before i, and unseen symbols start at L0(s) = -1 - s.  A symbol
// outside [0, W), negative ones included, matches no table entry: its
// rank is W and it changes nothing, as in _mtf_tile.  Each row starts
// afresh.
//
// Why not the Pallas layout: the TPU kernel walks a row in grid order,
// builds a (1024, W) one-hot tile per step and carries a (1, W) table in
// VMEM from one grid step to the next.  CUDA blocks run in no order, so
// the carry is made explicit.  Max is associative, so the table at any
// position is the max of L0 and the tables of everything before it:
//
//   pass 1 (chunk_last_kernel): one block per 1024-position chunk writes
//     the chunk's own last-occurrence table, tables[B, T, W].
//   pass 2 (carry_scan_kernel): turns the tables, in place, into each
//     chunk's carry: the exclusive prefix max over the row's chunks,
//     seeded with L0.  A block takes 32 symbols of a row and cuts the
//     row's chunks into 32 segments, a thread for each (symbol, segment),
//     so the work is linear in the number of chunks (880 at n_max =
//     901,120) and a row spreads over W / 32 blocks.
//   pass 3 (mtf_rank_kernel): one warp per chunk, 32 positions a step
//     (a window), one lane per position, with no chain between lanes.
//
// Pass 3 in detail.  The warp keeps the MTF list of its chunk in shared
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
// Why not the layout of the narrow kernel's two-pass form
// (csrc/mtf_narrow.cu, widths 32/64): it keeps a W-entry table per thread
// in shared memory.  At W = 256 that is 1 KB a
// thread, 128 KB for 128 threads: past the 48 KB of static shared memory
// and far past what leaves room for occupancy.
//
// What bounds it: instruction issue.  A window costs each lane about 200
// instructions, none waiting on another lane's previous position, where
// a walk of one position at a time spends about 30 dependent
// instructions per position.  Device-memory traffic is small beside
// that: the symbols are read twice and the ranks written once (12 bytes a
// position), and the tables are W ints per 1024 positions.

#include <cuda_runtime.h>

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

  // the list at the chunk's start: sort (carry entry, symbol) descending;
  // entries are >= -W and below 2**23, so each pair packs into 31 bits
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

template <int W>
int launch(const int* seqs, int* out, int* tables, int batch, int n_chunks,
           cudaStream_t stream) {
  chunk_last_kernel<W><<<dim3(n_chunks, batch), LAST_THREADS, 0, stream>>>(
      seqs, tables, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  carry_scan_kernel<W><<<dim3(W / SCAN_SYMS, batch), SCAN_SYMS * SCAN_SEGS, 0, stream>>>(
      tables, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_chunks + RANK_WARPS - 1) / RANK_WARPS, batch);
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
    case 128: return launch<128>(seqs, out, tables, batch, n_chunks, st);
    case 256: return launch<256>(seqs, out, tables, batch, n_chunks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* s3t_mtf_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
