// Narrow-alphabet MTF ranks on Hopper (sm_90a) at width 16: the MTF of the
// bits-4 tier.  Widths 32 and 64 (bits 5 and 6) run the windowed kernel of
// csrc/mtf_wide.cu.
//
// Replaces the Pallas kernel starch3_tpu/ops/mtf_narrow_pallas.py
// (_make_kernel, launched by mtf_ranks_narrow_batch).  Same function:
// int32[B, n_max] dense symbols < W -> int32[B, n_max] MTF ranks, where
// rank(i) = #{s : last[s] > last[seq[i]]}, last[s] is the last occurrence
// of s before i, and unseen symbols start at L0(s) = -1 - s.  A symbol
// outside [0, W) matches no table entry: its rank is W and it changes
// nothing, as in the Pallas kernel.  Each row starts afresh.
//
// Why not the Pallas layout: the TPU kernel walks a row in grid order and
// carries a (W, 128) last-occurrence table from one grid step to the next
// in VMEM.  CUDA blocks run in no order, so the carry is made explicit.
//
// mtf16_kernel: one launch that reads the input once.  The 16-entry MTF
// list is one 64-bit register, a nibble per list position (position 0,
// the front, in the low nibble).  The rank of s is
// the lowest zero nibble of list ^ (s * 0x1111...): with
// t = (x - 0x1111...) & ~x & 0x8888..., the lowest flagged nibble is exact.
// Moving s to the front shifts the nibbles below its rank up by one.  That
// is about 20 ALU instructions per position and no memory access.  The
// carry between runs of positions is an associative aggregate: a run's
// distinct symbols by last occurrence, most recent first (a packed list
// and a 16-bit presence mask), composed as compose(A, B) = B, then A's
// symbols not in B.  A full list composed after anything absorbs it.
//   - each thread builds the aggregate of its run of 32 positions, and
//     the block the last occurrence of each symbol in the chunk (shared
//     atomicMax), which it publishes at once: every later chunk of the
//     row waits for it.  Each published int carries its own validity
//     (0 is "not yet", the scratch starts zeroed), so a reader needs no
//     status word and no fence;
//   - the block composes the runs' aggregates (warp shuffles, then the
//     warps' totals) into each thread's exclusive prefix;
//   - the list entering the chunk comes from the last occurrences before
//     it: the block takes each symbol's max over the row's earlier chunks
//     (seeded with L0), all loads in one round, and ranks the 16 symbols
//     by it;
//   - each thread's starting list is its exclusive prefix composed after
//     the list entering the chunk; the thread walks its run.
// Blocks take their chunk from a counter (atomicAdd), so every chunk they
// wait on belongs to a block that is already running.  The carry between
// chunks is a max of tables, not a composition of aggregates: a
// composition costs the same whatever the data only when an aggregate
// holds all 16 symbols, and real BWT output often leaves some out.
//
// What bounds it: device-memory traffic at best, 4 bytes read and 4
// written per position; measured on an H100 it reaches 21-33% of that
// bound, held back by each block's chain of dependent steps (the
// aggregate, the block scan, the wait for the row's earlier tables, the
// walk) with five blocks an SM.  The input is read once, staged through
// shared memory so that loads and stores are coalesced.

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 4096;
constexpr int NEG = -(1 << 30);
constexpr unsigned FULL = 0xffffffffu;

namespace w16 {

constexpr int THREADS = 128, RUN = CHUNK / THREADS;  // 32 positions a thread
constexpr unsigned FULL16 = 0xffffu;

// distinct symbols by last occurrence, most recent first: nibble p of
// `list` for p < popc(mask), zero above
struct Agg {
  unsigned long long list;
  unsigned mask;
};

// a earlier, b later: b's symbols, then a's symbols not in b, in a's
// order.  Many compositions return at once: a prefix of a few runs often
// holds all 16 symbols, a full list absorbs whatever comes before it, and
// the empty aggregate pads the scans.  The rest is written for latency,
// not instruction count: every nibble of a is tested and placed on its
// own (its new position is a popcount of the kept nibbles below it), and
// the ORs go to four accumulators, so the dependent chain is about 25
// instructions where a nibble-by-nibble compaction is 16 times longer.
__device__ __forceinline__ Agg compose(Agg a, Agg b) {
  if ((a.mask & ~b.mask) == 0u) return b;  // a adds nothing (b full, or a within b)
  if (b.mask == 0u) return a;
  const unsigned lo = (unsigned)a.list, hi = (unsigned)(a.list >> 32);
  unsigned in_b[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const unsigned sym = (p < 8 ? lo >> (4 * p) : hi >> (4 * (p - 8))) & 15u;
    in_b[p & 3] |= ((b.mask >> sym) & 1u) << p;
  }
  const unsigned keep =
      ~(in_b[0] | in_b[1] | in_b[2] | in_b[3]) & (0xffffu >> (16 - __popc(a.mask)));
  const int cb = __popc(b.mask);
  unsigned long long acc[4] = {b.list, 0ull, 0ull, 0ull};
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const unsigned sym = (p < 8 ? lo >> (4 * p) : hi >> (4 * (p - 8))) & 15u;
    const int at = cb + __popc(keep & ((1u << p) - 1u));  // < 16 for a kept nibble
    if ((keep >> p) & 1u) acc[p & 3] |= (unsigned long long)sym << (4 * at);
  }
  return {acc[0] | acc[1] | acc[2] | acc[3], a.mask | b.mask};
}

__device__ __forceinline__ Agg shfl_up(Agg a, int d) {
  return {__shfl_up_sync(FULL, a.list, d), __shfl_up_sync(FULL, a.mask, d)};
}

__device__ __forceinline__ int4 ld_relaxed4(const int* p) {
  int4 v;
  asm volatile("ld.relaxed.gpu.global.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p) : "memory");
  return v;
}

constexpr int PER = 8;  // chunk tables a thread loads at once in the look-back

// lb[16 * tile + s]: symbol s's last row position in the chunk plus 2, or
// 1 if s is absent, or 0 while unpublished; lb[16 * n_tiles] is the tile
// counter.
// at most 102 registers: five blocks an SM, so the 660 chunks of a production
// batch (3 x 901,120) run in one wave
__global__ void __launch_bounds__(THREADS, 5)
mtf16_kernel(const int* __restrict__ seqs, int* __restrict__ out, int* lb, int n_chunks,
             int n_tiles) {
  __shared__ int4 s_io[CHUNK / 4];  // the chunk, for coalesced loads and stores
  __shared__ int s_tile;
  __shared__ int s_last[16];  // each symbol's last position in the chunk, or -1
  __shared__ Agg s_warp[THREADS / 32];
  __shared__ int s_max[THREADS / 32][16];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned long long s_in_reg;
  if (tid == 0) s_tile = atomicAdd(&lb[16LL * n_tiles], 1);
  if (tid < 16) s_last[tid] = -1;
  __syncthreads();
  const int tile = s_tile, t = tile % n_chunks;
  const long long row = (long long)(tile - t);  // the row's first tile

  // the chunk through shared memory: coalesced 16-byte loads, then each
  // thread takes its run (int4 slots XOR-swizzled within 128-byte rows,
  // so neither side has bank conflicts)
  const int4* src = reinterpret_cast<const int4*>(seqs + (long long)tile * CHUNK);
#pragma unroll
  for (int q = 0; q < RUN / 4; ++q) {
    const int g = q * THREADS + tid;
    s_io[g ^ ((g >> 3) & 7)] = src[g];
  }
  __syncthreads();
  int v[RUN];
#pragma unroll
  for (int j = 0; j < RUN / 4; ++j) {
    const int4 x = s_io[tid * (RUN / 4) + (j ^ (tid & 7))];
    v[4 * j] = x.x;
    v[4 * j + 1] = x.y;
    v[4 * j + 2] = x.z;
    v[4 * j + 3] = x.w;
  }

  // this run's aggregate: a backward walk keeps each symbol's last
  // occurrence; `slot` is 1 in the nibble the next new symbol takes
  Agg a = {0ull, 0u};
  unsigned long long slot = 1ull;
#pragma unroll
  for (int k = RUN - 1; k >= 0; --k) {
    const unsigned s = (unsigned)v[k];
    if (s < 16u && !((a.mask >> s) & 1u)) {
      a.list |= slot * s;
      a.mask |= 1u << s;
      slot <<= 4;
      atomicMax(&s_last[s], tid * RUN + k);
    }
  }
  __syncthreads();

  // publish the chunk's last occurrences
  if (tid < 16) {
    const int x = s_last[tid];
    asm volatile("st.relaxed.gpu.global.s32 [%0], %1;"
                 ::"l"(lb + 16LL * tile + tid), "r"(x >= 0 ? t * CHUNK + x + 2 : 1) : "memory");
  }

  // block scan: inclusive over the warp, then the earlier warps' totals
  Agg inc = a;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Agg o = shfl_up(inc, d);
    if (lane >= d) inc = compose(o, inc);
  }
  Agg ex = shfl_up(inc, 1);
  if (lane == 0) ex = {0ull, 0u};
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  Agg wp = {0ull, 0u};
  for (int w = 0; w < warp; ++w) wp = compose(wp, s_warp[w]);
  ex = compose(wp, ex);
  // the list entering this chunk: each symbol's last occurrence before it
  // is the max of L0 and the row's earlier chunks' tables.  Thread i
  // takes symbols 4 (i & 3) .. 4 (i & 3) + 3 of the chunks c = i / 4 + 32 k,
  // all loads in flight at once; quarters combine over the warp, then
  // over the warps, and every warp ranks the 16 symbols by their keys.
  {
    const int quarter = tid & 3;
    int m[4] = {NEG, NEG, NEG, NEG};
    for (int c0 = tid >> 2; c0 < t; c0 += 32 * PER) {
      int4 x[PER];
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int c = c0 + 32 * q;
        x[q] = c < t ? ld_relaxed4(lb + 16 * (row + c) + 4 * quarter) : make_int4(1, 1, 1, 1);
      }
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int c = c0 + 32 * q;
        while (!(x[q].x && x[q].y && x[q].z && x[q].w)) {  // not yet published
          __nanosleep(32);
          x[q] = ld_relaxed4(lb + 16 * (row + c) + 4 * quarter);
        }
        m[0] = max(m[0], x[q].x > 1 ? x[q].x - 2 : NEG);  // 1: absent from chunk c
        m[1] = max(m[1], x[q].y > 1 ? x[q].y - 2 : NEG);
        m[2] = max(m[2], x[q].z > 1 ? x[q].z - 2 : NEG);
        m[3] = max(m[3], x[q].w > 1 ? x[q].w - 2 : NEG);
      }
    }
#pragma unroll
    for (int d = 4; d < 32; d <<= 1)
#pragma unroll
      for (int u = 0; u < 4; ++u) m[u] = max(m[u], __shfl_xor_sync(FULL, m[u], d));
    if (lane < 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) s_max[warp][4 * lane + u] = m[u];
    }
  }
  __syncthreads();
  {
    const int s = lane & 15;
    int key = -1 - s;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) key = max(key, s_max[w][s]);
    int rank = 0;
#pragma unroll
    for (int u = 0; u < 16; ++u) rank += __shfl_sync(FULL, key, u) > key;
    unsigned long long nib = lane < 16 ? (unsigned long long)lane << (4 * rank) : 0ull;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) nib |= __shfl_xor_sync(FULL, nib, d);
    s_in_reg = nib;
  }

  // walk the run from its starting list, kept as two 32-bit halves (list
  // positions 0-7 and 8-15); ranks overwrite the symbols.  The halves'
  // zero-nibble tests are independent: the low half borrows into the high
  // one only past a match of its own.  `f` is the lowest flagged bit, bit
  // 4 * rank + 3 of its half: the masks of the nibbles below the rank and
  // up to it follow without a variable shift (at the top nibble the
  // second wraps to all ones).
  unsigned long long list = compose({s_in_reg, FULL16}, ex).list;
  unsigned lo = (unsigned)list, hi = (unsigned)(list >> 32);
#pragma unroll
  for (int k = 0; k < RUN; ++k) {
    const unsigned s = (unsigned)v[k];
    int r = 16;
    if (s < 16u) {
      const unsigned sx = 0x11111111u * s;
      const unsigned xl = lo ^ sx, xh = hi ^ sx;
      const unsigned tl = (xl - 0x11111111u) & ~xl & 0x88888888u;
      const unsigned th = (xh - 0x11111111u) & ~xh & 0x88888888u;
      const unsigned f = tl ? tl & (0u - tl) : th & (0u - th);
      const unsigned below = (f >> 3) - 1u, upto = (f << 1) - 1u;
      if (tl) {
        lo = (lo & ~upto) | ((lo & below) << 4) | s;
        r = __popc(below) >> 2;
      } else {
        hi = (hi & ~upto) | ((hi & below) << 4) | (lo >> 28);
        lo = (lo << 4) | s;
        r = 8 + (__popc(below) >> 2);
      }
    }
    v[k] = r;
  }

  // back through shared memory, for coalesced stores
#pragma unroll
  for (int j = 0; j < RUN / 4; ++j)
    s_io[tid * (RUN / 4) + (j ^ (tid & 7))] = make_int4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  __syncthreads();
  int4* dst = reinterpret_cast<int4*>(out + (long long)tile * CHUNK);
#pragma unroll
  for (int q = 0; q < RUN / 4; ++q) {
    const int g = q * THREADS + tid;
    dst[g] = s_io[g ^ ((g >> 3) & 7)];
  }
}

}  // namespace w16

}  // namespace

// seqs, out: int32[batch, n_chunks * 4096], 16-byte aligned,
// contiguous; lookback: int32[batch * n_chunks * 16 + 1], zeroed, 16-byte
// aligned.  Returns a cudaError_t.
extern "C" int s3t_mtf_narrow16(const int* seqs, int* out, int* lookback, int batch,
                                int n_chunks, void* stream) {
  const int n_tiles = batch * n_chunks;
  w16::mtf16_kernel<<<n_tiles, w16::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      seqs, out, lookback, n_chunks, n_tiles);
  return (int)cudaGetLastError();
}

extern "C" const char* s3t_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
