// Narrow-alphabet MTF ranks on Hopper (sm_90a): the bits==4 tier's MTF.
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
// Max is associative, so the last-occurrence table at any position is the
// max of L0 and the tables of everything before it:
//
//   pass 1 (chunk_last_kernel): one block per 4096-position chunk writes
//     the chunk's own last-occurrence table, tables[B, T, W].
//   pass 2 (mtf_rank_kernel): one block per chunk
//     a. max-reduces the tables of the row's earlier chunks with L0 (the
//        carry into the chunk; at most 219 chunks at n_max = 901,120),
//     b. gives each thread a run of RUN consecutive positions and builds
//        the run's own table in a shared-memory column,
//     c. turns the columns into each thread's starting table by an
//        exclusive max-scan across threads (warp shuffles, then the
//        totals of the earlier warps),
//     d. walks the run in order: rank = #entries above the own entry,
//        then own entry = position.
//
// What bounds it: device-memory traffic.  The work is W compares per
// position (16 on the main path), tiny for the card; the data is 4 bytes
// read and 4 bytes written per position, about 8 bytes a position.  Pass 1
// reads the input once more, but a production batch (3 x 901,120 int32,
// 10.8 MB) sits in the 50 MB L2 when pass 2 reads it again, and the
// tables are W ints per 4096 positions.  Loads and stores are 16 bytes a
// thread.  Tables live in shared memory, symbol-major and thread-minor
// (entry [s][thread]), so a warp touching one symbol hits 32 banks.  At
// W = 64 a block has 128 threads so the tables stay in 32 KB of static
// shared memory, under the 48 KB that needs no opt-in.

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 4096;
constexpr int NEG = -(1 << 30);
constexpr unsigned FULL = 0xffffffffu;

template <int W>
struct Cfg {
  static constexpr int THREADS = W == 64 ? 128 : 256;
  static constexpr int RUN = CHUNK / THREADS;  // positions per thread
  static constexpr int WARPS = THREADS / 32;
  static constexpr int GROUPS = THREADS / W;  // threads per symbol in the carry
};

template <int RUN>
__device__ __forceinline__ void load_run(const int* src, int (&v)[RUN]) {
  const int4* p = reinterpret_cast<const int4*>(src);
#pragma unroll
  for (int q = 0; q < RUN / 4; ++q) {
    int4 x = p[q];
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
}

template <int W>
__global__ void __launch_bounds__(Cfg<W>::THREADS)
chunk_last_kernel(const int* __restrict__ seqs, int* __restrict__ tables, int n_chunks) {
  constexpr int THREADS = Cfg<W>::THREADS, RUN = Cfg<W>::RUN;
  __shared__ int tab[W];
  const int t = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  for (int s = j; s < W; s += THREADS) tab[s] = NEG;
  __syncthreads();

  const int base = t * CHUNK + j * RUN;
  int v[RUN];
  load_run<RUN>(seqs + (long long)b * n_chunks * CHUNK + base, v);
  // backwards: only a symbol's last position in the run reaches shared memory
  unsigned long long seen = 0;
#pragma unroll
  for (int k = RUN - 1; k >= 0; --k) {
    const unsigned s = (unsigned)v[k];
    if (s < W && !((seen >> s) & 1ull)) {
      seen |= 1ull << s;
      atomicMax(&tab[s], base + k);
    }
  }
  __syncthreads();
  for (int s = j; s < W; s += THREADS)
    tables[((long long)b * n_chunks + t) * W + s] = tab[s];
}

template <int W>
__global__ void __launch_bounds__(Cfg<W>::THREADS)
mtf_rank_kernel(const int* __restrict__ seqs, const int* __restrict__ tables,
                int* __restrict__ out, int n_chunks) {
  constexpr int THREADS = Cfg<W>::THREADS, RUN = Cfg<W>::RUN;
  constexpr int WARPS = Cfg<W>::WARPS, GROUPS = Cfg<W>::GROUPS;
  __shared__ int last[W][THREADS];
  __shared__ int part[GROUPS][W];
  __shared__ int carry[W];
  __shared__ int wtot[WARPS][W];
  const int t = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5;

  // a. carry into this chunk: L0 and the tables of the row's earlier chunks
  {
    const int s = j % W, g = j / W;
    const int* tb = tables + (long long)b * n_chunks * W + s;
    int m = -1 - s;
    for (int c = g; c < t; c += GROUPS) m = max(m, tb[c * W]);
    part[g][s] = m;
  }

  // b. this thread's run and the run's own last-occurrence column
  const int base = t * CHUNK + j * RUN;
  const long long off = (long long)b * n_chunks * CHUNK + base;
  int v[RUN];
  load_run<RUN>(seqs + off, v);
#pragma unroll
  for (int s = 0; s < W; ++s) last[s][j] = NEG;
#pragma unroll
  for (int k = 0; k < RUN; ++k) {
    const unsigned s = (unsigned)v[k];
    if (s < W) last[s][j] = base + k;
  }
  __syncthreads();
  if (j < W) {
    int m = part[0][j];
#pragma unroll
    for (int g = 1; g < GROUPS; ++g) m = max(m, part[g][j]);
    carry[j] = m;
  }

  // c. exclusive max-scan of the columns across threads, per symbol
#pragma unroll 4
  for (int s = 0; s < W; ++s) {
    int x = last[s][j];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, x, d);
      if (lane >= d) x = max(x, y);
    }
    int ex = __shfl_up_sync(FULL, x, 1);
    last[s][j] = lane == 0 ? NEG : ex;
    if (lane == 31) wtot[warp][s] = x;
  }
  __syncthreads();
#pragma unroll 4
  for (int s = 0; s < W; ++s) {
    int m = max(carry[s], last[s][j]);
    for (int w = 0; w < warp; ++w) m = max(m, wtot[w][s]);
    last[s][j] = m;
  }

  // d. walk the run in order; ranks overwrite the symbols in registers
#pragma unroll
  for (int k = 0; k < RUN; ++k) {
    const unsigned s = (unsigned)v[k];
    int r = W;
    if (s < W) {
      const int own = last[s][j];
      r = 0;
#pragma unroll
      for (int q = 0; q < W; ++q) r += last[q][j] > own;
      last[s][j] = base + k;
    }
    v[k] = r;
  }
  int4* dst = reinterpret_cast<int4*>(out + off);
#pragma unroll
  for (int q = 0; q < RUN / 4; ++q)
    dst[q] = make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

template <int W>
int launch(const int* seqs, int* out, int* tables, int batch, int n_chunks,
           cudaStream_t stream) {
  const dim3 grid(n_chunks, batch);
  chunk_last_kernel<W><<<grid, Cfg<W>::THREADS, 0, stream>>>(seqs, tables, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mtf_rank_kernel<W><<<grid, Cfg<W>::THREADS, 0, stream>>>(seqs, tables, out, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// seqs, out: int32[batch, n_chunks * 4096], 16-byte aligned, contiguous;
// tables: int32[batch, n_chunks, width] scratch.  Returns a cudaError_t.
extern "C" int s3t_mtf_narrow(const int* seqs, int* out, int* tables, int batch,
                              int n_chunks, int width, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 16: return launch<16>(seqs, out, tables, batch, n_chunks, st);
    case 32: return launch<32>(seqs, out, tables, batch, n_chunks, st);
    case 64: return launch<64>(seqs, out, tables, batch, n_chunks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* s3t_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
