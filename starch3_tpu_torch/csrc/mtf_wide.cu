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
//   pass 2 (carry_scan_kernel): one block per row turns the tables, in
//     place, into each chunk's carry: the exclusive prefix max over the
//     row's chunks, seeded with L0.  Each of W x (1024 / W) threads scans
//     one segment of chunks for one symbol, so the work is linear in the
//     number of chunks (880 at n_max = 901,120).
//   pass 3 (mtf_rank_kernel): one warp per chunk walks its 1024 positions
//     in order.  Lane l holds the entries of symbols l, l + 32, ... in
//     registers (W / 32 of them: 8 at W = 256).  At each position the
//     owner lane of the symbol broadcasts its entry (__shfl_sync), every
//     lane counts its entries above it, __reduce_add_sync sums the counts
//     into the rank, and the owner sets the entry to the position.
//
// Why not the narrow kernel's layout (csrc/mtf_narrow.cu): it keeps a
// W-entry table per thread in shared memory.  At W = 256 that is 1 KB a
// thread, 128 KB for 128 threads: past the 48 KB of static shared memory
// and far past what leaves room for occupancy.  Here the whole table of a
// chunk lives in one warp's registers, 8 per lane.
//
// What bounds it: the serial walk.  Each position costs a warp about 30
// dependent instructions (shuffle, 8 compares, reduction, update), and a
// row's chunks run in parallel: 3 x 880 warps at (3, 901,120), about 20
// per SM, all resident at once.  Device-memory traffic is small beside
// that: the symbols are read twice and the ranks written once (12 bytes a
// position), and the tables are W ints per 1024 positions.

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 1024;
constexpr int NEG = -(1 << 30);
constexpr unsigned FULL = 0xffffffffu;
constexpr int LAST_THREADS = 256;  // pass 1: 4 positions a thread
constexpr int SCAN_THREADS = 1024;  // pass 2: W symbols x 1024 / W segments
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
__global__ void __launch_bounds__(SCAN_THREADS)
carry_scan_kernel(int* __restrict__ tables, int n_chunks) {
  constexpr int SEGS = SCAN_THREADS / W;
  __shared__ int part[SEGS][W];
  const int b = blockIdx.x, s = threadIdx.x % W, g = threadIdx.x / W;
  const int per = (n_chunks + SEGS - 1) / SEGS;
  const int c0 = min(g * per, n_chunks), c1 = min(c0 + per, n_chunks);
  int* tb = tables + (long long)b * n_chunks * W + s;

  // the segment's own max, then the carry into it from the earlier segments
  int m = NEG;
#pragma unroll 8
  for (int c = c0; c < c1; ++c) m = max(m, tb[(long long)c * W]);
  part[g][s] = m;
  __syncthreads();
  int run = -1 - s;
  for (int h = 0; h < g; ++h) run = max(run, part[h][s]);

  // in place: each chunk's table becomes the carry into that chunk
#pragma unroll 8
  for (int c = c0; c < c1; ++c) {
    const int x = tb[(long long)c * W];
    tb[(long long)c * W] = run;
    run = max(run, x);
  }
}

template <int W>
__global__ void __launch_bounds__(RANK_WARPS * 32)
mtf_rank_kernel(const int* __restrict__ seqs, const int* __restrict__ carry,
                int* __restrict__ out, int n_chunks) {
  constexpr int PER = W / 32;  // table entries per lane
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * RANK_WARPS + (threadIdx.x >> 5), b = blockIdx.y;
  if (t >= n_chunks) return;  // the whole warp leaves; no block barrier follows

  int last[PER];  // last[q] is the entry of symbol q * 32 + lane
  const int* cb = carry + ((long long)b * n_chunks + t) * W;
#pragma unroll
  for (int q = 0; q < PER; ++q) last[q] = cb[q * 32 + lane];

  const long long off = ((long long)b * n_chunks + t) * CHUNK;
  const int* src = seqs + off;
  int* dst = out + off;
  int v = src[lane];
  for (int base = 0; base < CHUNK; base += 32) {
    const int cur = v;
    if (base + 32 < CHUNK) v = src[base + 32 + lane];  // the next 32, in flight
    int mine = W;  // this lane's rank: position base + lane
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const unsigned s = (unsigned)__shfl_sync(FULL, cur, j);
      if (s < W) {  // uniform across the warp
        const int k = s >> 5, owner = s & 31;
        int sel = last[0];
#pragma unroll
        for (int q = 1; q < PER; ++q)
          if (k == q) sel = last[q];
        const int own = __shfl_sync(FULL, sel, owner);
        unsigned cnt = 0;
#pragma unroll
        for (int q = 0; q < PER; ++q) cnt += last[q] > own;
        const int r = (int)__reduce_add_sync(FULL, cnt);
        if (lane == j) mine = r;
        if (lane == owner) {
          const int pos = t * CHUNK + base + j;
#pragma unroll
          for (int q = 0; q < PER; ++q)
            if (k == q) last[q] = pos;
        }
      }
    }
    dst[base + lane] = mine;
  }
}

template <int W>
int launch(const int* seqs, int* out, int* tables, int batch, int n_chunks,
           cudaStream_t stream) {
  chunk_last_kernel<W><<<dim3(n_chunks, batch), LAST_THREADS, 0, stream>>>(
      seqs, tables, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  carry_scan_kernel<W><<<batch, SCAN_THREADS, 0, stream>>>(tables, n_chunks);
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
