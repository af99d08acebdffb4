// k-nearest-neighbor search for 2-D swarms, two kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   knn_fused  <- marl_distributedformation_tpu/ops/knn_pallas.py::_knn_kernel
//   knn_tiled  <- marl_distributedformation_tpu/ops/knn_pallas.py::_knn_kernel_chunked
//
// Contract (shared with the plain PyTorch version, ops/knn.py):
//   points (M, N, 2) f32, valid (M, N) bool or null
//   -> idx (M, N, K) int32, offsets (M, N, K, 2) f32, dists (M, N, K) f32,
//   sorted ascending; self and invalid columns are never chosen while a real
//   neighbor is left; a slot left over becomes a self-loop (idx = i, offset 0,
//   dist 0), as does any slot at or above 0.5 * SELF_MASK; ties go to the
//   lower column index.
//
// Neither kernel carries the TPU blocks over. The TPU kernels hold a full
// (Np, Np) distance matrix in VMEM and run K argmin passes over it; here a
// thread owns query rows, scans the columns in ascending order out of shared
// memory and keeps a K-deep sorted (distance, column) list per row in
// registers, so no distance matrix exists anywhere.
//
// The scan, shared by both kernels (scan_group):
// - Columns arrive in ascending order, so every column already in a list is
//   lower than the candidate. "(d, col) lexicographically smaller than the
//   K-th entry" is then exactly "d < K-th distance", one float compare, and
//   the insertion places the candidate after entries of equal distance.
// - Invalid columns are written into shared memory as NaN once, when staged.
//   A NaN distance compares false with everything, so such a column never
//   enters a list; a list slot still at its initial +inf after the scan
//   becomes a self-loop. The same holds for the padding that rounds a run of
//   columns up to whole groups.
// - The lists start empty, so the first group of columns is inserted one by
//   one with its distances still in registers (fill_group): every lane
//   inserts there, and a test would only add work.
// - Every later group of G columns is tested against the row's K-th
//   distance as it stood before the group, into a bit mask; only the set
//   bits are then inserted (__ffs loop), each recomputed and re-tested
//   against the current K-th distance. A warp pays for insertion once per
//   group and hit of its busiest lane, not on every column where one of its
//   lanes inserts. The self column (distance 0) is dropped in that loop, so
//   the common path carries no self test. A packed (distance bits, column)
//   key would need two integer compares and its building per pair; the
//   ascending scan makes one float compare exact.
//
// What bounds them on an H100 (NVIDIA H100 SXM: 3.35 TB/s, 67 TFLOP/s f32):
// - knn_fused at its main shape (M=4096, N=100, K=4): 41 M pairs against
//   29.5 MB of input and output, so the bytes bound it (~8.8 us). The design
//   gives every lane a row (a CTA takes a run of rows that may cross
//   formations, and stages each formation it touches) and writes each row's
//   K results as 16-byte vector stores from adjacent threads. What holds it
//   back is the insertions: at N=100 a row sees ~17 of them, most in the
//   first columns, and a warp runs each group's loop as long as its busiest
//   lane, so they cost about as much as the ~8.5 instructions a pair of the
//   common path.
// - knn_tiled at its main shape (M=512, N=1024, K=4): 537 M pairs, so the
//   arithmetic bounds it: 48 us counting 6 operations a pair at 67 TFLOP/s,
//   which counts an FMA as two. The distance is kept unfused (below), so at
//   one instruction per lane and cycle the floor is ~96 us for 6
//   instructions a pair. The common path is near that: each thread owns
//   kTiledRowsPerThread rows of one formation, so one 8-byte shared load
//   feeds that many distances, and a pair costs 5 float operations, a
//   compare and ~1.5 integer operations for the mask. Column tiles are
//   copied with cp.async into two buffers, the next tile in flight while the
//   current one is scanned, one barrier a tile.
//
// Rounding: the squared distance is written with __fsub_rn/__fmul_rn/
// __fadd_rn so that nvcc cannot contract it into an FMA, which would round
// differently from the CPU and the plain version and flip near-ties in idx.
// sqrtf is IEEE-rounded (no --use_fast_math, -prec-sqrt=true).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr float kSelfMask = 1e12f;
// Columns tested per group, per kernel. ops/knn_cuda.py::FUSED_GROUP pads
// the fused kernel's shared-memory stride to a multiple of kFusedGroup.
constexpr int kFusedGroup = 16;
constexpr int kTiledGroup = 32;
constexpr int kFusedMaxThreads = 256;
constexpr int kTiledThreads = 128;
constexpr int kTiledRowsPerThread = 2;
constexpr int kTiledRows = kTiledThreads * kTiledRowsPerThread;  // per CTA
constexpr int kTileCols = 1024;  // columns a shared-memory tile holds

__device__ __forceinline__ float2 nan2() {
  const float q = __int_as_float(0x7fffffff);
  return make_float2(q, q);
}

__device__ __forceinline__ float sq_dist(float2 a, float2 b) {
  const float dx = __fsub_rn(a.x, b.x);
  const float dy = __fsub_rn(a.y, b.y);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// Running K smallest (distance, column) pairs, sorted ascending. Columns
// are inserted in ascending order, so "smaller" is the distance alone and
// an equal distance keeps the lower column ahead.
template <int K>
struct TopK {
  float d[K];
  int i[K];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int p = 0; p < K; ++p) {
      d[p] = INFINITY;
      i[p] = INT_MAX;
    }
  }

  __device__ __forceinline__ void insert(float cd, int ci) {
    if (!(cd < d[K - 1])) return;
#pragma unroll
    for (int p = K - 1; p > 0; --p) {  // shift down the entries above cd
      const bool shift = cd < d[p - 1];
      const bool here = !shift && cd < d[p];
      d[p] = shift ? d[p - 1] : (here ? cd : d[p]);
      i[p] = shift ? i[p - 1] : (here ? ci : i[p]);
    }
    if (cd < d[0]) {
      d[0] = cd;
      i[0] = ci;
    }
  }
};

// Inserts the G columns cols[j0 .. j0 + G) into the R rows' lists one by
// one (the lists start empty, so every column but self and NaN ones goes
// in); col0 + j is column j's index in the formation.
template <int G, int K, int R>
__device__ __forceinline__ void fill_group(TopK<K> (&t)[R],
                                           const float2 (&me)[R],
                                           const int (&self)[R],
                                           const float2* cols, int j0,
                                           int col0) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float2 c = cols[j0 + g];
    const int col = col0 + j0 + g;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (col != self[r]) t[r].insert(sq_dist(me[r], c), col);
  }
}

// Scans the G columns cols[j0 .. j0 + G) for R rows (me[r], own column
// self[r]); col0 + j is column j's index in the formation.
template <int G, int K, int R>
__device__ __forceinline__ void scan_group(TopK<K> (&t)[R],
                                           const float2 (&me)[R],
                                           const int (&self)[R],
                                           const float2* cols, int j0,
                                           int col0) {
  unsigned bits[R];
  float thr[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    bits[r] = 0u;
    thr[r] = t[r].d[K - 1];
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float2 c = cols[j0 + g];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (sq_dist(me[r], c) < thr[r]) bits[r] |= 1u << g;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    while (bits[r]) {
      const int j = j0 + __ffs(bits[r]) - 1;
      bits[r] &= bits[r] - 1u;
      const int col = col0 + j;
      if (col == self[r]) continue;
      t[r].insert(sq_dist(me[r], cols[j]), col);
    }
  }
}

// Stores W consecutive 32-bit words as 16- or 8-byte vectors where W allows
// (the row's start is then aligned to the vector: the outputs come from
// torch.empty), else word by word.
template <int W>
__device__ __forceinline__ void store_words(uint32_t* dst,
                                            const uint32_t (&w)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int c = 0; c < W; c += 4)
      *reinterpret_cast<uint4*>(dst + c) =
          make_uint4(w[c], w[c + 1], w[c + 2], w[c + 3]);
  } else if constexpr (W % 2 == 0) {
#pragma unroll
    for (int c = 0; c < W; c += 2)
      *reinterpret_cast<uint2*>(dst + c) = make_uint2(w[c], w[c + 1]);
  } else {
#pragma unroll
    for (int c = 0; c < W; ++c) dst[c] = w[c];
  }
}

// Writes one query row's K results (row = m * N + i). pos(j) is column j's
// position; slots at or above 0.5 * SELF_MASK (unfilled ones hold +inf)
// become self-loops.
template <int K, typename Pos>
__device__ __forceinline__ void write_row(const TopK<K>& t, size_t row, int i,
                                          float2 me, Pos pos,
                                          int32_t* __restrict__ idx,
                                          float* __restrict__ off,
                                          float* __restrict__ dist) {
  uint32_t wi[K], wo[2 * K], wd[K];
#pragma unroll
  for (int p = 0; p < K; ++p) {
    const bool real = t.d[p] < 0.5f * kSelfMask;
    const int j = real ? t.i[p] : i;
    const float2 q = pos(j);
    wi[p] = static_cast<uint32_t>(j);
    wo[2 * p] = __float_as_uint(real ? __fsub_rn(q.x, me.x) : 0.0f);
    wo[2 * p + 1] = __float_as_uint(real ? __fsub_rn(q.y, me.y) : 0.0f);
    wd[p] = __float_as_uint(real ? sqrtf(t.d[p]) : 0.0f);
  }
  store_words<K>(reinterpret_cast<uint32_t*>(idx) + row * K, wi);
  store_words<2 * K>(reinterpret_cast<uint32_t*>(off) + row * 2 * K, wo);
  store_words<K>(reinterpret_cast<uint32_t*>(dist) + row * K, wd);
}

// A CTA owns blockDim.x consecutive query rows of the flattened (M*N) rows,
// one a thread, whatever formations they fall in. It stages every formation
// those rows touch in shared memory, `stride` float2 a formation (N rounded
// up to whole groups, the padding NaN), invalid points as NaN.
template <int K>
__global__ void __launch_bounds__(kFusedMaxThreads)
    knn_fused_kernel(const float2* __restrict__ pts,
                     const uint8_t* __restrict__ valid, int m, int n,
                     int stride, int32_t* __restrict__ idx,
                     float* __restrict__ off, float* __restrict__ dist) {
  extern __shared__ float2 cols_smem[];
  const int total = m * n;  // below 2**31, checked by the caller
  const int r0 = blockIdx.x * blockDim.x;
  const int r_end = r0 + min(total - r0, static_cast<int>(blockDim.x));
  const int f0 = r0 / n;
  const int nf = (r_end - 1) / n - f0 + 1;
  for (int q = threadIdx.x; q < nf * stride; q += blockDim.x) {
    const int f = q / stride;
    const int j = q - f * stride;
    float2 p = nan2();
    if (j < n) {
      const size_t g = static_cast<size_t>(f0 + f) * n + j;
      if (!valid || valid[g]) p = pts[g];
    }
    cols_smem[q] = p;
  }
  __syncthreads();
  const int row = r0 + threadIdx.x;
  if (row >= total) return;
  const int f = row / n;
  const int i = row - f * n;
  const float2* cols = cols_smem + static_cast<size_t>(f - f0) * stride;
  const float2 me[1] = {pts[row]};
  const int self[1] = {i};
  TopK<K> t[1];
  t[0].init();
  fill_group<kFusedGroup, K, 1>(t, me, self, cols, 0, 0);
  for (int j0 = kFusedGroup; j0 < stride; j0 += kFusedGroup)
    scan_group<kFusedGroup, K, 1>(t, me, self, cols, j0, 0);
  write_row<K>(t[0], static_cast<size_t>(row), i, me[0],
               [&](int j) { return cols[j]; }, idx, off, dist);
}

__device__ __forceinline__ void cp_async8(float2* dst, const float2* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}

// Starts the copy of columns [c0, c0 + cn) into buf, padding with NaN up to
// whole groups. Thread tid issues columns tid, tid + kTiledThreads, ...
__device__ __forceinline__ void issue_tile(float2* buf,
                                           const float2* __restrict__ pts,
                                           size_t base, int c0, int cn) {
  const int padded = (cn + kTiledGroup - 1) / kTiledGroup * kTiledGroup;
  for (int q = threadIdx.x; q < padded; q += kTiledThreads) {
    if (q < cn)
      cp_async8(buf + q, pts + base + c0 + q);
    else
      buf[q] = nan2();
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Grid (formation x block of kTiledRows query rows), flattened into x.
// Thread t owns rows t, t + kTiledThreads, ... of the block (adjacent
// threads, adjacent rows: coalesced stores). The columns stream through
// shared memory in kTileCols tiles, double-buffered; the running top-K
// stays in registers across tiles.
template <int K>
__global__ void __launch_bounds__(kTiledThreads)
    knn_tiled_kernel(const float2* __restrict__ pts,
                     const uint8_t* __restrict__ valid, int n,
                     int row_blocks, int32_t* __restrict__ idx,
                     float* __restrict__ off, float* __restrict__ dist) {
  constexpr int R = kTiledRowsPerThread;
  __shared__ float2 tiles[2][kTileCols];
  const int m = blockIdx.x / row_blocks;
  const int rb = blockIdx.x - m * row_blocks;
  const size_t base = static_cast<size_t>(m) * n;
  float2 me[R];
  int self[R];
  TopK<K> t[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    self[r] = rb * kTiledRows + r * kTiledThreads + threadIdx.x;
    me[r] = pts[base + min(self[r], n - 1)];  // rows past N scan, unwritten
    t[r].init();
  }
  const int n_tiles = (n + kTileCols - 1) / kTileCols;
  issue_tile(tiles[0], pts, base, 0, min(kTileCols, n));
  for (int ti = 0; ti < n_tiles; ++ti) {
    const int c0 = ti * kTileCols;
    const int cn = min(kTileCols, n - c0);
    float2* buf = tiles[ti & 1];
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    if (valid) {  // the same columns this thread copied
      for (int q = threadIdx.x; q < cn; q += kTiledThreads)
        if (!valid[base + c0 + q]) buf[q] = nan2();
    }
    __syncthreads();  // tile ti is whole; tile ti - 1 is no longer read
    if (ti + 1 < n_tiles)
      issue_tile(tiles[(ti + 1) & 1], pts, base, c0 + kTileCols,
                 min(kTileCols, n - c0 - kTileCols));
    const int padded = (cn + kTiledGroup - 1) / kTiledGroup * kTiledGroup;
    int j0 = 0;
    if (ti == 0) {
      fill_group<kTiledGroup, K, R>(t, me, self, buf, 0, 0);
      j0 = kTiledGroup;
    }
    for (; j0 < padded; j0 += kTiledGroup)
      scan_group<kTiledGroup, K, R>(t, me, self, buf, j0, c0);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (self[r] < n)
      write_row<K>(t[r], base + self[r], self[r], me[r],
                   [&](int j) { return pts[base + j]; }, idx, off, dist);
  }
}

struct Args {
  const float2* pts;
  const uint8_t* valid;
  int m, n;
  int32_t* idx;
  float* off;
  float* dist;
  cudaStream_t stream;
};

template <int K>
cudaError_t launch_fused(const Args& a, int threads, int stride, int span) {
  const size_t smem = static_cast<size_t>(span) * stride * sizeof(float2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        knn_fused_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long total = static_cast<long long>(a.m) * a.n;
  const long long blocks = (total + threads - 1) / threads;
  knn_fused_kernel<K><<<static_cast<unsigned>(blocks), threads, smem,
                        a.stream>>>(a.pts, a.valid, a.m, a.n, stride, a.idx,
                                    a.off, a.dist);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_tiled(const Args& a) {
  const int row_blocks = (a.n + kTiledRows - 1) / kTiledRows;
  const long long blocks = static_cast<long long>(a.m) * row_blocks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  knn_tiled_kernel<K><<<static_cast<unsigned>(blocks), kTiledThreads, 0,
                        a.stream>>>(a.pts, a.valid, a.n, row_blocks, a.idx,
                                    a.off, a.dist);
  return cudaGetLastError();
}

using FusedLaunch = cudaError_t (*)(const Args&, int, int, int);
using TiledLaunch = cudaError_t (*)(const Args&);
constexpr FusedLaunch kFused[] = {
    launch_fused<1>, launch_fused<2>, launch_fused<3>, launch_fused<4>,
    launch_fused<5>, launch_fused<6>, launch_fused<7>, launch_fused<8>};
constexpr TiledLaunch kTiled[] = {
    launch_tiled<1>, launch_tiled<2>, launch_tiled<3>, launch_tiled<4>,
    launch_tiled<5>, launch_tiled<6>, launch_tiled<7>, launch_tiled<8>};

Args make_args(const void* points, const void* valid, int m, int n,
               void* idx, void* off, void* dist, void* stream) {
  return {static_cast<const float2*>(points),
          static_cast<const uint8_t*>(valid),
          m,
          n,
          static_cast<int32_t*>(idx),
          static_cast<float*>(off),
          static_cast<float*>(dist),
          static_cast<cudaStream_t>(stream)};
}

}  // namespace

// Plain C interface, loaded with ctypes (ops/knn_cuda.py). Each returns the
// launch's cudaError_t, 0 on success; k outside 1..8 or a geometry the
// kernel cannot take gives cudaErrorInvalidValue. The caller checks shapes,
// types, alignment and contiguity and allocates the outputs.

// threads: rows a CTA owns (a multiple of 32, at most 256); stride: the
// shared-memory float2 a formation takes (N rounded up to a multiple of
// kFusedGroup); span: the most formations a CTA's rows touch, which the shared
// memory is sized for. ops/knn_cuda.py::fused_geometry computes all three;
// a span below what `threads` consecutive rows can touch is refused.
extern "C" int knn_fused_launch(const void* points, const void* valid, int m,
                                int n, int k, int threads, int stride,
                                int span, void* idx, void* off, void* dist,
                                void* stream) {
  if (k < 1 || k > 8 || threads < 32 || threads > kFusedMaxThreads ||
      threads % 32 || stride < n || stride % kFusedGroup ||
      span < std::min(m, (threads + n - 2) / n + 1))
    return cudaErrorInvalidValue;
  return kFused[k - 1](make_args(points, valid, m, n, idx, off, dist, stream),
                       threads, stride, span);
}

extern "C" int knn_tiled_launch(const void* points, const void* valid, int m,
                                int n, int k, void* idx, void* off,
                                void* dist, void* stream) {
  if (k < 1 || k > 8) return cudaErrorInvalidValue;
  return kTiled[k - 1](make_args(points, valid, m, n, idx, off, dist, stream));
}
