// k-nearest-neighbor search for 2-D swarms, two kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   knn_fused  <- marl_distributedformation_tpu/ops/knn_pallas.py::_knn_kernel
//   knn_tiled  <- marl_distributedformation_tpu/ops/knn_pallas.py::_knn_kernel_chunked
//
// Contract (shared with the plain PyTorch version, ops/knn.py):
//   points (M, N, 2) f32, valid (M, N) bool or null
//   -> idx (M, N, K) int32, offsets (M, N, K, 2) f32, dists (M, N, K) f32,
//   sorted ascending; self and invalid columns carry the finite distance
//   SELF_MASK and lose to every real neighbor; a slot left at SELF_MASK
//   becomes a self-loop (idx = i, offset 0, dist 0); ties go to the lower
//   column index.
//
// Neither kernel carries the TPU blocks over. The TPU kernels hold a full
// (Np, Np) distance matrix in VMEM and run K argmin passes over it; here each
// thread owns one query row, scans the columns in ascending order out of
// shared memory and keeps a K-deep sorted (distance, column) list in
// registers, so no distance matrix exists anywhere.
//
// What bounds them on an H100: at the main path's shapes the fused kernel
// (M=4096, N=100, K=4) has 41 M pairs against 29 MB of input and output, so
// the bytes bound it (~9 us at 3.35 TB/s); the tiled kernel (M=512, N=1024)
// has 537 M pairs, so the per-pair arithmetic bounds it. The per-pair work is
// five float operations plus one compare against the K-th best; the insertion
// runs only for the few candidates that beat it.
//
// Rounding: the squared distance is written with __fsub_rn/__fmul_rn/
// __fadd_rn so that nvcc cannot contract it into an FMA, which would round
// differently from the CPU and the plain version and flip near-ties in idx.
// sqrtf is IEEE-rounded (no --use_fast_math, -prec-sqrt=true).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kSelfMask = 1e12f;
constexpr int kTiledRows = 128;    // query rows (threads) per CTA
constexpr int kTiledCols = 512;    // columns staged per shared-memory tile

__device__ __forceinline__ float sq_dist(float xi, float yi, float xj,
                                         float yj) {
  const float dx = __fsub_rn(xi, xj);
  const float dy = __fsub_rn(yi, yj);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// Running K smallest (distance, column) pairs, sorted ascending, compared
// lexicographically: an equal distance never displaces a lower column. This
// reproduces lax.top_k's tie order whatever order the columns arrive in.
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
    if (!(cd < d[K - 1] || (cd == d[K - 1] && ci < i[K - 1]))) return;
#pragma unroll
    for (int p = 0; p < K; ++p) {  // bubble the candidate into place
      const bool take = cd < d[p] || (cd == d[p] && ci < i[p]);
      const float td = d[p];
      const int ti = i[p];
      d[p] = take ? cd : td;
      i[p] = take ? ci : ti;
      cd = take ? td : cd;
      ci = take ? ti : ci;
    }
  }
};

// Writes one query row's K results. (nx, ny) of neighbor j come from
// pos(j); slots still at SELF_MASK become self-loops.
template <int K, typename Pos>
__device__ __forceinline__ void write_row(const TopK<K>& t, size_t row, int i,
                                          float xi, float yi, Pos pos,
                                          int32_t* __restrict__ idx,
                                          float* __restrict__ off,
                                          float* __restrict__ dist) {
#pragma unroll
  for (int p = 0; p < K; ++p) {
    const bool real = t.d[p] < 0.5f * kSelfMask;
    const size_t o = row * K + p;
    float ox = 0.0f, oy = 0.0f, dd = 0.0f;
    if (real) {
      const float2 q = pos(t.i[p]);
      ox = __fsub_rn(q.x, xi);
      oy = __fsub_rn(q.y, yi);
      dd = sqrtf(t.d[p]);
    }
    idx[o] = real ? t.i[p] : i;
    off[2 * o] = ox;
    off[2 * o + 1] = oy;
    dist[o] = dd;
  }
}

// One CTA per formation: the formation's positions and valid flags sit in
// shared memory (9 bytes a point), each thread scans every column for the
// rows it owns.
template <int K>
__global__ void knn_fused_kernel(const float2* __restrict__ pts,
                                 const uint8_t* __restrict__ valid, int n,
                                 int32_t* __restrict__ idx,
                                 float* __restrict__ off,
                                 float* __restrict__ dist) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = smem + n;
  uint8_t* sv = reinterpret_cast<uint8_t*>(smem + 2 * n);
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float2 p = pts[base + j];
    sx[j] = p.x;
    sy[j] = p.y;
    sv[j] = valid ? valid[base + j] : 1;
  }
  __syncthreads();
  auto pos = [&](int j) { return make_float2(sx[j], sy[j]); };
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float xi = sx[i], yi = sy[i];
    TopK<K> t;
    t.init();
    for (int j = 0; j < n; ++j) {
      const float d =
          (j == i || !sv[j]) ? kSelfMask : sq_dist(xi, yi, sx[j], sy[j]);
      t.insert(d, j);
    }
    write_row<K>(t, base + i, i, xi, yi, pos, idx, off, dist);
  }
}

// Grid (formation x block of kTiledRows query rows), flattened into x. The
// columns stream through shared memory in kTiledCols tiles, so shared
// memory stays at 4.5 KB whatever N is; the running top-K stays in
// registers across tiles.
template <int K>
__global__ void __launch_bounds__(kTiledRows)
    knn_tiled_kernel(const float2* __restrict__ pts,
                     const uint8_t* __restrict__ valid, int n,
                     int row_blocks, int32_t* __restrict__ idx,
                     float* __restrict__ off, float* __restrict__ dist) {
  __shared__ float sx[kTiledCols];
  __shared__ float sy[kTiledCols];
  __shared__ uint8_t sv[kTiledCols];
  const int m = blockIdx.x / row_blocks;
  const int i = (blockIdx.x % row_blocks) * kTiledRows + threadIdx.x;
  const size_t base = static_cast<size_t>(m) * n;
  const bool active = i < n;
  float2 self = make_float2(0.0f, 0.0f);
  if (active) self = pts[base + i];
  TopK<K> t;
  t.init();
  for (int c0 = 0; c0 < n; c0 += kTiledCols) {
    const int cn = min(kTiledCols, n - c0);
    for (int j = threadIdx.x; j < cn; j += kTiledRows) {
      const float2 p = pts[base + c0 + j];
      sx[j] = p.x;
      sy[j] = p.y;
      sv[j] = valid ? valid[base + c0 + j] : 1;
    }
    __syncthreads();
    if (active) {
      for (int jj = 0; jj < cn; ++jj) {
        const int j = c0 + jj;
        const float d = (j == i || !sv[jj])
                            ? kSelfMask
                            : sq_dist(self.x, self.y, sx[jj], sy[jj]);
        t.insert(d, j);
      }
    }
    __syncthreads();
  }
  if (active) {
    auto pos = [&](int j) { return pts[base + j]; };
    write_row<K>(t, base + i, i, self.x, self.y, pos, idx, off, dist);
  }
}

template <int K>
cudaError_t launch_fused(const float2* pts, const uint8_t* valid, int m,
                         int n, int32_t* idx, float* off, float* dist,
                         cudaStream_t stream) {
  const int threads = n >= 256 ? 256 : ((n + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(n) * (2 * sizeof(float) + 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        knn_fused_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  knn_fused_kernel<K><<<m, threads, smem, stream>>>(pts, valid, n, idx, off,
                                                    dist);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_tiled(const float2* pts, const uint8_t* valid, int m,
                         int n, int32_t* idx, float* off, float* dist,
                         cudaStream_t stream) {
  const int row_blocks = (n + kTiledRows - 1) / kTiledRows;
  const long long blocks = static_cast<long long>(m) * row_blocks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  knn_tiled_kernel<K><<<static_cast<unsigned>(blocks), kTiledRows, 0,
                        stream>>>(pts, valid, n, row_blocks, idx, off, dist);
  return cudaGetLastError();
}

#define KNN_DISPATCH_K(LAUNCH)                                         \
  const auto* p = static_cast<const float2*>(points);                  \
  const auto* v = static_cast<const uint8_t*>(valid);                  \
  auto* i = static_cast<int32_t*>(idx);                                \
  auto* o = static_cast<float*>(off);                                  \
  auto* d = static_cast<float*>(dist);                                 \
  auto s = static_cast<cudaStream_t>(stream);                          \
  switch (k) {                                                         \
    case 1: return LAUNCH<1>(p, v, m, n, i, o, d, s);                  \
    case 2: return LAUNCH<2>(p, v, m, n, i, o, d, s);                  \
    case 3: return LAUNCH<3>(p, v, m, n, i, o, d, s);                  \
    case 4: return LAUNCH<4>(p, v, m, n, i, o, d, s);                  \
    case 5: return LAUNCH<5>(p, v, m, n, i, o, d, s);                  \
    case 6: return LAUNCH<6>(p, v, m, n, i, o, d, s);                  \
    case 7: return LAUNCH<7>(p, v, m, n, i, o, d, s);                  \
    case 8: return LAUNCH<8>(p, v, m, n, i, o, d, s);                  \
    default: return cudaErrorInvalidValue;                             \
  }

}  // namespace

// Plain C interface, loaded with ctypes (ops/knn_cuda.py). Each returns the
// launch's cudaError_t, 0 on success; k outside 1..8 gives
// cudaErrorInvalidValue. The caller checks shapes, types, alignment and
// contiguity and allocates the outputs.
extern "C" int knn_fused_launch(const void* points, const void* valid, int m,
                                int n, int k, void* idx, void* off,
                                void* dist, void* stream) {
  KNN_DISPATCH_K(launch_fused)
}

extern "C" int knn_tiled_launch(const void* points, const void* valid, int m,
                                int n, int k, void* idx, void* off,
                                void* dist, void* stream) {
  KNN_DISPATCH_K(launch_tiled)
}
