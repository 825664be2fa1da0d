// Within-eps neighbour counts of a point set: the DBSCAN count pass.
//
// Replaces: anovos_tpu/ops/pallas_kernels.py `neighbor_counts_pallas`
// (body `_neighbor_count_kernel`).  For every query point q of the centred
// (n, d) f32 set X it counts the points x of X, q itself included, with
//     d2 = (|q|^2 - 2 * (q . x)) + |x|^2  <=  eps2,
// evaluated in f32 in that order.  Every product and sum is rounded on its
// own (__fmul_rn / __fadd_rn / __fsub_rn, which nvcc never contracts into an
// FMA) and the sums over the d coordinates run in index order, so the bits
// of d2 are fixed and the plain PyTorch version (ops/kernels/
// neighbor_counts.py) repeats them with elementwise tensor operations.
// The dot product runs on CUDA cores: d is 2 for lat/lon, and TF32 would
// move which pairs count.
//
// Bound on the H100: operations.  This kernel spends 2d + 4 operations on
// each of the n^2 pairs (d products and d - 1 sums for the dot, the
// doubling, the subtraction, the addition, the compare and the count); the
// function needs 2d + 3, since -2q could be formed once per query.  The
// bytes are the (n, d) input read once and the (n,) counts written once.
// Every operation is its own instruction (no FMA), so the f32 pipes retire
// at most half the data sheet's FMA-counted rate of them.
//
// Design: one thread owns one query row and keeps its count in a register,
// so no atomics are needed and the (n, n) distance block never exists.  A
// block of 256 query rows walks the whole set in chunks of 1024 source
// points staged in shared memory with their squared norms; every thread of
// the block reads the same staged point at once (a broadcast).  The width d
// is a template parameter (1..8), so a query row's coordinates live in
// registers.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;

template <int D>
__device__ __forceinline__ float sq_norm(const float* p) {
  float s = __fmul_rn(p[0], p[0]);
#pragma unroll
  for (int k = 1; k < D; ++k) s = __fadd_rn(s, __fmul_rn(p[k], p[k]));
  return s;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
neighbor_count_kernel(const float* __restrict__ x, float eps2, int* __restrict__ counts, int n) {
  __shared__ float s_x[kChunk * D];
  __shared__ float s_norm[kChunk];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;
  float q[D];
#pragma unroll
  for (int k = 0; k < D; ++k) q[k] = live ? x[(long long)i * D + k] : 0.f;
  const float qq = sq_norm<D>(q);
  int count = 0;
  for (int base = 0; base < n; base += kChunk) {
    const int m = min(kChunk, n - base);
    __syncthreads();  // every thread is done with the previous chunk
    for (int t = threadIdx.x; t < m; t += kThreads) {
      float p[D];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        p[k] = x[(long long)(base + t) * D + k];
        s_x[t * D + k] = p[k];
      }
      s_norm[t] = sq_norm<D>(p);
    }
    __syncthreads();
    if (live) {
      for (int j = 0; j < m; ++j) {
        float dot = __fmul_rn(q[0], s_x[j * D]);
#pragma unroll
        for (int k = 1; k < D; ++k) dot = __fadd_rn(dot, __fmul_rn(q[k], s_x[j * D + k]));
        const float d2 = __fadd_rn(__fsub_rn(qq, __fmul_rn(2.f, dot)), s_norm[j]);
        count += d2 <= eps2 ? 1 : 0;
      }
    }
  }
  if (live) counts[i] = count;
}

template <int D>
void launch(const float* x, float eps2, int* counts, int n, cudaStream_t stream) {
  neighbor_count_kernel<D><<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(x, eps2, counts, n);
}

}  // namespace

// x (n, d) f32 contiguous on `device`, 1 <= d <= 8, n > 0; counts (n,)
// int32.  Launches on `stream`; returns the launch's error code.
extern "C" int anovos_neighbor_counts(const float* x, float eps2, int* counts, int n, int d,
                                      int device, cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  switch (d) {
    case 1: launch<1>(x, eps2, counts, n, stream); break;
    case 2: launch<2>(x, eps2, counts, n, stream); break;
    case 3: launch<3>(x, eps2, counts, n, stream); break;
    case 4: launch<4>(x, eps2, counts, n, stream); break;
    case 5: launch<5>(x, eps2, counts, n, stream); break;
    case 6: launch<6>(x, eps2, counts, n, stream); break;
    case 7: launch<7>(x, eps2, counts, n, stream); break;
    case 8: launch<8>(x, eps2, counts, n, stream); break;
    default: return cudaErrorInvalidValue;  // the wrapper refuses other widths
  }
  return cudaGetLastError();
}
