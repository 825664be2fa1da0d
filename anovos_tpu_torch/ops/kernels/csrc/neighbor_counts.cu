// Within-eps neighbour counts of a point set: the DBSCAN count pass.
//
// Replaces: anovos_tpu/ops/pallas_kernels.py `neighbor_counts_pallas`
// (body `_neighbor_count_kernel`).  For every query point q of the centred
// (n, d) f32 set X it counts the points x of X, q itself included, with
//     d2 = (|q|^2 - 2 * (q . x)) + |x|^2  <=  eps2,
// evaluated in f32 in that order.  Every product and sum is rounded on its
// own and the sums over the d coordinates run in index order, so the bits
// of d2 are fixed and the plain PyTorch version (ops/kernels/
// neighbor_counts.py) repeats them with elementwise tensor operations.
// The dot product runs on CUDA cores: d is 2 for lat/lon, and TF32 would
// move which pairs count.
//
// Bound on the H100: operations, n^2 pairs of 2d + 3 each (d products and
// d - 1 sums of the dot, the doubling folded in, the two additions, the
// compare, the count); the bytes are the (n, d) input and the (n,) counts.
// The f32 peak counts an FMA as two operations, and the dot's products and
// sums must stay separate instructions to keep their rounding, so the
// instructions a pair set the ceiling: (2d + 3) / (2 x instructions).
//
// Design, in what it buys:
// 1. The card is filled at the geo path's 16,384 points.  The grid is
//    query tiles x source splits; the split count is chosen from n and the
//    card's resident blocks (SMs x blocks an SM) so that the blocks fill
//    whole waves.  Each block adds its partial counts into `counts`
//    (zeroed first) with integer atomics, which are exact in any order.
// 2. A thread owns 16 query rows in registers (8 above d = 2).  A pack
//    kernel writes each point once as 16-byte vectors: its d coordinates,
//    then its threshold T (below), padded to a multiple of 4 floats; a
//    block stages its split's points in shared memory, 512 at a time.  One
//    broadcast load then serves 16 pairs, and the source loop is unrolled
//    8 points deep.
// 3. The doubling is folded into the subtraction: u = fma(-2, dot, |q|^2).
//    2 * dot is exact in f32 wherever it does not overflow, so the FMA's
//    single rounding is the subtraction's.
// 4. The addition of |x|^2 is folded into the compare: fl(u + |x|^2) is
//    non-decreasing in u, so fl(u + |x|^2) <= eps2 holds exactly when u <=
//    T_x, the largest f32 u for which it holds.  The pack kernel finds T_x
//    by bisection over the ordered f32 bit patterns, 32 steps a point.
// 5. The count is the sign bit of fl(T_x - u), added by one LEA.HI, where
//    a compare and a select would take three instructions.
// A pair then costs FMUL, FMUL, FADD, FFMA, FADD and LEA.HI at d = 2: 6
// instructions and the loop's share, a ceiling of 7/12 of the bound.
//
// Steps 3-5 are exact only while 2 * dot cannot overflow and eps2 is
// finite.  Every squared norm below 2^126 keeps |2 * dot| below 2^127(1 +
// 1e-6).  The pack kernel gives a point that fails that test, or every
// point under a non-finite eps2, a NaN for T; a chunk that stages such a
// point, or whose block holds such a row, evaluates the literal expression
// above instead, so NaN, infinite and huge inputs count as the plain
// version counts them.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include "columns.cuh"

namespace {

using anovos::kThreads;                  // 256 threads a block
constexpr int kChunk = 512;              // source points staged at once
constexpr int kUnroll = 8;               // source points an unrolled step
constexpr int kMinSplit = 64;            // least source points a split
// a block's fixed work (its rows' loads and norms, the atomics), in points
constexpr int kBlockCost = 32;
// squared norms below this keep 2 * dot finite for every pair
constexpr float kFastNorm = 0x1p126f;

// 16-byte vectors a staged source point: d coordinates and T
template <int D>
__host__ __device__ constexpr int vecs() {
  return (D + 4) / 4;
}

// query rows a thread: 16 up to d = 2 (86 registers at d = 2), 8 above, so
// that the rows' coordinates stay in registers without spilling
template <int D>
__host__ __device__ constexpr int rows() {
  return D <= 2 ? 16 : 8;
}

template <int D>
__device__ __forceinline__ float sq_norm(const float* p) {
  float s = __fmul_rn(p[0], p[0]);
#pragma unroll
  for (int k = 1; k < D; ++k) s = __fadd_rn(s, __fmul_rn(p[k], p[k]));
  return s;
}

// f32 bit patterns mapped to unsigned keys in the order of their values
// (-0 just below +0); NaNs lie outside [key(-inf), key(+inf)]
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}

// The largest f32 u with fl(u + xx) <= eps2, for finite xx and eps2:
// bisection between -inf (where it holds) and +inf (where it does not).
// The keys span less than 2^32, so 32 halvings close the gap.
__device__ float count_threshold(float xx, float eps2) {
  unsigned lo = order_key(-INFINITY), hi = order_key(INFINITY);
  for (int it = 0; it < 32; ++it) {
    const unsigned mid = lo + ((hi - lo) >> 1);
    if (__fadd_rn(key_value(mid), xx) <= eps2)
      lo = mid;
    else
      hi = mid;
  }
  return key_value(lo);
}

// One thread a point: zero its count and pack it for the count kernel as
// 16-byte vectors, its coordinates and then T_x, or NaN for T_x where the
// folded form could differ from the literal one (a squared norm that is
// NaN, infinite or 2^126 or more, or a non-finite eps2).
template <int D>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const float* __restrict__ x, float eps2, float4* __restrict__ packed,
            int* __restrict__ counts, int n) {
  constexpr int V = vecs<D>();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float p[4 * V];
#pragma unroll
  for (int k = 0; k < 4 * V; ++k) p[k] = k < D ? x[(long long)i * D + k] : 0.f;
  const float xx = sq_norm<D>(p);
  p[D] = xx < kFastNorm && fabsf(eps2) <= FLT_MAX ? count_threshold(xx, eps2) : NAN;
#pragma unroll
  for (int v = 0; v < V; ++v)
    packed[(long long)i * V + v] =
        make_float4(p[4 * v], p[4 * v + 1], p[4 * v + 2], p[4 * v + 3]);
  counts[i] = 0;
}

template <int D>
__device__ __forceinline__ void staged_point(const float4* s, int j, float* p) {
  constexpr int V = vecs<D>();
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float4 f = s[j * V + v];
    p[4 * v] = f.x; p[4 * v + 1] = f.y; p[4 * v + 2] = f.z; p[4 * v + 3] = f.w;
  }
}

template <int D>
__device__ __forceinline__ float dot_rn(const float* q, const float* p) {
  float dot = __fmul_rn(q[0], p[0]);
#pragma unroll
  for (int k = 1; k < D; ++k) dot = __fadd_rn(dot, __fmul_rn(q[k], p[k]));
  return dot;
}

// The pairs of m staged points (a multiple of kUnroll) with the thread's
// rows: u = fl(|q|^2 - 2 dot) by one FMA, and c[r] counts the pairs beyond
// eps, u > T_x.  For finite u the sign of fl(T_x - u) is exact (it is +0
// where they are equal, and T_x is never -0), so the sign bit is the count,
// added by one instruction.
template <int D, int R = rows<D>()>
__device__ __forceinline__ void fast_pairs(const float4* s, int m, const float (&q)[R][D],
                                           const float (&qq)[R], unsigned (&c)[R]) {
  for (int j = 0; j < m; j += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float p[4 * vecs<D>()];
      staged_point<D>(s, j + u, p);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float v = __fmaf_rn(-2.f, dot_rn<D>(q[r], p), qq[r]);
        c[r] += __float_as_uint(__fsub_rn(p[D], v)) >> 31;
      }
    }
  }
}

// the same pairs by the literal expression, rounded step by step; c[r]
// counts the pairs beyond eps, d2 > eps2 or NaN
template <int D, int R = rows<D>()>
__device__ __forceinline__ void literal_pairs(const float4* s, int m, const float (&q)[R][D],
                                              const float (&qq)[R], float eps2,
                                              unsigned (&c)[R]) {
  for (int j = 0; j < m; ++j) {
    float p[4 * vecs<D>()];
    staged_point<D>(s, j, p);
    const float xx = sq_norm<D>(p);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float d2 = __fadd_rn(__fsub_rn(qq[r], __fmul_rn(2.f, dot_rn<D>(q[r], p))), xx);
      c[r] += d2 <= eps2 ? 0u : 1u;
    }
  }
}

// Block (tile, split): the tile's 256 x rows<D>() query rows against the
// split's packed points, staged kChunk at a time.  A chunk whose points all
// have a T_x (none is NaN), with rows whose squared norms all lie below
// 2^126, takes the fast form; any other takes the literal one.  The fast
// form runs over the chunk padded to a multiple of kUnroll with points at
// the origin whose T is -inf (beyond eps for every row); the literal form
// stops at the chunk's real points.  A row's count is the points compared
// less those beyond eps.
template <int D>
__global__ void __launch_bounds__(kThreads)
count_kernel(const float* __restrict__ x, const float4* __restrict__ packed, float eps2,
             int* __restrict__ counts, int n, int split_len) {
  constexpr int V = vecs<D>(), R = rows<D>();
  __shared__ float4 s_pts[kChunk * V];
  const int row0 = blockIdx.x * (kThreads * R) + threadIdx.x;
  float q[R][D], qq[R];
  unsigned c[R];
  bool rows_fast = true;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r * kThreads;
#pragma unroll
    for (int k = 0; k < D; ++k) q[r][k] = i < n ? x[(long long)i * D + k] : 0.f;
    qq[r] = sq_norm<D>(q[r]);
    rows_fast = rows_fast && qq[r] < kFastNorm;
    c[r] = 0;
  }
  const int s0 = blockIdx.y * split_len;
  const int s1 = min(n, s0 + split_len);
  unsigned compared = 0;
  for (int base = s0; base < s1; base += kChunk) {
    const int m = min(kChunk, s1 - base);
    const int mr = (m + kUnroll - 1) / kUnroll * kUnroll;
    bool fast = rows_fast;
    __syncthreads();  // every thread is done with the previous chunk
    for (int t = threadIdx.x; t < mr * V; t += kThreads) {
      float4 f;
      if (t < m * V) {
        f = packed[(long long)base * V + t];
      } else {  // padding: the origin, T = -inf
        const int slot = D - 4 * (t % V);  // the component that holds T, if 0..3
        f = make_float4(slot == 0 ? -INFINITY : 0.f, slot == 1 ? -INFINITY : 0.f,
                        slot == 2 ? -INFINITY : 0.f, slot == 3 ? -INFINITY : 0.f);
      }
      if (t % V == D / 4) {
        const float tx = D % 4 == 0 ? f.x : D % 4 == 1 ? f.y : D % 4 == 2 ? f.z : f.w;
        fast = fast && tx == tx;
      }
      s_pts[t] = f;
    }
    if (__syncthreads_and(fast)) {
      fast_pairs<D>(s_pts, mr, q, qq, c);
      compared += mr;
    } else {
      literal_pairs<D>(s_pts, m, q, qq, eps2, c);
      compared += m;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r * kThreads;
    const int within = (int)(compared - c[r]);
    if (i < n && within != 0) atomicAdd(counts + i, within);
  }
}

anovos::Residency g_residency[8];

struct Plan {
  int tiles, splits, split_len, tile_rows;
};

// Query tiles, source splits and points a split.  Blocks of one tile take
// about equal time, (points a split, padded to kUnroll) + kBlockCost, so
// the launch takes waves x that, where a wave is the card's resident
// blocks; the split count minimizes it (the fewest splits among equals),
// with at least kMinSplit points a split.
template <int D>
cudaError_t plan(int n, int device, Plan* p) {
  int resident = 0;
  const cudaError_t err = g_residency[D - 1].get(count_kernel<D>, device, 0, &resident);
  if (err != cudaSuccess) return err;
  const long long tile = kThreads * rows<D>();
  const long long tiles = ((long long)n + tile - 1) / tile;
  const long long most = ((long long)n + kMinSplit - 1) / kMinSplit;
  const long long cap = 8 * resident / tiles > 1 ? 8 * resident / tiles : 1;
  long long best = -1;
  for (long long s = 1; s <= (most < cap ? most : cap); ++s) {
    const long long len = (n + s - 1) / s;
    const long long splits = (n + len - 1) / len;
    const long long waves = (tiles * splits + resident - 1) / resident;
    const long long cost = waves * ((len + kUnroll - 1) / kUnroll * kUnroll + kBlockCost);
    if (best < 0 || cost < best) {
      best = cost;
      p->split_len = (int)len;
      p->splits = (int)splits;
    }
  }
  p->tiles = (int)tiles;
  p->tile_rows = (int)tile;
  return cudaSuccess;
}

template <int D>
cudaError_t launch(const float* x, float eps2, float* scratch, int* counts, int n, int device,
                   cudaStream_t stream) {
  Plan p;
  cudaError_t err = plan<D>(n, device, &p);
  if (err != cudaSuccess) return err;
  float4* packed = reinterpret_cast<float4*>(scratch);
  const int pack_blocks = (int)(((long long)n + kThreads - 1) / kThreads);
  pack_kernel<D><<<pack_blocks, kThreads, 0, stream>>>(x, eps2, packed, counts, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  count_kernel<D><<<dim3(p.tiles, p.splits), kThreads, 0, stream>>>(x, packed, eps2, counts, n,
                                                                     p.split_len);
  return cudaGetLastError();
}

template <int D>
cudaError_t plan_of(int n, int device, int* out) {
  Plan p;
  const cudaError_t err = plan<D>(n, device, &p);
  if (err != cudaSuccess) return err;
  out[0] = p.tiles; out[1] = p.splits; out[2] = p.split_len; out[3] = p.tile_rows;
  return cudaSuccess;
}

}  // namespace

// f32 scratch the call needs for n points of width d: the packed points,
// 4 * ceil((d + 1) / 4) floats each.
extern "C" long long anovos_neighbor_counts_scratch(int n, int d) {
  return (long long)n * 4 * ((d + 4) / 4);
}

// The launch's shape for n > 0 points of width 1 <= d <= 8 on `device`:
// out[0..3] = query tiles, source splits, points a split, query rows a tile.
extern "C" int anovos_neighbor_counts_plan(int n, int d, int device, int* out) {
  const anovos::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  switch (d) {
    case 1: return plan_of<1>(n, device, out);
    case 2: return plan_of<2>(n, device, out);
    case 3: return plan_of<3>(n, device, out);
    case 4: return plan_of<4>(n, device, out);
    case 5: return plan_of<5>(n, device, out);
    case 6: return plan_of<6>(n, device, out);
    case 7: return plan_of<7>(n, device, out);
    case 8: return plan_of<8>(n, device, out);
    default: return cudaErrorInvalidValue;
  }
}

// x (n, d) f32 contiguous on `device`, 1 <= d <= 8, n > 0; scratch
// anovos_neighbor_counts_scratch(n, d) f32, 16-byte aligned; counts (n,)
// int32.  Launches two kernels on `stream` (the first zeroes the counts)
// and returns the first error code; the caller's current device is kept.
extern "C" int anovos_neighbor_counts(const float* x, float eps2, float* scratch, int* counts,
                                      int n, int d, int device, cudaStream_t stream) {
  const anovos::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  switch (d) {
    case 1: return launch<1>(x, eps2, scratch, counts, n, device, stream);
    case 2: return launch<2>(x, eps2, scratch, counts, n, device, stream);
    case 3: return launch<3>(x, eps2, scratch, counts, n, device, stream);
    case 4: return launch<4>(x, eps2, scratch, counts, n, device, stream);
    case 5: return launch<5>(x, eps2, scratch, counts, n, device, stream);
    case 6: return launch<6>(x, eps2, scratch, counts, n, device, stream);
    case 7: return launch<7>(x, eps2, scratch, counts, n, device, stream);
    case 8: return launch<8>(x, eps2, scratch, counts, n, device, stream);
    default: return cudaErrorInvalidValue;  // the wrapper refuses other widths
  }
}
