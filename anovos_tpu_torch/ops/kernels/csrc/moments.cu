// Single-pass masked moments of numeric columns.
//
// Replaces: anovos_tpu/ops/pallas_kernels.py `moments_pallas` (body
// `_moments_kernel`).  For each column it gives the (8, k) f32 accumulator
// [n, mean, M2, M3, M4, min, max, nonzero] over the rows whose mask is set,
// with M2..M4 the central sums of powers; ops/reductions.finalize_moments
// turns it into mean / variance / skewness / kurtosis.
//
// Bound on the H100: memory.  Each (row, column) is read once, 4 bytes of
// value and 1 byte of mask; the output is 32 bytes a column.  The update is
// about 30 f32 operations and one division a value, well under the card's
// f32 rate at this byte count.
//
// Design: layout is column-major, (k, rows), so a warp reads consecutive
// values of one column.  The grid is (row blocks x columns).  Each thread
// runs a Welford / Terriberry update over its rows in f32 (well conditioned
// for large means, where raw power sums cancel).  Every partial result
// keeps its mean relative to a reference value: a thread's first valid
// value.  For a column whose spread is small beside its mean (normal(1e5,
// 3)) the relative mean keeps the digits that a running f32 mean near 1e5
// would round away, whatever rows are masked (a null is stored as 0).  A
// merge moves the second partial onto the first one's reference; two
// references close to each other differ exactly in f32 (Sterbenz), so no
// digit is lost there.  min, max and nonzero are taken of the raw values.
// A warp merges its threads with Chan's formulas through shuffles, and the
// block merges its warps in shared memory.  Chan merges do not commute bit
// for bit and cannot be done with atomics, so each block writes its 9
// values to a (blocks, 9, k) scratch and a second launch merges each
// column's partials with one warp in a fixed order: the result is the same
// from run to run.
//
// Limit: n and nonzero are f32 counts, exact up to 2^24 valid rows a column,
// the same bound the Pallas kernel has.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 64;
constexpr long long kRowsPerBlock = (long long)kThreads * kRowsPerThread;
constexpr int kFields = 9;
// the Pallas kernel's empty-min / empty-max sentinel, so an all-masked
// column gives the same accumulator
constexpr float kBig = 3.4e38f;

// mean is relative to ref
struct Mom {
  float n, ref, mean, m2, m3, m4, mn, mx, nz;
};

__device__ __forceinline__ Mom empty_mom() {
  Mom a;
  a.n = 0.f; a.ref = 0.f; a.mean = 0.f; a.m2 = 0.f; a.m3 = 0.f; a.m4 = 0.f;
  a.mn = kBig; a.mx = -kBig; a.nz = 0.f;
  return a;
}

// one value into the running moments (Welford, with Terriberry's update of
// the third and fourth central sums); the first value becomes the reference
__device__ __forceinline__ void push(Mom& a, float x) {
  if (a.n == 0.f) a.ref = isfinite(x) ? x : 0.f;
  const float n1 = a.n;
  const float n = n1 + 1.f;
  const float delta = (x - a.ref) - a.mean;
  const float dn = delta / n;
  const float dn2 = dn * dn;
  const float t1 = delta * dn * n1;
  a.mean += dn;
  a.m4 += t1 * dn2 * (n * n - 3.f * n + 3.f) + 6.f * dn2 * a.m2 - 4.f * dn * a.m3;
  a.m3 += t1 * dn * (n - 2.f) - 3.f * dn * a.m2;
  a.m2 += t1;
  a.n = n;
  a.mn = fminf(a.mn, x);
  a.mx = fmaxf(a.mx, x);
  a.nz += (x != 0.f) ? 1.f : 0.f;
}

// Chan et al. pairwise merge (the Pallas kernel's _merge), with the weights
// taken as fractions of n so that large counts do not overflow f32; the
// result keeps a's reference (b's when a is empty)
__device__ __forceinline__ Mom merge(const Mom& a, const Mom& b) {
  if (a.n == 0.f) {
    Mom r = b;
    r.mn = fminf(a.mn, b.mn);
    r.mx = fmaxf(a.mx, b.mx);
    return r;
  }
  const float na = a.n, nb = b.n;
  const float n = na + nb;
  const float fa = na / n, fb = nb / n;
  const float d = nb > 0.f ? ((b.ref - a.ref) + b.mean) - a.mean : 0.f;
  const float d2 = d * d;
  Mom r;
  r.n = n;
  r.ref = a.ref;
  r.mean = a.mean + d * fb;
  r.m2 = a.m2 + b.m2 + d2 * na * fb;
  r.m3 = a.m3 + b.m3 + d2 * d * na * fb * (fa - fb) + 3.f * d * (fa * b.m2 - fb * a.m2);
  r.m4 = a.m4 + b.m4 + d2 * d2 * na * fb * (fa * fa - fa * fb + fb * fb) +
         6.f * d2 * (fa * fa * b.m2 + fb * fb * a.m2) + 4.f * d * (fa * b.m3 - fb * a.m3);
  r.mn = fminf(a.mn, b.mn);
  r.mx = fmaxf(a.mx, b.mx);
  r.nz = a.nz + b.nz;
  return r;
}

__device__ __forceinline__ Mom shfl_down(const Mom& a, int off) {
  Mom r;
  r.n = __shfl_down_sync(0xffffffffu, a.n, off);
  r.ref = __shfl_down_sync(0xffffffffu, a.ref, off);
  r.mean = __shfl_down_sync(0xffffffffu, a.mean, off);
  r.m2 = __shfl_down_sync(0xffffffffu, a.m2, off);
  r.m3 = __shfl_down_sync(0xffffffffu, a.m3, off);
  r.m4 = __shfl_down_sync(0xffffffffu, a.m4, off);
  r.mn = __shfl_down_sync(0xffffffffu, a.mn, off);
  r.mx = __shfl_down_sync(0xffffffffu, a.mx, off);
  r.nz = __shfl_down_sync(0xffffffffu, a.nz, off);
  return r;
}

// partials layout: part[(block * kFields + field) * k + col]
__global__ void __launch_bounds__(kThreads)
moments_partial_kernel(const float* __restrict__ x, const uint8_t* __restrict__ m,
                       float* __restrict__ part, long long rows, int k) {
  __shared__ Mom s_warp[kWarps];
  const int col = blockIdx.y;
  const float* xc = x + (long long)col * rows;
  const uint8_t* mc = m + (long long)col * rows;
  const long long base = (long long)blockIdx.x * kRowsPerBlock;
  const long long end = min(base + kRowsPerBlock, rows);

  Mom acc = empty_mom();
  for (long long r = base + threadIdx.x; r < end; r += kThreads) {
    if (mc[r]) push(acc, xc[r]);
  }
  for (int off = 16; off > 0; off >>= 1) acc = merge(acc, shfl_down(acc, off));
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) s_warp[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    Mom b = s_warp[0];
    for (int w = 1; w < kWarps; ++w) b = merge(b, s_warp[w]);
    float* p = part + (long long)blockIdx.x * kFields * k + col;
    p[0 * k] = b.n;  p[1 * k] = b.ref; p[2 * k] = b.mean; p[3 * k] = b.m2; p[4 * k] = b.m3;
    p[5 * k] = b.m4; p[6 * k] = b.mn;  p[7 * k] = b.mx;   p[8 * k] = b.nz;
  }
}

// one warp a column merges that column's block partials: lane l merges
// partials l, l + 32, l + 64, ... in order, then the lanes merge through
// the fixed shuffle tree, so the order (and the result) is the same from
// run to run; lane 0 adds the reference back to the mean
__global__ void moments_merge_kernel(const float* __restrict__ part, float* __restrict__ out,
                                     int nblocks, int k) {
  const int col = blockIdx.x;
  const int lane = threadIdx.x;
  Mom acc = empty_mom();
  for (int b = lane; b < nblocks; b += 32) {
    const float* p = part + (long long)b * kFields * k + col;
    Mom q;
    q.n = p[0 * k];  q.ref = p[1 * k]; q.mean = p[2 * k]; q.m2 = p[3 * k]; q.m3 = p[4 * k];
    q.m4 = p[5 * k]; q.mn = p[6 * k];  q.mx = p[7 * k];   q.nz = p[8 * k];
    acc = merge(acc, q);
  }
  for (int off = 16; off > 0; off >>= 1) acc = merge(acc, shfl_down(acc, off));
  if (lane != 0) return;
  out[0 * k + col] = acc.n;  out[1 * k + col] = acc.n > 0.f ? acc.ref + acc.mean : 0.f;
  out[2 * k + col] = acc.m2; out[3 * k + col] = acc.m3;
  out[4 * k + col] = acc.m4; out[5 * k + col] = acc.mn;
  out[6 * k + col] = acc.mx; out[7 * k + col] = acc.nz;
}

}  // namespace

extern "C" long long anovos_moments_blocks(long long rows) {
  return (rows + kRowsPerBlock - 1) / kRowsPerBlock;
}

// x (k, rows) f32, m (k, rows) uint8, contiguous on the device; part is an
// (anovos_moments_blocks(rows), 9, k) f32 scratch.  The caller checks the
// launch.
extern "C" void anovos_moments_partial(const float* x, const uint8_t* m, float* part,
                                       long long rows, int k, cudaStream_t stream) {
  const dim3 grid((unsigned)anovos_moments_blocks(rows), (unsigned)k);
  moments_partial_kernel<<<grid, kThreads, 0, stream>>>(x, m, part, rows, k);
}

// merges the partials into out (8, k) f32.  The caller checks the launch.
extern "C" void anovos_moments_merge(const float* part, float* out, long long rows, int k,
                                     cudaStream_t stream) {
  moments_merge_kernel<<<k, 32, 0, stream>>>(part, out, (int)anovos_moments_blocks(rows), k);
}
