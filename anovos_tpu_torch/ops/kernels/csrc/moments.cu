// Single-pass masked moments of numeric columns.
//
// Replaces: anovos_tpu/ops/pallas_kernels.py `moments_pallas` (body
// `_moments_kernel`).  For each column it gives the (8, k) f32 accumulator
// [n, mean, M2, M3, M4, min, max, nonzero] over the rows whose mask is set,
// with M2..M4 the central sums of powers; ops/reductions.finalize_moments
// turns it into mean / variance / skewness / kurtosis.
//
// Bound on the H100: memory.  Each (row, column) is read once, 4 bytes of
// value and 1 byte of mask; the output is 32 bytes a column.  The arithmetic
// is about 24 f32 operations a value read (push_step, an FMA counted as
// two), masked or not, well under the card's f32 rate at this byte count.
//
// Design.  The reads follow columns.cuh: 16 values and their mask a thread
// a step, loaded together and unconditionally, so enough bytes are in
// flight to reach the memory rate.
// - Per step a thread takes a two-pass moment of its 16 values, as the
//   Pallas kernel does of a tile: the count, one division for the step
//   mean, then the centred M2/M3/M4 over the registers, and min, max and
//   nonzero of the raw values; the mask selects.  It Chan-merges the step
//   into its running moments with one more division: 2 divisions for 16
//   values.
// - Every partial keeps its mean relative to a reference value: the
//   thread's first valid value of the work item.  For a column whose spread
//   is small beside its mean (normal(1e5, 3)) the relative mean keeps the
//   digits that a running f32 mean near 1e5 would round away, whatever rows
//   are masked (a null is stored as 0).  A merge moves the second partial
//   onto the first one's reference; two references close to each other
//   differ exactly in f32 (Sterbenz), so no digit is lost there.
// - Work items: each column is cut into items of 32,768 rows (8 steps of a
//   block); the last item of a column also reads its unaligned head and
//   tail rows.  One launch of SMs x resident blocks walks the items with a
//   grid stride, so no wave is left half full.  A block merges its threads
//   (warp shuffles, then its 8 warps in order) into the item's partial and
//   writes it to the item's own slot of a scratch.  The kernel is held to
//   64 registers, so 4 blocks (1024 threads) fit on an SM: on the H100 that
//   hid the loads and the merges better than 4-step items at 69 registers
//   and 3 blocks an SM.
// - Chan merges do not commute bit for bit and cannot be done with
//   atomics.  So after writing a partial the block takes a ticket on the
//   item's column (__threadfence, then atomicAdd on a per-call counter that
//   the entry point zeroes); the block that takes the column's last ticket
//   merges that column's partials in item order (thread t items t, t + 256,
//   ...; then the fixed shuffle tree and the 8 warps in order) and writes
//   the column's result.  The result depends on the items alone, not on
//   which block ran which item: two runs give the same bits.  Columns
//   finish one after another along the grid stride, so their merges overlap
//   the streaming of later columns.
//
// Limit: n and nonzero are f32 counts, exact up to 2^24 valid rows a column,
// the same bound the Pallas kernel has.

#include "columns.cuh"

namespace {

using namespace anovos;

constexpr int kItemSteps = 8;
constexpr long long kItemRows = (long long)kItemSteps * kStepRows;
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

// One step of 16 values into the thread's running moments.  When the
// running moments are empty, the step's first valid value becomes the
// reference.  No branch: an empty step leaves n, the mean and M2 as they
// were.
__device__ __forceinline__ void push_step(Mom& a, const Step& s) {
  float cnt = 0.f, first = 0.f;
#pragma unroll
  for (int i = kVec - 1; i >= 0; --i) {
    first = s.ok[i] ? s.v[i] : first;
    cnt += s.ok[i] ? 1.f : 0.f;
  }
  a.ref = a.n == 0.f ? (isfinite(first) ? first : 0.f) : a.ref;
  float d[kVec];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    d[i] = s.ok[i] ? s.v[i] - a.ref : 0.f;
    sum += d[i];
  }
  const float mu = sum / fmaxf(cnt, 1.f);
  float m2 = 0.f, m3 = 0.f, m4 = 0.f, mn = a.mn, mx = a.mx, nz = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const float e = s.ok[i] ? d[i] - mu : 0.f;
    const float e2 = e * e;
    m2 += e2;
    m3 = fmaf(e2, e, m3);
    m4 = fmaf(e2, e2, m4);
    mn = fminf(mn, s.ok[i] ? s.v[i] : kBig);
    mx = fmaxf(mx, s.ok[i] ? s.v[i] : -kBig);
    nz += (s.ok[i] && s.v[i] != 0.f) ? 1.f : 0.f;
  }
  // Chan merge of (cnt, mu, m2, m3, m4) into a, both relative to a.ref;
  // with a empty it gives the step, with the step empty it keeps a
  const float na = a.n, nb = cnt;
  const float n = na + nb;
  const float inv = 1.f / fmaxf(n, 1.f);
  const float fa = na * inv, fb = nb * inv;
  const float dl = mu - a.mean;
  const float dl2 = dl * dl;
  const float w = na * fb;
  const float a2 = a.m2, a3 = a.m3;
  a.n = n;
  a.mean += dl * fb;
  // w = 0 when either side is empty: no cross term then, also where dl²
  // passes the f32 maximum (inf · 0 would turn an overflowed M2 into NaN,
  // where the plain version and the JAX package keep inf).  The merge's
  // own expression is kept whole (the compiler fuses it into an FMA), so a
  // finite dl² gives the same bits as before
  a.m2 = w > 0.f ? a2 + m2 + dl2 * w : a2 + m2;
  a.m3 = a3 + m3 + dl2 * dl * w * (fa - fb) + 3.f * dl * (fa * m2 - fb * a2);
  a.m4 = a.m4 + m4 + dl2 * dl2 * w * (fa * fa - fa * fb + fb * fb) +
         6.f * dl2 * (fa * fa * m2 + fb * fb * a2) + 4.f * dl * (fa * m3 - fb * a3);
  a.mn = mn;
  a.mx = mx;
  a.nz += nz;
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
  const float inv = 1.f / n;
  const float fa = na * inv, fb = nb * inv;
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

// The block's threads merged in a fixed order: the shuffle tree in each
// warp, then warps 0..7 in order.  The result is valid in thread 0.  Ends
// with every thread past its use of s_warp's previous contents.
__device__ __forceinline__ Mom block_merge(Mom a, Mom* s_warp) {
  for (int off = 16; off > 0; off >>= 1) a = merge(a, shfl_down(a, off));
  __syncthreads();  // s_warp's previous contents are read
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = a;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kWarps; ++w) a = merge(a, s_warp[w]);
  return a;
}

__device__ __forceinline__ void store_mom(float* p, const Mom& a) {
  p[0] = a.n;  p[1] = a.ref; p[2] = a.mean; p[3] = a.m2; p[4] = a.m3;
  p[5] = a.m4; p[6] = a.mn;  p[7] = a.mx;   p[8] = a.nz;
}

// another block wrote p: read it from L2, past this SM's L1
__device__ __forceinline__ Mom load_mom(const float* p) {
  Mom a;
  a.n = __ldcg(p + 0);  a.ref = __ldcg(p + 1); a.mean = __ldcg(p + 2);
  a.m2 = __ldcg(p + 3); a.m3 = __ldcg(p + 4);  a.m4 = __ldcg(p + 5);
  a.mn = __ldcg(p + 6); a.mx = __ldcg(p + 7);  a.nz = __ldcg(p + 8);
  return a;
}

// part: (k * ipc, 9) item partials; tickets: (k,) int32, zero at launch;
// out: (8, k)
__global__ void __launch_bounds__(kThreads, 4)
moments_kernel(const float* __restrict__ x, const uint8_t* __restrict__ m, float* part,
               int* tickets, float* __restrict__ out, long long rows, int k, int ipc) {
  __shared__ Mom s_warp[kWarps];
  __shared__ int s_last;
  const long long items = (long long)k * ipc;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int col = (int)(item / ipc);
    const int j = (int)(item - (long long)col * ipc);
    const float* xc = x + (long long)col * rows;
    const uint8_t* mc = m + (long long)col * rows;
    const Span sp = col_span(col, rows);
    const long long lo = sp.head + (long long)j * kItemRows;
    const long long hi = min(lo + kItemRows, sp.end);

    Mom acc = empty_mom();
    Step s;
    long long base = lo;
    for (; base + kStepRows <= hi; base += kStepRows) {
      load_step<true>(xc, mc, base, hi, s);
      push_step(acc, s);
    }
    if (base < hi) {
      load_step<false>(xc, mc, base, hi, s);
      push_step(acc, s);
    }
    if (j == ipc - 1) {
      load_edges(xc, mc, sp, rows, s);
      push_step(acc, s);
    }
    acc = block_merge(acc, s_warp);
    if (threadIdx.x == 0) {
      store_mom(part + item * kFields, acc);
      __threadfence();  // the partial is visible before the ticket
      s_last = atomicAdd(&tickets[col], 1) == ipc - 1;
    }
    __syncthreads();
    if (s_last) {  // every other item of this column is written
      __threadfence();
      Mom c = empty_mom();
      const float* pc = part + (long long)col * ipc * kFields;
      for (int i = threadIdx.x; i < ipc; i += kThreads)
        c = merge(c, load_mom(pc + (long long)i * kFields));
      c = block_merge(c, s_warp);
      if (threadIdx.x == 0) {
        float* o = out + col;
        o[0] = c.n;                   o[(long long)k] = c.n > 0.f ? c.ref + c.mean : 0.f;
        o[2LL * k] = c.m2; o[3LL * k] = c.m3; o[4LL * k] = c.m4;
        o[5LL * k] = c.mn; o[6LL * k] = c.mx; o[7LL * k] = c.nz;
      }
    }
    __syncthreads();  // s_last and s_warp are read before the next item
  }
}

Residency g_residency;

}  // namespace

// work items a column (at least one, which also reads the unaligned rows)
extern "C" int anovos_moments_items(long long rows) {
  return (int)(rows > 0 ? (rows + kItemRows - 1) / kItemRows : 1);
}

// x (k, rows) f32 16-byte aligned and m (k, rows) uint8 4-byte aligned,
// contiguous on `device`, k > 0; part a (k * anovos_moments_items(rows), 9)
// f32 scratch; tickets a (k,) int32 scratch; out (8, k) f32.  Zeroes the
// tickets and launches on `stream`; returns the launch's error code;
// the caller's current device is kept.
extern "C" int anovos_moments(const float* x, const uint8_t* m, float* part, int* tickets,
                              float* out, long long rows, int k, int device,
                              cudaStream_t stream) {
  const anovos::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  int resident = 0;
  cudaError_t err = g_residency.get(moments_kernel, device, 0, &resident);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(tickets, 0, sizeof(int) * (size_t)k, stream);
  if (err != cudaSuccess) return err;
  const int ipc = anovos_moments_items(rows);
  const long long items = (long long)k * ipc;
  const int grid = (int)(items < resident ? items : resident);
  moments_kernel<<<grid, kThreads, 0, stream>>>(x, m, part, tickets, out, rows, k, ipc);
  return cudaGetLastError();
}
