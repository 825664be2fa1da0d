// Fused binning + counting of masked numeric columns: the drift histogram.
//
// Replaces: anovos_tpu/ops/pallas_kernels.py `binned_histograms_pallas`
// (body `_hist_kernel`).  A value's bin is the number of interior cutoffs
// strictly below it (searchsorted side='left'), compared in f32; rows whose
// mask is 0 are not counted.  A row of NaN cutoffs (a dead or all-null
// column) makes every compare false, so its valid values land in bin 0, as
// in JAX.
//
// Bound on the H100: memory.  Each (row, column) is read once as 4 bytes of
// value and 1 byte of mask, and nothing per row is written, so the least
// time is 5 * rows * k bytes over the card's memory rate; the compare count
// (nbins - 1 compares per value, 9 at the drift bench's bin_size=10) is far
// below the card's compute rate.
//
// Design.  The reads follow columns.cuh: 16 values and their mask a thread
// a step, loaded together and unconditionally, so enough bytes are in
// flight to reach the memory rate.
// - Work items are the 4096-row steps of each column; the last item of a
//   column also reads its unaligned head and tail rows.  One launch of SMs x
//   resident blocks gives each block an equal contiguous run of items, so a
//   block mostly stays on one column.
// - A block stages its column's cutoffs in shared memory (again when its
//   run crosses into the next column) and counts into shared int32
//   histograms laid out [bin][slot].  Up to 32 bins every thread has its
//   own slot (32 KB at 32 bins): a plain add, no atomics, and a warp's
//   lanes on distinct banks.  Above 32 bins each warp has a slot, counted
//   into with shared atomics.  When the block leaves a column it adds the
//   summed non-zero bins into a (k, nbins) int32 scratch with global
//   atomics.  Integer counts make the result independent of the order of
//   the atomics, and so equal to the plain version's.
// - Then the block adds the number of items it counted to the column's
//   ticket (__threadfence first); the block that completes the column
//   writes its f32 counts.  The entry point zeroes the scratch and the
//   tickets with one memset: two operations a call (memset, kernel).

#include "columns.cuh"

namespace {

using namespace anovos;

// the most bins that get a counter for every thread
constexpr int kPrivateBins = 32;

// a thread's 16 values into the block's histogram: the bin is the number of
// cutoffs strictly below the value; `slot` is the thread's own counter of
// bin 0 (kPrivate) or its warp's (atomics)
template <bool kPrivate>
__device__ __forceinline__ void count_step(const Step& s, const float* s_cut, int ncut,
                                           int* slot) {
  constexpr int kSlots = kPrivate ? kThreads : kWarps;
  int bin[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) bin[i] = 0;
  for (int t = 0; t < ncut; ++t) {
    const float cut = s_cut[t];
#pragma unroll
    for (int i = 0; i < kVec; ++i) bin[i] += s.v[i] > cut ? 1 : 0;
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    if (!s.ok[i]) continue;
    if (kPrivate) slot[bin[i] * kSlots] += 1;
    else atomicAdd(&slot[bin[i] * kSlots], 1);
  }
}

// the block's histogram of `col` into the (k, nbins) counts (warp w sums
// bins w, w + 8, ...); the block that completes the column casts it into out
template <bool kPrivate>
__device__ __forceinline__ void flush(int col, int covered, const int* s_hist, int* counts,
                                      int* tickets, float* out, int nbins, int steps,
                                      int* s_last) {
  constexpr int kSlots = kPrivate ? kThreads : kWarps;
  const int lane = threadIdx.x & 31;
  __syncthreads();  // every thread is done counting
  for (int i = threadIdx.x >> 5; i < nbins; i += kWarps) {
    int c = 0;
    for (int q = lane; q < kSlots; q += 32) c += s_hist[i * kSlots + q];
    for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
    if (lane == 0 && c) atomicAdd(&counts[(long long)col * nbins + i], c);
  }
  __threadfence();  // the counts are visible before the ticket
  __syncthreads();
  if (threadIdx.x == 0) *s_last = atomicAdd(&tickets[col], covered) + covered == steps;
  __syncthreads();
  if (*s_last) {
    __threadfence();
    for (int i = threadIdx.x; i < nbins; i += kThreads)
      out[(long long)col * nbins + i] = (float)__ldcg(&counts[(long long)col * nbins + i]);
  }
}

template <bool kPrivate>
size_t hist_smem(int nbins) {
  const size_t slots = kPrivate ? kThreads : kWarps;
  return sizeof(float) * (size_t)(nbins - 1) + sizeof(int) * slots * nbins;
}

// counts: (k, nbins) int32 and tickets (k,) int32, zero at launch; out:
// (k, nbins) f32; steps: work items a column.  At most 64 registers a
// thread, so that 4 blocks fit on an SM.
template <bool kPrivate>
__global__ void __launch_bounds__(kThreads, 4)
hist_kernel(const float* __restrict__ x, const uint8_t* __restrict__ m,
            const float* __restrict__ cuts, int* counts, int* tickets, float* __restrict__ out,
            long long rows, int k, int nbins, int steps) {
  constexpr int kSlots = kPrivate ? kThreads : kWarps;
  extern __shared__ float smem[];
  const int ncut = nbins - 1;
  float* s_cut = smem;
  int* s_hist = reinterpret_cast<int*>(smem + ncut);  // [nbins][kSlots]
  __shared__ int s_last;
  int* slot = s_hist + (kPrivate ? threadIdx.x : threadIdx.x >> 5);

  const long long items = (long long)k * steps;
  const long long first = (long long)blockIdx.x * items / gridDim.x;
  const long long last = (long long)(blockIdx.x + 1) * items / gridDim.x;
  int col = -1, covered = 0;
  const float* xc = x;
  const uint8_t* mc = m;
  Span sp = {0, 0};
  for (long long item = first; item < last; ++item) {
    const int c = (int)(item / steps);
    if (c != col) {
      if (col >= 0)
        flush<kPrivate>(col, covered, s_hist, counts, tickets, out, nbins, steps, &s_last);
      col = c;
      covered = 0;
      xc = x + (long long)col * rows;
      mc = m + (long long)col * rows;
      sp = col_span(col, rows);
      for (int i = threadIdx.x; i < ncut; i += kThreads) s_cut[i] = cuts[(long long)col * ncut + i];
      for (int i = threadIdx.x; i < kSlots * nbins; i += kThreads) s_hist[i] = 0;
      __syncthreads();
    }
    const int j = (int)(item - (long long)col * steps);
    const long long lo = sp.head + (long long)j * kStepRows;
    const long long hi = min(lo + kStepRows, sp.end);
    Step s;
    if (lo + kStepRows <= hi) {
      load_step<true>(xc, mc, lo, hi, s);
      count_step<kPrivate>(s, s_cut, ncut, slot);
    } else if (lo < hi) {
      load_step<false>(xc, mc, lo, hi, s);
      count_step<kPrivate>(s, s_cut, ncut, slot);
    }
    if (j == steps - 1) {
      load_edges(xc, mc, sp, rows, s);
      count_step<kPrivate>(s, s_cut, ncut, slot);
    }
    ++covered;
  }
  if (col >= 0) flush<kPrivate>(col, covered, s_hist, counts, tickets, out, nbins, steps, &s_last);
}

Residency g_residency[2];

template <bool kPrivate>
cudaError_t launch(const float* x, const uint8_t* m, const float* cuts, int* counts, int* tickets,
                   float* out, long long rows, int k, int nbins, int steps, int device,
                   cudaStream_t stream) {
  const size_t smem = hist_smem<kPrivate>(nbins);
  int resident = 0;
  const cudaError_t err = g_residency[kPrivate].get(hist_kernel<kPrivate>, device, smem, &resident);
  if (err != cudaSuccess) return err;
  const long long items = (long long)k * steps;
  const int grid = (int)(items < resident ? items : resident);
  hist_kernel<kPrivate><<<grid, kThreads, smem, stream>>>(x, m, cuts, counts, tickets, out,
                                                          rows, k, nbins, steps);
  return cudaGetLastError();
}

// work items a column (at least one, which also reads the unaligned rows)
int hist_steps(long long rows) {
  return (int)(rows > 0 ? (rows + kStepRows - 1) / kStepRows : 1);
}

}  // namespace

// x (k, rows) f32 16-byte aligned and m (k, rows) uint8 4-byte aligned,
// cuts (k, nbins-1) f32, all contiguous on `device`, k > 0, 1 <= nbins <=
// 1024; scratch (k * nbins + k) int32; out (k, nbins) f32.  Zeroes the
// scratch and launches on `stream`; returns the launch's error code;
// the caller's current device is kept.
extern "C" int anovos_histograms(const float* x, const uint8_t* m, const float* cuts,
                                 int* scratch, float* out, long long rows, int k, int nbins,
                                 int device, cudaStream_t stream) {
  const anovos::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const size_t ncounts = (size_t)k * nbins;
  const cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(int) * (ncounts + k), stream);
  if (err != cudaSuccess) return err;
  const int steps = hist_steps(rows);
  int* tickets = scratch + ncounts;
  if (nbins <= kPrivateBins)
    return launch<true>(x, m, cuts, scratch, tickets, out, rows, k, nbins, steps, device, stream);
  return launch<false>(x, m, cuts, scratch, tickets, out, rows, k, nbins, steps, device, stream);
}
