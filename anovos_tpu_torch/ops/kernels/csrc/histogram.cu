// Fused binning + counting of masked numeric columns: the drift histogram.
//
// Replaces: anovos_tpu/ops/pallas_kernels.py `binned_histograms_pallas`
// (body `_hist_kernel`).  A value's bin is the number of interior cutoffs
// strictly below it (searchsorted side='left'), compared in f32; rows whose
// mask is 0 are skipped.  A row of NaN cutoffs (a dead or all-null column)
// makes every compare false, so its valid values land in bin 0, as in JAX.
//
// Bound on the H100: memory.  Each (row, column) is read once as 4 bytes of
// value and 1 byte of mask, and nothing per row is written, so the least
// time is 5 * rows * k bytes over the card's memory rate; the compare count
// (nbins - 1 compares per value, 9 at the drift bench's bin_size=10) is far
// below the card's compute rate.
//
// Design: layout is column-major, (k, rows), so neighbouring threads read
// neighbouring values of one column (coalesced).  The grid is
// (row chunks x columns); a block stages its column's cutoffs in shared
// memory, each warp counts into its own shared int32 histogram (fewer
// collisions on the hot bins than one block-wide histogram), and the block
// flushes the summed non-zero bins into a (k, nbins) int32 scratch with
// global atomics.  Integer counts make the result independent of the order
// of the atomics.  A last small launch casts the counts to the f32 output.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 16;
constexpr long long kRowsPerBlock = (long long)kThreads * kRowsPerThread;

__global__ void __launch_bounds__(kThreads)
hist_kernel(const float* __restrict__ x, const uint8_t* __restrict__ m,
            const float* __restrict__ cuts, int* __restrict__ counts,
            long long rows, int ncut, int nbins) {
  extern __shared__ float smem[];
  float* s_cut = smem;
  int* s_hist = reinterpret_cast<int*>(smem + ncut);  // [kWarps][nbins]
  const int col = blockIdx.y;
  for (int i = threadIdx.x; i < ncut; i += kThreads) s_cut[i] = cuts[(long long)col * ncut + i];
  for (int i = threadIdx.x; i < kWarps * nbins; i += kThreads) s_hist[i] = 0;
  __syncthreads();

  int* my_hist = s_hist + (threadIdx.x / 32) * nbins;
  const float* xc = x + (long long)col * rows;
  const uint8_t* mc = m + (long long)col * rows;
  const long long base = (long long)blockIdx.x * kRowsPerBlock;
  const long long end = min(base + kRowsPerBlock, rows);
  for (long long r = base + threadIdx.x; r < end; r += kThreads) {
    if (mc[r]) {
      const float v = xc[r];
      int b = 0;
      for (int j = 0; j < ncut; ++j) b += (v > s_cut[j]) ? 1 : 0;
      atomicAdd(&my_hist[b], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nbins; i += kThreads) {
    int c = 0;
    for (int w = 0; w < kWarps; ++w) c += s_hist[w * nbins + i];
    if (c) atomicAdd(&counts[(long long)col * nbins + i], c);
  }
}

__global__ void int_to_float(const int* __restrict__ in, float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = (float)in[i];
}

}  // namespace

// x (k, rows) f32, m (k, rows) uint8, cuts (k, nbins-1) f32, all contiguous
// on the device, rows > 0; counts (k, nbins) int32, zeroed by the caller.
// The caller checks the launch.
extern "C" void anovos_hist_count(const float* x, const uint8_t* m, const float* cuts,
                                  int* counts, long long rows, int k, int nbins,
                                  cudaStream_t stream) {
  const dim3 grid((unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock), (unsigned)k);
  const size_t smem = sizeof(float) * (size_t)(nbins - 1) + sizeof(int) * (size_t)kWarps * nbins;
  hist_kernel<<<grid, kThreads, smem, stream>>>(x, m, cuts, counts, rows, nbins - 1, nbins);
}

// counts (k, nbins) int32 → out (k, nbins) f32.  The caller checks the launch.
extern "C" void anovos_hist_to_float(const int* counts, float* out, int total,
                                     cudaStream_t stream) {
  int_to_float<<<(total + 255) / 256, 256, 0, stream>>>(counts, out, total);
}
