// PyTorch binding of the port's CUDA kernels.  The only source that
// includes PyTorch's headers: the kernels' own files have a plain C
// interface, so nvcc compiles them quickly.
//
// Each function takes tensors that the Python wrapper has checked and
// allocated (ops/kernels/histogram.py, ops/kernels/moments.py,
// ops/kernels/neighbor_counts.py), launches on
// the current stream of the tensors' device and checks every launch.

#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>

extern "C" {
void anovos_hist_count(const float* x, const uint8_t* m, const float* cuts, int* counts,
                       long long rows, int k, int nbins, cudaStream_t stream);
void anovos_hist_to_float(const int* counts, float* out, int total, cudaStream_t stream);
long long anovos_moments_blocks(long long rows);
void anovos_moments_partial(const float* x, const uint8_t* m, float* part, long long rows,
                            int k, cudaStream_t stream);
void anovos_moments_merge(const float* part, float* out, long long rows, int k,
                          cudaStream_t stream);
void anovos_neighbor_counts(const float* x, float eps2, int* counts, int n, int d,
                            cudaStream_t stream);
}

namespace {

void check_cols(const torch::Tensor& x, const torch::Tensor& m) {
  TORCH_CHECK(x.is_cuda() && m.device() == x.device(), "x and m must be on one CUDA device");
  TORCH_CHECK(x.scalar_type() == torch::kFloat32 && m.scalar_type() == torch::kBool,
              "x must be float32 and m bool");
  TORCH_CHECK(x.dim() == 2 && m.sizes() == x.sizes(), "x and m must be the same (k, rows) shape");
  TORCH_CHECK(x.is_contiguous() && m.is_contiguous(), "x and m must be contiguous");
  TORCH_CHECK(x.size(0) <= 65535, "at most 65535 columns a launch");
}

// x, m (k, rows); cuts (k, nbins-1) f32; counts (k, nbins) int32 scratch;
// out (k, nbins) f32
void binned_histograms(torch::Tensor x, torch::Tensor m, torch::Tensor cuts,
                       torch::Tensor counts, torch::Tensor out) {
  check_cols(x, m);
  const int k = (int)x.size(0);
  const int nbins = (int)out.size(1);
  TORCH_CHECK(cuts.device() == x.device() && cuts.scalar_type() == torch::kFloat32 &&
                  cuts.is_contiguous() && cuts.dim() == 2 && cuts.size(0) == k &&
                  cuts.size(1) == nbins - 1,
              "cuts must be a contiguous (k, nbins-1) float32 tensor on x's device");
  TORCH_CHECK(counts.device() == x.device() && counts.scalar_type() == torch::kInt32 &&
                  counts.is_contiguous() && counts.sizes() == out.sizes() &&
                  out.device() == x.device() && out.scalar_type() == torch::kFloat32 &&
                  out.is_contiguous() && out.size(0) == k,
              "counts (int32) and out (float32) must be contiguous (k, nbins) on x's device");
  const int total = k * nbins;
  if (total == 0) return;
  const c10::cuda::CUDAGuard guard(x.device());
  const cudaStream_t stream = at::cuda::getCurrentCUDAStream();
  C10_CUDA_CHECK(cudaMemsetAsync(counts.data_ptr<int>(), 0, sizeof(int) * (size_t)total, stream));
  if (x.size(1) > 0) {
    anovos_hist_count(x.data_ptr<float>(), reinterpret_cast<const uint8_t*>(m.data_ptr<bool>()),
                      cuts.data_ptr<float>(), counts.data_ptr<int>(), x.size(1), k, nbins, stream);
    C10_CUDA_KERNEL_LAUNCH_CHECK();
  }
  anovos_hist_to_float(counts.data_ptr<int>(), out.data_ptr<float>(), total, stream);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

int64_t moments_blocks(int64_t rows) { return anovos_moments_blocks(rows); }

// x, m (k, rows); part (moments_blocks(rows), 9, k) f32 scratch; out (8, k) f32
void masked_moments(torch::Tensor x, torch::Tensor m, torch::Tensor part, torch::Tensor out) {
  check_cols(x, m);
  const int k = (int)x.size(0);
  const int64_t rows = x.size(1);
  TORCH_CHECK(part.device() == x.device() && part.scalar_type() == torch::kFloat32 &&
                  part.is_contiguous() && part.dim() == 3 &&
                  part.size(0) == anovos_moments_blocks(rows) && part.size(1) == 9 &&
                  part.size(2) == k,
              "part must be a contiguous (blocks, 9, k) float32 tensor on x's device");
  TORCH_CHECK(out.device() == x.device() && out.scalar_type() == torch::kFloat32 &&
                  out.is_contiguous() && out.dim() == 2 && out.size(0) == 8 && out.size(1) == k,
              "out must be a contiguous (8, k) float32 tensor on x's device");
  if (k == 0) return;
  const c10::cuda::CUDAGuard guard(x.device());
  const cudaStream_t stream = at::cuda::getCurrentCUDAStream();
  if (rows > 0) {
    anovos_moments_partial(x.data_ptr<float>(),
                           reinterpret_cast<const uint8_t*>(m.data_ptr<bool>()),
                           part.data_ptr<float>(), rows, k, stream);
    C10_CUDA_KERNEL_LAUNCH_CHECK();
  }
  anovos_moments_merge(part.data_ptr<float>(), out.data_ptr<float>(), rows, k, stream);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// x (n, d) f32 points, 1 <= d <= 8; eps2 the f32 squared radius; counts
// (n,) int32 out
void neighbor_counts(torch::Tensor x, double eps2, torch::Tensor counts) {
  TORCH_CHECK(x.is_cuda() && x.scalar_type() == torch::kFloat32 && x.dim() == 2 &&
                  x.is_contiguous(),
              "x must be a contiguous (n, d) float32 CUDA tensor");
  const int64_t n = x.size(0);
  const int64_t d = x.size(1);
  TORCH_CHECK(d >= 1 && d <= 8, "neighbor_counts: need 1 <= d <= 8, got ", d);
  TORCH_CHECK(n <= INT32_MAX, "neighbor_counts: at most 2^31 - 1 points");
  TORCH_CHECK(counts.device() == x.device() && counts.scalar_type() == torch::kInt32 &&
                  counts.is_contiguous() && counts.dim() == 1 && counts.size(0) == n,
              "counts must be a contiguous (n,) int32 tensor on x's device");
  if (n == 0) return;
  const c10::cuda::CUDAGuard guard(x.device());
  anovos_neighbor_counts(x.data_ptr<float>(), (float)eps2, counts.data_ptr<int>(), (int)n, (int)d,
                         at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, mod) {
  mod.def("binned_histograms", &binned_histograms, "binned histograms (csrc/histogram.cu)");
  mod.def("moments_blocks", &moments_blocks, "row blocks of the moments kernel");
  mod.def("masked_moments", &masked_moments, "masked moments (csrc/moments.cu)");
  mod.def("neighbor_counts", &neighbor_counts, "within-eps neighbour counts (csrc/neighbor_counts.cu)");
}
