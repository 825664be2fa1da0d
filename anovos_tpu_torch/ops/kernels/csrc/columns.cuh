// Streaming reads of a column-major (k, rows) block of f32 values and their
// uint8 mask, shared by the moments (moments.cu) and histogram
// (histogram.cu) kernels; the device guard and residency query below serve
// every kernel of the port.
//
// Both kernels are bound by the bytes they read (5 a value).  To stream at
// the card's 3.35 TB/s with about 700 ns of memory latency, an SM needs
// about 18 KB in flight (Little's law over 132 SMs).  So a thread reads 16
// values and their 16 mask bytes a step, as four 16-byte and four 4-byte
// loads issued together before any arithmetic: 80 bytes in flight a thread.
// Load j of lane l reads the rows (j * 32 + l) * 4 .. +3 of its warp's
// 512-row slice of the step, so each warp instruction covers 512 contiguous
// bytes of values and 128 of mask.  A block of 256 threads covers 4096 rows
// a step.  Loads are unconditional; the mask selects, it does not branch.
//
// Alignment: column c starts at element c * rows, so where rows is not a
// multiple of 4 the columns after the first start off the 16-byte grid.
// Each column is read as a head of at most 3 rows, a run of whole 4-row
// vectors [head, end), and a tail of at most 3 rows; head and tail are read
// one value a thread.  The kernels need x 16-byte aligned and m 4-byte
// aligned (the wrappers make sure of it).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace anovos {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 16;                    // values a thread reads a step
constexpr int kWarpRows = 32 * kVec;        // 512 rows a warp a step
constexpr int kStepRows = kThreads * kVec;  // 4096 rows a block a step

// the rows [head, end) of a column that whole 4-row vectors cover
struct Span {
  long long head, end;
};

__device__ __forceinline__ Span col_span(int col, long long rows) {
  const long long start = (long long)col * rows;
  long long head = (4 - (start & 3)) & 3;
  if (head > rows) head = rows;
  return {head, head + ((rows - head) & ~3LL)};
}

// a thread's 16 values of one step and whether each is valid
struct Step {
  float v[kVec];
  bool ok[kVec];
};

// The thread's part of the 4096-row step that starts at column row `base`.
// Vectors at or past `end` read as invalid zeros; with kFull every vector of
// the step lies before `end` and no load is predicated.  The loads bypass
// L1 and are marked evict-first: every byte is read once.
template <bool kFull>
__device__ __forceinline__ void load_step(const float* __restrict__ xc,
                                          const uint8_t* __restrict__ mc, long long base,
                                          long long end, Step& s) {
  const int lane = threadIdx.x & 31;
  const long long w0 = base + (long long)(threadIdx.x >> 5) * kWarpRows;
  float4 a[4];
  uchar4 b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long r = w0 + (long long)(j * 32 + lane) * 4;
    if (kFull || r < end) {
      a[j] = __ldcs(reinterpret_cast<const float4*>(xc + r));
      b[j] = __ldcs(reinterpret_cast<const uchar4*>(mc + r));
    } else {
      a[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      b[j] = make_uchar4(0, 0, 0, 0);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s.v[4 * j + 0] = a[j].x; s.v[4 * j + 1] = a[j].y;
    s.v[4 * j + 2] = a[j].z; s.v[4 * j + 3] = a[j].w;
    s.ok[4 * j + 0] = b[j].x != 0; s.ok[4 * j + 1] = b[j].y != 0;
    s.ok[4 * j + 2] = b[j].z != 0; s.ok[4 * j + 3] = b[j].w != 0;
  }
}

// The column's head and tail rows (at most 6), one a thread, as one more
// step in which only v[0] of threads 0..5 can be valid.
__device__ __forceinline__ void load_edges(const float* __restrict__ xc,
                                           const uint8_t* __restrict__ mc, Span sp,
                                           long long rows, Step& s) {
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    s.v[i] = 0.f;
    s.ok[i] = false;
  }
  const long long t = threadIdx.x;
  const long long r = t < sp.head ? t : sp.end + (t - sp.head);
  if (r < rows) {
    s.v[0] = xc[r];
    s.ok[0] = mc[r] != 0;
  }
}

// Makes `device` current for the scope of an entry point and gives the
// caller's device back when it ends, on every return, errors included.
struct DeviceGuard {
  int prev = -1, device;
  cudaError_t err;
  explicit DeviceGuard(int d) : device(d) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  }
  ~DeviceGuard() {
    if (prev >= 0 && prev != device) cudaSetDevice(prev);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
};

// How many blocks of one kernel the card holds at once (SMs x resident
// blocks an SM), queried once per device and shared-memory size.
struct Residency {
  static constexpr int kMaxDevices = 64;
  int blocks[kMaxDevices] = {0};
  size_t smem[kMaxDevices] = {0};

  template <typename K>
  cudaError_t get(K kernel, int device, size_t bytes, int* out) {
    const bool slot = device >= 0 && device < kMaxDevices;
    if (slot && blocks[device] > 0 && smem[device] == bytes) {
      *out = blocks[device];
      return cudaSuccess;
    }
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes);
    if (err != cudaSuccess) return err;
    *out = sms * (per_sm > 0 ? per_sm : 1);
    if (slot) {
      blocks[device] = *out;
      smem[device] = bytes;
    }
    return cudaSuccess;
  }
};

}  // namespace anovos
