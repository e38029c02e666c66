// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/rglru_scan.py::rglru_scan_kernel (body _rglru_kernel,
// pallas_call at :64). Every channel of (batch, width) is an independent
// recurrence over time, carried in f32 from h_{-1} = 0; h takes b's type.
//
// What bounds it on this card: memory. It reads a and b and writes h once,
// two operations per element: at the serving shapes (recurrentgemma-9b,
// B=4, S=512, lru width 4096, all f32) that is 100.7 MB, 30 us at 3.35 TB/s.
//
// Design: the TPU tiles the width over a parallel grid axis and walks time in
// blocks whose carry sits in VMEM scratch. Here one thread owns one channel
// and walks the whole sequence with its carry in a register; neighbouring
// threads own neighbouring channels, so every load and store of a time step is
// coalesced along W. Time is unrolled by 8 with the loads issued before the
// dependent multiply-adds, so eight steps' loads are in flight at once. The
// ragged edges need no padding: threads past W exit, and the time loop has a
// tail. At the serving shapes this is 16,384 threads, 128 blocks: about one
// block per SM, so the kernel is bound by load latency more than by bandwidth;
// a chunked two-pass scan over time would add blocks, and is later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_fwd(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ h, int S, int W,
          long long a_sb, long long a_ss, long long b_sb, long long b_ss) {
  const int w = blockIdx.x * kThreads + threadIdx.x, row = blockIdx.y;
  if (w >= W) return;
  const T* ap = a + row * a_sb + w;
  const T* bp = b + row * b_sb + w;
  T* hp = h + (long long)row * S * W + w;
  float carry = 0.f;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = repro::to_float(ap[(t + u) * a_ss]);
      bv[u] = repro::to_float(bp[(t + u) * b_ss]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      carry = av[u] * carry + bv[u];
      hp[(long long)(t + u) * W] = repro::from_float<T>(carry);
    }
  }
  for (; t < S; ++t) {
    carry = repro::to_float(ap[t * a_ss]) * carry + repro::to_float(bp[t * b_ss]);
    hp[(long long)t * W] = repro::from_float<T>(carry);
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* h, int B, int S, int W, long long a_sb,
                   long long a_ss, long long b_sb, long long b_ss, cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_fwd<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(a),
                                              static_cast<const T*>(b), static_cast<T*>(h),
                                              S, W, a_sb, a_ss, b_sb, b_ss);
  return cudaGetLastError();
}

}  // namespace

// dtype (of a, b and h): 0 float32, 1 bfloat16. a and b (B, S, W) are read
// through their batch and time strides (W contiguous); h is (B, S, W),
// contiguous. Returns 0, a cudaError_t, or REPRO_UNSUPPORTED.
extern "C" int rglru_scan_fwd(int dtype, int device, const void* a, const void* b, void* h,
                              int B, int S, int W, long long a_sb, long long a_ss,
                              long long b_sb, long long b_ss, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535) return REPRO_UNSUPPORTED;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, h, B, S, W, a_sb, a_ss, b_sb, b_ss, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, h, B, S, W, a_sb, a_ss, b_sb, b_ss, st);
  return REPRO_UNSUPPORTED;
}
