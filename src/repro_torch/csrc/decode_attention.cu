// Decode attention for Hopper (sm_90a): one query token per sequence against
// the KV cache.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention.py::decode_attention_kernel (body
// _decode_kernel, pallas_call at :100): per-row `lengths`, an optional window
// (pos >= length - window), GQA through kv head h / G, cache blocks past the
// length skipped. Accumulation is f32; the output takes q's type.
//
// What bounds it on this card: memory. Every cache entry it reads is used for
// two multiply-adds per query head of its group, so at the serving shapes
// (B=4, a 544-slot cache, 16 kv heads, head dim 64, bf16) it reads ~9 MB of
// K/V for ~9 MFLOP — about 3 us at 3.35 TB/s against nothing at 989 TF/s.
// What matters is to read the cache once, with enough blocks in flight to
// keep the memory busy.
//
// Design: split-K flash-decoding, the GPU form that the Pallas notes name
// (decode_attention.py:4-8). The TPU walks the cache of one (b, h) in order
// on one core and carries the softmax state in VMEM; here that sequential
// walk becomes many blocks in parallel and a second pass. Pass 1: one block
// per (cache split, kv head, batch row) loads the split's K/V rows once,
// scores them against all G query heads that share the kv head, and writes
// each head's partial max, sum and weighted values. Splits wholly past the
// length (or before the window) return at once and are never read. Pass 2:
// one block per (head, batch row) merges the live splits' partials. The
// cache is read in the model layout (B, S, KVH, D) through its strides, so no
// transpose copy precedes the launch.

#include "common.cuh"

namespace {

using repro::kNegInf;
using repro::Strides;

constexpr int kThreads = 128;
constexpr int kMaxGroup = 8;  // query heads per kv head that a block takes

// cache rows per split: 256 at D=16, 128 at D=32, 64 at D=64, 32 at D=128
__host__ __device__ constexpr int split_rows(int D) { return 4096 / D; }

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_split(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const int* __restrict__ lengths, float* __restrict__ part_ml,
             float* __restrict__ part_acc, int S, int H, int KVH, int NS, Strides qs,
             Strides ks, Strides vs, int window, float scale) {
  constexpr int CS = split_rows(D);
  constexpr int C4 = D / 4;
  __shared__ float k_s[CS][D + 1];  // +1: the rows of a warp's dot products fall in distinct banks
  __shared__ float v_s[CS][D];
  __shared__ float q_s[kMaxGroup][D];
  __shared__ float p_s[kMaxGroup][CS];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH;
  const int len = lengths[b];
  const int hi = min(len, S);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int s0 = split * CS;
  if (s0 >= hi || s0 + CS <= lo) return;  // no live position: pass 2 skips this split

  for (int idx = threadIdx.x; idx < G * C4; idx += kThreads) {
    const int g = idx / C4, c = idx % C4;
    const float4 x = repro::load4(q + b * qs.b + (long long)(kvh * G + g) * qs.h + 4 * c);
    q_s[g][4 * c] = x.x * scale;
    q_s[g][4 * c + 1] = x.y * scale;
    q_s[g][4 * c + 2] = x.z * scale;
    q_s[g][4 * c + 3] = x.w * scale;
  }
  const T* kbase = k + b * ks.b + (long long)kvh * ks.h;
  const T* vbase = v + b * vs.b + (long long)kvh * vs.h;
  for (int idx = threadIdx.x; idx < CS * C4; idx += kThreads) {
    const int r = idx / C4, c = idx % C4, pos = s0 + r;
    float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
    if (pos < hi) {
      kx = repro::load4(kbase + pos * ks.s + 4 * c);
      vx = repro::load4(vbase + pos * vs.s + 4 * c);
    }
    k_s[r][4 * c] = kx.x; k_s[r][4 * c + 1] = kx.y; k_s[r][4 * c + 2] = kx.z; k_s[r][4 * c + 3] = kx.w;
    v_s[r][4 * c] = vx.x; v_s[r][4 * c + 1] = vx.y; v_s[r][4 * c + 2] = vx.z; v_s[r][4 * c + 3] = vx.w;
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < G * CS; idx += kThreads) {
    const int g = idx / CS, r = idx % CS, pos = s0 + r;
    float s = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) s += q_s[g][d] * k_s[r][d];
    p_s[g][r] = (pos >= lo && pos < hi) ? s : kNegInf;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < G; g += kThreads / 32) {
    float mx = kNegInf;
    for (int r = lane; r < CS; r += 32) mx = fmaxf(mx, p_s[g][r]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int r = lane; r < CS; r += 32) {
      const float s = p_s[g][r];
      const float p = s == kNegInf ? 0.f : expf(s - mx);
      p_s[g][r] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      float* ml = part_ml + (((long long)b * H + kvh * G + g) * NS + split) * 2;
      ml[0] = mx;
      ml[1] = sum;
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float a = 0.f;
#pragma unroll 16
    for (int r = 0; r < CS; ++r) a += p_s[g][r] * v_s[r][d];
    part_acc[(((long long)b * H + kvh * G + g) * NS + split) * D + d] = a;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_combine(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
               const int* __restrict__ lengths, T* __restrict__ o, int S, int H, int NS,
               int window) {
  constexpr int CS = split_rows(D);
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int len = lengths[b];
  const int hi = min(len, S);
  const int lo = window > 0 ? max(0, len - window) : 0;
  float out = 0.f;
  if (hi > lo) {
    // exactly the splits pass 1 wrote: each holds at least one live position
    const int first = lo / CS, last = (hi - 1) / CS;
    const long long base = ((long long)b * H + h) * NS;
    float M = kNegInf;
    for (int s = first; s <= last; ++s) M = fmaxf(M, part_ml[(base + s) * 2]);
    float L = 0.f, a = 0.f;
    for (int s = first; s <= last; ++s) {
      const float w = expf(part_ml[(base + s) * 2] - M);
      L += w * part_ml[(base + s) * 2 + 1];
      a += w * part_acc[(base + s) * D + d];
    }
    out = a / fmaxf(L, 1e-30f);
  }
  o[((long long)b * H + h) * D + d] = repro::from_float<T>(out);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths,
                   float* part_ml, float* part_acc, void* o, int B, int S, int H, int KVH,
                   Strides qs, Strides ks, Strides vs, int window, float scale,
                   cudaStream_t stream) {
  const int NS = (S + split_rows(D) - 1) / split_rows(D);
  decode_split<T, D><<<dim3(NS, KVH, B), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      part_ml, part_acc, S, H, KVH, NS, qs, ks, vs, window, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine<T, D><<<dim3(H, B), D, 0, stream>>>(part_ml, part_acc, lengths,
                                                     static_cast<T*>(o), S, H, NS, window);
  return cudaGetLastError();
}

}  // namespace

// Number of cache splits pass 1 uses; the caller sizes the partials with it:
// part_ml (B, H, splits, 2) and part_acc (B, H, splits, D), both float32.
extern "C" int decode_attention_splits(int D, int S) {
  if (D != 16 && D != 32 && D != 64 && D != 128) return REPRO_UNSUPPORTED;
  return (S + split_rows(D) - 1) / split_rows(D);
}

// dtype: 0 float32, 1 bfloat16. q is (B, 1, H, D) read through (q_sb, q_sh);
// the cache (B, S, KVH, D) through its strides; lengths (B,) int32; window
// <= 0: none. o is (B, 1, H, D), contiguous. Returns 0, a cudaError_t, or
// REPRO_UNSUPPORTED for a type, head dim or group size it does not take.
extern "C" int decode_attention_fwd(int dtype, int device, const void* q, const void* k,
                                    const void* v, const int* lengths, float* part_ml,
                                    float* part_acc, void* o, int B, int S, int H, int KVH,
                                    int D, long long q_sb, long long q_sh, long long k_sb,
                                    long long k_ss, long long k_sh, long long v_sb,
                                    long long v_ss, long long v_sh, int window, float scale,
                                    void* stream) {
  if (KVH <= 0 || H % KVH != 0 || H / KVH > kMaxGroup) return REPRO_UNSUPPORTED;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Strides qs{q_sb, 0, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_DECODE(T, DIM)                                                                  \
  launch<T, DIM>(q, k, v, lengths, part_ml, part_acc, o, B, S, H, KVH, qs, ks, vs, window, \
                 scale, st)
#define REPRO_DECODE_DIMS(T)                   \
  if (D == 16) return REPRO_DECODE(T, 16);     \
  if (D == 32) return REPRO_DECODE(T, 32);     \
  if (D == 64) return REPRO_DECODE(T, 64);     \
  if (D == 128) return REPRO_DECODE(T, 128);
  if (dtype == 0) { REPRO_DECODE_DIMS(float) }
  if (dtype == 1) { REPRO_DECODE_DIMS(__nv_bfloat16) }
#undef REPRO_DECODE_DIMS
#undef REPRO_DECODE
  return REPRO_UNSUPPORTED;
}
