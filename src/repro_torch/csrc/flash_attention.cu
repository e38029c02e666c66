// Flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention_kernel (body
// _flash_kernel, pallas_call at :141): online-softmax attention, causal,
// sliding window (q_pos - k_pos < window) or non-causal, with q_offset, and
// GQA through kv head h / G. Accumulation is f32; the output takes q's type.
//
// What bounds it on this card: at the serving shapes (B=4, S=512, 16 heads,
// head dim 64, bf16) the function moves ~17 MB of q/k/v/o and does ~2.1
// GFLOP of causal work, so its floor is the memory (~5 us at 3.35 TB/s), not
// the tensor cores (~2 us at 989 TF/s); at recurrentgemma-9b's (16 heads,
// one kv head, head dim 256, window 2048) it moves ~36 MB (~11 us) for 8.6
// GFLOP (~9 us). This first version runs its products
// on the CUDA cores in f32 (67 TF/s), which makes it bound by operations and
// by shared-memory reads instead; moving the two products to wgmma is the
// later step.
//
// Design: one block of 256 threads owns 64 query rows of one (batch, head)
// (32 rows at head dim 256); four neighbouring lanes share a row (eight at head
// dim 256), each holding its share of the head dim of q and of the
// accumulator in registers, and reduce their partial dot products with
// shuffles. At head dim 256 four lanes would each hold 128 floats of q and
// accumulator, past the register budget of a 256-thread block, hence eight.
// K/V tiles are staged through shared memory as f32. The kv loop runs only
// over the tiles below the causal limit and above the window limit of the
// block's rows — no tile is visited and then gated, unlike the TPU grid,
// which has to step through every kv block. Operands are read in the model
// layout (B, S, heads, D) through their strides, so no transpose copy
// precedes the launch. Head dims 16, 32, 64, 128 and 256 are instantiated.

#include "common.cuh"

namespace {

using repro::kNegInf;
using repro::Strides;

constexpr int kThreads = 256;

// threads sharing one query row, query rows per block, kv rows per tile
__host__ __device__ constexpr int lanes(int D) { return D >= 256 ? 8 : 4; }
__host__ __device__ constexpr int block_q(int D) { return kThreads / lanes(D); }
__host__ __device__ constexpr int block_k(int D) { return D >= 64 ? 4096 / D : 64; }

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int Sq, int Sk, int H, int KVH, Strides qs, Strides ks,
          Strides vs, int causal, int window, int q_offset, float scale) {
  constexpr int kLanes = lanes(D), kBlockQ = block_q(D);
  constexpr int BK = block_k(D);        // kv rows per tile: 64 up to D=64, 32 at 128, 16 at 256
  constexpr int C4 = D / 4;             // float4 chunks in one row
  constexpr int CH = C4 / kLanes;       // chunks each lane owns: 1 at D=16 ... 8 at D=128 and 256
  __shared__ float4 k_s[BK][C4];
  __shared__ float4 v_s[BK][C4];

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int row = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int qi = qb * kBlockQ + row;
  const int qpos = qi + q_offset;

  // lane owns the float4 chunks lane, lane + kLanes, ... of its row, so the
  // lanes of a row read neighbouring chunks of a K/V row.
  float4 qr[CH], acc[CH];
  const T* qrow = q + b * qs.b + (long long)qi * qs.s + (long long)h * qs.h;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qi < Sq) x = repro::load4(qrow + 4 * (lane + kLanes * i));
    qr[i] = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInf, l = 0.f;

  // The kv positions any row of this block may see.
  const int first_pos = qb * kBlockQ + q_offset;
  const int last_pos = min(qb * kBlockQ + kBlockQ, Sq) - 1 + q_offset;
  const int kv_end = causal ? min(Sk, last_pos + 1) : Sk;
  const int kv_begin = window > 0 ? max(0, first_pos - window + 1) / BK * BK : 0;

  const T* kbase = k + b * ks.b + (long long)kvh * ks.h;
  const T* vbase = v + b * vs.b + (long long)kvh * vs.h;
  for (int t0 = kv_begin; t0 < kv_end; t0 += BK) {
    __syncthreads();  // every row is done with the previous tile
    for (int idx = threadIdx.x; idx < BK * C4; idx += kThreads) {
      const int r = idx / C4, c = idx % C4, kp = t0 + r;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (kp < Sk) {
        kx = repro::load4(kbase + kp * ks.s + 4 * c);
        vx = repro::load4(vbase + kp * vs.s + 4 * c);
      }
      k_s[r][c] = kx;
      v_s[r][c] = vx;
    }
    __syncthreads();

    float s[BK];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const float4 kk = k_s[j][lane + kLanes * i];
        part += qr[i].x * kk.x + qr[i].y * kk.y + qr[i].z * kk.z + qr[i].w * kk.w;
      }
#pragma unroll
      for (int off = 1; off < kLanes; off <<= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      const int kp = t0 + j;
      const bool live = kp < Sk && (!causal || qpos >= kp) && (window <= 0 || qpos - kp < window);
      s[j] = live ? part : kNegInf;
      tile_max = fmaxf(tile_max, s[j]);
    }

    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      acc[i].x *= corr; acc[i].y *= corr; acc[i].z *= corr; acc[i].w *= corr;
    }
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = s[j] == kNegInf ? 0.f : expf(s[j] - m_new);
      l += p;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const float4 vv = v_s[j][lane + kLanes * i];
        acc[i].x += p * vv.x; acc[i].y += p * vv.y; acc[i].z += p * vv.z; acc[i].w += p * vv.w;
      }
    }
    m = m_new;
  }

  if (qi < Sq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* orow = o + (((long long)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      repro::store4(orow + 4 * (lane + kLanes * i),
                    make_float4(acc[i].x * inv, acc[i].y * inv, acc[i].z * inv, acc[i].w * inv));
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                   int H, int KVH, Strides qs, Strides ks, Strides vs, int causal, int window,
                   int q_offset, float scale, cudaStream_t stream) {
  const dim3 grid((Sq + block_q(D) - 1) / block_q(D), H, B);
  flash_fwd<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, H, KVH, qs, ks, vs, causal, window, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. window <= 0: none. o is (B, Sq, H, D), contiguous.
// Returns 0, a cudaError_t, or REPRO_UNSUPPORTED for a type or head dim it does not take.
extern "C" int flash_attention_fwd(int dtype, int device, const void* q, const void* k,
                                   const void* v, void* o, int B, int Sq, int Sk, int H,
                                   int KVH, int D, long long q_sb, long long q_ss,
                                   long long q_sh, long long k_sb, long long k_ss,
                                   long long k_sh, long long v_sb, long long v_ss,
                                   long long v_sh, int causal, int window, int q_offset,
                                   float scale, void* stream) {
  if (KVH <= 0 || H % KVH != 0) return REPRO_UNSUPPORTED;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH(T, DIM) \
  launch<T, DIM>(q, k, v, o, B, Sq, Sk, H, KVH, qs, ks, vs, causal, window, q_offset, scale, st)
#define REPRO_FLASH_DIMS(T)                    \
  if (D == 16) return REPRO_FLASH(T, 16);      \
  if (D == 32) return REPRO_FLASH(T, 32);      \
  if (D == 64) return REPRO_FLASH(T, 64);      \
  if (D == 128) return REPRO_FLASH(T, 128);    \
  if (D == 256) return REPRO_FLASH(T, 256);
  if (dtype == 0) { REPRO_FLASH_DIMS(float) }
  if (dtype == 1) { REPRO_FLASH_DIMS(__nv_bfloat16) }
#undef REPRO_FLASH_DIMS
#undef REPRO_FLASH
  return REPRO_UNSUPPORTED;
}
