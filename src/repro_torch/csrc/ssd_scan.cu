// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan_kernel
// (body _ssd_kernel, pallas_call at :97). Per (batch, head) it walks the
// sequence in chunks of Q tokens and, for each chunk, with acum the running sum
// of the log decays a inside the chunk:
//   y_i  = sum_{j<=i} (C_i.B_j) exp(acum_i - acum_j) x_j  +  exp(acum_i) C_i.h
//   h   <- exp(acum_end) h + sum_j exp(acum_end - acum_j) x_j (x) B_j
// with the (P, N) state h carried in f32 from chunk to chunk. y takes x's type;
// the final state is f32.
//
// What bounds it on this card: at the serving shapes (mamba2-370m, B=4, S=512,
// H=32, P=64, N=128, chunk 256, bf16) it must read x, B, C and a and write y
// and the state: 55 MB with B and C per head, 22 MB with B and C read once per
// group, 7-16 us at 3.35 TB/s. Its causal products are 5.4 GFLOP, 5.4 us at
// 989 TF/s. This first version runs the products on the CUDA cores in f32 (67
// TF/s), so it is bound by operations; moving the three products to
// mma/wgmma on bf16 tiles is the later step.
//
// Design: the TPU grid walks chunks in order on one core and carries h in VMEM
// scratch; here one block owns one (batch, head, 32-column slice of P) and
// walks the chunks itself, h living in shared memory. Splitting P gives 2x the
// blocks of a (b, h) grid at P=64 (256 at the serving shapes, 64 for the
// fabric's B=1 probe) at the cost of computing the (C.B) scores once per slice.
// Inside a chunk the rows are handled in 32x32 tiles, so shared memory holds
// only one 32-row tile of C, of B and of x at a time (a 256x128 chunk of B
// alone would be 128 KB in f32). The decay exp(acum_i - acum_j) is computed
// only for j <= i: above the diagonal it overflows, and a mask applied by
// multiplying would give inf*0 = NaN. A ragged last chunk is walked over its
// live rows only, which is what the TPU's padding (a=0, x=0) computes, without
// a padded copy. The prefix sums acum are kept in f64: over a 256-token chunk
// they reach about -200, where an f32 difference acum_i - acum_j keeps only
// about four digits (an error of ~1e-3 in y, measured on the card); each
// difference is taken in f64 and only then rounded to f32 for expf. x, B and C
// are read in the model layout (B, S, H, .) through
// their strides; B and C may have head stride 0 (one group broadcast to every
// head), so the repeat of the reference is never materialised.

#include "common.cuh"

namespace {

using repro::Strides;

constexpr int kThreads = 256;
constexpr int kTile = 32;     // rows i and j of a chunk per tile
constexpr int kPTile = 32;    // columns of P (rows of the state) per block
constexpr int kPer = kTile * kPTile / kThreads;   // y outputs per thread: 4
constexpr int kLPer = kTile * kTile / kThreads;   // scores per thread: 4

// floats of dynamic shared memory for state rows of N and chunks of Q
__host__ __device__ constexpr long long smem_floats(int N, int Q) {
  return (long long)kPTile * (N + 1)    // h: the carried state (P slice x N), padded rows
         + (long long)kTile * N         // one tile of C rows
         + (long long)kTile * (N + 1)   // one tile of B rows, padded
         + kTile * kPTile               // one tile of x rows (P slice)
         + kTile * kTile                // one tile of the masked, decayed scores
         + 2LL * Q;                     // acum of the chunk, f64
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_fwd(const T* __restrict__ x, const float* __restrict__ a, const T* __restrict__ Bm,
        const T* __restrict__ Cm, T* __restrict__ y, float* __restrict__ state, int S, int H,
        int P, int N, int Q, Strides xs, Strides as, Strides bs, Strides cs) {
  extern __shared__ float smem[];
  float* h_s = smem;                          // [kPTile][N + 1]
  float* c_s = h_s + kPTile * (N + 1);        // [kTile][N]
  float* b_s = c_s + kTile * N;               // [kTile][N + 1]
  float* x_s = b_s + kTile * (N + 1);         // [kTile][kPTile]
  float* l_s = x_s + kTile * kPTile;          // [kTile][kTile]
  // [Q] f64; 8-byte aligned, since every region above is a multiple of 32 floats
  double* acum = reinterpret_cast<double*>(l_s + kTile * kTile);

  const int p0 = blockIdx.x * kPTile, hd = blockIdx.y, b = blockIdx.z;
  const int pt = min(kPTile, P - p0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* xb = x + b * xs.b + hd * xs.h + p0;
  const float* ab = a + b * as.b + hd * as.h;
  const T* bb = Bm + b * bs.b + hd * bs.h;
  const T* cb = Cm + b * cs.b + hd * cs.h;

  for (int idx = tid; idx < kPTile * (N + 1); idx += kThreads) h_s[idx] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int qn = min(Q, S - c0);            // live rows of this chunk
    __syncthreads();                          // the previous chunk is done with acum and h
    if (warp == 0) {                          // acum: segment sums, then a warp scan
      const int per = (qn + 31) / 32, lo = min(lane * per, qn), hi = min(lo + per, qn);
      double run = 0.0;
      for (int t = lo; t < hi; ++t) {
        run += ab[(long long)(c0 + t) * as.s];
        acum[t] = run;
      }
      double incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      for (int t = lo; t < hi; ++t) acum[t] += incl - run;
    }
    __syncthreads();

    // ---- y of the chunk, one 32-row tile at a time (reads the old h) ----
    for (int i0 = 0; i0 < qn; i0 += kTile) {
      const int ni = min(kTile, qn - i0);
      for (int idx = tid; idx < kTile * N; idx += kThreads) {
        const int r = idx / N, n = idx % N;
        c_s[idx] = r < ni ? repro::to_float(cb[(long long)(c0 + i0 + r) * cs.s + n]) : 0.f;
      }
      __syncthreads();
      // inter-chunk term: exp(acum_i) C_i . h[p]
      float acc[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int idx = tid + k * kThreads, r = idx / pt, p = idx % pt;
        acc[k] = 0.f;
        if (r < ni) {
          float s = 0.f;
          for (int n = 0; n < N; ++n) s += c_s[r * N + n] * h_s[p * (N + 1) + n];
          acc[k] = expf(static_cast<float>(acum[i0 + r])) * s;
        }
      }
      // intra-chunk term over the tiles of j at or below the diagonal
      for (int j0 = 0; j0 <= i0; j0 += kTile) {
        const int nj = min(kTile, qn - j0);
        __syncthreads();                      // the previous tile's readers are done
        for (int idx = tid; idx < kTile * N; idx += kThreads) {
          const int r = idx / N, n = idx % N;
          b_s[r * (N + 1) + n] =
              r < nj ? repro::to_float(bb[(long long)(c0 + j0 + r) * bs.s + n]) : 0.f;
        }
        for (int idx = tid; idx < kTile * kPTile; idx += kThreads) {
          const int r = idx / kPTile, p = idx % kPTile;
          x_s[idx] = (r < nj && p < pt)
                         ? repro::to_float(xb[(long long)(c0 + j0 + r) * xs.s + p]) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kLPer; ++k) {
          const int idx = tid + k * kThreads, ri = idx / kTile, rj = idx % kTile;
          const int i = i0 + ri, j = j0 + rj;
          float l = 0.f;
          if (ri < ni && rj < nj && j <= i) {  // decay only where it is finite
            float s = 0.f;
            for (int n = 0; n < N; ++n) s += c_s[ri * N + n] * b_s[rj * (N + 1) + n];
            l = s * expf(static_cast<float>(acum[i] - acum[j]));
          }
          l_s[idx] = l;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const int idx = tid + k * kThreads, r = idx / pt, p = idx % pt;
          if (r < ni) {
            float s = 0.f;
            for (int rj = 0; rj < nj; ++rj) s += l_s[r * kTile + rj] * x_s[rj * kPTile + p];
            acc[k] += s;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int idx = tid + k * kThreads, r = idx / pt, p = idx % pt;
        if (r < ni)
          y[(((long long)b * S + c0 + i0 + r) * H + hd) * P + p0 + p] =
              repro::from_float<T>(acc[k]);
      }
      __syncthreads();                        // c_s is reloaded by the next tile
    }

    // ---- state: h <- exp(acum_end) h + sum_j exp(acum_end - acum_j) x_j (x) B_j ----
    const double end = acum[qn - 1];
    const float chunk_decay = expf(static_cast<float>(end));
    for (int idx = tid; idx < pt * N; idx += kThreads)
      h_s[(idx / N) * (N + 1) + idx % N] *= chunk_decay;
    for (int j0 = 0; j0 < qn; j0 += kTile) {
      const int nj = min(kTile, qn - j0);
      __syncthreads();
      for (int idx = tid; idx < kTile * N; idx += kThreads) {
        const int r = idx / N, n = idx % N;
        b_s[r * (N + 1) + n] =
            r < nj ? repro::to_float(bb[(long long)(c0 + j0 + r) * bs.s + n]) : 0.f;
      }
      for (int idx = tid; idx < kTile * kPTile; idx += kThreads) {
        const int r = idx / kPTile, p = idx % kPTile;
        x_s[idx] = (r < nj && p < pt)
                       ? repro::to_float(xb[(long long)(c0 + j0 + r) * xs.s + p]) *
                             expf(static_cast<float>(end - acum[j0 + r]))
                       : 0.f;
      }
      __syncthreads();
      // each (p, n) belongs to one thread, the same one that scaled it above
      for (int idx = tid; idx < pt * N; idx += kThreads) {
        const int p = idx / N, n = idx % N;
        float s = 0.f;
        for (int rj = 0; rj < nj; ++rj) s += x_s[rj * kPTile + p] * b_s[rj * (N + 1) + n];
        h_s[p * (N + 1) + n] += s;
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < pt * N; idx += kThreads) {
    const int p = idx / N, n = idx % N;
    state[(((long long)b * H + hd) * P + p0 + p) * N + n] = h_s[p * (N + 1) + n];
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* a, const void* Bm, const void* Cm, void* y,
                   float* state, int B, int S, int H, int P, int N, int Q, Strides xs,
                   Strides as, Strides bs, Strides cs, cudaStream_t stream) {
  const size_t bytes = smem_floats(N, Q) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((P + kPTile - 1) / kPTile, H, B);
  ssd_fwd<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), a, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<T*>(y), state, S, H, P, N, Q, xs, as, bs, cs);
  return cudaGetLastError();
}

}  // namespace

// Bytes of shared memory a block needs for state width N and chunk Q (capped
// at INT_MAX); the caller refuses what exceeds the card's 227 KB per block.
extern "C" int ssd_scan_smem_bytes(int N, int Q) {
  const long long bytes = smem_floats(N, Q) * (long long)sizeof(float);
  return bytes > 0x7fffffffLL ? 0x7fffffff : static_cast<int>(bytes);
}

// dtype (of x, B, C and y): 0 float32, 1 bfloat16; a is float32. x (B, S, H, P),
// a (B, S, H), B and C (B, S, H, N) are read through their strides (the last dim
// contiguous; the head stride of B and C may be 0). y is (B, S, H, P) and state
// (B, H, P, N) f32, both contiguous. Q is the chunk. Returns 0, a cudaError_t,
// or REPRO_UNSUPPORTED.
extern "C" int ssd_scan_fwd(int dtype, int device, const void* x, const float* a,
                            const void* Bm, const void* Cm, void* y, float* state, int B, int S,
                            int H, int P, int N, int Q, long long x_sb, long long x_ss,
                            long long x_sh, long long a_sb, long long a_ss, long long a_sh,
                            long long b_sb, long long b_ss, long long b_sh, long long c_sb,
                            long long c_ss, long long c_sh, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || Q <= 0) return REPRO_UNSUPPORTED;
  if (ssd_scan_smem_bytes(N, Q) > 232448) return REPRO_UNSUPPORTED;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Strides xs{x_sb, x_ss, x_sh}, as{a_sb, a_ss, a_sh}, bs{b_sb, b_ss, b_sh},
      cs{c_sb, c_ss, c_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, a, Bm, Cm, y, state, B, S, H, P, N, Q, xs, as, bs, cs, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, a, Bm, Cm, y, state, B, S, H, P, N, Q, xs, as, bs, cs, st);
  return REPRO_UNSUPPORTED;
}
