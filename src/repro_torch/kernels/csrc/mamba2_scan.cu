// Mamba2 SSD selective scan (n_groups = 1) for Hopper (sm_90a) — prefill.
//
// Replaces: src/repro/kernels/mamba2_scan.py::mamba2_scan (the Pallas
// kernel `_kernel`, grid (B, H, S/L), the (ds x dh) state carried in VMEM
// scratch across the sequential chunk axis), and computes the function of
// src/repro/kernels/ref.py::mamba2_scan_chunked with its `h0` /
// `return_state` contract, which the Pallas kernel lacks:
//   h_t = exp(A dt_t) h_{t-1} + dt_t B_t (x) x_t ;  y_t = C_t . h_t + D x_t
// for any S >= 1: a ragged last chunk behaves as the reference's padding
// with dt = 0 (decay 1, nothing injected).
//
// Per chunk of L = 64 steps, with s_t the inclusive cumulative sum of A dt:
//   att[t, tau] = (C_t . B_tau) exp(s_t - s_tau) dt_tau      (tau <= t)
//   y_t   = sum_tau att[t, tau] x_tau + exp(s_t) C_t . h_in + D x_t
//   h_out = exp(s_L) h_in + sum_tau exp(s_L - s_tau) dt_tau B_tau (x) x_tau
// The exponent is selected before exp (tau <= t only), so the positive
// upper triangle never reaches exp.
//
// What bounds it on the H100: bytes.  Per chunk and head the products cost
// 2 * (L^2 ds + L^2 dh + 2 L ds dh) = 2.1 Mflop at L = ds = dh = 64, i.e.
// 32.8 kflop per step and head; the state-passing form needs 5 ds dh +
// 2 dh = 20.6 kflop (h = decay h + dt B x: a multiply and an FMA per state
// element; y = C . h: an FMA; D x).  At zamba2's prefill (B=4, S=1024,
// H=64, bf16) the kernel moves x and y (33.6 MB each) plus B, C and dt
// (~2 MB): 0.020 ms of HBM time, against 0.0055 ms for the state-passing
// flops at the bf16 tensor-core rate.  This simple kernel does the products as fp32 FMAs from shared
// memory (about 2 shared loads per 4 FMAs), so shared-memory bandwidth, not
// HBM, limits it.  Its design:
//   * one block per (b, h), 256 threads, looping over chunks of L = 64; x,
//     B, C, the (L x L) weights and the (ds x dh) fp32 state live in shared
//     memory (~84 KB, dynamic; two blocks fit on an SM, so the 256 blocks of
//     B=4, H=64 are resident at once on 132 SMs);
//   * every (64 x 64) product is a 16 x 16 thread grid with a 4 x 4 register
//     tile per thread (rows ty + 16a, columns tx + 16c);
//   * the chunk's cumulative decay is one warp scan.
// Left for a later PR: mma.sync / wgmma for the chunk products; C B^T is the
// same for all heads (n_groups = 1), so one (L x L) product per (b, chunk)
// could serve all 64 heads instead of one per head.
//
// Layouts: x, y (B, S, H, dh) with x given by its batch and step strides
// (elements; head stride dh, channel stride 1), y contiguous; Bmat, Cmat
// (B, S, ds) by their batch and step strides (channel stride 1); x, y,
// Bmat, Cmat share T (float or __nv_bfloat16).  dt (B, S, H), A, D (H,),
// h0, h_out (B, H, ds, dh) are fp32 and contiguous; h0 and h_out may be
// null.  Arithmetic is fp32 throughout; build without --use_fast_math /
// -ftz.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kL = 64;           // chunk length
constexpr int kDH = 64;          // head size this file builds
constexpr int kDS = 64;          // state size this file builds
constexpr int kThreads = 256;    // 16 x 16, a 4 x 4 tile each
constexpr int kP = kDS + 1;      // padded row of B, C and att (bank spread)
// one loader and one fused (att x | C h) loop serve all three extents
static_assert(kL == kDH && kL == kDS, "L, dh and ds must be equal");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr size_t kSmemFloats =
    (size_t)kL * kDH +     // x_s
    (size_t)kL * kP * 3 +  // b_s, c_s, att_s
    (size_t)kDS * kDH +    // h_s
    (size_t)kL * 4;        // dt_s, s_s, es_s, wd_s

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
mamba2_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   const T* __restrict__ Cm, const float* __restrict__ Dv,
                   const float* __restrict__ h0, T* __restrict__ y,
                   float* __restrict__ h_out, int S, int H, long long x_sb,
                   long long x_ss, long long b_sb, long long b_ss,
                   long long c_sb, long long c_ss) {
  extern __shared__ float smem[];
  float* x_s = smem;                 // [kL][kDH]
  float* b_s = x_s + kL * kDH;       // [kL][kP]
  float* c_s = b_s + kL * kP;        // [kL][kP]
  float* att_s = c_s + kL * kP;      // [kL][kP]
  float* h_s = att_s + kL * kP;      // [kDS][kDH]
  float* dt_s = h_s + kDS * kDH;     // [kL]
  float* s_s = dt_s + kL;            // cumulative log-decay, inclusive
  float* es_s = s_s + kL;            // exp(s_t)
  float* wd_s = es_s + kL;           // exp(s_L - s_t) dt_t

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const float a_h = A[h];
  const float d_h = Dv[h];
  const size_t hbase = ((size_t)b * H + h) * kDS * kDH;

  for (int e = tid; e < kDS * kDH; e += kThreads)
    h_s[e] = h0 ? h0[hbase + e] : 0.f;

  const T* xb = x + (size_t)b * x_sb + (size_t)h * kDH;
  const T* bb = Bm + (size_t)b * b_sb;
  const T* cb = Cm + (size_t)b * c_sb;
  T* yb = y + ((size_t)b * S * H + h) * kDH;     // y is contiguous
  const size_t y_ss = (size_t)H * kDH;

  for (int t0 = 0; t0 < S; t0 += kL) {
    const int n = min(kL, S - t0);
    __syncthreads();  // the previous chunk is consumed and h_s written
    for (int e = tid; e < kL * kDH; e += kThreads) {
      const int t = e / kDH, d = e % kDH;
      const bool ok = t < n;
      const size_t ts = (size_t)(t0 + t);
      x_s[e] = ok ? to_float(xb[ts * x_ss + d]) : 0.f;
      b_s[t * kP + d] = ok ? to_float(bb[ts * b_ss + d]) : 0.f;
      c_s[t * kP + d] = ok ? to_float(cb[ts * c_ss + d]) : 0.f;
    }
    if (tid < kL)
      dt_s[tid] = tid < n ? dt[((size_t)b * S + t0 + tid) * H + h] : 0.f;
    __syncthreads();

    if (tid < 32) {   // inclusive scan of A dt over the chunk, 2 per lane
      const float a0 = a_h * dt_s[2 * tid], a1 = a_h * dt_s[2 * tid + 1];
      const float p1 = a0 + a1;
      float incl = p1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      const float excl = incl - p1;
      const float s0v = excl + a0, s1v = incl;
      const float s_last = __shfl_sync(0xffffffffu, incl, 31);
      s_s[2 * tid] = s0v;
      s_s[2 * tid + 1] = s1v;
      es_s[2 * tid] = expf(s0v);
      es_s[2 * tid + 1] = expf(s1v);
      wd_s[2 * tid] = expf(s_last - s0v) * dt_s[2 * tid];
      wd_s[2 * tid + 1] = expf(s_last - s1v) * dt_s[2 * tid + 1];
    }
    __syncthreads();

    // att[t][tau] = (C_t . B_tau) exp(s_t - s_tau) dt_tau for tau <= t
    {
      float acc[4][4] = {};
#pragma unroll 4
      for (int k = 0; k < kDS; ++k) {
        float cv[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = c_s[(ty + 16 * a) * kP + k];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = b_s[(tx + 16 * c) * kP + k];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(cv[a], bv[c], acc[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = ty + 16 * a;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int tau = tx + 16 * c;
          att_s[t * kP + tau] =
              tau <= t ? acc[a][c] * expf(s_s[t] - s_s[tau]) * dt_s[tau]
                       : 0.f;
        }
      }
    }
    __syncthreads();

    // y_t = att x + exp(s_t) C_t . h_in + D x_t;  h_out, kept in registers
    float hn[4][4];
    {
      float ay[4][4] = {}, ah[4][4] = {};
#pragma unroll 4
      for (int k = 0; k < kL; ++k) {
        float av[4], cv[4], xv[4], hv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          av[a] = att_s[(ty + 16 * a) * kP + k];
          cv[a] = c_s[(ty + 16 * a) * kP + k];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          xv[c] = x_s[k * kDH + tx + 16 * c];
          hv[c] = h_s[k * kDH + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            ay[a][c] = fmaf(av[a], xv[c], ay[a][c]);
            ah[a][c] = fmaf(cv[a], hv[c], ah[a][c]);
          }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = ty + 16 * a;
        if (t >= n) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int d = tx + 16 * c;
          const float out =
              ay[a][c] + es_s[t] * ah[a][c] + d_h * x_s[t * kDH + d];
          yb[(size_t)(t0 + t) * y_ss + d] = from_float<T>(out);
        }
      }

      const float decay_all = expf(s_s[kL - 1]);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) hn[a][c] = 0.f;
#pragma unroll 4
      for (int k = 0; k < kL; ++k) {
        float bw[4], xv[4];
        const float wk = wd_s[k];
#pragma unroll
        for (int a = 0; a < 4; ++a) bw[a] = wk * b_s[k * kP + ty + 16 * a];
#pragma unroll
        for (int c = 0; c < 4; ++c) xv[c] = x_s[k * kDH + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) hn[a][c] = fmaf(bw[a], xv[c], hn[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          hn[a][c] = fmaf(decay_all,
                          h_s[(ty + 16 * a) * kDH + tx + 16 * c], hn[a][c]);
    }
    __syncthreads();  // every read of h_in is done
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        h_s[(ty + 16 * a) * kDH + tx + 16 * c] = hn[a][c];
  }

  if (h_out) {
    __syncthreads();
    for (int e = tid; e < kDS * kDH; e += kThreads) h_out[hbase + e] = h_s[e];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* D, const void* h0, void* y,
           void* h_out, int B, int S, int H, long long x_sb, long long x_ss,
           long long b_sb, long long b_ss, long long c_sb, long long c_ss,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * kSmemFloats;
  auto kernel = mamba2_scan_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
      (const T*)Cm, (const float*)D, (const float*)h0, (T*)y, (float*)h_out,
      S, H, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, Bmat, Cmat, y).  Strides are in
// elements.  h0 / h_out may be null.  Returns cudaGetLastError() after the
// launch (0 on success); -1 for a dh, ds or dtype this file does not build.
extern "C" int mamba2_scan_launch(const void* x, const void* dt,
                                  const void* A, const void* Bm,
                                  const void* Cm, const void* D,
                                  const void* h0, void* y, void* h_out, int B,
                                  int S, int H, int dh, int ds,
                                  long long x_sb, long long x_ss,
                                  long long b_sb, long long b_ss,
                                  long long c_sb, long long c_ss, int dtype,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dh != kDH || ds != kDS) return -1;
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, D, h0, y, h_out, B, S, H, x_sb,
                         x_ss, b_sb, b_ss, c_sb, c_ss, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, D, h0, y, h_out, B, S, H,
                                 x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, st);
  return -1;
}
