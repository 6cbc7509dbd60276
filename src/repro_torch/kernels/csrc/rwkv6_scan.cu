// RWKV6 (Finch) wkv recurrence for Hopper (sm_90a) — prefill and decode.
//
// Replaces: src/repro/kernels/rwkv6_scan.py::rwkv6_scan (the Pallas kernel
// `_kernel`, grid (B, H, S/L), the (dh x dh) state carried in VMEM scratch
// across the sequential chunk axis), and computes the function of
// src/repro/kernels/ref.py::rwkv6_scan with its `s0` / `return_state`
// contract, which the Pallas kernel lacks:
//   S_t = diag(w_t) S_{t-1} + k_t (x) v_t
//   y_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)
// for any S >= 1 (the Pallas kernel asserts S % chunk == 0).
//
// What bounds it on the H100: bytes.  Per step and head it reads r, k, v,
// w (4 * dh values) and writes y (dh values); the least arithmetic is
// 5 * dh^2 = 20 480 flops at dh = 64 (y = r . S + v (r . u k): one FMA per
// state element; S = w S + k v: a multiply and an FMA), and this kernel
// does 7 (it forms u k v per element).  At B=4, S=1024, H=32, bf16 that is
// 84 MB against 2.7 GFLOP: 0.025 ms of HBM time, 0.0027 ms at the bf16
// tensor-core rate.
// A decode step (S = 1) reads and writes the fp32 state, 2 MB each way at
// B=4, H=32.  The recurrence is sequential in S, and this simple kernel is
// latency bound on it, far above both bounds.  Its design:
//   * one block per (b, h), 4 * dh threads: thread (j, p) keeps the 16
//     state elements S[4*ii + p][j], ii < dh/4, in registers for the whole
//     sequence (interleaved rows: the 4 lanes of a column read 4 different
//     shared-memory banks); the loop over steps inside the block takes the
//     place of Pallas's sequential chunk axis;
//   * r, k, v, w are staged in shared memory kT = 32 steps at a time (one
//     coalesced load per chunk, two barriers per 32 steps), y goes back
//     through shared memory and out coalesced;
//   * y_t[j] is summed over the 4 lanes of column j with two shuffles.
// At B=4, H=32 that is 128 blocks for 132 SMs.  Left for a later PR: a
// chunk-parallel form (the intra-chunk (L x L) products on tensor cores,
// the state passed between chunks as the Pallas kernel does in VMEM),
// which removes the sequential dependence inside a chunk.
//
// Layouts (all contiguous): r, k, v, w, y (B, S, H, dh) in T (float or
// __nv_bfloat16); u (H, dh) fp32; s0, s_out (B, H, dh, dh) fp32, row index
// = k channel, column index = v channel; s0 and s_out may be null.
// Arithmetic is fp32 throughout; build without --use_fast_math / -ftz.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDH = 64;            // head size this file builds
constexpr int kLanes = 4;          // threads per state column
constexpr int kRows = kDH / kLanes;
constexpr int kThreads = kDH * kLanes;
constexpr int kT = 32;             // steps staged per chunk

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  T* __restrict__ y, float* __restrict__ s_out, int S,
                  int H) {
  __shared__ float r_s[kT][kDH];
  __shared__ float k_s[kT][kDH];
  __shared__ float v_s[kT][kDH];
  __shared__ float w_s[kT][kDH];
  __shared__ float y_s[kT][kDH];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int j = tid / kLanes;      // state column (v channel)
  const int p = tid % kLanes;      // rows p, p + 4, p + 8, ...

  float st[kRows], uu[kRows];
  const size_t sbase = ((size_t)b * H + h) * kDH * kDH;
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
    const int i = ii * kLanes + p;
    uu[ii] = u[(size_t)h * kDH + i];
    st[ii] = s0 ? s0[sbase + (size_t)i * kDH + j] : 0.f;
  }

  const size_t row = (size_t)H * kDH;            // stride of one step
  const size_t base = (size_t)b * S * row + (size_t)h * kDH;
  for (int t0 = 0; t0 < S; t0 += kT) {
    const int n = min(kT, S - t0);
    __syncthreads();               // the previous chunk's y_s is written out
    for (int e = tid; e < n * kDH; e += kThreads) {
      const int t = e / kDH, d = e % kDH;
      const size_t off = base + (size_t)(t0 + t) * row + d;
      r_s[t][d] = to_float(r[off]);
      k_s[t][d] = to_float(k[off]);
      v_s[t][d] = to_float(v[off]);
      w_s[t][d] = to_float(w[off]);
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float vj = v_s[t][j];
      float acc = 0.f;
#pragma unroll
      for (int ii = 0; ii < kRows; ++ii) {
        const int i = ii * kLanes + p;
        const float ki = k_s[t][i];
        const float kv = ki * vj;
        acc = fmaf(r_s[t][i], fmaf(uu[ii], kv, st[ii]), acc);
        st[ii] = fmaf(st[ii], w_s[t][i], kv);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (p == 0) y_s[t][j] = acc;
    }
    __syncthreads();
    for (int e = tid; e < n * kDH; e += kThreads) {
      const int t = e / kDH, d = e % kDH;
      y[base + (size_t)(t0 + t) * row + d] = from_float<T>(y_s[t][d]);
    }
  }

  if (s_out) {
#pragma unroll
    for (int ii = 0; ii < kRows; ++ii)
      s_out[sbase + (size_t)(ii * kLanes + p) * kDH + j] = st[ii];
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* s_out, int B, int S,
           int H, cudaStream_t stream) {
  dim3 grid(H, B);
  rwkv6_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const T*)w, (const float*)u,
      (const float*)s0, (T*)y, (float*)s_out, S, H);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w, y).  s0 / s_out may be
// null.  Returns cudaGetLastError() after the launch (0 on success); -1 for
// a dh or dtype this file does not build.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, const void* s0,
                                 void* y, void* s_out, int B, int S, int H,
                                 int dh, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dh != kDH) return -1;
  if (dtype == 0)
    return launch<float>(r, k, v, w, u, s0, y, s_out, B, S, H, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, u, s0, y, s_out, B, S, H, st);
  return -1;
}
