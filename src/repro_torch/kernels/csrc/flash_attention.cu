// Blocked (flash) causal GQA attention for Hopper (sm_90a) — whole-prompt
// prefill.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (the
// Pallas kernel `_kernel`, grid (B, H, Sq/bq, Skv/bk)), and computes the
// same function as src/repro/kernels/ref.py::mha_attention, which the JAX
// engine's prefill runs, including its `compute_dtype` rounding points.
//
// What bounds it: operations.  A causal prompt of S tokens costs
// ~2 * S^2 * D * H flops against ~(2*H + 4*Hkv) * S * D bytes, far above the
// card's ridge.  This first version is the simple, right kernel: the
// products are fp32 FMAs on the CUDA cores (not wgmma), so it sits far
// below the bf16 tensor-core bound; what the design does about the bound
// is only to do no work it need not do:
//   * one block per (b, query head, 64-row query tile); the block loops over
//     64-key K/V tiles staged in shared memory, with an fp32 online softmax
//     in registers, so the (S x S) logits never reach device memory;
//   * causal keys are right-aligned (query i sees keys <= i + Skv - Sq) and
//     the tiles above the diagonal are never loaded;
//   * ragged tails are masked (no divisibility requirement), and a row that
//     sees no key writes 0, like the Pallas kernel;
//   * GQA: query head h reads KV head h / (H / Hkv).
// Each thread owns a 4x4 block of the score tile and 4 rows x D/16 columns
// of the output; the 16 threads that share a row are one half-warp, so row
// maxima and sums are warp shuffles.  Later work: wgmma/mma.sync products
// and TMA loads.
//
// compute_bf16 = 1 rounds q*scale, k, v and the probabilities to bf16 before
// the products (accumulation stays fp32), the rounding points of
// mha_attention(compute_dtype=bfloat16).
//
// Layouts (all contiguous): q, out (B, H, Sq, D); k, v (B, Hkv, Skv, D).
// T is float or __nv_bfloat16, D is 64 or 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 256; // 16 row groups x 16 column lanes

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
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H,
                       int Hkv, int Sq, int Skv, int causal, float scale,
                       int compute_bf16) {
  constexpr int QS = D + 1;    // padded rows: no bank conflicts on row reads
  constexpr int KS = D + 1;
  constexpr int PS = kBK + 1;
  constexpr int NJ = D / 16;   // output columns per thread
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hkv = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int offs = Skv - Sq;

  extern __shared__ float smem[];
  float* q_s = smem;             // kBQ x QS
  float* k_s = q_s + kBQ * QS;   // kBK x KS
  float* v_s = k_s + kBK * KS;   // kBK x D
  float* p_s = v_s + kBK * D;    // kBQ x PS

  const T* qb = q + ((size_t)b * H + h) * (size_t)Sq * D;
  const T* kb = k + ((size_t)b * Hkv + hkv) * (size_t)Skv * D;
  const T* vb = v + ((size_t)b * Hkv + hkv) * (size_t)Skv * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (q0 + r < Sq) {
      x = to_float(qb[(size_t)(q0 + r) * D + d]) * scale;
      if (compute_bf16) x = round_bf16(x);
    }
    q_s[r * QS + d] = x;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  const int nk = (Skv + kBK - 1) / kBK;
  int n_tiles = nk;
  if (causal) {
    const int last_key = min(q0 + kBQ, Sq) - 1 + offs;
    n_tiles = last_key < 0 ? 0 : min(nk, last_key / kBK + 1);
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // previous tile consumed; q_s written
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      float kv = 0.f, vv = 0.f;
      if (k0 + c < Skv) {
        kv = to_float(kb[(size_t)(k0 + c) * D + d]);
        vv = to_float(vb[(size_t)(k0 + c) * D + d]);
        if (compute_bf16) {
          kv = round_bf16(kv);
          vv = round_bf16(vv);
        }
      }
      k_s[c * KS + d] = kv;
      v_s[c * D + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool ok = key < Skv && (!causal || key <= qi + offs);
        s[i][j] = ok ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w, 16));
      const float m_new = fmaxf(m[i], mx);
      float alpha = 1.f, rs = 0.f;
      if (m_new != -INFINITY) {
        alpha = expf(m[i] - m_new);  // 0 when m[i] = -inf
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = expf(s[i][j] - m_new);  // masked: exp(-inf) = 0
          rs += s[i][j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, w, 16);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = compute_bf16 ? round_bf16(s[i][j]) : s[i][j];
        p_s[(ty + 16 * i) * PS + tx + 16 * j] = p;
      }
    }
    __syncwarp();  // a row's probabilities come from its own half-warp

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) vv[jj] = v_s[c * D + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
          acc[i][jj] = fmaf(pv[i], vv[jj], acc[i][jj]);
    }
  }

  T* ob = out + ((size_t)b * H + h) * (size_t)Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      ob[(size_t)qi * D + tx + 16 * jj] = from_float<T>(acc[i][jj] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Hkv, int Sq, int Skv, int causal, float scale,
           int compute_bf16, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kBQ * (D + 1) +
                                       (size_t)kBK * (D + 1) +
                                       (size_t)kBK * D +
                                       (size_t)kBQ * (kBK + 1));
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, H, Hkv, Sq, Skv, causal,
      scale, compute_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success); -1 for a D or dtype this file does not build.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int H,
                                      int Hkv, int Sq, int Skv, int D,
                                      int causal, float scale,
                                      int compute_bf16, int dtype,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, out, B, H, Hkv, Sq, Skv, causal, scale,
                             compute_bf16, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, out, B, H, Hkv, Sq, Skv, causal, scale,
                              compute_bf16, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, B, H, Hkv, Sq, Skv, causal,
                                     scale, compute_bf16, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, B, H, Hkv, Sq, Skv,
                                      causal, scale, compute_bf16, s);
  return -1;
}
