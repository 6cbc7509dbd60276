// Paged decode attention for Hopper (sm_90a) — the §2.2 hardware TLB as a
// kernel: the virtual-to-physical page translation happens inside the
// attention kernel, which reads the page table itself; no gather
// materialises a sequence's K/V first.
//
// Replaces: src/repro/kernels/paged_attention.py::paged_attention (the
// Pallas kernel `_kernel`, grid (B, H, max_pages)).
//
// What bounds it: bytes.  One decode step reads every resident K/V page
// once, sum(seq_len) * 2 * Hkv * D * itemsize bytes, and does 4 flops per
// byte-pair read — far below the card's ~295 flops/byte ridge.  So the
// design spends nothing on tensor cores and everything on reading each page
// once:
//   * one block per (sequence b, KV head); the `group = H / Hkv` query heads
//     that share the KV head share every K/V load (the Pallas grid streams
//     each page once per query head);
//   * the block walks only the resident positions, min(seq_len,
//     max_pages * page), in tiles of TILE keys gathered through the page
//     table, so ragged batches pay only for what they hold;
//   * online softmax in fp32 shared memory across tiles; a row that sees no
//     key (seq_len == 0) writes 0, like the Pallas kernel.
// Left for later work: splitting long sequences across blocks (a
// log-sum-exp combine) so that small batches fill all 132 SMs, and 16-byte
// vector loads.
//
// Layouts (all contiguous): q (B, H, D); k_pages, v_pages (P, page, Hkv,
// D); page_table (B, max_pages) int32; seq_lens (B,) int32; out (B, H, D)
// in q's dtype.  T is float or __nv_bfloat16, D is 64 or 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// keys per tile: 4096 / D, so the K and V tiles take 32 KB of fp32 together
template <int D> struct Tile { static constexpr int kKeys = 4096 / D; };

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int32_t* __restrict__ page_table,
                       const int32_t* __restrict__ seq_lens,
                       T* __restrict__ out, int H, int Hkv, int page,
                       int max_pages, float scale) {
  constexpr int TILE = Tile<D>::kKeys;
  constexpr int KS = D + 1;  // padded K row: the score loop reads K by rows
  const int hkv = blockIdx.x;
  const int b = blockIdx.y;
  const int group = H / Hkv;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* k_s = smem;                    // TILE x KS
  float* v_s = k_s + TILE * KS;         // TILE x D
  float* q_s = v_s + TILE * D;          // group x D, pre-scaled
  float* acc = q_s + group * D;         // group x D
  float* p_s = acc + group * D;         // group x TILE (scores, then probs)
  float* m_s = p_s + group * TILE;      // group: running max
  float* l_s = m_s + group;             // group: running sum
  float* a_s = l_s + group;             // group: this tile's rescale factor

  const int h0 = hkv * group;
  for (int i = tid; i < group * D; i += kThreads) {
    const int g = i / D, d = i % D;
    q_s[i] = to_float(q[((size_t)b * H + h0 + g) * D + d]) * scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < group; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }

  const int n_keys = min(seq_lens[b], max_pages * page);
  const int32_t* row = page_table + (size_t)b * max_pages;
  for (int j0 = 0; j0 < n_keys; j0 += TILE) {
    __syncthreads();  // previous tile fully consumed (and q_s/acc set up)
    // gather this tile's keys through the page table: the TLB
    for (int i = tid; i < TILE * D; i += kThreads) {
      const int t = i / D, d = i % D;
      const int pos = j0 + t;
      float kv = 0.f, vv = 0.f;
      if (pos < n_keys) {
        const int phys = row[pos / page];
        const size_t off =
            (((size_t)phys * page + pos % page) * Hkv + hkv) * D + d;
        kv = to_float(k_pages[off]);
        vv = to_float(v_pages[off]);
      }
      k_s[t * KS + d] = kv;
      v_s[t * D + d] = vv;
    }
    __syncthreads();
    // scores: one (query head, key) pair per thread and step
    for (int i = tid; i < group * TILE; i += kThreads) {
      const int g = i / TILE, t = i % TILE;
      float s = -INFINITY;
      if (j0 + t < n_keys) {
        s = 0.f;
        const float* qr = q_s + g * D;
        const float* kr = k_s + t * KS;
#pragma unroll 16
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      }
      p_s[i] = s;
    }
    __syncthreads();
    // running max per query head; every tile holds at least one live key
    for (int g = tid; g < group; g += kThreads) {
      float mt = -INFINITY;
      for (int t = 0; t < TILE; ++t) mt = fmaxf(mt, p_s[g * TILE + t]);
      const float m_new = fmaxf(m_s[g], mt);
      a_s[g] = expf(m_s[g] - m_new);  // 0 on the first tile (m = -inf)
      m_s[g] = m_new;
    }
    __syncthreads();
    for (int i = tid; i < group * TILE; i += kThreads) {
      p_s[i] = expf(p_s[i] - m_s[i / TILE]);  // masked keys: exp(-inf) = 0
    }
    __syncthreads();
    for (int i = tid; i < group * D; i += kThreads) {
      const int g = i / D, d = i % D;
      const float* pr = p_s + g * TILE;
      float o = 0.f;
      for (int t = 0; t < TILE; ++t) o = fmaf(pr[t], v_s[t * D + d], o);
      acc[i] = acc[i] * a_s[g] + o;
      if (d == 0) {
        float l = 0.f;
        for (int t = 0; t < TILE; ++t) l += pr[t];
        l_s[g] = l_s[g] * a_s[g] + l;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < group * D; i += kThreads) {
    const int g = i / D, d = i % D;
    const float l = l_s[g];
    out[((size_t)b * H + h0 + g) * D + d] =
        from_float<T>(l > 0.f ? acc[i] / l : 0.f);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* pt,
           const void* sl, void* out, int B, int H, int Hkv, int page,
           int max_pages, float scale, cudaStream_t stream) {
  constexpr int TILE = Tile<D>::kKeys;
  const int group = H / Hkv;
  const size_t smem =
      sizeof(float) * ((size_t)TILE * (D + 1) + (size_t)TILE * D +
                       2 * (size_t)group * D + (size_t)group * TILE +
                       3 * (size_t)group);
  auto kernel = paged_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int32_t*)pt,
      (const int32_t*)sl, (T*)out, H, Hkv, page, max_pages, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success); -1 for a D or dtype this file does not build.
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* page_table,
                                      const void* seq_lens, void* out, int B,
                                      int H, int Hkv, int D, int page,
                                      int max_pages, float scale, int dtype,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k_pages, v_pages, page_table, seq_lens, out,
                             B, H, Hkv, page, max_pages, scale, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k_pages, v_pages, page_table, seq_lens, out,
                              B, H, Hkv, page, max_pages, scale, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k_pages, v_pages, page_table,
                                     seq_lens, out, B, H, Hkv, page,
                                     max_pages, scale, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k_pages, v_pages, page_table,
                                      seq_lens, out, B, H, Hkv, page,
                                      max_pages, scale, s);
  return -1;
}
