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
// byte-pair read — far below the card's ~295 flops/byte ridge.  At small
// batch the difficulty is parallelism, not arithmetic: one block per
// (sequence, KV head) gives 16 blocks on 132 SMs at the engine's batch of 8
// and each walks its whole sequence alone.  So the design is flash-decoding
// (split-K) with the page table read inside the kernel:
//   * each (sequence, KV head) is cut into partitions of `part_keys` keys;
//     the grid is (n_split, Hkv * head chunks, B) with n_split =
//     ceil(max_pages * page / part_keys), taken from the page table's shape
//     alone, so the host never reads seq_lens (no synchronisation);
//   * a block whose partition starts at or past n_keys = min(seq_len,
//     max_pages * page) writes an empty partial (l = 0) and exits;
//   * inside a block, the query heads of the group that share the KV head
//     (at most 8 a block; larger groups take several head chunks) sit in
//     registers, scaled; each key's row is read by D * itemsize / 16 lanes
//     with one 16-byte load each (8 lanes for a bf16 D = 64 row), every lane
//     translating its key's page through the table; four keys a lane group
//     are loaded before any is used, so the loads overlap;
//   * dot products are the lanes' partial sums reduced by __shfl_xor within
//     the lane group; each lane group keeps its own online softmax in fp32
//     registers and accumulates P V over its own columns; lane groups
//     combine by shuffles and warps once through shared memory at the end
//     (one __syncthreads a block, none per key);
//   * partials (acc[D], m, l) per (b, h, split) go to an fp32 scratch, and
//     a second small kernel combines them by log-sum-exp, grid (H, B); a row
//     with no key (seq_len == 0) writes 0, like the Pallas kernel.
// One instantiation a dtype and D serves every group size, MHA included
// (heads past the group's are masked off): no served model takes K1 with
// a group of 1, so no narrower variant is kept for it.
// The arithmetic is the plain version's (q * scale in fp32, fp32 logits,
// exp, fp32 sums) in another order.
//
// Resources (ptxas -v, CUDA 12.8, sm_90a), bf16 D = 64 with 8 heads a
// block (qwen2's path): 218 registers, 8 448 bytes of static shared memory
// (4 warps x 8 heads x (D + 2) floats), no spills; the combine kernel 32
// registers.
//
// Layouts (all contiguous): q (B, H, D); k_pages, v_pages (P, page, Hkv,
// D); page_table (B, max_pages) int32; seq_lens (B,) int32; partials (B, H,
// n_split, D + 2) fp32 (acc[D], m, l); out (B, H, D) in q's dtype.  T is
// float or __nv_bfloat16, D is 64 or 128; every other D up to 128 takes
// the small-width route at the end of this file (`paged_small_kernel`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxHeads = 8;  // query heads a block serves
constexpr int kUnroll = 4;    // keys a lane group loads before using any

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T -> fp32
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void widen(const uint4& r, float (&f)[N]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void widen(const uint4& r, float (&f)[N]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 -> fp32 is a 16-bit shift
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
paged_partial_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                     const T* __restrict__ v_pages,
                     const int32_t* __restrict__ page_table,
                     const int32_t* __restrict__ seq_lens,
                     float* __restrict__ part, int H, int Hkv, int page,
                     int max_pages, int part_keys, int n_chunk, float scale) {
  constexpr int VEC = Vec<T>::N;   // elements a lane loads at once
  constexpr int LPK = D / VEC;     // lanes a key
  constexpr int KPW = 32 / LPK;    // keys a warp step
  constexpr int GROUPS = kWarps * KPW;
  constexpr int PS = D + 2;        // a partial: acc[D], m, l
  constexpr int G = kMaxHeads;
  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int hkv = blockIdx.y / n_chunk;
  const int chunk = blockIdx.y % n_chunk;
  const int b = blockIdx.z;
  const int group = H / Hkv;
  const int h0 = hkv * group + chunk * kMaxHeads;
  const int nh = min(kMaxHeads, group - chunk * kMaxHeads);  // <= G
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int sub = lane % LPK;     // this lane's 16-byte slice of a row
  const int grp = warp * KPW + lane / LPK;

  const int n_keys = min(seq_lens[b], max_pages * page);
  const int j0 = split * part_keys;
  const int j_end = min(j0 + part_keys, n_keys);
  float* pb = part + ((size_t)b * H + h0) * n_split * PS + (size_t)split * PS;
  if (j0 >= n_keys) {  // empty partition
    if (tid < nh) {
      pb[(size_t)tid * n_split * PS + D] = -INFINITY;
      pb[(size_t)tid * n_split * PS + D + 1] = 0.f;
    }
    return;
  }

  float qv[G][VEC], acc[G][VEC], m[G], l[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {  // q: one 16-byte load a head and lane
    m[gi] = -INFINITY;
    l[gi] = 0.f;
    uint4 qr = make_uint4(0u, 0u, 0u, 0u);
    if (gi < nh)
      qr = *reinterpret_cast<const uint4*>(q + ((size_t)b * H + h0 + gi) * D +
                                           sub * VEC);
    Vec<T>::widen(qr, qv[gi]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      acc[gi][e] = 0.f;
      qv[gi][e] *= scale;
    }
  }

  const int32_t* row = page_table + (size_t)b * max_pages;
  const int rounds = (j_end - j0 + GROUPS * kUnroll - 1) / (GROUPS * kUnroll);
  for (int it = 0; it < rounds; ++it) {
    uint4 kr[kUnroll], vr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // loads first, use after
      const int j = j0 + (it * kUnroll + u) * GROUPS + grp;
      if (j < j_end) {
        const int phys = row[j / page];  // the TLB
        const size_t off =
            (((size_t)phys * page + j % page) * Hkv + hkv) * D + sub * VEC;
        kr[u] = *reinterpret_cast<const uint4*>(k_pages + off);
        vr[u] = *reinterpret_cast<const uint4*>(v_pages + off);
      } else {
        kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool live = j0 + (it * kUnroll + u) * GROUPS + grp < j_end;
      float kf[VEC], vf[VEC];
      Vec<T>::widen(kr[u], kf);
      Vec<T>::widen(vr[u], vf);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) s = fmaf(qv[gi][e], kf[e], s);
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1)  // all lanes take part
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (live && gi < nh) {
          const float m_new = fmaxf(m[gi], s);
          const float alpha = expf(m[gi] - m_new);  // 0 when m = -inf
          const float p = expf(s - m_new);
          l[gi] = l[gi] * alpha + p;
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[gi][e] = fmaf(p, vf[e], acc[gi][e] * alpha);
          m[gi] = m_new;
        }
      }
    }
  }

  // lane groups of a warp hold the same columns: combine by shuffles
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
#pragma unroll
    for (int o = LPK; o < 32; o <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[gi], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[gi], o);
      const float mx = fmaxf(m[gi], mo);
      const float a = m[gi] == -INFINITY ? 0.f : expf(m[gi] - mx);
      const float c = mo == -INFINITY ? 0.f : expf(mo - mx);
      l[gi] = l[gi] * a + lo * c;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[gi][e], o);
        acc[gi][e] = acc[gi][e] * a + ao * c;
      }
      m[gi] = mx;
    }
  }
  // ... and the warps through shared memory, once
  __shared__ float w_acc[kWarps][G][D];
  __shared__ float w_ml[kWarps][G][2];
  if (lane < LPK) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) w_acc[warp][gi][sub * VEC + e] = acc[gi][e];
      if (sub == 0) {
        w_ml[warp][gi][0] = m[gi];
        w_ml[warp][gi][1] = l[gi];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < nh * D; i += kWarps * 32) {
    const int gi = i / D, d = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, w_ml[w][gi][0]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w_ml[w][gi][1] > 0.f) {  // a warp that saw no key adds nothing
        const float c = expf(w_ml[w][gi][0] - mx);
        lsum += w_ml[w][gi][1] * c;
        a += w_acc[w][gi][d] * c;
      }
    }
    float* dst = pb + (size_t)gi * n_split * PS;
    dst[d] = a;
    if (d == 0) {
      dst[D] = mx;
      dst[D + 1] = lsum;
    }
  }
}

// out[b, h] = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M); 0 if no key
template <typename T, int D>
__global__ void __launch_bounds__(D)
paged_combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                     int n_split) {
  constexpr int PS = D + 2;
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const int d = threadIdx.x;
  const float* p = part + ((size_t)b * H + h) * n_split * PS;
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s)
    if (p[s * PS + D + 1] > 0.f) mx = fmaxf(mx, p[s * PS + D]);
  float lsum = 0.f, a = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float l = p[s * PS + D + 1];
    if (l > 0.f) {  // empty partitions wrote no acc
      const float c = expf(p[s * PS + D] - mx);
      lsum += l * c;
      a += p[s * PS + d] * c;
    }
  }
  out[((size_t)b * H + h) * D + d] = from_float<T>(lsum > 0.f ? a / lsum
                                                              : 0.f);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* pt,
           const void* sl, float* part, void* out, int B, int H, int Hkv,
           int page, int max_pages, int part_keys, int n_split, float scale,
           int* blocks, cudaStream_t stream) {
  const int n_chunk = (H / Hkv + kMaxHeads - 1) / kMaxHeads;
  dim3 grid(n_split, Hkv * n_chunk, B);
  *blocks = grid.x * grid.y * grid.z;
  paged_partial_kernel<T, D><<<grid, kWarps * 32, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int32_t*)pt,
      (const int32_t*)sl, part, H, Hkv, page, max_pages, part_keys, n_chunk,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_combine_kernel<T, D><<<dim3(H, B), D, 0, stream>>>(part, (T*)out,
                                                            n_split);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// Small-width route: any D up to 128 outside 64 and 128 (the reduced
// configs' head width of 16).  Simple and exact first: one block of
// kSmallThreads a (head, sequence), scalar loads through the page table.
// Per tile of kSmallThreads keys, each thread scores one key (fp32 dot
// product of q * scale and the key's row), the block takes the tile's max
// and sum (shuffles, then the warps through shared memory), and thread d
// (d < D) rescales its output column and adds p_j v_j[d] over the tile's
// keys, as the plain version's softmax; a row with no key writes 0.
// ---------------------------------------------------------------------------

constexpr int kSmallThreads = 128;
constexpr int kSmallMaxD = 128;

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// the block's max (op 0) or sum (op 1) of x, returned to every thread
template <int OP>
__device__ __forceinline__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = OP == 0 ? fmaxf(x, y) : x + y;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // the previous reduction's reads are done
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kSmallThreads / 32; ++w)
    r = OP == 0 ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kSmallThreads)
paged_small_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                   const T* __restrict__ v_pages,
                   const int32_t* __restrict__ page_table,
                   const int32_t* __restrict__ seq_lens, T* __restrict__ out,
                   int Hkv, int D, int page, int max_pages, float scale) {
  __shared__ float q_s[kSmallMaxD];
  __shared__ float p_s[kSmallThreads];
  __shared__ size_t row_s[kSmallThreads];
  __shared__ float red[kSmallThreads / 32];
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const int hkv = h / (H / Hkv);
  const int tid = threadIdx.x;
  for (int d = tid; d < D; d += kSmallThreads)
    q_s[d] = to_float(q[((size_t)b * H + h) * D + d]) * scale;
  const int n_keys = min(seq_lens[b], max_pages * page);
  const int32_t* table = page_table + (size_t)b * max_pages;
  float m = -INFINITY, l = 0.f, acc = 0.f;  // acc: column tid
  __syncthreads();
  for (int j0 = 0; j0 < n_keys; j0 += kSmallThreads) {
    const int j = j0 + tid;
    float s = -INFINITY;
    if (j < n_keys) {
      const size_t row =
          (((size_t)table[j / page] * page + j % page) * Hkv + hkv) * D;
      row_s[tid] = row;
      const T* kr = k_pages + row;
      s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(q_s[d], to_float(kr[d]), s);
    }
    const float m_new = fmaxf(m, block_reduce<0>(s, red));
    const float alpha = expf(m - m_new);  // 0 when m = -inf
    const float p = j < n_keys ? expf(s - m_new) : 0.f;
    p_s[tid] = p;
    l = l * alpha + block_reduce<1>(p, red);  // its syncs publish p_s, row_s
    m = m_new;
    if (tid < D) {
      const int n = min(kSmallThreads, n_keys - j0);
      float a = acc * alpha;
      for (int c = 0; c < n; ++c)
        a = fmaf(p_s[c], to_float(v_pages[row_s[c] + tid]), a);
      acc = a;
    }
    __syncthreads();  // p_s and row_s are consumed
  }
  if (tid < D)
    out[((size_t)b * H + h) * D + tid] = from_float<T>(l > 0.f ? acc / l
                                                               : 0.f);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  part: fp32 scratch of B * H * n_split
// * (D + 2) floats, n_split = ceil(max_pages * page / part_keys) (D = 64 or
// 128; the small-width route, any other D up to 128, reads none).  *blocks
// gets the grid size of the partial (or small-width) kernel as launched.
// Returns cudaGetLastError() after the launches (0 on success); -1 for a D,
// dtype or partition this file does not take.
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* page_table,
                                      const void* seq_lens, void* part,
                                      void* out, int B, int H, int Hkv, int D,
                                      int page, int max_pages, int part_keys,
                                      float scale, int dtype, int* blocks,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (part_keys <= 0) return -1;
  const int n_split = (max_pages * page + part_keys - 1) / part_keys;
  if (n_split == 0) return -1;
  float* p = (float*)part;
#define PAGED_LAUNCH(T, DD)                                                 \
  return launch<T, DD>(q, k_pages, v_pages, page_table, seq_lens, p, out, B, \
                       H, Hkv, page, max_pages, part_keys, n_split, scale,   \
                       blocks, s)
  if (dtype == 0 && D == 64) PAGED_LAUNCH(float, 64);
  if (dtype == 0 && D == 128) PAGED_LAUNCH(float, 128);
  if (dtype == 1 && D == 64) PAGED_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) PAGED_LAUNCH(__nv_bfloat16, 128);
#undef PAGED_LAUNCH
  // the small-width route: any other D up to 128; part is not used
  if (D < 1 || D > kSmallMaxD || (dtype != 0 && dtype != 1)) return -1;
  const dim3 grid(H, B);
  *blocks = grid.x * grid.y;
  if (dtype == 0)
    paged_small_kernel<float><<<grid, kSmallThreads, 0, s>>>(
        (const float*)q, (const float*)k_pages, (const float*)v_pages,
        (const int32_t*)page_table, (const int32_t*)seq_lens, (float*)out,
        Hkv, D, page, max_pages, scale);
  else
    paged_small_kernel<__nv_bfloat16><<<grid, kSmallThreads, 0, s>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
        (const __nv_bfloat16*)v_pages, (const int32_t*)page_table,
        (const int32_t*)seq_lens, (__nv_bfloat16*)out, Hkv, D, page,
        max_pages, scale);
  return (int)cudaGetLastError();
}
