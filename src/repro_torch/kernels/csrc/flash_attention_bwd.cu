// Backward of blocked causal GQA attention (K2-bwd) for Hopper (sm_90a).
//
// Replaces: the gradient of src/repro/kernels/ref.py::mha_attention, which
// the JAX package's training step takes by autodiff of the jnp attention
// (src/repro/models/attention.py::attn_full; the Pallas kernel
// src/repro/kernels/flash_attention.py::flash_attention has no backward).
// It computes dq, dk, dv of the function K2's forward computes
// (csrc/flash_attention.cu), `compute_dtype` included, from the forward's
// output O and its per-row log-sum-exp LSE (natural log of the sum of
// exp(scaled logits); +inf for a row that sees no key).
//
// What bounds it: operations.  Five products of S x S x D per (b, head),
// halved under the causal mask, against ~(4*H + 4*Hkv) * S * D bytes, far
// above the card's ridge: the products belong on the bf16 tensor cores.
//
// Three kernels, launched back to back on the caller's stream, with no
// floating-point atomics, so a rerun is bitwise equal:
//   1. `attn_bwd_dot_kernel`: D_i = rowsum(dO * O) in fp32, one warp a row;
//   2. dK, dV: one block per (64-key tile, KV head, b).  K and V stay in the
//      block; it walks the GQA group's query heads and, for each, the query
//      tiles that can see the key tile (causal: from the diagonal down).  It
//      recomputes S = (q * scale) K^T and P = exp(S - LSE) from the saved
//      LSE, dP = dO V^T and dS = P * (dP - D_i), and accumulates dV += P^T
//      dO and dK += dS^T (q * scale) in registers: the group's sum happens
//      in-block;
//   3. dQ: one block per (64-query tile, head, b) walks the visible key
//      tiles and accumulates dQ = scale * dS K.
// Two routes, by input dtype and D:
//   * bf16, D = 64 (the main path: qwen2 training) takes
//     `attn_bwd_dkdv_mma_kernel` / `attn_bwd_dq_mma_kernel`, the forward's
//     tensor-core design (`mma.sync`, `ldmatrix`, a `cp.async` ring; see
//     the section below); P and dS enter their products rounded once to
//     bf16;
//   * fp32 inputs, and bf16 with D = 128, take `attn_bwd_dkdv_kernel` /
//     `attn_bwd_dq_kernel`: fp32 FMAs on the CUDA cores, 4x4 register tiles
//     over fp32 tiles in shared memory (the forward's fp32 kernel's layout),
//     exact fp32 products — the reduced fp32 models' path.
// Rounding points follow autograd through ref.mha_attention: under
// compute_dtype=bf16, q * scale, k and v are rounded to bf16 (as in the
// forward), the probabilities are rounded to bf16 in dV = P^T dO, dP is
// rounded to bf16 (the gradient of that rounding), and dq, dk, dv are
// rounded to bf16 before the scale (the gradients of the operand casts).
// Empty causal rows (Sq > Skv) have LSE = +inf, so P = 0 and they add
// nothing: their dq is 0, as the forward's output is.
//
// Layouts (all contiguous): q, out, dout, dq (B, H, Sq, D); k, v, dk, dv
// (B, Hkv, Skv, D); lse and the D_i scratch (B, H, Sq) fp32.  D is 64 or
// 128; the input dtype is fp32 or bf16 (dq, dk, dv in the same dtype).

#include <atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;       // query rows / keys a tile
constexpr int kThreads = 256;   // 16 row groups x 16 column lanes

cudaError_t allow_dynamic_smem(std::atomic<unsigned long long>& done,
                               const void* kernel, int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// D_i = sum_d dO[i, d] * O[i, d]; one warp a row, 8 rows a block
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dot_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                    float* __restrict__ di, long long rows, int D) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* o = out + row * D;
  const T* g = dout + row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s = fmaf(to_f(o[d]), to_f(g[d]), s);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) di[row] = s;
}

// Shared tile loads.  A row past `n` is zeros.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0,
                                          int n, float mul, bool rnd) {
  constexpr int LD = D + 1;
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (r0 + r < n) {
      x = to_f(src[(size_t)(r0 + r) * D + d]) * mul;
      if (rnd) x = round_bf16(x);
    }
    dst[r * LD + d] = x;
  }
}

// S = Qs K^T and dP = dO V^T for a 64 x 64 tile, then P and dS in place:
// s[i][j], dp[i][j] for query row q0 + ty + 16 i and key k0 + tx + 16 j
template <int D>
__device__ __forceinline__ void scores(const float* q_s, const float* do_s,
                                       const float* k_s, const float* v_s,
                                       const float* lse_s, const float* di_s,
                                       int q0, int k0, int Sq, int Skv,
                                       int offs, int causal, bool rnd,
                                       float (&p)[4][4], float (&ds)[4][4]) {
  constexpr int LD = D + 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = q_s[(ty + 16 * i) * LD + d];
      gv[i] = do_s[(ty + 16 * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = k_s[(tx + 16 * j) * LD + d];
      vv[j] = v_s[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qi = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      const bool ok = qi < Sq && key < Skv && (!causal || key <= qi + offs);
      // LSE = +inf (a row that sees no key) gives exp(-inf) = 0
      const float pij = ok ? expf(s[i][j] - lse_s[r]) : 0.f;
      const float g = rnd ? round_bf16(dp[i][j]) : dp[i][j];
      p[i][j] = pij;
      ds[i][j] = pij * (g - di_s[r]);
    }
  }
}

// dK, dV for one 64-key tile of one KV head, summed over the head's query
// group and every query tile that sees the keys
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Hkv, int Sq, int Skv,
                     int causal, float scale, int compute_bf16) {
  constexpr int LD = D + 1;
  constexpr int PS = kTile + 1;
  constexpr int NJ = D / 16;
  const int k0 = blockIdx.x * kTile;
  const int hkv = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / Hkv;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int offs = Skv - Sq;
  const bool rnd = compute_bf16 != 0;

  extern __shared__ float smem[];
  float* k_s = smem;                  // kTile x LD
  float* v_s = k_s + kTile * LD;      // kTile x LD
  float* q_s = v_s + kTile * LD;      // kTile x LD: q * scale
  float* do_s = q_s + kTile * LD;     // kTile x LD
  float* p_s = do_s + kTile * LD;     // kTile x PS (query row, key)
  float* ds_s = p_s + kTile * PS;     // kTile x PS
  float* lse_s = ds_s + kTile * PS;   // kTile
  float* di_s = lse_s + kTile;        // kTile

  const size_t kv_off = ((size_t)b * Hkv + hkv) * (size_t)Skv * D;
  load_rows<T, D>(k_s, k + kv_off, k0, Skv, 1.f, rnd);
  load_rows<T, D>(v_s, v + kv_off, k0, Skv, 1.f, rnd);

  float acc_k[4][NJ], acc_v[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc_k[i][jj] = acc_v[i][jj] = 0.f;

  const int n_qt = (Sq + kTile - 1) / kTile;
  // causal: query row i sees key k0 from i = k0 - offs on
  const int qt0 = causal ? max(0, k0 - offs) / kTile : 0;
  for (int gi = 0; gi < group; ++gi) {
    const int h = hkv * group + gi;
    const size_t q_off = ((size_t)b * H + h) * (size_t)Sq * D;
    const size_t r_off = ((size_t)b * H + h) * (size_t)Sq;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // the previous tile's q/dO/P/dS are consumed
      load_rows<T, D>(q_s, q + q_off, q0, Sq, scale, rnd);
      load_rows<T, D>(do_s, dout + q_off, q0, Sq, 1.f, false);
      for (int r = threadIdx.x; r < kTile; r += kThreads) {
        const bool ok = q0 + r < Sq;
        lse_s[r] = ok ? lse[r_off + q0 + r] : INFINITY;
        di_s[r] = ok ? di[r_off + q0 + r] : 0.f;
      }
      __syncthreads();
      float p[4][4], ds[4][4];
      scores<D>(q_s, do_s, k_s, v_s, lse_s, di_s, q0, k0, Sq, Skv, offs,
                causal, rnd, p, ds);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p_s[(ty + 16 * i) * PS + tx + 16 * j] =
              rnd ? round_bf16(p[i][j]) : p[i][j];
          ds_s[(ty + 16 * i) * PS + tx + 16 * j] = ds[i][j];
        }
      __syncthreads();
      // this thread: keys ty + 16 i, columns tx + 16 jj
#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        float pv[4], sv[4], gv[NJ], qv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = p_s[r * PS + ty + 16 * i];
          sv[i] = ds_s[r * PS + ty + 16 * i];
        }
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          gv[jj] = do_s[r * LD + tx + 16 * jj];
          qv[jj] = q_s[r * LD + tx + 16 * jj];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) {
            acc_v[i][jj] = fmaf(pv[i], gv[jj], acc_v[i][jj]);
            acc_k[i][jj] = fmaf(sv[i], qv[jj], acc_k[i][jj]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Skv) continue;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const size_t o = kv_off + (size_t)key * D + tx + 16 * jj;
      const float gk = acc_k[i][jj], gvv = acc_v[i][jj];
      dk[o] = from_f<T>(rnd ? round_bf16(gk) : gk);
      dv[o] = from_f<T>(rnd ? round_bf16(gvv) : gvv);
    }
  }
}

// dQ for one 64-query tile of one head
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ di, T* __restrict__ dq, int H,
                   int Hkv, int Sq, int Skv, int causal, float scale,
                   int compute_bf16) {
  constexpr int LD = D + 1;
  constexpr int PS = kTile + 1;
  constexpr int NJ = D / 16;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hkv = h / (H / Hkv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int offs = Skv - Sq;
  const bool rnd = compute_bf16 != 0;

  extern __shared__ float smem[];
  float* q_s = smem;                  // kTile x LD: q * scale
  float* do_s = q_s + kTile * LD;     // kTile x LD
  float* k_s = do_s + kTile * LD;     // kTile x LD
  float* v_s = k_s + kTile * LD;      // kTile x LD
  float* ds_s = v_s + kTile * LD;     // kTile x PS
  float* lse_s = ds_s + kTile * PS;   // kTile
  float* di_s = lse_s + kTile;        // kTile

  const size_t q_off = ((size_t)b * H + h) * (size_t)Sq * D;
  const size_t r_off = ((size_t)b * H + h) * (size_t)Sq;
  const size_t kv_off = ((size_t)b * Hkv + hkv) * (size_t)Skv * D;
  load_rows<T, D>(q_s, q + q_off, q0, Sq, scale, rnd);
  load_rows<T, D>(do_s, dout + q_off, q0, Sq, 1.f, false);
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const bool ok = q0 + r < Sq;
    lse_s[r] = ok ? lse[r_off + q0 + r] : INFINITY;
    di_s[r] = ok ? di[r_off + q0 + r] : 0.f;
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;

  const int nk = (Skv + kTile - 1) / kTile;
  int n_tiles = nk;
  if (causal) {
    const int last_key = min(q0 + kTile, Sq) - 1 + offs;
    n_tiles = last_key < 0 ? 0 : min(nk, last_key / kTile + 1);
  }
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // q/dO/LSE written; the previous K/V/dS consumed
    load_rows<T, D>(k_s, k + kv_off, k0, Skv, 1.f, rnd);
    load_rows<T, D>(v_s, v + kv_off, k0, Skv, 1.f, rnd);
    __syncthreads();
    float p[4][4], ds[4][4];
    scores<D>(q_s, do_s, k_s, v_s, lse_s, di_s, q0, k0, Sq, Skv, offs, causal,
              rnd, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ds_s[(ty + 16 * i) * PS + tx + 16 * j] = ds[i][j];
    __syncthreads();
    // this thread: query rows ty + 16 i, columns tx + 16 jj
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float sv[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = ds_s[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) kv[jj] = k_s[c * LD + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
          acc[i][jj] = fmaf(sv[i], kv[jj], acc[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const float g = rnd ? round_bf16(acc[i][jj]) : acc[i][jj];
      dq[q_off + (size_t)qi * D + tx + 16 * jj] = from_f<T>(g * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 inputs, D = 64 (qwen2's and zamba2's heads): tensor-core products
// ---------------------------------------------------------------------------
// The forward's building blocks (csrc/flash_attention.cu): `mma.sync.m16n8k16`
// bf16 -> fp32 with operands through `ldmatrix`, tiles by `cp.async`, and
// the accumulator fragments re-packed as A-fragments for the next product.
//   * dK/dV: a block is 4 warps and 64 keys, 16 a warp; the warp's K and V
//     rows stay in registers as A-fragments.  Query tiles (Q and dO, 64
//     rows) of the group's heads stream through a two-stage cp.async ring.
//     S^T = K Q^T and dP^T = V dO^T on the tensor cores; P^T and dS^T
//     elementwise in the accumulators' layout; dV += P^T dO and
//     dK += dS^T Q with P^T, dS^T re-packed as A and dO, Q as B through
//     `ldmatrix.trans`;
//   * dQ: a block is 4 warps and 64 query rows; Q and dO stay in registers,
//     K/V tiles stream through the ring; S = Q K^T, dP = dO V^T, then
//     dQ += dS K with K through `ldmatrix.trans`.
// P and dS enter their products rounded once to bf16: at most 2^-9 of
// each term, far inside the bf16 bar (6e-2 of the largest gradient).

constexpr int kMmaWarps = 4;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared; src_bytes = 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&x);
  return __bfloat1622float2(v);
}
// q * scale rounded to bf16, on a fragment (compute_dtype=bf16)
__device__ __forceinline__ void scale_frag(uint32_t (&r)[4], float s) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float2 f = unpack_bf16(r[c]);
    r[c] = pack_bf16(f.x * s, f.y * s);
  }
}
// A-fragment (16 rows x 16 cols kk*16 ..) from accumulator n-tiles 2kk and
// 2kk + 1 (Fragment layouts: see csrc/flash_attention.cu)
template <int NTILE>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4],
                                       const float (&x)[NTILE][4], int kk) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    a[r] = pack_bf16(x[2 * kk + (r >> 1)][2 * (r & 1)],
                     x[2 * kk + (r >> 1)][2 * (r & 1) + 1]);
}

template <int D>
__global__ void __launch_bounds__(kMmaWarps * 32)
attn_bwd_dkdv_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ di, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int H, int Hkv, int Sq,
                         int Skv, int causal, float scale, int compute_bf16) {
  constexpr int BK = 16 * kMmaWarps;  // keys a block
  constexpr int BQ = 64;              // query rows a tile
  constexpr int NT = 32 * kMmaWarps;
  constexpr int LD = D + 8;
  constexpr int CH = D / 8;
  constexpr int KSTEPS = D / 16;
  constexpr int NTILE = BQ / 8;       // 8-query column tiles of S^T
  constexpr int DTILE = D / 8;

  const int k0 = blockIdx.x * BK;
  const int hkv = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int offs = Skv - Sq;
  const bool rnd = compute_bf16 != 0;
  // compute fp32: logits = scale * (q . k); compute bf16: bf16(q*scale) . k
  const float sl2 = (rnd ? 1.f : scale) * kLog2e;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // BK x LD
  bf16* v_s = k_s + BK * LD;                       // BK x LD
  bf16* q_s = v_s + BK * LD;                       // 2 stages x BQ x LD
  bf16* g_s = q_s + 2 * BQ * LD;                   // 2 stages x BQ x LD: dO
  float* l_s = reinterpret_cast<float*>(g_s + 2 * BQ * LD);  // LSE log2(e)
  float* d_s = l_s + 2 * BQ;                                  // D_i

  const size_t kv_off = ((size_t)b * Hkv + hkv) * (size_t)Skv * D;
  for (int i = tid; i < BK * CH; i += NT) {  // rows past Skv zero-filled
    const int r = i / CH, c = i % CH;
    const bool ok = k0 + r < Skv;
    const size_t off = kv_off + (ok ? (size_t)(k0 + r) * D + c * 8 : 0);
    cp_async16(smem_addr(k_s + r * LD + c * 8), k + off, ok ? 16 : 0);
    cp_async16(smem_addr(v_s + r * LD + c * 8), v + off, ok ? 16 : 0);
  }
  cp_async_commit();

  // the (head, query tile) pairs that see the key tile, one after another
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int qt0 = causal ? min(n_qt, max(0, k0 - offs) / BQ) : 0;
  const int nq = n_qt - qt0;
  const int n_iter = group * nq;
  auto load_tile = [&](int it) {  // rows past Sq zero-filled, LSE = +inf
    const int h = hkv * group + it / nq;
    const int q0 = (qt0 + it % nq) * BQ;
    const int st = it & 1;
    const size_t q_off = ((size_t)b * H + h) * (size_t)Sq * D;
    for (int i = tid; i < BQ * CH; i += NT) {
      const int r = i / CH, c = i % CH;
      const bool ok = q0 + r < Sq;
      const size_t off = q_off + (ok ? (size_t)(q0 + r) * D + c * 8 : 0);
      cp_async16(smem_addr(q_s + (st * BQ + r) * LD + c * 8), q + off,
                 ok ? 16 : 0);
      cp_async16(smem_addr(g_s + (st * BQ + r) * LD + c * 8), dout + off,
                 ok ? 16 : 0);
    }
    const size_t r_off = ((size_t)b * H + h) * (size_t)Sq;
    for (int r = tid; r < BQ; r += NT) {
      const bool ok = q0 + r < Sq;
      l_s[st * BQ + r] = ok ? lse[r_off + q0 + r] * kLog2e : INFINITY;
      d_s[st * BQ + r] = ok ? di[r_off + q0 + r] : 0.f;
    }
  };
  if (n_iter > 0) load_tile(0);
  cp_async_commit();

  const int wk_first = k0 + warp * 16;
  const int key0 = wk_first + g;  // keys of c0/c1; c2/c3: key0 + 8
  uint32_t kf[KSTEPS][4], vf[KSTEPS][4];
  float acc_k[DTILE][4], acc_v[DTILE][4];
#pragma unroll
  for (int j = 0; j < DTILE; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[j][c] = acc_v[j][c] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    if (it + 1 < n_iter) load_tile(it + 1);
    cp_async_commit();   // (maybe empty) group: the count stays uniform
    cp_async_wait<1>();  // K, V and tile it have landed
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s) {
        const uint32_t off = (warp * 16 + (lane & 15)) * LD + s * 16 +
                             (lane >> 4) * 8;
        ldmatrix_x4(kf[s], smem_addr(k_s + off));
        ldmatrix_x4(vf[s], smem_addr(v_s + off));
      }
    }
    const int st = it & 1;
    const int q0 = (qt0 + it % nq) * BQ;
    const bf16* qs = q_s + st * BQ * LD;
    const bf16* gs = g_s + st * BQ * LD;
    const float* ls = l_s + st * BQ;
    const float* dd = d_s + st * BQ;
    // a warp none of whose keys any row of this tile sees skips it
    const bool visible = wk_first < Skv &&
                         (!causal || wk_first <= min(q0 + BQ, Sq) - 1 + offs);
    if (visible) {
      float s[NTILE][4], dp[NTILE][4];
#pragma unroll
      for (int j = 0; j < NTILE; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
        for (int np = 0; np < NTILE / 2; ++np) {
          uint32_t bq[4], bg[4];  // query n-tiles 2np, 2np+1 at k-step kk
          const uint32_t off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                   LD + kk * 16 + ((lane >> 3) & 1) * 8;
          ldmatrix_x4(bq, smem_addr(qs + off));
          ldmatrix_x4(bg, smem_addr(gs + off));
          if (rnd) scale_frag(bq, scale);
          mma_bf16(s[2 * np], kf[kk], bq[0], bq[1]);
          mma_bf16(s[2 * np + 1], kf[kk], bq[2], bq[3]);
          mma_bf16(dp[2 * np], vf[kk], bg[0], bg[1]);
          mma_bf16(dp[2 * np + 1], vf[kk], bg[2], bg[3]);
        }
      }
      // P^T and dS^T in place; mask only tiles at the diagonal or a tail
      const bool straddles = k0 + BK > Skv || q0 + BQ > Sq ||
                             (causal && wk_first + 15 > q0 + offs);
#pragma unroll
      for (int j = 0; j < NTILE; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qc = j * 8 + 2 * t4 + (c & 1);
          const int key = key0 + 8 * (c >> 1);
          const bool ok = !straddles ||
                          (key < Skv && q0 + qc < Sq &&
                           (!causal || key <= q0 + qc + offs));
          const float p = ok ? exp2f(fmaf(s[j][c], sl2, -ls[qc])) : 0.f;
          const float gp = rnd ? __bfloat162float(__float2bfloat16(dp[j][c]))
                               : dp[j][c];
          s[j][c] = p;
          dp[j][c] = p * (gp - dd[qc]);
        }
      // dV += P^T dO, dK += dS^T Q: queries kk*16 .. +15 are the k-step
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t pa[4], sa[4];
        pack_a<NTILE>(pa, s, kk);
        pack_a<NTILE>(sa, dp, kk);
#pragma unroll
        for (int dq = 0; dq < DTILE / 2; ++dq) {
          uint32_t bg[4], bq[4];  // d-tiles 2dq, 2dq+1 at queries kk*16 ..
          const uint32_t off = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   LD + dq * 16 + (lane >> 4) * 8;
          ldmatrix_x4_trans(bg, smem_addr(gs + off));
          ldmatrix_x4_trans(bq, smem_addr(qs + off));
          if (rnd) scale_frag(bq, scale);
          mma_bf16(acc_v[2 * dq], pa, bg[0], bg[1]);
          mma_bf16(acc_v[2 * dq + 1], pa, bg[2], bg[3]);
          mma_bf16(acc_k[2 * dq], sa, bq[0], bq[1]);
          mma_bf16(acc_k[2 * dq + 1], sa, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // stage it & 1 is free for tile it + 2
  }

  // dK = scale * dS^T q (compute fp32) or dS^T bf16(q * scale)
  const float ks = rnd ? 1.f : scale;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= Skv) continue;
#pragma unroll
    for (int j = 0; j < DTILE; ++j) {
      const size_t o = kv_off + (size_t)key * D + j * 8 + 2 * t4;
      *reinterpret_cast<__nv_bfloat162*>(dk + o) = __floats2bfloat162_rn(
          acc_k[j][2 * i] * ks, acc_k[j][2 * i + 1] * ks);
      *reinterpret_cast<__nv_bfloat162*>(dv + o) =
          __floats2bfloat162_rn(acc_v[j][2 * i], acc_v[j][2 * i + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaWarps * 32)
attn_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ di, bf16* __restrict__ dq,
                       int H, int Hkv, int Sq, int Skv, int causal,
                       float scale, int compute_bf16) {
  constexpr int BQ = 16 * kMmaWarps;  // query rows a block
  constexpr int BK = 64;              // keys a tile
  constexpr int NT = 32 * kMmaWarps;
  constexpr int LD = D + 8;
  constexpr int CH = D / 8;
  constexpr int KSTEPS = D / 16;
  constexpr int NTILE = BK / 8;
  constexpr int DTILE = D / 8;

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.z) * BQ;  // heaviest tiles first
  const int h = blockIdx.x, b = blockIdx.y;
  const int hkv = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int offs = Skv - Sq;
  const bool rnd = compute_bf16 != 0;
  const float sl2 = (rnd ? 1.f : scale) * kLog2e;

  const size_t q_off = ((size_t)b * H + h) * (size_t)Sq * D;
  const size_t kv_off = ((size_t)b * Hkv + hkv) * (size_t)Skv * D;
  const size_t r_off = ((size_t)b * H + h) * (size_t)Sq;
  bf16* dqb = dq + q_off;

  const int nk = (Skv + BK - 1) / BK;
  int n_tiles = nk;
  if (causal) {
    const int last_key = min(q0 + BQ, Sq) - 1 + offs;
    n_tiles = last_key < 0 ? 0 : min(nk, last_key / BK + 1);
  }
  if (n_tiles == 0) {  // no row of the block sees a key: zero gradient
    for (int i = tid; i < BQ * D; i += NT) {
      const int r = q0 + i / D;
      if (r < Sq) dqb[(size_t)r * D + i % D] = __float2bfloat16(0.f);
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // BQ x LD
  bf16* g_s = q_s + BQ * LD;                       // BQ x LD: dO
  bf16* k_s = g_s + BQ * LD;                       // 2 stages x BK x LD
  bf16* v_s = k_s + 2 * BK * LD;                   // 2 stages x BK x LD

  for (int i = tid; i < BQ * CH; i += NT) {  // rows past Sq zero-filled
    const int r = i / CH, c = i % CH;
    const bool ok = q0 + r < Sq;
    const size_t off = q_off + (ok ? (size_t)(q0 + r) * D + c * 8 : 0);
    cp_async16(smem_addr(q_s + r * LD + c * 8), q + off, ok ? 16 : 0);
    cp_async16(smem_addr(g_s + r * LD + c * 8), dout + off, ok ? 16 : 0);
  }
  cp_async_commit();
  auto load_tile = [&](int kt) {  // K/V rows past Skv zero-filled
    const int k0 = kt * BK;
    bf16* ks = k_s + (kt & 1) * BK * LD;
    bf16* vs = v_s + (kt & 1) * BK * LD;
    for (int i = tid; i < BK * CH; i += NT) {
      const int r = i / CH, c = i % CH;
      const bool ok = k0 + r < Skv;
      const size_t off = kv_off + (ok ? (size_t)(k0 + r) * D + c * 8 : 0);
      cp_async16(smem_addr(ks + r * LD + c * 8), k + off, ok ? 16 : 0);
      cp_async16(smem_addr(vs + r * LD + c * 8), v + off, ok ? 16 : 0);
    }
  };
  load_tile(0);
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g;  // rows of c0/c1; c2/c3: row0 + 8
  const int warp_first = q0 + warp * 16, warp_last = warp_first + 15;
  float l2[2], dd[2];  // LSE * log2(e) and D_i of this thread's two rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    l2[i] = row < Sq ? lse[r_off + row] * kLog2e : INFINITY;
    dd[i] = row < Sq ? di[r_off + row] : 0.f;
  }
  uint32_t qf[KSTEPS][4], gf[KSTEPS][4];
  float acc[DTILE][4];
#pragma unroll
  for (int j = 0; j < DTILE; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) load_tile(kt + 1);
    cp_async_commit();
    cp_async_wait<1>();  // Q, dO and tile kt have landed
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s) {
        const uint32_t off = (warp * 16 + (lane & 15)) * LD + s * 16 +
                             (lane >> 4) * 8;
        ldmatrix_x4(qf[s], smem_addr(q_s + off));
        ldmatrix_x4(gf[s], smem_addr(g_s + off));
        if (rnd) scale_frag(qf[s], scale);
      }
    }
    const int k0 = kt * BK;
    const bf16* ks = k_s + (kt & 1) * BK * LD;
    const bf16* vs = v_s + (kt & 1) * BK * LD;
    const bool visible = warp_first < Sq &&
                         (!causal || k0 <= min(warp_last, Sq - 1) + offs);
    if (visible) {
      float s[NTILE][4], dp[NTILE][4];
#pragma unroll
      for (int j = 0; j < NTILE; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
        for (int np = 0; np < NTILE / 2; ++np) {
          uint32_t bk[4], bv[4];  // key n-tiles 2np, 2np+1 at k-step kk
          const uint32_t off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                   LD + kk * 16 + ((lane >> 3) & 1) * 8;
          ldmatrix_x4(bk, smem_addr(ks + off));
          ldmatrix_x4(bv, smem_addr(vs + off));
          mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
          mma_bf16(dp[2 * np], gf[kk], bv[0], bv[1]);
          mma_bf16(dp[2 * np + 1], gf[kk], bv[2], bv[3]);
        }
      }
      const bool straddles =
          k0 + BK > Skv || (causal && k0 + BK - 1 > warp_first + offs);
#pragma unroll
      for (int j = 0; j < NTILE; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = k0 + j * 8 + 2 * t4 + (c & 1);
          const int row = row0 + (c >> 1) * 8;
          const bool ok = !straddles ||
                          (key < Skv && (!causal || key <= row + offs));
          const float p = ok ? exp2f(fmaf(s[j][c], sl2, -l2[c >> 1])) : 0.f;
          const float gp = rnd ? __bfloat162float(__float2bfloat16(dp[j][c]))
                               : dp[j][c];
          dp[j][c] = p * (gp - dd[c >> 1]);
        }
      // dQ += dS K: keys kk*16 .. +15 are the k-step
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t sa[4];
        pack_a<NTILE>(sa, dp, kk);
#pragma unroll
        for (int dn = 0; dn < DTILE / 2; ++dn) {
          uint32_t bk[4];  // d-tiles 2dn, 2dn+1 at keys kk*16 ..
          const uint32_t off = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   LD + dn * 16 + (lane >> 4) * 8;
          ldmatrix_x4_trans(bk, smem_addr(ks + off));
          mma_bf16(acc[2 * dn], sa, bk[0], bk[1]);
          mma_bf16(acc[2 * dn + 1], sa, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // stage kt & 1 is free for tile kt + 2
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < DTILE; ++j) {
      float x = acc[j][2 * i], y = acc[j][2 * i + 1];
      if (rnd) {  // the gradient of q*scale's bf16 rounding, then the scale
        x = __bfloat162float(__float2bfloat16(x));
        y = __bfloat162float(__float2bfloat16(y));
      }
      *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)row * D + j * 8 +
                                         2 * t4) =
          __floats2bfloat162_rn(x * scale, y * scale);
    }
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const void* lse, void* dq, void* dk,
               void* dv, void* di, int B, int H, int Hkv, int Sq, int Skv,
               int causal, float scale, int compute_bf16,
               cudaStream_t stream) {
  constexpr int LD = D + 8;
  constexpr int smem_dkdv =
      (2 * 16 * kMmaWarps + 4 * 64) * LD * 2 + 4 * 64 * (int)sizeof(float);
  constexpr int smem_dq = (2 * 16 * kMmaWarps + 4 * 64) * LD * 2;
  static std::atomic<unsigned long long> set_dkdv{0}, set_dq{0};
  auto k_dkdv = attn_bwd_dkdv_mma_kernel<D>;
  auto k_dq = attn_bwd_dq_mma_kernel<D>;
  cudaError_t err = allow_dynamic_smem(set_dkdv, (const void*)k_dkdv,
                                       smem_dkdv);
  if (err != cudaSuccess) return (int)err;
  err = allow_dynamic_smem(set_dq, (const void*)k_dq, smem_dq);
  if (err != cudaSuccess) return (int)err;

  const long long rows = (long long)B * H * Sq;
  const int per_block = kThreads / 32;
  attn_bwd_dot_kernel<bf16><<<(unsigned)((rows + per_block - 1) / per_block),
                              kThreads, 0, stream>>>(
      (const bf16*)out, (const bf16*)dout, (float*)di, rows, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 g_kv((Skv + 16 * kMmaWarps - 1) / (16 * kMmaWarps), Hkv, B);
  k_dkdv<<<g_kv, kMmaWarps * 32, smem_dkdv, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)di, (bf16*)dk, (bf16*)dv, H, Hkv, Sq,
      Skv, causal, scale, compute_bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 g_q(H, B, (Sq + 16 * kMmaWarps - 1) / (16 * kMmaWarps));
  k_dq<<<g_q, kMmaWarps * 32, smem_dq, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)di, (bf16*)dq, H, Hkv, Sq, Skv, causal,
      scale, compute_bf16);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const void* lse, void* dq, void* dk, void* dv,
           void* di, int B, int H, int Hkv, int Sq, int Skv, int causal,
           float scale, int compute_bf16, cudaStream_t stream) {
  constexpr int LD = D + 1, PS = kTile + 1;
  constexpr int smem_dkdv =
      sizeof(float) * (4 * kTile * LD + 2 * kTile * PS + 2 * kTile);
  constexpr int smem_dq =
      sizeof(float) * (4 * kTile * LD + kTile * PS + 2 * kTile);
  static std::atomic<unsigned long long> set_dkdv{0}, set_dq{0};
  auto k_dkdv = attn_bwd_dkdv_kernel<T, D>;
  auto k_dq = attn_bwd_dq_kernel<T, D>;
  cudaError_t err = allow_dynamic_smem(set_dkdv, (const void*)k_dkdv,
                                       smem_dkdv);
  if (err != cudaSuccess) return (int)err;
  err = allow_dynamic_smem(set_dq, (const void*)k_dq, smem_dq);
  if (err != cudaSuccess) return (int)err;

  const long long rows = (long long)B * H * Sq;
  const int per_block = kThreads / 32;
  attn_bwd_dot_kernel<T><<<(unsigned)((rows + per_block - 1) / per_block),
                           kThreads, 0, stream>>>(
      (const T*)out, (const T*)dout, (float*)di, rows, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 g_kv((Skv + kTile - 1) / kTile, Hkv, B);
  k_dkdv<<<g_kv, kThreads, smem_dkdv, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)di, (T*)dk, (T*)dv, H, Hkv, Sq, Skv,
      causal, scale, compute_bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 g_q((Sq + kTile - 1) / kTile, H, B);
  k_dq<<<g_q, kThreads, smem_dq, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)di, (T*)dq, H, Hkv, Sq, Skv, causal,
      scale, compute_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `di` is fp32 scratch of B * H * Sq.
// Returns cudaGetLastError() after the launches (0 on success); -1 for a D
// or dtype this file does not build.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dq, void* dk, void* dv, void* di,
    int B, int H, int Hkv, int Sq, int Skv, int D, int causal, float scale,
    int compute_bf16, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, out, dout, lse, dq, dk, dv, di, B, H,
                             Hkv, Sq, Skv, causal, scale, compute_bf16, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, out, dout, lse, dq, dk, dv, di, B, H,
                              Hkv, Sq, Skv, causal, scale, compute_bf16, s);
  if (dtype == 1 && D == 64)
    return launch_mma<64>(q, k, v, out, dout, lse, dq, dk, dv, di, B, H, Hkv,
                          Sq, Skv, causal, scale, compute_bf16, s);
  if (dtype == 1 && D == 128)
    return launch<bf16, 128>(q, k, v, out, dout, lse, dq, dk, dv, di, B, H,
                             Hkv, Sq, Skv, causal, scale, compute_bf16, s);
  return -1;
}
