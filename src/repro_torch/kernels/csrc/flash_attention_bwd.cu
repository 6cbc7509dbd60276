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
//   1. a pre-pass: D_i = rowsum(dO * O) in fp32, one warp a row;
//   2. dK, dV: a block owns one 64-key tile of one KV head.  K and V stay in
//      the block; it walks the GQA group's query heads and, for each, the
//      query tiles that can see the key tile (causal: from the diagonal
//      down).  It recomputes S = (q * scale) K^T and P = exp(S - LSE) from
//      the saved LSE, dP = dO V^T and dS = P * (dP - D_i), and accumulates
//      dV += P^T dO and dK += dS^T (q * scale): the group's sum happens
//      in-block;
//   3. dQ: a block owns query rows of one head, walks the visible key tiles
//      and accumulates dQ = scale * dS K.
// Three routes, by input dtype and D; the C entry point reports the one it
// launched (`flash_attention_bwd.last_kernel`); the third, the small-width
// route, is the FMA pair below laid out 64 or 128 wide for any other D up
// to 128 (the columns past D zero):
//   * bf16, D = 64 or 128 (the main paths: qwen2, zamba2 and whisper
//     training at 64; olmoe, deepseek, starcoder2, moonshot and internvl2
//     at 128) takes `attn_bwd_dkdv_wgmma_kernel<D>` /
//     `attn_bwd_dq_wgmma_kernel<D>`: `wgmma` fed by TMA, warp-specialised
//     (see the section below); P and dS enter their products rounded once
//     to bf16;
//   * fp32 inputs take `attn_bwd_dkdv_kernel` / `attn_bwd_dq_kernel`: fp32
//     FMAs on the CUDA cores, 4x4 register tiles over fp32 tiles in shared
//     memory (the forward's fp32 kernel's layout), exact fp32 products —
//     the reduced fp32 models' path.
// Rounding points follow autograd through ref.mha_attention: under
// compute_dtype=bf16, q * scale, k and v are rounded to bf16 (as in the
// forward), the probabilities are rounded to bf16 in dV = P^T dO, dP is
// rounded to bf16 (the gradient of that rounding), and dq, dk, dv are
// rounded to bf16 before the scale (the gradients of the operand casts).
// Empty causal rows (Sq > Skv) have LSE = +inf, so P = 0 and they add
// nothing: their dq is 0, as the forward's output is.
//
// Layouts (all contiguous): q, out, dout, dq (B, H, Sq, D); k, v, dk, dv
// (B, Hkv, Skv, D); lse (B, H, Sq) fp32.  D is 1 to 128; the input dtype is
// fp32 or bf16 (dq, dk, dv in the same dtype).  `scratch` is fp32 workspace
// from the caller: D_i (B, H, Sq) on the FMA route; on the wgmma route (D
// = 64 or 128) LSE * log2(e) and D_i, each (B, H, Sq rounded up to 64), and
// under compute_dtype=bf16 then bf16(q * scale) in q's layout.

#include <atomic>
#include <climits>
#include <cuda.h>  // CUtensorMap and its enums; no libcuda symbol is linked
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

// Shared tile loads of rows of width D <= DP, laid out DP wide.  A row
// past `n` is zeros, and so are its columns D..DP-1: they add nothing to a
// product, which lets one instance serve every width up to DP.
template <typename T, int DP>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0,
                                          int n, int D, float mul, bool rnd) {
  constexpr int LD = DP + 1;
  for (int i = threadIdx.x; i < kTile * DP; i += kThreads) {
    const int r = i / DP, d = i % DP;
    float x = 0.f;
    if (r0 + r < n && d < D) {
      x = to_f(src[(size_t)(r0 + r) * D + d]) * mul;
      if (rnd) x = round_bf16(x);
    }
    dst[r * LD + d] = x;
  }
}

// S = Qs K^T and dP = dO V^T for a 64 x 64 tile, then P and dS in place:
// s[i][j], dp[i][j] for query row q0 + ty + 16 i and key k0 + tx + 16 j
template <int DP>
__device__ __forceinline__ void scores(const float* q_s, const float* do_s,
                                       const float* k_s, const float* v_s,
                                       const float* lse_s, const float* di_s,
                                       int q0, int k0, int Sq, int Skv,
                                       int offs, int causal, bool rnd,
                                       float (&p)[4][4], float (&ds)[4][4]) {
  constexpr int LD = DP + 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; ++d) {
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
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Hkv, int Sq, int Skv,
                     int D, int causal, float scale, int compute_bf16) {
  constexpr int LD = DP + 1;
  constexpr int PS = kTile + 1;
  constexpr int NJ = DP / 16;
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
  load_rows<T, DP>(k_s, k + kv_off, k0, Skv, D, 1.f, rnd);
  load_rows<T, DP>(v_s, v + kv_off, k0, Skv, D, 1.f, rnd);

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
      load_rows<T, DP>(q_s, q + q_off, q0, Sq, D, scale, rnd);
      load_rows<T, DP>(do_s, dout + q_off, q0, Sq, D, 1.f, false);
      for (int r = threadIdx.x; r < kTile; r += kThreads) {
        const bool ok = q0 + r < Sq;
        lse_s[r] = ok ? lse[r_off + q0 + r] : INFINITY;
        di_s[r] = ok ? di[r_off + q0 + r] : 0.f;
      }
      __syncthreads();
      float p[4][4], ds[4][4];
      scores<DP>(q_s, do_s, k_s, v_s, lse_s, di_s, q0, k0, Sq, Skv, offs,
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
      if (tx + 16 * jj >= D) continue;
      const size_t o = kv_off + (size_t)key * D + tx + 16 * jj;
      const float gk = acc_k[i][jj], gvv = acc_v[i][jj];
      dk[o] = from_f<T>(rnd ? round_bf16(gk) : gk);
      dv[o] = from_f<T>(rnd ? round_bf16(gvv) : gvv);
    }
  }
}

// dQ for one 64-query tile of one head
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ di, T* __restrict__ dq, int H,
                   int Hkv, int Sq, int Skv, int D, int causal, float scale,
                   int compute_bf16) {
  constexpr int LD = DP + 1;
  constexpr int PS = kTile + 1;
  constexpr int NJ = DP / 16;
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
  load_rows<T, DP>(q_s, q + q_off, q0, Sq, D, scale, rnd);
  load_rows<T, DP>(do_s, dout + q_off, q0, Sq, D, 1.f, false);
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
    load_rows<T, DP>(k_s, k + kv_off, k0, Skv, D, 1.f, rnd);
    load_rows<T, DP>(v_s, v + kv_off, k0, Skv, D, 1.f, rnd);
    __syncthreads();
    float p[4][4], ds[4][4];
    scores<DP>(q_s, do_s, k_s, v_s, lse_s, di_s, q0, k0, Sq, Skv, offs,
               causal, rnd, p, ds);
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
      if (tx + 16 * jj >= D) continue;
      const float g = rnd ? round_bf16(acc[i][jj]) : acc[i][jj];
      dq[q_off + (size_t)qi * D + tx + 16 * jj] = from_f<T>(g * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 inputs, D = 64 or 128 (the main paths' heads): wgmma, TMA, warp roles
// ---------------------------------------------------------------------------
// A block is two consumer warpgroups and one producer warpgroup.  One thread
// of the producer issues TMA copies of whole 64-row bf16 tiles into a ring
// of shared memory and their byte counts to `mbarrier`s; `setmaxnreg` moves
// registers from it to the consumers.  TMA's 128-byte swizzle caps a box
// at 128-byte rows, 64 bf16 columns, so a 64 x D tile is D / 64 swizzled
// halves of 64 x 64 (8 KB each, 1024-aligned, one box copy each against
// the tile's one barrier); the wgmma descriptors name the same swizzle.
// The consumers run every product as `wgmma` m64n64k16 (bf16 in, fp32
// accumulators):
//   * dK/dV (`attn_bwd_dkdv_wgmma_kernel<D>`): one block per (64-key tile,
//     KV head, b), K and V resident.  The (query head, query tile) pairs
//     that see the key tile are dealt to the two consumer warpgroups in turn
//     (pair i to warpgroup i % 2), each with its own Q/dO ring and its own
//     whole-width dK/dV accumulators.  Per pair: S^T = K Q^T and dP^T = V
//     dO^T (keys are wgmma's 64 rows, queries its N, D / 16 k-slices, slice
//     kk in half kk / 4 at byte 32 (kk % 4); both operands from shared
//     memory, K-major); P^T and dS^T elementwise in the accumulators; then
//     dV += P^T dO and dK += dS^T Q with P^T, dS^T packed to bf16 as the
//     register A operand and dO, Q as the shared-memory B operand, MN-major
//     (the transpose bit), one m64n64k16 per half and k-slice into that
//     half's own 32 accumulators.  At the end each warpgroup leaves one of
//     its sums in its own ring and adds the other's: dK = dK_0 + dK_1 and
//     dV = dV_1 + dV_0, one addition each, the same bits every run.  Key
//     tiles are issued heaviest first (blockIdx.z = key tile: under the
//     causal mask tile 0 sees every query tile).
//   * dQ (`attn_bwd_dq_wgmma_kernel<D>`): one block per (128 query rows,
//     head, b), 64 rows a consumer warpgroup; Q and dO resident, K/V tiles
//     stream through a two-stage ring.  S = Q K^T and dP = dO V^T from
//     shared memory, P and dS in the accumulators, dQ += dS K with dS as
//     the register A operand and K MN-major, a product per half.  Heaviest
//     row blocks first.
// At D = 128 the products whose N is D run as two m64n64k16 (one a half)
// rather than one m64n128k16: the halves' descriptors are the D = 64
// route's, and at N = 64 the register-A form reads 64 bytes of shared
// memory a clock, within its rate, so the split costs no bandwidth.  Each
// warpgroup keeps whole-width dK and dV (128 fp32 registers at D = 128),
// S^T and dP^T (64) and the packed P^T (16): the consumers take 240
// registers and the producer 24 (2 x 128 x 240 + 128 x 24 = the 64 512
// the block holds at launch); splitting dK/dV's columns between the
// warpgroups instead would make each compute every pair's S^T and dP^T,
// 7/5 of the tensor work.
// Q and dO (and K, V) are mapped as 3-D tensors (D, S, B * heads), so a
// tile's rows past a head's S are zero-filled by TMA instead of read from
// the next head.  The pre-pass `attn_bwd_prep_kernel<D>` writes LSE *
// log2(e) (+inf past Sq) and D_i (0 past Sq) padded to whole tiles, which
// the producer copies with plain bulk copies, and under compute_dtype=bf16
// the operand bf16(q * scale) that both kernels then read in place of q.
// The elementwise work stays branch-free: P = ex2.approx(.) and the mask
// is a select (a masked `exp2f` compiled into a branch region per element,
// which about doubled the kernels' time on the H100); in dK/dV a
// straddling tile's mask is two comparisons an element against per-pair
// bounds, and LSE and D_i are read from shared memory where they are used.
// Each warpgroup waits for a pair's dV/dK products before it issues the
// next pair's S^T/dP^T: issuing those first measured slower on the H100.
// At D = 128 the dK/dV consumers hold 208 live accumulator and fragment
// registers at the peak (dS^T being formed), so everything else is kept
// small: the mask bounds above, K's and V's slice descriptors formed anew
// each pair, the producer stepping its pairs without a division (with
// LSE / D_i held in registers and the masks' full bounds per element,
// ptxas spilled 28-40 bytes there).
// ptxas (-Xptxas -v, sm_90a), D = 64: dK/dV 168 registers at launch
// (setmaxnreg: 232 for the consumers, 40 for the producer), no spills,
// 85 064 bytes of dynamic shared memory; dQ 168 registers, no spills,
// 66 600 bytes.  D = 128: dK/dV 168 at launch (setmaxnreg 240 / 24), no
// spills, 166 984 bytes; dQ 168 (232 / 40), no spills, 132 136 bytes.

constexpr int kHalf = 64;                     // columns of a swizzled half
constexpr int kHalfBytes = kTile * kHalf * 2;  // one 64 x 64 bf16 half: 8 KB
constexpr int kWG = 2;                        // consumer warpgroups a block
constexpr int kStages = 2;  // ring depth (a warpgroup's, in dK/dV)
constexpr int kWsThreads = (kWG + 1) * 128;
constexpr float kLog2e = 1.4426950408889634f;

// shared memory of the two kernels, from a 1024-aligned base, and the
// registers setmaxnreg gives each role
template <int D>
struct Wg {
  static constexpr int NH = D / kHalf;              // swizzled halves a tile
  static constexpr int kTileBytes = NH * kHalfBytes;  // one 64 x D tile
  // dK/dV: K, V; then per warpgroup w and stage s a Q and a dO tile; then
  // LSE/D_i rows; then the barriers
  static constexpr int kRingBytes = kStages * 2 * kTileBytes;  // a ring
  static constexpr int kDkdvRows = 2 * kTileBytes + kWG * kRingBytes;
  static constexpr int kDkdvBars = kDkdvRows + kWG * kStages * 2 * kTile * 4;
  static constexpr int kDkdvSmem =
      1024 + kDkdvBars + (1 + 2 * kWG * kStages) * 8;
  // dQ: Q and dO of each consumer warpgroup; then per stage a K and a V
  // tile; then the barriers
  static constexpr int kDqKv = kWG * 2 * kTileBytes;
  static constexpr int kDqBars = kDqKv + kStages * 2 * kTileBytes;
  static constexpr int kDqSmem = 1024 + kDqBars + (1 + 2 * kStages) * 8;
  // dK/dV's consumers and producer (each pair uses the 64 512 registers
  // the block holds at launch); dQ keeps 232 / 40 at both widths
  static constexpr int kRegC = D == 64 ? 232 : 240;
  static constexpr int kRegP = D == 64 ? 40 : 24;
  static_assert(D == 64 || D == 128, "the wgmma route takes D = 64 or 128");
  static_assert(kRingBytes >= kTile * D * 4,
                "a ring holds one 64 x D fp32 sum");
  static_assert(kDkdvSmem <= 232448 && kDqSmem <= 232448,
                "a block's shared memory");
  static_assert(2 * 128 * kRegC + 128 * kRegP <= 65536, "the SM's registers");
};
static_assert(kWG == 2, "the dK/dV sum below pairs two warpgroups");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&x);
  return __bfloat1622float2(v);
}

// mbarriers: parity waits (a wait on parity p returns once the phase of
// parity p has completed)
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// one 64 x 64 box (columns col.., row.., head) of a 3-D tensor map into
// shared memory
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int col, int row,
                                        int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head)
      : "memory");
}
// one 64 x D tile: its D / 64 halves, 8 KB apart, against one barrier
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row, int head) {
#pragma unroll
  for (int h = 0; h < D / kHalf; ++h)
    tma_box(dst + h * kHalfBytes, map, bar, h * kHalf, row, head);
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) in one copy
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled bf16 half of 128-byte rows (as
// TMA writes it): rows 128 bytes apart, 8-row groups 1024 bytes apart (the
// stride byte offset, for the K-major A/B here and for the MN-major B,
// whose K runs down the rows), leading byte offset unused (one swizzle atom
// spans the 64 columns), 1024-byte-aligned halves (base offset 0)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
// k-slice kk (columns 16 kk .. + 15) of a K-major 64 x D tile: half kk / 4,
// 32 bytes a slice within it
__device__ __forceinline__ uint64_t kslice_desc(uint32_t tile, int kk) {
  return sw128_desc(tile + kHalfBytes * (kk >> 2) + 32 * (kk & 3));
}
// rows 16 kk .. + 15 of half nh of an MN-major 64 x D tile
__device__ __forceinline__ uint64_t rows_desc(uint32_t tile, int nh, int kk) {
  return sw128_desc(tile + kHalfBytes * nh + 2048 * kk);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of d across the asynchronous
// products that write it
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int NH>
__device__ __forceinline__ void fence_acc(float (&d)[NH][32]) {
#pragma unroll
  for (int h = 0; h < NH; ++h) fence_acc(d[h]);
}

// 2^x, flushing results below 2^-126 to 0 (no P that small moves a bf16
// gradient); without exp2f's slow path the probabilities stay branch-free
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// keeps A fragments in their registers until the products reading them
// have completed (a wait_group before this)
__device__ __forceinline__ void keep_frags(const uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" ::"r"(a[i][r]) : "memory");
}

// d (64 x 64 fp32) (+)= A (64 x 16, shared, K-major) * B (16 x 64, shared,
// K-major); accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}
// d (64 x 64 fp32) += A (64 x 16 bf16, registers) * B (16 x 64, shared,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
// Fragment layouts (PTX ISA, wgmma .m64nNk16): accumulator element d[4j + c]
// of thread t (warp w = t / 32 of the warpgroup, g = lane / 4, t4 = lane % 4)
// sits at row 16 w + g + 8 (c / 2), column 8 j + 2 t4 + c % 2; the register
// A fragment of k-slice kk (columns 16 kk ..) is the accumulator's columns
// 16 kk .. + 15 packed pairwise: a[r] = (d[4 (2 kk + r / 2) + 2 (r % 2)],
// the next), as for mma.sync.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&x)[32],
                                       int kk) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    a[r] = pack_bf16(x[4 * (2 * kk + (r >> 1)) + 2 * (r & 1)],
                     x[4 * (2 * kk + (r >> 1)) + 2 * (r & 1) + 1]);
}

// LSE * log2(e) and D_i per row, padded to whole 64-row tiles (+inf and 0
// past Sq), and under compute_dtype=bf16 qs = bf16(q * scale); D / 8
// threads a row, 16 bytes each
template <int D>
__global__ void __launch_bounds__(256)
attn_bwd_prep_kernel(const bf16* __restrict__ q, const bf16* __restrict__ out,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse, float* __restrict__ lse2,
                     float* __restrict__ di, bf16* __restrict__ qs, int Sq,
                     int sq_pad, float scale) {
  constexpr int TPR = D / 8;  // threads a row: 8 or 16
  const long long row = (long long)blockIdx.x * (256 / TPR) +
                        threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  const unsigned group =  // the row's lanes
      ((1u << TPR) - 1) << (threadIdx.x % 32 & (32 - TPR));
  const long long bh = row / sq_pad;
  const int i = (int)(row % sq_pad);
  if (i >= Sq) {
    if (part == 0) {
      lse2[row] = INFINITY;
      di[row] = 0.f;
    }
    return;
  }
  const long long src = bh * Sq + i;
  const uint4 o = reinterpret_cast<const uint4*>(out + src * D)[part];
  const uint4 g = reinterpret_cast<const uint4*>(dout + src * D)[part];
  const uint32_t ow[4] = {o.x, o.y, o.z, o.w}, gw[4] = {g.x, g.y, g.z, g.w};
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float2 a = unpack_bf16(ow[c]), b = unpack_bf16(gw[c]);
    s = fmaf(a.y, b.y, fmaf(a.x, b.x, s));
  }
#pragma unroll
  for (int w = TPR / 2; w > 0; w >>= 1) s += __shfl_xor_sync(group, s, w);
  if (part == 0) {
    lse2[row] = lse[src] * kLog2e;
    di[row] = s;
  }
  if (qs != nullptr) {
    const uint4 x = reinterpret_cast<const uint4*>(q + src * D)[part];
    const uint32_t xw[4] = {x.x, x.y, x.z, x.w};
    uint32_t y[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float2 f = unpack_bf16(xw[c]);
      y[c] = pack_bf16(f.x * scale, f.y * scale);
    }
    reinterpret_cast<uint4*>(qs + src * D)[part] =
        make_uint4(y[0], y[1], y[2], y[3]);
  }
}

__device__ __forceinline__ uint32_t align1024(uint32_t a) {
  return (a + 1023u) & ~1023u;
}

// acc + the other warpgroup's sum (left in shared memory in acc's
// layout), times mul, as bf16 rows key0 and key0 + 8 of dst (rows < n)
template <int D>
__device__ __forceinline__ void store_sum(float (&acc)[D / kHalf][32],
                                          const float* other, bf16* dst,
                                          float mul, int key0, int n,
                                          int t4) {
  constexpr int NH = D / kHalf;
  const int wt = threadIdx.x % 128;
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[h][r] += other[(h * 32 + r) * 128 + wt];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int key = key0 + 8 * h2;
    if (key >= n) continue;
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8) {
        const int r = 4 * j8 + 2 * h2;
        *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)key * D +
                                           h * kHalf + j8 * 8 + 2 * t4) =
            __floats2bfloat162_rn(acc[h][r] * mul, acc[h][r + 1] * mul);
      }
  }
}

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
attn_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_do,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const float* __restrict__ lse2,
                           const float* __restrict__ di,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int H, int Hkv, int Sq, int Skv, int sq_pad,
                           int causal, float scale, int compute_bf16) {
  using C = Wg<D>;
  constexpr int NH = C::NH, kTileBytes = C::kTileBytes;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = align1024(raw);
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t k_s = base, v_s = base + kTileBytes;
  auto q_s = [&](int w, int s) {
    return base + 2 * kTileBytes + w * C::kRingBytes + s * 2 * kTileBytes;
  };
  auto rows_off = [&](int w, int s) {  // LSE row, then D_i row (bytes)
    return C::kDkdvRows + (w * kStages + s) * 2 * kTile * 4;
  };
  const uint32_t bar_kv = base + C::kDkdvBars;
  auto bar_full = [&](int w, int s) {
    return bar_kv + 8 * (1 + w * kStages + s);
  };
  auto bar_empty = [&](int w, int s) {
    return bar_kv + 8 * (1 + kWG * kStages + w * kStages + s);
  };

  const int hkv = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kTile;  // heaviest (key tile 0) first
  const int group = H / Hkv;
  const int offs = Skv - Sq;
  const int n_qt = (Sq + kTile - 1) / kTile;
  // causal: query row i sees key k0 from i = k0 - offs on
  const int qt0 = causal ? min(n_qt, max(0, k0 - offs) / kTile) : 0;
  const int nq = n_qt - qt0;
  const int n_items = group * nq;  // (head, query tile) pairs, head-major
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int w = 0; w < kWG; ++w)
      for (int s = 0; s < kStages; ++s) {
        mbar_init(bar_full(w, s), 1);
        mbar_init(bar_empty(w, s), 128);
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kWG) {  // producer: warp w feeds consumer warpgroup w
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kRegP)
                 : "memory");
    const int pw = (tid % 128) / 32;
    if (pw < kWG && tid % 32 == 0) {
      if (pw == 0) {
        mbar_expect_tx(bar_kv, 2 * kTileBytes);
        tma_tile<D>(k_s, &tm_k, bar_kv, k0, b * Hkv + hkv);
        tma_tile<D>(v_s, &tm_v, bar_kv, k0, b * Hkv + hkv);
      }
      // pair i = pw + kWG j is head i / nq's query tile qt0 + i % nq,
      // stepped without a division (the producer keeps few registers)
      const int bh0 = b * H + hkv * group;
      const size_t r0 = (size_t)bh0 * sq_pad + qt0 * kTile;
      const float* lrow = lse2 + r0;
      const float* drow = di + r0;
      int hi = 0, ti = pw;
      for (int j = 0; nq > 0; ++j, ti += kWG) {
        while (ti >= nq) {
          ti -= nq;
          ++hi;
        }
        if (hi >= group) break;
        const int s = j % kStages;
        mbar_wait(bar_empty(pw, s), ((j / kStages) & 1) ^ 1);
        const int q0 = (qt0 + ti) * kTile;
        const uint32_t full = bar_full(pw, s);
        mbar_expect_tx(full, 2 * kTileBytes + 2 * kTile * 4);
        tma_tile<D>(q_s(pw, s), &tm_q, full, q0, bh0 + hi);
        tma_tile<D>(q_s(pw, s) + kTileBytes, &tm_do, full, q0, bh0 + hi);
        const int r = hi * sq_pad + ti * kTile;
        bulk_copy(base + rows_off(pw, s), lrow + r, kTile * 4, full);
        bulk_copy(base + rows_off(pw, s) + kTile * 4, drow + r, kTile * 4,
                  full);
      }
    }
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kRegC)
                 : "memory");
    const int lane = tid % 32, warp = (tid % 128) / 32;
    const int g = lane >> 2, t4 = lane & 3;
    const bool rnd = compute_bf16 != 0;
    // compute fp32: logits = scale * (q . k); compute bf16: bf16(q*scale) . k
    const float sl2 = (rnd ? 1.f : scale) * kLog2e;
    const int key_w = k0 + warp * 16;  // this warp's first key
    const int key0 = key_w + g;        // keys of d[4j], d[4j+1]; +8: the rest
    // a straddling tile's mask as two comparisons an element: query column
    // 2 t4 + cc (cc = 8 j8 + c % 2) of key key0 + 8 (c / 2) is kept iff cc <
    // qrem and dc[c / 2] <= cc (set per pair below; few live registers)
    const int kd = key0 - offs - 2 * t4;
    float acc_k[NH][32], acc_v[NH][32], st[32], dpt[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      st[r] = dpt[r] = 0.f;
#pragma unroll
      for (int h = 0; h < NH; ++h) acc_k[h][r] = acc_v[h][r] = 0.f;
    }

    mbar_wait(bar_kv, 0);
    for (int i = wg, j = 0, ti = wg; i < n_items; i += kWG, ++j, ti += kWG) {
      while (ti >= nq) ti -= nq;  // pair i's query tile qt0 + i % nq
      const int s = j % kStages;
      const int q0 = (qt0 + ti) * kTile;
      const uint32_t qa = q_s(wg, s), ga = qa + kTileBytes;
      const float* ls =
          reinterpret_cast<const float*>(gbase + rows_off(wg, s));
      const float* dd = ls + kTile;
      mbar_wait(bar_full(wg, s), (j / kStages) & 1);
      // K's and V's addresses anew each pair, so that their 2 D / 16 slice
      // descriptors are not held in registers from pair to pair
      uint32_t ka = k_s, va = v_s;
      asm volatile("" : "+r"(ka), "+r"(va));
      // S^T = K Q^T and dP^T = V dO^T: keys x queries, over D in D / 16
      // k-slices
      fence_acc(st);
      fence_acc(dpt);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(st, kslice_desc(ka, kk), kslice_desc(qa, kk), kk);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dpt, kslice_desc(va, kk), kslice_desc(ga, kk), kk);
      wg_commit();
      // mask only tiles at the diagonal or a tail: rows past Sq, keys past
      // Skv (dc = INT_MAX) and, causal, keys past a row's diagonal
      int qrem = INT_MAX, dc[2] = {INT_MIN, INT_MIN};
      if (k0 + kTile > Skv || q0 + kTile > Sq ||
          (causal && key_w + 15 > q0 + offs)) {
        qrem = Sq - q0 - 2 * t4;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
          dc[h2] = key0 + 8 * h2 >= Skv ? INT_MAX
                   : causal             ? kd + 8 * h2 - q0
                                        : INT_MIN;
      }
      wg_wait<1>();
      fence_acc(st);
      // P^T in place; LSE * log2(e) of this thread's query columns 8 j8 +
      // 2 t4 + e read where used
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8) {
        const float2 x = *reinterpret_cast<const float2*>(ls + j8 * 8 + 2 * t4);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int cc = j8 * 8 + (c & 1);
          const bool ok = cc < qrem && dc[c >> 1] <= cc;
          const int r = 4 * j8 + c;
          const float p = ex2(fmaf(st[r], sl2, (c & 1) ? -x.y : -x.x));
          st[r] = ok ? p : 0.f;
        }
      }
      // dV += P^T dO: queries 16 kk .. + 15 are the k-step (dO's rows)
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pack_a(pa[kk], st, kk);
      fence_acc(acc_v);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < NH; ++h)
          wgmma_rs(acc_v[h], pa[kk], rows_desc(ga, h, kk));
      wg_commit();
      wg_wait<1>();  // dP^T has landed (dV may still run)
      fence_acc(dpt);
      // dS^T = P^T * (dP^T - D_i), D_i of the same columns read where used
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8) {
        const float2 x = *reinterpret_cast<const float2*>(dd + j8 * 8 + 2 * t4);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = 4 * j8 + c;
          const float gp =
              rnd ? __bfloat162float(__float2bfloat16(dpt[r])) : dpt[r];
          dpt[r] = st[r] * (gp - ((c & 1) ? x.y : x.x));
        }
      }
      // dK += dS^T Q
      uint32_t sa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pack_a(sa[kk], dpt, kk);
      fence_acc(acc_k);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < NH; ++h)
          wgmma_rs(acc_k[h], sa[kk], rows_desc(qa, h, kk));
      wg_commit();
      wg_wait<0>();
      keep_frags(pa);
      keep_frags(sa);
      fence_acc(acc_k);
      fence_acc(acc_v);
      mbar_arrive(bar_empty(wg, s));  // the stage's tiles are consumed
    }

    // the two warpgroups' sums: warpgroup 0 leaves its dV in its ring,
    // warpgroup 1 its dK in its own; each adds the other's and writes one
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    float* mine = reinterpret_cast<float*>(
        gbase + (q_s(wg, 0) - base));  // this warpgroup's ring, now free
    float* other = reinterpret_cast<float*>(gbase + (q_s(wg ^ 1, 0) - base));
    const int wt = tid % 128;
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int r = 0; r < 32; ++r)
        mine[(h * 32 + r) * 128 + wt] = wg == 0 ? acc_v[h][r] : acc_k[h][r];
    asm volatile("bar.sync 1, %0;\n" ::"n"(kWG * 128) : "memory");
    const size_t kv_off = ((size_t)b * Hkv + hkv) * (size_t)Skv * D;
    // dK = scale * dS^T q (compute fp32) or dS^T bf16(q * scale)
    if (wg == 0)
      store_sum<D>(acc_k, other, dk + kv_off, rnd ? 1.f : scale, key0, Skv,
                   t4);
    else
      store_sum<D>(acc_v, other, dv + kv_off, 1.f, key0, Skv, t4);
  }
}

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
attn_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const float* __restrict__ lse2,
                         const float* __restrict__ di, bf16* __restrict__ dq,
                         int H, int Hkv, int Sq, int Skv, int sq_pad,
                         int causal, float scale, int compute_bf16) {
  using C = Wg<D>;
  constexpr int NH = C::NH, kTileBytes = C::kTileBytes;
  constexpr int BQ = kWG * kTile;  // query rows a block
  const int h = blockIdx.x, b = blockIdx.y;
  const int n_qb = (Sq + BQ - 1) / BQ;
  const int q0b = (n_qb - 1 - (int)blockIdx.z) * BQ;  // heaviest first
  const int hkv = h / (H / Hkv);
  const int offs = Skv - Sq;
  const int n_kt = (Skv + kTile - 1) / kTile;
  // key tiles up to the diagonal of row `last` (all of them if not causal)
  auto tiles_to = [&](int last) {
    if (!causal) return n_kt;
    const int last_key = last + offs;
    return last_key < 0 ? 0 : min(n_kt, last_key / kTile + 1);
  };
  const int n_tiles = tiles_to(min(q0b + BQ, Sq) - 1);
  const int tid = threadIdx.x, wg = tid / 128;
  const size_t q_off = ((size_t)b * H + h) * (size_t)Sq * D;
  if (n_tiles == 0) {  // no row of the block sees a key: zero gradient
    for (int i = tid; i < BQ * D; i += kWsThreads) {
      const int r = q0b + i / D;
      if (r < Sq) dq[q_off + (size_t)r * D + i % D] = __float2bfloat16(0.f);
    }
    return;
  }

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = align1024(smem_addr(smem_raw));
  auto k_s = [&](int s) { return base + C::kDqKv + s * 2 * kTileBytes; };
  const uint32_t bar_q = base + C::kDqBars;
  auto bar_full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto bar_empty = [&](int s) { return bar_q + 8 * (1 + kStages + s); };
  // warpgroups whose rows start past Sq have no tile to load
  const int n_wg_rows = min(kWG, (Sq - q0b + kTile - 1) / kTile);

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), kWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kWG) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid % 128 == 0) {
      mbar_expect_tx(bar_q, n_wg_rows * 2 * kTileBytes);
      for (int w = 0; w < n_wg_rows; ++w) {
        tma_tile<D>(base + w * 2 * kTileBytes, &tm_q, bar_q, q0b + w * kTile,
                    b * H + h);
        tma_tile<D>(base + w * 2 * kTileBytes + kTileBytes, &tm_do, bar_q,
                    q0b + w * kTile, b * H + h);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(bar_empty(s), ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full(s), 2 * kTileBytes);
        tma_tile<D>(k_s(s), &tm_k, bar_full(s), t * kTile, b * Hkv + hkv);
        tma_tile<D>(k_s(s) + kTileBytes, &tm_v, bar_full(s), t * kTile,
                    b * Hkv + hkv);
      }
    }
  } else {  // consumers: warpgroup wg owns rows q0 .. q0 + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int lane = tid % 32, warp = (tid % 128) / 32;
    const int g = lane >> 2, t4 = lane & 3;
    const bool rnd = compute_bf16 != 0;
    const float sl2 = (rnd ? 1.f : scale) * kLog2e;
    const int q0 = q0b + wg * kTile;
    const int my_tiles = q0 < Sq ? tiles_to(min(q0 + kTile, Sq) - 1) : 0;
    const int warp_first = q0 + warp * 16;
    const int row0 = warp_first + g;  // rows of d[4j], d[4j+1]; +8: the rest
    const uint32_t qa = base + wg * 2 * kTileBytes, ga = qa + kTileBytes;
    float l2[2], dd[2];  // LSE * log2(e) and D_i of this thread's two rows
    const size_t r_off = ((size_t)b * H + h) * sq_pad;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;  // < sq_pad whenever q0 < Sq
      l2[i] = q0 < Sq ? lse2[r_off + row] : INFINITY;
      dd[i] = q0 < Sq ? di[r_off + row] : 0.f;
    }
    float acc[NH][32], s_[32], dp[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      s_[r] = dp[r] = 0.f;
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) acc[hh][r] = 0.f;
    }
    if (my_tiles > 0) mbar_wait(bar_q, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      mbar_wait(bar_full(s), (t / kStages) & 1);
      if (t < my_tiles) {
        const int k0 = t * kTile;
        const uint32_t ka = k_s(s), va = ka + kTileBytes;
        fence_acc(s_);
        fence_acc(dp);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss(s_, kslice_desc(qa, kk), kslice_desc(ka, kk), kk);
        wg_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss(dp, kslice_desc(ga, kk), kslice_desc(va, kk), kk);
        wg_commit();
        const bool straddles =
            k0 + kTile > Skv || (causal && k0 + kTile - 1 > warp_first + offs);
        wg_wait<1>();
        fence_acc(s_);
#pragma unroll
        for (int j8 = 0; j8 < 8; ++j8)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int key = k0 + j8 * 8 + 2 * t4 + (c & 1);
            const int row = row0 + 8 * (c >> 1);
            const bool ok =
                !straddles || (key < Skv && (!causal || key <= row + offs));
            const int r = 4 * j8 + c;
            const float p = ex2(fmaf(s_[r], sl2, -l2[c >> 1]));
            s_[r] = ok ? p : 0.f;
          }
        wg_wait<0>();
        fence_acc(dp);
#pragma unroll
        for (int j8 = 0; j8 < 8; ++j8)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int r = 4 * j8 + c;
            const float gp =
                rnd ? __bfloat162float(__float2bfloat16(dp[r])) : dp[r];
            dp[r] = s_[r] * (gp - dd[c >> 1]);
          }
        // dQ += dS K: keys 16 kk .. + 15 are the k-step (K's rows)
        uint32_t sa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) pack_a(sa[kk], dp, kk);
        fence_acc(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int hh = 0; hh < NH; ++hh)
            wgmma_rs(acc[hh], sa[kk], rows_desc(ka, hh, kk));
        wg_commit();
        wg_wait<0>();
        keep_frags(sa);
        fence_acc(acc);
      }
      mbar_arrive(bar_empty(s));  // the stage's K and V are consumed
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= Sq) continue;
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
#pragma unroll
        for (int j8 = 0; j8 < 8; ++j8) {
          float x = acc[hh][4 * j8 + 2 * i], y = acc[hh][4 * j8 + 2 * i + 1];
          if (rnd) {  // the gradient of q*scale's bf16 rounding, then the
                      // scale
            x = __bfloat162float(__float2bfloat16(x));
            y = __bfloat162float(__float2bfloat16(y));
          }
          *reinterpret_cast<__nv_bfloat162*>(dq + q_off + (size_t)row * D +
                                             hh * kHalf + j8 * 8 + 2 * t4) =
              __floats2bfloat162_rn(x * scale, y * scale);
        }
    }
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links nothing beyond the CUDA runtime
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static std::atomic<EncodeTiled> fn{nullptr};
  EncodeTiled f = fn.load(std::memory_order_acquire);
  if (f != nullptr) return f;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
    return nullptr;
  f = reinterpret_cast<EncodeTiled>(p);
  fn.store(f, std::memory_order_release);
  return f;
}

// (D, rows, heads) bf16 tensor, 64 x 64 boxes (a tile is D / 64 of them),
// 128-byte swizzle; rows past `rows` read as zeros
template <int D>
bool head_map(CUtensorMap* map, EncodeTiled enc, const void* ptr, int rows,
              long long heads) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {kHalf, kTile, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* out,
                 const void* dout, const void* lse, void* dq, void* dk,
                 void* dv, void* scratch, int B, int H, int Hkv, int Sq,
                 int Skv, int causal, float scale, int compute_bf16,
                 cudaStream_t stream) {
  using C = Wg<D>;
  static std::atomic<unsigned long long> set_dkdv{0}, set_dq{0};
  cudaError_t err = allow_dynamic_smem(
      set_dkdv, (const void*)attn_bwd_dkdv_wgmma_kernel<D>, C::kDkdvSmem);
  if (err != cudaSuccess) return (int)err;
  err = allow_dynamic_smem(set_dq, (const void*)attn_bwd_dq_wgmma_kernel<D>,
                           C::kDqSmem);
  if (err != cudaSuccess) return (int)err;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;

  const int sq_pad = (Sq + kTile - 1) / kTile * kTile;
  const long long rows_pad = (long long)B * H * sq_pad;
  float* lse2 = (float*)scratch;
  float* di = lse2 + rows_pad;
  bf16* qs = compute_bf16 ? (bf16*)(di + rows_pad) : nullptr;
  // rows_pad: a multiple of 64, so of the 32 or 16 rows a block
  attn_bwd_prep_kernel<D><<<(unsigned)(rows_pad / (256 / (D / 8))), 256, 0,
                            stream>>>(
      (const bf16*)q, (const bf16*)out, (const bf16*)dout, (const float*)lse,
      lse2, di, qs, Sq, sq_pad, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  if (!head_map<D>(&tm_q, enc, qs ? (const void*)qs : q, Sq,
                   (long long)B * H) ||
      !head_map<D>(&tm_do, enc, dout, Sq, (long long)B * H) ||
      !head_map<D>(&tm_k, enc, k, Skv, (long long)B * Hkv) ||
      !head_map<D>(&tm_v, enc, v, Skv, (long long)B * Hkv))
    return (int)cudaErrorInvalidValue;
  const dim3 g_kv(Hkv, B, (Skv + kTile - 1) / kTile);
  attn_bwd_dkdv_wgmma_kernel<D><<<g_kv, kWsThreads, C::kDkdvSmem, stream>>>(
      tm_q, tm_do, tm_k, tm_v, lse2, di, (bf16*)dk, (bf16*)dv, H, Hkv, Sq,
      Skv, sq_pad, causal, scale, compute_bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g_q(H, B, (Sq + kWG * kTile - 1) / (kWG * kTile));
  attn_bwd_dq_wgmma_kernel<D><<<g_q, kWsThreads, C::kDqSmem, stream>>>(
      tm_q, tm_do, tm_k, tm_v, lse2, di, (bf16*)dq, H, Hkv, Sq, Skv, sq_pad,
      causal, scale, compute_bf16);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const void* lse, void* dq, void* dk, void* dv,
           void* di, int B, int H, int Hkv, int Sq, int Skv, int D,
           int causal, float scale, int compute_bf16, cudaStream_t stream) {
  constexpr int LD = DP + 1, PS = kTile + 1;
  constexpr int smem_dkdv =
      sizeof(float) * (4 * kTile * LD + 2 * kTile * PS + 2 * kTile);
  constexpr int smem_dq =
      sizeof(float) * (4 * kTile * LD + kTile * PS + 2 * kTile);
  static std::atomic<unsigned long long> set_dkdv{0}, set_dq{0};
  auto k_dkdv = attn_bwd_dkdv_kernel<T, DP>;
  auto k_dq = attn_bwd_dq_kernel<T, DP>;
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
      D, causal, scale, compute_bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 g_q((Sq + kTile - 1) / kTile, H, B);
  k_dq<<<g_q, kThreads, smem_dq, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)di, (T*)dq, H, Hkv, Sq, Skv, D,
      causal, scale, compute_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `scratch`: fp32 workspace of at least
// 2 * B * H * Sq_pad floats (Sq_pad: Sq rounded up to 64), plus
// B * H * Sq * D / 2 under compute_bf16.  `kernel` receives the route
// launched: 0 the FMA pair (fp32 at D = 64 or 128), 1 the wgmma pair at
// D = 64 (bf16), 2 the FMA pair at a small width (any other D up to 128,
// either dtype, laid out 64 or 128 wide with the columns past D zero), 3
// the wgmma pair at D = 128 (bf16).  Returns cudaGetLastError() after the
// launches (0 on success); -1 for a D above 128 or a dtype this file does
// not build.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* scratch, int B, int H, int Hkv, int Sq, int Skv, int D, int causal,
    float scale, int compute_bf16, int dtype, int* kernel, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D < 1 || D > 128 || (dtype != 0 && dtype != 1)) return -1;
  if (dtype == 1 && D == 64) {
    *kernel = 1;
    return launch_wgmma<64>(q, k, v, out, dout, lse, dq, dk, dv, scratch, B,
                            H, Hkv, Sq, Skv, causal, scale, compute_bf16, s);
  }
  if (dtype == 1 && D == 128) {
    *kernel = 3;
    return launch_wgmma<128>(q, k, v, out, dout, lse, dq, dk, dv, scratch, B,
                             H, Hkv, Sq, Skv, causal, scale, compute_bf16, s);
  }
  *kernel = (D == 64 || D == 128) ? 0 : 2;
  if (dtype == 0)
    return D <= 64
               ? launch<float, 64>(q, k, v, out, dout, lse, dq, dk, dv,
                                   scratch, B, H, Hkv, Sq, Skv, D, causal,
                                   scale, compute_bf16, s)
               : launch<float, 128>(q, k, v, out, dout, lse, dq, dk, dv,
                                    scratch, B, H, Hkv, Sq, Skv, D, causal,
                                    scale, compute_bf16, s);
  return D <= 64 ? launch<bf16, 64>(q, k, v, out, dout, lse, dq, dk, dv,
                                    scratch, B, H, Hkv, Sq, Skv, D, causal,
                                    scale, compute_bf16, s)
                 : launch<bf16, 128>(q, k, v, out, dout, lse, dq, dk, dv,
                                     scratch, B, H, Hkv, Sq, Skv, D, causal,
                                     scale, compute_bf16, s);
}
