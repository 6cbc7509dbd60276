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
// card's ridge, so the products belong on the bf16 tensor cores (989
// TFLOP/s, against 67 for fp32 on the CUDA cores).
//
// bf16 inputs (the main path: qwen2 prefill, zamba2's shared block) take
// `flash_attention_mma_kernel`, FA2's layout on warp-level tensor-core
// products (`mma.sync.m16n8k16` bf16 -> fp32, operands through `ldmatrix`):
//   * a block is 4 warps and 64 query rows, 16 a warp (an 8-warp,
//     128-row block was slower at every main-path shape on the H100 once
//     both fit 512 threads an SM); Q stays in registers as A-fragments for
//     the whole block;
//   * K/V tiles of 64 keys stream through a two-stage ring in shared memory
//     filled by `cp.async` (16 B a thread), the next tile in flight while
//     the current one is used; rows are padded to D + 8 bf16, so the eight
//     row addresses of every `ldmatrix` (and `ldmatrix.trans` for V) fall
//     in distinct bank groups;
//   * S = Q K^T on the tensor cores with fp32 accumulation; the online
//     softmax stays in registers in the accumulator's fragment layout (row
//     max by shuffles within each quad, row sums reduced once at the end);
//     the causal / ragged-tail mask is applied only to tiles that straddle
//     the diagonal or the tail; tiles above the diagonal are never loaded,
//     and a warp skips a tile that none of its rows can see;
//   * O += P V on the tensor cores, S's accumulator fragments re-packed as
//     A-fragments (FA2's register trick);
//   * the heaviest causal query tiles launch first (the tile index is the
//     slowest grid axis, reversed), so the triangle's long tiles do not
//     form the last wave.
// Rounding points, so the kernel computes ref.mha_attention's function:
//   * compute_dtype=fp32: the plain version multiplies q by the scale in
//     fp32 and never rounds the probabilities.  Products of bf16 operands
//     are exact in fp32, so S is taken from the unscaled bf16 q and the
//     scale multiplies the fp32 logits (folded into the exp2 argument): for
//     D = 64 the scale 1/8 is exact and the logits are the plain version's
//     up to the order of summation; for D = 128 they differ by fp32
//     rounding only.  Rounding P once to bf16 would err by up to
//     2^-9 * sum_j p_j |v_j| / l, ~1.5e-3 on outputs near 0, above the
//     bf16 check's 2.5e-4 abs term.  So P is split into hi = bf16(p) and
//     lo = bf16(p - hi) and both go through the tensor cores (p - hi is
//     exact in fp32; lo's rounding leaves ~2^-17 relative), 1.5x SDPA's
//     tensor-core work;
//   * compute_dtype=bf16: q * scale is rounded to bf16 first, as the plain
//     version does, and P is rounded once to bf16 (unnormalised; the plain
//     version rounds the normalised probabilities, a difference the
//     tolerance of that mode allows): one P V product.
// fp32 inputs take `flash_attention_kernel`, the first port's design: fp32
// FMAs on 4x4 register tiles over fp32 tiles in shared memory.  It is not
// on the bf16 main path; it carries the reduced fp32 models and the fp32
// cases, held to 1e-5, and counts under the same launch counter.
//
// Both kernels: causal keys are right-aligned (query i sees keys <= i +
// Skv - Sq); ragged tails are masked (no divisibility requirement); a row
// that sees no key writes 0, like the Pallas kernel; GQA: query head h
// reads KV head h / (H / Hkv).  With a non-null `lse` (training) both also
// write each row's log-sum-exp of its scaled logits, fp32 (B, H, Sq), +inf
// for a row that sees no key: the backward (csrc/flash_attention_bwd.cu)
// recomputes the probabilities from it.  Serving passes null.
//
// Resources (ptxas -v, CUDA 12.8, sm_90a): D = 64 capped at 128 registers
// (so 4 blocks, 512 threads, fit an SM; 20 bytes of spill stores), D = 128
// 200 registers, no spills; dynamic shared memory (64 + 4 * 64) * (D + 8)
// * 2 bytes a block: 46 080 for D = 64, 87 040 for D = 128.  The fp32
// kernel: 64 (D = 64) and 107 (D = 128) registers.
//
// Layouts (all contiguous): q, out (B, H, Sq, D); k, v (B, Hkv, Skv, D).
// D is 64 or 128 on those routes.  Any other D up to 128, in either dtype,
// takes the small-width route: the FMA kernel instantiated for T and laid
// out 64 or 128 wide, the columns past D zero in shared memory (the
// reduced configs' 16-wide heads).

#include <atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// cudaFuncSetAttribute once per kernel instantiation and device: `done`
// is a static of the caller's instantiation, one bit per device
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

// ---------------------------------------------------------------------------
// bf16 inputs: tensor-core products
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;      // 16 query rows a warp
constexpr int kTileKeys = 64;  // keys per K/V tile
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

// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t):
//   A (16x16): a0 = (row g, cols 2t, 2t+1), a1 = (g+8, 2t..), a2 = (g,
//              2t+8..), a3 = (g+8, 2t+8..);
//   B (16x8):  b0 = (k 2t, 2t+1; n g), b1 = (k 2t+8, 2t+9; n g);
//   C (16x8):  c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = (row g+8, ...).
// D = 64: at most 128 registers, so 4 blocks fit an SM
template <int D>
__global__ void __launch_bounds__(kWarps * 32, D == 64 ? 4 : 1)
flash_attention_mma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out,
                           float* __restrict__ lse, int H, int Hkv, int Sq,
                           int Skv, int causal, float scale,
                           int compute_bf16) {
  constexpr int BQ = 16 * kWarps;  // query rows a block
  constexpr int BK = kTileKeys;
  constexpr int NT = 32 * kWarps;
  constexpr int LD = D + 8;        // padded smem row, in bf16
  constexpr int CH = D / 8;        // 16-byte chunks a row
  constexpr int KSTEPS = D / 16;   // k-steps of Q K^T
  constexpr int NTILE = BK / 8;    // 8-key column tiles of S
  constexpr int DTILE = D / 8;     // 8-wide column tiles of O

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.z) * BQ;  // heaviest tiles first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hkv = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int offs = Skv - Sq;

  const bf16* qb = q + ((size_t)b * H + h) * (size_t)Sq * D;
  const bf16* kb = k + ((size_t)b * Hkv + hkv) * (size_t)Skv * D;
  const bf16* vb = v + ((size_t)b * Hkv + hkv) * (size_t)Skv * D;
  bf16* ob = out + ((size_t)b * H + h) * (size_t)Sq * D;

  const int nk = (Skv + BK - 1) / BK;
  int n_tiles = nk;
  if (causal) {
    const int last_key = min(q0 + BQ, Sq) - 1 + offs;
    n_tiles = last_key < 0 ? 0 : min(nk, last_key / BK + 1);
  }
  if (n_tiles == 0) {  // no row of the block sees a key: zeros
    for (int i = tid; i < BQ * D; i += NT) {
      const int r = q0 + i / D;
      if (r < Sq) ob[(size_t)r * D + i % D] = __float2bfloat16(0.f);
    }
    if (lse != nullptr && tid < BQ && q0 + tid < Sq)
      lse[((size_t)b * H + h) * Sq + q0 + tid] = INFINITY;
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // BQ x LD
  bf16* k_s = q_s + BQ * LD;                       // 2 stages x BK x LD
  bf16* v_s = k_s + 2 * BK * LD;                   // 2 stages x BK x LD

  // group 0: the Q tile (rows past Sq zero-filled)
  for (int i = tid; i < BQ * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool ok = q0 + r < Sq;
    cp_async16(smem_addr(q_s + r * LD + c * 8),
               qb + (ok ? (size_t)(q0 + r) * D + c * 8 : 0), ok ? 16 : 0);
  }
  cp_async_commit();
  auto load_tile = [&](int kt) {  // K/V rows past Skv zero-filled
    const int k0 = kt * BK;
    bf16* ks = k_s + (kt & 1) * BK * LD;
    bf16* vs = v_s + (kt & 1) * BK * LD;
    for (int i = tid; i < BK * CH; i += NT) {
      const int r = i / CH, c = i % CH;
      const bool ok = k0 + r < Skv;
      const size_t off = ok ? (size_t)(k0 + r) * D + c * 8 : 0;
      cp_async16(smem_addr(ks + r * LD + c * 8), kb + off, ok ? 16 : 0);
      cp_async16(smem_addr(vs + r * LD + c * 8), vb + off, ok ? 16 : 0);
    }
  };
  load_tile(0);
  cp_async_commit();

  // the logits' scale, folded into exp2's argument: p = 2^(s*sl2 - m*sl2)
  const float sc = compute_bf16 ? 1.f : scale;
  const float sl2 = sc * kLog2e;
  const int row0 = q0 + warp * 16 + g;  // rows of c0/c1; c2/c3: row0 + 8
  const int warp_first = q0 + warp * 16, warp_last = warp_first + 15;

  uint32_t qf[KSTEPS][4];
  float o[DTILE][4];
#pragma unroll
  for (int j = 0; j < DTILE; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // raw logit units
  float l_run[2] = {0.f, 0.f};              // this thread's partial sums

  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) load_tile(kt + 1);
    cp_async_commit();   // (maybe empty) group: the count stays uniform
    cp_async_wait<1>();  // Q and tile kt have landed
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s) {
        ldmatrix_x4(qf[s], smem_addr(q_s + (warp * 16 + (lane & 15)) * LD +
                                     s * 16 + (lane >> 4) * 8));
        if (compute_bf16) {  // ref: (q * scale) rounded to bf16
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float2 f = unpack_bf16(qf[s][c]);
            qf[s][c] = pack_bf16(f.x * scale, f.y * scale);
          }
        }
      }
    }
    const int k0 = kt * BK;
    const bf16* ks = k_s + (kt & 1) * BK * LD;
    const bf16* vs = v_s + (kt & 1) * BK * LD;
    // a warp none of whose rows sees a key of this tile skips it
    const bool visible = warp_first < Sq &&
                         (!causal || k0 <= min(warp_last, Sq - 1) + offs);
    if (visible) {
      float s[NTILE][4];
#pragma unroll
      for (int j = 0; j < NTILE; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
      for (int st = 0; st < KSTEPS; ++st) {
#pragma unroll
        for (int np = 0; np < NTILE / 2; ++np) {
          uint32_t bk[4];  // n-tiles 2np, 2np+1 at k-step st
          ldmatrix_x4(bk, smem_addr(ks + (np * 16 + (lane & 7) +
                                          ((lane >> 4) << 3)) * LD +
                                    st * 16 + ((lane >> 3) & 1) * 8));
          mma_bf16(s[2 * np], qf[st], bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], qf[st], bk[2], bk[3]);
        }
      }
      // mask only tiles that straddle the diagonal or the ragged tail
      const bool straddles =
          k0 + BK > Skv || (causal && k0 + BK - 1 > warp_first + offs);
      if (straddles) {
#pragma unroll
        for (int j = 0; j < NTILE; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int key = k0 + j * 8 + 2 * t4 + (c & 1);
            const int row = row0 + (c >> 1) * 8;
            if (key >= Skv || (causal && key > row + offs))
              s[j][c] = -INFINITY;
          }
      }
      // online softmax, rows row0 (i = 0) and row0 + 8 (i = 1)
      float base[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NTILE; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[i], mx);
        base[i] = m_new == -INFINITY ? 0.f : m_new * sl2;
        const float alpha = exp2f(m_run[i] * sl2 - base[i]);  // 0 at -inf
        m_run[i] = m_new;
        l_run[i] *= alpha;
#pragma unroll
        for (int j = 0; j < DTILE; ++j) {
          o[j][2 * i] *= alpha;
          o[j][2 * i + 1] *= alpha;
        }
      }
#pragma unroll
      for (int j = 0; j < NTILE; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[j][c] = exp2f(fmaf(s[j][c], sl2, -base[c >> 1]));  // -inf -> 0
          l_run[c >> 1] += s[j][c];
        }
      // O += P V: keys kk*16 .. +15 are the A-fragment of n-tiles 2kk, 2kk+1
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // a0..a3: (tile 2kk | 2kk+1, row g | g+8)
          const float x = s[2 * kk + (r >> 1)][2 * (r & 1)];
          const float y = s[2 * kk + (r >> 1)][2 * (r & 1) + 1];
          ph[r] = pack_bf16(x, y);
          if (!compute_bf16) {  // p - hi is exact in fp32
            const float2 hv = unpack_bf16(ph[r]);
            pl[r] = pack_bf16(x - hv.x, y - hv.y);
          }
        }
#pragma unroll
        for (int dp = 0; dp < DTILE / 2; ++dp) {
          uint32_t bv[4];  // d-tiles 2dp, 2dp+1 at keys kk*16 .. +15
          ldmatrix_x4_trans(bv, smem_addr(vs + (kk * 16 + (lane & 7) +
                                                ((lane >> 3) & 1) * 8) * LD +
                                          dp * 16 + (lane >> 4) * 8));
          mma_bf16(o[2 * dp], ph, bv[0], bv[1]);
          mma_bf16(o[2 * dp + 1], ph, bv[2], bv[3]);
          if (!compute_bf16) {
            mma_bf16(o[2 * dp], pl, bv[0], bv[1]);
            mma_bf16(o[2 * dp + 1], pl, bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();  // stage kt & 1 is free for tile kt + 2
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const int row = row0 + 8 * i;
    if (lse != nullptr && row < Sq && t4 == 0)  // natural log, scaled logits
      lse[((size_t)b * H + h) * Sq + row] =
          l > 0.f ? m_run[i] * sc + logf(l) : INFINITY;
    if (row < Sq) {
#pragma unroll
      for (int j = 0; j < DTILE; ++j) {
        const __nv_bfloat162 val = __floats2bfloat162_rn(o[j][2 * i] * inv,
                                                         o[j][2 * i + 1] * inv);
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * D + j * 8 +
                                           2 * t4) = val;
      }
    }
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               void* lse, int B, int H, int Hkv, int Sq, int Skv, int causal,
               float scale, int compute_bf16, cudaStream_t stream) {
  constexpr int smem = (16 * kWarps + 4 * kTileKeys) * (D + 8) * 2;
  static std::atomic<unsigned long long> smem_set{0};
  auto kernel = flash_attention_mma_kernel<D>;
  cudaError_t err =
      allow_dynamic_smem(smem_set, (const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B, (Sq + 16 * kWarps - 1) / (16 * kWarps));
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out,
      (float*)lse, H, Hkv, Sq, Skv, causal, scale, compute_bf16);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 inputs: fp32 FMAs on the CUDA cores (not the bf16 main path)
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 256; // 16 row groups x 16 column lanes

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Each thread owns a 4x4 block of the score tile and 4 rows x D/16 columns
// of the output; the 16 threads that share a row are one half-warp, so row
// maxima and sums are warp shuffles.  compute_bf16 = 1 rounds q*scale, k, v
// and the probabilities to bf16 before the products.
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// DP: the width the tiles are laid out for (64 or 128); D <= DP the head
// width of the tensors.  Columns D..DP-1 of q, k and v are zeros in shared
// memory, so they add nothing to a score and their outputs are not written:
// the fp32 route runs D = DP, the small-width route any D below it.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int H, int Hkv, int Sq,
                       int Skv, int D, int causal, float scale,
                       int compute_bf16) {
  constexpr int QS = DP + 1;   // padded rows: no bank conflicts on row reads
  constexpr int KS = DP + 1;
  constexpr int PS = kBK + 1;
  constexpr int NJ = DP / 16;  // output columns per thread
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
  float* v_s = k_s + kBK * KS;   // kBK x DP
  float* p_s = v_s + kBK * DP;   // kBQ x PS

  const T* qb = q + ((size_t)b * H + h) * (size_t)Sq * D;
  const T* kb = k + ((size_t)b * Hkv + hkv) * (size_t)Skv * D;
  const T* vb = v + ((size_t)b * Hkv + hkv) * (size_t)Skv * D;

  for (int i = tid; i < kBQ * DP; i += kThreads) {
    const int r = i / DP, d = i % DP;
    float x = 0.f;
    if (q0 + r < Sq && d < D) {
      x = to_f(qb[(size_t)(q0 + r) * D + d]) * scale;
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
    for (int i = tid; i < kBK * DP; i += kThreads) {
      const int c = i / DP, d = i % DP;
      float kv = 0.f, vv = 0.f;
      if (k0 + c < Skv && d < D) {
        kv = to_f(kb[(size_t)(k0 + c) * D + d]);
        vv = to_f(vb[(size_t)(k0 + c) * D + d]);
        if (compute_bf16) {
          kv = round_bf16(kv);
          vv = round_bf16(vv);
        }
      }
      k_s[c * KS + d] = kv;
      v_s[c * DP + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
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
      for (int jj = 0; jj < NJ; ++jj) vv[jj] = v_s[c * DP + tx + 16 * jj];
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
    if (lse != nullptr && tx == 0)  // m, l are in units of the scaled logits
      lse[((size_t)b * H + h) * Sq + qi] =
          l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = tx + 16 * jj;
      if (d < D) ob[(size_t)qi * D + d] = from_f<T>(acc[i][jj] * inv);
    }
  }
}

template <typename T, int DP>
int launch_fma(const void* q, const void* k, const void* v, void* out,
               void* lse, int B, int H, int Hkv, int Sq, int Skv, int D,
               int causal, float scale, int compute_bf16,
               cudaStream_t stream) {
  constexpr int smem =
      sizeof(float) * (kBQ * (DP + 1) + kBK * (DP + 1) + kBK * DP +
                       kBQ * (kBK + 1));
  static std::atomic<unsigned long long> smem_set{0};
  auto kernel = flash_attention_kernel<T, DP>;
  cudaError_t err = allow_dynamic_smem(smem_set, (const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)lse, H, Hkv,
      Sq, Skv, D, causal, scale, compute_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; lse: null, or fp32 (B, H, Sq).
// Routes, by width and dtype: bf16 with D = 64 or 128 takes the mma kernel,
// fp32 with D = 64 or 128 the FMA kernel at its width (the fp32 route), any
// other D up to 128 in either dtype the FMA kernel at the next width of 64
// or 128 with the columns past D zero (the small-width route).  *kernel
// receives 0 (fp32 route), 1 (mma) or 2 (small width).  Returns
// cudaGetLastError() after the launch (0 on success); -1 for a D above 128
// or a dtype this file does not build.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int H, int Hkv, int Sq, int Skv,
                                      int D, int causal, float scale,
                                      int compute_bf16, int dtype,
                                      int* kernel, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D < 1 || D > 128 || (dtype != 0 && dtype != 1)) return -1;
  const bool fast = D == 64 || D == 128;
  if (fast && dtype == 1) {
    *kernel = 1;
    return D == 64 ? launch_mma<64>(q, k, v, out, lse, B, H, Hkv, Sq, Skv,
                                    causal, scale, compute_bf16, s)
                   : launch_mma<128>(q, k, v, out, lse, B, H, Hkv, Sq, Skv,
                                     causal, scale, compute_bf16, s);
  }
  *kernel = fast ? 0 : 2;
  if (dtype == 0)
    return D <= 64 ? launch_fma<float, 64>(q, k, v, out, lse, B, H, Hkv, Sq,
                                           Skv, D, causal, scale,
                                           compute_bf16, s)
                   : launch_fma<float, 128>(q, k, v, out, lse, B, H, Hkv,
                                            Sq, Skv, D, causal, scale,
                                            compute_bf16, s);
  return D <= 64 ? launch_fma<bf16, 64>(q, k, v, out, lse, B, H, Hkv, Sq,
                                        Skv, D, causal, scale, compute_bf16,
                                        s)
                 : launch_fma<bf16, 128>(q, k, v, out, lse, B, H, Hkv, Sq,
                                         Skv, D, causal, scale, compute_bf16,
                                         s);
}
