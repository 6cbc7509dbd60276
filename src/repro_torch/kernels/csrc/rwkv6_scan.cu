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
// 5 * dh^2 = 20 480 flops at dh = 64.  At B=4, S=1024, H=32, bf16 that is
// 84 MB against 2.7 GFLOP: 0.025 ms of HBM time, 0.0027 ms at the bf16
// tensor-core rate.  A decode step (S = 1) reads and writes the fp32
// state, 2 MB each way at B=4, H=32: 0.0013 ms.
//
// Three kernels; the entry point picks one and reports which:
//
// * `rwkv6_scan_mma_kernel` (bf16, S > 1: rwkv6 prefill).  Chunk-parallel
//   on the tensor cores (`mma.sync.m16n8k16` bf16 -> fp32).  One block of
//   8 warps per (b, h), walking chunks of L = 64 steps; the fp32 state
//   passes only between chunks and lives in registers.  Per chunk, with
//   cum the inclusive cumulative sum of log2(max(w, 1e-30)) per channel
//   (the floor of ref.rwkv6_scan_chunked: zero or denormal w never reaches
//   log) and cumx_t = cum_{t-1}:
//     A[t, j] = sum_c r_t[c] 2^(cumx_t[c] - cum_j[c]) k_j[c]   (j < t)
//     A[t, t] = r_t . (u o k_t)                                 (bonus)
//     y       = A V + (r o 2^cumx) S_in
//     S_out   = 2^cum_L o S_in + (k o 2^(cum_L - cum))^T V
//   Warp (half, a) owns rows 16a..16a+15 (sub-chunk a) of A and y and of
//   the state, channel half `half` of A's sums (the two halves meet
//   through shared memory) and column half `half` of y and the state.
//   Warps w and w + 4 share an SM sub-partition and take sub-chunks a and
//   3 - a, so the causal triangle's work is even across sub-partitions.
//   A score block of sub-chunks a > b factors through ref = the last step
//   of b: (r_t o 2^(cumx_t - cum_ref)) (k_j o 2^(cum_ref - cum_j))^T,
//   both factors <= 1, so no decay, however strong, overflows (one
//   reference at the chunk's start would: 2^(-cum_j) passes fp32's range
//   two steps after a w of 1e-30).  Inside a diagonal 16 x 16 block the
//   lower-left 8 x 8 quadrant factors the same way through step 7 of the
//   block (a 16 x 8 product with 8 rows of zeros), and the two 8 x 8
//   diagonal blocks are exact: the decay is a running product of w from
//   j = t - 1 down (no exp or log; w = 0 and denormal w as they are), 4
//   lanes per row pair, folded so every lane takes 9 of the 36 entries.
//   Rounding: bf16 inputs are exact as bf16 operands; an fp32 operand goes
//   in as hi = x cut to bf16 (its low 16 bits dropped) and lo = bf16(x -
//   hi).  Three products (hi hi + hi lo + lo hi) where both sides are fp32
//   (the factored scores, r'' S_in), two where one side is exact (A V, the
//   state update): one rounding of any of them misses chip_smoke's 2^-12
//   max|y| or 1e-4 state bars (tests/test_torch_scan_design.py).  The
//   exponentials and logarithms are the MUFU's (`ex2.approx`, `lg2.approx`,
//   subnormals kept).  The
//   next chunk's r, k, v, w (4 x 8 KB) arrive by `cp.async`, one tile at
//   each of four points of this chunk's work.
//   Resources (ptxas -v, CUDA 12.8): 142 registers, no spills; 216 864
//   bytes of dynamic shared memory, one block an SM (128 blocks at B=4,
//   H=32 on 132 SMs).
//
// * `rwkv6_scan_decode_kernel` (S = 1, either dtype: the decode step).
//   At S = 1 the state's columns are independent: y[j] = sum_i r_i (S_ij
//   + u_i k_i v_j), S'_ij = w_i S_ij + k_i v_j.  Grid (4 column groups of
//   16, H, B), 64 threads a block; each thread streams 4 rows x 4 columns
//   of the fp32 state with 16-byte loads and stores, and y is summed over
//   rows by shuffles and one shared-memory step.
//
// * `rwkv6_scan_kernel` (fp32, S > 1: the reduced fp32 models and the fp32
//   checks).  The first port's design: one block per (b, h), 4 * dh
//   threads, the state in registers (thread (j, p) keeps S[4*ii + p][j]),
//   r, k, v, w staged 32 steps at a time, sequential over steps.
//
// Any other dh up to 64 (the reduced configs' 16), any S, either dtype,
// takes `rwkv6_scan_small_kernel`, the small-width route at the end of
// this file: one block a (b, h) stepping t, the state in shared memory.
//
// A second entry point, `rwkv6_scan_split_launch`, takes one decode step
// (S = 1) on a slice of the key channels: a rank of a "model" line that
// holds dk of every head's dv keys (the serving layout of
// `decode_state_specs`: the wkv state's key dim over "model").
// `rwkv6_scan_split_kernel` updates the slice's rows of the state and
// writes the slice's part of the readout in fp32; the readout is the sum
// of every slice's part, which the caller reduces over the line.
//
// Layouts (all contiguous): r, k, v, w, y (B, S, H, dh) in T (float or
// __nv_bfloat16); u (H, dh) fp32; s0, s_out (B, H, dh, dh) fp32, row index
// = k channel, column index = v channel; s0 and s_out may be null.
// Arithmetic is fp32 outside the tensor cores; build without
// --use_fast_math / -ftz.

#include <atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kDH = 64;            // head size this file builds

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

// ---------------------------------------------------------------------------
// fp32, S > 1: sequential over steps
// ---------------------------------------------------------------------------

constexpr int kLanes = 4;          // threads per state column
constexpr int kRows = kDH / kLanes;
constexpr int kThreads = kDH * kLanes;
constexpr int kT = 32;             // steps staged per chunk

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

// ---------------------------------------------------------------------------
// S = 1, either dtype: the decode step, split over state columns
// ---------------------------------------------------------------------------

constexpr int kDecCols = 16;                 // v columns a block
constexpr int kDecThreads = 64;              // 16 row groups x 4 column quads

template <typename T>
__global__ void __launch_bounds__(kDecThreads)
rwkv6_scan_decode_kernel(const T* __restrict__ r, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ w,
                         const float* __restrict__ u,
                         const float* __restrict__ s0, T* __restrict__ y,
                         float* __restrict__ s_out, int H) {
  __shared__ float part[kDecCols];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int quad = tid & 3;                  // columns j0 .. j0 + 3
  const int rg = tid >> 2;                   // rows rg + 16 m, m < 4
  const int j0 = blockIdx.x * kDecCols + 4 * quad;
  const size_t vec = ((size_t)b * H + h) * kDH;
  const size_t sbase = vec * kDH;

  float vj[4], acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) vj[jj] = to_float(v[vec + j0 + jj]);
#pragma unroll
  for (int m = 0; m < kDH / 16; ++m) {
    const int i = rg + 16 * m;
    const float ri = to_float(r[vec + i]), ki = to_float(k[vec + i]);
    const float wi = to_float(w[vec + i]), ui = u[(size_t)h * kDH + i];
    float4 st = s0 ? *reinterpret_cast<const float4*>(
                         s0 + sbase + (size_t)i * kDH + j0)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    float* sv = &st.x;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float kv = ki * vj[jj];
      acc[jj] = fmaf(ri, fmaf(ui, kv, sv[jj]), acc[jj]);
      sv[jj] = fmaf(sv[jj], wi, kv);
    }
    if (s_out)
      *reinterpret_cast<float4*>(s_out + sbase + (size_t)i * kDH + j0) = st;
  }
  // sum over the row groups: 8 in a warp (lane >> 2), then the two warps
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    acc[jj] += __shfl_xor_sync(0xffffffffu, acc[jj], 4);
    acc[jj] += __shfl_xor_sync(0xffffffffu, acc[jj], 8);
    acc[jj] += __shfl_xor_sync(0xffffffffu, acc[jj], 16);
  }
  if (tid >= 32 && tid < 36) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) part[4 * quad + jj] = acc[jj];
  }
  __syncthreads();
  if (tid < 4) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      y[vec + j0 + jj] = from_float<T>(acc[jj] + part[4 * quad + jj]);
  }
}

// ---------------------------------------------------------------------------
// bf16, S > 1: chunk-parallel on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kL = 64;             // chunk
constexpr int kSub = 16;           // sub-chunk: a warp's rows
constexpr int kWarps = 8;          // (channel / column half, sub-chunk)
constexpr int kLD = kDH + 8;       // padded bf16 row (ldmatrix: no conflicts)
constexpr int kCP = kDH + 8;       // padded fp32 row of the cumulative sums
constexpr int kDP = kSub + 1;      // padded row of a diagonal block
constexpr float kFloorW = 1e-30f;  // ref.rwkv6_scan_chunked's floor

constexpr int kTile = kL * kLD;    // one (64 x kLD) bf16 tile
constexpr size_t kMmaSmem =
    sizeof(bf16) * (2 * 4 * kTile      // r, k, v, w: two stages
                    + 8 * kTile        // S_in, kf, k2, ri: hi and lo
                    + kTile)           // kq: hi and lo, 32 rows each
    + sizeof(float) * ((kL + 1) * kCP  // cumE
                       + kWarps * kSub * kDP      // diagonal blocks
                       + kWarps * 8 * 32 * 4);    // partial scores

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
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
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
// (x, y) as bf16 hi + lo: hi = (x, y) cut to bf16 (the low 16 bits
// dropped: a byte permute, no conversion), lo = bf16((x, y) - hi) with the
// difference exact in fp32; hi + lo keeps ~16 bits of x
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t xb = __float_as_uint(x), yb = __float_as_uint(y);
  hi = __byte_perm(xb, yb, 0x7632);
  lo = pack_bf16(x - __uint_as_float(xb & 0xffff0000u),
                 y - __uint_as_float(yb & 0xffff0000u));
}
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ float2 ldf2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
// MUFU approximations, subnormals kept (no .ftz): 2^x within ~2 ulp (2^-inf
// = +0), log2 within ~2^-22 absolute; the accurate exp2f / log2f cost
// several times the instructions in the kernel's hottest loops
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float fast_log2(float x) {
  float y;
  asm("lg2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// 8 bf16 (16 bytes) as floats
__device__ __forceinline__ void unpack8(uint4 x, float (&f)[8]) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = unpack_bf16(w[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// Fragment layouts of mma.m16n8k16 (lane = 4 * g + q):
//   A (16x16): a0 = (row g, cols 2q, 2q+1), a1 = (g+8, 2q..), a2 = (g,
//              2q+8..), a3 = (g+8, 2q+8..);
//   B (16x8):  b0 = (k 2q, 2q+1; n g), b1 = (k 2q+8, 2q+9; n g);
//   C (16x8):  c0, c1 = (row g, cols 2q, 2q+1), c2, c3 = (row g+8, ...).
// ldmatrix addresses (lane l supplies one row of matrix l >> 3):
//   A from a row-major [m][k] tile: row m0 + (l & 15), col k0 + (l >> 4) 8;
//   A from a [k][m] tile (.trans): row k0 + (l & 7) + (l >> 4) 8, col m0 +
//     ((l >> 3) & 1) 8;
//   B, n-tiles n0 / n0 + 8, from an [n][k] tile: row n0 + (l & 7) +
//     (l >> 4) 8, col k0 + ((l >> 3) & 1) 8;
//   B, n-tiles n0 / n0 + 8, from a [k][n] tile (.trans): row k0 + (l & 7) +
//     ((l >> 3) & 1) 8, col n0 + (l >> 4) 8.
__device__ __forceinline__ int a_trans_row(int l) {
  return (l & 7) + ((l >> 4) << 3);
}
__device__ __forceinline__ int a_trans_col(int l) {
  return ((l >> 3) & 1) << 3;
}
__device__ __forceinline__ int b_row(int l) {
  return (l & 7) + ((l >> 4) << 3);
}
__device__ __forceinline__ int b_col(int l) { return ((l >> 3) & 1) << 3; }
__device__ __forceinline__ int bt_row(int l) {
  return (l & 7) + (((l >> 3) & 1) << 3);
}
__device__ __forceinline__ int bt_col(int l) { return (l >> 4) << 3; }

__global__ void __launch_bounds__(kWarps * 32, 1)
rwkv6_scan_mma_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ w,
                      const float* __restrict__ u,
                      const float* __restrict__ s0, bf16* __restrict__ y,
                      float* __restrict__ s_out, int S, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* stage = reinterpret_cast<bf16*>(smem_raw);  // [2][r k v w][64][kLD]
  bf16* s_hi = stage + 2 * 4 * kTile;   // S_in split, [i][j]
  bf16* s_lo = s_hi + kTile;
  bf16* kf_hi = s_lo + kTile;           // k_j 2^(cum_ref - cum_j), [j][c]
  bf16* kf_lo = kf_hi + kTile;
  bf16* k2_hi = kf_lo + kTile;          // k_t 2^(cum_L - cum_t), [t][i]
  bf16* k2_lo = k2_hi + kTile;
  bf16* ri_hi = k2_lo + kTile;          // r_t 2^cumx_t, [t][c]
  bf16* ri_lo = ri_hi + kTile;
  bf16* kq_hi = ri_lo + kTile;          // k_j 2^(cum_q - cum_j), [32][c]
  bf16* kq_lo = kq_hi + kTile / 2;      // (j & 8) == 0, q = (j | 7)
  float* cumE = reinterpret_cast<float*>(kq_hi + kTile);  // [65][kCP]
  float* diag = cumE + (kL + 1) * kCP;  // [warp][16][kDP]
  float4* part = reinterpret_cast<float4*>(diag + kWarps * kSub * kDP);
                                        // [warp][8 n-tiles][32 lanes]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  // warp = (half, a): rows 16a .. 16a + 15 of y and of the state; channel
  // half `half` of the scores, column half `half` of y and of the state
  // warps w and w + 4 share an SM sub-partition: give them sub-chunks a
  // and 3 - a, so each sub-partition carries 3 off-diagonal score blocks
  const int half = warp >> 2;
  const int a = half ? 3 - (warp & 3) : warp & 3;
  const int partner = 7 - warp;          // (1 - half, a)

  const size_t rstride = (size_t)H * kDH;      // one step
  const size_t base = (size_t)b * S * rstride + (size_t)h * kDH;
  const size_t sbase = ((size_t)b * H + h) * kDH * kDH;
  const int n_chunks = (S + kL - 1) / kL;

  // one tile (r, k, v or w) of chunk c, rows past S zero-filled.  The
  // next chunk's four tiles are issued at four points of this chunk's
  // work: issued together, every block's 32 KB arrive as one burst that
  // stalls the issuing warps for about a microsecond
  auto load_tile = [&](int c, int tile) {
    const int t0 = c * kL;
    bf16* st = stage + ((c & 1) * 4 + tile) * kTile;
    const bf16* src = tile == 0 ? r : tile == 1 ? k : tile == 2 ? v : w;
#pragma unroll
    for (int e = tid; e < kL * 8; e += kWarps * 32) {
      const int row = e >> 3, piece = e & 7;
      const bool ok = t0 + row < S;
      const size_t off =
          ok ? base + (size_t)(t0 + row) * rstride + piece * 8 : 0;
      cp_async16(smem_addr(st + row * kLD + piece * 8), src + off,
                 ok ? 16 : 0);
    }
  };

  // the state: warp (half, a) holds rows i = 16a + g (c0, c1) and + 8 (c2,
  // c3), columns 32 half + 8 nt + 2q (+1), nt < 4, in fp32 for the whole
  // sequence
  const int i0 = a * kSub + g;
  const int col0 = 32 * half + 2 * q;
  float sreg[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    float2 lo = make_float2(0.f, 0.f), hi8 = lo;
    if (s0) {
      lo = ldf2(s0 + sbase + (size_t)i0 * kDH + col0 + 8 * nt);
      hi8 = ldf2(s0 + sbase + (size_t)(i0 + 8) * kDH + col0 + 8 * nt);
    }
    sreg[nt][0] = lo.x; sreg[nt][1] = lo.y;
    sreg[nt][2] = hi8.x; sreg[nt][3] = hi8.y;
  }
  auto store_state_split = [&]() {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = col0 + 8 * nt;
      uint32_t hi, lo;
      split_bf16(sreg[nt][0], sreg[nt][1], hi, lo);
      *reinterpret_cast<uint32_t*>(s_hi + i0 * kLD + col) = hi;
      *reinterpret_cast<uint32_t*>(s_lo + i0 * kLD + col) = lo;
      split_bf16(sreg[nt][2], sreg[nt][3], hi, lo);
      *reinterpret_cast<uint32_t*>(s_hi + (i0 + 8) * kLD + col) = hi;
      *reinterpret_cast<uint32_t*>(s_lo + (i0 + 8) * kLD + col) = lo;
    }
  };

  // u for the bonus terms: this lane's channels 32 half + 8q .. + 7
  const int ch0 = 32 * half + 8 * q;
  float uu[8];
#pragma unroll
  for (int cc = 0; cc < 8; ++cc) uu[cc] = u[(size_t)h * kDH + ch0 + cc];

#pragma unroll
  for (int tile = 0; tile < 4; ++tile) load_tile(0, tile);
  cp_async_commit();
  store_state_split();

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<0>();  // chunk c has landed
    __syncthreads();     // ... for every thread; every read of chunk c - 1's
                         // buffers is done; S_in's split is written
    const bool more = c + 1 < n_chunks;  // into the stage chunk c - 1 used
    if (more) load_tile(c + 1, 0);
    const bf16* rs = stage + (c & 1) * 4 * kTile;
    const bf16* ks = rs + kTile;
    const bf16* vs = ks + kTile;
    const bf16* ws = vs + kTile;
    const int t0 = c * kL;
    const int n = min(kL, S - t0);

    // -- cumE[t + 1][ch] = sum_{s <= t} log2(max(w_s[ch], 1e-30)), cumE[0]
    //    = 0; steps past S have w = 1.  Lane (ch, qt) of warp w sums the 16
    //    steps 16 qt .. 16 qt + 15 of channel 8w + (lane >> 2); the 4
    //    quarters' totals are scanned by shuffles.
    {
      const int ch = 8 * warp + (lane >> 2), qt = lane & 3;
      float run[16];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int t = 16 * qt + i;
        const float lw =
            t < n ? fast_log2(fmaxf(__bfloat162float(ws[t * kLD + ch]),
                                    kFloorW))
                  : 0.f;
        acc += lw;
        run[i] = acc;
      }
      float incl = acc;
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off, 4);
        if (qt >= off) incl += o;
      }
      const float offset = incl - acc;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        cumE[(16 * qt + i + 1) * kCP + ch] = offset + run[i];
      if (qt == 0) cumE[ch] = 0.f;
    }
    __syncthreads();
    if (more) load_tile(c + 1, 1);

    // -- split operands, all factors <= 1: k2 = k o 2^(cum_L - cum) (the
    //    state update), ri = r o 2^cumx (r'' S), kf = k_j o 2^(cum_ref -
    //    cum_j) for j < 48 (ref = the last step of j's sub-chunk: the
    //    off-diagonal scores) and kq = k_j o 2^(cum_q - cum_j) for the
    //    first 8 steps j of each sub-chunk (q = j | 7: the lower-left
    //    quadrant of the diagonal blocks).  Thread (hh, sc, pair) walks
    //    steps 16 sc + 8 hh .. + 7 of channels 2 pair, 2 pair + 1.
    {
      const int cp = 2 * (tid & 31), sc = (tid >> 5) & 3, hh = tid >> 7;
      const int tb = kSub * sc + 8 * hh;
      const float2 cl = ldf2(cumE + kL * kCP + cp);
      const float2 cr = ldf2(cumE + (kSub * sc + kSub) * kCP + cp);
      const float2 cq = ldf2(cumE + (kSub * sc + 8) * kCP + cp);
      float2 cx = ldf2(cumE + tb * kCP + cp);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = tb + i;
        const float2 kk = unpack_bf16(ld32(ks + t * kLD + cp));
        const float2 rr = unpack_bf16(ld32(rs + t * kLD + cp));
        const float2 ce = ldf2(cumE + (t + 1) * kCP + cp);
        uint32_t hi, lo;
        split_bf16(kk.x * fast_exp2(cl.x - ce.x),
                   kk.y * fast_exp2(cl.y - ce.y), hi, lo);
        *reinterpret_cast<uint32_t*>(k2_hi + t * kLD + cp) = hi;
        *reinterpret_cast<uint32_t*>(k2_lo + t * kLD + cp) = lo;
        split_bf16(rr.x * fast_exp2(cx.x), rr.y * fast_exp2(cx.y), hi, lo);
        *reinterpret_cast<uint32_t*>(ri_hi + t * kLD + cp) = hi;
        *reinterpret_cast<uint32_t*>(ri_lo + t * kLD + cp) = lo;
        if (sc < 3) {
          split_bf16(kk.x * fast_exp2(cr.x - ce.x),
                     kk.y * fast_exp2(cr.y - ce.y), hi, lo);
          *reinterpret_cast<uint32_t*>(kf_hi + t * kLD + cp) = hi;
          *reinterpret_cast<uint32_t*>(kf_lo + t * kLD + cp) = lo;
        }
        if (hh == 0) {
          const int jq = 8 * sc + i;
          split_bf16(kk.x * fast_exp2(cq.x - ce.x),
                     kk.y * fast_exp2(cq.y - ce.y), hi, lo);
          *reinterpret_cast<uint32_t*>(kq_hi + jq * kLD + cp) = hi;
          *reinterpret_cast<uint32_t*>(kq_lo + jq * kLD + cp) = lo;
        }
        cx = ce;
      }
    }

    // -- the two 8 x 8 diagonal blocks of sub-chunk a over this warp's
    //    channel half: A[t, j] = sum_c r_t[c] k_j[c] prod_{j < s < t}
    //    w_s[c], the decay a running product of w (no exp or log; w = 0
    //    and denormal w as they are) from j = t - 1 down, after the bonus
    //    r_t . (u o k_t).  Lane (g, q) takes block g >> 2, rows gp = g & 3
    //    and 7 - gp of it (9 entries j <= t between them), channels ch0 ..
    //    ch0 + 7, summed over q by shuffles.  The quadrant below them goes
    //    to the tensor cores with the scores.
    {
      float* dg = diag + warp * kSub * kDP;
      const int blk = 8 * (g >> 2), gp = g & 3;
      float rA[8], rB[8], ruB[8], rf[8];
      unpack8(*reinterpret_cast<const uint4*>(
                  rs + (a * kSub + blk + gp) * kLD + ch0), rA);
      unpack8(*reinterpret_cast<const uint4*>(
                  rs + (a * kSub + blk + 7 - gp) * kLD + ch0), rB);
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) ruB[cc] = rB[cc] * uu[cc];
#pragma unroll
      for (int m = 0; m <= 8; ++m) {
        const bool first = m <= gp;             // row gp, else row 7 - gp
        const bool start = m == gp + 1;         // row 7 - gp's bonus
        const int tl = blk + (first ? gp : 7 - gp);
        const int jl = blk + (first ? gp - m : 8 - m);
        const int j = a * kSub + jl;
        float kj[8], wj[8];
        unpack8(*reinterpret_cast<const uint4*>(ks + j * kLD + ch0), kj);
        if (m > 0)
          unpack8(*reinterpret_cast<const uint4*>(ws + j * kLD + ch0), wj);
        float p0 = 0.f, p1 = 0.f;
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) {
          float f;
          if (m == 0) {     // row gp's bonus; then the factor 1 for j - 1
            f = rA[cc] * uu[cc];
            rf[cc] = rA[cc];
          } else {
            f = start ? ruB[cc] : rf[cc];
            rf[cc] = start ? rB[cc] : rf[cc] * wj[cc];
          }
          if (cc & 1)
            p1 = fmaf(f, kj[cc], p1);
          else
            p0 = fmaf(f, kj[cc], p0);
        }
        float sum = p0 + p1;
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (q == (m & 3)) dg[tl * kDP + jl] = sum;
      }
    }
    __syncthreads();     // kf, k2, ri, kq and the diagonal blocks are
                         // written
    if (more) load_tile(c + 1, 2);

    // -- this warp's partial scores (its channel half) of rows 16a .. 16a
    //    + 15: s[nt] holds columns 8 nt .. 8 nt + 7, nt <= 2a + 1
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    const int row0 = a * kSub + g;   // rows of c0/c1; c2/c3: row0 + 8
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      if (bb == a) {        // the diagonal block, upper triangle 0
        // the lower-left quadrant (rows 8..15, columns 0..7) factored
        // through q = 16a + 7: rows g + 8 of n-tile 2a (c2, c3)
        float quad[4] = {0.f, 0.f, 0.f, 0.f};
        const float* cref = cumE + (kSub * bb + 8) * kCP;
#pragma unroll
        for (int sh = 0; sh < 2; ++sh) {
          const int st = 2 * half + sh;     // k-steps of this channel half
          uint32_t ah[4] = {0u, 0u, 0u, 0u}, al[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int e = 1; e < 4; e += 2) {  // a1, a3: row g + 8
            const int row = row0 + 8;
            const int col = 16 * st + 2 * q + 8 * (e >> 1);
            const float2 rr = unpack_bf16(ld32(rs + row * kLD + col));
            const float2 ct = ldf2(cumE + row * kCP + col);
            const float2 cr = ldf2(cref + col);
            split_bf16(rr.x * fast_exp2(ct.x - cr.x),
                       rr.y * fast_exp2(ct.y - cr.y), ah[e], al[e]);
          }
          uint32_t bh[2], bl[2];   // n-tile of j = 16a .. 16a + 7
          const int off = (8 * bb + (lane & 7)) * kLD + 16 * st +
                          ((lane >> 3) & 1) * 8;
          ldmatrix_x2(bh, smem_addr(kq_hi + off));
          ldmatrix_x2(bl, smem_addr(kq_lo + off));
          mma_bf16(quad, ah, bh[0], bh[1]);
          mma_bf16(quad, ah, bl[0], bl[1]);
          mma_bf16(quad, al, bh[0], bh[1]);
        }
#pragma unroll
        for (int nh = 0; nh < 2; ++nh)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int tl = g + 8 * (e >> 1), jl = 8 * nh + 2 * q + (e & 1);
            s[2 * bb + nh][e] =
                nh == 0 && e >= 2
                    ? quad[e]
                    : jl <= tl ? diag[(warp * kSub + tl) * kDP + jl] : 0.f;
          }
      } else if (bb < a) {  // factored through ref = 16 bb + 15
        const float* cref = cumE + (kSub * bb + kSub) * kCP;
#pragma unroll
        for (int sh = 0; sh < 2; ++sh) {
          const int st = 2 * half + sh;     // k-steps of this channel half
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = row0 + 8 * (e & 1);
            const int col = 16 * st + 2 * q + 8 * (e >> 1);
            const float2 rr = unpack_bf16(ld32(rs + row * kLD + col));
            const float2 ct = ldf2(cumE + row * kCP + col);
            const float2 cr = ldf2(cref + col);
            split_bf16(rr.x * fast_exp2(ct.x - cr.x),
                       rr.y * fast_exp2(ct.y - cr.y), ah[e], al[e]);
          }
          uint32_t bh[4], bl[4];
          const int off = (kSub * bb + b_row(lane)) * kLD + 16 * st +
                          b_col(lane);
          ldmatrix_x4(bh, smem_addr(kf_hi + off));
          ldmatrix_x4(bl, smem_addr(kf_lo + off));
          mma_bf16(s[2 * bb], ah, bh[0], bh[1]);
          mma_bf16(s[2 * bb + 1], ah, bh[2], bh[3]);
          mma_bf16(s[2 * bb], ah, bl[0], bl[1]);
          mma_bf16(s[2 * bb + 1], ah, bl[2], bl[3]);
          mma_bf16(s[2 * bb], al, bh[0], bh[1]);
          mma_bf16(s[2 * bb + 1], al, bh[2], bh[3]);
        }
      }
    }
    // the partner warp holds the other channel half of the same rows
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      if (nt <= 2 * a + 1)
        part[(warp * 8 + nt) * 32 + lane] =
            make_float4(s[nt][0], s[nt][1], s[nt][2], s[nt][3]);
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + a), "r"(64) : "memory");
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      if (nt <= 2 * a + 1) {
        const float4 o4 = part[(partner * 8 + nt) * 32 + lane];
        s[nt][0] += o4.x; s[nt][1] += o4.y; s[nt][2] += o4.z; s[nt][3] += o4.w;
      }
    if (more) {
      load_tile(c + 1, 3);
      cp_async_commit();
    }

    // -- y, columns 32 half .. 32 half + 31: (r o 2^cumx) S_in (three
    //    products) + A V (two products)
    float o[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
#pragma unroll
    for (int st = 0; st < kDH / 16; ++st) {
      uint32_t ah[4], al[4];
      const int aoff = (a * kSub + (lane & 15)) * kLD + 16 * st +
                       ((lane >> 4) << 3);
      ldmatrix_x4(ah, smem_addr(ri_hi + aoff));
      ldmatrix_x4(al, smem_addr(ri_lo + aoff));
#pragma unroll
      for (int dp = 0; dp < 2; ++dp) {
        uint32_t bh[4], bl[4];
        const int off = (16 * st + bt_row(lane)) * kLD + 32 * half + 16 * dp +
                        bt_col(lane);
        ldmatrix_x4_trans(bh, smem_addr(s_hi + off));
        ldmatrix_x4_trans(bl, smem_addr(s_lo + off));
        mma_bf16(o[2 * dp], ah, bh[0], bh[1]);
        mma_bf16(o[2 * dp + 1], ah, bh[2], bh[3]);
        mma_bf16(o[2 * dp], ah, bl[0], bl[1]);
        mma_bf16(o[2 * dp + 1], ah, bl[2], bl[3]);
        mma_bf16(o[2 * dp], al, bh[0], bh[1]);
        mma_bf16(o[2 * dp + 1], al, bh[2], bh[3]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk > a) continue;
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)   // a0..a3: (tile 2kk | 2kk+1, row g | g+8)
        split_bf16(s[2 * kk + (e >> 1)][2 * (e & 1)],
                   s[2 * kk + (e >> 1)][2 * (e & 1) + 1], ph[e], pl[e]);
#pragma unroll
      for (int dp = 0; dp < 2; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, smem_addr(vs + (16 * kk + bt_row(lane)) * kLD +
                                        32 * half + 16 * dp + bt_col(lane)));
        mma_bf16(o[2 * dp], ph, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], ph, bv[2], bv[3]);
        mma_bf16(o[2 * dp], pl, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pl, bv[2], bv[3]);
      }
    }
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int tl = row0 + 8 * e2;
      if (tl < n) {
        bf16* yr = y + base + (size_t)(t0 + tl) * rstride + col0;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          *reinterpret_cast<__nv_bfloat162*>(yr + 8 * nt) =
              __floats2bfloat162_rn(o[nt][2 * e2], o[nt][2 * e2 + 1]);
      }
    }
    __syncthreads();     // every read of S_in's split is done

    // -- S_out = 2^cum_L o S_in + (k o 2^(cum_L - cum))^T V for this
    //    warp's rows and column half: the decay first, then two products
    //    over the steps
    {
      const float d0 = fast_exp2(cumE[kL * kCP + i0]);
      const float d1 = fast_exp2(cumE[kL * kCP + i0 + 8]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        sreg[nt][0] *= d0; sreg[nt][1] *= d0;
        sreg[nt][2] *= d1; sreg[nt][3] *= d1;
      }
#pragma unroll
      for (int st = 0; st < kL / 16; ++st) {
        uint32_t ah[4], al[4];
        const int aoff = (16 * st + a_trans_row(lane)) * kLD + kSub * a +
                         a_trans_col(lane);
        ldmatrix_x4_trans(ah, smem_addr(k2_hi + aoff));
        ldmatrix_x4_trans(al, smem_addr(k2_lo + aoff));
#pragma unroll
        for (int dp = 0; dp < 2; ++dp) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, smem_addr(vs + (16 * st + bt_row(lane)) * kLD +
                                          32 * half + 16 * dp + bt_col(lane)));
          mma_bf16(sreg[2 * dp], ah, bv[0], bv[1]);
          mma_bf16(sreg[2 * dp + 1], ah, bv[2], bv[3]);
          mma_bf16(sreg[2 * dp], al, bv[0], bv[1]);
          mma_bf16(sreg[2 * dp + 1], al, bv[2], bv[3]);
        }
      }
      store_state_split();
    }
  }

  if (s_out) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = col0 + 8 * nt;
      *reinterpret_cast<float2*>(s_out + sbase + (size_t)i0 * kDH + col) =
          make_float2(sreg[nt][0], sreg[nt][1]);
      *reinterpret_cast<float2*>(s_out + sbase + (size_t)(i0 + 8) * kDH +
                                 col) = make_float2(sreg[nt][2], sreg[nt][3]);
    }
  }
}

// cudaFuncSetAttribute once per device: one bit per device in `done`
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

int launch_fma(const void* r, const void* k, const void* v, const void* w,
               const void* u, const void* s0, void* y, void* s_out, int B,
               int S, int H, cudaStream_t stream) {
  dim3 grid(H, B);
  rwkv6_scan_kernel<float><<<grid, kThreads, 0, stream>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)w,
      (const float*)u, (const float*)s0, (float*)y, (float*)s_out, S, H);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_decode(const void* r, const void* k, const void* v, const void* w,
                  const void* u, const void* s0, void* y, void* s_out, int B,
                  int H, cudaStream_t stream) {
  dim3 grid(kDH / kDecCols, H, B);
  rwkv6_scan_decode_kernel<T><<<grid, kDecThreads, 0, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const T*)w, (const float*)u,
      (const float*)s0, (T*)y, (float*)s_out, H);
  return (int)cudaGetLastError();
}

int launch_mma(const void* r, const void* k, const void* v, const void* w,
               const void* u, const void* s0, void* y, void* s_out, int B,
               int S, int H, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = allow_dynamic_smem(
      smem_set, (const void*)rwkv6_scan_mma_kernel, (int)kMmaSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B);
  rwkv6_scan_mma_kernel<<<grid, kWarps * 32, kMmaSmem, stream>>>(
      (const bf16*)r, (const bf16*)k, (const bf16*)v, (const bf16*)w,
      (const float*)u, (const float*)s0, (bf16*)y, (float*)s_out, S, H);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Small-width route: any dh up to 64 other than 64 (the reduced configs'
// 16), prefill and the S = 1 decode, either dtype.  Simple and exact
// first: one block a (b, h) steps t in order with the (dh x dh) state in
// shared memory, as the recurrence reads:
//   y_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t) ;
//   S_t = diag(w_t) S_{t-1} + k_t (x) v_t
// with w floored at 1e-30 as ref.rwkv6_scan_chunked floors it before its
// log (the floor changes nothing the sequential form computes above it).
// fp32 throughout.
// ---------------------------------------------------------------------------

constexpr int kSmallThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kSmallThreads)
rwkv6_scan_small_kernel(const T* __restrict__ r, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ w,
                        const float* __restrict__ u,
                        const float* __restrict__ s0, T* __restrict__ y,
                        float* __restrict__ s_out, int S, int H, int dh) {
  __shared__ float s_s[kDH * kDH];  // [k channel i][v channel j]
  __shared__ float r_s[kDH], k_s[kDH], v_s[kDH], w_s[kDH], u_s[kDH];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int n = dh * dh;
  const size_t sbase = ((size_t)b * H + h) * n;
  const size_t row = (size_t)H * dh;                  // stride of one step
  const size_t base = (size_t)b * S * row + (size_t)h * dh;
  for (int e = tid; e < n; e += kSmallThreads)
    s_s[e] = s0 ? s0[sbase + e] : 0.f;
  if (tid < dh) u_s[tid] = u[(size_t)h * dh + tid];
  for (int t = 0; t < S; ++t) {
    const size_t off = base + (size_t)t * row;
    __syncthreads();  // the previous step's reads are done
    const int c = tid & 63, which = tid >> 6;
    if (c < dh) {
      if (which == 0) r_s[c] = to_float(r[off + c]);
      else if (which == 1) k_s[c] = to_float(k[off + c]);
      else if (which == 2) v_s[c] = to_float(v[off + c]);
      else w_s[c] = fmaxf(to_float(w[off + c]), kFloorW);
    }
    __syncthreads();
    if (tid < dh) {
      const float vj = v_s[tid];
      float acc = 0.f;
      for (int i = 0; i < dh; ++i)
        acc = fmaf(r_s[i], fmaf(u_s[i] * k_s[i], vj, s_s[i * dh + tid]),
                   acc);
      y[off + tid] = from_float<T>(acc);
    }
    __syncthreads();  // y read S_{t-1}
    for (int e = tid; e < n; e += kSmallThreads) {
      const int i = e / dh, j = e % dh;
      s_s[e] = fmaf(s_s[e], w_s[i], k_s[i] * v_s[j]);
    }
  }
  if (s_out) {
    __syncthreads();
    for (int e = tid; e < n; e += kSmallThreads) s_out[sbase + e] = s_s[e];
  }
}

template <typename T>
int launch_small(const void* r, const void* k, const void* v, const void* w,
                 const void* u, const void* s0, void* y, void* s_out, int B,
                 int S, int H, int dh, cudaStream_t stream) {
  rwkv6_scan_small_kernel<T><<<dim3(H, B), kSmallThreads, 0, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const T*)w, (const float*)u,
      (const float*)s0, (T*)y, (float*)s_out, S, H, dh);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Split key width, S = 1, either dtype: one decode step on dk of the dv key
// channels of every head.  r, k, w (B, H, dk), v (B, H, dv) in T; u
// (H, dk) fp32, the slice's bonus; s0, s_out (B, H, dk, dv) fp32, the
// slice's rows of the state; y (B, H, dv) fp32, the slice's part of
//   y[j] = sum_i r_i (S_ij + u_i k_i v_j),   S'_ij = w_i S_ij + k_i v_j
// (i over the slice's keys).  The columns are independent: one thread a
// column j, walking the slice's dk rows in order with the fused
// multiply-adds of `rwkv6_scan_decode_kernel`; a warp's loads and stores of
// a state row are contiguous, and r, k, w, u are read by every thread of a
// block at one address.  dk is small on a rank (4 at rwkv6-1.6b's 64 keys
// over 16 ranks): the kernel is the state's bytes, 2 dk dv fp32 a head.
// ---------------------------------------------------------------------------

constexpr int kSplitThreads = 64;

template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
rwkv6_scan_split_kernel(const T* __restrict__ r, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ w,
                        const float* __restrict__ u,
                        const float* __restrict__ s0, float* __restrict__ y,
                        float* __restrict__ s_out, int H, int dk, int dv) {
  const int j = blockIdx.x * kSplitThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (j >= dv) return;
  const size_t kvec = ((size_t)b * H + h) * dk;    // r, k, w rows
  const size_t vvec = ((size_t)b * H + h) * dv;    // v, y rows
  const size_t sbase = kvec * dv;                  // the (dk x dv) block
  const float vj = to_float(v[vvec + j]);
  float acc = 0.f;
  for (int i = 0; i < dk; ++i) {
    const float ri = to_float(r[kvec + i]), ki = to_float(k[kvec + i]);
    const float wi = to_float(w[kvec + i]), ui = u[(size_t)h * dk + i];
    const size_t e = sbase + (size_t)i * dv + j;
    const float s = s0 ? s0[e] : 0.f;
    const float kv = ki * vj;
    acc = fmaf(ri, fmaf(ui, kv, s), acc);
    s_out[e] = fmaf(s, wi, kv);
  }
  y[vvec + j] = acc;
}

template <typename T>
int launch_split(const void* r, const void* k, const void* v, const void* w,
                 const void* u, const void* s0, void* y, void* s_out, int B,
                 int H, int dk, int dv, cudaStream_t stream) {
  dim3 grid((dv + kSplitThreads - 1) / kSplitThreads, H, B);
  rwkv6_scan_split_kernel<T><<<grid, kSplitThreads, 0, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const T*)w, (const float*)u,
      (const float*)s0, (float*)y, (float*)s_out, H, dk, dv);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w, y).  s0 / s_out may be
// null.  *kernel receives the kernel launched: 0 rwkv6_scan_kernel (fp32,
// S > 1), 1 rwkv6_scan_mma_kernel (bf16, S > 1), 2 rwkv6_scan_decode_kernel
// (S = 1), all at dh = 64; 3 rwkv6_scan_small_kernel (any other dh up to
// 64, any S, either dtype).  Returns cudaGetLastError() after the launch
// (0 on success); -1 for a dh above 64 or a dtype this file does not build.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, const void* s0,
                                 void* y, void* s_out, int B, int S, int H,
                                 int dh, int dtype, int* kernel,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dh < 1 || dh > kDH || (dtype != 0 && dtype != 1)) return -1;
  if (dh != kDH) {
    *kernel = 3;
    return dtype == 0
               ? launch_small<float>(r, k, v, w, u, s0, y, s_out, B, S, H,
                                     dh, st)
               : launch_small<bf16>(r, k, v, w, u, s0, y, s_out, B, S, H, dh,
                                    st);
  }
  if (S == 1) {
    *kernel = 2;
    return dtype == 0
               ? launch_decode<float>(r, k, v, w, u, s0, y, s_out, B, H, st)
               : launch_decode<bf16>(r, k, v, w, u, s0, y, s_out, B, H, st);
  }
  if (dtype == 1) {
    *kernel = 1;
    return launch_mma(r, k, v, w, u, s0, y, s_out, B, S, H, st);
  }
  *kernel = 0;
  return launch_fma(r, k, v, w, u, s0, y, s_out, B, S, H, st);
}

// One decode step on a slice of the key channels (see the file's header):
// r, k, w (B, 1, H, dk) and v (B, 1, H, dv) in the dtype (0 = float32, 1 =
// bfloat16); u (H, dk), s0 and s_out (B, H, dk, dv) fp32, s0 may be null
// (a zero state); y_part (B, 1, H, dv) fp32.  Returns cudaGetLastError()
// after the launch; -1 for dk or dv below 1, dk above dv or a dtype this
// file does not build.
extern "C" int rwkv6_scan_split_launch(const void* r, const void* k,
                                       const void* v, const void* w,
                                       const void* u, const void* s0,
                                       void* y_part, void* s_out, int B,
                                       int H, int dk, int dv, int dtype,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dk < 1 || dv < 1 || dk > dv || (dtype != 0 && dtype != 1)) return -1;
  return dtype == 0 ? launch_split<float>(r, k, v, w, u, s0, y_part, s_out,
                                          B, H, dk, dv, st)
                    : launch_split<bf16>(r, k, v, w, u, s0, y_part, s_out, B,
                                         H, dk, dv, st);
}
