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
// 2 dh = 20.6 kflop.  At zamba2's prefill (B=4, S=1024, H=64, bf16) the
// kernel moves x and y (33.6 MB each) plus B, C and dt (~2 MB): 0.020 ms
// of HBM time, against 0.0055 ms for the state-passing flops at the bf16
// tensor-core rate.
//
// Two kernels; the entry point picks one by dtype and reports which:
//
// * `mamba2_scan_mma_kernel` (bf16: zamba2's prefill).  The chunk products
//   on the tensor cores (`mma.sync.m16n8k16` bf16 -> fp32, operands through
//   `ldmatrix` / `ldmatrix.trans`).  One block of 8 warps per (b, h),
//   walking the chunks in order; warp (half, a) owns chunk rows
//   16a..16a+15 of y and state rows 16a..16a+15 of h, columns 32 half ..
//   32 half + 31 of both; h stays fp32 in registers (the accumulator
//   layout) for the whole sequence.  Warps w and w + 4 share an SM
//   sub-partition and take a and 3 - a, so the causal triangle's work is
//   even across sub-partitions.  Per chunk:
//     1. G = C B^T (rows of sub-chunk a, columns tau <= its last row):
//        both operands exact bf16, one product (the C fragments are kept
//        for step 3);
//     2. att = G o 2^(s_t - s_tau) o dt_tau in G's accumulator fragments,
//        s in log2 units, the exponent selected before the exponential;
//     3. y = 2^s_t (C h_in) + att X + D x: h_in and att are fp32 and go in
//        as bf16 hi + lo, hi = x cut to bf16 (its low 16 bits dropped), lo
//        = bf16(x - hi): two products each (X and C are exact);
//     4. h_out = 2^s_L h_in + (B o wd)^T X, wd_tau = 2^(s_L - s_tau)
//        dt_tau: B o wd is fp32, split, two products.
//   One rounding of h, att or B o wd misses chip_smoke's 2^-12 max|y| or
//   1e-4 state bars (tests/test_torch_scan_design.py).  The exponentials
//   are the MUFU's (`ex2.approx`, subnormals kept).  x, B and C are
//   strided views into the mixer's projection with 128-byte rows: the next
//   chunk's rows arrive by `cp.async` (16 bytes a thread; the wrapper
//   checks 16-byte alignment), one tile at each of three points of this
//   chunk's work, and dt by plain loads held in a register across the
//   chunk.
//   Resources (ptxas -v, CUDA 12.8): 128 registers (capped for two blocks
//   an SM), no spills; 93 440 bytes of dynamic shared memory: two blocks
//   an SM, so all 256 blocks of B=4, H=64 are resident on 132 SMs.
//
// * `mamba2_scan_kernel` (fp32: the reduced fp32 models and the fp32
//   checks).  The first port's design: 256 threads, x, B, C, the (L x L)
//   weights and the fp32 state in shared memory, every (64 x 64) product a
//   16 x 16 thread grid with 4 x 4 register tiles of fp32 FMAs.
//
// Any other dh, ds up to 64 (the reduced configs' 8), either dtype, takes
// `mamba2_scan_small_kernel`, the small-width route at the end of this
// file: one block a (b, h) stepping t, the state in shared memory.
//
// Layouts: x, y (B, S, H, dh) with x given by its batch and step strides
// (elements; head stride dh, channel stride 1), y contiguous; Bmat, Cmat
// (B, S, ds) by their batch and step strides (channel stride 1); x, y,
// Bmat, Cmat share T (float or __nv_bfloat16).  dt (B, S, H), A, D (H,),
// h0, h_out (B, H, ds, dh) are fp32 and contiguous; h0 and h_out may be
// null.  Arithmetic is fp32 outside the tensor cores; build without
// --use_fast_math / -ftz.

#include <atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// fp32: FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kL = 64;           // chunk length
constexpr int kDH = 64;          // head size this file builds
constexpr int kDS = 64;          // state size this file builds
constexpr int kThreads = 256;    // 16 x 16, a 4 x 4 tile each
constexpr int kP = kDS + 1;      // padded row of B, C and att (bank spread)
// one loader and one fused (att x | C h) loop serve all three extents
static_assert(kL == kDH && kL == kDS, "L, dh and ds must be equal");

constexpr size_t kSmemFloats =
    (size_t)kL * kDH +     // x_s
    (size_t)kL * kP * 3 +  // b_s, c_s, att_s
    (size_t)kDS * kDH +    // h_s
    (size_t)kL * 4;        // dt_s, s_s, es_s, wd_s

__global__ void __launch_bounds__(kThreads, 2)
mamba2_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const float* __restrict__ Bm,
                   const float* __restrict__ Cm, const float* __restrict__ Dv,
                   const float* __restrict__ h0, float* __restrict__ y,
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

  const float* xb = x + (size_t)b * x_sb + (size_t)h * kDH;
  const float* bb = Bm + (size_t)b * b_sb;
  const float* cb = Cm + (size_t)b * c_sb;
  float* yb = y + ((size_t)b * S * H + h) * kDH;     // y is contiguous
  const size_t y_ss = (size_t)H * kDH;

  for (int t0 = 0; t0 < S; t0 += kL) {
    const int n = min(kL, S - t0);
    __syncthreads();  // the previous chunk is consumed and h_s written
    for (int e = tid; e < kL * kDH; e += kThreads) {
      const int t = e / kDH, d = e % kDH;
      const bool ok = t < n;
      const size_t ts = (size_t)(t0 + t);
      x_s[e] = ok ? xb[ts * x_ss + d] : 0.f;
      b_s[t * kP + d] = ok ? bb[ts * b_ss + d] : 0.f;
      c_s[t * kP + d] = ok ? cb[ts * c_ss + d] : 0.f;
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
          yb[(size_t)(t0 + t) * y_ss + d] = out;
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


// ---------------------------------------------------------------------------
// bf16: the chunk products on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;          // (column half, 16 chunk rows)
constexpr int kLD = kDH + 8;       // padded bf16 row (ldmatrix: no conflicts)
constexpr int kTile = kL * kLD;    // one (64 x kLD) bf16 tile
constexpr size_t kMmaSmem =
    sizeof(bf16) * (2 * 3 * kTile      // x, B, C: two stages
                    + 4 * kTile)       // h_in and B o wd, hi and lo
    + sizeof(float) * (2 * kL + 3 * kL);  // dt (two stages), s, exp(s), wd

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
// 2^x on the MUFU, subnormals kept (no .ftz), within ~2 ulp; 2^-inf = +0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f;

// Fragment layouts of mma.m16n8k16 (lane = 4 * g + q):
//   A (16x16): a0 = (row g, cols 2q, 2q+1), a1 = (g+8, 2q..), a2 = (g,
//              2q+8..), a3 = (g+8, 2q+8..);
//   B (16x8):  b0 = (k 2q, 2q+1; n g), b1 = (k 2q+8, 2q+9; n g);
//   C (16x8):  c0, c1 = (row g, cols 2q, 2q+1), c2, c3 = (row g+8, ...).
// ldmatrix addresses (lane l supplies one row of matrix l >> 3), as
// (row, col) offsets from the fragment's corner:
//   A from a row-major [m][k] tile:  (l & 15, (l >> 4) 8);
//   A from a [k][m] tile, .trans, and B (n-tiles n0, n0 + 8) from an
//   [n][k] tile:                     ((l & 7) + (l >> 4) 8, ((l >> 3) & 1) 8);
//   B (n-tiles n0, n0 + 8) from a [k][n] tile, .trans:
//                                    ((l & 7) + ((l >> 3) & 1) 8, (l >> 4) 8).
__device__ __forceinline__ int lm_row_a(int l) { return l & 15; }
__device__ __forceinline__ int lm_col_a(int l) { return (l >> 4) << 3; }
__device__ __forceinline__ int lm_row_n(int l) {  // A .trans, B from [n][k]
  return (l & 7) + ((l >> 4) << 3);
}
__device__ __forceinline__ int lm_col_n(int l) { return ((l >> 3) & 1) << 3; }
__device__ __forceinline__ int lm_row_t(int l) {  // B from [k][n], .trans
  return (l & 7) + (((l >> 3) & 1) << 3);
}
__device__ __forceinline__ int lm_col_t(int l) { return (l >> 4) << 3; }

__global__ void __launch_bounds__(kWarps * 32, 2)
mamba2_scan_mma_kernel(const bf16* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const bf16* __restrict__ Bm,
                       const bf16* __restrict__ Cm,
                       const float* __restrict__ Dv,
                       const float* __restrict__ h0, bf16* __restrict__ y,
                       float* __restrict__ h_out, int S, int H,
                       long long x_sb, long long x_ss, long long b_sb,
                       long long b_ss, long long c_sb, long long c_ss) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* stage = reinterpret_cast<bf16*>(smem_raw);  // [2][x B C][64][kLD]
  bf16* h_hi = stage + 2 * 3 * kTile;   // h_in split, [s][d]
  bf16* h_lo = h_hi + kTile;
  bf16* bw_hi = h_lo + kTile;           // B_tau o wd_tau split, [tau][s]
  bf16* bw_lo = bw_hi + kTile;
  float* dt_s = reinterpret_cast<float*>(bw_lo + kTile);  // [2][kL]
  float* s_s = dt_s + 2 * kL;           // cumulative log-decay, inclusive
  float* es_s = s_s + kL;               // exp(s_t)
  float* wd_s = es_s + kL;              // exp(s_L - s_t) dt_t

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  // warp = (half, a): chunk rows 16a .. 16a + 15 of y and state rows 16a ..
  // 16a + 15 of h, columns 32 half .. 32 half + 31 of both; warps w and
  // w + 4 share an SM sub-partition and take a and 3 - a, so the causal
  // triangle's work is even across sub-partitions
  const int half = warp >> 2;
  const int a = half ? 3 - (warp & 3) : warp & 3;
  const float a2 = A[h] * kLog2e;   // the decays in log2 units
  const float d_h = Dv[h];
  const size_t hbase = ((size_t)b * H + h) * kDS * kDH;
  const bf16* xb = x + (size_t)b * x_sb + (size_t)h * kDH;
  const bf16* bb = Bm + (size_t)b * b_sb;
  const bf16* cb = Cm + (size_t)b * c_sb;
  const size_t y_ss = (size_t)H * kDH;
  bf16* yb = y + (size_t)b * S * y_ss + (size_t)h * kDH;  // y is contiguous
  const int n_chunks = (S + kL - 1) / kL;

  // one tile (x, B or C) of chunk c, rows past S zero-filled.  The next
  // chunk's tiles are issued at three points of this chunk's work: issued
  // together, every block's 24 KB arrive as one burst that stalls the
  // issuing warps
  auto load_tile = [&](int c, int tile) {
    const int t0 = c * kL;
    bf16* st = stage + ((c & 1) * 3 + tile) * kTile;
    const bf16* src = tile == 0 ? xb : tile == 1 ? bb : cb;
    const long long ss = tile == 0 ? x_ss : tile == 1 ? b_ss : c_ss;
#pragma unroll
    for (int e = tid; e < kL * 8; e += kWarps * 32) {
      const int row = e >> 3, piece = e & 7;
      const bool ok = t0 + row < S;
      const size_t off = ok ? (size_t)(t0 + row) * ss + piece * 8 : 0;
      cp_async16(smem_addr(st + row * kLD + piece * 8), src + off,
                 ok ? 16 : 0);
    }
  };
  auto load_dt = [&](int c) {     // this thread's step of chunk c, 0 past S
    const int t = c * kL + tid;
    return tid < kL && t < S ? dt[((size_t)b * S + t) * H + h] : 0.f;
  };

  // the state: warp (half, a) holds rows s = 16a + g (c0, c1) and + 8 (c2,
  // c3), columns 32 half + 8 nt + 2q (+1), nt < 4, in fp32 throughout
  const int i0 = a * 16 + g;
  const int col0 = 32 * half + 2 * q;
  float hreg[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    float2 lo = make_float2(0.f, 0.f), hi8 = lo;
    if (h0) {
      lo = *reinterpret_cast<const float2*>(h0 + hbase + (size_t)i0 * kDH +
                                            col0 + 8 * nt);
      hi8 = *reinterpret_cast<const float2*>(
          h0 + hbase + (size_t)(i0 + 8) * kDH + col0 + 8 * nt);
    }
    hreg[nt][0] = lo.x; hreg[nt][1] = lo.y;
    hreg[nt][2] = hi8.x; hreg[nt][3] = hi8.y;
  }
  auto store_state_split = [&]() {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = col0 + 8 * nt;
      uint32_t hi, lo;
      split_bf16(hreg[nt][0], hreg[nt][1], hi, lo);
      *reinterpret_cast<uint32_t*>(h_hi + i0 * kLD + col) = hi;
      *reinterpret_cast<uint32_t*>(h_lo + i0 * kLD + col) = lo;
      split_bf16(hreg[nt][2], hreg[nt][3], hi, lo);
      *reinterpret_cast<uint32_t*>(h_hi + (i0 + 8) * kLD + col) = hi;
      *reinterpret_cast<uint32_t*>(h_lo + (i0 + 8) * kLD + col) = lo;
    }
  };

#pragma unroll
  for (int tile = 0; tile < 3; ++tile) load_tile(0, tile);
  cp_async_commit();
  if (tid < kL) dt_s[tid] = load_dt(0);
  store_state_split();

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<0>();  // chunk c has landed
    __syncthreads();     // ... for every thread; every read of chunk c - 1's
                         // buffers is done; h_in's split is written
    const bool more = c + 1 < n_chunks;  // into the stage chunk c - 1 used
    if (more) load_tile(c + 1, 0);
    const float dt_next = load_dt(c + 1);  // lands while this chunk runs
    const bf16* xs = stage + (c & 1) * 3 * kTile;
    const bf16* bs = xs + kTile;
    const bf16* cs = bs + kTile;
    const float* dtc = dt_s + (c & 1) * kL;
    const int t0 = c * kL;
    const int n = min(kL, S - t0);
    const int row0 = a * 16 + g;      // chunk rows of c0/c1; c2/c3: + 8

    // -- 1. G = C B^T for the warp's rows, columns tau <= its last row
    uint32_t cf[4][4];                // C's A-fragments, k-steps of ds
#pragma unroll
    for (int st = 0; st < 4; ++st)
      ldmatrix_x4(cf[st], smem_addr(cs + (a * 16 + lm_row_a(lane)) * kLD +
                                    16 * st + lm_col_a(lane)));
    float att[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) att[nt][e] = 0.f;
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (np > a) continue;
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        uint32_t bk[4];
        ldmatrix_x4(bk, smem_addr(bs + (16 * np + lm_row_n(lane)) * kLD +
                                  16 * st + lm_col_n(lane)));
        mma_bf16(att[2 * np], cf[st], bk[0], bk[1]);
        mma_bf16(att[2 * np + 1], cf[st], bk[2], bk[3]);
      }
    }

    // the chunk's cumulative decay (log2 units): one warp scan, 2 steps a
    // lane
    if (warp == 0) {
      const float a0 = a2 * dtc[2 * lane], a1 = a2 * dtc[2 * lane + 1];
      const float p1 = a0 + a1;
      float incl = p1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      const float excl = incl - p1;
      const float s0v = excl + a0, s1v = incl;
      const float s_last = __shfl_sync(0xffffffffu, incl, 31);
      s_s[2 * lane] = s0v;
      s_s[2 * lane + 1] = s1v;
      es_s[2 * lane] = fast_exp2(s0v);
      es_s[2 * lane + 1] = fast_exp2(s1v);
      wd_s[2 * lane] = fast_exp2(s_last - s0v) * dtc[2 * lane];
      wd_s[2 * lane + 1] = fast_exp2(s_last - s1v) * dtc[2 * lane + 1];
    }
    __syncthreads();     // s, exp(s), wd are written
    if (more) load_tile(c + 1, 1);

    // B o wd, split, for the state update (read after the next barrier)
#pragma unroll 2
    for (int e = tid; e < kL * (kDS / 2); e += kWarps * 32) {
      const int t = e >> 5, cp = (e & 31) * 2;
      const float2 bv = unpack_bf16(ld32(bs + t * kLD + cp));
      const float wt = wd_s[t];
      uint32_t hi, lo;
      split_bf16(bv.x * wt, bv.y * wt, hi, lo);
      *reinterpret_cast<uint32_t*>(bw_hi + t * kLD + cp) = hi;
      *reinterpret_cast<uint32_t*>(bw_lo + t * kLD + cp) = lo;
    }

    // -- 2. att = G o exp(s_t - s_tau) o dt_tau, tau <= t (exponent first)
    const float st0 = s_s[row0], st1 = s_s[row0 + 8];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt > 2 * a + 1) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = row0 + 8 * (e >> 1);
        const int tau = 8 * nt + 2 * q + (e & 1);
        const float ex = tau <= t ? (e >> 1 ? st1 : st0) - s_s[tau]
                                  : -INFINITY;
        att[nt][e] *= fast_exp2(ex) * dtc[tau];     // exp(-inf) = 0
      }
    }

    // -- 3. y = exp(s_t) (C h_in) + att X + D x, columns 32 half .. + 31
    float o[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
#pragma unroll
    for (int st = 0; st < 4; ++st) {
#pragma unroll
      for (int dp = 0; dp < 2; ++dp) {
        uint32_t bh[4], bl[4];
        const int off = (16 * st + lm_row_t(lane)) * kLD + 32 * half +
                        16 * dp + lm_col_t(lane);
        ldmatrix_x4_trans(bh, smem_addr(h_hi + off));
        ldmatrix_x4_trans(bl, smem_addr(h_lo + off));
        mma_bf16(o[2 * dp], cf[st], bh[0], bh[1]);
        mma_bf16(o[2 * dp + 1], cf[st], bh[2], bh[3]);
        mma_bf16(o[2 * dp], cf[st], bl[0], bl[1]);
        mma_bf16(o[2 * dp + 1], cf[st], bl[2], bl[3]);
      }
    }
    {
      const float e0 = es_s[row0], e1 = es_s[row0 + 8];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        o[nt][0] *= e0; o[nt][1] *= e0;
        o[nt][2] *= e1; o[nt][3] *= e1;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk > a) continue;
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)   // a0..a3: (tile 2kk | 2kk+1, row g | g+8)
        split_bf16(att[2 * kk + (e >> 1)][2 * (e & 1)],
                   att[2 * kk + (e >> 1)][2 * (e & 1) + 1], ph[e], pl[e]);
#pragma unroll
      for (int dp = 0; dp < 2; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, smem_addr(xs + (16 * kk + lm_row_t(lane)) * kLD +
                                        32 * half + 16 * dp + lm_col_t(lane)));
        mma_bf16(o[2 * dp], ph, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], ph, bv[2], bv[3]);
        mma_bf16(o[2 * dp], pl, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pl, bv[2], bv[3]);
      }
    }
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int t = row0 + 8 * e2;
      if (t < n) {
        bf16* yr = yb + (size_t)(t0 + t) * y_ss;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int d = col0 + 8 * nt;
          const float2 xv = unpack_bf16(ld32(xs + t * kLD + d));
          *reinterpret_cast<__nv_bfloat162*>(yr + d) = __floats2bfloat162_rn(
              fmaf(d_h, xv.x, o[nt][2 * e2]),
              fmaf(d_h, xv.y, o[nt][2 * e2 + 1]));
        }
      }
    }
    __syncthreads();     // h_in's split is read; B o wd is written
    if (more) {
      load_tile(c + 1, 2);
      cp_async_commit();
    }

    // -- 4. h_out = exp(s_L) h_in + (B o wd)^T X for the warp's rows and
    //    column half: the decay first, then two products over the steps
    {
      const float decay_all = fast_exp2(s_s[kL - 1]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) hreg[nt][e] *= decay_all;
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        uint32_t ah[4], al[4];
        const int aoff = (16 * st + lm_row_n(lane)) * kLD + 16 * a +
                         lm_col_n(lane);
        ldmatrix_x4_trans(ah, smem_addr(bw_hi + aoff));
        ldmatrix_x4_trans(al, smem_addr(bw_lo + aoff));
#pragma unroll
        for (int dp = 0; dp < 2; ++dp) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, smem_addr(xs + (16 * st + lm_row_t(lane)) *
                                                   kLD +
                                          32 * half + 16 * dp +
                                          lm_col_t(lane)));
          mma_bf16(hreg[2 * dp], ah, bv[0], bv[1]);
          mma_bf16(hreg[2 * dp + 1], ah, bv[2], bv[3]);
          mma_bf16(hreg[2 * dp], al, bv[0], bv[1]);
          mma_bf16(hreg[2 * dp + 1], al, bv[2], bv[3]);
        }
      }
      store_state_split();
    }
    if (tid < kL) dt_s[((c + 1) & 1) * kL + tid] = dt_next;
  }

  if (h_out) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = col0 + 8 * nt;
      *reinterpret_cast<float2*>(h_out + hbase + (size_t)i0 * kDH + col) =
          make_float2(hreg[nt][0], hreg[nt][1]);
      *reinterpret_cast<float2*>(h_out + hbase + (size_t)(i0 + 8) * kDH +
                                 col) = make_float2(hreg[nt][2], hreg[nt][3]);
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

int launch_fma(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, const void* D, const void* h0, void* y,
               void* h_out, int B, int S, int H, long long x_sb,
               long long x_ss, long long b_sb, long long b_ss,
               long long c_sb, long long c_ss, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kSmemFloats;
  static std::atomic<unsigned long long> smem_set{0};
  auto kernel = mamba2_scan_kernel;
  cudaError_t err = allow_dynamic_smem(smem_set, (const void*)kernel,
                                       (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const float*)x, (const float*)dt, (const float*)A, (const float*)Bm,
      (const float*)Cm, (const float*)D, (const float*)h0, (float*)y,
      (float*)h_out, S, H, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss);
  return (int)cudaGetLastError();
}

int launch_mma(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, const void* D, const void* h0, void* y,
               void* h_out, int B, int S, int H, long long x_sb,
               long long x_ss, long long b_sb, long long b_ss,
               long long c_sb, long long c_ss, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = allow_dynamic_smem(
      smem_set, (const void*)mamba2_scan_mma_kernel, (int)kMmaSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B);
  mamba2_scan_mma_kernel<<<grid, kWarps * 32, kMmaSmem, stream>>>(
      (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)Bm,
      (const bf16*)Cm, (const float*)D, (const float*)h0, (bf16*)y,
      (float*)h_out, S, H, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Small-width route: any dh, ds up to 64 other than dh = ds = 64 (the
// reduced configs' dh = ds = 8), in either dtype.  Simple and exact first:
// one block a (b, h) steps t in order with the (ds x dh) state in shared
// memory, as the recurrence reads:
//   h_t = exp(A dt_t) h_{t-1} + (dt_t B_t) (x) x_t ;  y_t = C_t . h_t + D x_t
// The decay's exponent A dt_t is a single step's, so no positive exponent
// can reach exp (the chunked form's guard selects the exponent for the
// same reason).  fp32 throughout; x, B, C by their strides.
// ---------------------------------------------------------------------------

constexpr int kSmallThreads = 256;
constexpr int kSmallMax = 64;  // the widest dh and ds this route takes

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kSmallThreads)
mamba2_scan_small_kernel(const T* __restrict__ x,
                         const float* __restrict__ dt,
                         const float* __restrict__ A,
                         const T* __restrict__ Bm, const T* __restrict__ Cm,
                         const float* __restrict__ Dv,
                         const float* __restrict__ h0, T* __restrict__ y,
                         float* __restrict__ h_out, int S, int H, int dh,
                         int ds, long long x_sb, long long x_ss,
                         long long b_sb, long long b_ss, long long c_sb,
                         long long c_ss) {
  __shared__ float h_s[kSmallMax * kSmallMax];  // [s][d]
  __shared__ float x_s[kSmallMax], b_s[kSmallMax], c_s[kSmallMax];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const float a_h = A[h], d_h = Dv[h];
  const int n = ds * dh;
  const size_t hbase = ((size_t)b * H + h) * n;
  for (int e = tid; e < n; e += kSmallThreads)
    h_s[e] = h0 ? h0[hbase + e] : 0.f;
  const T* xb = x + (size_t)b * x_sb + (size_t)h * dh;
  const T* bb = Bm + (size_t)b * b_sb;
  const T* cb = Cm + (size_t)b * c_sb;
  const size_t y_ss = (size_t)H * dh;                 // y is contiguous
  T* yb = y + (size_t)b * S * y_ss + (size_t)h * dh;
  for (int t = 0; t < S; ++t) {
    __syncthreads();  // the previous step's reads are done
    if (tid < dh)
      x_s[tid] = to_float(xb[(size_t)t * x_ss + tid]);
    else if (tid >= 64 && tid - 64 < ds)
      b_s[tid - 64] = to_float(bb[(size_t)t * b_ss + tid - 64]);
    else if (tid >= 128 && tid - 128 < ds)
      c_s[tid - 128] = to_float(cb[(size_t)t * c_ss + tid - 128]);
    const float dtv = dt[((size_t)b * S + t) * H + h];
    const float ea = expf(a_h * dtv);
    __syncthreads();
    for (int e = tid; e < n; e += kSmallThreads) {
      const int s = e / dh, d = e % dh;
      h_s[e] = fmaf(h_s[e], ea, b_s[s] * dtv * x_s[d]);
    }
    __syncthreads();
    if (tid < dh) {
      float acc = 0.f;
      for (int s = 0; s < ds; ++s) acc = fmaf(c_s[s], h_s[s * dh + tid], acc);
      yb[(size_t)t * y_ss + tid] = from_float<T>(fmaf(d_h, x_s[tid], acc));
    }
  }
  if (h_out) {
    __syncthreads();
    for (int e = tid; e < n; e += kSmallThreads) h_out[hbase + e] = h_s[e];
  }
}

template <typename T>
int launch_small(const void* x, const void* dt, const void* A,
                 const void* Bm, const void* Cm, const void* D,
                 const void* h0, void* y, void* h_out, int B, int S, int H,
                 int dh, int ds, long long x_sb, long long x_ss,
                 long long b_sb, long long b_ss, long long c_sb,
                 long long c_ss, cudaStream_t stream) {
  mamba2_scan_small_kernel<T><<<dim3(H, B), kSmallThreads, 0, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
      (const T*)Cm, (const float*)D, (const float*)h0, (T*)y,
      (float*)h_out, S, H, dh, ds, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, Bmat, Cmat, y).  Strides are in
// elements; for bf16, x, Bmat and Cmat and their strides must be 16-byte
// aligned (the wrapper checks).  h0 / h_out may be null.  *kernel receives
// the kernel launched: 0 mamba2_scan_kernel (fp32), 1
// mamba2_scan_mma_kernel (bf16), both at dh = ds = 64; 2
// mamba2_scan_small_kernel (either dtype, any other dh, ds up to 64).
// Returns cudaGetLastError() after the launch (0 on success); -1 for a dh
// or ds above 64 or a dtype this file does not build.
extern "C" int mamba2_scan_launch(const void* x, const void* dt,
                                  const void* A, const void* Bm,
                                  const void* Cm, const void* D,
                                  const void* h0, void* y, void* h_out, int B,
                                  int S, int H, int dh, int ds,
                                  long long x_sb, long long x_ss,
                                  long long b_sb, long long b_ss,
                                  long long c_sb, long long c_ss, int dtype,
                                  int* kernel, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dh < 1 || dh > kSmallMax || ds < 1 || ds > kSmallMax ||
      (dtype != 0 && dtype != 1))
    return -1;
  if (dh != kDH || ds != kDS) {
    *kernel = 2;
    return dtype == 0
               ? launch_small<float>(x, dt, A, Bm, Cm, D, h0, y, h_out, B, S,
                                     H, dh, ds, x_sb, x_ss, b_sb, b_ss, c_sb,
                                     c_ss, st)
               : launch_small<bf16>(x, dt, A, Bm, Cm, D, h0, y, h_out, B, S,
                                    H, dh, ds, x_sb, x_ss, b_sb, b_ss, c_sb,
                                    c_ss, st);
  }
  if (dtype == 0) {
    *kernel = 0;
    return launch_fma(x, dt, A, Bm, Cm, D, h0, y, h_out, B, S, H, x_sb, x_ss,
                      b_sb, b_ss, c_sb, c_ss, st);
  }
  if (dtype == 1) {
    *kernel = 1;
    return launch_mma(x, dt, A, Bm, Cm, D, h0, y, h_out, B, S, H, x_sb, x_ss,
                      b_sb, b_ss, c_sb, c_ss, st);
  }
  return -1;
}
