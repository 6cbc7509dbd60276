// Mamba2 SSD selective scan (n_groups = 1), backward (K3-bwd), bf16 route:
// chunk-parallel on the tensor cores, for Hopper (sm_90a).
//
// The gradient of K3's function (csrc/mamba2_scan.cu; the function of
// src/repro/kernels/ref.py::mamba2_scan with its h0 / return_state
// contract), for bf16 x, B, C and dy at dh = ds = 64 (zamba2-1.2b's
// training shape):
//   h_t = exp(a_t) h_{t-1} + dt_t B_t (x) x_t,  a_t = A dt_t
//   y_t = C_t . h_t + D x_t
// Replaces: no TPU kernel.  The Pallas kernel
// (src/repro/kernels/mamba2_scan.py:69) has no backward; JAX trains
// through jax.vjp of its chunked jnp reference (ref.py:214).  The fp32
// route stays csrc/mamba2_scan_bwd.cu (sequential, CUDA cores).
//
// Chunks of L = 64 steps; per chunk, s_t is the inclusive cumulative sum
// of a over the chunk (log2 units here), wd_tau = e^(s_L - s_tau) dt_tau,
//   att[m, tau] = (C_m . B_tau) e^(s_m - s_tau) dt_tau     (tau <= m)
//   M[m, tau]   = e^(s_m - s_tau) dt_tau (dy_m . x_tau)     (tau <= m)
// with the exponent selected before exp (tau <= m only), as K3 does.
// Three phases, sequential only between chunks:
//   A and B. `mamba2_scan_bwd_state_kernel`, one block a (b, h), walks the
//      chunks: h_in of chunk c + 1 = e^(s_L) h_in(c) + (B o wd)^T X
//      forwards from h0, and G_out of chunk c - 1 = e^(s_L) G_out(c) + C^T
//      (e^s o dY) backwards from dh_out (dh0 = the first chunk's G_in),
//      each chunk one 64 x 64 x 64 product (the forward's chunk-state
//      product) added to the state in the mma accumulators; the two walks
//      interleave, and the next chunk's tiles arrive by cp.async while
//      this one computes.  Every h_in and G_out goes to scratch;
//   C. `mamba2_scan_bwd_chunk_kernel`, one block a (b, h, chunk), all
//      independent: from h_in and G_out alone,
//        dx  = att^T dY + wd o (B G_out) + D dY
//        dBh = M^T C + wd o (X G_out^T)              (this head's part)
//        dCh = e^s o (dY h_in^T) + M B               (this head's part)
//        ddt = colsum(CB o E o DYX) + e^(s_L - s) o u + A da
//      with u_tau = B_tau^T G_out x_tau, v_m = C_m^T h_in . dy_m, and the
//      decay's gradient in the direct form, split exactly over the chunk
//      (every exponent <= 0, nothing subtracted):
//        da_t = e^(s_L) <G_out, h_in> + sum_{tau<t} wd_tau u_tau
//             + sum_{m>=t} e^(s_m) v_m
//             + sum_{m>=t} sum_{tau<t} att[m, tau] (dy_m . x_tau)
//      the last term a row prefix over tau of the fragments (shuffles in a
//      fixed order), then a column sum over m >= t.  The identity that the
//      usual chunked SSD backward takes (reverse cumulative sums) loses
//      digits (tests/test_torch_scan_bwd_design.py).
//   `mamba2_scan_bwd_sum_kernel` then adds dB, dC over the heads and dA,
//   dD over the batch and chunks, each in a fixed order: no atomics,
//   reruns are bitwise.
// Products: `mma.sync.m16n8k16` bf16 -> fp32, operands from shared memory
// by `ldmatrix` (64 x 64 bf16 tiles, 16-byte chunks XOR-swizzled by row:
// conflict-free, no padding); 8 warps, each a 16 x 32 block of the 64 x 64
// output.  x, B, C, dy are exact bf16 operands; an fp32 operand (B o wd,
// e^s o dY, att, M, G_out, h_in) goes in as bf16 hi (x cut to bf16) + lo
// (bf16(x - hi)): two products.  The CPU models show every product
// rounded once still holds chip_smoke's bf16 bar, the splits keeping the
// gradients within about a bf16 ulp of the plain backward.
// What bounds it: bytes.  At B=4, S=1024, H=64 the inputs and outputs are
// 105 MB (0.031 ms at 3.35 TB/s); the scratch moves more: h_in and G_out
// (2 x 67 MB, written by A/B, read by C) and the heads' parts of dB and dC
// (2 x 67 MB fp32, written by C, read by the sum), the next floor.  The
// products are 14 64^3 products a (b, h, chunk) in C and 4 in A/B: 37
// GFLOP at the training shape, 0.04 ms at the bf16 peak.
// Resources (ptxas -v, CUDA 12.8): the state walk 127 registers, no
// spills, 101 376 bytes of dynamic shared memory; the chunk kernel 128
// registers (capped for two blocks an SM), 8 bytes spilled, 103 000 bytes;
// the sum 32 registers.  Two blocks an SM for both.
//
// Layouts: x (B, S, H, dh) by its batch and step strides (head stride dh,
// channel stride 1); Bmat, Cmat (B, S, ds) by theirs (channel stride 1);
// base pointers and strides 16-byte aligned (the wrapper checks); dy, dx
// (B, S, H, dh) contiguous; dt, ddt (B, S, H), A, D, dA, dD (H,), h0,
// dh_out, dh0 (B, H, ds, dh) fp32 contiguous (h0, dh_out, dh0 may be
// null).  Scratch (fp32): dBh, dCh (B, S, H, ds), hs, gs (B, H, nC, ds,
// dh), dA_part, dD_part (B, H, nC).  Arithmetic is fp32 outside the
// tensor cores; build without --use_fast_math / -ftz.

#include <atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kL = 64;             // chunk length
constexpr int kDH = 64;            // head size this file builds
constexpr int kDS = 64;            // state size this file builds
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64 * 64;     // one 64 x 64 bf16 tile, swizzled
constexpr int kState = kDS * kDH;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kL == kDH && kL == kDS, "one tile shape serves every product");

// ---------------------------------------------------------------------------
// shared helpers
// ---------------------------------------------------------------------------

// element offset of (row, col) in a swizzled 64 x 64 bf16 tile: the 16-byte
// chunk col / 8 of a row moves to chunk (col / 8) ^ (row % 8), so the 8
// rows an ldmatrix reads at one column hit 8 different bank groups
__device__ __forceinline__ int swz(int row, int col) {
  return row * 64 + ((((col >> 3) ^ row) & 7) << 3) + (col & 7);
}

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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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
// dropped), lo = bf16((x, y) - hi), the difference exact in fp32
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t xb = __float_as_uint(x), yb = __float_as_uint(y);
  hi = __byte_perm(xb, yb, 0x7632);
  lo = pack_bf16(x - __uint_as_float(xb & 0xffff0000u),
                 y - __uint_as_float(yb & 0xffff0000u));
}
// 2^x on the MUFU, subnormals kept (no .ftz); 2^-inf = +0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// acc += A B over K = 64 for this warp's 16 x 32 block (rows m0.., columns
// n0..; acc[nt] the n-tile n0 + 8 nt).  A (64 x 64) is stored [m][k], or
// [k][m] with A_KM; B (64 x 64) is stored [n][k], or [k][n] with B_KN.
// Fragment layouts of mma.m16n8k16 (lane = 4 g + q): C (16x8): c0, c1 =
// (row g, cols 2q, 2q+1), c2, c3 = (row g + 8, ...).  ldmatrix addresses
// (lane l supplies one row of matrix l >> 3):
//   A from [m][k]: (m0 + (l & 15), k0 + (l >> 4) 8);
//   A from [k][m], .trans: (k0 + (l & 7) + (l >> 4) 8, m0 + ((l >> 3) & 1) 8);
//   B, n-tiles n0 and n0 + 8, from [n][k]: (n0 + (l & 7) + (l >> 4) 8,
//     k0 + ((l >> 3) & 1) 8);
//   B from [k][n], .trans: (k0 + (l & 7) + ((l >> 3) & 1) 8, n0 + (l >> 4) 8).
template <bool A_KM, bool B_KN>
__device__ __forceinline__ void mma64(float (&acc)[4][4], const bf16* A,
                                      const bf16* Bt, int m0, int n0,
                                      int lane) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int k0 = 16 * ks;
    uint32_t a[4];
    if (A_KM)
      ldmatrix_x4_trans(a, smem_addr(A + swz(k0 + (lane & 7) +
                                                 ((lane >> 4) << 3),
                                             m0 + (((lane >> 3) & 1) << 3))));
    else
      ldmatrix_x4(a, smem_addr(A + swz(m0 + (lane & 15),
                                       k0 + ((lane >> 4) << 3))));
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      const int nb = n0 + 16 * np;
      uint32_t b[4];
      if (B_KN)
        ldmatrix_x4_trans(b, smem_addr(Bt + swz(k0 + (lane & 7) +
                                                    (((lane >> 3) & 1) << 3),
                                                nb + ((lane >> 4) << 3))));
      else
        ldmatrix_x4(b, smem_addr(Bt + swz(nb + (lane & 7) +
                                              ((lane >> 4) << 3),
                                          k0 + (((lane >> 3) & 1) << 3))));
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
}

// one 64 x 64 bf16 tile of rows [t0, t0 + 64) by cp.async, rows past S
// zero-filled; row t of the source at src + t * stride (elements)
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int t0, int S,
                                          int tid) {
#pragma unroll
  for (int e = tid; e < 64 * 8; e += kThreads) {
    const int row = e >> 3, piece = e & 7;
    const bool ok = t0 + row < S;
    const size_t off = ok ? (size_t)(t0 + row) * stride + piece * 8 : 0;
    cp_async16(smem_addr(dst + swz(row, piece * 8)), src + off, ok ? 16 : 0);
  }
}

// the chunk's cumulative decay by warp 0, s in log2 units: s_s (inclusive),
// es_s = 2^s, dl_s = 2^(s_L - s), wd_s = dl_s dt; steps past S have dt = 0
__device__ __forceinline__ void chunk_decay(const float* dt_s, float a2,
                                            float* s_s, float* es_s,
                                            float* dl_s, float* wd_s,
                                            int lane) {
  const float a0 = a2 * dt_s[2 * lane], a1 = a2 * dt_s[2 * lane + 1];
  const float p1 = a0 + a1;
  float incl = p1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  const float excl = incl - p1;
  const float sv[2] = {excl + a0, incl};
  const float s_last = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int t = 2 * lane + j;
    s_s[t] = sv[j];
    es_s[t] = fast_exp2(sv[j]);
    dl_s[t] = fast_exp2(s_last - sv[j]);
    wd_s[t] = dl_s[t] * dt_s[t];
  }
}

// split the pair (x, y) into the hi and lo tiles at offset o
__device__ __forceinline__ void put_split(bf16* hi_t, bf16* lo_t, int o,
                                          float x, float y) {
  uint32_t hi, lo;
  split_bf16(x, y, hi, lo);
  *reinterpret_cast<uint32_t*>(hi_t + o) = hi;
  *reinterpret_cast<uint32_t*>(lo_t + o) = lo;
}

// ---------------------------------------------------------------------------
// A and B. the walks over the chunks, the states in registers
// ---------------------------------------------------------------------------

// dynamic shared memory: two stages of 4 tiles (x, B of the forward walk's
// chunk; C, dy of the backward walk's), the split B o wd and e^s o dy, dt
// (two stages x two walks) and each walk's decays
constexpr size_t kStateSmem =
    sizeof(bf16) * 12 * kTile + sizeof(float) * (4 * kL + 2 * 4 * kL);

// One block a (b, h).  Iteration i takes chunk c = i of the forward walk
// and chunk nC - 1 - i of the backward one; the next iteration's tiles
// arrive by cp.async while this one computes.  The state h (rows s,
// columns d) and its gradient G live in the mma accumulators: warp (m0,
// n0) holds rows m0 + g, m0 + g + 8 and columns n0 + 8 nt + 2 q (+ 1).
__global__ void __launch_bounds__(kThreads, 2)
mamba2_scan_bwd_state_kernel(const bf16* __restrict__ x,
                             const float* __restrict__ dt,
                             const float* __restrict__ A,
                             const bf16* __restrict__ Bm,
                             const bf16* __restrict__ Cm,
                             const bf16* __restrict__ dy,
                             const float* __restrict__ h0,
                             const float* __restrict__ dh_out,
                             float* __restrict__ hs, float* __restrict__ gs,
                             float* __restrict__ dh0, int S, int H,
                             long long x_sb, long long x_ss, long long b_sb,
                             long long b_ss, long long c_sb, long long c_ss) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* stage = reinterpret_cast<bf16*>(smem_raw);  // [2][x B C dy][tile]
  bf16* bw_hi = stage + 8 * kTile;                  // B o wd, [t][s]
  bf16* bw_lo = bw_hi + kTile;
  bf16* ey_hi = bw_lo + kTile;                      // e^s o dy, [t][d]
  bf16* ey_lo = ey_hi + kTile;
  float* dt_s = reinterpret_cast<float*>(ey_lo + kTile);  // [2][2 walks][kL]
  float* dec_s = dt_s + 4 * kL;     // [2 walks][s, 2^s, 2^(s_L - s), wd]

  const int h = blockIdx.x, b = blockIdx.y;
  const int nC = (S + kL - 1) / kL;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int m0 = 16 * (warp & 3), n0 = 32 * (warp >> 2);
  const float a2 = A[h] * kLog2e;
  const size_t y_ss = (size_t)H * kDH;
  const bf16* xb = x + (size_t)b * x_sb + (size_t)h * kDH;
  const bf16* bb = Bm + (size_t)b * b_sb;
  const bf16* cb = Cm + (size_t)b * c_sb;
  const bf16* yb = dy + (size_t)b * S * y_ss + (size_t)h * kDH;
  const size_t bh = (size_t)b * H + h;

  auto issue = [&](int i) {         // iteration i's tiles and dt
    const int ch = i, cg = nC - 1 - i;
    bf16* st = stage + (i & 1) * 4 * kTile;
    load_tile(st, xb, x_ss, ch * kL, S, tid);
    load_tile(st + kTile, bb, b_ss, ch * kL, S, tid);
    load_tile(st + 2 * kTile, cb, c_ss, cg * kL, S, tid);
    load_tile(st + 3 * kTile, yb, (long long)y_ss, cg * kL, S, tid);
    cp_async_commit();
    if (tid < 2 * kL) {
      const int walk = tid >> 6, tt = tid & 63;
      const int t = (walk ? cg : ch) * kL + tt;
      dt_s[((i & 1) * 2 + walk) * kL + tt] =
          t < S ? dt[((size_t)b * S + t) * H + h] : 0.f;
    }
  };

  float hreg[4][4], greg[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const size_t o = bh * kState + (size_t)(m0 + g + 8 * hh) * kDH + n0 +
                       8 * nt + 2 * q;
      const float2 hv = h0 ? *reinterpret_cast<const float2*>(h0 + o)
                           : make_float2(0.f, 0.f);
      const float2 gv = dh_out ? *reinterpret_cast<const float2*>(dh_out + o)
                               : make_float2(0.f, 0.f);
      hreg[nt][2 * hh] = hv.x; hreg[nt][2 * hh + 1] = hv.y;
      greg[nt][2 * hh] = gv.x; greg[nt][2 * hh + 1] = gv.y;
    }
  issue(0);
  for (int i = 0; i < nC; ++i) {
    const int ch = i, cg = nC - 1 - i;
    cp_async_wait_all();
    __syncthreads();       // stage i & 1 has landed; iteration i - 1 is done
    if (i + 1 < nC) issue(i + 1);
    const bf16* st = stage + (i & 1) * 4 * kTile;
    if (warp < 2) {
      float* d = dec_s + warp * 4 * kL;
      chunk_decay(dt_s + ((i & 1) * 2 + warp) * kL, a2, d, d + kL,
                  d + 2 * kL, d + 3 * kL, lane);
    }
    // h_in of chunk ch and G_out of chunk cg, as they stand
    const size_t oh = (bh * nC + ch) * kState, og = (bh * nC + cg) * kState;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const size_t o = (size_t)(m0 + g + 8 * hh) * kDH + n0 + 8 * nt +
                         2 * q;
        *reinterpret_cast<float2*>(hs + oh + o) =
            make_float2(hreg[nt][2 * hh], hreg[nt][2 * hh + 1]);
        *reinterpret_cast<float2*>(gs + og + o) =
            make_float2(greg[nt][2 * hh], greg[nt][2 * hh + 1]);
      }
    __syncthreads();       // the decays
    const float* wd_h = dec_s + 3 * kL;            // forward walk's wd
    const float* es_g = dec_s + 4 * kL + kL;       // backward walk's 2^s
    for (int e = tid; e < 64 * 32; e += kThreads) {
      const int t = e >> 5, col = (e & 31) * 2;
      const int o = swz(t, col);
      const float2 bv =
          unpack_bf16(*reinterpret_cast<const uint32_t*>(st + kTile + o));
      const float2 yv =
          unpack_bf16(*reinterpret_cast<const uint32_t*>(st + 3 * kTile + o));
      put_split(bw_hi, bw_lo, o, bv.x * wd_h[t], bv.y * wd_h[t]);
      put_split(ey_hi, ey_lo, o, yv.x * es_g[t], yv.y * es_g[t]);
    }
    __syncthreads();       // the split operands
    const float fh = dec_s[kL + kL - 1], fg = es_g[kL - 1];   // 2^(s_L)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hreg[nt][e] *= fh;
        greg[nt][e] *= fg;
      }
    // h <- 2^(s_L) h + (B o wd)^T X;  G <- 2^(s_L) G + C^T (e^s o dY)
    mma64<true, true>(hreg, bw_hi, st, m0, n0, lane);
    mma64<true, true>(hreg, bw_lo, st, m0, n0, lane);
    mma64<true, true>(greg, st + 2 * kTile, ey_hi, m0, n0, lane);
    mma64<true, true>(greg, st + 2 * kTile, ey_lo, m0, n0, lane);
  }
  if (dh0) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(dh0 + bh * kState +
                                   (size_t)(m0 + g + 8 * hh) * kDH + n0 +
                                   8 * nt + 2 * q) =
            make_float2(greg[nt][2 * hh], greg[nt][2 * hh + 1]);
  }
}

// ---------------------------------------------------------------------------
// C. every chunk's gradients
// ---------------------------------------------------------------------------

// after the 12 tiles: 18 vectors of kL floats (below), then 22 floats
constexpr size_t kChunkSmem =
    sizeof(bf16) * 12 * kTile + sizeof(float) * (18 * kL + 22);

__global__ void __launch_bounds__(kThreads, 2)
mamba2_scan_bwd_chunk_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const bf16* __restrict__ Bm,
    const bf16* __restrict__ Cm, const float* __restrict__ Dv,
    const bf16* __restrict__ dy, const float* __restrict__ hs,
    const float* __restrict__ gs, bf16* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ dBh,
    float* __restrict__ dCh, float* __restrict__ dA_part,
    float* __restrict__ dD_part, int S, int H, long long x_sb,
    long long x_ss, long long b_sb, long long b_ss, long long c_sb,
    long long c_ss) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);   // [tau][d]
  bf16* bs = xs + kTile;                          // [tau][s]
  bf16* cs = bs + kTile;                          // [m][s]
  bf16* ys = cs + kTile;                          // dy [m][d]
  bf16* go_hi = ys + kTile;                       // G_out [s][d]
  bf16* go_lo = go_hi + kTile;
  bf16* hi_hi = go_lo + kTile;                    // h_in [s][d]
  bf16* hi_lo = hi_hi + kTile;
  bf16* at_hi = hi_lo + kTile;                    // att [m][tau]
  bf16* at_lo = at_hi + kTile;
  bf16* mm_hi = at_lo + kTile;                    // M [m][tau]
  bf16* mm_lo = mm_hi + kTile;
  float* dt_s = reinterpret_cast<float*>(mm_lo + kTile);
  float* s_s = dt_s + kL;       // cumulative a, log2 units, inclusive
  float* es_s = s_s + kL;       // 2^s
  float* dl_s = es_s + kL;      // 2^(s_L - s)
  float* wd_s = dl_s + kL;      // 2^(s_L - s) dt
  float* rowt_s = wd_s + kL;    // a row's prefix over columns 0..31
  float* up_s = rowt_s + kL;    // [2 column halves][64]: u's parts
  float* vp_s = up_s + 2 * kL;  // [2][64]: v's parts
  float* qp_s = vp_s + 2 * kL;  // [4 row blocks][64]: colsum Q's parts
  float* rp_s = qp_s + 4 * kL;  // [4][64]: T4's parts
  float* red_s = rp_s + 4 * kL; // [18]: T1's, dD's and dA's parts
  float* wu_s = red_s + 18;     // [2]: the warps' sums of wd u
  float* ev_s = wu_s + 2;       // [2]: the warps' sums of e^s v

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nC = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int m0 = 16 * (warp & 3), n0 = 32 * (warp >> 2);
  const int t0 = c * kL;
  const int n = min(kL, S - t0);
  const size_t y_ss = (size_t)H * kDH;
  const size_t ybase = (size_t)b * S * y_ss + (size_t)h * kDH;
  const size_t hd_ss = (size_t)H * kDS;              // dBh, dCh
  const size_t hd_base = (size_t)b * S * hd_ss + (size_t)h * kDS;
  const size_t sbase = (((size_t)b * H + h) * nC + c) * kState;
  const float a_h = A[h], d_h = Dv[h];

  load_tile(xs, x + (size_t)b * x_sb + (size_t)h * kDH, x_ss, t0, S, tid);
  load_tile(bs, Bm + (size_t)b * b_sb, b_ss, t0, S, tid);
  load_tile(cs, Cm + (size_t)b * c_sb, c_ss, t0, S, tid);
  load_tile(ys, dy + ybase, (long long)y_ss, t0, S, tid);
  cp_async_commit();
  if (tid < kL) dt_s[tid] = tid < n ? dt[((size_t)b * S + t0 + tid) * H + h]
                                    : 0.f;
  // h_in and G_out: split into their tiles; e^(s_L)'s factor <G_out, h_in>
  float t1 = 0.f;
#pragma unroll
  for (int it = 0; it < kState / (4 * kThreads); ++it) {
    const int e4 = it * kThreads + tid;
    const int row = e4 >> 4, col = (e4 & 15) * 4;
    const float4 hv = *reinterpret_cast<const float4*>(hs + sbase + 4 * e4);
    const float4 gv = *reinterpret_cast<const float4*>(gs + sbase + 4 * e4);
    put_split(hi_hi, hi_lo, swz(row, col), hv.x, hv.y);
    put_split(hi_hi, hi_lo, swz(row, col + 2), hv.z, hv.w);
    put_split(go_hi, go_lo, swz(row, col), gv.x, gv.y);
    put_split(go_hi, go_lo, swz(row, col + 2), gv.z, gv.w);
    t1 = fmaf(gv.x, hv.x, t1);
    t1 = fmaf(gv.y, hv.y, t1);
    t1 = fmaf(gv.z, hv.z, t1);
    t1 = fmaf(gv.w, hv.w, t1);
  }
  t1 = warp_sum(t1);
  if (lane == 0) red_s[warp] = t1;
  __syncthreads();                       // dt_s
  if (warp == 0) chunk_decay(dt_s, a_h * kLog2e, s_s, es_s, dl_s, wd_s, lane);
  cp_async_wait_all();
  __syncthreads();                       // tiles, decays

  // dD's part: dy . x over the chunk
  {
    float p = 0.f;
    for (int e = tid; e < 64 * 32; e += kThreads) {
      const int t = e >> 5, col = (e & 31) * 2;
      const int o = swz(t, col);
      const float2 xv = unpack_bf16(*reinterpret_cast<const uint32_t*>(xs + o));
      const float2 yv = unpack_bf16(*reinterpret_cast<const uint32_t*>(ys + o));
      p = fmaf(xv.x, yv.x, p);
      p = fmaf(xv.y, yv.y, p);
    }
    p = warp_sum(p);
    if (lane == 0) red_s[8 + warp] = p;
  }

  // -- CB = C B^T and DYX = dY X^T, this warp's 16 x 32 block [m][tau]
  {
    float cb[4][4], yx[4][4];
    zero(cb);
    zero(yx);
    mma64<false, false>(cb, cs, bs, m0, n0, lane);
    mma64<false, false>(yx, ys, xs, m0, n0, lane);
    // E = 2^(s_m - s_tau) (tau <= m, exponent selected first); att, M;
    // Q = CB E DYX, P = Q dt (registers); colsum Q; T4's row prefix
    float qcol[4][2], pv[2][4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      qcol[nt][0] = qcol[nt][1] = 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = m0 + g + 8 * hh;
        const int tau = n0 + 8 * nt + 2 * q;
        float at[2], mv[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float ex = tau + j <= m ? s_s[m] - s_s[tau + j] : -INFINITY;
          const float E = fast_exp2(ex);
          const float dtt = dt_s[tau + j];
          const float cbv = cb[nt][2 * hh + j], yxv = yx[nt][2 * hh + j];
          at[j] = cbv * E * dtt;
          mv[j] = E * dtt * yxv;
          const float Q = cbv * E * yxv;
          qcol[nt][j] += Q;
          pv[hh][nt][j] = Q * dtt;
        }
        const int o = swz(m, tau);
        put_split(at_hi, at_lo, o, at[0], at[1]);
        put_split(mm_hi, mm_lo, o, mv[0], mv[1]);
      }
    }
    // colsum Q over this warp's 16 rows (the lanes' g), then the 4 row
    // blocks in order
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float v = qcol[nt][j];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        qcol[nt][j] = v;
      }
    if (g == 0) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        *reinterpret_cast<float2*>(qp_s + (warp & 3) * kL + n0 + 8 * nt +
                                   2 * q) =
            make_float2(qcol[nt][0], qcol[nt][1]);
    }
    // R[m, t] = sum_{tau < t} P[m, tau]: within the warp's 32 columns
    // (pairs, then the 4 lanes q of each n-tile, then the n-tiles), then
    // the left half's row total carried into the right half
    float rx[2][4][2], tot[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float base = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float pair = pv[hh][nt][0] + pv[hh][nt][1];
        float incl = pair;
        float o = __shfl_up_sync(0xffffffffu, incl, 1, 4);
        if (q >= 1) incl += o;
        o = __shfl_up_sync(0xffffffffu, incl, 2, 4);
        if (q >= 2) incl += o;
        float excl = __shfl_up_sync(0xffffffffu, incl, 1, 4);
        if (q == 0) excl = 0.f;
        const float total = __shfl_sync(0xffffffffu, incl, 3, 4);
        rx[hh][nt][0] = base + excl;
        rx[hh][nt][1] = (base + excl) + pv[hh][nt][0];
        base += total;
      }
      tot[hh] = base;
    }
    if (n0 == 0 && q == 0) {
      rowt_s[m0 + g] = tot[0];
      rowt_s[m0 + g + 8] = tot[1];
    }
    __syncthreads();                     // rowt_s, qp_s; att and M written
    // T4_t = sum_{m >= t} R[m, t]: the column sums of R over the rows at or
    // below the diagonal, 16 rows a warp, then the 4 row blocks in order
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int t = n0 + 8 * nt + 2 * q + j;
        float v = 0.f;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = m0 + g + 8 * hh;
          const float off = n0 ? rowt_s[m] : 0.f;
          v += t <= m ? off + rx[hh][nt][j] : 0.f;
        }
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) rp_s[(warp & 3) * kL + t] = v;
      }
  }

  // -- dx = att^T dY + wd o (B G_out) + D dY, this warp's block [tau][d]
  {
    float a1[4][4], a2[4][4];
    zero(a1);
    zero(a2);
    mma64<true, true>(a1, at_hi, ys, m0, n0, lane);
    mma64<true, true>(a1, at_lo, ys, m0, n0, lane);
    mma64<false, true>(a2, bs, go_hi, m0, n0, lane);
    mma64<false, true>(a2, bs, go_lo, m0, n0, lane);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int tau = m0 + g + 8 * hh;
      if (tau < n) {
        const float wdt = wd_s[tau];
        bf16* out = dx + ybase + (size_t)(t0 + tau) * y_ss;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int d = n0 + 8 * nt + 2 * q;
          const float2 yv =
              unpack_bf16(*reinterpret_cast<const uint32_t*>(ys + swz(tau, d)));
          *reinterpret_cast<__nv_bfloat162*>(out + d) = __floats2bfloat162_rn(
              fmaf(d_h, yv.x, fmaf(wdt, a2[nt][2 * hh], a1[nt][2 * hh])),
              fmaf(d_h, yv.y,
                   fmaf(wdt, a2[nt][2 * hh + 1], a1[nt][2 * hh + 1])));
        }
      }
    }
  }

  // -- dBh = M^T C + wd o (X G_out^T) [tau][s]; u = rowsum(B o X G_out^T)
  {
    float a1[4][4], a2[4][4];
    zero(a1);
    zero(a2);
    mma64<true, true>(a1, mm_hi, cs, m0, n0, lane);
    mma64<true, true>(a1, mm_lo, cs, m0, n0, lane);
    mma64<false, false>(a2, xs, go_hi, m0, n0, lane);
    mma64<false, false>(a2, xs, go_lo, m0, n0, lane);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int tau = m0 + g + 8 * hh;
      const float wdt = wd_s[tau];
      float up = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int s = n0 + 8 * nt + 2 * q;
        const float2 bv =
            unpack_bf16(*reinterpret_cast<const uint32_t*>(bs + swz(tau, s)));
        up = fmaf(bv.x, a2[nt][2 * hh], up);
        up = fmaf(bv.y, a2[nt][2 * hh + 1], up);
        if (tau < n)
          *reinterpret_cast<float2*>(dBh + hd_base + (size_t)(t0 + tau) * hd_ss +
                                     s) =
              make_float2(fmaf(wdt, a2[nt][2 * hh], a1[nt][2 * hh]),
                          fmaf(wdt, a2[nt][2 * hh + 1], a1[nt][2 * hh + 1]));
      }
      up += __shfl_xor_sync(0xffffffffu, up, 1);
      up += __shfl_xor_sync(0xffffffffu, up, 2);
      if (q == 0) up_s[(warp >> 2) * kL + tau] = up;
    }
  }

  // -- dCh = e^s o (dY h_in^T) + M B [m][s]; v = rowsum(C o dY h_in^T)
  {
    float a1[4][4], a2[4][4];
    zero(a1);
    zero(a2);
    mma64<false, false>(a1, ys, hi_hi, m0, n0, lane);
    mma64<false, false>(a1, ys, hi_lo, m0, n0, lane);
    mma64<false, true>(a2, mm_hi, bs, m0, n0, lane);
    mma64<false, true>(a2, mm_lo, bs, m0, n0, lane);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + g + 8 * hh;
      const float esm = es_s[m];
      float vp = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int s = n0 + 8 * nt + 2 * q;
        const float2 cv =
            unpack_bf16(*reinterpret_cast<const uint32_t*>(cs + swz(m, s)));
        vp = fmaf(cv.x, a1[nt][2 * hh], vp);
        vp = fmaf(cv.y, a1[nt][2 * hh + 1], vp);
        if (m < n)
          *reinterpret_cast<float2*>(dCh + hd_base + (size_t)(t0 + m) * hd_ss +
                                     s) =
              make_float2(fmaf(esm, a1[nt][2 * hh], a2[nt][2 * hh]),
                          fmaf(esm, a1[nt][2 * hh + 1], a2[nt][2 * hh + 1]));
      }
      vp += __shfl_xor_sync(0xffffffffu, vp, 1);
      vp += __shfl_xor_sync(0xffffffffu, vp, 2);
      if (q == 0) vp_s[(warp >> 2) * kL + m] = vp;
    }
  }
  __syncthreads();                       // u's and v's parts, T4's parts

  // -- per step (threads t < 64, warps 0 and 1): u, v; T2 an exclusive
  //    prefix of wd u and T3 an inclusive suffix of e^s v, by warp scans
  //    (fixed order), the first warp's total carried into the second
  //    (T2) and the second's into the first (T3); then da and ddt
  float dsum = 0.f;
  if (tid < kL) {
    const int t = tid;
    const float u = up_s[t] + up_s[kL + t];
    const float v = vp_s[t] + vp_s[kL + t];
    const float ddt1 =
        ((qp_s[t] + qp_s[kL + t]) + (qp_s[2 * kL + t] + qp_s[3 * kL + t])) +
        dl_s[t] * u;
    float pre = wd_s[t] * u, suf = es_s[t] * v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, pre, off);
      if (lane >= off) pre += o;
      const float o2 = __shfl_down_sync(0xffffffffu, suf, off);
      if (lane + off < 32) suf += o2;
    }
    float excl = __shfl_up_sync(0xffffffffu, pre, 1);
    if (lane == 0) excl = 0.f;
    if (lane == 31) wu_s[warp] = pre;    // the warp's sum of wd u
    if (lane == 0) ev_s[warp] = suf;     // the warp's sum of e^s v
    asm volatile("bar.sync 1, 64;\n" ::: "memory");
    const float t2 = warp ? wu_s[0] + excl : excl;
    const float t3 = warp ? suf : suf + ev_s[1];
    const float t4 = (rp_s[t] + rp_s[kL + t]) + (rp_s[2 * kL + t] +
                                                 rp_s[3 * kL + t]);
    const float T1 = es_s[kL - 1] *
                     (((red_s[0] + red_s[1]) + (red_s[2] + red_s[3])) +
                      ((red_s[4] + red_s[5]) + (red_s[6] + red_s[7])));
    const float da = ((T1 + t2) + t3) + t4;
    if (t < n) ddt[((size_t)b * S + t0 + t) * H + h] = fmaf(a_h, da, ddt1);
    dsum = dt_s[t] * da;                 // 0 past S
  }
  if (warp < 2) {
    dsum = warp_sum(dsum);
    if (lane == 0) red_s[16 + warp] = dsum;
  }
  __syncthreads();
  if (tid == 0) {
    const size_t i = ((size_t)b * H + h) * nC + c;
    dA_part[i] = red_s[16] + red_s[17];
    dD_part[i] = ((red_s[8] + red_s[9]) + (red_s[10] + red_s[11])) +
                 ((red_s[12] + red_s[13]) + (red_s[14] + red_s[15]));
  }
}

// dB, dC: the heads' parts added in order; dA, dD: the (b, chunk) partials
__global__ void __launch_bounds__(128)
mamba2_scan_bwd_sum_kernel(const float* __restrict__ dBh,
                           const float* __restrict__ dCh,
                           const float* __restrict__ dA_part,
                           const float* __restrict__ dD_part,
                           bf16* __restrict__ dB, bf16* __restrict__ dC,
                           float* __restrict__ dA, float* __restrict__ dD,
                           int B, int S, int H, int nC) {
  const int t = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int s = tid & 63;
  const size_t bt = (size_t)b * S + t;
  const float* src = (tid < kDS ? dBh : dCh) + bt * H * kDS + s;
  float acc = 0.f;
  for (int hh = 0; hh < H; ++hh) acc += src[(size_t)hh * kDS];
  (tid < kDS ? dB : dC)[bt * kDS + s] = __float2bfloat16(acc);
  if (t == 0 && b == 0) {
    for (int hh = tid; hh < H; hh += 128) {
      float a = 0.f, d = 0.f;
      for (int bb = 0; bb < B; ++bb)
        for (int cc = 0; cc < nC; ++cc) {
          a += dA_part[((size_t)bb * H + hh) * nC + cc];
          d += dD_part[((size_t)bb * H + hh) * nC + cc];
        }
      dA[hh] = a;
      dD[hh] = d;
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

}  // namespace

// x, Bmat, Cmat, dy, dx, dB, dC bf16.  Strides in elements; x, Bmat, Cmat
// and their strides 16-byte aligned.  h0, dh_out and dh0 may be null.
// scratch holds 2 * B * S * H * 64 + 2 * B * H * nC * 64 * 64 + 2 * B * H *
// nC floats, nC = ceil(S / 64).  *kernel receives 1
// (mamba2_scan_bwd_chunk_kernel and its two companions).  Returns
// cudaGetLastError() after the launches (0 on success); -1 for a dh or ds
// this file does not build.
extern "C" int mamba2_scan_bwd_chunk_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* D, const void* h0, const void* dy,
    const void* dh_out, void* dx, void* ddt, void* dB, void* dC, void* dA,
    void* dD, void* dh0, void* scratch, int B, int S, int H, int dh, int ds,
    long long x_sb, long long x_ss, long long b_sb, long long b_ss,
    long long c_sb, long long c_ss, int* kernel, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dh != kDH || ds != kDS || S < 1) return -1;
  *kernel = 1;
  static std::atomic<unsigned long long> state_set{0}, chunk_set{0};
  cudaError_t err = allow_dynamic_smem(
      state_set, (const void*)mamba2_scan_bwd_state_kernel, (int)kStateSmem);
  if (err != cudaSuccess) return (int)err;
  err = allow_dynamic_smem(chunk_set,
                           (const void*)mamba2_scan_bwd_chunk_kernel,
                           (int)kChunkSmem);
  if (err != cudaSuccess) return (int)err;
  const int nC = (S + kL - 1) / kL;
  const size_t n_hd = (size_t)B * S * H * kDS;
  const size_t n_st = (size_t)B * H * nC * kState;
  float* dBh = (float*)scratch;
  float* dCh = dBh + n_hd;
  float* hs = dCh + n_hd;
  float* gs = hs + n_st;
  float* dA_part = gs + n_st;
  float* dD_part = dA_part + (size_t)B * H * nC;
  mamba2_scan_bwd_state_kernel<<<dim3(H, B), kThreads, kStateSmem, st>>>(
      (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)Bm,
      (const bf16*)Cm, (const bf16*)dy, (const float*)h0,
      (const float*)dh_out, hs, gs, (float*)dh0, S, H, x_sb, x_ss, b_sb,
      b_ss, c_sb, c_ss);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mamba2_scan_bwd_chunk_kernel<<<dim3(nC, H, B), kThreads, kChunkSmem, st>>>(
      (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)Bm,
      (const bf16*)Cm, (const float*)D, (const bf16*)dy, hs, gs, (bf16*)dx,
      (float*)ddt, dBh, dCh, dA_part, dD_part, S, H, x_sb, x_ss, b_sb, b_ss,
      c_sb, c_ss);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mamba2_scan_bwd_sum_kernel<<<dim3(S, B), 128, 0, st>>>(
      dBh, dCh, dA_part, dD_part, (bf16*)dB, (bf16*)dC, (float*)dA,
      (float*)dD, B, S, H, nC);
  return (int)cudaGetLastError();
}
