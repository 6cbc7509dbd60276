// RWKV6 wkv recurrence, backward (K4-bwd), bf16 route: chunk-parallel, for
// Hopper (sm_90a).
//
// The gradient of K4's function (csrc/rwkv6_scan.cu; the function of
// src/repro/kernels/ref.py::rwkv6_scan with its s0 / return_state
// contract), for bf16 r, k, v, w and dy at dh = 64 (rwkv6-1.6b's training
// shape):
//   S_t = diag(w_t) S_{t-1} + k_t (x) v_t
//   y_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)
// With G_t = dL/dS_t (G_T = ds_out, or 0):
//   dr_t = S_{t-1} dy_t + (u o k_t)(v_t . dy_t)
//   dk_t = G_t v_t      + (u o r_t)(v_t . dy_t)
//   dv_t = G_t^T k_t    + (r_t . (u o k_t)) dy_t
//   dw_t = rowsum(G_t o S_{t-1}), 0 where w_t < 1e-30 (the plain version's
//          floor)
//   G_{t-1} = diag(w_t) G_t + r_t dy_t^T;   du = sum (r o k)(v . dy)
// Replaces: no TPU kernel.  The Pallas kernel
// (src/repro/kernels/rwkv6_scan.py:59) has no backward; JAX trains through
// jax.vjp of its chunked jnp reference (ref.py:282).  The fp32 route stays
// csrc/rwkv6_scan_bwd.cu (sequential, CUDA cores).
//
// Chunks of L = 64 steps; per chunk and channel i, cum is the inclusive
// cumulative sum of log2(max(w, 1e-30)) (K4's floor) and cumx_t = cum_{t-1}.
// Three phases, sequential only between chunks:
//   A/B. `rwkv6_scan_bwd_state_kernel`, one block a (b, h), walks the
//      chunks: S_in of chunk c + 1 = diag(2^cum_L) S_in(c) + (k o 2^(cum_L
//      - cum))^T V forwards from s0, and G_out of chunk c - 1 =
//      diag(2^cum_L) G_out(c) + (r o 2^cumx)^T dY backwards from ds_out
//      (ds0 = the first chunk's G_in): every factor <= 1, so no decay
//      overflows; each chunk one 64 x 64 x 64 product on the tensor cores
//      (`mma.sync.m16n8k16`, the fp32 side as bf16 hi + lo, the bf16 input
//      exact) added to the state in the mma accumulators; the two walks
//      interleave, the next chunk's tiles arriving by cp.async.  Every S_in
//      and G_out goes to scratch;
//   C. `rwkv6_scan_bwd_chunk_kernel`, one block a (b, h, chunk), all
//      independent: S_{t-1} stepped forwards from S_in and G_t backwards
//      from G_out, one step at a time inside the chunk, in fp32 on the CUDA
//      cores with w as it is (0 and denormal w included): dw in the direct
//      form, and dr, dk, dv from the same states.  The log-decay identity
//      (dlog w as suffix sums) divides its rounding by w and loses dw
//      (tests/test_torch_scan_bwd_design.py).  512 threads, each a 1 x 8
//      tile of the 64 x 64 state (row i, columns 4 jg .. 4 jg + 3 and 32 +
//      4 jg .. + 3).  S_{t-1} is kept at every 8th step of the chunk (8 x
//      16 KB of shared memory); the chunk is walked backwards 8 steps at a
//      time, each stretch's 8 states recomputed forwards into registers.
//      A row's sums (dr, dk, dw) over its 8 lanes are taken once a
//      stretch, as one reduce-scatter of the stretch's 8 steps (lane jg
//      ends with step jg's sum and writes it); a column's sum (dv) over a
//      warp's 4 rows is a reduce-scatter each step, then the 16 warps'
//      through shared memory in order.
//   `rwkv6_scan_bwd_du_kernel` adds du's (b, chunk) partials in order.  No
//   atomics: reruns are bitwise.
// What bounds it: the fp32 steps inside the chunk (per step and head about
// 6 x 64 x 64 multiply-adds and the row and column sums), not bytes: the
// inputs and outputs are 151 MB at B=4, S=1024, H=32 (0.045 ms at 3.35
// TB/s), the scratch S_in and G_out 2 x 34 MB.  Resources (ptxas -v, CUDA
// 12.8): the state walk 190 registers, no spills, 168 512 bytes of dynamic
// shared memory (one block of 8 warps an SM); the chunk kernel 128
// registers (the cap of 512 threads), 12 bytes spilled, 221 952 bytes (one
// block of 16 warps an SM); the du sum 30 registers.
//
// Layouts (contiguous): r, k, v, w, dy, dr, dk, dv, dw (B, S, H, 64) bf16,
// 16-byte aligned; u (H, 64) fp32; s0, ds_out, ds0 (B, H, 64, 64) fp32, row
// = k channel, column = v channel, each may be null; du (H, 64) fp32;
// scratch (fp32): ss, gs (B, H, nC, 64, 64), du_part (B, H, nC, 64).
// Arithmetic is fp32 outside the tensor cores; build without
// --use_fast_math / -ftz.

#include <atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kL = 64;             // chunk length
constexpr int kDH = 64;            // head size this file builds
constexpr int kTile = 64 * 64;     // one 64 x 64 bf16 tile, swizzled
constexpr int kState = kDH * kDH;
constexpr float kFloorW = 1e-30f;  // ref.rwkv6_scan_chunked's floor

// ---------------------------------------------------------------------------
// shared helpers
// ---------------------------------------------------------------------------

// element offset of (row, col) in a swizzled 64 x 64 bf16 tile: the 16-byte
// chunk col / 8 of a row moves to chunk (col / 8) ^ (row % 8)
__device__ __forceinline__ int swz(int row, int col) {
  return row * 64 + ((((col >> 3) ^ row) & 7) << 3) + (col & 7);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

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
// (x, y) as bf16 hi + lo: hi = (x, y) cut to bf16, lo = bf16((x, y) - hi)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t xb = __float_as_uint(x), yb = __float_as_uint(y);
  hi = __byte_perm(xb, yb, 0x7632);
  lo = pack_bf16(x - __uint_as_float(xb & 0xffff0000u),
                 y - __uint_as_float(yb & 0xffff0000u));
}
// MUFU approximations, subnormals kept (no .ftz): 2^x within ~2 ulp (2^-inf
// = +0), log2 within ~2^-22 absolute
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// A/B. the walks over the chunks, the states in registers
// ---------------------------------------------------------------------------

constexpr int kStateThreads = 256;
constexpr int kCP = kDH + 8;       // padded fp32 row of the cumulative sums
// two stages of 6 tiles (k, v, w of the forward walk's chunk; r, dy, w of
// the backward walk's), the split operands, and each walk's cumulative
// log-decays
constexpr size_t kStateSmem =
    sizeof(bf16) * 16 * kTile + sizeof(float) * 2 * (kL + 1) * kCP;

// acc += A^T B over the 64 steps for this warp's 16 x 32 block of the
// 64 x 64 result (rows m0.., columns n0..), A and B both stored [step][.]:
// A from [k][m] by ldmatrix .trans at (k0 + (l & 7) + (l >> 4) 8, m0 +
// ((l >> 3) & 1) 8); B from [k][n] by .trans at (k0 + (l & 7) + ((l >> 3)
// & 1) 8, n0 + (l >> 4) 8); mma.m16n8k16's C fragment: c0, c1 = (row g,
// cols 2q, 2q + 1), c2, c3 = (row g + 8, ...), lane = 4 g + q.
__device__ __forceinline__ void mma64_tn(float (&acc)[4][4], const bf16* A,
                                         const bf16* Bt, int m0, int n0,
                                         int lane) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int k0 = 16 * ks;
    uint32_t a[4];
    ldmatrix_x4_trans(a, smem_addr(A + swz(k0 + (lane & 7) +
                                               ((lane >> 4) << 3),
                                           m0 + (((lane >> 3) & 1) << 3))));
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, smem_addr(Bt + swz(k0 + (lane & 7) +
                                                  (((lane >> 3) & 1) << 3),
                                              n0 + 16 * np +
                                                  ((lane >> 4) << 3))));
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// cum[t + 1][ch] = sum_{s <= t} log2(max(w_s[ch], 1e-30)), cum[0] = 0, for
// the chunk's n steps (w = 1 past them).  Lane (ch, qt) of warp w sums the
// 16 steps 16 qt .. 16 qt + 15 of channel 8 w + (lane >> 2); the 4
// quarters' totals are scanned by shuffles.
__device__ __forceinline__ void cum_log2(const bf16* ws, int n, float* cum,
                                         int warp, int lane) {
  const int ch = 8 * warp + (lane >> 2), qt = lane & 3;
  float run[16];
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int t = 16 * qt + i;
    const float lw = t < n ? fast_log2(fmaxf(__bfloat162float(ws[swz(t, ch)]),
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
  for (int i = 0; i < 16; ++i) cum[(16 * qt + i + 1) * kCP + ch] = offset +
                                                                   run[i];
  if (qt == 0) cum[ch] = 0.f;
}

// One block a (b, h).  Iteration i takes chunk c = i of the forward walk
// and chunk nC - 1 - i of the backward one; the next iteration's tiles
// arrive by cp.async while this one computes.  S (rows i = k channel,
// columns j) and its gradient G live in the mma accumulators: warp (m0,
// n0) holds rows m0 + g, m0 + g + 8 and columns n0 + 8 nt + 2 q (+ 1).
__global__ void __launch_bounds__(kStateThreads, 1)
rwkv6_scan_bwd_state_kernel(const bf16* __restrict__ r,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ w,
                            const bf16* __restrict__ dy,
                            const float* __restrict__ s0,
                            const float* __restrict__ ds_out,
                            float* __restrict__ ss, float* __restrict__ gs,
                            float* __restrict__ ds0, int S, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* stage = reinterpret_cast<bf16*>(smem_raw);
      // [2][k v w (forward walk) r dy w (backward walk)][tile]
  bf16* k2_hi = stage + 12 * kTile;               // k o 2^(cum_L - cum)
  bf16* k2_lo = k2_hi + kTile;
  bf16* rx_hi = k2_lo + kTile;                    // r o 2^cumx
  bf16* rx_lo = rx_hi + kTile;
  float* cum_f = reinterpret_cast<float*>(rx_lo + kTile);   // [65][kCP]
  float* cum_b = cum_f + (kL + 1) * kCP;

  const int h = blockIdx.x, b = blockIdx.y;
  const int nC = (S + kL - 1) / kL;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int m0 = 16 * (warp & 3), n0 = 32 * (warp >> 2);
  const size_t rstride = (size_t)H * kDH;
  const size_t base = (size_t)b * S * rstride + (size_t)h * kDH;
  const size_t bh = (size_t)b * H + h;

  auto issue = [&](int i) {         // iteration i's tiles
    const int ch = i, cg = nC - 1 - i;
    bf16* st = stage + (i & 1) * 6 * kTile;
    const bf16* srcs[6] = {k, v, w, r, dy, w};
#pragma unroll
    for (int tile = 0; tile < 6; ++tile) {
      const int t0 = (tile < 3 ? ch : cg) * kL;
#pragma unroll
      for (int e = tid; e < 64 * 8; e += kStateThreads) {
        const int row = e >> 3, piece = e & 7;
        const bool ok = t0 + row < S;
        const size_t off =
            ok ? base + (size_t)(t0 + row) * rstride + piece * 8 : 0;
        cp_async16(smem_addr(st + tile * kTile + swz(row, piece * 8)),
                   srcs[tile] + off, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float sreg[4][4], greg[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const size_t o = bh * kState + (size_t)(m0 + g + 8 * hh) * kDH + n0 +
                       8 * nt + 2 * q;
      const float2 sv = s0 ? *reinterpret_cast<const float2*>(s0 + o)
                           : make_float2(0.f, 0.f);
      const float2 gv = ds_out ? *reinterpret_cast<const float2*>(ds_out + o)
                               : make_float2(0.f, 0.f);
      sreg[nt][2 * hh] = sv.x; sreg[nt][2 * hh + 1] = sv.y;
      greg[nt][2 * hh] = gv.x; greg[nt][2 * hh + 1] = gv.y;
    }
  issue(0);
  for (int i = 0; i < nC; ++i) {
    const int ch = i, cg = nC - 1 - i;
    cp_async_wait_all();
    __syncthreads();       // stage i & 1 has landed; iteration i - 1 is done
    if (i + 1 < nC) issue(i + 1);
    const bf16* st = stage + (i & 1) * 6 * kTile;
    cum_log2(st + 2 * kTile, min(kL, S - ch * kL), cum_f, warp, lane);
    cum_log2(st + 5 * kTile, min(kL, S - cg * kL), cum_b, warp, lane);
    // S_in of chunk ch and G_out of chunk cg, as they stand
    const size_t os = (bh * nC + ch) * kState, og = (bh * nC + cg) * kState;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const size_t o = (size_t)(m0 + g + 8 * hh) * kDH + n0 + 8 * nt +
                         2 * q;
        *reinterpret_cast<float2*>(ss + os + o) =
            make_float2(sreg[nt][2 * hh], sreg[nt][2 * hh + 1]);
        *reinterpret_cast<float2*>(gs + og + o) =
            make_float2(greg[nt][2 * hh], greg[nt][2 * hh + 1]);
      }
    __syncthreads();       // the cumulative sums
    // the split operands, every factor <= 1
    for (int e = tid; e < 64 * 32; e += kStateThreads) {
      const int t = e >> 5, cp = (e & 31) * 2;
      const int o = swz(t, cp);
      const float2 kk = unpack_bf16(*reinterpret_cast<const uint32_t*>(st + o));
      const float2 rr =
          unpack_bf16(*reinterpret_cast<const uint32_t*>(st + 3 * kTile + o));
      const float* cl = cum_f + kL * kCP + cp;
      const float* ct = cum_f + (t + 1) * kCP + cp;
      const float* cx = cum_b + t * kCP + cp;
      uint32_t hi, lo;
      split_bf16(kk.x * fast_exp2(cl[0] - ct[0]),
                 kk.y * fast_exp2(cl[1] - ct[1]), hi, lo);
      *reinterpret_cast<uint32_t*>(k2_hi + o) = hi;
      *reinterpret_cast<uint32_t*>(k2_lo + o) = lo;
      split_bf16(rr.x * fast_exp2(cx[0]), rr.y * fast_exp2(cx[1]), hi, lo);
      *reinterpret_cast<uint32_t*>(rx_hi + o) = hi;
      *reinterpret_cast<uint32_t*>(rx_lo + o) = lo;
    }
    __syncthreads();       // the split operands
    // S <- diag(2^cum_L) S + k2^T V;  G <- diag(2^cum_L) G + (r o 2^cumx)^T dY
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + g + 8 * hh;
      const float fs = fast_exp2(cum_f[kL * kCP + row]);
      const float fg = fast_exp2(cum_b[kL * kCP + row]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        sreg[nt][2 * hh] *= fs; sreg[nt][2 * hh + 1] *= fs;
        greg[nt][2 * hh] *= fg; greg[nt][2 * hh + 1] *= fg;
      }
    }
    mma64_tn(sreg, k2_hi, st + kTile, m0, n0, lane);
    mma64_tn(sreg, k2_lo, st + kTile, m0, n0, lane);
    mma64_tn(greg, rx_hi, st + 4 * kTile, m0, n0, lane);
    mma64_tn(greg, rx_lo, st + 4 * kTile, m0, n0, lane);
  }
  if (ds0) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(ds0 + bh * kState +
                                   (size_t)(m0 + g + 8 * hh) * kDH + n0 +
                                   8 * nt + 2 * q) =
            make_float2(greg[nt][2 * hh], greg[nt][2 * hh + 1]);
  }
}

// ---------------------------------------------------------------------------
// C. every chunk's gradients, step by step inside the chunk
// ---------------------------------------------------------------------------

constexpr int kThreads = 512;      // 64 rows x 8 lanes
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 8;            // steps a stretch; S_{t-1} kept at each
constexpr int kNSeg = kL / kSeg;
constexpr size_t kChunkSmem =
    sizeof(float) * ((size_t)kNSeg * kState   // S at each stretch's start
                     + 2 * kL * kDH           // v, dy
                     + kSeg * kWarps * kDH    // dv's per-warp parts
                     + 3 * kL)                // u, v . dy, r . (u o k)
    + sizeof(bf16) * 3 * kL * kDH;            // r, k, w [t][i]

// a thread's 8 columns of a 64-float row: 4 jg .. 4 jg + 3 and 32 + 4 jg ..
__device__ __forceinline__ void ld8(const float* row, int jg, float (&o)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(row + 4 * jg);
  const float4 c = *reinterpret_cast<const float4*>(row + 32 + 4 * jg);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = c.x; o[5] = c.y; o[6] = c.z; o[7] = c.w;
}
__device__ __forceinline__ void st8(float* row, int jg, const float (&o)[8]) {
  *reinterpret_cast<float4*>(row + 4 * jg) = make_float4(o[0], o[1], o[2],
                                                         o[3]);
  *reinterpret_cast<float4*>(row + 32 + 4 * jg) =
      make_float4(o[4], o[5], o[6], o[7]);
}
// A stretch's 8 per-step sums over a row's 8 lanes (lanes 8 p .. 8 p + 7),
// as a reduce-scatter in a fixed order: lane jg ends with step jg's sum
__device__ __forceinline__ float reduce_steps(const float (&v)[kSeg],
                                              int jg) {
  const int b2 = (jg >> 2) & 1, b1 = (jg >> 1) & 1, b0 = jg & 1;
  float h[4], q[2];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    h[c] = (b2 ? v[c + 4] : v[c]) +
           __shfl_xor_sync(0xffffffffu, b2 ? v[c] : v[c + 4], 4);
#pragma unroll
  for (int c = 0; c < 2; ++c)
    q[c] = (b1 ? h[c + 2] : h[c]) +
           __shfl_xor_sync(0xffffffffu, b1 ? h[c] : h[c + 2], 2);
  return (b0 ? q[1] : q[0]) + __shfl_xor_sync(0xffffffffu, b0 ? q[0] : q[1],
                                              1);
}

__global__ void __launch_bounds__(kThreads, 1)
rwkv6_scan_bwd_chunk_kernel(const bf16* __restrict__ r,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ w,
                            const float* __restrict__ u,
                            const bf16* __restrict__ dy,
                            const float* __restrict__ ss,
                            const float* __restrict__ gs,
                            bf16* __restrict__ dr, bf16* __restrict__ dk,
                            bf16* __restrict__ dv, bf16* __restrict__ dw,
                            float* __restrict__ du_part, int S, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* bnd = reinterpret_cast<float*>(smem_raw);   // [seg][i][j]
  float* v_s = bnd + kNSeg * kState;                 // [t][j]
  float* y_s = v_s + kL * kDH;                       // dy [t][j]
  float* dvp = y_s + kL * kDH;                       // [k][warp][j]
  float* u_s = dvp + kSeg * kWarps * kDH;
  float* vd_s = u_s + kL;                            // v_t . dy_t
  float* ruk_s = vd_s + kL;                          // r_t . (u o k_t)
  bf16* r_s = reinterpret_cast<bf16*>(ruk_s + kL);   // [t][i]
  bf16* k_s = r_s + kL * kDH;
  bf16* w_s = k_s + kL * kDH;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nC = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int i = tid >> 3, jg = tid & 7;   // row i, 8 columns (ld8)
  const int t0 = c * kL;
  const int n = min(kL, S - t0);
  const size_t rstride = (size_t)H * kDH;
  const size_t base = (size_t)b * S * rstride + (size_t)h * kDH;
  const size_t cb = ((size_t)b * H + h) * nC + c;

  // stage the chunk: v, dy as fp32; r, k, w as bf16; steps past S: zeros,
  // w = 1 (8 values a thread of each)
  {
    const int t = tid >> 3, c8 = (tid & 7) * 8;
    const bool ok = t < n;
    const size_t off = base + (size_t)(t0 + t) * rstride + c8;
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    const uint32_t one2 = 0x3f803f80u;                 // bf16 (1, 1)
    const uint4 vv = ok ? *reinterpret_cast<const uint4*>(v + off) : z;
    const uint4 yy = ok ? *reinterpret_cast<const uint4*>(dy + off) : z;
    *reinterpret_cast<uint4*>(r_s + t * kDH + c8) =
        ok ? *reinterpret_cast<const uint4*>(r + off) : z;
    *reinterpret_cast<uint4*>(k_s + t * kDH + c8) =
        ok ? *reinterpret_cast<const uint4*>(k + off) : z;
    *reinterpret_cast<uint4*>(w_s + t * kDH + c8) =
        ok ? *reinterpret_cast<const uint4*>(w + off)
           : make_uint4(one2, one2, one2, one2);
    const uint32_t vw[4] = {vv.x, vv.y, vv.z, vv.w};
    const uint32_t yw[4] = {yy.x, yy.y, yy.z, yy.w};
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      *reinterpret_cast<float2*>(v_s + t * kDH + c8 + 2 * p) =
          unpack_bf16(vw[p]);
      *reinterpret_cast<float2*>(y_s + t * kDH + c8 + 2 * p) =
          unpack_bf16(yw[p]);
    }
    if (tid < kDH) u_s[tid] = u[(size_t)h * kDH + tid];
  }
  // this thread's tile of S_in and G_out
  float st[8], gg[8];
  ld8(ss + cb * kState + (size_t)i * kDH, jg, st);
  ld8(gs + cb * kState + (size_t)i * kDH, jg, gg);
  __syncthreads();
  // v_t . dy_t and r_t . (u o k_t): 4 steps a warp
  for (int t = warp; t < kL; t += kWarps) {
    const float a = fmaf(v_s[t * kDH + lane], y_s[t * kDH + lane],
                         v_s[t * kDH + lane + 32] * y_s[t * kDH + lane + 32]);
    const float rk = fmaf(
        __bfloat162float(r_s[t * kDH + lane]) * u_s[lane],
        __bfloat162float(k_s[t * kDH + lane]),
        __bfloat162float(r_s[t * kDH + lane + 32]) * u_s[lane + 32] *
            __bfloat162float(k_s[t * kDH + lane + 32]));
    const float sa = warp_sum(a), sr = warp_sum(rk);
    if (lane == 0) {
      vd_s[t] = sa;
      ruk_s[t] = sr;
    }
  }
  // S at the start of every stretch (this thread's own slots)
  for (int sg = 0; sg < kNSeg; ++sg) {
    st8(bnd + sg * kState + i * kDH, jg, st);
    if (sg == kNSeg - 1) break;
#pragma unroll
    for (int kk = 0; kk < kSeg; ++kk) {
      const int t = sg * kSeg + kk;
      const float kt = __bfloat162float(k_s[t * kDH + i]);
      const float wt = __bfloat162float(w_s[t * kDH + i]);
      float vv[8];
      ld8(v_s + t * kDH, jg, vv);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) st[jj] = fmaf(wt, st[jj], kt * vv[jj]);
    }
  }
  __syncthreads();                       // vd_s, ruk_s
  const float ui = u_s[i];
  const int bit3 = (lane >> 3) & 1, bit4 = (lane >> 4) & 1;
  const int dv_col = (bit4 ? 32 : 0) + 4 * jg + 2 * bit3;
  float du_acc = 0.f;
  for (int sg = kNSeg - 1; sg >= 0; --sg) {
    // S_{t-1} over the stretch, forwards from its start; dr's row parts
    float sp[kSeg][8], part[kSeg];
    ld8(bnd + sg * kState + i * kDH, jg, st);
#pragma unroll
    for (int kk = 0; kk < kSeg; ++kk) {
      const int t = sg * kSeg + kk;
      const float kt = __bfloat162float(k_s[t * kDH + i]);
      const float wt = __bfloat162float(w_s[t * kDH + i]);
      float yv[8], vv[8];
      ld8(y_s + t * kDH, jg, yv);
      ld8(v_s + t * kDH, jg, vv);
      float p0 = 0.f, p1 = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; jj += 2) {
        sp[kk][jj] = st[jj];
        sp[kk][jj + 1] = st[jj + 1];
        p0 = fmaf(st[jj], yv[jj], p0);
        p1 = fmaf(st[jj + 1], yv[jj + 1], p1);
        st[jj] = fmaf(wt, st[jj], kt * vv[jj]);
        st[jj + 1] = fmaf(wt, st[jj + 1], kt * vv[jj + 1]);
      }
      part[kk] = p0 + p1;
    }
    {   // lane jg: step sg * kSeg + jg of row i
      const float acc = reduce_steps(part, jg);
      const int t = sg * kSeg + jg;
      const float kw = __bfloat162float(k_s[t * kDH + i]);
      const float rw = __bfloat162float(r_s[t * kDH + i]);
      const float vd = vd_s[t];
      du_acc = fmaf(rw * kw, vd, du_acc);
      if (t < n)
        dr[base + (size_t)(t0 + t) * rstride + i] =
            __float2bfloat16(fmaf(ui * kw, vd, acc));
    }
    // backwards over the stretch: dw's and dk's row parts, dv's parts,
    // then G_{t-1}
    float pw[kSeg], pk[kSeg];
#pragma unroll
    for (int kk = kSeg - 1; kk >= 0; --kk) {
      const int t = sg * kSeg + kk;
      const float rt = __bfloat162float(r_s[t * kDH + i]);
      const float kt = __bfloat162float(k_s[t * kDH + i]);
      const float wt = __bfloat162float(w_s[t * kDH + i]);
      float yv[8], vv[8];
      ld8(y_s + t * kDH, jg, yv);
      ld8(v_s + t * kDH, jg, vv);
      float aw0 = 0.f, aw1 = 0.f, ak0 = 0.f, ak1 = 0.f, p[8];
#pragma unroll
      for (int jj = 0; jj < 8; jj += 2) {
        aw0 = fmaf(gg[jj], sp[kk][jj], aw0);
        aw1 = fmaf(gg[jj + 1], sp[kk][jj + 1], aw1);
        ak0 = fmaf(gg[jj], vv[jj], ak0);
        ak1 = fmaf(gg[jj + 1], vv[jj + 1], ak1);
        p[jj] = gg[jj] * kt;
        p[jj + 1] = gg[jj + 1] * kt;
      }
      pw[kk] = aw0 + aw1;
      pk[kk] = ak0 + ak1;
      // dv's part over this warp's 4 rows: a reduce-scatter, so each lane
      // ends with 2 columns' sums (dv_col, dv_col + 1)
      float p4[4], p2[2];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float send = bit4 ? p[cc] : p[cc + 4];
        const float keep = bit4 ? p[cc + 4] : p[cc];
        p4[cc] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
      }
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const float send = bit3 ? p4[cc] : p4[cc + 2];
        const float keep = bit3 ? p4[cc + 2] : p4[cc];
        p2[cc] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
      }
      *reinterpret_cast<float2*>(dvp + (kk * kWarps + warp) * kDH + dv_col) =
          make_float2(p2[0], p2[1]);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) gg[jj] = fmaf(wt, gg[jj], rt * yv[jj]);
    }
    {   // lane jg: step sg * kSeg + jg of row i
      const float aw = reduce_steps(pw, jg), ak = reduce_steps(pk, jg);
      const int t = sg * kSeg + jg;
      if (t < n) {
        const size_t off = base + (size_t)(t0 + t) * rstride + i;
        const float rw = __bfloat162float(r_s[t * kDH + i]);
        const float ww = __bfloat162float(w_s[t * kDH + i]);
        dk[off] = __float2bfloat16(fmaf(ui * rw, vd_s[t], ak));
        dw[off] = __float2bfloat16(ww < kFloorW ? 0.f : aw);
      }
    }
    __syncthreads();                     // dv's parts of the stretch
    {
      const int kk = tid >> 6, col = tid & 63;
      const int t = sg * kSeg + kk;
      float sum = 0.f;
#pragma unroll
      for (int ww = 0; ww < kWarps; ++ww)
        sum += dvp[(kk * kWarps + ww) * kDH + col];
      if (t < n)
        dv[base + (size_t)(t0 + t) * rstride + col] =
            __float2bfloat16(fmaf(ruk_s[t], y_s[t * kDH + col], sum));
    }
    __syncthreads();                     // before the next stretch's parts
  }
  // du: the row's 8 lanes' steps, in a fixed order
  du_acc += __shfl_xor_sync(0xffffffffu, du_acc, 1);
  du_acc += __shfl_xor_sync(0xffffffffu, du_acc, 2);
  du_acc += __shfl_xor_sync(0xffffffffu, du_acc, 4);
  if (jg == 0) du_part[cb * kDH + i] = du_acc;
}

// du[h][i] = sum over b, then chunks, of du_part, in order
__global__ void rwkv6_scan_bwd_du_kernel(const float* __restrict__ du_part,
                                         float* __restrict__ du, int B, int H,
                                         int nC) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= H * kDH) return;
  const int h = e / kDH, i = e % kDH;
  float s = 0.f;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < nC; ++c)
      s += du_part[(((size_t)b * H + h) * nC + c) * kDH + i];
  du[e] = s;
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

// r, k, v, w, dy and dr, dk, dv, dw bf16, contiguous, 16-byte aligned.
// s0, ds_out and ds0 may be null.  scratch holds 2 * B * H * nC * 64 * 64 +
// B * H * nC * 64 floats, nC = ceil(S / 64).  *kernel receives 1
// (rwkv6_scan_bwd_chunk_kernel and its two companions).  Returns
// cudaGetLastError() after the launches (0 on success); -1 for a dh this
// file does not build.
extern "C" int rwkv6_scan_bwd_chunk_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* s0, const void* dy, const void* ds_out,
    void* dr, void* dk, void* dv, void* dw, void* du, void* ds0,
    void* scratch, int B, int S, int H, int dh, int* kernel, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dh != kDH || S < 1) return -1;
  *kernel = 1;
  static std::atomic<unsigned long long> state_set{0}, chunk_set{0};
  cudaError_t err = allow_dynamic_smem(
      state_set, (const void*)rwkv6_scan_bwd_state_kernel, (int)kStateSmem);
  if (err != cudaSuccess) return (int)err;
  err = allow_dynamic_smem(chunk_set,
                           (const void*)rwkv6_scan_bwd_chunk_kernel,
                           (int)kChunkSmem);
  if (err != cudaSuccess) return (int)err;
  const int nC = (S + kL - 1) / kL;
  const size_t n_st = (size_t)B * H * nC * kState;
  float* ss = (float*)scratch;
  float* gs = ss + n_st;
  float* du_part = gs + n_st;
  rwkv6_scan_bwd_state_kernel<<<dim3(H, B), kStateThreads, kStateSmem,
                                st>>>(
      (const bf16*)r, (const bf16*)k, (const bf16*)v, (const bf16*)w,
      (const bf16*)dy, (const float*)s0, (const float*)ds_out, ss, gs,
      (float*)ds0, S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rwkv6_scan_bwd_chunk_kernel<<<dim3(nC, H, B), kThreads, kChunkSmem, st>>>(
      (const bf16*)r, (const bf16*)k, (const bf16*)v, (const bf16*)w,
      (const float*)u, (const bf16*)dy, ss, gs, (bf16*)dr, (bf16*)dk,
      (bf16*)dv, (bf16*)dw, du_part, S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nu = H * kDH;
  rwkv6_scan_bwd_du_kernel<<<(nu + 255) / 256, 256, 0, st>>>(
      du_part, (float*)du, B, H, nC);
  return (int)cudaGetLastError();
}
