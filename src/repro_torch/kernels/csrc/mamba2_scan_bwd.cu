// Mamba2 SSD selective scan (n_groups = 1), backward (K3-bwd), for Hopper
// (sm_90a).
//
// The gradient of K3's function (csrc/mamba2_scan.cu; the function of
// src/repro/kernels/ref.py::mamba2_scan with its h0 / return_state
// contract):
//   h_t = exp(a_t) h_{t-1} + dt_t B_t (x) x_t,  a_t = A dt_t
//   y_t = C_t . h_t + D x_t
// Replaces: no TPU kernel.  The Pallas kernel
// (src/repro/kernels/mamba2_scan.py:69) has no backward; JAX trains
// through jax.vjp of its chunked jnp reference
// (src/repro/kernels/ref.py:214, mamba2_scan_chunked), and this kernel
// gives the gradient of the port's counterpart
// (kernels/ref.py::mamba2_scan_chunked) for any S >= 1.
//
// Per (b, head), with dy_t the output gradient and G = dL/dh (G = dh_out,
// or 0, after the last step), walking the steps backwards:
//   G    <- G + C_t dy_t^T            (now G_t = dL/dh_t)
//   dx_t  = dt_t G_t^T B_t + D dy_t
//   dB_t += dt_t G_t x_t              (this head's part)
//   da_t  = exp(a_t) <G_t, h_{t-1}>   (a_t's gradient, the direct form)
//   ddt_t = B_t^T G_t x_t + A da_t
//   G    <- exp(a_t) G;   at the end dh0 = G
// and dC_t += h_t dy_t (this head's part), dA = sum over batch and steps
// of dt_t da_t, dD = sum over batch, steps and channels of dy_t x_t.
// The decay's gradient takes the direct form.  The identity da_t =
// sum_{m >= t} (<dy_m, C_m . h_m> - dt_m B_m^T G_m x_m), plus <dh_out, h_T>,
// needs no stored state, but its suffix sums cancel what fp32 rounded in
// each term: over 1024 steps its dA lands 2.8e-4 to 2.6e-2 of max|dA| from
// the exact one, the direct form's within 4e-6 (CPU models of both in
// tests/test_torch_scan_bwd.py).
//
// Design (simple and exact first; no tensor cores), K4-bwd's: one block of
// 128 threads per (b, h).  Threads 0-63 own a row s of the (ds x dh)
// state, threads 64-127 a column d; each keeps its row or column of G in
// 64 fp32 registers, so every sum over d (dC, G x, <G, h>) is a row
// thread's own and every sum over s (dx) a column thread's own.
//   1. Forward: the row threads run h over the sequence and write it to a
//      checkpoint (fp32, global, [chunk][d][s]: coalesced) at the start of
//      every chunk of kC = 8 steps.
//   2. Reverse, chunk by chunk from the last: the chunk's x, B, C (read by
//      their strides: the mixer's views in place), dy and dt are staged in
//      shared memory; each row thread reloads its row of the chunk's
//      checkpoint and recomputes h_{t-1} over the chunk (keeping all kC of
//      them in shared memory, 128 KB, [t][d][s]: conflict-free) and writes
//      dC's head part; then walks the chunk backwards for dB's head part,
//      its parts of B^T G x and <G, h_{t-1}> (warp shuffles, then the two
//      row warps added through shared memory) and G.  The column threads
//      walk it backwards for dx, dD and their copy of G (the same fmaf as
//      the rows').
//   3. dB and dC are sums over the H heads: the block writes its head's
//      part (fp32 scratch) and `mamba2_scan_bwd_reduce_kernel` adds the
//      heads in order, and the batch's dA and dD partials.  No atomics:
//      reruns are bitwise.
// What bounds it: neither bytes nor the tensor cores: each step is 64-wide
// dot products and updates on the CUDA cores (three passes over the
// state), latency-bound at 4 warps a block, one block an SM (B * H = 256
// blocks at zamba2's training shape, for 132 SMs).  The checkpoints move
// 2 x 16 KB per (b, h) and chunk through device memory (at B=4, S=1024,
// H=64: 2 x 537 MB).  Resources (ptxas -v, CUDA 12.8): 228 registers, no
// spills; 139 456 bytes of dynamic shared memory.
//
// Layouts: x (B, S, H, dh) by its batch and step strides (head stride dh,
// channel stride 1); Bmat, Cmat (B, S, ds) by theirs (channel stride 1);
// dy, dx (B, S, H, dh) contiguous; x, Bmat, Cmat, dy, dx, dB, dC share T
// (float or __nv_bfloat16); dt, ddt (B, S, H), A, D, dA, dD (H,), h0,
// dh_out, dh0 (B, H, ds, dh) fp32 and contiguous; h0, dh_out and dh0 may be
// null.  Scratch: dBh, dCh (B, S, H, 64), dA_part, dD_part (B, H) and the
// checkpoints (B, H, ceil(S / 8), 64, 64), all fp32.  dh and ds are 64, or
// up to 64 on the small-width route: the same kernel with x, dy past dh and
// B, C past ds read as zeros.  Arithmetic is fp32; build without
// --use_fast_math / -ftz.

#include <atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kDH = 64;            // head size this file builds
constexpr int kDS = 64;            // state size this file builds
constexpr int kC = 8;              // steps a chunk of the reverse pass
constexpr int kThreads = 128;      // 64 row threads, 64 column threads
constexpr int kState = kDS * kDH;
static_assert(kDH == kDS, "rows and columns take one thread each");

// dynamic shared memory, in floats: the chunk's states h_{t-1}, its staged
// x, B, C, dy, dt, exp(A dt), and per step the row warps' two sums
constexpr size_t kSmemFloats = (size_t)kC * kState + 4 * kC * 64 + 6 * kC;
constexpr size_t kSmem = kSmemFloats * sizeof(float);

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// sum_j a[j] * b[stride * j], four partial sums (fixed order)
__device__ __forceinline__ float dot64(const float* a, const float* b,
                                       int stride) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 64; ++j)
    p[j & 3] = fmaf(a[j], b[stride * j], p[j & 3]);
  return (p[0] + p[1]) + (p[2] + p[3]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
mamba2_scan_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const T* __restrict__ Bm,
                       const T* __restrict__ Cm,
                       const float* __restrict__ Dv,
                       const float* __restrict__ h0, const T* __restrict__ dy,
                       const float* __restrict__ dh_out, T* __restrict__ dx,
                       float* __restrict__ ddt, float* __restrict__ dBh,
                       float* __restrict__ dCh, float* __restrict__ dh0,
                       float* __restrict__ ckpt,
                       float* __restrict__ dA_part,
                       float* __restrict__ dD_part, int S, int H, int dh,
                       int ds, long long x_sb, long long x_ss,
                       long long b_sb, long long b_ss, long long c_sb,
                       long long c_ss) {
  extern __shared__ __align__(16) float smem[];
  float* sbuf = smem;                      // [kC][d][s]: h_{t-1}
  float* x_s = sbuf + kC * kState;         // [kC][64] each
  float* b_s = x_s + kC * 64;
  float* c_s = b_s + kC * 64;
  float* dy_s = c_s + kC * 64;
  float* dt_s = dy_s + kC * 64;            // [kC]
  float* ea_s = dt_s + kC;                 // [kC]: exp(A dt)
  float* part_s = ea_s + kC;               // [kC][2 sums][2 row warps]
  __shared__ float red_s[2];               // dD, per column warp

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const bool is_row = tid < kDS;
  const int i = tid & 63;            // a row thread's s, a column's d
  const int warp = tid >> 5, lane = tid & 31;
  const float a_h = A[h];
  const float d_h = Dv[h];
  const size_t bh = (size_t)b * H + h;
  const size_t st_base = bh * ds * dh;              // h0, dh_out, dh0
  const T* xb = x + (size_t)b * x_sb + (size_t)h * dh;
  const T* bb = Bm + (size_t)b * b_sb;
  const T* cb = Cm + (size_t)b * c_sb;
  const size_t y_ss = (size_t)H * dh;               // dy, dx: contiguous
  const size_t ybase = (size_t)b * S * y_ss + (size_t)h * dh;
  // a small width runs padded to 64: x, dy past dh and B, C past ds read
  // as zeros, so the padded rows and columns of h and G stay zero and add
  // nothing to any sum; nothing past dh or ds is written
  const size_t hd_ss = (size_t)H * kDS;             // dBh, dCh
  const size_t hd_base = (size_t)b * S * hd_ss + (size_t)h * kDS;
  const int nC = (S + kC - 1) / kC;
  float* ck = ckpt + bh * (size_t)nC * kState;

  // stage steps [t0, t0 + n): x and B, with C and dy if `all`
  auto stage = [&](int t0, int n, bool all) {
    for (int e = tid; e < n * 64; e += kThreads) {
      const int t = e >> 6, d = e & 63;
      const size_t ts = (size_t)(t0 + t);
      x_s[e] = d < dh ? to_float(xb[ts * x_ss + d]) : 0.f;
      b_s[e] = d < ds ? to_float(bb[ts * b_ss + d]) : 0.f;
      if (all) {
        c_s[e] = d < ds ? to_float(cb[ts * c_ss + d]) : 0.f;
        dy_s[e] = d < dh ? to_float(dy[ybase + ts * y_ss + d]) : 0.f;
      }
    }
    if (tid < n) {
      const float v = dt[((size_t)b * S + t0 + tid) * H + h];
      dt_s[tid] = v;
      ea_s[tid] = expf(a_h * v);
    }
  };

  // ---- 1. forward: checkpoints of h at every chunk's start --------------
  float hs[kDH];
#pragma unroll
  for (int d = 0; d < kDH; ++d)
    hs[d] = (is_row && h0 && i < ds && d < dh)
                ? h0[st_base + (size_t)i * dh + d] : 0.f;
  for (int c = 0; c < nC; ++c) {
    if (is_row) {
#pragma unroll
      for (int d = 0; d < kDH; ++d)
        ck[((size_t)c * kDH + d) * kDS + i] = hs[d];
    }
    if (c == nC - 1) break;                // the last chunk's h is not used
    __syncthreads();                       // the previous chunk is consumed
    stage(c * kC, kC, false);              // a whole chunk: c < nC - 1
    __syncthreads();
    if (is_row) {
      for (int t = 0; t < kC; ++t) {
        const float ea = ea_s[t], bdt = b_s[t * 64 + i] * dt_s[t];
#pragma unroll
        for (int d = 0; d < kDH; ++d)
          hs[d] = fmaf(hs[d], ea, bdt * x_s[t * 64 + d]);
      }
    }
  }

  // ---- 2. reverse, chunk by chunk ---------------------------------------
  float g[kDH];     // row i of G (row threads) or column i (column threads)
#pragma unroll
  for (int j = 0; j < kDH; ++j)
    g[j] = !dh_out ? 0.f
           : is_row ? (i < ds && j < dh
                           ? dh_out[st_base + (size_t)i * dh + j] : 0.f)
                    : (j < ds && i < dh
                           ? dh_out[st_base + (size_t)j * dh + i] : 0.f);
  float dD_acc = 0.f, dA_acc = 0.f;
  for (int c = nC - 1; c >= 0; --c) {
    const int t0 = c * kC;
    const int n = min(kC, S - t0);
    __syncthreads();                       // the previous chunk is consumed
    stage(t0, n, true);
    __syncthreads();
    if (is_row) {
      // recompute h_{t-1} over the chunk from its checkpoint; dC's part
#pragma unroll
      for (int d = 0; d < kDH; ++d)
        hs[d] = ck[((size_t)c * kDH + d) * kDS + i];
      for (int t = 0; t < n; ++t) {
        float* sb = sbuf + t * kState;
#pragma unroll
        for (int d = 0; d < kDH; ++d) sb[d * kDS + i] = hs[d];
        const float ea = ea_s[t], bdt = b_s[t * 64 + i] * dt_s[t];
#pragma unroll
        for (int d = 0; d < kDH; ++d)
          hs[d] = fmaf(hs[d], ea, bdt * x_s[t * 64 + d]);
        dCh[hd_base + (size_t)(t0 + t) * hd_ss + i] =
            dot64(hs, dy_s + t * 64, 1);
      }
      // backwards over the chunk
      for (int t = n - 1; t >= 0; --t) {
        const float cs = c_s[t * 64 + i], ea = ea_s[t];
#pragma unroll
        for (int d = 0; d < kDH; ++d) g[d] = fmaf(cs, dy_s[t * 64 + d], g[d]);
        const float gx = dot64(g, x_s + t * 64, 1);
        const float gh = dot64(g, sbuf + t * kState + i, kDS);
        dBh[hd_base + (size_t)(t0 + t) * hd_ss + i] = dt_s[t] * gx;
        const float p_dt = warp_sum(b_s[t * 64 + i] * gx);
        const float p_da = warp_sum(gh);
        if (lane == 0) {
          part_s[t * 4 + warp] = p_dt;
          part_s[t * 4 + 2 + warp] = p_da;
        }
#pragma unroll
        for (int d = 0; d < kDH; ++d) g[d] *= ea;
      }
    } else {
      for (int t = n - 1; t >= 0; --t) {
        const float dyd = dy_s[t * 64 + i], ea = ea_s[t];
#pragma unroll
        for (int s = 0; s < kDS; ++s) g[s] = fmaf(c_s[t * 64 + s], dyd, g[s]);
        const float gb = dot64(g, b_s + t * 64, 1);
        if (i < dh)
          dx[ybase + (size_t)(t0 + t) * y_ss + i] =
              from_float<T>(fmaf(dt_s[t], gb, d_h * dyd));
        dD_acc = fmaf(dyd, x_s[t * 64 + i], dD_acc);
#pragma unroll
        for (int s = 0; s < kDS; ++s) g[s] *= ea;
      }
    }
    __syncthreads();
    if (tid < n) {                         // step t0 + tid: ddt and dA
      const float da = ea_s[tid] * (part_s[tid * 4 + 2] + part_s[tid * 4 + 3]);
      ddt[((size_t)b * S + t0 + tid) * H + h] =
          fmaf(a_h, da, part_s[tid * 4] + part_s[tid * 4 + 1]);
      dA_acc = fmaf(dt_s[tid], da, dA_acc);
    }
  }
  if (is_row && dh0 && i < ds) {
#pragma unroll
    for (int d = 0; d < kDH; ++d)
      if (d < dh) dh0[st_base + (size_t)i * dh + d] = g[d];
  }
  if (!is_row) {
    const float p = warp_sum(dD_acc);
    if (lane == 0) red_s[warp - 2] = p;
  }
  __syncthreads();
  if (warp == 0) {
    // dA: the kC per-lane sums (lanes kC.. hold 0), added in a fixed order
    const float p = warp_sum(lane < kC ? dA_acc : 0.f);
    if (lane == 0) {
      dA_part[bh] = p;
      dD_part[bh] = red_s[0] + red_s[1];
    }
  }
}

// dB, dC: the heads' parts added in order; dA, dD: the batch's partials
template <typename T>
__global__ void __launch_bounds__(kThreads)
mamba2_scan_bwd_reduce_kernel(const float* __restrict__ dBh,
                              const float* __restrict__ dCh,
                              const float* __restrict__ dA_part,
                              const float* __restrict__ dD_part,
                              T* __restrict__ dB, T* __restrict__ dC,
                              float* __restrict__ dA, float* __restrict__ dD,
                              int B, int S, int H, int ds) {
  const int t = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int s = tid & 63;
  const size_t bt = (size_t)b * S + t;
  const float* src = (tid < kDS ? dBh : dCh) + bt * H * kDS + s;
  float acc = 0.f;
  for (int hh = 0; hh < H; ++hh) acc += src[(size_t)hh * kDS];
  if (s < ds) (tid < kDS ? dB : dC)[bt * ds + s] = from_float<T>(acc);
  if (t == 0 && b == 0) {
    for (int hh = tid; hh < H; hh += kThreads) {
      float a = 0.f, d = 0.f;
      for (int bb = 0; bb < B; ++bb) {
        a += dA_part[(size_t)bb * H + hh];
        d += dD_part[(size_t)bb * H + hh];
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

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* D, const void* h0, const void* dy,
           const void* dh_out, void* dx, void* ddt, void* dB, void* dC,
           void* dA, void* dD, void* dh0, float* scratch, int B, int S,
           int H, int dh, int ds, long long x_sb, long long x_ss, long long b_sb,
           long long b_ss, long long c_sb, long long c_ss,
           cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = allow_dynamic_smem(
      smem_set, (const void*)mamba2_scan_bwd_kernel<T>, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const size_t n_hd = (size_t)B * S * H * kDS;
  float* dBh = scratch;
  float* dCh = dBh + n_hd;
  float* dA_part = dCh + n_hd;
  float* dD_part = dA_part + (size_t)B * H;
  float* ckpt = dD_part + (size_t)B * H;
  dim3 grid(H, B);
  mamba2_scan_bwd_kernel<T><<<grid, kThreads, kSmem, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
      (const T*)Cm, (const float*)D, (const float*)h0, (const T*)dy,
      (const float*)dh_out, (T*)dx, (float*)ddt, dBh, dCh, (float*)dh0, ckpt,
      dA_part, dD_part, S, H, dh, ds, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mamba2_scan_bwd_reduce_kernel<T><<<dim3(S, B), kThreads, 0, stream>>>(
      dBh, dCh, dA_part, dD_part, (T*)dB, (T*)dC, (float*)dA, (float*)dD, B,
      S, H, ds);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, Bmat, Cmat, dy and dx, dB, dC).
// Strides are in elements.  h0, dh_out and dh0 may be null.  scratch holds
// 2 * B * S * H * 64 + 2 * B * H + B * H * ceil(S / 8) * 64 * 64 floats
// (laid out 64 wide whatever dh and ds).  *kernel receives 0
// (mamba2_scan_bwd_kernel at dh = ds = 64) or 2 (the same kernel at a
// small width: any dh, ds up to 64, padded to 64 with zeros).  Returns
// cudaGetLastError() after the launches (0 on success); -1 for a dh or ds
// above 64 or a dtype this file does not build.
extern "C" int mamba2_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* D, const void* h0, const void* dy,
    const void* dh_out, void* dx, void* ddt, void* dB, void* dC, void* dA,
    void* dD, void* dh0, void* scratch, int B, int S, int H, int dh, int ds,
    long long x_sb, long long x_ss, long long b_sb, long long b_ss,
    long long c_sb, long long c_ss, int dtype, int* kernel, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dh < 1 || dh > kDH || ds < 1 || ds > kDS || S < 1) return -1;
  *kernel = (dh == kDH && ds == kDS) ? 0 : 2;
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, D, h0, dy, dh_out, dx, ddt, dB,
                         dC, dA, dD, dh0, (float*)scratch, B, S, H, dh, ds,
                         x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, st);
  if (dtype == 1)
    return launch<bf16>(x, dt, A, Bm, Cm, D, h0, dy, dh_out, dx, ddt, dB,
                        dC, dA, dD, dh0, (float*)scratch, B, S, H, dh, ds,
                        x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, st);
  return -1;
}
