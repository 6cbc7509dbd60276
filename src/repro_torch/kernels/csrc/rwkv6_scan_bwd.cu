// RWKV6 wkv recurrence, backward (K4-bwd), for Hopper (sm_90a).
//
// The gradient of K4's function (csrc/rwkv6_scan.cu; the function of
// src/repro/kernels/ref.py::rwkv6_scan with its s0 / return_state
// contract):
//   S_t = diag(w_t) S_{t-1} + k_t (x) v_t
//   y_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)
// Replaces: no TPU kernel.  The Pallas kernel
// (src/repro/kernels/rwkv6_scan.py:59) has no backward; JAX trains
// through jax.vjp of its chunked jnp reference
// (src/repro/kernels/ref.py:282, rwkv6_scan_chunked), and this kernel
// gives the gradient of the port's counterpart
// (kernels/ref.py::rwkv6_scan_chunked) for any S >= 1.
//
// With dy_t the output gradient and G_t = dL/dS_t (G_T = ds_out, or 0),
// 1-based t and S_0 = s0:
//   dr_t = S_{t-1} dy_t + (u o k_t)(v_t . dy_t)
//   dk_t = G_t v_t      + (u o r_t)(v_t . dy_t)
//   dv_t = G_t^T k_t    + (r_t . (u o k_t)) dy_t
//   dw_t = rowsum(G_t o S_{t-1}), and 0 where w_t < 1e-30 (the plain
//          version floors w there, so its gradient is 0)
//   G_{t-1} = diag(w_t) G_t + r_t dy_t^T;   ds0 = G_0
//   du   = sum over batch and steps of (r_t o k_t)(v_t . dy_t)
// The decay's gradient takes this direct form.  The log-decay identity
// (dlog w_t as suffix sums of r o (S dy) and k o (G v)) needs no stored
// state, but it gives dw = dlog w / w, its fp32 rounding divided by w:
// with w down to 1e-4 it lands 3.3e-3 of max|dw| from the exact one, the
// direct form 2e-7 (CPU models in tests/test_torch_scan_bwd.py).  The
// direct form divides by nothing.
//
// Design (simple and exact first; no tensor cores): one block of 128
// threads per (b, h).  Threads 0-63 own a row i of the state (k channel),
// threads 64-127 a column j (v channel); each keeps its row or column of
// G in 64 fp32 registers, so every sum over j (dr, dk, dw) is a row
// thread's own and every sum over i (dv) a column thread's own.
//   1. Forward: the row threads run S over the sequence and write it to
//      a checkpoint (fp32, global, [chunk][j][i]: coalesced) at the start
//      of every chunk of kC = 8 steps.
//   2. Reverse, chunk by chunk from the last: the chunk's r, k, v, w, dy
//      are staged in shared memory, with v_t . dy_t and r_t . (u o k_t)
//      reduced by warp shuffles; each row thread reloads its row of the
//      chunk's checkpoint, recomputes S_{t-1} over the chunk (keeping all
//      kC of them in shared memory, 128 KB, [t][j][i]: conflict-free) and
//      writes dr; then walks the chunk backwards for dk, dw and G.  The
//      column threads walk it backwards for dv and their copy of G (the
//      same fmaf as the rows', so the two copies agree bitwise).
//   3. du: each row thread's sum over its steps is a partial per (b, h);
//      `rwkv6_du_reduce_kernel` adds the batch's partials in a fixed
//      order.  No atomics anywhere: reruns are bitwise.
// What bounds it: neither bytes nor the tensor cores.  Each step is a
// chain of 64-wide dot products and updates on the CUDA cores (three
// passes over the state: forward, recompute, reverse), one block a (b, h)
// with 4 warps: latency-bound, B * H blocks (128 at rwkv6's training
// shape, for 132 SMs).  The checkpoints move 2 x 16 KB per (b, h) and
// chunk through device memory (at B=4, S=1024, H=32: 2 x 268 MB).
// Resources (ptxas -v, CUDA 12.8): 219 registers, no spills; 141 632
// bytes of dynamic shared memory, one block an SM.
//
// Layouts (contiguous): r, k, v, w, dy, dr, dk, dv, dw (B, S, H, dh) in T
// (float or __nv_bfloat16); u (H, dh) fp32; s0, ds_out, ds0 (B, H, dh, dh)
// fp32, row = k channel, column = v channel, each may be null; du (H, dh)
// fp32; scratch: du_part (B, H, 64) and ckpt (B, H, ceil(S / 8), 64, 64)
// fp32.  dh is 64, or up to 64 on the small-width route: the same kernel
// with r, k, v, dy past dh read as zeros and w as ones, so the padded rows
// and columns of S and G stay zero.  Arithmetic is fp32; build without
// --use_fast_math / -ftz.

#include <atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kDH = 64;            // head size this file builds
constexpr int kC = 8;              // steps a chunk of the reverse pass
constexpr int kThreads = 2 * kDH;  // row threads, then column threads
constexpr int kState = kDH * kDH;
constexpr float kFloorW = 1e-30f;  // ref.rwkv6_scan_chunked's floor

// dynamic shared memory, in floats: the chunk's states S_{t-1}, its
// staged r, k, v, w, dy, u, and two dot products a step
constexpr size_t kSmemFloats =
    (size_t)kC * kState + 5 * kC * kDH + kDH + 2 * kC;
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
  for (int j = 0; j < kDH; ++j)
    p[j & 3] = fmaf(a[j], b[stride * j], p[j & 3]);
  return (p[0] + p[1]) + (p[2] + p[3]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
rwkv6_scan_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ w,
                      const float* __restrict__ u,
                      const float* __restrict__ s0, const T* __restrict__ dy,
                      const float* __restrict__ ds_out, T* __restrict__ dr,
                      T* __restrict__ dk, T* __restrict__ dv,
                      T* __restrict__ dw, float* __restrict__ du_part,
                      float* __restrict__ ds0, float* __restrict__ ckpt,
                      int S, int H, int dh) {
  extern __shared__ __align__(16) float smem[];
  float* sbuf = smem;                      // [kC][j][i]: S_{t-1}
  float* r_s = sbuf + kC * kState;         // [kC][kDH] each
  float* k_s = r_s + kC * kDH;
  float* v_s = k_s + kC * kDH;
  float* w_s = v_s + kC * kDH;
  float* dy_s = w_s + kC * kDH;
  float* u_s = dy_s + kC * kDH;            // [kDH]
  float* vd_s = u_s + kDH;                 // [kC]: v_t . dy_t
  float* ruk_s = vd_s + kC;                // [kC]: r_t . (u o k_t)

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const bool is_row = tid < kDH;
  const int i = tid & (kDH - 1);  // a row thread's row, a column's column
  const size_t bh = (size_t)b * H + h;
  const size_t row = (size_t)H * dh;       // stride of one step
  const size_t base = (size_t)b * S * row + (size_t)h * dh;
  const size_t sbase = bh * dh * dh;       // s0, ds_out, ds0
  const int nC = (S + kC - 1) / kC;
  float* ck = ckpt + bh * (size_t)nC * kState;
  // a small width runs padded to 64: r, k, v, dy and u past dh read as
  // zeros (w as ones), so the padded rows and columns of S and G stay zero
  // and add nothing to any sum; nothing past dh is written
  if (tid < kDH) u_s[tid] = tid < dh ? u[(size_t)h * dh + tid] : 0.f;

  // ---- 1. forward: checkpoints of S at every chunk's start --------------
  float st[kDH];
#pragma unroll
  for (int j = 0; j < kDH; ++j)
    st[j] = (is_row && s0 && i < dh && j < dh)
                ? s0[sbase + (size_t)i * dh + j] : 0.f;
  for (int c = 0; c < nC; ++c) {
    if (is_row) {
#pragma unroll
      for (int j = 0; j < kDH; ++j)
        ck[((size_t)c * kDH + j) * kDH + i] = st[j];
    }
    if (c == nC - 1) break;                // the last chunk's S is not used
    const int t0 = c * kC;                 // a whole chunk: c < nC - 1
    __syncthreads();                       // the previous chunk is consumed
    for (int e = tid; e < kC * kDH; e += kThreads) {
      const int d = e % kDH;
      const size_t off = base + (size_t)(t0 + e / kDH) * row + d;
      const bool in = d < dh;
      k_s[e] = in ? to_float(k[off]) : 0.f;
      v_s[e] = in ? to_float(v[off]) : 0.f;
      w_s[e] = in ? to_float(w[off]) : 1.f;
    }
    __syncthreads();
    if (is_row) {
      for (int t = 0; t < kC; ++t) {
        const float ki = k_s[t * kDH + i], wi = w_s[t * kDH + i];
#pragma unroll
        for (int j = 0; j < kDH; ++j)
          st[j] = fmaf(st[j], wi, ki * v_s[t * kDH + j]);
      }
    }
  }

  // ---- 2. reverse, chunk by chunk ---------------------------------------
  float g[kDH];     // row i of G (row threads) or column i (column threads)
#pragma unroll
  for (int j = 0; j < kDH; ++j)
    g[j] = (!ds_out || i >= dh || j >= dh) ? 0.f
           : is_row ? ds_out[sbase + (size_t)i * dh + j]
                    : ds_out[sbase + (size_t)j * dh + i];
  float du_acc = 0.f;
  const int warp = tid >> 5, lane = tid & 31;
  for (int c = nC - 1; c >= 0; --c) {
    const int t0 = c * kC;
    const int n = min(kC, S - t0);
    __syncthreads();                       // the previous chunk is consumed
    for (int e = tid; e < n * kDH; e += kThreads) {
      const int d = e % kDH;
      const size_t off = base + (size_t)(t0 + e / kDH) * row + d;
      const bool in = d < dh;
      r_s[e] = in ? to_float(r[off]) : 0.f;
      k_s[e] = in ? to_float(k[off]) : 0.f;
      v_s[e] = in ? to_float(v[off]) : 0.f;
      w_s[e] = in ? to_float(w[off]) : 1.f;
      dy_s[e] = in ? to_float(dy[off]) : 0.f;
    }
    __syncthreads();
    for (int t = warp; t < n; t += kThreads / 32) {
      const float* vv = v_s + t * kDH;
      const float* dd = dy_s + t * kDH;
      const float* rr = r_s + t * kDH;
      const float* kk = k_s + t * kDH;
      const float a = warp_sum(fmaf(vv[lane], dd[lane],
                                    vv[lane + 32] * dd[lane + 32]));
      const float q = warp_sum(
          fmaf(rr[lane], u_s[lane] * kk[lane],
               rr[lane + 32] * (u_s[lane + 32] * kk[lane + 32])));
      if (lane == 0) {
        vd_s[t] = a;
        ruk_s[t] = q;
      }
    }
    __syncthreads();
    if (is_row) {
      const float ui = u_s[i];
      // recompute S_{t-1} over the chunk from its checkpoint; dr
#pragma unroll
      for (int j = 0; j < kDH; ++j)
        st[j] = ck[((size_t)c * kDH + j) * kDH + i];
      for (int t = 0; t < n; ++t) {
        float* sb = sbuf + t * kState;
#pragma unroll
        for (int j = 0; j < kDH; ++j) sb[j * kDH + i] = st[j];
        const float ki = k_s[t * kDH + i], ri = r_s[t * kDH + i];
        const float vd = vd_s[t];
        const float acc = dot64(st, dy_s + t * kDH, 1);
        const size_t off = base + (size_t)(t0 + t) * row + i;
        if (i < dh) dr[off] = from_float<T>(fmaf(ui * ki, vd, acc));
        du_acc = fmaf(ri * ki, vd, du_acc);
        if (t + 1 < n) {
          const float wi = w_s[t * kDH + i];
#pragma unroll
          for (int j = 0; j < kDH; ++j)
            st[j] = fmaf(st[j], wi, ki * v_s[t * kDH + j]);
        }
      }
      // backwards over the chunk: dk, dw, then G_{t-1}
      for (int t = n - 1; t >= 0; --t) {
        const float ri = r_s[t * kDH + i], wi = w_s[t * kDH + i];
        const float gv = dot64(g, v_s + t * kDH, 1);
        const float gs = dot64(g, sbuf + t * kState + i, kDH);
        const size_t off = base + (size_t)(t0 + t) * row + i;
        if (i < dh) {
          dk[off] = from_float<T>(fmaf(ui * ri, vd_s[t], gv));
          dw[off] = from_float<T>(wi < kFloorW ? 0.f : gs);
        }
#pragma unroll
        for (int j = 0; j < kDH; ++j)
          g[j] = fmaf(g[j], wi, ri * dy_s[t * kDH + j]);
      }
    } else {
      for (int t = n - 1; t >= 0; --t) {
        const float dyj = dy_s[t * kDH + i];
        const float gk = dot64(g, k_s + t * kDH, 1);
        if (i < dh)
          dv[base + (size_t)(t0 + t) * row + i] =
              from_float<T>(fmaf(ruk_s[t], dyj, gk));
#pragma unroll
        for (int ii = 0; ii < kDH; ++ii)
          g[ii] = fmaf(g[ii], w_s[t * kDH + ii], r_s[t * kDH + ii] * dyj);
      }
    }
  }
  if (is_row) {
    du_part[bh * kDH + i] = du_acc;
    if (ds0 && i < dh) {
#pragma unroll
      for (int j = 0; j < kDH; ++j)
        if (j < dh) ds0[sbase + (size_t)i * dh + j] = g[j];
    }
  }
}

// du[h][i] = sum over b of du_part[b][h][i] (laid out 64 wide), b in order
__global__ void rwkv6_du_reduce_kernel(const float* __restrict__ du_part,
                                       float* __restrict__ du, int B, int H,
                                       int dh) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= H * dh) return;
  const int hh = e / dh, i = e % dh;
  float s = 0.f;
  for (int b = 0; b < B; ++b)
    s += du_part[((size_t)b * H + hh) * kDH + i];
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

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, const void* dy, const void* ds_out,
           void* dr, void* dk, void* dv, void* dw, void* du, void* ds0,
           void* du_part, void* ckpt, int B, int S, int H, int dh,
           cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = allow_dynamic_smem(
      smem_set, (const void*)rwkv6_scan_bwd_kernel<T>, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B);
  rwkv6_scan_bwd_kernel<T><<<grid, kThreads, kSmem, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const T*)w, (const float*)u,
      (const float*)s0, (const T*)dy, (const float*)ds_out, (T*)dr, (T*)dk,
      (T*)dv, (T*)dw, (float*)du_part, (float*)ds0, (float*)ckpt, S, H, dh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = H * dh;
  rwkv6_du_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      (const float*)du_part, (float*)du, B, H, dh);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w, dy and dr, dk, dv, dw).
// s0, ds_out and ds0 may be null (zeros in; not written).  du_part
// (B * H * 64 floats) and ckpt (B * H * ceil(S / 8) * 64 * 64 floats) are
// scratch, laid out 64 wide whatever dh.  *kernel receives 0
// (rwkv6_scan_bwd_kernel at dh = 64) or 2 (the same kernel at a small
// width: any dh up to 64, padded to 64).  Returns cudaGetLastError() after
// the launches (0 on success); -1 for a dh above 64 or a dtype this file
// does not build.
extern "C" int rwkv6_scan_bwd_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* s0, const void* dy, const void* ds_out,
    void* dr, void* dk, void* dv, void* dw, void* du, void* ds0,
    void* du_part, void* ckpt, int B, int S, int H, int dh, int dtype,
    int* kernel, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dh < 1 || dh > kDH || S < 1) return -1;
  *kernel = dh == kDH ? 0 : 2;
  if (dtype == 0)
    return launch<float>(r, k, v, w, u, s0, dy, ds_out, dr, dk, dv, dw, du,
                         ds0, du_part, ckpt, B, S, H, dh, st);
  if (dtype == 1)
    return launch<bf16>(r, k, v, w, u, s0, dy, ds_out, dr, dk, dv, dw, du,
                        ds0, du_part, ckpt, B, S, H, dh, st);
  return -1;
}
