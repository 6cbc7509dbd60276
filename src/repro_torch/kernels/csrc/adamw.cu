// AdamW for Hopper (sm_90a): the single-card training step's whole
// optimizer update as one kernel pair, in place on the model's own
// parameters and on the optimizer's moments.
//
// Replaces: no TPU kernel.  The JAX package leaves the update to XLA
// (src/repro/optim/adamw.py::adamw_update), which fuses it.  The port ran
// it as about twenty eager PyTorch operators a leaf over layer-stacked
// fp32 copies (optim/adamw.py::adamw_update, with the stacking and the copy
// back around it), some 150 bytes of traffic a parameter.
//
// What bounds it: bytes.  A parameter costs one read and one write of
// itself (bf16: 2 + 2 bytes), two reads of its gradient (the norm pass and
// the update: 2 + 2) and one read and one write of each fp32 moment (8 +
// 8): 24 bytes for about a dozen flops, far below the card's ~295 flops a
// byte.  So the design moves each of those bytes once a pass:
//   * one table of records (parameter, gradient, moment slices, elements,
//     dtype, decay, alignment) covers every tensor of the step, so two
//     launches cover the whole model; the records' chunks of kChunk
//     elements are dealt to a persistent grid of as many blocks as the card
//     holds at once, block b taking chunks b, b + grid, ... (a binary search
//     over the records' first chunks finds a chunk's tensor);
//   * pass 1 (adamw_norm_kernel) sums the gradients' squares, each thread in
//     fp64 (the square of an fp32 value is exact there), one fp64 partial a
//     block; pass 2 (adamw_update_kernel) first reduces those partials in
//     one fixed order in every block, so every block, and every run, sees
//     the same norm and clip scale; the sum is rounded to fp32 before its
//     square root, as the eager norm's fp32 sum is;
//   * a thread takes 8 elements at a time with 16-byte loads and stores (a
//     bf16 parameter or gradient one access, an fp32 one two, each moment
//     two), where all four pointers of a record are 16-byte aligned; an
//     unaligned record, and a record's last elements short of 8, go one
//     element at a time;
//   * a record without a gradient (a parameter the loss did not reach) is
//     updated with a zero gradient, as the eager path's zeros are.
// The arithmetic is the eager update's, operator by operator and in its
// order, each step rounded as the eager operator rounds it (the __f*_rn
// intrinsics keep nvcc from contracting a product and a sum into an FMA):
// g * scale; b1 * m + (1 - b1) * g; ((1 - b2) * g) * g; (m / bc1) /
// (sqrt(v / bc2) + eps); + wd * p where the leaf decays; p - lr * delta;
// the parameter rounded to its dtype to nearest even.  The learning rate
// and the two bias corrections are read from device memory (the caller
// computes them on the card from the step counter there), so nothing
// waits for the host.
//
// Layouts: every tensor contiguous; m and v fp32; a parameter fp32 or bf16,
// its gradient of the same dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kChunk = 16384;  // elements; a multiple of 8 * kThreads
constexpr int kDecay = 1;            // Rec::flags
constexpr int kAligned = 2;

struct Rec {          // one tensor of the step, as the wrapper packs it
  void* p;            // the parameter, updated in place
  const void* g;      // its gradient, or null: a zero gradient
  float* m;           // its slice of the leaf's first moment
  float* v;           // ... and of the second
  long long n;        // elements (> 0)
  long long chunk0;   // its first chunk in the walk
  int dtype;          // 0 fp32, 1 bf16 (parameter and gradient)
  int flags;          // kDecay | kAligned
};
static_assert(sizeof(Rec) == 56, "Rec must match the wrapper's packing");

struct Coef {         // one step's fp32 constants, as the eager ops see them
  float scale, b1, omb1, b2, omb2, bc1, bc2, eps, wd, lr;
};

// 8 elements of T, 16 bytes at a time (streamed: each byte is used once)
template <typename T> struct Elems;
template <> struct Elems<float> {
  __device__ static void load(const float* s, float (&x)[8]) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(s));
    const float4 b = __ldcs(reinterpret_cast<const float4*>(s) + 1);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
  __device__ static void store(float* d, const float (&x)[8]) {
    __stcs(reinterpret_cast<float4*>(d), make_float4(x[0], x[1], x[2], x[3]));
    __stcs(reinterpret_cast<float4*>(d) + 1,
           make_float4(x[4], x[5], x[6], x[7]));
  }
  __device__ static float get(const float* s) { return *s; }
  __device__ static void put(float* d, float x) { *d = x; }
};
template <> struct Elems<__nv_bfloat16> {
  __device__ static void load(const __nv_bfloat16* s, float (&x)[8]) {
    const uint4 r = __ldcs(reinterpret_cast<const uint4*>(s));
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 -> fp32 is a 16-bit shift
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static void store(__nv_bfloat16* d, const float (&x)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // the lower address in the low half
      const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    __stcs(reinterpret_cast<uint4*>(d), make_uint4(w[0], w[1], w[2], w[3]));
  }
  __device__ static float get(const __nv_bfloat16* s) {
    return __bfloat162float(*s);
  }
  __device__ static void put(__nv_bfloat16* d, float x) {
    *d = __float2bfloat16_rn(x);
  }
};

// the last record whose first chunk is at or before chunk c
__device__ __forceinline__ const Rec& find_rec(const Rec* recs, int n_rec,
                                               long long c) {
  int lo = 0, hi = n_rec - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (recs[mid].chunk0 <= c) lo = mid;
    else hi = mid - 1;
  }
  return recs[lo];
}

// the block's sum of x in one fixed order; thread 0's value is the sum
__device__ double block_sum(double x, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  double t = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) t += red[w];
  return t;
}

template <typename T>
__device__ __forceinline__ void sum_sq(const T* g, long long lo, long long hi,
                                       bool aligned, double& acc) {
  for (long long i = lo + 8LL * threadIdx.x; i < hi; i += 8LL * kThreads) {
    if (aligned && i + 8 <= hi) {
      float x[8];
      Elems<T>::load(g + i, x);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc = fma((double)x[j], (double)x[j], acc);
    } else {
      const long long end = min(i + 8, hi);
      for (long long j = i; j < end; ++j) {
        const double x = Elems<T>::get(g + j);
        acc = fma(x, x, acc);
      }
    }
  }
}

// pass 1: one fp64 partial sum of squared gradients a block
__global__ void __launch_bounds__(kThreads)
adamw_norm_kernel(const Rec* __restrict__ recs, int n_rec, long long n_chunks,
                  double* __restrict__ partial) {
  __shared__ double red[kWarps];
  double acc = 0.0;
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Rec& r = find_rec(recs, n_rec, c);
    if (r.g == nullptr) continue;
    const long long lo = (c - r.chunk0) * kChunk;
    const long long hi = min(lo + kChunk, r.n);
    const bool aligned = r.flags & kAligned;
    if (r.dtype == 1)
      sum_sq(static_cast<const __nv_bfloat16*>(r.g), lo, hi, aligned, acc);
    else
      sum_sq(static_cast<const float*>(r.g), lo, hi, aligned, acc);
  }
  const double t = block_sum(acc, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = t;
}

// one element's AdamW step, in the eager operators' order and rounding
__device__ __forceinline__ void adamw_elem(float& p, float g, float& m,
                                           float& v, const Coef& k,
                                           bool decay) {
  g = __fmul_rn(g, k.scale);
  m = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.omb1, g));
  v = __fadd_rn(__fmul_rn(k.b2, v), __fmul_rn(__fmul_rn(k.omb2, g), g));
  float d = __fdiv_rn(__fdiv_rn(m, k.bc1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, k.bc2)), k.eps));
  if (decay) d = __fadd_rn(d, __fmul_rn(k.wd, p));
  p = __fsub_rn(p, __fmul_rn(k.lr, d));
}

template <typename T>
__device__ __forceinline__ void update_range(const Rec& r, long long lo,
                                             long long hi, const Coef& k) {
  T* p = static_cast<T*>(r.p);
  const T* g = static_cast<const T*>(r.g);
  float* m = r.m;
  float* v = r.v;
  const bool decay = r.flags & kDecay;
  const bool aligned = r.flags & kAligned;
  for (long long i = lo + 8LL * threadIdx.x; i < hi; i += 8LL * kThreads) {
    if (aligned && i + 8 <= hi) {
      float pv[8], gv[8], mv[8], vv[8];
      Elems<T>::load(p + i, pv);
      if (g != nullptr) {
        Elems<T>::load(g + i, gv);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) gv[j] = 0.f;
      }
      Elems<float>::load(m + i, mv);
      Elems<float>::load(v + i, vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) adamw_elem(pv[j], gv[j], mv[j], vv[j], k,
                                             decay);
      Elems<T>::store(p + i, pv);
      Elems<float>::store(m + i, mv);
      Elems<float>::store(v + i, vv);
    } else {
      const long long end = min(i + 8, hi);
      for (long long j = i; j < end; ++j) {
        float pj = Elems<T>::get(p + j), mj = m[j], vj = v[j];
        const float gj = g != nullptr ? Elems<T>::get(g + j) : 0.f;
        adamw_elem(pj, gj, mj, vj, k, decay);
        Elems<T>::put(p + j, pj);
        m[j] = mj;
        v[j] = vj;
      }
    }
  }
}

// pass 2: the clip scale from pass 1's partials, then every element's step
__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(const Rec* __restrict__ recs, int n_rec,
                    long long n_chunks, const double* __restrict__ partial,
                    int n_partial, const float* __restrict__ lr,
                    const float* __restrict__ bc1,
                    const float* __restrict__ bc2, float* __restrict__ norm_out,
                    float clip_norm, Coef k) {
  __shared__ double red[kWarps];
  __shared__ float s_scale;
  double t = 0.0;
  for (int i = threadIdx.x; i < n_partial; i += kThreads) t += partial[i];
  t = block_sum(t, red);
  if (threadIdx.x == 0) {
    const float norm = __fsqrt_rn((float)t);
    // the eager clip_norm / (norm + 1e-9) is reciprocal(norm + 1e-9) *
    // clip_norm
    const float s = __fmul_rn(__fdiv_rn(1.f, __fadd_rn(norm, 1e-9f)),
                              clip_norm);
    s_scale = s > 1.f ? 1.f : s;   // a NaN stays NaN, as under clamp
    if (blockIdx.x == 0) *norm_out = norm;
  }
  __syncthreads();
  k.scale = s_scale;
  k.lr = *lr;
  k.bc1 = *bc1;
  k.bc2 = *bc2;
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Rec& r = find_rec(recs, n_rec, c);
    const long long lo = (c - r.chunk0) * kChunk;
    const long long hi = min(lo + kChunk, r.n);
    if (r.dtype == 1) update_range<__nv_bfloat16>(r, lo, hi, k);
    else update_range<float>(r, lo, hi, k);
  }
}

// blocks of a kernel the card holds at once (0 on an error)
int resident_blocks(const void* kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    0) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

}  // namespace

// The step over n_rec records (recs: device memory) of n_chunks chunks in
// all.  partial: max_blocks fp64 of scratch; lr, bc1, bc2: fp32 scalars on
// the device; norm_out: the fp32 global gradient norm.  blocks[0..1]: the
// two kernels' grids.  Returns 0, -1 on bad sizes, or a CUDA error.
extern "C" int adamw_launch(const void* recs, int n_rec, long long n_chunks,
                            void* partial, int max_blocks, const void* lr,
                            const void* bc1, const void* bc2, void* norm_out,
                            float b1, float omb1, float b2, float omb2,
                            float eps, float wd, float clip_norm, int* blocks,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_rec <= 0 || n_chunks <= 0 || max_blocks <= 0) return -1;
  static int norm_grid = 0, update_grid = 0;  // the same on every H100
  if (norm_grid == 0) {
    norm_grid = resident_blocks((const void*)adamw_norm_kernel);
    update_grid = resident_blocks((const void*)adamw_update_kernel);
    if (norm_grid == 0 || update_grid == 0) {
      norm_grid = 0;
      return (int)cudaGetLastError();
    }
  }
  const int gn = (int)std::min<long long>(std::min(norm_grid, max_blocks),
                                          n_chunks);
  const int gu = (int)std::min<long long>(update_grid, n_chunks);
  const Rec* r = static_cast<const Rec*>(recs);
  adamw_norm_kernel<<<gn, kThreads, 0, s>>>(r, n_rec, n_chunks,
                                            static_cast<double*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Coef k;
  k.b1 = b1;
  k.omb1 = omb1;
  k.b2 = b2;
  k.omb2 = omb2;
  k.eps = eps;
  k.wd = wd;
  k.scale = k.bc1 = k.bc2 = k.lr = 0.f;  // set on the device
  adamw_update_kernel<<<gu, kThreads, 0, s>>>(
      r, n_rec, n_chunks, static_cast<const double*>(partial), gn,
      static_cast<const float*>(lr), static_cast<const float*>(bc1),
      static_cast<const float*>(bc2), static_cast<float*>(norm_out), clip_norm,
      k);
  blocks[0] = gn;
  blocks[1] = gu;
  return (int)cudaGetLastError();
}
