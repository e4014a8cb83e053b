// RMSNorm for Hopper (sm_90a): K4, a hand kernel with no Pallas counterpart.
//
// The JAX package computes rms_norm as an XLA fusion (voxtral_tpu/ops/norms.py:14-19):
//   out = (f32(x) * rsqrt(mean(f32(x)^2) + eps) * f32(w)).astype(x.dtype)
// over the last axis. Here it is one launch on x [rows, D] (bf16 or f32), w [D]
// (bf16 or f32) and out [rows, D] in x's dtype. Every decoder token step makes
// 53 such calls and every encoder chunk 65.
//
// Why a kernel: the plain PyTorch version is nine eager launches a call, and on
// CUDA torch.mean shapes its thread block by the row count, so a row's f32 sum
// of squares runs in another order at another row count and now and then the
// bf16 output rounds apart. A stream's tokens then follow how many rows its
// call holds (a data rank's share of the fleet). Nothing about a row's answer
// should depend on its neighbours.
//
// Bound: bytes. x is read once and out written once (2 rows D itemsize) and w
// once; four f32 operations an element are far below the card's rate. At decode
// shapes (1-16 rows of 3072) the call is held by launch latency.
//
// Design: the order of every f32 operation is a function of D and the dtype
// alone (ops/norms.k4_plan), never of the row count:
//   * one row per block, `threads` threads a block (a multiple of 32);
//   * thread t owns the VEC-element vectors t, t + threads, t + 2 threads, ...
//     (at most kMaxVecs), read with 16-byte loads (VEC = 16 / itemsize) when D
//     is a multiple of VEC, else one element at a time (the scalar path for an
//     odd width). It keeps them in registers and sums their squares in f32,
//     vector by vector and element by element, one fma each;
//   * a warp adds its lanes' sums by a fixed xor-shuffle tree (16, 8, 4, 2, 1;
//     a + b and b + a round alike, so every lane ends with the same bits), lane
//     0 writes the warp's sum to shared memory, and every thread adds the
//     warps' sums in warp order;
//   * ms = sum / D, r = 1 / sqrt(ms + eps) (IEEE division and square root, as
//     the plain version's rsqrt on the CPU), out = (x * r) * w, rounded to x's
//     dtype to nearest even.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxVecs = 4;                  // vectors a thread keeps in registers
constexpr int kMaxThreads = 1024;
enum DType { kF32 = 0, kBF16 = 1 };          // = _DTYPES in ops/norms.py

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// N elements of T at p (aligned to N * sizeof(T) where that is 8 or a multiple
// of 16) as f32: 16-byte or 8-byte loads where the run fills them, else scalars.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&out)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[c];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < kPer; ++i) out[c * kPer + i] = to_f32(e[i]);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(p[i]);
  }
}

// N f32 values rounded to T and stored at p: one 16-byte store where N
// elements fill it, else scalars.
template <typename T, int N>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&v)[N]) {
  if constexpr (N * sizeof(T) == 16) {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) e[i] = from_f32<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = from_f32<T>(v[i]);
  }
}

// Grid (rows); block (threads). x, out: [rows, d] dense; w: [d]; d % VEC == 0,
// d / VEC <= threads * kMaxVecs.
template <typename TX, typename TW, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
rms_norm_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ out,
                int d, float eps) {
  __shared__ float warp_sums[kMaxThreads / 32];
  const int nvec = d / VEC;
  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  float v[kMaxVecs][VEC];
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxVecs; ++j) {
    const int c = threadIdx.x + j * blockDim.x;
    if (c < nvec) {
      load_vec<TX, VEC>(x + base + static_cast<size_t>(c) * VEC, v[j]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc = __fmaf_rn(v[j][e], v[j][e], acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = acc;
  __syncthreads();
  float total = 0.f;
  for (int i = 0; i < static_cast<int>(blockDim.x / 32); ++i) total = __fadd_rn(total, warp_sums[i]);
  const float ms = __fdiv_rn(total, static_cast<float>(d));
  const float r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(ms, eps)));
#pragma unroll
  for (int j = 0; j < kMaxVecs; ++j) {
    const int c = threadIdx.x + j * blockDim.x;
    if (c < nvec) {
      float wv[VEC], o[VEC];
      load_vec<TW, VEC>(w + static_cast<size_t>(c) * VEC, wv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[e] = __fmul_rn(__fmul_rn(v[j][e], r), wv[e]);
      store_vec<TX, VEC>(out + base + static_cast<size_t>(c) * VEC, o);
    }
  }
}

template <typename TX, typename TW, int VEC>
void launch(const void* x, const void* w, void* out, int rows, int d, float eps, int threads,
            cudaStream_t stream) {
  rms_norm_kernel<TX, TW, VEC><<<rows, threads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TX*>(out), d, eps);
}

template <typename TX>
void launch_x(const void* x, const void* w, void* out, int rows, int d, int w_dtype, int vec,
              float eps, int threads, cudaStream_t stream) {
  constexpr int kWide = 16 / sizeof(TX);
  if (w_dtype == kF32) {
    if (vec == 1) launch<TX, float, 1>(x, w, out, rows, d, eps, threads, stream);
    else launch<TX, float, kWide>(x, w, out, rows, d, eps, threads, stream);
  } else {
    if (vec == 1) launch<TX, __nv_bfloat16, 1>(x, w, out, rows, d, eps, threads, stream);
    else launch<TX, __nv_bfloat16, kWide>(x, w, out, rows, d, eps, threads, stream);
  }
}

}  // namespace

extern "C" {

// x, out: [rows, d] dense in x_dtype (0 f32, 1 bf16); w: [d] in w_dtype. vec:
// 1, or 16 / sizeof(x) with d % vec == 0 and x, w, out 16-byte aligned;
// threads: a multiple of 32, at most 1024, with d / vec <= threads * 4 (both
// from ops/norms.k4_plan). Returns the CUDA error code of the launch (0 =
// launched).
int rms_norm_launch(const void* x, const void* w, void* out, int rows, int d, int x_dtype,
                    int w_dtype, int vec, int threads, float eps, void* stream) {
  const int wide = x_dtype == kF32 ? 4 : 8;
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                          reinterpret_cast<uintptr_t>(out);
  if (rows < 1 || d < 1 || (x_dtype != kF32 && x_dtype != kBF16) ||
      (w_dtype != kF32 && w_dtype != kBF16) || (vec != 1 && vec != wide) || d % vec ||
      threads < 32 || threads > kMaxThreads || threads % 32 ||
      d / vec > threads * kMaxVecs || (vec != 1 && align % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32)
    launch_x<float>(x, w, out, rows, d, w_dtype, vec, eps, threads, s);
  else
    launch_x<__nv_bfloat16>(x, w, out, rows, d, w_dtype, vec, eps, threads, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
