// RMSNorm for Hopper (sm_90a): K4, a hand kernel with no Pallas counterpart,
// and its fused form with the residual add and the ada scale.
//
// The JAX package computes rms_norm as an XLA fusion (voxtral_tpu/ops/norms.py:14-19):
//   out = (f32(x) * rsqrt(mean(f32(x)^2) + eps) * f32(w)).astype(x.dtype)
// over the last axis. Here it is one launch on x [rows, D] (bf16 or f32), w [D]
// (bf16 or f32) and out [rows, D] in x's dtype. On the TPU, XLA also fuses the
// layer's residual add before the norm and the `* (1 + ada)` after it
// (voxtral_tpu/models/decoder.py:477-479, encoder.py:277-279); the fused form
// does the same in one launch: h_new = h + delta, out = rms_norm(h_new, w)
// (* scale). Every decoder token step makes 1 + 52 such calls and every
// encoder chunk 1 + 64: each pass's first norm is plain, every later one
// takes the previous sublayer's output as delta.
//
// Why a kernel: the plain PyTorch version is nine eager launches a call, and on
// CUDA torch.mean shapes its thread block by the row count, so a row's f32 sum
// of squares runs in another order at another row count and now and then the
// bf16 output rounds apart. A stream's tokens then follow how many rows its
// call holds (a data rank's share of the fleet). Nothing about a row's answer
// should depend on its neighbours. The fused form takes the add and the
// multiply's two more eager launches off every call.
//
// Bound: bytes. x is read once and out written once (2 rows D itemsize) and w
// once; the fused form also reads delta and writes h_new (4 rows D itemsize)
// and reads the scale; four or five f32 operations an element are far below
// the card's rate. At decode shapes (1-16 rows of 3072) the call is held by
// launch latency, so what the fusion saves there is whole launches.
//
// Design: the order of every f32 operation is a function of D and the dtype
// alone (ops/norms.k4_plan), never of the row count:
//   * one row per block, `threads` threads a block (a multiple of 32);
//   * thread t owns the VEC-element vectors t, t + threads, t + 2 threads, ...
//     (at most kMaxVecs), read with 16-byte loads (VEC = 16 / itemsize) when D
//     is a multiple of VEC, else one element at a time (the scalar path for an
//     odd width). The fused form adds delta's vector in f32 and rounds to x's
//     dtype (torch's `h + delta`) in registers and stores h_new from them, so
//     the squares see exactly the values the unfused chain's K4 reads. It
//     keeps them in registers and sums their squares in f32, vector by vector
//     and element by element, one fma each; the weight's (and the scale's)
//     vectors are loaded then, before the block-wide sum that does not need them
//     (after it for rows of more than 2048 vectors, where they would spill);
//   * a warp adds its lanes' sums by a fixed xor-shuffle tree (16, 8, 4, 2, 1;
//     a + b and b + a round alike, so every lane ends with the same bits), lane
//     0 writes the warp's sum to shared memory, and every thread adds the
//     warps' sums in warp order;
//   * ms = sum / D, r = 1 / sqrt(ms + eps) (IEEE division and square root, as
//     the plain version's rsqrt on the CPU), out = (x * r) * w, rounded to x's
//     dtype to nearest even; with a scale, that rounded value times the scale
//     in f32, rounded again (torch's `x * scale`).
// So the fused launch equals the unfused chain (torch add, K4, torch mul) bit
// for bit, and a row's bits still never depend on the row count.

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
// d / VEC <= threads * NV (NV vectors a thread at most). RESID: x is h, delta
// [rows, d] is added element by element (f32 add, rounded to TX as torch's
// `h + delta`) before the squares, and the sum h_new is stored to h_out from
// the same registers. SCALE: the norm output is rounded to TX, then multiplied
// by scale [d] (TX) in f32 and rounded again, as torch's `x * scale`.
// Slots j >= NV hold no vector (c >= NV * threads >= d / VEC), so NV shortens
// the loops without changing the order of any operation.
template <typename TX, typename TW, int VEC, int NV, bool RESID, bool SCALE>
__global__ void __launch_bounds__(kMaxThreads)
rms_norm_kernel(const TX* __restrict__ x, const TX* __restrict__ delta,
                const TW* __restrict__ w, const TX* __restrict__ scale,
                TX* __restrict__ h_out, TX* __restrict__ out, int d, float eps) {
  static_assert(NV <= kMaxVecs, "at most kMaxVecs vectors a thread");
  // The weight and the scale do not depend on the sum: loaded before it, they
  // are in flight across it. At kMaxVecs vectors a thread (rows of more than
  // 2048 vectors) those registers would spill, so they are loaded after it.
  constexpr bool kEarly = NV < kMaxVecs;
  __shared__ float warp_sums[kMaxThreads / 32];
  const int nvec = d / VEC;
  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  float v[NV][VEC], wv[NV][VEC], sv[NV][VEC];
  float acc = 0.f;
  auto load_ws = [&](int j, int c) {
    load_vec<TW, VEC>(w + static_cast<size_t>(c) * VEC, wv[j]);
    if constexpr (SCALE) load_vec<TX, VEC>(scale + static_cast<size_t>(c) * VEC, sv[j]);
  };
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = threadIdx.x + j * blockDim.x;
    if (c < nvec) {
      const size_t at = base + static_cast<size_t>(c) * VEC;
      load_vec<TX, VEC>(x + at, v[j]);
      if constexpr (RESID) {
        float dv[VEC];
        load_vec<TX, VEC>(delta + at, dv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[j][e] = to_f32(from_f32<TX>(__fadd_rn(v[j][e], dv[e])));
        store_vec<TX, VEC>(h_out + at, v[j]);        // exact: v holds TX values
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc = __fmaf_rn(v[j][e], v[j][e], acc);
      if constexpr (kEarly) load_ws(j, c);
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
  for (int j = 0; j < NV; ++j) {
    const int c = threadIdx.x + j * blockDim.x;
    if (c < nvec) {
      if constexpr (!kEarly) load_ws(j, c);
      float o[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        o[e] = __fmul_rn(__fmul_rn(v[j][e], r), wv[j][e]);
        if constexpr (SCALE) o[e] = __fmul_rn(to_f32(from_f32<TX>(o[e])), sv[j][e]);
      }
      store_vec<TX, VEC>(out + base + static_cast<size_t>(c) * VEC, o);
    }
  }
}

struct Args {
  const void* x;
  const void* delta;          // null: plain K4
  const void* w;
  const void* scale;          // null: no scale
  void* h_out;
  void* out;
  int rows, d;
  float eps;
  int threads;
  cudaStream_t stream;
};

template <typename TX, typename TW, int VEC, int NV, bool RESID, bool SCALE>
void launch(const Args& a) {
  rms_norm_kernel<TX, TW, VEC, NV, RESID, SCALE><<<a.rows, a.threads, 0, a.stream>>>(
      static_cast<const TX*>(a.x), static_cast<const TX*>(a.delta),
      static_cast<const TW*>(a.w), static_cast<const TX*>(a.scale), static_cast<TX*>(a.h_out),
      static_cast<TX*>(a.out), a.d, a.eps);
}

// NV = 2 covers every row that k4_plan does not cap at 1024 threads (it gives
// about two vectors a thread); wider rows take up to kMaxVecs.
template <typename TX, typename TW, int VEC, bool RESID, bool SCALE>
void launch_nv(const Args& a, int vec) {
  if (a.d / vec <= 2 * a.threads) launch<TX, TW, VEC, 2, RESID, SCALE>(a);
  else launch<TX, TW, VEC, kMaxVecs, RESID, SCALE>(a);
}

template <typename TX, typename TW, bool RESID, bool SCALE>
void launch_vec(const Args& a, int vec) {
  if (vec == 1) launch_nv<TX, TW, 1, RESID, SCALE>(a, vec);
  else launch_nv<TX, TW, static_cast<int>(16 / sizeof(TX)), RESID, SCALE>(a, vec);
}

template <bool RESID, bool SCALE>
void launch_types(const Args& a, int x_dtype, int w_dtype, int vec) {
  if (x_dtype == kF32) {
    if (w_dtype == kF32) launch_vec<float, float, RESID, SCALE>(a, vec);
    else launch_vec<float, __nv_bfloat16, RESID, SCALE>(a, vec);
  } else {
    if (w_dtype == kF32) launch_vec<__nv_bfloat16, float, RESID, SCALE>(a, vec);
    else launch_vec<__nv_bfloat16, __nv_bfloat16, RESID, SCALE>(a, vec);
  }
}

// The launch's checks: dtypes, the plan (vec, threads) against d,
// and 16-byte alignment of every pointer the vector path reads or writes.
bool valid(const Args& a, int x_dtype, int w_dtype, int vec) {
  const int wide = x_dtype == kF32 ? 4 : 8;
  const uintptr_t align = reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.delta) |
                          reinterpret_cast<uintptr_t>(a.w) | reinterpret_cast<uintptr_t>(a.scale) |
                          reinterpret_cast<uintptr_t>(a.h_out) |
                          reinterpret_cast<uintptr_t>(a.out);
  return !(a.rows < 1 || a.d < 1 || (x_dtype != kF32 && x_dtype != kBF16) ||
           (w_dtype != kF32 && w_dtype != kBF16) || (vec != 1 && vec != wide) || a.d % vec ||
           a.threads < 32 || a.threads > kMaxThreads || a.threads % 32 ||
           a.d / vec > a.threads * kMaxVecs || (vec != 1 && align % 16));
}

}  // namespace

extern "C" {

// K4's one entry. x, out: [rows, d] dense in x_dtype (0 f32, 1 bf16); w: [d] in
// w_dtype. delta and h_out: null for the plain norm, or [rows, d] dense in
// x_dtype for the fused form (h_out = x + delta, out = rms_norm(h_out, w));
// scale: null, or [d] in x_dtype with delta (out *= scale). vec: 1, or 16 /
// sizeof(x) with d % vec == 0 and every pointer 16-byte aligned; threads: a
// multiple of 32, at most 1024, with d / vec <= threads * 4 (both from
// ops/norms.k4_plan). Returns the CUDA error code of the launch (0 = launched).
int k4_launch(const void* x, const void* delta, const void* w, const void* scale, void* h_out,
              void* out, int rows, int d, int x_dtype, int w_dtype, int vec, int threads,
              float eps, void* stream) {
  const Args a{x, delta, w, scale, h_out, out, rows, d, eps, threads,
               static_cast<cudaStream_t>(stream)};
  if ((delta == nullptr) != (h_out == nullptr) || (delta == nullptr && scale != nullptr) ||
      !valid(a, x_dtype, w_dtype, vec))
    return static_cast<int>(cudaErrorInvalidValue);
  if (delta == nullptr) launch_types<false, false>(a, x_dtype, w_dtype, vec);
  else if (scale == nullptr) launch_types<true, false>(a, x_dtype, w_dtype, vec);
  else launch_types<true, true>(a, x_dtype, w_dtype, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
