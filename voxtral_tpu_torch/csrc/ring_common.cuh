// Shared by the ring attention kernels (ring_attention.cu, ring_attention_enc.cu):
// 16-byte loads of a row's elements as f32, and the rounding of the TPU
// kernel's contract (voxtral_tpu/ops/pallas_attention.py:_attend_block):
// probabilities are rounded to q's dtype before the PV product, as the TPU
// kernel feeds its matrix unit, and the masked-score sentinel is -1e30 with
// the running max floored at half of it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ring_common {

constexpr float kNeg = -1e30f;

// elements per 16-byte load
template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int N = 4; };
template <> struct VecWidth<__nv_bfloat16> { static constexpr int N = 8; };
template <> struct VecWidth<int8_t> { static constexpr int N = 16; };

// bf16 and int8 rows are read through the non-coherent path (__ldg); f32
// rows with a plain load (each measured faster that way on the H100 in the
// decode kernel).
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load16(const int8_t* p, float* out) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  const char4* c = reinterpret_cast<const char4*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[4 * i] = c[i].x;
    out[4 * i + 1] = c[i].y;
    out[4 * i + 2] = c[i].z;
    out[4 * i + 3] = c[i].w;
  }
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded to T (round to nearest even) and back to f32
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

}  // namespace ring_common
