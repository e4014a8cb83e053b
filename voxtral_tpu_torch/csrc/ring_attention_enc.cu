// Ring-buffer attention for Hopper (sm_90a), encoder regime (K1-enc): S
// queries per stream against a ring that is float, int8 with scales, or
// int4-packed with scales, plus the chunk's own float K/V as extra columns.
//
// Replaces voxtral_tpu/ops/pallas_attention.py::ring_gqa_attention (the
// Pallas kernel, pallas_call at :314, body _kernel :113 -> _attend_block
// :45) in its encoder regime: S > 1 queries per stream (the encoder chunk),
// per-head path (:191-198), float rings, int8 rings with per-(slot, head)
// f32 scales [B, Hkv, P], or nibble-packed int4 rings (:147-163; halves
// packing of voxtral_tpu/quant.py:quantize_kv_int4: byte c of a head holds
// lane c in its low nibble and lane c + hd/2 in its high nibble, both
// signed). The wrapper also sends here any call with packed rings.
//
// What it computes, per stream b, query head hq (kv head h = hq / group)
// and query row i: s_j = (q_i . k_j) / sqrt(hd) [* ks_j] over ring slots
// j < nv and the Sx extra columns, masked by 0 <= pos_j <= q_pos_i and
// pos_j >= q_pos_i - (window-1); one softmax over both; the denominator sums
// the unscaled e_j; out_i = sum_j round(e_j [* vs_j]) v_j / denominator,
// with the probability column rounded to q's dtype as the TPU kernel feeds
// its matrix unit. The extra columns carry no scales. Fully-masked rows
// (padding rows, inactive streams) return 0: the max is floored at -5e29 and
// the denominator at 1e-30.
//
// Bound: bytes and operations are of one order here. At the fleet's B=16
// (Hq 32, hd 64, S 80, a full 928-slot int4 ring, 80 extra columns) the
// kernel must read ~55 MB (~16 us at 3.35 TB/s) and do 10.6 GFLOP
// (~11 us at the 989 TFLOP/s dense bf16 tensor-core rate).
//
// Design (FA2-style, CUDA cores, right before fast):
//   * one block per (tile of up to 64 query rows, query head, stream);
//     hd/32 neighbouring threads own one query row, 32 of its lanes each,
//     with q and the unnormalised output in registers;
//   * a loop over ring tiles of 32 slots below the device-side read bound
//     nv (no host sync; slots at or past nv are never read), then over the
//     extra columns: the block stages each K/V tile in shared memory as
//     f32, after an in-register convert (float, int8) or nibble unpack
//     (int4: two arithmetic shifts), with its positions and scales;
//   * an online softmax in f32 (running max and sum per row); the
//     probabilities are rounded to q's dtype against the running max,
//     where the TPU kernel uses the row's global max;
//   * each thread reads its lanes of a staged row in 16-byte chunks
//     interleaved with its neighbours', so the threads of a row hit
//     distinct banks and the rows of a warp share the same addresses.
// Tensor cores (mma.sync / wgmma) and TMA are not used yet: the kernel sits
// well above its bound (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ring_common.cuh"

namespace {

using namespace ring_common;

constexpr int kRowsPerBlock = 64;   // query rows per block
constexpr int kKeyTile = 32;        // K/V rows staged per pass
constexpr int kLanes = 32;          // lanes of a head per thread
constexpr int kChunks = kLanes / 4; // 16-byte f32 chunks per thread
constexpr int kPosInvalid = -(1 << 30);

enum RingKind { kFloatRing = 0, kInt8Ring = 1, kInt4Ring = 2 };

__device__ __forceinline__ void load4(const float* p, float* out) { load16(p, out); }

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

__device__ __forceinline__ void store4(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
}

// Lane of chunk element (i, e) owned by thread `part` of a row: 16-byte
// chunks interleaved across the row's TPR threads.
template <int TPR>
__device__ __forceinline__ int lane_of(int part, int i) { return 4 * (part + TPR * i); }

// Stage rows [t0, t0 + n) of one head into s_k/s_v ([kKeyTile][HD] f32),
// zeros past n. Float rows of element type T (HD lanes each, `stride`
// elements apart).
template <typename T, int HD>
__device__ __forceinline__ void stage_float(const T* __restrict__ kb, const T* __restrict__ vb,
                                            size_t stride, int n, float* s_k, float* s_v) {
  constexpr int W = VecWidth<T>::N;
  constexpr int PER_ROW = HD / W;
  for (int idx = threadIdx.x; idx < kKeyTile * PER_ROW; idx += blockDim.x) {
    const int j = idx / PER_ROW;
    const int c = (idx % PER_ROW) * W;
    float kr[W], vr[W];
    if (j < n) {
      load16(kb + j * stride + c, kr);
      load16(vb + j * stride + c, vr);
    } else {
#pragma unroll
      for (int e = 0; e < W; ++e) kr[e] = vr[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < W; e += 4) {
      store4(s_k + j * HD + c + e, kr + e);
      store4(s_v + j * HD + c + e, vr + e);
    }
  }
}

// int8 rows: 16 codes per 16-byte load, converted in registers.
template <int HD>
__device__ __forceinline__ void stage_int8(const int8_t* __restrict__ kb,
                                           const int8_t* __restrict__ vb, size_t stride,
                                           int n, float* s_k, float* s_v) {
  constexpr int PER_ROW = HD / 16;
  for (int idx = threadIdx.x; idx < kKeyTile * PER_ROW; idx += blockDim.x) {
    const int j = idx / PER_ROW;
    const int c = (idx % PER_ROW) * 16;
    int4 kw = make_int4(0, 0, 0, 0), vw = make_int4(0, 0, 0, 0);
    if (j < n) {
      kw = *reinterpret_cast<const int4*>(kb + j * stride + c);
      vw = *reinterpret_cast<const int4*>(vb + j * stride + c);
    }
    const int8_t* kc = reinterpret_cast<const int8_t*>(&kw);
    const int8_t* vc = reinterpret_cast<const int8_t*>(&vw);
    float kr[16], vr[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      kr[e] = kc[e];
      vr[e] = vc[e];
    }
#pragma unroll
    for (int e = 0; e < 16; e += 4) {
      store4(s_k + j * HD + c + e, kr + e);
      store4(s_v + j * HD + c + e, vr + e);
    }
  }
}

// int4-packed rows: HD/2 bytes per head; byte c -> lanes c (low nibble) and
// c + HD/2 (high nibble), each sign-extended by two arithmetic shifts.
template <int HD>
__device__ __forceinline__ void stage_int4(const int8_t* __restrict__ kb,
                                           const int8_t* __restrict__ vb, size_t stride,
                                           int n, float* s_k, float* s_v) {
  constexpr int PER_ROW = HD / 32;       // 16-byte loads per packed head row
  for (int idx = threadIdx.x; idx < kKeyTile * PER_ROW; idx += blockDim.x) {
    const int j = idx / PER_ROW;
    const int c = (idx % PER_ROW) * 16;
    int4 kw = make_int4(0, 0, 0, 0), vw = make_int4(0, 0, 0, 0);
    if (j < n) {
      kw = *reinterpret_cast<const int4*>(kb + j * stride + c);
      vw = *reinterpret_cast<const int4*>(vb + j * stride + c);
    }
    const int8_t* kc = reinterpret_cast<const int8_t*>(&kw);
    const int8_t* vc = reinterpret_cast<const int8_t*>(&vw);
    float k_lo[16], k_hi[16], v_lo[16], v_hi[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int32_t kx = kc[e];
      const int32_t vx = vc[e];
      k_lo[e] = static_cast<float>((int32_t)((uint32_t)kx << 28) >> 28);
      v_lo[e] = static_cast<float>((int32_t)((uint32_t)vx << 28) >> 28);
      k_hi[e] = static_cast<float>(kx >> 4);
      v_hi[e] = static_cast<float>(vx >> 4);
    }
#pragma unroll
    for (int e = 0; e < 16; e += 4) {
      store4(s_k + j * HD + c + e, k_lo + e);
      store4(s_v + j * HD + c + e, v_lo + e);
      store4(s_k + j * HD + c + e + HD / 2, k_hi + e);
      store4(s_v + j * HD + c + e + HD / 2, v_hi + e);
    }
  }
}

// One staged tile through the online softmax of this thread's row.
template <typename T, int HD, bool SCALED>
__device__ __forceinline__ void attend_tile(const float* s_k, const float* s_v,
                                            const int* s_pos, const float* s_ks,
                                            const float* s_vs, const float (&qr)[kLanes],
                                            float (&o)[kLanes], float& m_run, float& l_run,
                                            int part, int qp, int lo, float scale) {
  constexpr int TPR = HD / kLanes;
  float s[kKeyTile];
#pragma unroll
  for (int j = 0; j < kKeyTile; ++j) {
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const float4 k4 = *reinterpret_cast<const float4*>(s_k + j * HD + lane_of<TPR>(part, i));
      a = fmaf(qr[4 * i], k4.x, a);
      a = fmaf(qr[4 * i + 1], k4.y, a);
      a = fmaf(qr[4 * i + 2], k4.z, a);
      a = fmaf(qr[4 * i + 3], k4.w, a);
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
    s[j] = a;
  }
  float m_new = m_run;
#pragma unroll
  for (int j = 0; j < kKeyTile; ++j) {
    const int p = s_pos[j];
    const bool ok = p >= 0 && p <= qp && p >= lo;
    float x = s[j] * scale;
    if (SCALED) x *= s_ks[j];             // (q.k / sqrt(hd)) * ks_j
    s[j] = ok ? x : kNeg;
    m_new = fmaxf(m_new, s[j]);
  }
  const float alpha = expf(m_run - m_new);
  l_run *= alpha;
#pragma unroll
  for (int d = 0; d < kLanes; ++d) o[d] *= alpha;
#pragma unroll
  for (int j = 0; j < kKeyTile; ++j) {
    const float e = expf(s[j] - m_new);
    l_run += e;
    const float pe = round_to<T>(SCALED ? e * s_vs[j] : e);
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const float4 v4 = *reinterpret_cast<const float4*>(s_v + j * HD + lane_of<TPR>(part, i));
      o[4 * i] = fmaf(pe, v4.x, o[4 * i]);
      o[4 * i + 1] = fmaf(pe, v4.y, o[4 * i + 1]);
      o[4 * i + 2] = fmaf(pe, v4.z, o[4 * i + 2]);
      o[4 * i + 3] = fmaf(pe, v4.w, o[4 * i + 3]);
    }
  }
  m_run = m_new;
}

template <typename T, int HD, int RING>
__global__ void __launch_bounds__(kRowsPerBlock * HD / kLanes)
ring_enc_kernel(const T* __restrict__ q, const void* __restrict__ k_ring,
                const void* __restrict__ v_ring, const float* __restrict__ k_scale,
                const float* __restrict__ v_scale, const int* __restrict__ slot_pos,
                const int* __restrict__ q_pos, const T* __restrict__ xk,
                const T* __restrict__ xv, const int* __restrict__ x_pos,
                const int* __restrict__ n_valid, T* __restrict__ out, int S, int P,
                int Sx, int H, int Hkv, int window, float scale) {
  constexpr int TPR = HD / kLanes;        // threads per query row
  constexpr bool kScaled = RING != kFloatRing;
  __shared__ __align__(16) float s_k[kKeyTile * HD];
  __shared__ __align__(16) float s_v[kKeyTile * HD];
  __shared__ int s_pos[kKeyTile];
  __shared__ float s_ks[kKeyTile];
  __shared__ float s_vs[kKeyTile];

  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int h = hq / (H / Hkv);
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  const bool live = row < S;              // ragged edge: masked, not written
  const int qp = live ? q_pos[(size_t)b * S + row] : kPosInvalid;
  const int lo = qp - (window - 1);
  const int nv = min(max(*n_valid, 0), P);
  const int q_dim = H * HD;
  const int kv_dim = Hkv * HD;

  float qr[kLanes], o[kLanes];
  const T* qrow = q + ((size_t)b * S + (live ? row : 0)) * q_dim + hq * HD;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    if (live) {
      load4(qrow + lane_of<TPR>(part, i), qr + 4 * i);
    } else {
      qr[4 * i] = qr[4 * i + 1] = qr[4 * i + 2] = qr[4 * i + 3] = 0.f;
    }
  }
#pragma unroll
  for (int d = 0; d < kLanes; ++d) o[d] = 0.f;
  float m_run = 0.5f * kNeg;
  float l_run = 0.f;

  // ring slots below nv
  const int ring_w = RING == kInt4Ring ? kv_dim / 2 : kv_dim;     // elements per slot
  const int head_w = RING == kInt4Ring ? HD / 2 : HD;
  for (int t0 = 0; t0 < nv; t0 += kKeyTile) {
    const int n = min(kKeyTile, nv - t0);
    const size_t row0 = (size_t)b * P + t0;
    if (RING == kFloatRing) {
      stage_float<T, HD>(static_cast<const T*>(k_ring) + row0 * ring_w + h * head_w,
                         static_cast<const T*>(v_ring) + row0 * ring_w + h * head_w,
                         ring_w, n, s_k, s_v);
    } else if (RING == kInt8Ring) {
      stage_int8<HD>(static_cast<const int8_t*>(k_ring) + row0 * ring_w + h * head_w,
                     static_cast<const int8_t*>(v_ring) + row0 * ring_w + h * head_w,
                     ring_w, n, s_k, s_v);
    } else {
      stage_int4<HD>(static_cast<const int8_t*>(k_ring) + row0 * ring_w + h * head_w,
                     static_cast<const int8_t*>(v_ring) + row0 * ring_w + h * head_w,
                     ring_w, n, s_k, s_v);
    }
    for (int j = threadIdx.x; j < kKeyTile; j += blockDim.x) {
      s_pos[j] = j < n ? slot_pos[row0 + j] : kPosInvalid;
      if (kScaled) {
        const size_t sc = ((size_t)b * Hkv + h) * P + t0 + j;
        s_ks[j] = j < n ? k_scale[sc] : 1.f;
        s_vs[j] = j < n ? v_scale[sc] : 1.f;
      }
    }
    __syncthreads();
    attend_tile<T, HD, kScaled>(s_k, s_v, s_pos, s_ks, s_vs, qr, o, m_run, l_run, part,
                                qp, lo, scale);
    __syncthreads();
  }

  // the extra columns (float, no scales)
  for (int t0 = 0; t0 < Sx; t0 += kKeyTile) {
    const int n = min(kKeyTile, Sx - t0);
    const size_t row0 = (size_t)b * Sx + t0;
    stage_float<T, HD>(xk + row0 * kv_dim + h * HD, xv + row0 * kv_dim + h * HD, kv_dim,
                       n, s_k, s_v);
    for (int j = threadIdx.x; j < kKeyTile; j += blockDim.x)
      s_pos[j] = j < n ? x_pos[row0 + j] : kPosInvalid;
    __syncthreads();
    attend_tile<T, HD, false>(s_k, s_v, s_pos, s_ks, s_vs, qr, o, m_run, l_run, part, qp,
                              lo, scale);
    __syncthreads();
  }

  if (!live) return;
  const float inv = 1.f / fmaxf(l_run, 1e-30f);
  T* orow = out + ((size_t)b * S + row) * q_dim + hq * HD;
#pragma unroll
  for (int i = 0; i < kChunks; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      orow[lane_of<TPR>(part, i) + e] = from_float<T>(o[4 * i + e] * inv);
}

template <typename T, int HD, int RING>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* slot_pos, const void* q_pos, const void* xk,
           const void* xv, const void* x_pos, const void* n_valid, void* out, int B,
           int S, int P, int Sx, int H, int Hkv, int window, float scale,
           cudaStream_t stream) {
  const dim3 grid((S + kRowsPerBlock - 1) / kRowsPerBlock, H, B);
  ring_enc_kernel<T, HD, RING><<<grid, kRowsPerBlock * HD / kLanes, 0, stream>>>(
      static_cast<const T*>(q), k, v, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(slot_pos),
      static_cast<const int*>(q_pos), static_cast<const T*>(xk),
      static_cast<const T*>(xv), static_cast<const int*>(x_pos),
      static_cast<const int*>(n_valid), static_cast<T*>(out), S, P, Sx, H, Hkv,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int RING>
int launch_hd(int head_dim, const void* q, const void* k, const void* v,
              const void* k_scale, const void* v_scale, const void* slot_pos,
              const void* q_pos, const void* xk, const void* xv, const void* x_pos,
              const void* n_valid, void* out, int B, int S, int P, int Sx, int H,
              int Hkv, int window, float scale, cudaStream_t stream) {
#define VOX_HD_CASE(N)                                                                 \
  case N:                                                                              \
    return launch<T, N, RING>(q, k, v, k_scale, v_scale, slot_pos, q_pos, xk, xv, x_pos, \
                              n_valid, out, B, S, P, Sx, H, Hkv, window, scale, stream);
  switch (head_dim) {
    VOX_HD_CASE(64)       // the encoder's head width (voxtral_4b)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VOX_HD_CASE
}

template <typename T>
int launch_ring(int ring, int head_dim, const void* q, const void* k, const void* v,
                const void* k_scale, const void* v_scale, const void* slot_pos,
                const void* q_pos, const void* xk, const void* xv, const void* x_pos,
                const void* n_valid, void* out, int B, int S, int P, int Sx, int H,
                int Hkv, int window, float scale, cudaStream_t stream) {
#define VOX_RING_CASE(R)                                                              \
  case R:                                                                             \
    return launch_hd<T, R>(head_dim, q, k, v, k_scale, v_scale, slot_pos, q_pos, xk,  \
                           xv, x_pos, n_valid, out, B, S, P, Sx, H, Hkv, window,      \
                           scale, stream);
  switch (ring) {
    VOX_RING_CASE(kFloatRing)
    VOX_RING_CASE(kInt8Ring)
    VOX_RING_CASE(kInt4Ring)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VOX_RING_CASE
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, float rings, extra columns and out).
// ring: 0 = K/V rings in q's dtype [B, P, Hkv*hd]; 1 = int8 rings
// [B, P, Hkv*hd]; 2 = int4-packed rings [B, P, Hkv*hd/2]; 1 and 2 take f32
// scales k_scale/v_scale [B, Hkv, P]. q and out are [B, S, H*hd], q_pos
// [B, S], slot_pos [B, P], extra columns [B, Sx, Hkv*hd] with x_pos [B, Sx]
// (Sx may be 0). n_valid is a device int32 scalar. head_dim is 64.
// Returns the CUDA error code of the launch (0 = launched).
int ring_gqa_attention_enc_launch(int dtype, int ring, int head_dim, const void* q,
                                  const void* k, const void* v, const void* k_scale,
                                  const void* v_scale, const void* slot_pos,
                                  const void* q_pos, const void* xk, const void* xv,
                                  const void* x_pos, const void* n_valid, void* out,
                                  int B, int S, int P, int Sx, int H, int Hkv,
                                  int window, float scale, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || B <= 0 || S <= 0 || P <= 0 || Sx < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_ring<float>(ring, head_dim, q, k, v, k_scale, v_scale, slot_pos, q_pos,
                              xk, xv, x_pos, n_valid, out, B, S, P, Sx, H, Hkv, window,
                              scale, s);
  if (dtype == 1)
    return launch_ring<__nv_bfloat16>(ring, head_dim, q, k, v, k_scale, v_scale,
                                      slot_pos, q_pos, xk, xv, x_pos, n_valid, out, B, S,
                                      P, Sx, H, Hkv, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
