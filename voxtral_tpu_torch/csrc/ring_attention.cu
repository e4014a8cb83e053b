// Ring-buffer GQA decode attention for Hopper (sm_90a): float rings (K1) and
// int8 rings with per-(slot, kv head) f32 scales (K1-int8).
//
// Replaces voxtral_tpu/ops/pallas_attention.py::ring_gqa_attention (the
// Pallas kernel, pallas_call at :314, body _kernel :113 -> _attend_block
// :45) in its decode regime: one query per stream (S = 1), K/V rings either
// in q's float dtype (f32 or bf16) or int8 with scales k_scale/v_scale laid
// out [B, Hkv, P] (the kernel's has_scales path, :74-75, :102-103), and
// optional extra columns in q's dtype (the decode chunk's own K/V).
//
// What it computes, per stream b and query head hq (kv head h = hq / group):
//   s_j = (q . k_j) / sqrt(hd) [* ks_j for int8 rings] over ring slots
//   j < nv and the Sx extra columns, masked by 0 <= pos_j <= q_pos and
//   pos_j >= q_pos - (window-1); one softmax over both; the denominator
//   sums the unscaled e_j; out = sum_j round(e_j [* vs_j]) v_j / denominator.
// Fully-masked rows return 0: the running max is floored at -5e29 and the
// denominator at 1e-30, as in the TPU kernel (:94-107). The probability
// column (times vs_j for int8 rings) is rounded to q's dtype before the PV
// product, as the TPU kernel feeds its matrix unit (:80-87, :102-104); int8
// codes convert exactly; accumulation is f32. The extra columns carry no
// scales.
//
// Bound: bytes. Per call the kernel must read the K/V rows below nv (and
// their scales), q and the positions, and write the output; its arithmetic
// is 4 flops per K/V element read, far below the card's ratio of operations
// to bytes. Float rings: 34 MB for B=1 and a full 8320-slot bf16 ring, ~10 us
// at 3.35 TB/s. Int8 rings halve the ring bytes: at the fleet's B=16 and a
// full 2080-slot ring, codes, scales, q and out come to ~70 MB, ~21 us.
//
// Design (split-KV, "flash decoding"):
//   * grid (splits, Hkv * ceil(group/4), B): a block owns one kv head, up
//     to 4 of its query heads, and 256 consecutive ring slots, so every K/V
//     byte is read once and shared by the group's query heads; the last
//     split index holds the extra columns;
//   * the read bound nv is a device int32 the blocks read themselves (no
//     host sync, safe inside a CUDA graph): blocks wholly past nv exit at
//     once, so early in a stream the kernel reads only the filled prefix;
//   * K/V rows are read with 16-byte vector loads (8 bf16, 4 f32 or 16 int8
//     elements), one row per 4-32 neighbouring threads, 2-4 rows in flight
//     per thread; int8 codes are converted in registers, so the ring is
//     never dequantized in device memory; a block reads its split's slice of
//     the scale rows once, into shared memory;
//   * each block writes its f32 (max, sum, unnormalised output); a second
//     small kernel merges the splits and writes the output in q's dtype.
// wgmma/TMA are not used: at one query row per head the product is
// matrix-vector work, and the bound is the memory, not the arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ring_common.cuh"

namespace {

using namespace ring_common;

constexpr int kThreads = 128;     // 4 warps per block
constexpr int kSplit = 256;       // ring slots per split (also max extra cols);
                                  // _SPLIT_SLOTS in ops/ring_attention.py
constexpr int kGroupBlock = 4;    // query heads per block (one warp each)

// rows in flight per thread (int8 rows carry 16 elements per load)
template <typename T> struct Unroll { static constexpr int N = 4; };
template <> struct Unroll<int8_t> { static constexpr int N = 2; };

// N consecutive elements as f32, in 16-byte loads
template <int N, typename T>
__device__ __forceinline__ void load_n(const T* p, float* out) {
  constexpr int W = VecWidth<T>::N;
  static_assert(N % W == 0, "whole 16-byte loads");
#pragma unroll
  for (int i = 0; i < N / W; ++i) load16(p + i * W, out + i * W);
}

// Query heads [g0, g0 + gb) of one kv head over `count` rows of one split.
// Rows are of element type R (the ring's, or T for the extra columns), with
// per-row f32 scales when SCALED. Writes the split's (max, sum,
// unnormalised output) per query head at part0 + g * n_parts.
template <typename T, typename R, int HD, bool SCALED>
__device__ __forceinline__ void attend_split(
    const T* __restrict__ qb, int gb, const R* __restrict__ kb,
    const R* __restrict__ vb, int kv_dim, const int* __restrict__ pb,
    const float* __restrict__ ksb, const float* __restrict__ vsb, int count,
    int qp, int lo, float scale, float (*s_p)[kSplit], float* s_ks,
    float* s_vs, float* s_red, size_t part0, int n_parts,
    float* __restrict__ o_part, float* __restrict__ m_part,
    float* __restrict__ l_part) {
  constexpr int VEC = VecWidth<R>::N;     // elements per 16-byte row load
  constexpr int TPR = HD / VEC;           // threads per K/V row
  constexpr int ROWS = kThreads / TPR;    // rows read side by side
  constexpr int UNROLL = Unroll<R>::N;
  static_assert(TPR >= 1 && TPR <= 32 && 32 % TPR == 0,
                "a K/V row must lie within one warp");

  const int tid = threadIdx.x;
  const int r = tid / TPR;                // row slot of this thread
  const int c = tid % TPR;                // 16-byte column of this thread

  if (SCALED) {                           // the split's scale slices, once
    for (int j = tid; j < count; j += kThreads) {
      s_ks[j] = __ldg(ksb + j);
      s_vs[j] = __ldg(vsb + j);
    }
    __syncthreads();
  }

  float qr[kGroupBlock][VEC];
#pragma unroll
  for (int g = 0; g < kGroupBlock; ++g) {
    if (g < gb) {
      load_n<VEC>(qb + (size_t)g * HD + c * VEC, qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[g][e] = 0.f;
    }
  }

  // Scores. Every lane of a warp runs the same trip count (the shuffles
  // need the whole warp); rows past `count` load nothing.
  for (int j0 = 0; j0 < count; j0 += ROWS * UNROLL) {
    float kr[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * ROWS + r;
      if (j < count) {
        load_n<VEC>(kb + (size_t)j * kv_dim + c * VEC, kr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kr[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float acc[kGroupBlock];
#pragma unroll
      for (int g = 0; g < kGroupBlock; ++g) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) a = fmaf(qr[g][e], kr[u][e], a);
        acc[g] = a;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int g = 0; g < kGroupBlock; ++g)
          acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], off);
      }
      const int j = j0 + u * ROWS + r;
      if (c == 0 && j < count) {
        const int p = __ldg(pb + j);
        const bool ok = p >= 0 && p <= qp && p >= lo;
        const float ks = SCALED ? s_ks[j] : 1.f;
#pragma unroll
        for (int g = 0; g < kGroupBlock; ++g) {
          float s = acc[g] * scale;
          if (SCALED) s *= ks;            // (q.k / sqrt(hd)) * ks_j
          s_p[g][j] = ok ? s : kNeg;
        }
      }
    }
  }
  __syncthreads();

  // Softmax statistics of this split, one warp per query head. Masked
  // scores are kNeg and the max is floored at kNeg/2, so their exp is 0.
  // The sum takes e_j before the V scale; the PV operand is e_j * vs_j in
  // q's dtype.
  const int warp = tid / 32;
  const int lane = tid % 32;
  if (warp < gb) {
    float m = 0.5f * kNeg;
    for (int j = lane; j < count; j += 32) m = fmaxf(m, s_p[warp][j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int j = lane; j < count; j += 32) {
      const float e = expf(s_p[warp][j] - m);
      l += e;
      s_p[warp][j] = round_to<T>(SCALED ? e * s_vs[j] : e);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      m_part[part0 + (size_t)warp * n_parts] = m;
      l_part[part0 + (size_t)warp * n_parts] = l;
    }
  }
  __syncthreads();

  // Unnormalised PV over this split's rows; rows whose probabilities are
  // all zero (masked) are not read.
  float acc[kGroupBlock][VEC];
#pragma unroll
  for (int g = 0; g < kGroupBlock; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  for (int j0 = r; j0 < count; j0 += ROWS * UNROLL) {
    float vr[UNROLL][VEC];
    float pr[UNROLL][kGroupBlock];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * ROWS;
      bool any = false;
#pragma unroll
      for (int g = 0; g < kGroupBlock; ++g) {
        pr[u][g] = (j < count && g < gb) ? s_p[g][j] : 0.f;
        any |= pr[u][g] != 0.f;
      }
      if (any) {
        load_n<VEC>(vb + (size_t)j * kv_dim + c * VEC, vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) vr[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int g = 0; g < kGroupBlock; ++g)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(pr[u][g], vr[u][e], acc[g][e]);
  }
  // s_red: [ROWS][kGroupBlock][HD]
#pragma unroll
  for (int g = 0; g < kGroupBlock; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e) s_red[(r * kGroupBlock + g) * HD + c * VEC + e] = acc[g][e];
  __syncthreads();
  for (int i = tid; i < gb * HD; i += kThreads) {
    const int g = i / HD;
    const int d = i % HD;
    float sum = 0.f;
#pragma unroll 8
    for (int rr = 0; rr < ROWS; ++rr) sum += s_red[(rr * kGroupBlock + g) * HD + d];
    o_part[(part0 + (size_t)g * n_parts) * HD + d] = sum;
  }
}

// One block: kv head h, query heads [g0, g0 + gb) of its group, and one
// split (256 ring slots, or the extra columns). R is the ring's element
// type: T (float rings) or int8_t (int8 rings with scales).
template <typename T, typename R, int HD>
__global__ void __launch_bounds__(kThreads)
ring_partial_kernel(const T* __restrict__ q, const R* __restrict__ k,
                    const R* __restrict__ v, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const int* __restrict__ slot_pos,
                    const int* __restrict__ q_pos, const T* __restrict__ xk,
                    const T* __restrict__ xv, const int* __restrict__ x_pos,
                    const int* __restrict__ n_valid, float* __restrict__ o_part,
                    float* __restrict__ m_part, float* __restrict__ l_part,
                    int P, int Sx, int H, int Hkv, int n_ring_splits,
                    int window, float scale) {
  constexpr bool kScaled = std::is_same<R, int8_t>::value;
  constexpr int kMaxVec = VecWidth<R>::N > VecWidth<T>::N ? VecWidth<R>::N
                                                          : VecWidth<T>::N;
  __shared__ float s_p[kGroupBlock][kSplit];          // scores, then probs
  __shared__ float s_ks[kScaled ? kSplit : 1];        // the split's scales
  __shared__ float s_vs[kScaled ? kSplit : 1];
  __shared__ float s_red[kThreads * kGroupBlock * kMaxVec];  // PV partial sums

  const int split = blockIdx.x;
  const int G = H / Hkv;
  const int gblocks = (G + kGroupBlock - 1) / kGroupBlock;
  const int h = blockIdx.y / gblocks;
  const int g0 = (blockIdx.y % gblocks) * kGroupBlock;
  const int gb = min(kGroupBlock, G - g0);
  const int b = blockIdx.z;
  const int kv_dim = Hkv * HD;
  const int n_parts = n_ring_splits + 1;
  const size_t part0 = ((size_t)b * H + h * G + g0) * n_parts + split;
  const T* qb = q + ((size_t)b * H + h * G + g0) * HD;
  const int qp = q_pos[b];
  const int lo = qp - (window - 1);

  const bool ring_rows = split < n_ring_splits;
  int start = 0;
  int count = Sx;
  if (ring_rows) {
    const int nv = min(*n_valid, P);
    start = split * kSplit;
    if (start >= nv) return;              // past the filled prefix
    count = min(kSplit, nv - start);
  }
  const size_t row0 = ring_rows ? (size_t)b * P + start : (size_t)b * Sx;
  const size_t col = row0 * kv_dim + h * HD;
  if constexpr (kScaled) {
    if (ring_rows) {
      const size_t sc0 = ((size_t)b * Hkv + h) * P + start;
      attend_split<T, R, HD, true>(qb, gb, k + col, v + col, kv_dim, slot_pos + row0,
                                   k_scale + sc0, v_scale + sc0, count, qp, lo, scale,
                                   s_p, s_ks, s_vs, s_red, part0, n_parts, o_part,
                                   m_part, l_part);
    } else {
      attend_split<T, T, HD, false>(qb, gb, xk + col, xv + col, kv_dim, x_pos + row0,
                                    nullptr, nullptr, count, qp, lo, scale, s_p, s_ks,
                                    s_vs, s_red, part0, n_parts, o_part, m_part, l_part);
    }
  } else {
    // float rings share the extra columns' type: one call site for both
    attend_split<T, T, HD, false>(qb, gb, (ring_rows ? k : xk) + col,
                                  (ring_rows ? v : xv) + col, kv_dim,
                                  (ring_rows ? slot_pos : x_pos) + row0, nullptr,
                                  nullptr, count, qp, lo, scale, s_p, s_ks, s_vs, s_red,
                                  part0, n_parts, o_part, m_part, l_part);
  }
}

// Merge the splits of one (stream, query head): one thread per output lane.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
ring_merge_kernel(const float* __restrict__ o_part, const float* __restrict__ m_part,
                  const float* __restrict__ l_part, const int* __restrict__ n_valid,
                  T* __restrict__ out, int P, int H, int n_ring_splits, int has_extra) {
  const int hq = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int nv = min(max(*n_valid, 0), P);
  const int n_act = (nv + kSplit - 1) / kSplit;
  const size_t base = ((size_t)b * H + hq) * (n_ring_splits + 1);

  float mx = 0.5f * kNeg;
  for (int s = 0; s < n_act; ++s) mx = fmaxf(mx, m_part[base + s]);
  if (has_extra) mx = fmaxf(mx, m_part[base + n_ring_splits]);
  float den = 0.f;
  float acc = 0.f;
  for (int s = 0; s < n_act; ++s) {
    const float w = expf(m_part[base + s] - mx);
    den = fmaf(w, l_part[base + s], den);
    acc = fmaf(w, o_part[(base + s) * HD + d], acc);
  }
  if (has_extra) {
    const size_t s = base + n_ring_splits;
    const float w = expf(m_part[s] - mx);
    den = fmaf(w, l_part[s], den);
    acc = fmaf(w, o_part[s * HD + d], acc);
  }
  out[((size_t)b * H + hq) * HD + d] = from_float<T>(acc / fmaxf(den, 1e-30f));
}

template <typename T, typename R, int HD>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* slot_pos, const void* q_pos,
           const void* xk, const void* xv, const void* x_pos, const void* n_valid,
           void* o_part, void* m_part, void* l_part, void* out, int B, int P, int Sx,
           int H, int Hkv, int window, float scale, cudaStream_t stream) {
  const int n_ring_splits = (P + kSplit - 1) / kSplit;
  const int has_extra = Sx > 0 ? 1 : 0;
  const int G = H / Hkv;
  const int gblocks = (G + kGroupBlock - 1) / kGroupBlock;
  const dim3 grid(n_ring_splits + has_extra, Hkv * gblocks, B);
  ring_partial_kernel<T, R, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const R*>(k), static_cast<const R*>(v),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(slot_pos), static_cast<const int*>(q_pos),
      static_cast<const T*>(xk), static_cast<const T*>(xv),
      static_cast<const int*>(x_pos), static_cast<const int*>(n_valid),
      static_cast<float*>(o_part), static_cast<float*>(m_part),
      static_cast<float*>(l_part), P, Sx, H, Hkv, n_ring_splits, window, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ring_merge_kernel<T, HD><<<dim3(H, B), HD, 0, stream>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(m_part),
      static_cast<const float*>(l_part), static_cast<const int*>(n_valid),
      static_cast<T*>(out), P, H, n_ring_splits, has_extra);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename R>
int launch_hd(int head_dim, const void* q, const void* k, const void* v,
              const void* k_scale, const void* v_scale, const void* slot_pos,
              const void* q_pos, const void* xk, const void* xv, const void* x_pos,
              const void* n_valid, void* o_part, void* m_part, void* l_part, void* out,
              int B, int P, int Sx, int H, int Hkv, int window, float scale,
              cudaStream_t stream) {
#define VOX_HD_CASE(N)                                                               \
  case N:                                                                            \
    return launch<T, R, N>(q, k, v, k_scale, v_scale, slot_pos, q_pos, xk, xv, x_pos, \
                           n_valid, o_part, m_part, l_part, out, B, P, Sx, H, Hkv,   \
                           window, scale, stream);
  switch (head_dim) {
    VOX_HD_CASE(64)
    VOX_HD_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VOX_HD_CASE
}

template <typename T>
int launch_ring(int ring, int head_dim, const void* q, const void* k, const void* v,
                const void* k_scale, const void* v_scale, const void* slot_pos,
                const void* q_pos, const void* xk, const void* xv, const void* x_pos,
                const void* n_valid, void* o_part, void* m_part, void* l_part,
                void* out, int B, int P, int Sx, int H, int Hkv, int window,
                float scale, cudaStream_t stream) {
  if (ring == 0)
    return launch_hd<T, T>(head_dim, q, k, v, k_scale, v_scale, slot_pos, q_pos, xk, xv,
                           x_pos, n_valid, o_part, m_part, l_part, out, B, P, Sx, H,
                           Hkv, window, scale, stream);
  if (ring == 1)
    return launch_hd<T, int8_t>(head_dim, q, k, v, k_scale, v_scale, slot_pos, q_pos,
                                xk, xv, x_pos, n_valid, o_part, m_part, l_part, out, B,
                                P, Sx, H, Hkv, window, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, extra columns and out alike).
// ring: 0 = K/V rings in q's dtype (K1); 1 = int8 rings with f32 scales
// k_scale/v_scale [B, Hkv, P] (K1-int8). Pointers are device pointers;
// n_valid is a device int32 scalar. The partial buffers hold
// [B, H, ceil(P / kSplit) + 1] entries (x HD for o_part), kSplit = 256; Sx
// must not exceed kSplit. head_dim is 64 or 128. Returns the CUDA error code
// of the launches (0 = launched).
int ring_gqa_attention_launch(int dtype, int ring, int head_dim, const void* q,
                              const void* k, const void* v, const void* k_scale,
                              const void* v_scale, const void* slot_pos,
                              const void* q_pos, const void* xk, const void* xv,
                              const void* x_pos, const void* n_valid, void* o_part,
                              void* m_part, void* l_part, void* out, int B, int P,
                              int Sx, int H, int Hkv, int window, float scale,
                              void* stream) {
  if (Sx > kSplit || Hkv <= 0 || H % Hkv != 0 || B <= 0 || P <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_ring<float>(ring, head_dim, q, k, v, k_scale, v_scale, slot_pos, q_pos,
                              xk, xv, x_pos, n_valid, o_part, m_part, l_part, out, B, P,
                              Sx, H, Hkv, window, scale, s);
  if (dtype == 1)
    return launch_ring<__nv_bfloat16>(ring, head_dim, q, k, v, k_scale, v_scale,
                                      slot_pos, q_pos, xk, xv, x_pos, n_valid, o_part,
                                      m_part, l_part, out, B, P, Sx, H, Hkv, window,
                                      scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
