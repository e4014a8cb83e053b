// Ring-buffer GQA decode attention for Hopper (sm_90a), float rings.
//
// Replaces voxtral_tpu/ops/pallas_attention.py::ring_gqa_attention (the
// Pallas kernel, pallas_call at :314, body _kernel :113 -> _attend_block
// :45) in its decode regime: one query per stream (S = 1), float (f32 or
// bf16) K/V rings, optional extra columns (the decode chunk's own K/V).
//
// What it computes, per stream b and query head hq (kv head h = hq / group):
//   s_j = (q . k_j) / sqrt(hd) over ring slots j < nv and the Sx extra
//   columns, masked by 0 <= pos_j <= q_pos and pos_j >= q_pos - (window-1);
//   one softmax over both; out = sum_j p_j v_j.
// Fully-masked rows return 0: the running max is floored at -5e29 and the
// denominator at 1e-30, as in the TPU kernel (:94-107). In bf16 the
// unnormalised probabilities are rounded to bf16 before the PV product, as
// the TPU kernel feeds its matrix unit (:80-87); accumulation is f32.
//
// Bound: bytes. Per call the kernel must read 2 * B * nv * Hkv*hd elements
// of K/V (34 MB for B=1 and a full 8320-slot bf16 ring: ~10 us at
// 3.35 TB/s) plus the extra columns; its arithmetic is 4 flops per K/V
// element read, far below the card's ratio of operations to bytes.
//
// Design (split-KV, "flash decoding"):
//   * grid (splits, Hkv * ceil(group/4), B): a block owns one kv head, up
//     to 4 of its query heads, and 256 consecutive ring slots, so every K/V
//     byte is read once and shared by the group's query heads; the last
//     split index holds the extra columns;
//   * the read bound nv is a device int32 the blocks read themselves (no
//     host sync, safe inside a CUDA graph): blocks wholly past nv exit at
//     once, so early in a stream the kernel reads only the filled prefix;
//   * K/V rows are read with 16-byte vector loads, one row per 8-32
//     neighbouring threads, four rows in flight per thread;
//   * each block writes its f32 (max, sum, unnormalised output); a second
//     small kernel merges the splits and writes the output in q's dtype.
// wgmma/TMA are not used: at one query row per head the product is
// matrix-vector work, and the bound is the memory, not the arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // 4 warps per block
constexpr int kSplit = 256;       // ring slots per split (also max extra cols);
                                  // _SPLIT_SLOTS in ops/ring_attention.py
constexpr int kGroupBlock = 4;    // query heads per block (one warp each)
constexpr int kUnroll = 4;        // rows in flight per thread
constexpr float kNeg = -1e30f;

template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int N = 4; };
template <> struct VecWidth<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

// One block: kv head h, query heads [g0, g0 + gb) of its group, and `count`
// rows (ring slots of one split, or the extra columns).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
ring_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ slot_pos,
                    const int* __restrict__ q_pos, const T* __restrict__ xk,
                    const T* __restrict__ xv, const int* __restrict__ x_pos,
                    const int* __restrict__ n_valid, float* __restrict__ o_part,
                    float* __restrict__ m_part, float* __restrict__ l_part,
                    int P, int Sx, int H, int Hkv, int n_ring_splits,
                    int window, float scale) {
  constexpr int VEC = VecWidth<T>::N;     // elements per 16-byte load
  constexpr int TPR = HD / VEC;           // threads per K/V row
  constexpr int ROWS = kThreads / TPR;    // rows read side by side
  static_assert(TPR >= 1 && TPR <= 32 && 32 % TPR == 0,
                "a K/V row must lie within one warp");

  __shared__ float s_p[kGroupBlock][kSplit];          // scores, then probs
  __shared__ float s_red[ROWS][kGroupBlock][HD];      // PV partial sums

  const int split = blockIdx.x;
  const int G = H / Hkv;
  const int gblocks = (G + kGroupBlock - 1) / kGroupBlock;
  const int h = blockIdx.y / gblocks;
  const int g0 = (blockIdx.y % gblocks) * kGroupBlock;
  const int gb = min(kGroupBlock, G - g0);
  const int b = blockIdx.z;
  const int kv_dim = Hkv * HD;

  const T* kb;
  const T* vb;
  const int* pb;
  int count;
  if (split < n_ring_splits) {
    const int nv = min(*n_valid, P);
    const int start = split * kSplit;
    if (start >= nv) return;              // past the filled prefix
    count = min(kSplit, nv - start);
    kb = k + ((size_t)b * P + start) * kv_dim + h * HD;
    vb = v + ((size_t)b * P + start) * kv_dim + h * HD;
    pb = slot_pos + (size_t)b * P + start;
  } else {
    count = Sx;
    kb = xk + (size_t)b * Sx * kv_dim + h * HD;
    vb = xv + (size_t)b * Sx * kv_dim + h * HD;
    pb = x_pos + (size_t)b * Sx;
  }
  const int qp = q_pos[b];
  const int lo = qp - (window - 1);

  const int tid = threadIdx.x;
  const int r = tid / TPR;                // row slot of this thread
  const int c = tid % TPR;                // 16-byte column of this thread

  float qr[kGroupBlock][VEC];
#pragma unroll
  for (int g = 0; g < kGroupBlock; ++g) {
    if (g < gb) {
      load16(q + ((size_t)b * H + h * G + g0 + g) * HD + c * VEC, qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[g][e] = 0.f;
    }
  }

  // Scores. Every lane of a warp runs the same trip count (the shuffles
  // need the whole warp); rows past `count` load nothing.
  for (int j0 = 0; j0 < count; j0 += ROWS * kUnroll) {
    float kr[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * ROWS + r;
      if (j < count) {
        load16(kb + (size_t)j * kv_dim + c * VEC, kr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kr[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
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
        const int p = pb[j];
        const bool ok = p >= 0 && p <= qp && p >= lo;
#pragma unroll
        for (int g = 0; g < kGroupBlock; ++g) s_p[g][j] = ok ? acc[g] * scale : kNeg;
      }
    }
  }
  __syncthreads();

  // Softmax statistics of this split, one warp per query head. Masked
  // scores are kNeg and the max is floored at kNeg/2, so their exp is 0.
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
      s_p[warp][j] = round_to<T>(e);    // PV operand in V's dtype
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      const size_t part = ((size_t)b * H + h * G + g0 + warp) * (n_ring_splits + 1) + split;
      m_part[part] = m;
      l_part[part] = l;
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
  for (int j0 = r; j0 < count; j0 += ROWS * kUnroll) {
    float vr[kUnroll][VEC];
    float pr[kUnroll][kGroupBlock];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * ROWS;
      bool any = false;
#pragma unroll
      for (int g = 0; g < kGroupBlock; ++g) {
        pr[u][g] = (j < count && g < gb) ? s_p[g][j] : 0.f;
        any |= pr[u][g] != 0.f;
      }
      if (any) {
        load16(vb + (size_t)j * kv_dim + c * VEC, vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) vr[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int g = 0; g < kGroupBlock; ++g)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(pr[u][g], vr[u][e], acc[g][e]);
  }
#pragma unroll
  for (int g = 0; g < kGroupBlock; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e) s_red[r][g][c * VEC + e] = acc[g][e];
  __syncthreads();
  for (int i = tid; i < gb * HD; i += kThreads) {
    const int g = i / HD;
    const int d = i % HD;
    float sum = 0.f;
#pragma unroll 8
    for (int rr = 0; rr < ROWS; ++rr) sum += s_red[rr][g][d];
    const size_t part = ((size_t)b * H + h * G + g0 + g) * (n_ring_splits + 1) + split;
    o_part[part * HD + d] = sum;
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

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* slot_pos,
           const void* q_pos, const void* xk, const void* xv, const void* x_pos,
           const void* n_valid, void* o_part, void* m_part, void* l_part, void* out,
           int B, int P, int Sx, int H, int Hkv, int window, float scale,
           cudaStream_t stream) {
  const int n_ring_splits = (P + kSplit - 1) / kSplit;
  const int has_extra = Sx > 0 ? 1 : 0;
  const int G = H / Hkv;
  const int gblocks = (G + kGroupBlock - 1) / kGroupBlock;
  const dim3 grid(n_ring_splits + has_extra, Hkv * gblocks, B);
  ring_partial_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
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

template <typename T>
int launch_hd(int head_dim, const void* q, const void* k, const void* v,
              const void* slot_pos, const void* q_pos, const void* xk, const void* xv,
              const void* x_pos, const void* n_valid, void* o_part, void* m_part,
              void* l_part, void* out, int B, int P, int Sx, int H, int Hkv,
              int window, float scale, cudaStream_t stream) {
#define VOX_HD_CASE(N)                                                             \
  case N:                                                                          \
    return launch<T, N>(q, k, v, slot_pos, q_pos, xk, xv, x_pos, n_valid, o_part,  \
                        m_part, l_part, out, B, P, Sx, H, Hkv, window, scale, stream);
  switch (head_dim) {
    VOX_HD_CASE(64)
    VOX_HD_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VOX_HD_CASE
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, rings, extra columns and out alike).
// Pointers are device pointers; n_valid is a device int32 scalar. The
// partial buffers hold [B, H, ceil(P / kSplit) + 1] entries (x HD for
// o_part), kSplit = 256; Sx must not exceed kSplit. head_dim is 64 or 128.
// Returns the CUDA error code of the launches (0 = launched).
int ring_gqa_attention_launch(int dtype, int head_dim, const void* q, const void* k,
                              const void* v, const void* slot_pos, const void* q_pos,
                              const void* xk, const void* xv, const void* x_pos,
                              const void* n_valid, void* o_part, void* m_part,
                              void* l_part, void* out, int B, int P, int Sx, int H,
                              int Hkv, int window, float scale, void* stream) {
  if (Sx > kSplit || Hkv <= 0 || H % Hkv != 0 || B <= 0 || P <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(head_dim, q, k, v, slot_pos, q_pos, xk, xv, x_pos, n_valid,
                            o_part, m_part, l_part, out, B, P, Sx, H, Hkv, window,
                            scale, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(head_dim, q, k, v, slot_pos, q_pos, xk, xv, x_pos,
                                    n_valid, o_part, m_part, l_part, out, B, P, Sx, H,
                                    Hkv, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
