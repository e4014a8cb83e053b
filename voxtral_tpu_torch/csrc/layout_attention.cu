// Decode attention over int8, nibble-packed int4 and block-major rings for
// Hopper (sm_90a): the kernels of two profiling tools, T4 `attn8`, T5
// `attn4`, T6 `attn3d` and T7 `attn4d`.
//
// Replaces four Pallas kernels:
//   * T4 `attn8`, tools/profile_int4_unpack.py:83 (body kern8 :66,
//     pallas_call :85): int8 rings [B, P, kv_dim];
//   * T5 `attn4`, tools/profile_int4_unpack.py:131 (body kern4 :98,
//     pallas_call :133): nibble-packed rings [B, P, kv_dim / 2], byte c of a
//     head holding lane c in its low nibble and lane c + 64 in its high one,
//     both signed;
//   * T6 `attn3d`, tools/profile_attn_layout.py:52 (body _cell :29,
//     pallas_call :63): int8 rings [B, P, kv_dim] with f32 scales, masked;
//   * T7 `attn4d`, tools/profile_attn_layout.py:87 (pallas_call :98): the
//     same function on block-major rings [B, kv_dim / blk, P, blk].
//
// What they compute, per stream b and kv head h (hd 128; query heads
// 4h..4h+3 are the 4 rows of q[b, 0, 512 h : 512 h + 512]):
//   T4, T5 (unmasked): s = q . k^T in f32 (T5: q[:, :64] . lo^T plus
//     q[:, 64:] . hi^T, added in that order); e = exp(s - max_p s) rounded
//     to bf16; out = e . v summed in f32, stored as bf16. No 1/sqrt(hd), no
//     normalisation: values reach P * 127, as in the tool.
//   T6, T7 (masked): s = (q . k^T) * (1/sqrt(128)) * ks_p; slots with
//     sp < 0, sp > qp or sp < qp - 8191 score -1e30 and give e = 0; m =
//     max(max_p s, -5e29); e = exp(s - m); den = max(sum_p e, 1e-30), taken
//     before e is multiplied by vs_p; out = (round_bf16(e * vs) . v) / den.
//     A stream whose slots are all masked returns exact zeros. T6 and T7
//     are one kernel on two sets of strides, so they give the same bits on
//     the same values.
//
// Bound: bytes. Each K/V element read is 2 multiply-adds for each of the 4
// query heads, ~4 operations per byte (8 per byte of a packed ring), far
// below the ~295 a byte the card needs before its bf16 rate limits. At the
// tools' shapes: T4 (B 32) 137.4 MB, ~41 us at 3.35 TB/s; T5 (B 32) 68.9 MB,
// ~21 us; T6 / T7 (B 16) 69.9 MB with scales and positions, ~21 us.
//
// Design (a simple one first; split-P, cp.async and tensor cores are later
// work): one block of 256 threads per (kv head, stream), all P slots in one
// pass, no merge.
//   * A slot's K/V row is 128 bytes (int8) or 64 (packed) in every layout:
//     8 or 4 neighbouring threads read it with one 16-byte load each, so a
//     warp's load touches whole 128-byte segments; 4 slots in flight per
//     thread. The layouts differ only in the row stride (kv_dim against
//     blk) and the head's offset.
//   * Codes become f32 by a byte permute into 2^23 + code and one subtract
//     (exact, no int-to-float conversion, whose rate on this card is a
//     quarter of the FMA rate); nibbles are masked and biased by 8 first.
//   * Each thread keeps its 16 (int8) or 32 (packed) lanes of the 4 query
//     rows in registers; the 8 or 4 threads of a slot add their partial dots
//     by a reduce-scatter over shuffles that leaves each with one row's sum.
//   * T6/T7 first stage the mask and both scale rows in shared memory, and
//     issue each step's K/V loads during the previous step's arithmetic.
//     Pass 1 writes the P x 4 f32 scores to shared memory (33 KB at P 2088:
//     dynamic shared memory); a block reduction gives the row max (and den),
//     and e (T6/T7: e * vs) is rounded to bf16 in place; pass 2 reads V
//     once and accumulates e . v in f32 registers, reduced over the block
//     by shuffles and shared memory. T6/T7 skip the K and V rows of masked
//     slots (their e is 0): the bytes a call needs follow its mask.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ring_common.cuh"

namespace {

using namespace ring_common;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;                       // query heads per kv head
constexpr int kHd = 128;
constexpr int kUnroll = 4;                      // slots in flight per thread
constexpr int kWindow = 8192;                   // profile_attn_layout.py:31
constexpr float kScale = 0.08838834764831845f;  // 1/sqrt(128), rounded to f32
constexpr int kRedBytes = kWarps * kGroup * kHd * 4;   // PV partials per warp
// the dynamic shared memory a block may ask for (227 KB, less a margin for
// the static arrays); = _MAX_DYNAMIC_SMEM in ops/layout_attention.py
constexpr int kMaxDynamicSmem = 232448 - 1024;

__device__ __forceinline__ uint4 ld16(const int8_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// 2^23 + byte j of u, as an f32
__device__ __forceinline__ float biased(uint32_t u, int j) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j));
}

// One 16-byte load of a slot's row -> the thread's lanes as f32, exact.
// int8: 16 codes. packed: 16 bytes -> out[0, 16) the low nibbles (lanes c),
// out[16, 32) the high nibbles (lanes c + 64).
template <bool kPacked>
__device__ __forceinline__ void decode(const uint4& w, float* out) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (kPacked) {
      const uint32_t lo = (words[i] & 0x0F0F0F0Fu) ^ 0x08080808u;   // nibble + 8
      const uint32_t hi = ((words[i] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        out[4 * i + j] = biased(lo, j) - 8388616.f;                  // 2^23 + 8
        out[16 + 4 * i + j] = biased(hi, j) - 8388616.f;
      }
    } else {
      const uint32_t u = words[i] ^ 0x80808080u;                     // code + 128
#pragma unroll
      for (int j = 0; j < 4; ++j) out[4 * i + j] = biased(u, j) - 8388736.f;
    }
  }
}

// Sums v[0, N) over the threads whose lane ids differ only in the kLevels
// bits from kOff up. While more than kKeep values remain, a level halves
// them (a thread keeps the upper half where its bit is set and receives
// that half from its partner); the other levels add whole. Returns the
// index of the first value this thread keeps: v[0, kKeep) then hold the
// sums of values [first, first + kKeep).
template <int N, int kKeep, int kOff, int kLevels>
struct ReduceScatter {
  static __device__ __forceinline__ int run(float* v, int lane) {
    if constexpr (kLevels == 0) {
      return 0;
    } else if constexpr (N > kKeep) {
      constexpr int H = N / 2;
      const bool upper = lane & kOff;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float keep = upper ? v[i + H] : v[i];
        const float give = upper ? v[i] : v[i + H];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, give, kOff);
      }
      return (upper ? H : 0) + ReduceScatter<H, kKeep, kOff * 2, kLevels - 1>::run(v, lane);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], kOff);
      return ReduceScatter<N, kKeep, kOff * 2, kLevels - 1>::run(v, lane);
    }
  }
};

__host__ __device__ constexpr int log2_of(int n) { return n <= 1 ? 0 : 1 + log2_of(n / 2); }

// The body shared by both kernels: one (kv head, stream) over P slots.
// k, v: the head's row 0 (its lanes) with `stride` bytes between slots; q:
// the head's 4 query rows (bf16, 128 apart); out: the same lanes of the
// output. Masked: sp, ks, vs point at the stream's [P] rows (ks, vs of this
// head), qpos is the query position.
template <bool kPacked, bool kMasked>
__device__ __forceinline__ void attend(const __nv_bfloat16* __restrict__ q,
                                       const int8_t* __restrict__ k,
                                       const int8_t* __restrict__ v, size_t stride, int P,
                                       const int* __restrict__ sp, int qpos,
                                       const float* __restrict__ ks,
                                       const float* __restrict__ vs,
                                       __nv_bfloat16* __restrict__ out) {
  constexpr int kRuns = kPacked ? 2 : 1;        // runs of 16 lanes per thread
  constexpr int kLanes = 16 * kRuns;
  constexpr int kTps = 8 / kRuns;               // threads per slot
  constexpr int kRows = kThreads / kTps;        // slots per step of the block
  extern __shared__ float4 smem[];
  float4* sc = smem;                                                   // [P] x 4 rows
  float* red = reinterpret_cast<float*>(smem + P);                     // [warps][512]
  float* ks_s = red + kRedBytes / 4;                                   // masked: [P]
  float* vs_s = ks_s + P;                                              // masked: [P]
  uint8_t* valid = reinterpret_cast<uint8_t*>(vs_s + P);               // masked: [P]
  __shared__ float stat[kWarps][kGroup];
  __shared__ float row_max[kGroup], row_den[kGroup];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int li = t % kTps, row = t / kTps;
  // lanes of run r: [16 li + 64 r, + 16)
  const int lane0 = 16 * li;

  if constexpr (kMasked) {
    // the mask and both scale rows into shared memory, 12 loads in flight
    const int lo = static_cast<int>(static_cast<unsigned>(qpos) - (kWindow - 1u));
    for (int base = 0; base < P; base += kUnroll * kThreads) {
      int s[kUnroll];
      float a[kUnroll], c[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = base + u * kThreads + t;
        if (p < P) {
          s[u] = sp[p];
          a[u] = ks[p];
          c[u] = vs[p];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = base + u * kThreads + t;
        if (p < P) {
          valid[p] = s[u] >= 0 && s[u] <= qpos && s[u] >= lo;
          ks_s[p] = a[u];
          vs_s[p] = c[u];
        }
      }
    }
    __syncthreads();
  }

  // Each step of a pass covers kStep slots, kUnroll a thread. Masked slots
  // and slots past P read nothing. T6/T7 issue the next step's loads before
  // the current step's arithmetic (their blocks have registers to spare at
  // one block per SM); T4 issues them after it, to stay at two blocks per
  // SM, and T5 has no registers left for a second set.
  constexpr bool kPrefetch = kMasked;
  constexpr int kStep = kRows * kUnroll;
  auto live = [&](int p) { return p < P && (!kMasked || valid[p]); };

  // ---- pass 1: scores -> sc[p][g]
  {
    float qf[kGroup][kLanes];
#pragma unroll
    for (int g = 0; g < kGroup; ++g)
#pragma unroll
      for (int r = 0; r < kRuns; ++r) {
        load16(q + g * kHd + lane0 + 64 * r, &qf[g][16 * r]);
        load16(q + g * kHd + lane0 + 64 * r + 8, &qf[g][16 * r + 8]);
      }
    uint4 w[kUnroll];
    auto load_k = [&](int base) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = base + u * kRows + row;
        w[u] = live(p) ? ld16(k + p * stride + 16 * li) : make_uint4(0u, 0u, 0u, 0u);
      }
    };
    load_k(0);
    for (int base = 0; base < P; base += kStep) {
      uint4 cur[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) cur[u] = w[u];
      if constexpr (kPrefetch) load_k(base + kStep);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float x[kLanes];
        decode<kPacked>(cur[u], x);
        float a[kGroup * kRuns];                  // [g][run]
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
#pragma unroll
          for (int r = 0; r < kRuns; ++r) {
            float d = 0.f;
#pragma unroll
            for (int l = 0; l < 16; ++l) d = fmaf(qf[g][16 * r + l], x[16 * r + l], d);
            a[g * kRuns + r] = d;
          }
        const int first =
            ReduceScatter<kGroup * kRuns, kRuns, 1, log2_of(kTps)>::run(a, lane);
        const int g = first / kRuns;
        float s = a[0];
        if constexpr (kPacked) s = a[0] + a[1];   // lo dot, then hi dot
        const int p = base + u * kRows + row;
        if (p < P && li < kGroup) {               // one writer per (slot, row)
          if constexpr (kMasked) s = valid[p] ? (s * kScale) * ks_s[p] : kNeg;
          reinterpret_cast<float*>(sc + p)[g] = s;
        }
      }
      if constexpr (!kPrefetch) load_k(base + kStep);
    }
  }
  __syncthreads();

  // ---- softmax statistics: thread t owns row g = t % 4 of slots t / 4 + 64 i
  {
    const int g = t & 3;
    float mx = -INFINITY;
    for (int p = t >> 2; p < P; p += kThreads / kGroup)
      mx = fmaxf(mx, reinterpret_cast<const float*>(sc + p)[g]);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane < kGroup) stat[warp][lane] = mx;
    __syncthreads();
    if (t < kGroup) {
      float m = stat[0][t];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) m = fmaxf(m, stat[w][t]);
      row_max[t] = kMasked ? fmaxf(m, 0.5f * kNeg) : m;
    }
    __syncthreads();
    const float m = row_max[g];
    float den = 0.f;
    for (int p = t >> 2; p < P; p += kThreads / kGroup) {
      float* s = reinterpret_cast<float*>(sc + p) + g;
      float e = expf(*s - m);
      if constexpr (kMasked) {
        e = valid[p] ? e : 0.f;
        den += e;
        e *= vs_s[p];
      }
      *s = round_to<__nv_bfloat16>(e);
    }
    if constexpr (kMasked) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) den += __shfl_xor_sync(0xffffffffu, den, o);
      if (lane < kGroup) stat[warp][lane] = den;
      __syncthreads();
      if (t < kGroup) {
        float d = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) d += stat[w][t];
        row_den[t] = fmaxf(d, 1e-30f);
      }
    }
  }
  __syncthreads();

  // ---- pass 2: e . v
  float acc[kGroup * kLanes];                     // [g][lane]
#pragma unroll
  for (int i = 0; i < kGroup * kLanes; ++i) acc[i] = 0.f;
  uint4 w[kUnroll];
  float4 e[kUnroll];
  auto load_v = [&](int base) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = base + u * kRows + row;
      const bool l = live(p);
      e[u] = l ? sc[p] : make_float4(0.f, 0.f, 0.f, 0.f);
      w[u] = l ? ld16(v + p * stride + 16 * li) : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  load_v(0);
  for (int base = 0; base < P; base += kStep) {
    uint4 cur[kUnroll];
    float4 ecur[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      cur[u] = w[u];
      ecur[u] = e[u];
    }
    if constexpr (kPrefetch) load_v(base + kStep);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float x[kLanes];
      decode<kPacked>(cur[u], x);
      const float eg[kGroup] = {ecur[u].x, ecur[u].y, ecur[u].z, ecur[u].w};
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
#pragma unroll
        for (int l = 0; l < kLanes; ++l) acc[g * kLanes + l] = fmaf(eg[g], x[l], acc[g * kLanes + l]);
    }
    if constexpr (!kPrefetch) load_v(base + kStep);
  }
  // the threads of a warp with the same li hold the same lanes: reduce them,
  // 16 sums left per thread, then over the warps through shared memory
  const int first = ReduceScatter<kGroup * kLanes, 16, kTps, log2_of(32 / kTps)>::run(acc, lane);
  {
    const int g = first / kLanes, d0 = lane0 + 64 * ((first % kLanes) / 16);
#pragma unroll
    for (int i = 0; i < 16; ++i) red[warp * kGroup * kHd + g * kHd + d0 + i] = acc[i];
  }
  __syncthreads();
  for (int o = t; o < kGroup * kHd; o += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * kGroup * kHd + o];
    if constexpr (kMasked) s = s / row_den[o / kHd];
    out[o] = __float2bfloat16(s);
  }
}

// T4 / T5. Grid (kv_heads, B). k, v: [B, P, kv_heads * 128] int8, or
// [B, P, kv_heads * 64] packed; q, out: bf16 [B, 1, kv_heads * 512].
template <bool kPacked>
__global__ void __launch_bounds__(kThreads, kPacked ? 1 : 2)
unmasked_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k,
                const int8_t* __restrict__ v, __nv_bfloat16* __restrict__ out, int P) {
  const int h = blockIdx.x, b = blockIdx.y, hkv = gridDim.x;
  const size_t row = static_cast<size_t>(hkv) * (kPacked ? kHd / 2 : kHd);
  const size_t head = static_cast<size_t>(b) * P * row + h * (kPacked ? kHd / 2 : kHd);
  const size_t qo = (static_cast<size_t>(b) * hkv + h) * kGroup * kHd;
  attend<kPacked, false>(q + qo, k + head, v + head, row, P, nullptr, 0, nullptr, nullptr,
                         out + qo);
}

// T6 / T7. Grid (kv_heads, B). 3-D: k, v [B, P, kv_dim]; block-major: [B,
// kv_dim / blk, P, blk], head h in block h / (blk / 128) at lane offset
// 128 (h % (blk / 128)). sp: int32 [B, P]; qp: int32 [B]; ks, vs: f32 [B,
// kv_heads, P] (the tool's [B, nb, sub, P]); q, out: bf16 [B, 1, kv_dim * 4].
template <bool kBlockMajor>
__global__ void __launch_bounds__(kThreads, 1)
masked_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k,
              const int8_t* __restrict__ v, const int* __restrict__ sp,
              const int* __restrict__ qp, const float* __restrict__ ks,
              const float* __restrict__ vs, __nv_bfloat16* __restrict__ out, int P, int blk) {
  const int h = blockIdx.x, b = blockIdx.y, hkv = gridDim.x;
  const size_t kv_dim = static_cast<size_t>(hkv) * kHd;
  size_t head = static_cast<size_t>(b) * P * kv_dim, stride = kv_dim;
  if constexpr (kBlockMajor) {
    const int sub = blk / kHd;
    head += static_cast<size_t>(h / sub) * P * blk + (h % sub) * kHd;
    stride = blk;
  } else {
    head += static_cast<size_t>(h) * kHd;
  }
  const size_t qo = (static_cast<size_t>(b) * hkv + h) * kGroup * kHd;
  const size_t so = (static_cast<size_t>(b) * hkv + h) * P;
  attend<false, true>(q + qo, k + head, v + head, stride, P, sp + static_cast<size_t>(b) * P,
                      qp[b], ks + so, vs + so, out + qo);
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

// dynamic shared memory of a block at P slots (= _smem_bytes in
// ops/layout_attention.py): the scores, the PV partials; masked: the
// scale rows and the mask
int smem_bytes(int slots, bool masked) { return slots * 16 + kRedBytes + (masked ? 9 * slots : 0); }

}  // namespace

extern "C" {

// T4 (packed = 0) and T5 (packed = 1). Device pointers, 16-byte aligned:
// q, out bf16 [batch, 1, kv_heads * 512]; k, v int8 [batch, slots, kv_heads
// * 128] or packed [batch, slots, kv_heads * 64]. Returns the CUDA error
// code of the launch (0 = launched).
int attn_unmasked_launch(const void* q, const void* k, const void* v, void* out, int batch,
                         int slots, int kv_heads, int packed, void* stream) {
  const int smem = smem_bytes(slots, false);
  if (batch < 1 || batch > 65535 || slots < 1 || kv_heads < 1 || smem > kMaxDynamicSmem ||
      misaligned(q) || misaligned(k) || misaligned(v) || misaligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(kv_heads, batch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const int8_t*>(k);
  const auto* vb = static_cast<const int8_t*>(v);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  cudaError_t err;
  if (packed) {
    err = cudaFuncSetAttribute(unmasked_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    unmasked_kernel<true><<<grid, kThreads, smem, s>>>(qb, kb, vb, ob, slots);
  } else {
    err = cudaFuncSetAttribute(unmasked_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    unmasked_kernel<false><<<grid, kThreads, smem, s>>>(qb, kb, vb, ob, slots);
  }
  return static_cast<int>(cudaGetLastError());
}

// T6 (blk = 0: k, v [batch, slots, kv_heads * 128]) and T7 (blk a multiple
// of 128 dividing kv_heads * 128: k, v [batch, kv_heads * 128 / blk, slots,
// blk]). sp int32 [batch, slots], qp int32 [batch], ks, vs f32 [batch,
// kv_heads, slots]; q, out bf16 [batch, 1, kv_heads * 512]. 16-byte aligned
// device pointers. Returns the CUDA error code of the launch.
int attn_masked_launch(const void* q, const void* k, const void* v, const void* sp,
                       const void* qp, const void* ks, const void* vs, void* out, int batch,
                       int slots, int kv_heads, int blk, void* stream) {
  const int smem = smem_bytes(slots, true);
  if (batch < 1 || batch > 65535 || slots < 1 || kv_heads < 1 || smem > kMaxDynamicSmem ||
      blk < 0 || blk % kHd || (blk && (kv_heads * kHd) % blk) || misaligned(q) ||
      misaligned(k) || misaligned(v) || misaligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(kv_heads, batch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const int8_t*>(k);
  const auto* vb = static_cast<const int8_t*>(v);
  const auto* spb = static_cast<const int*>(sp);
  const auto* qpb = static_cast<const int*>(qp);
  const auto* ksb = static_cast<const float*>(ks);
  const auto* vsb = static_cast<const float*>(vs);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  cudaError_t err;
  if (blk) {
    err = cudaFuncSetAttribute(masked_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    masked_kernel<true><<<grid, kThreads, smem, s>>>(qb, kb, vb, spb, qpb, ksb, vsb, ob,
                                                     slots, blk);
  } else {
    err = cudaFuncSetAttribute(masked_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    masked_kernel<false><<<grid, kThreads, smem, s>>>(qb, kb, vb, spb, qpb, ksb, vsb, ob,
                                                      slots, 0);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
