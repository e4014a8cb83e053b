// Fused tied-embedding logits and greedy argmax for Hopper (sm_90a), K3.
//
// Replaces tools/profile_logits.py:57 fused_logits_argmax (the Pallas kernel,
// pallas_call at :103): the greedy head of every decode step, computed from
// the tied embedding table without writing the [B, V] logits to memory.
//
// What it computes, for b < B:
//   argmax mode: tok[b] = argmax_v  (h[b] . T[v]) [* s[v]]   (int32)
//   logits mode: logits[b, v] =     (h[b] . T[v]) [* s[v]]   (f32)
// T: [V, D] int8 with f32 scales s[V] (the Q8 embedding, per vocab row), or
// bf16 or f32 with no scales. For a float table h is first rounded to the
// table's dtype (voxtral_tpu/ops/linear.py:56); for an int8 table h keeps its
// own dtype (bf16 or f32). Products are exact in f32 and summed in f32; the
// scale multiplies the f32 sum (linear.py:50-54). Ties go to the first index,
// as jnp.argmax and the TPU kernel's strict ">" merge over sequential blocks.
//
// Bound: bytes at small B. One call must read the table once: 403.2 MB (int8
// codes + scales) or 805.3 MB (bf16) at V = 131072, D = 3072, i.e. 120.4 us
// or 240.4 us at 3.35 TB/s. Its f32 CUDA-core arithmetic (B FMAs per table
// element) passes the byte time above B of about 8 (int8) or 16 (bf16).
//
// Design (not the TPU kernel's sequential grid: blocks run in parallel):
//   * a block owns 512 vocab rows, two per thread, neighbouring threads on
//     neighbouring rows (so logits-mode stores are coalesced); a thread
//     walks its rows in 16-byte loads, so each table byte is read once and
//     used for all B streams (up to 16 per block; grid.y covers B in chunks
//     of 16);
//   * h is staged in shared memory as f32, 512 columns of D at a time,
//     [column][stream], so a thread reads it by broadcast;
//   * argmax mode: each block reduces its rows to one (max, index) per
//     stream, ordered by value then lower index (a total order, so the
//     result does not depend on the order of the merges), writes it to
//     scratch, and the last block to arrive (counter + __threadfence) merges
//     every block's entry and writes tok, then resets the counter: one
//     launch, no float atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "ring_common.cuh"

namespace {

using namespace ring_common;

constexpr int kThreads = 256;
constexpr int kRows = 2;                        // vocab rows per thread
constexpr int kBlockRows = kThreads * kRows;    // 512
constexpr int kDChunk = 512;                    // columns of h staged per pass
constexpr int kMaxBT = 16;                      // streams per block
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float kNegInf() { return __uint_as_float(0xff800000u); }

// (av, ai) comes before (bv, bi): a larger value, or the same value at a
// lower index. NaN never comes first.
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

// The block's best (v, i) of each thread's candidate; valid in thread 0.
__device__ __forceinline__ void block_best(float& v, int& i, float* s_val, int* s_idx) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_best(v, i);
  __syncthreads();                               // s_val/s_idx free to reuse
  if (lane == 0) { s_val[warp] = v; s_idx[warp] = i; }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kWarps; ++w)
      if (better(s_val[w], s_idx[w], v, i)) { v = s_val[w]; i = s_idx[w]; }
}

template <typename TT, typename HT, int BT, bool ARGMAX>
__global__ void __launch_bounds__(kThreads)
logits_kernel(const HT* __restrict__ h, const TT* __restrict__ table,
              const float* __restrict__ scales, float* __restrict__ logits,
              int* __restrict__ tok, float* __restrict__ part_val,
              int* __restrict__ part_idx, int* __restrict__ counters, int B, int V, int D) {
  constexpr int W = VecWidth<TT>::N;             // table elements per 16-byte load
  constexpr bool kQ8 = std::is_same<TT, int8_t>::value;
  __shared__ __align__(16) float hs[kDChunk * BT];
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ int is_last;
  const int tid = threadIdx.x;
  const int b0 = blockIdx.y * BT;
  const int v_base = blockIdx.x * kBlockRows;

  float acc[kRows][BT];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int b = 0; b < BT; ++b) acc[r][b] = 0.f;

  for (int c0 = 0; c0 < D; c0 += kDChunk) {
    const int cols = min(kDChunk, D - c0);
    __syncthreads();                             // the last pass is done with hs
    for (int e = tid; e < kDChunk * BT; e += kThreads) {
      const int d = e / BT, b = e % BT;
      float x = 0.f;
      if (d < cols && b0 + b < B) {
        x = to_float(h[(size_t)(b0 + b) * D + c0 + d]);
        if constexpr (!kQ8) x = round_to<TT>(x); // h in the float table's dtype
      }
      hs[e] = x;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int v = v_base + r * kThreads + tid;
      if (v >= V) continue;
      const TT* row = table + (size_t)v * D + c0;
#pragma unroll 4
      for (int d = 0; d < cols; d += W) {
        float t[W];
        load16(row + d, t);
#pragma unroll
        for (int j = 0; j < W; ++j) {
          const float* hp = hs + (d + j) * BT;
#pragma unroll
          for (int b = 0; b < BT; ++b) acc[r][b] = fmaf(hp[b], t[j], acc[r][b]);
        }
      }
    }
  }

  float best_v[BT];
  int best_i[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) { best_v[b] = kNegInf(); best_i[b] = INT_MAX; }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {              // rows in increasing v
    const int v = v_base + r * kThreads + tid;
    if (v >= V) continue;
    const float sc = kQ8 ? scales[v] : 1.f;
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      const float lg = kQ8 ? acc[r][b] * sc : acc[r][b];
      if (ARGMAX) {
        if (better(lg, v, best_v[b], best_i[b])) { best_v[b] = lg; best_i[b] = v; }
      } else if (b0 + b < B) {
        logits[(size_t)(b0 + b) * V + v] = lg;
      }
    }
  }
  if (!ARGMAX) return;

  const size_t slot = ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * kMaxBT;
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    float v = best_v[b];
    int i = best_i[b];
    block_best(v, i, s_val, s_idx);
    if (tid == 0) { __stcg(part_val + slot + b, v); __stcg(part_idx + slot + b, i); }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + blockIdx.y, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  for (int b = 0; b < BT; ++b) {
    float v = kNegInf();
    int i = INT_MAX;
    for (int blk = tid; blk < (int)gridDim.x; blk += kThreads) {
      const size_t at = ((size_t)blockIdx.y * gridDim.x + blk) * kMaxBT + b;
      const float pv = __ldcg(part_val + at);
      const int pi = __ldcg(part_idx + at);
      if (better(pv, pi, v, i)) { v = pv; i = pi; }
    }
    block_best(v, i, s_val, s_idx);
    if (tid == 0 && b0 + b < B) tok[b0 + b] = i < V ? i : 0;
  }
  if (tid == 0) counters[blockIdx.y] = 0;
}

template <typename TT, typename HT, int BT>
int launch_bt(int mode, const void* h, const void* table, const void* scales, void* logits,
              void* tok, void* part_val, void* part_idx, void* counters, int B, int V,
              int D, cudaStream_t stream) {
  const dim3 grid((V + kBlockRows - 1) / kBlockRows, (B + BT - 1) / BT);
  const auto* hh = static_cast<const HT*>(h);
  const auto* tt = static_cast<const TT*>(table);
  const auto* ss = static_cast<const float*>(scales);
  if (mode == 0)
    logits_kernel<TT, HT, BT, true><<<grid, kThreads, 0, stream>>>(
        hh, tt, ss, nullptr, static_cast<int*>(tok), static_cast<float*>(part_val),
        static_cast<int*>(part_idx), static_cast<int*>(counters), B, V, D);
  else
    logits_kernel<TT, HT, BT, false><<<grid, kThreads, 0, stream>>>(
        hh, tt, ss, static_cast<float*>(logits), nullptr, nullptr, nullptr, nullptr, B, V,
        D);
  return static_cast<int>(cudaGetLastError());
}

template <typename TT, typename HT>
int launch_b(int mode, const void* h, const void* table, const void* scales, void* logits,
             void* tok, void* part_val, void* part_idx, void* counters, int B, int V, int D,
             cudaStream_t stream) {
  if (B <= 1)
    return launch_bt<TT, HT, 1>(mode, h, table, scales, logits, tok, part_val, part_idx,
                                counters, B, V, D, stream);
  if (B <= 4)
    return launch_bt<TT, HT, 4>(mode, h, table, scales, logits, tok, part_val, part_idx,
                                counters, B, V, D, stream);
  return launch_bt<TT, HT, kMaxBT>(mode, h, table, scales, logits, tok, part_val, part_idx,
                                   counters, B, V, D, stream);
}

template <typename TT>
int launch_h(int h_dtype, int mode, const void* h, const void* table, const void* scales,
             void* logits, void* tok, void* part_val, void* part_idx, void* counters, int B,
             int V, int D, cudaStream_t stream) {
  if (h_dtype == 0)
    return launch_b<TT, float>(mode, h, table, scales, logits, tok, part_val, part_idx,
                               counters, B, V, D, stream);
  if (h_dtype == 1)
    return launch_b<TT, __nv_bfloat16>(mode, h, table, scales, logits, tok, part_val,
                                       part_idx, counters, B, V, D, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// table_kind: 0 = f32, 1 = bf16 (no scales), 2 = int8 with f32 scales [V].
// h_dtype: 0 = f32, 1 = bf16; h is [B, D]. mode: 0 = argmax (tok int32 [B];
// part_val/part_idx scratch of ceil(V / 512) * ceil(B / 16) * 16 entries;
// counters int32, zero, ceil(B / 16) entries, left zero by every launch, so
// one stream at a time), 1 = logits (f32 [B, V]). D % 16 == 0 and 16-byte
// aligned table rows. Returns the CUDA error code of the launch (0 =
// launched).
int logits_argmax_launch(int table_kind, int h_dtype, int mode, const void* h,
                         const void* table, const void* scales, void* logits, void* tok,
                         void* part_val, void* part_idx, void* counters, int B, int V, int D,
                         void* stream) {
  if (B < 1 || V < 1 || D < 16 || D % 16 || (mode != 0 && mode != 1) ||
      reinterpret_cast<uintptr_t>(table) % 16 || (table_kind == 2 && scales == nullptr) ||
      (B + kMaxBT - 1) / kMaxBT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (table_kind == 0)
    return launch_h<float>(h_dtype, mode, h, table, scales, logits, tok, part_val, part_idx,
                           counters, B, V, D, st);
  if (table_kind == 1)
    return launch_h<__nv_bfloat16>(h_dtype, mode, h, table, scales, logits, tok, part_val,
                                   part_idx, counters, B, V, D, st);
  if (table_kind == 2)
    return launch_h<int8_t>(h_dtype, mode, h, table, scales, logits, tok, part_val,
                            part_idx, counters, B, V, D, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
