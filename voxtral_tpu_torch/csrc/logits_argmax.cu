// Fused tied-embedding logits and greedy argmax for Hopper (sm_90a), K3.
//
// Replaces tools/profile_logits.py:57 fused_logits_argmax (the Pallas kernel,
// pallas_call at :103): the greedy head of every decode step, computed from
// the tied embedding table without writing the [B, V] logits to memory.
//
// What it computes, for b < B:
//   argmax mode: tok[b] = argmax_v  (h[b] . T[v]) [* s[v]]   (int32)
//                and, where asked, best[b] = that logit       (f32; a
//                tensor-parallel rank merges it with the others' shards)
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
// or 240.4 us at 3.35 TB/s; the products (2 B V D operations, 12.9 GFLOP at
// B = 16) take 13 us at the dense bf16 tensor-core rate.
//
// Two routes, chosen by dtype (a dispatch, not a fallback):
//
// bf16 products (bf16 table with any h, int8 table with bf16 h: the serving
// dtypes): tensor cores.
//   * mma.sync m16n8k16, bf16 -> f32: 16 vocab rows (A) x 8 streams (B) a
//     product, one n-tile for B <= 8, two for B <= 16 (grid.y covers more
//     streams in chunks of 16); the f32 accumulator is the logit;
//   * one block of 8 warps per SM walks the vocabulary in 16-row tiles;
//     the warps split each tile's columns, warp w taking the 128-column
//     segments w, w + 8, ..., so at each stage the block reads 2 KB (bf16;
//     1 KB int8) contiguous of each of 16 rows. Each warp streams its
//     segments through its own cp.async pipeline (up to 4 stages of 16
//     rows x 128 columns for bf16, 6 for int8; XOR-swizzled 16-byte
//     chunks); the warps meet once per tile, where their partial sums are
//     added in warp order (the same order for every row);
//   * A fragments come from ldmatrix; int8 codes are converted to bf16 in
//     registers (exact: byte permute into 2^23 + code, one f32 subtraction),
//     with the mma's k order permuted within each 16 so one 4-byte fragment
//     register holds 4 neighbouring codes; h (rounded to bf16 for a float
//     table, exact for a bf16 h) is laid out once per block in shared memory
//     in fragment order, the same k order, zero past B and D;
//   * scales multiply the f32 accumulator per vocab row; logits mode writes
//     [B, V] f32 from the C fragments (8 neighbouring rows of a stream, 32
//     bytes, per store);
// f32 products (f32 table, or int8 table with f32 h: the parity mode): CUDA
// cores, the same arithmetic in f32 that the plain version does:
//   * a block owns 512 vocab rows, two per thread, neighbouring threads on
//     neighbouring rows; a thread walks its rows in 16-byte loads, so each
//     table byte is read once and used for all B streams (up to 16 per
//     block; grid.y covers B in chunks of 16);
//   * h is staged in shared memory as f32, 512 columns of D at a time,
//     [column][stream], so a thread reads it by broadcast.
// Argmax mode, both routes: each block reduces its rows to one (max, index)
// per stream, ordered by value then lower index (a total order, so the
// result does not depend on the order of the merges), writes it to
// scratch, and the last block to arrive (counter + __threadfence) merges
// every block's entry and writes tok, then resets the counter: one launch,
// no float atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "mma_common.cuh"
#include "ring_common.cuh"

namespace {

using namespace ring_common;
using namespace mma_common;

constexpr int kThreads = 256;
constexpr int kMaxBT = 16;                      // streams per block (grid.y covers B)
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float kNegInf() { return __uint_as_float(0xff800000u); }

// (av, ai) comes before (bv, bi): a larger value, or the same value at a
// lower index. NaN never comes first.
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// The best (v, i) over the lanes that differ from this one in lane bits
// `from` .. 16 (from = 1: the whole warp).
__device__ __forceinline__ void warp_best(float& v, int& i, int from = 1) {
#pragma unroll
  for (int o = 16; o >= from; o >>= 1) {
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

// Argmax mode's end, both routes: this block's best of stream b is
// (blk_v[b], blk_i[b]) for b < bt (in thread 0's view after a barrier).
// Writes the block's partial; the last block of this grid.y row merges all
// of them, writes tok (and best), and resets the counter.
__device__ __forceinline__ void merge_blocks(const float* blk_v, const int* blk_i, int bt,
                                             int b0, int B, int V, int* __restrict__ tok,
                                             float* __restrict__ best,
                                             float* __restrict__ part_val,
                                             int* __restrict__ part_idx,
                                             int* __restrict__ counters, float* s_val,
                                             int* s_idx) {
  __shared__ int is_last;
  const int tid = threadIdx.x;
  const size_t slot = ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * kMaxBT;
  if (tid < bt) {
    __stcg(part_val + slot + tid, blk_v[tid]);
    __stcg(part_idx + slot + tid, blk_i[tid]);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + blockIdx.y, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  for (int b = 0; b < bt; ++b) {
    float v = kNegInf();
    int i = INT_MAX;
    for (int blk = tid; blk < (int)gridDim.x; blk += kThreads) {
      const size_t at = ((size_t)blockIdx.y * gridDim.x + blk) * kMaxBT + b;
      const float pv = __ldcg(part_val + at);
      const int pi = __ldcg(part_idx + at);
      if (better(pv, pi, v, i)) { v = pv; i = pi; }
    }
    block_best(v, i, s_val, s_idx);
    if (tid == 0 && b0 + b < B) {
      tok[b0 + b] = i < V ? i : 0;
      if (best != nullptr) best[b0 + b] = v;
    }
  }
  if (tid == 0) counters[blockIdx.y] = 0;
}

// ---------------------------------------------------------------------------
// f32 route (CUDA cores)
// ---------------------------------------------------------------------------

constexpr int kRows = 2;                        // vocab rows per thread
constexpr int kBlockRows = kThreads * kRows;    // 512
constexpr int kDChunk = 512;                    // columns of h staged per pass

template <typename TT, typename HT, int BT, bool ARGMAX>
__global__ void __launch_bounds__(kThreads)
logits_kernel(const HT* __restrict__ h, const TT* __restrict__ table,
              const float* __restrict__ scales, float* __restrict__ logits,
              int* __restrict__ tok, float* __restrict__ best, float* __restrict__ part_val,
              int* __restrict__ part_idx, int* __restrict__ counters, int B, int V, int D) {
  constexpr int W = VecWidth<TT>::N;             // table elements per 16-byte load
  constexpr bool kQ8 = std::is_same<TT, int8_t>::value;
  __shared__ __align__(16) float hs[kDChunk * BT];
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ float blk_v[BT];
  __shared__ int blk_i[BT];
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
      if (d < cols && b0 + b < B) x = to_float(h[(size_t)(b0 + b) * D + c0 + d]);
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
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    float v = best_v[b];
    int i = best_i[b];
    block_best(v, i, s_val, s_idx);
    if (tid == 0) { blk_v[b] = v; blk_i[b] = i; }
  }
  __syncthreads();
  merge_blocks(blk_v, blk_i, BT, b0, B, V, tok, best, part_val, part_idx, counters, s_val,
               s_idx);
}

template <typename TT, typename HT, int BT>
int launch_fma_bt(int mode, const void* h, const void* table, const void* scales,
                  void* logits, void* tok, void* best, void* part_val, void* part_idx,
                  void* counters, int B, int V, int D, cudaStream_t stream) {
  const dim3 grid((V + kBlockRows - 1) / kBlockRows, (B + BT - 1) / BT);
  const auto* hh = static_cast<const HT*>(h);
  const auto* tt = static_cast<const TT*>(table);
  const auto* ss = static_cast<const float*>(scales);
  if (mode == 0)
    logits_kernel<TT, HT, BT, true><<<grid, kThreads, 0, stream>>>(
        hh, tt, ss, nullptr, static_cast<int*>(tok), static_cast<float*>(best),
        static_cast<float*>(part_val), static_cast<int*>(part_idx),
        static_cast<int*>(counters), B, V, D);
  else
    logits_kernel<TT, HT, BT, false><<<grid, kThreads, 0, stream>>>(
        hh, tt, ss, static_cast<float*>(logits), nullptr, nullptr, nullptr, nullptr, nullptr,
        B, V, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename TT, typename HT>
int launch_fma(int mode, const void* h, const void* table, const void* scales, void* logits,
               void* tok, void* best, void* part_val, void* part_idx, void* counters, int B,
               int V, int D, int blocks, cudaStream_t stream) {
  if (blocks != (V + kBlockRows - 1) / kBlockRows) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 1)
    return launch_fma_bt<TT, HT, 1>(mode, h, table, scales, logits, tok, best, part_val,
                                    part_idx, counters, B, V, D, stream);
  if (B <= 4)
    return launch_fma_bt<TT, HT, 4>(mode, h, table, scales, logits, tok, best, part_val,
                                    part_idx, counters, B, V, D, stream);
  return launch_fma_bt<TT, HT, kMaxBT>(mode, h, table, scales, logits, tok, best, part_val,
                                       part_idx, counters, B, V, D, stream);
}

// ---------------------------------------------------------------------------
// bf16-product route (tensor cores)
// ---------------------------------------------------------------------------

constexpr int kSegCols = 128;                   // columns of a row a warp takes per stage
constexpr int kRed = kWarps * 16 * kMaxBT;      // one tile's partial sums, every warp
constexpr int kSmemReserve = 2048;              // static shared memory and slack

// bytes of h's fragments in shared memory: 16 x 8 per (k-step, n-tile),
// k-steps covering D rounded up to whole 128-column segments
__host__ __device__ constexpr int mma_h_bytes(int D, int nt) {
  return (D + kSegCols - 1) / kSegCols * (kSegCols / 16) * nt * 256;
}

// stages in flight, at most: 4 of 16 x 256 bytes (bf16), 6 of 16 x 128 (int8)
template <typename TT> constexpr int max_stages() { return sizeof(TT) == 1 ? 6 : 4; }

__device__ __forceinline__ void wait_stages(int pending) {
  switch (pending) {                             // stages - 2 groups may stay in flight
    case 4: cp_async_wait<4>(); break;
    case 3: cp_async_wait<3>(); break;
    case 2: cp_async_wait<2>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<0>(); break;
  }
}

template <typename TT, typename HT, int NT, bool ARGMAX>
__global__ void __launch_bounds__(kThreads)
logits_mma_kernel(const HT* __restrict__ h, const TT* __restrict__ table,
                  const float* __restrict__ scales, float* __restrict__ logits,
                  int* __restrict__ tok, float* __restrict__ best, float* __restrict__ part_val,
                  int* __restrict__ part_idx, int* __restrict__ counters, int B, int V, int D,
                  int stages) {
  constexpr bool kQ8 = std::is_same<TT, int8_t>::value;
  constexpr int kSeg = kSegCols * sizeof(TT);    // bytes of a row's segment
  constexpr int kChunks = kSeg / 16;             // its 16-byte chunks
  constexpr int kStage = 16 * kSeg;              // a warp's stage: 16 rows
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ float blk_v[NT * 8];
  __shared__ int blk_i[NT * 8];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b0 = blockIdx.y * kMaxBT;
  const int n_seg = (D + kSegCols - 1) / kSegCols;
  const int ksteps = n_seg * (kSegCols / 16);
  uint2* hfrag = reinterpret_cast<uint2*>(smem);                 // [ksteps][NT][32]
  float* red = reinterpret_cast<float*>(smem + mma_h_bytes(D, NT));   // [2][warp][16][16]
  unsigned char* stage0 = reinterpret_cast<unsigned char*>(red + 2 * kRed) +
                          (size_t)warp * stages * kStage;

  // Row tile i of this block is rt = blockIdx.x + i gridDim.x (16 rows); its
  // segments s = warp, warp + 8, ... go to this warp, so at each stage the
  // block reads 8 neighbouring segments, 2 KB (bf16) of each of 16 rows.
  const int n_rt = (V + 15) / 16;
  const int my_tiles = (int)blockIdx.x < n_rt ? (n_rt - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const int nsw = warp < n_seg ? (n_seg - warp + kWarps - 1) / kWarps : 0;
  const int steps = my_tiles * nsw;
  const size_t row_bytes = (size_t)D * sizeof(TT);
  const unsigned char* tbytes = reinterpret_cast<const unsigned char*>(table);

  // step s: segment warp + 8 (s % nsw) of tile s / nsw, into slot s %
  // stages; chunk c of row r lands at chunk c ^ (r & 7) of its row.
  auto issue = [&](int s) {
    const int rt = blockIdx.x + (s / nsw) * gridDim.x;
    const size_t off0 = (size_t)(warp + kWarps * (s % nsw)) * kSeg;
    unsigned char* buf = stage0 + (s % stages) * kStage;
#pragma unroll
    for (int i = 0; i < 16 * kChunks / 32; ++i) {
      const int q = lane + 32 * i, r = q / kChunks, c = q % kChunks;
      const int v = rt * 16 + r;
      const size_t off = off0 + c * 16;
      const bool ok = v < V && off < row_bytes;
      cp_async16(buf + r * kSeg + ((c ^ (r & 7)) << 4),
                 ok ? tbytes + (size_t)v * row_bytes + off : tbytes, ok ? 16 : 0);
    }
  };

  // the first stages are in flight while h is laid out
  for (int s = 0; s < stages - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }

  // h in fragment order. Column k of k-step ks: bf16 table, the mma's own
  // order (b0 = 2t, 2t+1; b1 = 2t+8, 2t+9); int8 table, 4 neighbouring
  // columns 4t..4t+3 (the order the codes arrive in, see below).
  for (int idx = tid; idx < ksteps * NT * 32; idx += kThreads) {
    const int ks = idx / (NT * 32), nt = (idx / 32) % NT, ln = idx % 32;
    const int stream = b0 + nt * 8 + (ln >> 2), tt = ln & 3;
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = ks * 16 + (kQ8 ? 4 * tt + e : 2 * tt + (e & 1) + (e >> 1) * 8);
      x[e] = stream < B && col < D ? to_float(h[(size_t)stream * D + col]) : 0.f;
    }
    hfrag[idx] = make_uint2(pack_bf16x2(x[0], x[1]), pack_bf16x2(x[2], x[3]));
  }
  __syncthreads();

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  // the reduction's thread: stream rs = tid / 16, row rr = tid % 16 of a tile
  const int rs = tid >> 4, rr = tid & 15;
  float bv = kNegInf();
  int bi = INT_MAX;

  // ldmatrix: lane l addresses row (l % 8) + 8 ((l / 8) % 2), chunk l / 16
  // of each 32-byte column pair, so r[0..3] = a0..a3 of the bf16 k-step
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = lane >> 4;
  for (int i = 0; i < my_tiles; ++i) {
    const int v = (blockIdx.x + i * gridDim.x) * 16 + rr;
    const float sc = kQ8 && v < V && rs < NT * 8 ? scales[v] : 1.f;   // used after the tile
    for (int k = 0; k < nsw; ++k) {
      const int s = i * nsw + k;
      wait_stages(stages - 2);
      __syncwarp();
      if (s + stages - 1 < steps) issue(s + stages - 1);
      cp_async_commit();
      const unsigned char* buf = stage0 + (s % stages) * kStage;
      const int ks0 = (warp + kWarps * k) * (kSegCols / 16);
#pragma unroll
      for (int j = 0; j < kSeg / 32; ++j) {       // 32 bytes of each row
        uint32_t r[4];
        ldmatrix_x4(r, buf + lr * kSeg + (((2 * j + lc) ^ (lr & 7)) << 4));
        if constexpr (kQ8) {
          // codes 4t..4t+3 of a 16-column half stand for the mma's k = 2t,
          // 2t+1 (a0 / a1) and 2t+8, 2t+9 (a2 / a3); h is laid out alike
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const uint2 lo = int8x4_to_bf16(r[2 * half]), hi = int8x4_to_bf16(r[2 * half + 1]);
            const uint32_t a[4] = {lo.x, hi.x, lo.y, hi.y};
            const int ks = ks0 + 2 * j + half;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const uint2 hb = hfrag[(ks * NT + nt) * 32 + lane];
              mma_bf16(acc[nt], a, hb.x, hb.y);
            }
          }
        } else {
          const int ks = ks0 + j;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const uint2 hb = hfrag[(ks * NT + nt) * 32 + lane];
            mma_bf16(acc[nt], r, hb.x, hb.y);
          }
        }
      }
    }
    // this warp's partial sums of the tile: rows g (c0, c1), g + 8 (c2, c3),
    // streams 8 nt + 2t (c0, c2), + 1 (c1, c3)
    float* mine = red + (i & 1) * kRed + warp * 16 * kMaxBT;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        mine[(g + 8 * (e >> 1)) * kMaxBT + nt * 8 + 2 * t + (e & 1)] = acc[nt][e];
        acc[nt][e] = 0.f;
      }
    }
    __syncthreads();
    // the tile's logits, summed over the warps in order (the same order for
    // every row): thread (rs, rr) takes stream rs of row rr
    if (rs < NT * 8) {
      const float* tile_red = red + (i & 1) * kRed + rr * kMaxBT + rs;
      float lg = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) lg += tile_red[w * 16 * kMaxBT];
      if (v < V) {
        if (kQ8) lg *= sc;
        if (ARGMAX) {
          if (better(lg, v, bv, bi)) { bv = lg; bi = v; }
        } else if (b0 + rs < B) {
          logits[(size_t)(b0 + rs) * V + v] = lg;
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!ARGMAX) return;

  // per stream: the best of its 16 threads (lanes of one half-warp)
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
  }
  if (rr == 0 && rs < NT * 8) { blk_v[rs] = bv; blk_i[rs] = bi; }
  __syncthreads();
  merge_blocks(blk_v, blk_i, NT * 8, b0, B, V, tok, best, part_val, part_idx, counters, s_val,
               s_idx);
}

template <typename TT, typename HT, int NT>
int launch_mma_nt(int mode, const void* h, const void* table, const void* scales,
                  void* logits, void* tok, void* best, void* part_val, void* part_idx,
                  void* counters, int B, int V, int D, int blocks, cudaStream_t stream) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int limit = optin - kSmemReserve;
  const int stage = 16 * kSegCols * (int)sizeof(TT);
  const int fixed = mma_h_bytes(D, NT) + 2 * kRed * (int)sizeof(float);
  const int stages = min(max_stages<TT>(), (limit - fixed) / (kWarps * stage));
  if (stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)fixed + (size_t)stages * kWarps * stage;
  static bool raised[2][64] = {};                // the shared-memory limit, per device
  const bool argmax = mode == 0;
  if (dev < 64 && !raised[argmax][dev]) {
    cudaError_t err = argmax
        ? cudaFuncSetAttribute(logits_mma_kernel<TT, HT, NT, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, limit)
        : cudaFuncSetAttribute(logits_mma_kernel<TT, HT, NT, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised[argmax][dev] = true;
  }
  const dim3 grid(blocks, (B + kMaxBT - 1) / kMaxBT);
  const auto* hh = static_cast<const HT*>(h);
  const auto* tt = static_cast<const TT*>(table);
  const auto* ss = static_cast<const float*>(scales);
  if (argmax)
    logits_mma_kernel<TT, HT, NT, true><<<grid, kThreads, smem, stream>>>(
        hh, tt, ss, nullptr, static_cast<int*>(tok), static_cast<float*>(best),
        static_cast<float*>(part_val), static_cast<int*>(part_idx),
        static_cast<int*>(counters), B, V, D, stages);
  else
    logits_mma_kernel<TT, HT, NT, false><<<grid, kThreads, smem, stream>>>(
        hh, tt, ss, static_cast<float*>(logits), nullptr, nullptr, nullptr, nullptr, nullptr,
        B, V, D, stages);
  return static_cast<int>(cudaGetLastError());
}

template <typename TT, typename HT>
int launch_mma(int mode, const void* h, const void* table, const void* scales, void* logits,
               void* tok, void* best, void* part_val, void* part_idx, void* counters, int B,
               int V, int D, int blocks, cudaStream_t stream) {
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 8)
    return launch_mma_nt<TT, HT, 1>(mode, h, table, scales, logits, tok, best, part_val,
                                    part_idx, counters, B, V, D, blocks, stream);
  return launch_mma_nt<TT, HT, 2>(mode, h, table, scales, logits, tok, best, part_val,
                                  part_idx, counters, B, V, D, blocks, stream);
}

}  // namespace

extern "C" {

// table_kind: 0 = f32, 1 = bf16 (no scales), 2 = int8 with f32 scales [V].
// h_dtype: 0 = f32, 1 = bf16; h is [B, D]. Route: a bf16 table, or an int8
// table with bf16 h, takes the tensor cores; the rest the CUDA cores.
// blocks: grid.x, from the wrapper (ops/logits_argmax.k3_plan): ceil(V / 512)
// on the CUDA cores, at most one block per SM on the tensor cores.
// mode: 0 = argmax (tok int32 [B]; part_val/part_idx scratch of blocks *
// ceil(B / 16) * 16 entries; counters int32, zero, ceil(B / 16) entries,
// left zero by every launch, so one stream at a time; best: f32 [B], the
// winning logits, or null), 1 = logits (f32 [B, V]). D % 16 == 0 and
// 16-byte aligned table rows. Returns the CUDA error code of the launch
// (0 = launched).
int logits_argmax_launch(int table_kind, int h_dtype, int mode, const void* h,
                         const void* table, const void* scales, void* logits, void* tok,
                         void* best, void* part_val, void* part_idx, void* counters, int B,
                         int V, int D, int blocks, void* stream) {
  if (B < 1 || V < 1 || D < 16 || D % 16 || (mode != 0 && mode != 1) ||
      reinterpret_cast<uintptr_t>(table) % 16 || (table_kind == 2 && scales == nullptr) ||
      (B + kMaxBT - 1) / kMaxBT > 65535 || (h_dtype != 0 && h_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (table_kind == 1) {
    if (h_dtype == 0)
      return launch_mma<__nv_bfloat16, float>(mode, h, table, scales, logits, tok, best,
                                              part_val, part_idx, counters, B, V, D, blocks, st);
    return launch_mma<__nv_bfloat16, __nv_bfloat16>(mode, h, table, scales, logits, tok, best,
                                                    part_val, part_idx, counters, B, V, D,
                                                    blocks, st);
  }
  if (table_kind == 2) {
    if (h_dtype == 1)
      return launch_mma<int8_t, __nv_bfloat16>(mode, h, table, scales, logits, tok, best,
                                               part_val, part_idx, counters, B, V, D, blocks, st);
    return launch_fma<int8_t, float>(mode, h, table, scales, logits, tok, best, part_val,
                                     part_idx, counters, B, V, D, blocks, st);
  }
  if (table_kind == 0) {
    if (h_dtype == 0)
      return launch_fma<float, float>(mode, h, table, scales, logits, tok, best, part_val,
                                      part_idx, counters, B, V, D, blocks, st);
    return launch_fma<float, __nv_bfloat16>(mode, h, table, scales, logits, tok, best,
                                            part_val, part_idx, counters, B, V, D, blocks, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
