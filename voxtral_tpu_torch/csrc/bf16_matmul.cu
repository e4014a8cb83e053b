// Skinny bf16 matrix product for Hopper (sm_90a), T3: the decode-regime
// product of a few rows of bf16 activations with a bf16 weight.
//
// Replaces the Pallas kernel `pallas_matmul`, tools/profile_weight_stream.py:98
// (pallas_call :103): x bf16 [B, K] @ w bf16 [K, N] -> f32 [B, N], K-blocked
// by 1536 and N-blocked by 1024 there, each output block accumulated in f32
// over the K blocks. That grid has k // 1536 steps, so it skips the last
// K % 1536 rows; this kernel computes the product over the whole K.
//
// What it computes: y[m, n] = sum_k x[m, k] * w[k, n], summed in f32
// (products of bf16 values are exact in f32; only the order of the sum
// differs from a plain f32 product). 1 <= B <= 64.
//
// Bound: bytes at decode's B (24 in the tool): each call must read K * N * 2
// weight bytes once; 2 B K N operations at 989 TFLOP/s are ~30x less time.
//
// Design (one launch per call):
//   * tensor cores: mma.sync m16n8k16 (bf16 operands, f32 accumulator), all
//     of B's 16-row tiles in one block (the kernel is compiled for 1 to 4
//     tiles, so a small B holds fewer accumulators), so every weight byte is
//     read once whatever B;
//   * a block owns 32 columns and a slice of K, taken in chunks of 256 rows;
//     its 4 warps take a chunk's 16-row steps in turn, 4 steps each. Each
//     warp issues all the weight loads of its 4 steps, then the block copies
//     the chunk's x rows into shared memory (16-byte loads, overlapping the
//     weight loads), so a chunk waits for memory once. A lane holds B
//     fragment rows 2t, 2t+1, 2t+8, 2t+9 (t = lane % 4) of mma column g
//     (g = lane / 4) of each of the 4 tiles of 8 columns; mapping tile j's
//     column g to the physical column 4g + j lets it read them as four
//     8-byte loads of 4 neighbouring columns, one per row, and pair two
//     rows' halves with one byte permute (the layout of K2's bf16 path,
//     without the code-to-bf16 step). A fragments come from shared memory,
//     rows padded so the reads hit 32 banks;
//   * split K fills the card where N has few column tiles, at most one wave
//     of resident blocks (the wrapper asks the runtime how many fit); one
//     launch and no float atomics: each block writes its f32 partial, and
//     the last block of a column tile to arrive (counter + __threadfence)
//     sums the partials in split order, writes y and resets the counter, so
//     the result does not depend on the order the blocks ran in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr int kThreads = 128;                 // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 32;                     // columns per block: 4 mma tiles of 8
constexpr int kSteps = 4;                     // 16-row steps per warp per chunk
constexpr int kChunk = 16 * kSteps * kWarps;  // 256 rows of K per chunk
constexpr int kXsRow = kChunk + 8;            // padded shared row of x (bf16)
constexpr int kMaxM = 64;                     // BF16_MATMUL_MAX_ROWS in ops/bf16_matmul.py

using mma_common::mma_bf16;

// Column j (0..3) of two rows' 4-column words as one bf16x2: the low half
// from row `lo`, the high half from row `hi`.
__device__ __forceinline__ uint32_t pair(const uint2& lo, const uint2& hi, int j) {
  const uint32_t a = j < 2 ? lo.x : lo.y, b = j < 2 ? hi.x : hi.y;
  return __byte_perm(a, b, (j & 1) ? 0x7632 : 0x5410);
}

template <int MT>   // 16-row tiles of x: M <= 16 MT
__global__ void __launch_bounds__(kThreads)
bf16_matmul_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                   float* __restrict__ y, float* __restrict__ part,
                   int* __restrict__ counters, int M, int K, int N, int k_slice) {
  constexpr int kRows = 16 * MT;
  constexpr int kXsBytes = kRows * kXsRow * 2, kRedBytes = kWarps * kRows * kCols * 4;
  // x's chunk rows during the K loop, then the warps' sums (`red`)
  __shared__ __align__(16) unsigned char smem[kXsBytes > kRedBytes ? kXsBytes : kRedBytes];
  __shared__ int is_last;
  auto xs = reinterpret_cast<__nv_bfloat16(*)[kXsRow]>(smem);
  auto red = reinterpret_cast<float(*)[kRows][kCols]>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col = blockIdx.x * kCols + 4 * g;   // this lane's 4 physical columns
  const bool col_ok = col < N;                  // N % 4 == 0
  const int k_begin = blockIdx.y * k_slice;
  const int k_end = min(K, k_begin + k_slice);  // a multiple of 8

  float c[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[mt][j][e] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kChunk) {
    // The weight rows of this warp's steps, all loads in flight together.
    uint2 b[kSteps][4];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int r = k0 + (warp + kWarps * i) * 16 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = r + 8 * h;               // rr even, k_end a multiple of 8
        const bool ok = col_ok && rr < k_end;
        b[i][2 * h] = ok ? __ldg(reinterpret_cast<const uint2*>(w + (size_t)rr * N + col))
                         : make_uint2(0u, 0u);
        b[i][2 * h + 1] =
            ok ? __ldg(reinterpret_cast<const uint2*>(w + (size_t)(rr + 1) * N + col))
               : make_uint2(0u, 0u);
      }
    }
    // The chunk's x rows (zero past M and past the slice) into shared memory.
    for (int e = tid; e < kRows * (kChunk / 8); e += kThreads) {
      const int m = e / (kChunk / 8), kv = (e % (kChunk / 8)) * 8;
      *reinterpret_cast<uint4*>(&xs[m][kv]) =
          m < M && k0 + kv < k_end
              ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)m * K + k0 + kv))
              : make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int kk = (warp + kWarps * i) * 16;  // within the chunk
      if (k0 + kk >= k_end) break;
      uint32_t bf[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bf[j][0] = pair(b[i][0], b[i][1], j);
        bf[j][1] = pair(b[i][2], b[i][3], j);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // A: a0 (row g, k 2t..2t+1), a1 (row g+8), a2/a3 the same at k + 8
        const int ra = 16 * mt + g;
        const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(&xs[ra][kk + 2 * t]),
                               *reinterpret_cast<const uint32_t*>(&xs[ra + 8][kk + 2 * t]),
                               *reinterpret_cast<const uint32_t*>(&xs[ra][kk + 8 + 2 * t]),
                               *reinterpret_cast<const uint32_t*>(&xs[ra + 8][kk + 8 + 2 * t])};
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(c[mt][j], a, bf[j][0], bf[j][1]);
      }
    }
    __syncthreads();                            // xs is rewritten next chunk
  }
  // c[mt][j]: rows 16 mt + g, + 8 and tile columns 2t, 2t+1, i.e. physical
  // columns 4 (2t) + j and 4 (2t + 1) + j of the block's 32.
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[warp][16 * mt + g][8 * t + j] = c[mt][j][0];
      red[warp][16 * mt + g][8 * t + 4 + j] = c[mt][j][1];
      red[warp][16 * mt + g + 8][8 * t + j] = c[mt][j][2];
      red[warp][16 * mt + g + 8][8 * t + 4 + j] = c[mt][j][3];
    }
  }
  __syncthreads();
  const int split = blockIdx.y, splits = gridDim.y;
  for (int o = tid; o < M * kCols; o += kThreads) {
    const int m = o / kCols, cc = o % kCols, nn = blockIdx.x * kCols + cc;
    if (nn >= N) continue;
    const float v = ((red[0][m][cc] + red[1][m][cc]) + red[2][m][cc]) + red[3][m][cc];
    if (splits == 1)
      y[(size_t)m * N + nn] = v;
    else
      __stcg(part + ((size_t)split * M + m) * N + nn, v);
  }
  if (splits == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + blockIdx.x, 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  for (int o = tid; o < M * kCols; o += kThreads) {
    const int m = o / kCols, nn = blockIdx.x * kCols + o % kCols;
    if (nn >= N) continue;
    float v = 0.f;
    for (int sp = 0; sp < splits; ++sp) v += __ldcg(part + ((size_t)sp * M + m) * N + nn);
    y[(size_t)m * N + nn] = v;
  }
  if (tid == 0) counters[blockIdx.x] = 0;
}

template <int MT>
int launch(const void* x, const void* w, void* y, void* part, void* counters, int M, int K,
           int N, int k_slice, int splits, cudaStream_t st) {
  const dim3 grid((N + kCols - 1) / kCols, splits);
  bf16_matmul_kernel<MT><<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<float*>(y), static_cast<float*>(part), static_cast<int*>(counters), M, K, N,
      k_slice);
  return static_cast<int>(cudaGetLastError());
}

template <int MT>
int occupancy(int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, bf16_matmul_kernel<MT>, kThreads, 0));
}

}  // namespace

extern "C" {

// Device pointers: x bf16 [M, K] (16-byte aligned), w bf16 [K, N] (8-byte
// aligned), y f32 [M, N]; part: f32 scratch of splits * M * N (unused when
// splits == 1); counters: int32, zero, at least ceil(N / 32) entries, left
// zero by every launch (so one stream at a time). Split s covers rows
// [s * k_slice, (s + 1) * k_slice) of K; k_slice a multiple of 16, every
// split non-empty. 1 <= M <= 64, K % 8 == 0, N % 4 == 0. Returns the CUDA
// error code of the launch (0 = launched).
int bf16_matmul_launch(const void* x, const void* w, void* y, void* part, void* counters,
                       int M, int K, int N, int k_slice, int splits, void* stream) {
  if (M < 1 || M > kMaxM || K < 8 || K % 8 || N < 4 || N % 4 || k_slice < 16 ||
      k_slice % 16 || splits < 1 || splits > 65535 || (long long)k_slice * splits < K ||
      (long long)k_slice * (splits - 1) >= K || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((M + 15) / 16) {
    case 1: return launch<1>(x, w, y, part, counters, M, K, N, k_slice, splits, st);
    case 2: return launch<2>(x, w, y, part, counters, M, K, N, k_slice, splits, st);
    case 3: return launch<3>(x, w, y, part, counters, M, K, N, k_slice, splits, st);
    default: return launch<4>(x, w, y, part, counters, M, K, N, k_slice, splits, st);
  }
}

// blocks: the resident blocks per SM of the kernel for M rows (1..64).
// Returns the CUDA error code (0 = ok).
int bf16_matmul_blocks_per_sm(int M, int* blocks) {
  if (M < 1 || M > kMaxM) return static_cast<int>(cudaErrorInvalidValue);
  switch ((M + 15) / 16) {
    case 1: return occupancy<1>(blocks);
    case 2: return occupancy<2>(blocks);
    case 3: return occupancy<3>(blocks);
    default: return occupancy<4>(blocks);
  }
}

}  // extern "C"
