// W8A16 GEMV for Hopper (sm_90a), K2: the decode-regime product of bf16 or
// f32 activations with Q8 weights.
//
// Replaces no Pallas kernel: the JAX package computes this product as an XLA
// mixed-dtype dot (voxtral_tpu/ops/linear.py:25-29,
// `dot_general(x, q, preferred_element_type=f32) * s`, then cast to x's
// dtype). No PyTorch call multiplies bf16 by int8, so the port needs a hand
// kernel for the decode step's matrix-vector products.
//
// What it computes:
//   y[m, n] = round_to<T>((sum_k x[m, k] * q[k, n]) * s[n])
// x: [M, K] in T (f32 or bf16), M <= 64; q: int8 [K, N], N contiguous (the
// param tree's [in, out] layout); s: f32 [N]; y: [M, N] in T. Products are
// exact in f32 (a bf16 value times |q| <= 127) and summed in f32; the scale
// multiplies the f32 sum, then the result is rounded to T, as in JAX.
//
// Bound: bytes at small M. Each call must read K*N weight bytes once: at the
// fleet's M = 16 the decoder's seven matrices are 3.76 us (wq, wo), 0.94 us
// (wk, wv) and 8.45 us (w1, w3, w2) at 3.35 TB/s; the tensor cores' bf16
// rate makes the operations negligible beside that.
//
// Design (two kernels, one launch per call either way):
//   * bf16 x, any M <= 64: tensor cores (mma.sync m16n8k16, bf16 operands,
//     f32 accumulator), M in tiles of 16 rows (grid.z); the codes are
//     converted to bf16 in registers (exact), x is read as pairs of bf16;
//   * f32 x (f32 models, used for checks): f32 FMAs on CUDA cores, 16
//     FMAs per weight byte whatever M, x staged in shared memory as f32;
//   * both: a block owns 32 columns and a slice of at most 512 rows of K;
//     each thread takes 4 neighbouring columns per row with one 4-byte load
//     and issues every weight load of its slice before it computes, so they
//     are in flight together; every weight byte is read once and used for
//     all (up to 16) rows of x of the block;
//   * split K fills the card and keeps slices short (N = 1024 gives 32
//     column tiles); one launch and no float atomics: each block writes its
//     f32 partial, and the last block of a column tile to arrive (counter +
//     __threadfence) sums the partials in split order, scales, rounds,
//     writes y and resets the counter, so results do not depend on the
//     order the blocks ran in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ring_common.cuh"

namespace {

using ring_common::from_float;

constexpr int kThreads = 128;   // 4 warps
constexpr int kCols = 32;       // columns per block: 8 lanes x 4 columns
constexpr int kRowStep = 16;    // rows per step (f32 kernel: 4 warps x 4 lane groups)
constexpr int kSlice = 512;     // the most rows of K one block takes
constexpr int kLoads = kSlice / kRowStep;
constexpr int kMTile = 16;      // rows of x per block (grid.z covers M)
constexpr int kMaxM = 64;       // Q8_GEMV_MAX_ROWS in ops/q8_matmul.py

// The block's [16 x 32] tile of sums, one partial per warp in `red`: sum the
// warps in order; one split writes y = round_to<T>(sum * s); with split K,
// each block writes its f32 partial and the last block of the column tile
// to arrive (counter + __threadfence) sums the partials in split order,
// scales, rounds, writes y and resets the counter.
template <typename T>
__device__ __forceinline__ void finish_tile(const float (*red)[kMTile][kCols],
                                            const float* __restrict__ s, T* __restrict__ y,
                                            float* __restrict__ part,
                                            int* __restrict__ counters, int M, int N,
                                            int m0, int* is_last) {
  const int tid = threadIdx.x, split = blockIdx.y, splits = gridDim.y;
  for (int o = tid; o < kMTile * kCols; o += kThreads) {
    const int m = o / kCols, col = o % kCols;
    const int mm = m0 + m, nn = blockIdx.x * kCols + col;
    if (mm >= M || nn >= N) continue;
    const float v = ((red[0][m][col] + red[1][m][col]) + red[2][m][col]) + red[3][m][col];
    if (splits == 1)
      y[(size_t)mm * N + nn] = from_float<T>(v * s[nn]);
    else
      __stcg(part + ((size_t)split * M + mm) * N + nn, v);
  }
  if (splits == 1) return;
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  if (tid == 0) *is_last = atomicAdd(counters + tile, 1) == splits - 1;
  __syncthreads();
  if (!*is_last) return;
  for (int o = tid; o < kMTile * kCols; o += kThreads) {
    const int mm = m0 + o / kCols, nn = blockIdx.x * kCols + o % kCols;
    if (mm >= M || nn >= N) continue;
    float v = 0.f;
    for (int sp = 0; sp < splits; ++sp) v += __ldcg(part + ((size_t)sp * M + mm) * N + nn);
    y[(size_t)mm * N + nn] = from_float<T>(v * s[nn]);
  }
  if (tid == 0) counters[tile] = 0;
}

// f32 x on the CUDA cores.
__global__ void __launch_bounds__(kThreads)
w8a16_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ s, float* __restrict__ y,
                 float* __restrict__ part, int* __restrict__ counters, int M, int K, int N,
                 int k_slice) {
  constexpr int W = ring_common::VecWidth<float>::N;   // x elements per 16-byte load
  constexpr int kVecs = kMTile * kSlice / W;           // 16-byte loads of x per block
  constexpr int kVecsPerThread = (kVecs + kThreads - 1) / kThreads;
  __shared__ __align__(16) float xs[kMTile][kSlice];
  __shared__ float red[kThreads / 32][kMTile][kCols];
  __shared__ int is_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = lane & 7;                       // column group of 4
  const int row0 = warp * 4 + (lane >> 3);       // row within each step of 16
  const int n = blockIdx.x * kCols + cg * 4;
  const bool col_ok = n < N;                     // N % 4 == 0
  const int m0 = blockIdx.z * kMTile;
  const int k_begin = blockIdx.y * k_slice;
  const int rows = min(k_slice, K - k_begin);    // <= kSlice, a multiple of 8

  // Every weight load of the block's slice first, all in flight together.
  char4 w[kLoads];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int r = row0 + i * kRowStep;
    w[i] = (col_ok && r < rows)
               ? __ldg(reinterpret_cast<const char4*>(q + (size_t)(k_begin + r) * N + n))
               : make_char4(0, 0, 0, 0);
  }
  // Then x's rows of the slice into shared memory as f32, in 16-byte loads
  // issued four at a time before their stores.
  for (int j0 = 0; j0 < kVecsPerThread; j0 += 4) {
    float v[4][W];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = tid + (j0 + j) * kThreads;
      const int m = e / (kSlice / W), r = (e % (kSlice / W)) * W;
      if (e < kVecs && m0 + m < M && r < rows) {
        ring_common::load16(x + (size_t)(m0 + m) * K + k_begin + r, v[j]);
      } else {
#pragma unroll
        for (int t = 0; t < W; ++t) v[j][t] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = tid + (j0 + j) * kThreads;
      if (e >= kVecs) continue;
      const int m = e / (kSlice / W), r = (e % (kSlice / W)) * W;
#pragma unroll
      for (int t = 0; t < W; t += 4)
        *reinterpret_cast<float4*>(&xs[m][r + t]) =
            make_float4(v[j][t], v[j][t + 1], v[j][t + 2], v[j][t + 3]);
    }
  }
  __syncthreads();

  float acc[kMTile][4];
#pragma unroll
  for (int m = 0; m < kMTile; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int r = row0 + i * kRowStep;           // rows past `rows`: w and xs are 0
    const float w0 = w[i].x, w1 = w[i].y, w2 = w[i].z, w3 = w[i].w;
#pragma unroll
    for (int m = 0; m < kMTile; ++m) {
      const float xv = xs[m][r];
      acc[m][0] = fmaf(xv, w0, acc[m][0]);
      acc[m][1] = fmaf(xv, w1, acc[m][1]);
      acc[m][2] = fmaf(xv, w2, acc[m][2]);
      acc[m][3] = fmaf(xv, w3, acc[m][3]);
    }
  }

  // The 4 lane groups of a warp hold sums over different rows of the same
  // columns: add them (every lane ends with the same value), then the warps
  // in order.
#pragma unroll
  for (int m = 0; m < kMTile; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float v = acc[m][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][c] = v;
    }
  if (lane < 8) {
#pragma unroll
    for (int m = 0; m < kMTile; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) red[warp][m][cg * 4 + c] = acc[m][c];
  }
  __syncthreads();
  finish_tile<float>(red, s, y, part, counters, M, N, m0, &is_last);
}

// bf16 x on the tensor cores: mma.sync m16n8k16 (bf16 operands, f32
// accumulator). A block owns 32 columns and a slice of at most 512 rows,
// like the kernel above; its 4 warps take the slice's 16-row steps in turn,
// each warp the whole 16 x 32 tile as 4 mma tiles of 8 columns. A lane
// holds B fragment rows 2t, 2t+1, 2t+8, 2t+9 (t = lane % 4) of "column" g
// (g = lane / 4) of every tile; mapping tile j's column g to the physical
// column 4g + j lets it read them as four 4-byte loads of 4 neighbouring
// columns, one per row, and convert the codes to bf16 in registers. The A
// fragment (x) is read from memory in pairs of bf16.
constexpr int kMmaSteps = kSlice / 16 / (kThreads / 32);   // steps per warp

__device__ __forceinline__ uint32_t codes_to_bf16x2(uint32_t lo_word, uint32_t hi_word, int j) {
  const float lo = static_cast<int8_t>((lo_word >> (8 * j)) & 0xffu);
  const float hi = static_cast<int8_t>((hi_word >> (8 * j)) & 0xffu);
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // exact: |code| <= 127
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
w8a16_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ s, __nv_bfloat16* __restrict__ y,
                 float* __restrict__ part, int* __restrict__ counters, int M, int K, int N,
                 int k_slice) {
  __shared__ float red[kThreads / 32][kMTile][kCols];
  __shared__ int is_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col = blockIdx.x * kCols + 4 * g;   // this lane's 4 physical columns
  const bool col_ok = col < N;                  // N % 4 == 0
  const int m0 = blockIdx.z * kMTile;
  const int k_begin = blockIdx.y * k_slice;
  const int rows = min(k_slice, K - k_begin);   // a multiple of 8
  const int n_steps = (rows + 15) / 16;
  const bool row_a = m0 + g < M, row_b = m0 + g + 8 < M;
  const __nv_bfloat16* xa = x + (size_t)(m0 + g) * K + k_begin + 2 * t;
  const __nv_bfloat16* xb = xa + 8 * (size_t)K;
  const int8_t* qc = q + (size_t)k_begin * N + col;

  // All loads of this warp's steps first, so they are in flight together.
  uint32_t w[kMmaSteps][4], a[kMmaSteps][4];
#pragma unroll
  for (int i = 0; i < kMmaSteps; ++i) {
    const int r = (warp + 4 * i) * 16 + 2 * t;  // rows r, r+1 (low) and r+8, r+9 (high)
    const bool lo = r < rows, hi = r + 8 < rows;    // (rows is a multiple of 8)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool ok = (h == 0 ? lo : hi);
      const int rr = r + 8 * h;
      w[i][2 * h] = ok && col_ok ? __ldg(reinterpret_cast<const unsigned int*>(qc + (size_t)rr * N)) : 0u;
      w[i][2 * h + 1] =
          ok && col_ok ? __ldg(reinterpret_cast<const unsigned int*>(qc + (size_t)(rr + 1) * N)) : 0u;
      const int kk = (warp + 4 * i) * 16 + 8 * h;
      a[i][2 * h] = ok && row_a ? __ldg(reinterpret_cast<const unsigned int*>(xa + kk)) : 0u;
      a[i][2 * h + 1] = ok && row_b ? __ldg(reinterpret_cast<const unsigned int*>(xb + kk)) : 0u;
    }
  }
  float c[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int i = 0; i < kMmaSteps; ++i) {
    if (warp + 4 * i >= n_steps) break;
    // A: a0 (row g, k 2t..2t+1), a1 (row g+8, same k), a2/a3 the same at k + 8
    const uint32_t af[4] = {a[i][0], a[i][1], a[i][2], a[i][3]};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      mma_bf16(c[j], af, codes_to_bf16x2(w[i][0], w[i][1], j),
               codes_to_bf16x2(w[i][2], w[i][3], j));
  }
  // c[j]: rows g, g+8 and tile columns 2t, 2t+1, i.e. physical columns
  // 4 (2t) + j and 4 (2t + 1) + j of the block's 32.
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[warp][g][8 * t + j] = c[j][0];
    red[warp][g][8 * t + 4 + j] = c[j][1];
    red[warp][g + 8][8 * t + j] = c[j][2];
    red[warp][g + 8][8 * t + 4 + j] = c[j][3];
  }
  __syncthreads();
  finish_tile<__nv_bfloat16>(red, s, y, part, counters, M, N, m0, &is_last);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and y). Device pointers: x [M, K],
// q int8 [K, N], s f32 [N], y [M, N]; part: f32 scratch of splits * M * N
// (unused when splits == 1); counters: int32, zero, at least
// ceil(N / 32) * ceil(M / 16) entries, left zero by every launch (so one
// stream at a time). Split s covers rows [s * k_slice, (s + 1) * k_slice) of
// K; k_slice must be a multiple of 16, at most 512, and every split
// non-empty. 1 <= M <= 64, K % 8 == 0, N % 4 == 0, x 16-byte and q 4-byte
// aligned. Returns the CUDA error code of the launch
// (0 = launched).
int w8a16_gemv_launch(int dtype, const void* x, const void* q, const void* s, void* y,
                      void* part, void* counters, int M, int K, int N, int k_slice,
                      int splits, void* stream) {
  if (M < 1 || M > kMaxM || K < 8 || K % 8 || N < 4 || N % 4 || k_slice < 1 ||
      k_slice > kSlice || k_slice % kRowStep || splits < 1 || splits > 65535 ||
      (long long)k_slice * splits < K || (long long)k_slice * (splits - 1) >= K ||
      reinterpret_cast<uintptr_t>(q) % 4 || reinterpret_cast<uintptr_t>(x) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kCols - 1) / kCols, splits, (M + kMTile - 1) / kMTile);
  const auto* qq = static_cast<const int8_t*>(q);
  const auto* ss = static_cast<const float*>(s);
  auto* pp = static_cast<float*>(part);
  auto* cc = static_cast<int*>(counters);
  if (dtype == 0)
    w8a16_f32_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), qq, ss, static_cast<float*>(y), pp, cc, M, K, N, k_slice);
  else if (dtype == 1)
    w8a16_mma_kernel<<<grid, kThreads, 0, st>>>(static_cast<const __nv_bfloat16*>(x), qq, ss,
                                              static_cast<__nv_bfloat16*>(y), pp, cc, M, K, N,
                                              k_slice);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
