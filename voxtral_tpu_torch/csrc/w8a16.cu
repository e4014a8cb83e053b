// W8A16 GEMV for Hopper (sm_90a), K2: the decode-regime product of bf16 or
// f32 activations with Q8 weights.
//
// Replaces no Pallas kernel: the JAX package computes this product as an XLA
// mixed-dtype dot (voxtral_tpu/ops/linear.py:25-29,
// `dot_general(x, q, preferred_element_type=f32) * s`, then cast to x's
// dtype). No PyTorch call multiplies bf16 by int8 with f32 scales in that
// layout, so the port needs a hand kernel for the decode step's products.
//
// What it computes:
//   y[m, n] = round_to<T>((sum_k x[m, k] * q[k, n]) * s[n])
// x: [M, K] in T (f32 or bf16), M <= 64; q: int8 [K, N], N contiguous (the
// param tree's [in, out] layout); s: f32 [N]; y: [M, N] in T. Products are
// exact in f32 (a bf16 value times |q| <= 127) and summed in f32; the scale
// multiplies the f32 sum, then the result is rounded to T, as in JAX.
//
// Bound: bytes at decode's M. Each call must read K * N code bytes once: at
// the fleet's M = 16 the decoder's seven matrices are 3.76 us (wq, wo),
// 0.94 us (wk, wv) and 8.45 us (w1, w3, w2) at 3.35 TB/s; 2 M K N operations
// at the tensor cores' bf16 rate are ~1/20 of that. So the bf16 route is a
// memory pipeline that keeps enough code bytes in flight, in whole 128-byte
// lines, with x and the code conversion out of its way:
//   * a block owns 128 columns (one whole 128-byte line of every code row)
//     and a slice of K, taken in stages of 64 rows;
//   * each stage (the 8 KB code tile and the x rows of the same 64 k) comes
//     in by 16-byte cp.async.cg into a ring of 4 shared-memory stages, so
//     three stages are in flight while one is multiplied; rows
//     past K, columns past N and x rows past M are zero-filled without a
//     global read. x is read once per stage and column tile, so it costs a
//     block 2 x 16 MT bytes per code row against the codes' 128;
//   * tensor cores: mma.sync m16n8k16 (bf16 operands, f32 accumulator), all
//     of M's 16-row tiles in one block (compiled for 1 to 4 tiles), so every
//     code byte is read once whatever M. Warp w owns the block's columns
//     32 w .. 32 w + 31 as 4 n-tiles whose fragment column g is the physical
//     column 32 w + 4 g + j of tile j: a lane reads one 32-bit word (4
//     neighbouring codes) of each of the rows 2t, 2t+1, 2t+8, 2t+9 of a
//     16-row k-step from the stage, interleaves the bytes of each row pair
//     with one byte permute and converts them exactly to the bf16 pairs
//     of the B fragments (mma_common::int8x4_to_bf16_pairs: byte permutes
//     and one bf16x2 subtraction, no int-to-float convert). The code tile is
//     XOR-swizzled by row pairs so those loads meet no bank conflict; A
//     fragments come from the x tile by ldmatrix.x4 (swizzled as in T3);
//   * every copy and shared-memory address that does not change from stage
//     to stage is computed once (the loop's instruction count sets the read
//     rate at a few warps per SM, as T3 found). A block of 4 warps holds
//     40-64 KB of stages, so 3-5 blocks share an SM;
//   * split K fills the card where N has few column tiles, at most one wave
//     of resident blocks (the wrapper's plan, ops/q8_matmul.k2_plan, asks
//     the runtime how many fit): one launch and no float atomics. The splits
//     of a column tile (at most 8) are one thread-block cluster, so they are
//     resident together: each block leaves its f32 partial in its own shared
//     memory, and after a cluster barrier each block sums a contiguous share
//     of the tile's outputs over the cluster's partials in split order
//     through distributed shared memory, scales, rounds and writes y. The
//     bits do not depend on the order the blocks ran in, no partial goes
//     through device memory and nothing is allocated per call. wk/wv (N
//     1024: 8 column tiles) gets 64 blocks and is left so (below).
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6, K2 row, and
// tools/profile_k2_variants.py, which times each choice against its
// alternatives): w1/w3 and w2 at M 16 in 14.8-15.2 us, 0.56-0.58 of the
// byte bound (the design before this one took 34.7-36.1 us); M 32 and 38
// within 1.15x of M 16. A launch's fixed costs (the grid, the cluster
// merge, the stores: 2.9-4.3 us at M 16 with no stages at all) hold the
// smaller matrices to 0.19 (wk/wv, 5.1 us) and 0.39-0.42 (wq, wo,
// 9.1-9.8 us) of their bounds; for wk/wv, 4 splits (32 blocks) took 7.0 us
// and non-portable clusters of 16 (128 blocks) 5.3. 128-row stages (2
// blocks per SM) took w1/w3 at M 16 to 15.8 us and at M 64 to 40.8 (21.4
// here); the code conversion costs 0.4-1.2 us a call.
//
// f32 x (f32 models, the checking route): f32 FMAs on the CUDA cores, a
// block per 32 columns and 16 rows of M, its slice of K in chunks of 512
// rows whose codes are all loaded before they are used; its splits merge
// in a cluster the same way.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "mma_common.cuh"
#include "ring_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace mma_common;
using ring_common::from_float;

constexpr int kThreads = 128;                  // 4 warps
constexpr int kMaxM = 64;                      // Q8_GEMV_MAX_ROWS in ops/q8_matmul.py
constexpr int kMaxSplits = 8;                  // splits of K: one portable cluster
constexpr int kStageRows = 64;                 // K rows per stage (bf16 route); slices are whole stages

// The block's f32 partial tile red [ROWS][LD] (columns n0 ..) is complete in
// its shared memory once every thread has passed the barrier below. One
// split: y = round_to<T>(red * s). SPLIT: the column tile's splits are one
// cluster; after a cluster barrier each block sums its share of the tile's
// outputs over the cluster's partials in rank (= split) order through
// distributed shared memory, scales, rounds and writes y; a second barrier
// keeps every partial alive until it is read. N % 16 == 0, so 4 columns are
// whole or absent.
template <typename T, bool SPLIT, int ROWS, int COLS, int LD>
__device__ __forceinline__ void store_tile(float* red, const float* __restrict__ s,
                                           T* __restrict__ y, int M, int N, int m0, int n0) {
  static_assert(COLS % 4 == 0 && LD % 4 == 0, "float4 groups");
  constexpr int kGroups = COLS / 4;
  int splits = 1, rank = 0;
  if constexpr (SPLIT) {
    cg::this_cluster().sync();
    splits = gridDim.y;                          // the cluster spans gridDim.y: rank = blockIdx.y
    rank = blockIdx.y;
  } else {
    __syncthreads();
  }
  const int items = ROWS * kGroups, per = (items + splits - 1) / splits;
  const int o_end = min(items, (rank + 1) * per);
  for (int o = rank * per + threadIdx.x; o < o_end; o += blockDim.x) {
    const int m = o / kGroups, c = 4 * (o % kGroups);
    if (m0 + m >= M || n0 + c >= N) continue;
    float4 v;
    if constexpr (SPLIT) {
      float4 u[kMaxSplits];
#pragma unroll
      for (int sp = 0; sp < kMaxSplits; ++sp)
        if (sp < splits)
          u[sp] = *reinterpret_cast<const float4*>(cg::this_cluster().map_shared_rank(red, sp) +
                                                   m * LD + c);
      v = u[0];
#pragma unroll
      for (int sp = 1; sp < kMaxSplits; ++sp)
        if (sp < splits) {
          v.x += u[sp].x;
          v.y += u[sp].y;
          v.z += u[sp].z;
          v.w += u[sp].w;
        }
    } else {
      v = *reinterpret_cast<const float4*>(red + m * LD + c);
    }
    const float4 sc = *reinterpret_cast<const float4*>(s + n0 + c);
    T* out = y + (size_t)(m0 + m) * N + n0 + c;
    out[0] = from_float<T>(v.x * sc.x);
    out[1] = from_float<T>(v.y * sc.y);
    out[2] = from_float<T>(v.z * sc.z);
    out[3] = from_float<T>(v.w * sc.w);
  }
  if constexpr (SPLIT) cg::this_cluster().sync();
}

// ---------------------------------------------------------------------------
// f32 x on the CUDA cores (the checking route).
// ---------------------------------------------------------------------------

constexpr int kF32Cols = 32;                   // columns per block: 8 lanes x 4 columns
constexpr int kF32RowStep = 16;                // rows per step: 4 warps x 4 lane groups
constexpr int kF32Chunk = 512;                 // rows whose codes a thread holds at once
constexpr int kF32Loads = kF32Chunk / kF32RowStep;
constexpr int kF32MTile = 16;                  // rows of x per block (grid.z covers M)

template <bool SPLIT>
__global__ void __launch_bounds__(kThreads)
w8a16_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ s, float* __restrict__ y, int M, int K, int N,
                 int k_slice) {
  constexpr int W = ring_common::VecWidth<float>::N;   // x elements per 16-byte load
  constexpr int kVecs = kF32MTile * kF32Chunk / W;     // 16-byte loads of x per chunk
  constexpr int kVecsPerThread = (kVecs + kThreads - 1) / kThreads;
  __shared__ __align__(16) float xs[kF32MTile][kF32Chunk];
  __shared__ __align__(16) float red[kThreads / 32][kF32MTile][kF32Cols];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cgp = lane & 7;                      // column group of 4
  const int row0 = warp * 4 + (lane >> 3);       // row within each step of 16
  const int n0 = blockIdx.x * kF32Cols;
  const int n = n0 + cgp * 4;
  const bool col_ok = n < N;                     // N % 4 == 0
  const int m0 = blockIdx.z * kF32MTile;
  const int k_begin = blockIdx.y * k_slice;
  const int k_end = min(K, k_begin + k_slice);

  float acc[kF32MTile][4];
#pragma unroll
  for (int m = 0; m < kF32MTile; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  for (int c0 = k_begin; c0 < k_end; c0 += kF32Chunk) {
    const int rows = min(kF32Chunk, k_end - c0);   // a multiple of 8
    // Every code load of the chunk first, all in flight together.
    char4 w[kF32Loads];
#pragma unroll
    for (int i = 0; i < kF32Loads; ++i) {
      const int r = row0 + i * kF32RowStep;
      w[i] = (col_ok && r < rows)
                 ? __ldg(reinterpret_cast<const char4*>(q + (size_t)(c0 + r) * N + n))
                 : make_char4(0, 0, 0, 0);
    }
    __syncthreads();                             // the last chunk's xs is read
    // Then x's rows of the chunk into shared memory as f32, in 16-byte loads
    // issued four at a time before their stores.
    for (int j0 = 0; j0 < kVecsPerThread; j0 += 4) {
      float v[4][W];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = tid + (j0 + j) * kThreads;
        const int m = e / (kF32Chunk / W), r = (e % (kF32Chunk / W)) * W;
        if (e < kVecs && m0 + m < M && r < rows) {
          ring_common::load16(x + (size_t)(m0 + m) * K + c0 + r, v[j]);
        } else {
#pragma unroll
          for (int t = 0; t < W; ++t) v[j][t] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = tid + (j0 + j) * kThreads;
        if (e >= kVecs) continue;
        const int m = e / (kF32Chunk / W), r = (e % (kF32Chunk / W)) * W;
#pragma unroll
        for (int t = 0; t < W; t += 4)
          *reinterpret_cast<float4*>(&xs[m][r + t]) =
              make_float4(v[j][t], v[j][t + 1], v[j][t + 2], v[j][t + 3]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kF32Loads; ++i) {
      const int r = row0 + i * kF32RowStep;      // rows past `rows`: w and xs are 0
      const float w0 = w[i].x, w1 = w[i].y, w2 = w[i].z, w3 = w[i].w;
#pragma unroll
      for (int m = 0; m < kF32MTile; ++m) {
        const float xv = xs[m][r];
        acc[m][0] = fmaf(xv, w0, acc[m][0]);
        acc[m][1] = fmaf(xv, w1, acc[m][1]);
        acc[m][2] = fmaf(xv, w2, acc[m][2]);
        acc[m][3] = fmaf(xv, w3, acc[m][3]);
      }
    }
  }

  // The 4 lane groups of a warp hold sums over different rows of the same
  // columns: add them (every lane ends with the same value), then the warps
  // in order, into red[0].
#pragma unroll
  for (int m = 0; m < kF32MTile; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float v = acc[m][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][c] = v;
    }
  if (lane < 8) {
#pragma unroll
    for (int m = 0; m < kF32MTile; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) red[warp][m][cgp * 4 + c] = acc[m][c];
  }
  __syncthreads();
  for (int o = tid; o < kF32MTile * kF32Cols; o += kThreads) {
    const int m = o / kF32Cols, c = o % kF32Cols;
    red[0][m][c] = ((red[0][m][c] + red[1][m][c]) + red[2][m][c]) + red[3][m][c];
  }
  store_tile<float, SPLIT, kF32MTile, kF32Cols, kF32Cols>(&red[0][0][0], s, y, M, N, m0, n0);
}

// ---------------------------------------------------------------------------
// bf16 x on the tensor cores.
// ---------------------------------------------------------------------------

constexpr int kCols = 128;                     // columns per block: 4 warps x 32
constexpr int kStages = 4;                     // stages in the ring
constexpr int kKSteps = kStageRows / 16;       // mma k-steps per stage
constexpr int kQRow = kCols;                   // bytes of a code tile row (128)
constexpr int kXRow = kStageRows * 2;          // bytes of an x tile row
constexpr int kQTile = kStageRows * kQRow;     // bytes of a code tile
constexpr int kRedRow = kCols + 4;             // f32 partial row, padded against bank conflicts
static_assert(kXRow % 128 == 0, "x tile rows of whole 128-byte lines");

// Byte offset of 16-byte chunk c of row j in the code tile: rows 2t, 2t+1,
// 2t+8, 2t+9 (t < 4) of a k-step are read together, each lane a word of one
// of 8 chunks; XOR-ing the chunk with j & 6 puts the four row pairs' chunks
// in distinct bank groups.
__device__ __forceinline__ int q_off(int j, int c) { return (j * (kQRow / 16) + (c ^ (j & 6))) * 16; }

// The same for the x tile (rows of kXRow bytes): chunk c of 8 consecutive
// rows in 8 distinct bank groups (ldmatrix reads 8 such rows at once).
__device__ __forceinline__ int x_off(int j, int c) { return (j * (kXRow / 16) + (c ^ (j & 7))) * 16; }

template <int MT>
__host__ __device__ constexpr int stage_bytes() { return kQTile + 16 * MT * kXRow; }

template <int MT>
__host__ __device__ constexpr int smem_bytes() { return kStages * stage_bytes<MT>(); }

// MT: 16-row tiles of x (M <= 16 MT). SPLIT: K is split over the blocks of a
// cluster (gridDim.y of them); otherwise one block per column tile.
template <int MT, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
w8a16_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ s, __nv_bfloat16* __restrict__ y, int M, int K,
                 int N, int k_slice) {
  static_assert(smem_bytes<MT>() >= 16 * MT * kRedRow * 4, "the f32 partial fits in the stages");
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kCols;
  const int k_begin = blockIdx.y * k_slice;
  const int slice_rows = min(K, k_begin + k_slice) - k_begin;   // a multiple of 8
  const int n_stages = (slice_rows + kStageRows - 1) / kStageRows;

  // A thread's code chunks: column chunk qc of rows qj + 16 e (e < 4) of
  // each stage; its x chunks: k chunk xc of rows xm + 16 e (e < MT). Both
  // swizzles keep their XOR over passes of 16 rows, so each pass is a fixed
  // shared offset.
  constexpr int kQChunks = kQRow / 16;
  constexpr int kQPassRows = kThreads / kQChunks;
  constexpr int kQPasses = kStageRows / kQPassRows;
  constexpr int kXChunks = kXRow / 16;
  constexpr int kXPassRows = kThreads / kXChunks;
  static_assert(kQPassRows % 8 == 0 && kXPassRows % 8 == 0 && kStageRows % kQPassRows == 0 &&
                16 % kXPassRows == 0, "passes keep the swizzles and tile the stage");
  const int qj = tid / kQChunks, qc = tid % kQChunks;
  const int xm = tid / kXChunks, xc = tid % kXChunks;
  const bool q_col_ok = n0 + 16 * qc < N;             // N % 16 == 0: chunks whole or absent
  const int8_t* q_src = q + (size_t)(k_begin + qj) * N + n0 + 16 * qc;
  const __nv_bfloat16* x_src = x + (size_t)xm * K + k_begin + 8 * xc;
  const size_t q_pass = (size_t)kQPassRows * N, q_stage = (size_t)kStageRows * N;
  const uint32_t s_base = smem_addr(smem);
  const uint32_t q_dst = s_base + q_off(qj, qc);
  const uint32_t x_dst = s_base + kQTile + x_off(xm, xc);

  // Start stage i (rows k_begin + kStageRows i ..) into ring slot i %
  // kStages; rows past the slice, columns past N and x rows past M are
  // zero-filled.
  auto issue = [&](int i) {
    const int r0 = i * kStageRows;                     // rows into the slice
    const uint32_t slot = (i % kStages) * stage_bytes<MT>();
    const int8_t* src = q_src + i * q_stage;
#pragma unroll
    for (int e = 0; e < kQPasses; ++e) {
      const bool ok = q_col_ok && r0 + qj + kQPassRows * e < slice_rows;
      cp_async16(q_dst + slot + e * kQPassRows * kQRow, ok ? src + e * q_pass : q, ok ? 16 : 0);
    }
#pragma unroll
    for (int e = 0; e < 16 * MT / kXPassRows; ++e) {
      const bool ok = xm + kXPassRows * e < M && r0 + 8 * xc < slice_rows;
      cp_async16(x_dst + slot + e * kXPassRows * kXRow,
                 ok ? x_src + (size_t)kXPassRows * e * K + r0 : x, ok ? 16 : 0);
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  // This lane's shared addresses within a stage, at k-step 0 (the next
  // k-steps 16 rows on: the same XOR). Codes: the word of columns
  // 32 warp + 4 g .. + 3 in rows 2t, 2t+1, 2t+8, 2t+9. x: ldmatrix rows
  // (matrices (rows 0-7 | 8-15) x (chunk | + 1)) at each k-step for x rows
  // 0-15 (the next m-tiles 16 rows on).
  const int g = lane >> 2, t = lane & 3;
  int b_off[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = 2 * t + (r & 1) + 8 * (r >> 1);
    b_off[r] = q_off(j, 2 * warp + (g >> 2)) + 4 * (g & 3);
  }
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lchunk = lane >> 4;
  uint32_t a_off[kKSteps];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) a_off[kk] = kQTile + x_off(lrow, 2 * kk + lchunk);

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_stages) issue(st);
    cp_async_commit();
  }
  for (int i = 0; i < n_stages; ++i) {
    cp_async_wait<kStages - 2>();                  // stage i landed (this thread's copies) ...
    __syncthreads();                             // ... and every thread's; slot i - 1 is free
    if (i + kStages - 1 < n_stages) issue(i + kStages - 1);
    cp_async_commit();
    const int slot = (i % kStages) * stage_bytes<MT>();
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      // rows 2t, 2t+1 (b0) and 2t+8, 2t+9 (b1): interleave each pair's bytes,
      // then convert: lo -> n-tiles 0, 1; hi -> n-tiles 2, 3
      uint32_t w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        w[r] = *reinterpret_cast<const uint32_t*>(smem + slot + b_off[r] + kk * 16 * kQRow);
      const uint2 b0_lo = int8x4_to_bf16_pairs<0, 1, 2, 3>(__byte_perm(w[0], w[1], 0x5140));
      const uint2 b0_hi = int8x4_to_bf16_pairs<0, 1, 2, 3>(__byte_perm(w[0], w[1], 0x7362));
      const uint2 b1_lo = int8x4_to_bf16_pairs<0, 1, 2, 3>(__byte_perm(w[2], w[3], 0x5140));
      const uint2 b1_hi = int8x4_to_bf16_pairs<0, 1, 2, 3>(__byte_perm(w[2], w[3], 0x7362));
      const uint32_t b0[4] = {b0_lo.x, b0_lo.y, b0_hi.x, b0_hi.y};
      const uint32_t b1[4] = {b1_lo.x, b1_lo.y, b1_hi.x, b1_hi.y};
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, s_base + slot + a_off[kk] + mt * 16 * kXRow);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[mt][j], a, b0[j], b1[j]);
      }
    }
  }
  cp_async_wait<0>();

  // acc[mt][j]: rows 16 mt + g (+ 8) and fragment columns 2t, 2t + 1, i.e.
  // the physical columns 32 warp + 8t + j and 32 warp + 8t + 4 + j: a lane
  // holds 8 neighbouring columns of each of its rows. Into the f32 partial
  // tile, then scaled, rounded and written (merged over the splits first).
  __syncthreads();                               // every warp is done with the stages
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* row = red + (16 * mt + g + 8 * h) * kRedRow + 32 * warp + 8 * t;
      *reinterpret_cast<float4*>(row) =
          make_float4(acc[mt][0][2 * h], acc[mt][1][2 * h], acc[mt][2][2 * h], acc[mt][3][2 * h]);
      *reinterpret_cast<float4*>(row + 4) = make_float4(
          acc[mt][0][2 * h + 1], acc[mt][1][2 * h + 1], acc[mt][2][2 * h + 1], acc[mt][3][2 * h + 1]);
    }
  store_tile<__nv_bfloat16, SPLIT, 16 * MT, kCols, kRedRow>(red, s, y, M, N, 0, n0);
}

// The dynamic shared memory limit of the bf16 kernels, raised once per device.
template <int MT, bool SPLIT>
cudaError_t prepare() {
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && raised[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(w8a16_mma_kernel<MT, SPLIT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<MT>());
  if (err == cudaSuccess && dev < 64) raised[dev] = true;
  return err;
}

// A launch configuration: a column tile's splits are one cluster.
cudaLaunchConfig_t config(cudaLaunchAttribute* attr, dim3 grid, int threads, int smem,
                          bool split, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 0;
  if (split) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = grid.y;
    attr[0].val.clusterDim.z = 1;
    cfg.numAttrs = 1;
  }
  return cfg;
}

template <int MT, bool SPLIT>
int launch_mma(const void* x, const void* q, const void* s, void* y, int M, int K, int N,
               int k_slice, int splits, cudaStream_t st) {
  const cudaError_t err = prepare<MT, SPLIT>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config(attr, dim3((N + kCols - 1) / kCols, splits), kThreads, smem_bytes<MT>(), SPLIT, st);
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, w8a16_mma_kernel<MT, SPLIT>, static_cast<const __nv_bfloat16*>(x),
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<__nv_bfloat16*>(y), M, K, N, k_slice));
}

template <int MT>
int launch_mma(const void* x, const void* q, const void* s, void* y, int M, int K, int N,
               int k_slice, int splits, cudaStream_t st) {
  return splits == 1 ? launch_mma<MT, false>(x, q, s, y, M, K, N, k_slice, splits, st)
                     : launch_mma<MT, true>(x, q, s, y, M, K, N, k_slice, splits, st);
}

template <bool SPLIT>
int launch_f32(const void* x, const void* q, const void* s, void* y, int M, int K, int N,
               int k_slice, int splits, cudaStream_t st) {
  cudaLaunchAttribute attr[1];
  const dim3 grid((N + kF32Cols - 1) / kF32Cols, splits, (M + kF32MTile - 1) / kF32MTile);
  const cudaLaunchConfig_t cfg = config(attr, grid, kThreads, 0, SPLIT, st);
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, w8a16_f32_kernel<SPLIT>, static_cast<const float*>(x),
      static_cast<const int8_t*>(q), static_cast<const float*>(s), static_cast<float*>(y), M,
      K, N, k_slice));
}

// Blocks of the bf16 kernel resident at once when a column tile's splits
// form clusters of `splits` blocks: whole clusters (the runtime's count)
// times their size.
template <int MT>
int resident(int splits, int* blocks) {
  cudaError_t err = splits == 1 ? prepare<MT, false>() : prepare<MT, true>();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits == 1) {
    int dev = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, w8a16_mma_kernel<MT, false>, kThreads, smem_bytes<MT>());
    *blocks = per_sm * sms;
    return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config(attr, dim3(1, splits), kThreads, smem_bytes<MT>(), true, nullptr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, w8a16_mma_kernel<MT, true>, &cfg);
  *blocks = clusters * splits;
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and y). Device pointers: x [M, K],
// q int8 [K, N], s f32 [N], y [M, N], x, q and s 16-byte aligned. Split s
// covers rows [s * k_slice, (s + 1) * k_slice) of K; k_slice a multiple of
// 128 (a stage), every split non-empty, 1 <= splits <= 8 (one cluster per
// column tile). 1 <= M <= 64, K % 8 == 0, N % 16 == 0. Returns the CUDA
// error code of the launch (0 = launched).
int w8a16_gemv_launch(int dtype, const void* x, const void* q, const void* s, void* y, int M,
                      int K, int N, int k_slice, int splits, void* stream) {
  if (M < 1 || M > kMaxM || K < 8 || K % 8 || N < 16 || N % 16 || k_slice < kStageRows ||
      k_slice % kStageRows || splits < 1 || splits > kMaxSplits ||
      (long long)k_slice * splits < K || (long long)k_slice * (splits - 1) >= K ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(s) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return splits == 1 ? launch_f32<false>(x, q, s, y, M, K, N, k_slice, splits, st)
                       : launch_f32<true>(x, q, s, y, M, K, N, k_slice, splits, st);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch ((M + 15) / 16) {
    case 1: return launch_mma<1>(x, q, s, y, M, K, N, k_slice, splits, st);
    case 2: return launch_mma<2>(x, q, s, y, M, K, N, k_slice, splits, st);
    case 3: return launch_mma<3>(x, q, s, y, M, K, N, k_slice, splits, st);
    default: return launch_mma<4>(x, q, s, y, M, K, N, k_slice, splits, st);
  }
}

// blocks: the bf16 kernel's blocks for M rows (1..64) resident at once on
// the current device when a column tile's splits (1..8) form one cluster.
// Returns the CUDA error code (0 = ok).
int w8a16_resident_blocks(int M, int splits, int* blocks) {
  if (M < 1 || M > kMaxM || splits < 1 || splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  switch ((M + 15) / 16) {
    case 1: return resident<1>(splits, blocks);
    case 2: return resident<2>(splits, blocks);
    case 3: return resident<3>(splits, blocks);
    default: return resident<4>(splits, blocks);
  }
}

}  // extern "C"
