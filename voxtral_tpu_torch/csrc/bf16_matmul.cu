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
// differs from a plain f32 product). 1 <= B <= 64, K % 8 == 0, N % 8 == 0,
// x and w 16-byte aligned (every weight row is then whole 16-byte chunks).
//
// Bound: bytes at decode's B (24 in the tool): each call must read K * N * 2
// weight bytes once; 2 B K N operations at 989 TFLOP/s are ~30x less time.
// So the design is a memory pipeline that keeps enough weight bytes in
// flight, in whole 128-byte lines, with the products out of its way:
//   * a block owns 128 columns (256 contiguous bytes of every weight row:
//     two whole lines) and a slice of K, taken in stages of 64 rows;
//   * each stage (the 16 KB weight tile and the x rows of the same 64 k)
//     comes in by 16-byte cp.async.cg into a ring of 4 shared-memory
//     stages, so three stages are in flight while one is multiplied, and
//     the block waits for memory once per stage, behind one __syncthreads;
//     rows past K, columns past N and x rows past B are zero-filled without
//     a global read;
//   * tensor cores: mma.sync m16n8k16 (bf16 operands, f32 accumulator), all
//     of B's 16-row tiles in one block (compiled for 1 to 4 tiles, so a
//     small B holds fewer accumulators), so every weight byte is read once
//     whatever B. Warp w owns the block's columns 32 w .. 32 w + 31 (4
//     n-tiles) over every k of the stage: its B fragments come from the
//     weight tile by ldmatrix.x4.trans (two per 16 rows), its A fragments
//     from the x tile by ldmatrix.x4; both tiles are XOR-swizzled by row,
//     so ldmatrix meets no bank conflict;
//   * at 2 blocks (8 warps) per SM the instructions per stage set the read
//     rate as much as the bytes in flight do: every copy and ldmatrix
//     address that does not change from stage to stage is computed once
//     (on NVIDIA H100 80GB HBM3, 700 W, this took w13 from 47.3 to 40.7 us);
//   * split K fills the card where N has few column tiles, at most one wave
//     of resident blocks (the wrapper's plan, ops/bf16_matmul.t3_plan, asks
//     the runtime how many fit): one launch and no float atomics. The
//     splits of a column tile (at most 8) are one thread-block cluster, so
//     they are resident together: each block leaves its f32 partial in its
//     own shared memory, and after a cluster barrier each block sums a
//     contiguous share of the tile's outputs over the cluster's partials in
//     split order, through distributed shared memory, and writes y. The
//     bits do not depend on the order the blocks ran in, and no partial
//     goes through device memory. One split per tile runs a kernel without
//     the cluster code.
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6, T3 row): 0.85 of the
// byte bound at w13 [3072, 18432], B 24 (40.7 us, torch.mm 41.4), and
// 0.44-0.69 at the tools' four smaller tensors, where a launch's fixed
// costs (the first stage's latency, the cluster's merge) weigh more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "mma_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace mma_common;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 32 * kWarps;             // columns per block: 4 n-tiles per warp
constexpr int kStageRows = 64;                 // K rows per stage
constexpr int kStages = 4;                     // stages in the ring
constexpr int kMaxM = 64;                      // BF16_MATMUL_MAX_ROWS in ops/bf16_matmul.py
constexpr int kMaxSplits = 8;                  // splits of K: one portable cluster
constexpr int kWRow = kCols * 2;               // bytes of a weight tile row (256)
constexpr int kXRow = kStageRows * 2;          // bytes of an x tile row (128)
constexpr int kWTile = kStageRows * kWRow;     // 16 KB
constexpr int kRedRow = kCols + 4;             // f32 partial row, padded against bank conflicts

// Byte offset of 16-byte chunk c of row j in a tile of RB-byte rows, XOR-
// swizzled so that chunk c of 8 consecutive rows lies in 8 distinct bank
// groups (ldmatrix, plain or transposed, reads 8 such rows at once).
template <int RB>
__device__ __forceinline__ int chunk_off(int j, int c) {
  static_assert(RB % 128 == 0, "rows of whole 128-byte lines");
  return (j * (RB / 16) + (c ^ (j & 7))) * 16;
}

template <int MT>
__host__ __device__ constexpr int stage_bytes() { return kWTile + 16 * MT * kXRow; }

template <int MT>
__host__ __device__ constexpr int smem_bytes() { return kStages * stage_bytes<MT>(); }

// MT: 16-row tiles of x (M <= 16 MT). SPLIT: K is split over the blocks of a
// cluster (gridDim.y of them); otherwise one block per column tile.
template <int MT, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
bf16_matmul_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                   float* __restrict__ y, int M, int K, int N, int k_slice) {
  static_assert(smem_bytes<MT>() >= 16 * MT * kRedRow * 4, "the f32 partial fits in the stages");
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kCols;
  const int k_begin = blockIdx.y * k_slice;
  const int k_end = min(K, k_begin + k_slice);   // a multiple of 8
  const int n_stages = (k_end - k_begin + kStageRows - 1) / kStageRows;

  // The block runs at a few warps per SM, so the instructions around the
  // copies and products count: every address that does not change from
  // stage to stage is computed once. A thread's weight chunks: column chunk
  // wc of rows wj + 8 e (e < kWPasses) of each stage; its x chunks: k chunk
  // xc of rows xm + 16 e (e < MT). A swizzled row keeps its XOR (j & 7)
  // over passes of 8 or 16 rows, so each pass is a fixed shared offset.
  constexpr int kChunks = kCols / 8;                    // 16-byte chunks of a weight row
  constexpr int kWPasses = kStageRows * kChunks / kThreads;
  constexpr int kWPassRows = kThreads / kChunks;
  constexpr int kXPassRows = kThreads / (kStageRows / 8);
  static_assert(kWPassRows % 8 == 0 && kXPassRows % 8 == 0 && 16 % kXPassRows == 0,
                "passes keep the swizzle");
  const int wj = tid / kChunks, wc = tid % kChunks;
  const int xm = tid / (kStageRows / 8), xc = tid % (kStageRows / 8);
  const bool w_col_ok = n0 + 8 * wc < N;
  const __nv_bfloat16* w_src = w + (size_t)(k_begin + wj) * N + n0 + 8 * wc;
  const __nv_bfloat16* x_src = x + (size_t)xm * K + k_begin + 8 * xc;
  const size_t w_pass = (size_t)kWPassRows * N, w_stage = (size_t)kStageRows * N;
  const uint32_t s_base = smem_addr(smem);
  const uint32_t w_dst = s_base + chunk_off<kWRow>(wj, wc);
  const uint32_t x_dst = s_base + kWTile + chunk_off<kXRow>(xm, xc);
  const int slice_rows = k_end - k_begin;

  // Start stage i (rows k_begin + 64 i ..) into ring slot i % kStages; rows
  // past the slice, columns past N and x rows past M are zero-filled.
  auto issue = [&](int i) {
    const int r0 = i * kStageRows;                     // rows into the slice
    const uint32_t slot = (i % kStages) * stage_bytes<MT>();
    const __nv_bfloat16* src = w_src + i * w_stage;
#pragma unroll
    for (int e = 0; e < kWPasses; ++e) {
      const bool ok = w_col_ok && r0 + wj + kWPassRows * e < slice_rows;
      cp_async16(w_dst + slot + e * kWPassRows * kWRow, ok ? src + e * w_pass : w, ok ? 16 : 0);
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

  // ldmatrix addresses of this lane (matrices (rows 0-7 | 8-15) x (chunk |
  // + 1)), within a stage: B for n-tiles 2p, 2p + 1 of this warp (chunks
  // 4 warp + 2p, + 1) at k-step 0 (the next k-steps 16 rows on: the same
  // XOR); A at each k-step for x rows 0-15 (the next m-tiles 16 rows on).
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lchunk = lane >> 4;
  uint32_t b_off[2], a_off[kStageRows / 16];
#pragma unroll
  for (int p = 0; p < 2; ++p) b_off[p] = chunk_off<kWRow>(lrow, 4 * warp + 2 * p + lchunk);
#pragma unroll
  for (int kk = 0; kk < kStageRows / 16; ++kk)
    a_off[kk] = kWTile + chunk_off<kXRow>(lrow, 2 * kk + lchunk);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) issue(s);
    cp_async_commit();
  }
  for (int i = 0; i < n_stages; ++i) {
    cp_async_wait<kStages - 2>();                  // stage i landed (this thread's copies) ...
    __syncthreads();                             // ... and every thread's; slot i - 1 is free
    if (i + kStages - 1 < n_stages) issue(i + kStages - 1);
    cp_async_commit();
    const uint32_t st = s_base + (i % kStages) * stage_bytes<MT>();
#pragma unroll
    for (int kk = 0; kk < kStageRows / 16; ++kk) {
      uint32_t b[2][4];
#pragma unroll
      for (int p = 0; p < 2; ++p) ldmatrix_x4_trans(b[p], st + b_off[p] + kk * 16 * kWRow);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, st + a_off[kk] + mt * 16 * kXRow);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[mt][j], a, b[j >> 1][2 * (j & 1)], b[j >> 1][2 * (j & 1) + 1]);
      }
    }
  }
  cp_async_wait<0>();

  // acc[mt][j]: rows 16 mt + g (+ 8), columns 32 warp + 8 j + 2t, + 1
  const int g = lane >> 2, t = lane & 3;
  if constexpr (!SPLIT) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = 16 * mt + g + 8 * h, col = n0 + 32 * warp + 8 * j + 2 * t;
          if (m < M && col < N)
            *reinterpret_cast<float2*>(y + (size_t)m * N + col) =
                make_float2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
        }
  } else {
    // The splits of a column tile are one cluster: each block leaves its f32
    // partial [16 MT][kRedRow] in its own shared memory, then block r sums a
    // contiguous share of the tile's outputs over the cluster's partials in
    // rank (= split) order through distributed shared memory.
    __syncthreads();                             // every warp is done with the stages
    float* red = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(red + (16 * mt + g + 8 * h) * kRedRow + 32 * warp +
                                     8 * j + 2 * t) =
              make_float2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();                              // every split's partial is in place
    const int splits = gridDim.y, rank = cluster.block_rank();
    const int items = M * (kCols / 4), per = (items + splits - 1) / splits;
    const int o_end = min(items, (rank + 1) * per);
    for (int o = rank * per + tid; o < o_end; o += kThreads) {
      const int m = o / (kCols / 4), c = 4 * (o % (kCols / 4));
      if (n0 + c >= N) continue;                 // N % 8 == 0: 4 columns whole or absent
      float4 u[kMaxSplits];
#pragma unroll
      for (int sp = 0; sp < kMaxSplits; ++sp)
        if (sp < splits)
          u[sp] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, sp) +
                                                   m * kRedRow + c);
      float4 v = u[0];
#pragma unroll
      for (int sp = 1; sp < kMaxSplits; ++sp)
        if (sp < splits) {
          v.x += u[sp].x;
          v.y += u[sp].y;
          v.z += u[sp].z;
          v.w += u[sp].w;
        }
      *reinterpret_cast<float4*>(y + (size_t)m * N + n0 + c) = v;
    }
    cluster.sync();                              // no block leaves while its partial is read
  }
}

// The kernel's dynamic shared memory limit, raised once per device.
template <int MT, bool SPLIT>
cudaError_t prepare() {
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && raised[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(bf16_matmul_kernel<MT, SPLIT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<MT>());
  if (err == cudaSuccess && dev < 64) raised[dev] = true;
  return err;
}

// A launch configuration: a column tile's splits are one cluster.
template <int MT, bool SPLIT>
cudaLaunchConfig_t config(cudaLaunchAttribute* attr, int tiles, int splits, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes<MT>();
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 0;
  if (SPLIT) {
    attr[cfg.numAttrs].id = cudaLaunchAttributeClusterDimension;
    attr[cfg.numAttrs].val.clusterDim.x = 1;
    attr[cfg.numAttrs].val.clusterDim.y = splits;
    attr[cfg.numAttrs].val.clusterDim.z = 1;
    ++cfg.numAttrs;
  }
  return cfg;
}

template <int MT, bool SPLIT>
int launch_as(const void* x, const void* w, void* y, int M, int K, int N, int k_slice,
              int splits, cudaStream_t st) {
  const cudaError_t err = prepare<MT, SPLIT>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<MT, SPLIT>(attr, (N + kCols - 1) / kCols, splits, st);
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, bf16_matmul_kernel<MT, SPLIT>, static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<float*>(y), M, K, N, k_slice));
}

template <int MT>
int launch(const void* x, const void* w, void* y, int M, int K, int N, int k_slice, int splits,
           cudaStream_t st) {
  return splits == 1 ? launch_as<MT, false>(x, w, y, M, K, N, k_slice, splits, st)
                     : launch_as<MT, true>(x, w, y, M, K, N, k_slice, splits, st);
}

// Blocks resident at once when a column tile's splits form clusters of
// `splits` blocks: whole clusters (the runtime's count) times their size.
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
          &per_sm, bf16_matmul_kernel<MT, false>, kThreads, smem_bytes<MT>());
    *blocks = per_sm * sms;
    return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<MT, true>(attr, 1, splits, nullptr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, bf16_matmul_kernel<MT, true>, &cfg);
  *blocks = clusters * splits;
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Device pointers: x bf16 [M, K], w bf16 [K, N], both 16-byte aligned; y f32
// [M, N]. Split s covers rows [s * k_slice, (s + 1) * k_slice) of K; k_slice
// a multiple of 64 (a stage), every split non-empty, 1 <= splits <= 8 (one
// cluster per column tile). 1 <= M <= 64, K % 8 == 0, N % 8 == 0. Returns
// the CUDA error code of the launch (0 = launched).
int bf16_matmul_launch(const void* x, const void* w, void* y, int M, int K, int N, int k_slice,
                       int splits, void* stream) {
  if (M < 1 || M > kMaxM || K < 8 || K % 8 || N < 8 || N % 8 || k_slice < kStageRows ||
      k_slice % kStageRows || splits < 1 || splits > kMaxSplits ||
      (long long)k_slice * splits < K || (long long)k_slice * (splits - 1) >= K ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((M + 15) / 16) {
    case 1: return launch<1>(x, w, y, M, K, N, k_slice, splits, st);
    case 2: return launch<2>(x, w, y, M, K, N, k_slice, splits, st);
    case 3: return launch<3>(x, w, y, M, K, N, k_slice, splits, st);
    default: return launch<4>(x, w, y, M, K, N, k_slice, splits, st);
  }
}

// blocks: the blocks of the kernel for M rows (1..64) resident at once on
// the current device when a column tile's splits (1..8) form one cluster.
// Returns the CUDA error code (0 = ok).
int bf16_matmul_resident_blocks(int M, int splits, int* blocks) {
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
