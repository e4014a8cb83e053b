// Read ceilings for Hopper (sm_90a): T1 `wread`, T11 `rd` and T2
// `pure_stream`, kernels that read a weight stack or a KV ring once and
// reduce it to almost nothing. Their time is the time this card takes to
// read those bytes in that access pattern: the yardstick for the kernels
// that read the same data and compute on it (K2, K3, K1-int8, cuBLAS).
//
// Replaces three Pallas kernels:
//   * T1 `wread`, tools/profile_q8_matmul_roofline.py:85 (pallas_call :87):
//     int8 w [K, N] -> f32 column sums [1, N];
//   * T11 `rd`, tools/profile_dma_ceiling.py:28 (pallas_call :33): int8 k, v
//     rings [B, P, C] and an f32 salt -> f32 [B, 1, C] =
//     (sum_p k + sum_p v) + salt;
//   * T2 `pure_stream`, tools/profile_weight_stream.py:73 (pallas_call :77):
//     bf16 w [K, N] read whole in [bk, bn] blocks -> f32 [8, 128] = sum over
//     the blocks (N-outer, K-inner) of each block's top-left [8, 128] tile.
//
// Bound: bytes, all three. Each reads its input once (1 byte per int8
// element, 2 per bf16) and does an add or two per byte, far below the
// card's integer or float rate.
//
// Design:
//   * every load is 16 bytes wide (`ld.global.nc.L1::no_allocate.v4`: read
//     only, not kept in L1, so the bytes stream through), neighbouring
//     threads on neighbouring addresses, 8 loads of each thread in flight
//     before their values are used;
//   * column sums (T1, T11): a block owns 512 columns (32 lanes x 16) of one
//     matrix and a slice of its rows; each warp takes every 8th row. Sums are
//     int32 (each partial sum of int8 codes is an integer below 2^24, checked
//     by the wrapper), so the f32 result is exact and any split of the rows
//     gives the same bits. Splits meet in an int32 scratch row by integer
//     atomics; the last block of a column tile to arrive (counter +
//     __threadfence) reads and zeroes it, converts once, adds the salt and
//     resets the counter: one launch, the same bits on every run;
//   * T2 streams the whole tensor as 16-byte words (grid-stride) and folds
//     every loaded word into a 32-bit wrapping sum, stored per block: a
//     load whose value went nowhere could be dropped by the compiler, and
//     the stored sum lets a caller check that every byte was read. The
//     [8, 128] result needs none of that: 4 more blocks of the same launch
//     (the first 4, so they start at once) compute it while the others
//     stream, one thread per output, adding the blocks' tiles in the JAX
//     grid's order (N-outer, K-inner, from 0) with 16 loads in flight. It
//     equals the Pallas kernel's bit for bit where K and N are multiples of
//     the blocks; a ragged last block adds its tile too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                 // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 16;                      // bytes per load
constexpr int kTileCols = 32 * kVec;          // int8 columns per block: 512
constexpr int kUnroll = 8;                    // loads in flight per thread
constexpr int kRowsPerIter = kWarps * kUnroll;  // 64: a multiple of the slice
constexpr int kTileBlocks = 8 * 128 / kThreads;  // T2: blocks of the [8, 128] result
constexpr int kTerms = 16;                    // T2: tile loads in flight per thread

__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// s[4 w + j] += signed byte j of word w
__device__ __forceinline__ void add_codes(int* s, const uint4& v) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int w = 0; w < 4; ++w)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      s[4 * w + j] += static_cast<int>(words[w] << (24 - 8 * j)) >> 24;
}

// out[b, c] = float(sum_r a[b, r, c] + sum_r a2[b, r, c]) (+ salt[0]).
// a, a2: int8 [batch, rows, cols] (a2 may be null), cols % 16 == 0, 16-byte
// aligned. Grid (column tiles, splits, batch); split s takes rows
// [s * k_slice, (s + 1) * k_slice). acc: int32 [batch * cols], counters:
// int32 [batch * column tiles], both zero and left zero.
__global__ void __launch_bounds__(kThreads)
colsum_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ a2,
              const float* __restrict__ salt, float* __restrict__ out,
              int* __restrict__ acc, int* __restrict__ counters, int rows, int cols,
              int k_slice) {
  __shared__ int red[kWarps][32][kVec + 1];    // padded: no bank conflicts
  __shared__ int is_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.z, c0 = blockIdx.x * kTileCols;
  const bool col_ok = c0 + lane * kVec < cols;
  const int r_begin = blockIdx.y * k_slice;
  const int r_end = min(rows, r_begin + k_slice);
  int s[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) s[e] = 0;
  for (int pass = 0; pass < (a2 != nullptr ? 2 : 1); ++pass) {
    const int8_t* base = (pass ? a2 : a) + (size_t)b * rows * cols + c0 + lane * kVec;
    for (int r0 = r_begin + warp; r0 < r_end; r0 += kRowsPerIter) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + u * kWarps;
        v[u] = (col_ok && r < r_end) ? ld_stream(base + (size_t)r * cols)
                                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add_codes(s, v[u]);
    }
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) red[warp][lane][e] = s[e];
  __syncthreads();
  const int splits = gridDim.y;
  const int tile = b * gridDim.x + blockIdx.x;
  const float add = salt != nullptr ? salt[0] : 0.f;
  for (int j = threadIdx.x; j < kTileCols; j += kThreads) {
    if (c0 + j >= cols) continue;
    int t = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w][j / kVec][j % kVec];
    const size_t o = (size_t)b * cols + c0 + j;
    if (splits == 1)
      out[o] = salt != nullptr ? static_cast<float>(t) + add : static_cast<float>(t);
    else
      atomicAdd(acc + o, t);
  }
  if (splits == 1) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(counters + tile, 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  for (int j = threadIdx.x; j < kTileCols; j += kThreads) {
    if (c0 + j >= cols) continue;
    const size_t o = (size_t)b * cols + c0 + j;
    const int t = atomicExch(acc + o, 0);
    out[o] = salt != nullptr ? static_cast<float>(t) + add : static_cast<float>(t);
  }
  if (threadIdx.x == 0) counters[tile] = 0;
}

// T2. w: bf16 [K, N] as n16 16-byte words (K * N % 8 == 0, 16-byte
// aligned). Blocks 0..3 compute out: f32 [8, 128]; block 4 + i streams and
// stores checksum[i], the wrapping sum of the 32-bit words it loaded.
__global__ void __launch_bounds__(kThreads)
stream_kernel(const uint4* __restrict__ w, long long n16, int K, int N, int bk, int bn,
              float* __restrict__ out, uint32_t* __restrict__ checksum) {
  if (blockIdx.x < kTileBlocks) {
    // out[r, c] = sum over blocks (bi over N, bj over K, bj inner) of
    // w[bj bk + r, bi bn + c], where the block has that element.
    const __nv_bfloat16* wb = reinterpret_cast<const __nv_bfloat16*>(w);
    const int o = blockIdx.x * kThreads + threadIdx.x, r = o / 128, c = o % 128;
    const int nb_k = (K + bk - 1) / bk, nb = nb_k * ((N + bn - 1) / bn);
    float v = 0.f;
    for (int t0 = 0; t0 < nb; t0 += kTerms) {
      float x[kTerms];
      bool ok[kTerms];
#pragma unroll
      for (int u = 0; u < kTerms; ++u) {
        const int t = t0 + u, row = (t % nb_k) * bk + r, col = (t / nb_k) * bn + c;
        ok[u] = t < nb && r < bk && c < bn && row < K && col < N;
        x[u] = ok[u] ? __bfloat162float(wb[(size_t)row * N + col]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kTerms; ++u)
        if (ok[u]) v += x[u];
    }
    out[o] = v;
    return;
  }
  __shared__ uint32_t red[kWarps];
  const int block = blockIdx.x - kTileBlocks;
  const long long stride = (long long)(gridDim.x - kTileBlocks) * kThreads;
  long long i = (long long)block * kThreads + threadIdx.x;
  uint32_t s = 0;
  for (; i + (kUnroll - 1) * stride < n16; i += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = ld_stream(w + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) s += (v[u].x + v[u].y) + (v[u].z + v[u].w);
  }
  for (; i < n16; i += stride) {
    const uint4 v = ld_stream(w + i);
    s += (v.x + v.y) + (v.z + v.w);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t t = 0;
    for (int k = 0; k < kWarps; ++k) t += red[k];
    checksum[block] = t;
  }
}

}  // namespace

extern "C" {

// T1 and T11. a, a2 (a2 may be null): int8 [batch, rows, cols] device
// pointers, 16-byte aligned, cols % 16 == 0; salt: one f32 or null; out:
// f32 [batch, cols]; acc: int32 [batch * cols] and counters: int32
// [batch * ceil(cols / 512)], both zero (left zero; one stream at a time).
// k_slice: a multiple of 64, every split non-empty. Returns the CUDA error
// code of the launch (0 = launched).
int colsum_int8_launch(const void* a, const void* a2, const void* salt, void* out, void* acc,
                       void* counters, int batch, int rows, int cols, int k_slice,
                       int splits, void* stream) {
  if (batch < 1 || batch > 65535 || rows < 1 || cols < 16 || cols % 16 || k_slice < 1 ||
      k_slice % kRowsPerIter || splits < 1 || splits > 65535 ||
      (long long)k_slice * splits < rows || (long long)k_slice * (splits - 1) >= rows ||
      reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(a2) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((cols + kTileCols - 1) / kTileCols, splits, batch);
  colsum_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(a2),
      static_cast<const float*>(salt), static_cast<float*>(out), static_cast<int*>(acc),
      static_cast<int*>(counters), rows, cols, k_slice);
  return static_cast<int>(cudaGetLastError());
}

// T2. w: bf16 [K, N] device pointer, 16-byte aligned, K * N % 8 == 0; bk,
// bn: the block shape (each >= 1); out: f32 [8, 128]; checksum: uint32
// [blocks], one per streaming block.
int pure_stream_launch(const void* w, int K, int N, int bk, int bn, void* out,
                       void* checksum, int blocks, void* stream) {
  const long long n = (long long)K * N;
  if (K < 1 || N < 1 || n % 8 || bk < 1 || bn < 1 || blocks < 1 || blocks > (1 << 20) ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  stream_kernel<<<blocks + kTileBlocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(w), n / 8, K, N, bk, bn, static_cast<float*>(out),
      static_cast<uint32_t*>(checksum));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
