// Ring-buffer attention for Hopper (sm_90a), encoder regime (K1-enc): S
// queries per stream against a ring that is float, int8 with scales, or
// int4-packed with scales, plus the chunk's own float K/V as extra columns.
//
// Replaces voxtral_tpu/ops/pallas_attention.py::ring_gqa_attention (the
// Pallas kernel, pallas_call at :314, body _kernel :113 -> _attend_block
// :45) in its encoder regime: S > 1 queries per stream (the encoder chunk),
// per-head path (:191-198), float rings, int8 rings with per-(slot, head)
// f32 scales [B, Hkv, P], or nibble-packed int4 rings (:147-163; halves
// packing of voxtral_tpu/quant.py:quantize_kv_int4: byte c of a head holds
// lane c in its low nibble and lane c + hd/2 in its high nibble, both
// signed). The wrapper also sends here any call with packed rings.
//
// What it computes, per stream b, query head hq (kv head h = hq / group)
// and query row i: s_j = (q_i . k_j) / sqrt(hd) [* ks_j] over ring slots
// j < nv and the Sx extra columns, masked by 0 <= pos_j <= q_pos_i and
// pos_j >= q_pos_i - (window-1); one softmax over both; the denominator sums
// the unscaled e_j; out_i = sum_j round(e_j [* vs_j]) v_j / denominator,
// with the probability column rounded to q's dtype as the TPU kernel feeds
// its matrix unit (q and k are operands of q's dtype, summed in f32: the
// TPU kernel's mxu_dt, :55). The extra columns carry no scales. Fully-masked
// rows (padding rows, inactive streams) return 0: the max is floored at
// -5e29 and the denominator at 1e-30. Slots at or past nv are never read.
//
// Bound: bytes and operations are of one order. At the fleet's B = 16 (Hq
// 32, hd 64, S 80, a full 928-slot int4 ring, 80 extra columns, window 750)
// the ring slots and extra columns that some query row can see come to
// ~48 MB of codes, scales, q and out (14.3 us at 3.35 TB/s), and the
// products of the (row, column) pairs inside the mask to ~8 GFLOP (8 us at
// the 989 TFLOP/s dense bf16 rate): chip_smoke.py's _ring_bound counts both
// from a case's own inputs.
//
// Two routes, chosen by q's dtype (a dispatch, not a fallback):
//
// bf16 (the serving dtype): tensor cores, FlashAttention-2 shaped.
//   * one block per (kv head, stream, split) holds every query row of that
//     head's query heads, one warp per 16 rows, at most 5 warps a pass (the
//     fleet's S = 80 in one pass; more rows take further passes over the
//     tiles), so each ring tile is read and unpacked once per (stream, kv
//     head); at most 102 registers a thread and ~36 KB of shared memory,
//     so four 5-warp blocks share an SM and the fleet's 512 blocks (B 16 x
//     32 heads) run in one wave;
//   * q fragments stay in registers for the whole loop; tiles of 32 ring
//     slots, then of 32 extra columns, arrive by cp.async as read (int8 /
//     int4 codes or bf16 rows), two tiles in flight while one is attended;
//     each thread converts the chunks it copied itself into bf16 rows
//     (16-byte chunks XOR-swizzled by row, so ldmatrix meets no bank
//     conflict) and its columns' positions and scale factors, so a tile
//     costs one barrier. Codes convert exactly by byte permutes and one
//     subtraction, no int-to-float converts: int4 lane c from the low
//     nibbles and lane c + 32 from the high ones, so q lanes [0, 32) meet
//     the low codes and [32, 64) the high ones (the two half-width
//     products) and P V writes the two output halves, with no lane shuffle;
//   * S = Q K^T on mma.sync m16n8k16 (bf16 -> f32, K through ldmatrix); the
//     mask, 1/sqrt(hd) and ks_j act on the f32 C fragment; an online softmax
//     in f32 (base 2, ex2.approx) per row, the row max reduced over the 4
//     threads of a quad; p = round_bf16(e * vs_j) is packed straight into
//     the A fragment of P V (V through ldmatrix.trans), O accumulates in
//     f32 and is rescaled per tile; the denominator sums the unscaled e;
//   * before the loop the block reads its slots' positions and lists the
//     tiles that some query row of the stream can see; only those are read;
//   * small grids (B * Hkv under half the SMs: B = 1 and 2 at 32 heads)
//     split the tiles over several blocks, each writing f32 partials (o, m,
//     l) that a second small kernel merges, as K1 does; the wrapper picks
//     the split (ops/ring_attention.enc_plan).
// Why 32-slot tiles and 5 warps: the route is latency-bound (each warp's
// tile is a chain of ldmatrix, mma, shuffle and ex2 steps), so warps per SM
// matter most; 64-slot tiles need ~128 registers and 69 KB, three blocks
// per SM and two waves for the fleet's 512 blocks (PERF.md §6).
//
// f32 (parity mode): CUDA cores, so the f32 result stays f32 throughout
// (the tensor cores would round q and k to bf16 or TF32):
//   * one block per (tile of up to 64 query rows, query head, stream);
//     hd/32 neighbouring threads own one query row, 32 of its lanes each,
//     with q and the unnormalised output in registers;
//   * a loop over ring tiles of 32 slots below nv, then over the extra
//     columns: each K/V tile is staged in shared memory as f32 (int8:
//     converted, int4: two arithmetic shifts), with its positions and
//     scales; an online softmax in f32, exact exp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "mma_common.cuh"
#include "ring_common.cuh"

namespace {

using namespace ring_common;
using namespace mma_common;

constexpr int kPosInvalid = -(1 << 30);

enum RingKind { kFloatRing = 0, kInt8Ring = 1, kInt4Ring = 2 };

// ---------------------------------------------------------------------------
// f32 route (CUDA cores)
// ---------------------------------------------------------------------------

constexpr int kRowsPerBlock = 64;   // query rows per block
constexpr int kKeyTile = 32;        // K/V rows staged per pass
constexpr int kLanes = 32;          // lanes of a head per thread
constexpr int kChunks = kLanes / 4; // 16-byte f32 chunks per thread

__device__ __forceinline__ void store4(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
}

// Lane of chunk element (i, e) owned by thread `part` of a row: 16-byte
// chunks interleaved across the row's TPR threads.
template <int TPR>
__device__ __forceinline__ int lane_of(int part, int i) { return 4 * (part + TPR * i); }

// Stage rows [t0, t0 + n) of one head into s_k/s_v ([kKeyTile][HD] f32),
// zeros past n. f32 rows (HD lanes each, `stride` elements apart).
template <int HD>
__device__ __forceinline__ void stage_float(const float* __restrict__ kb,
                                            const float* __restrict__ vb, size_t stride,
                                            int n, float* s_k, float* s_v) {
  constexpr int PER_ROW = HD / 4;
  for (int idx = threadIdx.x; idx < kKeyTile * PER_ROW; idx += blockDim.x) {
    const int j = idx / PER_ROW;
    const int c = (idx % PER_ROW) * 4;
    float kr[4] = {0.f, 0.f, 0.f, 0.f}, vr[4] = {0.f, 0.f, 0.f, 0.f};
    if (j < n) {
      load16(kb + j * stride + c, kr);
      load16(vb + j * stride + c, vr);
    }
    store4(s_k + j * HD + c, kr);
    store4(s_v + j * HD + c, vr);
  }
}

// int8 rows: 16 codes per 16-byte load, converted in registers.
template <int HD>
__device__ __forceinline__ void stage_int8(const int8_t* __restrict__ kb,
                                           const int8_t* __restrict__ vb, size_t stride,
                                           int n, float* s_k, float* s_v) {
  constexpr int PER_ROW = HD / 16;
  for (int idx = threadIdx.x; idx < kKeyTile * PER_ROW; idx += blockDim.x) {
    const int j = idx / PER_ROW;
    const int c = (idx % PER_ROW) * 16;
    int4 kw = make_int4(0, 0, 0, 0), vw = make_int4(0, 0, 0, 0);
    if (j < n) {
      kw = *reinterpret_cast<const int4*>(kb + j * stride + c);
      vw = *reinterpret_cast<const int4*>(vb + j * stride + c);
    }
    const int8_t* kc = reinterpret_cast<const int8_t*>(&kw);
    const int8_t* vc = reinterpret_cast<const int8_t*>(&vw);
    float kr[16], vr[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      kr[e] = kc[e];
      vr[e] = vc[e];
    }
#pragma unroll
    for (int e = 0; e < 16; e += 4) {
      store4(s_k + j * HD + c + e, kr + e);
      store4(s_v + j * HD + c + e, vr + e);
    }
  }
}

// int4-packed rows: HD/2 bytes per head; byte c -> lanes c (low nibble) and
// c + HD/2 (high nibble), each sign-extended by two arithmetic shifts.
template <int HD>
__device__ __forceinline__ void stage_int4(const int8_t* __restrict__ kb,
                                           const int8_t* __restrict__ vb, size_t stride,
                                           int n, float* s_k, float* s_v) {
  constexpr int PER_ROW = HD / 32;       // 16-byte loads per packed head row
  for (int idx = threadIdx.x; idx < kKeyTile * PER_ROW; idx += blockDim.x) {
    const int j = idx / PER_ROW;
    const int c = (idx % PER_ROW) * 16;
    int4 kw = make_int4(0, 0, 0, 0), vw = make_int4(0, 0, 0, 0);
    if (j < n) {
      kw = *reinterpret_cast<const int4*>(kb + j * stride + c);
      vw = *reinterpret_cast<const int4*>(vb + j * stride + c);
    }
    const int8_t* kc = reinterpret_cast<const int8_t*>(&kw);
    const int8_t* vc = reinterpret_cast<const int8_t*>(&vw);
    float k_lo[16], k_hi[16], v_lo[16], v_hi[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int32_t kx = kc[e];
      const int32_t vx = vc[e];
      k_lo[e] = static_cast<float>((int32_t)((uint32_t)kx << 28) >> 28);
      v_lo[e] = static_cast<float>((int32_t)((uint32_t)vx << 28) >> 28);
      k_hi[e] = static_cast<float>(kx >> 4);
      v_hi[e] = static_cast<float>(vx >> 4);
    }
#pragma unroll
    for (int e = 0; e < 16; e += 4) {
      store4(s_k + j * HD + c + e, k_lo + e);
      store4(s_v + j * HD + c + e, v_lo + e);
      store4(s_k + j * HD + c + e + HD / 2, k_hi + e);
      store4(s_v + j * HD + c + e + HD / 2, v_hi + e);
    }
  }
}

// One staged tile through the online softmax of this thread's row.
template <int HD, bool SCALED>
__device__ __forceinline__ void attend_tile(const float* s_k, const float* s_v,
                                            const int* s_pos, const float* s_ks,
                                            const float* s_vs, const float (&qr)[kLanes],
                                            float (&o)[kLanes], float& m_run, float& l_run,
                                            int part, int qp, int lo, float scale) {
  constexpr int TPR = HD / kLanes;
  float s[kKeyTile];
#pragma unroll
  for (int j = 0; j < kKeyTile; ++j) {
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const float4 k4 = *reinterpret_cast<const float4*>(s_k + j * HD + lane_of<TPR>(part, i));
      a = fmaf(qr[4 * i], k4.x, a);
      a = fmaf(qr[4 * i + 1], k4.y, a);
      a = fmaf(qr[4 * i + 2], k4.z, a);
      a = fmaf(qr[4 * i + 3], k4.w, a);
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
    s[j] = a;
  }
  float m_new = m_run;
#pragma unroll
  for (int j = 0; j < kKeyTile; ++j) {
    const int p = s_pos[j];
    const bool ok = p >= 0 && p <= qp && p >= lo;
    float x = s[j] * scale;
    if (SCALED) x *= s_ks[j];             // (q.k / sqrt(hd)) * ks_j
    s[j] = ok ? x : kNeg;
    m_new = fmaxf(m_new, s[j]);
  }
  const float alpha = expf(m_run - m_new);
  l_run *= alpha;
#pragma unroll
  for (int d = 0; d < kLanes; ++d) o[d] *= alpha;
#pragma unroll
  for (int j = 0; j < kKeyTile; ++j) {
    const float e = expf(s[j] - m_new);
    l_run += e;
    const float pe = SCALED ? e * s_vs[j] : e;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const float4 v4 = *reinterpret_cast<const float4*>(s_v + j * HD + lane_of<TPR>(part, i));
      o[4 * i] = fmaf(pe, v4.x, o[4 * i]);
      o[4 * i + 1] = fmaf(pe, v4.y, o[4 * i + 1]);
      o[4 * i + 2] = fmaf(pe, v4.z, o[4 * i + 2]);
      o[4 * i + 3] = fmaf(pe, v4.w, o[4 * i + 3]);
    }
  }
  m_run = m_new;
}

template <int HD, int RING>
__global__ void __launch_bounds__(kRowsPerBlock * HD / kLanes)
ring_enc_kernel(const float* __restrict__ q, const void* __restrict__ k_ring,
                const void* __restrict__ v_ring, const float* __restrict__ k_scale,
                const float* __restrict__ v_scale, const int* __restrict__ slot_pos,
                const int* __restrict__ q_pos, const float* __restrict__ xk,
                const float* __restrict__ xv, const int* __restrict__ x_pos,
                const int* __restrict__ n_valid, float* __restrict__ out, int S, int P,
                int Sx, int H, int Hkv, int window, float scale) {
  constexpr int TPR = HD / kLanes;        // threads per query row
  constexpr bool kScaled = RING != kFloatRing;
  __shared__ __align__(16) float s_k[kKeyTile * HD];
  __shared__ __align__(16) float s_v[kKeyTile * HD];
  __shared__ int s_pos[kKeyTile];
  __shared__ float s_ks[kKeyTile];
  __shared__ float s_vs[kKeyTile];

  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int h = hq / (H / Hkv);
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  const bool live = row < S;              // ragged edge: masked, not written
  const int qp = live ? q_pos[(size_t)b * S + row] : kPosInvalid;
  const int lo = qp - (window - 1);
  const int nv = min(max(*n_valid, 0), P);
  const int q_dim = H * HD;
  const int kv_dim = Hkv * HD;

  float qr[kLanes], o[kLanes];
  const float* qrow = q + ((size_t)b * S + (live ? row : 0)) * q_dim + hq * HD;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    if (live) {
      load16(qrow + lane_of<TPR>(part, i), qr + 4 * i);
    } else {
      qr[4 * i] = qr[4 * i + 1] = qr[4 * i + 2] = qr[4 * i + 3] = 0.f;
    }
  }
#pragma unroll
  for (int d = 0; d < kLanes; ++d) o[d] = 0.f;
  float m_run = 0.5f * kNeg;
  float l_run = 0.f;

  // ring slots below nv
  const int ring_w = RING == kInt4Ring ? kv_dim / 2 : kv_dim;     // elements per slot
  const int head_w = RING == kInt4Ring ? HD / 2 : HD;
  for (int t0 = 0; t0 < nv; t0 += kKeyTile) {
    const int n = min(kKeyTile, nv - t0);
    const size_t row0 = (size_t)b * P + t0;
    if (RING == kFloatRing) {
      stage_float<HD>(static_cast<const float*>(k_ring) + row0 * ring_w + h * head_w,
                      static_cast<const float*>(v_ring) + row0 * ring_w + h * head_w,
                      ring_w, n, s_k, s_v);
    } else if (RING == kInt8Ring) {
      stage_int8<HD>(static_cast<const int8_t*>(k_ring) + row0 * ring_w + h * head_w,
                     static_cast<const int8_t*>(v_ring) + row0 * ring_w + h * head_w,
                     ring_w, n, s_k, s_v);
    } else {
      stage_int4<HD>(static_cast<const int8_t*>(k_ring) + row0 * ring_w + h * head_w,
                     static_cast<const int8_t*>(v_ring) + row0 * ring_w + h * head_w,
                     ring_w, n, s_k, s_v);
    }
    for (int j = threadIdx.x; j < kKeyTile; j += blockDim.x) {
      s_pos[j] = j < n ? slot_pos[row0 + j] : kPosInvalid;
      if (kScaled) {
        const size_t sc = ((size_t)b * Hkv + h) * P + t0 + j;
        s_ks[j] = j < n ? k_scale[sc] : 1.f;
        s_vs[j] = j < n ? v_scale[sc] : 1.f;
      }
    }
    __syncthreads();
    attend_tile<HD, kScaled>(s_k, s_v, s_pos, s_ks, s_vs, qr, o, m_run, l_run, part, qp, lo,
                             scale);
    __syncthreads();
  }

  // the extra columns (float, no scales)
  for (int t0 = 0; t0 < Sx; t0 += kKeyTile) {
    const int n = min(kKeyTile, Sx - t0);
    const size_t row0 = (size_t)b * Sx + t0;
    stage_float<HD>(xk + row0 * kv_dim + h * HD, xv + row0 * kv_dim + h * HD, kv_dim, n,
                    s_k, s_v);
    for (int j = threadIdx.x; j < kKeyTile; j += blockDim.x)
      s_pos[j] = j < n ? x_pos[row0 + j] : kPosInvalid;
    __syncthreads();
    attend_tile<HD, false>(s_k, s_v, s_pos, s_ks, s_vs, qr, o, m_run, l_run, part, qp, lo,
                           scale);
    __syncthreads();
  }

  if (!live) return;
  const float inv = 1.f / fmaxf(l_run, 1e-30f);
  float* orow = out + ((size_t)b * S + row) * q_dim + hq * HD;
#pragma unroll
  for (int i = 0; i < kChunks; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) orow[lane_of<TPR>(part, i) + e] = o[4 * i + e] * inv;
}

template <int RING>
int launch_f32(const void* q, const void* k, const void* v, const void* k_scale,
               const void* v_scale, const void* slot_pos, const void* q_pos, const void* xk,
               const void* xv, const void* x_pos, const void* n_valid, void* out, int B,
               int S, int P, int Sx, int H, int Hkv, int window, float scale,
               cudaStream_t stream) {
  constexpr int HD = 64;
  const dim3 grid((S + kRowsPerBlock - 1) / kRowsPerBlock, H, B);
  ring_enc_kernel<HD, RING><<<grid, kRowsPerBlock * HD / kLanes, 0, stream>>>(
      static_cast<const float*>(q), k, v, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(slot_pos),
      static_cast<const int*>(q_pos), static_cast<const float*>(xk),
      static_cast<const float*>(xv), static_cast<const int*>(x_pos),
      static_cast<const int*>(n_valid), static_cast<float*>(out), S, P, Sx, H, Hkv, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 route (tensor cores)
// ---------------------------------------------------------------------------

constexpr int kHD = 64;              // head width of the route (the encoder's)
constexpr int kTile = 32;            // ring slots or extra columns per tile
constexpr int kNT = kTile / 8;       // its n-tiles of 8 columns in Q K^T
constexpr int kMaxWarps = 5;         // 16 query rows each: 80 rows a pass
constexpr int kMaxTiles = 256;       // tiles one split may hold (the wrapper
                                     // splits longer rings)
constexpr int kStageBytes = 2 * kTile * kHD * 2;   // a tile's K and V as read:
                                                   // bf16 rows at most
constexpr float kLog2e = 1.4426950408889634f;

// A column of a staged tile: its position (invalid ones folded to INT_MAX,
// so two compares decide the mask), the factor of its score (1/sqrt(hd)
// log2(e) ks_j) and of its probability (vs_j; 1 without scales).
struct Col {
  int pos;
  float cm;
  float vs;
  float unused;
};

// Shared memory of one block. K/V tiles as bf16 [slot][lane] rows of 128
// bytes whose 16-byte chunk c sits at c ^ (slot % 8), so the 8 rows of an
// ldmatrix (plain or transposed) hit distinct banks.
struct EncSmem {
  int8_t stage[2][kStageBytes];             // tiles as read (codes or bf16)
  __nv_bfloat16 kv[2][2][kTile][kHD];       // [buffer][K, V][slot][lane]
  int pos[3][kTile];                        // three buffers: a tile's positions
  float ks[3][kTile];                       // and scales land while the one two
  float vs[3][kTile];                       // before is still attended
  Col col[2][kTile];
  int flag[kMaxTiles];                      // tiles that some row can see
  int list[kMaxTiles];                      // ... in order
  int n_list, q_hi, lo_min;
};

template <int RING> struct RawRow { static constexpr int N = 2 * kHD; };   // bf16 rows
template <> struct RawRow<kInt8Ring> { static constexpr int N = kHD; };
template <> struct RawRow<kInt4Ring> { static constexpr int N = kHD / 2; };

// Lane chunk c (8 bf16) of staged row j.
__device__ __forceinline__ __nv_bfloat16* kv_chunk(__nv_bfloat16 (*rows)[kHD], int j, int c) {
  return rows[j] + ((c ^ (j & 7)) << 3);
}

struct EncArgs {
  const __nv_bfloat16* q;
  const int8_t* k_ring;           // raw bytes of the rings
  const int8_t* v_ring;
  const float* k_scale;
  const float* v_scale;
  const int* slot_pos;
  const int* q_pos;
  const __nv_bfloat16* xk;
  const __nv_bfloat16* xv;
  const int* x_pos;
  const int* n_valid;
  float* o_part;                  // splits > 1: [B, H, S, splits, 64] f32
  float* m_part;                  //             [B, H, S, splits]
  float* l_part;
  __nv_bfloat16* out;             // splits == 1: [B, S, H * 64]
  int S, P, Sx, H, Hkv, window, splits, tiles_per_split;
  float scale;
};

// This thread's 16-byte chunks of a staged tile whose K and V rows are
// RB bytes: (index in the stage, K or V, row, chunk in the row).
template <int RB, typename F>
__device__ __forceinline__ void for_chunks(F&& f) {
  constexpr int CPR = RB / 16;
  for (int idx = threadIdx.x; idx < 2 * kTile * CPR; idx += blockDim.x)
    f(idx, idx / (kTile * CPR), (idx / CPR) % kTile, idx % CPR);
}

// At most 102 registers a thread, so four 5-warp blocks (the fleet's S =
// 80) share an SM: the fleet's 512 blocks (B 16 x 32 heads) in one wave.
template <int RING>
__global__ void __launch_bounds__(kMaxWarps * 32, 4)
ring_enc_mma_kernel(const EncArgs a) {
  constexpr int RAW = RawRow<RING>::N;               // bytes of a ring head row
  constexpr bool kQuant = RING != kFloatRing;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  EncSmem& sm = *reinterpret_cast<EncSmem*>(smem_raw);

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int group = a.H / a.Hkv;
  const int R = a.S * group;                         // query rows of the block
  const int nv = min(max(*a.n_valid, 0), a.P);
  const int n_ring = (a.P + kTile - 1) / kTile;     // tiles of the ring (< nv read)
  const int n_all = n_ring + (a.Sx + kTile - 1) / kTile;
  const int t_begin = split * a.tiles_per_split;
  const int n_mine = min(a.tiles_per_split, n_all - t_begin);
  const float scale_l2 = a.scale * kLog2e;
  const int q_dim = a.H * kHD;

  // Tile li of the list: ring tile or extra columns, its first column and
  // its width.
  struct Tile { bool ring; int j0, n; };
  auto tile = [&](int li) {
    const int vt = t_begin + sm.list[li];
    Tile x;
    x.ring = vt < n_ring;
    x.j0 = x.ring ? vt * kTile : (vt - n_ring) * kTile;
    x.n = x.ring ? min(kTile, nv - x.j0) : min(kTile, a.Sx - x.j0);
    return x;
  };

  // Start tile li's copies (cp.async) into stage li % 2 and positions /
  // scales buffer li % 3; rows past the tile's end are zero-filled, their
  // positions invalid; tiles without scales get 1.
  auto issue = [&](int li) {
    const Tile x = tile(li);
    const int pb = li % 3;
    const bool scaled = kQuant && x.ring;
    const int* pos = x.ring ? a.slot_pos + (size_t)b * a.P + x.j0
                            : a.x_pos + (size_t)b * a.Sx + x.j0;
    const size_t sc = ((size_t)b * a.Hkv + h) * a.P + x.j0;
    for (int j = tid; j < kTile; j += nthreads) {
      if (j < x.n) {
        cp_async4(&sm.pos[pb][j], pos + j);
      } else {
        sm.pos[pb][j] = kPosInvalid;
      }
      if (scaled && j < x.n) {
        cp_async4(&sm.ks[pb][j], a.k_scale + sc + j);
        cp_async4(&sm.vs[pb][j], a.v_scale + sc + j);
      } else {
        sm.ks[pb][j] = sm.vs[pb][j] = scaled ? 0.f : 1.f;
      }
    }
    int8_t* dst = sm.stage[li & 1];
    const int hkv = a.Hkv, n = x.n;
    auto copy = [dst, hkv, n, h](const int8_t* kb, const int8_t* vb, size_t row0, int rb) {
      return [=](int idx, int which, int j, int c) {
        const int8_t* src = (which ? vb : kb) + (row0 + min(j, n - 1)) * hkv * rb + h * rb +
                            c * 16;
        cp_async16(dst + idx * 16, src, j < n ? 16 : 0);
      };
    };
    if (scaled) {
      for_chunks<RAW>(copy(a.k_ring, a.v_ring, (size_t)b * a.P + x.j0, RAW));
    } else if (x.ring) {
      for_chunks<2 * kHD>(copy(a.k_ring, a.v_ring, (size_t)b * a.P + x.j0, 2 * kHD));
    } else {
      for_chunks<2 * kHD>(copy(reinterpret_cast<const int8_t*>(a.xk),
                               reinterpret_cast<const int8_t*>(a.xv),
                               (size_t)b * a.Sx + x.j0, 2 * kHD));
    }
  };

  // This thread's part of tile li (the copies it made itself, so no
  // barrier is needed before): its chunks from stage li % 2 into bf16 rows
  // of buffer li % 2, and its columns' Col entries.
  auto convert = [&](int li) {
    const int kb = li & 1, pb = li % 3;
    const bool scaled = kQuant && tile(li).ring;
    for (int j = tid; j < kTile; j += nthreads) {
      const int p = sm.pos[pb][j];
      sm.col[kb][j] = Col{p >= 0 ? p : INT_MAX, scale_l2 * sm.ks[pb][j], sm.vs[pb][j], 0.f};
    }
    const int8_t* src = sm.stage[kb];
    auto rows = [&](int which) { return sm.kv[kb][which]; };
    if (!scaled) {                         // bf16 lanes c*8 .. c*8+7
      for_chunks<2 * kHD>([&](int idx, int which, int j, int c) {
        *reinterpret_cast<uint4*>(kv_chunk(rows(which), j, c)) =
            *reinterpret_cast<const uint4*>(src + idx * 16);
      });
      return;
    }
    for_chunks<RAW>([&](int idx, int which, int j, int c) {
      const uint4 w = *reinterpret_cast<const uint4*>(src + idx * 16);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
      if constexpr (RING == kInt8Ring) {   // codes c*16 .. c*16+15 -> lanes alike
        uint32_t o[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint2 p = int8x4_to_bf16(words[i]);
          o[2 * i] = p.x;
          o[2 * i + 1] = p.y;
        }
        *reinterpret_cast<uint4*>(kv_chunk(rows(which), j, 2 * c)) =
            make_uint4(o[0], o[1], o[2], o[3]);
        *reinterpret_cast<uint4*>(kv_chunk(rows(which), j, 2 * c + 1)) =
            make_uint4(o[4], o[5], o[6], o[7]);
      } else {                             // bytes c*16.. -> lanes c*16.. (low), +32 (high)
        uint32_t lo[8], hi[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint2 pl = nibbles_to_bf16(lo_nibbles(words[i]));
          const uint2 ph = nibbles_to_bf16(hi_nibbles(words[i]));
          lo[2 * i] = pl.x;
          lo[2 * i + 1] = pl.y;
          hi[2 * i] = ph.x;
          hi[2 * i + 1] = ph.y;
        }
        *reinterpret_cast<uint4*>(kv_chunk(rows(which), j, 2 * c)) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
        *reinterpret_cast<uint4*>(kv_chunk(rows(which), j, 2 * c + 1)) =
            make_uint4(lo[4], lo[5], lo[6], lo[7]);
        *reinterpret_cast<uint4*>(kv_chunk(rows(which), j, 4 + 2 * c)) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(kv_chunk(rows(which), j, 5 + 2 * c)) =
            make_uint4(hi[4], hi[5], hi[6], hi[7]);
      }
    });
  };

  for (int r0 = 0; r0 < R; r0 += nwarps * 16) {
    // this warp's rows: e = 0 row g, e = 1 row g + 8 of its 16; their q
    // fragments (qa[kk] covers head lanes [16 kk, 16 kk + 16)) load while
    // the block lists its tiles
    const int rw = r0 + warp * 16;
    const bool has_rows = rw < R;
    // row e's (query head, position in the chunk); r >= R: not a row
    auto row_of = [&](int e) {
      const int r = rw + g + 8 * e;
      return make_int2(h * group + r / a.S, r % a.S);
    };
    int qp[2], lo[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      qp[e] = rw + g + 8 * e < R ? a.q_pos[(size_t)b * a.S + row_of(e).y] : kPosInvalid;
      lo[e] = qp[e] - (a.window - 1);
    }
    uint32_t qa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = r & 1;               // a0, a2: row g; a1, a3: row g + 8
        const int col = kk * 16 + 2 * t + (r >> 1) * 8;
        const int2 hi = row_of(e);
        qa[kk][r] = rw + g + 8 * e < R
                        ? *reinterpret_cast<const uint32_t*>(
                              a.q + ((size_t)b * a.S + hi.y) * q_dim + hi.x * kHD + col)
                        : 0u;
      }

    if (r0 == 0) {
      // The stream's query rows see positions in [lo_min, q_hi]: a tile
      // holding none of those is skipped (exact: its columns are masked for
      // every row). Warp 0 finds the range, each warp flags its tiles, warp
      // 0 lists the flagged ones in order.
      if (warp == 0) {
        int hi = -1, lmin = INT_MAX;
        for (int i = lane; i < a.S; i += 32) {
          const int p = a.q_pos[(size_t)b * a.S + i];
          if (p >= 0) {
            hi = max(hi, p);
            lmin = min(lmin, p - (a.window - 1));
          }
        }
        hi = __reduce_max_sync(0xffffffffu, hi);
        lmin = __reduce_min_sync(0xffffffffu, lmin);
        if (lane == 0) { sm.q_hi = hi; sm.lo_min = lmin; }
      }
      __syncthreads();
      const int q_hi = sm.q_hi, lo_min = sm.lo_min;
      for (int lt = warp; lt < n_mine; lt += nwarps) {
        const int vt = t_begin + lt;
        bool any = false;
        for (int c = lane; c < kTile; c += 32) {
          int p = kPosInvalid;
          if (vt < n_ring) {
            const int j = vt * kTile + c;
            if (j < nv) p = a.slot_pos[(size_t)b * a.P + j];
          } else {
            const int j = (vt - n_ring) * kTile + c;
            if (j < a.Sx) p = a.x_pos[(size_t)b * a.Sx + j];
          }
          any |= p >= 0 && p <= q_hi && p >= lo_min;
        }
        any = __any_sync(0xffffffffu, any);
        if (lane == 0) sm.flag[lt] = any;
      }
      __syncthreads();
      if (warp == 0) {
        int n = 0;
        for (int base = 0; base < n_mine; base += 32) {
          const int lt = base + lane;
          const bool f = lt < n_mine && sm.flag[lt];
          const unsigned m = __ballot_sync(0xffffffffu, f);
          if (f) sm.list[n + __popc(m & ((1u << lane) - 1))] = lt;
          n += __popc(m);
        }
        if (lane == 0) sm.n_list = n;
      }
      __syncthreads();
    }
    const int n_list = sm.n_list;

    float o[8][4];
#pragma unroll
    for (int nd = 0; nd < 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
    float m_run[2] = {0.5f * kNeg, 0.5f * kNeg};
    float l_run[2] = {0.f, 0.f};

    // Two tiles in flight while one is attended; one barrier a tile.
    if (n_list > 0) issue(0);
    cp_async_commit();
    if (n_list > 1) issue(1);
    cp_async_commit();
    cp_async_wait<1>();
    if (n_list > 0) convert(0);
    for (int li = 0; li < n_list; ++li) {
      __syncthreads();                     // tile li converted; tile li - 1 attended
      if (li + 2 < n_list) issue(li + 2);  // into what tile li (stage) and li - 1 used
      cp_async_commit();
      const int kb = li & 1;
      if (has_rows) {
        // S = Q K^T: 16 rows x kTile columns, n-tile nt = columns 8 nt .. 8 nt + 7
        float s[kNT][4];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
          uint32_t kf[4];
          const int j = nt * 8 + (lane & 7);
          ldmatrix_x4(kf, kv_chunk(sm.kv[kb][0], j, lane >> 3));
          mma_bf16(s[nt], qa[0], kf[0], kf[1]);
          mma_bf16(s[nt], qa[1], kf[2], kf[3]);
          ldmatrix_x4(kf, kv_chunk(sm.kv[kb][0], j, 4 + (lane >> 3)));
          mma_bf16(s[nt], qa[2], kf[0], kf[1]);
          mma_bf16(s[nt], qa[3], kf[2], kf[3]);
        }
        // scale (base 2, ks_j), mask, row max over the quad
        float mx[2] = {0.5f * kNeg, 0.5f * kNeg};
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const Col cj = sm.col[kb][nt * 8 + 2 * t + c];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = s[nt][2 * e + c];
              x = (cj.pos <= qp[e] && cj.pos >= lo[e]) ? x * cj.cm : kNeg;
              mx[e] = fmaxf(mx[e], x);
            }
          }
        float alpha[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
          mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
          const float m_new = fmaxf(m_run[e], mx[e]);
          alpha[e] = ex2(m_run[e] - m_new);
          m_run[e] = m_new;
          l_run[e] *= alpha[e];
        }
#pragma unroll
        for (int nd = 0; nd < 8; ++nd) {
          o[nd][0] *= alpha[0];
          o[nd][1] *= alpha[0];
          o[nd][2] *= alpha[1];
          o[nd][3] *= alpha[1];
        }
        // p = round_bf16(e * vs_j) as the A fragments of P V; l sums e
        uint32_t pa[kNT / 2][4];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          float pe[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int e = r >> 1;
            const float ex = ex2(s[nt][r] - m_run[e]);
            l_run[e] += ex;
            pe[r] = ex * sm.col[kb][nt * 8 + 2 * t + (r & 1)].vs;
          }
          pa[nt >> 1][(nt & 1) * 2] = pack_bf16x2(pe[0], pe[1]);
          pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16x2(pe[2], pe[3]);
        }
        // O += P V: k-step kk = columns 16 kk .. 16 kk + 15, n-tiles of 8 lanes
#pragma unroll
        for (int kk = 0; kk < kNT / 2; ++kk)
#pragma unroll
          for (int nd = 0; nd < 8; nd += 2) {
            uint32_t vf[4];
            ldmatrix_x4_trans(vf, kv_chunk(sm.kv[kb][1], kk * 16 + (lane & 7) + (lane & 8),
                                           nd + (lane >> 4)));
            mma_bf16(o[nd], pa[kk], vf[0], vf[1]);
            mma_bf16(o[nd + 1], pa[kk], vf[2], vf[3]);
          }
      }
      cp_async_wait<1>();                  // tile li + 1 landed (this thread's copies)
      if (li + 1 < n_list) convert(li + 1);
    }
    cp_async_wait<0>();

    if (has_rows) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        l_run[e] += __shfl_xor_sync(0xffffffffu, l_run[e], 1);
        l_run[e] += __shfl_xor_sync(0xffffffffu, l_run[e], 2);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (rw + g + 8 * e >= R) continue;
        const int2 hi = row_of(e);
        const size_t row = (size_t)b * a.S + hi.y;
        if (a.splits == 1) {
          const float inv = 1.f / fmaxf(l_run[e], 1e-30f);
          __nv_bfloat16* orow = a.out + row * q_dim + hi.x * kHD;
#pragma unroll
          for (int nd = 0; nd < 8; ++nd)
            *reinterpret_cast<uint32_t*>(orow + nd * 8 + 2 * t) =
                pack_bf16x2(o[nd][2 * e] * inv, o[nd][2 * e + 1] * inv);
        } else {
          const size_t part = (((size_t)b * a.H + hi.x) * a.S + hi.y) * a.splits + split;
          float* op = a.o_part + part * kHD;
#pragma unroll
          for (int nd = 0; nd < 8; ++nd)
            *reinterpret_cast<float2*>(op + nd * 8 + 2 * t) =
                make_float2(o[nd][2 * e], o[nd][2 * e + 1]);
          if (t == 0) {
            a.m_part[part] = m_run[e];
            a.l_part[part] = l_run[e];
          }
        }
      }
    }
    __syncthreads();                       // the next pass reuses the buffers
  }
}

// Merge the splits of one query row (row, head, stream): one thread per
// output lane.
__global__ void __launch_bounds__(kHD)
ring_enc_merge_kernel(const float* __restrict__ o_part, const float* __restrict__ m_part,
                      const float* __restrict__ l_part, __nv_bfloat16* __restrict__ out, int S,
                      int H, int splits) {
  const int i = blockIdx.x, hq = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const size_t base = (((size_t)b * H + hq) * S + i) * splits;
  float mx = 0.5f * kNeg;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, m_part[base + s]);
  float den = 0.f, acc = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float w = ex2(m_part[base + s] - mx);
    den = fmaf(w, l_part[base + s], den);
    acc = fmaf(w, o_part[(base + s) * kHD + d], acc);
  }
  out[((size_t)b * S + i) * H * kHD + hq * kHD + d] = __float2bfloat16(acc / fmaxf(den, 1e-30f));
}

template <int RING>
int launch_mma(const void* q, const void* k, const void* v, const void* k_scale,
               const void* v_scale, const void* slot_pos, const void* q_pos, const void* xk,
               const void* xv, const void* x_pos, const void* n_valid, void* o_part,
               void* m_part, void* l_part, void* out, int B, int S, int P, int Sx, int H,
               int Hkv, int window, float scale, int splits, cudaStream_t stream) {
  const int n_all = (P + kTile - 1) / kTile + (Sx + kTile - 1) / kTile;
  const int per = splits < 1 ? 0 : (n_all + splits - 1) / splits;
  if (splits < 1 || (splits - 1) * per >= n_all || per > kMaxTiles ||
      (splits > 1 && (o_part == nullptr || m_part == nullptr || l_part == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const EncArgs a{static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
                  static_cast<const int8_t*>(v), static_cast<const float*>(k_scale),
                  static_cast<const float*>(v_scale), static_cast<const int*>(slot_pos),
                  static_cast<const int*>(q_pos), static_cast<const __nv_bfloat16*>(xk),
                  static_cast<const __nv_bfloat16*>(xv), static_cast<const int*>(x_pos),
                  static_cast<const int*>(n_valid), static_cast<float*>(o_part),
                  static_cast<float*>(m_part), static_cast<float*>(l_part),
                  static_cast<__nv_bfloat16*>(out), S, P, Sx, H, Hkv, window, splits, per,
                  scale};
  constexpr size_t smem = sizeof(EncSmem);
  static bool raised[64] = {};              // the shared-memory limit, per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !raised[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        ring_enc_mma_kernel<RING>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised[dev] = true;
  }
  const int rows = S * (H / Hkv);
  const int warps = min(kMaxWarps, (rows + 15) / 16);
  ring_enc_mma_kernel<RING><<<dim3(splits, Hkv, B), warps * 32, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  ring_enc_merge_kernel<<<dim3(S, H, B), kHD, 0, stream>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(m_part),
      static_cast<const float*>(l_part), static_cast<__nv_bfloat16*>(out), S, H, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (the CUDA-core route), 1 = bfloat16 (the tensor-core
// route) for q, float rings, extra columns and out.
// ring: 0 = K/V rings in q's dtype [B, P, Hkv*hd]; 1 = int8 rings
// [B, P, Hkv*hd]; 2 = int4-packed rings [B, P, Hkv*hd/2]; 1 and 2 take f32
// scales k_scale/v_scale [B, Hkv, P]. q and out are [B, S, H*hd], q_pos
// [B, S], slot_pos [B, P], extra columns [B, Sx, Hkv*hd] with x_pos [B, Sx]
// (Sx may be 0). n_valid is a device int32 scalar. head_dim is 64.
// splits (bf16 only; 1 for f32): blocks a (stream, kv head) is split over;
// the tiles (ceil(P / 64) + ceil(Sx / 64)) go ceil(tiles / splits) to a
// split, and no split may be empty. With splits > 1, o_part [B, H, S,
// splits, 64], m_part and l_part [B, H, S, splits] f32 hold the partials.
// Returns the CUDA error code of the launches (0 = launched).
int ring_gqa_attention_enc_launch(int dtype, int ring, int head_dim, const void* q,
                                  const void* k, const void* v, const void* k_scale,
                                  const void* v_scale, const void* slot_pos,
                                  const void* q_pos, const void* xk, const void* xv,
                                  const void* x_pos, const void* n_valid, void* o_part,
                                  void* m_part, void* l_part, void* out, int B, int S, int P,
                                  int Sx, int H, int Hkv, int window, float scale, int splits,
                                  void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || B <= 0 || S <= 0 || P <= 0 || Sx < 0 || head_dim != 64 ||
      B > 65535 || Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VOX_RING_CASE(R)                                                                     \
  case R:                                                                                    \
    if (dtype == 0)                                                                          \
      return splits == 1 ? launch_f32<R>(q, k, v, k_scale, v_scale, slot_pos, q_pos, xk, xv, \
                                         x_pos, n_valid, out, B, S, P, Sx, H, Hkv, window,   \
                                         scale, s)                                           \
                         : static_cast<int>(cudaErrorInvalidValue);                         \
    if (dtype == 1)                                                                          \
      return launch_mma<R>(q, k, v, k_scale, v_scale, slot_pos, q_pos, xk, xv, x_pos,        \
                           n_valid, o_part, m_part, l_part, out, B, S, P, Sx, H, Hkv, window, \
                           scale, splits, s);                                                \
    return static_cast<int>(cudaErrorInvalidValue);
  switch (ring) {
    VOX_RING_CASE(kFloatRing)
    VOX_RING_CASE(kInt8Ring)
    VOX_RING_CASE(kInt4Ring)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VOX_RING_CASE
}

}  // extern "C"
