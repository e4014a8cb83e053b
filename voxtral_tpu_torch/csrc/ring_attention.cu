// Ring-buffer GQA decode attention for Hopper (sm_90a): float rings (K1) and
// int8 rings with per-(slot, kv head) f32 scales (K1-int8).
//
// Replaces voxtral_tpu/ops/pallas_attention.py::ring_gqa_attention (the
// Pallas kernel, pallas_call at :314, body _kernel :113 -> _attend_block
// :45) in its decode regime: one query per stream (S = 1), K/V rings either
// in q's float dtype (f32 or bf16) or int8 with scales k_scale/v_scale laid
// out [B, Hkv, P] (the kernel's has_scales path, :74-75, :102-103), and
// optional extra columns in q's dtype (the decode chunk's own K/V).
//
// What it computes, per stream b and query head hq (kv head h = hq / group):
//   s_j = (q . k_j) / sqrt(hd) [* ks_j for int8 rings] over ring slots
//   j < nv and the Sx extra columns, masked by 0 <= pos_j <= q_pos and
//   pos_j >= q_pos - (window-1); one softmax over both; the denominator
//   sums the unscaled e_j; out = sum_j round(e_j [* vs_j]) v_j / denominator.
// Fully-masked rows return 0: the running max is floored at -5e29 and the
// denominator at 1e-30, as in the TPU kernel (:94-107). The probability
// column (times vs_j for int8 rings) is rounded to q's dtype before the PV
// product, as the TPU kernel feeds its matrix unit (:80-87, :102-104); int8
// codes convert exactly; accumulation is f32. The extra columns carry no
// scales.
//
// Bound: bytes. A call must read the K/V rows below nv (and their scales),
// q and the positions, and write the output; its arithmetic is 4 flops per
// K/V element. Float rings: 34 MB for B = 1 and a full 8320-slot bf16 ring,
// ~10 us at 3.35 TB/s. Int8 rings halve the ring bytes: at the fleet's B =
// 16 (Hq 32, Hkv 8, hd 128, nv 2080, Sx 20, one stream masked) the codes,
// scales, q and out a call needs come to ~67 MB, 19.88 us.
//
// Both routes split the ring into fixed splits of kSplit = 256 slots
// (never derived from B, Hkv or the SM count, so a tensor-parallel rank's
// heads compute the whole call's bits): grid (splits + 1, kv heads
// [x query-head blocks], B), the last split index holding the extra
// columns. The read bound nv is a device int32 the blocks read themselves
// (no host sync, safe in a CUDA graph): blocks wholly past nv exit at once.
// Each block writes its split's f32 (max, sum, unnormalised output); a
// second small kernel merges the splits in a fixed order (no atomics:
// identical bits in every run).
//
// Two routes, chosen by the wrapper (ops/ring_attention.dec_plan):
//
// CUDA cores (ring_partial_kernel, ring_merge_kernel): f32 q on either ring
// (parity mode: f32 throughout), and bf16 q on float rings with more than 8
// query heads per kv head (no configuration the port runs has one). A block
// owns one kv head, up to 4 of its query heads and one split; K/V rows are
// read with 16-byte vector loads (int8 codes converted in registers),
// scores go to shared memory, a softmax pass and a PV pass follow.
//
// Tensor cores (ring_dec_mma_kernel<R>, ring_dec_merge_kernel): bf16 q on
// int8 rings (K1-int8, R = int8_t) and on bf16 float rings (K1, R = bf16),
// the serving routes. On the CUDA cores K1-int8 was held back by its
// arithmetic and serial phases, not by bytes (int-to-float converts at a
// quarter of the FMA rate, per-row shuffle reductions, three barrier-
// separated passes, 38 KB of shared memory per 4-warp block: 79 us at the
// fleet shape). Here:
//   * mma.sync m16n8k16 in the transposed shape: S^T = K Q^T with a
//     16-slot tile as the m rows (A = K by ldmatrix) and the kv head's
//     query heads as the n columns (group <= 8, padded to 8), then O^T =
//     V^T P^T with head lanes as rows (A = V by ldmatrix.trans) and P^T as
//     B (the S^T fragments transposed in registers by movmatrix). Against
//     FlashAttention-2's shape (queries as rows, padded to 16) this halves
//     the products, the exponentials and the registers of O and q;
//   * int8 codes are never converted in shared memory or device memory: a
//     lane's ldmatrix word of K holds codes 4t..4t+3 of one slot (q's k
//     order is permuted within each 16 lanes to match), its .trans word of
//     V two lanes of two slots; both become bf16 pairs in registers, exact,
//     by byte permutes and one bf16x2 subtraction (no int-to-float convert);
//   * each of the block's 4 warps takes every 4th 16-slot tile of the split
//     and streams it by 16-byte cp.async (codes, positions, scales) through
//     its own 2 stages, so a warp waits with __syncwarp only; shared memory
//     is XOR-swizzled by row, so ldmatrix meets no bank conflict; 34 KB and
//     at most 128 registers a thread put 4 blocks (16 warps) on an SM. On
//     bf16 rings a stage is twice the bytes (8 KB a warp at hd 128); 2 of
//     them (66 KB, 3 blocks per SM) beat 1 (34 KB, 4 blocks) at B 1 and
//     within 2% of it at B 16;
//   * per warp an online softmax in f32, base 2 (ex2), scores scaled per
//     slot by 1/sqrt(hd) log2(e) ks_j, p = round_bf16(e vs_j), O in f32
//     rescaled when a head's max moves; the warps' (m, l, O) merge once in
//     shared memory at the end, in warp order; the splits merge one warp
//     per (stream, query head), up to 16 splits' loads at once;
//   * bf16 rows (a float ring's, and the extra columns on either ring) take
//     the same path with unit scales and q in the plain k order: no
//     conversion; a stream whose query position is invalid writes its
//     neutral partials without reading the ring.
// At the fleet shape the route is held back by its memory pipeline and its
// fixed per-block costs, not by the tensor cores (PERF.md §6): on NVIDIA
// H100 80GB HBM3 at 700 W, K1-int8 runs at about 0.6 of its byte bound,
// K1 (bf16 float rings, B 16, nv 2080) at 0.73 (52.4 us; SDPA 55.7).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_common.cuh"
#include "ring_common.cuh"

namespace {

using namespace mma_common;
using namespace ring_common;

constexpr int kThreads = 128;     // 4 warps per block
constexpr int kSplit = 256;       // ring slots per split (also max extra cols);
                                  // _SPLIT_SLOTS in ops/ring_attention.py
constexpr int kGroupBlock = 4;    // query heads per block (one warp each)

// rows in flight per thread (int8 rows carry 16 elements per load)
template <typename T> struct Unroll { static constexpr int N = 4; };
template <> struct Unroll<int8_t> { static constexpr int N = 2; };

// N consecutive elements as f32, in 16-byte loads
template <int N, typename T>
__device__ __forceinline__ void load_n(const T* p, float* out) {
  constexpr int W = VecWidth<T>::N;
  static_assert(N % W == 0, "whole 16-byte loads");
#pragma unroll
  for (int i = 0; i < N / W; ++i) load16(p + i * W, out + i * W);
}

// Query heads [g0, g0 + gb) of one kv head over `count` rows of one split.
// Rows are of element type R (the ring's, or T for the extra columns), with
// per-row f32 scales when SCALED. Writes the split's (max, sum,
// unnormalised output) per query head at part0 + g * n_parts.
template <typename T, typename R, int HD, bool SCALED>
__device__ __forceinline__ void attend_split(
    const T* __restrict__ qb, int gb, const R* __restrict__ kb,
    const R* __restrict__ vb, int kv_dim, const int* __restrict__ pb,
    const float* __restrict__ ksb, const float* __restrict__ vsb, int count,
    int qp, int lo, float scale, float (*s_p)[kSplit], float* s_ks,
    float* s_vs, float* s_red, size_t part0, int n_parts,
    float* __restrict__ o_part, float* __restrict__ m_part,
    float* __restrict__ l_part) {
  constexpr int VEC = VecWidth<R>::N;     // elements per 16-byte row load
  constexpr int TPR = HD / VEC;           // threads per K/V row
  constexpr int ROWS = kThreads / TPR;    // rows read side by side
  constexpr int UNROLL = Unroll<R>::N;
  static_assert(TPR >= 1 && TPR <= 32 && 32 % TPR == 0,
                "a K/V row must lie within one warp");

  const int tid = threadIdx.x;
  const int r = tid / TPR;                // row slot of this thread
  const int c = tid % TPR;                // 16-byte column of this thread

  if (SCALED) {                           // the split's scale slices, once
    for (int j = tid; j < count; j += kThreads) {
      s_ks[j] = __ldg(ksb + j);
      s_vs[j] = __ldg(vsb + j);
    }
    __syncthreads();
  }

  float qr[kGroupBlock][VEC];
#pragma unroll
  for (int g = 0; g < kGroupBlock; ++g) {
    if (g < gb) {
      load_n<VEC>(qb + (size_t)g * HD + c * VEC, qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[g][e] = 0.f;
    }
  }

  // Scores. Every lane of a warp runs the same trip count (the shuffles
  // need the whole warp); rows past `count` load nothing.
  for (int j0 = 0; j0 < count; j0 += ROWS * UNROLL) {
    float kr[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * ROWS + r;
      if (j < count) {
        load_n<VEC>(kb + (size_t)j * kv_dim + c * VEC, kr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kr[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
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
        const int p = __ldg(pb + j);
        const bool ok = p >= 0 && p <= qp && p >= lo;
        const float ks = SCALED ? s_ks[j] : 1.f;
#pragma unroll
        for (int g = 0; g < kGroupBlock; ++g) {
          float s = acc[g] * scale;
          if (SCALED) s *= ks;            // (q.k / sqrt(hd)) * ks_j
          s_p[g][j] = ok ? s : kNeg;
        }
      }
    }
  }
  __syncthreads();

  // Softmax statistics of this split, one warp per query head. Masked
  // scores are kNeg and the max is floored at kNeg/2, so their exp is 0.
  // The sum takes e_j before the V scale; the PV operand is e_j * vs_j in
  // q's dtype.
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
      s_p[warp][j] = round_to<T>(SCALED ? e * s_vs[j] : e);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      m_part[part0 + (size_t)warp * n_parts] = m;
      l_part[part0 + (size_t)warp * n_parts] = l;
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
  for (int j0 = r; j0 < count; j0 += ROWS * UNROLL) {
    float vr[UNROLL][VEC];
    float pr[UNROLL][kGroupBlock];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * ROWS;
      bool any = false;
#pragma unroll
      for (int g = 0; g < kGroupBlock; ++g) {
        pr[u][g] = (j < count && g < gb) ? s_p[g][j] : 0.f;
        any |= pr[u][g] != 0.f;
      }
      if (any) {
        load_n<VEC>(vb + (size_t)j * kv_dim + c * VEC, vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) vr[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int g = 0; g < kGroupBlock; ++g)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(pr[u][g], vr[u][e], acc[g][e]);
  }
  // s_red: [ROWS][kGroupBlock][HD]
#pragma unroll
  for (int g = 0; g < kGroupBlock; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e) s_red[(r * kGroupBlock + g) * HD + c * VEC + e] = acc[g][e];
  __syncthreads();
  for (int i = tid; i < gb * HD; i += kThreads) {
    const int g = i / HD;
    const int d = i % HD;
    float sum = 0.f;
#pragma unroll 8
    for (int rr = 0; rr < ROWS; ++rr) sum += s_red[(rr * kGroupBlock + g) * HD + d];
    o_part[(part0 + (size_t)g * n_parts) * HD + d] = sum;
  }
}

// One block: kv head h, query heads [g0, g0 + gb) of its group, and one
// split (256 ring slots, or the extra columns). R is the ring's element
// type: T (float rings) or int8_t (int8 rings with scales).
template <typename T, typename R, int HD>
__global__ void __launch_bounds__(kThreads)
ring_partial_kernel(const T* __restrict__ q, const R* __restrict__ k,
                    const R* __restrict__ v, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const int* __restrict__ slot_pos,
                    const int* __restrict__ q_pos, const T* __restrict__ xk,
                    const T* __restrict__ xv, const int* __restrict__ x_pos,
                    const int* __restrict__ n_valid, float* __restrict__ o_part,
                    float* __restrict__ m_part, float* __restrict__ l_part,
                    int P, int Sx, int H, int Hkv, int n_ring_splits,
                    int window, float scale) {
  constexpr bool kScaled = std::is_same<R, int8_t>::value;
  constexpr int kMaxVec = VecWidth<R>::N > VecWidth<T>::N ? VecWidth<R>::N
                                                          : VecWidth<T>::N;
  __shared__ float s_p[kGroupBlock][kSplit];          // scores, then probs
  __shared__ float s_ks[kScaled ? kSplit : 1];        // the split's scales
  __shared__ float s_vs[kScaled ? kSplit : 1];
  __shared__ float s_red[kThreads * kGroupBlock * kMaxVec];  // PV partial sums

  const int split = blockIdx.x;
  const int G = H / Hkv;
  const int gblocks = (G + kGroupBlock - 1) / kGroupBlock;
  const int h = blockIdx.y / gblocks;
  const int g0 = (blockIdx.y % gblocks) * kGroupBlock;
  const int gb = min(kGroupBlock, G - g0);
  const int b = blockIdx.z;
  const int kv_dim = Hkv * HD;
  const int n_parts = n_ring_splits + 1;
  const size_t part0 = ((size_t)b * H + h * G + g0) * n_parts + split;
  const T* qb = q + ((size_t)b * H + h * G + g0) * HD;
  const int qp = q_pos[b];
  const int lo = qp - (window - 1);

  const bool ring_rows = split < n_ring_splits;
  int start = 0;
  int count = Sx;
  if (ring_rows) {
    const int nv = min(*n_valid, P);
    start = split * kSplit;
    if (start >= nv) return;              // past the filled prefix
    count = min(kSplit, nv - start);
  }
  const size_t row0 = ring_rows ? (size_t)b * P + start : (size_t)b * Sx;
  const size_t col = row0 * kv_dim + h * HD;
  if constexpr (kScaled) {
    if (ring_rows) {
      const size_t sc0 = ((size_t)b * Hkv + h) * P + start;
      attend_split<T, R, HD, true>(qb, gb, k + col, v + col, kv_dim, slot_pos + row0,
                                   k_scale + sc0, v_scale + sc0, count, qp, lo, scale,
                                   s_p, s_ks, s_vs, s_red, part0, n_parts, o_part,
                                   m_part, l_part);
    } else {
      attend_split<T, T, HD, false>(qb, gb, xk + col, xv + col, kv_dim, x_pos + row0,
                                    nullptr, nullptr, count, qp, lo, scale, s_p, s_ks,
                                    s_vs, s_red, part0, n_parts, o_part, m_part, l_part);
    }
  } else {
    // float rings share the extra columns' type: one call site for both
    attend_split<T, T, HD, false>(qb, gb, (ring_rows ? k : xk) + col,
                                  (ring_rows ? v : xv) + col, kv_dim,
                                  (ring_rows ? slot_pos : x_pos) + row0, nullptr,
                                  nullptr, count, qp, lo, scale, s_p, s_ks, s_vs, s_red,
                                  part0, n_parts, o_part, m_part, l_part);
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

// ---------------------------------------------------------------------------
// bf16 q on int8 rings: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTile = 16;          // ring slots (or extra columns) per warp tile
constexpr int kWarps = 4;          // warps per block; warp w takes tiles w, w + 4, ...
constexpr int kMaxGroup = 8;       // query heads per kv head: one n-tile (_DEC_MAX_GROUP)
constexpr int kInt8Stages = 2;     // int8 ring tiles in flight per warp
constexpr int kBf16Stages = 2;     // bf16 ring tiles in flight per warp
constexpr int kMinBlocks = 4;      // blocks per SM the registers must allow
constexpr int kPosInvalid = -(1 << 30);
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block on rings of element type R (int8 codes or bf16
// rows): per warp, the stages of R's K and V tiles with each stage's
// positions and scales; the warps' (m, l) for the final merge (their O
// reuses the tiles' bytes). The bf16 extra columns take the same bytes in
// fewer stages (int8 rings: one).
template <typename R, int HD>
struct DecSmem {
  static constexpr int kStages = sizeof(R) == 1 ? kInt8Stages : kBf16Stages;
  static constexpr int kWarpBytes = kStages * 2 * kTile * HD * (int)sizeof(R);
  alignas(16) int8_t tiles[kWarps][kWarpBytes];
  int pos[kWarps][kStages][kTile];
  float ks[kWarps][kStages][kTile];
  float vs[kWarps][kStages][kTile];
  float m[kWarps][kMaxGroup];
  float l[kWarps][kMaxGroup];
};

// Byte offset of 16-byte chunk c of row j in a tile of RB-byte rows, XOR-
// swizzled so that chunk c of 8 consecutive rows lies in 8 distinct bank
// groups (ldmatrix, plain or transposed, reads 8 such rows at once).
template <int RB>
__device__ __forceinline__ int chunk_off(int j, int c) {
  constexpr int CPR = RB / 16;
  static_assert(CPR == 4 || CPR % 8 == 0, "rows of 64 bytes or a multiple of 128");
  return (j * CPR + (CPR == 4 ? c ^ ((j >> 1) & 3) : c ^ (j & 7))) * 16;
}

template <typename R>
struct DecArgs {
  const __nv_bfloat16* q;         // [B, H * HD]
  const R* k;                     // [B, P, Hkv * HD]: int8 codes or bf16 rows
  const R* v;
  const float* k_scale;           // [B, Hkv, P] (int8 rings; unused for bf16)
  const float* v_scale;
  const int* slot_pos;            // [B, P]
  const int* q_pos;               // [B]
  const __nv_bfloat16* xk;        // [B, Sx, Hkv * HD]
  const __nv_bfloat16* xv;
  const int* x_pos;               // [B, Sx]
  const int* n_valid;
  float* o_part;                  // [B, H, n_ring_splits + 1, HD]
  float* m_part;                  // [B, H, n_ring_splits + 1]
  float* l_part;
  int P, Sx, H, Hkv, n_ring_splits, window;
  float scale;
};

// One block's split: `count` rows of element type T (int8 codes with per-row
// scales ksb / vsb, or bf16 rows, the float ring's or the extra columns,
// with unit scales) from kb / vb
// (kv head h's lanes, rows `stride` elements apart), positions `pos`. qb: the
// group's G query heads. Writes the split's (m, l, O) of each query head at
// part0 + g * n_parts.
//
// Products in the transposed shape: S^T = K Q^T with a tile's 16 slots as
// the m rows (A = K by ldmatrix) and the query heads as the n columns (B =
// q, padded to 8), then O^T = V^T P^T with head lanes as the m rows (A = V
// by ldmatrix.trans) and P^T as B (the S^T fragments transposed by
// movmatrix). A lane holds slots g and g + 8 of heads 2t and 2t + 1; each
// head's max over the tile's slots takes three shuffles.
template <typename T, int HD, typename R>
__device__ __forceinline__ void dec_attend(const DecArgs<R>& a, DecSmem<R, HD>& sm,
                                           const __nv_bfloat16* __restrict__ qb, int G,
                                           const T* __restrict__ kb, const T* __restrict__ vb,
                                           int stride, const int* __restrict__ pos,
                                           const float* __restrict__ ksb,
                                           const float* __restrict__ vsb, int count, int qp,
                                           int lo, size_t part0, int n_parts) {
  constexpr bool kCodes = sizeof(T) == 1;
  constexpr int RB = HD * (int)sizeof(T);            // bytes of a K or V row
  constexpr int CPR = RB / 16;                        // its 16-byte chunks
  constexpr int EPC = 16 / (int)sizeof(T);            // elements per chunk
  constexpr int kStageBytes = 2 * kTile * RB;
  constexpr int kStages = DecSmem<R, HD>::kWarpBytes / kStageBytes;
  constexpr int NK = HD / 16;                         // k-steps of S^T; m-tiles of O^T
  static_assert(kStages >= 1 && kStages <= DecSmem<R, HD>::kStages, "stages fit the block's");
  static_assert(kMaxGroup * HD * 4 <= DecSmem<R, HD>::kWarpBytes,
                "the warps' O fits in their tiles' bytes");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  int8_t* stages = sm.tiles[warp];
  const float scale_l2 = a.scale * kLog2e;

  // q as B fragments (head g; zero past G). For code tiles the k order is
  // permuted within each 16 lanes so that b0 / b1 hold lanes 4t .. 4t+3,
  // the 4 codes of one ldmatrix word of K; bf16 tiles keep the plain order
  // (b0 = lanes 2t, 2t+1; b1 = 2t+8, 2t+9).
  uint32_t qf[NK][2];
  {
    const __nv_bfloat16* qr = qb + (size_t)min(g, G - 1) * HD;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t w0 = 0u, w1 = 0u;
      if (g < G) {
        if (kCodes) {
          const uint2 w = *reinterpret_cast<const uint2*>(qr + 16 * kk + 4 * t);
          w0 = w.x;
          w1 = w.y;
        } else {
          w0 = *reinterpret_cast<const uint32_t*>(qr + 16 * kk + 2 * t);
          w1 = *reinterpret_cast<const uint32_t*>(qr + 16 * kk + 8 + 2 * t);
        }
      }
      qf[kk][0] = w0;
      qf[kk][1] = w1;
    }
  }

  const int n_tiles = (count + kTile - 1) / kTile;
  const int mine = warp < n_tiles ? (n_tiles - warp + kWarps - 1) / kWarps : 0;

  // Start this warp's i-th tile (tile warp + 4 i of the split) into stage
  // i % kStages. Rows past `count` are zero-filled without a global read,
  // their positions invalid and their scales 0.
  auto issue = [&](int i) {
    const int j0 = (warp + i * kWarps) * kTile;
    const int n = min(kTile, count - j0);
    const int s = i % kStages;
    int8_t* st = stages + s * kStageBytes;
#pragma unroll
    for (int idx = lane; idx < 2 * kTile * CPR; idx += 32) {
      const int which = idx / (kTile * CPR);
      const int j = (idx / CPR) % kTile;
      const int c = idx % CPR;
      const T* src = (which ? vb : kb) + (size_t)(j0 + min(j, n - 1)) * stride + c * EPC;
      cp_async16(st + which * kTile * RB + chunk_off<RB>(j, c), src, j < n ? 16 : 0);
    }
    if (lane < kTile) {
      const int j = lane;
      if (j < n) {
        cp_async4(&sm.pos[warp][s][j], pos + j0 + j);
        if (kCodes) {
          cp_async4(&sm.ks[warp][s][j], ksb + j0 + j);
          cp_async4(&sm.vs[warp][s][j], vsb + j0 + j);
        } else {
          sm.ks[warp][s][j] = sm.vs[warp][s][j] = 1.f;
        }
      } else {
        sm.pos[warp][s][j] = kPosInvalid;
        sm.ks[warp][s][j] = sm.vs[warp][s][j] = 0.f;
      }
    }
  };

  // O^T: m-tile mt holds 16 head lanes (rows g, g + 8) x heads 2t, 2t + 1
  float o[NK][4];
#pragma unroll
  for (int mt = 0; mt < NK; ++mt) o[mt][0] = o[mt][1] = o[mt][2] = o[mt][3] = 0.f;
  float m_run[2] = {0.5f * kNeg, 0.5f * kNeg};     // heads 2t, 2t + 1
  float l_run[2] = {0.f, 0.f};

#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (s < mine) issue(s);
    cp_async_commit();
  }
  for (int i = 0; i < mine; ++i) {
    cp_async_wait<kStages - 1>();        // tile i landed (this lane's copies) ...
    __syncwarp();                        // ... and every lane's
    const int s = i % kStages;
    const int8_t* kt = stages + s * kStageBytes;
    const int8_t* vt = kt + kTile * RB;

    // S^T = K Q^T: rows g, g + 8 = the tile's slots, columns 2t, 2t + 1 = heads
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
    const int kr = (lane & 7) + ((lane >> 3) & 1) * 8;     // ldmatrix row of this lane
    if constexpr (kCodes) {
      // matrices (slots 0-7 | 8-15) x chunks c0, c0 + 1: chunk = k-step
#pragma unroll
      for (int c0 = 0; c0 < CPR; c0 += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kt + chunk_off<RB>(kr, c0 + (lane >> 4)));
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint2 lo8 = int8x4_to_bf16_pairs<0, 1, 2, 3>(kf[2 * r]);       // slot g
          const uint2 hi8 = int8x4_to_bf16_pairs<0, 1, 2, 3>(kf[2 * r + 1]);   // slot g + 8
          const uint32_t af[4] = {lo8.x, hi8.x, lo8.y, hi8.y};
          mma_bf16(sc, af, qf[c0 + r][0], qf[c0 + r][1]);
        }
      }
    } else {
      // k-step kk = chunks 2 kk (lanes 16 kk ..) and 2 kk + 1 (.. + 8)
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kt + chunk_off<RB>(kr, 2 * kk + (lane >> 4)));
        mma_bf16(sc, kf, qf[kk][0], qf[kk][1]);
      }
    }
    // scale (base 2, ks_j) and mask per slot (one query position per
    // stream); each head's max over the 16 slots: lanes of one t
    const int* cpos = sm.pos[warp][s];
    const float* cks = sm.ks[warp][s];
    const float* cvs = sm.vs[warp][s];
    float mx[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {                        // slot g + 8 e
      const int j = g + 8 * e;
      const int p = cpos[j];
      const bool ok = p >= 0 && p <= qp && p >= lo;
      const float f = scale_l2 * cks[j];
      sc[2 * e] = ok ? sc[2 * e] * f : kNeg;
      sc[2 * e + 1] = ok ? sc[2 * e + 1] * f : kNeg;
    }
    float alpha[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {                        // head 2t + c
      mx[c] = fmaxf(sc[c], sc[2 + c]);
      mx[c] = fmaxf(mx[c], __shfl_xor_sync(0xffffffffu, mx[c], 4));
      mx[c] = fmaxf(mx[c], __shfl_xor_sync(0xffffffffu, mx[c], 8));
      mx[c] = fmaxf(mx[c], __shfl_xor_sync(0xffffffffu, mx[c], 16));
      const float m_new = fmaxf(m_run[c], mx[c]);
      alpha[c] = ex2(m_run[c] - m_new);
      m_run[c] = m_new;
    }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
      l_run[0] *= alpha[0];
      l_run[1] *= alpha[1];
#pragma unroll
      for (int mt = 0; mt < NK; ++mt) {
        o[mt][0] *= alpha[0];
        o[mt][1] *= alpha[1];
        o[mt][2] *= alpha[0];
        o[mt][3] *= alpha[1];
      }
    }
    // p = round_bf16(e * vs_j); l sums e. P^T's B fragments: the packed
    // (slot, head) pairs transposed to (head, slot) pairs.
    uint32_t pb[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float v_s = cvs[g + 8 * e];
      float pe[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float ex = ex2(sc[2 * e + c] - m_run[c]);
        l_run[c] += ex;
        pe[c] = ex * v_s;
      }
      pb[e] = movmatrix_trans(pack_bf16x2(pe[0], pe[1]));
    }
    // O^T += V^T P^T
    if constexpr (kCodes) {
      // matrices (slots 0-7 | 8-15) x chunks c0, c0 + 1, transposed: a
      // lane's word holds lanes 2g, 2g+1 of slots 2t, 2t+1 (or 2t+8, 2t+9);
      // m-tile c = chunk c, its row g lane 16c + 2g, row g + 8 lane 16c + 2g + 1
#pragma unroll
      for (int c0 = 0; c0 < CPR; c0 += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vt + chunk_off<RB>(kr, c0 + (lane >> 4)));
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint2 lo8 = int8x4_to_bf16_pairs<0, 2, 1, 3>(vf[2 * r]);       // slots 2t, 2t+1
          const uint2 hi8 = int8x4_to_bf16_pairs<0, 2, 1, 3>(vf[2 * r + 1]);   // 2t+8, 2t+9
          const uint32_t af[4] = {lo8.x, lo8.y, hi8.x, hi8.y};
          mma_bf16(o[c0 + r], af, pb[0], pb[1]);
        }
      }
    } else {
      // m-tile mt: rows g, g + 8 = lanes 16 mt + g, 16 mt + 8 + g
      const int vr = (lane & 7) + (lane >> 4) * 8;        // slot row of this lane
#pragma unroll
      for (int mt = 0; mt < NK; ++mt) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vt + chunk_off<RB>(vr, 2 * mt + ((lane >> 3) & 1)));
        mma_bf16(o[mt], vf, pb[0], pb[1]);
      }
    }
    __syncwarp();                          // stage s is free again
    if (i + kStages < mine) issue(i + kStages);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // The warps' (m, l, O) merge in shared memory, in warp order.
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    l_run[c] += __shfl_xor_sync(0xffffffffu, l_run[c], 4);
    l_run[c] += __shfl_xor_sync(0xffffffffu, l_run[c], 8);
    l_run[c] += __shfl_xor_sync(0xffffffffu, l_run[c], 16);
  }
  __syncthreads();                         // every warp is done with its tiles
  float* red = reinterpret_cast<float*>(sm.tiles[0]);   // [kWarps][G][HD]
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int hh = 2 * t + c;
    if (hh < G) {
      if (g == 0) {
        sm.m[warp][hh] = m_run[c];
        sm.l[warp][hh] = l_run[c];
      }
      float* orow = red + ((size_t)warp * G + hh) * HD;
#pragma unroll
      for (int mt = 0; mt < NK; ++mt) {
        orow[kCodes ? 16 * mt + 2 * g : 16 * mt + g] = o[mt][c];
        orow[kCodes ? 16 * mt + 2 * g + 1 : 16 * mt + 8 + g] = o[mt][2 + c];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * HD; i += kWarps * 32) {
    const int r = i / HD, d = i % HD;
    float mx = 0.5f * kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm.m[w][r]);
    float den = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = ex2(sm.m[w][r] - mx);
      den = fmaf(f, sm.l[w][r], den);
      acc = fmaf(f, red[((size_t)w * G + r) * HD + d], acc);
    }
    const size_t part = part0 + (size_t)r * n_parts;
    a.o_part[part * HD + d] = acc;
    if (d == 0) {
      a.m_part[part] = mx;
      a.l_part[part] = den;
    }
  }
}

// One block: stream b, kv head h with all its query heads, one split of
// kSplit ring slots (or the extra columns, the last split index). R: the
// ring's element type, int8 codes (with scales) or bf16 rows.
template <typename R, int HD>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
ring_dec_mma_kernel(const DecArgs<R> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DecSmem<R, HD>& sm = *reinterpret_cast<DecSmem<R, HD>*>(smem_raw);
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Hkv;
  const int kv_dim = a.Hkv * HD;
  const int n_parts = a.n_ring_splits + 1;
  const size_t part0 = ((size_t)b * a.H + h * G) * n_parts + split;
  const bool ring_rows = split < a.n_ring_splits;
  int start = 0;
  int count = a.Sx;
  if (ring_rows) {
    const int nv = min(*a.n_valid, a.P);
    start = split * kSplit;
    if (start >= nv) return;              // past the filled prefix
    count = min(kSplit, nv - start);
  }
  const int qp = a.q_pos[b];
  if (qp < 0) {                           // no column can pass the mask
    for (int i = threadIdx.x; i < G * HD; i += kWarps * 32) {
      const size_t part = part0 + (size_t)(i / HD) * n_parts;
      a.o_part[part * HD + i % HD] = 0.f;
      if (i % HD == 0) {
        a.m_part[part] = 0.5f * kNeg;
        a.l_part[part] = 0.f;
      }
    }
    return;
  }
  const int lo = qp - (a.window - 1);
  const __nv_bfloat16* qb = a.q + ((size_t)b * a.H + h * G) * HD;
  if (ring_rows) {
    const size_t row0 = (size_t)b * a.P + start;
    const size_t col = row0 * kv_dim + h * HD;
    const size_t sc0 = ((size_t)b * a.Hkv + h) * a.P + start;
    const bool codes = sizeof(R) == 1;                  // bf16 rings: unit scales
    dec_attend<R, HD>(a, sm, qb, G, a.k + col, a.v + col, kv_dim, a.slot_pos + row0,
                      codes ? a.k_scale + sc0 : nullptr, codes ? a.v_scale + sc0 : nullptr,
                      count, qp, lo, part0, n_parts);
  } else {
    const size_t row0 = (size_t)b * a.Sx;
    const size_t col = row0 * kv_dim + h * HD;
    dec_attend<__nv_bfloat16, HD>(a, sm, qb, G, a.xk + col, a.xv + col, kv_dim,
                                  a.x_pos + row0, nullptr, nullptr, count, qp, lo, part0,
                                  n_parts);
  }
}

// Merge the splits of one (stream, query head) per warp, in split order
// (ring splits below nv, then the extra columns). Each lane owns HD / 32
// output lanes; the partials of up to kMergeBatch splits are loaded at
// once, so a row costs two memory latencies (the maxima, then everything
// else) rather than one per split.
constexpr int kMergeWarps = 8;
constexpr int kMergeBatch = 16;

template <int HD>
__global__ void __launch_bounds__(kMergeWarps * 32)
ring_dec_merge_kernel(const float* __restrict__ o_part, const float* __restrict__ m_part,
                      const float* __restrict__ l_part, const int* __restrict__ n_valid,
                      __nv_bfloat16* __restrict__ out, int P, int rows, int n_ring_splits,
                      int has_extra) {
  constexpr int V = HD / 32;
  using Vec = typename std::conditional<V == 4, float4, float2>::type;
  const int row = blockIdx.x * kMergeWarps + (threadIdx.x >> 5);   // b * H + hq
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int nv = min(max(*n_valid, 0), P);
  const int n_act = (nv + kSplit - 1) / kSplit;
  const int n = n_act + has_extra;
  const size_t base = (size_t)row * (n_ring_splits + 1);
  auto part = [&](int s) { return base + (s < n_act ? s : n_ring_splits); };
  float mx = 0.5f * kNeg;
  for (int s = lane; s < n; s += 32) mx = fmaxf(mx, m_part[part(s)]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float acc[V] = {};
  float den = 0.f;
  for (int s0 = 0; s0 < n; s0 += kMergeBatch) {
    Vec ov[kMergeBatch];
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u)
      if (s0 + u < n) ov[u] = *reinterpret_cast<const Vec*>(o_part + part(s0 + u) * HD + lane * V);
    const int s = s0 + lane % kMergeBatch;         // lane u holds split s0 + u's weight
    const float w = s < n ? ex2(m_part[part(s)] - mx) : 0.f;
    const float wl = s < n ? w * l_part[part(s)] : 0.f;
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u) {
      if (s0 + u >= n) break;
      const float wu = __shfl_sync(0xffffffffu, w, u);
      den += __shfl_sync(0xffffffffu, wl, u);
      const float* o = reinterpret_cast<const float*>(&ov[u]);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = fmaf(wu, o[e], acc[e]);
    }
  }
  const float inv = 1.f / fmaxf(den, 1e-30f);
#pragma unroll
  for (int e = 0; e < V; ++e) out[(size_t)row * HD + lane * V + e] = __float2bfloat16(acc[e] * inv);
}

template <typename R, int HD>
int launch_dec_mma(const DecArgs<R>& a, __nv_bfloat16* out, int B, cudaStream_t stream) {
  constexpr size_t smem = sizeof(DecSmem<R, HD>);
  static bool raised[64] = {};              // the shared-memory limit, per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !raised[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        ring_dec_mma_kernel<R, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised[dev] = true;
  }
  const int has_extra = a.Sx > 0 ? 1 : 0;
  ring_dec_mma_kernel<R, HD><<<dim3(a.n_ring_splits + has_extra, a.Hkv, B), kWarps * 32,
                               smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = B * a.H;
  ring_dec_merge_kernel<HD><<<(rows + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32, 0,
                              stream>>>(a.o_part, a.m_part, a.l_part, a.n_valid, out, a.P,
                                        rows, a.n_ring_splits, has_extra);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename R, int HD>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* slot_pos, const void* q_pos,
           const void* xk, const void* xv, const void* x_pos, const void* n_valid,
           void* o_part, void* m_part, void* l_part, void* out, int B, int P, int Sx,
           int H, int Hkv, int window, float scale, cudaStream_t stream) {
  const int n_ring_splits = (P + kSplit - 1) / kSplit;
  const int has_extra = Sx > 0 ? 1 : 0;
  const int G = H / Hkv;
  const int gblocks = (G + kGroupBlock - 1) / kGroupBlock;
  const dim3 grid(n_ring_splits + has_extra, Hkv * gblocks, B);
  ring_partial_kernel<T, R, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const R*>(k), static_cast<const R*>(v),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
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

template <typename T, typename R>
int launch_hd(int head_dim, const void* q, const void* k, const void* v,
              const void* k_scale, const void* v_scale, const void* slot_pos,
              const void* q_pos, const void* xk, const void* xv, const void* x_pos,
              const void* n_valid, void* o_part, void* m_part, void* l_part, void* out,
              int B, int P, int Sx, int H, int Hkv, int window, float scale,
              cudaStream_t stream) {
#define VOX_HD_CASE(N)                                                               \
  case N:                                                                            \
    return launch<T, R, N>(q, k, v, k_scale, v_scale, slot_pos, q_pos, xk, xv, x_pos, \
                           n_valid, o_part, m_part, l_part, out, B, P, Sx, H, Hkv,   \
                           window, scale, stream);
  switch (head_dim) {
    VOX_HD_CASE(64)
    VOX_HD_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VOX_HD_CASE
}

template <typename T>
int launch_ring(int ring, int head_dim, const void* q, const void* k, const void* v,
                const void* k_scale, const void* v_scale, const void* slot_pos,
                const void* q_pos, const void* xk, const void* xv, const void* x_pos,
                const void* n_valid, void* o_part, void* m_part, void* l_part,
                void* out, int B, int P, int Sx, int H, int Hkv, int window,
                float scale, cudaStream_t stream) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  // bf16 q takes the tensor cores (ring_gqa_attention_mma_launch), except
  // on float rings with more query heads per kv head than one n-tile holds
  if (ring == 0 && (kF32 || H / Hkv > kMaxGroup))
    return launch_hd<T, T>(head_dim, q, k, v, k_scale, v_scale, slot_pos, q_pos, xk, xv,
                           x_pos, n_valid, o_part, m_part, l_part, out, B, P, Sx, H,
                           Hkv, window, scale, stream);
  if (ring == 1 && kF32)
    return launch_hd<T, int8_t>(head_dim, q, k, v, k_scale, v_scale, slot_pos, q_pos, xk, xv,
                                x_pos, n_valid, o_part, m_part, l_part, out, B, P, Sx, H, Hkv,
                                window, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename R>
int launch_mma(int head_dim, const void* q, const void* k, const void* v, const void* k_scale,
               const void* v_scale, const void* slot_pos, const void* q_pos, const void* xk,
               const void* xv, const void* x_pos, const void* n_valid, void* o_part,
               void* m_part, void* l_part, void* out, int B, int P, int Sx, int H, int Hkv,
               int window, float scale, cudaStream_t stream) {
  const DecArgs<R> a{static_cast<const __nv_bfloat16*>(q), static_cast<const R*>(k),
                     static_cast<const R*>(v), static_cast<const float*>(k_scale),
                     static_cast<const float*>(v_scale), static_cast<const int*>(slot_pos),
                     static_cast<const int*>(q_pos), static_cast<const __nv_bfloat16*>(xk),
                     static_cast<const __nv_bfloat16*>(xv), static_cast<const int*>(x_pos),
                     static_cast<const int*>(n_valid), static_cast<float*>(o_part),
                     static_cast<float*>(m_part), static_cast<float*>(l_part), P, Sx, H, Hkv,
                     (P + kSplit - 1) / kSplit, window, scale};
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (head_dim == 64) return launch_dec_mma<R, 64>(a, o, B, stream);
  if (head_dim == 128) return launch_dec_mma<R, 128>(a, o, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, extra columns and out alike).
// ring: 0 = K/V rings in q's dtype (K1); 1 = int8 rings with f32 scales
// k_scale/v_scale [B, Hkv, P] (K1-int8). The CUDA cores: f32 q on either
// ring, and bf16 q on float rings whose group H / Hkv is above 8; other bf16
// calls take ring_gqa_attention_mma_launch. Pointers are device pointers;
// n_valid is a device int32 scalar. The partial buffers hold
// [B, H, ceil(P / kSplit) + 1] entries (x HD for o_part), kSplit = 256; Sx
// must not exceed kSplit. head_dim is 64 or 128. Returns the CUDA error code
// of the launches (0 = launched).
int ring_gqa_attention_launch(int dtype, int ring, int head_dim, const void* q,
                              const void* k, const void* v, const void* k_scale,
                              const void* v_scale, const void* slot_pos,
                              const void* q_pos, const void* xk, const void* xv,
                              const void* x_pos, const void* n_valid, void* o_part,
                              void* m_part, void* l_part, void* out, int B, int P,
                              int Sx, int H, int Hkv, int window, float scale,
                              void* stream) {
  if (Sx > kSplit || Hkv <= 0 || H % Hkv != 0 || B <= 0 || P <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_ring<float>(ring, head_dim, q, k, v, k_scale, v_scale, slot_pos, q_pos,
                              xk, xv, x_pos, n_valid, o_part, m_part, l_part, out, B, P,
                              Sx, H, Hkv, window, scale, s);
  if (dtype == 1)
    return launch_ring<__nv_bfloat16>(ring, head_dim, q, k, v, k_scale, v_scale,
                                      slot_pos, q_pos, xk, xv, x_pos, n_valid, o_part,
                                      m_part, l_part, out, B, P, Sx, H, Hkv, window,
                                      scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// bf16 q on the tensor cores: ring 0 = bf16 float rings (K1; k_scale and
// v_scale unused), 1 = int8 rings with scales (K1-int8). Other arguments as
// ring_gqa_attention_launch's with dtype 1 (the partial buffers hold
// ceil(P / kSplit) + 1 splits), plus split_slots, which must be kSplit (the
// wrapper's plan and the kernel agree on it). The group H / Hkv is at most 8.
int ring_gqa_attention_mma_launch(int ring, int head_dim, const void* q, const void* k,
                                  const void* v, const void* k_scale, const void* v_scale,
                                  const void* slot_pos, const void* q_pos, const void* xk,
                                  const void* xv, const void* x_pos, const void* n_valid,
                                  void* o_part, void* m_part, void* l_part, void* out, int B,
                                  int P, int Sx, int H, int Hkv, int window, float scale,
                                  int split_slots, void* stream) {
  if (split_slots != kSplit || Sx < 0 || Sx > kSplit || Hkv <= 0 || H % Hkv != 0 ||
      H / Hkv > kMaxGroup || B <= 0 || P <= 0 || B > 65535 || Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ring == 0)
    return launch_mma<__nv_bfloat16>(head_dim, q, k, v, k_scale, v_scale, slot_pos, q_pos,
                                     xk, xv, x_pos, n_valid, o_part, m_part, l_part, out, B,
                                     P, Sx, H, Hkv, window, scale, s);
  if (ring == 1)
    return launch_mma<int8_t>(head_dim, q, k, v, k_scale, v_scale, slot_pos, q_pos, xk, xv,
                              x_pos, n_valid, o_part, m_part, l_part, out, B, P, Sx, H, Hkv,
                              window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
