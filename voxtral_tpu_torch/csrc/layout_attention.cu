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
//     q[:, 64:] . hi^T); e = exp(s - max_p s) rounded to bf16; out = e . v
//     summed in f32, stored as bf16. No 1/sqrt(hd), no normalisation:
//     values reach P * 127, as in the tool.
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
// Two designs.
//
// T4, T6, T7 on the CUDA cores (`attend`): one block of 256 threads per (kv
// head, stream), all P slots in one pass, no merge.
//   * A slot's K/V row is 128 bytes in every layout: 8 neighbouring threads
//     read it with one 16-byte load each, so a warp's load touches whole
//     128-byte segments; 4 slots in flight per thread. The layouts differ
//     only in the row stride (kv_dim against blk) and the head's offset.
//   * Codes become f32 by a byte permute into 2^23 + code and one subtract
//     (exact, no int-to-float conversion, whose rate on this card is a
//     quarter of the FMA rate).
//   * Each thread keeps its 16 lanes of the 4 query rows in registers; the 8
//     threads of a slot add their partial dots by a reduce-scatter over
//     shuffles that leaves each with one row's sum.
//   * T6/T7 first stage the mask and both scale rows in shared memory, and
//     issue each step's K/V loads during the previous step's arithmetic.
//     Pass 1 writes the P x 4 f32 scores to shared memory (33 KB at P 2088:
//     dynamic shared memory); a block reduction gives the row max (and den),
//     and e (T6/T7: e * vs) is rounded to bf16 in place; pass 2 reads V
//     once and accumulates e . v in f32 registers, reduced over the block
//     by shuffles and shared memory. T6/T7 skip the K and V rows of masked
//     slots (their e is 0): the bytes a call needs follow its mask.
//
// T5 on the tensor cores (`attn4_mma_kernel`). On the CUDA cores T5 ran at
// 0.34 of its bound: 256 blocks of one (stream, head) each in two serial
// waves, no loads in flight during the arithmetic, and every nibble turned
// into f32 for 8 FMAs and shuffles. Here:
//   * mma.sync m16n8k16 in K1-int8's transposed shape: S^T = K Q^T with a
//     16-slot tile as the m rows and the 4 query rows as n (padded to 8),
//     then O^T = V^T P^T with head lanes as the m rows. The low and high
//     nibbles are the two 64-lane halves of one 128-deep product (8
//     k-steps), so the f32 order differs from the tool's "lo dot, then hi
//     dot"; the tool's own check allows it (T5_CHECK_RTOL).
//   * Codes go from shared memory into fragments without a store: each
//     32-bit word of packed bytes gives its low and its high nibbles as bf16
//     pairs, exact, by a mask, byte permutes and one bf16x2 subtraction
//     (mma_common::nibbles_to_bf16; no int-to-float convert, no f32 FMA on
//     a lane). K: a lane reads 16 bytes of slot g and of slot g + 8, whose
//     words i give k-steps (i, lo) and (i, hi); q's k order is permuted to
//     match once per block. V: a lane reads 8 bytes of each of slots 2t,
//     2t + 1, 2t + 8, 2t + 9; a byte permute interleaves each slot pair, so
//     a converted pair holds one head lane of two slots, as A = V^T needs.
//     The 8 m-tiles' rows are head lanes 8g + 4hb + 2sel + 64nib (+1).
//   * Bytes in flight at all times: every warp streams its stages of two
//     tiles (32 slots: stage warp + 4 i of the block's share; all K stages,
//     then all V stages) by 16-byte cp.async.cg into its own ring of 3 and
//     waits with __syncwarp only, so 4 KB a warp are in flight while it
//     computes; the V stages start while the last K stages are scored and
//     while the block waits for the global max. A tile's two 64-byte rows
//     per 128-byte line are XOR-swizzled by line, so the K reads (16 bytes)
//     and the V reads (8 bytes) meet no bank conflict.
//   * Split P: the plan (ops/layout_attention.t5_plan) cuts P into fixed
//     shares of whole tiles, one block each: the fewest splits whose blocks
//     cover every SM. Fewer, longer blocks beat more, shorter ones: at the
//     tool's B 32 one split (256 blocks, 3 resident an SM) against two
//     (512), whose per-block fixed costs and mid-kernel cluster barrier
//     cost more than the idle SMs of a ragged wave (PERF.md §6, PR 12). The
//     splits of a (stream, head) are one thread-block cluster (at most 8),
//     so they are resident together. Each block keeps its share's f32
//     scores in shared memory (padded slots -inf); after the score pass the
//     blocks exchange their maxima through distributed shared memory, and
//     e = bf16(exp(s - M)) is rounded against the global M as P^T's
//     fragments are built (2^(s log2 e - M log2 e) by ex2.approx), the
//     tool's one rounding. After the PV pass each block adds its warps' f32
//     partials in warp order, and the splits' partials are added in rank
//     order through distributed shared memory. One launch, no device-memory
//     partials, no counters, no per-call allocation, and the bits do not
//     depend on the order the blocks ran in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "mma_common.cuh"
#include "ring_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace ring_common;
using namespace mma_common;

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

// One 16-byte load of a slot's row -> its 16 int8 codes as f32, exact.
__device__ __forceinline__ void decode(const uint4& w, float* out) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = words[i] ^ 0x80808080u;                       // code + 128
#pragma unroll
    for (int j = 0; j < 4; ++j) out[4 * i + j] = biased(u, j) - 8388736.f;
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

// The body shared by T4, T6 and T7: one (kv head, stream) over P slots.
// k, v: the head's row 0 (its lanes) with `stride` bytes between slots; q:
// the head's 4 query rows (bf16, 128 apart); out: the same lanes of the
// output. Masked: sp, ks, vs point at the stream's [P] rows (ks, vs of this
// head), qpos is the query position.
template <bool kMasked>
__device__ __forceinline__ void attend(const __nv_bfloat16* __restrict__ q,
                                       const int8_t* __restrict__ k,
                                       const int8_t* __restrict__ v, size_t stride, int P,
                                       const int* __restrict__ sp, int qpos,
                                       const float* __restrict__ ks,
                                       const float* __restrict__ vs,
                                       __nv_bfloat16* __restrict__ out) {
  constexpr int kLanes = 16;                    // lanes per thread
  constexpr int kTps = 8;                       // threads per slot
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
  const int lane0 = 16 * li;                    // lanes [16 li, + 16)

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
  // SM.
  constexpr bool kPrefetch = kMasked;
  constexpr int kStep = kRows * kUnroll;
  auto live = [&](int p) { return p < P && (!kMasked || valid[p]); };

  // ---- pass 1: scores -> sc[p][g]
  {
    float qf[kGroup][kLanes];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      load16(q + g * kHd + lane0, &qf[g][0]);
      load16(q + g * kHd + lane0 + 8, &qf[g][8]);
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
        decode(cur[u], x);
        float a[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          float d = 0.f;
#pragma unroll
          for (int l = 0; l < kLanes; ++l) d = fmaf(qf[g][l], x[l], d);
          a[g] = d;
        }
        const int g = ReduceScatter<kGroup, 1, 1, 3>::run(a, lane);
        float s = a[0];
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
      decode(cur[u], x);
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
  const int first = ReduceScatter<kGroup * kLanes, 16, kTps, 2>::run(acc, lane);
  {
    const int g = first / kLanes;
#pragma unroll
    for (int i = 0; i < 16; ++i) red[warp * kGroup * kHd + g * kHd + lane0 + i] = acc[i];
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

// T4. Grid (kv_heads, B). k, v: [B, P, kv_heads * 128] int8; q, out: bf16
// [B, 1, kv_heads * 512].
__global__ void __launch_bounds__(kThreads, 2)
unmasked_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k,
                const int8_t* __restrict__ v, __nv_bfloat16* __restrict__ out, int P) {
  const int h = blockIdx.x, b = blockIdx.y, hkv = gridDim.x;
  const size_t row = static_cast<size_t>(hkv) * kHd;
  const size_t head = static_cast<size_t>(b) * P * row + h * kHd;
  const size_t qo = (static_cast<size_t>(b) * hkv + h) * kGroup * kHd;
  attend<false>(q + qo, k + head, v + head, row, P, nullptr, 0, nullptr, nullptr, out + qo);
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
  attend<true>(q + qo, k + head, v + head, stride, P, sp + static_cast<size_t>(b) * P, qp[b],
               ks + so, vs + so, out + qo);
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

// dynamic shared memory of a block at P slots (= _smem_bytes in
// ops/layout_attention.py): the scores, the PV partials; masked: the
// scale rows and the mask
int smem_bytes(int slots, bool masked) { return slots * 16 + kRedBytes + (masked ? 9 * slots : 0); }

// ---------------------------------------------------------------------------
// T5 on the tensor cores.
// ---------------------------------------------------------------------------

constexpr int kT5Warps = 4;
constexpr int kT5Threads = 32 * kT5Warps;
constexpr int kT5Tile = 16;                       // slots of an mma tile; = _T5_TILE
constexpr int kT5Row = kHd / 2;                   // bytes of a packed slot-head row
constexpr int kT5TileBytes = kT5Tile * kT5Row;    // 1 KB
constexpr int kT5Sub = 2;                         // tiles per stage
constexpr int kT5StageSlots = kT5Sub * kT5Tile;
constexpr int kT5StageBytes = kT5Sub * kT5TileBytes;
constexpr int kT5Stages = 3;                      // stages in each warp's ring
constexpr int kT5MaxSplits = 8;                   // one portable cluster; = _T5_MAX_SPLITS
constexpr int kT5MaxShare = 2096;                 // slots of one split (131 tiles); = _T5_MAX_SHARE
// floats per head row of the scores: room for the last stage's slots past
// the share, and 8 mod 32, so the score stores (slots g, heads 2t, 2t + 1)
// and the P^T loads (slots 2t, 2t + 1, head g) meet no bank conflict
constexpr int kT5Covered = (kT5MaxShare + kT5StageSlots - 1) / kT5StageSlots * kT5StageSlots;
constexpr int kT5ScoreRow = (kT5Covered + 31) / 32 * 32 + 8;
constexpr float kLog2e = 1.4426950408889634f;

struct T5Smem {
  // each warp's ring of stages; after both passes, the warps' f32 O
  // partials [warp][head][lane], then the block's (warp 0's place)
  alignas(128) int8_t ring[kT5Warps][kT5Stages][kT5StageBytes];
  float sc[kGroup][kT5ScoreRow];                  // the share's scores [head][slot]
  float wmax[kT5Warps][kGroup];
  float m_blk[kGroup];                            // the block's max, read by its cluster
  float m_all[kGroup];                            // the (stream, head)'s max
};
static_assert(sizeof(T5Smem::ring) >= kT5Warps * kGroup * kHd * 4,
              "the warps' O partials fit in their rings");
static_assert(kT5ScoreRow % 32 == 8 && kT5ScoreRow >= kT5Covered,
              "score rows hold every slot a stage covers");

// Byte offset of 16-byte chunk c (0..3) of row j (0..15) in a tile: rows
// 2L and 2L + 1 form line L (128 bytes, 8 chunks), whose chunk positions are
// XOR-ed with 2 (L % 4). K reads (chunk t of rows g, g + 8; 16 bytes) and V
// reads (rows 2t + e (+ 8), bytes 8g..8g+7) then each cover all 32 banks
// per phase.
__device__ __forceinline__ int t5_off(int j, int c) {
  return (j >> 1) * 128 + 16 * ((((j & 1) << 2) | c) ^ (((j >> 1) & 3) << 1));
}

// Grid (splits, kv_heads, B); SPLIT: the splits of a (stream, head) are one
// cluster along x. Split r covers slots [r share, min(P, (r + 1) share)).
// k, v: packed [B, P, kv_heads * 64]; q, out: bf16 [B, 1, kv_heads * 512].
template <bool SPLIT>
__global__ void __launch_bounds__(kT5Threads, 4)
attn4_mma_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k,
                 const int8_t* __restrict__ v, __nv_bfloat16* __restrict__ out, int P,
                 int share) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T5Smem& sm = *reinterpret_cast<T5Smem*>(smem_raw);
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z, hkv = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int start = split * share;
  const int count = min(share, P - start);       // > 0: the plan leaves no split empty
  const int n_stages = (count + kT5StageSlots - 1) / kT5StageSlots;
  const int mine = warp < n_stages ? (n_stages - warp + kT5Warps - 1) / kT5Warps : 0;
  const int total = 2 * mine;                    // this warp's K stages, then its V stages
  const size_t stride = static_cast<size_t>(hkv) * kT5Row;
  const size_t qo = (static_cast<size_t>(b) * hkv + h) * kGroup * kHd;
  const int8_t* ring = sm.ring[warp][0];

  // This warp's items: its K stages (slots (warp + 4 i) x 32 .. of the
  // share, i < mine), then its V stages, each into ring stage (item %
  // kT5Stages). A lane copies chunk lane % 4 of rows lane / 4 and lane / 4 +
  // 8 of each of a stage's tiles; rows past the share's slots are
  // zero-filled without a global read. `issue` starts the next item.
  const int crow = lane >> 2, cchunk = lane & 3;
  const uint32_t dst0 = smem_addr(ring) + t5_off(crow, cchunk);
  const uint32_t dst1 = smem_addr(ring) + t5_off(crow + 8, cchunk);
  const size_t first = static_cast<size_t>(start + warp * kT5StageSlots + crow) * stride +
                       static_cast<size_t>(h) * kT5Row + 16 * cchunk;
  const int8_t* kb = k + static_cast<size_t>(b) * P * stride;
  const int8_t* vb = v + static_cast<size_t>(b) * P * stride;
  const size_t step = kT5Warps * kT5StageSlots * stride;
  const int room0 = count - (warp * kT5StageSlots + crow);  // the share's rows from this lane's first
  const int8_t* src = kb + first;
  int room = room0, issued = 0;
  uint32_t st = 0;
  auto issue = [&]() {
    if (issued == mine) {                         // the V stages, from the start again
      src = vb + first;
      room = room0;
    }
#pragma unroll
    for (int s = 0; s < kT5Sub; ++s) {
      const int r = room - s * kT5Tile;
      const int8_t* p = src + s * kT5Tile * stride;
      cp_async16(dst0 + st + s * kT5TileBytes, r > 0 ? p : kb, r > 0 ? 16 : 0);
      cp_async16(dst1 + st + s * kT5TileBytes, r > 8 ? p + 8 * stride : kb, r > 8 ? 16 : 0);
    }
    src += step;
    room -= kT5Warps * kT5StageSlots;
    st = st + kT5StageBytes == kT5Stages * kT5StageBytes ? 0 : st + kT5StageBytes;
    ++issued;
  };

#pragma unroll
  for (int s = 0; s < kT5Stages - 1; ++s) {
    if (issued < total) issue();
    cp_async_commit();
  }

  // q as B fragments (head g; zero for the padding heads 4-7): k-step 2i + n
  // holds lanes 64 n + 16 t + 4 i .. + 3, the lanes that word i of a K
  // chunk gives in its low (n = 0) or high (n = 1) nibbles
  uint32_t qf[8][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      uint2 w = make_uint2(0u, 0u);
      if (g < kGroup)
        w = *reinterpret_cast<const uint2*>(q + qo + g * kHd + 64 * n + 16 * t + 4 * i);
      qf[2 * i + n][0] = w.x;
      qf[2 * i + n][1] = w.y;
    }

  // ---- pass 1: S^T = K Q^T, a tile's slots g, g + 8 x heads 2t, 2t + 1
  float m_run[2] = {-INFINITY, -INFINITY};        // heads 2t, 2t + 1 (t < 2)
  const int8_t* k_rd0 = ring + t5_off(g, t);      // this lane's K chunks in stage 0
  const int8_t* k_rd1 = ring + t5_off(g + 8, t);
  float* sc_wr = &sm.sc[2 * (t & 1)][warp * kT5StageSlots + g];   // t < 2: heads 2t, 2t + 1
  int rd = 0, j = warp * kT5StageSlots + g;       // the stage read; slot g of its first tile
  for (int i = 0; i < mine; ++i) {
    cp_async_wait<kT5Stages - 2>();             // item i landed (this lane's copies) ...
    __syncwarp();                               // ... and every lane's; stage i - 1 is free
    if (issued < total) issue();
    cp_async_commit();
    float c[kT5Sub][4];
#pragma unroll
    for (int s = 0; s < kT5Sub; ++s) {
      const uint4 r0 = *reinterpret_cast<const uint4*>(k_rd0 + rd + s * kT5TileBytes);
      const uint4 r1 = *reinterpret_cast<const uint4*>(k_rd1 + rd + s * kT5TileBytes);
      const uint32_t w0[4] = {r0.x, r0.y, r0.z, r0.w}, w1[4] = {r1.x, r1.y, r1.z, r1.w};
      c[s][0] = c[s][1] = c[s][2] = c[s][3] = 0.f;
#pragma unroll
      for (int wi = 0; wi < 4; ++wi)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const uint2 a0 = nibbles_to_bf16(n ? hi_nibbles(w0[wi]) : lo_nibbles(w0[wi]));  // slot g
          const uint2 a1 = nibbles_to_bf16(n ? hi_nibbles(w1[wi]) : lo_nibbles(w1[wi]));  // g + 8
          const uint32_t af[4] = {a0.x, a1.x, a0.y, a1.y};
          mma_bf16(c[s], af, qf[2 * wi + n][0], qf[2 * wi + n][1]);
        }
    }
    rd = rd + kT5StageBytes == kT5Stages * kT5StageBytes ? 0 : rd + kT5StageBytes;
    if (t < 2) {
#pragma unroll
      for (int s = 0; s < kT5Sub; ++s) {
        const int js = j + s * kT5Tile;
        const bool ok0 = js < count, ok1 = js + 8 < count;
        const float x[4] = {ok0 ? c[s][0] : -INFINITY, ok0 ? c[s][1] : -INFINITY,
                            ok1 ? c[s][2] : -INFINITY, ok1 ? c[s][3] : -INFINITY};
        float* w = sc_wr + s * kT5Tile;
        w[0] = x[0];
        w[kT5ScoreRow] = x[1];
        w[8] = x[2];
        w[kT5ScoreRow + 8] = x[3];
        m_run[0] = fmaxf(m_run[0], fmaxf(x[0], x[2]));
        m_run[1] = fmaxf(m_run[1], fmaxf(x[1], x[3]));
      }
    }
    sc_wr += kT5Warps * kT5StageSlots;
    j += kT5Warps * kT5StageSlots;
  }

  // ---- the global max: warps, then the block, then the cluster's blocks
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
      m_run[c] = fmaxf(m_run[c], __shfl_xor_sync(0xffffffffu, m_run[c], o));
  if (g == 0 && t < 2) {
    sm.wmax[warp][2 * t] = m_run[0];
    sm.wmax[warp][2 * t + 1] = m_run[1];
  }
  __syncthreads();
  if (threadIdx.x < kGroup) {
    float m = sm.wmax[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kT5Warps; ++w) m = fmaxf(m, sm.wmax[w][threadIdx.x]);
    sm.m_blk[threadIdx.x] = m;
  }
  if constexpr (SPLIT) {
    cg::this_cluster().sync();
    if (threadIdx.x < kGroup) {
      float m = -INFINITY;
      for (int r = 0; r < static_cast<int>(gridDim.x); ++r)
        m = fmaxf(m, cg::this_cluster().map_shared_rank(sm.m_blk, r)[threadIdx.x]);
      sm.m_all[threadIdx.x] = m;
    }
  } else {
    __syncthreads();
    if (threadIdx.x < kGroup) sm.m_all[threadIdx.x] = sm.m_blk[threadIdx.x];
  }
  __syncthreads();

  // ---- pass 2: O^T += V^T P^T. m-tile mt = 4 hb + 2 sel + nib holds head
  // lanes d = 8g + 4hb + 2sel + 64nib (row g) and d + 1 (row g + 8) x heads
  // 2t, 2t + 1
  const float mg = g < kGroup ? sm.m_all[g] * kLog2e : 0.f;
  float o[8][4];
#pragma unroll
  for (int mt = 0; mt < 8; ++mt) o[mt][0] = o[mt][1] = o[mt][2] = o[mt][3] = 0.f;
  // this lane's V words in a tile: bytes 8g .. 8g + 7 (word hb: 8g + 4hb ..)
  // of slots 2t + 8p + e; its scores: slots 2t, 2t + 1 (+ 8) of head g
  int v_rd[2][2];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int e = 0; e < 2; ++e) v_rd[p][e] = t5_off(2 * t + 8 * p + e, g >> 1) + 8 * (g & 1);
  const float* sc_rd = &sm.sc[g & 3][warp * kT5StageSlots + 2 * t];
  for (int i = mine; i < total; ++i) {
    cp_async_wait<kT5Stages - 2>();
    __syncwarp();
    if (issued < total) issue();
    cp_async_commit();
#pragma unroll
    for (int s = 0; s < kT5Sub; ++s) {
      const int8_t* tile = ring + rd + s * kT5TileBytes;
      // P^T's B fragments: e of slots 2t, 2t + 1 (b0) and 2t + 8, 2t + 9
      // (b1) of head g, exp(s - M) = 2^(s log2 e - M log2 e), rounded to
      // bf16 once, here
      uint32_t pb[2] = {0u, 0u};
      if (g < kGroup) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const float2 x = *reinterpret_cast<const float2*>(sc_rd + s * kT5Tile + 8 * p);
          pb[p] = pack_bf16x2(ex2(fmaf(x.x, kLog2e, -mg)), ex2(fmaf(x.y, kLog2e, -mg)));
        }
      }
      uint2 vw[2][2];
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int e = 0; e < 2; ++e) vw[p][e] = *reinterpret_cast<const uint2*>(tile + v_rd[p][e]);
#pragma unroll
      for (int hb = 0; hb < 2; ++hb)
#pragma unroll
        for (int sel = 0; sel < 2; ++sel) {
          // each slot pair's bytes interleaved: (lane d, d + 1) x (slot 2t + 8p, + 1)
          uint32_t x[2];
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const uint32_t a = hb ? vw[p][0].y : vw[p][0].x, c = hb ? vw[p][1].y : vw[p][1].x;
            x[p] = __byte_perm(a, c, sel ? 0x7362 : 0x5140);
          }
#pragma unroll
          for (int nib = 0; nib < 2; ++nib) {
            const uint2 a0 = nibbles_to_bf16(nib ? hi_nibbles(x[0]) : lo_nibbles(x[0]));
            const uint2 a1 = nibbles_to_bf16(nib ? hi_nibbles(x[1]) : lo_nibbles(x[1]));
            const uint32_t af[4] = {a0.x, a0.y, a1.x, a1.y};
            mma_bf16(o[4 * hb + 2 * sel + nib], af, pb[0], pb[1]);
          }
        }
    }
    rd = rd + kT5StageBytes == kT5Stages * kT5StageBytes ? 0 : rd + kT5StageBytes;
    sc_rd += kT5Warps * kT5StageSlots;
  }
  cp_async_wait<0>();

  // ---- the warps' partials, added in warp order, then the splits' in rank order
  __syncthreads();                                // every warp is done with its ring
  float* red = reinterpret_cast<float*>(sm.ring);  // [warp][head][lane]
  if (t < 2) {
#pragma unroll
    for (int mt = 0; mt < 8; ++mt) {
      const int d = 8 * g + 4 * (mt >> 2) + 2 * ((mt >> 1) & 1) + 64 * (mt & 1);
      float* r = red + (warp * kGroup + 2 * t) * kHd + d;
      *reinterpret_cast<float2*>(r) = make_float2(o[mt][0], o[mt][2]);
      *reinterpret_cast<float2*>(r + kHd) = make_float2(o[mt][1], o[mt][3]);
    }
  }
  __syncthreads();
  constexpr int kOut = kGroup * kHd;
  for (int e = threadIdx.x; e < kOut; e += kT5Threads) {
    float s = red[e];
#pragma unroll
    for (int w = 1; w < kT5Warps; ++w) s += red[w * kOut + e];
    red[e] = s;
  }
  if constexpr (SPLIT) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int splits = gridDim.x, per = (kOut + splits - 1) / splits;
    const int e_end = min(kOut, (split + 1) * per);
    for (int e = split * per + threadIdx.x; e < e_end; e += kT5Threads) {
      float s = cluster.map_shared_rank(red, 0)[e];
      for (int r = 1; r < splits; ++r) s += cluster.map_shared_rank(red, r)[e];
      out[qo + e] = __float2bfloat16(s);
    }
    cluster.sync();                               // every partial stays until it is read
  } else {
    __syncthreads();
    for (int e = threadIdx.x; e < kOut; e += kT5Threads) out[qo + e] = __float2bfloat16(red[e]);
  }
}

// The dynamic shared memory limit of T5's kernel, raised once per device.
template <bool SPLIT>
cudaError_t prepare_attn4() {
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && raised[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(attn4_mma_kernel<SPLIT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(T5Smem)));
  if (err == cudaSuccess && dev < 64) raised[dev] = true;
  return err;
}

// A launch configuration of T5: a (stream, head)'s splits are one cluster.
cudaLaunchConfig_t attn4_config(cudaLaunchAttribute* attr, dim3 grid, bool split,
                                cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kT5Threads);
  cfg.dynamicSmemBytes = sizeof(T5Smem);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 0;
  if (split) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = grid.x;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.numAttrs = 1;
  }
  return cfg;
}

template <bool SPLIT>
int launch_attn4(const void* q, const void* k, const void* v, void* out, int batch, int slots,
                 int kv_heads, int share, int splits, cudaStream_t st) {
  const cudaError_t err = prepare_attn4<SPLIT>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = attn4_config(attr, dim3(splits, kv_heads, batch), SPLIT, st);
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, attn4_mma_kernel<SPLIT>, static_cast<const __nv_bfloat16*>(q),
      static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
      static_cast<__nv_bfloat16*>(out), slots, share));
}

}  // namespace

extern "C" {

// T4. Device pointers, 16-byte aligned: q, out bf16 [batch, 1, kv_heads *
// 512]; k, v int8 [batch, slots, kv_heads * 128]. Returns the CUDA error
// code of the launch (0 = launched).
int attn8_launch(const void* q, const void* k, const void* v, void* out, int batch, int slots,
                 int kv_heads, void* stream) {
  const int smem = smem_bytes(slots, false);
  if (batch < 1 || batch > 65535 || slots < 1 || kv_heads < 1 || smem > kMaxDynamicSmem ||
      misaligned(q) || misaligned(k) || misaligned(v) || misaligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      cudaFuncSetAttribute(unmasked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  unmasked_kernel<<<dim3(kv_heads, batch), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<__nv_bfloat16*>(out), slots);
  return static_cast<int>(cudaGetLastError());
}

// T5. Device pointers, 16-byte aligned: q, out bf16 [batch, 1, kv_heads *
// 512]; k, v packed int8 [batch, slots, kv_heads * 64]. Split r covers slots
// [r share, (r + 1) share): share a multiple of 16, at most 2096; 1 <=
// splits <= 8, every split non-empty (ops/layout_attention.t5_plan).
// Returns the CUDA error code of the launch (0 = launched).
int attn4_launch(const void* q, const void* k, const void* v, void* out, int batch, int slots,
                 int kv_heads, int share, int splits, void* stream) {
  if (batch < 1 || batch > 65535 || kv_heads < 1 || kv_heads > 65535 || slots < 1 ||
      share < kT5Tile || share % kT5Tile || share > kT5MaxShare || splits < 1 ||
      splits > kT5MaxSplits || (long long)share * splits < slots ||
      (long long)share * (splits - 1) >= slots || misaligned(q) || misaligned(k) ||
      misaligned(v) || misaligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return splits == 1
             ? launch_attn4<false>(q, k, v, out, batch, slots, kv_heads, share, splits, st)
             : launch_attn4<true>(q, k, v, out, batch, slots, kv_heads, share, splits, st);
}

// blocks: T5's blocks resident at once on the current device when a (stream,
// head)'s splits (1..8) form one cluster: whole clusters times their size.
// Returns the CUDA error code (0 = ok).
int attn4_resident_blocks(int splits, int* blocks) {
  if (splits < 1 || splits > kT5MaxSplits) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = splits == 1 ? prepare_attn4<false>() : prepare_attn4<true>();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits == 1) {
    int dev = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, attn4_mma_kernel<false>,
                                                          kT5Threads, sizeof(T5Smem));
    *blocks = per_sm * sms;
    return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = attn4_config(attr, dim3(splits, 1, 1), true, nullptr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, attn4_mma_kernel<true>, &cfg);
  *blocks = clusters * splits;
  return static_cast<int>(err);
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
