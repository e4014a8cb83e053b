// Tensor-core and asynchronous-copy building blocks shared by the port's
// mma.sync kernels (ring_attention.cu, ring_attention_enc.cu,
// logits_argmax.cu, w8a16.cu, bf16_matmul.cu, layout_attention.cu): the
// m16n8k16 bf16 product with an f32 accumulator, ldmatrix (plain and
// transposed), cp.async with its group waits, two exact int8 -> bf16
// conversions and one exact int4 (nibble) -> bf16 conversion, the
// in-register 8 x 8 transpose and one-instruction 2^x.
//
// Fragment layout of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row major) a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
//     a3 = (g+8, 2t+8..); B (16 x 8) b0 = (2t..2t+1, g), b1 = (2t+8..2t+9, g);
//   C (16 x 8, f32) c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1).
// Each pair is one 32-bit register, the lower index in the low half.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_common {

// c += a b: bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 (16 bytes), and receives row l / 4, elements 2 (l % 4) and 2 (l % 4) + 1
// of each matrix in r[0..3].
// (The address as a pointer or as a shared-space address.)
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  ldmatrix_x4(r, smem_addr(p));
}

// The same, each matrix transposed: lane l receives column l / 4, rows
// 2 (l % 4) and 2 (l % 4) + 1.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  ldmatrix_x4_trans(r, smem_addr(p));
}

// 16 bytes global -> shared, not kept in L1; `bytes` < 16 zero-fills the
// rest (0: no global read at all, `src` only needs to be a valid address).
// The destination as a pointer or as a shared-space address (smem_addr).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes = 16) {
  cp_async16(smem_addr(dst), src, bytes);
}

// 4 bytes global -> shared
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 4 int8 codes (one word) -> bf16 pairs (codes 0, 1) and (2, 3), exact:
// each byte biased to code + 128 lands in the mantissa of 2^23 (a byte
// permute), and one f32 subtraction of 2^23 + 128 leaves the code; no
// int-to-float convert.
__device__ __forceinline__ uint2 int8x4_to_bf16(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) - 8388736.f;
  return make_uint2(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]));
}

// 4 int8 codes (code i in byte i) -> the bf16 pairs (I0, I1) and (I2, I3),
// exact, in 8 instructions per word: 128 + (code & 127) is a bf16 whose
// mantissa holds those bits, 128 + (code & 128) one whose exponent holds the
// sign bit (128 or 256), both built by a byte permute, and one bf16x2
// subtraction per pair leaves the code.
template <int I0, int I1, int I2, int I3>
__device__ __forceinline__ uint2 int8x4_to_bf16_pairs(uint32_t w) {
  const uint32_t mag = w & 0x7F7F7F7Fu, sgn = w & 0x80808080u;
  auto pair = [&](uint32_t sel) {
    uint32_t x = __byte_perm(mag, 0x43434343u, sel), y = __byte_perm(sgn, 0x43434343u, sel);
    __nv_bfloat162 d = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&x),
                               *reinterpret_cast<__nv_bfloat162*>(&y));
    return *reinterpret_cast<uint32_t*>(&d);
  };
  return make_uint2(pair(0x4040 | I0 | (I1 << 8)), pair(0x4040 | I2 | (I3 << 8)));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}

// The low and the high nibbles of a packed int4 word (4 bytes, each two
// signed nibbles), each biased to nibble + 8 in the low half of a byte: the
// input of nibbles_to_bf16. The XOR is shared when both are taken.
__device__ __forceinline__ uint32_t lo_nibbles(uint32_t w) {
  return (w ^ 0x88888888u) & 0x0F0F0F0Fu;
}

__device__ __forceinline__ uint32_t hi_nibbles(uint32_t w) {
  return ((w ^ 0x88888888u) >> 4) & 0x0F0F0F0Fu;
}

// 4 signed nibbles, biased to nibble + 8 in the low half of each byte of
// u -> bf16 pairs (0, 1) and (2, 3), exact: 128 + u is a bf16 with the byte
// in its mantissa (a byte permute), minus 136 (one bf16x2 subtraction).
__device__ __forceinline__ uint2 nibbles_to_bf16(uint32_t u) {
  const __nv_bfloat162 bias = as_bf2(0x43084308u);                // 136, 136
  return make_uint2(as_u32(__hsub2(as_bf2(__byte_perm(u, 0x43u, 0x4140)), bias)),
                    as_u32(__hsub2(as_bf2(__byte_perm(u, 0x43u, 0x4342)), bias)));
}

// An 8 x 8 b16 matrix held as mma fragments (lane l: row l / 4, elements
// 2 (l % 4) and 2 (l % 4) + 1) -> its transpose, in the same layout.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// 2^x in one MUFU instruction (2 ulp; 0 for x below -126, as the masked
// columns' -5e29 needs)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace mma_common
