// Warp-level tensor-core helpers for Hopper (sm_90a) as inline PTX: the
// bf16 m16n8k16 product with fp32 sums, the int8 m16n8k32 product with
// int32 sums, ldmatrix, 16- and 8-byte cp.async, and
// packing fp32 values into bf16x2 operand registers; with them, the quad
// reductions, the bf16 store of accumulator fragments, and the two steps
// the channel-attention kernels (inference and training) share: a 16-row
// strip of a window's Gram from hi + lo operands, and its row softmax.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 g + t, g = lane / 4,
// t = lane % 4), each register two bf16, the lower column in the low half:
//   A (16 x 16, row-major): a0 (row g, cols 2t, 2t+1), a1 (row g+8, same),
//                           a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, same)
//   B (16 x 8, k x n):      b0 (rows k 2t, 2t+1, col n g), b1 (rows 2t+8, 2t+9)
//   C (16 x 8, fp32):       c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8)
// So the C fragments of two neighbouring n-tiles are, packed to bf16, the A
// fragment of one 16-deep k-step (the FlashAttention-2 register reuse).
//
// ldmatrix x4 lane addresses (row pointers of 16 bytes, lane l): for a
// 16 x 16 tile at (r0, c0) of a row-major bf16 array,
//   A from [m][k]           row r0 + (l & 15),                  col c0 + (l >> 4) * 8
//   A from [k][m], .trans   row r0 + (l & 7) + (l >> 4) * 8,    col c0 + ((l >> 3) & 1) * 8
//   B from [n][k]           row r0 + (l & 7) + (l >> 4) * 8,    col c0 + ((l >> 3) & 1) * 8
//   B from [k][n], .trans   row r0 + (l & 7) + ((l >> 3) & 1) * 8, col c0 + (l >> 4) * 8
// where a B load gives {b0, b1} of the n-tile at c0 (or r0) and then of the
// n-tile 8 further. Rows whose stride is an odd multiple of 16 bytes keep
// the eight rows of each 8 x 8 matrix in distinct banks.
#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>

namespace mstgan {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a b
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b on int8 operands, int32 sums (m16n8k32; lane = 4 g + t). Each
// register four int8, the lowest column (A) or k (B) in the low byte:
//   A (16 x 32, row-major): a0 (row g, cols 4t .. 4t+3), a1 (row g+8, same),
//                           a2 (row g, cols 4t+16 .. 4t+19), a3 (row g+8, same)
//   B (32 x 8, k x n):      b0 (k 4t .. 4t+3, col n g), b1 (k 4t+16 .. 4t+19)
//   C (16 x 8, int32):      as the bf16 product's C
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x1(uint32_t& r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];\n"
               : "=r"(r) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x1_trans(uint32_t& r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.trans.shared.b16 {%0}, [%1];\n"
               : "=r"(r) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// 16 bytes from global to shared memory, bypassing L1; zeros when !valid
// (src is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}
// 8 bytes from global to shared memory (through L1); zeros when !valid.
// Both addresses 8-byte aligned.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid = true) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Two fp32 values as one bf16x2 register, `lo` in the low half (rounded to
// nearest even).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// The same pair split as hi + lo with hi = bf16(x) and lo = bf16(x - hi):
// two products, hi and lo, carry x to ~2^-16 relative instead of 2^-9.
__device__ __forceinline__ void pack_bf16_split(float a, float b, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// Sum and max over the four lanes of a quad (lanes 4 g .. 4 g + 3), which
// hold one row of a C fragment between them.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// Writes a 16-row strip of C fragments (NT n-tiles, times `mul`) as bf16
// at (r0, c0) of a row-major array with row stride ld; with lo, as hi there
// and lo at the same place in lo.
template <int NT>
__device__ __forceinline__ void store_frags(__nv_bfloat16* dst, __nv_bfloat16* lo, int ld,
                                            int r0, int c0, const float (&x)[NT][4], float mul,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int off = (r0 + g + 8 * h) * ld + c0 + j * 8 + 2 * t;
      const float a = x[j][2 * h] * mul, b = x[j][2 * h + 1] * mul;
      if (lo)
        pack_bf16_split(a, b, *reinterpret_cast<uint32_t*>(dst + off),
                        *reinterpret_cast<uint32_t*>(lo + off));
      else
        *reinterpret_cast<uint32_t*>(dst + off) = pack_bf16(a, b);
    }
}

// The C fragments of two neighbouring n-tiles (columns 16 kk .. 16 kk + 15)
// as the A fragment of k-step kk: one bf16 term, or hi + lo.
__device__ __forceinline__ void frags_to_a(uint32_t (&a)[4], const float (&x0)[4],
                                           const float (&x1)[4]) {
  a[0] = pack_bf16(x0[0], x0[1]);
  a[1] = pack_bf16(x0[2], x0[3]);
  a[2] = pack_bf16(x1[0], x1[1]);
  a[3] = pack_bf16(x1[2], x1[3]);
}
__device__ __forceinline__ void frags_to_a_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                                 const float (&x0)[4], const float (&x1)[4]) {
  pack_bf16_split(x0[0], x0[1], hi[0], lo[0]);
  pack_bf16_split(x0[2], x0[3], hi[1], lo[1]);
  pack_bf16_split(x1[0], x1[1], hi[2], lo[2]);
  pack_bf16_split(x1[2], x1[3], hi[3], lo[3]);
}

// g = rows 16 mt.. of a window's Gram qn^T kn (16 x C, C fragments). qn and
// kn are [p][c] rows of 16 positions, qn at column 0 and kn at column C of
// x (hi, row stride xs) and of lo (row stride ls): hi hi + hi lo + lo hi.
template <int C>
__device__ __forceinline__ void gram_strip(float (&g)[C / 8][4], const __nv_bfloat16* x, int xs,
                                           const __nv_bfloat16* lo, int ls, int mt, int lane) {
#pragma unroll
  for (int j = 0; j < C / 8; ++j) g[j][0] = g[j][1] = g[j][2] = g[j][3] = 0.f;
  // A[c1][p] = qn[p][c1]: the [p][c] rows through ldmatrix.trans
  const int ar = (lane & 7) + (lane >> 4) * 8, ac = mt * 16 + ((lane >> 3) & 1) * 8;
  uint32_t ah[4], al[4];
  ldmatrix_x4_trans(ah, x + ar * xs + ac);
  ldmatrix_x4_trans(al, lo + ar * ls + ac);
  const int br = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int nb = 0; nb < C / 16; ++nb) {
    const int bc = C + nb * 16 + (lane >> 4) * 8;
    uint32_t bh[4], bl[4];
    ldmatrix_x4_trans(bh, x + br * xs + bc);
    ldmatrix_x4_trans(bl, lo + br * ls + bc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float (&acc)[4] = g[2 * nb + h];
      mma_bf16(acc, ah, bh[2 * h], bh[2 * h + 1]);
      mma_bf16(acc, ah, bl[2 * h], bl[2 * h + 1]);
      mma_bf16(acc, al, bh[2 * h], bh[2 * h + 1]);
    }
  }
}

// exp(x) for x <= 0: expf, or with kFast the two-instruction __expf
// (relative error ~1e-7 |x|), for kernels whose result is rounded to bf16.
template <bool kFast>
__device__ __forceinline__ float exp_neg(float x) {
  return kFast ? __expf(x) : expf(x);
}

// Row softmax, max-subtracted, of a 16-row strip of C fragments in place.
template <int NT, bool kFast = false>
__device__ __forceinline__ void softmax_strip(float (&s)[NT][4]) {
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
    m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] = exp_neg<kFast>(s[j][0] - m0);
    s[j][1] = exp_neg<kFast>(s[j][1] - m0);
    s[j][2] = exp_neg<kFast>(s[j][2] - m1);
    s[j][3] = exp_neg<kFast>(s[j][3] - m1);
    l0 += s[j][0] + s[j][1];
    l1 += s[j][2] + s[j][3];
  }
  l0 = 1.f / quad_sum(l0);
  l1 = 1.f / quad_sum(l1);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] *= l0;
    s[j][1] *= l0;
    s[j][2] *= l1;
    s[j][3] *= l1;
  }
}

}  // namespace mstgan
