// The warp-MMA steps of the window-8 multi-head self-attention forward on
// Hopper (sm_90a), shared by the training kernels (window_mhsa_train.cu)
// and the fused structural block (fused_structural_block.cu): one warp
// owns 16 query rows of a 64-token window and one head of 32 channels,
// FlashAttention-2 style. k and v (and q, in the training kernels) are
// staged in shared memory as bf16 [token][channel] tiles whose rows are
// padded to 80 bytes, so ldmatrix is free of bank conflicts.
//
// Head slots. A head of another width hd runs in a slot of S = hd rounded
// up to 16 channels (the m16n8k16 k-step): S = 16, 32, 48 or 64 (hd = 4 ..
// 64, the heads of every generator width from 1 to 64). Its q, k and v sit
// at the start of the slot with zeros in the pad channels, so the scores and
// the real channels of the output are those of the head; the scale is
// 1/sqrt(hd), a runtime value. A slot tile's rows are S + 8 values: 48, 80,
// 112 or 144 bytes, each an odd multiple of 16, so ldmatrix stays free of
// bank conflicts. The steps below take S as a template parameter, 32 by
// default (the heads of 32 the fused block uses).
#pragma once

#include <cmath>

#include "mma.cuh"

namespace mstgan {
namespace mhsa {

using bf16 = __nv_bfloat16;
constexpr int kWin = 8;
constexpr int kTok = kWin * kWin;
constexpr int kHd = 32;
constexpr int RS = kHd + 8;               // staged token row: 80 bytes
constexpr int TILE = kTok * RS;           // one staged 64 x 32 tile

// The staged row and tile of a slot of S channels.
template <int S>
__host__ __device__ constexpr int slot_rs() { return S + 8; }
template <int S>
__host__ __device__ constexpr int slot_tile() { return kTok * slot_rs<S>(); }

// A fragments (S / 16 k-steps) of rows r0..r0+15 of a staged tile.
template <int S = kHd>
__device__ __forceinline__ void load_a(uint32_t (&a)[S / 16][4], const bf16* tile, int r0,
                                       int lane) {
#pragma unroll
  for (int kk = 0; kk < S / 16; ++kk)
    ldmatrix_x4(a[kk], tile + (r0 + (lane & 15)) * slot_rs<S>() + kk * 16 + (lane >> 4) * 8);
}

// acc (16 x 64, 8 n-tiles) = a (16 x S) y^T, y a staged [token][d] tile.
template <int S = kHd>
__device__ __forceinline__ void times_tile_t(float (&acc)[8][4], const uint32_t (&a)[S / 16][4],
                                             const bf16* y, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < S / 16; ++kk)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      uint32_t b[4];
      ldmatrix_x4(b, y + (nb * 16 + (lane & 7) + (lane >> 4) * 8) * slot_rs<S>() + kk * 16 +
                         ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * nb], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * nb + 1], a[kk], b[2], b[3]);
    }
}

// The same with a and y as hi + lo bf16 pairs (yl the tile of y's lo
// parts): hi hi + hi lo + lo hi.
template <int S = kHd>
__device__ __forceinline__ void times_tile_t_split(float (&acc)[8][4],
                                                   const uint32_t (&ah)[S / 16][4],
                                                   const uint32_t (&al)[S / 16][4], const bf16* yh,
                                                   const bf16* yl, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < S / 16; ++kk)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int off = (nb * 16 + (lane & 7) + (lane >> 4) * 8) * slot_rs<S>() + kk * 16 +
                      ((lane >> 3) & 1) * 8;
      uint32_t bh[4], bl[4];
      ldmatrix_x4(bh, yh + off);
      ldmatrix_x4(bl, yl + off);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mma_bf16(acc[2 * nb + h], ah[kk], bh[2 * h], bh[2 * h + 1]);
        mma_bf16(acc[2 * nb + h], ah[kk], bl[2 * h], bl[2 * h + 1]);
        mma_bf16(acc[2 * nb + h], al[kk], bh[2 * h], bh[2 * h + 1]);
      }
    }
}

// acc (16 x S, S / 8 n-tiles) += x (16 x 64, C fragments) y, y a staged
// [token][d] tile read through ldmatrix.trans; x repacked as A fragments,
// as hi + lo bf16 when kSplit.
template <bool kSplit, int S = kHd>
__device__ __forceinline__ void strip_times_tile(float (&acc)[S / 8][4], const float (&x)[8][4],
                                                 const bf16* y, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {   // a0..a3: (n-tile 2kk, row g), (2kk, g+8), (2kk+1, g), ...
      const float c0 = x[2 * kk + r / 2][(r % 2) * 2], c1 = x[2 * kk + r / 2][(r % 2) * 2 + 1];
      if (kSplit) pack_bf16_split(c0, c1, hi[r], lo[r]);
      else hi[r] = pack_bf16(c0, c1);
    }
#pragma unroll
    for (int dp = 0; dp < S / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, y + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * slot_rs<S>() +
                               dp * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * dp], hi, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], hi, b[2], b[3]);
      if (kSplit) {
        mma_bf16(acc[2 * dp], lo, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], lo, b[2], b[3]);
      }
    }
  }
}

// exp((s - row max) scale) in place on a 16 x 64 strip of C fragments, and
// the sums of the lane's two rows (g and g + 8); kFast as exp_neg.
template <bool kFast = false>
__device__ __forceinline__ void exp_rows(float (&s)[8][4], float scale, float& l0, float& l1) {
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
    m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  l0 = l1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] = exp_neg<kFast>((s[j][0] - m0) * scale);
    s[j][1] = exp_neg<kFast>((s[j][1] - m0) * scale);
    s[j][2] = exp_neg<kFast>((s[j][2] - m1) * scale);
    s[j][3] = exp_neg<kFast>((s[j][3] - m1) * scale);
    l0 += s[j][0] + s[j][1];
    l1 += s[j][2] + s[j][3];
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
}

}  // namespace mhsa
}  // namespace mstgan
