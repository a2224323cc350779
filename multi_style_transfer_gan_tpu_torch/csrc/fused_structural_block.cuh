// The pieces of the fused structural block's bf16 designs that its two
// sources share: fused_structural_block.cu (every dim up to 256, and fp32
// past it) and fused_structural_block_pair.cu (bf16 at dims 260 .. 512, a
// cluster of two blocks a window): the window and group geometry, the heads
// rule and the split between the two sources, and two warp-MMA steps, a
// 16-row strip times 32 weight rows and the softmax's exponentials times a
// staged [token][d] tile.
#pragma once

#include "common.cuh"
#include "mma.cuh"
#include "window_mhsa_mma.cuh"

namespace mstgan {
namespace {

using bf16 = __nv_bfloat16;
constexpr int kWin = 8;
constexpr int kTok = kWin * kWin;
constexpr int kGroups = 2;                // windows in flight per block (C <= 64)
constexpr int kGroupThreads = 128;        // 4 warps x 16 token rows
constexpr int kMmaThreads = kGroups * kGroupThreads;
// the widest dim whose window one block holds: past it bf16 runs in the pair
// kernel and fp32 keeps a window's residual stream and LN output in a
// workspace (ops/kernels/fused_transformer.py::FRAME_DIM)
constexpr int kFrameDim = 256;
constexpr int kPairMaxHeads = 16;

// models/structural_transformer.py::default_num_heads
constexpr int default_num_heads(int dim) {
  int h = dim / 32 > 1 ? dim / 32 : 1;
  while (dim % h) --h;
  return h;
}

// bf16 at a dim from 257 to 512 with C % 4 == 0 and up to 16 heads of at
// most 64 channels: the pair kernel (fused_structural_block_pair.cu).
inline bool pair_takes(int C, int heads) {
  const int hd = C / heads;
  return C > kFrameDim && C <= 2 * kFrameDim && C % 4 == 0 && heads <= kPairMaxHeads &&
         hd <= 64;
}

// acc (16 rows x 32 outputs, 4 n-tiles) += a w^T: a 16 rows of KS k-steps
// at ah (and lo at al when kSplit), row stride lda; w 32 rows [n][k] of
// stride ldw.
template <int KS, bool kSplit>
__device__ __forceinline__ void rows_times_w(float (&acc)[4][4], const bf16* ah, const bf16* al,
                                             int lda, const bf16* w, int ldw, int lane) {
#pragma unroll 4
  for (int kk = 0; kk < KS; ++kk) {
    const int aoff = (lane & 15) * lda + kk * 16 + (lane >> 4) * 8;
    uint32_t a[4], b[2][4];
    ldmatrix_x4(a, ah + aoff);
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      ldmatrix_x4(b[nb], w + (nb * 16 + (lane & 7) + (lane >> 4) * 8) * ldw + kk * 16 +
                             ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * nb], a, b[nb][0], b[nb][1]);
      mma_bf16(acc[2 * nb + 1], a, b[nb][2], b[nb][3]);
    }
    if constexpr (kSplit) {
      ldmatrix_x4(a, al + aoff);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        mma_bf16(acc[2 * nb], a, b[nb][0], b[nb][1]);
        mma_bf16(acc[2 * nb + 1], a, b[nb][2], b[nb][3]);
      }
    }
  }
}

// acc (16 x 16: columns c0.. of y) += x (16 x 64, C fragments) y, y a
// [token][d] tile of stride ldy through ldmatrix.trans; x as A fragments,
// hi + lo when kSplit.
template <bool kSplit>
__device__ __forceinline__ void probs_times_cols(float (&acc)[2][4], const float (&x)[8][4],
                                                 const bf16* y, int ldy, int c0, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a0 = x[2 * kk + r / 2][(r % 2) * 2], a1 = x[2 * kk + r / 2][(r % 2) * 2 + 1];
      if (kSplit) pack_bf16_split(a0, a1, hi[r], lo[r]);
      else hi[r] = pack_bf16(a0, a1);
    }
    uint32_t b[4];
    ldmatrix_x4_trans(b, y + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldy + c0 +
                             (lane >> 4) * 8);
    mma_bf16(acc[0], hi, b[0], b[1]);
    mma_bf16(acc[1], hi, b[2], b[3]);
    if (kSplit) {
      mma_bf16(acc[0], lo, b[0], b[1]);
      mma_bf16(acc[1], lo, b[2], b[3]);
    }
  }
}

}  // namespace
}  // namespace mstgan
