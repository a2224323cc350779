// Fused StructuralTransformerBlock body, inference forward, bf16 at dims
// 260 .. 512, for Hopper (sm_90a): with fused_structural_block.cu (every
// other dim, and fp32 at these) it replaces
// ops/pallas/fused_transformer.py::fused_structural_block of the JAX package
// (the op: that file's header). A source of its own so that nvcc builds it
// beside the other dims' designs, not after them.
//
// The blocks of the c65 .. c128 generators (dims 4c = 260 .. 512 in
// default_num_heads(4c) = 8 .. 16 heads of hd = 32 .. 64 channels, hd
// even or odd). In the slot kernel's frame a window's LN output alone (64
// rows of 512 channels as hi and lo) would take 133 KB and its residual
// stream 128 fp32 values a thread, so the window is split by tokens over a
// cluster of two blocks (thread block clusters, distributed shared memory):
// block r of the pair takes the 32 tokens of window rows 4r .. 4r + 3 with
// 8 warps, warp w the token rows 16 (w % 2).. and, of every 128 columns of
// the stream, the 32 at 32 (w / 2).. (128 columns in all), so the residual
// stream is 64 fp32 values a thread in registers, as in the slot kernel.
// Everything but the MHSA's keys and values is per token, so that is all the
// two blocks exchange: each block writes the k and v tiles of its 32 tokens
// into its own shared memory and into its partner's (st through the
// partner's mapped address), and a cluster barrier before and one after each
// head's attention keep the writes and the reads apart. The weights pass
// through two shared-memory tiles of 32 rows of DP + 8 (each block streams
// them all; the pair's second read comes from L2), zero-filled past the
// real rows and columns, one block barrier a tile. Per head, one at a time,
// in a slot of S = hd rounded up to 16 channels (the slot kernel's, with C,
// the head count and the scale 1/sqrt(hd) at run time):
//   q, k, v  ceil(S / 32) tiles of 32 slot rows of Wqkv each (K = the C real
//            inputs): warp w forms, for its 16 tokens, the slot's 8 columns
//            at 32 tile + 8 (w / 2) of LN1's output (hi + lo) times the
//            tile, into shared memory as hi + lo (k and v into both blocks);
//   MHSA     each warp the scores of its 16 queries over the window's 64
//            keys (the four warps of a row all form them), keys outside a
//            ragged grid at -inf, the exponentials at the scale and, for the
//            slot's 16-column group w / 2, the exponentials (hi + lo) times v
//            (hi, then lo), divided by the row sums, into shared memory as
//            hi + lo;
//   proj     four tiles of 128 output rows x the slot's S columns of Wproj
//            onto the residual stream (which starts as x + the proj bias);
// then LN2 over the C real channels (its row sums exchanged between the four
// warps of a row through shared memory) and the MLP in chunks of 64 hidden
// columns: two tiles of 32 fc1 rows (the warp's 8 hidden columns, GELU on
// the accumulators, into shared memory as hi + lo), then four tiles of fc2
// (128 output rows x the chunk's 64 columns) onto the stream. Every operand
// the kernel forms is a hi + lo pair, as in the slot kernel. A slot row's
// proj columns start at h hd: 8 bytes at a time where hd % 4 == 0, a value
// at a time otherwise (c68's heads of 34, c116's of 58 and c124's of 62).
// The grid is persistent in clusters: one pair a window until the card is
// full (cudaOccupancyMaxActiveClusters). What bounds it: operations (~1700
// flop a byte at dim 512), and the barriers between tiles of 32 rows; it is
// the simple design of these dims, not a fast one.
#include <type_traits>

#include <cooperative_groups.h>

#include "fused_structural_block.cuh"

namespace mstgan {
namespace {

constexpr int kHalfTok = kTok / 2;   // the tokens of one block of a pair

template <int S>
struct PairLayout {
  static constexpr int DP = 512, HC = 64;       // hidden columns a chunk
  static constexpr int TR = 32;                 // Wqkv and fc1 rows a tile
  static constexpr int WS = DP + 8;             // rows of DP values: 1040 bytes
  static constexpr int RS = S + 8;              // a slot's rows (q, k, v, o; proj tiles)
  static constexpr int FS = HC + 8;             // fc2 tile rows, the hidden chunk: 144 bytes
  static constexpr int TILE = TR * WS;          // the largest tile (128 x RS, 128 x FS fit)
  static constexpr int W = 0;                   // [2][TILE]
  static constexpr int HH = W + 2 * TILE;       // [32][WS] LN1 out, then LN2 out, hi
  static constexpr int HL = HH + kHalfTok * WS; //   ... lo
  static constexpr int U = HL + kHalfTok * WS;  // union:
  static constexpr int Q = U;                   //   q hi, q lo: [2][32][RS]
  static constexpr int K = Q + 2 * kHalfTok * RS;   // k hi, k lo, v hi, v lo: [4][64][RS]
  static constexpr int O = K + 4 * kTok * RS;   //   o hi, o lo: [2][32][RS]
  static constexpr int AH = U;                  //   [32][FS] the hidden chunk hi
  static constexpr int AL = AH + kHalfTok * FS; //   ... lo
  static constexpr int ELEMS = O + 2 * kHalfTok * RS > AL + kHalfTok * FS
                                   ? O + 2 * kHalfTok * RS
                                   : AL + kHalfTok * FS;
  static constexpr int N1W = 0, N1B = DP, N2W = 2 * DP, N2B = 3 * DP;
  static constexpr int QKV_B = 4 * DP;                          // [3][heads][S], slot layout
  static constexpr int PROJ_B = QKV_B + 3 * kPairMaxHeads * 64, FC1_B = PROJ_B + DP,
                       FC2_B = FC1_B + 4 * DP, STAT = FC2_B + DP;   // + [2][4][32] row sums
  static constexpr int PARAMS = STAT + 2 * 4 * kHalfTok;
  static constexpr int BYTES = ELEMS * (int)sizeof(bf16) + PARAMS * (int)sizeof(float);
  static_assert(S % 16 == 0 && S <= 64 && 128 * RS <= TILE && 128 * FS <= TILE, "slots");
  static_assert(BYTES <= 232448, "a block's shared memory");
};

// acc (16 rows x 8 outputs, one n-tile) += a w^T over `ks` k-steps: a 16
// rows at ah (and lo at al when kSplit) of stride lda, w 8 rows [n][k] of
// stride ldw.
template <bool kSplit>
__device__ __forceinline__ void rows_times_w8(float (&acc)[4], const bf16* ah, const bf16* al,
                                              int lda, const bf16* w, int ldw, int ks, int lane) {
#pragma unroll 4
  for (int kk = 0; kk < ks; ++kk) {
    const int aoff = (lane & 15) * lda + kk * 16 + (lane >> 4) * 8;
    uint32_t a[4], b[2];
    ldmatrix_x4(a, ah + aoff);
    ldmatrix_x2(b, w + (lane & 7) * ldw + kk * 16 + ((lane >> 3) & 1) * 8);
    mma_bf16(acc, a, b[0], b[1]);
    if constexpr (kSplit) {
      ldmatrix_x4(a, al + aoff);
      mma_bf16(acc, a, b[0], b[1]);
    }
  }
}

template <int S>
__global__ void __launch_bounds__(kMmaThreads, 1)
fused_structural_block_pair_kernel(const bf16* __restrict__ x, const bf16* __restrict__ st,
                                   const float* __restrict__ gamma,
                                   const float* __restrict__ beta, const bf16* __restrict__ n1w,
                                   const bf16* __restrict__ n1b, const bf16* __restrict__ qkvw,
                                   const bf16* __restrict__ qkvb, const bf16* __restrict__ projw,
                                   const bf16* __restrict__ projb, const bf16* __restrict__ n2w,
                                   const bf16* __restrict__ n2b, const bf16* __restrict__ f1w,
                                   const bf16* __restrict__ f1b, const bf16* __restrict__ f2w,
                                   const bf16* __restrict__ f2b, bf16* __restrict__ y, int B,
                                   int H, int W, int C, int heads, float scale, float eps) {
  namespace cg = cooperative_groups;
  using L = PairLayout<S>;
  constexpr int DP = L::DP, WS = L::WS, RS = L::RS, FS = L::FS, HC = L::HC, TR = L::TR;
  constexpr int NTP = (S + TR - 1) / TR;      // tiles of each of q, k, v of a head
  constexpr int PER_HEAD = 3 * NTP + 4;       // and the four proj tiles
  extern __shared__ __align__(16) unsigned char smem_mma[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();   // tokens 32 rank.. of each window
  bf16* sW = reinterpret_cast<bf16*>(smem_mma);
  bf16* sHH = sW + L::HH;
  bf16* sHL = sW + L::HL;
  bf16* sQ = sW + L::Q;                       // q hi, then q lo (32 rows each)
  bf16* sK = sW + L::K;                       // k hi, k lo, v hi, v lo (64 rows each)
  bf16* sO = sW + L::O;                       // o hi, then o lo (32 rows each)
  bf16* sAH = sW + L::AH;
  bf16* sAL = sW + L::AL;
  bf16* rK = cluster.map_shared_rank(sK, rank ^ 1);   // the partner's k, v tiles
  float* sP = reinterpret_cast<float*>(sW + L::ELEMS);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = (warp & 1) * 16, qt = warp >> 1, g = lane >> 2, tq = lane & 3;
  const int hd = C / heads;
  const int ks = (C + 15) / 16;                         // k-steps over the C inputs
  const int chunks = (4 * C + HC - 1) / HC;
  const int tiles_heads = PER_HEAD * heads, tiles = tiles_heads + 6 * chunks;
  const bool proj8 = hd % 4 == 0;                       // proj columns 8 bytes at a time

  // tile t into buffer `buf` by the whole block, zeros past the real rows
  // and columns: per head NTP tiles of 32 slot rows of each of q, k and v
  // (the C inputs), then four proj tiles (128 output rows x the head's S
  // slot columns); per hidden chunk two fc1 tiles (32 rows) and four fc2
  // tiles (128 output rows x the chunk's 64 columns)
  auto load_tile = [&](int t, int buf) {
    bf16* dst = sW + buf * L::TILE;
    if (t < tiles_heads) {
      const int h = t / PER_HEAD, p = t % PER_HEAD;
      if (p < 3 * NTP) {
        const int part = p / NTP, s0 = (p % NTP) * TR;
        for (int e = tid; e < TR * (DP / 4); e += kMmaThreads) {
          const int r = e / (DP / 4), c = (e % (DP / 4)) * 4;
          const bool real = s0 + r < hd && c < C;
          const bf16* src = qkvw + (long long)(part * C + h * hd + s0 + r) * C + c;
          cp_async8(dst + r * WS + c, real ? src : qkvw, real);
        }
        return;
      }
      const int o0 = (p - 3 * NTP) * 128;
      if (proj8) {
        for (int e = tid; e < 128 * (S / 4); e += kMmaThreads) {
          const int r = e / (S / 4), c = (e % (S / 4)) * 4;
          const bool real = o0 + r < C && c < hd;
          const bf16* src = projw + (long long)(o0 + r) * C + h * hd + c;
          cp_async8(dst + r * RS + c, real ? src : projw, real);
        }
      } else {
        for (int e = tid; e < 128 * S; e += kMmaThreads) {
          const int r = e / S, c = e % S;
          dst[r * RS + c] = o0 + r < C && c < hd ? projw[(long long)(o0 + r) * C + h * hd + c]
                                                 : __float2bfloat16(0.f);
        }
      }
      return;
    }
    const int hc = (t - tiles_heads) / 6, part = (t - tiles_heads) % 6;
    if (part < 2) {
      const int h0 = hc * HC + part * TR;
      for (int e = tid; e < TR * (DP / 4); e += kMmaThreads) {
        const int r = e / (DP / 4), c = (e % (DP / 4)) * 4;
        const bool real = h0 + r < 4 * C && c < C;
        const bf16* src = f1w + (long long)(h0 + r) * C + c;
        cp_async8(dst + r * WS + c, real ? src : f1w, real);
      }
    } else {
      const int o0 = (part - 2) * 128;
      for (int e = tid; e < 128 * (HC / 4); e += kMmaThreads) {
        const int r = e / (HC / 4), c = (e % (HC / 4)) * 4;
        const bool real = o0 + r < C && hc * HC + c < 4 * C;
        const bf16* src = f2w + (long long)(o0 + r) * 4 * C + hc * HC + c;
        cp_async8(dst + r * FS + c, real ? src : f2w, real);
      }
    }
  };

  // the fp32 parameters: norms, proj and fc2 biases, fc1's over DP and 4 DP
  // (zero past C and 4C); qkv's in the slot layout [3][heads][S]
  for (int e = tid; e < DP; e += kMmaThreads) {
    const bool real = e < C;
    sP[L::N1W + e] = real ? to_f(n1w[e]) : 0.f;
    sP[L::N1B + e] = real ? to_f(n1b[e]) : 0.f;
    sP[L::N2W + e] = real ? to_f(n2w[e]) : 0.f;
    sP[L::N2B + e] = real ? to_f(n2b[e]) : 0.f;
    sP[L::PROJ_B + e] = real ? to_f(projb[e]) : 0.f;
    sP[L::FC2_B + e] = real ? to_f(f2b[e]) : 0.f;
  }
  for (int e = tid; e < 4 * DP; e += kMmaThreads) sP[L::FC1_B + e] = e < 4 * C ? to_f(f1b[e]) : 0.f;
  for (int e = tid; e < 3 * heads * S; e += kMmaThreads) {
    const int part = e / (heads * S), h = (e / S) % heads, d = e % S;
    sP[L::QKV_B + e] = d < hd ? to_f(qkvb[part * C + h * hd + d]) : 0.f;
  }

  const int nwx = (W + kWin - 1) / kWin, nwy = (H + kWin - 1) / kWin;
  const long long n_windows = (long long)B * nwy * nwx;
  const long long pairs = gridDim.x / 2, pair0 = blockIdx.x / 2;
  if (pair0 < n_windows) load_tile(0, 0);
  cp_async_commit();
  // the tiles taken so far, over all windows: the next is in buffer seq & 1
  // (a window's tile count may be odd, so not the buffer of its index)
  int seq = 0;
#pragma unroll 1
  for (long long win = pair0; win < n_windows; win += pairs) {
    const int b = (int)(win / (nwy * nwx)), rem = (int)(win - (long long)b * nwy * nwx);
    const int row0 = (rem / nwx) * kWin, col0 = (rem % nwx) * kWin;
    const bool ragged = row0 + kWin > H || col0 + kWin > W;
    auto valid = [&](int tok) { return row0 + tok / kWin < H && col0 + tok % kWin < W; };
    auto offset = [&](int tok) {
      return (((long long)b * H + row0 + tok / kWin) * W + col0 + tok % kWin) * C;
    };
    const bool more = win + pairs < n_windows;
    int t = 0;
    auto next_tile = [&]() {
      cp_async_wait<0>();
      __syncthreads();   // tile t is in; every warp is done with tile t - 1
      if (t + 1 < tiles) load_tile(t + 1, (seq + 1) & 1);
      else if (more) load_tile(0, (seq + 1) & 1);
      cp_async_commit();
      ++t;
      return static_cast<const bf16*>(sW + (seq++ & 1) * L::TILE);
    };

    // both blocks are done with the previous window (the partner writes this
    // window's k and v into the union, which held the hidden chunk); on the
    // first window, both blocks have started
    cluster.sync();
    // LN1 + FiLM over the C real channels, a warp a token, 16 channels a
    // lane (four 8-byte loads: C % 4 == 0); tokens outside the grid and the
    // pad channels as zeros; hi + lo to shared memory
    for (int lt = warp; lt < kHalfTok; lt += kMmaThreads / 32) {
      const int tok = kHalfTok * rank + lt;
      float u[16] = {};
      if (valid(tok)) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = (q >> 1) * 256 + lane * 8 + (q & 1) * 4;
          if (c >= C) continue;
          const uint2 xv = __ldg(reinterpret_cast<const uint2*>(x + offset(tok) + c));
          const uint2 sv = __ldg(reinterpret_cast<const uint2*>(st + offset(tok) + c));
          const bf16* xp = reinterpret_cast<const bf16*>(&xv);
          const bf16* sp = reinterpret_cast<const bf16*>(&sv);
#pragma unroll
          for (int i = 0; i < 4; ++i) u[q * 4 + i] = __bfloat162float(xp[i]) + __bfloat162float(sp[i]);
        }
      }
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) sum += u[i];
      const float mean = warp_sum(sum) / C;
      float var = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if ((i >> 3) * 256 + lane * 8 + (i & 7) < C) var = fmaf(u[i] - mean, u[i] - mean, var);
      const float rstd = 1.f / sqrtf(warp_sum(var) / C + eps);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint4 hi = make_uint4(0u, 0u, 0u, 0u), lo = hi;
        uint32_t* hp = reinterpret_cast<uint32_t*>(&hi);
        uint32_t* lp = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
        for (int i = 0; i < 8; i += 2) {
          float v[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = p * 256 + lane * 8 + i + j;
            v[j] = 0.f;
            if (c < C) {
              v[j] = (u[p * 8 + i + j] - mean) * rstd * sP[L::N1W + c] + sP[L::N1B + c];
              v[j] = v[j] * (1.f + __ldg(gamma + (long long)b * C + c)) +
                     __ldg(beta + (long long)b * C + c);
            }
          }
          pack_bf16_split(v[0], v[1], hp[i / 2], lp[i / 2]);
        }
        *reinterpret_cast<uint4*>(sHH + lt * WS + p * 256 + lane * 8) = hi;
        *reinterpret_cast<uint4*>(sHL + lt * WS + p * 256 + lane * 8) = lo;
      }
    }

    // the residual stream: x + the proj bias at the warp's rows and columns
    // (of 128-column block j, the 32 at 32 qt + 8 n + 2 tq); zero past C
    float xr[4][4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int c = j * 128 + qt * 32 + n * 8 + 2 * tq;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int tok = kHalfTok * rank + r0 + g + 8 * hh;
          float2 xv = make_float2(0.f, 0.f);
          if (valid(tok) && c < C)
            xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + offset(tok) + c));
          xr[j][n][2 * hh] = xv.x + sP[L::PROJ_B + c];
          xr[j][n][2 * hh + 1] = xv.y + sP[L::PROJ_B + c + 1];
        }
      }

    // the heads, one at a time
#pragma unroll 1
    for (int h = 0; h < heads; ++h) {
#pragma unroll
      for (int part = 0; part < 3; ++part) {   // q, k, v: the warp's 8 slot columns a tile
#pragma unroll
        for (int i = 0; i < NTP; ++i) {
          const bf16* tile = next_tile();
          const int sc = i * TR + qt * 8;
          if (sc >= S) continue;
          float acc[1][4];
          const float2 bb = *reinterpret_cast<const float2*>(
              sP + L::QKV_B + (part * heads + h) * S + sc + 2 * tq);
          acc[0][0] = acc[0][2] = bb.x;
          acc[0][1] = acc[0][3] = bb.y;
          rows_times_w8<true>(acc[0], sHH + r0 * WS, sHL + r0 * WS, WS, tile + qt * 8 * WS, WS,
                              ks, lane);
          if (part == 0) {
            store_frags<1>(sQ, sQ + kHalfTok * RS, RS, r0, sc, acc, 1.f, lane);
          } else {   // k or v of this block's tokens, here and in the partner
            const int off = (part - 1) * 2 * kTok * RS, row = kHalfTok * rank + r0;
            store_frags<1>(sK + off, sK + off + kTok * RS, RS, row, sc, acc, 1.f, lane);
            store_frags<1>(rK + off, rK + off + kTok * RS, RS, row, sc, acc, 1.f, lane);
          }
        }
      }
      cluster.sync();   // q, and k and v of the window's 64 tokens, are in
      {
        constexpr int G = S / 16;
        uint32_t qh[G][4], ql[G][4];
        mhsa::load_a<S>(qh, sQ, r0, lane);
        mhsa::load_a<S>(ql, sQ + kHalfTok * RS, r0, lane);
        float s[8][4];
        mhsa::times_tile_t_split<S>(s, qh, ql, sK, sK + kTok * RS, lane);
        if (ragged) {   // keys outside the grid drop out of the softmax
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (!valid(j * 8 + 2 * tq)) s[j][0] = s[j][2] = -INFINITY;
            if (!valid(j * 8 + 2 * tq + 1)) s[j][1] = s[j][3] = -INFINITY;
          }
        }
        float l0, l1;   // token 0 of a window is always a valid key
        mhsa::exp_rows<true>(s, scale, l0, l1);   // __expf: y is bf16
        l0 = 1.f / l0;
        l1 = 1.f / l1;
        if (qt < G) {   // the slot's 16-column group qt
          const int gc = qt * 16;
          float o[2][4] = {};
          probs_times_cols<true>(o, s, sK + 2 * kTok * RS, RS, gc, lane);    // e (hi + lo) v hi
          probs_times_cols<false>(o, s, sK + 3 * kTok * RS, RS, gc, lane);   // e hi v lo
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            o[j][0] *= l0;
            o[j][1] *= l0;
            o[j][2] *= l1;
            o[j][3] *= l1;
          }
          store_frags<2>(sO, sO + kHalfTok * RS, RS, r0, gc, o, 1.f, lane);
        }
      }
      // both blocks are done with this head's k and v (the partner may
      // write the next head's), and every warp's o is in
      cluster.sync();
      // the head's share of the proj: output rows 128 i.. of Wproj x the
      // slot's S columns; the warp's 32 columns of 128-column block i
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bf16* tile = next_tile();
        if (i * 128 + qt * 32 >= C) continue;   // 32 pad columns
        rows_times_w<S / 16, true>(xr[i], sO + r0 * RS, sO + (kHalfTok + r0) * RS, RS,
                                   tile + qt * 32 * RS, RS, lane);
      }
    }

    // LN2 over the stream's C real columns: the row sums of the warp's
    // columns (the pads are zero), then the other three warps' of the row
    // (w ^ 2, w ^ 4, w ^ 6) through shared memory; the variance column by
    // column
    {
      float* stat = sP + L::STAT;   // [sum, squares][quarter][32 rows]
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          s0 += xr[j][n][0] + xr[j][n][1];
          s1 += xr[j][n][2] + xr[j][n][3];
        }
      s0 = quad_sum(s0);
      s1 = quad_sum(s1);
      if (tq == 0) {
        stat[qt * kHalfTok + r0 + g] = s0;
        stat[qt * kHalfTok + r0 + g + 8] = s1;
      }
      __syncthreads();
      float m0 = 0.f, m1 = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        m0 += stat[q * kHalfTok + r0 + g];
        m1 += stat[q * kHalfTok + r0 + g + 8];
      }
      m0 /= C;
      m1 /= C;
      float v0 = 0.f, v1 = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          if (j * 128 + qt * 32 + n * 8 + 2 * tq >= C) continue;   // C is even
          v0 = fmaf(xr[j][n][0] - m0, xr[j][n][0] - m0, fmaf(xr[j][n][1] - m0, xr[j][n][1] - m0, v0));
          v1 = fmaf(xr[j][n][2] - m1, xr[j][n][2] - m1, fmaf(xr[j][n][3] - m1, xr[j][n][3] - m1, v1));
        }
      v0 = quad_sum(v0);
      v1 = quad_sum(v1);
      if (tq == 0) {
        stat[4 * kHalfTok + qt * kHalfTok + r0 + g] = v0;
        stat[4 * kHalfTok + qt * kHalfTok + r0 + g + 8] = v1;
      }
      __syncthreads();
      float w0 = 0.f, w1 = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        w0 += stat[4 * kHalfTok + q * kHalfTok + r0 + g];
        w1 += stat[4 * kHalfTok + q * kHalfTok + r0 + g + 8];
      }
      const float i0 = 1.f / sqrtf(w0 / C + eps);
      const float i1 = 1.f / sqrtf(w1 / C + eps);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float hn[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int c = j * 128 + qt * 32 + n * 8 + 2 * tq;
          const float wa = sP[L::N2W + c], wb = sP[L::N2W + c + 1];
          const float ba = sP[L::N2B + c], bb = sP[L::N2B + c + 1];
          hn[n][0] = (xr[j][n][0] - m0) * i0 * wa + ba;   // zero past C (w, b zero)
          hn[n][1] = (xr[j][n][1] - m0) * i0 * wb + bb;
          hn[n][2] = (xr[j][n][2] - m1) * i1 * wa + ba;
          hn[n][3] = (xr[j][n][3] - m1) * i1 * wb + bb;
          xr[j][n][0] += sP[L::FC2_B + c];   // the stream now collects fc2
          xr[j][n][1] += sP[L::FC2_B + c + 1];
          xr[j][n][2] += sP[L::FC2_B + c];
          xr[j][n][3] += sP[L::FC2_B + c + 1];
        }
        store_frags<4>(sHH, sHL, WS, r0, j * 128 + qt * 32, hn, 1.f, lane);
      }
    }

    // the MLP, 64 hidden columns at a time
#pragma unroll 1
    for (int hc = 0; hc < chunks; ++hc) {
#pragma unroll
      for (int part = 0; part < 2; ++part) {   // fc1, GELU: hidden columns 32 part + 8 qt..
        const bf16* tile = next_tile();
        float f[1][4];
        const float2 bb =
            *reinterpret_cast<const float2*>(sP + L::FC1_B + hc * HC + part * TR + qt * 8 + 2 * tq);
        f[0][0] = f[0][2] = bb.x;
        f[0][1] = f[0][3] = bb.y;
        rows_times_w8<true>(f[0], sHH + r0 * WS, sHL + r0 * WS, WS, tile + qt * 8 * WS, WS, ks,
                            lane);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          f[0][i] = 0.5f * f[0][i] * (1.f + erff(f[0][i] * 0.70710678118654752f));
        store_frags<1>(sAH, sAL, FS, r0, part * TR + qt * 8, f, 1.f, lane);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {   // fc2: output rows 128 j.., the chunk's columns
        const bf16* tile = next_tile();   // also: every warp's hidden columns are in
        if (j * 128 + qt * 32 >= C) continue;   // 32 pad columns
        rows_times_w<HC / 16, true>(xr[j], sAH + r0 * FS, sAL + r0 * FS, FS, tile + qt * 32 * FS,
                                    FS, lane);
      }
    }

    // y, where the token and the column exist
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int tok = kHalfTok * rank + r0 + g + 8 * hh;
      if (!valid(tok)) continue;
      bf16* row = y + offset(tok);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int c = j * 128 + qt * 32 + n * 8 + 2 * tq;
          if (c < C)
            *reinterpret_cast<uint32_t*>(row + c) = pack_bf16(xr[j][n][2 * hh], xr[j][n][2 * hh + 1]);
        }
    }
  }
  cp_async_wait<0>();
  cluster.sync();   // no block leaves while its partner may still write into it
}

int launch_pair(const void* x, const void* st, const void* gamma, const void* beta,
                const void* const* w, void* y, int B, int H, int W, int C, int heads, float eps,
                cudaStream_t stream) {
  const int hd = C / heads;
  const float scale = 1.f / sqrtf((float)hd);
  // past dim 256 a head has more than 16 channels (at most 16 heads): slots
  // of 32, 48 and 64 only
  auto with_slot = [&](auto f) {
    if (hd <= 32) return f(std::integral_constant<int, 32>{});
    if (hd <= 48) return f(std::integral_constant<int, 48>{});
    return f(std::integral_constant<int, 64>{});
  };
  return with_slot([&](auto slot) {
    constexpr int S = decltype(slot)::value;
    using L = PairLayout<S>;
    auto kernel = fused_structural_block_pair_kernel<S>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 2;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(2);
    cfg.blockDim = dim3(kMmaThreads);
    cfg.dynamicSmemBytes = L::BYTES;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    static int clusters = 0;   // resident pairs, asked once per slot width
    if (clusters == 0) {
      err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
      if (err == cudaSuccess && clusters < 1) err = cudaErrorLaunchOutOfResources;
      if (err != cudaSuccess) {
        clusters = 0;
        return (int)err;
      }
    }
    const long long n_windows =
        (long long)B * ((H + kWin - 1) / kWin) * ((W + kWin - 1) / kWin);
    cfg.gridDim = dim3(2 * (unsigned)persistent_grid(n_windows, clusters, 1));
    auto p = [&](int i) { return static_cast<const bf16*>(w[i]); };
    err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(x),
                             static_cast<const bf16*>(st), static_cast<const float*>(gamma),
                             static_cast<const float*>(beta), p(0), p(1), p(2), p(3), p(4), p(5),
                             p(6), p(7), p(8), p(9), p(10), p(11), static_cast<bf16*>(y), B, H, W,
                             C, heads, scale, eps);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  });
}

}  // namespace
}  // namespace mstgan

// Plain C entry point (loaded with ctypes), as fused_structural_block_launch
// without the workspace: bf16 only, C % 4 == 0 from 260 to 512 with
// default_num_heads(C) heads of at most 64 channels. Launches on `stream`
// and returns cudaGetLastError() (0 on success); anything else returns
// cudaErrorInvalidValue.
extern "C" int fused_structural_block_pair_launch(const void* x, const void* st,
                                                  const void* gamma, const void* beta,
                                                  const void* const* weights, void* y, int B,
                                                  int H, int W, int C, int dtype, float eps,
                                                  int device, void* stream) {
  if (dtype != mstgan::kBF16 || C < 1) return (int)cudaErrorInvalidValue;
  const int heads = mstgan::default_num_heads(C);
  if (!mstgan::pair_takes(C, heads)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return mstgan::launch_pair(x, st, gamma, beta, weights, y, B, H, W, C, heads, eps,
                             static_cast<cudaStream_t>(stream));
}
