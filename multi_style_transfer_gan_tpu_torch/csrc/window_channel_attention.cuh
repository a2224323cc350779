// The body of the windowed channel-attention kernel (the EnhancedGenerator's
// LocalAttention, inference forward) for Hopper (sm_90a), shared by
// window_channel_attention.cu (the op: kStage == kFull, NHWC and packed
// rows) and window_attention_stages.cu (prefixes of the op, NHWC, for the
// stage ablation).
//
// Per 4x4 window, with P = 16 positions:
//   qkv   = x @ Wqkv^T + bqkv                       (P x 3C)
//   qn,kn = zero-safe L2 normalize of q, k over C   (0 -> 0, else u / max(|u|, eps))
//   A     = softmax_rows(qn^T kn)                   (C x C, max-subtracted)
//   out   = v A^T                                   (P x C)
//   y     = out @ Wproj^T + bproj                   (P x C)
// Weights come in the PyTorch (out, in) layout of the 1x1 convs.
//
// What bounds it. Per pixel the op does 12*C^2 flops and moves 4*C bytes
// in bf16 (read x once, write y once): about 3*C flop per byte, 24-192 at
// C = 8..64. Against the tensor-core ridge (~295 flop/B in bf16) that is
// bytes-bound at those widths, which is why the whole chain stays in one
// pass and no intermediate touches device memory. At C = 128 (the c32
// generator's down2) it is 384 flop/B, at C = 256 (c64's down2) 768, past
// the ridge: operations bound it there, and the hi + lo pairs below add to
// them.
//
// bf16 design (window_channel_attention_mma_kernel). Persistent blocks of 8
// warps: the grid is one block per 8 windows until the card is full
// (persistent_grid; four times that at C = 16, whose weights cost less
// than the imbalance), and every block stages Wqkv, Wproj (bf16, as
// stored, rows padded by 16 bytes) and the biases (fp32) once with 16-byte
// cp.async, then strides over the windows. One warp owns one window, a
// 16-position m-tile, through the whole chain, so the only block barrier is
// the one after the weights; the warp's next window is fetched with
// cp.async into a second buffer while this one is computed. Every product
// is mma.sync.m16n8k16 (bf16 in, fp32 sums; csrc/mma.cuh). For y = x W^T
// the B operand is W as stored, [n][k] rows through ldmatrix; q, k and v
// arrive as accumulator fragments. The L2 norm of a position is a quad
// reduction over its fragments (fp32; 1 / max(|u|, eps), which sends a zero
// vector to zero). qn and kn go to shared memory as hi + lo bf16 pairs and
// come back transposed (ldmatrix.trans) for the Gram, 16 rows of it at a
// time (gram_strip, three products hi hi + hi lo + lo hi); the softmax runs
// on those fragments (quad shuffles); out = v A^T takes v's fragments as A
// and the softmax's as B straight from registers, and each 16-column strip
// of out is at once one k-step of the proj, so only x, qn and kn ever touch
// shared memory. y leaves through the window's own x buffer as 16-byte
// stores.
// Operands rounded to bf16 inside the kernel: qn and kn as hi + lo pairs
// (with one term each a flat window whose q and k sit on a few channels
// misses the bf16 bound by 1.05-1.35x, with the pairs it stays at 0.41-0.66
// of it; devtools/serving_kernel_rounding.py); v, A and out as one term,
// except at C >= 64, where A and out are pairs too (one such window at
// C = 64 on a 128^2 grid reaches 1.13 of the bound with one term each, the
// 128-key softmax at C = 128 0.97; with the pairs both stay at 0.68).
//
// Widths. C is a runtime argument: any C from 1 to 512 (the LocalAttention
// widths C, 2C and 4C of every generator width from 1 to 128). Each C runs
// inside a built layout of CP >= C channels (a template parameter): bf16 CP
// = 16 (C <= 16), 32, 64, 128, 256 and 512; fp32 the next power of two from
// 8.
// x and y are read and written at their real row stride C and the channels
// C..CP are zeros in shared memory or registers: zeros in the pad columns of
// x, the weights and the biases, so q, k, v and y are zero there; the pad
// keys of the Gram are set to -inf (bf16; the fp32 softmax and apply run
// over the C real keys) before the softmax, and the pad rows of A meet zero
// columns of Wproj, so neither reaches y. Gram strips made only of pad rows
// are skipped. C = 1-15 run in the C = 16 layout (m16n8k16 takes 16-deep
// k-steps), 17-31 in C = 32's, 33-63 in 64's, 65-127 in the 128 layout with
// 3 warps a block (the 139 KB of resident weights leave room for no more),
// 129-256 in the C = 256 kernel (window_channel_attention_wide_kernel,
// below), whose weights (541 KB) stream through shared memory, and 257-512
// in the same kernel's C = 512 layout (one window a block). Padding to the
// next layout costs up to (256 / 129)^2 = 3.9x the Gram work at C = 129.
// Rows of C % 8 == 0 values move 16 bytes at a time (cp.async and 16-byte
// stores); at any other C a row's start is not 16-byte aligned, and the
// runtime-C variant (kC = 0) moves x, y and the weights 8 bytes at a time
// where C % 4 == 0 (every LocalAttention width of a generator) and a value
// at a time otherwise, and masks the pad keys one by one (an n-tile of the
// Gram then holds real and pad keys). The variants with C folded in are those of the widths
// their layouts were built for and never take that path.
//
// fp32 stays exact fp32 (window_channel_attention_f32_kernel): FMAs on the
// CUDA cores, no tensor cores, no TF32. One block of 256 threads (512 at
// CP = 512, one output channel of the layout a thread) walks
// tiles of NW = 64 / CP windows (one at CP >= 128) over the same persistent
// grid; Wqkv^T, Wproj^T and the biases are staged once per block in fp32,
// with row strides of 3CP + 1 and CP + 1 floats so that the transposing
// stores, like the column walks of qkv and the Gram (strides 3CP + 1,
// CP + 1), fall in distinct banks. At CP >= 128 the weights (~263 KB at
// 128) stay in device memory and are read through L2 and the read-only
// cache, 16 bytes a load, over the C real inputs. Every intermediate lives
// in shared memory; each thread owns one output channel of the layout at PJ
// positions (4; 8 at CP = 128, 16 at CP = 256 and 512) in the qkv and proj
// products. The Gram, its softmax and the apply run on SR rows of the Gram
// at a time: all CP up to CP = 128, strips of 64 at CP = 256, whose whole
// Gram (263 KB) would outgrow shared memory, and of 32 at CP = 512. Windows past the end of the
// last tile compute on zeros and are not stored.
//
// Stages. kStage < kFull ends each window early and stores a result folded
// from everything that stage computed (so no work is dead code), rounded
// once to the input's type, at position p, channel c of each window:
//   kCopy    x
//   kQkv     q + k + v
//   kNorm    qn + kn + v
//   kLogits  v + (p < min(C, 16) ? sum_c2 G[p, c2] : 0),  G = qn^T kn
//   kSoftmax the same fold over A = softmax_rows(G)
// The row sums of every Gram row are written to shared memory (fp32: the
// pad slot of each Gram row; bf16: a per-warp array) and the first 16 read
// back. The stage kernels run at C = CP only (16, 32, 64). kFull is the
// op, and its instantiation compiles exactly the code above.
#pragma once

#include <climits>
#include <cmath>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace mstgan {
namespace {

constexpr int kWs = 4;
constexpr int kP = kWs * kWs;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum Stage : int { kCopy = 0, kQkv = 1, kNorm = 2, kLogits = 3, kSoftmax = 4, kFull = 5 };

// Offset, in units of C elements, of position 0 of window `win`, windows
// numbered (b, window row, window column) row-major. NHWC: a pixel of a (B,
// H, W, C) tensor. Packed: the packed tensor (B, H/4, W/4, 16*C) holds
// window `win` as one contiguous row of 16 positions. The index type I is
// int where the caller knows the windows fit (32-bit divisions), else long
// long.
template <bool kPacked, typename I>
__device__ __forceinline__ long long window_base(I win, int H, int W) {
  if constexpr (kPacked) {
    return (long long)win * kP;
  } else {
    const int nw = W / kWs;
    const I per_image = (I)(H / kWs) * nw;
    const I b = win / per_image;
    const int rem = (int)(win - b * per_image);
    return ((long long)b * H + (rem / nw) * kWs) * W + (rem % nw) * kWs;
  }
}

// Offset of position p (0..15, row-major in the window) from window_base.
template <bool kPacked>
__device__ __forceinline__ int position_offset(int p, int W) {
  return kPacked ? p : (p / kWs) * W + p % kWs;
}

template <bool kPacked>
__device__ __forceinline__ long long pixel_offset(long long win, int p, int H, int W) {
  return window_base<kPacked, long long>(win, H, W) + position_offset<kPacked>(p, W);
}

// ---------------------------------------------------------------------------
// fp32: the FMA body
// ---------------------------------------------------------------------------

template <int CP>
struct Layout {
  // weights staged in shared memory up to CP = 64; at CP = 128 the
  // transposed fp32 weights alone (~263 KB) outgrow it, and the products read
  // them through L2 and the read-only cache, 16 bytes a load
  static constexpr bool RESIDENT = CP <= 64;
  // 256 threads, one output channel of the layout each; 512 at CP = 512
  static constexpr int THREADS = CP > kThreads ? CP : kThreads;
  static constexpr int NW = CP <= 64 ? 64 / CP : 1;   // windows per tile
  // Gram rows at a time: 64 at CP = 256, 32 at CP = 512 (whose strip of 64
  // rows would take the block past 227 KB)
  static constexpr int SR = CP > 256 ? 32 : CP > 128 ? 64 : CP;
  static constexpr int ROWS = NW * kP;   // positions per tile
  static constexpr int RG = THREADS / CP;             // thread rows of the products
  static constexpr int PJ = ROWS / RG;                // positions per thread
  static constexpr int QS = 3 * CP + 1;  // padded qkv row stride; also Wqkv^T's
  static constexpr int GS = CP + 1;      // padded Gram row stride; also Wproj^T's
  static constexpr int W_QKV = 0;                  // [CP][QS], (in, out)
  static constexpr int B_QKV = W_QKV + (RESIDENT ? CP * QS : 0);   // [3CP]
  static constexpr int W_PROJ = B_QKV + 3 * CP;    // [CP][GS], (in, out)
  static constexpr int B_PROJ = W_PROJ + (RESIDENT ? CP * GS : 0);  // [CP]
  static constexpr int X = B_PROJ + CP;            // [ROWS][CP]; later the attention output
  static constexpr int QKV = X + ROWS * CP;        // [ROWS][QS]
  static constexpr int DEN = QKV + ROWS * QS;      // [2][ROWS] normalize denominators
  static constexpr int G = DEN + 2 * ROWS;         // [NW][SR][GS]
  static constexpr int TOTAL = G + NW * SR * GS;
};

// An early stage's store: f(r) at channel og of the thread's PJ positions
// r = rg + RG * j of the tile, as the proj store lays them out (C = CP).
template <int CP, bool kPacked, typename F>
__device__ __forceinline__ void store_stage(float* __restrict__ y, long long win0,
                                            long long n_windows, int H, int W, int og, int rg,
                                            F f) {
  using L = Layout<CP>;
#pragma unroll
  for (int j = 0; j < L::PJ; ++j) {
    const int r = rg + L::RG * j;
    const long long win = win0 + r / kP;
    if (win < n_windows) y[pixel_offset<kPacked>(win, r % kP, H, W) * CP + og] = f(r);
  }
}

// The layout's channels are CP; the tensors' are C <= CP (C % 8 == 0).
template <int CP, bool kPacked, int kStage>
__global__ void __launch_bounds__(Layout<CP>::THREADS)
window_channel_attention_f32_kernel(const float* __restrict__ x, const float* __restrict__ wqkv,
                                    const float* __restrict__ bqkv,
                                    const float* __restrict__ wproj,
                                    const float* __restrict__ bproj, float* __restrict__ y,
                                    int H, int W, long long n_windows, int C, float eps) {
  using L = Layout<CP>;
  extern __shared__ float smem[];
  float* sWq = smem + L::W_QKV;
  float* sBq = smem + L::B_QKV;
  float* sWp = smem + L::W_PROJ;
  float* sBp = smem + L::B_PROJ;
  float* sX = smem + L::X;
  float* sQKV = smem + L::QKV;
  float* sDen = smem + L::DEN;
  float* sG = smem + L::G;
  const int tid = threadIdx.x;
  // qkv, apply and proj: thread (og, rg) owns output channel og at PJ
  // positions (4, and 8 at CP = 128), so one shared-memory load feeds 3-4
  // FMAs
  constexpr int RG = L::RG, PJ = L::PJ, THREADS = L::THREADS;
  static_assert(L::ROWS == PJ * RG && kP % PJ == 0, "PJ positions of one window per thread");
  const int og = tid % CP, rg = tid / CP;
  // the qkv and norm stages' fold: q + k + v (normalized or not) at (r, og)
  [[maybe_unused]] auto qkv_sum = [&](int r) {
    const float* u = sQKV + r * L::QS + og;
    return u[0] + u[CP] + u[2 * CP];
  };

  // the weights, transposed to (in, out): consecutive threads read
  // consecutive `in` and store QS (GS) floats apart, an odd stride; zeros
  // in the pad rows and columns
  if constexpr (L::RESIDENT) {
    for (int e = tid; e < 3 * CP * CP; e += THREADS) {
      const int o = e / CP, i = e % CP, blk = o / CP, oi = o % CP;
      sWq[i * L::QS + o] = i < C && oi < C ? wqkv[(blk * C + oi) * C + i] : 0.f;
    }
    for (int e = tid; e < CP * CP; e += THREADS) {
      const int o = e / CP, i = e % CP;
      sWp[i * L::GS + o] = i < C && o < C ? wproj[o * C + i] : 0.f;
    }
  }
  for (int e = tid; e < 3 * CP; e += THREADS) {
    const int blk = e / CP, i = e % CP;
    sBq[e] = i < C ? bqkv[blk * C + i] : 0.f;
  }
  for (int e = tid; e < CP; e += THREADS) sBp[e] = e < C ? bproj[e] : 0.f;

  const long long n_tiles = (n_windows + L::NW - 1) / L::NW;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long win0 = tile * L::NW;
    __syncthreads();  // weights staged; the previous tile is done with sX

    for (int e = tid; e < L::ROWS * CP; e += THREADS) {
      const int r = e / CP, c = e % CP;
      const long long win = win0 + r / kP;
      sX[e] = win < n_windows && c < C ? x[pixel_offset<kPacked>(win, r % kP, H, W) * C + c]
                                       : 0.f;
    }
    __syncthreads();
    if constexpr (kStage == kCopy) {
      store_stage<CP, kPacked>(y, win0, n_windows, H, W, og, rg,
                               [&](int r) { return sX[r * CP + og]; });
      continue;
    }

    // qkv = x @ Wqkv^T + b; each thread sums q, k and v of channel og
    // at PJ positions in registers
    {
      float acc[PJ][3] = {};
      if constexpr (L::RESIDENT) {
#pragma unroll 4
        for (int i = 0; i < CP; ++i) {
          float a[PJ], w[3];
#pragma unroll
          for (int j = 0; j < PJ; ++j) a[j] = sX[(rg + RG * j) * CP + i];
#pragma unroll
          for (int k = 0; k < 3; ++k) w[k] = sWq[i * L::QS + og + CP * k];
#pragma unroll
          for (int j = 0; j < PJ; ++j)
#pragma unroll
            for (int k = 0; k < 3; ++k) acc[j][k] = fmaf(a[j], w[k], acc[j][k]);
        }
      } else if (og < C && C % 4) {   // rows of C % 4 != 0 values: scalar loads
#pragma unroll 1
        for (int i = 0; i < C; ++i) {
          float w[3];
#pragma unroll
          for (int k = 0; k < 3; ++k) w[k] = wqkv[(long long)(og + C * k) * C + i];
#pragma unroll
          for (int j = 0; j < PJ; ++j)
#pragma unroll
            for (int k = 0; k < 3; ++k) acc[j][k] = fmaf(sX[(rg + RG * j) * CP + i], w[k], acc[j][k]);
        }
      } else if (og < C) {   // Wqkv rows og + C k, 4 of the C inputs a load
#pragma unroll 1
        for (int i = 0; i < C; i += 4) {
          float4 w[3];
#pragma unroll
          for (int k = 0; k < 3; ++k) w[k] = load4(wqkv + (long long)(og + C * k) * C + i);
#pragma unroll
          for (int j = 0; j < PJ; ++j) {
            const float4 a = *reinterpret_cast<const float4*>(sX + (rg + RG * j) * CP + i);
#pragma unroll
            for (int k = 0; k < 3; ++k)
              acc[j][k] = fmaf(a.w, w[k].w, fmaf(a.z, w[k].z, fmaf(a.y, w[k].y,
                                                                   fmaf(a.x, w[k].x, acc[j][k]))));
          }
        }
      }
#pragma unroll
      for (int j = 0; j < PJ; ++j)
#pragma unroll
        for (int k = 0; k < 3; ++k)
          sQKV[(rg + RG * j) * L::QS + og + CP * k] = acc[j][k] + sBq[og + CP * k];
    }
    __syncthreads();
    if constexpr (kStage == kQkv) {
      store_stage<CP, kPacked>(y, win0, n_windows, H, W, og, rg, qkv_sum);
      continue;
    }

    // zero-safe L2 normalize of q and k at each position
    for (int e = tid; e < 2 * L::ROWS; e += THREADS) {
      const int s = e / L::ROWS, r = e % L::ROWS;
      const float* u = sQKV + r * L::QS + s * CP;
      float ss = 0.f;
#pragma unroll 16
      for (int c = 0; c < CP; ++c) ss = fmaf(u[c], u[c], ss);
      sDen[e] = fmaxf(ss == 0.f ? 0.f : sqrtf(ss), eps);
    }
    __syncthreads();
    for (int e = tid; e < L::ROWS * 2 * CP; e += THREADS) {
      const int r = e / (2 * CP), c = e % (2 * CP);
      sQKV[r * L::QS + c] /= sDen[(c / CP) * L::ROWS + r];
    }
    __syncthreads();
    if constexpr (kStage == kNorm) {
      store_stage<CP, kPacked>(y, win0, n_windows, H, W, og, rg, qkv_sum);
      continue;
    }

    // per SR rows of the Gram qn^T kn (each window's, over its 16
    // positions): the rows, their softmax over the C real keys
    // (max-subtracted) and the apply out[r, c1] = sum_c2 A[c1, c2] v[r, c2]
    // of those c1, into sX; each thread takes channel oc at PJS consecutive
    // positions of one window. A strip of pad rows only is skipped: its
    // columns of sX keep x's zeros, and Wproj is zero there.
    constexpr int SR = L::SR, PJS = L::ROWS * SR / THREADS;
    static_assert(SR == CP || (kStage == kFull && CP % SR == 0), "strips only in the op");
    const int oc = tid % SR, rgs = tid / SR;
    for (int s0 = 0; s0 < C; s0 += SR) {
      for (int e = tid; e < L::NW * SR * CP; e += THREADS) {
        const int n = e / (SR * CP), c1 = (e / CP) % SR, c2 = e % CP;
        const float* base = sQKV + n * kP * L::QS;
        float acc = 0.f;
#pragma unroll
        for (int t = 0; t < kP; ++t)
          acc = fmaf(base[t * L::QS + s0 + c1], base[t * L::QS + CP + c2], acc);
        sG[(n * SR + c1) * L::GS + c2] = acc;
      }
      __syncthreads();

      for (int row = tid; row < L::NW * SR; row += THREADS) {
        float* g = sG + row * L::GS;
        if constexpr (kStage == kLogits) {  // the raw row's sum, into its pad slot
          float rs = 0.f;
          for (int c = 0; c < C; ++c) rs += g[c];
          g[CP] = rs;
          continue;
        }
        float m = -INFINITY;
        for (int c = 0; c < C; ++c) m = fmaxf(m, g[c]);
        float sum = 0.f;
        for (int c = 0; c < C; ++c) {
          const float ev = expf(g[c] - m);
          g[c] = ev;
          sum += ev;
        }
        for (int c = 0; c < C; ++c) g[c] = g[c] / sum;
        if constexpr (kStage == kSoftmax) {  // the softmax row's sum, into its pad slot
          float rs = 0.f;
          for (int c = 0; c < C; ++c) rs += g[c];
          g[CP] = rs;
        }
      }
      __syncthreads();
      if constexpr (kStage == kLogits || kStage == kSoftmax) {
        // v + the sum of Gram row p at position p < min(C, 16)
        store_stage<CP, kPacked>(y, win0, n_windows, H, W, og, rg, [&](int r) {
          const int p = r % kP;
          const float fold = p < (CP < kP ? CP : kP) ? sG[((r / kP) * CP + p) * L::GS + CP] : 0.f;
          return sQKV[r * L::QS + 2 * CP + og] + fold;
        });
        break;
      }

      const float* a = sG + (((rgs * PJS) / kP) * SR + oc) * L::GS;
      float acc[PJS] = {};
#pragma unroll 4
      for (int c2 = 0; c2 < C; ++c2) {
        const float g = a[c2];
#pragma unroll
        for (int j = 0; j < PJS; ++j)
          acc[j] = fmaf(g, sQKV[(rgs * PJS + j) * L::QS + 2 * CP + c2], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < PJS; ++j) sX[(rgs * PJS + j) * CP + s0 + oc] = acc[j];
      __syncthreads();   // the strip's rows are applied; sX holds them
    }
    if constexpr (kStage == kLogits || kStage == kSoftmax) continue;

    // y = out @ Wproj^T + b, stored once at the C real channels
    {
      float acc[PJ] = {};
      if constexpr (L::RESIDENT) {
#pragma unroll 4
        for (int i = 0; i < CP; ++i) {
          const float w = sWp[i * L::GS + og];
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[j] = fmaf(sX[(rg + RG * j) * CP + i], w, acc[j]);
        }
      } else if (og < C && C % 4) {   // rows of C % 4 != 0 values: scalar loads
#pragma unroll 1
        for (int i = 0; i < C; ++i) {
          const float w = wproj[(long long)og * C + i];
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[j] = fmaf(sX[(rg + RG * j) * CP + i], w, acc[j]);
        }
      } else if (og < C) {   // Wproj row og, 4 of the C inputs a load
#pragma unroll 1
        for (int i = 0; i < C; i += 4) {
          const float4 w = load4(wproj + (long long)og * C + i);
#pragma unroll
          for (int j = 0; j < PJ; ++j) {
            const float4 a = *reinterpret_cast<const float4*>(sX + (rg + RG * j) * CP + i);
            acc[j] = fmaf(a.w, w.w, fmaf(a.z, w.z, fmaf(a.y, w.y, fmaf(a.x, w.x, acc[j]))));
          }
        }
      }
      if (og < C) {
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const int r = rg + RG * j;
          const long long win = win0 + r / kP;
          if (win < n_windows)
            y[pixel_offset<kPacked>(win, r % kP, H, W) * C + og] = acc[j] + sBp[og];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: warp MMA
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

template <int CP_>
struct MmaLayout {
  // CP channels inside (16, 32, 64 or 128; m16n8k16 takes 16-deep
  // k-steps); a tensor of C < CP channels runs with zeros in the pad
  // columns of x, the weights and the biases, so q, k, v and y are zero
  // there; the pad keys of the Gram are set to -inf before the softmax, and
  // the pad rows of A meet zero columns of Wproj, so neither reaches y
  static constexpr int CP = CP_;
  static constexpr int NT = CP / 8;         // n-tiles of a CP-wide strip
  static constexpr int KT = CP / 16;        // k-steps over CP; m-tiles of the Gram
  static constexpr int CHP = CP / 8;        // 16-byte chunks of a row in shared memory
  static constexpr int XS = CP + 8;         // x / y row
  static constexpr int QS = 2 * CP + 8;     // qn | kn row, hi and lo alike
  static constexpr int WS = CP + 8;         // weight row: [4CP][WS], Wqkv then Wproj
  static constexpr int X = kP * XS;         // one x buffer of a warp (it has two)
  static constexpr int Q = kP * QS;         // qn | kn of a warp, hi or lo
  static constexpr int WARP = 2 * X + 2 * Q;
  static constexpr int W_ELEMS = 4 * CP * WS;
  // warps a block: at CP = 128 the weights take 139 KB and each warp 25.6
  // KB of the 227, so 3 warps; 8 elsewhere
  static constexpr int WARPS = CP > 64 ? 3 : kWarps;
  static constexpr int THREADS = 32 * WARPS;
  // at CP >= 64 the softmax S enters the apply and the apply's output the
  // proj as hi + lo pairs too: with one term each a saturated window at
  // C = 64 on 128^2 (c16's down2 at canvas 512, c32's down1) reaches 1.13
  // of the bf16 bound and at C = 128 0.97, with the pairs 0.68
  // (devtools/serving_kernel_rounding.py)
  static constexpr bool SPLIT_APPLY = CP >= 64;
  // bf16: weights, the warps' buffers; fp32: 4CP biases, CP row sums a warp
  static constexpr int BYTES = (W_ELEMS + WARPS * WARP) * (int)sizeof(bf16) +
                               (4 * CP + WARPS * CP) * (int)sizeof(float);
};

// acc (16 positions x CP outputs) = a w^T + bias: a as A fragments (CP / 16
// k-steps), w as CP rows [n][k] of stride WS (B fragments through ldmatrix).
template <int CP>
__device__ __forceinline__ void linear_strip(float (&acc)[MmaLayout<CP>::NT][4],
                                             const uint32_t (&a)[MmaLayout<CP>::KT][4],
                                             const bf16* w, const float* bias, int lane) {
  using L = MmaLayout<CP>;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < L::NT; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias + j * 8 + 2 * t);
    acc[j][0] = acc[j][2] = b.x;
    acc[j][1] = acc[j][3] = b.y;
  }
#pragma unroll
  for (int kk = 0; kk < L::KT; ++kk)
#pragma unroll
    for (int nb = 0; nb < L::KT; ++nb) {
      uint32_t b[4];
      ldmatrix_x4(b, w + (nb * 16 + (lane & 7) + (lane >> 4) * 8) * L::WS + kk * 16 +
                         ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * nb], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * nb + 1], a[kk], b[2], b[3]);
    }
}

// Zero-safe L2 normalize over C of the strip's two rows per lane, in place:
// u / max(|u|, eps); a zero vector stays zero (0 times the finite 1 / eps).
template <int NT>
__device__ __forceinline__ void normalize_strip(float (&u)[NT][4], float eps) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s0 = fmaf(u[j][0], u[j][0], fmaf(u[j][1], u[j][1], s0));
    s1 = fmaf(u[j][2], u[j][2], fmaf(u[j][3], u[j][3], s1));
  }
  const float i0 = 1.f / fmaxf(sqrtf(quad_sum(s0)), eps);
  const float i1 = 1.f / fmaxf(sqrtf(quad_sum(s1)), eps);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    u[j][0] *= i0;
    u[j][1] *= i0;
    u[j][2] *= i1;
    u[j][3] *= i1;
  }
}

template <int NT>
__device__ __forceinline__ void add_strip(float (&acc)[NT][4], const float (&x)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] += x[j][i];
}

// The tensors' C: kC at compile time, or `width` at run time where kC is 0.
template <int CP, bool kPacked, int kStage, int kC>
__global__ void __launch_bounds__(MmaLayout<CP>::THREADS)
window_channel_attention_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
                                    const bf16* __restrict__ bqkv,
                                    const bf16* __restrict__ wproj,
                                    const bf16* __restrict__ bproj, bf16* __restrict__ y, int H,
                                    int W, long long n_windows, int width, float eps) {
  using L = MmaLayout<CP>;
  constexpr int WARPS = L::WARPS;
  const int C = kC ? kC : width;
  const int CH = C / 8;   // 16-byte chunks of a position in x and y
  // rows of C % 8 != 0 values (kC = 0 only) are not 16-byte aligned: x, y
  // and the weights move a value at a time there
  const bool vec = kC != 0 || C % 8 == 0;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* sW = reinterpret_cast<bf16*>(smem_mma);                   // [4CP][WS]
  bf16* sWarps = sW + L::W_ELEMS;
  float* sBias = reinterpret_cast<float*>(sWarps + WARPS * L::WARP);   // bqkv, bproj
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  bf16* sX = sWarps + warp * L::WARP;     // [2][16][XS]
  bf16* sQK = sX + 2 * L::X;              // [16][QS]: qn, kn hi
  bf16* sLO = sQK + L::Q;                 // [16][QS]: qn, kn lo
  [[maybe_unused]] float* sRow = sBias + 4 * CP + warp * CP;   // Gram row sums (stages)

  // the window at `base` (window_base): x into a buffer of the warp, 16
  // bytes a copy from rows of C; the pad columns as zeros
  auto stage = [&](long long base, bf16* dst) {
    const bf16* src = x + base * C;
    if (!vec && C % 4 == 0) {   // rows of 8-byte multiples: 8-byte copies
      for (int e = lane; e < kP * CP / 4; e += 32) {
        const int p = e / (CP / 4), c = e % (CP / 4);
        const bool real = c * 4 < C;
        cp_async8(dst + p * L::XS + c * 4,
                  src + position_offset<kPacked>(p, W) * C + (real ? c * 4 : 0), real);
      }
      return;
    }
    if (!vec) {
      for (int e = lane; e < kP * CP; e += 32) {
        const int p = e / CP, c = e % CP;
        dst[p * L::XS + c] = c < C ? src[position_offset<kPacked>(p, W) * C + c]
                                   : __float2bfloat16(0.f);
      }
      return;
    }
#pragma unroll
    for (int e = lane; e < kP * L::CHP; e += 32) {
      const int p = e / L::CHP, c = e % L::CHP;
      const bool real = c < CH;
      cp_async16(dst + p * L::XS + c * 8,
                 src + position_offset<kPacked>(p, W) * C + (real ? c * 8 : 0), real);
    }
  };
  // fragments (16 positions x C) through the buffer to the window in y
  auto store = [&](long long base, bf16* buf, const float (&frags)[L::NT][4]) {
    if constexpr (kStage != kCopy) {
      store_frags<L::NT>(buf, nullptr, L::XS, 0, 0, frags, 1.f, lane);
      __syncwarp();
    }
    bf16* dst = y + base * C;
    if (!vec && C % 4 == 0) {   // 8-byte stores
      for (int e = lane; e < kP * C / 4; e += 32) {
        const int p = e / (C / 4), c = e % (C / 4);
        *reinterpret_cast<uint2*>(dst + position_offset<kPacked>(p, W) * C + c * 4) =
            *reinterpret_cast<const uint2*>(buf + p * L::XS + c * 4);
      }
      return;
    }
    if (!vec) {
      for (int e = lane; e < kP * C; e += 32) {
        const int p = e / C, c = e % C;
        dst[position_offset<kPacked>(p, W) * C + c] = buf[p * L::XS + c];
      }
      return;
    }
    for (int e = lane; e < kP * CH; e += 32) {
      const int p = e / CH, c = e % CH;
      *reinterpret_cast<uint4*>(dst + position_offset<kPacked>(p, W) * C + c * 8) =
          *reinterpret_cast<const uint4*>(buf + p * L::XS + c * 8);
    }
  };

  // the weights: row i of each CP-row block (q, k, v, proj), column chunk
  // c; zeros in the pads
  if (!vec) {
    for (int e = tid; e < 4 * CP * CP; e += L::THREADS) {
      const int r = e / CP, c = e % CP, blk = r / CP, i = r % CP;
      const bf16* src = blk < 3 ? wqkv + (blk * C + i) * C : wproj + i * C;
      sW[r * L::WS + c] = i < C && c < C ? src[c] : __float2bfloat16(0.f);
    }
  }
  for (int e = tid; vec && e < 4 * CP * L::CHP; e += L::THREADS) {
    const int r = e / L::CHP, c = e % L::CHP, blk = r / CP, i = r % CP;
    const bool real = i < C && c < CH;
    const bf16* src = blk < 3 ? wqkv + (blk * C + i) * C : wproj + i * C;
    cp_async16(sW + r * L::WS + c * 8, real ? src + c * 8 : wqkv, real);
  }
  for (int e = tid; e < 4 * CP; e += L::THREADS) {
    const int blk = e / CP, i = e % CP;
    sBias[e] = i < C ? to_f(blk < 3 ? bqkv[blk * C + i] : bproj[i]) : 0.f;
  }

  // windows as int: the launcher refuses more than INT_MAX of them
  const int n = (int)n_windows, stride = (int)gridDim.x * WARPS;
  int win = (int)blockIdx.x * WARPS + warp;
  long long base = 0, next_base = 0;
  if (win < n) stage(base = window_base<kPacked, int>(win, H, W), sX);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();   // the weights; the only block barrier

  for (int cur = 0; win < n; win += stride, cur ^= 1, base = next_base) {
    bf16* xs = sX + cur * L::X;
    if (win < n - stride)
      stage(next_base = window_base<kPacked, int>(win + stride, H, W),
            sX + (cur ^ 1) * L::X);
    cp_async_commit();
    cp_async_wait<1>();   // all but the copy just started: this window is in
    __syncwarp();
    float u[L::NT][4];    // q, then k, then the folds and y
    if constexpr (kStage == kCopy) {
      store(base, xs, u);
      __syncwarp();
      continue;
    }
    uint32_t xa[L::KT][4];
#pragma unroll
    for (int kk = 0; kk < L::KT; ++kk)
      ldmatrix_x4(xa[kk], xs + (lane & 15) * L::XS + kk * 16 + (lane >> 4) * 8);

    // q and k: normalized, to shared memory as hi + lo
    [[maybe_unused]] float fold[L::NT][4] = {};
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      linear_strip<CP>(u, xa, sW + s * CP * L::WS, sBias + s * CP, lane);
      if constexpr (kStage > kQkv) {
        normalize_strip(u, eps);
        store_frags<L::NT>(sQK, sLO, L::QS, 0, s * CP, u, 1.f, lane);
      }
      if constexpr (kStage <= kNorm) add_strip(fold, u);
    }
    float v[L::NT][4];
    linear_strip<CP>(v, xa, sW + 2 * CP * L::WS, sBias + 2 * CP, lane);
    if constexpr (kStage <= kNorm) {
      add_strip(fold, v);
      store(base, xs, fold);
      __syncwarp();
      continue;
    }
    __syncwarp();   // qn, kn are in

    uint32_t va[L::KT][4];
#pragma unroll
    for (int kk = 0; kk < L::KT; ++kk) frags_to_a(va[kk], v[2 * kk], v[2 * kk + 1]);
    {   // y starts from the proj bias
      const int t = lane & 3;
#pragma unroll
      for (int j = 0; j < L::NT; ++j) {
        const float2 b = *reinterpret_cast<const float2*>(sBias + 3 * CP + j * 8 + 2 * t);
        u[j][0] = u[j][2] = b.x;
        u[j][1] = u[j][3] = b.y;
      }
    }
#pragma unroll
    for (int mt = 0; mt < L::KT; ++mt) {
      // rows 16 mt.. of the Gram and of its softmax; a strip of pad rows
      // only adds nothing to y (Wproj is zero there) and is skipped
      if (mt * 16 >= C) break;
      float a[L::NT][4];
      gram_strip<CP>(a, sQK, L::QS, sLO, L::QS, mt, lane);
      if constexpr (kC != 0) {
        if (CH < L::NT) {   // the pad keys drop out of the softmax
#pragma unroll
          for (int j = 0; j < L::NT; ++j)
            if (j >= CH) a[j][0] = a[j][1] = a[j][2] = a[j][3] = -INFINITY;
        }
      } else if (C < CP) {   // the same key by key: C need not fill an n-tile
        const int c0 = 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < L::NT; ++j) {
          if (j * 8 + c0 >= C) a[j][0] = a[j][2] = -INFINITY;
          if (j * 8 + c0 + 1 >= C) a[j][1] = a[j][3] = -INFINITY;
        }
      }
      if constexpr (kStage != kLogits) softmax_strip<L::NT, true>(a);   // __expf: y is bf16
      if constexpr (kStage != kFull) {   // every row's sum, to shared memory
        float r0 = 0.f, r1 = 0.f;
#pragma unroll
        for (int j = 0; j < L::NT; ++j) {
          r0 += a[j][0] + a[j][1];
          r1 += a[j][2] + a[j][3];
        }
        r0 = quad_sum(r0);
        r1 = quad_sum(r1);
        if ((lane & 3) == 0) {
          sRow[mt * 16 + (lane >> 2)] = r0;
          sRow[mt * 16 + (lane >> 2) + 8] = r1;
        }
        continue;
      }
      // out[p][c1], c1 in 16 mt.. = sum_c2 v[p][c2] A[c1][c2]: A's C
      // fragments are the B fragments (B[k][n] = A[n][k])
      float o[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < L::KT; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if constexpr (L::SPLIT_APPLY) {
            uint32_t h0, l0, h1, l1;
            pack_bf16_split(a[2 * kk][2 * h], a[2 * kk][2 * h + 1], h0, l0);
            pack_bf16_split(a[2 * kk + 1][2 * h], a[2 * kk + 1][2 * h + 1], h1, l1);
            mma_bf16(o[h], va[kk], h0, h1);
            mma_bf16(o[h], va[kk], l0, l1);
          } else {
            mma_bf16(o[h], va[kk], pack_bf16(a[2 * kk][2 * h], a[2 * kk][2 * h + 1]),
                     pack_bf16(a[2 * kk + 1][2 * h], a[2 * kk + 1][2 * h + 1]));
          }
        }
      // ... which is k-step mt of y = out Wproj^T
      uint32_t oa[4];
      [[maybe_unused]] uint32_t ol[4];
      if constexpr (L::SPLIT_APPLY) frags_to_a_split(oa, ol, o[0], o[1]);
      else frags_to_a(oa, o[0], o[1]);
#pragma unroll
      for (int nb = 0; nb < L::KT; ++nb) {
        uint32_t b[4];
        ldmatrix_x4(b, sW + (3 * CP + nb * 16 + (lane & 7) + (lane >> 4) * 8) * L::WS + mt * 16 +
                           ((lane >> 3) & 1) * 8);
        mma_bf16(u[2 * nb], oa, b[0], b[1]);
        mma_bf16(u[2 * nb + 1], oa, b[2], b[3]);
        if constexpr (L::SPLIT_APPLY) {
          mma_bf16(u[2 * nb], ol, b[0], b[1]);
          mma_bf16(u[2 * nb + 1], ol, b[2], b[3]);
        }
      }
    }
    if constexpr (kStage != kFull) {
      // v + the sum of Gram row p at position p (C >= 16: every position)
      __syncwarp();
      const float f0 = sRow[lane >> 2], f1 = sRow[(lane >> 2) + 8];
#pragma unroll
      for (int j = 0; j < L::NT; ++j) {
        v[j][0] += f0;
        v[j][1] += f0;
        v[j][2] += f1;
        v[j][3] += f1;
      }
      store(base, xs, v);
    } else {
      store(base, xs, u);
    }
    __syncwarp();   // the buffer is free for the copy after next
  }
}

// ---------------------------------------------------------------------------
// bf16 at C = 129 .. 512: the weights streamed
// ---------------------------------------------------------------------------
//
// The layouts of CP = 256 channels (the c64 generator's down2; C = 160, 192
// and 224 of the c40, c48 and c56 generators run in it, padded) and CP =
// 512 (the down2 of the c65 .. c128 generators, C = 260 .. 512). Wqkv and
// Wproj as bf16 rows are 4CP x (CP + 8) = 541 KB at CP = 256, past the 227
// KB a block may hold, and a warp that owned a window's 16 x CP strips (q,
// k, v, the proj's sums, a Gram strip) would hold 128 fp32 values a thread
// in each. So a block of 8 warps takes WINDOWS windows at a time (two at CP
// = 256: 32 positions, two m-tiles; one at CP = 512, whose two windows'
// buffers would need ~406 KB) through three phases, every intermediate in
// shared memory, and the weights pass through it in tiles of 64 rows
// (double-buffered 16-byte cp.async, one block barrier a tile, each tile
// used by every window of the block; the first tile of the next unit is
// copied while the last is used). A tile holds the whole width of its rows
// at CP = 256 and half of it at CP = 512 (KSPLIT = 2 tiles a 64-row block,
// the sums kept in registers between them). Of each of q, k, v and proj
// only the ceil(C / 64) row blocks that hold a real row pass (zero-filled
// past C), and the products take ceil(C / 16) k-steps:
//   qkv   3 ceil(C / 64) row blocks of Wqkv (12 at C = 256). Each warp
//         computes 16 positions (window w / (8 / WINDOWS)) x OPW outputs
//         (16 at CP = 256, 8 at CP = 512) of a row block, k-steps from the
//         staged x. q and k go to shared memory raw as hi + lo pairs and
//         are normalized from those pairs afterwards (a warp a row: 1 /
//         max(|u|, eps), so a zero vector stays zero) and split again; v is
//         a pair too.
//   Gram  each window's ceil(C / 16) strips of 16 query channels, shared
//         out over the window's warps, keys in chunks of 64: the scores (hi
//         hi + hi lo + lo hi), their exponentials and at once the apply
//         out[p][c1] += sum_c2 v[p][c2] e[c1][c2] (v and e both as pairs:
//         three products). The exponentials are taken at the fixed shift 16
//         instead of the row max: qn and kn are unit vectors (or zero) at
//         each of 16 positions, so every logit lies in [-16, 16], exp(g -
//         16) >= exp(-32) stays a normal fp32 value, and no running max or
//         rescale is needed over any number of key chunks; a pad key's
//         exponential is 0 (its logit -inf). The row sums (quad sums) divide
//         the strip of out at the end (a shuffle brings row c1's sum to the
//         lanes that hold column c1), and it goes to shared memory as hi +
//         lo.
//   proj  ceil(C / 64) row blocks of Wproj on out (hi + lo); y + bias leaves
//         as bf16 pairs at the C real columns.
// Operands rounded to bf16 inside: every one the kernel forms is a hi + lo
// pair (q, k, qn, kn, v, the exponentials, out). With v as one term a
// saturated window on the 64^2 grid reaches 0.83 of the bf16 bound, with the
// pair 0.67 (devtools/serving_kernel_rounding.py).
template <int CP_>
struct WideLayout {
  static constexpr int CP = CP_;
  static_assert(CP == 256 || CP == 512, "the streamed layouts");
  static constexpr int WINDOWS = CP > 256 ? 1 : 2;   // windows a block takes at a time
  static constexpr int KSPLIT = CP > 256 ? 2 : 1;    // tiles a 64-row block of weights
  static constexpr int ROWS = WINDOWS * kP;     // positions: one m-tile a window
  static constexpr int TILE_ROWS = 64;          // weight rows a tile
  static constexpr int TK = CP / KSPLIT;        // weight columns a tile
  static constexpr int TS = TK + 8;             // tile rows: 528 bytes
  static constexpr int XS = CP + 8;             // rows of CP values: 528 or 1040 bytes
  static constexpr int QS = 2 * CP + 8;         // q | k rows: 1040 or 2064 bytes
  static constexpr int CH = CP / 8;             // 16-byte chunks of a row
  static constexpr int TCH = TK / 8;            // 16-byte chunks of a tile row
  static constexpr int WPW = kWarps / WINDOWS;  // warps a window
  static constexpr int OPW = TILE_ROWS / WPW;   // outputs of a tile a warp: 16 or 8
  static constexpr int NJ = OPW / 8;            // their n-tiles
  static constexpr int TILE = TILE_ROWS * TS;
  static constexpr int W = 0;                   // [2][64][TS] weight tiles
  static constexpr int X = W + 2 * TILE;        // [ROWS][XS] x; later out hi
  static constexpr int OL = X + ROWS * XS;      // [ROWS][XS] out lo
  static constexpr int QH = OL + ROWS * XS;     // [ROWS][QS] q | k hi
  static constexpr int QL = QH + ROWS * QS;     // [ROWS][QS] q | k lo
  static constexpr int VH = QL + ROWS * QS;     // [ROWS][XS] v hi
  static constexpr int VL = VH + ROWS * XS;     // [ROWS][XS] v lo
  static constexpr int ELEMS = VL + ROWS * XS;
  static constexpr int BYTES = ELEMS * (int)sizeof(bf16) + 4 * CP * (int)sizeof(float);
};

// The tensors' C: kC at compile time, or `width` at run time where kC is 0.
template <int CP, bool kPacked, int kC>
__global__ void __launch_bounds__(kThreads, 1)
window_channel_attention_wide_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
                                     const bf16* __restrict__ bqkv,
                                     const bf16* __restrict__ wproj,
                                     const bf16* __restrict__ bproj, bf16* __restrict__ y, int H,
                                     int W, long long n_windows, int width, float eps) {
  using L = WideLayout<CP>;
  constexpr int XS = L::XS, QS = L::QS, TS = L::TS, NJ = L::NJ, KS = L::KSPLIT;
  constexpr int KT_TILE = L::TK / 16;   // k-steps of a tile
  const int C = kC ? kC : width;
  // rows of C % 8 != 0 values (kC = 0 only) move a value at a time
  const bool vec = kC != 0 || C % 8 == 0;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* sW = reinterpret_cast<bf16*>(smem_mma) + L::W;
  bf16* sX = reinterpret_cast<bf16*>(smem_mma) + L::X;    // x, then out hi
  bf16* sOL = reinterpret_cast<bf16*>(smem_mma) + L::OL;
  bf16* sQH = reinterpret_cast<bf16*>(smem_mma) + L::QH;
  bf16* sQL = reinterpret_cast<bf16*>(smem_mma) + L::QL;
  bf16* sVH = reinterpret_cast<bf16*>(smem_mma) + L::VH;
  bf16* sVL = reinterpret_cast<bf16*>(smem_mma) + L::VL;
  float* sBias = reinterpret_cast<float*>(reinterpret_cast<bf16*>(smem_mma) + L::ELEMS);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  // the products: the warp's window (m-tile) and its OPW outputs of a tile
  const int mt = warp / L::WPW, np = warp % L::WPW;
  const int CH = C / 8;                                   // real 16-byte chunks of a row
  const int tpb = (C + L::TILE_ROWS - 1) / L::TILE_ROWS;  // row blocks of q, k, v or proj
  const int tiles_qkv = 3 * tpb * KS, tiles = 4 * tpb * KS;
  const int kt = (C + 15) / 16;                           // k-steps; query strips

  // weight tile t into buffer t & 1: rows 64 (u % tpb).. of block u / tpb
  // (q, k, v of Wqkv, then Wproj), u = t / KSPLIT, the columns of its part
  // t % KSPLIT; zeros past C
  auto load_tile = [&](int t) {
    const int u = t / KS, c0 = (t % KS) * L::TK;
    const int blk = u / tpb, i0 = (u % tpb) * L::TILE_ROWS;
    bf16* dst = sW + (t & 1) * L::TILE;
    for (int e = tid; !vec && C % 4 == 0 && e < L::TILE_ROWS * L::TK / 4; e += kThreads) {
      const int r = e / (L::TK / 4), c = c0 + (e % (L::TK / 4)) * 4, i = i0 + r;
      const bool real = i < C && c < C;
      const bf16* src = blk < 3 ? wqkv + (long long)(blk * C + i) * C : wproj + (long long)i * C;
      cp_async8(dst + r * TS + c - c0, real ? src + c : wqkv, real);
    }
    for (int e = tid; !vec && C % 4 && e < L::TILE_ROWS * L::TK; e += kThreads) {
      const int r = e / L::TK, c = c0 + e % L::TK, i = i0 + r;
      const bf16* src = blk < 3 ? wqkv + (long long)(blk * C + i) * C : wproj + (long long)i * C;
      dst[r * TS + c - c0] = i < C && c < C ? src[c] : __float2bfloat16(0.f);
    }
    for (int e = tid; vec && e < L::TILE_ROWS * L::TCH; e += kThreads) {
      const int r = e / L::TCH, c = c0 + (e % L::TCH) * 8, i = i0 + r;
      const bool real = kC == CP || (i < C && c < C);
      const bf16* src = blk < 3 ? wqkv + (long long)(blk * C + i) * C : wproj + (long long)i * C;
      cp_async16(dst + r * TS + c - c0, real ? src + c : wqkv, real);
    }
  };
  for (int e = tid; e < 4 * CP; e += kThreads) {
    const int blk = e / CP, i = e % CP;
    sBias[e] = i < C ? to_f(blk < 3 ? bqkv[blk * C + i] : bproj[i]) : 0.f;
  }

  const long long n_units = (n_windows + L::WINDOWS - 1) / L::WINDOWS;
  if ((long long)blockIdx.x < n_units) load_tile(0);
  cp_async_commit();
  for (long long unit = blockIdx.x; unit < n_units; unit += gridDim.x) {
    const long long win0 = unit * L::WINDOWS;
    __syncthreads();   // the previous unit is done with sX (its out hi)
    // the windows' x, 16 bytes a copy from rows of C; pads and a window past
    // the end as zeros
    for (int e = tid; !vec && C % 4 == 0 && e < L::ROWS * CP / 4; e += kThreads) {
      const int r = e / (CP / 4), c = e % (CP / 4);
      const long long win = win0 + r / kP;
      const bool ok = win < n_windows && c * 4 < C;
      cp_async8(sX + r * XS + c * 4,
                x + (ok ? pixel_offset<kPacked>(win, r % kP, H, W) * C + c * 4 : 0), ok);
    }
    for (int e = tid; !vec && C % 4 && e < L::ROWS * CP; e += kThreads) {
      const int r = e / CP, c = e % CP;
      const long long win = win0 + r / kP;
      sX[r * XS + c] = win < n_windows && c < C
                           ? x[pixel_offset<kPacked>(win, r % kP, H, W) * C + c]
                           : __float2bfloat16(0.f);
    }
    for (int e = tid; vec && e < L::ROWS * L::CH; e += kThreads) {
      const int r = e / L::CH, c = e % L::CH;
      const long long win = win0 + r / kP;
      const bool ok = win < n_windows && c < CH;
      cp_async16(sX + r * XS + c * 8,
                 x + (ok ? pixel_offset<kPacked>(win, r % kP, H, W) * C + c * 8 : 0), ok);
    }
    cp_async_commit();

    float acc[NJ][4];   // 16 positions x OPW outputs, over the KSPLIT tiles of a row block
#pragma unroll 1
    for (int t = 0; t < tiles; ++t) {
      cp_async_wait<0>();
      __syncthreads();   // tile t (and x) are in; every warp is done with tile t - 1
      if (t + 1 < tiles) load_tile(t + 1);
      else if (unit + gridDim.x < n_units) load_tile(0);
      cp_async_commit();
      const bf16* tile = sW + (t & 1) * L::TILE;
      const int u = t / KS, part = t % KS;
      const int blk = u / tpb;   // 0 q, 1 k, 2 v, 3 proj
      const bool proj = blk == 3;
      // 16 positions x OPW outputs of this row block: bias, then the k-steps
      const int o0 = (u % tpb) * L::TILE_ROWS + np * L::OPW;
      if (part == 0) {
        const float* bias = sBias + blk * CP + o0;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float2 b = *reinterpret_cast<const float2*>(bias + j * 8 + 2 * tq);
          acc[j][0] = acc[j][2] = b.x;
          acc[j][1] = acc[j][3] = b.y;
        }
      }
      const int k0 = part * KT_TILE, k1 = kt < k0 + KT_TILE ? kt : k0 + KT_TILE;
#pragma unroll 4
      for (int kk = k0; kk < k1; ++kk) {
        uint32_t b[4], a[4];
        const int kl = kk - k0;   // the k-step within the tile
        if constexpr (NJ == 2) {
          ldmatrix_x4(b, tile + (np * 16 + (lane & 7) + (lane >> 4) * 8) * TS + kl * 16 +
                             ((lane >> 3) & 1) * 8);
        } else {
          uint32_t b2[2];
          ldmatrix_x2(b2, tile + (np * 8 + (lane & 7)) * TS + kl * 16 + ((lane >> 3) & 1) * 8);
          b[0] = b2[0];
          b[1] = b2[1];
        }
        const int aoff = (mt * 16 + (lane & 15)) * XS + kk * 16 + (lane >> 4) * 8;
        ldmatrix_x4(a, sX + aoff);
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_bf16(acc[j], a, b[2 * j], b[2 * j + 1]);
        if (proj) {   // out's lo part
          ldmatrix_x4(a, sOL + aoff);
#pragma unroll
          for (int j = 0; j < NJ; ++j) mma_bf16(acc[j], a, b[2 * j], b[2 * j + 1]);
        }
      }
      if (part + 1 < KS) continue;   // the row block's sums go on in the next tile

      if (proj) {   // y, where the window and the column exist
        const long long win = win0 + mt;
        if (win < n_windows) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            bf16* row = y + pixel_offset<kPacked>(win, g + 8 * hh, H, W) * C + o0 + 2 * tq;
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              const int c = o0 + j * 8 + 2 * tq;
              if (!vec && C % 2 == 0) {   // pairs (4-byte aligned), the real columns
                if (c < C)
                  *reinterpret_cast<uint32_t*>(row + j * 8) =
                      pack_bf16(acc[j][2 * hh], acc[j][2 * hh + 1]);
              } else if (!vec) {   // value by value, the real columns only
                if (c < C) row[j * 8] = __float2bfloat16(acc[j][2 * hh]);
                if (c + 1 < C) row[j * 8 + 1] = __float2bfloat16(acc[j][2 * hh + 1]);
              } else if (o0 + j * 8 < C) {
                *reinterpret_cast<uint32_t*>(row + j * 8) =
                    pack_bf16(acc[j][2 * hh], acc[j][2 * hh + 1]);
              }
            }
          }
        }
        continue;
      }
      // q and k raw into q | k, v into v, all as hi + lo
      if (blk < 2)
        store_frags<NJ>(sQH, sQL, QS, mt * 16, blk * CP + o0, acc, 1.f, lane);
      else
        store_frags<NJ>(sVH, sVL, XS, mt * 16, o0, acc, 1.f, lane);
      if (t + 1 < tiles_qkv) continue;

      // the last qkv tile: normalize every q and k row from its pair, a
      // warp a row, 8 channels a lane in each 256-channel part of the row
      // (the real ones; the tiles wrote the rest of the first 64
      // ceil(C / 64) as zeros), and split it again
      __syncthreads();
      constexpr int NP = CP / 256;   // 256-channel parts of a row
      for (int v = warp; v < 2 * L::ROWS; v += kWarps) {
        uint4 hu[NP], lu[NP];
        float u[NP][8], ss = 0.f;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const int off = (v >> 1) * QS + (v & 1) * CP + p * 256 + lane * 8;
          hu[p] = lu[p] = make_uint4(0u, 0u, 0u, 0u);
          if (p * 256 + lane * 8 < C) {
            hu[p] = *reinterpret_cast<const uint4*>(sQH + off);
            lu[p] = *reinterpret_cast<const uint4*>(sQL + off);
          }
          const bf16* hp = reinterpret_cast<const bf16*>(&hu[p]);
          const bf16* lp = reinterpret_cast<const bf16*>(&lu[p]);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            u[p][i] = __bfloat162float(hp[i]) + __bfloat162float(lp[i]);
            ss = fmaf(u[p][i], u[p][i], ss);
          }
        }
        const float inv = 1.f / fmaxf(sqrtf(warp_sum(ss)), eps);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          uint32_t* ho = reinterpret_cast<uint32_t*>(&hu[p]);
          uint32_t* lo = reinterpret_cast<uint32_t*>(&lu[p]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            pack_bf16_split(u[p][2 * i] * inv, u[p][2 * i + 1] * inv, ho[i], lo[i]);
          if (p * 256 + lane * 8 < C) {
            const int off = (v >> 1) * QS + (v & 1) * CP + p * 256 + lane * 8;
            *reinterpret_cast<uint4*>(sQH + off) = hu[p];
            *reinterpret_cast<uint4*>(sQL + off) = lu[p];
          }
        }
      }
      __syncthreads();

      // the Gram strips of window mt: 16 query channels c1 = 16 s.. each
      const bf16* qh = sQH + mt * kP * QS;
      const bf16* ql = sQL + mt * kP * QS;
      const bf16* vh = sVH + mt * kP * XS;
      const bf16* vl = sVL + mt * kP * XS;
#pragma unroll 1
      for (int s = np; s < kt; s += L::WPW) {
        // A[c1][p] = qn[p][c1] through ldmatrix.trans
        uint32_t ah[4], al[4];
        const int aoff = ((lane & 7) + (lane >> 4) * 8) * QS + s * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(ah, qh + aoff);
        ldmatrix_x4_trans(al, ql + aoff);
        float o[2][4] = {};
        float l0 = 0.f, l1 = 0.f;   // the row sums of rows g and g + 8
#pragma unroll 1
        for (int kc = 0; kc < tpb; ++kc) {
          float e[8][4];
#pragma unroll
          for (int j = 0; j < 8; ++j) e[j][0] = e[j][1] = e[j][2] = e[j][3] = 0.f;
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) {
            const int boff = ((lane & 7) + ((lane >> 3) & 1) * 8) * QS + CP + kc * 64 + nb * 16 +
                             (lane >> 4) * 8;
            uint32_t bh[4], bl[4];
            ldmatrix_x4_trans(bh, qh + boff);
            ldmatrix_x4_trans(bl, ql + boff);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              mma_bf16(e[2 * nb + h], ah, bh[2 * h], bh[2 * h + 1]);
              mma_bf16(e[2 * nb + h], ah, bl[2 * h], bl[2 * h + 1]);
              mma_bf16(e[2 * nb + h], al, bh[2 * h], bh[2 * h + 1]);
            }
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            // a pad key's exponential is 0 (key by key: C need not fill an n-tile)
            const int key = kc * 64 + j * 8 + 2 * tq;
#pragma unroll
            for (int i = 0; i < 4; ++i)
              e[j][i] = key + (i & 1) < C ? __expf(e[j][i] - 16.f) : 0.f;   // y is bf16
            l0 += e[j][0] + e[j][1];
            l1 += e[j][2] + e[j][3];
          }
          // out[p][c1] += v[p][c2] e[c1][c2] over the chunk's 64 keys: e's C
          // fragments are the B fragments (B[k][n] = e[n][k])
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            uint32_t va[4], vb[4];
            const int voff = (lane & 15) * XS + kc * 64 + kk * 16 + (lane >> 4) * 8;
            ldmatrix_x4(va, vh + voff);
            ldmatrix_x4(vb, vl + voff);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              uint32_t h0, q0, h1, q1;
              pack_bf16_split(e[2 * kk][2 * h], e[2 * kk][2 * h + 1], h0, q0);
              pack_bf16_split(e[2 * kk + 1][2 * h], e[2 * kk + 1][2 * h + 1], h1, q1);
              mma_bf16(o[h], va, h0, h1);
              mma_bf16(o[h], va, q0, q1);
              mma_bf16(o[h], vb, h0, h1);
            }
          }
        }
        // column c1 = 8 h + 2 tq + i of o is row c1 of the strip, whose sum
        // lanes 4 (2 tq + i) hold (l0 for h = 0, l1 for h = 1)
        l0 = quad_sum(l0);
        l1 = quad_sum(l1);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float r0 = 1.f / __shfl_sync(0xffffffffu, l0, 4 * (2 * tq + i));
          const float r1 = 1.f / __shfl_sync(0xffffffffu, l1, 4 * (2 * tq + i));
          o[0][i] *= r0;
          o[0][i + 2] *= r0;
          o[1][i] *= r1;
          o[1][i + 2] *= r1;
        }
        store_frags<2>(sX, sOL, XS, mt * 16, s * 16, o, 1.f, lane);
      }
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------

// One launch in the layout of CP channels for a tensor of C <= CP. Each bf16
// kernel is built twice per layout: with C folded in at compile time (kC =
// C: the widths the layout was made for, as fast as before C was a runtime
// value, and C = 8 in the CP = 16 layout) and with the runtime C (kC = 0)
// for every other width, C % 8 != 0 included. fp32 (a checking path) takes
// C at run time only.
template <typename T, int CP, bool kPacked, int kStage, int kC>
int launch(const void* x, const void* wqkv, const void* bqkv, const void* wproj,
           const void* bproj, void* y, int H, int W, long long n_windows, int C, float eps,
           cudaStream_t stream) {
  constexpr bool kFloat = sizeof(T) == sizeof(float);
  constexpr bool kWide = !kFloat && CP > 128;
  static_assert(kFloat || CP >= 16, "bf16 layouts start at 16 channels");
  static_assert(!kWide || kStage == kFull, "CP = 256 and 512: the op only");
  using WL = WideLayout<kWide ? CP : 256>;
  auto kernel = [] {
    if constexpr (kFloat) return window_channel_attention_f32_kernel<CP, kPacked, kStage>;
    else if constexpr (kWide) return window_channel_attention_wide_kernel<CP, kPacked, kC>;
    else return window_channel_attention_mma_kernel<CP, kPacked, kStage, kC>;
  }();
  // units of work a block strides over: tiles of NW windows (fp32), rounds
  // of one window per warp (bf16), pairs of windows (bf16, CP = 256), one
  // window (bf16, CP = 512)
  constexpr int smem = kFloat  ? Layout<CP>::TOTAL * (int)sizeof(float)
                       : kWide ? WL::BYTES
                               : MmaLayout<CP>::BYTES;
  constexpr int per_unit = kFloat ? Layout<CP>::NW : kWide ? WL::WINDOWS : MmaLayout<CP>::WARPS;
  constexpr int threads = kFloat ? Layout<CP>::THREADS : kWide ? kThreads : MmaLayout<CP>::THREADS;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (!kFloat && n_windows > INT_MAX - (1 << 20)) return (int)cudaErrorInvalidValue;
  static int sms = 0, blocks_per_sm = 0;   // asked once per instantiation
  if (sms == 0) {
    const int rc = residency(kernel, threads, smem, &sms, &blocks_per_sm);
    if (rc != 0) return rc;
  }
  // At CP = 16 (C = 8 and 16) the weights are 3-4 KB, cheaper to stage four
  // times than a static share of the work is to balance: four blocks per
  // resident slot there (5-8% faster at batch 64 and at canvas 512), one
  // elsewhere.
  constexpr int kWaves = CP <= 16 ? 4 : 1;
  const int grid = persistent_grid((n_windows + per_unit - 1) / per_unit, sms,
                                   blocks_per_sm * kWaves);
  kernel<<<(unsigned)grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv), static_cast<const T*>(bqkv),
      static_cast<const T*>(wproj), static_cast<const T*>(bproj), static_cast<T*>(y),
      H, W, n_windows, C, eps);
  return (int)cudaGetLastError();
}

// With kAllWidths (the production entry points) any C from 1 to 512, in the
// layout of the next power of two from 8 (fp32) or 16 (bf16);
// without (the stage kernels) C = 16, 32 and 64, unpadded.
template <bool kPacked, int kStage, bool kAllWidths, typename T>
int launch_c(const void* x, const void* wqkv, const void* bqkv, const void* wproj,
             const void* bproj, void* y, int H, int W, long long n_windows, int C,
             float eps, cudaStream_t stream) {
  auto go = [&](auto cp) {
    constexpr int CP = decltype(cp)::value;
    auto with = [&](auto kc) {   // kc: C folded in, or 0 (C at run time)
      return launch<T, CP, kPacked, kStage, decltype(kc)::value>(
          x, wqkv, bqkv, wproj, bproj, y, H, W, n_windows, C, eps, stream);
    };
    if constexpr (sizeof(T) == sizeof(float)) return with(std::integral_constant<int, 0>{});
    else if constexpr (!kAllWidths) return with(std::integral_constant<int, CP>{});
    else {
      if (C == CP) return with(std::integral_constant<int, CP>{});
      // below CP: C = 8 in the CP = 16 layout, or any other width in the
      // layout above it (C at run time)
      if constexpr (CP == 16)
        if (C == 8) return with(std::integral_constant<int, 8>{});
      return with(std::integral_constant<int, 0>{});
    }
  };
  using std::integral_constant;
  if constexpr (!kAllWidths) {
    switch (C) {
      case 16: return go(integral_constant<int, 16>{});
      case 32: return go(integral_constant<int, 32>{});
      case 64: return go(integral_constant<int, 64>{});
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    if (C < 1 || C > 512) return (int)cudaErrorInvalidValue;
    if constexpr (sizeof(T) == sizeof(float))
      if (C <= 8) return go(integral_constant<int, 8>{});
    if (C <= 16) return go(integral_constant<int, 16>{});
    if (C <= 32) return go(integral_constant<int, 32>{});
    if (C <= 64) return go(integral_constant<int, 64>{});
    if (C <= 128) return go(integral_constant<int, 128>{});
    if (C <= 256) return go(integral_constant<int, 256>{});
    return go(integral_constant<int, 512>{});
  }
}

template <bool kPacked, int kStage, bool kAllWidths = false>
int launch_dtype(const void* x, const void* wqkv, const void* bqkv, const void* wproj,
                 const void* bproj, void* y, int H, int W, long long n_windows, int C,
                 int dtype, float eps, int device, void* stream) {
  if (n_windows <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_c<kPacked, kStage, kAllWidths, float>(x, wqkv, bqkv, wproj, bproj, y, H, W,
                                                        n_windows, C, eps, s);
  if (dtype == kBF16)
    return launch_c<kPacked, kStage, kAllWidths, __nv_bfloat16>(x, wqkv, bqkv, wproj, bproj, y,
                                                                H, W, n_windows, C, eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace mstgan
