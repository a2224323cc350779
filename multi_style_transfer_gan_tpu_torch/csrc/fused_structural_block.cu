// Fused StructuralTransformerBlock body, inference forward, for Hopper
// (sm_90a).
//
// Replaces ops/pallas/fused_transformer.py::fused_structural_block of the
// JAX package. On the (B, H, W, C) token grid, per 8x8 window:
//   h   = LN1(x + struct) * (1 + gamma) + beta        (FiLM; fp32 LayerNorm)
//   x   = x + proj(MHSA(h))                            (heads of 32 channels)
//   out = x + fc2(GELU_erf(fc1(LN2(x))))
// Weights come in the PyTorch Linear (out, in) layout.
//
// Ragged grids. When H or W is not a multiple of 8 the edge windows hold
// tokens outside the grid. Their keys get a score of -inf before the
// softmax and their outputs are not written, which is what the reference's
// zero-pad-and-mask formulation (models/structural_transformer.py:113-150)
// computes. So every grid shape runs here; none is sent elsewhere.
//
// Widths: C = 32, 64 and 128 with C / 32 heads of 32 (default_num_heads),
// the blocks of the c8, c16 and c32 generators.
//
// What bounds it. About 24 C^2 + 256 C flop per token against 6 C bytes of
// bf16 traffic (read x and struct, write out): ~300 flop/B at C = 64, at the
// tensor-core ridge (0.0038 ms of matrix products at (8, 64, 64, 64) against
// 0.0032 ms of bytes); at C = 32 about half that, bytes-bound; at C = 128
// about 570 flop/B, bound by operations.
//
// bf16 design (fused_structural_block_mma_kernel, C = 32 and 64; C = 128
// in fused_structural_block_wide_kernel below). Persistent blocks: each
// stages the four weight matrices once (bf16 as stored, (out, in) rows
// padded by 16 bytes: 105 KB at C = 64) and the biases and LayerNorm
// parameters (fp32) with 16-byte cp.async, then strides over the windows,
// two at a time: a block is two groups of 4 warps, one window each, so one
// group's loads overlap the other's products. A warp owns 16 token rows of
// its window through the whole chain; the residual stream, both
// LayerNorms (fp32, quad reductions over accumulator fragments), the GELU
// and every intermediate but k and v stay in its registers. Every product
// is mma.sync.m16n8k16 (bf16 in, fp32 sums; csrc/mma.cuh) with the weight
// as the B operand straight from its (out, in) rows. The MHSA is the
// forward of window_mhsa_train.cu (window_mhsa_mma.cuh): q stays in
// registers as A fragments, k and v of the window's 64 tokens go to shared
// memory (the chain's only exchange between warps, two named barriers of
// the group's 128 threads per window), scores, softmax and p v are
// FlashAttention-2 style per warp and head, with keys outside a ragged
// grid set to -inf. fc1's GELU runs on the accumulator fragments, 16
// hidden columns at a time, which are at once one k-step of fc2, so the
// 64 x 4C hidden activations never leave the registers.
// Operands rounded to bf16 inside the kernel: LN1's output enters the q
// and k columns of the qkv product as a hi + lo pair, and q and k enter
// the scores as hi + lo pairs (three products); with one term each, a
// block whose scores are 16 times larger misses the bf16 bound by 2.2-3.9x,
// with either pair alone by 1.8-3.0x, with both it stays at 0.51 of it
// (devtools/serving_kernel_rounding.py). LN1's output for v, the
// exponentials, v, the MHSA output, LN2's output and the GELU output are
// one term.
//
// fp32 stays exact fp32 (fused_structural_block_f32_kernel): FMAs on the
// CUDA cores, no tensor cores, no TF32. One block of 256 threads per window
// of 64 tokens; activations live in dynamic shared memory in fp32 (about
// 97 KB at C = 64, 193 KB at C = 128, buffers reused between phases); weights are read through L2 and
// the read-only cache, four at a time. In the four Linear products each
// thread keeps a 4-token by N/16-output tile of sums in registers;
// activation rows have an odd stride so a warp's reads fall in distinct
// banks.
#include <cmath>

#include "common.cuh"
#include "mma.cuh"
#include "window_mhsa_mma.cuh"

namespace mstgan {
namespace {

constexpr int kWin = 8;
constexpr int kTok = kWin * kWin;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// models/structural_transformer.py::default_num_heads
constexpr int default_num_heads(int dim) {
  int h = dim / 32 > 1 ? dim / 32 : 1;
  while (dim % h) --h;
  return h;
}

template <int C>
struct Layout {
  static constexpr int HEADS = default_num_heads(C);
  static constexpr int HD = C / HEADS;
  static constexpr int XS = C + 1;       // token rows of width C
  static constexpr int QS = 3 * C + 1;   // qkv rows
  static constexpr int SS = kTok + 1;    // score rows
  static constexpr int AS = 4 * C + 1;   // MLP hidden rows
  static constexpr int X = 0;                 // [kTok][XS] residual stream
  static constexpr int H = X + kTok * XS;     // [kTok][XS] LN out / attention out
  static constexpr int U = H + kTok * XS;     // union: qkv + scores, later MLP hidden
  static constexpr int QKV = U;
  static constexpr int S = U + kTok * QS;
  static constexpr int A1 = U;
  static constexpr int U_SIZE = kTok * QS + kTok * SS > kTok * AS ? kTok * QS + kTok * SS : kTok * AS;
  static constexpr int TOTAL = U + U_SIZE;
};


// out[t][o] = A[t] . w[o] + b[o] for every token t and output o < N,
// handed to epi(t, o, value). Each thread keeps a 4 x N/16 tile of sums in
// registers (tokens tg + 16j, outputs og + 16r, with tg = tid % 16 and
// og = tid / 16), so every 4-deep step loads 16 activations from shared
// memory and N/16 weight quads for 4 * N/4 FMAs. A warp reads 16 activation
// rows (odd stride: distinct banks) and two weight rows.
template <int K, int N, int AS, typename T, typename Epi>
__device__ __forceinline__ void linear_rows(const float* A, const T* __restrict__ w,
                                            const T* __restrict__ b, Epi epi) {
  static_assert(kThreads == 256 && kTok == 64 && N % 16 == 0 && K % 4 == 0,
                "a 16 x 16 grid of threads over 64 tokens and N outputs");
  constexpr int TM = kTok / 16, TN = N / 16;
  const int tg = threadIdx.x % 16, og = threadIdx.x / 16;
  float acc[TM][TN] = {};
#pragma unroll 1
  for (int i = 0; i < K; i += 4) {
    float a[TM][4];
#pragma unroll
    for (int j = 0; j < TM; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) a[j][q] = A[(tg + 16 * j) * AS + i + q];
#pragma unroll
    for (int r = 0; r < TN; ++r) {
      const float4 wv = load4(w + (long long)(og + 16 * r) * K + i);
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        acc[j][r] = fmaf(a[j][0], wv.x, acc[j][r]);
        acc[j][r] = fmaf(a[j][1], wv.y, acc[j][r]);
        acc[j][r] = fmaf(a[j][2], wv.z, acc[j][r]);
        acc[j][r] = fmaf(a[j][3], wv.w, acc[j][r]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < TM; ++j)
#pragma unroll
    for (int r = 0; r < TN; ++r) {
      const int o = og + 16 * r;
      epi(tg + 16 * j, o, acc[j][r] + to_f(b[o]));
    }
}

// LayerNorm over C of each token row (one warp per row), optionally
// followed by the FiLM (1 + gamma), beta. `in` and `out` may alias.
template <int C, typename T>
__device__ __forceinline__ void layer_norm_rows(const float* in, float* out,
                                                const T* __restrict__ w,
                                                const T* __restrict__ b, float eps,
                                                const float* gamma, const float* beta) {
  constexpr int XS = Layout<C>::XS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = warp; t < kTok; t += kWarps) {
    const float* r = in + t * XS;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += r[c];
    const float mean = warp_sum(s) / C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = r[c] - mean;
      v = fmaf(d, d, v);
    }
    const float rstd = 1.f / sqrtf(warp_sum(v) / C + eps);
    for (int c = lane; c < C; c += 32) {
      float o = (r[c] - mean) * rstd * to_f(w[c]) + to_f(b[c]);
      if (gamma != nullptr) o = o * (1.f + gamma[c]) + beta[c];
      out[t * XS + c] = o;
    }
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
fused_structural_block_f32_kernel(const T* __restrict__ x, const T* __restrict__ st,
                              const float* __restrict__ gamma, const float* __restrict__ beta,
                              const T* __restrict__ n1w, const T* __restrict__ n1b,
                              const T* __restrict__ qkvw, const T* __restrict__ qkvb,
                              const T* __restrict__ projw, const T* __restrict__ projb,
                              const T* __restrict__ n2w, const T* __restrict__ n2b,
                              const T* __restrict__ f1w, const T* __restrict__ f1b,
                              const T* __restrict__ f2w, const T* __restrict__ f2b,
                              T* __restrict__ y, int H, int W, float eps) {
  using L = Layout<C>;
  extern __shared__ float smem[];
  float* sX = smem + L::X;
  float* sH = smem + L::H;
  float* sQKV = smem + L::QKV;
  float* sS = smem + L::S;
  float* sA1 = smem + L::A1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z, row0 = blockIdx.y * kWin, col0 = blockIdx.x * kWin;
  auto valid = [&](int t) { return row0 + t / kWin < H && col0 + t % kWin < W; };
  auto offset = [&](int t) {
    return (((long long)b * H + row0 + t / kWin) * W + col0 + t % kWin) * C;
  };

  // x (residual) and x + struct; tokens outside the grid load as zeros
  for (int e = tid; e < kTok * C; e += kThreads) {
    const int t = e / C, c = e % C;
    float xv = 0.f, sv = 0.f;
    if (valid(t)) {
      xv = to_f(x[offset(t) + c]);
      sv = to_f(st[offset(t) + c]);
    }
    sX[t * L::XS + c] = xv;
    sH[t * L::XS + c] = xv + sv;
  }
  __syncthreads();
  layer_norm_rows<C>(sH, sH, n1w, n1b, eps, gamma + (long long)b * C, beta + (long long)b * C);
  __syncthreads();

  linear_rows<C, 3 * C, L::XS>(sH, qkvw, qkvb,
                               [&](int t, int o, float v) { sQKV[t * L::QS + o] = v; });
  __syncthreads();

  const float scale = 1.f / sqrtf((float)L::HD);
  for (int hh = 0; hh < L::HEADS; ++hh) {
    for (int e = tid; e < kTok * kTok; e += kThreads) {
      const int s = e % kTok, t = e / kTok;
      float acc = -INFINITY;  // keys outside the grid drop out of the softmax
      if (valid(s)) {
        const float* q = sQKV + t * L::QS + hh * L::HD;
        const float* k = sQKV + s * L::QS + C + hh * L::HD;
        acc = 0.f;
#pragma unroll 8
        for (int d = 0; d < L::HD; ++d) acc = fmaf(q[d], k[d], acc);
        acc *= scale;
      }
      sS[t * L::SS + s] = acc;
    }
    __syncthreads();
    for (int t = warp; t < kTok; t += kWarps) {  // token 0 of a window is always a valid key
      float* r = sS + t * L::SS;
      const float m = warp_max(fmaxf(r[lane], r[lane + 32]));
      const float e0 = expf(r[lane] - m), e1 = expf(r[lane + 32] - m);
      const float sum = warp_sum(e0 + e1);
      r[lane] = e0 / sum;
      r[lane + 32] = e1 / sum;
    }
    __syncthreads();
    for (int e = tid; e < kTok * L::HD; e += kThreads) {
      const int d = e % L::HD, t = e / L::HD;
      const float* p = sS + t * L::SS;
      const float* v = sQKV + 2 * C + hh * L::HD + d;
      float acc = 0.f;
#pragma unroll 8
      for (int s = 0; s < kTok; ++s) acc = fmaf(p[s], v[s * L::QS], acc);
      sH[t * L::XS + hh * L::HD + d] = acc;
    }
    __syncthreads();
  }

  linear_rows<C, C, L::XS>(sH, projw, projb,
                           [&](int t, int o, float v) { sX[t * L::XS + o] += v; });
  __syncthreads();
  layer_norm_rows<C>(sX, sH, n2w, n2b, eps, nullptr, nullptr);
  __syncthreads();
  linear_rows<C, 4 * C, L::XS>(sH, f1w, f1b, [&](int t, int o, float v) {
    sA1[t * L::AS + o] = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  });
  __syncthreads();
  linear_rows<4 * C, C, L::AS>(sA1, f2w, f2b, [&](int t, int o, float v) {
    sH[t * L::XS + o] = sX[t * L::XS + o] + v;
  });
  __syncthreads();

  for (int e = tid; e < kTok * C; e += kThreads) {
    const int t = e / C, c = e % C;
    if (valid(t)) y[offset(t) + c] = from_f<T>(sH[t * L::XS + c]);
  }
}

// ---------------------------------------------------------------------------
// bf16: warp MMA
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kGroups = 2;                // windows in flight per block (C <= 64)
constexpr int kGroupThreads = 128;        // 4 warps x 16 token rows
constexpr int kMmaThreads = kGroups * kGroupThreads;

// C = 32 and 64: every weight resident (bf16 as stored, (out, in) rows
// padded by 16 bytes), two windows in flight.
template <int C>
struct MmaLayout {
  static constexpr int HEADS = C / mhsa::kHd;   // default_num_heads: 1, 2
  static constexpr int KT = C / 16;             // k-steps over C
  static constexpr int NT = C / 8;              // n-tiles of a C-wide strip
  static constexpr int WS = C + 8;              // rows of C values
  static constexpr int W2S = 4 * C + 8;         // fc2's rows of 4C values
  // bf16 elements: the weights, then per group x | struct | k hi | k lo | v
  static constexpr int W_QKV = 0;                        // [3C][WS]
  static constexpr int W_PROJ = W_QKV + 3 * C * WS;      // [C][WS]
  static constexpr int W_FC1 = W_PROJ + C * WS;          // [4C][WS]
  static constexpr int W_FC2 = W_FC1 + 4 * C * WS;       // [C][W2S]
  static constexpr int GROUPS = W_FC2 + C * W2S;
  static constexpr int G_X = 0;                          // [64][WS]; later y
  static constexpr int G_ST = G_X + kTok * WS;           // [64][WS]
  static constexpr int G_KH = G_ST + kTok * WS;          // [heads][64][RS]
  static constexpr int G_KL = G_KH + HEADS * mhsa::TILE;
  static constexpr int G_V = G_KL + HEADS * mhsa::TILE;
  static constexpr int GROUP = G_V + HEADS * mhsa::TILE;
  // fp32 parameters after the bf16 part
  static constexpr int N1W = 0, N1B = C, N2W = 2 * C, N2B = 3 * C;
  static constexpr int QKV_B = 4 * C, PROJ_B = QKV_B + 3 * C, FC1_B = PROJ_B + C,
                       FC2_B = FC1_B + 4 * C, PARAMS = FC2_B + C;
  static constexpr int BYTES = (GROUPS + kGroups * GROUP) * (int)sizeof(bf16) +
                               PARAMS * (int)sizeof(float);
  static_assert(mhsa::kHd * HEADS == C && mhsa::kTok == kTok, "heads of 32 over 64 tokens");
};

// acc (16 tokens x 8 NT outputs) = a w^T + bias: a as A fragments of C / 16
// k-steps (hi, and lo when kSplit), w rows [n][k] of stride C + 8.
template <int C, int NT, bool kSplit>
__device__ __forceinline__ void linear_frags(float (&acc)[NT][4], const uint32_t (&ah)[C / 16][4],
                                             const uint32_t (&al)[C / 16][4], const bf16* w,
                                             const float* bias, int lane) {
  constexpr int WS = C + 8;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias + j * 8 + 2 * t);
    acc[j][0] = acc[j][2] = b.x;
    acc[j][1] = acc[j][3] = b.y;
  }
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk)
#pragma unroll
    for (int nb = 0; nb < NT / 2; ++nb) {
      uint32_t b[4];
      ldmatrix_x4(b, w + (nb * 16 + (lane & 7) + (lane >> 4) * 8) * WS + kk * 16 +
                         ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * nb], ah[kk], b[0], b[1]);
      mma_bf16(acc[2 * nb + 1], ah[kk], b[2], b[3]);
      if (kSplit) {
        mma_bf16(acc[2 * nb], al[kk], b[0], b[1]);
        mma_bf16(acc[2 * nb + 1], al[kk], b[2], b[3]);
      }
    }
}

// LayerNorm over the C channels of the lane's two token rows (g and g + 8
// of the strip), in place on C fragments; w and b are fp32 in shared memory.
template <int C>
__device__ __forceinline__ void layer_norm_frags(float (&h)[C / 8][4], const float* w,
                                                 const float* b, float eps, int lane) {
  const int t = lane & 3;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
    s0 += h[j][0] + h[j][1];
    s1 += h[j][2] + h[j][3];
  }
  const float m0 = quad_sum(s0) / C, m1 = quad_sum(s1) / C;
  float v0 = 0.f, v1 = 0.f;
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
    v0 = fmaf(h[j][0] - m0, h[j][0] - m0, fmaf(h[j][1] - m0, h[j][1] - m0, v0));
    v1 = fmaf(h[j][2] - m1, h[j][2] - m1, fmaf(h[j][3] - m1, h[j][3] - m1, v1));
  }
  const float r0 = 1.f / sqrtf(quad_sum(v0) / C + eps);
  const float r1 = 1.f / sqrtf(quad_sum(v1) / C + eps);
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
    const float2 wv = *reinterpret_cast<const float2*>(w + j * 8 + 2 * t);
    const float2 bv = *reinterpret_cast<const float2*>(b + j * 8 + 2 * t);
    h[j][0] = (h[j][0] - m0) * r0 * wv.x + bv.x;
    h[j][1] = (h[j][1] - m0) * r0 * wv.y + bv.y;
    h[j][2] = (h[j][2] - m1) * r1 * wv.x + bv.x;
    h[j][3] = (h[j][3] - m1) * r1 * wv.y + bv.y;
  }
}

// FiLM of the LN1 output on C fragments: h (1 + gamma) + beta, gamma and
// beta the batch entry's rows (fp32, read through the read-only cache).
template <int C>
__device__ __forceinline__ void film_frags(float (&h)[C / 8][4], const float* gamma,
                                           const float* beta, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
    const float2 ga = __ldg(reinterpret_cast<const float2*>(gamma + j * 8 + 2 * t));
    const float2 be = __ldg(reinterpret_cast<const float2*>(beta + j * 8 + 2 * t));
    h[j][0] = h[j][0] * (1.f + ga.x) + be.x;
    h[j][1] = h[j][1] * (1.f + ga.y) + be.y;
    h[j][2] = h[j][2] * (1.f + ga.x) + be.x;
    h[j][3] = h[j][3] * (1.f + ga.y) + be.y;
  }
}

// One head's attention for the warp's 16 queries: scores q k^T (q, k as hi
// + lo), keys outside a ragged grid at -inf, the softmax's exponentials
// times v, divided by the row sums; o (16 x 32) as C fragments.
template <typename Valid>
__device__ __forceinline__ void head_attention(float (&o)[4][4], const uint32_t (&qh)[2][4],
                                               const uint32_t (&ql)[2][4], const bf16* kh,
                                               const bf16* kl, const bf16* v, bool ragged,
                                               Valid valid, int lane) {
  const int t = lane & 3;
  float s[8][4];
  mhsa::times_tile_t_split(s, qh, ql, kh, kl, lane);
  if (ragged) {   // keys outside the grid drop out of the softmax
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!valid(j * 8 + 2 * t)) s[j][0] = s[j][2] = -INFINITY;
      if (!valid(j * 8 + 2 * t + 1)) s[j][1] = s[j][3] = -INFINITY;
    }
  }
  float l0, l1;   // token 0 of a window is always a valid key
  mhsa::exp_rows<true>(s, 1.f / sqrtf((float)mhsa::kHd), l0, l1);   // __expf: y is bf16
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  mhsa::strip_times_tile<false>(o, s, v, lane);
  l0 = 1.f / l0;
  l1 = 1.f / l1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    o[j][0] *= l0;
    o[j][1] *= l0;
    o[j][2] *= l1;
    o[j][3] *= l1;
  }
}

// GELU (erf) in place on two C fragments.
__device__ __forceinline__ void gelu_frags(float (&f)[2][4]) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) f[n][i] = 0.5f * f[n][i] * (1.f + erff(f[n][i] * 0.70710678118654752f));
}

// Barrier of one group's 128 threads (named barrier 1 + group).
__device__ __forceinline__ void group_barrier(int group) {
  asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "n"(kGroupThreads) : "memory");
}

template <int C>
__global__ void __launch_bounds__(kMmaThreads, 1)
fused_structural_block_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ st,
                                  const float* __restrict__ gamma,
                                  const float* __restrict__ beta, const bf16* __restrict__ n1w,
                                  const bf16* __restrict__ n1b, const bf16* __restrict__ qkvw,
                                  const bf16* __restrict__ qkvb, const bf16* __restrict__ projw,
                                  const bf16* __restrict__ projb, const bf16* __restrict__ n2w,
                                  const bf16* __restrict__ n2b, const bf16* __restrict__ f1w,
                                  const bf16* __restrict__ f1b, const bf16* __restrict__ f2w,
                                  const bf16* __restrict__ f2b, bf16* __restrict__ y, int B,
                                  int H, int W, float eps) {
  using L = MmaLayout<C>;
  constexpr int KT = L::KT, NT = L::NT, WS = L::WS, CH = C / 8;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* sW = reinterpret_cast<bf16*>(smem_mma);
  float* sP = reinterpret_cast<float*>(sW + L::GROUPS + kGroups * L::GROUP);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int group = warp / 4, r0 = (warp % 4) * 16, g = lane >> 2, t = lane & 3;
  bf16* sG = sW + L::GROUPS + group * L::GROUP;
  bf16* sX = sG + L::G_X;
  bf16* sSt = sG + L::G_ST;
  bf16* sKh = sG + L::G_KH;
  bf16* sKl = sG + L::G_KL;
  bf16* sV = sG + L::G_V;

  // the weights as stored, 16 bytes a copy; the small parameters as fp32
  for (int e = tid; e < 8 * C * CH; e += kMmaThreads) {   // 8C rows of C values
    const int r = e / CH, c = e % CH;
    const bf16* src = r < 3 * C ? qkvw + r * C
                      : r < 4 * C ? projw + (r - 3 * C) * C : f1w + (r - 4 * C) * C;
    cp_async16(sW + r * WS + c * 8, src + c * 8);
  }
  for (int e = tid; e < C * 4 * CH; e += kMmaThreads) {   // fc2: C rows of 4C values
    const int r = e / (4 * CH), c = e % (4 * CH);
    cp_async16(sW + L::W_FC2 + r * L::W2S + c * 8, f2w + r * 4 * C + c * 8);
  }
  for (int e = tid; e < C; e += kMmaThreads) {
    sP[L::N1W + e] = to_f(n1w[e]);
    sP[L::N1B + e] = to_f(n1b[e]);
    sP[L::N2W + e] = to_f(n2w[e]);
    sP[L::N2B + e] = to_f(n2b[e]);
    sP[L::PROJ_B + e] = to_f(projb[e]);
    sP[L::FC2_B + e] = to_f(f2b[e]);
  }
  for (int e = tid; e < 3 * C; e += kMmaThreads) sP[L::QKV_B + e] = to_f(qkvb[e]);
  for (int e = tid; e < 4 * C; e += kMmaThreads) sP[L::FC1_B + e] = to_f(f1b[e]);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int nwx = (W + kWin - 1) / kWin, nwy = (H + kWin - 1) / kWin;
  const long long n_windows = (long long)B * nwy * nwx;
  for (long long win = (long long)blockIdx.x * kGroups + group; win < n_windows;
       win += (long long)gridDim.x * kGroups) {
    const int b = (int)(win / (nwy * nwx)), rem = (int)(win - (long long)b * nwy * nwx);
    const int row0 = (rem / nwx) * kWin, col0 = (rem % nwx) * kWin;
    const bool ragged = row0 + kWin > H || col0 + kWin > W;
    auto valid = [&](int tok) { return row0 + tok / kWin < H && col0 + tok % kWin < W; };
    auto offset = [&](int tok) {
      return (((long long)b * H + row0 + tok / kWin) * W + col0 + tok % kWin) * C;
    };

    // the warp's 16 token rows of x and struct; tokens outside the grid
    // load as zeros
#pragma unroll
    for (int e = lane; e < 16 * CH; e += 32) {
      const int tok = r0 + e / CH, c = e % CH;
      const bool ok = valid(tok);
      const long long off = ok ? offset(tok) + c * 8 : 0;
      cp_async16(sX + tok * WS + c * 8, x + off, ok);
      cp_async16(sSt + tok * WS + c * 8, st + off, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();

    float h[NT][4];   // x + struct, then the LN outputs and the products' sums
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int off = (r0 + g + 8 * hh) * WS + j * 8 + 2 * t;
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sX + off));
        const float2 sv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sSt + off));
        h[j][2 * hh] = xv.x + sv.x;
        h[j][2 * hh + 1] = xv.y + sv.y;
      }
    layer_norm_frags<C>(h, sP + L::N1W, sP + L::N1B, eps, lane);
    film_frags<C>(h, gamma + b * C, beta + b * C, lane);
    uint32_t ah[KT][4], al[KT][4];
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) frags_to_a_split(ah[kk], al[kk], h[2 * kk], h[2 * kk + 1]);

    // q stays in registers as A fragments (hi + lo); k (hi + lo) and v go
    // to the group's tiles
    uint32_t qh[L::HEADS][2][4], ql[L::HEADS][2][4];
#pragma unroll
    for (int hd = 0; hd < L::HEADS; ++hd) {
      float acc[4][4];
      linear_frags<C, 4, true>(acc, ah, al, sW + L::W_QKV + hd * mhsa::kHd * WS,
                               sP + L::QKV_B + hd * mhsa::kHd, lane);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        frags_to_a_split(qh[hd][kk], ql[hd][kk], acc[2 * kk], acc[2 * kk + 1]);
    }
    group_barrier(group);   // the previous window's k and v are read
#pragma unroll
    for (int hd = 0; hd < L::HEADS; ++hd) {
      float acc[4][4];
      linear_frags<C, 4, true>(acc, ah, al, sW + L::W_QKV + (C + hd * mhsa::kHd) * WS,
                               sP + L::QKV_B + C + hd * mhsa::kHd, lane);
      store_frags<4>(sKh + hd * mhsa::TILE, sKl + hd * mhsa::TILE, mhsa::RS, r0, 0, acc, 1.f,
                     lane);
      linear_frags<C, 4, false>(acc, ah, al, sW + L::W_QKV + (2 * C + hd * mhsa::kHd) * WS,
                                sP + L::QKV_B + 2 * C + hd * mhsa::kHd, lane);
      store_frags<4>(sV + hd * mhsa::TILE, nullptr, mhsa::RS, r0, 0, acc, 1.f, lane);
    }
    group_barrier(group);   // this window's k and v are in

    // per head: scores, softmax and p v for the warp's 16 queries; the
    // result is two k-steps of the proj
#pragma unroll
    for (int hd = 0; hd < L::HEADS; ++hd) {
      float o[4][4];
      head_attention(o, qh[hd], ql[hd], sKh + hd * mhsa::TILE, sKl + hd * mhsa::TILE,
                     sV + hd * mhsa::TILE, ragged, valid, lane);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) frags_to_a(ah[2 * hd + kk], o[2 * kk], o[2 * kk + 1]);
    }

    // proj and the residual (x is still in the warp's rows of sX), LN2
    float xr[NT][4];   // the residual stream, then y's sums
    linear_frags<C, NT, false>(xr, ah, al, sW + L::W_PROJ, sP + L::PROJ_B, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            sX + (r0 + g + 8 * hh) * WS + j * 8 + 2 * t));
        h[j][2 * hh] = xr[j][2 * hh] += xv.x;
        h[j][2 * hh + 1] = xr[j][2 * hh + 1] += xv.y;
      }
    layer_norm_frags<C>(h, sP + L::N2W, sP + L::N2B, eps, lane);
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) frags_to_a(ah[kk], h[2 * kk], h[2 * kk + 1]);

    // the MLP, 16 hidden columns at a time: fc1 and its GELU on the
    // accumulators are one k-step of fc2, summed onto the residual
    {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 bv = *reinterpret_cast<const float2*>(sP + L::FC2_B + j * 8 + 2 * t);
        xr[j][0] += bv.x;
        xr[j][2] += bv.x;
        xr[j][1] += bv.y;
        xr[j][3] += bv.y;
      }
#pragma unroll 1
      for (int hc = 0; hc < 4 * C / 16; ++hc) {
        float f[2][4];
        linear_frags<C, 2, false>(f, ah, al, sW + L::W_FC1 + hc * 16 * WS,
                                  sP + L::FC1_B + hc * 16, lane);
        gelu_frags(f);
        uint32_t fa[4];
        frags_to_a(fa, f[0], f[1]);
#pragma unroll
        for (int nb = 0; nb < KT; ++nb) {
          uint32_t w[4];
          ldmatrix_x4(w, sW + L::W_FC2 + (nb * 16 + (lane & 7) + (lane >> 4) * 8) * L::W2S + hc * 16 +
                             ((lane >> 3) & 1) * 8);
          mma_bf16(xr[2 * nb], fa, w[0], w[1]);
          mma_bf16(xr[2 * nb + 1], fa, w[2], w[3]);
        }
      }
    }

    // y through the warp's own x rows to 16-byte stores
    store_frags<NT>(sX, nullptr, WS, r0, 0, xr, 1.f, lane);
    __syncwarp();
#pragma unroll
    for (int e = lane; e < 16 * CH; e += 32) {
      const int tok = r0 + e / CH, c = e % CH;
      if (valid(tok))
        *reinterpret_cast<uint4*>(y + offset(tok) + c * 8) =
            *reinterpret_cast<const uint4*>(sX + tok * WS + c * 8);
    }
    __syncwarp();
  }
}

// C = 128 (the c32 generator): the four weights are ~400 KB with padding,
// past the 227 KB a block may hold. qkv and proj stay resident (139 KB);
// fc1's rows and fc2's columns stream through shared memory in chunks of
// 16 hidden columns (double-buffered cp.async, one block barrier a chunk),
// which is the grain the MLP consumes anyway. A block is one group of 4
// warps on one window; k and v are staged one head at a time. LN1's
// output enters q, k and v as hi + lo pairs, LN2's output fc1 and the GELU
// output fc2 as pairs too: with the c16 kernel's pairs alone a saturated
// block at dim 128 reaches 1.01-1.09 of the bf16 bound, with these 0.67-0.72
// (devtools/serving_kernel_rounding.py).
struct WideLayout {
  static constexpr int C = 128, HEADS = C / mhsa::kHd, KT = C / 16, NT = C / 8, CH = C / 8;
  static constexpr int WS = C + 8;              // rows of C values: 272 bytes
  static constexpr int CS = 16 + 8;             // an fc2 chunk row: 16 values, 48 bytes
  static constexpr int CHUNKS = 4 * C / 16;
  static constexpr int W_QKV = 0;                        // [3C][WS]
  static constexpr int W_PROJ = W_QKV + 3 * C * WS;      // [C][WS]
  static constexpr int FC = W_PROJ + C * WS;             // [2] chunks:
  static constexpr int FC1 = 0, FC2 = 16 * WS;           //   fc1 rows [16][WS], fc2 [C][CS]
  static constexpr int CHUNK = FC2 + C * CS;
  static constexpr int X = FC + 2 * CHUNK;               // [64][WS]; later y
  static constexpr int KH = X + kTok * WS;               // one head: k hi, k lo, v [64][RS]
  static constexpr int KL = KH + mhsa::TILE;
  static constexpr int V = KL + mhsa::TILE;
  static constexpr int ELEMS = V + mhsa::TILE;
  static constexpr int N1W = 0, N1B = C, N2W = 2 * C, N2B = 3 * C;
  static constexpr int QKV_B = 4 * C, PROJ_B = QKV_B + 3 * C, FC1_B = PROJ_B + C,
                       FC2_B = FC1_B + 4 * C, PARAMS = FC2_B + C;
  static constexpr int BYTES = ELEMS * (int)sizeof(bf16) + PARAMS * (int)sizeof(float);
};

__global__ void __launch_bounds__(kGroupThreads, 1)
fused_structural_block_wide_kernel(const bf16* __restrict__ x, const bf16* __restrict__ st,
                                   const float* __restrict__ gamma,
                                   const float* __restrict__ beta, const bf16* __restrict__ n1w,
                                   const bf16* __restrict__ n1b, const bf16* __restrict__ qkvw,
                                   const bf16* __restrict__ qkvb, const bf16* __restrict__ projw,
                                   const bf16* __restrict__ projb, const bf16* __restrict__ n2w,
                                   const bf16* __restrict__ n2b, const bf16* __restrict__ f1w,
                                   const bf16* __restrict__ f1b, const bf16* __restrict__ f2w,
                                   const bf16* __restrict__ f2b, bf16* __restrict__ y, int B,
                                   int H, int W, float eps) {
  using L = WideLayout;
  constexpr int C = L::C, KT = L::KT, NT = L::NT, WS = L::WS, CH = L::CH;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* sW = reinterpret_cast<bf16*>(smem_mma);
  bf16* sFC = sW + L::FC;
  bf16* sX = sW + L::X;
  bf16* sKh = sW + L::KH;
  bf16* sKl = sW + L::KL;
  bf16* sV = sW + L::V;
  float* sP = reinterpret_cast<float*>(sW + L::ELEMS);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16, g = lane >> 2, t = lane & 3;

  // chunk hc of the MLP into buffer dst: fc1 rows 16 hc.., fc2 columns
  // 16 hc.. of every row, 16 bytes a copy by the whole block
  auto load_chunk = [&](int hc, bf16* dst) {
    for (int e = tid; e < 16 * CH + 2 * C; e += kGroupThreads) {
      if (e < 16 * CH) {
        const int r = e / CH, c = e % CH;
        cp_async16(dst + L::FC1 + r * WS + c * 8, f1w + (hc * 16 + r) * C + c * 8);
      } else {
        const int r = (e - 16 * CH) / 2, c = (e - 16 * CH) % 2;
        cp_async16(dst + L::FC2 + r * L::CS + c * 8, f2w + r * 4 * C + hc * 16 + c * 8);
      }
    }
  };

  for (int e = tid; e < 4 * C * CH; e += kGroupThreads) {   // qkv and proj: 4C rows
    const int r = e / CH, c = e % CH;
    cp_async16(sW + r * WS + c * 8, (r < 3 * C ? qkvw + r * C : projw + (r - 3 * C) * C) + c * 8);
  }
  for (int e = tid; e < C; e += kGroupThreads) {
    sP[L::N1W + e] = to_f(n1w[e]);
    sP[L::N1B + e] = to_f(n1b[e]);
    sP[L::N2W + e] = to_f(n2w[e]);
    sP[L::N2B + e] = to_f(n2b[e]);
    sP[L::PROJ_B + e] = to_f(projb[e]);
    sP[L::FC2_B + e] = to_f(f2b[e]);
  }
  for (int e = tid; e < 3 * C; e += kGroupThreads) sP[L::QKV_B + e] = to_f(qkvb[e]);
  for (int e = tid; e < 4 * C; e += kGroupThreads) sP[L::FC1_B + e] = to_f(f1b[e]);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int nwx = (W + kWin - 1) / kWin, nwy = (H + kWin - 1) / kWin;
  const long long n_windows = (long long)B * nwy * nwx;
  for (long long win = blockIdx.x; win < n_windows; win += gridDim.x) {
    const int b = (int)(win / (nwy * nwx)), rem = (int)(win - (long long)b * nwy * nwx);
    const int row0 = (rem / nwx) * kWin, col0 = (rem % nwx) * kWin;
    const bool ragged = row0 + kWin > H || col0 + kWin > W;
    auto valid = [&](int tok) { return row0 + tok / kWin < H && col0 + tok % kWin < W; };
    auto offset = [&](int tok) {
      return (((long long)b * H + row0 + tok / kWin) * W + col0 + tok % kWin) * C;
    };

    // the warp's 16 token rows of x (tokens outside the grid as zeros),
    // then chunk 0 of the MLP into buffer 0: every warp is past the
    // barrier of the previous window's last chunk, which used buffer 1
#pragma unroll
    for (int e = lane; e < 16 * CH; e += 32) {
      const int tok = r0 + e / CH, c = e % CH;
      const bool ok = valid(tok);
      cp_async16(sX + tok * WS + c * 8, x + (ok ? offset(tok) + c * 8 : 0), ok);
    }
    cp_async_commit();
    load_chunk(0, sFC);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();

    float h[NT][4];   // x + struct (struct read straight from device memory)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int tok = r0 + g + 8 * hh;
      const bool ok = valid(tok);
      const bf16* srow = st + (ok ? offset(tok) : 0);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sX + tok * WS + j * 8 + 2 * t));
        float2 sv = make_float2(0.f, 0.f);
        if (ok) {
          const unsigned int u = __ldg(reinterpret_cast<const unsigned int*>(srow + j * 8 + 2 * t));
          sv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
        }
        h[j][2 * hh] = xv.x + sv.x;
        h[j][2 * hh + 1] = xv.y + sv.y;
      }
    }
    layer_norm_frags<C>(h, sP + L::N1W, sP + L::N1B, eps, lane);
    film_frags<C>(h, gamma + b * C, beta + b * C, lane);
    uint32_t ah[KT][4], al[KT][4];
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) frags_to_a_split(ah[kk], al[kk], h[2 * kk], h[2 * kk + 1]);

    // head by head: q in registers, k and v through the block's tiles,
    // the head's output two k-steps of the proj
    uint32_t oa[KT][4];
#pragma unroll 1
    for (int hd = 0; hd < L::HEADS; ++hd) {
      uint32_t qh[2][4], ql[2][4];
      {
        float acc[4][4];
        linear_frags<C, 4, true>(acc, ah, al, sW + L::W_QKV + hd * mhsa::kHd * WS,
                                 sP + L::QKV_B + hd * mhsa::kHd, lane);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          frags_to_a_split(qh[kk], ql[kk], acc[2 * kk], acc[2 * kk + 1]);
      }
      __syncthreads();   // every warp is done with the previous head's k and v
      {
        float acc[4][4];
        linear_frags<C, 4, true>(acc, ah, al, sW + L::W_QKV + (C + hd * mhsa::kHd) * WS,
                                 sP + L::QKV_B + C + hd * mhsa::kHd, lane);
        store_frags<4>(sKh, sKl, mhsa::RS, r0, 0, acc, 1.f, lane);
        linear_frags<C, 4, true>(acc, ah, al, sW + L::W_QKV + (2 * C + hd * mhsa::kHd) * WS,
                                 sP + L::QKV_B + 2 * C + hd * mhsa::kHd, lane);
        store_frags<4>(sV, nullptr, mhsa::RS, r0, 0, acc, 1.f, lane);
      }
      __syncthreads();   // this head's k and v are in
      float o[4][4];
      head_attention(o, qh, ql, sKh, sKl, sV, ragged, valid, lane);
      // oa[2 hd + kk]: a register array indexed at run time would go to
      // local memory, so the head's k-steps are placed by a static walk
#pragma unroll
      for (int i = 0; i < L::HEADS; ++i)
        if (i == hd) {
          frags_to_a(oa[2 * i], o[0], o[1]);
          frags_to_a(oa[2 * i + 1], o[2], o[3]);
        }
    }

    // proj and the residual, LN2 (as hi + lo)
    float xr[NT][4];
    linear_frags<C, NT, false>(xr, oa, oa, sW + L::W_PROJ, sP + L::PROJ_B, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            sX + (r0 + g + 8 * hh) * WS + j * 8 + 2 * t));
        h[j][2 * hh] = xr[j][2 * hh] += xv.x;
        h[j][2 * hh + 1] = xr[j][2 * hh + 1] += xv.y;
      }
    layer_norm_frags<C>(h, sP + L::N2W, sP + L::N2B, eps, lane);
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) frags_to_a_split(ah[kk], al[kk], h[2 * kk], h[2 * kk + 1]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 bv = *reinterpret_cast<const float2*>(sP + L::FC2_B + j * 8 + 2 * t);
      xr[j][0] += bv.x;
      xr[j][2] += bv.x;
      xr[j][1] += bv.y;
      xr[j][3] += bv.y;
    }

    // the MLP, chunk by chunk: chunk hc + 1 is copied while hc is used
#pragma unroll 1
    for (int hc = 0; hc < L::CHUNKS; ++hc) {
      cp_async_wait<0>();
      __syncthreads();   // chunk hc is in; every warp is done with chunk hc - 1
      if (hc + 1 < L::CHUNKS) load_chunk(hc + 1, sFC + ((hc + 1) & 1) * L::CHUNK);
      cp_async_commit();
      const bf16* chunk = sFC + (hc & 1) * L::CHUNK;
      float f[2][4];
      linear_frags<C, 2, true>(f, ah, al, chunk + L::FC1, sP + L::FC1_B + hc * 16, lane);
      gelu_frags(f);
      uint32_t fa[4], fl[4];
      frags_to_a_split(fa, fl, f[0], f[1]);
#pragma unroll
      for (int nb = 0; nb < KT; ++nb) {
        uint32_t w[4];
        ldmatrix_x4(w, chunk + L::FC2 + (nb * 16 + (lane & 7) + (lane >> 4) * 8) * L::CS +
                           ((lane >> 3) & 1) * 8);
        mma_bf16(xr[2 * nb], fa, w[0], w[1]);
        mma_bf16(xr[2 * nb + 1], fa, w[2], w[3]);
        mma_bf16(xr[2 * nb], fl, w[0], w[1]);
        mma_bf16(xr[2 * nb + 1], fl, w[2], w[3]);
      }
    }

    // y through the warp's own x rows to 16-byte stores
    store_frags<NT>(sX, nullptr, WS, r0, 0, xr, 1.f, lane);
    __syncwarp();
#pragma unroll
    for (int e = lane; e < 16 * CH; e += 32) {
      const int tok = r0 + e / CH, c = e % CH;
      if (valid(tok))
        *reinterpret_cast<uint4*>(y + offset(tok) + c * 8) =
            *reinterpret_cast<const uint4*>(sX + tok * WS + c * 8);
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------

template <int C>
int launch_f32(const void* x, const void* st, const void* gamma, const void* beta,
               const void* const* w, void* y, int B, int H, int W, float eps,
               cudaStream_t stream) {
  using L = Layout<C>;
  static_assert(L::HD % 4 == 0 && C % 4 == 0, "4-wide weight loads");
  const int smem = L::TOTAL * (int)sizeof(float);
  auto kernel = fused_structural_block_f32_kernel<float, C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kWin - 1) / kWin, (H + kWin - 1) / kWin, B);
  auto p = [&](int i) { return static_cast<const float*>(w[i]); };
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(st),
      static_cast<const float*>(gamma), static_cast<const float*>(beta), p(0), p(1), p(2), p(3),
      p(4), p(5), p(6), p(7), p(8), p(9), p(10), p(11), static_cast<float*>(y), H, W, eps);
  return (int)cudaGetLastError();
}

template <int C>
int launch_bf16(const void* x, const void* st, const void* gamma, const void* beta,
                const void* const* w, void* y, int B, int H, int W, float eps,
                cudaStream_t stream) {
  constexpr bool kWide = C > 64;
  constexpr int threads = kWide ? kGroupThreads : kMmaThreads;
  constexpr int per_block = kWide ? 1 : kGroups;   // windows in flight
  constexpr int smem = kWide ? WideLayout::BYTES : MmaLayout<C>::BYTES;
  auto kernel = [] {
    if constexpr (kWide) return fused_structural_block_wide_kernel;
    else return fused_structural_block_mma_kernel<C>;
  }();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  static int sms = 0, blocks_per_sm = 0;   // asked once per width
  if (sms == 0) {
    const int rc = residency(kernel, threads, smem, &sms, &blocks_per_sm);
    if (rc != 0) return rc;
  }
  const long long n_windows =
      (long long)B * ((H + kWin - 1) / kWin) * ((W + kWin - 1) / kWin);
  const int grid = persistent_grid((n_windows + per_block - 1) / per_block, sms, blocks_per_sm);
  auto p = [&](int i) { return static_cast<const bf16*>(w[i]); };
  kernel<<<(unsigned)grid, threads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(st),
      static_cast<const float*>(gamma), static_cast<const float*>(beta), p(0), p(1), p(2), p(3),
      p(4), p(5), p(6), p(7), p(8), p(9), p(10), p(11), static_cast<bf16*>(y), B, H, W, eps);
  return (int)cudaGetLastError();
}

template <int C>
int launch_width(const void* x, const void* st, const void* gamma, const void* beta,
                 const void* const* w, void* y, int B, int H, int W, int dtype, float eps,
                 cudaStream_t stream) {
  if (dtype == kF32) return launch_f32<C>(x, st, gamma, beta, w, y, B, H, W, eps, stream);
  if (dtype == kBF16) return launch_bf16<C>(x, st, gamma, beta, w, y, B, H, W, eps, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace mstgan

// Plain C entry point (loaded with ctypes). x, struct and y are (B, H, W, C)
// contiguous; gamma and beta (B, C) fp32; `weights` points to 12 pointers in
// the order norm1 w/b, qkv w/b, proj w/b, norm2 w/b, fc1 w/b, fc2 w/b, of
// the same type as x (dtype 0 = fp32, 1 = bf16). C in {32, 64, 128}, with
// C / 32 heads (the c8, c16 and c32 generators' blocks). Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int fused_structural_block_launch(const void* x, const void* st, const void* gamma,
                                             const void* beta, const void* const* weights,
                                             void* y, int B, int H, int W, int C, int dtype,
                                             float eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return mstgan::launch_width<32>(x, st, gamma, beta, weights, y, B, H, W, dtype, eps, s);
    case 64: return mstgan::launch_width<64>(x, st, gamma, beta, weights, y, B, H, W, dtype, eps, s);
    case 128: return mstgan::launch_width<128>(x, st, gamma, beta, weights, y, B, H, W, dtype, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
