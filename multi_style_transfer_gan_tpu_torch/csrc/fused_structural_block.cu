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
// What bounds it. About 114 kflop per token against 384 bytes of bf16
// traffic (read x and struct, write out): ~300 flop/B, at the tensor-core
// ridge: 0.0038 ms of matrix products at (8, 64, 64, 64) against 0.0032 ms
// of bytes.
//
// bf16 design (fused_structural_block_mma_kernel). Persistent blocks, one
// per SM: each stages the four weight matrices once (bf16 as stored, (out,
// in) rows padded by 16 bytes: 105 KB) and the biases and LayerNorm
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
// 64 x 256 hidden activations never leave the registers.
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
// 97 KB, buffers reused between phases); weights are read through L2 and
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
constexpr int kC = 64;                    // the only width built
constexpr int kHeads = 2;
constexpr int kGroups = 2;                // windows in flight per block
constexpr int kGroupThreads = 128;        // 4 warps x 16 token rows
constexpr int kMmaThreads = kGroups * kGroupThreads;
constexpr int WS = kC + 8;                // rows of 64 values: 144 bytes
constexpr int W2S = 4 * kC + 8;           // fc2's rows of 256 values: 528 bytes
static_assert(mhsa::kHd * kHeads == kC && mhsa::kTok == kTok, "two heads of 32 over 64 tokens");

struct MmaLayout {
  // bf16 elements: the weights, then per group x | struct | k hi | k lo | v
  static constexpr int W_QKV = 0;                        // [3C][WS]
  static constexpr int W_PROJ = W_QKV + 3 * kC * WS;     // [C][WS]
  static constexpr int W_FC1 = W_PROJ + kC * WS;         // [4C][WS]
  static constexpr int W_FC2 = W_FC1 + 4 * kC * WS;      // [C][W2S]
  static constexpr int GROUPS = W_FC2 + kC * W2S;
  static constexpr int G_X = 0;                          // [64][WS]; later y
  static constexpr int G_ST = G_X + kTok * WS;           // [64][WS]
  static constexpr int G_KH = G_ST + kTok * WS;          // [heads][64][RS]
  static constexpr int G_KL = G_KH + kHeads * mhsa::TILE;
  static constexpr int G_V = G_KL + kHeads * mhsa::TILE;
  static constexpr int GROUP = G_V + kHeads * mhsa::TILE;
  // fp32 parameters after the bf16 part
  static constexpr int N1W = 0, N1B = kC, N2W = 2 * kC, N2B = 3 * kC;
  static constexpr int QKV_B = 4 * kC, PROJ_B = QKV_B + 3 * kC, FC1_B = PROJ_B + kC,
                       FC2_B = FC1_B + 4 * kC, PARAMS = FC2_B + kC;
  static constexpr int BYTES = (GROUPS + kGroups * GROUP) * (int)sizeof(bf16) +
                               PARAMS * (int)sizeof(float);
};

// acc (16 tokens x 8 NT outputs) = a w^T + bias: a as A fragments of 4
// k-steps (hi, and lo when kSplit), w rows [n][k] of stride WS.
template <int NT, bool kSplit>
__device__ __forceinline__ void linear_frags(float (&acc)[NT][4], const uint32_t (&ah)[4][4],
                                             const uint32_t (&al)[4][4], const bf16* w,
                                             const float* bias, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias + j * 8 + 2 * t);
    acc[j][0] = acc[j][2] = b.x;
    acc[j][1] = acc[j][3] = b.y;
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
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

// LayerNorm over the 64 channels of the lane's two token rows (g and g + 8
// of the strip), in place on C fragments; w and b are fp32 in shared memory.
__device__ __forceinline__ void layer_norm_frags(float (&h)[8][4], const float* w,
                                                 const float* b, float eps, int lane) {
  const int t = lane & 3;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s0 += h[j][0] + h[j][1];
    s1 += h[j][2] + h[j][3];
  }
  const float m0 = quad_sum(s0) / kC, m1 = quad_sum(s1) / kC;
  float v0 = 0.f, v1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v0 = fmaf(h[j][0] - m0, h[j][0] - m0, fmaf(h[j][1] - m0, h[j][1] - m0, v0));
    v1 = fmaf(h[j][2] - m1, h[j][2] - m1, fmaf(h[j][3] - m1, h[j][3] - m1, v1));
  }
  const float r0 = 1.f / sqrtf(quad_sum(v0) / kC + eps);
  const float r1 = 1.f / sqrtf(quad_sum(v1) / kC + eps);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 wv = *reinterpret_cast<const float2*>(w + j * 8 + 2 * t);
    const float2 bv = *reinterpret_cast<const float2*>(b + j * 8 + 2 * t);
    h[j][0] = (h[j][0] - m0) * r0 * wv.x + bv.x;
    h[j][1] = (h[j][1] - m0) * r0 * wv.y + bv.y;
    h[j][2] = (h[j][2] - m1) * r1 * wv.x + bv.x;
    h[j][3] = (h[j][3] - m1) * r1 * wv.y + bv.y;
  }
}

// Barrier of one group's 128 threads (named barrier 1 + group).
__device__ __forceinline__ void group_barrier(int group) {
  asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "n"(kGroupThreads) : "memory");
}

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
  using L = MmaLayout;
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
  for (int e = tid; e < 8 * kC * 8; e += kMmaThreads) {   // 512 rows of 64 values
    const int r = e / 8, c = e % 8;
    const bf16* src = r < 3 * kC ? qkvw + r * kC
                      : r < 4 * kC ? projw + (r - 3 * kC) * kC : f1w + (r - 4 * kC) * kC;
    cp_async16(sW + r * WS + c * 8, src + c * 8);
  }
  for (int e = tid; e < kC * 32; e += kMmaThreads) {      // fc2: 64 rows of 256 values
    const int r = e / 32, c = e % 32;
    cp_async16(sW + L::W_FC2 + r * W2S + c * 8, f2w + r * 4 * kC + c * 8);
  }
  for (int e = tid; e < kC; e += kMmaThreads) {
    sP[L::N1W + e] = to_f(n1w[e]);
    sP[L::N1B + e] = to_f(n1b[e]);
    sP[L::N2W + e] = to_f(n2w[e]);
    sP[L::N2B + e] = to_f(n2b[e]);
    sP[L::PROJ_B + e] = to_f(projb[e]);
    sP[L::FC2_B + e] = to_f(f2b[e]);
  }
  for (int e = tid; e < 3 * kC; e += kMmaThreads) sP[L::QKV_B + e] = to_f(qkvb[e]);
  for (int e = tid; e < 4 * kC; e += kMmaThreads) sP[L::FC1_B + e] = to_f(f1b[e]);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int nwx = (W + kWin - 1) / kWin, nwy = (H + kWin - 1) / kWin;
  const long long n_windows = (long long)B * nwy * nwx;
  const float scale = 1.f / sqrtf((float)mhsa::kHd);
  for (long long win = (long long)blockIdx.x * kGroups + group; win < n_windows;
       win += (long long)gridDim.x * kGroups) {
    const int b = (int)(win / (nwy * nwx)), rem = (int)(win - (long long)b * nwy * nwx);
    const int row0 = (rem / nwx) * kWin, col0 = (rem % nwx) * kWin;
    const bool ragged = row0 + kWin > H || col0 + kWin > W;
    auto valid = [&](int tok) { return row0 + tok / kWin < H && col0 + tok % kWin < W; };
    auto offset = [&](int tok) {
      return (((long long)b * H + row0 + tok / kWin) * W + col0 + tok % kWin) * kC;
    };

    // the warp's 16 token rows of x and struct; tokens outside the grid
    // load as zeros
#pragma unroll
    for (int e = lane; e < 16 * 8; e += 32) {
      const int tok = r0 + e / 8, c = e % 8;
      const bool ok = valid(tok);
      const long long off = ok ? offset(tok) + c * 8 : 0;
      cp_async16(sX + tok * WS + c * 8, x + off, ok);
      cp_async16(sSt + tok * WS + c * 8, st + off, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();

    float h[8][4];   // x + struct, then the LN outputs and the products' sums
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int off = (r0 + g + 8 * hh) * WS + j * 8 + 2 * t;
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sX + off));
        const float2 sv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sSt + off));
        h[j][2 * hh] = xv.x + sv.x;
        h[j][2 * hh + 1] = xv.y + sv.y;
      }
    layer_norm_frags(h, sP + L::N1W, sP + L::N1B, eps, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {   // FiLM
      const float2 ga = __ldg(reinterpret_cast<const float2*>(gamma + b * kC + j * 8 + 2 * t));
      const float2 be = __ldg(reinterpret_cast<const float2*>(beta + b * kC + j * 8 + 2 * t));
      h[j][0] = h[j][0] * (1.f + ga.x) + be.x;
      h[j][1] = h[j][1] * (1.f + ga.y) + be.y;
      h[j][2] = h[j][2] * (1.f + ga.x) + be.x;
      h[j][3] = h[j][3] * (1.f + ga.y) + be.y;
    }
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) frags_to_a_split(ah[kk], al[kk], h[2 * kk], h[2 * kk + 1]);

    // q stays in registers as A fragments (hi + lo); k (hi + lo) and v go
    // to the group's tiles
    uint32_t qh[kHeads][2][4], ql[kHeads][2][4];
#pragma unroll
    for (int hd = 0; hd < kHeads; ++hd) {
      float acc[4][4];
      linear_frags<4, true>(acc, ah, al, sW + L::W_QKV + hd * mhsa::kHd * WS,
                            sP + L::QKV_B + hd * mhsa::kHd, lane);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        frags_to_a_split(qh[hd][kk], ql[hd][kk], acc[2 * kk], acc[2 * kk + 1]);
    }
    group_barrier(group);   // the previous window's k and v are read
#pragma unroll
    for (int hd = 0; hd < kHeads; ++hd) {
      float acc[4][4];
      linear_frags<4, true>(acc, ah, al, sW + L::W_QKV + (kC + hd * mhsa::kHd) * WS,
                            sP + L::QKV_B + kC + hd * mhsa::kHd, lane);
      store_frags<4>(sKh + hd * mhsa::TILE, sKl + hd * mhsa::TILE, mhsa::RS, r0, 0, acc, 1.f,
                     lane);
      linear_frags<4, false>(acc, ah, al, sW + L::W_QKV + (2 * kC + hd * mhsa::kHd) * WS,
                             sP + L::QKV_B + 2 * kC + hd * mhsa::kHd, lane);
      store_frags<4>(sV + hd * mhsa::TILE, nullptr, mhsa::RS, r0, 0, acc, 1.f, lane);
    }
    group_barrier(group);   // this window's k and v are in

    // per head: scores, softmax and p v for the warp's 16 queries; the
    // result is two k-steps of the proj
#pragma unroll
    for (int hd = 0; hd < kHeads; ++hd) {
      float s[8][4];
      mhsa::times_tile_t_split(s, qh[hd], ql[hd], sKh + hd * mhsa::TILE, sKl + hd * mhsa::TILE,
                               lane);
      if (ragged) {   // keys outside the grid drop out of the softmax
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (!valid(j * 8 + 2 * t)) s[j][0] = s[j][2] = -INFINITY;
          if (!valid(j * 8 + 2 * t + 1)) s[j][1] = s[j][3] = -INFINITY;
        }
      }
      float l0, l1;   // token 0 of a window is always a valid key
      mhsa::exp_rows<true>(s, scale, l0, l1);   // __expf: y is rounded to bf16
      float o[4][4] = {};
      mhsa::strip_times_tile<false>(o, s, sV + hd * mhsa::TILE, lane);
      l0 = 1.f / l0;
      l1 = 1.f / l1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[j][0] *= l0;
        o[j][1] *= l0;
        o[j][2] *= l1;
        o[j][3] *= l1;
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) frags_to_a(ah[2 * hd + kk], o[2 * kk], o[2 * kk + 1]);
    }

    // proj and the residual (x is still in the warp's rows of sX), LN2
    float xr[8][4];   // the residual stream, then y's sums
    linear_frags<8, false>(xr, ah, al, sW + L::W_PROJ, sP + L::PROJ_B, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            sX + (r0 + g + 8 * hh) * WS + j * 8 + 2 * t));
        h[j][2 * hh] = xr[j][2 * hh] += xv.x;
        h[j][2 * hh + 1] = xr[j][2 * hh + 1] += xv.y;
      }
    layer_norm_frags(h, sP + L::N2W, sP + L::N2B, eps, lane);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) frags_to_a(ah[kk], h[2 * kk], h[2 * kk + 1]);

    // the MLP, 16 hidden columns at a time: fc1 and its GELU on the
    // accumulators are one k-step of fc2, summed onto the residual
    {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bv = *reinterpret_cast<const float2*>(sP + L::FC2_B + j * 8 + 2 * t);
        xr[j][0] += bv.x;
        xr[j][2] += bv.x;
        xr[j][1] += bv.y;
        xr[j][3] += bv.y;
      }
#pragma unroll 1
      for (int hc = 0; hc < 4 * kC / 16; ++hc) {
        float f[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float2 bv =
              *reinterpret_cast<const float2*>(sP + L::FC1_B + hc * 16 + n * 8 + 2 * t);
          f[n][0] = f[n][2] = bv.x;
          f[n][1] = f[n][3] = bv.y;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t w[4];
          ldmatrix_x4(w, sW + L::W_FC1 + (hc * 16 + (lane & 7) + (lane >> 4) * 8) * WS + kk * 16 +
                             ((lane >> 3) & 1) * 8);
          mma_bf16(f[0], ah[kk], w[0], w[1]);
          mma_bf16(f[1], ah[kk], w[2], w[3]);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            f[n][i] = 0.5f * f[n][i] * (1.f + erff(f[n][i] * 0.70710678118654752f));
        uint32_t fa[4];
        frags_to_a(fa, f[0], f[1]);
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          uint32_t w[4];
          ldmatrix_x4(w, sW + L::W_FC2 + (nb * 16 + (lane & 7) + (lane >> 4) * 8) * W2S + hc * 16 +
                             ((lane >> 3) & 1) * 8);
          mma_bf16(xr[2 * nb], fa, w[0], w[1]);
          mma_bf16(xr[2 * nb + 1], fa, w[2], w[3]);
        }
      }
    }

    // y through the warp's own x rows to 16-byte stores
    store_frags<8>(sX, nullptr, WS, r0, 0, xr, 1.f, lane);
    __syncwarp();
#pragma unroll
    for (int e = lane; e < 16 * 8; e += 32) {
      const int tok = r0 + e / 8, c = e % 8;
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

int launch_bf16(const void* x, const void* st, const void* gamma, const void* beta,
                const void* const* w, void* y, int B, int H, int W, float eps,
                cudaStream_t stream) {
  auto kernel = fused_structural_block_mma_kernel;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         MmaLayout::BYTES);
  if (err != cudaSuccess) return (int)err;
  static int sms = 0, blocks_per_sm = 0;   // asked once
  if (sms == 0) {
    const int rc = residency(kernel, kMmaThreads, MmaLayout::BYTES, &sms, &blocks_per_sm);
    if (rc != 0) return rc;
  }
  const long long n_windows =
      (long long)B * ((H + kWin - 1) / kWin) * ((W + kWin - 1) / kWin);
  const int grid = persistent_grid((n_windows + kGroups - 1) / kGroups, sms, blocks_per_sm);
  auto p = [&](int i) { return static_cast<const bf16*>(w[i]); };
  kernel<<<(unsigned)grid, kMmaThreads, MmaLayout::BYTES, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(st),
      static_cast<const float*>(gamma), static_cast<const float*>(beta), p(0), p(1), p(2), p(3),
      p(4), p(5), p(6), p(7), p(8), p(9), p(10), p(11), static_cast<bf16*>(y), B, H, W, eps);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace mstgan

// Plain C entry point (loaded with ctypes). x, struct and y are (B, H, W, C)
// contiguous; gamma and beta (B, C) fp32; `weights` points to 12 pointers in
// the order norm1 w/b, qkv w/b, proj w/b, norm2 w/b, fc1 w/b, fc2 w/b, of
// the same type as x (dtype 0 = fp32, 1 = bf16). Only C = 64 is built.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int fused_structural_block_launch(const void* x, const void* st, const void* gamma,
                                             const void* beta, const void* const* weights,
                                             void* y, int B, int H, int W, int C, int dtype,
                                             float eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (C != 64) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mstgan::kF32)
    return mstgan::launch_f32<64>(x, st, gamma, beta, weights, y, B, H, W, eps, s);
  if (dtype == mstgan::kBF16)
    return mstgan::launch_bf16(x, st, gamma, beta, weights, y, B, H, W, eps, s);
  return (int)cudaErrorInvalidValue;
}
