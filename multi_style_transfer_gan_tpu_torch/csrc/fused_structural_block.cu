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
// Widths: any C from 1 to 256 with default_num_heads(C) heads of at most 64
// channels here; in bf16 the dims from 260 to 512 (C % 4 == 0, heads of at
// most 64) in the pair kernel, a source of its own,
// fused_structural_block_pair.cu, and every other dim (past 512, or heads
// wider than 64) in the streamed chain, fused_structural_block_stream.cu; in
// fp32 every dim past 256 or with wider heads in the FMA bodies with a
// workspace below (heads of up to 174 channels). Below, the
// designs of C % 32 == 0 with C / 32 heads of 32 (c8 .. c64 at multiples
// of 8: dims 32, 64, .., 256); after them the head-slot kernel (bf16, the
// other generator dims from 48 on) and the FMA bodies (fp32 at every
// other dim; bf16 at dim 16 and the dims no generator has). In bf16, dims
// 32 and 64 have a kernel each; dim 96 runs padded in the dim-128 design and
// dims 160, 192 and 224 in the dim-256 design, one instantiation per dim
// with the dim and the head count folded in. Padding is exact: the
// residual stream's channels from C to the layout's DP are zero, every
// weight row and column and every bias, norm and FiLM entry past C is a
// staged zero, so a pad channel stays zero through every product, and both
// LayerNorms take their mean and variance over the C real channels only
// (over DP each pad channel would add (0 - mean)^2 to the variance). A head slot past the real heads
// is skipped in the dim-128 design; in the dim-256 design, which takes heads
// in pairs, the second head of an odd count's last pair runs on zeros (q = k
// = v = 0: a uniform softmax over zero v, dropped by zero proj columns).
// The scale stays 1/sqrt(32). fp32 has an instantiation at each dim.
//
// What bounds it. About 24 C^2 + 256 C flop per token against 6 C bytes of
// bf16 traffic (read x and struct, write out): ~300 flop/B at C = 64, at the
// tensor-core ridge (0.0038 ms of matrix products at (8, 64, 64, 64) against
// 0.0032 ms of bytes); at C = 32 about half that, bytes-bound; at C = 128
// about 570 flop/B and at C = 256 about 1100, bound by operations.
//
// bf16 design (fused_structural_block_mma_kernel, C = 32 and 64; C = 96-128
// and 160-256 in fused_structural_block_wide_kernel and _widest_kernel
// below).
// Persistent blocks: each
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
// 97 KB at C = 64, 193 KB at C = 128, buffers reused between phases; C =
// 160-256 in fused_structural_block_f32_wide_kernel, a head and a hidden
// chunk at a time); weights are read through L2 and
// the read-only cache, four at a time. In the four Linear products each
// thread keeps a 4-token by N/16-output tile of sums in registers;
// activation rows have an odd stride so a warp's reads fall in distinct
// banks.
#include <cmath>
#include <type_traits>

#include "fused_structural_block.cuh"

namespace mstgan {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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


// out[t][o] = A[t] . row(o) + bias(o) for every token t and output o < N,
// handed to epi(t, o, value); row(o) points to the K weights of output o.
// Each thread keeps a 4 x N/16 tile of sums in registers (tokens tg + 16j,
// outputs og + 16r, with tg = tid % 16 and og = tid / 16), so every 4-deep
// step loads 16 activations from shared memory and N/16 weight quads for
// 4 * N/4 FMAs. A warp reads 16 activation rows (odd stride: distinct
// banks) and two weight rows.
__device__ __forceinline__ float fma_acc(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_acc(double a, double b, double c) { return fma(a, b, c); }

// The sums are carried in Acc (float, or double where the caller needs
// them exact to fp32 rounding of their inputs).
template <int K, int N, int AS, typename Acc = float, typename Row, typename Bias, typename Epi>
__device__ __forceinline__ void linear_rows_mapped(const float* A, Row row, Bias bias, Epi epi) {
  static_assert(kThreads == 256 && kTok == 64 && N % 16 == 0 && K % 4 == 0,
                "a 16 x 16 grid of threads over 64 tokens and N outputs");
  constexpr int TM = kTok / 16, TN = N / 16;
  const int tg = threadIdx.x % 16, og = threadIdx.x / 16;
  Acc acc[TM][TN] = {};
#pragma unroll 1
  for (int i = 0; i < K; i += 4) {
    float a[TM][4];
#pragma unroll
    for (int j = 0; j < TM; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) a[j][q] = A[(tg + 16 * j) * AS + i + q];
#pragma unroll
    for (int r = 0; r < TN; ++r) {
      const float4 wv = load4(row(og + 16 * r) + i);
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        acc[j][r] = fma_acc((Acc)a[j][0], (Acc)wv.x, acc[j][r]);
        acc[j][r] = fma_acc((Acc)a[j][1], (Acc)wv.y, acc[j][r]);
        acc[j][r] = fma_acc((Acc)a[j][2], (Acc)wv.z, acc[j][r]);
        acc[j][r] = fma_acc((Acc)a[j][3], (Acc)wv.w, acc[j][r]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < TM; ++j)
#pragma unroll
    for (int r = 0; r < TN; ++r) {
      const int o = og + 16 * r;
      epi(tg + 16 * j, o, acc[j][r] + (Acc)bias(o));
    }
}

// The same with w the (N, K) weight in rows and b its N biases.
template <int K, int N, int AS, typename T, typename Epi>
__device__ __forceinline__ void linear_rows(const float* A, const T* __restrict__ w,
                                            const T* __restrict__ b, Epi epi) {
  linear_rows_mapped<K, N, AS>(
      A, [&](int o) { return w + (long long)o * K; }, [&](int o) { return to_f(b[o]); }, epi);
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

// fp32 at C = 160-256 (the c40 .. c64 generators' blocks, 5-8 heads):
// Layout<256> would need ~394 KB. The MHSA runs a head at a time and adds
// that head's share of the proj, o_h Wproj[:, head]^T, onto the residual
// stream at once; the MLP runs in chunks of 128 hidden columns, each chunk's
// fc2 share added onto the residual stream, so no product's register tile
// grows past 4 x 16 and no intermediate past 64 x (C + 1) floats (214 KB in
// all at C = 256). A head's q and k, its scores and their softmax are
// carried in double, as the plain version carries them in float64: where a
// block's scores are 16 times larger (chip_smoke.py's saturated input) fp32
// scores at dim 256 leave the block 2.6e-4 from a float64 evaluation, past
// the 2e-4 the two are held to, and float64 ones 8.6e-5
// (devtools/serving_kernel_rounding.py --fp32). The softmax meets v in fp32.
template <int C_>
struct F32WideLayout {
  static constexpr int C = C_, HEADS = C / 32, HD = C / HEADS, HC = 128;
  static constexpr int XS = C + 1;          // token rows of width C
  static constexpr int KS = 2 * HD + 1;     // one head's q | k rows (double)
  static constexpr int SS = kTok + 1;       // score rows (double)
  static constexpr int VS = HD + 1;         // one head's v rows, then its output
  static constexpr int AS = HC + 1;         // a chunk of the MLP's hidden rows
  static constexpr int X = 0;                 // [kTok][XS] residual stream
  static constexpr int H = X + kTok * XS;     // [kTok][XS] LN1 out, then LN2 out
  static constexpr int U = H + kTok * XS;     // union: one head, later a hidden chunk
  static constexpr int QK = U;                // [kTok][KS] doubles
  static constexpr int S = QK + 2 * kTok * KS;   // [kTok][SS] doubles
  static constexpr int V = S + 2 * kTok * SS;    // [kTok][VS]
  static constexpr int O = V + kTok * VS;        // [kTok][VS]
  static constexpr int A1 = U;
  static constexpr int HEAD = 2 * kTok * (KS + SS) + 2 * kTok * VS;
  static constexpr int U_SIZE = HEAD > kTok * AS ? HEAD : kTok * AS;
  static constexpr int TOTAL = U + U_SIZE;
  static_assert(U % 2 == 0, "the double arrays are 8-byte aligned");
  static_assert(C % 32 == 0 && 4 * C % HC == 0, "heads of 32; whole hidden chunks");
};

template <typename T, int C_>
__global__ void __launch_bounds__(kThreads)
fused_structural_block_f32_wide_kernel(const T* __restrict__ x, const T* __restrict__ st,
                                       const float* __restrict__ gamma,
                                       const float* __restrict__ beta, const T* __restrict__ n1w,
                                       const T* __restrict__ n1b, const T* __restrict__ qkvw,
                                       const T* __restrict__ qkvb, const T* __restrict__ projw,
                                       const T* __restrict__ projb, const T* __restrict__ n2w,
                                       const T* __restrict__ n2b, const T* __restrict__ f1w,
                                       const T* __restrict__ f1b, const T* __restrict__ f2w,
                                       const T* __restrict__ f2b, T* __restrict__ y, int H, int W,
                                       float eps) {
  using L = F32WideLayout<C_>;
  constexpr int C = L::C, HD = L::HD, HC = L::HC;
  extern __shared__ float smem[];
  float* sX = smem + L::X;
  float* sH = smem + L::H;
  double* sQK = reinterpret_cast<double*>(smem + L::QK);
  double* sS = reinterpret_cast<double*>(smem + L::S);
  float* sV = smem + L::V;
  float* sO = smem + L::O;
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

  const double scale = 1.0 / sqrt((double)HD);
#pragma unroll 1
  for (int hh = 0; hh < L::HEADS; ++hh) {
    // this head's q, k (double) and v: rows hh HD.. of each third of Wqkv
    linear_rows_mapped<C, 3 * HD, L::XS, double>(
        sH, [&](int o) { return qkvw + (long long)((o / HD) * C + hh * HD + o % HD) * C; },
        [&](int o) { return to_f(qkvb[(o / HD) * C + hh * HD + o % HD]); },
        [&](int t, int o, double v) {
          if (o < 2 * HD) sQK[t * L::KS + o] = v;
          else sV[t * L::VS + o - 2 * HD] = (float)v;
        });
    __syncthreads();
    for (int e = tid; e < kTok * kTok; e += kThreads) {
      const int s = e % kTok, t = e / kTok;
      double acc = -INFINITY;  // keys outside the grid drop out of the softmax
      if (valid(s)) {
        const double* q = sQK + t * L::KS;
        const double* k = sQK + s * L::KS + HD;
        acc = 0.0;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) acc = fma(q[d], k[d], acc);
        acc *= scale;
      }
      sS[t * L::SS + s] = acc;
    }
    __syncthreads();
    for (int t = warp; t < kTok; t += kWarps) {  // token 0 of a window is always a valid key
      double* r = sS + t * L::SS;
      double m = fmax(r[lane], r[lane + 32]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmax(m, __shfl_xor_sync(0xffffffffu, m, o));
      const double e0 = exp(r[lane] - m), e1 = exp(r[lane + 32] - m);
      double sum = e0 + e1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      r[lane] = e0 / sum;
      r[lane + 32] = e1 / sum;
    }
    __syncthreads();
    for (int e = tid; e < kTok * HD; e += kThreads) {
      const int d = e % HD, t = e / HD;
      const double* p = sS + t * L::SS;
      const float* v = sV + d;
      float acc = 0.f;
#pragma unroll 8
      for (int s = 0; s < kTok; ++s) acc = fmaf((float)p[s], v[s * L::VS], acc);
      sO[t * L::VS + d] = acc;
    }
    __syncthreads();
    // the head's share of the proj (and, once, its bias) onto the residual
    linear_rows_mapped<HD, C, L::VS>(
        sO, [&](int o) { return projw + (long long)o * C + hh * HD; },
        [&](int o) { return hh == 0 ? to_f(projb[o]) : 0.f; },
        [&](int t, int o, float v) { sX[t * L::XS + o] += v; });
    __syncthreads();
  }

  layer_norm_rows<C>(sX, sH, n2w, n2b, eps, nullptr, nullptr);
  __syncthreads();
#pragma unroll 1
  for (int hc = 0; hc < 4 * C / HC; ++hc) {
    linear_rows_mapped<C, HC, L::XS>(
        sH, [&](int o) { return f1w + (long long)(hc * HC + o) * C; },
        [&](int o) { return to_f(f1b[hc * HC + o]); }, [&](int t, int o, float v) {
          sA1[t * L::AS + o] = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
        });
    __syncthreads();
    linear_rows_mapped<HC, C, L::AS>(
        sA1, [&](int o) { return f2w + (long long)o * 4 * C + hc * HC; },
        [&](int o) { return hc == 0 ? to_f(f2b[o]) : 0.f; },
        [&](int t, int o, float v) { sX[t * L::XS + o] += v; });
    __syncthreads();
  }

  for (int e = tid; e < kTok * C; e += kThreads) {
    const int t = e / C, c = e % C;
    if (valid(t)) y[offset(t) + c] = from_f<T>(sX[t * L::XS + c]);
  }
}

// ---------------------------------------------------------------------------
// bf16: warp MMA
// ---------------------------------------------------------------------------

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

// LayerNorm over the C real channels of the lane's two token rows (g and
// g + 8 of the strip), in place on DP / 8 fragments whose channels from C
// on are zero; w and b are fp32 in shared memory (zero past C, so the pads
// stay zero). The mean and the variance count the real channels only.
template <int DP>
__device__ __forceinline__ void layer_norm_frags(float (&h)[DP / 8][4], const float* w,
                                                 const float* b, float eps, int lane,
                                                 int C = DP) {
  const int t = lane & 3;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    s0 += h[j][0] + h[j][1];
    s1 += h[j][2] + h[j][3];
  }
  const float m0 = quad_sum(s0) / C, m1 = quad_sum(s1) / C;
  float v0 = 0.f, v1 = 0.f;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    if (j * 8 >= C) break;
    v0 = fmaf(h[j][0] - m0, h[j][0] - m0, fmaf(h[j][1] - m0, h[j][1] - m0, v0));
    v1 = fmaf(h[j][2] - m1, h[j][2] - m1, fmaf(h[j][3] - m1, h[j][3] - m1, v1));
  }
  const float r0 = 1.f / sqrtf(quad_sum(v0) / C + eps);
  const float r1 = 1.f / sqrtf(quad_sum(v1) / C + eps);
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const float2 wv = *reinterpret_cast<const float2*>(w + j * 8 + 2 * t);
    const float2 bv = *reinterpret_cast<const float2*>(b + j * 8 + 2 * t);
    h[j][0] = (h[j][0] - m0) * r0 * wv.x + bv.x;
    h[j][1] = (h[j][1] - m0) * r0 * wv.y + bv.y;
    h[j][2] = (h[j][2] - m1) * r1 * wv.x + bv.x;
    h[j][3] = (h[j][3] - m1) * r1 * wv.y + bv.y;
  }
}

// FiLM of the LN1 output on DP / 8 fragments: h (1 + gamma) + beta, gamma
// and beta the batch entry's rows of C (fp32, read through the read-only
// cache); the pad channels (zero) are left as they are.
template <int DP>
__device__ __forceinline__ void film_frags(float (&h)[DP / 8][4], const float* gamma,
                                           const float* beta, int lane, int C = DP) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    if (j * 8 >= C) break;
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

// DP = 128 (the c32 generator's dim 128, and c24's dim 96 padded): the four
// weights are ~400 KB with padding, past the 227 KB a block may hold. qkv
// and proj stay resident (139 KB); fc1's rows and fc2's columns stream
// through shared memory in chunks of 16 hidden columns (double-buffered
// cp.async, one block barrier a chunk), which is the grain the MLP consumes
// anyway; only the 4C / 16 chunks of the real hidden columns pass. A block
// is one group of 4 warps on one window; k and v are staged one head at a
// time, for the C / 32 real heads. LN1's output enters q, k and v as hi +
// lo pairs, LN2's output fc1 and the GELU output fc2 as pairs too: with the
// c16 kernel's pairs alone a saturated block at dim 128 reaches 1.01-1.09
// of the bf16 bound, with these 0.67-0.72 (devtools/serving_kernel_rounding.py).
struct WideLayout {
  static constexpr int DP = 128, HEADS = DP / mhsa::kHd, KT = DP / 16, NT = DP / 8, CH = DP / 8;
  static constexpr int WS = DP + 8;             // rows of DP values: 272 bytes
  static constexpr int CS = 16 + 8;             // an fc2 chunk row: 16 values, 48 bytes
  static constexpr int W_QKV = 0;                        // [3DP][WS]
  static constexpr int W_PROJ = W_QKV + 3 * DP * WS;     // [DP][WS]
  static constexpr int FC = W_PROJ + DP * WS;            // [2] chunks:
  static constexpr int FC1 = 0, FC2 = 16 * WS;           //   fc1 rows [16][WS], fc2 [DP][CS]
  static constexpr int CHUNK = FC2 + DP * CS;
  static constexpr int X = FC + 2 * CHUNK;               // [64][WS]; later y
  static constexpr int KH = X + kTok * WS;               // one head: k hi, k lo, v [64][RS]
  static constexpr int KL = KH + mhsa::TILE;
  static constexpr int V = KL + mhsa::TILE;
  static constexpr int ELEMS = V + mhsa::TILE;
  static constexpr int N1W = 0, N1B = DP, N2W = 2 * DP, N2B = 3 * DP;
  static constexpr int QKV_B = 4 * DP, PROJ_B = QKV_B + 3 * DP, FC1_B = PROJ_B + DP,
                       FC2_B = FC1_B + 4 * DP, PARAMS = FC2_B + DP;
  static constexpr int BYTES = ELEMS * (int)sizeof(bf16) + PARAMS * (int)sizeof(float);
};

// The fp32 parameters of a padded design into sP at the offsets of layout
// L: norms, proj and fc2 biases (DP each), qkv's (3 DP: q, k, v at 0, DP,
// 2 DP) and fc1's (4 DP); zeros past the real C (4C for fc1).
template <typename L>
__device__ __forceinline__ void stage_params(float* sP, const bf16* __restrict__ n1w,
                                             const bf16* __restrict__ n1b,
                                             const bf16* __restrict__ qkvb,
                                             const bf16* __restrict__ projb,
                                             const bf16* __restrict__ n2w,
                                             const bf16* __restrict__ n2b,
                                             const bf16* __restrict__ f1b,
                                             const bf16* __restrict__ f2b, int C, int tid,
                                             int threads) {
  constexpr int DP = L::DP;
  for (int e = tid; e < DP; e += threads) {
    const bool real = e < C;
    sP[L::N1W + e] = real ? to_f(n1w[e]) : 0.f;
    sP[L::N1B + e] = real ? to_f(n1b[e]) : 0.f;
    sP[L::N2W + e] = real ? to_f(n2w[e]) : 0.f;
    sP[L::N2B + e] = real ? to_f(n2b[e]) : 0.f;
    sP[L::PROJ_B + e] = real ? to_f(projb[e]) : 0.f;
    sP[L::FC2_B + e] = real ? to_f(f2b[e]) : 0.f;
  }
  for (int e = tid; e < 3 * DP; e += threads) {
    const int blk = e / DP, i = e % DP;
    sP[L::QKV_B + e] = i < C ? to_f(qkvb[blk * C + i]) : 0.f;
  }
  for (int e = tid; e < 4 * DP; e += threads) sP[L::FC1_B + e] = e < 4 * C ? to_f(f1b[e]) : 0.f;
}

// C: the real dim (96 or 128), a compile-time constant.
template <int C>
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
  constexpr int DP = L::DP, KT = L::KT, NT = L::NT, WS = L::WS;
  static_assert(C % mhsa::kHd == 0 && C > 64 && C <= DP, "dims 96 and 128");
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
  constexpr int CH = C / 8, heads = C / mhsa::kHd, chunks = 4 * C / 16;

  // chunk hc of the MLP into buffer dst: fc1 rows 16 hc.., fc2 columns
  // 16 hc.. of every row, 16 bytes a copy by the whole block; zeros past C
  auto load_chunk = [&](int hc, bf16* dst) {
    for (int e = tid; e < 16 * L::CH + 2 * DP; e += kGroupThreads) {
      if (e < 16 * L::CH) {
        const int r = e / L::CH, c = e % L::CH;
        const bool real = c < CH;
        cp_async16(dst + L::FC1 + r * WS + c * 8,
                   real ? f1w + (long long)(hc * 16 + r) * C + c * 8 : f1w, real);
      } else {
        const int r = (e - 16 * L::CH) / 2, c = (e - 16 * L::CH) % 2;
        const bool real = r < C;
        cp_async16(dst + L::FC2 + r * L::CS + c * 8,
                   real ? f2w + (long long)r * 4 * C + hc * 16 + c * 8 : f2w, real);
      }
    }
  };

  for (int e = tid; e < 4 * DP * L::CH; e += kGroupThreads) {   // qkv and proj: 4DP rows
    const int r = e / L::CH, c = e % L::CH, blk = r / DP, i = r % DP;
    const bool real = i < C && c < CH;
    const bf16* src = blk < 3 ? qkvw + (long long)(blk * C + i) * C : projw + (long long)i * C;
    cp_async16(sW + r * WS + c * 8, real ? src + c * 8 : qkvw, real);
  }
  stage_params<L>(sP, n1w, n1b, qkvb, projb, n2w, n2b, f1b, f2b, C, tid, kGroupThreads);
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

    // the warp's 16 token rows of x (tokens outside the grid and the pad
    // channels as zeros), then chunk 0 of the MLP into buffer 0: every warp
    // is past the barrier of the previous window's last chunk, which used
    // buffer 1 (the chunk count is even)
#pragma unroll
    for (int e = lane; e < 16 * L::CH; e += 32) {
      const int tok = r0 + e / L::CH, c = e % L::CH;
      const bool ok = valid(tok) && c < CH;
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
        if (ok && j * 8 < C) {
          const unsigned int u = __ldg(reinterpret_cast<const unsigned int*>(srow + j * 8 + 2 * t));
          sv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
        }
        h[j][2 * hh] = xv.x + sv.x;
        h[j][2 * hh + 1] = xv.y + sv.y;
      }
    }
    layer_norm_frags<DP>(h, sP + L::N1W, sP + L::N1B, eps, lane, C);
    film_frags<DP>(h, gamma + (long long)b * C, beta + (long long)b * C, lane, C);
    uint32_t ah[KT][4], al[KT][4];
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) frags_to_a_split(ah[kk], al[kk], h[2 * kk], h[2 * kk + 1]);

    // head by head: q in registers, k and v through the block's tiles,
    // the head's output two k-steps of the proj (zero for a head slot past
    // the real heads, whose proj columns are zero too)
    uint32_t oa[KT][4] = {};
#pragma unroll 1
    for (int hd = 0; hd < heads; ++hd) {
      uint32_t qh[2][4], ql[2][4];
      {
        float acc[4][4];
        linear_frags<DP, 4, true>(acc, ah, al, sW + L::W_QKV + hd * mhsa::kHd * WS,
                                  sP + L::QKV_B + hd * mhsa::kHd, lane);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          frags_to_a_split(qh[kk], ql[kk], acc[2 * kk], acc[2 * kk + 1]);
      }
      __syncthreads();   // every warp is done with the previous head's k and v
      {
        float acc[4][4];
        linear_frags<DP, 4, true>(acc, ah, al, sW + L::W_QKV + (DP + hd * mhsa::kHd) * WS,
                                  sP + L::QKV_B + DP + hd * mhsa::kHd, lane);
        store_frags<4>(sKh, sKl, mhsa::RS, r0, 0, acc, 1.f, lane);
        linear_frags<DP, 4, true>(acc, ah, al, sW + L::W_QKV + (2 * DP + hd * mhsa::kHd) * WS,
                                  sP + L::QKV_B + 2 * DP + hd * mhsa::kHd, lane);
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
    linear_frags<DP, NT, false>(xr, oa, oa, sW + L::W_PROJ, sP + L::PROJ_B, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            sX + (r0 + g + 8 * hh) * WS + j * 8 + 2 * t));
        h[j][2 * hh] = xr[j][2 * hh] += xv.x;
        h[j][2 * hh + 1] = xr[j][2 * hh + 1] += xv.y;
      }
    layer_norm_frags<DP>(h, sP + L::N2W, sP + L::N2B, eps, lane, C);
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
    for (int hc = 0; hc < chunks; ++hc) {
      cp_async_wait<0>();
      __syncthreads();   // chunk hc is in; every warp is done with chunk hc - 1
      if (hc + 1 < chunks) load_chunk(hc + 1, sFC + ((hc + 1) & 1) * L::CHUNK);
      cp_async_commit();
      const bf16* chunk = sFC + (hc & 1) * L::CHUNK;
      float f[2][4];
      linear_frags<DP, 2, true>(f, ah, al, chunk + L::FC1, sP + L::FC1_B + hc * 16, lane);
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

    // y through the warp's own x rows to 16-byte stores, the C real channels
    store_frags<NT>(sX, nullptr, WS, r0, 0, xr, 1.f, lane);
    __syncwarp();
    for (int e = lane; e < 16 * CH; e += 32) {
      const int tok = r0 + e / CH, c = e % CH;
      if (valid(tok))
        *reinterpret_cast<uint4*>(y + offset(tok) + c * 8) =
            *reinterpret_cast<const uint4*>(sX + tok * WS + c * 8);
    }
    __syncwarp();
  }
}

// DP = 256 (the c64 generator's dim 256 in 8 heads, and c40's, c48's and
// c56's dims 160, 192 and 224 in 5, 6 and 7 heads, padded): the four
// weights are ~1.6 MB with padding and all of them stream, and a warp that
// owned 16 token rows of the window's width would hold 128 fp32 values a
// thread for the residual stream alone. A block is 8 warps on one window:
// warp w owns token rows 16 (w % 4).. and, of every 64 output columns, the
// 32 at 32 (w / 4).. (128 columns in all), so the residual stream is 64
// values a thread in registers. The weights pass through shared memory in
// tiles (double-buffered 16-byte cp.async, one block barrier a tile, the
// next window's first tile copied during the last), zero-filled past C:
//   heads  per pair of heads (ceil(heads / 2) pairs), a tile of 64 q rows,
//          one of k rows and one of v rows of Wqkv: warp w forms q (kept as A
//          fragments), k and v of head 2 pair + w / 4 for its 16 tokens; k
//          and v of both heads go to shared memory; the MHSA of
//          window_mhsa_mma.cuh runs per warp and head (keys outside a ragged
//          grid at -inf); the pair's output (64 x 64) goes to shared memory,
//          and two tiles of Wproj (128 output rows x the pair's 64 columns)
//          add its share of the proj onto the residual stream, which starts
//          as x + the proj bias;
//   LN2    over the residual stream's C real columns, its row sums exchanged
//          between the two warps of a row through shared memory;
//   MLP    4C / 128 chunks of 128 hidden columns: two tiles of fc1 rows
//          (GELU on the accumulators, the chunk to shared memory), then four
//          tiles of fc2 (64 output rows x the chunk's 128 columns) onto the
//          stream.
// Operands rounded to bf16 inside: every one the kernel forms is a hi + lo
// pair (LN1's and LN2's outputs, q, k, v, the exponentials, the MHSA output,
// the GELU output): with the dim-128 kernel's pairs a random block at dim
// 256 misses the bf16 bound by 1.35x, with these it stays at 0.68 (0.81 on
// the saturated one, a one-ulp flip of the output rounding;
// devtools/serving_kernel_rounding.py).
struct WidestLayout {
  static constexpr int DP = 256, KT = DP / 16;
  static constexpr int HC = 128;                // hidden columns a chunk
  static constexpr int WS = DP + 8;             // rows of DP values: 528 bytes
  static constexpr int PS = 64 + 8;             // proj tile rows, a pair's output: 144 bytes
  static constexpr int FS = HC + 8;             // fc2 tile rows, the hidden chunk: 272 bytes
  static constexpr int TILE = 64 * WS;          // the largest tile (128 x PS fits too)
  static constexpr int W = 0;                             // [2][TILE]
  static constexpr int HH = W + 2 * TILE;                 // [64][WS] LN1 out, then LN2 out, hi
  static constexpr int HL = HH + kTok * WS;               //   ... lo
  static constexpr int U = HL + kTok * WS;                // union:
  static constexpr int KV = U;                            //   [2 heads][kh, kl, vh, vl] tiles
  static constexpr int OH = KV + 2 * 4 * mhsa::TILE;      //   [64][PS] the pair's output hi
  static constexpr int OL = OH + kTok * PS;               //   ... lo
  static constexpr int AH = U;                            //   [64][FS] the hidden chunk hi
  static constexpr int AL = AH + kTok * FS;               //   ... lo
  static constexpr int ELEMS = (OL + kTok * PS > AL + kTok * FS ? OL + kTok * PS : AL + kTok * FS);
  static constexpr int N1W = 0, N1B = DP, N2W = 2 * DP, N2B = 3 * DP;
  static constexpr int QKV_B = 4 * DP, PROJ_B = QKV_B + 3 * DP, FC1_B = PROJ_B + DP,
                       FC2_B = FC1_B + 4 * DP, STAT = FC2_B + DP;   // + [2][2][64] row sums
  static constexpr int PARAMS = STAT + 4 * kTok;
  static constexpr int BYTES = ELEMS * (int)sizeof(bf16) + PARAMS * (int)sizeof(float);
};

// acc (4 n-tiles) = the 32 biases at `bias` (fp32), columns of the lane.
__device__ __forceinline__ void bias_frags(float (&acc)[4][4], const float* bias, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias + j * 8 + 2 * (lane & 3));
    acc[j][0] = acc[j][2] = b.x;
    acc[j][1] = acc[j][3] = b.y;
  }
}

// C: the real dim (160, 192, 224 or 256), a compile-time constant.
template <int C>
__global__ void __launch_bounds__(kMmaThreads, 1)
fused_structural_block_widest_kernel(const bf16* __restrict__ x, const bf16* __restrict__ st,
                                     const float* __restrict__ gamma,
                                     const float* __restrict__ beta, const bf16* __restrict__ n1w,
                                     const bf16* __restrict__ n1b, const bf16* __restrict__ qkvw,
                                     const bf16* __restrict__ qkvb, const bf16* __restrict__ projw,
                                     const bf16* __restrict__ projb, const bf16* __restrict__ n2w,
                                     const bf16* __restrict__ n2b, const bf16* __restrict__ f1w,
                                     const bf16* __restrict__ f1b, const bf16* __restrict__ f2w,
                                     const bf16* __restrict__ f2b, bf16* __restrict__ y, int B,
                                     int H, int W, float eps) {
  using L = WidestLayout;
  constexpr int DP = L::DP, WS = L::WS, PS = L::PS, FS = L::FS, HC = L::HC;
  static_assert(C % mhsa::kHd == 0 && C > WideLayout::DP && C <= DP, "dims 160 .. 256");
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* sW = reinterpret_cast<bf16*>(smem_mma);
  bf16* sHH = sW + L::HH;
  bf16* sHL = sW + L::HL;
  bf16* sKV = sW + L::KV;
  bf16* sOH = sW + L::OH;
  bf16* sOL = sW + L::OL;
  bf16* sAH = sW + L::AH;
  bf16* sAL = sW + L::AL;
  float* sP = reinterpret_cast<float*>(sW + L::ELEMS);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = (warp & 3) * 16, half = warp >> 2, g = lane >> 2, tq = lane & 3;
  constexpr int pairs = (C / mhsa::kHd + 1) / 2;   // head pairs, the last one half zeros when odd
  constexpr int tiles_heads = pairs * 5, tiles = tiles_heads + 4 * C / HC * 6;

  // tile t into buffer `buf`, 16 bytes a copy by the whole block: per pair
  // of heads q, k, v (64 rows of Wqkv) and the two proj tiles (128 rows of
  // Wproj x the pair's 64 columns); per hidden chunk two fc1 tiles (64 rows)
  // and four fc2 tiles (64 rows x the chunk's 128 columns). Rows and columns
  // past the real ones are zero-filled.
  auto load_tile = [&](int t, int buf) {
    const bf16* src;
    int rows, chunks, ld, lds, rows_real, cols_real;
    if (t < tiles_heads) {
      const int hp = t / 5, part = t % 5;
      if (part < 3) {
        src = qkvw + (long long)(part * C + hp * 64) * C;
        rows = 64, chunks = DP / 8, ld = C, lds = WS;
        rows_real = C - hp * 64, cols_real = C;
      } else {
        src = projw + (long long)(part - 3) * 128 * C + hp * 64;
        rows = 128, chunks = 8, ld = C, lds = PS;
        rows_real = C - (part - 3) * 128, cols_real = C - hp * 64;
      }
    } else {
      const int hc = (t - tiles_heads) / 6, part = (t - tiles_heads) % 6;
      if (part < 2) {
        src = f1w + (long long)(hc * HC + part * 64) * C;
        rows = 64, chunks = DP / 8, ld = C, lds = WS;
        rows_real = 64, cols_real = C;
      } else {
        src = f2w + (long long)(part - 2) * 64 * 4 * C + hc * HC;
        rows = 64, chunks = HC / 8, ld = 4 * C, lds = FS;
        rows_real = C - (part - 2) * 64, cols_real = HC;
      }
    }
    bf16* dst = sW + buf * L::TILE;
    for (int e = tid; e < rows * chunks; e += kMmaThreads) {
      const int r = e / chunks, c = e % chunks;
      const bool real = C == DP || (r < rows_real && c * 8 < cols_real);
      cp_async16(dst + r * lds + c * 8, real ? src + (long long)r * ld + c * 8 : qkvw, real);
    }
  };

  stage_params<L>(sP, n1w, n1b, qkvb, projb, n2w, n2b, f1b, f2b, C, tid, kMmaThreads);

  const int nwx = (W + kWin - 1) / kWin, nwy = (H + kWin - 1) / kWin;
  const long long n_windows = (long long)B * nwy * nwx;
  if ((long long)blockIdx.x < n_windows) load_tile(0, 0);
  cp_async_commit();
  // the tiles taken so far, over all windows: the next is in buffer seq & 1
  // (a window's tile count may be odd, so not the buffer of its index)
  int seq = 0;
#pragma unroll 1
  for (long long win = blockIdx.x; win < n_windows; win += gridDim.x) {
    const int b = (int)(win / (nwy * nwx)), rem = (int)(win - (long long)b * nwy * nwx);
    const int row0 = (rem / nwx) * kWin, col0 = (rem % nwx) * kWin;
    const bool ragged = row0 + kWin > H || col0 + kWin > W;
    auto valid = [&](int tok) { return row0 + tok / kWin < H && col0 + tok % kWin < W; };
    auto offset = [&](int tok) {
      return (((long long)b * H + row0 + tok / kWin) * W + col0 + tok % kWin) * C;
    };
    const bool more = win + gridDim.x < n_windows;
    int t = 0;
    // the next tile: wait for it, and copy the one after while it is used
    auto next_tile = [&]() {
      cp_async_wait<0>();
      __syncthreads();   // tile t is in; every warp is done with tile t - 1
      if (t + 1 < tiles) load_tile(t + 1, (seq + 1) & 1);
      else if (more) load_tile(0, (seq + 1) & 1);
      cp_async_commit();
      ++t;
      return static_cast<const bf16*>(sW + (seq++ & 1) * L::TILE);
    };

    __syncthreads();   // the previous window is done with LN2's output
    // LN1 + FiLM over the C real channels, a warp a token, 8 channels a
    // lane; tokens outside the grid and the pad channels as zeros; hi + lo
    // to shared memory
    const bool live = lane * 8 < C;
    for (int tok = warp; tok < kTok; tok += kMmaThreads / 32) {
      float u[8] = {};
      if (valid(tok) && live) {
        const uint4 xv = __ldg(reinterpret_cast<const uint4*>(x + offset(tok) + lane * 8));
        const uint4 sv = __ldg(reinterpret_cast<const uint4*>(st + offset(tok) + lane * 8));
        const bf16* xp = reinterpret_cast<const bf16*>(&xv);
        const bf16* sp = reinterpret_cast<const bf16*>(&sv);
#pragma unroll
        for (int i = 0; i < 8; ++i) u[i] = __bfloat162float(xp[i]) + __bfloat162float(sp[i]);
      }
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += u[i];
      const float mean = warp_sum(sum) / C;
      float var = 0.f;
      if (live) {
#pragma unroll
        for (int i = 0; i < 8; ++i) var = fmaf(u[i] - mean, u[i] - mean, var);
      }
      const float rstd = 1.f / sqrtf(warp_sum(var) / C + eps);
      uint4 hi = make_uint4(0u, 0u, 0u, 0u), lo = hi;
      if (live) {
        uint32_t* hp = reinterpret_cast<uint32_t*>(&hi);
        uint32_t* lp = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
        for (int i = 0; i < 8; i += 2) {
          float v[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = lane * 8 + i + j;
            v[j] = (u[i + j] - mean) * rstd * sP[L::N1W + c] + sP[L::N1B + c];
            v[j] = v[j] * (1.f + __ldg(gamma + (long long)b * C + c)) +
                   __ldg(beta + (long long)b * C + c);
          }
          pack_bf16_split(v[0], v[1], hp[i / 2], lp[i / 2]);
        }
      }
      *reinterpret_cast<uint4*>(sHH + tok * WS + lane * 8) = hi;
      *reinterpret_cast<uint4*>(sHL + tok * WS + lane * 8) = lo;
    }

    // the residual stream: x + the proj bias at the warp's rows and columns
    // (of 64-column block j, the 32 at 32 half + 8 n + 2 tq); zero past C
    float xr[4][4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int c = j * 64 + half * 32 + n * 8 + 2 * tq;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int tok = r0 + g + 8 * hh;
          float2 xv = make_float2(0.f, 0.f);
          if (valid(tok) && c < C)
            xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + offset(tok) + c));
          xr[j][n][2 * hh] = xv.x + sP[L::PROJ_B + c];
          xr[j][n][2 * hh + 1] = xv.y + sP[L::PROJ_B + c + 1];
        }
      }

    // the heads, a pair at a time; warp w takes head 2 hp + half
#pragma unroll 1
    for (int hp = 0; hp < pairs; ++hp) {
      const int hd = 2 * hp + half;
      bf16* kv = sKV + half * 4 * mhsa::TILE;   // k hi, k lo, v hi, v lo
      uint32_t qh[2][4], ql[2][4];
#pragma unroll
      for (int part = 0; part < 3; ++part) {
        const bf16* tile = next_tile();
        float acc[4][4];
        bias_frags(acc, sP + L::QKV_B + part * DP + hd * mhsa::kHd, lane);
        rows_times_w<L::KT, true>(acc, sHH + r0 * WS, sHL + r0 * WS, WS,
                                  tile + half * mhsa::kHd * WS, WS, lane);
        if (part == 0) {
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
            frags_to_a_split(qh[kk], ql[kk], acc[2 * kk], acc[2 * kk + 1]);
        } else {
          bf16* dst = kv + (part - 1) * 2 * mhsa::TILE;
          store_frags<4>(dst, dst + mhsa::TILE, mhsa::RS, r0, 0, acc, 1.f, lane);
        }
      }
      __syncthreads();   // k and v of both heads are in
      {
        float s[8][4];
        mhsa::times_tile_t_split(s, qh, ql, kv, kv + mhsa::TILE, lane);
        if (ragged) {   // keys outside the grid drop out of the softmax
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (!valid(j * 8 + 2 * tq)) s[j][0] = s[j][2] = -INFINITY;
            if (!valid(j * 8 + 2 * tq + 1)) s[j][1] = s[j][3] = -INFINITY;
          }
        }
        float l0, l1;   // token 0 of a window is always a valid key
        mhsa::exp_rows<true>(s, 1.f / sqrtf((float)mhsa::kHd), l0, l1);   // __expf: y is bf16
        float o[4][4] = {};
        mhsa::strip_times_tile<true>(o, s, kv + 2 * mhsa::TILE, lane);    // e (hi + lo) v hi
        mhsa::strip_times_tile<false>(o, s, kv + 3 * mhsa::TILE, lane);   // e hi v lo
        l0 = 1.f / l0;
        l1 = 1.f / l1;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          o[j][0] *= l0;
          o[j][1] *= l0;
          o[j][2] *= l1;
          o[j][3] *= l1;
        }
        store_frags<4>(sOH, sOL, PS, r0, half * mhsa::kHd, o, 1.f, lane);
      }
      // the pair's share of the proj: output rows 128 i.. of Wproj x the
      // pair's 64 columns; the warp's 64-column blocks 2 i and 2 i + 1
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bf16* tile = next_tile();
#pragma unroll
        for (int j = 0; j < 2; ++j)
          rows_times_w<4, true>(xr[2 * i + j], sOH + r0 * PS, sOL + r0 * PS, PS,
                                tile + (j * 64 + half * 32) * PS, PS, lane);
      }
    }

    // LN2 over the stream's C real columns: the row sums of the warp's
    // columns (the pads are zero), then the partner warp's (w ^ 4) through
    // shared memory
    {
      float* stat = sP + L::STAT;   // [sum, squares][half][64 rows]
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
        stat[half * kTok + r0 + g] = s0;
        stat[half * kTok + r0 + g + 8] = s1;
      }
      __syncthreads();
      const float m0 = (stat[r0 + g] + stat[kTok + r0 + g]) / C;
      const float m1 = (stat[r0 + g + 8] + stat[kTok + r0 + g + 8]) / C;
      float v0 = 0.f, v1 = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j * 64 + half * 32 >= C) continue;   // 32 pad columns
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          v0 = fmaf(xr[j][n][0] - m0, xr[j][n][0] - m0, fmaf(xr[j][n][1] - m0, xr[j][n][1] - m0, v0));
          v1 = fmaf(xr[j][n][2] - m1, xr[j][n][2] - m1, fmaf(xr[j][n][3] - m1, xr[j][n][3] - m1, v1));
        }
      }
      v0 = quad_sum(v0);
      v1 = quad_sum(v1);
      if (tq == 0) {
        stat[2 * kTok + half * kTok + r0 + g] = v0;
        stat[2 * kTok + half * kTok + r0 + g + 8] = v1;
      }
      __syncthreads();
      const float i0 = 1.f / sqrtf((stat[2 * kTok + r0 + g] + stat[3 * kTok + r0 + g]) / C + eps);
      const float i1 =
          1.f / sqrtf((stat[2 * kTok + r0 + g + 8] + stat[3 * kTok + r0 + g + 8]) / C + eps);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float h[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int c = j * 64 + half * 32 + n * 8 + 2 * tq;
          const float w0 = sP[L::N2W + c], w1 = sP[L::N2W + c + 1];
          const float b0 = sP[L::N2B + c], b1 = sP[L::N2B + c + 1];
          h[n][0] = (xr[j][n][0] - m0) * i0 * w0 + b0;
          h[n][1] = (xr[j][n][1] - m0) * i0 * w1 + b1;
          h[n][2] = (xr[j][n][2] - m1) * i1 * w0 + b0;
          h[n][3] = (xr[j][n][3] - m1) * i1 * w1 + b1;
          xr[j][n][0] += sP[L::FC2_B + c];   // the stream now collects fc2
          xr[j][n][1] += sP[L::FC2_B + c + 1];
          xr[j][n][2] += sP[L::FC2_B + c];
          xr[j][n][3] += sP[L::FC2_B + c + 1];
        }
        store_frags<4>(sHH, sHL, WS, r0, j * 64 + half * 32, h, 1.f, lane);
      }
    }

    // the MLP, 128 hidden columns at a time
#pragma unroll 1
    for (int hc = 0; hc < 4 * C / HC; ++hc) {
#pragma unroll
      for (int part = 0; part < 2; ++part) {   // fc1, GELU: hidden columns 64 part + 32 half..
        const bf16* tile = next_tile();
        float f[4][4];
        bias_frags(f, sP + L::FC1_B + hc * HC + part * 64 + half * 32, lane);
        rows_times_w<L::KT, true>(f, sHH + r0 * WS, sHL + r0 * WS, WS, tile + half * 32 * WS, WS,
                                  lane);
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            f[n][i] = 0.5f * f[n][i] * (1.f + erff(f[n][i] * 0.70710678118654752f));
        store_frags<4>(sAH, sAL, FS, r0, part * 64 + half * 32, f, 1.f, lane);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {   // fc2: output rows 64 j.., the chunk's columns
        const bf16* tile = next_tile();
        rows_times_w<HC / 16, true>(xr[j], sAH + r0 * FS, sAL + r0 * FS, FS,
                                    tile + half * 32 * FS, FS, lane);
      }
    }

    // y, where the token and the column exist
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int tok = r0 + g + 8 * hh;
      if (!valid(tok)) continue;
      bf16* row = y + offset(tok);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j * 64 + half * 32 >= C) continue;
#pragma unroll
        for (int n = 0; n < 4; ++n)
          *reinterpret_cast<uint32_t*>(row + j * 64 + half * 32 + n * 8 + 2 * tq) =
              pack_bf16(xr[j][n][2 * hh], xr[j][n][2 * hh + 1]);
      }
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// bf16 at the dims of heads other than 32: head slots
// ---------------------------------------------------------------------------
//
// The generators' dims that are not multiples of 32 (4c: 16, 48, 80, ..,
// 240) have default_num_heads(C) heads of hd = 16 .. 56 channels, hd % 4 ==
// 0 (C = 16 k; 1, 2, 4, 6 heads). From dim 48 on,
// fused_structural_block_slot_kernel<S>
// runs them in the dim-256 design's frame (8 warps on one window, every
// weight streamed through two shared-memory tiles, the residual stream 64
// fp32 a thread split over two warps a row, every operand a hi + lo pair)
// with C and the head count at run time and each head in a slot of S = hd
// rounded up to 16 channels (S = 16, 32, 48, 64): the head's q, k and v
// weight rows sit at the start of the slot, its proj columns too, and the
// pad rows and columns are staged as zeros, so the scores and the real
// outputs are the head's; the scale is 1/sqrt(hd), a runtime value. The
// slot width and the residual width are separate quantities (c60's 6
// heads of 40 take 6 x 48 = 288 slot channels against a residual of 240),
// so the heads pass one at a time, with all 8 warps:
//   q, k, v  a tile of S rows of Wqkv each (K = the C real inputs,
//            ceil(C / 16) k-steps): warp w forms, for its 16 tokens, its
//            share of the slot's 16-column groups (half w / 4 of them),
//            into shared memory as hi + lo;
//   MHSA     each warp the scores of its 16 queries over the 64 keys (the
//            two warps of a row both form them), keys outside a ragged
//            grid at -inf, the exponentials at the scale 1/sqrt(hd) and,
//            for its share of the slot's columns, the exponentials (hi +
//            lo) times v (hi, then lo); divided by the row sums, into
//            shared memory as hi + lo;
//   proj     two tiles of 128 output rows x the slot's S columns of Wproj
//            onto the residual stream (which starts as x + the proj bias).
// LN1, LN2 and the MLP are the dim-256 design's, over the C real channels
// (a 32-column block of the stream may hold real and pad columns here, so
// LN2's variance and y's stores go column by column). Rows of C % 4 == 0
// values move 8 bytes at a time (cp.async). The dims of the FMA bodies'
// that are not a generator's (C % 4 != 0, or hd % 4 != 0) and fp32 stay
// in those bodies, and so does dim 16 (c4), where they are faster.
constexpr int kSlotMaxHeads = 8;

template <int S>
struct SlotLayout {
  static constexpr int DP = 256, HC = 128;
  static constexpr int WS = DP + 8;             // rows of DP values: 528 bytes
  static constexpr int RS = S + 8;              // a slot's rows (q, k, v, o; proj tiles)
  static constexpr int FS = HC + 8;             // fc2 tile rows, the hidden chunk
  static constexpr int TILE = 64 * WS;          // the largest tile (S x WS, 128 x RS fit)
  static constexpr int HEAD = kTok * RS;        // one head tile
  static constexpr int W = 0;                   // [2][TILE]
  static constexpr int HH = W + 2 * TILE;       // [64][WS] LN1 out, then LN2 out, hi
  static constexpr int HL = HH + kTok * WS;     //   ... lo
  static constexpr int U = HL + kTok * WS;      // union:
  static constexpr int QH = U;                  //   q, k, v, o, each hi and lo: [8][HEAD]
  static constexpr int AH = U;                  //   [64][FS] the hidden chunk hi
  static constexpr int AL = AH + kTok * FS;     //   ... lo
  static constexpr int ELEMS = (QH + 8 * HEAD > AL + kTok * FS ? QH + 8 * HEAD : AL + kTok * FS);
  static constexpr int N1W = 0, N1B = DP, N2W = 2 * DP, N2B = 3 * DP;
  static constexpr int QKV_B = 4 * DP;                          // [3][heads][S], slot layout
  static constexpr int PROJ_B = QKV_B + 3 * kSlotMaxHeads * 64, FC1_B = PROJ_B + DP,
                       FC2_B = FC1_B + 4 * DP, STAT = FC2_B + DP;   // + [2][2][64] row sums
  static constexpr int PARAMS = STAT + 4 * kTok;
  static constexpr int BYTES = ELEMS * (int)sizeof(bf16) + PARAMS * (int)sizeof(float);
  static_assert(S % 16 == 0 && S <= 64 && 128 * RS <= TILE, "slots of 16 .. 64");
};

// acc (16 rows x 16 outputs, 2 n-tiles) += a w^T over `ks` k-steps: a 16
// rows at ah (and lo at al when kSplit) of stride lda, w 16 rows [n][k] of
// stride ldw.
template <bool kSplit>
__device__ __forceinline__ void rows_times_w16(float (&acc)[2][4], const bf16* ah, const bf16* al,
                                               int lda, const bf16* w, int ldw, int ks,
                                               int lane) {
#pragma unroll 4
  for (int kk = 0; kk < ks; ++kk) {
    const int aoff = (lane & 15) * lda + kk * 16 + (lane >> 4) * 8;
    uint32_t a[4], b[4];
    ldmatrix_x4(a, ah + aoff);
    ldmatrix_x4(b, w + ((lane & 7) + (lane >> 4) * 8) * ldw + kk * 16 + ((lane >> 3) & 1) * 8);
    mma_bf16(acc[0], a, b[0], b[1]);
    mma_bf16(acc[1], a, b[2], b[3]);
    if constexpr (kSplit) {
      ldmatrix_x4(a, al + aoff);
      mma_bf16(acc[0], a, b[0], b[1]);
      mma_bf16(acc[1], a, b[2], b[3]);
    }
  }
}

template <int S>
__global__ void __launch_bounds__(kMmaThreads, 1)
fused_structural_block_slot_kernel(const bf16* __restrict__ x, const bf16* __restrict__ st,
                                   const float* __restrict__ gamma,
                                   const float* __restrict__ beta, const bf16* __restrict__ n1w,
                                   const bf16* __restrict__ n1b, const bf16* __restrict__ qkvw,
                                   const bf16* __restrict__ qkvb, const bf16* __restrict__ projw,
                                   const bf16* __restrict__ projb, const bf16* __restrict__ n2w,
                                   const bf16* __restrict__ n2b, const bf16* __restrict__ f1w,
                                   const bf16* __restrict__ f1b, const bf16* __restrict__ f2w,
                                   const bf16* __restrict__ f2b, bf16* __restrict__ y, int B,
                                   int H, int W, int C, int heads, float scale, float eps) {
  using L = SlotLayout<S>;
  constexpr int DP = L::DP, WS = L::WS, RS = L::RS, FS = L::FS, HC = L::HC;
  constexpr int G = S / 16;                   // 16-column groups of a slot
  constexpr int GW = (G + 1) / 2;             // groups of a warp at most (half 0 takes GW)
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* sW = reinterpret_cast<bf16*>(smem_mma);
  bf16* sHH = sW + L::HH;
  bf16* sHL = sW + L::HL;
  bf16* sQH = sW + L::QH;                     // q hi, q lo, k hi, k lo, v hi, v lo, o hi, o lo
  bf16* sAH = sW + L::AH;
  bf16* sAL = sW + L::AL;
  float* sP = reinterpret_cast<float*>(sW + L::ELEMS);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = (warp & 3) * 16, half = warp >> 2, g = lane >> 2, tq = lane & 3;
  const int hd = C / heads;
  const int g0 = half * GW, gn = half ? G - GW : GW;   // this warp's slot column groups
  const int ks = (C + 15) / 16;                         // k-steps over the C inputs
  const int chunks = (4 * C + HC - 1) / HC;
  const int tiles_heads = 5 * heads, tiles = tiles_heads + 6 * chunks;
  auto tile_of = [&](int i) { return sQH + i * L::HEAD; };

  // tile t into buffer `buf`, 8 bytes a copy by the whole block, zeros past
  // the real rows and columns: per head q, k, v (S slot rows of Wqkv, the C
  // inputs) and two proj tiles (128 output rows x the head's S slot
  // columns); per hidden chunk two fc1 tiles (64 rows) and four fc2 tiles
  // (64 output rows x the chunk's 128 columns)
  auto load_tile = [&](int t, int buf) {
    bf16* dst = sW + buf * L::TILE;
    if (t < tiles_heads) {
      const int h = t / 5, part = t % 5;
      if (part < 3) {
        for (int e = tid; e < S * (DP / 4); e += kMmaThreads) {
          const int r = e / (DP / 4), c = (e % (DP / 4)) * 4;
          const bool real = r < hd && c < C;
          const bf16* src = qkvw + (long long)(part * C + h * hd + r) * C + c;
          cp_async8(dst + r * WS + c, real ? src : qkvw, real);
        }
      } else {
        const int o0 = (part - 3) * 128;
        for (int e = tid; e < 128 * (S / 4); e += kMmaThreads) {
          const int r = e / (S / 4), c = (e % (S / 4)) * 4;
          const bool real = o0 + r < C && c < hd;
          const bf16* src = projw + (long long)(o0 + r) * C + h * hd + c;
          cp_async8(dst + r * RS + c, real ? src : projw, real);
        }
      }
      return;
    }
    const int hc = (t - tiles_heads) / 6, part = (t - tiles_heads) % 6;
    if (part < 2) {
      const int h0 = hc * HC + part * 64;
      for (int e = tid; e < 64 * (DP / 4); e += kMmaThreads) {
        const int r = e / (DP / 4), c = (e % (DP / 4)) * 4;
        const bool real = h0 + r < 4 * C && c < C;
        const bf16* src = f1w + (long long)(h0 + r) * C + c;
        cp_async8(dst + r * WS + c, real ? src : f1w, real);
      }
    } else {
      const int o0 = (part - 2) * 64;
      for (int e = tid; e < 64 * (HC / 4); e += kMmaThreads) {
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
  if ((long long)blockIdx.x < n_windows) load_tile(0, 0);
  cp_async_commit();
  // the tiles taken so far, over all windows: the next is in buffer seq & 1
  // (a window's tile count may be odd, so not the buffer of its index)
  int seq = 0;
#pragma unroll 1
  for (long long win = blockIdx.x; win < n_windows; win += gridDim.x) {
    const int b = (int)(win / (nwy * nwx)), rem = (int)(win - (long long)b * nwy * nwx);
    const int row0 = (rem / nwx) * kWin, col0 = (rem % nwx) * kWin;
    const bool ragged = row0 + kWin > H || col0 + kWin > W;
    auto valid = [&](int tok) { return row0 + tok / kWin < H && col0 + tok % kWin < W; };
    auto offset = [&](int tok) {
      return (((long long)b * H + row0 + tok / kWin) * W + col0 + tok % kWin) * C;
    };
    const bool more = win + gridDim.x < n_windows;
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

    __syncthreads();   // the previous window is done with LN2's output
    // LN1 + FiLM over the C real channels, a warp a token, 8 channels a
    // lane (two 8-byte loads: C % 4 == 0); tokens outside the grid and the
    // pad channels as zeros; hi + lo to shared memory
    for (int tok = warp; tok < kTok; tok += kMmaThreads / 32) {
      float u[8] = {};
      if (valid(tok)) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c = lane * 8 + q * 4;
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
      for (int i = 0; i < 8; ++i) sum += u[i];
      const float mean = warp_sum(sum) / C;
      float var = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (lane * 8 + i < C) var = fmaf(u[i] - mean, u[i] - mean, var);
      const float rstd = 1.f / sqrtf(warp_sum(var) / C + eps);
      uint4 hi = make_uint4(0u, 0u, 0u, 0u), lo = hi;
      uint32_t* hp = reinterpret_cast<uint32_t*>(&hi);
      uint32_t* lp = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
      for (int i = 0; i < 8; i += 2) {
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = lane * 8 + i + j;
          v[j] = 0.f;
          if (c < C) {
            v[j] = (u[i + j] - mean) * rstd * sP[L::N1W + c] + sP[L::N1B + c];
            v[j] = v[j] * (1.f + __ldg(gamma + (long long)b * C + c)) +
                   __ldg(beta + (long long)b * C + c);
          }
        }
        pack_bf16_split(v[0], v[1], hp[i / 2], lp[i / 2]);
      }
      *reinterpret_cast<uint4*>(sHH + tok * WS + lane * 8) = hi;
      *reinterpret_cast<uint4*>(sHL + tok * WS + lane * 8) = lo;
    }

    // the residual stream: x + the proj bias at the warp's rows and columns
    // (of 64-column block j, the 32 at 32 half + 8 n + 2 tq); zero past C
    float xr[4][4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int c = j * 64 + half * 32 + n * 8 + 2 * tq;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int tok = r0 + g + 8 * hh;
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
      for (int part = 0; part < 3; ++part) {   // q, k, v: this warp's slot columns
        const bf16* tile = next_tile();
#pragma unroll
        for (int i = 0; i < GW; ++i) {
          if (i >= gn) break;
          const int gc = (g0 + i) * 16;
          float acc[2][4];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float2 bb = *reinterpret_cast<const float2*>(
                sP + L::QKV_B + (part * heads + h) * S + gc + j * 8 + 2 * tq);
            acc[j][0] = acc[j][2] = bb.x;
            acc[j][1] = acc[j][3] = bb.y;
          }
          rows_times_w16<true>(acc, sHH + r0 * WS, sHL + r0 * WS, WS, tile + gc * WS, WS, ks,
                               lane);
          store_frags<2>(tile_of(2 * part), tile_of(2 * part + 1), RS, r0, gc, acc, 1.f, lane);
        }
      }
      __syncthreads();   // q, k and v of the head are in
      {
        uint32_t qh[G][4], ql[G][4];
        mhsa::load_a<S>(qh, tile_of(0), r0, lane);
        mhsa::load_a<S>(ql, tile_of(1), r0, lane);
        float s[8][4];
        mhsa::times_tile_t_split<S>(s, qh, ql, tile_of(2), tile_of(3), lane);
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
#pragma unroll
        for (int i = 0; i < GW; ++i) {
          if (i >= gn) break;
          const int gc = (g0 + i) * 16;
          float o[2][4] = {};
          probs_times_cols<true>(o, s, tile_of(4), RS, gc, lane);    // e (hi + lo) v hi
          probs_times_cols<false>(o, s, tile_of(5), RS, gc, lane);   // e hi v lo
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            o[j][0] *= l0;
            o[j][1] *= l0;
            o[j][2] *= l1;
            o[j][3] *= l1;
          }
          store_frags<2>(tile_of(6), tile_of(7), RS, r0, gc, o, 1.f, lane);
        }
      }
      // the head's share of the proj: output rows 128 i.. of Wproj x the
      // slot's S columns; the warp's 64-column blocks 2 i and 2 i + 1
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bf16* tile = next_tile();   // also: every warp's o is in
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if ((2 * i + j) * 64 + half * 32 >= C) continue;   // 32 pad columns
          rows_times_w<S / 16, true>(xr[2 * i + j], tile_of(6) + r0 * RS, tile_of(7) + r0 * RS, RS,
                                     tile + (j * 64 + half * 32) * RS, RS, lane);
        }
      }
    }

    // LN2 over the stream's C real columns: the row sums of the warp's
    // columns (the pads are zero), then the partner warp's (w ^ 4) through
    // shared memory; the variance column by column
    {
      float* stat = sP + L::STAT;   // [sum, squares][half][64 rows]
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
        stat[half * kTok + r0 + g] = s0;
        stat[half * kTok + r0 + g + 8] = s1;
      }
      __syncthreads();
      const float m0 = (stat[r0 + g] + stat[kTok + r0 + g]) / C;
      const float m1 = (stat[r0 + g + 8] + stat[kTok + r0 + g + 8]) / C;
      float v0 = 0.f, v1 = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          if (j * 64 + half * 32 + n * 8 + 2 * tq >= C) continue;   // C is even
          v0 = fmaf(xr[j][n][0] - m0, xr[j][n][0] - m0, fmaf(xr[j][n][1] - m0, xr[j][n][1] - m0, v0));
          v1 = fmaf(xr[j][n][2] - m1, xr[j][n][2] - m1, fmaf(xr[j][n][3] - m1, xr[j][n][3] - m1, v1));
        }
      v0 = quad_sum(v0);
      v1 = quad_sum(v1);
      if (tq == 0) {
        stat[2 * kTok + half * kTok + r0 + g] = v0;
        stat[2 * kTok + half * kTok + r0 + g + 8] = v1;
      }
      __syncthreads();
      const float i0 = 1.f / sqrtf((stat[2 * kTok + r0 + g] + stat[3 * kTok + r0 + g]) / C + eps);
      const float i1 =
          1.f / sqrtf((stat[2 * kTok + r0 + g + 8] + stat[3 * kTok + r0 + g + 8]) / C + eps);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float hn[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int c = j * 64 + half * 32 + n * 8 + 2 * tq;
          const float w0 = sP[L::N2W + c], w1 = sP[L::N2W + c + 1];
          const float b0 = sP[L::N2B + c], b1 = sP[L::N2B + c + 1];
          hn[n][0] = (xr[j][n][0] - m0) * i0 * w0 + b0;   // zero past C (w, b zero)
          hn[n][1] = (xr[j][n][1] - m0) * i0 * w1 + b1;
          hn[n][2] = (xr[j][n][2] - m1) * i1 * w0 + b0;
          hn[n][3] = (xr[j][n][3] - m1) * i1 * w1 + b1;
          xr[j][n][0] += sP[L::FC2_B + c];   // the stream now collects fc2
          xr[j][n][1] += sP[L::FC2_B + c + 1];
          xr[j][n][2] += sP[L::FC2_B + c];
          xr[j][n][3] += sP[L::FC2_B + c + 1];
        }
        store_frags<4>(sHH, sHL, WS, r0, j * 64 + half * 32, hn, 1.f, lane);
      }
    }

    // the MLP, 128 hidden columns at a time
#pragma unroll 1
    for (int hc = 0; hc < chunks; ++hc) {
#pragma unroll
      for (int part = 0; part < 2; ++part) {   // fc1, GELU: hidden columns 64 part + 32 half..
        const bf16* tile = next_tile();
        float f[4][4];
        bias_frags(f, sP + L::FC1_B + hc * HC + part * 64 + half * 32, lane);
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          float acc[2][4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[0][q] = f[2 * nb][q];
            acc[1][q] = f[2 * nb + 1][q];
          }
          rows_times_w16<true>(acc, sHH + r0 * WS, sHL + r0 * WS, WS,
                               tile + (half * 32 + nb * 16) * WS, WS, ks, lane);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            f[2 * nb][q] = acc[0][q];
            f[2 * nb + 1][q] = acc[1][q];
          }
        }
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            f[n][i] = 0.5f * f[n][i] * (1.f + erff(f[n][i] * 0.70710678118654752f));
        store_frags<4>(sAH, sAL, FS, r0, part * 64 + half * 32, f, 1.f, lane);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {   // fc2: output rows 64 j.., the chunk's columns
        const bf16* tile = next_tile();
        if (j * 64 + half * 32 >= C) continue;   // 32 pad columns
        rows_times_w<HC / 16, true>(xr[j], sAH + r0 * FS, sAL + r0 * FS, FS,
                                    tile + half * 32 * FS, FS, lane);
      }
    }

    // y, where the token and the column exist
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int tok = r0 + g + 8 * hh;
      if (!valid(tok)) continue;
      bf16* row = y + offset(tok);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int c = j * 64 + half * 32 + n * 8 + 2 * tq;
          if (c < C)
            *reinterpret_cast<uint32_t*>(row + c) = pack_bf16(xr[j][n][2 * hh], xr[j][n][2 * hh + 1]);
        }
    }
  }
  cp_async_wait<0>();
}

// The slot of a head of hd channels: hd rounded up to 16.
template <typename F>
int with_block_slot(int hd, F f) {
  if (hd <= 16) return f(std::integral_constant<int, 16>{});
  if (hd <= 32) return f(std::integral_constant<int, 32>{});
  if (hd <= 48) return f(std::integral_constant<int, 48>{});
  return f(std::integral_constant<int, 64>{});
}

// bf16 at a dim C % 4 == 0 from 36 to 252 (not a multiple of 32) whose
// heads have hd % 4 == 0 channels, hd <= 64, up to 8 heads: the slot
// kernel. Below 32 the dim-256 frame cost more than the FMA bodies in a
// probe at c4's dim 16 (numbers not kept), which keep those dims.
bool slot_takes(int C, int heads) {
  const int hd = C / heads;
  return C > 32 && C <= 256 && C % 4 == 0 && heads <= kSlotMaxHeads && hd % 4 == 0 &&
         hd <= 64;
}

int launch_slot(const void* x, const void* st, const void* gamma, const void* beta,
                const void* const* w, void* y, int B, int H, int W, int C, int heads, float eps,
                cudaStream_t stream) {
  const int hd = C / heads;
  const float scale = 1.f / sqrtf((float)hd);
  return with_block_slot(hd, [&](auto slot) {
    constexpr int S = decltype(slot)::value;
    using L = SlotLayout<S>;
    auto kernel = fused_structural_block_slot_kernel<S>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return (int)err;
    static int sms = 0, blocks_per_sm = 0;   // asked once per slot width
    if (sms == 0) {
      const int rc = residency(kernel, kMmaThreads, L::BYTES, &sms, &blocks_per_sm);
      if (rc != 0) return rc;
    }
    const long long n_windows =
        (long long)B * ((H + kWin - 1) / kWin) * ((W + kWin - 1) / kWin);
    const int grid = persistent_grid(n_windows, sms, blocks_per_sm);
    auto p = [&](int i) { return static_cast<const bf16*>(w[i]); };
    kernel<<<(unsigned)grid, kMmaThreads, L::BYTES, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(st),
        static_cast<const float*>(gamma), static_cast<const float*>(beta), p(0), p(1), p(2), p(3),
        p(4), p(5), p(6), p(7), p(8), p(9), p(10), p(11), static_cast<bf16*>(y), B, H, W, C, heads,
        scale, eps);
    return (int)cudaGetLastError();
  });
}

// ---------------------------------------------------------------------------
// Any other dim: FMA bodies, fp32 and bf16
// ---------------------------------------------------------------------------
//
// The dims that are not multiples of 32 (4c for c = 1 .. 64 not a multiple
// of 8: 4, 12, .., 252) have default_num_heads(C) heads of hd = 4 .. 62
// channels, which the tensor-core designs above (heads of 32) do not take.
// fused_structural_block_any_kernel takes them, in fp32 and in bf16, with C
// and the head count at run time: the dim-256 fp32 design (a head at a
// time, its share of the proj added onto the residual stream at once; the
// MLP in chunks of hidden columns) on the CUDA cores, every sum in fp32
// (the residual stream, the LayerNorms, the proj, the MLP) and a head's q,
// k, scores and softmax in Acc: double for fp32 storage, as the plain
// version carries them in float64, and float for bf16 storage, whose
// output rounding is 2^-8. No operand is rounded to bf16 inside: bf16
// inputs and weights are read as they are stored and the result is
// rounded once. One block of 256 threads per 8x8 window; the scores of a
// head are taken 16 query rows at a time, and a row's attention output is
// written over its q (dead once the row's scores exist). Shared memory:
// two 64 x (C + 1) fp32 rows (the residual stream; LN1's, then LN2's
// output) and a union of one head (q | k in Acc, 64 x (2 hd + 1); 16 score
// rows; v) and a 64-column hidden chunk: 212 KB at C = 244 (hd = 61), the
// largest. Rows whose length and start are multiples of 4 values are read
// 4 at a time (load4), others a value at a time. What bounds it: the FMA
// rate, about 24 C^2 + 256 C flop per token at a few TFLOP/s, not the
// bytes; it is the simple design of these widths, not a fast one.
template <typename T>
struct AnyAcc { using type = float; };
template <>
struct AnyAcc<float> { using type = double; };

constexpr int kAnyQRows = 16;   // query rows a score tile holds
constexpr int kAnyHC = 64;      // hidden columns a chunk

// The dynamic shared memory of the kernel at dim C, hd channels a head
// (kWs: without the residual stream and the LN output, which are in the
// workspace).
template <typename T>
int any_smem_bytes(int C, int hd, bool ws) {
  using Acc = typename AnyAcc<T>::type;
  const int xs = ws ? 0 : 2 * kTok * (C + 1) * (int)sizeof(float);
  const int head = kTok * (2 * hd + 1) * (int)sizeof(Acc) +
                   kAnyQRows * (kTok + 1) * (int)sizeof(Acc) + kTok * (hd + 1) * (int)sizeof(float);
  const int chunk = kTok * (kAnyHC + 1) * (int)sizeof(float);
  return (xs + 7) / 8 * 8 + (head > chunk ? head : chunk);
}

// out[t][o] = A[t] . row(o) + bias(o) for the 64 tokens and N outputs,
// handed to epi(t, o, value): a 16 x 16 grid of threads over 64 tokens and
// 64 outputs at a time (4 x 4 sums a thread, in Acc), K inputs, row(o) the
// K weights of output o; `vec` when K, every row's start and A's rows allow
// 4-wide weight loads. A holds fp32 or (past dim 256, fp32 storage) float64
// rows, converted to Acc.
template <typename Acc, typename AT, typename Row, typename Bias, typename Epi>
__device__ __forceinline__ void linear_any(const AT* A, int lda, int K, int N, bool vec,
                                           Row row, Bias bias, Epi epi) {
  const int tg = threadIdx.x % 16, og = threadIdx.x / 16;
#pragma unroll 1
  for (int n0 = 0; n0 < N; n0 += 64) {
    Acc acc[4][4] = {};
    bool live[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) live[r] = n0 + og + 16 * r < N;
    if (vec) {
#pragma unroll 1
      for (int i = 0; i < K; i += 4) {
        AT a[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) a[j][q] = A[(tg + 16 * j) * lda + i + q];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (!live[r]) continue;
          const float4 w = load4(row(n0 + og + 16 * r) + i);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[j][r] = fma_acc((Acc)a[j][0], (Acc)w.x, acc[j][r]);
            acc[j][r] = fma_acc((Acc)a[j][1], (Acc)w.y, acc[j][r]);
            acc[j][r] = fma_acc((Acc)a[j][2], (Acc)w.z, acc[j][r]);
            acc[j][r] = fma_acc((Acc)a[j][3], (Acc)w.w, acc[j][r]);
          }
        }
      }
    } else {
#pragma unroll 1
      for (int i = 0; i < K; ++i) {
        AT a[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) a[j] = A[(tg + 16 * j) * lda + i];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (!live[r]) continue;
          const float w = to_f(row(n0 + og + 16 * r)[i]);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j][r] = fma_acc((Acc)a[j], (Acc)w, acc[j][r]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (live[r]) {
          const int o = n0 + og + 16 * r;
          epi(tg + 16 * j, o, acc[j][r] + (Acc)bias(o));
        }
  }
}

// LayerNorm over the C channels of each token row (one warp per row), and
// the FiLM (1 + gamma), beta when gamma is given; rows of stride ld. Out is
// float, or double (past dim 256 in fp32: mean, variance, LN and FiLM in
// float64).
template <typename T, typename In, typename Out>
__device__ __forceinline__ void layer_norm_any(const In* in, Out* out, int C, int ld,
                                               const T* __restrict__ w, const T* __restrict__ b,
                                               float eps, const float* gamma,
                                               const float* beta) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if constexpr (std::is_same_v<Out, double>) {
    auto sum = [](double v) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      return v;
    };
    for (int t = warp; t < kTok; t += kWarps) {
      const In* r = in + t * ld;
      double s = 0.0;
      for (int c = lane; c < C; c += 32) s += r[c];
      const double mean = sum(s) / C;
      double v = 0.0;
      for (int c = lane; c < C; c += 32) {
        const double d = r[c] - mean;
        v = fma(d, d, v);
      }
      const double rstd = 1.0 / sqrt(sum(v) / C + eps);
      for (int c = lane; c < C; c += 32) {
        double o = (r[c] - mean) * rstd * to_f(w[c]) + to_f(b[c]);
        if (gamma != nullptr) o = o * (1.0 + gamma[c]) + beta[c];
        out[t * ld + c] = o;
      }
    }
  } else {
    for (int t = warp; t < kTok; t += kWarps) {
      const float* r = in + t * ld;
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
        out[t * ld + c] = o;
      }
    }
  }
}

// kRes64 (fp32 past dim 512, in the workspace): the residual stream in
// float64 and the proj's and the MLP's sums in float64, as the plain version
// carries them there: at dim 1024 .. 2048 the fp32 residual takes 64 heads'
// proj shares and 64 .. 128 hidden chunks of fc2 one rounding each, and an
// fp32 evaluation of those lay 2.1e-4 .. 5.9e-4 from the plain version's,
// past the fp32 tolerance (devtools/serving_kernel_rounding.py --fp32)
template <typename T, bool kWs, bool kRes64 = false>
__global__ void __launch_bounds__(kThreads)
fused_structural_block_any_kernel(const T* __restrict__ x, const T* __restrict__ st,
                                  const float* __restrict__ gamma,
                                  const float* __restrict__ beta, const T* __restrict__ n1w,
                                  const T* __restrict__ n1b, const T* __restrict__ qkvw,
                                  const T* __restrict__ qkvb, const T* __restrict__ projw,
                                  const T* __restrict__ projb, const T* __restrict__ n2w,
                                  const T* __restrict__ n2b, const T* __restrict__ f1w,
                                  const T* __restrict__ f1b, const T* __restrict__ f2w,
                                  const T* __restrict__ f2b, T* __restrict__ y, int H, int W,
                                  int C, int heads, float eps, float* __restrict__ ws) {
  using Acc = typename AnyAcc<T>::type;
  const int hd = C / heads;
  const int XS = C + 1, KS = 2 * hd + 1, SS = kTok + 1, VS = hd + 1, AS = kAnyHC + 1;
  // a row's attention output over its q: rows of KS Acc values
  const int OS = KS * (int)(sizeof(Acc) / sizeof(float));
  extern __shared__ __align__(16) float smem_any[];
  // [64][XS] residual stream and [64][XS] LN1's (then LN2's) output, in
  // shared memory, or (kWs) in the block's share of the workspace with the
  // LN output in float64, as the plain version carries it past dim 256: on
  // a block whose scores are 16 times larger (chip_smoke.py's saturated
  // input) an fp32 LN1 output leaves the block at dim 512 1.6e-4 from a
  // float64 evaluation, a float64 one 6.8e-5, and two fp32 evaluations
  // (this kernel's and the plain version's) were 2.3e-4 apart, past the
  // fp32 tolerance (devtools/serving_kernel_rounding.py --fp32)
  using HT = std::conditional_t<kWs, double, float>;
  using RT = std::conditional_t<kRes64, double, float>;   // the residual stream
  using MT = std::conditional_t<kRes64, double, float>;   // the proj's and the MLP's sums
  RT* sX = reinterpret_cast<RT*>(smem_any);
  if constexpr (kWs)
    sX = reinterpret_cast<RT*>(
        ws + ((long long)(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) *
                 (kRes64 ? 4 : 3) * kTok * XS);
  HT* sH = reinterpret_cast<HT*>(sX + kTok * XS);
  float* sU = kWs ? smem_any : reinterpret_cast<float*>(sX) + 2 * kTok * XS;
  sU += (reinterpret_cast<uintptr_t>(sU) / sizeof(float)) % 2;   // 8-byte aligned
  Acc* sQK = reinterpret_cast<Acc*>(sU);    // [64][KS] q | k, then o (float, stride OS)
  Acc* sS = sQK + kTok * KS;                // [16][SS] a tile of scores
  float* sV = reinterpret_cast<float*>(sS + kAnyQRows * SS);   // [64][VS]
  float* sO = reinterpret_cast<float*>(sQK);
  float* sA1 = sU;                          // [64][AS] a hidden chunk
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z, row0 = blockIdx.y * kWin, col0 = blockIdx.x * kWin;
  auto valid = [&](int t) { return row0 + t / kWin < H && col0 + t % kWin < W; };
  auto offset = [&](int t) {
    return (((long long)b * H + row0 + t / kWin) * W + col0 + t % kWin) * C;
  };
  // 4-wide weight loads: rows of C and hd values that start 4 apart
  const bool vec_c = C % 4 == 0, vec_hd = vec_c && hd % 4 == 0;

  // x (residual) and x + struct; tokens outside the grid load as zeros
  for (int e = tid; e < kTok * C; e += kThreads) {
    const int t = e / C, c = e % C;
    float xv = 0.f, sv = 0.f;
    if (valid(t)) {
      xv = to_f(x[offset(t) + c]);
      sv = to_f(st[offset(t) + c]);
    }
    sX[t * XS + c] = xv;
    sH[t * XS + c] = xv + sv;
  }
  __syncthreads();
  layer_norm_any(sH, sH, C, XS, n1w, n1b, eps, gamma + (long long)b * C,
                 beta + (long long)b * C);
  __syncthreads();

  const Acc scale = (Acc)1 / sqrt((Acc)hd);
#pragma unroll 1
  for (int hh = 0; hh < heads; ++hh) {
    // this head's q, k (Acc) and v: rows hh hd.. of each third of Wqkv
    linear_any<Acc>(
        sH, XS, C, 3 * hd, vec_c,
        [&](int o) { return qkvw + (long long)((o / hd) * C + hh * hd + o % hd) * C; },
        [&](int o) { return to_f(qkvb[(o / hd) * C + hh * hd + o % hd]); },
        [&](int t, int o, Acc v) {
          if (o < 2 * hd) sQK[t * KS + o] = v;
          else sV[t * VS + o - 2 * hd] = (float)v;
        });
    __syncthreads();
#pragma unroll 1
    for (int q0 = 0; q0 < kTok; q0 += kAnyQRows) {
      for (int e = tid; e < kAnyQRows * kTok; e += kThreads) {
        const int s = e % kTok, tl = e / kTok;
        Acc acc = -INFINITY;   // keys outside the grid drop out of the softmax
        if (valid(s)) {
          const Acc* q = sQK + (q0 + tl) * KS;
          const Acc* k = sQK + s * KS + hd;
          acc = 0;
          for (int d = 0; d < hd; ++d) acc = fma_acc(q[d], k[d], acc);
          acc *= scale;
        }
        sS[tl * SS + s] = acc;
      }
      __syncthreads();
      for (int tl = warp; tl < kAnyQRows; tl += kWarps) {   // token 0 is always a valid key
        Acc* r = sS + tl * SS;
        Acc m = r[lane] > r[lane + 32] ? r[lane] : r[lane + 32];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const Acc w = __shfl_xor_sync(0xffffffffu, m, o);
          m = w > m ? w : m;
        }
        const Acc e0 = exp(r[lane] - m), e1 = exp(r[lane + 32] - m);
        Acc sum = e0 + e1;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        r[lane] = e0 / sum;
        r[lane + 32] = e1 / sum;
      }
      __syncthreads();
      // o[t][d] = sum_s p[t][s] v[s][d] in fp32, over the row's own q
      for (int e = tid; e < kAnyQRows * hd; e += kThreads) {
        const int d = e % hd, tl = e / hd;
        const Acc* p = sS + tl * SS;
        float acc = 0.f;
        for (int s = 0; s < kTok; ++s) acc = fmaf((float)p[s], sV[s * VS + d], acc);
        sO[(q0 + tl) * OS + d] = acc;
      }
      __syncthreads();
    }
    // the head's share of the proj (and, once, its bias) onto the residual
    linear_any<MT>(
        sO, OS, hd, C, vec_hd, [&](int o) { return projw + (long long)o * C + hh * hd; },
        [&](int o) { return hh == 0 ? to_f(projb[o]) : 0.f; },
        [&](int t, int o, MT v) { sX[t * XS + o] += v; });
    __syncthreads();
  }

  layer_norm_any(sX, sH, C, XS, n2w, n2b, eps, (const float*)nullptr, (const float*)nullptr);
  __syncthreads();
#pragma unroll 1
  for (int h0 = 0; h0 < 4 * C; h0 += kAnyHC) {
    const int n = 4 * C - h0 < kAnyHC ? 4 * C - h0 : kAnyHC;   // hidden columns of the chunk
    linear_any<MT>(
        sH, XS, C, n, vec_c, [&](int o) { return f1w + (long long)(h0 + o) * C; },
        [&](int o) { return to_f(f1b[h0 + o]); }, [&](int t, int o, MT v) {
          if constexpr (kRes64)
            sA1[t * AS + o] = (float)(0.5 * v * (1.0 + erf(v * 0.70710678118654752440)));
          else
            sA1[t * AS + o] = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
        });
    __syncthreads();
    linear_any<MT>(
        sA1, AS, n, C, vec_c && n % 4 == 0,
        [&](int o) { return f2w + (long long)o * 4 * C + h0; },
        [&](int o) { return h0 == 0 ? to_f(f2b[o]) : 0.f; },
        [&](int t, int o, MT v) { sX[t * XS + o] += v; });
    __syncthreads();
  }

  for (int e = tid; e < kTok * C; e += kThreads) {
    const int t = e / C, c = e % C;
    if (valid(t)) y[offset(t) + c] = from_f<T>((float)sX[t * XS + c]);
  }
}

template <typename T>
int launch_any(const void* x, const void* st, const void* gamma, const void* beta,
               const void* const* w, void* y, int B, int H, int W, int C, float eps, void* ws,
               int ws_windows, cudaStream_t stream) {
  const int heads = default_num_heads(C);
  auto p = [&](int i) { return static_cast<const T*>(w[i]); };
  const int nwx = (W + kWin - 1) / kWin, nwy = (H + kWin - 1) / kWin;
  if (C <= kFrameDim && C / heads <= 64) {
    const int smem = any_smem_bytes<T>(C, C / heads, false);
    auto kernel = fused_structural_block_any_kernel<T, false>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(nwx, nwy, B);
    if (grid.z > 65535) return (int)cudaErrorInvalidConfiguration;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(st), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), p(0), p(1), p(2), p(3), p(4), p(5), p(6), p(7), p(8),
        p(9), p(10), p(11), static_cast<T*>(y), H, W, C, heads, eps, nullptr);
    return (int)cudaGetLastError();
  }
  // C > 256, or heads wider than 64 (fp32; bf16 runs in the pair kernel or
  // fused_structural_block_stream.cu): the residual stream and the LN output
  // of a window (64 x (C + 1) fp32 and float64 rows, 394 KB at C = 512)
  // outgrow shared memory and live in the caller's workspace, ws_windows
  // windows of it; the images pass in slices of as many windows, one launch
  // each. Shared memory holds one head (q | k in float64, v, a score tile):
  // heads of up to 174 channels (227 KB)
  if constexpr (!std::is_same_v<T, float>) {
    return (int)cudaErrorInvalidValue;
  } else {
    const int smem = any_smem_bytes<T>(C, C / heads, true);
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    auto kernel = C > 2 * kFrameDim ? fused_structural_block_any_kernel<T, true, true>
                                    : fused_structural_block_any_kernel<T, true>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const int per_image = nwx * nwy, nb = ws == nullptr ? 0 : ws_windows / per_image;
    if (nb < 1) return (int)cudaErrorInvalidValue;
    for (int b0 = 0; b0 < B; b0 += nb) {
      const int n = B - b0 < nb ? B - b0 : nb;
      const long long pix = (long long)b0 * H * W * C;
      kernel<<<dim3(nwx, nwy, n), kThreads, smem, stream>>>(
          static_cast<const T*>(x) + pix, static_cast<const T*>(st) + pix,
          static_cast<const float*>(gamma) + (long long)b0 * C,
          static_cast<const float*>(beta) + (long long)b0 * C, p(0), p(1), p(2), p(3), p(4), p(5),
          p(6), p(7), p(8), p(9), p(10), p(11), static_cast<T*>(y) + pix, H, W, C, heads, eps,
          static_cast<float*>(ws));
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    return 0;
  }
}

// ---------------------------------------------------------------------------

template <int C>
int launch_f32(const void* x, const void* st, const void* gamma, const void* beta,
               const void* const* w, void* y, int B, int H, int W, float eps,
               cudaStream_t stream) {
  constexpr bool kWide = C > 128;
  const int smem = (kWide ? F32WideLayout<C>::TOTAL : Layout<C>::TOTAL) * (int)sizeof(float);
  auto kernel = [] {
    if constexpr (kWide) return fused_structural_block_f32_wide_kernel<float, C>;
    else return fused_structural_block_f32_kernel<float, C>;
  }();
  static_assert(Layout<C>::HD % 4 == 0 && C % 4 == 0, "4-wide weight loads");
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

// bf16 at dim C: its own kernel at 32 and 64, the dim-128 design at 96 and
// 128, the dim-256 design at 160 .. 256.
template <int C>
int launch_bf16(const void* x, const void* st, const void* gamma, const void* beta,
                const void* const* w, void* y, int B, int H, int W, float eps,
                cudaStream_t stream) {
  constexpr bool kWide = C > 64 && C <= WideLayout::DP, kWidest = C > WideLayout::DP;
  static_assert(C <= WidestLayout::DP && C % mhsa::kHd == 0, "heads of 32 up to dim 256");
  constexpr int threads = kWide ? kGroupThreads : kMmaThreads;
  constexpr int per_block = kWide || kWidest ? 1 : kGroups;   // windows in flight
  constexpr int smem = kWide ? WideLayout::BYTES : kWidest ? WidestLayout::BYTES : MmaLayout<C>::BYTES;
  auto kernel = [] {   // one instantiation per dim, its dim folded in
    if constexpr (kWide) return fused_structural_block_wide_kernel<C>;
    else if constexpr (kWidest) return fused_structural_block_widest_kernel<C>;
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
// the same type as x (dtype 0 = fp32, 1 = bf16). Any C up to 256 whose
// default_num_heads(C) heads are at most 64 channels wide: C % 32 == 0 in
// the designs of heads of 32, any other C in the slot kernel or the FMA
// bodies; in fp32 also every C past 256 and every C with wider heads (up to
// 174 channels) in the FMA bodies (in bf16 the pair kernel's own entry
// point, fused_structural_block_pair.cu, and the streamed chain,
// fused_structural_block_stream.cu, take them) with the residual stream in
// `ws`, an fp32 workspace of ws_windows
// windows of 3 x 64 x (C + 1) floats (fp32: the residual stream, then the
// LN output in float64; 4 x 64 x (C + 1) past dim 512, whose residual
// stream is float64 too; unused otherwise). Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int fused_structural_block_launch(const void* x, const void* st, const void* gamma,
                                             const void* beta, const void* const* weights,
                                             void* y, int B, int H, int W, int C, int dtype,
                                             float eps, void* ws, int ws_windows, int device,
                                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return mstgan::launch_width<32>(x, st, gamma, beta, weights, y, B, H, W, dtype, eps, s);
    case 64: return mstgan::launch_width<64>(x, st, gamma, beta, weights, y, B, H, W, dtype, eps, s);
    case 96: return mstgan::launch_width<96>(x, st, gamma, beta, weights, y, B, H, W, dtype, eps, s);
    case 128: return mstgan::launch_width<128>(x, st, gamma, beta, weights, y, B, H, W, dtype, eps, s);
    case 160: return mstgan::launch_width<160>(x, st, gamma, beta, weights, y, B, H, W, dtype, eps, s);
    case 192: return mstgan::launch_width<192>(x, st, gamma, beta, weights, y, B, H, W, dtype, eps, s);
    case 224: return mstgan::launch_width<224>(x, st, gamma, beta, weights, y, B, H, W, dtype, eps, s);
    case 256: return mstgan::launch_width<256>(x, st, gamma, beta, weights, y, B, H, W, dtype, eps, s);
    default: {   // every other dim: 4 .. 252 (heads of 4 .. 62), and from 260 on in fp32
      if (C < 1) return (int)cudaErrorInvalidValue;
      const int heads = mstgan::default_num_heads(C);
      if (dtype == mstgan::kF32)
        return mstgan::launch_any<float>(x, st, gamma, beta, weights, y, B, H, W, C, eps, ws,
                                         ws_windows, s);
      if (dtype == mstgan::kBF16 && mstgan::slot_takes(C, heads))
        return mstgan::launch_slot(x, st, gamma, beta, weights, y, B, H, W, C, heads, eps, s);
      if (dtype == mstgan::kBF16 && C <= mstgan::kFrameDim && C / heads <= 64)
        return mstgan::launch_any<__nv_bfloat16>(x, st, gamma, beta, weights, y, B, H, W, C,
                                                 eps, nullptr, 0, s);
      return (int)cudaErrorInvalidValue;
    }
  }
}
