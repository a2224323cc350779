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
// ridge. This first kernel does every product with fp32 FMAs on the CUDA
// cores and leaves the tensor cores idle, so its arithmetic bounds it;
// mma/wgmma tiles are later work.
//
// Design. One block of 256 threads per window of 64 tokens. Activations
// live in dynamic shared memory in fp32 (about 97 KB at C = 64, buffers
// reused between phases); weights are read through L2 and the read-only
// cache, four at a time. In the four Linear products each thread keeps a
// 4-token by N/16-output tile of sums in registers; activation rows have
// an odd stride so a warp's reads fall in distinct banks.
#include <cmath>

#include "common.cuh"

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
fused_structural_block_kernel(const T* __restrict__ x, const T* __restrict__ st,
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

template <typename T, int C>
int launch(const void* x, const void* st, const void* gamma, const void* beta,
           const void* const* w, void* y, int B, int H, int W, float eps,
           cudaStream_t stream) {
  using L = Layout<C>;
  static_assert(L::HD % 4 == 0 && C % 4 == 0, "4-wide weight loads");
  const int smem = L::TOTAL * (int)sizeof(float);
  auto kernel = fused_structural_block_kernel<T, C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kWin - 1) / kWin, (H + kWin - 1) / kWin, B);
  auto p = [&](int i) { return static_cast<const T*>(w[i]); };
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(st), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), p(0), p(1), p(2), p(3), p(4), p(5), p(6), p(7), p(8),
      p(9), p(10), p(11), static_cast<T*>(y), H, W, eps);
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
    return mstgan::launch<float, 64>(x, st, gamma, beta, weights, y, B, H, W, eps, s);
  if (dtype == mstgan::kBF16)
    return mstgan::launch<__nv_bfloat16, 64>(x, st, gamma, beta, weights, y, B, H, W, eps, s);
  return (int)cudaErrorInvalidValue;
}
