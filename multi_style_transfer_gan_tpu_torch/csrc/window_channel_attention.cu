// Windowed channel attention (the EnhancedGenerator's LocalAttention),
// inference forward, for Hopper (sm_90a), on two layouts of one op.
//
// NHWC (window_channel_attention_launch) replaces the three TPU layouts of
// the op on unpacked activations in the JAX package:
//   ops/pallas/window_attention.py::fused_window_channel_attention (v1),
//   ops/pallas/window_attention_grouped.py::grouped_window_channel_attention,
//   ops/pallas/window_attention_v3.py::window_attention_v3.
// Packed rows (packed_window_channel_attention_launch) replace the three
// kernels of the packed (space-to-depth) engine, whose activations hold one
// 4x4 window per packed pixel, position major (lane p*C + c, p = 4*pi + pj):
//   ops/pallas/window_attention_grouped.py::packed_grouped_window_attention,
//   ops/pallas/window_attention_v3.py::packed_window_attention_v3,
//   ops/pallas/packed_attention.py::packed_window_attention_pallas.
// The two layouts differ only in where position p of window w lives
// (`pixel_offset` below), so one kernel body serves both; the TPU kernels'
// expanded block-diagonal weights, 0/1 rep/tile matrices and lane-stacked
// groups were answers to 128-lane tiles and have no counterpart here.
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
// in bf16 (read x once, write y once): about 3*C flop per byte, 48-192 at
// C = 16..64. Against the tensor-core ridge (~295 flop/B in bf16) that is
// bytes-bound at every C, which is why the whole chain stays in one pass
// and no intermediate touches device memory. This first kernel does its
// products with fp32 FMAs on the CUDA cores, whose ridge is ~20 flop/B, so
// for now its arithmetic and shared-memory traffic bound it; moving the
// qkv/proj products onto mma/wgmma is later work.
//
// Design. One block of 256 threads stages Wqkv^T, Wproj^T and the biases in
// shared memory once (fp32; 48 KB + 16 KB at C = 64), then walks tiles of
// NW = 64 / C windows (1024 activations per tile at every C). Each tile is
// loaded once, every intermediate lives in shared memory in fp32, and the
// result is written once in the input's type. In the qkv, apply and proj
// products each thread owns one output channel at 4 positions, so one
// shared-memory load feeds 3-4 FMAs. Row strides of qkv and the Gram are
// padded to an odd number of floats so column walks hit distinct banks.
// Windows past the end of the last tile compute on zeros and are not
// stored.
#include <climits>
#include <cmath>

#include "common.cuh"

namespace mstgan {
namespace {

constexpr int kWs = 4;
constexpr int kP = kWs * kWs;
constexpr int kThreads = 256;
constexpr int kTilesPerBlock = 4;

template <int C>
struct Layout {
  static constexpr int NW = 64 / C;      // windows per tile
  static constexpr int ROWS = NW * kP;   // positions per tile
  static constexpr int QS = 3 * C + 1;   // padded qkv row stride
  static constexpr int GS = C + 1;       // padded Gram row stride
  static constexpr int W_QKV = 0;                  // [C][3C], (in, out)
  static constexpr int B_QKV = W_QKV + C * 3 * C;  // [3C]
  static constexpr int W_PROJ = B_QKV + 3 * C;     // [C][C], (in, out)
  static constexpr int B_PROJ = W_PROJ + C * C;    // [C]
  static constexpr int X = B_PROJ + C;             // [ROWS][C]; later the attention output
  static constexpr int QKV = X + ROWS * C;         // [ROWS][QS]
  static constexpr int DEN = QKV + ROWS * QS;      // [2][ROWS] normalize denominators
  static constexpr int G = DEN + 2 * ROWS;         // [NW][C][GS]
  static constexpr int TOTAL = G + NW * C * GS;
};

// Row (in units of C elements) of position `p` (0..15, row-major in the
// window) of window `win`, windows numbered (b, window row, window column)
// row-major. NHWC: a pixel of a (B, H, W, C) tensor. Packed: the packed
// tensor (B, H/4, W/4, 16*C) holds window `win` as one contiguous row of 16
// positions, so the tile of a block is one contiguous span.
template <bool kPacked>
__device__ __forceinline__ long long pixel_offset(long long win, int p, int H, int W) {
  if constexpr (kPacked) {
    return win * kP + p;
  } else {
    const int nw = W / kWs, nh = H / kWs;
    const long long b = win / ((long long)nh * nw);
    const int rem = (int)(win - b * nh * nw);
    const int row = (rem / nw) * kWs + p / kWs;
    const int col = (rem % nw) * kWs + p % kWs;
    return (b * H + row) * (long long)W + col;
  }
}

template <typename T, int C, bool kPacked>
__global__ void __launch_bounds__(kThreads)
window_channel_attention_kernel(const T* __restrict__ x, const T* __restrict__ wqkv,
                                const T* __restrict__ bqkv, const T* __restrict__ wproj,
                                const T* __restrict__ bproj, T* __restrict__ y,
                                int H, int W, long long n_windows, float eps) {
  using L = Layout<C>;
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
  // qkv, apply and proj: thread (og, rg) owns output channel og at 4
  // positions, so one shared-memory load feeds 3-4 FMAs
  constexpr int RG = kThreads / C;
  static_assert(L::ROWS == 4 * RG && kP % 4 == 0, "4 positions per thread");
  const int og = tid % C, rg = tid / C;

  for (int e = tid; e < 3 * C * C; e += kThreads) {
    const int o = e / C, i = e % C;
    sWq[i * 3 * C + o] = to_f(wqkv[e]);
  }
  for (int e = tid; e < 3 * C; e += kThreads) sBq[e] = to_f(bqkv[e]);
  for (int e = tid; e < C * C; e += kThreads) {
    const int o = e / C, i = e % C;
    sWp[i * C + o] = to_f(wproj[e]);
  }
  for (int e = tid; e < C; e += kThreads) sBp[e] = to_f(bproj[e]);

  const long long n_tiles = (n_windows + L::NW - 1) / L::NW;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long win0 = tile * L::NW;
    __syncthreads();  // weights staged; the previous tile is done with sX

    for (int e = tid; e < L::ROWS * C; e += kThreads) {
      const int r = e / C, c = e % C;
      const long long win = win0 + r / kP;
      sX[e] = win < n_windows ? to_f(x[pixel_offset<kPacked>(win, r % kP, H, W) * C + c]) : 0.f;
    }
    __syncthreads();

    // qkv = x @ Wqkv^T + b; each thread sums q, k and v of channel og
    // at 4 positions in registers
    {
      float acc[4][3] = {};
#pragma unroll 4
      for (int i = 0; i < C; ++i) {
        float a[4], w[3];
#pragma unroll
        for (int j = 0; j < 4; ++j) a[j] = sX[(rg + RG * j) * C + i];
#pragma unroll
        for (int k = 0; k < 3; ++k) w[k] = sWq[i * 3 * C + og + C * k];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int k = 0; k < 3; ++k) acc[j][k] = fmaf(a[j], w[k], acc[j][k]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 3; ++k)
          sQKV[(rg + RG * j) * L::QS + og + C * k] = acc[j][k] + sBq[og + C * k];
    }
    __syncthreads();

    // zero-safe L2 normalize of q and k at each position
    for (int e = tid; e < 2 * L::ROWS; e += kThreads) {
      const int s = e / L::ROWS, r = e % L::ROWS;
      const float* u = sQKV + r * L::QS + s * C;
      float ss = 0.f;
#pragma unroll 16
      for (int c = 0; c < C; ++c) ss = fmaf(u[c], u[c], ss);
      sDen[e] = fmaxf(ss == 0.f ? 0.f : sqrtf(ss), eps);
    }
    __syncthreads();
    for (int e = tid; e < L::ROWS * 2 * C; e += kThreads) {
      const int r = e / (2 * C), c = e % (2 * C);
      sQKV[r * L::QS + c] /= sDen[(c / C) * L::ROWS + r];
    }
    __syncthreads();

    // Gram qn^T kn per window, over its 16 positions
    for (int e = tid; e < L::NW * C * C; e += kThreads) {
      const int n = e / (C * C), c1 = (e / C) % C, c2 = e % C;
      const float* base = sQKV + n * kP * L::QS;
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < kP; ++t) acc = fmaf(base[t * L::QS + c1], base[t * L::QS + C + c2], acc);
      sG[(n * C + c1) * L::GS + c2] = acc;
    }
    __syncthreads();

    // row softmax, max-subtracted
    for (int row = tid; row < L::NW * C; row += kThreads) {
      float* g = sG + row * L::GS;
      float m = -INFINITY;
      for (int c = 0; c < C; ++c) m = fmaxf(m, g[c]);
      float sum = 0.f;
      for (int c = 0; c < C; ++c) {
        const float ev = expf(g[c] - m);
        g[c] = ev;
        sum += ev;
      }
      for (int c = 0; c < C; ++c) g[c] = g[c] / sum;
    }
    __syncthreads();

    // out[r, c1] = sum_c2 A[c1, c2] v[r, c2], into sX; each thread takes
    // channel og at 4 consecutive positions of one window
    {
      const float* a = sG + ((rg * 4 / kP) * C + og) * L::GS;
      float acc[4] = {};
#pragma unroll 4
      for (int c2 = 0; c2 < C; ++c2) {
        const float g = a[c2];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[j] = fmaf(g, sQKV[(rg * 4 + j) * L::QS + 2 * C + c2], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) sX[(rg * 4 + j) * C + og] = acc[j];
    }
    __syncthreads();

    // y = out @ Wproj^T + b, stored once
    {
      float acc[4] = {};
#pragma unroll 4
      for (int i = 0; i < C; ++i) {
        const float w = sWp[i * C + og];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = fmaf(sX[(rg + RG * j) * C + i], w, acc[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = rg + RG * j;
        const long long win = win0 + r / kP;
        if (win < n_windows)
          y[pixel_offset<kPacked>(win, r % kP, H, W) * C + og] = from_f<T>(acc[j] + sBp[og]);
      }
    }
  }
}

template <typename T, int C, bool kPacked>
int launch(const void* x, const void* wqkv, const void* bqkv, const void* wproj,
           const void* bproj, void* y, int H, int W, long long n_windows, float eps,
           cudaStream_t stream) {
  using L = Layout<C>;
  const int smem = L::TOTAL * (int)sizeof(float);
  auto kernel = window_channel_attention_kernel<T, C, kPacked>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = (n_windows + L::NW - 1) / L::NW;
  long long grid = (n_tiles + kTilesPerBlock - 1) / kTilesPerBlock;
  if (grid > INT_MAX) grid = INT_MAX;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv), static_cast<const T*>(bqkv),
      static_cast<const T*>(wproj), static_cast<const T*>(bproj), static_cast<T*>(y),
      H, W, n_windows, eps);
  return (int)cudaGetLastError();
}

template <bool kPacked, typename T>
int launch_c(const void* x, const void* wqkv, const void* bqkv, const void* wproj,
             const void* bproj, void* y, int H, int W, long long n_windows, int C,
             float eps, cudaStream_t stream) {
  switch (C) {
    case 16: return launch<T, 16, kPacked>(x, wqkv, bqkv, wproj, bproj, y, H, W, n_windows, eps, stream);
    case 32: return launch<T, 32, kPacked>(x, wqkv, bqkv, wproj, bproj, y, H, W, n_windows, eps, stream);
    case 64: return launch<T, 64, kPacked>(x, wqkv, bqkv, wproj, bproj, y, H, W, n_windows, eps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kPacked>
int launch_dtype(const void* x, const void* wqkv, const void* bqkv, const void* wproj,
                 const void* bproj, void* y, int H, int W, long long n_windows, int C,
                 int dtype, float eps, int device, void* stream) {
  if (n_windows <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_c<kPacked, float>(x, wqkv, bqkv, wproj, bproj, y, H, W, n_windows, C, eps, s);
  if (dtype == kBF16)
    return launch_c<kPacked, __nv_bfloat16>(x, wqkv, bqkv, wproj, bproj, y, H, W, n_windows, C,
                                            eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace mstgan

// Plain C entry points (loaded with ctypes). Weights: wqkv (3C, C), bqkv
// (3C), wproj (C, C), bproj (C), in the input's type: dtype 0 = fp32,
// 1 = bf16; C in {16, 32, 64}. Each launches on `stream` and returns
// cudaGetLastError() (0 on success).
//
// x and y (B, H, W, C) contiguous, H % 4 == W % 4 == 0.
extern "C" int window_channel_attention_launch(const void* x, const void* wqkv,
                                               const void* bqkv, const void* wproj,
                                               const void* bproj, void* y, int B, int H,
                                               int W, int C, int dtype, float eps,
                                               int device, void* stream) {
  const long long n_windows = (long long)B * (H / mstgan::kWs) * (W / mstgan::kWs);
  return mstgan::launch_dtype<false>(x, wqkv, bqkv, wproj, bproj, y, H, W, n_windows, C, dtype,
                                     eps, device, stream);
}

// x and y packed (B, Hp, Wp, 16*C) contiguous: one window per packed pixel.
extern "C" int packed_window_channel_attention_launch(const void* x, const void* wqkv,
                                                      const void* bqkv, const void* wproj,
                                                      const void* bproj, void* y, int B,
                                                      int Hp, int Wp, int C, int dtype,
                                                      float eps, int device, void* stream) {
  const long long n_windows = (long long)B * Hp * Wp;
  return mstgan::launch_dtype<true>(x, wqkv, bqkv, wproj, bproj, y, Hp * mstgan::kWs,
                                    Wp * mstgan::kWs, n_windows, C, dtype, eps, device, stream);
}
