// Windowed channel-attention mid (the EnhancedGenerator's LocalAttention
// between its two 1x1 convs), forward and backward, for Hopper (sm_90a).
//
// Replaces ops/pallas/window_attention_train.py::window_channel_attention_train
// of the JAX package: the forward _mid_fwd_kernel and the hand-written
// backward _mid_bwd_kernel of its grouped custom_vjp. On a (B, H, W, 3C) qkv
// map, per 4x4 window with P = 16 positions:
//   qn, kn = zero-safe L2 normalize of q, k over C (u / max(|u|, eps), 0 -> 0)
//   S      = softmax_rows(qn^T kn)                        (C x C, max-subtracted)
//   out    = v S^T                                        (P x C)
// and, given dO = d(out):
//   dS = dO^T v ;  dL = S (.) (dS - rowsum(S (.) dS))
//   dv = dO S ;  dqn = kn dL^T ;  dkn = qn dL
//   dq = (dqn - qn <qn, dqn> sel) / max(|q|, eps)   (dk alike; sel = 0 when
//        |q| is 0 or not above eps, so an all-zero window stays finite)
// The TPU's grouped lane-stacked layout and its block-diagonal mask exist
// for the 128-lane MXU and are not ported: here one window is one C x C
// Gram in shared memory.
//
// What bounds it. Per position the forward reads 3C values and writes C;
// its arithmetic is about 4*C flops per value moved (two C x C x 16
// products per window), so against the card's bf16 ridge (~295 flop/B) it
// is bytes-bound; the backward does five such products for 4C values
// read and 3C written, still under the ridge. Both therefore keep every
// intermediate in shared memory: one read of the inputs, one write of the
// outputs, the softmax recomputed in the backward rather than saved, as the
// Pallas backward does. This first version does its products with fp32 FMAs
// on the CUDA cores, whose ridge is ~20 flop/B, so for now its arithmetic
// and shared-memory traffic bound it; tensor-core tiles are later work.
//
// Design. One block of 256 threads per tile of NW = 64 / C windows (1024
// values of q at every C). Every intermediate is fp32 in shared memory;
// softmax and every sum are fp32, and bf16 inputs are rounded once at each
// output. Row strides are odd so column walks fall in distinct banks; the
// softmax rows and the softmax-backward row sums are one warp per row.
// Windows past the end of the last tile compute on zeros and are not stored.
#include <climits>
#include <cmath>

#include "common.cuh"

namespace mstgan {
namespace {

constexpr int kWs = 4;
constexpr int kP = kWs * kWs;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int C>
struct Layout {
  static constexpr int NW = 64 / C;      // windows per block
  static constexpr int ROWS = NW * kP;   // positions per block
  static constexpr int QS = 3 * C + 1;   // qkv row stride
  static constexpr int DS = C + 1;       // dO row stride
  static constexpr int GS = C + 1;       // C x C row stride
  static constexpr int KS = 2 * C + 1;   // dqn | dkn row stride
  static constexpr int GRAMS = NW * C * GS;
  // forward
  static constexpr int F_QKV = 0;                    // [ROWS][QS]: qn, kn, v
  static constexpr int F_INV = F_QKV + ROWS * QS;    // [2][ROWS]
  static constexpr int F_S = F_INV + 2 * ROWS;       // [NW][C][GS]
  static constexpr int F_TOTAL = F_S + GRAMS;
  // backward
  static constexpr int B_QKV = 0;                    // [ROWS][QS]: qn, kn, v
  static constexpr int B_DO = B_QKV + ROWS * QS;     // [ROWS][DS]
  static constexpr int B_INV = B_DO + ROWS * DS;     // [2][ROWS]
  static constexpr int B_SEL = B_INV + 2 * ROWS;     // [2][ROWS]
  static constexpr int B_DOT = B_SEL + 2 * ROWS;     // [2][ROWS] <un, dun> sel
  static constexpr int B_S = B_DOT + 2 * ROWS;       // [NW][C][GS] S
  static constexpr int B_D = B_S + GRAMS;            // [NW][C][GS] dS, then dL
  static constexpr int B_DQK = B_D + GRAMS;          // [ROWS][KS]
  static constexpr int B_TOTAL = B_DQK + ROWS * KS;
};

// Element offset of pixel `p` (0..15, row-major in the window) of window
// `win`, windows numbered (b, window row, window column) row-major.
__device__ __forceinline__ long long pixel_offset(long long win, int p, int H, int W) {
  const int nw = W / kWs, nh = H / kWs;
  const long long b = win / ((long long)nh * nw);
  const int rem = (int)(win - b * nh * nw);
  const int row = (rem / nw) * kWs + p / kWs;
  const int col = (rem % nw) * kWs + p % kWs;
  return (b * H + row) * (long long)W + col;
}

// Loads the tile's q, k, v as fp32 and normalizes q and k in place.
// inv[s][r] = 1 / max(|u|, eps), or 1 / eps for a zero vector; sel[s][r]
// = 1 where u is nonzero and |u| > eps (s = 0 for q, 1 for k). Ends with
// the block synchronized.
template <typename T, int C>
__device__ void load_normalize(const T* __restrict__ qkv, float* sQKV, float* sInv,
                               float* sSel, long long win0, long long n_windows, int H,
                               int W, float eps) {
  using L = Layout<C>;
  const int tid = threadIdx.x;
  for (int e = tid; e < L::ROWS * 3 * C; e += kThreads) {
    const int r = e / (3 * C), c = e % (3 * C);
    const long long win = win0 + r / kP;
    sQKV[r * L::QS + c] =
        win < n_windows ? to_f(qkv[pixel_offset(win, r % kP, H, W) * 3 * C + c]) : 0.f;
  }
  __syncthreads();
  for (int e = tid; e < 2 * L::ROWS; e += kThreads) {
    const int s = e / L::ROWS, r = e % L::ROWS;
    const float* u = sQKV + r * L::QS + s * C;
    float ss = 0.f;
#pragma unroll 16
    for (int c = 0; c < C; ++c) ss = fmaf(u[c], u[c], ss);
    const bool nz = ss > 0.f;
    const float n = sqrtf(nz ? ss : 1.f);
    sInv[e] = 1.f / (nz ? fmaxf(n, eps) : eps);
    if (sSel) sSel[e] = (nz && n > eps) ? 1.f : 0.f;
  }
  __syncthreads();
  for (int e = tid; e < L::ROWS * 2 * C; e += kThreads) {
    const int r = e / (2 * C), c = e % (2 * C);
    sQKV[r * L::QS + c] *= sInv[(c / C) * L::ROWS + r];
  }
  __syncthreads();
}

// S[n][c1][c2] = softmax over c2 of sum_t qn[t][c1] kn[t][c2], per window
// n of the tile, max-subtracted. Ends with the block synchronized.
template <int C>
__device__ void gram_softmax(const float* sQKV, float* sS) {
  using L = Layout<C>;
  const int tid = threadIdx.x;
  for (int e = tid; e < L::NW * C * C; e += kThreads) {
    const int n = e / (C * C), c1 = (e / C) % C, c2 = e % C;
    const float* base = sQKV + n * kP * L::QS;
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < kP; ++t) acc = fmaf(base[t * L::QS + c1], base[t * L::QS + C + c2], acc);
    sS[(n * C + c1) * L::GS + c2] = acc;
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  for (int row = warp; row < L::NW * C; row += kWarps) {
    float* g = sS + row * L::GS;
    float m = -INFINITY;
    for (int c = lane; c < C; c += 32) m = fmaxf(m, g[c]);
    m = warp_max(m);
    float sum = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float ev = expf(g[c] - m);
      g[c] = ev;
      sum += ev;
    }
    sum = warp_sum(sum);
    for (int c = lane; c < C; c += 32) g[c] = g[c] / sum;
  }
  __syncthreads();
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
mid_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int H, int W,
               long long n_windows, float eps) {
  using L = Layout<C>;
  extern __shared__ float smem[];
  float* sQKV = smem + L::F_QKV;
  float* sS = smem + L::F_S;
  const long long win0 = (long long)blockIdx.x * L::NW;
  load_normalize<T, C>(qkv, sQKV, smem + L::F_INV, nullptr, win0, n_windows, H, W, eps);
  gram_softmax<C>(sQKV, sS);
  // out[t][c1] = sum_c2 S[c1][c2] v[t][c2]
  for (int e = threadIdx.x; e < L::ROWS * C; e += kThreads) {
    const int r = e / C, c1 = e % C;
    const long long win = win0 + r / kP;
    if (win >= n_windows) continue;
    const float* s = sS + ((r / kP) * C + c1) * L::GS;
    const float* v = sQKV + r * L::QS + 2 * C;
    float acc = 0.f;
#pragma unroll 16
    for (int c2 = 0; c2 < C; ++c2) acc = fmaf(s[c2], v[c2], acc);
    out[pixel_offset(win, r % kP, H, W) * C + c1] = from_f<T>(acc);
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
mid_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ dout, T* __restrict__ dqkv,
               int H, int W, long long n_windows, float eps) {
  using L = Layout<C>;
  extern __shared__ float smem[];
  float* sQKV = smem + L::B_QKV;
  float* sDO = smem + L::B_DO;
  float* sInv = smem + L::B_INV;
  float* sSel = smem + L::B_SEL;
  float* sDot = smem + L::B_DOT;
  float* sS = smem + L::B_S;
  float* sD = smem + L::B_D;
  float* sDQK = smem + L::B_DQK;
  const int tid = threadIdx.x;
  const long long win0 = (long long)blockIdx.x * L::NW;

  for (int e = tid; e < L::ROWS * C; e += kThreads) {
    const int r = e / C, c = e % C;
    const long long win = win0 + r / kP;
    sDO[r * L::DS + c] =
        win < n_windows ? to_f(dout[pixel_offset(win, r % kP, H, W) * C + c]) : 0.f;
  }
  load_normalize<T, C>(qkv, sQKV, sInv, sSel, win0, n_windows, H, W, eps);
  gram_softmax<C>(sQKV, sS);  // the forward's S, recomputed

  // dS[n][c1][c2] = sum_t dO[t][c1] v[t][c2]
  for (int e = tid; e < L::NW * C * C; e += kThreads) {
    const int n = e / (C * C), c1 = (e / C) % C, c2 = e % C;
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < kP; ++t) {
      const int r = n * kP + t;
      acc = fmaf(sDO[r * L::DS + c1], sQKV[r * L::QS + 2 * C + c2], acc);
    }
    sD[(n * C + c1) * L::GS + c2] = acc;
  }
  __syncthreads();

  // softmax backward: dL = S (.) (dS - rowsum(S (.) dS)), one warp per row
  const int warp = tid / 32, lane = tid % 32;
  for (int row = warp; row < L::NW * C; row += kWarps) {
    const float* s = sS + row * L::GS;
    float* d = sD + row * L::GS;
    float rs = 0.f;
    for (int c = lane; c < C; c += 32) rs = fmaf(s[c], d[c], rs);
    rs = warp_sum(rs);
    for (int c = lane; c < C; c += 32) d[c] = s[c] * (d[c] - rs);
  }
  __syncthreads();

  // dv[t][c] = sum_j S[j][c] dO[t][j], stored; dqn[t][c] = sum_j dL[c][j]
  // kn[t][j] and dkn[t][c] = sum_j dL[j][c] qn[t][j], kept for the norm
  // backward
  for (int e = tid; e < L::ROWS * C; e += kThreads) {
    const int r = e / C, c = e % C, n = r / kP;
    const float* s = sS + n * C * L::GS;
    const float* dl = sD + n * C * L::GS;
    const float* u = sQKV + r * L::QS;
    const float* g = sDO + r * L::DS;
    float dv = 0.f, dq = 0.f, dk = 0.f;
#pragma unroll 8
    for (int j = 0; j < C; ++j) {
      dv = fmaf(s[j * L::GS + c], g[j], dv);
      dq = fmaf(dl[c * L::GS + j], u[C + j], dq);
      dk = fmaf(dl[j * L::GS + c], u[j], dk);
    }
    sDQK[r * L::KS + c] = dq;
    sDQK[r * L::KS + C + c] = dk;
    const long long win = win0 + n;
    if (win < n_windows) dqkv[pixel_offset(win, r % kP, H, W) * 3 * C + 2 * C + c] = from_f<T>(dv);
  }
  __syncthreads();

  // L2-normalize backward: du = (dun - un <un, dun> sel) * inv
  for (int e = tid; e < 2 * L::ROWS; e += kThreads) {
    const int s = e / L::ROWS, r = e % L::ROWS;
    const float* un = sQKV + r * L::QS + s * C;
    const float* dun = sDQK + r * L::KS + s * C;
    float dot = 0.f;
#pragma unroll 16
    for (int c = 0; c < C; ++c) dot = fmaf(un[c], dun[c], dot);
    sDot[e] = dot * sSel[e];
  }
  __syncthreads();
  for (int e = tid; e < L::ROWS * 2 * C; e += kThreads) {
    const int r = e / (2 * C), c = e % (2 * C), s = c / C;
    const long long win = win0 + r / kP;
    if (win >= n_windows) continue;
    const float du = (sDQK[r * L::KS + c] - sQKV[r * L::QS + c] * sDot[s * L::ROWS + r]) *
                     sInv[s * L::ROWS + r];
    dqkv[pixel_offset(win, r % kP, H, W) * 3 * C + c] = from_f<T>(du);
  }
}

template <typename T, int C>
int launch_fwd(const void* qkv, void* out, int B, int H, int W, float eps, cudaStream_t stream) {
  using L = Layout<C>;
  const int smem = L::F_TOTAL * (int)sizeof(float);
  auto kernel = mid_fwd_kernel<T, C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_windows = (long long)B * (H / kWs) * (W / kWs);
  const long long grid = (n_windows + L::NW - 1) / L::NW;
  if (grid > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(static_cast<const T*>(qkv),
                                                     static_cast<T*>(out), H, W, n_windows, eps);
  return (int)cudaGetLastError();
}

template <typename T, int C>
int launch_bwd(const void* qkv, const void* dout, void* dqkv, int B, int H, int W, float eps,
               cudaStream_t stream) {
  using L = Layout<C>;
  const int smem = L::B_TOTAL * (int)sizeof(float);
  auto kernel = mid_bwd_kernel<T, C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_windows = (long long)B * (H / kWs) * (W / kWs);
  const long long grid = (n_windows + L::NW - 1) / L::NW;
  if (grid > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout), static_cast<T*>(dqkv), H, W,
      n_windows, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_c(const void* qkv, void* out, int B, int H, int W, int C, float eps, cudaStream_t s) {
  switch (C) {
    case 16: return launch_fwd<T, 16>(qkv, out, B, H, W, eps, s);
    case 32: return launch_fwd<T, 32>(qkv, out, B, H, W, eps, s);
    case 64: return launch_fwd<T, 64>(qkv, out, B, H, W, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int bwd_c(const void* qkv, const void* dout, void* dqkv, int B, int H, int W, int C, float eps,
          cudaStream_t s) {
  switch (C) {
    case 16: return launch_bwd<T, 16>(qkv, dout, dqkv, B, H, W, eps, s);
    case 32: return launch_bwd<T, 32>(qkv, dout, dqkv, B, H, W, eps, s);
    case 64: return launch_bwd<T, 64>(qkv, dout, dqkv, B, H, W, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace mstgan

// Plain C entry points (loaded with ctypes). qkv and dqkv are (B, H, W, 3C),
// out and dout (B, H, W, C), all contiguous, of one type (dtype 0 = fp32,
// 1 = bf16), with H % 4 == W % 4 == 0 and C in {16, 32, 64}. Each launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int window_attention_train_fwd_launch(const void* qkv, void* out, int B, int H,
                                                 int W, int C, int dtype, float eps,
                                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mstgan::kF32) return mstgan::fwd_c<float>(qkv, out, B, H, W, C, eps, s);
  if (dtype == mstgan::kBF16) return mstgan::fwd_c<__nv_bfloat16>(qkv, out, B, H, W, C, eps, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int window_attention_train_bwd_launch(const void* qkv, const void* dout,
                                                 void* dqkv, int B, int H, int W, int C,
                                                 int dtype, float eps, int device,
                                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mstgan::kF32)
    return mstgan::bwd_c<float>(qkv, dout, dqkv, B, H, W, C, eps, s);
  if (dtype == mstgan::kBF16)
    return mstgan::bwd_c<__nv_bfloat16>(qkv, dout, dqkv, B, H, W, C, eps, s);
  return (int)cudaErrorInvalidValue;
}
