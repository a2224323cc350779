// Window-8 multi-head self-attention mid of the StructuralTransformerBlock,
// forward and backward, for Hopper (sm_90a).
//
// Replaces ops/pallas/window_mhsa_train.py::window_mhsa_train of the JAX
// package (its _fwd_kernel and hand-written _bwd_kernel). On a (B, H, W, 3C)
// qkv grid with C = 64 in 2 heads of 32, per 8x8 window of 64 tokens and
// per head, scale = 32^-0.5:
//   s  = q k^T scale, minus its row max ;  p = softmax(s) ;  o = p v
// and, given dO = d(o):
//   dv = p^T dO ;  dp = dO v^T ;  ds = p (.) (dp - rowsum(p (.) dp))
//   dq = ds k scale ;  dk = ds^T q scale
//
// What bounds it. Per token and head the forward reads 96 values and writes
// 32 while doing 2 x 64 x 32 x 2 = 8 kflop: about 32 flop per byte in bf16,
// under the card's bf16 ridge (~295 flop/B) but above the fp32 CUDA-core
// ridge (~20 flop/B); the backward does 2.5x the work for 128 values read and
// 96 written. This first version computes with fp32 FMAs from shared memory,
// so its arithmetic and shared-memory loads bound it; tensor-core tiles are
// later work. What the design secures is the traffic: the window partition
// and merge are address arithmetic, each of qkv and dO is read once, the
// 64 x 64 probabilities live only in shared memory and are recomputed in the
// backward, not saved.
//
// Design. One block of 256 threads per (window, head). q, k, v (and dO) are
// staged as fp32 rows of 32 with an odd stride; the 64 x 64 score tile has
// an odd stride too, so row and column walks fall in distinct banks. Each
// row softmax (and its backward row sum) is one warp. Softmax and every sum
// are fp32; bf16 inputs are rounded once at each output.
#include <climits>
#include <cmath>

#include "common.cuh"

namespace mstgan {
namespace {

constexpr int kWin = 8;
constexpr int kTok = kWin * kWin;
constexpr int kC = 64;
constexpr int kHeads = 2;
constexpr int kHd = kC / kHeads;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int TS = kHd + 1;    // token row stride (q, k, v, dO)
constexpr int PS = kTok + 1;   // score row stride
constexpr int ROWS = kTok * TS;
constexpr int SCORES = kTok * PS;
constexpr int F_TOTAL = 3 * ROWS + SCORES;            // q, k, v, p
constexpr int B_TOTAL = 4 * ROWS + 2 * SCORES;        // q, k, v, dO, p, dp

// Element offset of token t (row-major in the window) of window `win`,
// windows numbered (b, window row, window column) row-major.
__device__ __forceinline__ long long token_offset(long long win, int t, int H, int W) {
  const int nw = W / kWin, nh = H / kWin;
  const long long b = win / ((long long)nh * nw);
  const int rem = (int)(win - b * nh * nw);
  const int row = (rem / nw) * kWin + t / kWin;
  const int col = (rem % nw) * kWin + t % kWin;
  return (b * H + row) * (long long)W + col;
}

// Stages rows of 32 channels starting at `first` of a (.., stride) tensor.
template <typename T>
__device__ void load_rows(const T* __restrict__ src, int stride, int first, float* dst,
                          long long win, int H, int W) {
  for (int e = threadIdx.x; e < kTok * kHd; e += kThreads) {
    const int t = e / kHd, d = e % kHd;
    dst[t * TS + d] = to_f(src[token_offset(win, t, H, W) * stride + first + d]);
  }
}

// a[t][s] = scale * sum_d x[t][d] y[s][d] over the 64 x 64 tile.
__device__ void scores(const float* x, const float* y, float* a, float scale) {
  for (int e = threadIdx.x; e < kTok * kTok; e += kThreads) {
    const int t = e / kTok, s = e % kTok;
    float acc = 0.f;
#pragma unroll 8
    for (int d = 0; d < kHd; ++d) acc = fmaf(x[t * TS + d], y[s * TS + d], acc);
    a[t * PS + s] = acc * scale;
  }
}

// Row softmax of the 64 x 64 tile in place, max-subtracted; a warp per row.
__device__ void softmax_rows(float* p) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = warp; t < kTok; t += kWarps) {
    float* r = p + t * PS;
    const float m = warp_max(fmaxf(r[lane], r[lane + 32]));
    const float e0 = expf(r[lane] - m), e1 = expf(r[lane + 32] - m);
    const float sum = warp_sum(e0 + e1);
    r[lane] = e0 / sum;
    r[lane + 32] = e1 / sum;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mhsa_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int H, int W, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + ROWS;
  float* sV = sK + ROWS;
  float* sP = sV + ROWS;
  const long long win = blockIdx.x / kHeads;
  const int head = blockIdx.x % kHeads;
  load_rows(qkv, 3 * kC, head * kHd, sQ, win, H, W);
  load_rows(qkv, 3 * kC, kC + head * kHd, sK, win, H, W);
  load_rows(qkv, 3 * kC, 2 * kC + head * kHd, sV, win, H, W);
  __syncthreads();
  scores(sQ, sK, sP, scale);
  __syncthreads();
  softmax_rows(sP);
  __syncthreads();
  // o[t][d] = sum_s p[t][s] v[s][d]
  for (int e = threadIdx.x; e < kTok * kHd; e += kThreads) {
    const int t = e / kHd, d = e % kHd;
    float acc = 0.f;
#pragma unroll 8
    for (int s = 0; s < kTok; ++s) acc = fmaf(sP[t * PS + s], sV[s * TS + d], acc);
    out[token_offset(win, t, H, W) * kC + head * kHd + d] = from_f<T>(acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mhsa_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ dout, T* __restrict__ dqkv,
                int H, int W, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + ROWS;
  float* sV = sK + ROWS;
  float* sDO = sV + ROWS;
  float* sP = sDO + ROWS;
  float* sDP = sP + SCORES;
  const long long win = blockIdx.x / kHeads;
  const int head = blockIdx.x % kHeads;
  load_rows(qkv, 3 * kC, head * kHd, sQ, win, H, W);
  load_rows(qkv, 3 * kC, kC + head * kHd, sK, win, H, W);
  load_rows(qkv, 3 * kC, 2 * kC + head * kHd, sV, win, H, W);
  load_rows(dout, kC, head * kHd, sDO, win, H, W);
  __syncthreads();
  scores(sQ, sK, sP, scale);    // the forward's p, recomputed
  scores(sDO, sV, sDP, 1.f);    // dp[t][s] = sum_d dO[t][d] v[s][d]
  __syncthreads();
  softmax_rows(sP);
  __syncthreads();
  // ds = p (.) (dp - rowsum(p (.) dp)) into sDP, a warp per row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = warp; t < kTok; t += kWarps) {
    const float* p = sP + t * PS;
    float* g = sDP + t * PS;
    const float rs = warp_sum(p[lane] * g[lane] + p[lane + 32] * g[lane + 32]);
    g[lane] = p[lane] * (g[lane] - rs);
    g[lane + 32] = p[lane + 32] * (g[lane + 32] - rs);
  }
  __syncthreads();
  // row i of the outputs: dq[i] = scale sum_s ds[i][s] k[s];
  // dk[i] = scale sum_t ds[t][i] q[t]; dv[i] = sum_t p[t][i] dO[t]
  for (int e = threadIdx.x; e < kTok * kHd; e += kThreads) {
    const int i = e / kHd, d = e % kHd;
    float dq = 0.f, dk = 0.f, dv = 0.f;
#pragma unroll 8
    for (int j = 0; j < kTok; ++j) {
      dq = fmaf(sDP[i * PS + j], sK[j * TS + d], dq);
      dk = fmaf(sDP[j * PS + i], sQ[j * TS + d], dk);
      dv = fmaf(sP[j * PS + i], sDO[j * TS + d], dv);
    }
    T* row = dqkv + token_offset(win, i, H, W) * 3 * kC + head * kHd + d;
    row[0] = from_f<T>(dq * scale);
    row[kC] = from_f<T>(dk * scale);
    row[2 * kC] = from_f<T>(dv);
  }
}

template <typename T>
int launch_fwd(const void* qkv, void* out, int B, int H, int W, cudaStream_t stream) {
  const int smem = F_TOTAL * (int)sizeof(float);
  auto kernel = mhsa_fwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (long long)B * (H / kWin) * (W / kWin) * kHeads;
  if (grid > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), H, W, 1.f / sqrtf((float)kHd));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* qkv, const void* dout, void* dqkv, int B, int H, int W,
               cudaStream_t stream) {
  const int smem = B_TOTAL * (int)sizeof(float);
  auto kernel = mhsa_bwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (long long)B * (H / kWin) * (W / kWin) * kHeads;
  if (grid > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout), static_cast<T*>(dqkv), H, W,
      1.f / sqrtf((float)kHd));
  return (int)cudaGetLastError();
}

bool supported(int H, int W, int C, int heads) {
  return C == kC && heads == kHeads && H % kWin == 0 && W % kWin == 0;
}

}  // namespace
}  // namespace mstgan

// Plain C entry points (loaded with ctypes). qkv and dqkv are (B, H, W, 3C),
// out and dout (B, H, W, C), all contiguous, of one type (dtype 0 = fp32,
// 1 = bf16), with C = 64 in 2 heads and H % 8 == W % 8 == 0. Each launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int window_mhsa_train_fwd_launch(const void* qkv, void* out, int B, int H, int W,
                                            int C, int heads, int dtype, int device,
                                            void* stream) {
  if (!mstgan::supported(H, W, C, heads)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mstgan::kF32) return mstgan::launch_fwd<float>(qkv, out, B, H, W, s);
  if (dtype == mstgan::kBF16) return mstgan::launch_fwd<__nv_bfloat16>(qkv, out, B, H, W, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int window_mhsa_train_bwd_launch(const void* qkv, const void* dout, void* dqkv,
                                            int B, int H, int W, int C, int heads, int dtype,
                                            int device, void* stream) {
  if (!mstgan::supported(H, W, C, heads)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mstgan::kF32) return mstgan::launch_bwd<float>(qkv, dout, dqkv, B, H, W, s);
  if (dtype == mstgan::kBF16)
    return mstgan::launch_bwd<__nv_bfloat16>(qkv, dout, dqkv, B, H, W, s);
  return (int)cudaErrorInvalidValue;
}
