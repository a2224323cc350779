// Window-8 multi-head self-attention mid of the StructuralTransformerBlock,
// forward and backward, for Hopper (sm_90a).
//
// Replaces ops/pallas/window_mhsa_train.py::window_mhsa_train of the JAX
// package (its _fwd_kernel and hand-written _bwd_kernel). On a (B, H, W, 3C)
// qkv grid with C = 32 HEADS in HEADS heads of 32 (the blocks of the c8,
// c16 and c32 generators: C = 32, 64, 128 in 1, 2, 4 heads), per 8x8
// window of 64 tokens and per head, scale = 32^-0.5:
//   s  = q k^T scale, minus its row max ;  p = softmax(s) ;  o = p v
// and, given dO = d(o):
//   dv = p^T dO ;  dp = dO v^T ;  ds = p (.) (dp - rowsum(p (.) dp))
//   dq = ds k scale ;  dk = ds^T q scale
//
// What bounds it. Per token and head the forward reads 96 values and writes
// 32 while doing 2 x 64 x 32 x 2 = 8 kflop, the backward 2.5x the work for
// 128 values read and 96 written: ~32 flop per byte in bf16, far under the
// card's bf16 tensor-core ridge (~295 flop/B), so the bound is the bytes:
// 0.0138 ms for forward + backward at qkv (8, 64, 64, 192) (the matrix
// products alone would take 0.0019 ms at 989 TFLOP/s). Each of qkv and dO
// is read once, the window partition and merge are address arithmetic, and
// the 64 x 64 probabilities never leave the chip: the backward recomputes
// them.
//
// The first design (kept as the fp32 instantiation below) did every product
// as fp32 FMAs with both operands read from shared memory, two wavefronts
// per warp FMA against one wavefront per SM and clock: 0.94 G FMAs per
// forward + backward at batch 8 are ~59 M wavefronts, ~0.25 ms at ~1.75
// GHz over 132 SMs, ~90% of its measured 0.284 ms.
//
// bf16 design. One block of 4 warps per (window, head); each warp owns 16
// query rows, FlashAttention-2 style, and every product is
// mma.sync.m16n8k16 (bf16 in, fp32 sums; csrc/mma.cuh). q, k, v (and dO)
// are staged as bf16 with 16-byte cp.async into rows padded to 80 bytes, so
// ldmatrix is free of bank conflicts. Forward: the 16 x 64 score strip in
// registers, row max and sum by quad shuffles, the exponentials repacked
// from accumulators into A fragments, o = p v with v through ldmatrix.trans,
// o staged in shared memory for 16-byte stores. Backward: scores and p
// recomputed, dp = dO v^T, the row term and ds in registers, dq = ds k from
// register fragments; p and ds then go to shared memory once (bf16), and
// each warp forms 16 key rows of dk = ds^T q and dv = p^T dO through
// ldmatrix.trans. Softmax and every sum are fp32, outputs rounded once.
// Operands rounded to bf16 inside the kernel: the exponentials in o = p v
// and ds in dq, dk are split as hi + lo bf16 (two products, ~2^-16
// relative): on a saturated softmax (qkv x 8) one bf16 term takes dq and
// dk to 4.8x the bf16 bound and o to 0.74 of it, the split to 0.65 and
// 0.49 (devtools/train_kernel_rounding.py). p in dv = p^T dO is one bf16
// term. q, k, v and dO are the bf16 inputs themselves.
//
// fp32 stays exact fp32: the fp32 instantiation keeps the first design's FMA
// bodies unchanged (no tensor cores, no TF32). Its blocks of 256 threads
// stage fp32 rows of 32 with an odd stride and a 64 x 64 score tile with an
// odd stride; each row softmax (and its backward row sum) is one warp.
//
// Heads. Both designs give a block one (window, head): it stages that
// head's 32 channels of q, k, v (and dO) alone, so the shared memory of a
// block does not grow with the width. At dim 128 a window's qkv and dO are
// 64 x 512 values, 128 KB in fp32, and a block still holds one head's 64 x
// 128 of them. The kernels are instantiated per head count (HEADS = C /
// 32: 1, 2, 4); supported() refuses any other (C, heads).
#include <climits>
#include <cmath>

#include "common.cuh"
#include "mma.cuh"
#include "window_mhsa_mma.cuh"

namespace mstgan {
namespace {

using namespace mhsa;   // kWin, kTok, kHd, RS, TILE and the forward's MMA steps

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

// ---------------------------------------------------------------------------
// fp32: the FMA bodies
// ---------------------------------------------------------------------------

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

template <typename T, int HEADS>
__global__ void __launch_bounds__(kThreads)
mhsa_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int H, int W, float scale) {
  constexpr int kC = HEADS * kHd;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + ROWS;
  float* sV = sK + ROWS;
  float* sP = sV + ROWS;
  const long long win = blockIdx.x / HEADS;
  const int head = blockIdx.x % HEADS;
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

template <typename T, int HEADS>
__global__ void __launch_bounds__(kThreads)
mhsa_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ dout, T* __restrict__ dqkv,
                int H, int W, float scale) {
  constexpr int kC = HEADS * kHd;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + ROWS;
  float* sV = sK + ROWS;
  float* sDO = sV + ROWS;
  float* sP = sDO + ROWS;
  float* sDP = sP + SCORES;
  const long long win = blockIdx.x / HEADS;
  const int head = blockIdx.x % HEADS;
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

// ---------------------------------------------------------------------------
// bf16: warp MMA
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;          // 4 warps x 16 query rows
constexpr int QS = kTok + 8;              // 64-wide p / ds row: 144 bytes
constexpr int SQUARE = kTok * QS;         // one 64 x 64 tile
constexpr int MMA_F_BYTES = 3 * TILE * (int)sizeof(bf16);                 // q, k, v
constexpr int MMA_B_BYTES = (4 * TILE + 3 * SQUARE) * (int)sizeof(bf16);  // + dO, p, ds hi, lo

// Stages n 64 x 32 tiles of the window with 16-byte cp.async: tile i holds
// channels first + i * gap .. +31 of each token's row of `src` (row stride
// `stride` values) and lands at dst + i * TILE.
__device__ void stage_tiles(const bf16* __restrict__ src, int stride, int first, int gap, int n,
                            bf16* dst, long long win, int H, int W) {
  for (int e = threadIdx.x; e < kTok * n * 4; e += kMmaThreads) {
    const int t = e / (n * 4), i = (e / 4) % n, part = e % 4;
    cp_async16(dst + i * TILE + t * RS + part * 8,
               src + token_offset(win, t, H, W) * stride + first + i * gap + part * 8);
  }
}

// The inverse for the 16 token rows t0.. of one warp: staged tile i goes to
// channels first + i * gap of each token's row of `dst`.
__device__ void store_tiles(bf16* __restrict__ dst, int stride, int first, int gap, int n,
                            const bf16* src, int t0, long long win, int H, int W, int lane) {
  for (int e = lane; e < 16 * n * 4; e += 32) {
    const int t = t0 + e / (n * 4), i = (e / 4) % n, part = e % 4;
    *reinterpret_cast<uint4*>(dst + token_offset(win, t, H, W) * stride + first + i * gap +
                              part * 8) =
        *reinterpret_cast<const uint4*>(src + i * TILE + t * RS + part * 8);
  }
}

// acc (16 x 32: key rows k0..k0+15) += x^T y, x a [query][key] 64 x 64 tile
// in shared memory (hi, and lo when kSplit), y a staged [query][d] tile.
template <bool kSplit>
__device__ __forceinline__ void square_t_times_tile(float (&acc)[4][4], const bf16* xh,
                                                    const bf16* xl, const bf16* y, int k0,
                                                    int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t hi[4], lo[4];
    const int off = (kk * 16 + (lane & 7) + (lane >> 4) * 8) * QS + k0 + ((lane >> 3) & 1) * 8;
    ldmatrix_x4_trans(hi, xh + off);
    if (kSplit) ldmatrix_x4_trans(lo, xl + off);
#pragma unroll
    for (int dp = 0; dp < 2; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, y + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS + dp * 16 +
                               (lane >> 4) * 8);
      mma_bf16(acc[2 * dp], hi, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], hi, b[2], b[3]);
      if (kSplit) {
        mma_bf16(acc[2 * dp], lo, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], lo, b[2], b[3]);
      }
    }
  }
}

template <int HEADS>
__global__ void __launch_bounds__(kMmaThreads)
mhsa_fwd_mma_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int H, int W,
                    float scale) {
  constexpr int kC = HEADS * kHd;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_mma);   // q, k, v tiles back to back
  bf16* sK = sQ + TILE;
  bf16* sV = sK + TILE;
  const long long win = blockIdx.x / HEADS;
  const int head = blockIdx.x % HEADS;
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * 16;
  stage_tiles(qkv, 3 * kC, head * kHd, kC, 3, sQ, win, H, W);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qa[2][4];
  load_a(qa, sQ, r0, lane);
  float s[8][4];
  times_tile_t(s, qa, sK, lane);
  float l0, l1;
  exp_rows(s, scale, l0, l1);
  float o[4][4] = {};
  strip_times_tile<true>(o, s, sV, lane);
  l0 = 1.f / l0;
  l1 = 1.f / l1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    o[j][0] *= l0;
    o[j][1] *= l0;
    o[j][2] *= l1;
    o[j][3] *= l1;
  }
  // o through the warp's own q rows (read by no other warp) to 16-byte stores
  __syncwarp();
  store_frags<4>(sQ, nullptr, RS, r0, 0, o, 1.f, lane);
  __syncwarp();
  store_tiles(out, kC, head * kHd, kC, 1, sQ, r0, win, H, W, lane);
}

template <int HEADS>
__global__ void __launch_bounds__(kMmaThreads)
mhsa_bwd_mma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                    bf16* __restrict__ dqkv, int H, int W, float scale) {
  constexpr int kC = HEADS * kHd;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_mma);   // q, k, v, dO tiles back to back
  bf16* sK = sQ + TILE;
  bf16* sV = sK + TILE;
  bf16* sDO = sV + TILE;
  bf16* sP = sDO + TILE;                          // [query][key]: p, ds hi, ds lo
  bf16* sDH = sP + SQUARE;
  bf16* sDL = sDH + SQUARE;
  const long long win = blockIdx.x / HEADS;
  const int head = blockIdx.x % HEADS;
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * 16;
  stage_tiles(qkv, 3 * kC, head * kHd, kC, 3, sQ, win, H, W);
  stage_tiles(dout, kC, head * kHd, kC, 1, sDO, win, H, W);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // the warp's 16 query rows: p recomputed, dp = dO v^T, ds, dq = ds k
  uint32_t a[2][4];
  load_a(a, sQ, r0, lane);
  float p[8][4];
  times_tile_t(p, a, sK, lane);
  float l0, l1;
  exp_rows(p, scale, l0, l1);
  l0 = 1.f / l0;
  l1 = 1.f / l1;
  load_a(a, sDO, r0, lane);
  float ds[8][4];
  times_tile_t(ds, a, sV, lane);
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    p[j][0] *= l0;
    p[j][1] *= l0;
    p[j][2] *= l1;
    p[j][3] *= l1;
    rs0 += p[j][0] * ds[j][0] + p[j][1] * ds[j][1];
    rs1 += p[j][2] * ds[j][2] + p[j][3] * ds[j][3];
  }
  rs0 = quad_sum(rs0);
  rs1 = quad_sum(rs1);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    ds[j][0] = p[j][0] * (ds[j][0] - rs0);
    ds[j][1] = p[j][1] * (ds[j][1] - rs0);
    ds[j][2] = p[j][2] * (ds[j][2] - rs1);
    ds[j][3] = p[j][3] * (ds[j][3] - rs1);
  }
  float dq[4][4] = {};
  strip_times_tile<true>(dq, ds, sK, lane);
  store_frags<8>(sP, nullptr, QS, r0, 0, p, 1.f, lane);
  store_frags<8>(sDH, sDL, QS, r0, 0, ds, 1.f, lane);
  __syncthreads();

  // the warp's 16 key rows: dk = ds^T q, dv = p^T dO
  float dk[4][4] = {}, dv[4][4] = {};
  square_t_times_tile<true>(dk, sDH, sDL, sQ, r0, lane);
  square_t_times_tile<false>(dv, sP, nullptr, sDO, r0, lane);
  __syncthreads();
  store_frags<4>(sQ, nullptr, RS, r0, 0, dq, scale, lane);
  store_frags<4>(sK, nullptr, RS, r0, 0, dk, scale, lane);
  store_frags<4>(sV, nullptr, RS, r0, 0, dv, 1.f, lane);
  __syncwarp();
  store_tiles(dqkv, 3 * kC, head * kHd, kC, 3, sQ, r0, win, H, W, lane);
}

// ---------------------------------------------------------------------------

template <int HEADS>
int launch_fwd_f32(const void* qkv, void* out, long long grid, int H, int W, float scale,
                   cudaStream_t stream) {
  const int smem = F_TOTAL * (int)sizeof(float);
  auto kernel = mhsa_fwd_kernel<float, HEADS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(static_cast<const float*>(qkv),
                                                     static_cast<float*>(out), H, W, scale);
  return (int)cudaGetLastError();
}

template <int HEADS>
int launch_bwd_f32(const void* qkv, const void* dout, void* dqkv, long long grid, int H, int W,
                   float scale, cudaStream_t stream) {
  const int smem = B_TOTAL * (int)sizeof(float);
  auto kernel = mhsa_bwd_kernel<float, HEADS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(dout),
      static_cast<float*>(dqkv), H, W, scale);
  return (int)cudaGetLastError();
}

template <int HEADS>
int launch_fwd_bf16(const void* qkv, void* out, long long grid, int H, int W, float scale,
                    cudaStream_t stream) {
  auto kernel = mhsa_fwd_mma_kernel<HEADS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_F_BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)grid, kMmaThreads, MMA_F_BYTES, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), H, W, scale);
  return (int)cudaGetLastError();
}

template <int HEADS>
int launch_bwd_bf16(const void* qkv, const void* dout, void* dqkv, long long grid, int H, int W,
                    float scale, cudaStream_t stream) {
  auto kernel = mhsa_bwd_mma_kernel<HEADS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_B_BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)grid, kMmaThreads, MMA_B_BYTES, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout), static_cast<bf16*>(dqkv),
      H, W, scale);
  return (int)cudaGetLastError();
}

// The blocks of the c8, c16 and c32 generators: C = 32 heads, heads of 32.
bool supported(int H, int W, int C, int heads) {
  return (heads == 1 || heads == 2 || heads == 4) && C == heads * kHd && H % kWin == 0 &&
         W % kWin == 0;
}

// One block per (window, head).
long long grid_size(int B, int H, int W, int heads) {
  return (long long)B * (H / kWin) * (W / kWin) * heads;
}

int fwd(const void* qkv, void* out, long long grid, int H, int W, int heads, int dtype,
        cudaStream_t s) {
  const float scale = 1.f / sqrtf((float)kHd);
  const bool f32 = dtype == kF32;
  if (!f32 && dtype != kBF16) return (int)cudaErrorInvalidValue;
  switch (heads) {
    case 1: return f32 ? launch_fwd_f32<1>(qkv, out, grid, H, W, scale, s)
                       : launch_fwd_bf16<1>(qkv, out, grid, H, W, scale, s);
    case 2: return f32 ? launch_fwd_f32<2>(qkv, out, grid, H, W, scale, s)
                       : launch_fwd_bf16<2>(qkv, out, grid, H, W, scale, s);
    case 4: return f32 ? launch_fwd_f32<4>(qkv, out, grid, H, W, scale, s)
                       : launch_fwd_bf16<4>(qkv, out, grid, H, W, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int bwd(const void* qkv, const void* dout, void* dqkv, long long grid, int H, int W, int heads,
        int dtype, cudaStream_t s) {
  const float scale = 1.f / sqrtf((float)kHd);
  const bool f32 = dtype == kF32;
  if (!f32 && dtype != kBF16) return (int)cudaErrorInvalidValue;
  switch (heads) {
    case 1: return f32 ? launch_bwd_f32<1>(qkv, dout, dqkv, grid, H, W, scale, s)
                       : launch_bwd_bf16<1>(qkv, dout, dqkv, grid, H, W, scale, s);
    case 2: return f32 ? launch_bwd_f32<2>(qkv, dout, dqkv, grid, H, W, scale, s)
                       : launch_bwd_bf16<2>(qkv, dout, dqkv, grid, H, W, scale, s);
    case 4: return f32 ? launch_bwd_f32<4>(qkv, dout, dqkv, grid, H, W, scale, s)
                       : launch_bwd_bf16<4>(qkv, dout, dqkv, grid, H, W, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace mstgan

// Plain C entry points (loaded with ctypes). qkv and dqkv are (B, H, W, 3C),
// out and dout (B, H, W, C), all contiguous and 16-byte aligned, of one type
// (dtype 0 = fp32, 1 = bf16), with C = 32 heads in 1, 2 or 4 heads and H % 8
// == W % 8 == 0. Each launches on `stream` and returns cudaGetLastError()
// (0 on success); another (C, heads) returns cudaErrorInvalidValue.
extern "C" int window_mhsa_train_fwd_launch(const void* qkv, void* out, int B, int H, int W,
                                            int C, int heads, int dtype, int device,
                                            void* stream) {
  if (!mstgan::supported(H, W, C, heads)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long grid = mstgan::grid_size(B, H, W, heads);
  if (grid > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  return mstgan::fwd(qkv, out, grid, H, W, heads, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int window_mhsa_train_bwd_launch(const void* qkv, const void* dout, void* dqkv,
                                            int B, int H, int W, int C, int heads, int dtype,
                                            int device, void* stream) {
  if (!mstgan::supported(H, W, C, heads)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long grid = mstgan::grid_size(B, H, W, heads);
  if (grid > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  return mstgan::bwd(qkv, dout, dqkv, grid, H, W, heads, dtype,
                     static_cast<cudaStream_t>(stream));
}
