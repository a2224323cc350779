// The windowed channel attention past C = 512 (the LocalAttention widths 2C
// and 4C of every generator from c129 on: 516 .. 1024 up to c256, 2048 at
// c512), for Hopper (sm_90a): the op of window_channel_attention.cuh,
// streamed over channels through a workspace, since no shared-memory layout
// of one window fits past C = 512 (the C = 512 layout already takes 208 KB).
//
// Per chunk of `ws_windows` windows (the caller's fp32 workspace holds q, k
// and v as rows of 3C and the attention output as rows of C for each of a
// window's 16 positions: 256 C bytes a window), four launches:
//   qkv   stream::gemm: the windows' positions gathered from x (NHWC or
//         packed rows) times Wqkv^T, + bqkv, into the workspace (fp32);
//   norms + Gram + softmax + apply (attention_mid_*_kernel): a block per
//         window and strip of query channels (128 in bf16, 64 in fp32). It
//         first takes the inverse L2 norms of the window's 16 q rows and 16
//         k rows (a warp a row, 1 / max(|u|, eps), so a zero vector stays
//         zero: the zero-safe normalize), then stages its strip of qn and
//         passes over the keys in chunks of 64 channels (kn and v staged):
//         the scores, their exponentials at the fixed shift 16 and at once
//         the apply out[p][c1] += sum_c2 v[p][c2] e[c1][c2], the row sums
//         kept beside; out / row sum into the workspace. qn and kn are unit
//         vectors (or zero) at each of 16 positions, so every logit lies in
//         [-16, 16] and exp(g - 16) >= exp(-32) stays a normal fp32 value:
//         no running max or rescale over any number of key chunks (the C =
//         256 and 512 layouts' rule);
//   proj  stream::gemm: the workspace's output rows times Wproj^T, + bproj,
//         scattered back to the windows' positions of y in y's type.
// The L2 norm is taken where its rows are read (the mid), not in the qkv
// product's epilogue: a product's block holds 64 of the 3C columns of a
// row, so its epilogue could only leave partial sums for a later pass.
//
// Operands rounded to bf16 inside (bf16): x and the weights are the bf16
// inputs themselves; q, k and v stay fp32 in the workspace and qn, kn, v,
// the exponentials and the output enter their products as hi + lo pairs
// (the plan of the C = 256 and 512 layouts, with q and k unrounded before
// the norm; devtools/serving_kernel_rounding.py --past128). fp32 stays exact
// fp32: every product an FMA on the CUDA cores, no TF32.
#pragma once

#include "stream.cuh"
#include "window_channel_attention.cuh"

namespace mstgan {
namespace {

constexpr int kMidThreads = 256;
constexpr int kMidStrips = kMidThreads / 32;      // bf16: a warp a strip of 16 query channels
constexpr int kMidQ = 16 * kMidStrips;            // bf16: query channels a block (128)
constexpr int kMidQS = kMidQ + 8;                 // qn strip rows: 272 bytes
constexpr int kMidKS = 64 + 8;                    // kn and v chunk rows: 144 bytes
constexpr int kMidQF = 64;                        // fp32: query channels a block

// Inverse norms of the 16 q rows (sInv[0..15]) and 16 k rows (sInv[16..31])
// of the window whose rows start at `base` (rows of 3C floats): a warp a row.
__device__ __forceinline__ void qk_inverse_norms(const float* __restrict__ base, int C, float eps,
                                                 float* sInv) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int v = warp; v < 2 * kP; v += kMidThreads / 32) {
    const float* row = base + (long long)(v % kP) * 3 * C + (v / kP) * C;
    float ss = 0.f;
    for (int c = lane; c < C; c += 32) ss = fmaf(row[c], row[c], ss);
    ss = warp_sum(ss);
    if (lane == 0) sInv[v] = 1.f / fmaxf(sqrtf(ss), eps);
  }
}

// bf16: 8 warps, a strip of 16 query channels c1 = c0 + 16 warp .. each.
__global__ void __launch_bounds__(kMidThreads)
attention_mid_mma_kernel(const float* __restrict__ qkv, float* __restrict__ out, int C,
                         float eps) {
  __shared__ __align__(16) bf16 sQh[kP * kMidQS], sQl[kP * kMidQS];
  __shared__ __align__(16) bf16 sKh[kP * kMidKS], sKl[kP * kMidKS];
  __shared__ __align__(16) bf16 sVh[kP * kMidKS], sVl[kP * kMidKS];
  __shared__ float sInv[2 * kP];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const long long win = blockIdx.x;
  const int c0 = blockIdx.y * kMidQ;
  const float* base = qkv + win * kP * 3 * C;
  qk_inverse_norms(base, C, eps, sInv);
  __syncthreads();
  // the block's strip of qn: 16 positions x 128 channels, hi + lo
  for (int e = tid; e < kP * kMidQ / 2; e += kMidThreads) {
    const int p = e / (kMidQ / 2), c = (e % (kMidQ / 2)) * 2, ch = c0 + c;
    const float* row = base + (long long)p * 3 * C;
    const float a = ch < C ? row[ch] * sInv[p] : 0.f;
    const float b = ch + 1 < C ? row[ch + 1] * sInv[p] : 0.f;
    pack_bf16_split(a, b, *reinterpret_cast<uint32_t*>(sQh + p * kMidQS + c),
                    *reinterpret_cast<uint32_t*>(sQl + p * kMidQS + c));
  }
  const int s = warp;   // the warp's strip in the block
  const bool live = c0 + 16 * s < C;
  uint32_t ah[4], al[4];
  float o[2][4] = {};
  float l0 = 0.f, l1 = 0.f;   // the row sums of strip rows g and g + 8
  const int chunks = (C + 63) / 64;
#pragma unroll 1
  for (int kc = 0; kc < chunks; ++kc) {
    __syncthreads();   // the strip is staged; every warp is done with the last chunk
    for (int e = tid; e < kP * 32; e += kMidThreads) {   // kn and v: 16 x 64, hi + lo
      const int p = e / 32, c = (e % 32) * 2, ch = kc * 64 + c;
      const float* row = base + (long long)p * 3 * C;
      const float k0 = ch < C ? row[C + ch] * sInv[kP + p] : 0.f;
      const float k1 = ch + 1 < C ? row[C + ch + 1] * sInv[kP + p] : 0.f;
      const float v0 = ch < C ? row[2 * C + ch] : 0.f;
      const float v1 = ch + 1 < C ? row[2 * C + ch + 1] : 0.f;
      pack_bf16_split(k0, k1, *reinterpret_cast<uint32_t*>(sKh + p * kMidKS + c),
                      *reinterpret_cast<uint32_t*>(sKl + p * kMidKS + c));
      pack_bf16_split(v0, v1, *reinterpret_cast<uint32_t*>(sVh + p * kMidKS + c),
                      *reinterpret_cast<uint32_t*>(sVl + p * kMidKS + c));
    }
    __syncthreads();
    if (!live) continue;
    if (kc == 0) {   // A[c1][p] = qn[p][c1] through ldmatrix.trans
      const int aoff = ((lane & 7) + (lane >> 4) * 8) * kMidQS + s * 16 + ((lane >> 3) & 1) * 8;
      ldmatrix_x4_trans(ah, sQh + aoff);
      ldmatrix_x4_trans(al, sQl + aoff);
    }
    float e[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j][0] = e[j][1] = e[j][2] = e[j][3] = 0.f;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int boff = ((lane & 7) + ((lane >> 3) & 1) * 8) * kMidKS + nb * 16 + (lane >> 4) * 8;
      uint32_t bh[4], bl[4];
      ldmatrix_x4_trans(bh, sKh + boff);
      ldmatrix_x4_trans(bl, sKl + boff);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mma_bf16(e[2 * nb + h], ah, bh[2 * h], bh[2 * h + 1]);
        mma_bf16(e[2 * nb + h], ah, bl[2 * h], bl[2 * h + 1]);
        mma_bf16(e[2 * nb + h], al, bh[2 * h], bh[2 * h + 1]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = kc * 64 + j * 8 + 2 * tq;   // a pad key's exponential is 0
#pragma unroll
      for (int i = 0; i < 4; ++i) e[j][i] = key + (i & 1) < C ? __expf(e[j][i] - 16.f) : 0.f;
      l0 += e[j][0] + e[j][1];
      l1 += e[j][2] + e[j][3];
    }
    // out[p][c1] += v[p][c2] e[c1][c2] over the chunk's 64 keys: e's C
    // fragments are the B fragments (B[k][n] = e[n][k])
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t va[4], vb[4];
      const int voff = (lane & 15) * kMidKS + kk * 16 + (lane >> 4) * 8;
      ldmatrix_x4(va, sVh + voff);
      ldmatrix_x4(vb, sVl + voff);
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
  if (!live) return;
  // column c1 = 8 h + 2 tq + i of o is row c1 of the strip, whose sum lanes
  // 4 (2 tq + i) hold (l0 for h = 0, l1 for h = 1)
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  float* orow = out + win * kP * C;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float r0 = 1.f / __shfl_sync(0xffffffffu, l0, 4 * (2 * tq + i));
    const float r1 = 1.f / __shfl_sync(0xffffffffu, l1, 4 * (2 * tq + i));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c1 = c0 + 16 * s + 8 * h + 2 * tq + i;
      const float r = h ? r1 : r0;
      if (c1 < C) {
        orow[(long long)g * C + c1] = o[h][i] * r;
        orow[(long long)(g + 8) * C + c1] = o[h][i + 2] * r;
      }
    }
  }
}

// fp32: 256 threads over 64 query channels c1 = c0 ..; the scores of a key
// chunk a thread's 16 (c1 = tid / 4, keys 16 (tid % 4) ..), the apply four
// outputs a thread (c1 = c0 + tid % 64 at positions tid / 64 + 4 i).
__global__ void __launch_bounds__(kMidThreads)
attention_mid_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out, int C,
                         float eps) {
  __shared__ float sQ[kP][kMidQF + 1], sK[kP][65], sV[kP][65], sE[kMidQF][65];
  __shared__ float sInv[2 * kP], sL[kMidQF];
  const int tid = threadIdx.x;
  const long long win = blockIdx.x;
  const int c0 = blockIdx.y * kMidQF;
  const float* base = qkv + win * kP * 3 * C;
  qk_inverse_norms(base, C, eps, sInv);
  __syncthreads();
  for (int e = tid; e < kP * kMidQF; e += kMidThreads) {
    const int p = e / kMidQF, c = e % kMidQF;
    sQ[p][c] = c0 + c < C ? base[(long long)p * 3 * C + c0 + c] * sInv[p] : 0.f;
  }
  const int c1 = tid / 4, kq = (tid % 4) * 16;   // scores
  const int ca = tid % kMidQF, pa = tid / kMidQF;  // apply
  float lsum = 0.f, acc[4] = {};
  const int chunks = (C + 63) / 64;
#pragma unroll 1
  for (int kc = 0; kc < chunks; ++kc) {
    __syncthreads();
    for (int e = tid; e < kP * 64; e += kMidThreads) {
      const int p = e / 64, c = e % 64, ch = kc * 64 + c;
      const float* row = base + (long long)p * 3 * C;
      sK[p][c] = ch < C ? row[C + ch] * sInv[kP + p] : 0.f;
      sV[p][c] = ch < C ? row[2 * C + ch] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < 16; ++j) {
      float gsum = 0.f;
#pragma unroll
      for (int p = 0; p < kP; ++p) gsum = fmaf(sQ[p][c1], sK[p][kq + j], gsum);
      const float e = kc * 64 + kq + j < C ? expf(gsum - 16.f) : 0.f;
      sE[c1][kq + j] = e;
      lsum += e;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = pa + 4 * i;
#pragma unroll 8
      for (int c2 = 0; c2 < 64; ++c2) acc[i] = fmaf(sE[ca][c2], sV[p][c2], acc[i]);
    }
  }
  lsum = quad_sum(lsum);   // the four threads of row c1 are one quad
  if (tid % 4 == 0) sL[c1] = lsum;
  __syncthreads();
  if (c0 + ca < C)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      out[(win * kP + pa + 4 * i) * C + c0 + ca] = acc[i] / sL[ca];
}

// A: the 16 positions of windows w0 .. gathered from x (NHWC or packed
// rows of C values), row r = 16 (window - w0) + position; zeros past the
// last window.
template <typename T, bool kPacked>
struct WindowRowsA {
  const T* x;
  int H, W, C;
  long long w0, n_windows;
  bool vec;
  __device__ void operator()(int r, int k, float (&v)[8]) const {
    const long long win = w0 + r / kP;
    if (win >= n_windows) {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.f;
      return;
    }
    stream::load8(x + pixel_offset<kPacked>(win, r % kP, H, W) * C, k, C, vec, v);
  }
};

// y at the windows' positions: out + bproj in y's type.
template <typename T, bool kPacked>
struct WindowRowsStore {
  T* y;
  const T* bias;
  int H, W, C;
  long long w0, n_windows;
  __device__ void operator()(int r, int n, float v) const {
    const long long win = w0 + r / kP;
    if (win < n_windows)
      y[pixel_offset<kPacked>(win, r % kP, H, W) * C + n] = from_f<T>(v + to_f(bias[n]));
  }
};

// The op at C > 512 on n_windows windows, ws_windows a chunk.
template <typename T, bool kPacked>
int launch_streamed(const void* x, const void* wqkv, const void* bqkv, const void* wproj,
                    const void* bproj, void* y, int H, int W, long long n_windows, int C,
                    float eps, float* ws, int ws_windows, cudaStream_t s) {
  constexpr bool kFloat = sizeof(T) == sizeof(float);
  if (ws == nullptr || ws_windows < 1 || (long long)ws_windows * kP * 3 * C > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const T* tx = static_cast<const T*>(x);
  const T* wq = static_cast<const T*>(wqkv);
  const T* wp = static_cast<const T*>(wproj);
  float* qkv = ws;
  float* attn = ws + (long long)ws_windows * kP * 3 * C;
  const bool xvec = C % (kFloat ? 4 : 8) == 0 && stream::aligned16(tx);
  for (long long w0 = 0; w0 < n_windows; w0 += ws_windows) {
    const int n = (int)(n_windows - w0 < ws_windows ? n_windows - w0 : ws_windows);
    const int M = n * kP;
    int rc = stream::gemm<1>(WindowRowsA<T, kPacked>{tx, H, W, C, w0, n_windows, xvec}, wq,
                                 M, 3 * C, C,
                                 stream::StoreRows<T>{qkv, 3 * C, static_cast<const T*>(bqkv)},
                                 s);
    if (rc) return rc;
    const dim3 grid((unsigned)n, (C + (kFloat ? kMidQF : kMidQ) - 1) / (kFloat ? kMidQF : kMidQ));
    if constexpr (kFloat) attention_mid_f32_kernel<<<grid, kMidThreads, 0, s>>>(qkv, attn, C, eps);
    else attention_mid_mma_kernel<<<grid, kMidThreads, 0, s>>>(qkv, attn, C, eps);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
    rc = stream::gemm<2>(
        stream::RowsA<float>{attn, C, M, C, C % 4 == 0},
        wp, M, C, C,
        WindowRowsStore<T, kPacked>{static_cast<T*>(y), static_cast<const T*>(bproj), H, W, C, w0,
                                    n_windows},
        s);
    if (rc) return rc;
  }
  return 0;
}

template <bool kPacked>
int launch_streamed_dtype(const void* x, const void* wqkv, const void* bqkv, const void* wproj,
                          const void* bproj, void* y, int H, int W, long long n_windows, int C,
                          int dtype, float eps, void* ws, int ws_windows, int device,
                          void* stream) {
  if (n_windows <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (dtype == kF32)
    return launch_streamed<float, kPacked>(x, wqkv, bqkv, wproj, bproj, y, H, W, n_windows, C,
                                           eps, w, ws_windows, s);
  if (dtype == kBF16)
    return launch_streamed<__nv_bfloat16, kPacked>(x, wqkv, bqkv, wproj, bproj, y, H, W,
                                                   n_windows, C, eps, w, ws_windows, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace mstgan
