// Streaming building blocks for the widths whose window outgrows one
// block's shared memory: a tiled matrix product whose rows are gathered and
// whose outputs are handed to an epilogue, for Hopper (sm_90a). The channel
// attention past C = 512 (window_channel_attention_stream.cuh) and the
// structural block past dim 512 or with heads wider than 64
// (fused_structural_block_stream.cu) run as chains of these products and a
// few kernels of their own through a device workspace, instead of one
// kernel that holds a window.
//
//   out[r][n] = sum_k A[r][k] W[n][k]      (r < M, n < N, k < K)
//
// handed to epi(r, n, value). W is a weight in the PyTorch (out, in) layout,
// rows of K values. A is read through a loader, a(r, k, v), which fills
// v[0..7] with A[r][k..k+7] as fp32, zeros past M and K: rows of a
// workspace, or the positions of windows gathered from an activation.
//
// bf16 (gemm_mma_kernel): blocks of 4 warps own a 64 x 64 tile of out, each
// warp 16 rows x 64 columns (8 n-tiles of mma.sync.m16n8k16, bf16 in, fp32
// sums; csrc/mma.cuh); k passes in steps of 32, A and W staged in shared
// memory in rows of 40 values (80 bytes, an odd multiple of 16: ldmatrix
// free of bank conflicts). A that the chain formed in fp32 enters as kTerms
// bf16 terms: a hi + lo pair (hi = bf16(a), lo = bf16(a - hi): two
// products, ~2^-16 relative) or three (hi, mid = bf16(a - hi), lo =
// bf16(a - hi - mid): ~2^-24, where the products feed a saturated softmax);
// A read from a bf16 activation as the one term it is; W is bf16 as stored.
// The tensor cores' fp32 sums do not round to nearest, and over the
// thousands of k of a wide dim their error adds up one way: each k-step of
// 32 is summed into fresh fragments and added to the running sums with
// ordinary (round-to-nearest) fp32 adds, so the bias a sum carries is that
// of two MMA steps, not of K / 16 (with the sums kept in the fragments a
// saturated block at dims 2032 and 2048 left the bf16 bound: max |d| 1.0
// in chip_smoke.py's past-128 block check).
// fp32 (gemm_fma_kernel): blocks of 256 threads own a 64 x 64 tile, each
// thread 4 x 4 sums in fp32 FMAs, k in steps of 32 staged in shared memory;
// no tensor cores, no TF32.
// Neither is a fast design: both are the simple form of a product whose
// operands never fit one block, and what bounds them is the staging
// through registers, not the tensor cores (PERF.md section 6).
#pragma once

#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace mstgan {
namespace stream {

using bf16 = __nv_bfloat16;

constexpr int BM = 64, BN = 64, BK = 32;   // a block's tile of out, the k-step of the staging
constexpr int TS = BK + 8;                 // staged rows: 40 values, 80 bytes
constexpr int kMmaThreads = 128;           // bf16: 4 warps x 16 rows
constexpr int kFmaThreads = 256;           // fp32: 16 x 16 threads, 4 x 4 sums each

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// Eight values of a row of `n` values starting at `p` from column k (zeros
// from n on); 16 (bf16) or 32 (fp32) bytes at a time where `vec` says the
// row and k allow it.
__device__ __forceinline__ void load8(const bf16* __restrict__ p, int k, int n, bool vec,
                                      float (&v)[8]) {
  if (vec && k + 8 <= n) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p + k));
    const bf16* b = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(b[i]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = k + i < n ? __bfloat162float(p[k + i]) : 0.f;
}
__device__ __forceinline__ void load8(const float* __restrict__ p, int k, int n, bool vec,
                                      float (&v)[8]) {
  if (vec && k + 8 <= n) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p + k));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p + k + 4));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = k + i < n ? p[k + i] : 0.f;
}

// A as rows of a (M, K) array with row stride ld (a workspace).
template <typename T>
struct RowsA {
  const T* p;
  int ld, M, K;
  bool vec;   // ld and the base allow 16-byte (bf16) or 32-byte (fp32) loads
  __device__ void operator()(int r, int k, float (&v)[8]) const {
    if (r >= M) {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.f;
      return;
    }
    load8(p + (long long)r * ld, k, K, vec, v);
  }
};

// out[r][n] + bias[n] into rows of a workspace (row stride ld); with kGelu
// through the erf GELU first, with kAdd added onto what is there.
template <typename T, bool kGelu = false, bool kAdd = false>
struct StoreRows {
  float* p;
  int ld;
  const T* bias;
  __device__ void operator()(int r, int n, float v) const {
    v += to_f(bias[n]);
    if (kGelu) v = gelu_erf(v);
    float* d = p + (long long)r * ld + n;
    *d = kAdd ? *d + v : v;
  }
};

template <typename T>
__host__ __device__ inline bool aligned16(const T* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int kTerms, typename A, typename Epi>
__global__ void __launch_bounds__(kMmaThreads)
gemm_mma_kernel(A a, const bf16* __restrict__ w, int M, int N, int K, bool wvec, Epi epi) {
  static_assert(kTerms >= 1 && kTerms <= 3, "one, two or three bf16 terms of A");
  __shared__ __align__(16) bf16 sA[kTerms][BM * TS];   // A's terms: hi, (mid,) lo
  __shared__ __align__(16) bf16 sB[BN * TS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float acc[8][4] = {};
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += BK) {
    // 64 rows x 32 of A and of W, eight values a thread at a time
    for (int e = tid; e < BM * BK / 8; e += kMmaThreads) {
      const int r = e / (BK / 8), c = (e % (BK / 8)) * 8;
      float v[8];
      a(m0 + r, k0 + c, v);
#pragma unroll
      for (int term = 0; term < kTerms; ++term) {
        uint32_t* d = reinterpret_cast<uint32_t*>(sA[term] + r * TS + c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          d[i] = pack_bf16(v[2 * i], v[2 * i + 1]);
          if (term + 1 < kTerms) {   // what is left for the next term
            const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&d[i]));
            v[2 * i] -= f.x;
            v[2 * i + 1] -= f.y;
          }
        }
      }
    }
    for (int e = tid; e < BN * BK / 8; e += kMmaThreads) {
      const int r = e / (BK / 8), c = (e % (BK / 8)) * 8, n = n0 + r, k = k0 + c;
      bf16* d = sB + r * TS + c;
      if (wvec && n < N && k + 8 <= K) {
        *reinterpret_cast<uint4*>(d) =
            __ldg(reinterpret_cast<const uint4*>(w + (long long)n * K + k));
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          d[i] = n < N && k + i < K ? w[(long long)n * K + k + i] : __float2bfloat16(0.f);
      }
    }
    __syncthreads();
    float part[8][4] = {};   // this k-step's sums
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t at[kTerms][4];
      const int aoff = (warp * 16 + (lane & 15)) * TS + kk * 16 + (lane >> 4) * 8;
#pragma unroll
      for (int term = 0; term < kTerms; ++term) ldmatrix_x4(at[term], sA[term] + aoff);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        uint32_t b[4];
        ldmatrix_x4(b, sB + (nb * 16 + (lane & 7) + (lane >> 4) * 8) * TS + kk * 16 +
                           ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int term = kTerms - 1; term >= 0; --term) {   // the small terms first
          mma_bf16(part[2 * nb], at[term], b[0], b[1]);
          mma_bf16(part[2 * nb + 1], at[term], b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] += part[j][i];
    __syncthreads();
  }
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + warp * 16 + g + 8 * h, n = n0 + j * 8 + 2 * tq;
      if (r >= M) continue;
      if (n < N) epi(r, n, acc[j][2 * h]);
      if (n + 1 < N) epi(r, n + 1, acc[j][2 * h + 1]);
    }
}

template <typename A, typename Epi>
__global__ void __launch_bounds__(kFmaThreads)
gemm_fma_kernel(A a, const float* __restrict__ w, int M, int N, int K, bool wvec, Epi epi) {
  __shared__ float sA[BK][BM + 1];   // [k][row]
  __shared__ float sB[BK][BN + 1];   // [k][n]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float acc[4][4] = {};
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += BK) {
    {   // one run of 8 values of A and one of W a thread
      const int r = tid / (BK / 8), c = (tid % (BK / 8)) * 8;
      float v[8];
      a(m0 + r, k0 + c, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) sA[c + i][r] = v[i];
      const int n = n0 + r;
      if (n < N) load8(w + (long long)n * K, k0 + c, K, wvec, v);
      else
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) sB[c + i][r] = v[i];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = sA[kk][ty + 16 * i];
        bv[i] = sB[kk][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (r < M && n < N) epi(r, n, acc[i][j]);
    }
}

// out = A W^T handed to epi, on `stream`: the bf16 kernel (A in kTerms
// bf16 terms) for bf16 weights, the fp32 one for fp32 weights. Returns a
// CUDA error code, 0 on success.
template <int kTerms, typename A, typename Epi>
int gemm(A a, const bf16* w, int M, int N, int K, Epi epi, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  gemm_mma_kernel<kTerms><<<grid, kMmaThreads, 0, stream>>>(a, w, M, N, K,
                                                            K % 8 == 0 && aligned16(w), epi);
  return (int)cudaGetLastError();
}
template <int kTerms, typename A, typename Epi>
int gemm(A a, const float* w, int M, int N, int K, Epi epi, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  gemm_fma_kernel<<<grid, kFmaThreads, 0, stream>>>(a, w, M, N, K, K % 4 == 0 && aligned16(w),
                                                    epi);
  return (int)cudaGetLastError();
}

}  // namespace stream
}  // namespace mstgan
