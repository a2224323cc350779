// Fused StructuralTransformerBlock body, inference forward, for Hopper
// (sm_90a), in bf16 at the dims no one-window design holds: past dim 512
// (c129's 516 .. c512's 2048) and at any dim whose default_num_heads heads
// are wider than 64 channels (16 heads of 67 at c268's dim 1072, of 127 at
// c508's 2032). Replaces ops/pallas/fused_transformer.py::
// fused_structural_block of the JAX package at those dims, as
// fused_structural_block.cu and fused_structural_block_pair.cu do below
// them; the fp32 body at every such dim is fused_structural_block.cu's FMA
// bodies with their workspace.
//
// At dim 1024 a window's fp32 residual stream alone is 64 x 1024 x 4 =
// 256 KB, the whole register file of an SM, and its weights (12 C^2 bf16
// values, 25 MB) pass through every window. So the block streams: the
// window's residual stream, LN output, qkv and MLP hidden rows live in an
// fp32 workspace (window-major rows: row 64 w + t is token t of window w of
// the chunk, tokens outside a ragged grid included) and the body is a chain
// of launches over a chunk of `ws_windows` windows:
//   LN1 + FiLM    block_ln_kernel<kFirst>: x + struct gathered, a warp a
//                 token, LayerNorm over the C channels in fp32, (1 + gamma)
//                 and beta; x kept as the residual stream; a token outside
//                 the grid as zeros
//   qkv           stream::gemm (csrc/stream.cuh), LN1's output in three
//                 bf16 terms
//   MHSA          block_mhsa_kernel: a block a (window, head), the head in
//                 chunks of 32 channels (any width), the scores, the softmax
//                 and p v in fp32 FMAs from the workspace, keys outside the
//                 grid at -inf; the output over LN1's rows
//   proj          stream::gemm added onto the residual stream
//   LN2           block_ln_kernel<!kFirst>
//   fc1 + GELU    stream::gemm, the erf GELU in the epilogue, rows of 4C
//   fc2           stream::gemm: residual + fc2 + bias to y (bf16) at the
//                 tokens inside the grid.
// The four weight products are warp MMA (bf16 in, fp32 sums), every operand
// the chain forms in fp32 entered as a hi + lo pair, the plan of the dim-256
// and pair designs, but for LN1's output, which enters the qkv product in
// three terms; q and k then meet in fp32. At dim 2032 and 2048 a block whose
// scores are 16 times larger (chip_smoke.block_stress_inputs) leaves the
// output at 2.49 and 1.60 of the bf16 bound with every operand a pair, at
// 0.94 with this plan (devtools/serving_kernel_rounding.py --past128); the
// MHSA is 2 x 64 x 64 x C FMAs a window against the products' 24 x 64 x
// C^2, so fp32 costs it little. Tokens
// outside a ragged grid run through the products and are never stored; as
// keys they are out of every softmax, which is what the reference's
// zero-pad-and-mask formulation computes.
//
// What bounds it: about 24 C^2 flop a token (1100 flop per byte of bf16
// traffic at C = 1024), so the products, not the bytes; the chain moves the
// workspace rows through L2 between launches, which one fused window never
// did, and its products stage operands through registers (stream.cuh): a
// simple design that is right, whose time PERF.md records.
#include <climits>
#include <cmath>

#include "common.cuh"
#include "mma.cuh"
#include "stream.cuh"

namespace mstgan {
namespace {

using bf16 = __nv_bfloat16;
constexpr int kWin = 8;
constexpr int kTok = kWin * kWin;
constexpr int kLnThreads = 256;   // a warp a token row

// models/structural_transformer.py::default_num_heads
int default_num_heads(int dim) {
  int h = dim / 32 > 1 ? dim / 32 : 1;
  while (dim % h) --h;
  return h;
}

// Where token t of window `win` (numbered (b, window row, window column)
// over a grid of ceil(H / 8) x ceil(W / 8) windows an image) lies.
struct Token {
  long long off;   // its pixel's offset, in units of C values
  int b;
  bool valid;      // inside the H x W grid
};
__device__ __forceinline__ Token token_of(long long win, int t, int H, int W) {
  const int nwx = (W + kWin - 1) / kWin, nwy = (H + kWin - 1) / kWin;
  const long long per_image = (long long)nwx * nwy;
  const int b = (int)(win / per_image);
  const int rem = (int)(win - b * per_image);
  const int row = (rem / nwx) * kWin + t / kWin, col = (rem % nwx) * kWin + t % kWin;
  return {((long long)b * H + row) * W + col, b, row < H && col < W};
}

// kFirst: LN1 of x + struct with the FiLM into h, x into the residual rows;
// else LN2 of the residual rows into h. Rows of C fp32 values.
template <bool kFirst>
__global__ void __launch_bounds__(kLnThreads)
block_ln_kernel(const bf16* __restrict__ x, const bf16* __restrict__ st,
                const float* __restrict__ gamma, const float* __restrict__ beta,
                const bf16* __restrict__ w, const bf16* __restrict__ b, float* __restrict__ xs,
                float* __restrict__ hs, int H, int W, int C, long long w0, int rows, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = blockIdx.x * (kLnThreads / 32) + warp;
  if (r >= rows) return;
  float* xr = xs + (long long)r * C;
  float* hr = hs + (long long)r * C;
  const bf16 *px = nullptr, *ps = nullptr;
  const float *pg = nullptr, *pb = nullptr;
  if constexpr (kFirst) {
    const Token tok = token_of(w0 + r / kTok, r % kTok, H, W);
    if (!tok.valid) {
      for (int c = lane; c < C; c += 32) xr[c] = hr[c] = 0.f;
      return;
    }
    px = x + tok.off * C;
    ps = st + tok.off * C;
    pg = gamma + (long long)tok.b * C;
    pb = beta + (long long)tok.b * C;
  }
  auto in = [&](int c) {
    if constexpr (kFirst) return __bfloat162float(px[c]) + __bfloat162float(ps[c]);
    else return xr[c];
  };
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += in(c);
  const float mean = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = in(c) - mean;
    v = fmaf(d, d, v);
  }
  const float rstd = 1.f / sqrtf(warp_sum(v) / C + eps);
  for (int c = lane; c < C; c += 32) {
    float o = (in(c) - mean) * rstd * __bfloat162float(w[c]) + __bfloat162float(b[c]);
    if constexpr (kFirst) {
      o = o * (1.f + pg[c]) + pb[c];
      xr[c] = __bfloat162float(px[c]);
    }
    hr[c] = o;
  }
}

constexpr int kMhsaThreads = 256;
constexpr int kMhsaChunk = 32;   // head channels a pass

// The MHSA of window `win` of the chunk (blockIdx.x / heads) and head
// blockIdx.x % heads on the workspace's q | k | v rows of 3C: each thread
// owns 16 scores of query row tid / 4 (keys 16 (tid % 4) ..), summed over
// the head's chunks of 32 channels; keys outside the grid at -inf, the
// softmax at scale 1/sqrt(hd) across the row's quad; then o = p v a chunk
// at a time, 8 channels of query row tid / 4 a thread, over LN1's rows.
__global__ void __launch_bounds__(kMhsaThreads)
block_mhsa_kernel(const float* __restrict__ qkv, float* __restrict__ o, int H, int W,
                  long long w0, int C, int heads, float scale) {
  __shared__ float sA[kTok][kMhsaChunk + 1], sB[kTok][kMhsaChunk + 1];
  __shared__ float sP[kTok][kTok + 1];
  const int tid = threadIdx.x, t = tid / 4, q4 = tid % 4;
  const long long win = blockIdx.x / heads;
  const int head = blockIdx.x % heads, hd = C / heads;
  const float* base = qkv + win * kTok * 3 * C + head * hd;
  float s[16] = {};
#pragma unroll 1
  for (int c0 = 0; c0 < hd; c0 += kMhsaChunk) {
    const int n = hd - c0 < kMhsaChunk ? hd - c0 : kMhsaChunk;
    __syncthreads();
    for (int e = tid; e < kTok * kMhsaChunk; e += kMhsaThreads) {
      const int r = e / kMhsaChunk, d = e % kMhsaChunk;
      const float* row = base + (long long)r * 3 * C + c0 + d;
      sA[r][d] = d < n ? row[0] : 0.f;
      sB[r][d] = d < n ? row[C] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int d = 0; d < kMhsaChunk; ++d) {
      const float q = sA[t][d];
#pragma unroll
      for (int j = 0; j < 16; ++j) s[j] = fmaf(q, sB[16 * q4 + j][d], s[j]);
    }
  }
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    s[j] = token_of(w0 + win, 16 * q4 + j, H, W).valid ? s[j] * scale : -INFINITY;
    m = fmaxf(m, s[j]);
  }
  m = quad_max(m);   // the row's four threads are one quad
  float l = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    s[j] = expf(s[j] - m);   // 0 at a key outside the grid; token 0 is inside
    l += s[j];
  }
  l = 1.f / quad_sum(l);
#pragma unroll
  for (int j = 0; j < 16; ++j) sP[t][16 * q4 + j] = s[j] * l;
  float* orow = o + (win * kTok + t) * C + head * hd;
#pragma unroll 1
  for (int c0 = 0; c0 < hd; c0 += kMhsaChunk) {
    const int n = hd - c0 < kMhsaChunk ? hd - c0 : kMhsaChunk;
    __syncthreads();
    for (int e = tid; e < kTok * kMhsaChunk; e += kMhsaThreads) {
      const int r = e / kMhsaChunk, d = e % kMhsaChunk;
      sA[r][d] = d < n ? base[(long long)r * 3 * C + 2 * C + c0 + d] : 0.f;
    }
    __syncthreads();
    float acc[8] = {};
#pragma unroll 4
    for (int u = 0; u < kTok; ++u) {
      const float p = sP[t][u];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(p, sA[u][8 * q4 + i], acc[i]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (8 * q4 + i < n) orow[c0 + 8 * q4 + i] = acc[i];
  }
}

// y at the tokens inside the grid: residual + fc2 + bias.
struct BlockOut {
  bf16* y;
  const float* xs;
  const bf16* bias;
  int H, W, C;
  long long w0;
  __device__ void operator()(int r, int n, float v) const {
    const Token tok = token_of(w0 + r / kTok, r % kTok, H, W);
    if (tok.valid)
      y[tok.off * C + n] =
          __float2bfloat16(xs[(long long)r * C + n] + v + __bfloat162float(bias[n]));
  }
};

int launch_stream(const bf16* x, const bf16* st, const float* gamma, const float* beta,
                  const bf16* const* w, bf16* y, int B, int H, int W, int C, float eps,
                  float* ws, int ws_windows, cudaStream_t s) {
  const int heads = default_num_heads(C), hd = C / heads;
  const long long n_windows = (long long)B * ((H + kWin - 1) / kWin) * ((W + kWin - 1) / kWin);
  if (ws == nullptr || ws_windows < 1 || (long long)ws_windows * kTok * 4 * C > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const long long rows_max = (long long)ws_windows * kTok;
  float* xs = ws;                       // residual stream, rows of C
  float* hs = xs + rows_max * C;        // LN output, then the MHSA output
  float* big = hs + rows_max * C;       // qkv rows of 3C, then hidden rows of 4C
  const bool vec = C % 4 == 0;
  using stream::RowsA;
  using stream::StoreRows;
  for (long long w0 = 0; w0 < n_windows; w0 += ws_windows) {
    const int n = (int)(n_windows - w0 < ws_windows ? n_windows - w0 : ws_windows);
    const int M = n * kTok;
    const int ln_grid = (M + kLnThreads / 32 - 1) / (kLnThreads / 32);
    block_ln_kernel<true><<<ln_grid, kLnThreads, 0, s>>>(x, st, gamma, beta, w[0], w[1], xs, hs,
                                                         H, W, C, w0, M, eps);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    rc = stream::gemm<3>(RowsA<float>{hs, C, M, C, vec}, w[2], M, 3 * C, C,
                         StoreRows<bf16>{big, 3 * C, w[3]}, s);
    if (rc) return rc;
    if ((long long)n * heads > INT_MAX) return (int)cudaErrorInvalidConfiguration;
    block_mhsa_kernel<<<(unsigned)(n * heads), kMhsaThreads, 0, s>>>(
        big, hs, H, W, w0, C, heads, 1.f / sqrtf((float)hd));
    rc = (int)cudaGetLastError();
    if (rc) return rc;
    rc = stream::gemm<2>(RowsA<float>{hs, C, M, C, vec}, w[4], M, C, C,
                         StoreRows<bf16, false, true>{xs, C, w[5]}, s);
    if (rc) return rc;
    block_ln_kernel<false><<<ln_grid, kLnThreads, 0, s>>>(nullptr, nullptr, nullptr, nullptr,
                                                          w[6], w[7], xs, hs, H, W, C, w0, M,
                                                          eps);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
    rc = stream::gemm<2>(RowsA<float>{hs, C, M, C, vec}, w[8], M, 4 * C, C,
                         StoreRows<bf16, true>{big, 4 * C, w[9]}, s);
    if (rc) return rc;
    rc = stream::gemm<2>(RowsA<float>{big, 4 * C, M, 4 * C, vec}, w[10], M, C, 4 * C,
                         BlockOut{y, xs, w[11], H, W, C, w0}, s);
    if (rc) return rc;
  }
  return 0;
}

}  // namespace
}  // namespace mstgan

// Plain C entry point (loaded with ctypes), as fused_structural_block.cu's:
// x, struct and y (B, H, W, C) bf16 contiguous; gamma and beta (B, C) fp32;
// `weights` 12 bf16 pointers (norm1 w/b, qkv w/b, proj w/b, norm2 w/b, fc1
// w/b, fc2 w/b); any C; ws an fp32 workspace of ws_windows windows of 64 x
// 6C floats (the residual stream, the LN output, then qkv or the hidden
// rows). dtype must be 1 (bf16). Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int fused_structural_block_stream_launch(const void* x, const void* st,
                                                    const void* gamma, const void* beta,
                                                    const void* const* weights, void* y, int B,
                                                    int H, int W, int C, int dtype, float eps,
                                                    void* ws, int ws_windows, int device,
                                                    void* stream) {
  if (dtype != mstgan::kBF16 || C < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return mstgan::launch_stream(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(st),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      reinterpret_cast<const __nv_bfloat16* const*>(weights), static_cast<__nv_bfloat16*>(y), B,
      H, W, C, eps, static_cast<float*>(ws), ws_windows, static_cast<cudaStream_t>(stream));
}
