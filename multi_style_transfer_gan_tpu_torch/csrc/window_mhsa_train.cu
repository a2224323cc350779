// Window-8 multi-head self-attention mid of the StructuralTransformerBlock,
// forward and backward, for Hopper (sm_90a).
//
// Replaces ops/pallas/window_mhsa_train.py::window_mhsa_train of the JAX
// package (its _fwd_kernel and hand-written _bwd_kernel). On a (B, H, W, 3C)
// qkv grid with C = heads x hd in `heads` heads of hd channels (the blocks
// of every generator width: C = 4, 8, .. in default_num_heads(C) heads, 4
// to 64 channels each up to c128, 16 heads of 67 at c268, 64 of 32 at
// c512), per 8x8 window
// of 64 tokens and per head, scale = hd^-0.5:
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
// fp32 keeps the first design's FMA bodies (no tensor cores, no TF32), with
// every intermediate in double and one rounding at the store. Its blocks of
// 256 threads stage rows of the slot with an odd stride and a 64 x 64 score
// tile with an odd stride; each row softmax (and its backward row sum) is
// one warp. Double because two fp32 evaluations of this mid cannot agree:
// on the saturated input (qkv x 8, logits of magnitude ~10^2, a softmax on
// a few keys) an fp32 evaluation lies 2e-4 .. 7e-4 from float64 in the
// forward and 5e-4 .. 5.5e-3 in the backward at every head width (CPU, the
// plain formulas in fp32 against float64), so kernel and plain version
// met the fp32 tolerance only while their summation orders happened to
// agree (they did not at 1 head of 6 channels); the plain version carries
// float64 too, and the two agree to the last rounding.
//
// Heads. Both designs give a block one (window, head): it stages that
// head's 32 channels of q, k, v (and dO) alone, so the shared memory of a
// block does not grow with the width. At dim 256 a window's qkv and dO are
// 64 x 1024 values, 256 KB in fp32, and a block still holds one head's 64 x
// 128 of them. The head count is a runtime argument (head h of q, k and v
// at column hd h of each third of the 3C row), any count that divides C
// (64 heads of 32 at c512's dim 2048). Nothing in a block grows with the
// count: the grid does.
//
// Head widths. A head of hd channels runs in a slot of S = hd rounded up to
// 16 (window_mhsa_mma.cuh: S = 16, 32, 48, 64, one instantiation of each
// kernel per S): its channels are staged at the start of the slot, zeros
// in the pad channels, so every product adds exact zeros there and the
// scores and the real outputs are the head's; the scale is 1/sqrt(hd) of
// the real width, and only the hd real channels are stored. A head
// of hd % 8 == 0 channels (the heads of 32 of the c8 .. c64 generators
// among them) is staged and stored 16 bytes at a time, hd % 4 == 0 8 bytes
// at a time (every head of a generator's block is one or the other), any
// other a value at a time. The fp32 bodies take the same slots, rows of S
// + 1 floats.
//
// Heads wider than 64 (hd = 67 at c268's dim 1072, 127 at c508's 2032, any
// hd past them): the head passes in chunks of 64 channels, the k-steps of
// the widest slot (mhsa_wide_fwd_mma_kernel, mhsa_wide_bwd_mma_kernel; in
// fp32 mhsa_wide_*_f64_kernel): the scores
// (and in the backward dp = dO v^T) summed over the chunks, then the outputs
// a chunk at a time (o = p v; dq = ds k, dk = ds^T q, dv = p^T dO), so a
// block holds 64 x 64 tiles whatever hd is. Every value is staged one at a
// time there (a chunk's start need not be aligned).
#include <climits>
#include <cmath>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"
#include "window_mhsa_mma.cuh"

namespace mstgan {
namespace {

using namespace mhsa;   // kWin, kTok, kHd, RS, TILE, slot_rs, slot_tile and the MMA steps

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int PS = kTok + 1;   // score row stride
constexpr int SCORES = kTok * PS;

// fp32 storage: rows of a slot of S channels, in double, at an odd stride of
// S + 1 values.
template <int S>
struct F32Slot {
  static constexpr int TS = S + 1;                       // token row stride (q, k, v, dO)
  static constexpr int ROWS = kTok * TS;
  static constexpr int F_TOTAL = 3 * ROWS + SCORES;      // q, k, v, p
  static constexpr int B_TOTAL = 4 * ROWS + 2 * SCORES;  // q, k, v, dO, p, dp
};

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

// Stages rows of hd channels starting at `first` of a (.., stride) tensor
// into a slot of S, as double; zeros in the pad channels hd..S.
template <int S, typename T>
__device__ void load_rows(const T* __restrict__ src, int stride, int first, int hd, double* dst,
                          long long win, int H, int W) {
  for (int e = threadIdx.x; e < kTok * S; e += kThreads) {
    const int t = e / S, d = e % S;
    dst[t * F32Slot<S>::TS + d] =
        d < hd ? (double)to_f(src[token_offset(win, t, H, W) * stride + first + d]) : 0.0;
  }
}

// a[t][s] = scale * sum_d x[t][d] y[s][d] over the 64 x 64 tile.
template <int S>
__device__ void scores(const double* x, const double* y, double* a, double scale) {
  constexpr int TS = F32Slot<S>::TS;
  for (int e = threadIdx.x; e < kTok * kTok; e += kThreads) {
    const int t = e / kTok, s = e % kTok;
    double acc = 0.0;
#pragma unroll 8
    for (int d = 0; d < S; ++d) acc = fma(x[t * TS + d], y[s * TS + d], acc);
    a[t * PS + s] = acc * scale;
  }
}

__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Row softmax of the 64 x 64 tile in place, max-subtracted; a warp per row.
__device__ void softmax_rows(double* p) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = warp; t < kTok; t += kWarps) {
    double* r = p + t * PS;
    double m = fmax(r[lane], r[lane + 32]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmax(m, __shfl_xor_sync(0xffffffffu, m, o));
    const double e0 = exp(r[lane] - m), e1 = exp(r[lane + 32] - m);
    const double sum = warp_sum_d(e0 + e1);
    r[lane] = e0 / sum;
    r[lane + 32] = e1 / sum;
  }
}

// Every product, softmax and sum in double; one rounding at the store.
template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
mhsa_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int H, int W, int heads,
                int hd) {
  using L = F32Slot<S>;
  const int C = heads * hd;
  extern __shared__ double smem_d[];
  double* sQ = smem_d;
  double* sK = sQ + L::ROWS;
  double* sV = sK + L::ROWS;
  double* sP = sV + L::ROWS;
  const long long win = blockIdx.x / heads;
  const int head = blockIdx.x % heads;
  load_rows<S>(qkv, 3 * C, head * hd, hd, sQ, win, H, W);
  load_rows<S>(qkv, 3 * C, C + head * hd, hd, sK, win, H, W);
  load_rows<S>(qkv, 3 * C, 2 * C + head * hd, hd, sV, win, H, W);
  __syncthreads();
  scores<S>(sQ, sK, sP, 1.0 / sqrt((double)hd));
  __syncthreads();
  softmax_rows(sP);
  __syncthreads();
  // o[t][d] = sum_s p[t][s] v[s][d], the hd real channels
  for (int e = threadIdx.x; e < kTok * hd; e += kThreads) {
    const int t = e / hd, d = e % hd;
    double acc = 0.0;
#pragma unroll 8
    for (int s = 0; s < kTok; ++s) acc = fma(sP[t * PS + s], sV[s * L::TS + d], acc);
    out[token_offset(win, t, H, W) * C + head * hd + d] = from_f<T>((float)acc);
  }
}

template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
mhsa_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ dout, T* __restrict__ dqkv,
                int H, int W, int heads, int hd) {
  using L = F32Slot<S>;
  const int C = heads * hd;
  extern __shared__ double smem_d[];
  double* sQ = smem_d;
  double* sK = sQ + L::ROWS;
  double* sV = sK + L::ROWS;
  double* sDO = sV + L::ROWS;
  double* sP = sDO + L::ROWS;
  double* sDP = sP + SCORES;
  const long long win = blockIdx.x / heads;
  const int head = blockIdx.x % heads;
  const double sc = 1.0 / sqrt((double)hd);
  load_rows<S>(qkv, 3 * C, head * hd, hd, sQ, win, H, W);
  load_rows<S>(qkv, 3 * C, C + head * hd, hd, sK, win, H, W);
  load_rows<S>(qkv, 3 * C, 2 * C + head * hd, hd, sV, win, H, W);
  load_rows<S>(dout, C, head * hd, hd, sDO, win, H, W);
  __syncthreads();
  scores<S>(sQ, sK, sP, sc);     // the forward's p, recomputed
  scores<S>(sDO, sV, sDP, 1.0);  // dp[t][s] = sum_d dO[t][d] v[s][d]
  __syncthreads();
  softmax_rows(sP);
  __syncthreads();
  // ds = p (.) (dp - rowsum(p (.) dp)) into sDP, a warp per row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = warp; t < kTok; t += kWarps) {
    const double* p = sP + t * PS;
    double* g = sDP + t * PS;
    const double rs = warp_sum_d(p[lane] * g[lane] + p[lane + 32] * g[lane + 32]);
    g[lane] = p[lane] * (g[lane] - rs);
    g[lane + 32] = p[lane + 32] * (g[lane + 32] - rs);
  }
  __syncthreads();
  // row i of the outputs, the hd real channels: dq[i] = scale sum_s
  // ds[i][s] k[s]; dk[i] = scale sum_t ds[t][i] q[t]; dv[i] = sum_t p[t][i] dO[t]
  for (int e = threadIdx.x; e < kTok * hd; e += kThreads) {
    const int i = e / hd, d = e % hd;
    double dq = 0.0, dk = 0.0, dv = 0.0;
#pragma unroll 8
    for (int j = 0; j < kTok; ++j) {
      dq = fma(sDP[i * PS + j], sK[j * L::TS + d], dq);
      dk = fma(sDP[j * PS + i], sQ[j * L::TS + d], dk);
      dv = fma(sP[j * PS + i], sDO[j * L::TS + d], dv);
    }
    T* row = dqkv + token_offset(win, i, H, W) * 3 * C + head * hd + d;
    row[0] = from_f<T>((float)(dq * sc));
    row[C] = from_f<T>((float)(dk * sc));
    row[2 * C] = from_f<T>((float)dv);
  }
}

// ---------------------------------------------------------------------------
// bf16: warp MMA
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;          // 4 warps x 16 query rows
constexpr int QS = kTok + 8;              // 64-wide p / ds row: 144 bytes
constexpr int SQUARE = kTok * QS;         // one 64 x 64 tile
template <int S>
constexpr int mma_f_bytes() { return 3 * slot_tile<S>() * (int)sizeof(bf16); }   // q, k, v
template <int S>   // + dO, p, ds hi, lo
constexpr int mma_b_bytes() { return (4 * slot_tile<S>() + 3 * SQUARE) * (int)sizeof(bf16); }

// Stages n 64 x S tiles of the window: tile i holds channels first + i *
// gap .. + hd - 1 of each token's row of `src` (row stride `stride`
// values) and lands at dst + i * slot_tile<S>(), zeros in the pad channels
// hd..S. A head of hd % 8 == 0 channels (so C and every offset are
// multiples of 8 too) moves with 16-byte cp.async, hd % 4 == 0 with 8-byte
// cp.async (every head of a generator's block), any other a value at a
// time; the pad channels are zero-filled copies.
template <int S>
__device__ void stage_tiles(const bf16* __restrict__ src, int stride, int first, int gap, int n,
                            int hd, bf16* dst, long long win, int H, int W) {
  constexpr int RSS = slot_rs<S>(), TS = slot_tile<S>(), PARTS = S / 8;
  if (hd % 8 && hd % 4 == 0) {
    for (int e = threadIdx.x; e < kTok * n * (S / 4); e += kMmaThreads) {
      const int t = e / (n * (S / 4)), i = (e / (S / 4)) % n, q = e % (S / 4);
      const bool real = q * 4 < hd;
      cp_async8(dst + i * TS + t * RSS + q * 4,
                src + token_offset(win, t, H, W) * stride + first + i * gap + (real ? q * 4 : 0),
                real);
    }
    return;
  }
  if (hd % 8) {   // a warp a row: its offset once, its values by the lanes
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < kTok * n; r += kMmaThreads / 32) {
      const int t = r / n, i = r % n;
      const bf16* row = src + token_offset(win, t, H, W) * stride + first + i * gap;
      for (int d = lane; d < S; d += 32)
        dst[i * TS + t * RSS + d] = d < hd ? row[d] : __float2bfloat16(0.f);
    }
    return;
  }
  for (int e = threadIdx.x; e < kTok * n * PARTS; e += kMmaThreads) {
    const int t = e / (n * PARTS), i = (e / PARTS) % n, part = e % PARTS;
    const bool real = hd == S || part * 8 < hd;
    cp_async16(dst + i * TS + t * RSS + part * 8,
               src + token_offset(win, t, H, W) * stride + first + i * gap +
                   (real ? part * 8 : 0),
               real);
  }
}

// The inverse for the 16 token rows t0.. of one warp: the hd real channels
// of staged tile i go to channels first + i * gap of each token's row of
// `dst` (16-, 8-byte or single-value stores as stage_tiles moves them).
template <int S>
__device__ void store_tiles(bf16* __restrict__ dst, int stride, int first, int gap, int n,
                            int hd, const bf16* src, int t0, long long win, int H, int W,
                            int lane) {
  constexpr int RSS = slot_rs<S>(), TS = slot_tile<S>(), PARTS = S / 8;
  if (hd % 8 && hd % 4 == 0) {
    for (int e = lane; e < 16 * n * (hd / 4); e += 32) {
      const int t = t0 + e / (n * (hd / 4)), i = (e / (hd / 4)) % n, q = e % (hd / 4);
      *reinterpret_cast<uint2*>(dst + token_offset(win, t, H, W) * stride + first + i * gap +
                                q * 4) =
          *reinterpret_cast<const uint2*>(src + i * TS + t * RSS + q * 4);
    }
    return;
  }
  if (hd % 8) {   // row by row: its offset once, its values by the lanes
    for (int r = 0; r < 16 * n; ++r) {
      const int t = t0 + r / n, i = r % n;
      bf16* row = dst + token_offset(win, t, H, W) * stride + first + i * gap;
      for (int d = lane; d < hd; d += 32) row[d] = src[i * TS + t * RSS + d];
    }
    return;
  }
  const int parts = hd == S ? PARTS : hd / 8;   // the real 16-byte chunks
  for (int e = lane; e < 16 * n * parts; e += 32) {
    const int t = t0 + e / (n * parts), i = (e / parts) % n, part = e % parts;
    *reinterpret_cast<uint4*>(dst + token_offset(win, t, H, W) * stride + first + i * gap +
                              part * 8) =
        *reinterpret_cast<const uint4*>(src + i * TS + t * RSS + part * 8);
  }
}

// acc (16 x S: key rows k0..k0+15) += x^T y, x a [query][key] 64 x 64 tile
// in shared memory (hi, and lo when kSplit), y a staged [query][d] tile.
template <bool kSplit, int S>
__device__ __forceinline__ void square_t_times_tile(float (&acc)[S / 8][4], const bf16* xh,
                                                    const bf16* xl, const bf16* y, int k0,
                                                    int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t hi[4], lo[4];
    const int off = (kk * 16 + (lane & 7) + (lane >> 4) * 8) * QS + k0 + ((lane >> 3) & 1) * 8;
    ldmatrix_x4_trans(hi, xh + off);
    if (kSplit) ldmatrix_x4_trans(lo, xl + off);
#pragma unroll
    for (int dp = 0; dp < S / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, y + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * slot_rs<S>() +
                               dp * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * dp], hi, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], hi, b[2], b[3]);
      if (kSplit) {
        mma_bf16(acc[2 * dp], lo, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], lo, b[2], b[3]);
      }
    }
  }
}

template <int S>
__global__ void __launch_bounds__(kMmaThreads)
mhsa_fwd_mma_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int H, int W,
                    int heads, int hd, float scale) {
  constexpr int NT = S / 8, TS = slot_tile<S>();
  const int C = heads * hd;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_mma);   // q, k, v tiles back to back
  bf16* sK = sQ + TS;
  bf16* sV = sK + TS;
  const long long win = blockIdx.x / heads;
  const int head = blockIdx.x % heads;
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * 16;
  stage_tiles<S>(qkv, 3 * C, head * hd, C, 3, hd, sQ, win, H, W);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qa[S / 16][4];
  load_a<S>(qa, sQ, r0, lane);
  float s[8][4];
  times_tile_t<S>(s, qa, sK, lane);
  float l0, l1;
  exp_rows(s, scale, l0, l1);
  float o[NT][4] = {};
  strip_times_tile<true, S>(o, s, sV, lane);
  l0 = 1.f / l0;
  l1 = 1.f / l1;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    o[j][0] *= l0;
    o[j][1] *= l0;
    o[j][2] *= l1;
    o[j][3] *= l1;
  }
  // o through the warp's own q rows (read by no other warp) to the stores
  __syncwarp();
  store_frags<NT>(sQ, nullptr, slot_rs<S>(), r0, 0, o, 1.f, lane);
  __syncwarp();
  store_tiles<S>(out, C, head * hd, C, 1, hd, sQ, r0, win, H, W, lane);
}

template <int S>
__global__ void __launch_bounds__(kMmaThreads)
mhsa_bwd_mma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                    bf16* __restrict__ dqkv, int H, int W, int heads, int hd, float scale) {
  constexpr int NT = S / 8, TS = slot_tile<S>(), RSS = slot_rs<S>();
  const int C = heads * hd;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_mma);   // q, k, v, dO tiles back to back
  bf16* sK = sQ + TS;
  bf16* sV = sK + TS;
  bf16* sDO = sV + TS;
  bf16* sP = sDO + TS;                            // [query][key]: p, ds hi, ds lo
  bf16* sDH = sP + SQUARE;
  bf16* sDL = sDH + SQUARE;
  const long long win = blockIdx.x / heads;
  const int head = blockIdx.x % heads;
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * 16;
  stage_tiles<S>(qkv, 3 * C, head * hd, C, 3, hd, sQ, win, H, W);
  stage_tiles<S>(dout, C, head * hd, C, 1, hd, sDO, win, H, W);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // the warp's 16 query rows: p recomputed, dp = dO v^T, ds, dq = ds k
  uint32_t a[S / 16][4];
  load_a<S>(a, sQ, r0, lane);
  float p[8][4];
  times_tile_t<S>(p, a, sK, lane);
  float l0, l1;
  exp_rows(p, scale, l0, l1);
  l0 = 1.f / l0;
  l1 = 1.f / l1;
  load_a<S>(a, sDO, r0, lane);
  float ds[8][4];
  times_tile_t<S>(ds, a, sV, lane);
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
  float dq[NT][4] = {};
  strip_times_tile<true, S>(dq, ds, sK, lane);
  store_frags<8>(sP, nullptr, QS, r0, 0, p, 1.f, lane);
  store_frags<8>(sDH, sDL, QS, r0, 0, ds, 1.f, lane);
  __syncthreads();

  // the warp's 16 key rows: dk = ds^T q, dv = p^T dO
  float dk[NT][4] = {}, dv[NT][4] = {};
  square_t_times_tile<true, S>(dk, sDH, sDL, sQ, r0, lane);
  square_t_times_tile<false, S>(dv, sP, nullptr, sDO, r0, lane);
  __syncthreads();
  store_frags<NT>(sQ, nullptr, RSS, r0, 0, dq, scale, lane);
  store_frags<NT>(sK, nullptr, RSS, r0, 0, dk, scale, lane);
  store_frags<NT>(sV, nullptr, RSS, r0, 0, dv, 1.f, lane);
  __syncwarp();
  store_tiles<S>(dqkv, 3 * C, head * hd, C, 3, hd, sQ, r0, win, H, W, lane);
}

// ---------------------------------------------------------------------------
// Heads wider than 64: chunks of 64 channels
// ---------------------------------------------------------------------------

constexpr int kChunk = 64;                 // head channels a pass
constexpr int CRS = slot_rs<kChunk>();     // staged chunk row: 144 bytes
constexpr int CTILE = slot_tile<kChunk>(); // one staged 64 x 64 chunk

// Stages channels col0 .. col0 + n - 1 (n <= 64) of each of the window's 64
// token rows of `src` (row stride `stride`) as a [token][d] chunk, zeros
// from n on, a value at a time (a chunk's start need not be aligned).
__device__ __forceinline__ void stage_chunk(const bf16* __restrict__ src, int stride, int col0,
                                            int n, bf16* tile, long long win, int H, int W) {
  for (int e = threadIdx.x; e < kTok * kChunk; e += blockDim.x) {
    const int t = e / kChunk, d = e % kChunk;
    tile[t * CRS + d] =
        d < n ? src[token_offset(win, t, H, W) * stride + col0 + d] : __float2bfloat16(0.f);
  }
}

// s (16 x 64) += x y^T over one chunk: x rows r0.. of a staged chunk, y a
// staged chunk.
__device__ __forceinline__ void add_scores(float (&s)[8][4], const bf16* x, const bf16* y, int r0,
                                           int lane) {
  uint32_t a[kChunk / 16][4];
  load_a<kChunk>(a, x, r0, lane);
  float t[8][4];
  times_tile_t<kChunk>(t, a, y, lane);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] += t[j][i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mhsa_wide_fwd_f64_kernel(const T* __restrict__ qkv, T* __restrict__ out, int H, int W, int heads,
                         int hd) {
  using L = F32Slot<kChunk>;
  const int C = heads * hd;
  extern __shared__ double smem_d[];
  double* sA = smem_d;
  double* sB = sA + L::ROWS;
  double* sP = sB + L::ROWS;
  const long long win = blockIdx.x / heads;
  const int head = blockIdx.x % heads;
  for (int e = threadIdx.x; e < SCORES; e += kThreads) sP[e] = 0.0;
#pragma unroll 1
  for (int c0 = 0; c0 < hd; c0 += kChunk) {
    const int n = hd - c0 < kChunk ? hd - c0 : kChunk;
    __syncthreads();
    load_rows<kChunk>(qkv, 3 * C, head * hd + c0, n, sA, win, H, W);
    load_rows<kChunk>(qkv, 3 * C, C + head * hd + c0, n, sB, win, H, W);
    __syncthreads();
    for (int e = threadIdx.x; e < kTok * kTok; e += kThreads) {
      const int t = e / kTok, u = e % kTok;
      double acc = 0.0;
#pragma unroll 8
      for (int d = 0; d < kChunk; ++d) acc = fma(sA[t * L::TS + d], sB[u * L::TS + d], acc);
      sP[t * PS + u] += acc;
    }
  }
  __syncthreads();
  const double sc = 1.0 / sqrt((double)hd);
  for (int e = threadIdx.x; e < kTok * kTok; e += kThreads) sP[(e / kTok) * PS + e % kTok] *= sc;
  __syncthreads();
  softmax_rows(sP);
#pragma unroll 1
  for (int c0 = 0; c0 < hd; c0 += kChunk) {
    const int n = hd - c0 < kChunk ? hd - c0 : kChunk;
    __syncthreads();
    load_rows<kChunk>(qkv, 3 * C, 2 * C + head * hd + c0, n, sA, win, H, W);
    __syncthreads();
    for (int e = threadIdx.x; e < kTok * n; e += kThreads) {
      const int t = e / n, d = e % n;
      double acc = 0.0;
#pragma unroll 8
      for (int u = 0; u < kTok; ++u) acc = fma(sP[t * PS + u], sA[u * L::TS + d], acc);
      out[token_offset(win, t, H, W) * C + head * hd + c0 + d] = from_f<T>((float)acc);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mhsa_wide_bwd_f64_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                         T* __restrict__ dqkv, int H, int W, int heads, int hd) {
  using L = F32Slot<kChunk>;
  const int C = heads * hd;
  extern __shared__ double smem_d[];
  double* sA = smem_d;
  double* sB = sA + L::ROWS;
  double* sC = sB + L::ROWS;
  double* sP = sC + L::ROWS;
  double* sDP = sP + SCORES;
  const long long win = blockIdx.x / heads;
  const int head = blockIdx.x % heads;
  for (int e = threadIdx.x; e < SCORES; e += kThreads) sP[e] = sDP[e] = 0.0;
  // s = q k^T and dp = dO v^T, summed over the chunks
#pragma unroll 1
  for (int c0 = 0; c0 < hd; c0 += kChunk) {
    const int n = hd - c0 < kChunk ? hd - c0 : kChunk;
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      __syncthreads();
      if (pass == 0) {
        load_rows<kChunk>(qkv, 3 * C, head * hd + c0, n, sA, win, H, W);
        load_rows<kChunk>(qkv, 3 * C, C + head * hd + c0, n, sB, win, H, W);
      } else {
        load_rows<kChunk>(dout, C, head * hd + c0, n, sA, win, H, W);
        load_rows<kChunk>(qkv, 3 * C, 2 * C + head * hd + c0, n, sB, win, H, W);
      }
      __syncthreads();
      double* dst = pass == 0 ? sP : sDP;
      for (int e = threadIdx.x; e < kTok * kTok; e += kThreads) {
        const int t = e / kTok, u = e % kTok;
        double acc = 0.0;
#pragma unroll 8
        for (int d = 0; d < kChunk; ++d) acc = fma(sA[t * L::TS + d], sB[u * L::TS + d], acc);
        dst[t * PS + u] += acc;
      }
    }
  }
  __syncthreads();
  const double sc = 1.0 / sqrt((double)hd);
  for (int e = threadIdx.x; e < kTok * kTok; e += kThreads) sP[(e / kTok) * PS + e % kTok] *= sc;
  __syncthreads();
  softmax_rows(sP);
  __syncthreads();
  // ds = p (.) (dp - rowsum(p (.) dp)) into sDP, a warp per row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = warp; t < kTok; t += kWarps) {
    const double* p = sP + t * PS;
    double* g = sDP + t * PS;
    const double rs = warp_sum_d(p[lane] * g[lane] + p[lane + 32] * g[lane + 32]);
    g[lane] = p[lane] * (g[lane] - rs);
    g[lane + 32] = p[lane + 32] * (g[lane + 32] - rs);
  }
#pragma unroll 1
  for (int c0 = 0; c0 < hd; c0 += kChunk) {
    const int n = hd - c0 < kChunk ? hd - c0 : kChunk;
    __syncthreads();
    load_rows<kChunk>(qkv, 3 * C, head * hd + c0, n, sA, win, H, W);
    load_rows<kChunk>(qkv, 3 * C, C + head * hd + c0, n, sB, win, H, W);
    load_rows<kChunk>(dout, C, head * hd + c0, n, sC, win, H, W);
    __syncthreads();
    for (int e = threadIdx.x; e < kTok * n; e += kThreads) {
      const int i = e / n, d = e % n;
      double dq = 0.0, dk = 0.0, dv = 0.0;
#pragma unroll 8
      for (int j = 0; j < kTok; ++j) {
        dq = fma(sDP[i * PS + j], sB[j * L::TS + d], dq);
        dk = fma(sDP[j * PS + i], sA[j * L::TS + d], dk);
        dv = fma(sP[j * PS + i], sC[j * L::TS + d], dv);
      }
      T* row = dqkv + token_offset(win, i, H, W) * 3 * C + head * hd + c0 + d;
      row[0] = from_f<T>((float)(dq * sc));
      row[C] = from_f<T>((float)(dk * sc));
      row[2 * C] = from_f<T>((float)dv);
    }
  }
}

// bf16 forward of a head of hd > 64, a block of 4 warps (16 query rows each)
// per (window, head): the scores summed over the chunks of q and k, the
// softmax's exponentials, then o = p v a chunk of v at a time, the
// exponentials as hi + lo pairs as in the slots up to 64.
__global__ void __launch_bounds__(kMmaThreads)
mhsa_wide_fwd_mma_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int H, int W,
                         int heads, int hd, float scale) {
  __shared__ __align__(16) bf16 sX[CTILE], sY[CTILE];
  const long long win = blockIdx.x / heads;
  const int head = blockIdx.x % heads, C = heads * hd;
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * 16;
  const int g = lane >> 2, tq = lane & 3;
  float s[8][4] = {};
#pragma unroll 1
  for (int c0 = 0; c0 < hd; c0 += kChunk) {
    const int n = hd - c0 < kChunk ? hd - c0 : kChunk;
    __syncthreads();
    stage_chunk(qkv, 3 * C, head * hd + c0, n, sX, win, H, W);
    stage_chunk(qkv, 3 * C, C + head * hd + c0, n, sY, win, H, W);
    __syncthreads();
    add_scores(s, sX, sY, r0, lane);
  }
  float l0, l1;
  exp_rows(s, scale, l0, l1);
  l0 = 1.f / l0;
  l1 = 1.f / l1;
#pragma unroll 1
  for (int c0 = 0; c0 < hd; c0 += kChunk) {
    const int n = hd - c0 < kChunk ? hd - c0 : kChunk;
    __syncthreads();
    stage_chunk(qkv, 3 * C, 2 * C + head * hd + c0, n, sY, win, H, W);
    __syncthreads();
    float o[8][4] = {};
    strip_times_tile<true, kChunk>(o, s, sY, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int t = r0 + g + 8 * h, d = j * 8 + 2 * tq + i;
          if (d < n)
            out[token_offset(win, t, H, W) * C + head * hd + c0 + d] =
                __float2bfloat16(o[j][2 * h + i] * (h ? l1 : l0));
        }
  }
}

// bf16 backward of a head of hd > 64: s and dp summed over the chunks, p
// and ds as in mhsa_bwd_mma_kernel (p one term, ds a pair in shared memory;
// ds in registers for dq), then dq, dk and dv a chunk at a time.
__global__ void __launch_bounds__(kMmaThreads)
mhsa_wide_bwd_mma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                         bf16* __restrict__ dqkv, int H, int W, int heads, int hd,
                         float scale) {
  const int C = heads * hd;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* sA = reinterpret_cast<bf16*>(smem_mma);   // three chunks, then p, ds hi, ds lo
  bf16* sB = sA + CTILE;
  bf16* sC = sB + CTILE;
  bf16* sP = sC + CTILE;
  bf16* sDH = sP + SQUARE;
  bf16* sDL = sDH + SQUARE;
  const long long win = blockIdx.x / heads;
  const int head = blockIdx.x % heads;
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * 16;
  const int g = lane >> 2, tq = lane & 3;
  float p[8][4] = {}, ds[8][4] = {};
#pragma unroll 1
  for (int c0 = 0; c0 < hd; c0 += kChunk) {
    const int n = hd - c0 < kChunk ? hd - c0 : kChunk;
    __syncthreads();
    stage_chunk(qkv, 3 * C, head * hd + c0, n, sA, win, H, W);
    stage_chunk(qkv, 3 * C, C + head * hd + c0, n, sB, win, H, W);
    stage_chunk(dout, C, head * hd + c0, n, sC, win, H, W);
    __syncthreads();
    add_scores(p, sA, sB, r0, lane);
    __syncthreads();
    stage_chunk(qkv, 3 * C, 2 * C + head * hd + c0, n, sB, win, H, W);
    __syncthreads();
    add_scores(ds, sC, sB, r0, lane);   // dp = dO v^T
  }
  float l0, l1;
  exp_rows(p, scale, l0, l1);
  l0 = 1.f / l0;
  l1 = 1.f / l1;
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
  store_frags<8>(sP, nullptr, QS, r0, 0, p, 1.f, lane);
  store_frags<8>(sDH, sDL, QS, r0, 0, ds, 1.f, lane);
#pragma unroll 1
  for (int c0 = 0; c0 < hd; c0 += kChunk) {
    const int n = hd - c0 < kChunk ? hd - c0 : kChunk;
    __syncthreads();
    stage_chunk(qkv, 3 * C, head * hd + c0, n, sA, win, H, W);
    stage_chunk(qkv, 3 * C, C + head * hd + c0, n, sB, win, H, W);
    stage_chunk(dout, C, head * hd + c0, n, sC, win, H, W);
    __syncthreads();
    float dq[8][4] = {}, dk[8][4] = {}, dv[8][4] = {};
    strip_times_tile<true, kChunk>(dq, ds, sB, lane);
    square_t_times_tile<true, kChunk>(dk, sDH, sDL, sA, r0, lane);
    square_t_times_tile<false, kChunk>(dv, sP, nullptr, sC, r0, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int t = r0 + g + 8 * h, d = j * 8 + 2 * tq + i;
          if (d >= n) continue;
          bf16* row = dqkv + token_offset(win, t, H, W) * 3 * C + head * hd + c0 + d;
          row[0] = __float2bfloat16(dq[j][2 * h + i] * scale);
          row[C] = __float2bfloat16(dk[j][2 * h + i] * scale);
          row[2 * C] = __float2bfloat16(dv[j][2 * h + i]);
        }
  }
}

constexpr int wide_f_bytes() { return (2 * F32Slot<kChunk>::ROWS + SCORES) * (int)sizeof(double); }
constexpr int wide_b_bytes() { return (3 * F32Slot<kChunk>::ROWS + 2 * SCORES) * (int)sizeof(double); }
constexpr int wide_mma_b_bytes() { return (3 * CTILE + 3 * SQUARE) * (int)sizeof(bf16); }

int wide_fwd(const void* qkv, void* out, long long grid, int H, int W, int heads, int hd,
             int dtype, cudaStream_t s) {
  if (dtype == kF32) {
    auto kernel = mhsa_wide_fwd_f64_kernel<float>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           wide_f_bytes());
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)grid, kThreads, wide_f_bytes(), s>>>(
        static_cast<const float*>(qkv), static_cast<float*>(out), H, W, heads, hd);
  } else if (dtype == kBF16) {
    mhsa_wide_fwd_mma_kernel<<<(unsigned)grid, kMmaThreads, 0, s>>>(
        static_cast<const bf16*>(qkv), static_cast<bf16*>(out), H, W, heads, hd,
        1.f / sqrtf((float)hd));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int wide_bwd(const void* qkv, const void* dout, void* dqkv, long long grid, int H, int W,
             int heads, int hd, int dtype, cudaStream_t s) {
  if (dtype == kF32) {
    auto kernel = mhsa_wide_bwd_f64_kernel<float>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           wide_b_bytes());
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)grid, kThreads, wide_b_bytes(), s>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(dout),
        static_cast<float*>(dqkv), H, W, heads, hd);
  } else if (dtype == kBF16) {
    cudaError_t err = cudaFuncSetAttribute(
        mhsa_wide_bwd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wide_mma_b_bytes());
    if (err != cudaSuccess) return (int)err;
    mhsa_wide_bwd_mma_kernel<<<(unsigned)grid, kMmaThreads, wide_mma_b_bytes(), s>>>(
        static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout), static_cast<bf16*>(dqkv),
        H, W, heads, hd, 1.f / sqrtf((float)hd));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------

// The slot of a head of hd channels: hd rounded up to the k-step of 16.
template <typename F>
int with_slot(int hd, F f) {
  if (hd <= 16) return f(std::integral_constant<int, 16>{});
  if (hd <= 32) return f(std::integral_constant<int, 32>{});
  if (hd <= 48) return f(std::integral_constant<int, 48>{});
  return f(std::integral_constant<int, 64>{});
}

// One block per (window, head); fp32 kernels on 256 threads, bf16 on 128.
int fwd(const void* qkv, void* out, long long grid, int H, int W, int heads, int hd, int dtype,
        cudaStream_t s) {
  if (hd > 64) return wide_fwd(qkv, out, grid, H, W, heads, hd, dtype, s);
  const float scale = 1.f / sqrtf((float)hd);
  return with_slot(hd, [&](auto slot) {
    constexpr int S = decltype(slot)::value;
    if (dtype == kF32) {
      const int smem = F32Slot<S>::F_TOTAL * (int)sizeof(double);
      auto kernel = mhsa_fwd_kernel<float, S>;
      cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      kernel<<<(unsigned)grid, kThreads, smem, s>>>(static_cast<const float*>(qkv),
                                                    static_cast<float*>(out), H, W, heads, hd);
    } else if (dtype == kBF16) {
      auto kernel = mhsa_fwd_mma_kernel<S>;
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, mma_f_bytes<S>());
      if (err != cudaSuccess) return (int)err;
      kernel<<<(unsigned)grid, kMmaThreads, mma_f_bytes<S>(), s>>>(
          static_cast<const bf16*>(qkv), static_cast<bf16*>(out), H, W, heads, hd, scale);
    } else {
      return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
  });
}

int bwd(const void* qkv, const void* dout, void* dqkv, long long grid, int H, int W, int heads,
        int hd, int dtype, cudaStream_t s) {
  if (hd > 64) return wide_bwd(qkv, dout, dqkv, grid, H, W, heads, hd, dtype, s);
  const float scale = 1.f / sqrtf((float)hd);
  return with_slot(hd, [&](auto slot) {
    constexpr int S = decltype(slot)::value;
    if (dtype == kF32) {
      const int smem = F32Slot<S>::B_TOTAL * (int)sizeof(double);
      auto kernel = mhsa_bwd_kernel<float, S>;
      cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      kernel<<<(unsigned)grid, kThreads, smem, s>>>(
          static_cast<const float*>(qkv), static_cast<const float*>(dout),
          static_cast<float*>(dqkv), H, W, heads, hd);
    } else if (dtype == kBF16) {
      auto kernel = mhsa_bwd_mma_kernel<S>;
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, mma_b_bytes<S>());
      if (err != cudaSuccess) return (int)err;
      kernel<<<(unsigned)grid, kMmaThreads, mma_b_bytes<S>(), s>>>(
          static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
          static_cast<bf16*>(dqkv), H, W, heads, hd, scale);
    } else {
      return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
  });
}

// Any C in any head count that divides it (slots up to 64 channels, wider
// heads in chunks of 64).
bool supported(int H, int W, int C, int heads) {
  return heads >= 1 && C > 0 && C % heads == 0 && H % kWin == 0 && W % kWin == 0;
}

// One block per (window, head).
long long grid_size(int B, int H, int W, int heads) {
  return (long long)B * (H / kWin) * (W / kWin) * heads;
}

}  // namespace
}  // namespace mstgan

// Plain C entry points (loaded with ctypes). qkv and dqkv are (B, H, W, 3C),
// out and dout (B, H, W, C), all contiguous and 16-byte aligned, of one type
// (dtype 0 = fp32, 1 = bf16), with C in any number of heads that divides it
// and H % 8 == W % 8 == 0. Each launches on `stream` and returns cudaGetLastError()
// (0 on success); another (C, heads) returns cudaErrorInvalidValue.
extern "C" int window_mhsa_train_fwd_launch(const void* qkv, void* out, int B, int H, int W,
                                            int C, int heads, int dtype, int device,
                                            void* stream) {
  if (!mstgan::supported(H, W, C, heads)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long grid = mstgan::grid_size(B, H, W, heads);
  if (grid > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  return mstgan::fwd(qkv, out, grid, H, W, heads, C / heads, dtype,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int window_mhsa_train_bwd_launch(const void* qkv, const void* dout, void* dqkv,
                                            int B, int H, int W, int C, int heads, int dtype,
                                            int device, void* stream) {
  if (!mstgan::supported(H, W, C, heads)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long grid = mstgan::grid_size(B, H, W, heads);
  if (grid > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  return mstgan::bwd(qkv, dout, dqkv, grid, H, W, heads, C / heads, dtype,
                     static_cast<cudaStream_t>(stream));
}
