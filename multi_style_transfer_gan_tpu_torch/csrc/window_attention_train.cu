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
// Gram.
//
// What bounds it. Per position the forward reads 3C values and writes C,
// the backward reads 4C and writes 3C, with 14 C^2 flops of products per
// position in all: ~0.6 C flop per byte in bf16, far under the card's bf16
// tensor-core ridge (~295 flop/B). So the bound is the bytes: 0.124 ms for
// forward + backward of one generator's four calls at 256^2, batch 8. Every
// intermediate stays on the chip: one read of the inputs, one write of the
// outputs, the softmax recomputed in the backward rather than saved, as the
// Pallas backward does.
//
// The first design (kept as the fp32 instantiation below) did its products
// as fp32 FMAs with both operands read from shared memory, two wavefronts
// per warp FMA against one wavefront per SM and clock: the 7.5 GFLOP of one
// generator's forward + backward are ~117 M warp FMAs and ~235 M
// wavefronts, ~1.0 ms of its measured 2.024; scalar 2-byte staging loads,
// norm loops with half the threads idle, softmax rows with half the lanes
// idle at C = 16 and six to eight block barriers per tile made the rest.
//
// bf16 design. Every product is mma.sync.m16n8k16 (bf16 in, fp32 sums;
// csrc/mma.cuh); the Gram's depth is a window's 16 positions, exactly one
// k-step. A block of 8 warps takes NWR = 128 / C windows per round (8, 4,
// 2) and 4, 2, 1 rounds, so every warp handles 4 windows at C = 16 and 2 at
// C = 32, and one 16-row m-tile of a window's Gram at every C (C / 16 warps
// per window). qkv (and dO) are staged as bf16 with 16-byte cp.async into
// rows padded by 16 bytes (conflict-free ldmatrix). All 256 threads then
// normalize, 16 channels each with the partial sums joined by shuffles;
// |u|, inv and sel are fp32 and the zero-vector guard is the one above.
// Each warp forms its m-tile of the Gram, takes the softmax on the
// accumulator fragments (quad shuffles), and in the forward applies it to v
// straight from registers: out = v S^T takes S's C fragments as its B
// fragments. The backward adds dS = dO^T v on the same fragments, dL, and
// dqn = kn dL^T from registers; S and dL go through shared memory as bf16
// because dv = dO S and dkn = qn dL read them transposed (ldmatrix.trans).
// The norm backward du = (dun - un <un, dun> sel) inv is fp32, from dqn and
// dkn kept in fp32 shared memory; outputs are staged for 16-byte stores.
// Operands rounded to bf16 inside the kernel: qn, kn and dL enter their
// products (the Gram, dqn, dkn) as hi + lo bf16 pairs (three products:
// hi hi, hi lo, lo hi; ~2^-16 relative), because a window whose q and k
// have norms ~1e-3 multiplies the error of dqn and dkn by inv ~ 1e3: with
// single bf16 terms the backward misses the bf16 bound by 8.8-30x, with
// only dL split by 6.2-13x, with the three split it stays at 0.65-0.84 of
// it (devtools/train_kernel_rounding.py). S enters dv = dO S as one bf16
// term, and out = v S^T as one term too but at C = 8, where a softmax over
// 8 keys puts ~1/8 on each and one term takes the saturated input (qkv x 8)
// to 1.08 of the bound at (8, 256, 256, 24) (emulated); there S enters as a
// pair. v and dO are the bf16 inputs themselves.
//
// Widths. C = 16, 32, 64 (the c16 generator; c32's down1, up1, up2) and 8
// (the c8 generator's up2). In bf16, C = 8 runs padded to 16 channels
// inside (MmaLayout); the fp32 bodies take it as it is. c32's down2 (C =
// 128) has no training kernel here, as it has none in the JAX package
// (_group_geometry takes C <= 64): its gradient goes the JAX package's way,
// ops/kernels/window_attention_fast_vjp.py.
//
// fp32 stays exact fp32 in the forward: the fp32 instantiation keeps the
// first design's FMA bodies (no tensor cores, no TF32): one block of 256
// threads per tile of NW = 64 / C windows, every intermediate in shared
// memory with odd row strides, a warp per softmax row. The fp32 backward
// runs the same bodies with every intermediate in double and rounds once
// at the store. A window whose q and k have norms ~1e-3 has gradients ~4e3
// at C = 8 (~1.2e3 at 16), where one fp32 ulp is 4.9e-4: two fp32
// evaluations in different orders (this body against cuBLAS in the plain
// version) then differ by more than the 2e-4 they are held to, and the
// plain version alone missed a float64 evaluation by 5.1e-4 at C = 8 and
// 2.4e-4 at C = 16 (devtools/train_kernel_rounding.py --fp32). Both now
// carry the sums in double, and agree to the last fp32 rounding. Windows
// past the end of the last tile compute on zeros and are not stored (both
// designs).
#include <climits>
#include <cmath>

#include "common.cuh"
#include "mma.cuh"

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

// ---------------------------------------------------------------------------
// fp32: the FMA bodies
// ---------------------------------------------------------------------------

// The sums of the FMA bodies are taken in A: float in the forward, double in
// the backward (see the header: the small-norm windows' gradients).
__device__ __forceinline__ float fma_a(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_a(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float exp_a(float x) { return expf(x); }
__device__ __forceinline__ double exp_a(double x) { return exp(x); }
__device__ __forceinline__ float sqrt_a(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_a(double x) { return sqrt(x); }

template <typename A>
__device__ __forceinline__ A warp_sum_a(A v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
template <typename A>
__device__ __forceinline__ A warp_max_a(A v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const A w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w > v ? w : v;
  }
  return v;
}

// Loads the tile's q, k, v as A and normalizes q and k in place.
// inv[s][r] = 1 / max(|u|, eps), or 1 / eps for a zero vector; sel[s][r]
// = 1 where u is nonzero and |u| > eps (s = 0 for q, 1 for k). Ends with
// the block synchronized.
template <typename T, typename A, int C>
__device__ void load_normalize(const T* __restrict__ qkv, A* sQKV, A* sInv, A* sSel,
                               long long win0, long long n_windows, int H, int W, float eps) {
  using L = Layout<C>;
  const int tid = threadIdx.x;
  for (int e = tid; e < L::ROWS * 3 * C; e += kThreads) {
    const int r = e / (3 * C), c = e % (3 * C);
    const long long win = win0 + r / kP;
    sQKV[r * L::QS + c] =
        win < n_windows ? (A)to_f(qkv[pixel_offset(win, r % kP, H, W) * 3 * C + c]) : (A)0;
  }
  __syncthreads();
  for (int e = tid; e < 2 * L::ROWS; e += kThreads) {
    const int s = e / L::ROWS, r = e % L::ROWS;
    const A* u = sQKV + r * L::QS + s * C;
    A ss = 0;
#pragma unroll 16
    for (int c = 0; c < C; ++c) ss = fma_a(u[c], u[c], ss);
    const bool nz = ss > (A)0;
    const A n = sqrt_a(nz ? ss : (A)1);
    sInv[e] = (A)1 / (nz ? (n > (A)eps ? n : (A)eps) : (A)eps);
    if (sSel) sSel[e] = (nz && n > (A)eps) ? (A)1 : (A)0;
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
template <typename A, int C>
__device__ void gram_softmax(const A* sQKV, A* sS) {
  using L = Layout<C>;
  const int tid = threadIdx.x;
  for (int e = tid; e < L::NW * C * C; e += kThreads) {
    const int n = e / (C * C), c1 = (e / C) % C, c2 = e % C;
    const A* base = sQKV + n * kP * L::QS;
    A acc = 0;
#pragma unroll
    for (int t = 0; t < kP; ++t) acc = fma_a(base[t * L::QS + c1], base[t * L::QS + C + c2], acc);
    sS[(n * C + c1) * L::GS + c2] = acc;
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  for (int row = warp; row < L::NW * C; row += kWarps) {
    A* g = sS + row * L::GS;
    A m = (A)-INFINITY;
    for (int c = lane; c < C; c += 32) m = g[c] > m ? g[c] : m;
    m = warp_max_a(m);
    A sum = 0;
    for (int c = lane; c < C; c += 32) {
      const A ev = exp_a(g[c] - m);
      g[c] = ev;
      sum += ev;
    }
    sum = warp_sum_a(sum);
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
  load_normalize<T, float, C>(qkv, sQKV, smem + L::F_INV, nullptr, win0, n_windows, H, W, eps);
  gram_softmax<float, C>(sQKV, sS);
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

// Every intermediate in double (the fp32 instantiation): rounded once, at
// the store of d(qkv).
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
mid_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ dout, T* __restrict__ dqkv,
               int H, int W, long long n_windows, float eps) {
  using L = Layout<C>;
  using A = double;
  extern __shared__ double smem_d[];
  A* sQKV = smem_d + L::B_QKV;
  A* sDO = smem_d + L::B_DO;
  A* sInv = smem_d + L::B_INV;
  A* sSel = smem_d + L::B_SEL;
  A* sDot = smem_d + L::B_DOT;
  A* sS = smem_d + L::B_S;
  A* sD = smem_d + L::B_D;
  A* sDQK = smem_d + L::B_DQK;
  const int tid = threadIdx.x;
  const long long win0 = (long long)blockIdx.x * L::NW;

  for (int e = tid; e < L::ROWS * C; e += kThreads) {
    const int r = e / C, c = e % C;
    const long long win = win0 + r / kP;
    sDO[r * L::DS + c] =
        win < n_windows ? (A)to_f(dout[pixel_offset(win, r % kP, H, W) * C + c]) : (A)0;
  }
  load_normalize<T, A, C>(qkv, sQKV, sInv, sSel, win0, n_windows, H, W, eps);
  gram_softmax<A, C>(sQKV, sS);  // the forward's S, recomputed

  // dS[n][c1][c2] = sum_t dO[t][c1] v[t][c2]
  for (int e = tid; e < L::NW * C * C; e += kThreads) {
    const int n = e / (C * C), c1 = (e / C) % C, c2 = e % C;
    A acc = 0;
#pragma unroll
    for (int t = 0; t < kP; ++t) {
      const int r = n * kP + t;
      acc = fma(sDO[r * L::DS + c1], sQKV[r * L::QS + 2 * C + c2], acc);
    }
    sD[(n * C + c1) * L::GS + c2] = acc;
  }
  __syncthreads();

  // softmax backward: dL = S (.) (dS - rowsum(S (.) dS)), one warp per row
  const int warp = tid / 32, lane = tid % 32;
  for (int row = warp; row < L::NW * C; row += kWarps) {
    const A* s = sS + row * L::GS;
    A* d = sD + row * L::GS;
    A rs = 0;
    for (int c = lane; c < C; c += 32) rs = fma(s[c], d[c], rs);
    rs = warp_sum_a(rs);
    for (int c = lane; c < C; c += 32) d[c] = s[c] * (d[c] - rs);
  }
  __syncthreads();

  // dv[t][c] = sum_j S[j][c] dO[t][j], stored; dqn[t][c] = sum_j dL[c][j]
  // kn[t][j] and dkn[t][c] = sum_j dL[j][c] qn[t][j], kept for the norm
  // backward
  for (int e = tid; e < L::ROWS * C; e += kThreads) {
    const int r = e / C, c = e % C, n = r / kP;
    const A* s = sS + n * C * L::GS;
    const A* dl = sD + n * C * L::GS;
    const A* u = sQKV + r * L::QS;
    const A* g = sDO + r * L::DS;
    A dv = 0, dq = 0, dk = 0;
#pragma unroll 8
    for (int j = 0; j < C; ++j) {
      dv = fma(s[j * L::GS + c], g[j], dv);
      dq = fma(dl[c * L::GS + j], u[C + j], dq);
      dk = fma(dl[j * L::GS + c], u[j], dk);
    }
    sDQK[r * L::KS + c] = dq;
    sDQK[r * L::KS + C + c] = dk;
    const long long win = win0 + n;
    if (win < n_windows)
      dqkv[pixel_offset(win, r % kP, H, W) * 3 * C + 2 * C + c] = from_f<T>((float)dv);
  }
  __syncthreads();

  // L2-normalize backward: du = (dun - un <un, dun> sel) * inv
  for (int e = tid; e < 2 * L::ROWS; e += kThreads) {
    const int s = e / L::ROWS, r = e % L::ROWS;
    const A* un = sQKV + r * L::QS + s * C;
    const A* dun = sDQK + r * L::KS + s * C;
    A dot = 0;
#pragma unroll 16
    for (int c = 0; c < C; ++c) dot = fma(un[c], dun[c], dot);
    sDot[e] = dot * sSel[e];
  }
  __syncthreads();
  for (int e = tid; e < L::ROWS * 2 * C; e += kThreads) {
    const int r = e / (2 * C), c = e % (2 * C), s = c / C;
    const long long win = win0 + r / kP;
    if (win >= n_windows) continue;
    const A du = (sDQK[r * L::KS + c] - sQKV[r * L::QS + c] * sDot[s * L::ROWS + r]) *
                 sInv[s * L::ROWS + r];
    dqkv[pixel_offset(win, r % kP, H, W) * 3 * C + c] = from_f<T>((float)du);
  }
}

// ---------------------------------------------------------------------------
// bf16: warp MMA
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// C = 8 runs padded to CP = 16 channels inside (m16n8k16 takes 16-deep
// k-steps, and a Gram strip is 16 rows): the pad columns of q, k, v and dO
// are staged as zeros, so qn, kn and the pad rows and columns of dS are 0;
// the pad keys of the Gram are -inf before the softmax, so S is 0 there and
// dL is 0 on the pad keys; the pad rows of S (uniform over the real keys)
// meet zero columns of dO in dv = dO S, and the pad columns of out and
// d(qkv) are never stored.
template <int C>
struct MmaLayout {
  static constexpr int CP = C < 16 ? 16 : C;            // channels inside
  static constexpr int WPW = CP / 16;                   // warps per window
  static constexpr int NWR = kWarps / WPW;              // windows per round
  static constexpr int ROUNDS = CP == 16 ? 4 : CP == 32 ? 2 : 1;
  static constexpr int NWB = NWR * ROUNDS;              // windows per block
  static constexpr int NT = CP / 8;                     // n-tiles of a Gram row strip
  static constexpr int XS = 3 * CP + 8;                 // qkv row (qn hi, kn hi, v)
  static constexpr int LS = 2 * CP + 8;                 // qn lo, kn lo row
  static constexpr int DS = CP + 8;                     // dO / out row; CP x CP rows
  static constexpr int FS = 2 * CP + 4;                 // fp32 dqn, dkn row
  // per window, in elements
  static constexpr int X = kP * XS, LO = kP * LS, D = kP * DS, SQ = CP * DS, F = kP * FS;
  static constexpr int F_BYTES = NWR * (X + LO + D) * (int)sizeof(bf16);
  static constexpr int B_BF16 = NWR * (X + LO + D + 3 * SQ);
  static constexpr int B_BYTES = B_BF16 * (int)sizeof(bf16) + NWR * F * (int)sizeof(float);
};

// Stages the round's windows win0.. with 16-byte cp.async: each position's
// `parts` x C values of `src` (row stride parts * C) into dst + window *
// per_win + p * ld, part i at column i * CP; the pad chunks of a part (C <
// CP) and windows at or past n_windows read as zeros.
template <int C, int CP>
__device__ __forceinline__ void stage_windows(const bf16* __restrict__ src, int parts, bf16* dst,
                                              int per_win, int ld, int nwr, long long win0,
                                              long long n_windows, int H, int W) {
  constexpr int PC = CP / 8;                     // 16-byte chunks of a part inside
  const int chunks = parts * PC, per = kP * chunks;
  for (int e = threadIdx.x; e < nwr * per; e += kThreads) {
    const int wl = e / per, p = (e % per) / chunks, c = e % chunks;
    const int part = c / PC, j = c % PC;
    const long long win = win0 + wl;
    const bool valid = win < n_windows && j < C / 8;
    cp_async16(dst + wl * per_win + p * ld + c * 8,
               valid ? src + pixel_offset(win, p, H, W) * parts * C + part * C + j * 8 : src,
               valid);
  }
}

// The inverse, 16-byte stores of the C real values of each part per
// position; windows at or past n_windows are not stored.
template <int C, int CP>
__device__ __forceinline__ void store_windows(bf16* __restrict__ dst, int parts, const bf16* src,
                                              int per_win, int ld, int nwr, long long win0,
                                              long long n_windows, int H, int W) {
  constexpr int PC = C / 8;                      // real 16-byte chunks of a part
  const int chunks = parts * PC, per = kP * chunks;
  for (int e = threadIdx.x; e < nwr * per; e += kThreads) {
    const int wl = e / per, p = (e % per) / chunks, c = e % chunks;
    const int part = c / PC, j = c % PC;
    const long long win = win0 + wl;
    if (win < n_windows)
      *reinterpret_cast<uint4*>(dst + pixel_offset(win, p, H, W) * parts * C + part * C + j * 8) =
          *reinterpret_cast<const uint4*>(src + wl * per_win + p * ld + part * CP + j * 8);
  }
}

// The thread's share of the L2 normalize and its backward: 16 channels
// (part j of C / 16) of vector s (0 q, 1 k) at position p of window wl.
template <int C>
struct NormSlot {
  int wl, p, s, j;
  __device__ NormSlot() {
    const int vid = threadIdx.x / MmaLayout<C>::WPW;
    j = threadIdx.x % MmaLayout<C>::WPW;
    wl = vid / 32;
    s = (vid / 16) & 1;
    p = vid & 15;
  }
  // column of the share in a row holding q then k
  __device__ int col() const { return s * C + 16 * j; }
};

// Sum over the C / 16 neighbouring lanes that share a vector.
template <int C>
__device__ __forceinline__ float slot_sum(float v) {
#pragma unroll
  for (int o = 1; o < MmaLayout<C>::WPW; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 8 bf16 values (16 bytes) of shared memory as fp32.
__device__ __forceinline__ void load8(const bf16* p, float* u) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    u[2 * i] = f.x;
    u[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load16(const bf16* p, float (&u)[16]) {
  load8(p, u);
  load8(p + 8, u + 8);
}

// 8 channels of the normalize backward's operands: un = hi + lo, and dun.
__device__ __forceinline__ void norm_bwd_load(const bf16* hi, const bf16* lo, const float* g,
                                              float (&un)[8], float (&dun)[8]) {
  float ul[8];
  load8(hi, un);
  load8(lo, ul);
  const float4 a = *reinterpret_cast<const float4*>(g);
  const float4 b = *reinterpret_cast<const float4*>(g + 4);
  const float d[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    un[i] += ul[i];
    dun[i] = d[i];
  }
}

// Normalizes the thread's share in place: un = u inv as hi (over u in the
// qkv row) + lo (into the lo row); returns inv and sel of the vector.
template <int C>
__device__ __forceinline__ void normalize_slot(bf16* x, bf16* lo, float eps, float& inv,
                                               float& sel) {
  float u[16], ss = 0.f;
  load16(x, u);
#pragma unroll
  for (int i = 0; i < 16; ++i) ss = fmaf(u[i], u[i], ss);
  ss = slot_sum<C>(ss);
  const bool nz = ss > 0.f;
  const float n = sqrtf(nz ? ss : 1.f);
  inv = 1.f / (nz ? fmaxf(n, eps) : eps);
  sel = (nz && n > eps) ? 1.f : 0.f;
  uint32_t hi[8], lw[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) pack_bf16_split(u[2 * i] * inv, u[2 * i + 1] * inv, hi[i], lw[i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    *reinterpret_cast<uint4*>(x + 8 * h) = make_uint4(hi[4 * h], hi[4 * h + 1], hi[4 * h + 2], hi[4 * h + 3]);
    *reinterpret_cast<uint4*>(lo + 8 * h) = make_uint4(lw[4 * h], lw[4 * h + 1], lw[4 * h + 2], lw[4 * h + 3]);
  }
}

// acc (16 positions x the 16 columns 16 mt.., two n-tiles) += a m^T, where a
// is [p][c] bf16 rows (hi at a + col0, and lo at al when kSplitA) and m^T's
// B fragments come straight from the C fragments of m's rows 16 mt.. (B[k][n]
// = m[n][k] is the C layout), as hi (+ lo when kSplitB).
template <int C, bool kSplitA, bool kSplitB>
__device__ __forceinline__ void rows_times_strip_t(float (&acc)[2][4], const bf16* a, int lda,
                                                   const bf16* al, int ldl,
                                                   const float (&m)[C / 8][4], int lane) {
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk) {
    uint32_t ah[4], aw[4];
    ldmatrix_x4(ah, a + (lane & 15) * lda + kk * 16 + (lane >> 4) * 8);
    if (kSplitA) ldmatrix_x4(aw, al + (lane & 15) * ldl + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t b0, b1, w0, w1;
      if (kSplitB) {
        pack_bf16_split(m[2 * kk][2 * h], m[2 * kk][2 * h + 1], b0, w0);
        pack_bf16_split(m[2 * kk + 1][2 * h], m[2 * kk + 1][2 * h + 1], b1, w1);
      } else {
        b0 = pack_bf16(m[2 * kk][2 * h], m[2 * kk][2 * h + 1]);
        b1 = pack_bf16(m[2 * kk + 1][2 * h], m[2 * kk + 1][2 * h + 1]);
      }
      mma_bf16(acc[h], ah, b0, b1);
      if (kSplitB) mma_bf16(acc[h], ah, w0, w1);
      if (kSplitA) mma_bf16(acc[h], aw, b0, b1);
    }
  }
}

// acc (16 positions x the 16 columns 16 mt..) += a m, a as [p][c] bf16 rows
// (hi, and lo when kSplit), m a C x C [k][n] bf16 array (hi, and lo when
// kSplit) read through ldmatrix.trans.
template <int C, bool kSplit>
__device__ __forceinline__ void rows_times_square(float (&acc)[2][4], const bf16* a, int lda,
                                                  const bf16* al, int ldl, const bf16* mh,
                                                  const bf16* ml, int mt, int lane) {
  using L = MmaLayout<C>;
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk) {
    uint32_t ah[4], aw[4], bh[4], bl[4];
    ldmatrix_x4(ah, a + (lane & 15) * lda + kk * 16 + (lane >> 4) * 8);
    const int off = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L::DS + mt * 16 +
                    (lane >> 4) * 8;
    ldmatrix_x4_trans(bh, mh + off);
    if (kSplit) {
      ldmatrix_x4(aw, al + (lane & 15) * ldl + kk * 16 + (lane >> 4) * 8);
      ldmatrix_x4_trans(bl, ml + off);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mma_bf16(acc[h], ah, bh[2 * h], bh[2 * h + 1]);
      if (kSplit) {
        mma_bf16(acc[h], ah, bl[2 * h], bl[2 * h + 1]);
        mma_bf16(acc[h], aw, bh[2 * h], bh[2 * h + 1]);
      }
    }
  }
}

// Two n-tiles of C fragments as fp32 at columns c0.. of rows 0..15.
__device__ __forceinline__ void put_strip_f32(float* dst, int ld, int c0, const float (&x)[2][4],
                                              int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(dst + (g + 8 * h) * ld + c0 + j * 8 + 2 * t) =
          make_float2(x[j][2 * h], x[j][2 * h + 1]);
}

// The pad keys (C = 8 inside CP = 16) drop out of the softmax: -inf on the
// n-tiles past C of a Gram row strip.
template <int C, int NT>
__device__ __forceinline__ void mask_pad_keys(float (&s)[NT][4]) {
#pragma unroll
  for (int j = C / 8; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = -INFINITY;
}

template <int C>
__global__ void __launch_bounds__(kThreads)
mid_fwd_mma_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int H, int W,
                   long long n_windows, float eps) {
  using L = MmaLayout<C>;
  constexpr int CP = L::CP;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* sX = reinterpret_cast<bf16*>(smem_mma);   // [NWR][16][XS]
  bf16* sLO = sX + L::NWR * L::X;                 // [NWR][16][LS]
  bf16* sOut = sLO + L::NWR * L::LO;              // [NWR][16][DS]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wl = warp / L::WPW, mt = warp % L::WPW;
  const NormSlot<CP> slot;
  bf16* x = sX + wl * L::X;
  bf16* lo = sLO + wl * L::LO;
  for (int round = 0; round < L::ROUNDS; ++round) {
    const long long win0 = (long long)blockIdx.x * L::NWB + round * L::NWR;
    stage_windows<C, CP>(qkv, 3, sX, L::X, L::XS, L::NWR, win0, n_windows, H, W);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float inv, sel;
    normalize_slot<CP>(sX + slot.wl * L::X + slot.p * L::XS + slot.col(),
                       sLO + slot.wl * L::LO + slot.p * L::LS + slot.col(), eps, inv, sel);
    __syncthreads();
    float s[L::NT][4];
    gram_strip<CP>(s, x, L::XS, lo, L::LS, mt, lane);
    mask_pad_keys<C>(s);
    softmax_strip(s);
    // out[p][c1], c1 in 16 mt.. = sum_c2 v[p][c2] S[c1][c2]; S as hi + lo
    // at C = 8 (see the header)
    float o[2][4] = {};
    rows_times_strip_t<CP, false, (C < 16)>(o, x + 2 * CP, L::XS, nullptr, 0, s, lane);
    store_frags<2>(sOut + wl * L::D, nullptr, L::DS, 0, mt * 16, o, 1.f, lane);
    __syncthreads();
    store_windows<C, CP>(out, 1, sOut, L::D, L::DS, L::NWR, win0, n_windows, H, W);
    __syncthreads();
  }
}

// At least 3 blocks per SM, as many as the shared memory of C = 16 lets in
// (67.6 KB a block, and at C = 8, padded to 16; 2 at C = 32 and 64):
// without that minimum, ptxas held the C = 16 instantiation to 64
// registers and spilled.
template <int C>
__global__ void __launch_bounds__(kThreads, 3)
mid_bwd_mma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                   bf16* __restrict__ dqkv, int H, int W, long long n_windows, float eps) {
  using L = MmaLayout<C>;
  constexpr int CP = L::CP;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* sX = reinterpret_cast<bf16*>(smem_mma);   // [NWR][16][XS]: qn hi, kn hi, v; then dq, dk, dv
  bf16* sLO = sX + L::NWR * L::X;                 // [NWR][16][LS]: qn lo, kn lo
  bf16* sDO = sLO + L::NWR * L::LO;               // [NWR][16][DS]
  bf16* sS = sDO + L::NWR * L::D;                 // [NWR][CP][DS]: S, dL hi, dL lo
  bf16* sDLH = sS + L::NWR * L::SQ;
  bf16* sDLL = sDLH + L::NWR * L::SQ;
  float* sF = reinterpret_cast<float*>(sX + L::B_BF16);   // [NWR][16][FS]: dqn, dkn
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wl = warp / L::WPW, mt = warp % L::WPW;
  const NormSlot<CP> slot;
  bf16* x = sX + wl * L::X;
  bf16* lo = sLO + wl * L::LO;
  bf16* dO = sDO + wl * L::D;
  bf16* S = sS + wl * L::SQ;
  bf16* dlh = sDLH + wl * L::SQ;
  bf16* dll = sDLL + wl * L::SQ;
  float* f = sF + wl * L::F;
  for (int round = 0; round < L::ROUNDS; ++round) {
    const long long win0 = (long long)blockIdx.x * L::NWB + round * L::NWR;
    stage_windows<C, CP>(qkv, 3, sX, L::X, L::XS, L::NWR, win0, n_windows, H, W);
    stage_windows<C, CP>(dout, 1, sDO, L::D, L::DS, L::NWR, win0, n_windows, H, W);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    bf16* sx = sX + slot.wl * L::X + slot.p * L::XS + slot.col();
    bf16* slo = sLO + slot.wl * L::LO + slot.p * L::LS + slot.col();
    float inv, sel;
    normalize_slot<CP>(sx, slo, eps, inv, sel);
    __syncthreads();

    // the warp's rows 16 mt.. of S (recomputed), dS = dO^T v and dL
    float s[L::NT][4], d[L::NT][4];
    gram_strip<CP>(s, x, L::XS, lo, L::LS, mt, lane);
    mask_pad_keys<C>(s);
    softmax_strip(s);
#pragma unroll
    for (int j = 0; j < L::NT; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
    {
      uint32_t a[4];   // A[c1][p] = dO[p][c1] through ldmatrix.trans
      ldmatrix_x4_trans(a, dO + ((lane & 7) + (lane >> 4) * 8) * L::DS + mt * 16 +
                               ((lane >> 3) & 1) * 8);
      const int br = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int nb = 0; nb < CP / 16; ++nb) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, x + br * L::XS + 2 * CP + nb * 16 + (lane >> 4) * 8);
        mma_bf16(d[2 * nb], a, b[0], b[1]);
        mma_bf16(d[2 * nb + 1], a, b[2], b[3]);
      }
    }
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < L::NT; ++j) {
      rs0 += s[j][0] * d[j][0] + s[j][1] * d[j][1];
      rs1 += s[j][2] * d[j][2] + s[j][3] * d[j][3];
    }
    rs0 = quad_sum(rs0);
    rs1 = quad_sum(rs1);
#pragma unroll
    for (int j = 0; j < L::NT; ++j) {
      d[j][0] = s[j][0] * (d[j][0] - rs0);
      d[j][1] = s[j][1] * (d[j][1] - rs0);
      d[j][2] = s[j][2] * (d[j][2] - rs1);
      d[j][3] = s[j][3] * (d[j][3] - rs1);
    }
    store_frags<L::NT>(S, nullptr, L::DS, mt * 16, 0, s, 1.f, lane);
    store_frags<L::NT>(dlh, dll, L::DS, mt * 16, 0, d, 1.f, lane);
    // dqn[p][c1], c1 in 16 mt.. = sum_c2 kn[p][c2] dL[c1][c2], from registers
    float acc[2][4] = {};
    rows_times_strip_t<CP, true, true>(acc, x + CP, L::XS, lo + CP, L::LS, d, lane);
    put_strip_f32(f, L::FS, mt * 16, acc, lane);
    __syncthreads();

    // dv[p][c2] = sum_c1 dO[p][c1] S[c1][c2] and dkn[p][c2] = sum_c1
    // qn[p][c1] dL[c1][c2], c2 in 16 mt..; dv over the v columns (read
    // before the barrier above)
    float dv[2][4] = {};
    rows_times_square<CP, false>(dv, dO, L::DS, nullptr, 0, S, nullptr, mt, lane);
    store_frags<2>(x, nullptr, L::XS, 0, 2 * CP + mt * 16, dv, 1.f, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) acc[h][0] = acc[h][1] = acc[h][2] = acc[h][3] = 0.f;
    rows_times_square<CP, true>(acc, x, L::XS, lo, L::LS, dlh, dll, mt, lane);
    put_strip_f32(f, L::FS, CP + mt * 16, acc, lane);
    __syncthreads();

    // L2-normalize backward, fp32: du = (dun - un <un, dun> sel) inv, un =
    // hi + lo; over the thread's own share of the qn / kn row, 8 channels
    // at a time (the dot, then du over the same values read again)
    {
      const float* g = sF + slot.wl * L::F + slot.p * L::FS + slot.col();
      float un[8], dun[8], dot = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        norm_bwd_load(sx + 8 * h, slo + 8 * h, g + 8 * h, un, dun);
#pragma unroll
        for (int i = 0; i < 8; ++i) dot = fmaf(un[i], dun[i], dot);
      }
      dot = slot_sum<CP>(dot) * sel;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        norm_bwd_load(sx + 8 * h, slo + 8 * h, g + 8 * h, un, dun);
        uint32_t du[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          du[i] = pack_bf16((dun[2 * i] - un[2 * i] * dot) * inv,
                            (dun[2 * i + 1] - un[2 * i + 1] * dot) * inv);
        *reinterpret_cast<uint4*>(sx + 8 * h) = make_uint4(du[0], du[1], du[2], du[3]);
      }
    }
    __syncthreads();
    store_windows<C, CP>(dqkv, 3, sX, L::X, L::XS, L::NWR, win0, n_windows, H, W);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------

long long window_count(int B, int H, int W) { return (long long)B * (H / kWs) * (W / kWs); }

template <int C>
int launch_fwd_f32(const void* qkv, void* out, int B, int H, int W, float eps,
                   cudaStream_t stream) {
  using L = Layout<C>;
  const int smem = L::F_TOTAL * (int)sizeof(float);
  auto kernel = mid_fwd_kernel<float, C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_windows = window_count(B, H, W);
  const long long grid = (n_windows + L::NW - 1) / L::NW;
  if (grid > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(static_cast<const float*>(qkv),
                                                     static_cast<float*>(out), H, W, n_windows, eps);
  return (int)cudaGetLastError();
}

template <int C>
int launch_bwd_f32(const void* qkv, const void* dout, void* dqkv, int B, int H, int W, float eps,
                   cudaStream_t stream) {
  using L = Layout<C>;
  const int smem = L::B_TOTAL * (int)sizeof(double);
  auto kernel = mid_bwd_kernel<float, C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_windows = window_count(B, H, W);
  const long long grid = (n_windows + L::NW - 1) / L::NW;
  if (grid > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(dout), static_cast<float*>(dqkv),
      H, W, n_windows, eps);
  return (int)cudaGetLastError();
}

template <int C>
int launch_fwd_bf16(const void* qkv, void* out, int B, int H, int W, float eps,
                    cudaStream_t stream) {
  using L = MmaLayout<C>;
  auto kernel = mid_fwd_mma_kernel<C>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::F_BYTES);
  if (err != cudaSuccess) return (int)err;
  const long long n_windows = window_count(B, H, W);
  const long long grid = (n_windows + L::NWB - 1) / L::NWB;
  if (grid > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)grid, kThreads, L::F_BYTES, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), H, W, n_windows, eps);
  return (int)cudaGetLastError();
}

template <int C>
int launch_bwd_bf16(const void* qkv, const void* dout, void* dqkv, int B, int H, int W, float eps,
                    cudaStream_t stream) {
  using L = MmaLayout<C>;
  auto kernel = mid_bwd_mma_kernel<C>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::B_BYTES);
  if (err != cudaSuccess) return (int)err;
  const long long n_windows = window_count(B, H, W);
  const long long grid = (n_windows + L::NWB - 1) / L::NWB;
  if (grid > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)grid, kThreads, L::B_BYTES, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout), static_cast<bf16*>(dqkv), H,
      W, n_windows, eps);
  return (int)cudaGetLastError();
}

int fwd_c(const void* qkv, void* out, int B, int H, int W, int C, int dtype, float eps,
          cudaStream_t s) {
  const bool f32 = dtype == kF32;
  if (!f32 && dtype != kBF16) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 8: return f32 ? launch_fwd_f32<8>(qkv, out, B, H, W, eps, s)
                       : launch_fwd_bf16<8>(qkv, out, B, H, W, eps, s);
    case 16: return f32 ? launch_fwd_f32<16>(qkv, out, B, H, W, eps, s)
                        : launch_fwd_bf16<16>(qkv, out, B, H, W, eps, s);
    case 32: return f32 ? launch_fwd_f32<32>(qkv, out, B, H, W, eps, s)
                        : launch_fwd_bf16<32>(qkv, out, B, H, W, eps, s);
    case 64: return f32 ? launch_fwd_f32<64>(qkv, out, B, H, W, eps, s)
                        : launch_fwd_bf16<64>(qkv, out, B, H, W, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int bwd_c(const void* qkv, const void* dout, void* dqkv, int B, int H, int W, int C, int dtype,
          float eps, cudaStream_t s) {
  const bool f32 = dtype == kF32;
  if (!f32 && dtype != kBF16) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 8: return f32 ? launch_bwd_f32<8>(qkv, dout, dqkv, B, H, W, eps, s)
                       : launch_bwd_bf16<8>(qkv, dout, dqkv, B, H, W, eps, s);
    case 16: return f32 ? launch_bwd_f32<16>(qkv, dout, dqkv, B, H, W, eps, s)
                        : launch_bwd_bf16<16>(qkv, dout, dqkv, B, H, W, eps, s);
    case 32: return f32 ? launch_bwd_f32<32>(qkv, dout, dqkv, B, H, W, eps, s)
                        : launch_bwd_bf16<32>(qkv, dout, dqkv, B, H, W, eps, s);
    case 64: return f32 ? launch_bwd_f32<64>(qkv, dout, dqkv, B, H, W, eps, s)
                        : launch_bwd_bf16<64>(qkv, dout, dqkv, B, H, W, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace mstgan

// Plain C entry points (loaded with ctypes). qkv and dqkv are (B, H, W, 3C),
// out and dout (B, H, W, C), all contiguous and 16-byte aligned, of one type
// (dtype 0 = fp32, 1 = bf16), with H % 4 == W % 4 == 0 and C in {8, 16,
// 32, 64}. Each launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int window_attention_train_fwd_launch(const void* qkv, void* out, int B, int H,
                                                 int W, int C, int dtype, float eps,
                                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return mstgan::fwd_c(qkv, out, B, H, W, C, dtype, eps, static_cast<cudaStream_t>(stream));
}

extern "C" int window_attention_train_bwd_launch(const void* qkv, const void* dout,
                                                 void* dqkv, int B, int H, int W, int C,
                                                 int dtype, float eps, int device,
                                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return mstgan::bwd_c(qkv, dout, dqkv, B, H, W, C, dtype, eps,
                       static_cast<cudaStream_t>(stream));
}
