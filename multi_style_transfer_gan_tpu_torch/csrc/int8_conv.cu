// int8 x int8 -> int32 convolution for Hopper (sm_90a): the int8 serving
// engine's every convolution (models/quantized_generator.py).
//
// Replaces no Pallas kernel: the JAX package runs these convolutions as XLA
// int8 convolutions (models/quantized_generator.py:86-106, `_conv_i8` and
// `_convt_i8_k4s2p1`, lax.conv_general_dilated with
// preferred_element_type=int32). PyTorch has no int8 convolution on CUDA,
// so this is the port's own.
//
// The op, an implicit GEMM: M = B * Ho * Wo output pixels, N = Cout, K =
// KH * KW * Cin in (kh, kw, cin) order. A[m][k] is the input pixel of tap
// (kh, kw) of output pixel m, quantized on load,
//   q = clamp(rint(x / s_in[cin]), -127, 127)      (IEEE division, ties even)
// with 0 where the tap falls in the padding (quantize-then-pad). B[k][n] is
// the int8 weight, laid out at build time as (phases, Npad, Kpad), K-major,
// Cout padded to 8 and K to 32 with zeros. ConvTranspose2d(4, 2, 1) runs as
// its four output phases (blockIdx.z), each a 2x2 convolution over the
// input with its taps of the kernel (exact in integers): output row 2u + py
// takes input rows u - 1 + py + dh, dh = 0, 1, with kernel row 3 - py - 2 dh
// (the wrapper lays out the phases; ops/kernels/int8_conv.py).
//
// Epilogue (mode): 0 the int32 sums; 1 bf16 of the sums, rounded through
// fp32 as XLA's and PyTorch's int32 -> bf16 casts do (two roundings past
// 2^24); 2 bf16(acc * s_w[n] + bias[n]), the products and the sum rounded
// separately (__fmul_rn, __fadd_rn: nvcc would contract them into one FMA,
// which XLA does not). The output may be a channel slice [coff, coff + Cout)
// of a (B, Hout, Wout, ld) tensor, so the multi-scale block's four branches
// write their concatenation in place.
//
// What bounds it: at the generator's widths (Cout 3 .. 4C, K up to 49 C)
// the products are a few GOPs a forward against 1,979 int8 TOPS, so the
// bytes bound it: each bf16 input read once (2 bytes an element, the taps
// re-read from L1/L2) and the output written once. The design: mma.sync
// m16n8k32 on int8 operands staged through shared memory, 128 output
// pixels x BN (8 .. 64) channels a block of four warps, each warp 32 pixels
// x BN; K in steps of 32 in two shared buffers, the next step's bf16 loads
// issued before the current step's products and quantized after them. Rows
// are 48 bytes apart in shared memory, so the 32-bit fragment loads of the
// eight rows of a quad group fall in distinct banks. A simple kernel:
// wgmma, TMA and one launch for the four branches are later work.
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace mstgan {
namespace {

constexpr int kBM = 128;       // output pixels a block
constexpr int kBK = 32;        // k a step (one m16n8k32)
constexpr int kThreads = 128;  // four warps, 32 pixels each
constexpr int kRow = 48;       // bytes between shared rows (32 + 16)
constexpr int kRowsPerThread = kBM * kBK / 8 / kThreads;  // 8-wide groups: 4

struct Args {
  const __nv_bfloat16* x;  // (B, H, W, Cin)
  const float* s_in;       // (Cin,)
  const int8_t* w;         // (phases, Npad, Kpad)
  const float* s_w;        // (Cout,), mode 2
  const float* bias;       // (Cout,) or null, mode 2
  void* out;               // (B, Hout, Wout, ld): int32 (mode 0) or bf16
  int B, H, W, Cin, Cout, KH, KW, stride, pad, dil, transposed;
  int Ho, Wo, K, Kpad, Npad, Hout, Wout, ld, coff, mode;
};

__device__ __forceinline__ int quantize(float v, float s) {
  const float q = rintf(__fdiv_rn(v, s));
  return (int)fminf(fmaxf(q, -127.f), 127.f);
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) | ((uint32_t)(c & 0xff) << 16) |
         ((uint32_t)(d & 0xff) << 24);
}

// 8 bf16 (one uint4) quantized with the scales of channels c0 .. c0 + 7
__device__ __forceinline__ uint2 quantize8(uint4 raw, const float* s) {
  const float4 s0 = __ldg(reinterpret_cast<const float4*>(s));
  const float4 s1 = __ldg(reinterpret_cast<const float4*>(s + 4));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 v0 = __bfloat1622float2(h[0]), v1 = __bfloat1622float2(h[1]);
  const float2 v2 = __bfloat1622float2(h[2]), v3 = __bfloat1622float2(h[3]);
  return make_uint2(pack4(quantize(v0.x, s0.x), quantize(v0.y, s0.y), quantize(v1.x, s0.z),
                          quantize(v1.y, s0.w)),
                    pack4(quantize(v2.x, s1.x), quantize(v2.y, s1.y), quantize(v3.x, s1.z),
                          quantize(v3.y, s1.w)));
}

template <int BN, bool kVec>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(Args a) {
  __shared__ __align__(16) uint8_t sa[2][kBM * kRow];
  __shared__ __align__(16) uint8_t sb[2][BN * kRow];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long M = (long long)a.B * a.Ho * a.Wo;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int phase = blockIdx.z, py = phase >> 1, px = phase & 1;
  const int pad_h = a.transposed ? 1 - py : a.pad, pad_w = a.transposed ? 1 - px : a.pad;
  const int8_t* w = a.w + (long long)phase * a.Npad * a.Kpad;

  // this thread's four A rows and its 8-wide k group within a step
  const int kg = tid & 3;
  int row_b[kRowsPerThread], row_h[kRowsPerThread], row_w[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const long long m = m0 + (tid >> 2) + i * (kThreads / 4);
    if (m < M) {
      const int wo = (int)(m % a.Wo);
      const long long bh = m / a.Wo;
      row_b[i] = (int)(bh / a.Ho);
      row_h[i] = (int)(bh % a.Ho) * a.stride - pad_h;
      row_w[i] = wo * a.stride - pad_w;
    } else {
      row_b[i] = -1;
    }
  }

  // where tap k of row i reads; false in the padding, past K or past M
  auto tap = [&](int i, int k, long long& off) -> bool {
    if (row_b[i] < 0 || k >= a.K) return false;
    const int tp = k / a.Cin, c = k - tp * a.Cin;
    const int kh = tp / a.KW, kw = tp - kh * a.KW;
    const int hi = row_h[i] + kh * a.dil, wi = row_w[i] + kw * a.dil;
    if (hi < 0 || hi >= a.H || wi < 0 || wi >= a.W) return false;
    off = (((long long)row_b[i] * a.H + hi) * a.W + wi) * a.Cin + c;
    return true;
  };

  uint4 raw[kRowsPerThread];  // kVec: the next step's bf16, quantized later
  bool live[kRowsPerThread];
  int chan[kRowsPerThread];
  uint4 wraw;

  auto load = [&](int k0) {
    const int k = k0 + kg * 8;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      long long off = 0;
      if (kVec) {
        live[i] = tap(i, k, off);
        chan[i] = k % a.Cin;
        raw[i] = live[i] ? __ldg(reinterpret_cast<const uint4*>(a.x + off)) : make_uint4(0, 0, 0, 0);
      }
    }
    if (tid < BN * 2) {
      const int n = n0 + (tid >> 1);
      wraw = n < a.Npad ? __ldg(reinterpret_cast<const uint4*>(
                              w + (long long)n * a.Kpad + k0 + (tid & 1) * 16))
                        : make_uint4(0, 0, 0, 0);
    }
  };

  auto store = [&](int buf, int k0) {
    const int k = k0 + kg * 8;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      uint2 q;
      if (kVec) {
        q = live[i] ? quantize8(raw[i], a.s_in + chan[i]) : make_uint2(0, 0);
      } else {  // any Cin: element by element
        int v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          long long off = 0;
          v[j] = tap(i, k + j, off)
                     ? quantize(__bfloat162float(a.x[off]), __ldg(a.s_in + (k + j) % a.Cin))
                     : 0;
        }
        q = make_uint2(pack4(v[0], v[1], v[2], v[3]), pack4(v[4], v[5], v[6], v[7]));
      }
      const int r = (tid >> 2) + i * (kThreads / 4);
      *reinterpret_cast<uint2*>(&sa[buf][r * kRow + kg * 8]) = q;
    }
    if (tid < BN * 2)
      *reinterpret_cast<uint4*>(&sb[buf][(tid >> 1) * kRow + (tid & 1) * 16]) = wraw;
  };

  int acc[2][BN / 8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] =
        acc[mt][nt][3] = 0;

  const int steps = a.Kpad / kBK;
  load(0);
  store(0, 0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) load((s + 1) * kBK);
    uint32_t fa[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const uint8_t* p = &sa[buf][(warp * 32 + mt * 16 + g) * kRow + 4 * t];
      fa[mt][0] = *reinterpret_cast<const uint32_t*>(p);
      fa[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kRow);
      fa[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
      fa[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kRow + 16);
    }
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const uint8_t* p = &sb[buf][(nt * 8 + g) * kRow + 4 * t];
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 16);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][nt], fa[mt], b0, b1);
    }
    if (s + 1 < steps) store(buf ^ 1, (s + 1) * kBK);
    __syncthreads();
  }

  // epilogue: rows g and g + 8 of each m-tile, columns 2t, 2t + 1 of each n-tile
  const int os = a.transposed ? 2 : 1, oy = a.transposed ? py : 0, ox = a.transposed ? px : 0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + warp * 32 + mt * 16 + g + 8 * h;
      if (m >= M) continue;
      const int wo = (int)(m % a.Wo);
      const long long bh = m / a.Wo;
      const int b = (int)(bh / a.Ho), ho = (int)(bh % a.Ho);
      const long long base =
          (((long long)b * a.Hout + ho * os + oy) * a.Wout + wo * os + ox) * a.ld + a.coff;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n0 + nt * 8 + 2 * t + j;
          if (n >= a.Cout) continue;
          const int v = acc[mt][nt][2 * h + j];
          if (a.mode == 0) {
            static_cast<int*>(a.out)[base + n] = v;
          } else {
            float f = __int2float_rn(v);
            if (a.mode == 2) {
              f = __fmul_rn(f, __ldg(a.s_w + n));
              if (a.bias) f = __fadd_rn(f, __ldg(a.bias + n));
            }
            static_cast<__nv_bfloat16*>(a.out)[base + n] = __float2bfloat16_rn(f);
          }
        }
    }
}

template <int BN>
int launch_bn(const Args& a, bool vec, dim3 grid, cudaStream_t stream) {
  if (vec)
    int8_conv_kernel<BN, true><<<grid, kThreads, 0, stream>>>(a);
  else
    int8_conv_kernel<BN, false><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace mstgan

// Plain C entry point (loaded with ctypes). x (B, H, W, Cin) bf16 NHWC
// contiguous, 16-byte aligned; s_in (Cin,) fp32; w (phases, Npad, Kpad)
// int8, phases 4 when `transposed` (ConvTranspose2d(4, 2, 1), KH = KW = 2
// a phase, the output 2H x 2W) and 1 otherwise; Npad a multiple of 8 at
// least Cout, Kpad a multiple of 32 at least KH * KW * Cin, 16-byte
// aligned. out (B, Hout, Wout, ld), channels [coff, coff + Cout) written:
// int32 (mode 0) or bf16 (modes 1, 2; mode 2 reads s_w (Cout,) and bias
// (Cout,) fp32, bias may be null). Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int int8_conv_launch(const void* x, const void* s_in, const void* w, const void* s_w,
                                const void* bias, void* out, int B, int H, int W, int Cin,
                                int Cout, int KH, int KW, int stride, int pad, int dil,
                                int transposed, int Kpad, int Npad, int Hout, int Wout, int ld,
                                int coff, int mode, int device, void* stream) {
  mstgan::Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(s_in),
                 static_cast<const int8_t*>(w), static_cast<const float*>(s_w),
                 static_cast<const float*>(bias), out, B, H, W, Cin, Cout, KH, KW, stride, pad,
                 dil, transposed, 0, 0, KH * KW * Cin, Kpad, Npad, Hout, Wout, ld, coff, mode};
  if (transposed) {
    if (KH != 2 || KW != 2 || Hout != 2 * H || Wout != 2 * W) return (int)cudaErrorInvalidValue;
    a.Ho = H;
    a.Wo = W;
    a.stride = 1;
    a.dil = 1;
  } else {
    a.Ho = (H + 2 * pad - dil * (KH - 1) - 1) / stride + 1;
    a.Wo = (W + 2 * pad - dil * (KW - 1) - 1) / stride + 1;
    if (a.Ho != Hout || a.Wo != Wout) return (int)cudaErrorInvalidValue;
  }
  if (B <= 0 || Cin <= 0 || Cout <= 0 || Npad % 8 || Npad < Cout || Kpad % 32 || Kpad < a.K ||
      coff < 0 || coff + Cout > ld || mode < 0 || mode > 2 || (mode == 2 && !s_w))
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * a.Ho * a.Wo;
  if (M <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int bn = Npad > 32 ? 64 : Npad > 16 ? 32 : Npad > 8 ? 16 : 8;
  const dim3 grid((unsigned)((M + mstgan::kBM - 1) / mstgan::kBM), (unsigned)((Npad + bn - 1) / bn),
                  transposed ? 4 : 1);
  const bool vec = Cin % 8 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 64: return mstgan::launch_bn<64>(a, vec, grid, s);
    case 32: return mstgan::launch_bn<32>(a, vec, grid, s);
    case 16: return mstgan::launch_bn<16>(a, vec, grid, s);
    default: return mstgan::launch_bn<8>(a, vec, grid, s);
  }
}
