// Window relayout between NHWC and packed (space-to-depth) rows, for
// Hopper (sm_90a): the packed engine's space_to_depth / depth_to_space.
//
// Replaces ops/pallas/window_relayout.py::s2d_rows and ::d2s_rows of the JAX
// package (the NHWC <-> window-major row copies, done there as VMEM block
// copies). For a factor f, NHWC x (B, H, W, C) and packed rows
// (B, H/f, W/f, f*f*C) in the (pi, pj, c) channel order:
//   rows[b, hp, wp, (pi*f + pj)*C + c] = x[b, hp*f + pi, wp*f + pj, c].
// Both sides hold the same f*C-element segments: segment (b, h, wp) is
// x[b, h, wp*f : wp*f + f, :] in NHWC and lane span [pi*f*C, (pi+1)*f*C) of
// packed pixel (b, h / f, wp), pi = h % f. Numbered in NHWC order the
// segments are contiguous in x; the packed side places each at
//   s' = ((b*H/f + h/f) * W/f + wp) * f + pi.
//
// What bounds it: a copy, 2 bytes of traffic per byte, no arithmetic. The
// design makes both sides wide: the kernel moves bytes, not elements, in
// units of the widest of 16/8/4/2 bytes that divides a segment and both
// pointers' alignment (16 bytes at C = 64 bf16 and C = 3 fp32; 8 at C = 3
// bf16), consecutive threads on consecutive units. The NHWC side is read or
// written in one unbroken stream; the packed side in runs of one segment.
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace mstgan {
namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 32;  // grid-stride beyond this

template <typename V, bool kToRows>
__global__ void __launch_bounds__(kThreads)
window_relayout_kernel(const V* __restrict__ src, V* __restrict__ dst, long long n_units,
                       int seg_units, int Wp, int f) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x; t < n_units; t += stride) {
    const long long seg = t / seg_units;          // NHWC segment (b, h, wp)
    const int u = (int)(t - seg * seg_units);
    const long long bh = seg / Wp;                 // b * H + h
    const int wp = (int)(seg - bh * Wp);
    const long long bhp = bh / f;                  // b * H/f + h/f
    const int pi = (int)(bh - bhp * f);
    const long long row = ((bhp * Wp + wp) * f + pi) * seg_units + u;
    if (kToRows)
      dst[row] = src[t];
    else
      dst[t] = src[row];
  }
}

template <typename V>
int launch(const void* src, void* dst, long long n_seg, int seg_bytes, int Wp, int f,
           bool to_rows, cudaStream_t stream) {
  const int seg_units = seg_bytes / (int)sizeof(V);
  const long long n_units = n_seg * seg_units;
  long long blocks = (n_units + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const V* s = static_cast<const V*>(src);
  V* d = static_cast<V*>(dst);
  if (to_rows)
    window_relayout_kernel<V, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        s, d, n_units, seg_units, Wp, f);
  else
    window_relayout_kernel<V, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        s, d, n_units, seg_units, Wp, f);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace mstgan

// Plain C entry point (loaded with ctypes). NHWC shape (B, H, W, C) with
// H % f == W % f == 0; elem_bytes the element size (any type: the kernel
// copies bytes). to_rows = 1: src NHWC -> dst packed rows (space_to_depth);
// 0: src packed rows -> dst NHWC (depth_to_space). Both contiguous, not
// overlapping. Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int window_relayout_launch(const void* src, void* dst, int B, int H, int W, int C,
                                      int f, int elem_bytes, int to_rows, int device,
                                      void* stream) {
  if (f <= 0 || H % f || W % f || C <= 0 || elem_bytes <= 0) return (int)cudaErrorInvalidValue;
  const long long n_seg = (long long)B * H * (W / f);
  if (n_seg <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long seg_bytes = (long long)f * C * elem_bytes;
  if (seg_bytes > INT_MAX) return (int)cudaErrorInvalidValue;
  const uintptr_t align = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst) |
                          static_cast<uintptr_t>(seg_bytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int sb = (int)seg_bytes, Wp = W / f;
  const bool rows = to_rows != 0;
  if (align % 16 == 0) return mstgan::launch<uint4>(src, dst, n_seg, sb, Wp, f, rows, s);
  if (align % 8 == 0) return mstgan::launch<uint2>(src, dst, n_seg, sb, Wp, f, rows, s);
  if (align % 4 == 0) return mstgan::launch<unsigned int>(src, dst, n_seg, sb, Wp, f, rows, s);
  if (align % 2 == 0) return mstgan::launch<unsigned short>(src, dst, n_seg, sb, Wp, f, rows, s);
  return mstgan::launch<unsigned char>(src, dst, n_seg, sb, Wp, f, rows, s);
}
