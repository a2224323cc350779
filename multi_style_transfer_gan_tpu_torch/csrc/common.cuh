// Shared helpers for the port's hand-written kernels: element-type
// conversions (fp32 or bf16 storage, fp32 arithmetic), 4-wide loads, warp
// reductions and the grid size of the persistent kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mstgan {

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// Four consecutive elements as fp32, read through the read-only path.
// The pointer must be aligned to 4 elements (the wrappers check 16 bytes).
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Sum and max over the 32 lanes of a warp; every lane gets the result.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The grid of a persistent kernel whose blocks stride over `n_units` units
// of work: one block per unit until the card is full, `blocks_per_sm`
// resident blocks on each of `sms` SMs; never less than one block.
inline int persistent_grid(long long n_units, int sms, int blocks_per_sm) {
  const long long cap = (long long)sms * blocks_per_sm;
  const long long grid = n_units < cap ? n_units : cap;
  return grid < 1 ? 1 : (int)grid;
}

// What persistent_grid needs to know of the current device for `kernel`
// launched with `threads` threads and `smem` bytes of dynamic shared memory:
// its SM count and the resident blocks per SM the runtime reports. Returns
// a CUDA error code, 0 on success.
template <typename K>
int residency(K kernel, int threads, int smem, int* sms, int* blocks_per_sm) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, threads, smem);
  if (err == cudaSuccess && *blocks_per_sm < 1) err = cudaErrorLaunchOutOfResources;
  if (err != cudaSuccess) *sms = 0;   // a caller that keeps the answer asks again
  return (int)err;
}

}  // namespace mstgan
