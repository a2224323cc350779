// Windowed channel attention (the EnhancedGenerator's LocalAttention),
// inference forward, for Hopper (sm_90a), on two layouts of one op.
//
// NHWC (window_channel_attention_launch) replaces the three TPU layouts of
// the op on unpacked activations in the JAX package:
//   ops/pallas/window_attention.py::fused_window_channel_attention (v1),
//   ops/pallas/window_attention_grouped.py::grouped_window_channel_attention,
//   ops/pallas/window_attention_v3.py::window_attention_v3.
// Packed rows (packed_window_channel_attention_launch) replace the three
// kernels of the packed (space-to-depth) engine, whose activations hold one
// 4x4 window per packed pixel, position major (lane p*C + c, p = 4*pi + pj):
//   ops/pallas/window_attention_grouped.py::packed_grouped_window_attention,
//   ops/pallas/window_attention_v3.py::packed_window_attention_v3,
//   ops/pallas/packed_attention.py::packed_window_attention_pallas.
// The two layouts differ only in where position p of window w lives
// (`pixel_offset` in the header), so one kernel body serves both; the TPU kernels'
// expanded block-diagonal weights, 0/1 rep/tile matrices and lane-stacked
// groups were answers to 128-lane tiles and have no counterpart here.
//
// The kernel body (the op, what bounds it, the design) is in
// window_channel_attention.cuh; this source instantiates its kFull stage
// only.
#include "window_channel_attention.cuh"

// Plain C entry points (loaded with ctypes). Weights: wqkv (3C, C), bqkv
// (3C), wproj (C, C), bproj (C), in the input's type: dtype 0 = fp32,
// 1 = bf16; C in {16, 32, 64}. Each launches on `stream` and returns
// cudaGetLastError() (0 on success).
//
// x and y (B, H, W, C) contiguous, H % 4 == W % 4 == 0.
extern "C" int window_channel_attention_launch(const void* x, const void* wqkv,
                                               const void* bqkv, const void* wproj,
                                               const void* bproj, void* y, int B, int H,
                                               int W, int C, int dtype, float eps,
                                               int device, void* stream) {
  const long long n_windows = (long long)B * (H / mstgan::kWs) * (W / mstgan::kWs);
  return mstgan::launch_dtype<false, mstgan::kFull>(x, wqkv, bqkv, wproj, bproj, y, H, W,
                                                    n_windows, C, dtype, eps, device, stream);
}

// x and y packed (B, Hp, Wp, 16*C) contiguous: one window per packed pixel.
extern "C" int packed_window_channel_attention_launch(const void* x, const void* wqkv,
                                                      const void* bqkv, const void* wproj,
                                                      const void* bproj, void* y, int B,
                                                      int Hp, int Wp, int C, int dtype,
                                                      float eps, int device, void* stream) {
  const long long n_windows = (long long)B * Hp * Wp;
  return mstgan::launch_dtype<true, mstgan::kFull>(x, wqkv, bqkv, wproj, bproj, y,
                                                   Hp * mstgan::kWs, Wp * mstgan::kWs, n_windows,
                                                   C, dtype, eps, device, stream);
}
