// Stage prefixes of the windowed channel-attention kernel, for Hopper
// (sm_90a): a measuring instrument, not a path of the model.
//
// Replaces the TPU stage-ablation kernel of scripts/ab_v3_ablation.py
// (run_stage, pallas_call at :121), which times cumulative prefixes of the
// v3 attention body to find where its time goes. Here the prefixes are
// those of this port's own kernel body (window_channel_attention.cuh,
// kStage): copy, qkv, norm, logits, softmax, full. Each stage stores a
// result folded from everything it computed, so nvcc cannot drop its work;
// `full` is the op itself, bit-equal to window_channel_attention_launch.
// Only the NHWC layout is instantiated (the TPU harness takes NHWC in).
//
// What bounds each stage. Every stage reads x once and writes y once (4*C
// bytes per pixel in bf16); its operations grow with the prefix: none for
// copy, 6*C^2 flops per pixel for qkv, about 6*C more for norm, 2*C^2
// more for the Gram of logits and softmax, 12*C^2 for full. At C <= 64 that is
// under the tensor-core ridge, so bytes bound every stage on the card
// (copy's time is the kernel's floor); the deltas between stages show what
// each step of the chain costs this kernel, which does its products with
// fp32 FMAs on the CUDA cores.
#include "window_channel_attention.cuh"

namespace mstgan {
namespace {

int launch_stage(const void* x, const void* wqkv, const void* bqkv, const void* wproj,
                 const void* bproj, void* y, int H, int W, long long n_windows, int C,
                 int stage, int dtype, float eps, int device, void* stream) {
  switch (stage) {
    case kCopy:
      return launch_dtype<false, kCopy>(x, wqkv, bqkv, wproj, bproj, y, H, W, n_windows, C,
                                        dtype, eps, device, stream);
    case kQkv:
      return launch_dtype<false, kQkv>(x, wqkv, bqkv, wproj, bproj, y, H, W, n_windows, C,
                                       dtype, eps, device, stream);
    case kNorm:
      return launch_dtype<false, kNorm>(x, wqkv, bqkv, wproj, bproj, y, H, W, n_windows, C,
                                        dtype, eps, device, stream);
    case kLogits:
      return launch_dtype<false, kLogits>(x, wqkv, bqkv, wproj, bproj, y, H, W, n_windows, C,
                                          dtype, eps, device, stream);
    case kSoftmax:
      return launch_dtype<false, kSoftmax>(x, wqkv, bqkv, wproj, bproj, y, H, W, n_windows, C,
                                           dtype, eps, device, stream);
    case kFull:
      return launch_dtype<false, kFull>(x, wqkv, bqkv, wproj, bproj, y, H, W, n_windows, C,
                                        dtype, eps, device, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace mstgan

// Plain C entry point (loaded with ctypes). x and y (B, H, W, C)
// contiguous, H % 4 == W % 4 == 0; weights wqkv (3C, C), bqkv (3C), wproj
// (C, C), bproj (C) in the input's type (dtype 0 = fp32, 1 = bf16); C in
// {16, 32, 64}; stage 0..5 = copy, qkv, norm, logits, softmax, full.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int window_channel_attention_stage_launch(const void* x, const void* wqkv,
                                                     const void* bqkv, const void* wproj,
                                                     const void* bproj, void* y, int B, int H,
                                                     int W, int C, int stage, int dtype,
                                                     float eps, int device, void* stream) {
  const long long n_windows = (long long)B * (H / mstgan::kWs) * (W / mstgan::kWs);
  return mstgan::launch_stage(x, wqkv, bqkv, wproj, bproj, y, H, W, n_windows, C, stage, dtype,
                              eps, device, stream);
}
