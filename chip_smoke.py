"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths (``multi_style_transfer_gan_tpu_torch``) on the
card, serving at the full width of the trained c16 EnhancedGenerator shipped
in ``trained/`` with both engines (NHWC and packed space-to-depth) and every
mode of the uint8 program (``cyclegan``, and ``local_style`` with the
enhanced and advanced post chains), the single-image pipelines, CycleGAN
training at the reference configuration, the plain generator and
masked-inpainting pretraining at the reference's width, the evaluation
path (metrics, folder comparisons, FID on a full-width InceptionV3), the
GUI's tab workers and the checkpoint tools, the VGG16 perceptual + Gram
loss in the train step, the c8 and c32 EnhancedGenerators on the serving
kernels' other widths and trained (CycleGAN and enhanced pretraining), and
checks every hand-written kernel on the way:

1. build: all six CUDA sources compile from ``csrc/`` at once, one nvcc
   each;
2. window channel attention, kernel vs plain PyTorch at every shape the
   generator gives it at canvas 256 and 512 (fp32 with TF32 off, and bf16),
   on three inputs each (random, a flat window with a saturated softmax, a
   window whose q and k have norms ~1e-3 under zero q and k biases), every
   one with an all-zero window;
3. the same op on packed rows (the packed engine's layout), kernel vs
   plain at every packed-engine shape on the same three inputs, beside the
   NHWC kernel's time at the same windows; the window relayout, kernel vs
   plain, bit-exact;
4. the fused transformer block, kernel vs plain, including a ragged grid,
   on a random input and on one with 16-fold scores (a saturated softmax),
   each with an all-zero window; then the attention and the block at the
   shapes ``generate_new_image`` gives them on a 1000 x 760 photo (992 x
   752: a 188 x 248 token grid, ragged), fp32 and bf16;
5. the training kernels (channel-attention mid, window-MHSA mid), forward
   and backward, kernel vs plain at every training shape on three inputs
   (random, a saturated softmax, a window whose q and k have norms ~1e-3),
   each with one all-zero window;
6. the stage kernels of the channel attention (copy, qkv, norm, logits,
   softmax, full), each vs its plain version at the three canvas-256
   attention shapes (fp32 with TF32 off, and bf16) and on the ablation
   tool's own bf16 inputs at each shape the ablation path gives them,
   ``full`` bit-equal to the production kernel;
7. the local-style post chains alone (no kernel of their own: plain
   PyTorch in fp32), card vs CPU on the same canvas and styled arrays: the
   sky mask, the detail mask and Canny, then every mode with colour boost
   and smoothing on and off, on a batch with an image that trips the
   has-sky gate and one whose Canny map is dense; each chain's CUDA-event
   ms, device ms and device operations per batch at the rate cells;
8. serving path: the uint8 -> uint8 stylize program on the trained weights
   with each engine (fp32 on the card vs the plain path on the CPU, packed
   vs NHWC on the card, launch counts per forward, the enhanced and
   advanced programs card vs CPU, bf16 img/s of both engines at canvas 256
   and 512, batch 16 and 64, and of the enhanced and advanced programs at
   ``MODE_CELLS``), the batch CLI on 24 JPEGs of mixed sizes with
   ``--engine packed``, ``auto`` and ``nhwc`` and with ``--mode
   local_style`` in both post chains, the HTTP server answering 4 requests
   with each engine and one in ``local_style`` ``enhanced``;
9. single-image path: the ``direct_transform``, ``enhanced_local_style``
   and ``improved_smooth`` CLIs and the five advanced variants, each card
   vs CPU (``phase_single_image`` says which paths draw figures and are not
   driven here);
10. training path: the bf16 train step at c16, 256^2, batch 8 (launches
    per step, finite losses, moved G, D and u, ms/step), one fp32 step on
    the card vs the CPU, and the train CLI writing, resuming and producing
    a generator that stylizes;
11. pretraining path: the plain generator at the reference's width (c64)
    from a legacy checkpoint (fp32 forward and uint8 program card vs CPU,
    bf16 img/s at canvas 256, batch 16 and 64), masked-inpainting
    pretraining (the plain bf16 step at c64, 256^2, batch 16 with ms/step
    and the device idle share; two fp32 steps card vs CPU; the enhanced
    bf16 step at c16, 256^2, batch 8 with its launches per step), and the
    pretrain CLI writing, resuming and serving its checkpoint through the
    batch CLI;
12. evaluation path: the metrics card vs CPU (``check_metrics_device``'s
    probe; random and smooth pairs at 256^2 and 512^2 with every TF32
    switch on; SSIM(x, x)) and ``compare_pair`` pairs/s; m_test's FID
    harness with the trained G_AB and G_BA on a ``write_domains`` test
    tree, InceptionV3 features from a seeded random full-width ``.pth``
    and the fallback features, card vs CPU, each run's launches (4 + 1 a
    generator forward), both timed at 100 images a direction with their
    host split and device busy share; ``compare_folder_pair`` on the batch
    CLI's folders card vs CPU, and the ``improved_image_compare`` and
    ``prepare_comparison_folders`` CLIs (``phase_folders`` says which
    entry points draw figures and are not driven here);
13. GUI and tools path: the GUI's ModelManager loads its four fixed files
    (the trained pair, a seeded plain c64 pair) on the card and the CPU;
    every tab worker (standard, local style in three modes with its
    toggles, cyclegan) on three photos card vs CPU, the GUI's masks, each
    tab's wall per image and launches; the ``pth_info`` and
    ``convert_model`` CLIs (the converted file serves the same bits),
    ``debug_model`` and its two-variant forward, and
    ``generate_new_image``'s transform of a 1000 x 760 photo card vs CPU
    (``phase_gui`` says what draws a figure and is not driven here);
14. perceptual training path: the bf16 train step at c16, 256^2, batch 8
    with the VGG16 perceptual + Gram loss (a seeded random full-width
    VGG16) as its ``extra_g_loss`` (launches per step, finite losses,
    moved G, D and u, ms/step with and without the hook in turns, the
    trunk's device share), one fp32 hooked step and the loss alone card vs
    CPU;
15. ablation path: the stage-ablation tool
    (``python -m multi_style_transfer_gan_tpu_torch.tools.attention_ablation``)
    at the TPU script's default shape (96 x 512^2, C = 16) and at the
    canvas-256 batch-64 shapes of C = 32 and 64, its tables printed;
16. widths (``phase_width_kernels``, after step 4, and the width serving
    path after the serving path): the attention (NHWC and packed), the
    relayout and the block at the shapes of a canvas-256 forward of seeded
    c8 and c32 generators (attention at C = 8 and 128, blocks of 32 and 128
    channels with 1 and 4 heads), kernel vs plain on the stress inputs in
    fp32 and bf16 with event and device time and the bound; then each
    generator written to a ``.pth`` and served through ``load_generator``:
    the fp32 program at 'highest' card vs CPU on both engines with 4 + 1
    launches a forward (and 5 relayouts packed), packed vs NHWC, the bf16
    program's img/s at canvas 256, batch 16 and 64, and ``batch_process``
    on a small folder at c32; a c4 and a c64 checkpoint raise at
    ``load_generator`` on the card, and the train CLI at ``--channels 64``
    raises before its first step;
17. width training (``phase_width_train_kernels`` and ``phase_fast_vjp``
    after step 5, the width training path after the training path): the
    training kernels at the shapes of a bf16 train step of the c8 and c32
    generators (row 11 at C = 8, 16, 32 and 32, 64; row 12 at 1 and 4
    heads), kernel vs plain in fp32 and bf16 on the three inputs of step 5
    (row 11's fp32 backward also on more draws of the small-q, k input),
    timed against plain and SDPA; c32's down2 under grad (C = 128, no
    training kernel) through ``window_channel_attention_fast_vjp``, card vs
    CPU in fp32 and bf16 and timed against the plain formulation; then for
    each width the bf16 CycleGAN step (launches per step, ms/step), one
    fp32 step card vs CPU, the enhanced bf16 pretrain step (launches,
    ms/step, idle share) and two fp32 pretrain steps card vs CPU; a hooked
    c8 step; the train CLI at ``--channels 32`` and the pretrain CLI at
    ``--model enhanced --channels 8``; one ``fast_attention=False`` step
    (``--no_fast_attention``) card vs CPU with no kernel launch; c4 and c64
    refused.

Every phase raises on failure. The last line is the result JSON; the line
before it lists each kernel with its launches on the ten paths (launch
counts are reset just before each path and read just after), its largest
fp32 deviation from the plain version, its time beside the plain
version's (the serving and training rows also per generator width,
``widths``; the channel-attention row also the C = 128 training route,
``fast_vjp_c128``), its
bound (the larger of its bytes over the card's memory rate
and its bf16 matrix-product flops over the tensor-core peak) and, where
one PyTorch call computes the same function, that call's time
(``library_ms``, else null; for the channel-attention rows also
``sdpa_mid_ms``, the Gram -> softmax -> apply part alone through
``scaled_dot_product_attention``, for information). Every library time is
taken in turns with its kernel (CUDA events); for the two rows with a
library call, kernel and library are also read in ``torch.profiler``
device time, in turns (``device_ms``, ``library_device_ms``), and so are
the channel-attention mid and its SDPA mid (``device_ms``,
``sdpa_mid_device_ms``); the serving attention (both layouts) and the block
carry their own ``device_ms`` too. Exits nonzero without a CUDA device.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
TRAINED = os.path.join(REPO, "trained", "G_BA_selected.pth")
SEED = 0
BATCH = 8            # kernel-phase batch
GEN_BATCH = 16       # generator-phase batch
RATE_BATCHES = (16, 64)  # img/s of both engines at these batches
ENGINES = ("nhwc", "packed")
CANVASES = (256, 512)
FP32_TOL = 1e-4      # channel attention, fp32: summation order only
BLOCK_FP32_TOL = 2e-4  # block, fp32: two LayerNorms and a 256-wide MLP
TRAIN_GRAD_FP32_TOL = 2e-4  # training kernels' backward, fp32
TRAIN_BATCH = 8
# launches per generator forward: NHWC attention, block, packed attention,
# relayout (s2d of the input; d2s of tokens and struct, s2d of the block's
# output; d2s of the result)
FORWARD_LAUNCHES = {"nhwc": [4, 1, 0, 0], "packed": [0, 1, 4, 5]}
# launches per bf16 train step with pair batching, remat off: the G phase
# runs 4 generator forwards with grad (4 LocalAttention + 1 block each, fwd
# and bwd); the D-phase fakes are 2 forwards under no_grad, which take the
# inference kernels
TRAIN_LAUNCHES_PER_STEP = {
    "window_attention_mid_fwd": 16, "window_attention_mid_bwd": 16,
    "window_mhsa_fwd": 4, "window_mhsa_bwd": 4,
    "window_channel_attention": 8, "fused_structural_block": 2}
# fp32 step card vs CPU: cuDNN and CPU convs sum in other orders, and the
# adversarial update amplifies that (tests/test_train.py:486-491)
TRAIN_FP32_RTOL = 1e-3
# bf16: the plain versions compute in fp32 from the bf16 inputs and round
# once at the output; the fp32-FMA bodies and the relayout do the same. The
# tensor-core kernels also round operands they form inside to bf16 for
# their matrix products, sums staying fp32. Training: S and p as one bf16
# term (out = v S^T, dv = dO S; dv = p^T dO), and qn, kn, dL (the Gram,
# dqn, dkn), the exponentials of o = p v, and ds (dq, dk) as hi + lo bf16
# pairs, ~2^-16 relative. Serving: the channel attention takes qn and kn as
# pairs and v, the softmax and its output as one term; the block takes
# LN1's output (for q and k) and q, k (the scores) as pairs and the rest as
# one term. The bound is unchanged; the stress inputs of
# ``train_kernel_inputs``, ``attention_stress_inputs`` and
# ``block_stress_inputs`` hold the kernels to it.
BF16_ATOL, BF16_RTOL = 3e-2, 2 ** -7
# uint8 fp32 card vs CPU, and packed vs NHWC engine on the card: different
# conv algorithms (and, packed, the repacked convs' extra zero taps) move
# values by ~1e-5, which flips a rounding on a small share of pixels by one
# level.
U8_MAX_DIFF, U8_MAX_SHARE = 1, 0.01
# bf16 vs fp32 program on the card, mean |d| in uint8 levels (a sanity
# bound: a broken kernel lands far above it).
BF16_MEAN_LSB = 4.0
# published H100 SXM peaks (NVIDIA's data sheet): device memory rate and the
# dense bf16 tensor-core rate. A kernel's bound is the larger of its bytes
# (each input read once, each output written once) over the first and its
# matrix-product flops over the second.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
BF16_BYTES = 2
# the pretraining path: the plain generator at the reference's width
# (Generator(64)), pretrained at batch 16; the enhanced generator at c16,
# batch TRAIN_BATCH
PLAIN_CHANNELS = 64
PLAIN_FWD_BATCH = 2
PRETRAIN_BATCH = 16
# fp32 plain forward card vs CPU (TF32 off): cuDNN and the CPU sum the
# convs in other orders, and the eight layers and four BatchNorms carry it
PLAIN_FP32_ATOL = 1e-3
# two fp32 pretrain steps card vs CPU: the loss, relative
PRETRAIN_FP32_RTOL = 1e-3
# launches per enhanced bf16 pretrain step: one generator forward and
# backward with grad (4 LocalAttention mids and 1 block), nothing under
# no_grad, so no inference kernel
PRETRAIN_LAUNCHES_PER_STEP = {
    "window_attention_mid_fwd": 4, "window_attention_mid_bwd": 4,
    "window_mhsa_fwd": 1, "window_mhsa_bwd": 1,
    "window_channel_attention": 0, "fused_structural_block": 0}
# the ablation path: the tool's runs at (batch, hw, C): the TPU script's
# default shape, then the canvas-256 batch-64 shapes of C = 32 and 64
ABLATION_SHAPES = ((96, 512, 16), (64, 128, 32), (64, 64, 64))
# the local-style post chains of the uint8 program (--mode local_style)
POST_MODES = ("enhanced", "advanced")
CHAIN_BATCH = 8
CHAIN_CASES = (("simple", True, True), ("enhanced", True, True),
               ("enhanced", False, False), ("enhanced", True, False),
               ("enhanced", False, True), ("advanced", True, True))
# the chain thresholds masks and rounds at the end, so card vs CPU (and the
# port vs JAX in the CPU tests) is held to: more than 1 level apart on at
# most 0.1% of values, mean |d| at most 0.05 levels; the masks themselves
# equal on at least 99.9% of pixels
CHAIN_LEVEL_SHARE, CHAIN_MEAN_LEVELS = 1e-3, 0.05
MASK_SHARE = 0.999
# (canvas, batch) cells of the per-mode program rates and chain times
MODE_CELLS = ((256, 16), (256, 64), (512, 16))
# the evaluation path: m_test's --max_images default and run_fid_eval's
# batch; the card-vs-CPU FID runs at EVAL_CPU_IMAGES a direction
EVAL_IMAGES, EVAL_CPU_IMAGES, EVAL_BATCH = 100, 32, 16
# metrics card vs CPU: SSIM absolute per image, PSNR in dB, MSE relative;
# SSIM(x, x) on the card; FID per direction and mean, relative
SSIM_ATOL, PSNR_ATOL, MSE_RTOL, SSIM_IDENT_ATOL = 1e-4, 1e-3, 1e-5, 1e-6
FID_RTOL = 1e-3
METRIC_SIZES, METRIC_PAIRS, METRIC_RATE_BATCHES = (256, 512), 16, (16, 64)
# launches per generator forward on the evaluation path (LoadedModel.apply,
# the NHWC engine): row 1 and row 4
EVAL_LAUNCHES_PER_FORWARD = {"window_channel_attention": 4,
                             "fused_structural_block": 1}
# the perceptual loss alone, fp32 card vs CPU (TF32 off): relative
PERCEPTUAL_RTOL = 1e-4
# generator widths the serving kernels are built for; the c8 and c32 ones
# (random weights at the JAX init law, seeded) drive the width path:
# LocalAttention at C = 8 and 128 and the block at 32 and 128 channels (1
# and 4 heads) beside c16's widths. Its fp32 card-vs-CPU program runs on
# WIDTH_CPU_BATCH images, its folder through batch_process holds
# WIDTH_FOLDER_IMAGES.
GENERATOR_CHANNELS = (8, 16, 32)
WIDTH_CHANNELS = (8, 32)
WIDTH_CPU_BATCH = 4
WIDTH_FOLDER_IMAGES = 6
# the c8 and c32 generators trained: launches per bf16 CycleGAN step (pair
# batching, remat off; 4 generator forwards with grad, 2 under no_grad) and
# per enhanced pretrain step (1 forward with grad). c8 trains LocalAttention
# at C = 8, 16, 32 through row 11, as c16 does; c32 at C = 32, 64, 64
# through row 11 and its down2 at C = 128 through the fast-VJP route, whose
# forward is row 1's kernel under grad (4 a step beside the D phase's 8)
WIDTH_TRAIN_LAUNCHES_PER_STEP = {
    8: TRAIN_LAUNCHES_PER_STEP,
    32: {"window_attention_mid_fwd": 12, "window_attention_mid_bwd": 12,
         "window_mhsa_fwd": 4, "window_mhsa_bwd": 4,
         "window_channel_attention": 12, "fused_structural_block": 2}}
WIDTH_PRETRAIN_LAUNCHES_PER_STEP = {
    8: PRETRAIN_LAUNCHES_PER_STEP,
    32: {"window_attention_mid_fwd": 3, "window_attention_mid_bwd": 3,
         "window_mhsa_fwd": 1, "window_mhsa_bwd": 1,
         "window_channel_attention": 1, "fused_structural_block": 0}}
# c32's down2 under grad: the fast-VJP route at its 256^2, batch-8 shape;
# the fp32 backward of the channel-attention mid on more draws of the small
# q, k input at each width's shapes
FAST_VJP_SHAPE = (TRAIN_BATCH, 64, 64, 128)
SMALL_QK_DRAWS = 3
WIDTH_TRAIN_SIZE = 256   # the bf16 steps' images


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of one call, CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_turns(*fns, timer=time_ms):
    """The mean ``timer`` time of each of ``fns``, taken in turns: in order,
    then in reverse (a, b, c, c, b, a), so that a drift of the card or the
    host falls on each alike."""
    order = list(fns) + list(fns)[::-1]
    ms = [timer(fn) for fn in order]
    return [(ms[i] + ms[-1 - i]) / 2 for i in range(len(fns))]


def time_pair(kernel_fn, plain_fn):
    """Kernel and plain times taken in turns (plain, kernel, kernel, plain)."""
    p_ms, k_ms = time_turns(plain_fn, kernel_fn)
    return k_ms, p_ms


def device_ms(fn, iters=20, warmup=3) -> float:
    """Device time of one call: the device events' own time in
    ``torch.profiler`` (``self_device_time_total`` of the CUDA entries of
    ``key_averages()``) over ``iters`` calls, so that host gaps between
    launches drop out."""
    return device_profile(fn, iters, warmup)[0]


def device_profile(fn, iters=20, warmup=3):
    """(device ms, device operations launched) per call of ``fn``, from
    ``torch.profiler`` as in :func:`device_ms`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    for _ in range(3):   # a profile now and then comes back empty: ask again
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]
        us = sum(e.self_device_time_total for e in rows)
        if us > 0:
            return us / iters / 1e3, sum(e.count for e in rows) / iters
    raise AssertionError("torch.profiler recorded no device time")


def bound(moved: float, flops: float):
    """(bound_ms, bound_by) of work that moves ``moved`` bytes and does
    ``flops`` bf16 matrix-product flops."""
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_work(shapes):
    """Bytes and flops of the channel attention on NHWC ``shapes`` in bf16:
    x read and y written once, the four weights read once; 12 C^2 flops of
    products per pixel (qkv 6, Gram 2, apply 2, proj 2)."""
    moved = flops = 0
    for B, H, W, C in shapes:
        px = B * H * W
        moved += BF16_BYTES * (2 * px * C + 4 * C * C + 4 * C)
        flops += 12 * C * C * px
    return moved, flops


def block_work(shape):
    """Bytes and flops of the fused block on a (B, H, W, C) grid in bf16:
    x and struct read, y written, FiLM gamma and beta (fp32) and the
    weights read once; per token 24 C^2 flops of products (qkv 6, proj 2,
    MLP 16) and 4 * 64 * C in the 8x8-window scores and their apply."""
    from multi_style_transfer_gan_tpu_torch.ops.kernels.fused_transformer import (
        weight_shapes,
    )

    B, H, W, C = shape
    tokens = B * H * W
    weights = sum(int(np.prod(s)) for s in weight_shapes(C).values())
    moved = BF16_BYTES * (3 * tokens * C + weights) + 4 * 2 * B * C
    return moved, tokens * (24 * C * C + 4 * 64 * C)


def train_mid_work(shapes):
    """Bytes and flops of the channel-attention mid, forward + backward, on
    qkv grids (B, H, W, 3C) in bf16: the forward reads qkv and writes out
    (4C per pixel), the backward reads qkv and d_out and writes d_qkv (7C);
    products 4 C^2 (Gram, apply) + 10 C^2 (Gram again, dA, dv, dqn, dkn)."""
    moved = flops = 0
    for B, H, W, C3 in shapes:
        px, C = B * H * W, C3 // 3
        moved += BF16_BYTES * 11 * C * px
        flops += 14 * C * C * px
    return moved, flops


def mhsa_work(shape, heads=2, window=8):
    """The same for the window-MHSA mid on a (B, H, W, 3C) qkv grid: 11C
    values per pixel; per token 4 * 64 * C flops forward (scores, apply),
    10 * 64 * C backward (scores again, dP, dV, dQ, dK)."""
    B, H, W, C3 = shape
    px, C = B * H * W, C3 // 3
    return BF16_BYTES * 11 * C * px, 14 * window * window * C * px


def sdpa_call(shape, scale, dev, backward=False):
    """A no-argument call of ``scaled_dot_product_attention`` on bf16 (N,
    heads, L, E) = ``shape`` at ``scale``, with ``backward`` forward +
    gradient; the library yardstick, timed here and never called by the
    port."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v, d_out = (torch.randn(shape, generator=gen, device=dev,
                                  dtype=torch.bfloat16) for _ in range(4))
    if not backward:
        return lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)
    for t in (q, k, v):
        t.requires_grad_(True)
    return lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(q, k, v, scale=scale), (q, k, v),
        d_out)


def sdpa_mid_call(shape, dev, backward=False):
    """SDPA on the channel-attention mid of the NHWC (B, H, W, C) ``shape``:
    per window (C tokens of 16 positions) Gram -> softmax -> apply at scale
    1.0, without the normalize and the two 1x1 products, so a part of the
    op and no yardstick of the whole."""
    B, H, W, C = shape
    return sdpa_call((B * H * W // 16, 1, C, 16), 1.0, dev, backward)


def compare(got, ref, dtype):
    """max |d| and whether it is inside the dtype's stated tolerance."""
    import torch

    d = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        return d.max().item(), None
    ok = bool((d <= BF16_ATOL + BF16_RTOL * ref.float().abs()).all())
    return d.max().item(), ok


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    """Every source at once, one nvcc each, then each entry point loads."""
    from multi_style_transfer_gan_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    seconds = _build.build_all()
    for name, dt in seconds.items():
        log(f"[build] {name}: {dt:.2f} s "
            f"({os.path.relpath(_build.library_path(name), REPO)})")
    for name in _build.SIGNATURES:
        _build.kernel(name)
    log(f"[build] {len(seconds)} sources in {time.perf_counter() - t0:.2f} s "
        f"wall, {len(_build.SIGNATURES)} entry points loaded")


def attention_shapes(canvas, channels=16):
    """(name, shape) of the four LocalAttention calls of one forward of the
    generator of width ``channels`` (c16 by default)."""
    c = channels
    return [("down1", (BATCH, canvas // 2, canvas // 2, 2 * c)),
            ("down2", (BATCH, canvas // 4, canvas // 4, 4 * c)),
            ("up1", (BATCH, canvas // 2, canvas // 2, 2 * c)),
            ("up2", (BATCH, canvas, canvas, c))]


def attention_stress_inputs(rng, shape, packed=False):
    """[(label, x, [wqkv, bqkv, wproj, bproj])] host arrays for the channel
    attention on the NHWC ``shape`` (B, H, W, C), x laid out NHWC or, with
    ``packed``, as packed rows (B, H/4, W/4, 16 C). Window (0, 0, 0) is all
    zeros in each. "random": standard normal x and biases. "saturated":
    batch entry 1 (0 at batch 1) is constant inside every window (a flat
    image region) and the biases make one q channel and two k channels
    dominant (16, 8 and 8 against 0.05), so the Gram's 16 terms add up
    coherently to logits near its maximum with two keys competing, and the
    v rows of the qkv weight are 8 times larger: the input on which bf16
    rounding of qn and kn costs the most. "small q, k": the q and k biases
    are zero, so the zero window meets the zero-safe normalize with q = k =
    0, and the window below it is scaled by 1e-3 (|q|, |k| ~ 1e-3)."""
    B, H, W, C = shape
    t = rng.standard_normal((B, H // 4, W // 4, 16, C)).astype(np.float32)
    t[0, 0, 0] = 0.0
    ws = [rng.standard_normal((3 * C, C)) * 0.1, rng.standard_normal(3 * C),
          rng.standard_normal((C, C)) * 0.1, rng.standard_normal(C)]
    flat, small = t.copy(), t.copy()
    flat[min(1, B - 1)] = flat[min(1, B - 1), :, :, :1]
    sharp = [ws[0].copy(), ws[1].copy(), ws[2], ws[3]]
    sharp[0][2 * C:] *= 8.0
    sharp[1][:2 * C] *= 0.05
    sharp[1][[0, C + 1, C + 2]] = 16.0, 8.0, 8.0
    small[0, 1, 0] *= 1e-3
    no_qk_bias = [ws[0], ws[1].copy(), ws[2], ws[3]]
    no_qk_bias[1][:2 * C] = 0.0

    def lay(rows):
        if packed:
            return rows.reshape(B, H // 4, W // 4, 16 * C)
        rows = rows.reshape(B, H // 4, W // 4, 4, 4, C)
        return np.ascontiguousarray(
            rows.transpose(0, 1, 3, 2, 4, 5)).reshape(B, H, W, C)

    return [("random", lay(t), ws), ("saturated", lay(flat), sharp),
            ("small q, k", lay(small), no_qk_bias)]


def block_stress_inputs(rng, shape):
    """[(label, [x, struct, gamma, beta], {weight: array})] host arrays for
    the fused block on the (B, H, W, C) grid ``shape``; x and struct are
    zero on the first 8x8 window. "random": as the block phase always had.
    "saturated": the q and k rows of the qkv weight times 4, so the scores
    grow 16-fold and every softmax row sits on a few keys."""
    from multi_style_transfer_gan_tpu_torch.ops.kernels.fused_transformer import (
        weight_shapes,
    )

    B, H, W, C = shape
    host = [rng.standard_normal(shape), rng.standard_normal(shape),
            rng.standard_normal((B, C)) * 0.1,
            rng.standard_normal((B, C)) * 0.1]
    host[0][0, :8, :8] = 0.0
    host[1][0, :8, :8] = 0.0
    weights = {}
    for n, s in weight_shapes(C).items():
        a = rng.standard_normal(s) * (0.1 if len(s) == 2 else 0.05)
        weights[n] = a + 1.0 if n in ("norm1_w", "norm2_w") else a
    sharp = dict(weights, qkv_w=weights["qkv_w"].copy())
    sharp["qkv_w"][:2 * C] *= 4.0
    return [("random", host, weights), ("saturated", host, sharp)]


def phase_attention(rng, dev):
    """The NHWC attention kernel vs plain at every shape of a forward at each
    canvas, fp32 (TF32 off) and bf16, on the three inputs of
    ``attention_stress_inputs`` (each with one all-zero window); timed on
    the random input, in bf16 in turns with the SDPA mid."""
    import torch

    from multi_style_transfer_gan_tpu_torch.ops.kernels import (
        window_channel_attention, window_channel_attention_plain,
    )

    worst = 0.0
    times = {}
    for canvas in CANVASES:
        seen = {}
        for stage, shape in attention_shapes(canvas):
            if shape in seen:  # up1 has down1's shape
                times[(canvas, stage)] = seen[shape]
                continue
            for label, x, ws in attention_stress_inputs(rng, shape):
                for dtype in (torch.float32, torch.bfloat16):
                    args = [torch.from_numpy(np.asarray(a, np.float32))
                            .to(dev, dtype) for a in [x] + ws]
                    got = window_channel_attention(*args)
                    ref = window_channel_attention_plain(*args)
                    torch.cuda.synchronize()
                    err, bf16_ok = compare(got, ref, dtype)
                    ok = (err <= FP32_TOL if dtype == torch.float32
                          else bf16_ok)
                    # the all-zero window: finite, inside the same tolerance
                    zero_ok = bool(torch.isfinite(got[0, :4, :4]).all())
                    ok = ok and bool(torch.isfinite(got).all()) and zero_ok
                    line = (f"[attention] canvas {canvas} {stage} {shape} "
                            f"{label} {str(dtype)[6:]}: max|d| {err:.3e} "
                            f"zero-window {'ok' if zero_ok else 'BAD'}")
                    if label == "random":
                        # bf16: the SDPA mid in turns with kernel and plain
                        k_ms, p_ms, *s_ms = time_turns(
                            lambda: window_channel_attention(*args),
                            lambda: window_channel_attention_plain(*args),
                            *([sdpa_mid_call(shape, dev)]
                              if dtype == torch.bfloat16 else []))
                        line += (f", kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms"
                                 + "".join(f", SDPA mid {t:.4f} ms"
                                           for t in s_ms))
                        if dtype == torch.bfloat16:
                            d_ms = device_ms(
                                lambda: window_channel_attention(*args))
                            line += f", kernel device {d_ms:.4f} ms"
                            times[(canvas, stage)] = seen[shape] = (
                                k_ms, p_ms, s_ms[0], d_ms)
                    log(line)
                    if not ok:
                        raise AssertionError(
                            f"window_channel_attention {shape} {label} "
                            f"{dtype}: max|d| {err:.3e} outside tolerance")
                    if dtype == torch.float32:
                        worst = max(worst, err)
    return worst, times


def phase_packed_attention(rng, dev):
    """Packed-row attention kernel vs plain at every packed-engine shape on
    the three inputs of ``attention_stress_inputs`` (one all-zero window
    each), and, on the random input, the NHWC kernel's time at the same
    windows (the same op, one relayout away)."""
    import torch

    from multi_style_transfer_gan_tpu_torch.ops.kernels import (
        depth_to_space_plain, packed_window_channel_attention,
        packed_window_channel_attention_plain, window_channel_attention,
    )

    worst = 0.0
    times = {}
    for canvas in CANVASES:
        seen = {}
        for stage, nhwc_shape in attention_shapes(canvas):
            B, H, W, C = nhwc_shape
            shape = (B, H // 4, W // 4, 16 * C)
            if shape in seen:  # up1 has down1's shape
                times[(canvas, stage)] = seen[shape]
                continue
            for label, x, ws in attention_stress_inputs(rng, nhwc_shape,
                                                        packed=True):
                for dtype in (torch.float32, torch.bfloat16):
                    args = [torch.from_numpy(np.asarray(a, np.float32))
                            .to(dev, dtype) for a in [x] + ws]
                    got = packed_window_channel_attention(*args)
                    ref = packed_window_channel_attention_plain(*args)
                    torch.cuda.synchronize()
                    err, bf16_ok = compare(got, ref, dtype)
                    ok = (err <= FP32_TOL if dtype == torch.float32
                          else bf16_ok)
                    zero_ok = bool(torch.isfinite(got[0, 0, 0]).all())
                    ok = ok and bool(torch.isfinite(got).all()) and zero_ok
                    line = (f"[packed attention] canvas {canvas} {stage} "
                            f"{shape} {label} {str(dtype)[6:]}: max|d| "
                            f"{err:.3e} zero-window "
                            f"{'ok' if zero_ok else 'BAD'}")
                    if label == "random":
                        k_ms, p_ms = time_pair(
                            lambda: packed_window_channel_attention(*args),
                            lambda: packed_window_channel_attention_plain(
                                *args))
                        nhwc = ([depth_to_space_plain(args[0], 4).contiguous()]
                                + args[1:])
                        n_ms = time_ms(lambda: window_channel_attention(*nhwc))
                        line += (f", kernel {k_ms:.4f} ms, plain {p_ms:.4f} "
                                 f"ms, NHWC kernel {n_ms:.4f} ms")
                        if dtype == torch.bfloat16:
                            d_ms = device_ms(
                                lambda: packed_window_channel_attention(*args))
                            line += f", kernel device {d_ms:.4f} ms"
                            times[(canvas, stage)] = seen[shape] = (
                                k_ms, p_ms, n_ms, d_ms)
                    log(line)
                    if not ok:
                        raise AssertionError(
                            f"packed_window_channel_attention {shape} {label} "
                            f"{dtype}: max|d| {err:.3e} outside tolerance")
                    if dtype == torch.float32:
                        worst = max(worst, err)
    return worst, times


def relayout_cases(canvas, channels=16):
    """(name, NHWC shape, direction) of the five relayouts of one packed
    forward at BATCH: the input and output (C = 3) and the bottleneck
    tokens, struct and block output (C = 4 ``channels``, 64 at c16)."""
    full, bottleneck = (BATCH, canvas, canvas, 3), (BATCH, canvas // 4,
                                                    canvas // 4, 4 * channels)
    return [("s2d input", full, "s2d"), ("d2s tokens", bottleneck, "d2s"),
            ("d2s struct", bottleneck, "d2s"), ("s2d block", bottleneck, "s2d"),
            ("d2s output", full, "d2s")]


def phase_relayout(rng, dev, cases=None, tag="[relayout]"):
    """The relayout kernel vs the plain reshape + permute, both directions,
    bit-exact; returns the largest |d| (0) and the ms of the five relayouts
    of one forward (``cases``; by default c16's at the first canvas), bf16:
    kernel, plain and library (``.contiguous()`` of the permuted window
    view) in CUDA-event time taken in turns, then kernel and library in
    profiler device time in turns."""
    import torch

    from multi_style_transfer_gan_tpu_torch.ops.kernels import (
        depth_to_space_plain, space_to_depth_plain, window_relayout,
    )

    worst = 0.0
    case_ms = {}
    cases = cases or relayout_cases(CANVASES[0])
    for shape in sorted({s for _, s, _ in cases}):
        B, H, W, C = shape
        host = rng.standard_normal(shape).astype(np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(host).to(dev, dtype)
            rows = space_to_depth_plain(x, 4).contiguous()
            for direction, src, plain, view in (
                    ("s2d", x, lambda t: space_to_depth_plain(t, 4).contiguous(),
                     x.reshape(B, H // 4, 4, W // 4, 4, C)),
                    ("d2s", rows, lambda t: depth_to_space_plain(t, 4).contiguous(),
                     rows.reshape(B, H // 4, W // 4, 4, 4, C))):
                inverse = direction == "d2s"
                got = window_relayout(src, inverse=inverse)
                ref = plain(src)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                exact = torch.equal(got, ref)
                kernel = lambda: window_relayout(src, inverse=inverse)
                library = view.permute(0, 1, 3, 2, 4, 5).contiguous
                if dtype == torch.bfloat16:
                    ms = time_turns(kernel, lambda: plain(src), library)
                    ms += time_turns(kernel, library, timer=device_ms)
                    case_ms[(shape, direction)] = ms
                else:
                    ms = time_pair(kernel, lambda: plain(src))
                log(f"{tag} {direction} {shape} {str(dtype)[6:]}: "
                    f"{'bit-exact' if exact else f'DIFFERS max|d| {err:.3e}'}, "
                    + ", ".join(f"{n} {t:.4f} ms" for n, t in zip(
                        ("kernel", "plain", "library", "kernel device",
                         "library device"), ms)))
                if not exact:
                    raise AssertionError(f"window_relayout {direction} {shape} "
                                         f"{dtype} is not bit-exact")
                worst = max(worst, err)
    return worst, [sum(case_ms[(shape, d)][i] for _, shape, d in cases)
                   for i in range(5)]


def phase_block(rng, dev):
    """The fused block kernel vs plain at its shapes of a forward at each
    canvas and on a ragged grid, fp32 (TF32 off) and bf16, on the inputs of
    ``block_stress_inputs`` (one all-zero window each); timed on the random
    input."""
    import torch

    from multi_style_transfer_gan_tpu_torch.ops.kernels import (
        fused_structural_block, structural_block_plain,
    )

    worst = 0.0
    times = {}
    for shape in [(BATCH, 64, 64, 64), (BATCH, 128, 128, 64), (2, 12, 20, 64)]:
        B, H, W, C = shape
        for label, host, weights in block_stress_inputs(rng, shape):
            for dtype in (torch.float32, torch.bfloat16):
                t = lambda a, dt=dtype: torch.from_numpy(
                    np.asarray(a, np.float32)).to(dev, dt)
                args = (t(host[0]), t(host[1]), t(host[2], torch.float32),
                        t(host[3], torch.float32))
                kw = {n: t(a) for n, a in weights.items()}
                got = fused_structural_block(*args, **kw)
                ref = structural_block_plain(*args, **kw)
                torch.cuda.synchronize()
                err, bf16_ok = compare(got, ref, dtype)
                ok = (err <= BLOCK_FP32_TOL if dtype == torch.float32
                      else bf16_ok)
                ok = ok and bool(torch.isfinite(got).all())
                ragged = " (ragged)" if H % 8 or W % 8 else ""
                line = (f"[block] {shape}{ragged} {label} {str(dtype)[6:]}: "
                        f"max|d| {err:.3e}")
                if label == "random":
                    k_ms, p_ms = time_pair(
                        lambda: fused_structural_block(*args, **kw),
                        lambda: structural_block_plain(*args, **kw))
                    line += f", kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms"
                    if dtype == torch.bfloat16:
                        d_ms = device_ms(
                            lambda: fused_structural_block(*args, **kw))
                        line += f", kernel device {d_ms:.4f} ms"
                        times[shape] = (k_ms, p_ms, d_ms)
                log(line)
                if not ok:
                    raise AssertionError(
                        f"fused_structural_block {shape} {label} {dtype}: "
                        f"max|d| {err:.3e} outside tolerance")
                if dtype == torch.float32:
                    worst = max(worst, err)
    return worst, times


def train_kernel_cases():
    """(kernel, stage, qkv shape) at every shape a bf16 train step at 256^2
    gives the training kernels, batch TRAIN_BATCH (pair batching doubles it
    on the main path; the kernels are per window, so the shapes' batch only
    scales the grid)."""
    B = TRAIN_BATCH
    return [("attention", "down1/up1", (B, 128, 128, 96)),
            ("attention", "down2", (B, 64, 64, 192)),
            ("attention", "up2", (B, 256, 256, 48)),
            ("mhsa", "block", (B, 64, 64, 192))]


def width_train_kernel_cases(channels):
    """(kernel, stage, qkv shape, heads) at every shape a bf16 train step at
    256^2, batch TRAIN_BATCH gives the training kernels of the generator of
    width ``channels``: the channel-attention mid at C, 2C and 4C where
    row 11 is built (C <= 64; c32's down2 at C = 128 takes the fast-VJP
    route), the window-MHSA mid at dim 4C in 4C / 32 heads."""
    from multi_style_transfer_gan_tpu_torch.ops.kernels.window_attention_train import (
        KERNEL_WIDTHS,
    )

    B, c = TRAIN_BATCH, channels
    cases = [("attention", stage, (B, hw, hw, 3 * w), None)
             for stage, hw, w in (("up2", 256, c), ("down1/up1", 128, 2 * c),
                                  ("down2", 64, 4 * c))
             if w in KERNEL_WIDTHS]
    return cases + [("mhsa", "block", (B, 64, 64, 12 * c), 4 * c // 32)]


def train_kernel_inputs(rng, name, shape):
    """[(label, qkv, d_out)] host arrays for a training kernel at ``shape``:
    random with one all-zero window; the same with qkv x 8 in batch entry 1
    (a saturated softmax); the same with the q and k of the window below the
    zero window scaled to norms ~1e-3 (small, but above eps: the normalize
    backward multiplies by ~1e3)."""
    win = 4 if name == "attention" else 8
    C = shape[3] // 3
    qkv = rng.standard_normal(shape).astype(np.float32)
    qkv[0, :win, :win] = 0.0      # one all-zero window
    d_out = rng.standard_normal(shape[:3] + (C,)).astype(np.float32)
    saturated, small = qkv.copy(), qkv.copy()
    saturated[1] *= 8.0
    small[0, win:2 * win, :win, :2 * C] *= 1e-3 / np.sqrt(C)
    return [("random", qkv, d_out), ("saturated", saturated, d_out),
            ("small q, k", small, d_out)]


def train_kernel_fns(name, heads=2):
    """(fwd, bwd, plain fwd, plain bwd, extra args, window) of a training
    kernel; the window-MHSA mid takes ``heads``."""
    from multi_style_transfer_gan_tpu_torch.ops import kernels as K

    if name == "attention":
        return (K.window_attention_mid_fwd, K.window_attention_mid_bwd,
                K.window_attention_mid_plain,
                K.window_attention_mid_backward_plain, (), 4)
    return (K.window_mhsa_fwd, K.window_mhsa_bwd, K.window_mhsa_plain,
            K.window_mhsa_backward_plain, (heads,), 8)


def check_train_kernel(tag, name, stage, shape, heads, label, host, g_host,
                       dtype, dev, timed=True):
    """Forward and backward of a training kernel vs its plain version on one
    input (``train_kernel_inputs``): fp32 at FP32_TOL and
    TRAIN_GRAD_FP32_TOL, bf16 at the bound, every value finite, the zero
    window's gradient too. On the random input (when ``timed``) the
    ``time_train_kernel`` times. Raises outside tolerance; returns (fwd
    max|d|, bwd max|d|, times)."""
    import torch

    fwd, bwd, fwd_plain, bwd_plain, extra, win = train_kernel_fns(name, heads)
    qkv = torch.from_numpy(host).to(dev, dtype)
    d_out = torch.from_numpy(g_host).to(dev, dtype)
    got = fwd(qkv, *extra)
    dgot = bwd(qkv, d_out, *extra)
    ref = fwd_plain(qkv, *extra)
    dref = bwd_plain(qkv, d_out, *extra)
    torch.cuda.synchronize()
    err, ok = compare(got, ref, dtype)
    derr, dok = compare(dgot, dref, dtype)
    if dtype == torch.float32:
        ok, dok = err <= FP32_TOL, derr <= TRAIN_GRAD_FP32_TOL
    finite = bool(torch.isfinite(got).all() and torch.isfinite(dgot).all())
    zero_ok = bool(torch.isfinite(dgot[0, :win, :win]).all())
    ms = ()
    if label == "random" and timed:
        ms = time_train_kernel(name, shape, dtype, dev, (
            lambda: (fwd(qkv, *extra), bwd(qkv, d_out, *extra)),
            lambda: (fwd_plain(qkv, *extra), bwd_plain(qkv, d_out, *extra))),
            heads)
    log(f"{tag} {name} {stage} qkv {shape}"
        + ("" if name == "attention" else f" {heads} heads")
        + f" {label} {str(dtype)[6:]}: fwd max|d| {err:.3e}, bwd max|d| "
        f"{derr:.3e}, zero window {'finite' if zero_ok else 'BAD'}"
        + "".join(f"; fwd+bwd {n} {t:.4f} ms" for n, t in zip(
            ("kernel", "plain", "SDPA", "kernel device", "SDPA device"), ms)))
    if not (ok and dok and finite and zero_ok):
        raise AssertionError(f"{name} train kernel {shape} {label} {dtype}: "
                             f"outside tolerance or not finite")
    return err, derr, ms


def phase_train_kernels(rng, dev):
    """Forward and backward of both training kernels vs their plain versions,
    fp32 (TF32 off) and bf16, on the three inputs of
    ``train_kernel_inputs`` (each with one all-zero window). On the random
    input the kernel is timed in turns with its plain version and, in bf16,
    with the SDPA yardstick (fwd + bwd): the channel-attention mid on
    (windows, 1, C, 16), information only; the window-MHSA mid's library
    call on (windows, 2 heads, 64, C/2); in CUDA events and then, kernel and
    SDPA in turns, in profiler device time."""
    import torch

    worst = {"attention": 0.0, "mhsa": 0.0}
    times = {}
    for name, stage, shape in train_kernel_cases():
        for label, host, g_host in train_kernel_inputs(rng, name, shape):
            for dtype in (torch.float32, torch.bfloat16):
                err, derr, ms = check_train_kernel(
                    "[train kernels]", name, stage, shape, 2, label, host,
                    g_host, dtype, dev)
                if dtype == torch.float32:
                    worst[name] = max(worst[name], err, derr)
                if ms:
                    times[(name, stage, dtype)] = ms
    return worst, times


def time_train_kernel(name, shape, dtype, dev, calls, heads=2):
    """fwd + bwd ms of a training kernel and its plain version, in turns; in
    bf16 with the SDPA yardstick in CUDA events, then kernel and SDPA in
    turns in profiler device time: (kernel, plain[, SDPA, kernel device,
    SDPA device])."""
    import torch

    kernel, plain = calls
    if dtype == torch.float32:
        return time_pair(kernel, plain)
    B, H, W, C3 = shape
    if name == "attention":
        sdpa = sdpa_mid_call((B, H, W, C3 // 3), dev, backward=True)
    else:
        hd = C3 // 3 // heads
        sdpa = sdpa_call((B * (H // 8) * (W // 8), heads, 64, hd), hd ** -0.5,
                         dev, backward=True)
    return (time_turns(kernel, plain, sdpa)
            + time_turns(kernel, sdpa, timer=device_ms))


def phase_stages(rng, dev):
    """Each stage kernel of the channel attention vs its plain version at
    the three distinct canvas-256 attention shapes, fp32 (TF32 off) and
    bf16, one all-zero window each; ``full`` bit-equal to
    ``window_channel_attention`` on the same inputs. Returns the largest
    fp32 |d| and {(shape, stage): bf16 kernel ms}, with the plain full's
    ms under (shape, "full plain")."""
    import torch

    from multi_style_transfer_gan_tpu_torch.ops.kernels import (
        STAGES, window_channel_attention, window_channel_attention_stage,
        window_channel_attention_stage_plain,
    )

    worst = 0.0
    times = {}
    for shape in dict.fromkeys(s for _, s in attention_shapes(CANVASES[0])):
        C = shape[-1]
        x = rng.standard_normal(shape).astype(np.float32)
        x[0, :4, :4] = 0.0  # one all-zero window: zero-safe normalize
        ws = [rng.standard_normal((3 * C, C)) * 0.1,
              rng.standard_normal(3 * C),
              rng.standard_normal((C, C)) * 0.1,
              rng.standard_normal(C)]
        for dtype in (torch.float32, torch.bfloat16):
            args = [torch.from_numpy(a.astype(np.float32)).to(dev, dtype)
                    for a in [x] + ws]
            for stage in STAGES:
                got = window_channel_attention_stage(*args, stage=stage)
                ref = window_channel_attention_stage_plain(*args, stage=stage)
                torch.cuda.synchronize()
                err, bf16_ok = compare(got, ref, dtype)
                ok = (err <= FP32_TOL if dtype == torch.float32 else bf16_ok)
                ok = ok and bool(torch.isfinite(got).all())
                line = (f"[stages] {shape} {str(dtype)[6:]} {stage}: max|d| "
                        f"{err:.3e}")
                if stage == "full":
                    exact = torch.equal(got, window_channel_attention(*args))
                    ok = ok and exact
                    line += (", bit-equal to window_channel_attention" if exact
                             else ", DIFFERS from window_channel_attention")
                if dtype == torch.bfloat16:
                    times[(shape, stage)] = time_ms(
                        lambda: window_channel_attention_stage(*args,
                                                               stage=stage))
                    line += f", kernel {times[(shape, stage)]:.4f} ms"
                log(line)
                if not ok:
                    raise AssertionError(f"stage {stage} {shape} {dtype}: "
                                         f"max|d| {err:.3e} outside tolerance, "
                                         f"not finite or not bit-equal")
                if dtype == torch.float32:
                    worst = max(worst, err)
            if dtype == torch.bfloat16:
                times[(shape, "full plain")] = time_ms(
                    lambda: window_channel_attention_stage_plain(
                        *args, stage="full"))
    return worst, times


def phase_ablation_inputs(dev):
    """Each stage kernel vs its plain version on the ablation tool's own
    inputs (``ablation_inputs``, bf16) at every ABLATION_SHAPES entry, the
    shapes the ablation path gives it; ``full`` bit-equal to
    ``window_channel_attention``. Returns the largest |d|."""
    import torch

    from multi_style_transfer_gan_tpu_torch.ops.kernels import (
        STAGES, window_channel_attention, window_channel_attention_stage,
        window_channel_attention_stage_plain,
    )
    from multi_style_transfer_gan_tpu_torch.tools.attention_ablation import (
        ablation_inputs,
    )

    worst = 0.0
    with torch.inference_mode():
        for B, HW, C in ABLATION_SHAPES:
            x, weights = ablation_inputs(B, HW, C, dev)
            for stage in STAGES:
                got = window_channel_attention_stage(x, *weights, stage=stage)
                ref = window_channel_attention_stage_plain(x, *weights,
                                                           stage=stage)
                torch.cuda.synchronize()
                err, ok = compare(got, ref, torch.bfloat16)
                ok = ok and bool(torch.isfinite(got).all())
                line = (f"[ablation inputs] {B}x{HW}^2 C={C} bf16 {stage}: "
                        f"max|d| {err:.3e}")
                if stage == "full":
                    exact = torch.equal(got, window_channel_attention(
                        x, *weights))
                    ok = ok and exact
                    line += (", bit-equal to window_channel_attention" if exact
                             else ", DIFFERS from window_channel_attention")
                log(line)
                if not ok:
                    raise AssertionError(f"stage {stage} at {B}x{HW}^2 C={C}: "
                                         f"max|d| {err:.3e} outside tolerance, "
                                         f"not finite or not bit-equal")
                worst = max(worst, err)
                del got, ref
            del x
    torch.cuda.empty_cache()
    return worst


def phase_ablation():
    """The stage-ablation tool as a user runs it, once per ABLATION_SHAPES
    entry; its tables are printed."""
    import contextlib

    from multi_style_transfer_gan_tpu_torch.tools.attention_ablation import (
        main,
    )

    for B, HW, C in ABLATION_SHAPES:
        argv = ["--batch", str(B), "--hw", str(HW), "--c", str(C)]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        log(f"[ablation] {' '.join(argv)}: exit {rc}, "
            f"{time.perf_counter() - t0:.2f} s wall; its output:")
        for line in buf.getvalue().splitlines():
            log(f"    {line}")
        if rc != 0 or "  full " not in buf.getvalue():
            raise AssertionError(f"the ablation tool failed on {argv}")


def smooth_images(rng, n, size):
    """Seeded photo-like uint8 images: low-frequency colour fields."""
    from PIL import Image

    out = []
    for _ in range(n):
        low = (rng.random((6, 6, 3)) * 255).astype(np.uint8)
        out.append(np.asarray(Image.fromarray(low).resize(size,
                                                          Image.BICUBIC)))
    return out


def program_rate(fn, x, iters=10, warmup=2) -> float:
    """img/s of the uint8 program ``fn`` on the device-resident batch x
    (host clock around work ending in a synchronize)."""
    import torch

    for _ in range(warmup):
        fn(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(x)
    torch.cuda.synchronize()
    return iters * x.shape[0] / (time.perf_counter() - t0)


def u8_diff(got, ref):
    """max |d| and the share of values that differ, in uint8 levels."""
    d = np.abs(got.astype(int) - ref.astype(int))
    return int(d.max()), float((d > 0).mean())


def chain_images(rng, n, size):
    """n uint8 (size, size, 3) images for the post chains: photo-like colour
    fields, then a pale overcast sky (it trips the has-sky gate) and seeded
    noise (a dense Canny map)."""
    sky = np.empty((size, size, 3), np.float32)
    sky[...] = [196.0, 206.0, 222.0]
    sky = np.clip(np.round(sky + rng.normal(0, 3, sky.shape)), 0, 255)
    noise = rng.integers(0, 256, (size, size, 3))
    return smooth_images(rng, n - 2, (size, size)) + [sky.astype(np.uint8),
                                                      noise.astype(np.uint8)]


def level_stats(got, ref):
    """(share of values more than 1 level apart, mean |d| in levels)."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    return float((d > 1).mean()), float(d.mean())


def check_levels(what, got, ref):
    share, mean = level_stats(got, ref)
    log(f"    {what}: > 1 level on {share:.3e} of values, mean |d| "
        f"{mean:.4f} levels")
    if share > CHAIN_LEVEL_SHARE or mean > CHAIN_MEAN_LEVELS:
        raise AssertionError(f"{what}: card and CPU disagree ({share:.3e} of "
                             f"values > 1 level, mean {mean:.4f})")


def phase_post_chain(rng, dev):
    """The local-style post chains (``pipelines/batch.py::_postprocess``) on
    the card against the port on the CPU, on the same canvas and styled
    arrays: the masks, then every mode with colour boost and smoothing on
    and off. Then each chain alone at the rate cells: CUDA-event ms, device
    ms and device operations per batch (``chain`` in the returned dict)."""
    import torch

    from multi_style_transfer_gan_tpu_torch.ops.color import rgb_to_gray
    from multi_style_transfer_gan_tpu_torch.ops.filters import canny
    from multi_style_transfer_gan_tpu_torch.pipelines import batch as B

    canvas = np.stack(chain_images(rng, CHAIN_BATCH, 256)).astype(np.float32)
    styled = rng.integers(0, 256, canvas.shape).astype(np.float32)
    c_cpu, s_cpu = torch.from_numpy(canvas), torch.from_numpy(styled)
    c_dev, s_dev = c_cpu.to(dev), s_cpu.to(dev)
    masks = {"sky mask": lambda c: B._sky_mask(c)[0],
             "detail mask": B._detail_mask,
             "canny": lambda c: canny(rgb_to_gray(c))}
    log(f"[post chain] {canvas.shape} canvas, card vs CPU")
    for name, fn in masks.items():
        share = float((fn(c_dev).cpu() == fn(c_cpu)).float().mean())
        log(f"    {name}: equal on {share:.6f} of pixels")
        if share < MASK_SHARE:
            raise AssertionError(f"{name}: card and CPU agree on {share:.6f} "
                                 f"of pixels")
    has_sky = B._sky_mask(c_dev)[1].cpu().tolist()
    dense = float(B._detail_mask(c_dev)[-1].float().mean())
    log(f"    has-sky gate per image {has_sky}; detail mask of the noise "
        f"image covers {dense:.3f}")
    if has_sky != B._sky_mask(c_cpu)[1].tolist() or not has_sky[-2] \
            or any(has_sky[:-2]) or dense < 0.5:
        raise AssertionError("the sky gate or the dense detail mask is off")
    for mode, ec, sm in CHAIN_CASES:
        got, ref = (torch.clamp(torch.round(B._postprocess(
            c, s, mode, 0.8, 0.7, ec, sm)), 0, 255).cpu().numpy()
            for c, s in ((c_dev, s_dev), (c_cpu, s_cpu)))
        check_levels(f"_postprocess {mode}, enhance_colors={ec}, "
                     f"smooth={sm}", got, ref)

    chain = {}
    for canvas_px, n in MODE_CELLS:
        c = torch.from_numpy(np.stack(smooth_images(
            rng, n, (canvas_px, canvas_px)))).to(dev).float()
        st = torch.from_numpy(np.stack(smooth_images(
            rng, n, (canvas_px, canvas_px)))).to(dev).float()
        for mode in POST_MODES:
            fn = lambda: B._postprocess(c, st, mode, 0.8, 0.7, True, True)
            ev_ms = time_ms(fn, iters=10, warmup=2)
            dev_ms, ops = device_profile(fn, iters=5, warmup=1)
            chain[(canvas_px, n, mode)] = (ev_ms, dev_ms, ops)
            log(f"[post chain] {mode} alone, canvas {canvas_px} batch {n}: "
                f"{ev_ms:.3f} ms events, {dev_ms:.3f} ms device, "
                f"{ops:.0f} device operations per batch")
    return chain


def phase_generator(rng, dev, counts):
    """The uint8 program with each engine: fp32 on the card vs the CPU plain
    path and packed vs NHWC on the card (launches per forward checked), the
    enhanced and advanced post chains in the program card vs CPU, then bf16
    img/s of both engines in turns at every canvas and batch, with the two
    post-chain modes beside ``cyclegan`` at ``MODE_CELLS``."""
    import torch

    from multi_style_transfer_gan_tpu_torch.pipelines import (
        load_generator, make_batch_fn,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu_model = load_generator(TRAINED, device=dev)
    cpu_model = load_generator(TRAINED, device="cpu")
    log(f"[generator] {gpu_model.kind} c{gpu_model.channels} direction "
        f"{gpu_model.direction}, {sum(p.numel() for p in gpu_model.module.parameters())} "
        f"parameters")
    batch = np.stack(smooth_images(rng, GEN_BATCH, (256, 256)))

    fp32, bf16, outs = {}, {}, {}
    for engine in ENGINES:
        fp32[engine] = make_batch_fn(gpu_model, "cyclegan", engine=engine,
                                     device=dev)
        bf16[engine] = make_batch_fn(gpu_model, "cyclegan", engine=engine,
                                     compute_dtype=torch.bfloat16, device=dev)
        before = counts()
        got = outs[engine] = fp32[engine](batch).cpu().numpy()
        launched = [a - b for a, b in zip(counts(), before)]
        ref = make_batch_fn(cpu_model, "cyclegan", engine=engine,
                            device="cpu")(batch).numpy()
        dmax, share = u8_diff(got, ref)
        log(f"[generator] {engine} fp32 card vs CPU plain, {batch.shape} "
            f"uint8: max diff {dmax}, differing share {share:.3e}; launches "
            f"per forward (NHWC attention, block, packed attention, "
            f"relayout): {launched}")
        if launched != FORWARD_LAUNCHES[engine]:
            raise AssertionError(f"{engine}: expected launches per forward "
                                 f"{FORWARD_LAUNCHES[engine]}, got {launched}")
        if got.shape != batch.shape or dmax > U8_MAX_DIFF or share > U8_MAX_SHARE:
            raise AssertionError(f"{engine} fp32 program on the card "
                                 f"disagrees with the CPU")
        if np.abs(got.astype(int) - batch.astype(int)).mean() < 2.0:
            raise AssertionError("output is a passthrough, not a translation")
    dmax, share = u8_diff(outs["packed"], outs["nhwc"])
    log(f"[generator] fp32 packed vs NHWC engine on the card: max diff {dmax}, "
        f"differing share {share:.3e}")
    if dmax > U8_MAX_DIFF or share > U8_MAX_SHARE:
        raise AssertionError("packed and NHWC engines disagree on the card")

    # the post chains inside the program: fp32 card vs CPU, each engine
    mode_batch = np.stack(chain_images(rng, 4, 256))
    for mode in POST_MODES:
        for engine in ENGINES:
            got, ref = (make_batch_fn(m, "local_style", mode, engine=engine,
                                      device=d)(mode_batch).cpu().numpy()
                        for m, d in ((gpu_model, dev), (cpu_model, "cpu")))
            if got.shape != mode_batch.shape:
                raise AssertionError(f"{mode} program gave {got.shape}")
            check_levels(f"[generator] {engine} fp32 program, local_style "
                         f"{mode}, card vs CPU", got, ref)

    programs = {("cyclegan", e): bf16[e] for e in ENGINES}
    for mode in POST_MODES:
        for engine in ENGINES:
            programs[(mode, engine)] = make_batch_fn(
                gpu_model, "local_style", mode, engine=engine,
                compute_dtype=torch.bfloat16, device=dev)
    rates = {}
    for canvas in CANVASES:
        for n in RATE_BATCHES:
            x = torch.from_numpy(np.stack(smooth_images(
                rng, n, (canvas, canvas)))).to(dev)
            if n == GEN_BATCH:
                for engine in ENGINES:
                    mean_lsb = (bf16[engine](x).float()
                                - fp32[engine](x).float()).abs().mean().item()
                    log(f"[generator] {engine} bf16 vs fp32 at canvas "
                        f"{canvas}: mean |d| {mean_lsb:.3f} levels")
                    if mean_lsb > BF16_MEAN_LSB:
                        raise AssertionError(f"{engine} bf16 program drifts "
                                             f"{mean_lsb:.2f} levels from fp32")
            modes = ("cyclegan",) + (POST_MODES if (canvas, n) in MODE_CELLS
                                     else ())
            keys = [(m, e) for m in modes for e in ENGINES]
            turns = {k: [] for k in keys}
            for k in keys + keys[::-1]:   # in order, then in reverse
                turns[k].append(program_rate(programs[k], x))
            rate = rates[(canvas, n)] = {k: sum(r) / len(r)
                                         for k, r in turns.items()}
            for m in modes:
                log(f"[generator] bf16 program {m}, batch {n} at canvas "
                    f"{canvas} (device-resident uint8 in and out): NHWC "
                    f"{rate[(m, 'nhwc')]:.1f} img/s, packed "
                    f"{rate[(m, 'packed')]:.1f} img/s (packed/NHWC "
                    f"{rate[(m, 'packed')] / rate[(m, 'nhwc')]:.3f}); turns "
                    f"{turns[(m, 'nhwc')]}, {turns[(m, 'packed')]}")
    return rates


def phase_cli(rng, tmp):
    """The batch CLI on 24 JPEGs of mixed sizes at --batch_size 8, once per
    engine flag (auto must resolve to packed at batch 8), then with --mode
    local_style in the enhanced and the advanced post chain, in ``tmp``:
    the inputs in ``in/``, each run's outputs in ``out_<engine>_<sub>/``
    (the evaluation path compares them)."""
    import contextlib

    from PIL import Image

    from multi_style_transfer_gan_tpu_torch.cli.batch_process_images import main

    src = os.path.join(tmp, "in")
    models = os.path.join(tmp, "models")
    os.makedirs(src)
    os.makedirs(models)
    shutil.copy(TRAINED, os.path.join(models, "cyclegan_epoch_200.pth"))
    shutil.copy(TRAINED, os.path.join(models, "G_BA_epoch_200.pth"))
    sizes = {}
    for i in range(24):
        w, h = int(rng.integers(96, 640)), int(rng.integers(96, 640))
        name = f"photo_{i:02d}.jpg"
        Image.fromarray(smooth_images(rng, 1, (w, h))[0]).save(
            os.path.join(src, name), quality=92)
        sizes[name] = (w, h)
    runs = [(engine, ["--mode", "cyclegan"], "cyclegan_photo2monet")
            for engine in ("packed", "auto", "nhwc")]
    runs += [("auto", ["--mode", "local_style", "--local_style_mode", m],
              f"local_style_{m}_photo2monet") for m in POST_MODES]
    for engine, mode_flags, sub in runs:
        out = os.path.join(tmp, f"out_{engine}_{sub}")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = main(["--input_dir", src, "--output_dir", out,
                       "--models_dir", models, *mode_flags,
                       "--direction", "photo2monet", "--bf16",
                       "--batch_size", "8", "--engine", engine])
        elapsed = time.perf_counter() - t0
        for line in buf.getvalue().splitlines():
            log(f"    {line}")
        what = f"{' '.join(mode_flags)} --engine {engine}"
        if rc != 0:
            raise AssertionError(f"batch CLI {what} exited {rc}")
        if engine == "auto" and "engine=auto -> packed (batch 8" not in \
                buf.getvalue():
            raise AssertionError("--engine auto did not take the packed "
                                 "engine at batch 8")
        done = 0
        for name, size in sizes.items():
            path = os.path.join(out, sub, name)
            if os.path.exists(path):
                with Image.open(path) as img:
                    done += img.size == size
        log(f"[cli] {what}: {done}/24 outputs at their original sizes; "
            f"CLI wall {elapsed:.2f} s including model load")
        if done != 24:
            raise AssertionError(f"batch CLI {what} wrote {done}/24 "
                                 f"correct outputs")


def phase_server(rng, dev, engine, local_style_mode=None):
    """The HTTP server with ``engine``: four concurrent requests in
    ``cyclegan`` mode, or one in ``local_style`` with ``local_style_mode``."""
    import torch
    from PIL import Image

    from multi_style_transfer_gan_tpu_torch.pipelines import load_generator
    from multi_style_transfer_gan_tpu_torch.serving import (
        StyleTransferService, serve,
    )

    model = load_generator(TRAINED, device=dev)
    mode = {} if local_style_mode is None else dict(
        mode="local_style", local_style_mode=local_style_mode)
    service = StyleTransferService(model, canvas=256, max_batch=8,
                                   compute_dtype=torch.bfloat16, engine=engine,
                                   device=dev, **mode)
    server = serve(service, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address
    what = f"engine {engine}" + ("" if local_style_mode is None
                                 else f", local_style {local_style_mode}")
    try:
        sizes = [(320, 200), (200, 320), (256, 256), (500, 375)]
        if local_style_mode is not None:
            sizes = sizes[:1]
        replies = [None] * len(sizes)

        def post(i):
            buf = io.BytesIO()
            Image.fromarray(smooth_images(np.random.default_rng(SEED + i), 1,
                                          sizes[i])[0]).save(buf, "JPEG")
            req = urllib.request.Request(f"http://{host}:{port}/stylize",
                                         data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                replies[i] = (r.status, r.read())

        workers = [threading.Thread(target=post, args=(i,))
                   for i in range(len(sizes))]
        for w in workers:
            w.start()
        for w in workers:
            w.join(180)
        good = 0
        for (status, body), size in zip(replies, sizes):
            with Image.open(io.BytesIO(body)) as img:
                good += status == 200 and img.format == "PNG" and img.size == size
        with urllib.request.urlopen(f"http://{host}:{port}/stats",
                                    timeout=30) as r:
            stats = json.loads(r.read())
        log(f"[server] {what}: {good}/{len(sizes)} replies 200 with a PNG "
            f"of the right size; /stats requests {stats['requests']}, "
            f"batches {stats['batches']}")
        if good != len(sizes) or stats["requests"] != len(sizes):
            raise AssertionError(f"server round trip failed ({what})")
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(10)


def phase_single_image(rng, dev):
    """The single-image pipelines on a generated 400 x 300 photo, each on the
    card against the same code on the CPU. First the ``direct_transform``,
    ``enhanced_local_style`` (without its figure) and ``improved_smooth``
    CLIs as a user runs them; then, with TF32 off in the generator,
    ``transform_image`` (at most 1 level apart, as the program),
    ``enhanced_local_style_transfer`` and the five advanced variants
    through ``render_variants``, the module function that
    ``generate_with_different_settings`` calls before it draws its grid
    (the post chain's limits). The
    card's machine has no matplotlib, so the paths that draw a figure (the
    size sweep, the skip blends, the advanced CLI, the local-style figure,
    ``compare_models``) are held against the JAX package by the CPU tests
    only, and not driven here."""
    import contextlib

    from PIL import Image

    from multi_style_transfer_gan_tpu_torch.cli import (
        direct_transform, enhanced_local_style, improved_smooth,
    )
    from multi_style_transfer_gan_tpu_torch.pipelines import (
        load_generator, transform_image,
    )
    from multi_style_transfer_gan_tpu_torch.pipelines.advanced import (
        VARIANTS, render_variants,
    )
    from multi_style_transfer_gan_tpu_torch.pipelines.local_style import (
        enhanced_local_style_transfer,
    )

    def run_cli(cli, argv, out, device):
        """The CLI's main with its DEVICE set to ``device``; the image it
        wrote."""
        buf = io.StringIO()
        saved, cli.DEVICE = cli.DEVICE, device
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv + [out])
        finally:
            cli.DEVICE = saved
        name = cli.__name__.rsplit(".", 1)[-1]
        log(f"[single image] {name} on {device}: exit {rc}, wall "
            f"{time.perf_counter() - t0:.2f} s including model load; "
            + " | ".join(buf.getvalue().splitlines()))
        if rc != 0 or not os.path.exists(out):
            raise AssertionError(f"{name} on {device} exited {rc}")
        with Image.open(out) as img:
            return np.asarray(img.convert("RGB"))

    with tempfile.TemporaryDirectory() as tmp:
        photo = os.path.join(tmp, "photo.png")
        Image.fromarray(smooth_images(rng, 1, (400, 300))[0]).save(photo)
        outs = {}
        for where, device in (("card", dev.type), ("cpu", "cpu")):
            d = os.path.join(tmp, where)
            os.makedirs(d)
            direct = os.path.join(d, "direct.png")
            outs[where] = {
                "direct_transform": run_cli(
                    direct_transform, ["--image", photo, "--model", TRAINED,
                                       "--output"], direct, device),
                "enhanced_local_style": run_cli(
                    enhanced_local_style, ["--image", photo, "--model",
                                           TRAINED, "--no_comparison",
                                           "--output"],
                    os.path.join(d, "local.png"), device),
                # both devices repair the card's direct output
                "improved_smooth": run_cli(
                    improved_smooth, ["--input", os.path.join(
                        tmp, "card", "direct.png"), "--original", photo,
                                      "--output"],
                    os.path.join(d, "smooth.png"), device),
            }
            if os.path.exists(os.path.join(d, "comparison.jpg")):
                raise AssertionError("--no_comparison drew the figure")
        # the CLIs run the generator at load_generator's default precision,
        # where cuDNN may take TF32 on the card: a sanity bound on the two
        # that run it (a broken path lands far above), the post chain's
        # limits on the repair, which runs no generator
        got, ref = outs["card"], outs["cpu"]
        for name in got:
            if got[name].shape != ref[name].shape:
                raise AssertionError(f"{name}: {got[name].shape} vs "
                                     f"{ref[name].shape}")
        for name in ("direct_transform", "enhanced_local_style"):
            mean = level_stats(got[name], ref[name])[1]
            log(f"    {name} CLI {got[name].shape}, TF32 allowed: mean |d| "
                f"{mean:.4f} levels")
            if mean > BF16_MEAN_LSB:
                raise AssertionError(f"{name} CLI drifts {mean:.2f} levels")
        check_levels(f"improved_smooth CLI {got['improved_smooth'].shape}",
                     got["improved_smooth"], ref["improved_smooth"])

        # the same pipelines with TF32 off (precision 'highest'), card vs CPU
        models = {"card": load_generator(TRAINED, precision="highest",
                                         device=dev),
                  "cpu": load_generator(TRAINED, device="cpu")}
        direct = {w: np.clip(np.round(transform_image(m, photo) * 255), 0, 255)
                  for w, m in models.items()}
        dmax, share = u8_diff(direct["card"], direct["cpu"])
        log(f"    transform_image {direct['card'].shape}: max diff {dmax}, "
            f"differing share {share:.3e}")
        if direct["card"].shape != (256, 256, 3) or dmax > U8_MAX_DIFF \
                or share > U8_MAX_SHARE:
            raise AssertionError("transform_image: card and CPU disagree")
        local = {}
        for where, m in models.items():
            path = os.path.join(tmp, where, "local_highest.png")
            local[where] = np.asarray(enhanced_local_style_transfer(
                m, photo, path, make_comparison=False))
        check_levels(f"enhanced_local_style_transfer {local['card'].shape}",
                     local["card"], local["cpu"])
        t0 = time.perf_counter()
        _, got_v = render_variants(models["card"], photo)
        wall = time.perf_counter() - t0
        _, ref_v = render_variants(models["cpu"], photo)
        log(f"[single image] advanced variants on the card: {wall:.2f} s")
        if list(got_v) != list(VARIANTS):
            raise AssertionError(f"advanced variants: {list(got_v)}")
        for name in VARIANTS:
            check_levels(f"advanced {name}", got_v[name].cpu().numpy(),
                         ref_v[name].numpy())


def uint8_pairs(rng, n, batch, size, dev):
    """n (A, B) pairs of photo-like uint8 batches on the card."""
    import torch

    return [tuple(torch.from_numpy(np.stack(smooth_images(rng, batch, (size, size))))
                  .to(dev) for _ in range(2)) for _ in range(n)]


def phase_train_step(rng, dev):
    """The bf16 CycleGAN step at the reference configuration (c16, one
    block, 256^2, batch 8, pair batching) from a seeded fresh init: finite
    losses, G, D and u moved, launches per step, ms/step; then one fp32
    step on the card against the port on the CPU (c16, 128^2, batch 2)."""
    import torch

    from multi_style_transfer_gan_tpu_torch.ops import kernels as K
    from multi_style_transfer_gan_tpu_torch.train import cyclegan_init_state

    state = cyclegan_init_state(SEED, 16, 1, device=dev)
    before = {n: {k: v.clone() for k, v in getattr(state, n).state_dict().items()}
              for n in ("G_AB", "G_BA", "D_A", "D_B")}
    step = train_step_runner(state, uint8_pairs(rng, 2, TRAIN_BATCH, 256, dev),
                             pair_batching=True)
    counts = lambda: {n: getattr(K, n).launches for n in TRAIN_LAUNCHES_PER_STEP}
    losses = launches_of(step, counts, TRAIN_LAUNCHES_PER_STEP, "[train step]")
    for _ in range(2):   # warm-up: 3 steps in all
        step()
    torch.cuda.synchronize()
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        losses = step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1000 / iters
    vals = {k: float(v) for k, v in losses.items()}
    log(f"[train step] bf16 c16 256^2 batch {TRAIN_BATCH}, pair batching: "
        f"{ms:.2f} ms/step, {TRAIN_BATCH * 1000 / ms:.1f} image pairs/s "
        f"({card_line()}); losses after {state.step} steps {vals}; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not all(np.isfinite(v) for v in vals.values()):
        raise AssertionError(f"non-finite losses {vals}")
    for name, sd in before.items():
        now = getattr(state, name).state_dict()
        moved = sum(not torch.equal(now[k], v) for k, v in sd.items())
        if not moved:
            raise AssertionError(f"{name} did not move")
        if name[0] == "D" and torch.equal(now["main.2.weight_u"],
                                          sd["main.2.weight_u"]):
            raise AssertionError(f"{name} spectral-norm u did not move")

    # one fp32 step on the card vs the same step on the CPU (TF32 off)
    host = [t.cpu() for t in uint8_pairs(rng, 1, 2, 128, dev)[0]]
    fp32_step_card_vs_cpu(dev, 16, "[train step]", host=host)
    return ms


def phase_train_cli(rng, dev):
    """The train CLI on 16 synthetic JPEGs per domain: 2 epochs with
    checkpoints every epoch, a rerun to 3 epochs that resumes at epoch 2,
    and the saved G_AB stylizing a batch through load_generator."""
    import contextlib
    import torch
    from PIL import Image

    from multi_style_transfer_gan_tpu_torch.cli.train import main
    from multi_style_transfer_gan_tpu_torch.pipelines import (
        load_generator, make_batch_fn,
    )

    with tempfile.TemporaryDirectory() as tmp:
        for domain in ("A", "B"):
            d = os.path.join(tmp, "data", f"train{domain}")
            os.makedirs(d)
            for i in range(16):
                w, h = int(rng.integers(256, 400)), int(rng.integers(256, 400))
                Image.fromarray(smooth_images(rng, 1, (w, h))[0]).save(
                    os.path.join(d, f"{i:02d}.jpg"), quality=92)
        models = os.path.join(tmp, "models")
        argv = ["--data_root", os.path.join(tmp, "data"), "--save_dir", models,
                "--image_size", "256", "--batch_size", "8",
                "--checkpoint_every", "1", "--log_every", "1", "--seed", "0",
                "--resume_dir", os.path.join(tmp, "ckpt")]
        outputs = []
        for epochs in (2, 3):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = main(argv + ["--num_epochs", str(epochs)])
            outputs.append(buf.getvalue())
            log(f"[train cli] --num_epochs {epochs}: exit {rc}, "
                f"{time.perf_counter() - t0:.2f} s wall; its output:")
            for line in buf.getvalue().splitlines():
                log(f"    {line}")
            if rc != 0:
                raise AssertionError(f"train CLI exited {rc}")
        for epoch in (1, 2, 3):
            for name in ("G_AB", "G_BA", "discriminators"):
                path = os.path.join(models, f"{name}_epoch_{epoch}.pth")
                if not os.path.exists(path):
                    raise AssertionError(f"train CLI did not write {path}")
        if "at epoch 2" not in outputs[1] or "epoch 1 step" in outputs[1]:
            raise AssertionError("the rerun did not resume at epoch 2")
        model = load_generator(os.path.join(models, "G_AB_epoch_3.pth"),
                               device=dev)
        batch = np.stack(smooth_images(rng, 4, (256, 256)))
        out = make_batch_fn(model, "cyclegan", compute_dtype=torch.bfloat16,
                            device=dev)(batch).cpu().numpy()
        log(f"[train cli] saved G_AB (direction {model.direction}) stylized "
            f"{batch.shape}: output {out.shape} {out.dtype}, mean |out - in| "
            f"{np.abs(out.astype(int) - batch.astype(int)).mean():.2f} levels")
        if out.shape != batch.shape or out.dtype != np.uint8 or out.std() == 0:
            raise AssertionError("the trained G_AB does not stylize")


# ---------------------------------------------------------------------------
# the pretraining path: the plain generator served, masked-inpainting
# pretraining (plain at the reference's c64, enhanced at c16) and its CLI

def plain_checkpoint(path, channels):
    """A random-init plain ``Generator(channels)`` from SEED, with seeded
    BatchNorm affines and running statistics (so eval mode normalizes for
    real), saved in the reference's legacy CycleGAN flavor
    (``G_BA_state_dict``)."""
    import torch

    from multi_style_transfer_gan_tpu_torch.models import PlainGenerator

    m = PlainGenerator(channels, generator=torch.Generator().manual_seed(SEED))
    g = np.random.default_rng(SEED)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                n = mod.num_features
                for t, lo, hi in ((mod.weight, 0.5, 1.5), (mod.bias, -0.1, 0.1),
                                  (mod.running_mean, -0.1, 0.1),
                                  (mod.running_var, 0.5, 1.5)):
                    t.copy_(torch.from_numpy(g.uniform(lo, hi, n)
                                             .astype(np.float32)))
    torch.save({"G_BA_state_dict": m.state_dict(), "epoch": 0}, path)


def phase_plain_serving(rng, dev):
    """The plain generator at the reference's width (c64) from a legacy
    checkpoint: the fp32 forward on the card against the CPU (TF32 off),
    the uint8 program fp32 card vs CPU under both engine flags, bf16 vs
    fp32, and its bf16 img/s at canvas 256, batches 16 and 64. Returns
    {batch: img/s}."""
    import torch

    from multi_style_transfer_gan_tpu_torch.ops import to_model_range
    from multi_style_transfer_gan_tpu_torch.pipelines import (
        load_generator, make_batch_fn,
    )

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "plain.pth")
        plain_checkpoint(path, PLAIN_CHANNELS)
        gpu = load_generator(path, precision="highest", device=dev)
        cpu = load_generator(path, device="cpu")
    log(f"[plain] {gpu.kind} c{gpu.channels} direction {gpu.direction}, "
        f"{sum(p.numel() for p in gpu.module.parameters())} parameters")
    batch = np.stack(smooth_images(rng, PLAIN_FWD_BATCH, (256, 256)))
    x = to_model_range(torch.from_numpy(batch))
    got, ref = gpu.apply(x.to(dev)).cpu(), cpu.apply(x)
    err = (got - ref).abs().max().item()
    log(f"[plain] fp32 forward c{PLAIN_CHANNELS} {tuple(x.shape)}, card vs "
        f"CPU: max |d| {err:.3e} (limit {PLAIN_FP32_ATOL}); output std "
        f"{got.std().item():.3f}")
    if got.shape != x.shape or not torch.isfinite(got).all() \
            or err > PLAIN_FP32_ATOL or got.std().item() < 1e-3:
        raise AssertionError("plain fp32 forward: card and CPU disagree")

    fp32 = make_batch_fn(gpu, "cyclegan", device=dev)
    for engine in ENGINES:   # a plain model has one engine whatever is asked
        out = make_batch_fn(gpu, "cyclegan", engine=engine,
                            device=dev)(batch).cpu().numpy()
        want = make_batch_fn(cpu, "cyclegan", engine=engine,
                             device="cpu")(batch).numpy()
        dmax, share = u8_diff(out, want)
        log(f"[plain] uint8 program --engine {engine}, fp32 card vs CPU: "
            f"max diff {dmax}, differing share {share:.3e}")
        if out.shape != batch.shape or dmax > U8_MAX_DIFF \
                or share > U8_MAX_SHARE:
            raise AssertionError("plain uint8 program: card and CPU disagree")
    bf16 = make_batch_fn(gpu, "cyclegan", compute_dtype=torch.bfloat16,
                         device=dev)
    bn = {t.dtype for m in bf16.module.modules()
          if isinstance(m, torch.nn.BatchNorm2d)
          for t in (m.weight, m.bias, m.running_mean, m.running_var)}
    if bn != {torch.float32}:
        raise AssertionError(f"bf16 program's BatchNorms are {bn}, not fp32")
    rates = {}
    for n in RATE_BATCHES:
        xb = torch.from_numpy(np.stack(smooth_images(rng, n, (256, 256)))).to(dev)
        if n == RATE_BATCHES[0]:
            mean_lsb = (bf16(xb).float() - fp32(xb).float()).abs().mean().item()
            log(f"[plain] bf16 vs fp32 program at canvas 256: mean |d| "
                f"{mean_lsb:.3f} levels")
            if mean_lsb > BF16_MEAN_LSB:
                raise AssertionError(f"plain bf16 program drifts "
                                     f"{mean_lsb:.2f} levels")
        turns = [program_rate(bf16, xb) for _ in range(2)]
        rates[n] = sum(turns) / len(turns)
        log(f"[plain] bf16 program, batch {n} at canvas 256 "
            f"(device-resident uint8 in and out): {rates[n]:.1f} img/s "
            f"({card_line()}); runs {turns}")
    return rates


def pretrain_steps(state, batches, masks, dtype):
    """A function that runs one pretrain step on the next batch and mask."""
    from multi_style_transfer_gan_tpu_torch.ops import to_model_range
    from multi_style_transfer_gan_tpu_torch.train import pretrain_train_step

    it = {"i": 0}

    def step():
        i = it["i"] = it["i"] + 1
        return pretrain_train_step(state, to_model_range(
            batches[i % len(batches)]), masks[i % len(masks)],
            compute_dtype=dtype)[1]
    return step


def time_pretrain(step, what, batch):
    """3 warm-up and 10 timed steps on the host clock, then the profiled
    device time of 5 steps: (ms/step, device ms/step, idle share)."""
    import torch

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        loss = step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1000 / 10
    dev_ms = device_ms(step, iters=5, warmup=0)
    idle = max(0.0, 1.0 - dev_ms / ms)
    log(f"[pretrain] {what}: {ms:.2f} ms/step, {batch * 1000 / ms:.1f} "
        f"images/s, device {dev_ms:.2f} ms/step (torch.profiler), device "
        f"idle share {idle:.1%} ({card_line()}); loss {float(loss):.4f}")
    if not np.isfinite(float(loss)):
        raise AssertionError(f"{what}: non-finite loss {float(loss)}")
    return ms, dev_ms, idle


def phase_pretrain_step(rng, dev):
    """Masked-inpainting pretraining from seeded fresh inits: the plain bf16
    step at c64, 256^2, batch 16 (finite loss, parameters and running
    statistics moved, ms/step, images/s, device idle share), two fp32 plain
    steps on the card against the CPU on the same masks (c64, 128^2, batch
    2), then the enhanced bf16 step at c16, 256^2, batch 8 (its launches
    per step, ms/step). Returns {name: (ms, device ms, idle share)}."""
    import torch

    from multi_style_transfer_gan_tpu_torch.data import random_patch_mask
    from multi_style_transfer_gan_tpu_torch.ops import kernels as K
    from multi_style_transfer_gan_tpu_torch.ops import to_model_range
    from multi_style_transfer_gan_tpu_torch.train import (
        pretrain_init_state, pretrain_train_step,
    )

    gen = torch.Generator().manual_seed(SEED + 1)

    def data(batch, size, n=2):
        imgs = [torch.from_numpy(np.stack(smooth_images(rng, batch,
                                                        (size, size)))).to(dev)
                for _ in range(n)]
        return imgs, [random_patch_mask(batch, size, generator=gen, device=dev)
                      for _ in range(n)]

    out = {}
    torch.cuda.reset_peak_memory_stats()
    state = pretrain_init_state(SEED, PLAIN_CHANNELS, device=dev)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    step = pretrain_steps(state, *data(PRETRAIN_BATCH, 256),
                          torch.bfloat16)
    out["plain"] = time_pretrain(step, f"plain bf16 c{PLAIN_CHANNELS} 256^2 "
                                 f"batch {PRETRAIN_BATCH}", PRETRAIN_BATCH)
    now = state.model.state_dict()
    still = [k for k, v in before.items() if torch.equal(now[k], v)]
    log(f"[pretrain] plain: {len(before) - len(still)}/{len(before)} state "
        f"tensors moved after {state.step} steps; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if any(k.endswith(("weight", "running_mean", "running_var"))
           for k in still):
        raise AssertionError(f"plain pretraining left {still} unmoved")
    del state, step

    # two fp32 steps on the card vs the same steps on the CPU (TF32 off)
    imgs = [torch.from_numpy(np.stack(smooth_images(rng, 2, (128, 128))))
            for _ in range(2)]
    masks = [random_patch_mask(2, 128, generator=gen, device="cpu")
             for _ in range(2)]
    losses = []
    for device in (dev, torch.device("cpu")):
        st = pretrain_init_state(SEED + 1, PLAIN_CHANNELS, device=device)
        losses.append([float(pretrain_train_step(
            st, to_model_range(x.to(device)), m.to(device))[1])
            for x, m in zip(imgs, masks)])
    rel = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    log(f"[pretrain] plain fp32 c{PLAIN_CHANNELS} 128^2 batch 2, two steps "
        f"card vs CPU: {losses[0]} vs {losses[1]}; max relative difference "
        f"{rel:.2e} (limit {PRETRAIN_FP32_RTOL})")
    if rel > PRETRAIN_FP32_RTOL:
        raise AssertionError("fp32 pretrain steps: card and CPU disagree")

    state = pretrain_init_state(SEED, 16, model="enhanced", device=dev)
    step = pretrain_steps(state, *data(TRAIN_BATCH, 256), torch.bfloat16)
    launches_of(step, lambda: {n: getattr(K, n).launches
                               for n in PRETRAIN_LAUNCHES_PER_STEP},
                PRETRAIN_LAUNCHES_PER_STEP, "[pretrain] enhanced")
    out["enhanced"] = time_pretrain(step, f"enhanced bf16 c16 256^2 batch "
                                    f"{TRAIN_BATCH}", TRAIN_BATCH)
    return out


def phase_pretrain_cli(rng, dev):
    """The pretrain CLI (plain c64, the reference's recipe at --batch_size
    4) on a small ``write_domains`` folder: 2 epochs with a checkpoint each,
    a rerun to 3 that resumes at epoch 2; the checkpoint then stylizes
    through the batch CLI with --engine auto, as the plain generator of a
    legacy CycleGAN file (--mode cyclegan) and as it is (--mode
    local_style)."""
    import contextlib

    import torch
    from PIL import Image

    from multi_style_transfer_gan_tpu_torch.cli.batch_process_images import (
        main as batch_main,
    )
    from multi_style_transfer_gan_tpu_torch.cli.pretrain import main
    from multi_style_transfer_gan_tpu_torch.data import list_images, write_domains

    def run(fn, argv, what):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = fn(argv)
        log(f"[pretrain cli] {what}: exit {rc}, "
            f"{time.perf_counter() - t0:.2f} s wall; its output:")
        for line in buf.getvalue().splitlines():
            log(f"    {line}")
        if rc != 0:
            raise AssertionError(f"{what} exited {rc}")
        return buf.getvalue()

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        write_domains(data, n_train=8, n_test=4, size=256, seed=SEED)
        models = os.path.join(tmp, "models")
        argv = ["--data_root", data, "--save_dir", models, "--batch_size",
                "4", "--channels", str(PLAIN_CHANNELS), "--checkpoint_every",
                "1", "--log_every", "2", "--seed", "0"]
        run(main, argv + ["--num_epochs", "2"], "pretrain --num_epochs 2")
        ck2 = os.path.join(models, "generator_pretrain_epoch_2.pth")
        second = run(main, argv + ["--num_epochs", "3", "--resume", ck2],
                     "pretrain --num_epochs 3 --resume epoch 2")
        if "at epoch 2" not in second or "epoch 1 [" in second:
            raise AssertionError("the rerun did not resume at epoch 2")
        ck3 = os.path.join(models, "generator_pretrain_epoch_3.pth")
        ck = torch.load(ck3, map_location="cpu", weights_only=True)
        nbt = int(ck["model_state_dict"]["encoder.3.num_batches_tracked"])
        if ck["epoch"] != 2 or nbt != 12:
            raise AssertionError(f"checkpoint epoch {ck['epoch']}, "
                                 f"num_batches_tracked {nbt}")

        serve = os.path.join(tmp, "serve")
        os.makedirs(serve)
        torch.save({"G_BA_state_dict": ck["model_state_dict"]},
                   os.path.join(serve, "cyclegan_epoch_200.pth"))
        shutil.copy(ck3, os.path.join(serve, "G_BA_epoch_200.pth"))
        src = os.path.join(data, "testB")
        for mode, sub in ((["--mode", "cyclegan"], "cyclegan_photo2monet"),
                          (["--mode", "local_style"],
                           "local_style_enhanced_photo2monet")):
            out = os.path.join(tmp, "out")
            text = run(batch_main, ["--input_dir", src, "--output_dir", out,
                                    "--models_dir", serve, *mode,
                                    "--direction", "photo2monet", "--bf16",
                                    "--batch_size", "8", "--engine", "auto"],
                       f"batch CLI {' '.join(mode)} --engine auto")
            if f"loaded plain generator (channels={PLAIN_CHANNELS})" \
                    not in text or \
                    "engine=auto -> nhwc" not in text:
                raise AssertionError("the batch CLI did not serve the plain "
                                     "checkpoint with the NHWC engine")
            done = 0
            for path in list_images(src):
                got = os.path.join(out, sub, os.path.basename(path))
                if os.path.exists(got):
                    with Image.open(got) as img:
                        done += img.size == (256, 256) and \
                            np.asarray(img).std() > 0
            if done != 4:
                raise AssertionError(f"batch CLI {mode} wrote {done}/4")


def metric_pairs(rng, n, size, kind):
    """n fp32 (a, b) image pairs in [0, 1] at size^2: independent noise, or
    a photo-like colour field and a copy with noise of sigma 0.02."""
    if kind == "random":
        a, b = rng.random((n, size, size, 3)), rng.random((n, size, size, 3))
    else:
        a = np.stack(smooth_images(rng, n, (size, size))) / 255.0
        b = np.clip(a + rng.normal(0, 0.02, a.shape), 0, 1)
    return a.astype(np.float32), b.astype(np.float32)


def phase_metrics(rng, dev):
    """The metrics alone: ``check_metrics_device``'s probe pair on the card;
    METRIC_PAIRS random and smooth pairs at each of METRIC_SIZES through
    ``compare_pair`` on the card against the CPU, with every TF32 switch
    on (the box filter is an average pool, which no switch reaches), and
    SSIM(x, x) on the card; then ``compare_pair`` pairs/s at 256^2 for
    METRIC_RATE_BATCHES (CUDA events, pairs already on the card). Returns
    the largest deviations and the rates."""
    import torch

    from multi_style_transfer_gan_tpu_torch.metrics import quality

    a, b = quality._probe_pair()
    probe = [float(quality.ssim(a.to(d), b.to(d))) for d in (dev, "cpu")]
    quality.check_metrics_device(dev)
    log(f"[metrics] check_metrics_device probe: SSIM {probe[0]!r} on the "
        f"card, {probe[1]!r} on the CPU")

    worst = dict.fromkeys(("ssim", "psnr", "mse", "ssim_ident"), 0.0)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
            for size in METRIC_SIZES:
                for kind in ("random", "smooth"):
                    a, b = (torch.from_numpy(x) for x in
                            metric_pairs(rng, METRIC_PAIRS, size, kind))
                    want = quality.compare_pair(a, b)
                    got = {k: v.cpu() for k, v in quality.compare_pair(
                        a.to(dev), b.to(dev)).items()}
                    d = {"ssim": (got["ssim"] - want["ssim"]).abs().max(),
                         "psnr": (got["psnr"] - want["psnr"]).abs().max(),
                         "mse": ((got["mse"] - want["mse"]).abs()
                                 / want["mse"]).max(),
                         "ssim_ident": (quality.ssim(a.to(dev), a.to(dev))
                                        - 1.0).abs().max()}
                    d = {k: float(v) for k, v in d.items()}
                    log(f"[metrics] {METRIC_PAIRS} {kind} pairs at {size}^2, "
                        f"card vs CPU: SSIM max |d| {d['ssim']:.3e}, PSNR "
                        f"{d['psnr']:.3e} dB, MSE relative {d['mse']:.3e}; "
                        f"card SSIM(x, x) - 1 {d['ssim_ident']:.3e}; mean "
                        f"SSIM {want['ssim'].mean().item():.4f}")
                    for k in worst:
                        worst[k] = max(worst[k], d[k])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    limits = {"ssim": SSIM_ATOL, "psnr": PSNR_ATOL, "mse": MSE_RTOL,
              "ssim_ident": SSIM_IDENT_ATOL}
    if any(worst[k] > limits[k] for k in worst):
        raise AssertionError(f"metrics on the card disagree with the CPU: "
                             f"{worst} against {limits}")

    rates = {}
    for n in METRIC_RATE_BATCHES:
        a, b = (torch.from_numpy(x).to(dev) for x in
                metric_pairs(rng, n, 256, "smooth"))
        rates[n] = n * 1000.0 / time_ms(lambda: quality.compare_pair(a, b))
        log(f"[metrics] compare_pair at 256^2, batch {n}: {rates[n]:.1f} "
            f"pairs/s")
    return worst, rates


def random_inception_pth(path):
    """A seeded random InceptionV3 state dict at full width with
    torchvision's keys, its ``num_batches_tracked`` counters and the
    ``AuxLogits``/``fc`` head the importer drops, saved as ``.pth``: the
    route a user's torchvision file takes. Conv weights He-normal, the
    BatchNorms near identity (tests/feature_oracle.py's law)."""
    import torch

    from multi_style_transfer_gan_tpu_torch.metrics.inception import (
        InceptionV3,
    )

    gen = torch.Generator().manual_seed(SEED)
    sd = {}
    for k, v in InceptionV3().state_dict().items():
        if k.endswith("conv.weight"):
            sd[k] = torch.randn(v.shape, generator=gen) * (2.0 / v[0].numel()) ** 0.5
        elif k.endswith("bn.weight"):
            sd[k] = 0.8 + 0.4 * torch.rand(v.shape, generator=gen)
        elif k.endswith("bn.bias"):
            sd[k] = 0.05 * torch.randn(v.shape, generator=gen)
        elif k.endswith("bn.running_mean"):
            sd[k] = 0.1 * torch.randn(v.shape, generator=gen)
        else:
            sd[k] = 0.5 + torch.rand(v.shape, generator=gen)
            sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(0)
    sd["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    sd["fc.weight"] = torch.zeros(1000, 2048)
    sd["fc.bias"] = torch.zeros(1000)
    torch.save(sd, path)


def phase_fid(dev, counts, tmp):
    """m_test's path: a ``write_domains`` test tree of EVAL_IMAGES images a
    domain, the trained G_AB and G_BA at precision 'highest', and features
    from a seeded random full-width InceptionV3 ``.pth``
    (``make_inception_feature_fn``) or the fallback features. Each
    ``run_fid_eval`` on the card (panels off) checks its launches: 4 of row
    1 and 1 of row 4 per generator forward, ceil(n / EVAL_BATCH) forwards
    a direction. Card vs CPU at EVAL_CPU_IMAGES a direction, both feature
    kinds (FID relative FID_RTOL); then each kind timed on the card at
    EVAL_IMAGES, its host-clock split (decode, generator with a
    synchronize, features, the statistic, the rest) and, from one more run
    under ``torch.profiler``, its device time. Returns the numbers."""
    import contextlib
    import dataclasses
    import math

    import torch

    from multi_style_transfer_gan_tpu_torch.data import (
        ImageFolderDataset, write_domains,
    )
    from multi_style_transfer_gan_tpu_torch.metrics import fid_harness
    from multi_style_transfer_gan_tpu_torch.metrics.inception import (
        make_inception_feature_fn,
    )
    from multi_style_transfer_gan_tpu_torch.pipelines import load_generator

    data = os.path.join(tmp, "fid_data")
    t0 = time.perf_counter()
    write_domains(data, n_train=0, n_test=EVAL_IMAGES, size=256, seed=SEED)
    weights = os.path.join(tmp, "inception_v3.pth")
    random_inception_pth(weights)
    log(f"[fid] test tree of {EVAL_IMAGES} images a domain and a random "
        f"InceptionV3 .pth ({os.path.getsize(weights) / 2 ** 20:.1f} MiB) "
        f"written in {time.perf_counter() - t0:.1f} s")
    devices = {"card": dev, "cpu": torch.device("cpu")}
    gens = {w: [load_generator(os.path.join(REPO, "trained",
                                            f"G_{d}_selected.pth"),
                               precision="highest", device=devices[w])
                for d in ("AB", "BA")] for w in devices}
    features = {(w, "inception"): make_inception_feature_fn(weights,
                                                            device=d)
                for w, d in devices.items()}
    features.update({(w, "fallback"): None for w in devices})

    def run(where, kind, n, generators=None):
        before = counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = fid_harness.run_fid_eval(
                *(generators or gens[where]), data,
                os.path.join(tmp, f"fid_{where}_{kind}"), max_images=n,
                feature_fn=features[(where, kind)], batch=EVAL_BATCH,
                save_panels=False)
        if list(out) != ["monet2photo", "photo2monet", "mean"] or not all(
                math.isfinite(v) and v > 0 for v in out.values()):
            raise AssertionError(f"run_fid_eval on {where}, {kind}: {out}; "
                                 f"{buf.getvalue()}")
        if where == "card":
            forwards = 2 * math.ceil(n / EVAL_BATCH)
            launched = {k: v - before[k] for k, v in counts().items()}
            want = {k: EVAL_LAUNCHES_PER_FORWARD.get(k, 0) * forwards
                    for k in launched}
            if launched != want:
                raise AssertionError(f"run_fid_eval at {n} images a "
                                     f"direction launched {launched}, "
                                     f"expected {want}")
        return out

    fids, worst = {}, 0.0
    for kind in ("inception", "fallback"):
        got, want = (run(w, kind, EVAL_CPU_IMAGES) for w in ("card", "cpu"))
        rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in want}
        worst = max(worst, *rel.values())
        fids[kind] = got
        log(f"[fid] {kind} features, {EVAL_CPU_IMAGES} images a direction: "
            f"card {got}, CPU {want}; relative |d| "
            + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()))
        if max(rel.values()) > FID_RTOL:
            raise AssertionError(f"FID with {kind} features: card and CPU "
                                 f"differ by {rel}")

    spent = {}

    def clocked(key, fn, sync=False):
        def call(*args):
            t = time.perf_counter()
            out = fn(*args)
            if sync:
                torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t
            return out
        return call

    class TimedDataset(ImageFolderDataset):
        load = clocked("decode", ImageFolderDataset.load)

    timed_gens = [dataclasses.replace(g, apply=clocked("generator", g.apply,
                                                       sync=True))
                  for g in gens["card"]]
    statistic = fid_harness.fid_from_features
    timing = {}
    for kind in ("inception", "fallback"):
        spent.update(dict.fromkeys(("decode", "generator", "features",
                                    "statistic"), 0.0))
        feature_fn = features[("card", kind)] or \
            fid_harness.default_feature_fn
        features[("card", kind)] = clocked("features", feature_fn)
        fid_harness.ImageFolderDataset = TimedDataset
        fid_harness.fid_from_features = clocked("statistic", statistic)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run("card", kind, EVAL_IMAGES, timed_gens)
            wall = time.perf_counter() - t0
        finally:
            fid_harness.ImageFolderDataset = ImageFolderDataset
            fid_harness.fid_from_features = statistic
            features[("card", kind)] = feature_fn
        split = dict(spent, other=wall - sum(spent.values()))
        dev_ms = device_ms(lambda: run("card", kind, EVAL_IMAGES), iters=1,
                           warmup=0)
        images = 4 * EVAL_IMAGES   # generated and real, both directions
        timing[kind] = (images / wall, wall, split, dev_ms / 1e3 / wall, out)
        log(f"[fid] {kind} features on the card, {EVAL_IMAGES} images a "
            f"direction: {out}; {images} images in {wall:.3f} s, "
            f"{images / wall:.1f} images/s; split "
            + ", ".join(f"{k} {v:.3f} s ({v / wall:.1%})"
                        for k, v in split.items())
            + f"; device time {dev_ms:.1f} ms under the profiler, busy "
            f"{dev_ms / 1e3 / wall:.1%} of the unprofiled wall")
    return worst, fids, timing


def phase_folders(dev, work):
    """The folder comparison on the card: ``compare_folder_pair`` between
    the batch CLI's inputs and its NHWC ``cyclegan`` outputs (24 images of
    24 sizes, one bucket each), card vs CPU per image; then the
    ``improved_image_compare`` CLI (the cyclegan outputs against the
    local-style enhanced ones) and the ``prepare_comparison_folders`` CLI
    through ``main(argv)``. The entry points that draw a figure
    (``compare_image_quality``, ``complete_comparison`` and
    ``image_quality_comparison`` always draw bar charts, and m_test's
    panels) need matplotlib, which the card's machine does not have: the
    CPU tests hold them against the JAX package, and they are not driven
    here."""
    import contextlib

    from multi_style_transfer_gan_tpu_torch.cli import (
        improved_image_compare, prepare_comparison_folders,
    )
    from multi_style_transfer_gan_tpu_torch.metrics.evaluation import (
        compare_folder_pair,
    )

    src = os.path.join(work, "in")
    styled = os.path.join(work, "out_nhwc_cyclegan_photo2monet",
                          "cyclegan_photo2monet")
    local = os.path.join(work, "out_auto_local_style_enhanced_photo2monet",
                         "local_style_enhanced_photo2monet")
    t0 = time.perf_counter()
    got = compare_folder_pair(src, styled, device=dev)
    wall = time.perf_counter() - t0
    want = compare_folder_pair(src, styled, device="cpu")
    if len(got["per_image"]) != 24 or got["skipped"] or \
            list(got["per_image"]) != list(want["per_image"]):
        raise AssertionError(f"compare_folder_pair: {len(got['per_image'])} "
                             f"images, skipped {got['skipped']}")
    d = {k: max(abs(got["per_image"][n][k] - m[k]) / (m[k] if k == "mse"
                                                        else 1.0)
                for n, m in want["per_image"].items())
         for k in ("ssim", "psnr", "mse")}
    log(f"[folders] compare_folder_pair on the card, 24 images: "
        f"{wall:.2f} s; average {got['average']}; card vs CPU per image: "
        f"SSIM max |d| {d['ssim']:.3e}, PSNR {d['psnr']:.3e} dB, MSE "
        f"relative {d['mse']:.3e}")
    if d["ssim"] > SSIM_ATOL or d["psnr"] > PSNR_ATOL or d["mse"] > MSE_RTOL:
        raise AssertionError(f"compare_folder_pair: card vs CPU {d}")

    prep = os.path.join(work, "prepare")
    shutil.copytree(styled, prep)
    for cli, argv, expect in (
            (improved_image_compare,
             ["--original_dir", src, "--folder_a", styled, "--folder_b",
              local], "=== Summary over 24 images ==="),
            (prepare_comparison_folders,
             ["--src_dir", prep, "--prefix", "photo_0"],
             "prepared 10 files")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        text = buf.getvalue()
        name = cli.__name__.rsplit(".", 1)[-1]
        tail = " | ".join(text.strip().splitlines()[-5:])
        log(f"[folders] {name} CLI: exit {rc}; {tail}")
        if rc != 0 or expect not in text:
            raise AssertionError(f"{name} CLI: exit {rc}, {text[-500:]}")
    return d


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the GUI and tools path: the tab workers and their model manager, the
# checkpoint CLIs, debug_model and generate_new_image

def gui_photos(tmp):
    """Three photos for the tab workers: a landscape over the canvas, a
    portrait, and a landscape whose upper half is a blue sky (the GUI's
    blue-sky mask trips on it). Returns their paths."""
    from PIL import Image

    from multi_style_transfer_gan_tpu_torch.data.synthetic import render_photo

    sky = render_photo(SEED + 3, size=320)[:240, :320].copy()
    sky[:100] = np.clip(sky[:100] * 0.3 + np.float32([60, 120, 220]) * 0.7,
                        0, 255).astype(np.uint8)
    paths = []
    for name, img in (("landscape", render_photo(SEED + 1, size=400)[:300]),
                      ("portrait", render_photo(SEED + 2, size=320)[:, :240]),
                      ("sky", sky)):
        paths.append(os.path.join(tmp, f"{name}.png"))
        Image.fromarray(np.ascontiguousarray(img)).save(paths[-1])
    return paths


def gui_models_dir(tmp):
    """The GUI's fixed files: the trained pair as ``G_{AB,BA}_epoch_200.pth``
    and a seeded plain c64 pair, both generators in one
    ``cyclegan_epoch_200.pth``."""
    import torch

    d = os.path.join(tmp, "models")
    os.makedirs(d)
    for ab in ("AB", "BA"):
        shutil.copy(os.path.join(REPO, "trained", f"G_{ab}_selected.pth"),
                    os.path.join(d, f"G_{ab}_epoch_200.pth"))
    path = os.path.join(d, "cyclegan_epoch_200.pth")
    plain_checkpoint(path, PLAIN_CHANNELS)
    ck = torch.load(path, map_location="cpu", weights_only=True)
    ck["G_AB_state_dict"] = ck["G_BA_state_dict"]
    torch.save(ck, path)
    return d


def run_quiet(fn, *args):
    """(return value, printed lines) of ``fn(*args)``."""
    import contextlib

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue().splitlines()


def phase_gui(rng, dev, counts):
    """The GUI's workers and tools on the card against the CPU (fp32, TF32
    off). The model manager loads the four fixed files; every tab worker
    runs on the three ``gui_photos`` (standard at its defaults, with fix
    blocks, and monet2photo without extras; local style simple, enhanced
    with its toggles on and off, advanced; cyclegan) and is held to the
    post chain's limits, its masks equal on >= 99.9% of pixels; then each
    tab's wall per image on the card. The ``pth_info`` and
    ``convert_model`` CLIs run, and the converted file serves with the same
    bits; ``debug_model`` prints, and its two-variant forward and
    ``generate_new_image``'s transform of a 1000 x 760 photo run card vs
    CPU. Returns ({tab: ms per image on the card}, {part: ms} of a
    standard-tab image)."""
    import torch
    from PIL import Image

    from multi_style_transfer_gan_tpu_torch.cli import (
        convert_model, debug_model, generate_new_image, pth_info,
    )
    from multi_style_transfer_gan_tpu_torch.data.synthetic import render_photo
    from multi_style_transfer_gan_tpu_torch.gui import app
    from multi_style_transfer_gan_tpu_torch.ops.gui_effects import (
        blue_sky_mask, edge_weight_mask,
    )
    from multi_style_transfer_gan_tpu_torch.pipelines import load_generator
    from multi_style_transfer_gan_tpu_torch.pipelines.batch import (
        _decode_canvas,
    )

    log("[gui] not driven on the card (no display, no matplotlib there; "
        "the CPU tests hold them against the JAX package): the Tk shell, "
        "the compare tab and the enhanced_segmentation mode (both draw a "
        "figure), debug_model --image and generate_new_image's plot")
    tmp = tempfile.mkdtemp(prefix="gui_")
    try:
        photos = gui_photos(tmp)
        models_dir = gui_models_dir(tmp)
        managers = {"card": app.ModelManager(models_dir, "highest",
                                             device=dev),
                    "cpu": app.ModelManager(models_dir, device="cpu")}
        for where, m in managers.items():
            msgs = []
            t0 = time.perf_counter()
            m.load(log=msgs.append)
            log(f"[gui] ModelManager on {where}: {m.loaded()}/4 loaded in "
                f"{time.perf_counter() - t0:.2f} s: " + " | ".join(msgs))
            if m.loaded() != 4:
                raise AssertionError(f"ModelManager on {where} loaded "
                                     f"{m.loaded()} of 4")
        info = app.model_info_text(managers["card"])
        if info != app.model_info_text(managers["cpu"]):
            raise AssertionError("model_info_text differs card vs CPU")
        log("[gui] model_info_text (equal on both):\n" + info)

        for path in photos:
            canvas = torch.from_numpy(np.array(_decode_canvas(path)[0])) \
                .float()[None]
            for name, fn in (("blue sky mask", blue_sky_mask),
                             ("edge weight mask", edge_weight_mask)):
                got, ref = fn(canvas.to(dev)).cpu(), fn(canvas)
                share = float((got == ref).float().mean())
                log(f"    {os.path.basename(path)} {name}: mean "
                    f"{float(ref.mean()):.4f}, equal on {share:.6f} of pixels")
                if share < MASK_SHARE:
                    raise AssertionError(f"{name}: card and CPU agree on "
                                         f"{share:.6f} of pixels")
        if float(blue_sky_mask(canvas).mean()) < 0.05:
            raise AssertionError("the sky photo does not trip the sky mask")

        cases = [
            ("standard", "_process_standard", "enhanced", {}),
            ("standard", "_process_standard", "enhanced",
             {"fix_blocks": True, "blend_original": 0.3}),
            ("standard", "_process_standard", "enhanced",
             {"direction": "monet2photo", "strength": 0.5, "smooth": 0,
              "fix_blocks": False}),
            ("local", "_process_local", "enhanced", {"mode": "simple"}),
            ("local", "_process_local", "enhanced", {"mode": "enhanced"}),
            ("local", "_process_local", "enhanced",
             {"mode": "enhanced", "sky_handling": False,
              "enhance_colors": False, "smooth_transitions": False}),
            ("local", "_process_local", "enhanced", {"mode": "advanced"}),
            ("cyclegan", "_process_cyclegan", "cyclegan", {}),
        ]
        for tab, worker, family, kw in cases:
            for path in photos:
                outs = {}
                for where, m in managers.items():
                    model = m.pick(family, kw.get("direction", "photo2monet"))
                    out = os.path.join(tmp, where, f"{tab}.png")
                    getattr(app, worker)(model, path, out, **kw)
                    with Image.open(out) as img:
                        outs[where] = np.asarray(img.convert("RGB"))
                check_levels(f"{tab} {kw} {os.path.basename(path)} "
                             f"{outs['card'].shape}", outs["card"],
                             outs["cpu"])

        # each tab's wall per image on the card, after one warm-up call;
        # the cyclegan tab's plain generator launches no kernel
        walls = {}
        for tab, worker, family, kw in (cases[0], cases[4], cases[7]):
            model = managers["card"].pick(family, "photo2monet")
            out = os.path.join(tmp, "card", "wall.png")
            getattr(app, worker)(model, photos[0], out, **kw)
            before = counts()
            t0 = time.perf_counter()
            for path in photos:
                getattr(app, worker)(model, path, out, **kw)
            torch.cuda.synchronize()
            walls[tab] = (time.perf_counter() - t0) * 1000 / len(photos)
            launched = {n: v - before[n] for n, v in counts().items()
                        if v != before[n]}
            log(f"[gui] {tab} tab on the card: {walls[tab]:.2f} ms per image "
                f"(decode, generator, post chain, restore and PNG save; "
                f"{card_line()}); launches over {len(photos)} images "
                f"{launched}")
            expected = ({} if family == "cyclegan" else
                        {n: len(photos) * k
                         for n, k in EVAL_LAUNCHES_PER_FORWARD.items()})
            if launched != expected:
                raise AssertionError(f"{tab} tab launched {launched}, "
                                     f"expected {expected}")
        # where a standard-tab image's wall goes: host decode and canvas
        # paste, the generator (synchronized; ``_styled_canvas`` decodes
        # again, which is taken off), the post chain and the restore and
        # save
        split = {"decode": 0.0, "generator": 0.0, "chain": 0.0, "save": 0.0}
        model = managers["card"].pick("enhanced", "photo2monet")
        for path in photos:
            t0 = time.perf_counter()
            _decode_canvas(path)
            t1 = time.perf_counter()
            canvas_f, styled, (w, h) = app._styled_canvas(model, path)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            res = app._boost_colors(canvas_f * 0.2 + styled * 0.8,
                                    "photo2monet")
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            app._finish_and_save(res, w, h, os.path.join(tmp, "split.png"))
            t4 = time.perf_counter()
            for k, dt in zip(split, (t1 - t0, t2 - t1 - (t1 - t0), t3 - t2,
                                     t4 - t3)):
                split[k] += dt * 1000 / len(photos)
        log("[gui] standard tab split per image on the card: "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items())
            + " (the chain without its Gaussian)")

        # the checkpoint tools, as a user runs them
        ckpt = os.path.join(models_dir, "cyclegan_epoch_200.pth")
        _, lines = run_quiet(pth_info.main, [ckpt])
        log(f"[gui] pth_info {os.path.basename(ckpt)}: {len(lines)} "
            f"tensors; first {lines[0]}")
        flat = os.path.join(tmp, "flat.pth")
        src = os.path.join(models_dir, "G_BA_epoch_200.pth")
        rc, lines = run_quiet(convert_model.main,
                              ["--input", src, "--output", flat])
        log(f"[gui] convert_model: exit {rc}; " + " | ".join(lines))
        # the converted file serves the same weights, bit for bit; the two
        # forwards agree as far as the card's fp32 forward repeats itself
        # (its transposed convolutions are not bit-stable, ~3e-5)
        orig = managers["card"].enhanced_ba
        conv = load_generator(flat, precision="highest", device=dev)
        same = all(torch.equal(v, conv.module.state_dict()[k])
                   for k, v in orig.module.state_dict().items())
        x = torch.from_numpy(np.stack(smooth_images(rng, 2, (256, 256)))) \
            .to(dev).float() / 127.5 - 1.0
        fwd = float((orig.apply(x) - conv.apply(x)).abs().max())
        log(f"    converted file: weights bit-equal {same}, forward max |d| "
            f"{fwd:.2e}")
        if rc != 0 or not same or fwd > 1e-4:
            raise AssertionError(f"convert_model exit {rc}; the converted "
                                 f"file's weights equal {same}, forward "
                                 f"max |d| {fwd:.2e}")

        rc, lines = run_quiet(debug_model.main, ["--model", src])
        log(f"[gui] debug_model: exit {rc}; {lines[0]} | {lines[1]}")
        if rc != 0 or len(lines) < 10:
            raise AssertionError(f"debug_model exited {rc}")
        img01 = torch.from_numpy(np.asarray(
            Image.open(photos[0]).convert("RGB"), np.float32) / 255.0)
        variants = {where: debug_model.preprocess_variants(
            m.enhanced_ba, img01) for where, m in managers.items()}
        for name, (x_card, y_card) in variants["card"].items():
            x_cpu, y_cpu = variants["cpu"][name]
            x_err = float((x_card.cpu() - x_cpu).abs().max())
            got, ref = (np.clip(np.round(y.cpu().numpy() * 255), 0, 255)
                        for y in (y_card, y_cpu))
            dmax, share = u8_diff(got, ref)
            log(f"    debug_model {name} {tuple(x_card.shape)}: input max "
                f"|d| {x_err:.2e}, output max diff {dmax}, differing share "
                f"{share:.3e}")
            if x_err > 1e-5 or dmax > U8_MAX_DIFF or share > U8_MAX_SHARE:
                raise AssertionError(f"debug_model {name}: card and CPU "
                                     f"disagree")

        photo = render_photo(SEED + 4, size=1000)[:760]
        before = counts()
        t0 = time.perf_counter()
        got = generate_new_image.transform_full_size(
            managers["card"].enhanced_ba, photo)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        photo_launches = {n: v - before[n] for n, v in counts().items()
                          if v != before[n]}
        ref = generate_new_image.transform_full_size(
            managers["cpu"].enhanced_ba, photo)
        dmax, share = u8_diff(got[1], ref[1])
        log(f"[gui] generate_new_image on a 1000 x 760 photo: "
            f"{got[0].shape} -> {got[1].shape}, {wall * 1000:.1f} ms on the "
            f"card (first call at this size), launches {photo_launches}; "
            f"card vs CPU max diff {dmax}, differing share {share:.3e}")
        if got[1].shape != (752, 992, 3) or dmax > U8_MAX_DIFF \
                or share > U8_MAX_SHARE:
            raise AssertionError("generate_new_image: card and CPU disagree")
        if photo_launches != EVAL_LAUNCHES_PER_FORWARD:
            raise AssertionError(f"the 992 x 752 forward launched "
                                 f"{photo_launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return walls, split


def photo_shapes():
    """The shapes ``generate_new_image`` gives rows 1 and 4 on a 1000 x 760
    photo (992 x 752 after the crop): the four LocalAttention calls, and
    the block's 188 x 248 token grid (188 is not a multiple of the
    8-window, so the kernel takes its key-mask path)."""
    return ([(1, 376, 496, 32), (1, 188, 248, 64), (1, 752, 992, 16)],
            (1, 188, 248, 64))


def phase_photo_kernels(rng, dev):
    """Rows 1 and 4 vs their plain versions at ``photo_shapes``, fp32 (TF32
    off) and bf16, on the stress inputs of ``attention_stress_inputs`` and
    ``block_stress_inputs``. Returns the largest fp32 |d| of each."""
    import torch

    from multi_style_transfer_gan_tpu_torch.ops.kernels import (
        fused_structural_block, structural_block_plain,
        window_channel_attention, window_channel_attention_plain,
    )

    attn_shapes, blk_shape = photo_shapes()
    worst = {"attention": 0.0, "block": 0.0}
    for shape in attn_shapes:
        for label, x, ws in attention_stress_inputs(rng, shape):
            for dtype in (torch.float32, torch.bfloat16):
                args = [torch.from_numpy(np.asarray(a, np.float32))
                        .to(dev, dtype) for a in [x] + ws]
                got = window_channel_attention(*args)
                ref = window_channel_attention_plain(*args)
                err, bf16_ok = compare(got, ref, dtype)
                ok = (err <= FP32_TOL if dtype == torch.float32 else bf16_ok)
                ok = ok and bool(torch.isfinite(got).all())
                log(f"[photo kernels] attention {shape} {label} "
                    f"{str(dtype)[6:]}: max|d| {err:.3e}")
                if not ok:
                    raise AssertionError(f"window_channel_attention {shape} "
                                         f"{label} {dtype}: outside tolerance")
                if dtype == torch.float32:
                    worst["attention"] = max(worst["attention"], err)
    for label, host, weights in block_stress_inputs(rng, blk_shape):
        for dtype in (torch.float32, torch.bfloat16):
            t = lambda a, dt=dtype: torch.from_numpy(
                np.asarray(a, np.float32)).to(dev, dt)
            args = (t(host[0]), t(host[1]), t(host[2], torch.float32),
                    t(host[3], torch.float32))
            kw = {n: t(a) for n, a in weights.items()}
            got = fused_structural_block(*args, **kw)
            ref = structural_block_plain(*args, **kw)
            err, bf16_ok = compare(got, ref, dtype)
            ok = (err <= BLOCK_FP32_TOL if dtype == torch.float32 else bf16_ok)
            ok = ok and bool(torch.isfinite(got).all())
            log(f"[photo kernels] block {blk_shape} (ragged) {label} "
                f"{str(dtype)[6:]}: max|d| {err:.3e}")
            if not ok:
                raise AssertionError(f"fused_structural_block {blk_shape} "
                                     f"{label} {dtype}: outside tolerance")
            if dtype == torch.float32:
                worst["block"] = max(worst["block"], err)
    return worst


# ---------------------------------------------------------------------------
# the perceptual training path: the VGG16 perceptual + Gram loss through the
# train step's extra_g_loss hook

def random_vgg16_sd():
    """A seeded random torchvision-format ``vgg16`` state dict, conv1_1 to
    conv4_3 at full width (He-normal weights, small biases): no trained
    VGG16 is in the repository."""
    import torch

    from multi_style_transfer_gan_tpu_torch.train.perceptual import (
        _VGG16_CONVS,
    )

    gen = torch.Generator().manual_seed(SEED)
    sd = {}
    for idx, cin, cout in _VGG16_CONVS:
        sd[f"features.{idx}.weight"] = torch.randn(
            (cout, cin, 3, 3), generator=gen) * (2.0 / (cin * 9)) ** 0.5
        sd[f"features.{idx}.bias"] = 0.05 * torch.randn(cout, generator=gen)
    return sd


def phase_perceptual(rng, dev, counts):
    """The bf16 train step at the reference configuration (c16, 256^2,
    batch 8, pair batching) with ``extra_g_loss=make_extra_g_loss(vgg)``
    on a seeded random full-width VGG16: launches per step (the hook's
    trunk is cuDNN and matmul, so they equal the hookless step's), finite
    losses, G, D and u moved; ms/step with and without the hook in turns,
    and the trunk's share of the hooked step's device time; one fp32
    hooked step card vs CPU (c16, 128^2, batch 2), and
    ``perceptual_gram_loss`` alone card vs CPU. Returns (ms with the hook,
    ms without, device share of the trunk)."""
    import torch

    from multi_style_transfer_gan_tpu_torch.ops import to_model_range
    from multi_style_transfer_gan_tpu_torch.train import (
        cyclegan_init_state, cyclegan_train_step,
    )
    from multi_style_transfer_gan_tpu_torch.train.perceptual import (
        make_extra_g_loss, perceptual_gram_loss, vgg16_from_torchvision_sd,
    )

    sd = random_vgg16_sd()
    vgg = vgg16_from_torchvision_sd(sd, device=dev)
    log(f"[perceptual] VGG16 conv1_1..conv4_3, {len(sd) // 2} convolutions, "
        f"{sum(v.numel() for v in sd.values()):,} parameters (seeded random)")
    hook = make_extra_g_loss(vgg)
    state = cyclegan_init_state(SEED + 2, 16, 1, device=dev)
    before = {n: {k: v.clone() for k, v in getattr(state, n).state_dict().items()}
              for n in ("G_AB", "G_BA", "D_A", "D_B")}
    pairs = uint8_pairs(rng, 2, TRAIN_BATCH, 256, dev)
    i = [0]

    def step(extra):
        a, b = pairs[i[0] % len(pairs)]
        i[0] += 1
        return cyclegan_train_step(state, to_model_range(a), to_model_range(b),
                                   compute_dtype=torch.bfloat16,
                                   pair_batching=True, extra_g_loss=extra)[1]

    n0 = counts()
    losses = step(hook)
    torch.cuda.synchronize()
    n1 = counts()
    per_step = {n: n1[n] - n0[n] for n in TRAIN_LAUNCHES_PER_STEP}
    log(f"[perceptual] launches in one hooked step: {per_step}")
    if per_step != TRAIN_LAUNCHES_PER_STEP:
        raise AssertionError(f"hooked step launches {per_step}, expected the "
                             f"hookless step's {TRAIN_LAUNCHES_PER_STEP}")
    vals = {k: float(v) for k, v in losses.items()}
    if not all(np.isfinite(v) for v in vals.values()):
        raise AssertionError(f"non-finite losses {vals}")
    for name, sd_before in before.items():
        now = getattr(state, name).state_dict()
        if not any(not torch.equal(now[k], v) for k, v in sd_before.items()):
            raise AssertionError(f"{name} did not move")
        if name[0] == "D" and torch.equal(now["main.2.weight_u"],
                                          sd_before["main.2.weight_u"]):
            raise AssertionError(f"{name} spectral-norm u did not move")

    for extra in (None, hook):   # warm-up: 3 steps each
        for _ in range(3):
            step(extra)
    times = []   # 10 timed steps each, in turns: without, with, with, without
    for extra in (None, hook, hook, None):
        t0 = time.perf_counter()
        for _ in range(5):
            step(extra)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000 / 5)
    ms = {"without": (times[0] + times[3]) / 2,
          "with": (times[1] + times[2]) / 2}
    dev_with = device_ms(lambda: step(hook), iters=2, warmup=0)
    dev_without = device_ms(lambda: step(None), iters=2, warmup=0)
    share = (dev_with - dev_without) / dev_with
    log(f"[perceptual] bf16 c16 256^2 batch {TRAIN_BATCH}, pair batching "
        f"({card_line()}): with the hook {ms['with']:.2f} ms/step, without "
        f"{ms['without']:.2f} (in turns of 5 steps: "
        + ", ".join(f"{t:.2f}" for t in times)
        + f"); device {dev_with:.2f} vs {dev_without:.2f} ms/step, the VGG "
        f"trunk's share {share:.1%}; losses {vals}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # one fp32 hooked step on the card vs the CPU (TF32 off)
    host = [to_model_range(t).cpu() for t in uint8_pairs(rng, 1, 2, 128,
                                                         dev)[0]]
    out = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        st = cyclegan_init_state(SEED + 3, 16, 1, device=device)
        a, b = (t.to(device) for t in host)
        dhook = make_extra_g_loss(vgg16_from_torchvision_sd(sd, device=device))
        out[where] = {k: float(v) for k, v in cyclegan_train_step(
            st, a, b, compute_dtype=torch.float32,
            extra_g_loss=dhook)[1].items()}
    rel = {k: abs(out["card"][k] - out["cpu"][k]) / abs(out["cpu"][k])
           for k in out["cpu"]}
    log(f"[perceptual] fp32 hooked step c16 128^2 batch 2, card vs CPU: "
        f"max relative difference {max(rel.values()):.2e}")
    if max(rel.values()) > TRAIN_FP32_RTOL:
        raise AssertionError(f"fp32 hooked step: card and CPU disagree {rel}")
    imgs = [torch.tanh(torch.from_numpy(rng.standard_normal(
        (2, 128, 128, 3)).astype(np.float32))) for _ in range(3)]
    got = float(perceptual_gram_loss(vgg, *(t.to(dev) for t in imgs)))
    ref = float(perceptual_gram_loss(
        vgg16_from_torchvision_sd(sd, device="cpu"), *imgs))
    log(f"[perceptual] perceptual_gram_loss fp32 card vs CPU: {got:.8f} vs "
        f"{ref:.8f}, relative {abs(got - ref) / abs(ref):.2e}")
    if abs(got - ref) > PERCEPTUAL_RTOL * abs(ref):
        raise AssertionError("perceptual_gram_loss: card and CPU disagree")
    return ms["with"], ms["without"], share


# ---------------------------------------------------------------------------
# the c8 and c32 generators' widths
# ---------------------------------------------------------------------------

def width_checkpoint(path, channels):
    """A seeded EnhancedGenerator of width ``channels`` with one transformer
    block, drawn by the port's module at ``enhanced_generator_init``'s law,
    written as a G_AB ``.pth``; returns its parameter count."""
    import torch

    from multi_style_transfer_gan_tpu_torch.models import EnhancedGenerator

    module = EnhancedGenerator(
        channels, 1, generator=torch.Generator().manual_seed(SEED + channels))
    torch.save({"G_AB_state_dict": module.state_dict()}, path)
    return sum(p.numel() for p in module.parameters())


def phase_width_kernels(rng, dev):
    """Rows 1-7 (the attention, NHWC and packed), 9 (the relayout) and 4 (the
    block) at the shapes of one canvas-256 forward of each of the c8 and c32
    generators: the attention and the block kernel vs plain, fp32 (TF32 off)
    and bf16, on the stress inputs of ``attention_stress_inputs`` and
    ``block_stress_inputs`` (one all-zero window each; the block also on a
    ragged 12 x 20 grid); on the random input, bf16 kernel and plain in
    CUDA-event time in turns and the kernel in profiler device time; the
    relayout as ``phase_relayout`` does at the width's bottleneck. Returns
    {channels: {kernel: record}}, a record per forward at batch BATCH: ms,
    device_ms, plain_ms (bf16), max_abs_err (fp32), max_abs_err_bf16,
    bound_ms, bound_by and the shapes."""
    import torch

    from multi_style_transfer_gan_tpu_torch.ops.kernels import (
        fused_structural_block, packed_window_channel_attention,
        packed_window_channel_attention_plain, structural_block_plain,
        window_channel_attention, window_channel_attention_plain,
    )

    canvas = CANVASES[0]
    out = {}
    for channels in WIDTH_CHANNELS:
        rec = out[channels] = {}
        shapes = [s for _, s in attention_shapes(canvas, channels)]
        for name, fn, plain, packed in (
                ("window_channel_attention", window_channel_attention,
                 window_channel_attention_plain, False),
                ("packed_window_channel_attention",
                 packed_window_channel_attention,
                 packed_window_channel_attention_plain, True)):
            times, worst = {}, {torch.float32: 0.0, torch.bfloat16: 0.0}
            for shape in dict.fromkeys(shapes):
                for label, x, ws in attention_stress_inputs(rng, shape,
                                                            packed=packed):
                    for dtype in (torch.float32, torch.bfloat16):
                        args = [torch.from_numpy(np.asarray(a, np.float32))
                                .to(dev, dtype) for a in [x] + ws]
                        got = fn(*args)
                        ref = plain(*args)
                        torch.cuda.synchronize()
                        err, bf16_ok = compare(got, ref, dtype)
                        zero = got[0, 0, 0] if packed else got[0, :4, :4]
                        ok = ((err <= FP32_TOL if dtype == torch.float32
                               else bf16_ok)
                              and bool(torch.isfinite(got).all())
                              and bool(torch.isfinite(zero).all()))
                        line = (f"[widths] c{channels} {name} {shape} {label} "
                                f"{str(dtype)[6:]}: max|d| {err:.3e}")
                        if label == "random" and dtype == torch.bfloat16:
                            k_ms, p_ms = time_pair(lambda: fn(*args),
                                                   lambda: plain(*args))
                            d_ms = device_ms(lambda: fn(*args))
                            times[shape] = (k_ms, p_ms, d_ms)
                            line += (f", kernel {k_ms:.4f} ms, plain "
                                     f"{p_ms:.4f} ms, kernel device "
                                     f"{d_ms:.4f} ms")
                        log(line)
                        if not ok:
                            raise AssertionError(
                                f"{name} c{channels} {shape} {label} {dtype}:"
                                f" max|d| {err:.3e} outside tolerance")
                        worst[dtype] = max(worst[dtype], err)
            k_ms, p_ms, d_ms = (sum(times[s][i] for s in shapes)
                                for i in range(3))
            b_ms, b_by = bound(*attention_work(shapes))
            rec[name] = dict(ms=k_ms, device_ms=d_ms, plain_ms=p_ms,
                             max_abs_err=worst[torch.float32],
                             max_abs_err_bf16=worst[torch.bfloat16],
                             bound_ms=b_ms, bound_by=b_by, shapes=shapes)

        blk_shape = (BATCH, canvas // 4, canvas // 4, 4 * channels)
        worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
        for grid in (blk_shape, (2, 12, 20, 4 * channels)):
            for label, host, weights in block_stress_inputs(rng, grid):
                for dtype in (torch.float32, torch.bfloat16):
                    t = lambda a, dt=dtype: torch.from_numpy(
                        np.asarray(a, np.float32)).to(dev, dt)
                    args = (t(host[0]), t(host[1]), t(host[2], torch.float32),
                            t(host[3], torch.float32))
                    kw = {n: t(a) for n, a in weights.items()}
                    got = fused_structural_block(*args, **kw)
                    ref = structural_block_plain(*args, **kw)
                    torch.cuda.synchronize()
                    err, bf16_ok = compare(got, ref, dtype)
                    ok = ((err <= BLOCK_FP32_TOL if dtype == torch.float32
                           else bf16_ok) and bool(torch.isfinite(got).all()))
                    line = (f"[widths] c{channels} fused_structural_block "
                            f"{grid} {label} {str(dtype)[6:]}: max|d| "
                            f"{err:.3e}")
                    if (grid == blk_shape and label == "random"
                            and dtype == torch.bfloat16):
                        k_ms, p_ms = time_pair(
                            lambda: fused_structural_block(*args, **kw),
                            lambda: structural_block_plain(*args, **kw))
                        d_ms = device_ms(
                            lambda: fused_structural_block(*args, **kw))
                        line += (f", kernel {k_ms:.4f} ms, plain {p_ms:.4f} "
                                 f"ms, kernel device {d_ms:.4f} ms")
                        b_ms, b_by = bound(*block_work(blk_shape))
                        rec["fused_structural_block"] = dict(
                            ms=k_ms, device_ms=d_ms, plain_ms=p_ms,
                            bound_ms=b_ms, bound_by=b_by, shapes=[blk_shape])
                    log(line)
                    if not ok:
                        raise AssertionError(
                            f"fused_structural_block c{channels} {grid} "
                            f"{label} {dtype}: max|d| {err:.3e} outside "
                            f"tolerance")
                    worst[dtype] = max(worst[dtype], err)
        rec["fused_structural_block"].update(
            max_abs_err=worst[torch.float32],
            max_abs_err_bf16=worst[torch.bfloat16])

        cases = relayout_cases(canvas, channels)
        err, ms = phase_relayout(rng, dev, cases, tag=f"[widths] c{channels} "
                                                      f"relayout")
        moved = sum(2 * BF16_BYTES * int(np.prod(shape))
                    for _, shape, _ in cases)
        b_ms, b_by = bound(moved, 0)
        rec["window_relayout"] = dict(
            ms=ms[0], plain_ms=ms[1], library_ms=ms[2], device_ms=ms[3],
            library_device_ms=ms[4], max_abs_err=err, bound_ms=b_ms,
            bound_by=b_by, shapes=[shape for _, shape, _ in cases])
    return out


def phase_width_serving(rng, dev, counts, work):
    """The c8 and c32 generators through the entry points: each written to
    a ``.pth`` (``width_checkpoint``) and loaded by ``load_generator`` on
    the card and on the CPU at precision 'highest'; the fp32 uint8 program
    card vs CPU on both engines (``WIDTH_CPU_BATCH`` images at canvas 256;
    launches per forward: 4 attention calls and 1 block, and 5 relayouts
    on the packed engine), packed vs NHWC on the card; the bf16 program's
    img/s of both engines at canvas 256, batch ``RATE_BATCHES``, in turns;
    ``batch_process`` at c32 on a folder of ``WIDTH_FOLDER_IMAGES`` JPEGs
    of mixed sizes. Then the widths the kernels are not built for: a c4
    and a c64 checkpoint raise at ``load_generator`` on the card, and the
    train CLI at ``--channels 64`` raises before its first step. Returns
    {channels: {"parameters", "rates", "launches"}}, launches the counts
    this generator's part of the path made."""
    import contextlib

    import torch
    from PIL import Image

    from multi_style_transfer_gan_tpu_torch.cli import train as train_cli
    from multi_style_transfer_gan_tpu_torch.pipelines import (
        batch_process, load_generator, make_batch_fn,
    )

    names = ("window_channel_attention", "fused_structural_block",
             "packed_window_channel_attention", "window_relayout")
    canvas = CANVASES[0]
    out = {}
    for channels in WIDTH_CHANNELS:
        start = counts()
        path = os.path.join(work, f"enhanced_c{channels}.pth")
        n_params = width_checkpoint(path, channels)
        gpu = load_generator(path, precision="highest", device=dev)
        cpu = load_generator(path, precision="highest", device="cpu")
        log(f"[width serving] c{channels}: {gpu.kind} c{gpu.channels}, "
            f"{n_params} parameters, {path}")
        batch = np.stack(smooth_images(rng, WIDTH_CPU_BATCH, (canvas, canvas)))
        outs = {}
        for engine in ENGINES:
            before = counts()
            got = outs[engine] = make_batch_fn(
                gpu, "cyclegan", engine=engine, device=dev)(batch).cpu().numpy()
            launched = [counts()[n] - before[n] for n in names]
            ref = make_batch_fn(cpu, "cyclegan", engine=engine,
                                device="cpu")(batch).numpy()
            dmax, share = u8_diff(got, ref)
            log(f"[width serving] c{channels} {engine} fp32 card vs CPU, "
                f"{batch.shape} uint8: max diff {dmax}, differing share "
                f"{share:.3e}; launches per forward (NHWC attention, block, "
                f"packed attention, relayout): {launched}")
            if launched != FORWARD_LAUNCHES[engine]:
                raise AssertionError(f"c{channels} {engine}: expected "
                                     f"launches {FORWARD_LAUNCHES[engine]}, "
                                     f"got {launched}")
            if (got.shape != batch.shape or dmax > U8_MAX_DIFF
                    or share > U8_MAX_SHARE):
                raise AssertionError(f"c{channels} {engine} fp32 program on "
                                     f"the card disagrees with the CPU")
        dmax, share = u8_diff(outs["packed"], outs["nhwc"])
        log(f"[width serving] c{channels} fp32 packed vs NHWC engine on the "
            f"card: max diff {dmax}, differing share {share:.3e}")
        if dmax > U8_MAX_DIFF or share > U8_MAX_SHARE:
            raise AssertionError(f"c{channels}: packed and NHWC engines "
                                 f"disagree on the card")

        bf16 = {e: make_batch_fn(gpu, "cyclegan", engine=e,
                                 compute_dtype=torch.bfloat16, device=dev)
                for e in ENGINES}
        rates = {}
        for n in RATE_BATCHES:
            x = torch.from_numpy(np.stack(smooth_images(
                rng, n, (canvas, canvas)))).to(dev)
            turns = {e: [] for e in ENGINES}
            for e in ENGINES + ENGINES[::-1]:
                turns[e].append(program_rate(bf16[e], x))
            for e in ENGINES:
                rates[(n, e)] = sum(turns[e]) / len(turns[e])
            log(f"[width serving] c{channels} bf16 program, batch {n} at "
                f"canvas {canvas} (device-resident uint8 in and out): NHWC "
                f"{rates[(n, 'nhwc')]:.1f} img/s, packed "
                f"{rates[(n, 'packed')]:.1f} img/s; turns {turns['nhwc']}, "
                f"{turns['packed']}")

        if channels == max(WIDTH_CHANNELS):
            src = os.path.join(work, f"widths_in_c{channels}")
            dst = os.path.join(work, f"widths_out_c{channels}")
            os.makedirs(src)
            sizes = {}
            for i in range(WIDTH_FOLDER_IMAGES):
                w, h = int(rng.integers(96, 480)), int(rng.integers(96, 480))
                name = f"photo_{i:02d}.jpg"
                Image.fromarray(smooth_images(rng, 1, (w, h))[0]).save(
                    os.path.join(src, name), quality=92)
                sizes[name] = (w, h)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                stats = batch_process(gpu, src, dst, batch_size=4,
                                      compute_dtype=torch.bfloat16,
                                      device=dev)
            done = 0
            for name, size in sizes.items():
                target = os.path.join(dst, "cyclegan_photo2monet", name)
                if os.path.exists(target):
                    with Image.open(target) as img:
                        done += img.size == size
            log(f"[width serving] c{channels} batch_process: {done}/"
                f"{len(sizes)} outputs at their original sizes; stats "
                f"{stats}")
            if done != len(sizes):
                raise AssertionError(f"batch_process at c{channels} wrote "
                                     f"{done}/{len(sizes)} correct outputs")
        end = counts()
        out[channels] = {"parameters": n_params, "rates": rates,
                         "launches": {n: end[n] - start[n] for n in end}}

    # no fallback: what the kernels are not built for raises up front
    for channels in (4, 64):
        path = os.path.join(work, f"enhanced_c{channels}.pth")
        width_checkpoint(path, channels)
        try:
            load_generator(path, device=dev)
        except ValueError as e:
            log(f"[width serving] c{channels} on the card: {e}")
        else:
            raise AssertionError(f"a c{channels} checkpoint loaded on the "
                                 f"card")
    data = os.path.join(work, "widths_train_data")
    os.makedirs(os.path.join(data, "trainA"))
    os.makedirs(os.path.join(data, "trainB"))
    before = counts()
    try:
        train_cli.main(["--data_root", data, "--channels", "64",
                        "--save_dir", os.path.join(work, "widths_models")])
    except ValueError as e:
        log(f"[width serving] train --channels 64 on the card: {e}")
    else:
        raise AssertionError("train --channels 64 did not raise")
    if counts() != before:
        raise AssertionError("train --channels 64 launched a kernel")
    return out


# ---------------------------------------------------------------------------
# the c8 and c32 generators trained
# ---------------------------------------------------------------------------

def phase_width_train_kernels(rng, dev):
    """Rows 11 and 12 at the shapes of a bf16 train step of the c8 and c32
    generators (``width_train_kernel_cases``): forward and backward kernel
    vs plain, fp32 (TF32 off) and bf16, on the three inputs of
    ``train_kernel_inputs`` (one all-zero window each), plus the fp32
    backward of row 11 on SMALL_QK_DRAWS more draws of the small-q, k input
    at every shape; on the random input kernel, plain and the SDPA
    yardstick timed in turns (events, then kernel and SDPA in device time).
    Returns {channels: {kernel: record}}, a record per generator forward
    and backward at batch TRAIN_BATCH: ms, device_ms, plain_ms, library_ms
    (row 12: SDPA fwd + bwd) or sdpa_mid_ms (row 11), bound_ms, bound_by,
    max_abs_err (fp32), max_abs_err_bf16, shapes."""
    import torch

    per_fwd = {"up2": 1, "down1/up1": 2, "down2": 1}
    out = {}
    for channels in WIDTH_CHANNELS:
        rec = out[channels] = {}
        worst = {n: {torch.float32: 0.0, torch.bfloat16: 0.0}
                 for n in ("attention", "mhsa")}
        times = {}
        for name, stage, shape, heads in width_train_kernel_cases(channels):
            for label, host, g_host in train_kernel_inputs(rng, name, shape):
                for dtype in (torch.float32, torch.bfloat16):
                    err, derr, ms = check_train_kernel(
                        f"[width train kernels] c{channels}", name, stage,
                        shape, heads, label, host, g_host, dtype, dev)
                    worst[name][dtype] = max(worst[name][dtype], err, derr)
                    if ms and dtype == torch.bfloat16:
                        times[(name, stage)] = ms
            if name == "attention":
                for draw in range(SMALL_QK_DRAWS):
                    _, host, g_host = train_kernel_inputs(rng, name, shape)[2]
                    _, derr, _ = check_train_kernel(
                        f"[width train kernels] c{channels} draw {draw + 2}",
                        name, stage, shape, heads, "small q, k", host, g_host,
                        torch.float32, dev)
                    worst[name][torch.float32] = max(
                        worst[name][torch.float32], derr)
        cases = width_train_kernel_cases(channels)
        att = [(st, shape) for n, st, shape, _ in cases if n == "attention"]
        ms = [sum(per_fwd[st] * times[("attention", st)][i] for st, _ in att)
              for i in range(5)]
        shapes = [shape for st, shape in att for _ in range(per_fwd[st])]
        b_ms, b_by = bound(*train_mid_work(shapes))
        rec["window_attention_train"] = dict(
            ms=ms[0], plain_ms=ms[1], sdpa_mid_ms=ms[2], device_ms=ms[3],
            library_ms=None, bound_ms=b_ms, bound_by=b_by,
            max_abs_err=worst["attention"][torch.float32],
            max_abs_err_bf16=worst["attention"][torch.bfloat16], shapes=shapes)
        _, _, shape, heads = cases[-1]
        mh = times[("mhsa", "block")]
        b_ms, b_by = bound(*mhsa_work(shape, heads))
        rec["window_mhsa_train"] = dict(
            ms=mh[0], plain_ms=mh[1], library_ms=mh[2], device_ms=mh[3],
            library_device_ms=mh[4], bound_ms=b_ms, bound_by=b_by,
            max_abs_err=worst["mhsa"][torch.float32],
            max_abs_err_bf16=worst["mhsa"][torch.bfloat16], shapes=[shape],
            heads=heads)
    return out


def phase_fast_vjp(rng, dev):
    """c32's down2 under grad (LocalAttention at C = 128, no training
    kernel): ``window_channel_attention_fast_vjp`` at FAST_VJP_SHAPE on the
    three inputs of ``attention_stress_inputs`` (one all-zero window; small
    q and k), fp32 (TF32 off) and bf16, the forward and the five gradients
    of <y, g> on the card against the same Function on the CPU: the forward
    at FP32_TOL and at the bf16 bound; the gradients, which sum over the
    B H W positions (the weights') or over 3C and C channels (x's), at
    TRAIN_GRAD_FP32_TOL in fp32 and BF16_RTOL in bf16, each relative to the
    largest of its tensor (at least 1). Then, bf16 on the random input,
    forward + backward of the route against the plain formulation
    (``window_channel_attention_plain`` in autograd) in turns, and the route
    in device time.
    Returns {ms, plain_ms, device_ms, max_abs_err, max_rel_grad_err,
    max_rel_grad_err_bf16, shape}."""
    import torch

    from multi_style_transfer_gan_tpu_torch.ops.kernels import (
        window_channel_attention_fast_vjp, window_channel_attention_plain,
    )

    shape = FAST_VJP_SHAPE
    names = ("y", "dx", "dwqkv", "dbqkv", "dwproj", "dbproj")
    rec = {"shape": shape, "max_abs_err": 0.0, "max_rel_grad_err": 0.0,
           "max_rel_grad_err_bf16": 0.0}
    for label, x, ws in attention_stress_inputs(rng, shape):
        g = rng.standard_normal(shape).astype(np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            outs = {}
            for key, device in (("card", dev), ("cpu", torch.device("cpu"))):
                args = [torch.from_numpy(np.asarray(a, np.float32)).to(
                    device, dtype).requires_grad_(True) for a in [x] + ws]
                y = window_channel_attention_fast_vjp(*args)
                grads = torch.autograd.grad(
                    y, args, torch.from_numpy(g).to(device, dtype))
                outs[key] = [t.detach().float().cpu() for t in (y, *grads)]
            card, cpu = outs["card"], outs["cpu"]
            err, bf16_ok = compare(card[0], cpu[0], dtype)
            fp32 = dtype == torch.float32
            ok = err <= FP32_TOL if fp32 else bf16_ok
            rel = [((a - b).abs().max() / max(1.0, b.abs().max().item())).item()
                   for a, b in zip(card[1:], cpu[1:])]
            ok = ok and max(rel) <= (TRAIN_GRAD_FP32_TOL if fp32 else BF16_RTOL)
            ok = ok and all(bool(torch.isfinite(t).all()) for t in card)
            log(f"[fast vjp] C = 128 route {shape} {label} {str(dtype)[6:]}, "
                f"card vs CPU: y max|d| {err:.3e}; gradients max|d| relative "
                f"to their largest " + ", ".join(
                    f"{n} {r:.3e}" for n, r in zip(names[1:], rel)))
            if not ok:
                raise AssertionError(f"fast-VJP route {label} {dtype}: card "
                                     f"and CPU disagree")
            if fp32:
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                rec["max_rel_grad_err"] = max(rec["max_rel_grad_err"], max(rel))
            else:
                rec["max_rel_grad_err_bf16"] = max(
                    rec["max_rel_grad_err_bf16"], max(rel))

    x, ws = attention_stress_inputs(rng, shape)[0][1:]
    args = [torch.from_numpy(np.asarray(a, np.float32)).to(
        dev, torch.bfloat16).requires_grad_(True) for a in [x] + ws]
    g = torch.randn(shape, device=dev, dtype=torch.bfloat16)

    def run(fn):
        return lambda: torch.autograd.grad(fn(*args), args, g)

    rec["ms"], rec["plain_ms"] = time_pair(
        run(window_channel_attention_fast_vjp),
        run(window_channel_attention_plain))
    rec["device_ms"] = device_ms(run(window_channel_attention_fast_vjp))
    log(f"[fast vjp] bf16 {shape} forward + backward: route {rec['ms']:.4f} ms "
        f"({rec['device_ms']:.4f} ms device), plain formulation "
        f"{rec['plain_ms']:.4f} ms ({card_line()})")
    return rec


def train_step_runner(state, pairs, **kw):
    """A function that runs one bf16 CycleGAN step on the next pair."""
    import torch

    from multi_style_transfer_gan_tpu_torch.ops import to_model_range
    from multi_style_transfer_gan_tpu_torch.train import cyclegan_train_step

    it = {"i": 0}

    def step():
        a, b = pairs[it["i"] % len(pairs)]
        it["i"] += 1
        return cyclegan_train_step(state, to_model_range(a), to_model_range(b),
                                   compute_dtype=torch.bfloat16, **kw)[1]
    return step


def launches_of(step, counts, expected, what):
    """Runs ``step`` once and checks its launches against ``expected``."""
    import torch

    n0 = counts()
    out = step()
    torch.cuda.synchronize()
    per_step = {n: counts()[n] - n0[n] for n in expected}
    log(f"{what}: launches in one step: {per_step}")
    if per_step != expected:
        raise AssertionError(f"{what}: launches per step {per_step}, "
                             f"predicted {expected}")
    return out


def fp32_step_card_vs_cpu(dev, channels, what, host=None, **kw):
    """One fp32 CycleGAN step at ``channels`` (128^2, batch 2) on the card
    and on the CPU from the same init and uint8 images (``host``, an (A, B)
    pair on the CPU; by default drawn from a generator of this width's
    own): the five losses, relative, at TRAIN_FP32_RTOL. Returns the card's
    launches."""
    import torch

    from multi_style_transfer_gan_tpu_torch.ops import kernels as K
    from multi_style_transfer_gan_tpu_torch.ops import to_model_range
    from multi_style_transfer_gan_tpu_torch.train import (
        cyclegan_init_state, cyclegan_train_step,
    )

    if host is None:
        rng = np.random.default_rng(SEED + channels)
        host = [torch.from_numpy(np.stack(smooth_images(rng, 2, (128, 128))))
                for _ in range(2)]
    out, launched = {}, None
    for key, device in (("card", dev), ("cpu", torch.device("cpu"))):
        st = cyclegan_init_state(SEED + 1, channels, 1, device=device)
        a, b = (to_model_range(t.to(device)) for t in host)
        n0 = sum(k.launches for k in K.KERNELS)
        out[key] = {k: float(v) for k, v in cyclegan_train_step(
            st, a, b, compute_dtype=torch.float32, **kw)[1].items()}
        if key == "card":
            launched = sum(k.launches for k in K.KERNELS) - n0
    rel = {k: abs(out["card"][k] - out["cpu"][k]) / abs(out["cpu"][k])
           for k in out["cpu"]}
    log(f"{what} fp32 c{channels} 128^2 batch 2, card vs CPU: {out['card']} "
        f"vs {out['cpu']}; max relative difference {max(rel.values()):.2e}; "
        f"{launched} kernel launches on the card")
    if max(rel.values()) > TRAIN_FP32_RTOL:
        raise AssertionError(f"{what}: fp32 step on the card disagrees with "
                             f"the CPU: {rel}")
    return launched


def phase_width_train(rng, dev, counts, work):
    """The c8 and c32 generators trained through the entry points. For each
    width: the bf16 CycleGAN step at 256^2, batch TRAIN_BATCH, pair
    batching, from a seeded fresh init (launches per step against
    WIDTH_TRAIN_LAUNCHES_PER_STEP, finite losses, G, D and u moved, ms/step
    over 10 steps after 3 warm-up); one fp32 step card vs CPU (128^2, batch
    2) and the step's profiler device time over 5 more; the enhanced bf16
    pretrain step at 256^2, batch TRAIN_BATCH
    (launches per step against WIDTH_PRETRAIN_LAUNCHES_PER_STEP, ms/step,
    device idle share) and two fp32 pretrain steps card vs CPU (128^2,
    batch 2). Then at c8 one bf16 step with the VGG16 perceptual hook
    (launches equal to the hookless step's); the train CLI at --channels 32
    and the pretrain CLI at --model enhanced --channels 8, one epoch each on
    a small folder; one fp32 step with ``fast_attention=False`` (the CLI's
    --no_fast_attention) card vs CPU at c8 with no kernel launch; c4 and
    c64 refused before any work. Returns {channels: {"step_ms",
    "step_device_ms", "step_idle", "pretrain": (ms, device ms, idle),
    "launches"}}."""
    import contextlib

    import torch
    from PIL import Image

    from multi_style_transfer_gan_tpu_torch.cli import pretrain as pretrain_cli
    from multi_style_transfer_gan_tpu_torch.cli import train as train_cli
    from multi_style_transfer_gan_tpu_torch.data import random_patch_mask
    from multi_style_transfer_gan_tpu_torch.ops import to_model_range
    from multi_style_transfer_gan_tpu_torch.train import (
        check_kernel_width, cyclegan_init_state, pretrain_init_state,
        pretrain_train_step,
    )
    from multi_style_transfer_gan_tpu_torch.train.perceptual import (
        make_extra_g_loss, vgg16_from_torchvision_sd,
    )

    out = {}
    gen = torch.Generator().manual_seed(SEED + 3)
    for channels in WIDTH_CHANNELS:
        start = counts()
        tag = f"[width train] c{channels}"
        state = cyclegan_init_state(SEED, channels, 1, device=dev)
        before = {n: {k: v.clone() for k, v in getattr(state, n)
                      .state_dict().items()}
                  for n in ("G_AB", "G_BA", "D_A", "D_B")}
        step = train_step_runner(state, uint8_pairs(
            rng, 2, TRAIN_BATCH, WIDTH_TRAIN_SIZE, dev))
        launches_of(step, counts, WIDTH_TRAIN_LAUNCHES_PER_STEP[channels],
                    f"{tag} bf16 step")
        for _ in range(2):   # warm-up: 3 steps in all
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            losses = step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1000 / 10
        step_dev = device_ms(step, iters=5, warmup=0)
        idle = max(0.0, 1.0 - step_dev / ms)
        vals = {k: float(v) for k, v in losses.items()}
        log(f"{tag} bf16 {WIDTH_TRAIN_SIZE}^2 batch {TRAIN_BATCH}, pair "
            f"batching: {ms:.2f} ms/step, {TRAIN_BATCH * 1000 / ms:.1f} image "
            f"pairs/s, device {step_dev:.2f} ms/step (torch.profiler), device "
            f"idle share {idle:.1%} ({card_line()}); losses after "
            f"{state.step} steps {vals}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"{tag}: non-finite losses {vals}")
        for name, sd in before.items():
            now = getattr(state, name).state_dict()
            if not any(not torch.equal(now[k], v) for k, v in sd.items()):
                raise AssertionError(f"{tag}: {name} did not move")
            if name[0] == "D" and torch.equal(now["main.2.weight_u"],
                                              sd["main.2.weight_u"]):
                raise AssertionError(f"{tag}: {name} spectral-norm u did not "
                                     f"move")
        if channels == min(WIDTH_CHANNELS):
            vgg = vgg16_from_torchvision_sd(random_vgg16_sd(), device=dev)
            hooked = train_step_runner(
                state, uint8_pairs(rng, 1, TRAIN_BATCH, WIDTH_TRAIN_SIZE, dev),
                extra_g_loss=make_extra_g_loss(vgg))
            vals = {k: float(v) for k, v in launches_of(
                hooked, counts, WIDTH_TRAIN_LAUNCHES_PER_STEP[channels],
                f"{tag} bf16 step with the VGG16 hook").items()}
            if not all(np.isfinite(v) for v in vals.values()):
                raise AssertionError(f"{tag}: non-finite hooked losses {vals}")
            del vgg, hooked
        del state, step
        fp32_step_card_vs_cpu(dev, channels, f"{tag} train step")

        state = pretrain_init_state(SEED, channels, model="enhanced",
                                    device=dev)
        size = WIDTH_TRAIN_SIZE
        imgs = [torch.from_numpy(np.stack(smooth_images(
            rng, TRAIN_BATCH, (size, size)))).to(dev) for _ in range(2)]
        masks = [random_patch_mask(TRAIN_BATCH, size, generator=gen,
                                   device=dev) for _ in range(2)]
        pstep = pretrain_steps(state, imgs, masks, torch.bfloat16)
        launches_of(pstep, counts, WIDTH_PRETRAIN_LAUNCHES_PER_STEP[channels],
                    f"{tag} enhanced pretrain bf16 step")
        pre = time_pretrain(pstep, f"c{channels} enhanced bf16 {size}^2 "
                            f"batch {TRAIN_BATCH}", TRAIN_BATCH)
        del state, pstep
        host = [torch.from_numpy(np.stack(smooth_images(rng, 2, (128, 128))))
                for _ in range(2)]
        hmasks = [random_patch_mask(2, 128, generator=gen, device="cpu")
                  for _ in range(2)]
        losses = []
        for device in (dev, torch.device("cpu")):
            st = pretrain_init_state(SEED + 1, channels, model="enhanced",
                                     device=device)
            losses.append([float(pretrain_train_step(
                st, to_model_range(x.to(device)), m.to(device))[1])
                for x, m in zip(host, hmasks)])
        rel = max(abs(a - b) / abs(b) for a, b in zip(*losses))
        log(f"{tag} enhanced pretrain fp32 128^2 batch 2, two steps card vs "
            f"CPU: {losses[0]} vs {losses[1]}; max relative difference "
            f"{rel:.2e} (limit {PRETRAIN_FP32_RTOL})")
        if rel > PRETRAIN_FP32_RTOL:
            raise AssertionError(f"{tag}: fp32 pretrain steps, card and CPU "
                                 f"disagree")
        end = counts()
        out[channels] = {"step_ms": ms, "step_device_ms": step_dev,
                         "step_idle": idle, "pretrain": pre,
                         "launches": {n: end[n] - start[n] for n in end}}

    # the entry points at the new widths: one epoch each on a small folder
    def run(fn, argv, what):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = fn(argv)
        log(f"[width train] {what}: exit {rc}, {time.perf_counter() - t0:.2f} "
            f"s wall; its output:")
        for line in buf.getvalue().splitlines():
            log(f"    {line}")
        if rc != 0:
            raise AssertionError(f"{what} exited {rc}")

    data = os.path.join(work, "width_train_data")
    for domain in ("A", "B"):
        d = os.path.join(data, f"train{domain}")
        os.makedirs(d)
        for i in range(8):
            Image.fromarray(smooth_images(rng, 1, (256, 256))[0]).save(
                os.path.join(d, f"{i:02d}.jpg"), quality=92)
    models = os.path.join(work, "width_train_models")
    run(train_cli.main, ["--data_root", data, "--save_dir", models,
                         "--channels", str(max(WIDTH_CHANNELS)),
                         "--num_epochs", "1", "--batch_size", "4",
                         "--checkpoint_every", "1", "--log_every", "1"],
        f"train --channels {max(WIDTH_CHANNELS)}")
    run(pretrain_cli.main, ["--data_root", data, "--save_dir", models,
                            "--model", "enhanced",
                            "--channels", str(min(WIDTH_CHANNELS)),
                            "--num_epochs", "1", "--batch_size", "4",
                            "--checkpoint_every", "1", "--log_every", "1"],
        f"pretrain --model enhanced --channels {min(WIDTH_CHANNELS)}")
    for name in ("G_AB_epoch_1.pth", "discriminators_epoch_1.pth",
                 "generator_pretrain_epoch_1.pth"):
        if not os.path.exists(os.path.join(models, name)):
            raise AssertionError(f"the width CLIs did not write {name}")

    launched = fp32_step_card_vs_cpu(dev, min(WIDTH_CHANNELS),
                                     "[width train] --no_fast_attention step",
                                     fast_attention=False)
    if launched:
        raise AssertionError(f"the fast_attention=False step launched "
                             f"{launched} kernels")
    for channels in (4, 64):
        before = counts()
        try:
            check_kernel_width(channels, "CycleGAN training")
            cyclegan_init_state(SEED, channels, 1, device=dev)
        except ValueError as e:
            log(f"[width train] c{channels} on the card: {e}")
        else:
            raise AssertionError(f"c{channels} training was not refused")
        if counts() != before:
            raise AssertionError(f"the c{channels} refusal launched a kernel")
    return out


def main() -> int:
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        return run(work)


def run(work) -> int:
    """Every path and check, in order; ``work`` holds the files the paths
    share (the batch CLI's folders, which the evaluation path compares)."""
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; chip_smoke.py runs on the GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    log(card)  # name, power limit as nvidia-smi prints them
    log(f"torch.cuda.get_device_name(0): {torch.cuda.get_device_name(0)}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    from multi_style_transfer_gan_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    attn_err, attn_times = phase_attention(rng, dev)
    packed_err, packed_times = phase_packed_attention(rng, dev)
    relayout_err, relayout_ms = phase_relayout(rng, dev)
    block_err, block_times = phase_block(rng, dev)
    photo_err = phase_photo_kernels(rng, dev)
    attn_err = max(attn_err, photo_err["attention"])
    block_err = max(block_err, photo_err["block"])
    # the width phases draw from their own generator, so that every other
    # phase keeps the inputs it had before them
    width_rng = np.random.default_rng(SEED)
    width_kernels = phase_width_kernels(width_rng, dev)
    train_err, train_times = phase_train_kernels(rng, dev)
    # the c8 and c32 training phases draw from their own generator too
    width_train_rng = np.random.default_rng(SEED + 12)
    width_train_kernels = phase_width_train_kernels(width_train_rng, dev)
    fast_vjp = phase_fast_vjp(width_train_rng, dev)
    stages_err, stage_times = phase_stages(rng, dev)
    ablation_err = phase_ablation_inputs(dev)

    counted = {"window_channel_attention": K.window_channel_attention,
               "fused_structural_block": K.fused_structural_block,
               "packed_window_channel_attention":
                   K.packed_window_channel_attention,
               "window_relayout": K.window_relayout,
               "window_attention_mid_fwd": K.window_attention_mid_fwd,
               "window_attention_mid_bwd": K.window_attention_mid_bwd,
               "window_mhsa_fwd": K.window_mhsa_fwd,
               "window_mhsa_bwd": K.window_mhsa_bwd,
               "window_channel_attention_stage":
                   K.window_channel_attention_stage}
    counts = lambda: {n: k.launches for n, k in counted.items()}
    serving_kernels = list(counted)[:4]   # the order of FORWARD_LAUNCHES

    chain = phase_post_chain(rng, dev)

    K.reset_launch_counts()   # the serving path starts here
    rates = phase_generator(rng, dev, lambda: [
        counted[n].launches for n in serving_kernels])
    phase_cli(rng, work)
    for engine in ENGINES:
        phase_server(rng, dev, engine)
    phase_server(rng, dev, "nhwc", local_style_mode="enhanced")
    serving = counts()        # ...and ends here
    log(f"[main path: serving] launches: {serving}")
    attention_calls = (serving["window_channel_attention"]
                       + serving["packed_window_channel_attention"])
    if (min(serving[n] for n in serving_kernels) == 0
            or attention_calls != 4 * serving["fused_structural_block"]):
        raise AssertionError(f"serving path launches {serving}: expected "
                             f"every kernel, 4 attention calls (NHWC + "
                             f"packed) per block call")

    K.reset_launch_counts()   # the c8 and c32 serving path starts here
    width_serving = phase_width_serving(width_rng, dev, counts, work)
    widths = counts()         # ...and ends here
    log(f"[width serving path] launches: {widths}")
    attention_calls = (widths["window_channel_attention"]
                       + widths["packed_window_channel_attention"])
    if (min(widths[n] for n in serving_kernels) == 0
            or attention_calls != 4 * widths["fused_structural_block"]):
        raise AssertionError(f"width serving path launches {widths}: "
                             f"expected every serving kernel, 4 attention "
                             f"calls per block call")

    K.reset_launch_counts()   # the single-image path starts here
    phase_single_image(rng, dev)
    single = counts()         # ...and ends here
    log(f"[single-image path] launches: {single}")
    if min(single[n] for n in ("window_channel_attention",
                               "fused_structural_block")) == 0:
        raise AssertionError(f"single-image path launches {single}: the "
                             f"NHWC attention or the block never launched")

    K.reset_launch_counts()   # the training path starts here
    step_ms = phase_train_step(rng, dev)
    phase_train_cli(rng, dev)
    training = counts()       # ...and ends here
    log(f"[main path: training] launches: {training}")
    if min(training[n] for n in TRAIN_LAUNCHES_PER_STEP) == 0:
        raise AssertionError(f"training path launches {training}: a kernel "
                             f"of the path never launched")

    K.reset_launch_counts()   # the c8 and c32 training path starts here
    width_train = phase_width_train(width_train_rng, dev, counts, work)
    width_training = counts()  # ...and ends here
    log(f"[width training path] launches: {width_training}")
    if min(width_training[n] for n in TRAIN_LAUNCHES_PER_STEP) == 0:
        raise AssertionError(f"width training path launches "
                             f"{width_training}: a kernel of the path never "
                             f"launched")

    K.reset_launch_counts()   # the pretraining path starts here
    plain_rates = phase_plain_serving(rng, dev)
    pretrain = phase_pretrain_step(rng, dev)
    phase_pretrain_cli(rng, dev)
    pretraining = counts()    # ...and ends here
    log(f"[pretraining path] launches: {pretraining}")
    if min(pretraining[n] for n in PRETRAIN_LAUNCHES_PER_STEP
           if PRETRAIN_LAUNCHES_PER_STEP[n]) == 0:
        raise AssertionError(f"pretraining path launches {pretraining}: a "
                             f"kernel of the path never launched")

    K.reset_launch_counts()   # the evaluation path starts here
    metric_err, pair_rates = phase_metrics(rng, dev)
    fid_err, fids, fid_timing = phase_fid(dev, counts, work)
    folder_err = phase_folders(dev, work)
    evaluation = counts()     # ...and ends here
    log(f"[evaluation path] launches: {evaluation}")
    if evaluation["window_channel_attention"] == 0 or any(
            evaluation[n] != EVAL_LAUNCHES_PER_FORWARD.get(n, 0)
            * evaluation["fused_structural_block"] for n in evaluation):
        raise AssertionError(f"evaluation path launches {evaluation}: "
                             f"expected 4 NHWC attention calls per block "
                             f"call and no other kernel")

    K.reset_launch_counts()   # the GUI and tools path starts here
    gui_walls, gui_split = phase_gui(rng, dev, counts)
    gui = counts()            # ...and ends here
    log(f"[GUI and tools path] launches: {gui}")
    if gui["window_channel_attention"] == 0 or any(
            gui[n] != EVAL_LAUNCHES_PER_FORWARD.get(n, 0)
            * gui["fused_structural_block"] for n in gui):
        raise AssertionError(f"GUI and tools path launches {gui}: expected "
                             f"4 NHWC attention calls per block call and no "
                             f"other kernel")

    K.reset_launch_counts()   # the perceptual training path starts here
    perceptual_ms = phase_perceptual(rng, dev, counts)
    perceptual = counts()     # ...and ends here
    log(f"[perceptual training path] launches: {perceptual}")
    if min(perceptual[n] for n in TRAIN_LAUNCHES_PER_STEP) == 0:
        raise AssertionError(f"perceptual training path launches "
                             f"{perceptual}: a kernel of the path never "
                             f"launched")

    K.reset_launch_counts()   # the ablation path starts here
    phase_ablation()
    ablation = counts()       # ...and ends here
    log(f"[ablation path] launches: {ablation}")
    if ablation["window_channel_attention_stage"] == 0:
        raise AssertionError(f"ablation path launches {ablation}: the stage "
                             f"kernel never launched")
    launches = {n: serving[n] + widths[n] + single[n] + training[n]
                + width_training[n] + pretraining[n] + evaluation[n] + gui[n]
                + perceptual[n] + ablation[n] for n in counted}

    # inference kernels: per forward at canvas 256, batch 8, bf16 (the four
    # LocalAttention shapes, NHWC or packed; the block's one shape; the five
    # relayouts of a packed forward; the stage kernel's full stage at the
    # LocalAttention shapes). Training kernels: fwd + bwd per generator
    # forward and backward at 256^2, batch 8, bf16.
    canvas = CANVASES[0]
    fwd_shapes = [shape for _, shape in attention_shapes(canvas)]
    attn_ms, attn_plain, sdpa_fwd, attn_dev = (
        sum(attn_times[(canvas, s)][i] for s, _ in attention_shapes(canvas))
        for i in range(4))
    pk_ms, pk_plain, pk_nhwc, pk_dev = (
        sum(packed_times[(canvas, s)][i] for s, _ in attention_shapes(canvas))
        for i in range(4))
    st_ms, st_plain = (sum(stage_times[(shape, key)] for shape in fwd_shapes)
                       for key in ("full", "full plain"))
    blk_shape = (BATCH, 64, 64, 64)
    blk_ms, blk_plain, blk_dev = block_times[blk_shape]
    bf16 = torch.bfloat16
    per_fwd = {"down1/up1": 2, "down2": 1, "up2": 1}
    tr_ms = [sum(n * train_times[("attention", st, bf16)][i]
                 for st, n in per_fwd.items()) for i in range(5)]
    mh_ms = train_times[("mhsa", "block", bf16)]
    train_qkv = [shape for name, st, shape in train_kernel_cases()
                 if name == "attention" for _ in range(per_fwd[st])]
    mh_qkv = next(shape for name, _, shape in train_kernel_cases()
                  if name == "mhsa")

    # bounds from this run's shapes; the library yardsticks were timed in
    # turns with their kernels in the phases above
    attn_bound = bound(*attention_work(fwd_shapes))
    relayout_bytes = sum(2 * BF16_BYTES * int(np.prod(shape))
                         for _, shape, _ in relayout_cases(canvas))
    yardsticks = {
        "window_channel_attention": (attn_bound, None, sdpa_fwd),
        "packed_window_channel_attention": (attn_bound, None, sdpa_fwd),
        "window_relayout": (bound(relayout_bytes, 0), relayout_ms[2], None),
        "fused_structural_block": (bound(*block_work(blk_shape)), None, None),
        "window_attention_train": (bound(*train_mid_work(train_qkv)), None,
                                   tr_ms[2]),
        "window_mhsa_train": (bound(*mhsa_work(mh_qkv)), mh_ms[2], None),
        "window_channel_attention_stages": (attn_bound, None, sdpa_fwd),
    }

    pkg = "multi_style_transfer_gan_tpu_torch/csrc"
    tpu = "multi_style_transfer_gan_tpu/ops/pallas"
    report = {"kernels": [
        {"name": "window_channel_attention", "route": "cuda",
         "source": f"{pkg}/window_channel_attention.cu",
         "replaces": f"{tpu}/window_attention.py:122; "
                     f"{tpu}/window_attention_grouped.py:148; "
                     f"{tpu}/window_attention_v3.py:173; "
                     f"{tpu}/window_attention_v4.py:101; "
                     f"{tpu}/window_relayout.py:165; "
                     f"scripts/ab_v6_attention.py:117",
         "launches": launches["window_channel_attention"],
         "max_abs_err": attn_err, "ms": attn_ms, "plain_ms": attn_plain,
         "device_ms": attn_dev},
        {"name": "packed_window_channel_attention", "route": "cuda",
         "source": f"{pkg}/window_channel_attention.cu",
         "replaces": f"{tpu}/window_attention_grouped.py:148 "
                     f"(packed_grouped_window_attention :168); "
                     f"{tpu}/window_attention_v3.py:173 "
                     f"(packed_window_attention_v3 :227); "
                     f"{tpu}/packed_attention.py:138",
         "launches": launches["packed_window_channel_attention"],
         "max_abs_err": packed_err, "ms": pk_ms, "plain_ms": pk_plain,
         "device_ms": pk_dev},
        {"name": "window_relayout", "route": "cuda",
         "source": f"{pkg}/window_relayout.cu",
         "replaces": f"{tpu}/window_relayout.py:81 (s2d_rows); "
                     f"{tpu}/window_relayout.py:102 (d2s_rows)",
         "launches": launches["window_relayout"],
         "max_abs_err": relayout_err, "ms": relayout_ms[0],
         "plain_ms": relayout_ms[1], "device_ms": relayout_ms[3],
         "library_device_ms": relayout_ms[4]},
        {"name": "fused_structural_block", "route": "cuda",
         "source": f"{pkg}/fused_structural_block.cu",
         "replaces": f"{tpu}/fused_transformer.py:169",
         "launches": launches["fused_structural_block"],
         "max_abs_err": block_err, "ms": blk_ms, "plain_ms": blk_plain,
         "device_ms": blk_dev},
        {"name": "window_attention_train", "route": "cuda",
         "source": f"{pkg}/window_attention_train.cu",
         "replaces": f"{tpu}/window_attention_train.py:220",
         "launches": launches["window_attention_mid_fwd"]
                     + launches["window_attention_mid_bwd"],
         "launches_fwd": launches["window_attention_mid_fwd"],
         "launches_bwd": launches["window_attention_mid_bwd"],
         "max_abs_err": train_err["attention"], "ms": tr_ms[0],
         "plain_ms": tr_ms[1], "device_ms": tr_ms[3],
         "sdpa_mid_device_ms": tr_ms[4]},
        {"name": "window_mhsa_train", "route": "cuda",
         "source": f"{pkg}/window_mhsa_train.cu",
         "replaces": f"{tpu}/window_mhsa_train.py:134",
         "launches": launches["window_mhsa_fwd"] + launches["window_mhsa_bwd"],
         "launches_fwd": launches["window_mhsa_fwd"],
         "launches_bwd": launches["window_mhsa_bwd"],
         "max_abs_err": train_err["mhsa"], "ms": mh_ms[0],
         "plain_ms": mh_ms[1], "device_ms": mh_ms[3],
         "library_device_ms": mh_ms[4]},
        {"name": "window_channel_attention_stages", "route": "cuda",
         "source": f"{pkg}/window_attention_stages.cu",
         "replaces": "scripts/ab_v3_ablation.py:121",
         "launches": launches["window_channel_attention_stage"],
         "max_abs_err": stages_err, "ms": st_ms, "plain_ms": st_plain,
         "max_abs_err_ablation_bf16": ablation_err},
    ]}
    # per generator width: the serving kernels at c16 (this entry's own
    # numbers, launches of every path but the two width paths) and at c8
    # and c32 (phase_width_kernels at their canvas-256 forward, launches of
    # the width serving path, and of the width training path beside them);
    # the training kernels alike (phase_width_train_kernels per generator
    # forward and backward at 256^2, launches of the width training path)
    width_keys = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
                  "bound_by", "max_abs_err")
    train_rows = {"window_attention_train": ("window_attention_mid_fwd",
                                             "window_attention_mid_bwd"),
                  "window_mhsa_train": ("window_mhsa_fwd", "window_mhsa_bwd")}
    for entry in report["kernels"]:
        (b_ms, b_by), library, sdpa_mid = yardsticks[entry["name"]]
        entry.update(bound_ms=b_ms, bound_by=b_by, library_ms=library)
        name = entry["name"]
        if name in width_kernels[WIDTH_CHANNELS[0]]:
            entry["widths"] = {"c16": {
                **{k: entry.get(k) for k in width_keys},
                "launches": entry["launches"] - widths[name]
                - width_training.get(name, 0)}}
            for c in WIDTH_CHANNELS:
                rec = width_kernels[c][name]
                entry["widths"][f"c{c}"] = {
                    **{k: rec.get(k) for k in width_keys},
                    "max_abs_err_bf16": rec.get("max_abs_err_bf16"),
                    "launches": width_serving[c]["launches"][name],
                    "training_launches": width_train[c]["launches"].get(name, 0),
                    "shapes": rec["shapes"]}
        if name in train_rows:
            ran = lambda launched: sum(launched[n] for n in train_rows[name])
            entry["widths"] = {"c16": {
                **{k: entry.get(k) for k in width_keys},
                "launches": entry["launches"] - ran(width_training)}}
            for c in WIDTH_CHANNELS:
                rec = width_train_kernels[c][name]
                entry["widths"][f"c{c}"] = {
                    **{k: rec.get(k) for k in width_keys + (
                        "max_abs_err_bf16", "sdpa_mid_ms", "heads", "shapes")
                       if k in rec},
                    "launches": ran(width_train[c]["launches"])}
        if name == "window_channel_attention":
            # c32's down2 under grad: this kernel forward, the backward
            # recomputed through the plain version (fwd + bwd at batch 8)
            entry["fast_vjp_c128"] = fast_vjp
        if sdpa_mid is not None:
            entry["sdpa_mid_ms"] = sdpa_mid
        dev_ms = entry.get("device_ms")
        log(f"[yardsticks] {entry['name']}: kernel {entry['ms']:.4f} ms"
            + ("" if dev_ms is None else f" ({dev_ms:.4f} ms device, of "
               f"which the bound is {b_ms / dev_ms:.1%})")
            + f", bound {b_ms:.6f} ms ({b_by}; {b_ms / entry['ms']:.1%} of the "
            f"kernel's time), library "
            f"{'none' if library is None else f'{library:.4f} ms'}"
            + ("" if sdpa_mid is None else f", SDPA mid {sdpa_mid:.4f} ms"))
    rate_text = "; ".join(
        f"{m} canvas {c} batch {n} NHWC {r[(m, 'nhwc')]:.1f} packed "
        f"{r[(m, 'packed')]:.1f}"
        for (c, n), r in rates.items() for m in dict.fromkeys(k[0] for k in r))
    chain_text = "; ".join(
        f"{m} canvas {c} batch {n} {ev:.3f} ms events, {dv:.3f} ms device, "
        f"{ops:.0f} operations" for (c, n, m), (ev, dv, ops) in chain.items())
    log(f"[summary] {card}; post chain alone per batch: {chain_text}")
    log(f"[summary] {card}; bf16 program img/s: {rate_text}; bf16 train step "
        f"c16 256^2 batch {TRAIN_BATCH}: {step_ms:.2f} ms "
        f"({TRAIN_BATCH * 1000 / step_ms:.1f} image pairs/s). Inference "
        f"kernel ms are per forward at canvas {canvas}, batch {BATCH}, bf16 (the "
        f"NHWC kernel at the packed attention's windows: {pk_nhwc:.4f} ms); "
        f"training kernel ms are forward + backward per generator at 256^2, "
        f"batch {TRAIN_BATCH}, bf16")
    pre_text = "; ".join(
        f"{k} {ms:.2f} ms/step ({dev_ms:.2f} ms device, idle {idle:.1%})"
        for k, (ms, dev_ms, idle) in pretrain.items())
    log(f"[summary] {card}; plain c{PLAIN_CHANNELS} bf16 program img/s at "
        f"canvas 256: "
        + ", ".join(f"batch {n} {r:.1f}" for n, r in plain_rates.items())
        + f"; pretrain step bf16 256^2 (plain c{PLAIN_CHANNELS} batch "
        f"{PRETRAIN_BATCH}, enhanced c16 batch {TRAIN_BATCH}): {pre_text}")
    fid_text = "; ".join(
        f"{kind} features {rate:.1f} images/s ({4 * EVAL_IMAGES} images in "
        f"{wall:.2f} s: " + ", ".join(f"{k} {v:.2f} s" for k, v in
                                     split.items())
        + f"; device busy {busy:.1%})"
        for kind, (rate, wall, split, busy, _) in fid_timing.items())
    log(f"[summary] {card}; evaluation: compare_pair pairs/s at 256^2 "
        + ", ".join(f"batch {n} {r:.1f}" for n, r in pair_rates.items())
        + f"; metrics card vs CPU max SSIM {metric_err['ssim']:.3e}, PSNR "
        f"{metric_err['psnr']:.3e} dB, MSE relative {metric_err['mse']:.3e}, "
        f"SSIM(x, x) - 1 {metric_err['ssim_ident']:.3e}, folder pairs SSIM "
        f"{folder_err['ssim']:.3e}; FID card vs CPU at {EVAL_CPU_IMAGES} "
        f"images a direction relative {fid_err:.3e}; m_test path at "
        f"{EVAL_IMAGES} images a direction, fp32: {fid_text}; whole run "
        f"{time.perf_counter() - t_start:.1f} s")
    for c in WIDTH_CHANNELS:
        log(f"[summary] {card}; c{c} generator "
            f"({width_serving[c]['parameters']} parameters) bf16 program "
            f"img/s at canvas 256: "
            + ", ".join(f"batch {n} {e} {r:.1f}"
                        for (n, e), r in width_serving[c]["rates"].items())
            + "; kernels per forward at canvas 256, batch "
            f"{BATCH}, bf16: "
            + "; ".join(f"{n} {r['ms']:.4f} ms ({r['device_ms']:.4f} ms "
                        f"device, plain {r['plain_ms']:.4f} ms, bound "
                        f"{r['bound_ms']:.6f} ms by {r['bound_by']})"
                        for n, r in width_kernels[c].items()))
    for c in WIDTH_CHANNELS:
        t = width_train[c]
        rows = width_train_kernels[c]
        log(f"[summary] {card}; c{c} training: bf16 CycleGAN step 256^2 batch "
            f"{TRAIN_BATCH} {t['step_ms']:.2f} ms/step "
            f"({TRAIN_BATCH * 1000 / t['step_ms']:.1f} image pairs/s; "
            f"{t['step_device_ms']:.2f} ms device, idle {t['step_idle']:.1%}); "
            f"enhanced "
            f"pretrain step bf16 256^2 batch {TRAIN_BATCH} "
            f"{t['pretrain'][0]:.2f} ms/step ({t['pretrain'][1]:.2f} ms device, "
            f"idle {t['pretrain'][2]:.1%}); training kernels fwd + bwd per "
            f"generator at batch {TRAIN_BATCH}, bf16: "
            + "; ".join(f"{n} {r['ms']:.4f} ms ({r['device_ms']:.4f} ms device, "
                        f"plain {r['plain_ms']:.4f} ms, bound "
                        f"{r['bound_ms']:.6f} ms by {r['bound_by']})"
                        for n, r in rows.items()))
    c32 = width_train[max(WIDTH_CHANNELS)]
    share = 6 * fast_vjp["ms"] / c32["step_ms"]
    dev_share = 6 * fast_vjp["device_ms"] / c32["step_device_ms"]
    log(f"[summary] {card}; c32's down2 under grad (C = 128 fast-VJP route) "
        f"fwd + bwd at {fast_vjp['shape']}, bf16: {fast_vjp['ms']:.4f} ms "
        f"({fast_vjp['device_ms']:.4f} ms device; plain formulation "
        f"{fast_vjp['plain_ms']:.4f} ms); 6 batch-8 calls a step (4 forwards "
        f"with grad, 2 of them pair-batched) are ~{share:.1%} of the c32 "
        f"step's host clock and ~{dev_share:.1%} of its device time")
    p_with, p_without, vgg_share = perceptual_ms
    log(f"[summary] {card}; GUI tab wall per image on the card (decode, "
        f"generator, post chain, restore and save; 3 photos after a warm-up): "
        + ", ".join(f"{tab} {ms:.2f} ms" for tab, ms in gui_walls.items())
        + " (standard: " + ", ".join(f"{k} {v:.2f} ms"
                                     for k, v in gui_split.items())
        + f"); perceptual train step bf16 c16 256^2 batch {TRAIN_BATCH} with "
        f"the VGG16 hook {p_with:.2f} ms/step, without {p_without:.2f} "
        f"ms/step (in turns), the trunk {vgg_share:.1%} of the hooked "
        f"step's device time")
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
