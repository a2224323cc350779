"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths (``multi_style_transfer_gan_tpu_torch``) on the
card, serving at the full width of the trained c16 EnhancedGenerator shipped
in ``trained/`` with both engines (NHWC and packed space-to-depth) and every
mode of the uint8 program (``cyclegan``, and ``local_style`` with the
enhanced and advanced post chains), the single-image pipelines (also
with one image's rows sharded over several devices), CycleGAN
training at the reference configuration, the plain generator and
masked-inpainting pretraining at the reference's width, the evaluation
path (metrics, folder comparisons, FID on a full-width InceptionV3), the
GUI's tab workers and the checkpoint tools, the VGG16 perceptual + Gram
loss in the train step, the trained-model study's scripts, the c8, c32
and c64 EnhancedGenerators on the serving kernels' other widths and
trained (CycleGAN and enhanced pretraining, c64 also through the pretrain
CLI's defaults), the c24, c40,
c48 and c56 ones, which run padded inside the kernels, the c4, c12, .., c60
ones (the widths that are not multiples of 8), the c68 .. c128 ones (the
widths past 64), the c132, c192 and c256 ones (the widths past 128), and
checks every hand-written kernel on the way:

1. build: all nine CUDA sources compile from ``csrc/`` at once, one nvcc
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
   advanced programs card vs CPU, the bf16 program against fp32 at every
   canvas and at batches 1, 4, 8, 16 and 64 held relative to JAX's own
   bf16 distance (``bf16_gate``), bf16 img/s of both engines at canvas 256
   and 512, batch 16 and 64, and of the enhanced and advanced programs at
   ``MODE_CELLS``), the batch CLI on 24 JPEGs of mixed sizes with
   ``--engine packed``, ``auto`` and ``nhwc`` and with ``--mode
   local_style`` in both post chains, the HTTP server answering 4 requests
   with each engine and one in ``local_style`` ``enhanced``;
9. single-image path: the ``direct_transform``, ``enhanced_local_style``
   and ``improved_smooth`` CLIs and the five advanced variants, each card
   vs CPU (the two CLIs that run the generator at 'default', TF32 on the
   card, under the bf16 gate; ``phase_single_image`` says which paths draw
   figures and are not driven here);
10. training path: the bf16 train step at c16, 256^2, batch 8 (launches
    per step, finite losses, moved G, D and u, ms/step), one fp32 step on
    the card vs the CPU, and the train CLI writing, resuming and producing
    a generator that stylizes;
11. pretraining path: the plain generator at the reference's width (c64)
    from a legacy checkpoint (fp32 forward and uint8 program card vs CPU,
    the bf16 gate at batches 1-64, bf16 img/s at canvas 256, batch 16 and
    64), masked-inpainting
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
    on a small folder at c32;
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
    (``--no_fast_attention``) card vs CPU with no kernel launch;
18. c64, the JAX pretrain CLI's default width (``phase_width_kernels`` and
    ``phase_width_train_kernels`` with ``C64_CHANNELS`` and ``phase_fast_vjp``
    at ``C64_FAST_VJP_SHAPES`` beside the other width phases, the c64
    serving path after the width serving path, the c64 training path after
    the width training path, each on its own rng): the attention at C = 256
    (both layouts) and 128 on 128^2, the block at 256 channels in 8 heads
    (and on the ragged grid), the relayout at the 256-channel bottleneck,
    row 11 at up2's C = 64 on 256^2, row 12 at 8 heads, kernel vs plain as
    for the other widths; the route under grad at C = 256 card vs CPU and
    timed with its peak memory, and at C = 128 on 128^2 timed; the c64
    generator served as c8 and c32 are (its fp32 CPU half at one image),
    and through the batch CLI, the server and ``direct_transform``; the
    bf16 CycleGAN step (also with the VGG16 hook), the enhanced pretrain
    step at batch 16, the fp32 steps card vs CPU, their launches per step;
    the CLI chain ``pretrain --model enhanced`` (no ``--channels``),
    ``train --channels 64`` fresh and ``--pretrained`` on that checkpoint,
    and ``batch_process`` on the trained G_AB; the route's share of a c64
    step;
19. the widths that run padded (``GRID_CHANNELS``: c24, c40, c48, c56;
    their kernel phases beside the other width phases, the grid serving
    path after the c64 serving path, the grid training path after the c64
    training path, on their own rngs): the attention (both layouts, C = 24
    .. 224 inside the layouts of 32, 64, 128 and 256 channels), the block
    at dims 96, 160, 192 and 224 (3, 5, 6, 7 heads), the relayout, and row
    12 at 3, 5, 6 and 7 heads, kernel vs plain at each width's canvas-256
    shapes on the stress inputs (the attention also at its canvas-512
    down2, the largest window count at its widest C); the fast-VJP route,
    which takes all four LocalAttention calls of these generators under
    grad, at c48's shapes (card vs CPU at its down2, timed at all); c48
    at full width as c8 and c32 are (served on both engines, fp32 card vs
    CPU, bf16 img/s, ``batch_process``; the bf16 CycleGAN step with its
    launches, ms/step, idle share and peak memory, the fp32 step card vs
    CPU, the enhanced pretrain step), also through the batch CLI, the
    server, ``direct_transform`` and ``train --channels 48``, c24 through
    ``pretrain --model enhanced``; c24, c40 and c56 small (the fp32
    program at 64^2 on both engines, one fp32 CycleGAN step and two fp32
    pretrain steps at 128^2, card vs CPU); the route's share of the c48
    step;
20. the widths that are not multiples of 8 (c4, c12, c20, c28, c36, c44,
    c52, c60: every generator width from 1 to 64 that is not a multiple of
    8, as the EnhancedGenerator exists at c % 4 == 0 only; on
    their own rngs, the kernel phases beside the others, the serving and
    training paths after the grid's): every new kernel variant against its
    plain version in fp32 and bf16 (``phase_any_kernels``: the attention,
    both layouts, at C = 1 .. 8 and every LocalAttention width of those
    generators and of c1, c2, c3, c63 on the stress inputs; the block at
    the dims, the head-slot kernel and the FMA bodies, a ragged grid too;
    row 12 in head slots of 16 .. 64 at the same dims; row 11 at C = 1, 2,
    4); c4 and c60 at full width as c48 is (kernel phases at their
    canvas-256 shapes, served on
    both engines with fp32 card vs CPU and bf16 img/s, c60 also through
    the batch CLI, the server and ``direct_transform``; the bf16 CycleGAN
    step with its launches (c4 through row 11, c60 through the route), the
    fp32 step card vs CPU, the enhanced pretrain step, ``train --channels
    4`` and ``pretrain --model enhanced --channels 60``; c60's down2 under
    grad card vs CPU); c12, c20, c28 and c44 small (the fp32 program at
    64^2 on both engines, one fp32 CycleGAN step and two fp32 pretrain
    steps at 64^2, card vs CPU);
21. the widths past 64 (c65 .. c128, on their own rngs, the kernel phases
    beside the others, the serving and training paths after the any-width
    ones): every kernel against its plain version in fp32 and bf16 on the
    stress inputs (``phase_any_kernels``: the attention, both layouts, at C
    = 257, 272, 384, 500 and 512 in the C = 512 layout; the block, the pair
    kernel in bf16 and the FMA bodies with a workspace in fp32, and row 12
    at dims 260, 272, 288, 416, 464, 480 and 512 in 5 to 16 heads, a ragged
    grid too; the bf16 block at dims 200, 220, 252, 416 and 480, whose
    windows have an odd count of weight tiles, on 512 windows:
    ``phase_block_many_windows``);
    the route at C = 512 card vs CPU; c68 (8 heads of 34 in slots of 48)
    at full width as c48 is, through the pair kernel in bf16 (kernel
    phases at its canvas-256 shapes, served on both engines with fp32 card
    vs CPU and bf16 img/s, ``batch_process``; the bf16 CycleGAN step with
    its launches, the fp32 step card vs CPU at 64^2, the enhanced pretrain
    step, ``train --channels 68`` whose G_AB stylizes a folder); c72, c96,
    c116 and c128 small (the fp32 program at 64^2 on the NHWC engine, one
    fp32 CycleGAN step and two fp32 pretrain steps at 64^2, card vs CPU;
    ``train --channels 72 --no_fast_attention`` with no kernel launch);
22. the widths past 128 (c132, c192 and c256, on their own rngs, the
    kernel phases beside the others, the serving and training paths after
    the wide ones): every kernel against its plain version in fp32 and bf16
    on the stress inputs (``phase_any_kernels``: the attention, both
    layouts, at C = 516, 528, 768, 1024 and 2048, streamed through a
    workspace; the block, the bf16 chain and the fp32 FMA bodies with the
    residual stream in float64, and row 12 at dims 528, 768, 1024, 1072,
    2032 and 2048 in 16 to 64 heads of 32 to 127 channels, a ragged grid
    too; ``phase_past_many_windows``: bf16 on grids of several workspace
    chunks); c256 at full width (kernel phases at its canvas-256 shapes;
    served with the fp32 program at 64^2 card vs CPU, bf16 img/s of both
    engines at batch 16, ``batch_process``, the batch CLI with ``--engine
    nhwc`` and ``auto``, the server and ``direct_transform``; the bf16
    CycleGAN step with its launches, every LocalAttention call on the route
    up to C = 1024, ms/step, idle share and peak memory, the fp32 step and
    two fp32 pretrain steps at 64^2 card vs CPU, the enhanced pretrain step
    with its peak memory; ``train --channels 256`` and ``pretrain --model
    enhanced --channels 256`` at the CLIs' other defaults; the route at C =
    1024 card vs CPU and timed with its peak memory); c132 and c192 served
    (the fp32 program at 64^2 card vs CPU, the fp32 packed engine vs the
    NHWC one on the card, bf16 img/s of both engines at canvas 256, batch
    16);
23. the trained-model study (``phase_study``, after the evaluation path):
    the recipe of ``docs/TRAINED_STUDY.md`` through
    ``multi_style_transfer_gan_tpu_torch.scripts``: the synthetic domains,
    the train CLI for 2 epochs at c16, the shipped trained pair staged as
    epoch 3, ``select_checkpoints`` (every forward 4 + 1 launches, timed in
    img/s; the shipped pair's fp32 ``forward_u8`` card vs CPU; the exported
    soup bit-equal to a host recomputation), ``make_sample_grids``,
    ``run_trained_surface`` with no stage skipped (each stage's seconds,
    the server's p50 / p95 and img/s) and ``reproduce_quality_study
    --synthetic``.
24. data parallelism (``phase_data_parallel``, after the perceptual path;
    its processes start once every source is built, ``dp_start``, and
    wait for its release): ``torchrun --standalone --nproc_per_node=1``
    running this script as its rank (``--data-parallel-rank``; NCCL at
    world 1): the train CLI at its defaults for 3 steps and the pretrain
    CLI at its plain default for 2, rank 0 writing, then the bf16 c16
    step timed in turns with its gradient all-reduces and without them,
    and the all-reduces alone; two gloo ranks sharing the card against
    one rank on the same global batch (a CycleGAN step with pools, a plain
    pretrain step with global BatchNorm; fp32, TF32 off, deterministic
    cuDNN, warm Adams): the losses, the averaged gradients' norms, the
    ranks' gradients bit-equal, and again under the planted all-sum fault,
    which must fail; ``batch_process`` over two replicas of the program on
    the card against one device at a replica's batch, and the batch CLI
    with ``--data_parallel``. The ranks' launches count with the path's.
25. height-sharded inference (``phase_spatial``, after the single-image
    path; its kernel checks ``phase_spatial_kernels`` beside step 4): the
    trained c16 generator's rows over ``[the card] * shards`` against its
    unsharded forward at 1024^2 over 2 and 4 shards, 960^2 over 4, 992^2
    over 2 and 1008^2 over 3 (windows across shard boundaries, a padded
    last window), fp32 with deterministic cuDNN, at precision 'highest'
    (within 1 level) and 'default'; each sharded forward's 4 x shards
    attention launches and one block launch a window-aligned piece, no
    plain version run; two planted faults (each shard's own InstanceNorm
    statistics, zero halos), each of which must fail the check; the seeded
    plain c64 generator at 1024^2 over 4; the unsharded forward and 2 and
    4 shards at 2048^2 in turns (ms, peak memory), and 2 and 4 shards
    there at 'default' held to 1.25 x the unsharded image alone against
    first in a batch of two, which differ only in cuDNN's algorithms
    (``spatial_tf32``); ``direct_transform
    --spatial 2`` (exit 1 with "need 2 devices, have 1" on one card);
    rows 1 and 4 against their plain versions at every shard and piece
    shape;
26. the int8 engine (``phase_int8``, after the serving path; its kernel
    checks ``phase_int8_kernels`` beside step 4): the int8 convolution
    against its float64 plain version, max |d| = 0 on the int32 sums and
    on the bf16 epilogue, at every site of a c16 forward at canvas 256 and
    512 (batch 8) and on +-127 stress inputs at every c16 site and at
    c64's down2 (K = 2048, sums past 2^24), each c16 site timed at canvas
    256 beside the bf16 cuDNN convolution and ``_int_mm`` on the im2col
    shape; the trained c16's ``engine='int8'`` program calibrated on the
    gate images' first 8 (26 int8, 4 attention and 1 block launches a
    forward) held to the fp32 program at 1.25x JAX's own int8 mean |d|
    (``int8_gate``, ``JAX_INT8_DISTANCE``) and step by step to the same
    module's forward on the CPU (``int8_forced``: each step fed the CPU's
    input, the convolutions and every step's input bit-equal), four
    planted wiring faults (``INT8_FAULTS``) each failing the step-by-step
    check and the branch swap the gate, its SSIM / PSNR against bf16
    and fp32, img/s of int8 and bf16 NHWC in turns at INT8_RATE_CELLS;
    the batch CLI with ``--engine int8``, ``direct_transform --precision
    int8`` and the server with the int8 engine; the packed engine against
    the NHWC one at 48 x 80 (an odd packed token grid), fp32.

Every fp32 pretrain check holds the losses of two steps and the first
step's gradient norms, and reruns the card's half under each of
PLANTED_FAULTS (a doubled backward of row 12 or of LocalAttention), which
must fail it; the fp32 CycleGAN step check holds the step's losses, which
read the generators' forward and the discriminators' backward. Both start
from warm Adams (``warm_adam``).

The CPU halves of the card-vs-CPU checks (the fp32 programs of the width
paths, the fp32 train and pretrain steps, the fast-VJP route, FID) run in a
pool of CPU_WORKERS spawned processes beside the card's work, and the
evaluation path's test tree is written there meanwhile; each half is
compared when it arrives (FID's when its path starts), and every one before
the report. Every phase
raises on failure, a CPU half too. The last line is the result JSON; the
line before it lists each kernel with its launches on the twenty-four paths
(launch counts are reset just before each path and read just after), its
largest fp32 deviation from the plain version, its time beside the plain
version's (the serving and training rows also per generator width,
``widths``; the channel-attention row also the C = 128 training route,
``fast_vjp_c128``, and c64's at C = 256 and 128, ``fast_vjp_c64``), its
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

import contextlib
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
# The bf16 gate (``bf16_gate``): the bf16 uint8 program on the card against
# the fp32 one (TF32 off) on the same images, held relative to the JAX
# package's own bf16 program's distance from its fp32 one: mean |d| and
# the share of values more than BF16_GATE_LEVELS apart, each at most
# BF16_GATE_FACTOR times JAX's. bf16 alone moves single pixels of the
# trained c16 program by up to ~190 levels through its 13 InstanceNorms,
# so an absolute bound cannot tell a broken kernel from bf16's
# conditioning. The gate images: ``gate_images``, BF16_GATE_IMAGES of
# ``smooth_images`` from default_rng(BF16_GATE_SEED) a canvas; a batch past
# their count runs them tiled. JAX_BF16_DISTANCE holds JAX's figures
# (mean |d| in levels, share past BF16_GATE_LEVELS), computed on the CPU
# on those images (JAX's ``make_batch_fn`` with compute_dtype bf16 against
# None, its NHWC or packed engine) and recomputed by
# tests/test_torch_bf16_gate.py: "trained", the trained c16 generator;
# "plain", ``plain_checkpoint``'s seeded c64 generator; "direct" and
# "local style", JAX's ``transform_image`` and
# ``enhanced_local_style_transfer`` with the generator applied in bf16 on
# ``gate_photo`` (the single-image CLIs at their 'default' precision, TF32
# on the card, are held to the same gate against the CPU's fp32).
BF16_GATE_SEED = 3
BF16_GATE_IMAGES = {256: 16, 512: 4}
BF16_GATE_BATCHES = (1, 4, 8) + RATE_BATCHES
BF16_GATE_FACTOR = 1.25
BF16_GATE_LEVELS = 2
JAX_BF16_DISTANCE = {
    ("trained", "nhwc", 256): (0.5043, 0.01685),
    ("trained", "packed", 256): (0.5128, 0.01745),
    ("trained", "nhwc", 512): (0.4581, 0.01209),
    ("trained", "packed", 512): (0.4693, 0.01289),
    ("plain", 256): (0.1230, 0.0),
    ("direct", 256): (0.4858, 0.01457),
    ("local style", 256): (2.464, 0.3357),
}
# The int8 engine (phase_int8_kernels, phase_int8). Its convolution is held
# to its float64 plain version exactly at every c16 site of a forward at
# each canvas of CANVASES (batch BATCH), and on +-127 stress inputs at every
# c16 site and at INT8_STRESS_SITE of the c{INT8_STRESS_CHANNELS} generator
# (K = 2048: sums up to 3.3e7, past 2^24, where the int32 -> bf16 cast
# rounds twice). The program on the trained c16 is held to the fp32 one
# (TF32 off) on gate_images(256), calibrated on their first
# INT8_CALIB_IMAGES, at BF16_GATE_FACTOR times JAX_INT8_DISTANCE: JAX's own
# int8 program's distance on the same images and calibration batch (mean
# |d| in levels, share past BF16_GATE_LEVELS), computed on the CPU and
# recomputed by tests/test_torch_int8.py. img/s of int8 against bf16 NHWC
# at INT8_RATE_CELLS (canvas, batch). PACKED_ODD_SIZE: (H, W) of the packed
# engine's check at sides that are multiples of 16 and not of 32.
INT8_STRESS_CHANNELS = 64
INT8_STRESS_SITE = "down2.0"
INT8_CALIB_IMAGES = 8
INT8_RATE_CELLS = ((256, 64), (512, 16))
JAX_INT8_DISTANCE = (30.03, 0.9382)
INT8_LAUNCHES_PER_FORWARD = 26
INT8_OPS_PER_S = 1979e12   # dense int8 tensor-core rate, H100 SXM
# The int8 program step by step (int8_trace, int8_forced): each step fed
# the reference's input, its output held to the reference's. An
# InstanceNorm's fp32 sums of int32-sized values differ between two
# summation orders in the last place, which moves a few of its values by
# one bf16 step.
INT8_IN_NEQ_SHARE = 1e-3
# planted wiring faults (int8_fault): each fails int8_forced. On the gate
# images at 256^2 only 'branches' moves the program past the int8 gate
# (phase_int8 logs each fault's reading); at 64^2 (tests/test_torch_int8.py)
# the first three do.
INT8_FAULTS = ("residual", "branches", "convT phases", "welford")
INT8_FORCED_IMAGES = 2   # phase_int8's step-by-step check, gate images
PACKED_ODD_SIZE = (48, 80)
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
# two fp32 pretrain steps card vs CPU: the losses, relative
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
# and 4 heads) beside c16's widths; the c64 one (the JAX pretrain CLI's
# default width) its own path: LocalAttention at C = 256 and the block at
# 256 channels in 8 heads. The fp32 card-vs-CPU program runs on
# WIDTH_CPU_BATCH images of the width (the c64 packed engine's repacked
# weights are 2.37 GB in fp32 on the CPU; c8 and c32 on 2 images, which
# keeps the whole run near half its time limit), the folder through
# batch_process holds WIDTH_FOLDER_IMAGES.
GENERATOR_CHANNELS = (8, 16, 24, 32, 40, 48, 56, 64)
WIDTH_CHANNELS = (8, 32)
C64_CHANNELS = (64,)
# the widths that run padded inside the kernels (the attention at C, 2C, 4C
# in the next power-of-two layout, the block at 4C in the dim-128 or dim-256
# design): c48 at full width, c24, c40 and c56 small (GRID_SMALL_SIZE, so
# that the run keeps near its time with every width's paths); the kernels
# of all four at their full shapes
GRID_CHANNELS = (24, 40, 48, 56)
GRID_FULL_CHANNELS = (48,)
GRID_SMALL_CHANNELS = (24, 40, 56)
GRID_SMALL_SIZE = 64
# every other width from 1 to 64: the attention at C % 8 != 0 (and below 8)
# in the runtime-C variant of its layout, the block's heads of 4 .. 62
# channels in the FMA bodies, row 12's in slots of 16 .. 64 channels, row 11
# at C = 1, 2 and 4. The EnhancedGenerator itself exists at c % 4 == 0 only
# (its multi-scale block splits c into four branches of c // 4 channels, in
# the JAX package as in the port), so the generators that are not multiples
# of 8 are c4, c12, .., c60: c4 (row 11 at C = 4, 8, 16) and c60 (6 heads
# of 40 in slots of 48, the widest slots under 256; the attention at C = 60,
# 120, 240) at full width, c12, c20, c28 and c44 at ANY_SMALL_SIZE (c36 and
# c52 have the heads of c12 .. c44's kinds: 4 of 36 and 4 of 52 in slots
# of 48 and 64, checked in the kernel phase)
ANY_FULL_CHANNELS = (4, 60)
ANY_SMALL_CHANNELS = (12, 20, 28, 44)
ANY_CHANNELS = ANY_FULL_CHANNELS + ANY_SMALL_CHANNELS
ANY_SMALL_SIZE = 64
# the new kernel variants against their plain versions, at the widths of
# ANY_CHANNELS, c36 and c52, and those of c1, c2, c3 and c63 (widths no
# generator has, which the kernels take all the same): the attention at every
# LocalAttention width and C = 5, 7 (all of CP = 16's runtime-C range),
# the block and row 12 at the dims, row 11 at C = 1, 2, 4, on a grid of
# ANY_KERNEL_GRID (and the block on a ragged one too)
ANY_KERNEL_CHANNELS = (1, 2, 3) + ANY_CHANNELS + (36, 52, 63)
# block and row 12 dims off every generator: C % 4 != 0 (dim 6) and heads
# of an odd width (dim 244, 4 heads of 61), which the block runs in its FMA
# bodies in bf16 too and row 12 stages a value at a time
ANY_ODD_DIMS = (6, 244)
ANY_ATTENTION_WIDTHS = tuple(sorted(
    {w for c in ANY_KERNEL_CHANNELS for w in (c, 2 * c, 4 * c)} | {5, 7}))
ANY_KERNEL_GRID = (2, 32, 32)
# the widths past 64 (c65 .. c128): the attention at 4C in the C = 512
# layout (C = 257 .. 512), the block at dims 260 .. 512 in the pair kernel
# (bf16: a cluster of two blocks a window) and the FMA bodies with a
# workspace (fp32), row 12 at 8 .. 16 heads. c68 (8 heads of 34 in slots of
# 48, the attention at 68, 136, 272: the narrowest width past 256, with the
# most padding) at full width, served and trained in bf16 through the pair
# kernel; c72 (9 heads of 32), c96 (12 of 32), c116 (8 of 58 in slots of
# 64) and, since the paths past 128 came, c128 (16 of 32) at
# WIDE_SMALL_SIZE; every kernel against its plain version at the attention
# widths WIDE_ATTENTION_WIDTHS and the block and row 12 dims
# WIDE_BLOCK_DIMS on ANY_KERNEL_GRID
WIDE_FULL_CHANNELS = (68,)
WIDE_SMALL_CHANNELS = (72, 96, 116, 128)
WIDE_SMALL_SIZE = 64
WIDE_ATTENTION_WIDTHS = (257, 272, 384, 500, 512)
WIDE_BLOCK_DIMS = (260, 272, 288, 416, 464, 480, 512)
# the bf16 block's weights pass through two shared-memory buffers, tile after
# tile across the windows a block (or pair) takes in turn; at these dims a
# window has an odd tile count and reads its last tile (fc2's output rows from
# 192 or 384): held on a grid of more windows than the card holds blocks,
# where the next window's first tile is copied while the last one is read
MANY_WINDOW_BLOCK_DIMS = (200, 220, 252, 416, 480)
MANY_WINDOW_GRID = (8, 64, 64)
# the widths past 128 (c129 .. c512): the attention past C = 512 streamed
# through a workspace, the bf16 block past dim 512 (and at heads wider than
# 64) as the streamed chain, the fp32 block in the FMA bodies with its
# residual stream in float64, row 12 at 16 .. 64 heads and at heads wider
# than 64 in chunks of 64. Every new kernel shape against its plain version
# on ANY_KERNEL_GRID (PAST_ATTENTION_WIDTHS: the down2 of c129, c132, c192,
# c256 and c512; PAST_BLOCK_DIMS: the blocks of c132 (16 heads of 33), c192,
# c256, c268 (16 of 67), c508 (16 of 127) and c512 (64 of 32)) and, in
# bf16, on grids of more windows than one workspace chunk holds
# (PAST_MANY_ATTENTION; PAST_MANY_BLOCK_DIMS on MANY_WINDOW_GRID); c256 (32
# heads of 32, the attention at 256, 512 and 1024) at full width, served
# and trained; c132 and c192 served on both engines at canvas 256, batch
# PAST_RATE_BATCH. c128 runs small since then (WIDE_SMALL_CHANNELS), which
# keeps the run near its time with these paths
PAST_FULL_CHANNELS = (256,)
PAST_SERVED_CHANNELS = (132, 192) + PAST_FULL_CHANNELS
PAST_ATTENTION_WIDTHS = (516, 528, 768, 1024, 2048)
PAST_BLOCK_DIMS = (528, 768, 1024, 1072, 2032, 2048)
PAST_MANY_ATTENTION = ((8, 64, 64, 1024), (4, 48, 48, 2048))
PAST_MANY_BLOCK_DIMS = (528, 1072, 2048)
PAST_RATE_BATCH = 16
# c256's fp32 programs and steps card vs CPU: at 64^2, as c68 .. c128's
PAST_FP32_SIZE = 64
# the fp32 CycleGAN and pretrain steps card vs CPU run from warm Adams
# (``warm_adam``): a fresh Adam's first update is lr times the gradient's
# sign, and from fresh ones the second losses read 1.05e-3 .. 1.18e-3 card
# vs CPU at c72, c128 and c256 against rtol 1e-3 (PERF.md, which holds
# both against float64: devtools/fp32_step_spread.py). The pretrain
# check also holds the first step's gradient norms, and its negative
# control reruns the card's half under each of PLANTED_FAULTS
# (``planted_fault``), each of which must fail it
WARM_ADAM_NU = 1e-6
PLANTED_FAULTS = ("row 12 dqkv x2", "LocalAttention dx x2")
# the pretrain check's gradient norms, card vs CPU (``grad_rel``): each
# tensor's norm against itself, or against GRAD_NORM_FLOOR of the largest
# where it is smaller, at GRAD_NORM_RTOL. Card vs CPU they read 2.2e-4 ..
# 5.9e-2 at c4 .. c256 (the largest at c28); each planted fault 0.88 or
# more (PERF.md). The check logs its farthest tensor. At c28 on
# devtools/fp32_step_spread.py's images (NVIDIA H100 80GB HBM3, 700.00 W)
# the farthest are down2.3.qkv.bias at 64^2, card vs CPU 3.49e-4 with the
# CPU's own fp32 7.33e-4 from float64, and down2.4.branch1.0.weight at
# 128^2, card vs CPU 4.49e-3 with the card 4.99e-3 from float64 and float64
# under an fp32-sized rounding after every operation up to 3.51e-3
# (``--noise``): conditioning, the norm of a gradient whose exact sum
# cancels, not a fault
GRAD_NORM_FLOOR = 1e-2
GRAD_NORM_RTOL = 0.2
# c256's bf16 steps and the CLIs' batch: at TRAIN_BATCH (the train CLI's
# default) the route's plain VJP at the down2 holds 8 GiB tensors and the
# CycleGAN step outgrows the card (73.44 GiB in use when one more did not
# fit), so batch 4 (the pretrain CLI's default 16 alike)
PAST_TRAIN_BATCH = 4
# the width whose fp32 packed engine is held against the NHWC one on the
# card (c192's repacked fp32 weights are ~20 GiB, c256's would be ~35)
PAST_PACKED_FP32_CHANNELS = (132,)
# c256's steps are long (its CycleGAN step ~1.8 s at batch 4): fewer timed
WIDE_TIMED_STEPS = 3
# the width paths read a step's device time from this many profiled steps
# (a profiler session of a whole step takes seconds to read back), time
# WIDTH_TIMED_STEPS steps after the warm-up and each engine's img/s over
# WIDTH_RATE_ITERS forwards a turn (fewer since the paths past 128 and the
# data-parallel path came, to keep the run near its time)
WIDTH_PROFILED_STEPS = 2
WIDTH_TIMED_STEPS = 3
WIDTH_RATE_ITERS = 3
# also through the batch CLI, server, direct_transform (c256 on the past-128
# path)
ENTRY_CHANNELS = (48, 60, 64)
WIDTH_CPU_BATCH = {8: 2, 32: 2, 64: 1, 24: 2, 48: 1, 40: 2, 56: 2, 4: 2,
                   60: 1, **{c: 2 for c in ANY_SMALL_CHANNELS},
                   **{c: 1 for c in WIDE_FULL_CHANNELS + WIDE_SMALL_CHANNELS
                      + PAST_SERVED_CHANNELS}}
WIDTH_FOLDER_IMAGES = 6
# the c8, c32 and c64 generators trained: launches per bf16 CycleGAN step (pair
# batching, remat off; 4 generator forwards with grad, 2 under no_grad) and
# per enhanced pretrain step (1 forward with grad). c8 trains LocalAttention
# at C = 8, 16, 32 through row 11, as c16 does; c32 at C = 32, 64, 64
# through row 11 and its down2 at C = 128 through the fast-VJP route, whose
# forward is row 1's kernel under grad (4 a step beside the D phase's 8);
# c64 trains only its up2 (C = 64) through row 11 and down1, down2 and up1
# (C = 128, 256, 128) through the route (12 a step beside the D phase's 8)
WIDTH_TRAIN_LAUNCHES_PER_STEP = {
    8: TRAIN_LAUNCHES_PER_STEP,
    32: {"window_attention_mid_fwd": 12, "window_attention_mid_bwd": 12,
         "window_mhsa_fwd": 4, "window_mhsa_bwd": 4,
         "window_channel_attention": 12, "fused_structural_block": 2},
    64: {"window_attention_mid_fwd": 4, "window_attention_mid_bwd": 4,
         "window_mhsa_fwd": 4, "window_mhsa_bwd": 4,
         "window_channel_attention": 20, "fused_structural_block": 2}}
# c24 .. c56 train every LocalAttention call (C, 2C, 4C: none in row 11's
# widths) through the route: 16 a step beside the D phase's 8, no row 11
for _c in GRID_CHANNELS:
    WIDTH_TRAIN_LAUNCHES_PER_STEP[_c] = {
        "window_attention_mid_fwd": 0, "window_attention_mid_bwd": 0,
        "window_mhsa_fwd": 4, "window_mhsa_bwd": 4,
        "window_channel_attention": 24, "fused_structural_block": 2}
# c4 trains LocalAttention at C = 4, 8, 16, all through row 11, as c16
# does; c60 at C = 60, 120, 240, all through the route, as c24 .. c56 do
WIDTH_TRAIN_LAUNCHES_PER_STEP[4] = TRAIN_LAUNCHES_PER_STEP
WIDTH_TRAIN_LAUNCHES_PER_STEP[60] = WIDTH_TRAIN_LAUNCHES_PER_STEP[24]
# c68 and c256 train every LocalAttention call through the route too
for _c in WIDE_FULL_CHANNELS + PAST_FULL_CHANNELS:
    WIDTH_TRAIN_LAUNCHES_PER_STEP[_c] = WIDTH_TRAIN_LAUNCHES_PER_STEP[24]
WIDTH_PRETRAIN_LAUNCHES_PER_STEP = {
    8: PRETRAIN_LAUNCHES_PER_STEP,
    32: {"window_attention_mid_fwd": 3, "window_attention_mid_bwd": 3,
         "window_mhsa_fwd": 1, "window_mhsa_bwd": 1,
         "window_channel_attention": 1, "fused_structural_block": 0},
    64: {"window_attention_mid_fwd": 1, "window_attention_mid_bwd": 1,
         "window_mhsa_fwd": 1, "window_mhsa_bwd": 1,
         "window_channel_attention": 3, "fused_structural_block": 0}}
for _c in GRID_CHANNELS:
    WIDTH_PRETRAIN_LAUNCHES_PER_STEP[_c] = {
        "window_attention_mid_fwd": 0, "window_attention_mid_bwd": 0,
        "window_mhsa_fwd": 1, "window_mhsa_bwd": 1,
        "window_channel_attention": 4, "fused_structural_block": 0}
WIDTH_PRETRAIN_LAUNCHES_PER_STEP[4] = PRETRAIN_LAUNCHES_PER_STEP
WIDTH_PRETRAIN_LAUNCHES_PER_STEP[60] = WIDTH_PRETRAIN_LAUNCHES_PER_STEP[24]
for _c in WIDE_FULL_CHANNELS + PAST_FULL_CHANNELS:
    WIDTH_PRETRAIN_LAUNCHES_PER_STEP[_c] = WIDTH_PRETRAIN_LAUNCHES_PER_STEP[24]
# c32's down2 under grad: the fast-VJP route at its 256^2, batch-8 shape;
# c64's down2 (C = 256, checked card vs CPU and timed) and down1 and up1
# (C = 128 on 128^2, timed); the fp32 backward of the channel-attention mid
# on more draws of the small q, k input at each width's shapes
FAST_VJP_SHAPE = (TRAIN_BATCH, 64, 64, 128)
C64_FAST_VJP_SHAPES = ((TRAIN_BATCH, 64, 64, 256), (TRAIN_BATCH, 128, 128, 128))
# c48's LocalAttention shapes under grad, all on the route: up2, down1 /
# up1, down2 (checked card vs CPU at down2)
GRID_FAST_VJP_SHAPES = {c: ((TRAIN_BATCH, 256, 256, c),
                            (TRAIN_BATCH, 128, 128, 2 * c),
                            (TRAIN_BATCH, 64, 64, 4 * c))
                        for c in GRID_FULL_CHANNELS}
# c60's down2 under grad: the route at C = 240 (checked card vs CPU, timed)
ANY_FAST_VJP_SHAPE = (TRAIN_BATCH, 64, 64, 240)
# c128's down2 under grad, the route at C = 512: checked card vs CPU on a
# small grid (the CPU half of the batch-8 shape would hold the run for
# minutes)
WIDE_FAST_VJP_SHAPES = (((2, 32, 32, 512), True),)
# c256's down2 under grad, the route at C = 1024 over the streamed kernel:
# card vs CPU on a small grid, timed (with its peak memory) at the train
# step's shape
PAST_FAST_VJP_SHAPES = (((2, 32, 32, 1024), True),
                        ((TRAIN_BATCH, 64, 64, 1024), False))
SMALL_QK_DRAWS = 2
WIDTH_TRAIN_SIZE = 256   # the bf16 steps' images


PROFILE_ATTEMPTS = 10    # torch.profiler sessions asked for one device time
# the CPU halves of the card-vs-CPU checks run in worker processes beside the
# card's work (``CpuHalves``): of the card machine's 8 cores, each worker
# takes CPU_THREADS intra-op threads and the driving process the rest
CPU_WORKERS, CPU_THREADS = 2, 3


def log(*a):
    print(*a, flush=True)


def _cpu_worker_init(threads):
    import torch

    # behind the driving process, whose host work paces the card: a CPU
    # half takes the cores the card's work leaves
    os.nice(10)
    torch.set_num_threads(threads)


class CpuHalves:
    """The CPU halves of the card-vs-CPU checks, computed in worker
    processes (spawned: no CUDA there) while the card works on.
    ``check(fn, args, finish)`` submits ``fn(*args)`` (a function of this
    module, numpy in and out) and keeps ``finish``, which takes the CPU
    result, compares it with the card's and raises on a disagreement;
    ``settle()`` waits for every pending half in the order submitted and
    runs its ``finish``, re-raising a worker's exception: nothing is
    dropped."""

    def __init__(self, workers, threads):
        import concurrent.futures
        import multiprocessing

        self.pool = concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"),
            initializer=_cpu_worker_init, initargs=(threads,))
        self.pending = []

    def check(self, fn, args, finish):
        self.pending.append((self.pool.submit(fn, *args), finish))

    def submit(self, fn, args):
        return self.pool.submit(fn, *args)

    def settle(self):
        pending, self.pending = self.pending, []
        for future, finish in pending:
            finish(future.result())

    def close(self):
        self.pool.shutdown(wait=True, cancel_futures=True)


CPU_HALVES = [None]   # the run's CpuHalves, set in run()


def cpu_check(fn, args, finish):
    """``finish(fn(*args))``: at once without the run's pool (a rehearsal
    on the CPU), else when the pool has computed it."""
    if CPU_HALVES[0] is None:
        finish(fn(*args))
    else:
        CPU_HALVES[0].check(fn, args, finish)


def cpu_result(fn, args):
    """A callable that returns ``fn(*args)``: computed in the run's pool
    from now on (host work done ahead of the path that needs it), or at
    once without a pool."""
    if CPU_HALVES[0] is None:
        out = fn(*args)
        return lambda: out
    return CPU_HALVES[0].submit(fn, args).result


def settle_cpu_halves():
    """Every pending CPU half compared: raises on the first that fails."""
    if CPU_HALVES[0] is not None:
        CPU_HALVES[0].settle()


_STARTED = [time.perf_counter()]   # reset at the start of run()


def clock(what):
    """The run's clock at ``what``, a line of its own."""
    log(f"[clock] {what}: {time.perf_counter() - _STARTED[0]:.1f} s")


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
    # a profile now and then comes back empty, at times several in a row:
    # ask again, letting the tracer settle a little longer each time
    for attempt in range(PROFILE_ATTEMPTS):
        if attempt:
            log(f"[profiler] empty session, asking again ({attempt + 1} of "
                f"{PROFILE_ATTEMPTS})")
            time.sleep(0.2 * attempt)
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
    """Every source at once, one nvcc each, in the background. Returns
    ``ready(*sources)``, which waits for those sources (every one when none
    is named), logs the seconds each took and loads its entry points: the
    first phases run while the longest source still compiles. A failed
    build raises there."""
    from concurrent.futures import ThreadPoolExecutor

    from multi_style_transfer_gan_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(max_workers=len(_build.SOURCES))

    def timed(name):
        _build.build(name)
        return time.perf_counter() - t0

    pending = {name: pool.submit(timed, name) for name in _build.SOURCES}
    finished = []

    def ready(*sources):
        for name in sources or tuple(pending):
            if name not in pending:
                continue
            log(f"[build] {name}: {pending.pop(name).result():.2f} s "
                f"({os.path.relpath(_build.library_path(name), REPO)})")
            for entry, (source, _, _) in _build.SIGNATURES.items():
                if source == name:
                    _build.kernel(entry)
        if not pending and not finished:
            pool.shutdown()
            finished.append(True)
            log(f"[build] {len(_build.SOURCES)} sources, "
                f"{len(_build.SIGNATURES)} entry points loaded, "
                f"{time.perf_counter() - t0:.2f} s after the builds started")
    return ready


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
    dominant (16, 8 and 8 against 0.05; at C < 3 the k channels there are),
    so the Gram's 16 terms add up
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
    sharp[1][[0, C + 1 % C, C + 2 % C]] = 16.0, 8.0, 8.0   # C < 3: fewer k
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
    route), the window-MHSA mid at dim 4C in default_num_heads(4C) heads."""
    from multi_style_transfer_gan_tpu_torch.ops.kernels.fused_transformer import (
        default_num_heads,
    )
    from multi_style_transfer_gan_tpu_torch.ops.kernels.window_attention_train import (
        KERNEL_WIDTHS,
    )

    B, c = TRAIN_BATCH, channels
    cases = [("attention", stage, (B, hw, hw, 3 * w), None)
             for stage, hw, w in (("up2", 256, c), ("down1/up1", 128, 2 * c),
                                  ("down2", 64, 4 * c))
             if w in KERNEL_WIDTHS]
    return cases + [("mhsa", "block", (B, 64, 64, 12 * c),
                     default_num_heads(4 * c))]


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


def gate_images(canvas):
    """The bf16 gate's images at ``canvas`` (``JAX_BF16_DISTANCE``)."""
    return np.stack(smooth_images(np.random.default_rng(BF16_GATE_SEED),
                                  BF16_GATE_IMAGES[canvas], (canvas, canvas)))


def gate_photo():
    """The single-image gate's 400 x 300 photo (``JAX_BF16_DISTANCE``)."""
    return smooth_images(np.random.default_rng(BF16_GATE_SEED), 1,
                         (400, 300))[0]


def bf16_distance(got, ref):
    """(mean |d| in uint8 levels, share of values more than
    BF16_GATE_LEVELS apart) of ``got`` from ``ref``."""
    d = np.abs(np.asarray(got, np.int32) - np.asarray(ref, np.int32))
    return float(d.mean()), float((d > BF16_GATE_LEVELS).mean())


def bf16_gate(what, got, ref, key):
    """Holds ``got`` (the bf16 program's uint8 output, or a TF32 run's) to
    ``ref`` (the fp32 one on the same images) at BF16_GATE_FACTOR times
    JAX's bf16 distance ``JAX_BF16_DISTANCE[key]``; raises past it."""
    mean, share = bf16_distance(got, ref)
    jmean, jshare = JAX_BF16_DISTANCE[key]
    log(f"    {what}: mean |d| {mean:.4f} levels (limit "
        f"{BF16_GATE_FACTOR * jmean:.4f}), past {BF16_GATE_LEVELS} levels "
        f"{share:.4%} (limit {BF16_GATE_FACTOR * jshare:.4%})")
    if not (mean <= BF16_GATE_FACTOR * jmean
            and share <= BF16_GATE_FACTOR * jshare):   # NaN fails too
        raise AssertionError(f"{what}: the bf16 program lies {mean:.4f} "
                             f"levels (mean), {share:.4%} past "
                             f"{BF16_GATE_LEVELS} from fp32, past "
                             f"{BF16_GATE_FACTOR} x JAX's {jmean} / {jshare}")


def bf16_batch_sweep(tag, bf16, fp32, canvas, key, dev):
    """The bf16 gate at every batch of BF16_GATE_BATCHES: the gate images at
    ``canvas`` (tiled up to the batch where it is past their count) through
    the bf16 program ``bf16`` in chunks of that batch, against the fp32
    program ``fp32`` (TF32 off) on them at their own count."""
    import torch

    x = gate_images(canvas)
    ref = fp32(x).cpu().numpy()
    for n in BF16_GATE_BATCHES:
        reps = max(n, len(x)) // len(x)
        xs = torch.from_numpy(np.tile(x, (reps, 1, 1, 1))).to(dev)
        got = torch.cat([bf16(xs[i:i + n]) for i in range(0, len(xs), n)])
        bf16_gate(f"{tag} bf16 batch {n} vs fp32, canvas {canvas}",
                  got.cpu().numpy(), np.tile(ref, (reps, 1, 1, 1)), key)


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
    enhanced and advanced post chains in the program card vs CPU, the bf16
    program against fp32 at every canvas and every batch of
    BF16_GATE_BATCHES (``bf16_batch_sweep``: the bf16 gate), then bf16
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

    # the bf16 program at every batch against fp32, relative to JAX's
    for canvas in CANVASES:
        for engine in ENGINES:
            bf16_batch_sweep(f"[generator] {engine}", bf16[engine],
                             fp32[engine], canvas, ("trained", engine, canvas),
                             dev)

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


def phase_server(rng, dev, engine, local_style_mode=None, model_path=TRAINED):
    """The HTTP server with ``engine`` on the generator at ``model_path``
    (the trained c16 one by default): four concurrent requests in
    ``cyclegan`` mode, or one in ``local_style`` with ``local_style_mode``."""
    import torch
    from PIL import Image

    from multi_style_transfer_gan_tpu_torch.pipelines import load_generator
    from multi_style_transfer_gan_tpu_torch.serving import (
        StyleTransferService, serve,
    )

    model = load_generator(model_path, device=dev)
    mode = {} if local_style_mode is None else dict(
        mode="local_style", local_style_mode=local_style_mode)
    service = StyleTransferService(model, canvas=256, max_batch=8,
                                   compute_dtype=torch.bfloat16, engine=engine,
                                   device=dev, **mode)
    server = serve(service, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address
    what = (f"c{model.channels} engine {engine}"
            + ("" if local_style_mode is None
               else f", local_style {local_style_mode}"))
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


# ---------------------------------------------------------------------------
# the int8 engine
# ---------------------------------------------------------------------------

def int8_sites(channels, canvas, batch=BATCH):
    """[(site, Int8ConvSpec, input shape (B, H, W, Cin), epilogue mode)] of
    every quantized convolution of one forward of the width-``channels``
    EnhancedGenerator at ``canvas``, in forward order (the int8 engine's 26
    launches at any width)."""
    from multi_style_transfer_gan_tpu_torch.models import EnhancedGenerator
    from multi_style_transfer_gan_tpu_torch.models.enhanced_generator import (
        _MSB_BRANCHES,
    )
    from multi_style_transfer_gan_tpu_torch.models.quantized_generator import (
        _needs_dequant, _site_of, _spec_of,
    )

    gen = EnhancedGenerator(channels, 1)
    # the input side of each site: canvas over this
    first = {"initial.0": 1, "down1.0": 1, "down2.0": 2, "up1.0": 4,
             "up2.0": 2, "output.0": 1}
    msb = {"down1": 2, "down2": 4, "up1": 2, "up2": 1}
    sites = ["initial.0"]
    for stage in msb:
        sites += [f"{stage}.0"] + [f"{stage}.4.{name}.0" for name, *_ in
                                   _MSB_BRANCHES] + [f"{stage}.4.fusion.0"]
    sites.append("output.0")
    assert sorted(sites) == sorted(filter(None, map(_site_of, gen.state_dict())))
    out = []
    for site in sites:
        spec = _spec_of(gen.get_submodule(site))
        side = canvas // (first[site] if site in first
                          else msb[site.split(".")[0]])
        out.append((site, spec, (batch, side, side, spec.cin),
                    "dequant" if _needs_dequant(site) else "bf16"))
    return out


def int8_inputs(rng, spec, shape, dev, stress=False):
    """x (bf16), s_in, the kernel-layout weight, s_w and bias (fp32) of one
    site on the card. Random: x ~ N(0, 1), scales that clip its tails, int8
    weights across the range. ``stress``: every value at +-127 after
    quantization (s_in = 2^-7, x = +-127 s_in: all positive in the first
    half of the batch, all negative in the second) and every weight at
    +127, so that the sums reach K * 127^2 (past 2^24 at K = 2048)."""
    import torch

    from multi_style_transfer_gan_tpu_torch.ops.kernels.int8_conv import (
        pack_weight,
    )

    B = shape[0]
    wshape = ((spec.cin, spec.cout, 4, 4) if spec.transposed
              else (spec.cout, spec.cin, spec.kernel, spec.kernel))
    if stress:
        s_in = np.full(spec.cin, 2.0 ** -7, np.float32)
        x = np.full(shape, 127 * 2.0 ** -7, np.float32)
        x[B // 2:] *= -1
        wq = np.full(wshape, 127, np.int8)
    else:
        s_in = rng.uniform(0.008, 0.03, spec.cin).astype(np.float32)
        x = rng.standard_normal(shape).astype(np.float32)
        wq = rng.integers(-127, 128, wshape).astype(np.int8)
    s_w = rng.uniform(1e-6, 1e-4, spec.cout).astype(np.float32)
    bias = rng.standard_normal(spec.cout).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)
    return (t(x).to(torch.bfloat16), t(s_in),
            pack_weight(torch.from_numpy(wq), spec).to(dev), t(s_w), t(bias))


def int8_work(spec, shape, mode):
    """(bytes, int8 ops) of one site: the bf16 input read once, the int8
    weight and the fp32 scales read once, the output (bf16, or int32) written
    once; 2 M N K operations (the transposed conv's four phases of 2x2
    taps)."""
    B, H, W, _ = shape
    Ho, Wo = spec.out_hw(H, W)
    phases = 4 if spec.transposed else 1
    out_bytes = 4 if mode == "int32" else BF16_BYTES
    moved = (BF16_BYTES * B * H * W * spec.cin + phases * spec.cout * spec.k
             + 4 * (spec.cin + 2 * spec.cout) + out_bytes * B * Ho * Wo
             * spec.cout)
    return moved, 2 * B * Ho * Wo * spec.cout * spec.k


def int8_bound(moved, ops):
    """(bound_ms, bound_by) against the int8 tensor-core rate."""
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def int8_library_calls(x, w, spec, dev):
    """The yardsticks of one site, timed and never called by the port: the
    bf16 cuDNN convolution at the same shape (NCHW in channels_last memory),
    and ``torch._int_mm`` of a random int8 matrix of the im2col shape (M,
    Kpad) by the (Kpad, Npad) weight (the im2col itself not counted)."""
    import torch
    import torch.nn.functional as F

    B, H, W, C = x.shape
    xc = x.permute(0, 3, 1, 2)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    if spec.transposed:
        wb = torch.randn(spec.cin, spec.cout, 4, 4, generator=gen,
                         device=dev).to(torch.bfloat16)
        conv_call = lambda: F.conv_transpose2d(xc, wb, stride=2, padding=1)
    else:
        wb = torch.randn(spec.cout, spec.cin, spec.kernel, spec.kernel,
                         generator=gen, device=dev).to(torch.bfloat16)
        wb = wb.contiguous(memory_format=torch.channels_last)
        conv_call = lambda: F.conv2d(xc, wb, stride=spec.stride,
                                     padding=spec.padding,
                                     dilation=spec.dilation)
    Ho, Wo = spec.out_hw(H, W)
    M = B * Ho * Wo
    a = torch.randint(-127, 128, (M, w.shape[2]), generator=gen, device=dev,
                      dtype=torch.int8)
    wt = w.reshape(-1, w.shape[2])   # every phase's rows: N = phases * Npad
    int_mm_call = lambda: torch._int_mm(a, wt.t())
    return conv_call, int_mm_call


def phase_int8_kernels(rng, dev):
    """The int8 convolution against its float64 plain version on the card,
    exactly (max |d| = 0 on the int32 sums and on the site's own bf16
    epilogue): at every c16 site's shape at canvas 256 and 512 (batch 8) on
    random inputs, and on the +-127 stress inputs at every c16 site at
    canvas 256 and at c64's down2 (K = 2048, sums past 2^24). Times each
    c16 site at canvas 256 in turns with its yardsticks (cuDNN bf16,
    ``_int_mm``); the plain version after them. Returns the report's
    numbers."""
    import torch

    from multi_style_transfer_gan_tpu_torch.ops.kernels import (
        int8_conv, int8_conv_plain,
    )

    err = 0
    cases = [(16, canvas, False) for canvas in CANVASES]
    cases += [(16, CANVASES[0], True), (INT8_STRESS_CHANNELS, CANVASES[0], True)]
    timed = {}
    for channels, canvas, stress in cases:
        seen = set()
        for site, spec, shape, mode in int8_sites(channels, canvas):
            if stress and channels != 16 and site != INT8_STRESS_SITE:
                continue
            if (spec, shape) in seen:
                continue
            seen.add((spec, shape))
            x, s_in, w, s_w, bias = int8_inputs(rng, spec, shape, dev, stress)
            kw = dict(s_w=s_w, bias=bias) if mode == "dequant" else {}
            peak = 0
            for m in ("int32", mode):
                got = int8_conv(x, s_in, w, spec, m, **kw)
                ref = int8_conv_plain(x, s_in, w, spec, m, **kw)
                torch.cuda.synchronize()
                if m == "int32":
                    peak = int(ref.abs().max().item())
                d = (got.double() - ref.double()).abs().max().item()
                err = max(err, d)
                if not d == 0:   # NaN fails too
                    raise AssertionError(
                        f"int8_conv c{channels} {site} {shape} mode {m}"
                        f"{' stress' if stress else ''}: kernel vs plain "
                        f"max |d| {d}")
            log(f"[int8 kernel] c{channels} canvas {canvas} {site} {shape} -> "
                f"{spec.cout} ({'stress' if stress else 'random'}): int32 and "
                f"{mode} bit-equal to the plain version, largest |sum| "
                f"{peak}{' (past 2^24)' if peak > 2 ** 24 else ''}")
            if (channels == INT8_STRESS_CHANNELS and site == INT8_STRESS_SITE
                    and peak <= 2 ** 24):
                raise AssertionError(f"the stress input at {site} kept its "
                                     f"sums at {peak}, not past 2^24")
            if channels == 16 and canvas == CANVASES[0] and not stress:
                kernel = lambda: int8_conv(x, s_in, w, spec, mode, **kw)
                conv_call, int_mm_call = int8_library_calls(x, w, spec, dev)
                k_ms, c_ms, i_ms = time_turns(kernel, conv_call, int_mm_call)
                p_ms = time_ms(lambda: int8_conv_plain(x, s_in, w, spec, mode,
                                                       **kw), iters=2,
                               warmup=1)
                timed[(spec, shape, mode)] = (k_ms, p_ms, c_ms, i_ms)
    rows = {}
    for site, spec, shape, mode in int8_sites(16, CANVASES[0]):
        k_ms, p_ms, c_ms, i_ms = timed[(spec, shape, mode)]
        b_ms, b_by = int8_bound(*int8_work(spec, shape, mode))
        rows[site] = dict(shape=list(shape), cout=spec.cout, ms=k_ms,
                          plain_ms=p_ms, cudnn_bf16_ms=c_ms, int_mm_ms=i_ms,
                          bound_ms=b_ms, bound_by=b_by)
        log(f"[int8 kernel] c16 canvas {CANVASES[0]} batch {BATCH} {site} "
            f"{tuple(shape)} -> {spec.cout}: kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.3f} ms, cuDNN bf16 {c_ms:.4f} ms, _int_mm (im2col "
            f"excluded) {i_ms:.4f} ms, bound {b_ms:.6f} ms by {b_by} "
            f"({b_ms / k_ms:.1%} of the kernel's time)")
    return err, rows


def int8_gate(what, got, ref):
    """Holds the int8 program's uint8 output ``got`` to the fp32 program's
    ``ref`` (TF32 off) on the gate images at BF16_GATE_FACTOR times JAX's
    own int8 mean |d|, ``JAX_INT8_DISTANCE[0]``; raises past it. The share
    past BF16_GATE_LEVELS is logged and not held: JAX's own reads 93.82%,
    so 1.25 times it cannot bind. The gate sees gross faults only
    (branches in each other's channels; see INT8_FAULTS): ``int8_forced``
    holds the program step by step."""
    mean, share = bf16_distance(got, ref)
    jmean, jshare = JAX_INT8_DISTANCE
    log(f"    {what}: mean |d| {mean:.4f} levels (limit "
        f"{BF16_GATE_FACTOR * jmean:.4f}), past {BF16_GATE_LEVELS} levels "
        f"{share:.4%} (JAX's {jshare:.4%}, not held)")
    if not mean <= BF16_GATE_FACTOR * jmean:   # NaN fails too
        raise AssertionError(f"{what}: the int8 program lies {mean:.4f} "
                             f"levels (mean) from fp32, past "
                             f"{BF16_GATE_FACTOR} x JAX's {jmean}")
    return mean, share


def int8_in_probe():
    """A near-flat (2, 16, 16, 24) bf16 NHWC input of the InstanceNorm, as
    the int8 engine's absorbed sites hand it: sums of ~1e6 within one binade
    (every sum and square sum exact in fp32, whatever the order), the first
    8 channels flat but for a few values one bf16 step off, where one-pass
    statistics cancel to (or below) 0 and are clamped and Welford's do
    not."""
    import torch

    rng = np.random.default_rng(7)
    base = rng.uniform(2 ** 20, 2 ** 20 * 1.5, (2, 1, 1, 24))
    steps = rng.integers(-40, 40, (2, 16, 16, 24))
    steps[..., :8] = 0
    steps[..., :8][rng.random((2, 16, 16, 8)) < 0.02] = 1
    return torch.from_numpy(base + steps * 2.0 ** 13).to(torch.bfloat16)


@contextlib.contextmanager
def int8_hooks(wrap):
    """Within the block, QuantizedEnhancedGenerator's forward hands its
    steps (``_forward``'s conv_fn, attention, style linear, blocks, input
    and in_act) through ``wrap``, which returns their replacements."""
    from multi_style_transfer_gan_tpu_torch.models import (
        quantized_generator as tq,
    )

    forward = tq._forward
    tq._forward = lambda *steps: forward(*wrap(*steps))
    try:
        yield
    finally:
        tq._forward = forward


def int8_trace(q, x):
    """Each step of one int8 forward of ``q`` on ``x`` ((B, 3, H, W) bf16),
    on the CPU: {'conv': {site: (input, output)}, 'in': [(input, output)],
    'attention': [(input, output)], 'block': [(input, style, output)],
    'probe': the InstanceNorm of int8_in_probe(), 'out': the output}, NHWC
    (the form ``int8_forced`` takes; tests/test_torch_int8.py builds one
    from the JAX package's forward)."""
    trace = {"conv": {}, "in": [], "attention": [], "block": []}
    cpu = lambda t: t.detach().to("cpu", copy=True)

    def wrap(conv_fn, attention, style_linear, blocks, xin, in_act):
        def conv_step(site, h, out, off):
            y = conv_fn(site, h, out, off)
            cout = q.site(site).spec.cout
            trace["conv"][site] = (cpu(h), cpu(y[..., off:off + cout]))
            return y

        def in_step(h):
            if "probe" not in trace:
                trace["probe"] = cpu(in_act(int8_in_probe().to(h.device)))
            y = in_act(h)
            trace["in"].append((cpu(h), cpu(y)))
            return y

        def attention_step(module):
            def step(h):
                y = module(h)
                trace["attention"].append((cpu(h.permute(0, 2, 3, 1)),
                                           cpu(y.permute(0, 2, 3, 1))))
                return y
            return step

        def block_step(block):
            def step(h, style, orig):
                y = block(h, style, orig)
                trace["block"].append((cpu(h), cpu(style), cpu(y)))
                return y
            return step

        return (conv_step, {k: attention_step(m) for k, m in
                            attention.items()}, style_linear,
                [block_step(b) for b in blocks], xin, in_step)

    with int8_hooks(wrap):
        y = q(x)
    trace["out"] = cpu(y.permute(0, 2, 3, 1))
    return trace


def _bf16_steps(got, ref):
    """|got - ref| in units of one bf16 step at ref's magnitude."""
    import torch

    got, ref = got.float().cpu(), ref.float().cpu()
    step = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30)))
                      - 7)
    return (got - ref).abs() / step


def int8_forced(q, x, trace):
    """One int8 forward of ``q`` on ``x`` with each step's input replaced by
    ``trace``'s (teacher forcing; see ``int8_trace``), each step's output
    held to the trace's: every step's own input bit-equal to the trace's
    (the wiring between steps: the branches' channel slices, the
    residuals), the convolutions bit-equal, each InstanceNorm within one
    bf16 step and at most INT8_IN_NEQ_SHARE of its values not bit-equal,
    and on int8_in_probe() within one bf16 step, the attention, the style
    vector and the block (bf16 computations on the int8 program's large
    activations, where bf16's own error passes BF16_ATOL) within twice the
    reference's own distance from the same step in fp32 on the CPU, or
    BF16_ATOL if that is larger, past BF16_RTOL |ref|, the output within
    one bf16 step.
    Raises at the first step that disagrees; returns the worst reading of
    each kind (the bf16 steps' as a share of their limit)."""
    import copy

    import torch

    worst = {"in_steps": 0.0, "in_neq": 0.0, "probe_steps": 0.0,
             "attention": 0.0, "style": 0.0, "block": 0.0, "out_steps": 0.0}
    n_in = iter(range(len(trace["in"])))
    n_att = iter(range(len(trace["attention"])))
    n_block = iter(range(len(trace["block"])))

    def same(what, got, ref):
        if got.shape != ref.shape or not torch.equal(
                got.to(torch.bfloat16).cpu(), ref.to(torch.bfloat16)):
            raise AssertionError(f"int8 forced: {what} differs from the "
                                 f"reference's")

    def past_rtol(got, ref):
        d = (got.float().cpu() - ref.float()).abs()
        return (d - BF16_RTOL * ref.float().abs()).max().item()

    def close(what, got, ref, ref32):
        """``got`` against ``ref``, the reference's bf16 output, whose
        distance from ``ref32`` (the step in fp32) sets the limit."""
        limit = max(BF16_ATOL, 2 * past_rtol(ref, ref32))
        excess = past_rtol(got, ref)
        if got.shape != ref.shape or not excess <= limit:
            raise AssertionError(f"int8 forced: {what} off by {excess} past "
                                 f"{BF16_RTOL} |ref| (limit {limit})")
        return excess / limit

    def fp32(module):
        return copy.deepcopy(module).float().cpu()

    def steps_within(what, got, ref, key):
        s = _bf16_steps(got, ref)
        worst[key] = max(worst[key], s.max().item())
        if not s.max().item() <= 1:
            raise AssertionError(f"int8 forced: {what} {s.max().item()} bf16 "
                                 f"steps from the reference's")
        return s

    def wrap(conv_fn, attention, style_linear, blocks, xin, in_act):
        dev = xin.device
        on = lambda t: t.to(dev).contiguous()

        def conv_step(site, h, out, off):
            h_ref, y_ref = trace["conv"][site]
            same(f"{site}'s input", h, h_ref)
            y = conv_fn(site, on(h_ref), out, off)
            cout = q.site(site).spec.cout
            same(f"{site}'s output", y[..., off:off + cout], y_ref)
            return y

        def in_step(h):
            i = next(n_in)
            h_ref, y_ref = trace["in"][i]
            same(f"InstanceNorm {i}'s input", h, h_ref)
            if i == 0:
                steps_within("the InstanceNorm of the near-flat probe",
                             in_act(int8_in_probe().to(dev)), trace["probe"],
                             "probe_steps")
            y = in_act(on(h_ref))
            s = steps_within(f"InstanceNorm {i}", y, y_ref, "in_steps")
            neq = (s > 0).float().mean().item()
            worst["in_neq"] = max(worst["in_neq"], neq)
            if not neq <= INT8_IN_NEQ_SHARE:
                raise AssertionError(f"int8 forced: InstanceNorm {i} differs "
                                     f"on {neq:.3%} of its values")
            return on(y_ref)

        def attention_step(module):
            module32 = fp32(module)

            def step(h):
                i = next(n_att)
                h_ref, y_ref = trace["attention"][i]
                same(f"attention {i}'s input", h.permute(0, 2, 3, 1), h_ref)
                y = module(on(h_ref).permute(0, 3, 1, 2))
                y32 = module32(h_ref.float().permute(0, 3, 1, 2))
                worst["attention"] = max(worst["attention"], close(
                    f"attention {i}", y.permute(0, 2, 3, 1), y_ref,
                    y32.permute(0, 2, 3, 1)))
                return on(y_ref).permute(0, 3, 1, 2)
            return step

        linear32 = fp32(style_linear)

        def block_step(block):
            block32 = fp32(block)

            def step(h, style, orig):
                i = next(n_block)
                h_ref, style_ref, y_ref = trace["block"][i]
                same(f"block {i}'s input", h, h_ref)
                style32 = torch.relu(linear32(h_ref.float().mean(dim=(1, 2))))
                worst["style"] = max(worst["style"], close(
                    f"block {i}'s style", style, style_ref, style32))
                y = block(on(h_ref), on(style_ref), orig)
                y32 = block32(h_ref.float(), style_ref.float(),
                              orig.float().cpu())
                worst["block"] = max(worst["block"], close(
                    f"block {i}", y, y_ref, y32))
                return on(y_ref)
            return step

        return (conv_step, {k: attention_step(m) for k, m in
                            attention.items()}, style_linear,
                [block_step(b) for b in blocks], xin, in_step)

    with int8_hooks(wrap):
        y = q(x)
    steps_within("the output", y.permute(0, 2, 3, 1), trace["out"],
                 "out_steps")
    for what, left in (("InstanceNorm", n_in), ("attention", n_att),
                       ("block", n_block)):
        if next(left, None) is not None:
            raise AssertionError(f"int8 forced: the forward skipped an "
                                 f"{what} step of the reference's")
    return worst


@contextlib.contextmanager
def int8_fault(name):
    """One planted wiring fault of the int8 program (INT8_FAULTS) for the
    block's duration: 'residual' drops each MultiScaleBlock's residual,
    'branches' writes the four branches into each other's channels,
    'convT phases' swaps the transposed convolutions' even and odd output
    rows (as a kernel with its phases in the wrong order would), 'welford'
    takes Welford statistics in place of one-pass ones at the absorbed
    sites."""
    import torch

    from multi_style_transfer_gan_tpu_torch.core.norm import in_relu
    from multi_style_transfer_gan_tpu_torch.models import (
        quantized_generator as tq,
    )

    conv = tq.int8_conv

    def convt_swapped(x, s_in, w, spec, *args, **kw):
        y = conv(x, s_in, w, spec, *args, **kw)
        if spec.transposed:
            y = torch.stack([y[:, 1::2], y[:, 0::2]], 2).flatten(1, 2)
        return y

    def msb_without_residual(conv_fn, h, prefix, in_act):
        cat = torch.empty_like(h)
        for i, (branch, *_) in enumerate(tq._MSB_BRANCHES):
            conv_fn(f"{prefix}{branch}.0", h, cat, i * (h.shape[-1] // 4))
        return in_act(conv_fn(f"{prefix}fusion.0", in_act(cat), None, 0))

    patch = {"residual": ("_msb", msb_without_residual),
             "branches": ("_MSB_BRANCHES", tq._MSB_BRANCHES[::-1]),
             "convT phases": ("int8_conv", convt_swapped),
             "welford": ("in_relu_onepass", lambda h: in_relu(
                 h.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))}[name]
    saved = getattr(tq, patch[0])
    setattr(tq, *patch)
    try:
        yield
    finally:
        setattr(tq, patch[0], saved)


def int8_calibration(images):
    """The int8 engine's calibration batch from uint8 images: the first
    INT8_CALIB_IMAGES in [-1, 1], as the batch CLI takes a folder's."""
    import torch

    from multi_style_transfer_gan_tpu_torch.ops import to_model_range

    return [to_model_range(torch.from_numpy(
        np.asarray(images[:INT8_CALIB_IMAGES]))).numpy()]


def phase_int8(rng, dev, counts, work):
    """The int8 engine's path: the uint8 program on the trained c16 with
    ``engine='int8'`` calibrated on the gate images' first 8 (26 int8
    launches, 4 attention and 1 block launch a forward), held to the int8
    gate against fp32, and step by step (``int8_forced``) to the same
    module's forward on the CPU on INT8_FORCED_IMAGES of the images; each
    planted fault of INT8_FAULTS fails the step-by-step check, and
    'branches' the gate too; SSIM / PSNR of its output against bf16 and
    fp32;
    img/s of int8 and bf16 NHWC in turns at INT8_RATE_CELLS; the batch CLI
    with ``--engine int8`` on the serving path's folder,
    ``direct_transform --precision int8`` and the server with the int8
    engine; and the packed engine at a side that is a multiple of 16 and
    not of 32 (PACKED_ODD_SIZE) against the NHWC engine, fp32."""
    import copy

    import torch

    from multi_style_transfer_gan_tpu_torch.cli import direct_transform
    from multi_style_transfer_gan_tpu_torch.cli.batch_process_images import (
        main as batch_main,
    )
    from multi_style_transfer_gan_tpu_torch.metrics.quality import psnr, ssim
    from multi_style_transfer_gan_tpu_torch.ops import to_model_range
    from multi_style_transfer_gan_tpu_torch.pipelines import (
        load_generator, make_batch_fn,
    )

    from PIL import Image

    model = load_generator(TRAINED, device=dev)
    gate = gate_images(256)
    int8 = make_batch_fn(model, "cyclegan", engine="int8",
                         calib_batches=int8_calibration(gate), device=dev)
    fp32 = make_batch_fn(model, "cyclegan", device=dev)
    bf16 = make_batch_fn(model, "cyclegan", compute_dtype=torch.bfloat16,
                         device=dev)
    x = torch.from_numpy(gate).to(dev)
    before = counts()
    got = int8(x).cpu().numpy()
    launched = {n: counts()[n] - before[n] for n in before}
    want = {"int8_conv": INT8_LAUNCHES_PER_FORWARD,
            "window_channel_attention": 4,
            "fused_structural_block": 1}
    log(f"[int8] launches per forward: {launched}")
    if any(launched[n] != want.get(n, 0) for n in launched):
        raise AssertionError(f"int8 forward launches {launched}, expected "
                             f"{want}")
    ref = fp32(x).cpu().numpy()
    half = bf16(x).cpu().numpy()
    gate_mean, gate_share = int8_gate(
        f"[int8] trained c16 int8 program vs fp32, {gate.shape}", got, ref)
    # the program step by step: the card's forward fed, at each step, the
    # input of the same module's forward on the CPU (the plain versions)
    # and held to its output; then each planted fault against the gate and
    # the step-by-step check
    from multi_style_transfer_gan_tpu_torch.ops import to_model_range

    q = int8.module
    xq = to_model_range(torch.from_numpy(gate[:INT8_FORCED_IMAGES])).to(
        torch.bfloat16).permute(0, 3, 1, 2)
    trace = int8_trace(copy.deepcopy(q).to("cpu"), xq)
    forced = int8_forced(q, xq.to(dev), trace)
    log(f"[int8] step by step, card vs CPU on {INT8_FORCED_IMAGES} gate "
        f"images: 26 convolutions and every step's input bit-equal; worst "
        + ", ".join(f"{k} {v:.4g}" for k, v in forced.items()))
    faults = {}
    for fault in INT8_FAULTS:
        with int8_fault(fault):
            bad = int8(x).cpu().numpy()
            try:
                int8_gate(f"[int8] planted fault '{fault}'", bad, ref)
                seen = "inside the gate"
            except AssertionError:
                seen = "past the gate"
            try:
                int8_forced(q, xq.to(dev), trace)
                step = None
            except AssertionError as e:
                step = str(e)
        log(f"[int8] planted fault '{fault}': {seen}; step by step: {step}")
        faults[fault] = seen
        if step is None or (fault == "branches"
                            and seen != "past the gate"):
            raise AssertionError(f"the int8 checks miss the planted fault "
                                 f"'{fault}'")
    on_card = lambda u8: torch.from_numpy(u8).to(dev).float() / 255.0
    quality = {name: (ssim(on_card(got), on_card(other)).mean().item(),
                      psnr(on_card(got), on_card(other)).mean().item())
               for name, other in (("bf16", half), ("fp32", ref))}
    bf_ssim = ssim(on_card(half), on_card(ref)).mean().item()
    log(f"[int8] {card_line()}; on the {len(gate)} gate images at 256^2 "
        f"(uint8 outputs over 255, mean of the per-image values): int8 vs "
        f"bf16 SSIM {quality['bf16'][0]:.4f} PSNR {quality['bf16'][1]:.2f} "
        f"dB; int8 vs fp32 SSIM {quality['fp32'][0]:.4f} PSNR "
        f"{quality['fp32'][1]:.2f} dB; the bf16 floor (bf16 vs fp32) SSIM "
        f"{bf_ssim:.4f}")

    rates = {}
    for canvas, n in INT8_RATE_CELLS:
        xs = torch.from_numpy(np.stack(smooth_images(
            rng, n, (canvas, canvas)))).to(dev)
        calib = int8_calibration(xs.cpu().numpy())
        programs = {"bf16 nhwc": make_batch_fn(
            model, "cyclegan", compute_dtype=torch.bfloat16, device=dev),
            "int8": make_batch_fn(model, "cyclegan", engine="int8",
                                  calib_batches=calib, device=dev)}
        turns = {k: [] for k in programs}
        for k in list(programs) + list(programs)[::-1]:
            turns[k].append(program_rate(programs[k], xs, iters=5))
        rate = rates[(canvas, n)] = {k: sum(r) / len(r)
                                     for k, r in turns.items()}
        log(f"[int8] {card_line()}; batch {n} at canvas {canvas} "
            f"(device-resident uint8 in and out): bf16 NHWC "
            f"{rate['bf16 nhwc']:.1f} img/s, int8 {rate['int8']:.1f} img/s "
            f"(int8 / bf16 {rate['int8'] / rate['bf16 nhwc']:.3f}); turns "
            f"{turns}")

    # the entry points: the batch CLI on the serving path's folder, the
    # single-image CLI, the server
    models = os.path.join(work, "models")
    out = os.path.join(work, "out_int8")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = batch_main(["--input_dir", os.path.join(work, "in"),
                         "--output_dir", out, "--models_dir", models,
                         "--mode", "local_style", "--local_style_mode",
                         "simple", "--batch_size", "8", "--engine", "int8"])
    written = len(os.listdir(os.path.join(
        out, "local_style_simple_photo2monet")))
    log(f"[int8] batch CLI --engine int8 (local_style simple): exit {rc}, "
        f"{written} outputs; " + " | ".join(
            line for line in buf.getvalue().splitlines()
            if "WARNING" in line or "done:" in line))
    if rc != 0 or written != 24 or "EXPERIMENTAL" not in buf.getvalue():
        raise AssertionError("batch CLI --engine int8 failed")
    photo = os.path.join(work, "int8_photo.png")
    Image.fromarray(gate_photo()).save(photo)
    dst = os.path.join(work, "int8_direct.png")
    rc, _ = run_quiet(direct_transform.main, ["--image", photo, "--model",
                                              TRAINED, "--output", dst,
                                              "--precision", "int8"])
    with Image.open(dst) as img:
        ok = rc == 0 and img.size == (256, 256)
    log(f"[int8] direct_transform --precision int8: exit {rc}, "
        f"{'a 256^2 PNG' if ok else 'no output'}")
    if not ok:
        raise AssertionError("direct_transform --precision int8 failed")
    phase_server(rng, dev, "int8")

    # the packed engine at sides that are multiples of 16 and not of 32
    xs = np.stack(smooth_images(rng, 2, PACKED_ODD_SIZE[::-1]))
    packed, nhwc = (make_batch_fn(model, "cyclegan", engine=e,
                                  device=dev)(xs).cpu().numpy()
                    for e in ("packed", "nhwc"))
    dmax, share = u8_diff(packed, nhwc)
    log(f"[int8] packed vs NHWC engine, fp32 at {PACKED_ODD_SIZE[0]} x "
        f"{PACKED_ODD_SIZE[1]} (odd packed token grid): max diff {dmax}, "
        f"differing share {share:.3e}")
    if packed.shape != xs.shape or dmax > U8_MAX_DIFF or share > U8_MAX_SHARE:
        raise AssertionError("packed and NHWC engines disagree at "
                             f"{PACKED_ODD_SIZE}")
    return {"gate": (gate_mean, gate_share), "forced": forced,
            "faults": faults, "quality": quality, "bf16_ssim": bf_ssim,
            "rates": rates}


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
    card's machine has no matplotlib: the size sweep and the skip blends,
    which draw with it alone, are held against the JAX package by the CPU
    tests only; the advanced CLI, the local-style figure and
    ``compare_models`` draw with PIL there and run in the study path
    (``phase_study``)."""
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
        Image.fromarray(gate_photo()).save(photo)
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
        # where cuDNN may take TF32 on the card: the bf16 gate on the two
        # that run it (TF32 rounds finer than bf16), the post chain's limits
        # on the repair, which runs no generator
        got, ref = outs["card"], outs["cpu"]
        for name in got:
            if got[name].shape != ref[name].shape:
                raise AssertionError(f"{name}: {got[name].shape} vs "
                                     f"{ref[name].shape}")
        for name, key in (("direct_transform", ("direct", 256)),
                          ("enhanced_local_style", ("local style", 256))):
            bf16_gate(f"{name} CLI {got[name].shape}, TF32 allowed, card vs "
                      f"CPU", got[name], ref[name], key)
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
    fp32 at every batch of BF16_GATE_BATCHES (the bf16 gate), and its bf16
    img/s at canvas 256, batches 16 and 64. Returns {batch: img/s}."""
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
    bf16_batch_sweep("[plain]", bf16, fp32, 256, ("plain", 256), dev)
    rates = {}
    for n in RATE_BATCHES:
        xb = torch.from_numpy(np.stack(smooth_images(rng, n, (256, 256)))).to(dev)
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


def time_pretrain(step, what, batch, steps=10, profiled=None):
    """3 warm-up and ``steps`` timed steps on the host clock, then the
    profiled device time of ``profiled`` steps (by default ``steps`` / 2,
    at least 2): (ms/step, device ms/step, idle share)."""
    import torch

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1000 / steps
    dev_ms = device_ms(step, iters=profiled or max(2, steps // 2), warmup=0)
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


def fid_generators(device):
    """The trained G_AB and G_BA at precision 'highest' on ``device``."""
    from multi_style_transfer_gan_tpu_torch.pipelines import load_generator

    return [load_generator(os.path.join(REPO, "trained",
                                        f"G_{d}_selected.pth"),
                           precision="highest", device=device)
            for d in ("AB", "BA")]


def fid_reference(tmp, n, batch):
    """m_test's inputs and the CPU half of :func:`phase_fid`'s check, for
    the CPU pool: a test tree of EVAL_IMAGES images a domain
    (``write_domains``) and a seeded random InceptionV3 ``.pth`` under
    ``tmp``, then ``run_fid_eval`` on the CPU at ``n`` images a direction
    with each kind of features. Returns (tree, weights, seconds the files
    took, {kind: the CPU's FIDs})."""
    import contextlib

    from multi_style_transfer_gan_tpu_torch.data import write_domains
    from multi_style_transfer_gan_tpu_torch.metrics import fid_harness
    from multi_style_transfer_gan_tpu_torch.metrics.inception import (
        make_inception_feature_fn,
    )

    t0 = time.perf_counter()
    data = os.path.join(tmp, "fid_data")
    write_domains(data, n_train=0, n_test=EVAL_IMAGES, size=256, seed=SEED)
    weights = os.path.join(tmp, "inception_v3.pth")
    random_inception_pth(weights)
    seconds = time.perf_counter() - t0
    fids = {}
    for kind, feature_fn in (
            ("inception", make_inception_feature_fn(weights, device="cpu")),
            ("fallback", None)):
        with contextlib.redirect_stdout(io.StringIO()):
            fids[kind] = fid_harness.run_fid_eval(
                *fid_generators("cpu"), data,
                os.path.join(tmp, f"fid_cpu_{kind}"), max_images=n,
                feature_fn=feature_fn, batch=batch, save_panels=False)
    return data, weights, seconds, fids


def phase_fid(dev, counts, tmp, reference):
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
    under ``torch.profiler`` with the host statistic skipped, its device
    time. ``reference()`` gives the test tree, the weights and the CPU's
    FIDs (:func:`fid_reference`). Returns the numbers."""
    import contextlib
    import dataclasses
    import math

    import torch

    from multi_style_transfer_gan_tpu_torch.data import ImageFolderDataset
    from multi_style_transfer_gan_tpu_torch.metrics import fid_harness
    from multi_style_transfer_gan_tpu_torch.metrics.inception import (
        make_inception_feature_fn,
    )
    t0 = time.perf_counter()
    data, weights, seconds, cpu_fids = reference()
    log(f"[fid] test tree of {EVAL_IMAGES} images a domain and a random "
        f"InceptionV3 .pth ({os.path.getsize(weights) / 2 ** 20:.1f} MiB), "
        f"written in {seconds:.1f} s, and the CPU's FIDs, computed in the "
        f"CPU pool beside the earlier paths; waited "
        f"{time.perf_counter() - t0:.1f} s for them")
    gens = {"card": fid_generators(dev)}
    features = {("card", "inception"): make_inception_feature_fn(weights,
                                                                 device=dev),
                ("card", "fallback"): None}

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
        got = fids[kind] = run("card", kind, EVAL_CPU_IMAGES)
        want = cpu_fids[kind]
        rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in want}
        worst = max(worst, *rel.values())
        log(f"[fid] {kind} features, {EVAL_CPU_IMAGES} images a direction: "
            f"card {got}, CPU {want}; relative |d| "
            + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()))
        if not max(rel.values()) <= FID_RTOL:   # NaN fails too
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
        # the device time of one more run, whose Frechet statistic (numpy on
        # the host, no launch) is skipped
        fid_harness.fid_from_features = lambda *a, **k: 1.0
        try:
            dev_ms = device_ms(lambda: run("card", kind, EVAL_IMAGES),
                               iters=1, warmup=0)
        finally:
            fid_harness.fid_from_features = statistic
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
    panels) draw with PIL on the card's machine, which has no matplotlib;
    the CPU tests hold them against the JAX package, and all but
    ``image_quality_comparison`` run in the study path."""
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
        "the enhanced_segmentation mode, debug_model --image and "
        "generate_new_image's plot; the compare tab's worker runs in the "
        "study path")
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


def phase_width_kernels(rng, dev, widths=WIDTH_CHANNELS, stress=True):
    """Rows 1-7 (the attention, NHWC and packed), 9 (the relayout) and 4 (the
    block) at the shapes of one canvas-256 forward of each generator of
    ``widths`` (c8 and c32; c64 and the padded ``GRID_CHANNELS`` on their
    own paths, the latter also at their canvas-512 down2): the attention and the
    block kernel vs plain, fp32 (TF32 off)
    and bf16, on the stress inputs of ``attention_stress_inputs`` and
    ``block_stress_inputs`` (one all-zero window each; the block also on a
    ragged 12 x 20 grid); on the random input, bf16 kernel and plain in
    CUDA-event time in turns and the kernel in profiler device time; the
    relayout as ``phase_relayout`` does at the width's bottleneck. Without
    ``stress`` (c256, whose stress inputs run in ``phase_any_kernels`` and
    ``phase_past_many_windows``) the random input alone in bf16, and the
    block on the canvas-256 grid alone (the fp32 max|d| then None).
    Returns
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
    dtypes = ((torch.float32,) if stress else ()) + (torch.bfloat16,)
    out = {}
    for channels in widths:
        rec = out[channels] = {}
        shapes = [s for _, s in attention_shapes(canvas, channels)]
        # a width that runs padded is also checked at its canvas-512 down2,
        # the largest window count at its widest C
        checked = shapes + ([dict(attention_shapes(CANVASES[1], channels))[
            "down2"]] if channels in GRID_CHANNELS else [])
        for name, fn, plain, packed in (
                ("window_channel_attention", window_channel_attention,
                 window_channel_attention_plain, False),
                ("packed_window_channel_attention",
                 packed_window_channel_attention,
                 packed_window_channel_attention_plain, True)):
            times, worst = {}, {torch.float32: None if not stress else 0.0,
                                 torch.bfloat16: 0.0}
            for shape in dict.fromkeys(checked):
                for label, x, ws in attention_stress_inputs(
                        rng, shape, packed=packed)[:None if stress else 1]:
                    for dtype in dtypes:
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
                        if (label == "random" and dtype == torch.bfloat16
                                and shape in shapes):
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
                        worst[dtype] = max(worst[dtype] or 0.0, err)
            k_ms, p_ms, d_ms = (sum(times[s][i] for s in shapes)
                                for i in range(3))
            b_ms, b_by = bound(*attention_work(shapes))
            rec[name] = dict(ms=k_ms, device_ms=d_ms, plain_ms=p_ms,
                             max_abs_err=worst[torch.float32],
                             max_abs_err_bf16=worst[torch.bfloat16],
                             bound_ms=b_ms, bound_by=b_by, shapes=shapes)

        blk_shape = (BATCH, canvas // 4, canvas // 4, 4 * channels)
        worst = {torch.float32: None if not stress else 0.0,
                 torch.bfloat16: 0.0}
        for grid in (blk_shape, (2, 12, 20, 4 * channels))[:2 if stress
                                                            else 1]:
            for label, host, weights in block_stress_inputs(
                    rng, grid)[:None if stress else 1]:
                for dtype in dtypes:
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
                    worst[dtype] = max(worst[dtype] or 0.0, err)
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


def cpu_program(path, batch, engine):
    """The CPU half of :func:`program_card_vs_cpu`: the fp32 uint8 program
    of the generator at ``path`` (precision 'highest') on ``batch``."""
    from multi_style_transfer_gan_tpu_torch.pipelines import (
        load_generator, make_batch_fn,
    )

    cpu = load_generator(path, precision="highest", device="cpu")
    return make_batch_fn(cpu, "cyclegan", engine=engine,
                         device="cpu")(batch).numpy()


def program_card_vs_cpu(tag, gpu, path, batch, counts, dev, engines=None):
    """The fp32 uint8 program of the loaded generator ``gpu`` (on the card)
    and of its checkpoint ``path`` on the CPU on ``batch`` with each engine
    (of ``engines``, by default ENGINES): at most U8_MAX_DIFF levels on
    U8_MAX_SHARE of the values (the CPU half through ``cpu_check``),
    FORWARD_LAUNCHES per forward. Returns {engine: the card's output}."""
    from multi_style_transfer_gan_tpu_torch.pipelines import make_batch_fn

    names = ("window_channel_attention", "fused_structural_block",
             "packed_window_channel_attention", "window_relayout")
    outs = {}
    for engine in engines or ENGINES:
        before = counts()
        got = outs[engine] = make_batch_fn(
            gpu, "cyclegan", engine=engine, device=dev)(batch).cpu().numpy()
        launched = [counts()[n] - before[n] for n in names]
        log(f"{tag} {engine} fp32 on the card, {batch.shape} uint8: launches "
            f"per forward (NHWC attention, block, packed attention, "
            f"relayout): {launched}")
        if launched != FORWARD_LAUNCHES[engine]:
            raise AssertionError(f"{tag} {engine}: expected launches "
                                 f"{FORWARD_LAUNCHES[engine]}, got {launched}")

        def finish(ref, got=got, engine=engine):
            dmax, share = u8_diff(got, ref)
            log(f"{tag} {engine} fp32 card vs CPU, {batch.shape} uint8: max "
                f"diff {dmax}, differing share {share:.3e}")
            if (got.shape != batch.shape or dmax > U8_MAX_DIFF
                    or share > U8_MAX_SHARE):
                raise AssertionError(f"{tag} {engine} fp32 program on the "
                                     f"card disagrees with the CPU")

        cpu_check(cpu_program, (path, batch, engine), finish)
    return outs


def stylize_folder(rng, model, dev, work, name, tag):
    """``batch_process`` (bf16, batch 4) with ``model`` on a folder of
    WIDTH_FOLDER_IMAGES JPEGs of mixed sizes under ``work``; every output
    must come back at its image's size. Returns (the folder, {file:
    size})."""
    import contextlib

    import torch
    from PIL import Image

    from multi_style_transfer_gan_tpu_torch.pipelines import batch_process

    src = os.path.join(work, f"{name}_in")
    dst = os.path.join(work, f"{name}_out")
    os.makedirs(src)
    sizes = {}
    for i in range(WIDTH_FOLDER_IMAGES):
        w, h = int(rng.integers(96, 480)), int(rng.integers(96, 480))
        file = f"photo_{i:02d}.jpg"
        Image.fromarray(smooth_images(rng, 1, (w, h))[0]).save(
            os.path.join(src, file), quality=92)
        sizes[file] = (w, h)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        stats = batch_process(model, src, dst, batch_size=4,
                              compute_dtype=torch.bfloat16, device=dev)
    done = 0
    for file, size in sizes.items():
        target = os.path.join(dst, "cyclegan_photo2monet", file)
        if os.path.exists(target):
            with Image.open(target) as img:
                done += img.size == size
    log(f"{tag} batch_process: {done}/{len(sizes)} outputs at their original "
        f"sizes; stats {stats}")
    if done != len(sizes):
        raise AssertionError(f"{tag} batch_process wrote {done}/{len(sizes)} "
                             f"correct outputs")
    return src, sizes


def phase_width_serving(rng, dev, counts, work, widths=WIDTH_CHANNELS):
    """The generators of ``widths`` (c8 and c32; c64 on its own path)
    through the entry points: each written to a ``.pth``
    (``width_checkpoint``) and loaded by ``load_generator`` on the card and
    on the CPU at precision 'highest'; the fp32 uint8 program card vs CPU
    on both engines (``WIDTH_CPU_BATCH`` images at canvas 256; launches per
    forward: 4 attention calls and 1 block, and 5 relayouts on the packed
    engine), packed vs NHWC on the card; the bf16 program's img/s of both
    engines at canvas 256, batch ``RATE_BATCHES``, in turns;
    ``batch_process`` at the widest on a folder of ``WIDTH_FOLDER_IMAGES``
    JPEGs of mixed sizes, and at ``ENTRY_CHANNELS`` (c48, c60, c64) the batch
    CLI, the server and ``direct_transform`` too (``serve_entry_points``).
    Returns {channels: {"parameters", "rates", "weights_gib", "launches"}}:
    weights_gib the device memory of each bf16 engine's weights, launches
    the counts this generator's part of the path made."""
    import torch

    from multi_style_transfer_gan_tpu_torch.pipelines import (
        load_generator, make_batch_fn,
    )

    canvas = CANVASES[0]
    out = {}
    for channels in widths:
        start = counts()
        path = os.path.join(work, f"enhanced_c{channels}.pth")
        n_params = width_checkpoint(path, channels)
        gpu = load_generator(path, precision="highest", device=dev)
        log(f"[width serving] c{channels}: {gpu.kind} c{gpu.channels}, "
            f"{n_params} parameters, {path}")
        batch = np.stack(smooth_images(rng, WIDTH_CPU_BATCH[channels],
                                       (canvas, canvas)))
        outs = program_card_vs_cpu(f"[width serving] c{channels}", gpu,
                                   path, batch, counts, dev)
        clock(f"[width serving] c{channels} card vs CPU")
        dmax, share = u8_diff(outs["packed"], outs["nhwc"])
        log(f"[width serving] c{channels} fp32 packed vs NHWC engine on the "
            f"card: max diff {dmax}, differing share {share:.3e}")
        if dmax > U8_MAX_DIFF or share > U8_MAX_SHARE:
            raise AssertionError(f"c{channels}: packed and NHWC engines "
                                 f"disagree on the card")

        bf16, held = {}, {}
        for e in ENGINES:   # the device memory each engine's weights take
            m0 = torch.cuda.memory_allocated()
            bf16[e] = make_batch_fn(gpu, "cyclegan", engine=e,
                                    compute_dtype=torch.bfloat16, device=dev)
            held[e] = (torch.cuda.memory_allocated() - m0) / 2 ** 30
        log(f"[width serving] c{channels} bf16 weights on the card: NHWC "
            f"{held['nhwc']:.3f} GiB, packed (repacked) {held['packed']:.3f} "
            f"GiB")
        rates = {}
        for n in RATE_BATCHES:
            x = torch.from_numpy(np.stack(smooth_images(
                rng, n, (canvas, canvas)))).to(dev)
            turns = {e: [] for e in ENGINES}
            for e in ENGINES + ENGINES[::-1]:
                turns[e].append(program_rate(bf16[e], x, iters=WIDTH_RATE_ITERS))
            for e in ENGINES:
                rates[(n, e)] = sum(turns[e]) / len(turns[e])
            log(f"[width serving] c{channels} bf16 program, batch {n} at "
                f"canvas {canvas} (device-resident uint8 in and out): NHWC "
                f"{rates[(n, 'nhwc')]:.1f} img/s, packed "
                f"{rates[(n, 'packed')]:.1f} img/s; turns {turns['nhwc']}, "
                f"{turns['packed']}")

        clock(f"[width serving] c{channels} rates")
        if channels == max(widths):
            src, sizes = stylize_folder(rng, gpu, dev, work,
                                        f"widths_c{channels}",
                                        f"[width serving] c{channels}")
            if channels in ENTRY_CHANNELS:
                serve_entry_points(
                    rng, dev, path, src, sizes, work, channels,
                    ENGINES if channels > 64 else ("auto",))
        end = counts()
        out[channels] = {"parameters": n_params, "rates": rates,
                         "weights_gib": held,
                         "launches": {n: end[n] - start[n] for n in end}}
        del gpu, bf16
    return out


def serve_entry_points(rng, dev, path, src, sizes, work, channels,
                       engines=("auto",)):
    """The generator at ``path`` through the user's serving entry points on
    the card: the batch CLI (``--engine`` each of ``engines``, bf16, batch
    4) on the folder ``src`` (its images' ``sizes``), the HTTP server (NHWC
    engine) answering four requests, and the ``direct_transform`` CLI on
    one photo (at its default --size, 256); each writes images of the right
    size."""
    import contextlib

    import torch
    from PIL import Image

    from multi_style_transfer_gan_tpu_torch.cli import (
        batch_process_images, direct_transform,
    )

    sd = torch.load(path, map_location="cpu", weights_only=True)[
        "G_AB_state_dict"]
    models = os.path.join(work, f"entry_models_c{channels}")
    os.makedirs(models)
    torch.save({"G_AB_state_dict": sd, "G_BA_state_dict": sd},
               os.path.join(models, "cyclegan_epoch_200.pth"))
    for engine in engines:
        out = os.path.join(work, f"entry_out_c{channels}_{engine}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = batch_process_images.main([
                "--input_dir", src, "--output_dir", out, "--models_dir",
                models, "--direction", "photo2monet", "--bf16",
                "--batch_size", "4", "--engine", engine])
        done = 0
        for name, size in sizes.items():
            target = os.path.join(out, "cyclegan_photo2monet", name)
            if os.path.exists(target):
                with Image.open(target) as img:
                    done += img.size == size
        log(f"[entry points] c{channels} batch CLI --engine {engine}: exit "
            f"{rc}, {done}/{len(sizes)} outputs at their original sizes; "
            + " | ".join(buf.getvalue().splitlines()))
        if rc != 0 or done != len(sizes):
            raise AssertionError(f"the batch CLI exited {rc} with {done}/"
                                 f"{len(sizes)} correct outputs")
    phase_server(rng, dev, "nhwc", model_path=path)
    photo = os.path.join(work, f"entry_photo_c{channels}.png")
    result = os.path.join(work, f"entry_direct_c{channels}.png")
    Image.fromarray(smooth_images(rng, 1, (400, 300))[0]).save(photo)
    buf = io.StringIO()
    saved, direct_transform.DEVICE = direct_transform.DEVICE, dev.type
    try:
        with contextlib.redirect_stdout(buf):
            rc = direct_transform.main(["--image", photo, "--model", path,
                                        "--output", result])
    finally:
        direct_transform.DEVICE = saved
    size = None
    if os.path.exists(result):
        with Image.open(result) as img:
            size = img.size
    log(f"[entry points] c{channels} direct_transform: exit {rc}, output size {size}; "
        + " | ".join(buf.getvalue().splitlines()))
    if rc != 0 or size != (256, 256):   # its --size default
        raise AssertionError(f"direct_transform exited {rc}, wrote {size}")


# ---------------------------------------------------------------------------
# the c8 and c32 generators trained
# ---------------------------------------------------------------------------

def phase_width_train_kernels(rng, dev, widths=WIDTH_CHANNELS):
    """Rows 11 and 12 at the shapes of a bf16 train step of the generators
    of ``widths`` (c8 and c32; c64 and the padded widths on their own paths,
    the latter row 12 only; ``width_train_kernel_cases``): forward and backward kernel
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
    for channels in widths:
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
        if att:   # none at the padded widths: their attention takes the route
            ms = [sum(per_fwd[st] * times[("attention", st)][i]
                      for st, _ in att) for i in range(5)]
            shapes = [shape for st, shape in att for _ in range(per_fwd[st])]
            b_ms, b_by = bound(*train_mid_work(shapes))
            rec["window_attention_train"] = dict(
                ms=ms[0], plain_ms=ms[1], sdpa_mid_ms=ms[2], device_ms=ms[3],
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=worst["attention"][torch.float32],
                max_abs_err_bf16=worst["attention"][torch.bfloat16],
                shapes=shapes)
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


def fast_vjp_outputs(x, ws, g, dtype, device="cpu"):
    """``window_channel_attention_fast_vjp`` on ``device`` in ``dtype``: y
    and the five gradients of <y, g>, as fp32 numpy. The CPU half of
    :func:`phase_fast_vjp`'s card-vs-CPU check."""
    import torch

    from multi_style_transfer_gan_tpu_torch.ops.kernels import (
        window_channel_attention_fast_vjp,
    )

    args = [torch.from_numpy(np.asarray(a, np.float32)).to(
        device, dtype).requires_grad_(True) for a in [x] + list(ws)]
    y = window_channel_attention_fast_vjp(*args)
    grads = torch.autograd.grad(y, args, torch.from_numpy(g).to(device, dtype))
    return [t.detach().float().cpu().numpy() for t in (y, *grads)]


def phase_fast_vjp(rng, dev, shape=FAST_VJP_SHAPE, check=True):
    """LocalAttention under grad where no training kernel is built (C = 128:
    c32's down2, c64's down1 and up1; C = 256: c64's down2):
    ``window_channel_attention_fast_vjp`` at ``shape``; with ``check``, on
    the three inputs of ``attention_stress_inputs`` (one all-zero window; small
    q and k), fp32 (TF32 off) and bf16, the forward and the five gradients
    of <y, g> on the card against the same Function on the CPU: the forward
    at FP32_TOL and at the bf16 bound; the gradients, which sum over the
    B H W positions (the weights') or over 3C and C channels (x's), at
    TRAIN_GRAD_FP32_TOL in fp32 and BF16_RTOL in bf16, each relative to the
    largest of its tensor (at least 1). Then, bf16 on the random input,
    forward + backward of the route against the plain formulation
    (``window_channel_attention_plain`` in autograd) in turns, the route in
    device time and its peak memory.
    Returns {ms, plain_ms, device_ms, peak_gib, max_abs_err,
    max_rel_grad_err, max_rel_grad_err_bf16, shape}."""
    import torch

    from multi_style_transfer_gan_tpu_torch.ops.kernels import (
        window_channel_attention_fast_vjp, window_channel_attention_plain,
    )

    names = ("y", "dx", "dwqkv", "dbqkv", "dwproj", "dbproj")
    rec = {"shape": shape, "max_abs_err": 0.0, "max_rel_grad_err": 0.0,
           "max_rel_grad_err_bf16": 0.0}
    C = shape[-1]
    for label, x, ws in attention_stress_inputs(rng, shape) if check else ():
        g = rng.standard_normal(shape).astype(np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            card = [torch.from_numpy(t) for t in fast_vjp_outputs(
                x, ws, g, dtype, dev)]

            def finish(cpu, card=card, label=label, dtype=dtype):
                cpu = [torch.from_numpy(t) for t in cpu]
                err, bf16_ok = compare(card[0], cpu[0], dtype)
                fp32 = dtype == torch.float32
                ok = err <= FP32_TOL if fp32 else bf16_ok
                rel = [((a - b).abs().max()
                        / max(1.0, b.abs().max().item())).item()
                       for a, b in zip(card[1:], cpu[1:])]
                ok = ok and max(rel) <= (TRAIN_GRAD_FP32_TOL if fp32
                                         else BF16_RTOL)
                ok = ok and all(bool(torch.isfinite(t).all()) for t in card)
                log(f"[fast vjp] C = {C} route {shape} {label} "
                    f"{str(dtype)[6:]}, card vs CPU: y max|d| {err:.3e}; "
                    f"gradients max|d| relative to their largest " + ", ".join(
                        f"{n} {r:.3e}" for n, r in zip(names[1:], rel)))
                if not ok:
                    raise AssertionError(f"fast-VJP route {label} {dtype}: "
                                         f"card and CPU disagree")
                if fp32:
                    rec["max_abs_err"] = max(rec["max_abs_err"], err)
                    rec["max_rel_grad_err"] = max(rec["max_rel_grad_err"],
                                                  max(rel))
                else:
                    rec["max_rel_grad_err_bf16"] = max(
                        rec["max_rel_grad_err_bf16"], max(rel))

            cpu_check(fast_vjp_outputs, (x, ws, g, dtype), finish)

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
    torch.cuda.reset_peak_memory_stats()
    run(window_channel_attention_fast_vjp)()
    torch.cuda.synchronize()
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[fast vjp] bf16 {shape} forward + backward: route {rec['ms']:.4f} ms "
        f"({rec['device_ms']:.4f} ms device, peak memory "
        f"{rec['peak_gib']:.2f} GiB), plain formulation "
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


def warm_adam(opt):
    """Adam ``opt`` as after one step taken with zero first moments and
    second moments of WARM_ADAM_NU: its next update is linear in the
    gradient. A fresh Adam's first update is lr times the gradient's sign,
    which an element whose gradient is rounding noise turns either way, and
    a loss after it then measures that noise (the CPU tests against JAX
    resume such an Adam for the same reason,
    tests/test_torch_pretrain.py::_write_checkpoint)."""
    import torch

    for group in opt.param_groups:
        for p in group["params"]:
            opt.state[p] = {"step": torch.tensor(1.0),
                            "exp_avg": torch.zeros_like(p),
                            "exp_avg_sq": torch.full_like(p, WARM_ADAM_NU)}


@contextlib.contextmanager
def planted_fault(name):
    """One of PLANTED_FAULTS put into the training path's backward for the
    span of the block: the negative control of the fp32 pretrain check,
    which each must fail. "row 12 dqkv x2" doubles row 12's d(qkv);
    "LocalAttention dx x2" doubles the input gradient of every
    LocalAttention call under grad (row 11's d(qkv) and the fast-VJP
    route's dx)."""
    import importlib

    mods = {m: importlib.import_module(
        f"multi_style_transfer_gan_tpu_torch.ops.kernels.{m}")
        for m in ("window_mhsa_train", "window_attention_train",
                  "window_attention_fast_vjp")}

    def doubled(fn):
        """``fn``, an autograd Function's backward, with its first
        gradient doubled."""
        def backward(ctx, *grads):
            d, *rest = fn(ctx, *grads)
            return (2 * d, *rest)
        return staticmethod(backward)

    if name == "row 12 dqkv x2":
        fns = [mods["window_mhsa_train"]._WindowMHSA]
    elif name == "LocalAttention dx x2":
        fns = [mods["window_attention_train"]._WindowAttentionMid,
               mods["window_attention_fast_vjp"]._FastVJP]
    else:
        raise ValueError(f"no planted fault {name!r}")
    saved = [(fn, fn.backward) for fn in fns]
    for fn in fns:
        fn.backward = doubled(fn.backward)
    try:
        yield
    finally:
        for fn, backward in saved:
            fn.backward = staticmethod(backward)


def sees_fault(what, fault, faulty_rel, rtol):
    """The negative control of the fp32 pretrain check: the card's gradient
    norms under the planted ``fault`` must lie past ``rtol`` from the
    CPU's (``faulty_rel``, ``grad_rel``)."""
    log(f"{what}: under the planted fault {fault!r} the gradient norms lie "
        f"{faulty_rel:.2e} from the CPU's (limit {rtol})")
    if not faulty_rel > rtol:
        raise AssertionError(f"{what}: the check does not see the planted "
                             f"fault {fault!r} ({faulty_rel:.2e} <= {rtol})")


def grad_norms(*modules):
    """The norm of each parameter tensor's gradient in ``modules``, in
    order (0 where it has none), as floats."""
    import torch

    return torch.stack([
        torch.zeros((), dtype=torch.float64) if p.grad is None
        else p.grad.detach().double().norm().cpu()
        for m in modules for p in m.parameters()]).tolist()


def grad_terms(norms, ref):
    """Each tensor's change of gradient norm from ``ref`` to ``norms``,
    relative to its norm in ``ref`` (to GRAD_NORM_FLOOR of the largest norm
    of ``ref`` where it is smaller)."""
    floor = GRAD_NORM_FLOOR * max(ref)
    return [abs(a - b) / max(b, floor) for a, b in zip(norms, ref)]


def grad_rel(norms, ref):
    """How far the gradient norms ``norms`` lie from ``ref``: the largest
    of ``grad_terms``."""
    return max(grad_terms(norms, ref))


def cpu_train_losses(channels, host, kw):
    """The CPU half of :func:`fp32_step_card_vs_cpu`: one fp32 CycleGAN step
    from the same init and warm Adams on the uint8 images ``host`` (numpy),
    its losses."""
    import torch

    from multi_style_transfer_gan_tpu_torch.ops import to_model_range
    from multi_style_transfer_gan_tpu_torch.train import (
        cyclegan_init_state, cyclegan_train_step,
    )

    st = cyclegan_init_state(SEED + 1, channels, 1, device="cpu")
    warm_adam(st.g_opt)
    warm_adam(st.d_opt)
    a, b = (to_model_range(torch.from_numpy(t)) for t in host)
    return {k: float(v) for k, v in cyclegan_train_step(
        st, a, b, compute_dtype=torch.float32, **kw)[1].items()}


def fp32_step_host(channels, size):
    """The uint8 (A, B) pair of :func:`fp32_step_card_vs_cpu` at ``channels``
    and ``size``^2, batch 2, drawn from a generator of the width's own."""
    rng = np.random.default_rng(SEED + channels)
    return [np.stack(smooth_images(rng, 2, (size, size))) for _ in range(2)]


def fp32_step_card_vs_cpu(dev, channels, what, host=None, size=128, **kw):
    """One fp32 CycleGAN step at ``channels`` (``size``^2, batch 2) on the
    card and on the CPU from the same init, warm Adams (``warm_adam``: the
    G losses follow the D phase's update) and uint8 images (``host``, an
    (A, B) pair on the CPU; by default ``fp32_step_host``'s): the five
    losses, relative, at TRAIN_FP32_RTOL (the CPU half through
    ``cpu_check``). The losses read the generators' forward and the D
    phase's backward and update; the generators' backward reaches no loss
    of the step, and the pretrain check holds it
    (``fp32_pretrain_card_vs_cpu``). Returns the card's launches."""
    import torch

    from multi_style_transfer_gan_tpu_torch.ops import kernels as K
    from multi_style_transfer_gan_tpu_torch.ops import to_model_range
    from multi_style_transfer_gan_tpu_torch.train import (
        cyclegan_init_state, cyclegan_train_step,
    )

    if host is None:
        host = [torch.from_numpy(a) for a in fp32_step_host(channels, size)]
    st = cyclegan_init_state(SEED + 1, channels, 1, device=dev)
    warm_adam(st.g_opt)
    warm_adam(st.d_opt)
    a, b = (to_model_range(t.to(dev)) for t in host)
    n0 = sum(k.launches for k in K.KERNELS)
    card = {k: float(v) for k, v in cyclegan_train_step(
        st, a, b, compute_dtype=torch.float32, **kw)[1].items()}
    launched = sum(k.launches for k in K.KERNELS) - n0

    def finish(cpu):
        rel = {k: abs(card[k] - cpu[k]) / abs(cpu[k]) for k in cpu}
        log(f"{what} fp32 c{channels} {host[0].shape[1]}^2 batch 2, card vs "
            f"CPU: {card} vs {cpu}; max relative difference "
            f"{max(rel.values()):.2e}; {launched} kernel launches on the "
            f"card")
        if not max(rel.values()) <= TRAIN_FP32_RTOL:   # NaN fails too
            raise AssertionError(f"{what}: fp32 step on the card disagrees "
                                 f"with the CPU: {rel}")

    cpu_check(cpu_train_losses, (channels, [t.numpy() for t in host], kw),
              finish)
    return launched


def train_width(rng, dev, counts, channels, gen, pretrain_batch=TRAIN_BATCH,
                steps=WIDTH_TIMED_STEPS, fp32_size=128, fp32_pretrain_size=128,
                batch=TRAIN_BATCH):
    """The generator of width ``channels`` trained through the entry points:
    the bf16 CycleGAN step at 256^2, batch ``batch``, pair batching, from
    a seeded fresh init (launches per step against
    WIDTH_TRAIN_LAUNCHES_PER_STEP, finite losses, G, D and u moved, ms/step
    over ``steps`` steps after 3 warm-up, the step's profiler device time
    over WIDTH_PROFILED_STEPS more and the peak memory); at c8 and c64 one bf16
    step with the VGG16 perceptual hook (launches equal to the hookless
    step's); one fp32 step card vs CPU (``fp32_size``^2, batch 2); the
    enhanced bf16 pretrain step at 256^2, batch ``pretrain_batch``
    (launches per step against WIDTH_PRETRAIN_LAUNCHES_PER_STEP, ms/step
    over ``steps``, device idle share from WIDTH_PROFILED_STEPS, peak
    memory) and two fp32 pretrain steps card vs CPU
    (``fp32_pretrain_size``^2, batch 2). Returns {"step_ms",
    "step_device_ms", "step_idle", "step_peak_gib", "pretrain": (ms, device
    ms, idle), "launches"}."""
    import torch

    from multi_style_transfer_gan_tpu_torch.data import random_patch_mask
    from multi_style_transfer_gan_tpu_torch.train import (
        cyclegan_init_state, pretrain_init_state,
    )
    from multi_style_transfer_gan_tpu_torch.train.perceptual import (
        make_extra_g_loss, vgg16_from_torchvision_sd,
    )

    start = counts()
    tag = f"[width train] c{channels}"
    state = cyclegan_init_state(SEED, channels, 1, device=dev)
    before = {n: {k: v.clone() for k, v in getattr(state, n)
                  .state_dict().items()}
              for n in ("G_AB", "G_BA", "D_A", "D_B")}
    step = train_step_runner(state, uint8_pairs(
        rng, 2, batch, WIDTH_TRAIN_SIZE, dev))
    torch.cuda.reset_peak_memory_stats()
    launches_of(step, counts, WIDTH_TRAIN_LAUNCHES_PER_STEP[channels],
                f"{tag} bf16 step")
    for _ in range(2):   # warm-up: 3 steps in all
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        losses = step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1000 / steps
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_dev = device_ms(step, iters=WIDTH_PROFILED_STEPS, warmup=0)
    idle = max(0.0, 1.0 - step_dev / ms)
    vals = {k: float(v) for k, v in losses.items()}
    log(f"{tag} bf16 {WIDTH_TRAIN_SIZE}^2 batch {batch}, pair "
        f"batching: {ms:.2f} ms/step, {batch * 1000 / ms:.1f} image "
        f"pairs/s, device {step_dev:.2f} ms/step (torch.profiler), device "
        f"idle share {idle:.1%} ({card_line()}); losses after "
        f"{state.step} steps {vals}; peak memory {peak:.2f} GiB")
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
    if channels in (min(WIDTH_CHANNELS),) + C64_CHANNELS:
        vgg = vgg16_from_torchvision_sd(random_vgg16_sd(), device=dev)
        hooked = train_step_runner(
            state, uint8_pairs(rng, 1, batch, WIDTH_TRAIN_SIZE, dev),
            extra_g_loss=make_extra_g_loss(vgg))
        vals = {k: float(v) for k, v in launches_of(
            hooked, counts, WIDTH_TRAIN_LAUNCHES_PER_STEP[channels],
            f"{tag} bf16 step with the VGG16 hook").items()}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"{tag}: non-finite hooked losses {vals}")
        del vgg, hooked
    del state, step
    clock(f"{tag} bf16 steps")
    fp32_step_card_vs_cpu(dev, channels, f"{tag} train step", size=fp32_size)
    clock(f"{tag} fp32 step card vs CPU")

    state = pretrain_init_state(SEED, channels, model="enhanced", device=dev)
    size = WIDTH_TRAIN_SIZE
    imgs = [torch.from_numpy(np.stack(smooth_images(
        rng, pretrain_batch, (size, size)))).to(dev) for _ in range(2)]
    masks = [random_patch_mask(pretrain_batch, size, generator=gen,
                               device=dev) for _ in range(2)]
    pstep = pretrain_steps(state, imgs, masks, torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    launches_of(pstep, counts, WIDTH_PRETRAIN_LAUNCHES_PER_STEP[channels],
                f"{tag} enhanced pretrain bf16 step")
    pre = time_pretrain(pstep, f"c{channels} enhanced bf16 {size}^2 "
                        f"batch {pretrain_batch}", pretrain_batch, steps,
                        WIDTH_PROFILED_STEPS)
    pre_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{tag} enhanced pretrain bf16 step peak memory {pre_peak:.2f} GiB")
    del state, pstep
    clock(f"{tag} pretrain steps")
    fp32_pretrain_card_vs_cpu(rng, dev, channels, gen, tag,
                              size=fp32_pretrain_size)
    clock(f"{tag} fp32 pretrain card vs CPU")
    end = counts()
    return {"step_ms": ms, "step_device_ms": step_dev, "step_idle": idle,
            "step_peak_gib": peak, "pretrain": pre, "batch": batch,
            "pretrain_batch": pretrain_batch,
            "pretrain_peak_gib": pre_peak,
            "launches": {n: end[n] - start[n] for n in end}}


def pretrain_losses(channels, host, masks, device="cpu", fault=None):
    """Two fp32 enhanced pretrain steps at ``channels`` from SEED + 1 and a
    warm Adam (``warm_adam``) on ``device``, on the uint8 images ``host``
    and the ``masks`` (numpy), under the planted ``fault`` (or none): the
    losses, the first step's gradient norms (``grad_norms``; clipped as
    the step clips them) and their tensors' names. The CPU half of
    :func:`fp32_pretrain_card_vs_cpu`."""
    import torch

    from multi_style_transfer_gan_tpu_torch.ops import to_model_range
    from multi_style_transfer_gan_tpu_torch.train import (
        pretrain_init_state, pretrain_train_step,
    )

    st = pretrain_init_state(SEED + 1, channels, model="enhanced",
                             device=device)
    warm_adam(st.opt)
    out, norms = [], None
    with planted_fault(fault) if fault else contextlib.nullcontext():
        for x, m in zip(host, masks):
            out.append(float(pretrain_train_step(
                st, to_model_range(torch.from_numpy(x).to(device)),
                torch.from_numpy(m).to(device))[1]))
            norms = norms or grad_norms(st.model)
    return out, norms, [n for n, _ in st.model.named_parameters()]


def fp32_pretrain_card_vs_cpu(rng, dev, channels, gen, tag, size=128):
    """Two fp32 enhanced pretrain steps at ``channels`` (``size``^2, batch
    2) on the card and on the CPU from the same init, images, masks and
    warm Adam (``pretrain_losses``): the losses, relative, at
    PRETRAIN_FP32_RTOL and the first step's gradient norms (``grad_rel``)
    at GRAD_NORM_RTOL (the CPU half through ``cpu_check``). The card's
    half again under each of PLANTED_FAULTS, a wrong backward of a kernel
    the step runs, must land past that limit (``sees_fault``)."""
    from multi_style_transfer_gan_tpu_torch.data import random_patch_mask

    host = [np.stack(smooth_images(rng, 2, (size, size))) for _ in range(2)]
    masks = [random_patch_mask(2, size, generator=gen, device="cpu").numpy()
             for _ in range(2)]
    card, norms, names = pretrain_losses(channels, host, masks, dev)
    faulty = {f: pretrain_losses(channels, host, masks, dev, f)[1]
              for f in PLANTED_FAULTS}

    def finish(cpu_out):
        cpu, cpu_norms, _ = cpu_out
        rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
        terms = grad_terms(norms, cpu_norms)
        grel = max(terms)
        log(f"{tag} enhanced pretrain fp32 {size}^2 batch 2, two steps card "
            f"vs CPU: {card} vs {cpu}; max relative difference {rel:.2e} "
            f"(limit {PRETRAIN_FP32_RTOL}), first step's gradient norms "
            f"{grel:.2e} (limit {GRAD_NORM_RTOL}), farthest "
            f"{names[terms.index(grel)]}")
        if not (rel <= PRETRAIN_FP32_RTOL
                and grel <= GRAD_NORM_RTOL):   # NaN fails too
            raise AssertionError(f"{tag}: fp32 pretrain steps, card and CPU "
                                 f"disagree")
        for fault, fn in faulty.items():
            sees_fault(f"{tag} enhanced pretrain", fault,
                       grad_rel(fn, cpu_norms), GRAD_NORM_RTOL)

    cpu_check(pretrain_losses, (channels, host, masks), finish)


def run_cli(fn, argv, what, tag="[width train]"):
    """One CLI's main(argv), its output logged; raises unless it exits 0
    (None counts as 0, for the scripts whose main returns nothing)."""
    import contextlib

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv) or 0
    log(f"{tag} {what}: exit {rc}, {time.perf_counter() - t0:.2f} "
        f"s wall; its output:")
    for line in buf.getvalue().splitlines():
        log(f"    {line}")
    if rc != 0:
        raise AssertionError(f"{what} exited {rc}")
    return buf.getvalue()


def train_folder(rng, path, n=8, size=256):
    """A trainA / trainB folder of ``n`` smooth JPEGs a domain at ``path``."""
    from PIL import Image

    for domain in ("A", "B"):
        d = os.path.join(path, f"train{domain}")
        os.makedirs(d)
        for i in range(n):
            Image.fromarray(smooth_images(rng, 1, (size, size))[0]).save(
                os.path.join(d, f"{i:02d}.jpg"), quality=92)


def phase_width_train(rng, dev, counts, work):
    """The c8 and c32 generators trained through the entry points
    (``train_width`` for each); the train CLI at --channels 32 and the
    pretrain CLI at --model enhanced --channels 8, one epoch each on a small
    folder; one fp32 step with ``fast_attention=False`` (the CLI's
    --no_fast_attention) card vs CPU at c8 with no kernel launch. Returns
    {channels: train_width's record}."""
    import torch

    from multi_style_transfer_gan_tpu_torch.cli import pretrain as pretrain_cli
    from multi_style_transfer_gan_tpu_torch.cli import train as train_cli

    gen = torch.Generator().manual_seed(SEED + 3)
    out = {channels: train_width(rng, dev, counts, channels, gen)
           for channels in WIDTH_CHANNELS}

    # the entry points at the new widths: one epoch each on a small folder
    data = os.path.join(work, "width_train_data")
    train_folder(rng, data)
    models = os.path.join(work, "width_train_models")
    one_epoch = ["--num_epochs", "1", "--batch_size", "4",
                 "--checkpoint_every", "1", "--log_every", "1"]
    run_cli(train_cli.main, ["--data_root", data, "--save_dir", models,
                             "--channels", str(max(WIDTH_CHANNELS))]
            + one_epoch, f"train --channels {max(WIDTH_CHANNELS)}")
    run_cli(pretrain_cli.main, ["--data_root", data, "--save_dir", models,
                                "--model", "enhanced",
                                "--channels", str(min(WIDTH_CHANNELS))]
            + one_epoch,
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
    return out


def phase_c64_train(rng, dev, counts, work):
    """The c64 generator (the JAX pretrain CLI's default width) trained
    through the entry points: ``train_width`` at c64, its enhanced pretrain
    step at PRETRAIN_BATCH (16, the pretrain CLI's default batch); then the
    chain a user runs at the CLIs' defaults, one epoch each on a small
    folder: ``cli.pretrain --model enhanced`` with no --channels (so c64),
    ``cli.train --channels 64`` from scratch and with ``--pretrained`` on
    that checkpoint (every tensor of both generators warm-started), and
    ``batch_process`` with the trained G_AB through ``load_generator``
    (``--engine auto``, bf16). Returns train_width's record."""
    import torch

    from multi_style_transfer_gan_tpu_torch.cli import pretrain as pretrain_cli
    from multi_style_transfer_gan_tpu_torch.cli import train as train_cli
    from multi_style_transfer_gan_tpu_torch.models import EnhancedGenerator
    from multi_style_transfer_gan_tpu_torch.pipelines import load_generator

    channels = C64_CHANNELS[0]
    gen = torch.Generator().manual_seed(SEED + channels)
    out = train_width(rng, dev, counts, channels, gen,
                      pretrain_batch=PRETRAIN_BATCH)

    data = os.path.join(work, "c64_train_data")
    train_folder(rng, data)
    models = os.path.join(work, "c64_models")
    one_epoch = ["--num_epochs", "1", "--batch_size", "4",
                 "--checkpoint_every", "1", "--log_every", "1"]
    run_cli(pretrain_cli.main, ["--data_root", data, "--save_dir", models,
                                "--model", "enhanced"] + one_epoch,
            "pretrain --model enhanced (no --channels)")
    ckpt = os.path.join(models, "generator_pretrain_epoch_1.pth")
    pre = load_generator(ckpt, device="cpu")
    if (pre.kind, pre.channels) != ("enhanced", channels):
        raise AssertionError(f"the pretrain CLI's default wrote "
                             f"{pre.kind} c{pre.channels}")
    fresh = os.path.join(work, "c64_fresh_models")
    text = run_cli(train_cli.main, ["--data_root", data, "--save_dir", fresh,
                                    "--channels", str(channels)] + one_epoch,
                   f"train --channels {channels}")
    if ("warm start" in text
            or not os.path.exists(os.path.join(fresh, "G_AB_epoch_1.pth"))):
        raise AssertionError("train --channels 64 warm-started or wrote no "
                             "checkpoint")
    text = run_cli(train_cli.main, ["--data_root", data, "--save_dir", models,
                                    "--channels", str(channels),
                                    "--pretrained", ckpt] + one_epoch,
                   f"train --channels {channels} --pretrained <that checkpoint>")
    tensors = 2 * len(EnhancedGenerator(channels, 1).state_dict())
    if f"warm start: {tensors} tensors transferred" not in text:
        raise AssertionError(f"the warm start did not transfer all {tensors} "
                             f"tensors")
    model = load_generator(os.path.join(models, "G_AB_epoch_1.pth"),
                           device=dev)
    if model.channels != channels:
        raise AssertionError(f"the train CLI wrote a c{model.channels} G_AB")
    stylize_folder(rng, model, dev, work, "c64",
                   f"[c64 train] the trained c{channels} G_AB:")
    return out


def phase_grid_small_serving(rng, dev, counts, work):
    """c24, c40 and c56 (``GRID_SMALL_CHANNELS``) served at a small size: each
    written to a ``.pth`` (``width_checkpoint``) and loaded by
    ``load_generator`` on the card and on the CPU at precision 'highest';
    the fp32 uint8 program card vs CPU on both engines at GRID_SMALL_SIZE^2
    (``WIDTH_CPU_BATCH`` images; 4 attention calls and 1 block a forward, 5
    relayouts on the packed engine). Returns {channels: {"parameters",
    "launches"}}."""
    from multi_style_transfer_gan_tpu_torch.pipelines import load_generator

    size = GRID_SMALL_SIZE
    out = {}
    for channels in GRID_SMALL_CHANNELS:
        start = counts()
        path = os.path.join(work, f"enhanced_c{channels}.pth")
        n_params = width_checkpoint(path, channels)
        gpu = load_generator(path, precision="highest", device=dev)
        batch = np.stack(smooth_images(rng, WIDTH_CPU_BATCH[channels],
                                       (size, size)))
        program_card_vs_cpu(f"[grid serving] c{channels}", gpu, path, batch,
                            counts, dev)
        end = counts()
        out[channels] = {"parameters": n_params,
                         "launches": {n: end[n] - start[n] for n in end}}
    return out


def phase_grid_train(rng, dev, counts, work):
    """The padded widths trained through the entry points: c48
    (``GRID_FULL_CHANNELS``) at full width (``train_width``: the bf16
    CycleGAN step with its launches per step, every LocalAttention call on
    the fast-VJP route, the fp32 step card vs CPU, the enhanced pretrain
    step), then ``train --channels 48`` for one epoch on a small folder,
    whose G_AB stylizes through ``batch_process``, and ``pretrain --model
    enhanced --channels 24`` for one epoch; c24, c40 and c56
    (``GRID_SMALL_CHANNELS``) small: one fp32 CycleGAN step and two fp32
    enhanced pretrain steps at 128^2, batch 2, card vs CPU. Returns
    {channels: record}: train_width's for c48, {"launches"} for the
    others."""
    import torch

    from multi_style_transfer_gan_tpu_torch.cli import pretrain as pretrain_cli
    from multi_style_transfer_gan_tpu_torch.cli import train as train_cli
    from multi_style_transfer_gan_tpu_torch.pipelines import load_generator

    gen = torch.Generator().manual_seed(SEED + 24)
    out = {c: train_width(rng, dev, counts, c, gen) for c in GRID_FULL_CHANNELS}

    channels = max(GRID_FULL_CHANNELS)
    data = os.path.join(work, "grid_train_data")
    train_folder(rng, data)
    models = os.path.join(work, "grid_models")
    one_epoch = ["--num_epochs", "1", "--batch_size", "4",
                 "--checkpoint_every", "1", "--log_every", "1"]
    run_cli(train_cli.main, ["--data_root", data, "--save_dir", models,
                             "--channels", str(channels)] + one_epoch,
            f"train --channels {channels}")
    low = min(GRID_CHANNELS)
    run_cli(pretrain_cli.main, ["--data_root", data, "--save_dir", models,
                                "--model", "enhanced", "--channels", str(low)]
            + one_epoch, f"pretrain --model enhanced --channels {low}")
    if not os.path.exists(os.path.join(models,
                                       "generator_pretrain_epoch_1.pth")):
        raise AssertionError("the pretrain CLI wrote no checkpoint")
    model = load_generator(os.path.join(models, "G_AB_epoch_1.pth"),
                           device=dev)
    if model.channels != channels:
        raise AssertionError(f"the train CLI wrote a c{model.channels} G_AB")
    stylize_folder(rng, model, dev, work, "grid",
                   f"[grid train] the trained c{channels} G_AB:")

    for channels in GRID_SMALL_CHANNELS:
        start = counts()
        tag = f"[grid train] c{channels}"
        fp32_step_card_vs_cpu(dev, channels, f"{tag} train step")
        fp32_pretrain_card_vs_cpu(rng, dev, channels, gen, tag)
        end = counts()
        out[channels] = {"launches": {n: end[n] - start[n] for n in end}}
    return out


def phase_block_many_windows(rng, dev, dims=MANY_WINDOW_BLOCK_DIMS,
                             tag="[many windows]"):
    """The bf16 block kernel against its plain version at ``dims``
    (``MANY_WINDOW_BLOCK_DIMS``) on ``MANY_WINDOW_GRID`` (512 windows: every
    block or pair takes several in turn; past dim 512 several chunks of the
    chain's workspace) on ``block_stress_inputs``. Returns {dim: bf16
    max|d|}."""
    import torch

    from multi_style_transfer_gan_tpu_torch.ops import kernels as K
    from multi_style_transfer_gan_tpu_torch.ops.kernels.fused_transformer import (
        default_num_heads,
    )

    out = {}
    for dim in dims:
        heads = default_num_heads(dim)
        worst = 0.0
        for label, host, weights in block_stress_inputs(
                rng, MANY_WINDOW_GRID + (dim,)):
            t = lambda a, dt=torch.bfloat16: torch.from_numpy(
                np.asarray(a, np.float32)).to(dev, dt)
            args = (t(host[0]), t(host[1]), t(host[2], torch.float32),
                    t(host[3], torch.float32))
            kw = {n: t(a) for n, a in weights.items()}
            n0 = K.fused_structural_block.launches
            got = K.fused_structural_block(*args, **kw)
            ref = K.structural_block_plain(*args, **kw)
            torch.cuda.synchronize()
            err, ok = compare(got, ref, torch.bfloat16)
            if not (ok and K.fused_structural_block.launches == n0 + 1
                    and bool(torch.isfinite(got).all())):
                raise AssertionError(
                    f"{tag} fused_structural_block dim {dim} "
                    f"{label} bf16: max|d| {err:.3e} outside tolerance, not "
                    f"finite or not launched")
            worst = max(worst, err)
        out[dim] = worst
        log(f"{tag} fused_structural_block "
            f"{MANY_WINDOW_GRID + (dim,)} ({heads} heads of {dim // heads}): "
            f"bf16 max|d| {worst:.3e} (stress inputs)")
    return out


def phase_any_kernels(rng, dev, attention_widths=ANY_ATTENTION_WIDTHS,
                      block_dims=None, mid_widths=(1, 2, 4), tag="[any widths]"):
    """The kernel variants of the widths that are not multiples of 8, each
    against its plain version in fp32 (TF32 off) and bf16, one launch a
    call: row 1 (NHWC and packed) at every C of ``ANY_ATTENTION_WIDTHS`` on
    ``attention_stress_inputs`` (C % 8 != 0 and C < 8 in the runtime-C
    variant of their layouts, CP = 16 .. 256); row 4 at the dims 4c (from
    48 on, heads in slots of 16 .. 64: the slot kernel in bf16, the FMA
    bodies in fp32; below, and at ``ANY_ODD_DIMS``, the FMA bodies in both) on
    ``block_stress_inputs``, a ragged 12 x 20 grid too; row 12 at the same
    dims in their default_num_heads (slots of 16 .. 64) and row 11 at C = 1,
    2, 4 (padded to 16 in bf16) on ``train_kernel_inputs``, forward and
    backward; the widths are those of ``ANY_KERNEL_CHANNELS``. The grids are ``ANY_KERNEL_GRID``; c4's and c60's full shapes
    are ``phase_width_kernels``'s and ``phase_width_train_kernels``'s.
    Returns {kernel: {width: (fp32 max|d|, bf16 max|d|)}}."""
    import torch

    from multi_style_transfer_gan_tpu_torch.ops import kernels as K
    from multi_style_transfer_gan_tpu_torch.ops.kernels.fused_transformer import (
        default_num_heads,
    )

    dtypes = (torch.float32, torch.bfloat16)
    out = {n: {} for n in ("window_channel_attention",
                           "packed_window_channel_attention",
                           "fused_structural_block", "window_mhsa_train",
                           "window_attention_train")}
    if block_dims is None:
        block_dims = [4 * c for c in ANY_KERNEL_CHANNELS] + list(ANY_ODD_DIMS)
    for C in attention_widths:
        shape = ANY_KERNEL_GRID + (C,)
        for name, fn, plain, packed in (
                ("window_channel_attention", K.window_channel_attention,
                 K.window_channel_attention_plain, False),
                ("packed_window_channel_attention",
                 K.packed_window_channel_attention,
                 K.packed_window_channel_attention_plain, True)):
            worst = {dt: 0.0 for dt in dtypes}
            for label, x, ws in attention_stress_inputs(rng, shape,
                                                        packed=packed):
                for dtype in dtypes:
                    args = [torch.from_numpy(np.asarray(a, np.float32))
                            .to(dev, dtype) for a in [x] + ws]
                    n0 = fn.launches
                    got = fn(*args)
                    ref = plain(*args)
                    torch.cuda.synchronize()
                    err, bf16_ok = compare(got, ref, dtype)
                    ok = ((err <= FP32_TOL if dtype == torch.float32
                           else bf16_ok) and fn.launches == n0 + 1
                          and bool(torch.isfinite(got).all()))
                    if not ok:
                        raise AssertionError(
                            f"{tag} {name} C = {C} {label} {dtype}: "
                            f"max|d| {err:.3e} outside tolerance, not finite "
                            f"or not launched")
                    worst[dtype] = max(worst[dtype], err)
            out[name][C] = tuple(worst[dt] for dt in dtypes)
            log(f"{tag} {name} {shape}: fp32 max|d| "
                f"{worst[torch.float32]:.3e}, bf16 max|d| "
                f"{worst[torch.bfloat16]:.3e} (stress inputs)")

    for dim in block_dims:
        heads = default_num_heads(dim)
        worst = {dt: 0.0 for dt in dtypes}
        for grid in (ANY_KERNEL_GRID + (dim,), (1, 12, 20, dim)):
            for label, host, weights in block_stress_inputs(rng, grid):
                for dtype in dtypes:
                    t = lambda a, dt=dtype: torch.from_numpy(
                        np.asarray(a, np.float32)).to(dev, dt)
                    args = (t(host[0]), t(host[1]), t(host[2], torch.float32),
                            t(host[3], torch.float32))
                    kw = {n: t(a) for n, a in weights.items()}
                    n0 = K.fused_structural_block.launches
                    got = K.fused_structural_block(*args, **kw)
                    ref = K.structural_block_plain(*args, **kw)
                    torch.cuda.synchronize()
                    err, bf16_ok = compare(got, ref, dtype)
                    ok = ((err <= BLOCK_FP32_TOL if dtype == torch.float32
                           else bf16_ok)
                          and K.fused_structural_block.launches == n0 + 1
                          and bool(torch.isfinite(got).all()))
                    if not ok:
                        raise AssertionError(
                            f"{tag} fused_structural_block {grid} "
                            f"{label} {dtype}: max|d| {err:.3e} outside "
                            f"tolerance, not finite or not launched")
                    worst[dtype] = max(worst[dtype], err)
        out["fused_structural_block"][dim] = tuple(worst[dt] for dt in dtypes)
        log(f"{tag} fused_structural_block dim {dim} ({heads} heads of "
            f"{dim // heads}): fp32 max|d| {worst[torch.float32]:.3e}, bf16 "
            f"max|d| {worst[torch.bfloat16]:.3e} (stress inputs, a ragged "
            f"grid too)")

        shape = ANY_KERNEL_GRID + (3 * dim,)
        worst = {dt: 0.0 for dt in dtypes}
        for label, host, g in train_kernel_inputs(rng, "mhsa", shape):
            for dtype in dtypes:
                err, derr, _ = check_train_kernel(
                    tag, "mhsa", "block", shape, heads, label, host,
                    g, dtype, dev, timed=False)
                worst[dtype] = max(worst[dtype], err, derr)
        out["window_mhsa_train"][dim] = tuple(worst[dt] for dt in dtypes)

    for C in mid_widths:
        shape = ANY_KERNEL_GRID + (3 * C,)
        worst = {dt: 0.0 for dt in dtypes}
        for label, host, g in train_kernel_inputs(rng, "attention", shape):
            for dtype in dtypes:
                err, derr, _ = check_train_kernel(
                    tag, "attention", "mid", shape, None, label,
                    host, g, dtype, dev, timed=False)
                worst[dtype] = max(worst[dtype], err, derr)
        out["window_attention_train"][C] = tuple(worst[dt] for dt in dtypes)
    return out


def phase_any_small_serving(rng, dev, counts, work, widths=ANY_SMALL_CHANNELS,
                            size=ANY_SMALL_SIZE, tag="[any serving]",
                            engines=None):
    """The widths of ``widths`` (c12, c20, c28, c44; the widths past 64 pass
    c72, c96, c116 and the NHWC engine alone, whose packed engine's fp32
    weights, 3.1-7.6 GiB on the CPU, would cost the run more than the packed
    kernels' check at c68 and c128 adds) served at ``size``^2 through
    ``load_generator`` on the card and on the CPU at precision 'highest':
    the fp32 uint8 program card vs CPU on both engines or ``engines``
    (``WIDTH_CPU_BATCH`` images; 4 attention calls and 1 block a forward, 5
    relayouts on the packed engine). Returns {channels: {"parameters",
    "launches"}}."""
    from multi_style_transfer_gan_tpu_torch.pipelines import load_generator

    out = {}
    for channels in widths:
        start = counts()
        path = os.path.join(work, f"enhanced_c{channels}.pth")
        n_params = width_checkpoint(path, channels)
        gpu = load_generator(path, precision="highest", device=dev)
        batch = np.stack(smooth_images(rng, WIDTH_CPU_BATCH[channels],
                                       (size, size)))
        program_card_vs_cpu(f"{tag} c{channels}", gpu, path, batch, counts,
                            dev, engines)
        clock(f"{tag} c{channels}")
        end = counts()
        out[channels] = {"parameters": n_params,
                         "launches": {n: end[n] - start[n] for n in end}}
    return out


def phase_any_train(rng, dev, counts, work):
    """The widths that are not multiples of 8 trained through the entry
    points: c4 and c60 (``ANY_FULL_CHANNELS``) at full width
    (``train_width``: the bf16 CycleGAN step with its launches per step, c4
    through row 11 at C = 4, 8, 16, c60 through the route at 60, 120, 240,
    both with row 12; the fp32 step card vs CPU; the enhanced pretrain
    step), then ``train --channels 4`` for one epoch on a small folder,
    whose G_AB stylizes through ``batch_process``, and ``pretrain --model
    enhanced --channels 60`` for one epoch; the widths of
    ``ANY_SMALL_CHANNELS`` small: one fp32 CycleGAN step and two fp32
    enhanced pretrain steps at ANY_SMALL_SIZE^2, batch 2, card vs CPU. Returns
    {channels: record}: train_width's for c4 and c60, {"launches"} for the
    rest."""
    import torch

    from multi_style_transfer_gan_tpu_torch.cli import pretrain as pretrain_cli
    from multi_style_transfer_gan_tpu_torch.cli import train as train_cli
    from multi_style_transfer_gan_tpu_torch.pipelines import load_generator

    gen = torch.Generator().manual_seed(SEED + 1)
    out = {c: train_width(rng, dev, counts, c, gen) for c in ANY_FULL_CHANNELS}

    channels = min(ANY_FULL_CHANNELS)
    data = os.path.join(work, "any_train_data")
    train_folder(rng, data)
    models = os.path.join(work, "any_models")
    one_epoch = ["--num_epochs", "1", "--batch_size", "4",
                 "--checkpoint_every", "1", "--log_every", "1"]
    run_cli(train_cli.main, ["--data_root", data, "--save_dir", models,
                             "--channels", str(channels)] + one_epoch,
            f"train --channels {channels}")
    high = max(ANY_FULL_CHANNELS)
    run_cli(pretrain_cli.main, ["--data_root", data, "--save_dir", models,
                                "--model", "enhanced", "--channels", str(high)]
            + one_epoch, f"pretrain --model enhanced --channels {high}")
    if not os.path.exists(os.path.join(models,
                                       "generator_pretrain_epoch_1.pth")):
        raise AssertionError("the pretrain CLI wrote no checkpoint")
    model = load_generator(os.path.join(models, "G_AB_epoch_1.pth"),
                           device=dev)
    if model.channels != channels:
        raise AssertionError(f"the train CLI wrote a c{model.channels} G_AB")
    stylize_folder(rng, model, dev, work, "any",
                   f"[any train] the trained c{channels} G_AB:")

    for channels in ANY_SMALL_CHANNELS:
        start = counts()
        tag = f"[any train] c{channels}"
        fp32_step_card_vs_cpu(dev, channels, f"{tag} train step",
                              size=ANY_SMALL_SIZE)
        fp32_pretrain_card_vs_cpu(rng, dev, channels, gen, tag,
                                  size=ANY_SMALL_SIZE)
        end = counts()
        out[channels] = {"launches": {n: end[n] - start[n] for n in end}}
    return out


def phase_wide_train(rng, dev, counts, work):
    """The widths past 64 trained through the entry points: c68
    (``WIDE_FULL_CHANNELS``) at full width (``train_width`` over
    WIDE_TIMED_STEPS timed steps: the bf16 CycleGAN step with its launches
    per step, every LocalAttention call through the route (C = 68, 136,
    272) and row 12 at 8 heads of 34, the fp32 step card vs CPU at
    WIDE_SMALL_SIZE^2, the enhanced pretrain step at PRETRAIN_BATCH, the
    pretrain CLI's batch, and two fp32 pretrain steps at 128^2 card vs CPU);
    then ``train --channels 68`` for one epoch on a small folder, whose G_AB
    stylizes through ``batch_process``, and ``train --channels 72
    --no_fast_attention`` for one epoch at WIDE_SMALL_SIZE^2 with no kernel
    launch; the widths of ``WIDE_SMALL_CHANNELS`` small: one fp32 CycleGAN
    step and two fp32 enhanced pretrain steps at WIDE_SMALL_SIZE^2, batch 2,
    card vs CPU (the route at C = 72 .. 512; row 12 at 9 .. 16 heads).
    Returns {channels: record}: train_width's for c68, {"launches"} for the
    rest."""
    import torch

    from multi_style_transfer_gan_tpu_torch.cli import train as train_cli
    from multi_style_transfer_gan_tpu_torch.pipelines import load_generator

    gen = torch.Generator().manual_seed(SEED + 128)
    out = {c: train_width(rng, dev, counts, c, gen,
                          pretrain_batch=PRETRAIN_BATCH,
                          steps=WIDE_TIMED_STEPS, fp32_size=WIDE_SMALL_SIZE)
           for c in WIDE_FULL_CHANNELS}

    data = os.path.join(work, "wide_train_data")
    train_folder(rng, data)
    models = os.path.join(work, "wide_models")
    one_epoch = ["--num_epochs", "1", "--batch_size", "4",
                 "--checkpoint_every", "1", "--log_every", "1"]
    low = min(WIDE_FULL_CHANNELS)
    run_cli(train_cli.main, ["--data_root", data, "--save_dir", models,
                             "--channels", str(low)] + one_epoch,
            f"train --channels {low}")
    model = load_generator(os.path.join(models, "G_AB_epoch_1.pth"),
                           device=dev)
    if model.channels != low:
        raise AssertionError(f"the train CLI wrote a c{model.channels} G_AB")
    stylize_folder(rng, model, dev, work, "wide",
                   f"[wide train] the trained c{low} G_AB:")
    del model
    plain_models = os.path.join(work, "wide_plain_models")
    before = counts()
    run_cli(train_cli.main, ["--data_root", data, "--save_dir", plain_models,
                             "--channels", str(WIDE_SMALL_CHANNELS[0]),
                             "--image_size", str(WIDE_SMALL_SIZE),
                             "--no_fast_attention"] + one_epoch,
            f"train --channels {WIDE_SMALL_CHANNELS[0]} --no_fast_attention")
    if counts() != before:
        raise AssertionError(f"--no_fast_attention launched kernels: "
                             f"{before} -> {counts()}")

    for channels in WIDE_SMALL_CHANNELS:
        start = counts()
        tag = f"[wide train] c{channels}"
        fp32_step_card_vs_cpu(dev, channels, f"{tag} train step",
                              size=WIDE_SMALL_SIZE)
        fp32_pretrain_card_vs_cpu(rng, dev, channels, gen, tag,
                                  size=WIDE_SMALL_SIZE)
        end = counts()
        out[channels] = {"launches": {n: end[n] - start[n] for n in end}}
    return out


# ---------------------------------------------------------------------------
# the widths past 128
# ---------------------------------------------------------------------------

def phase_past_many_windows(rng, dev):
    """The streamed attention, NHWC at ``PAST_MANY_ATTENTION[0]`` and packed
    at ``[1]`` (2048 windows at C = 1024, 576 at C = 2048: two workspace
    chunks each), and the bf16 block chain at ``PAST_MANY_BLOCK_DIMS`` on
    ``MANY_WINDOW_GRID`` (512 windows: 2 to 7 chunks), against their plain
    versions in bf16 on the stress inputs. Returns {"attention": {C: bf16
    max|d|}, "block": {dim: bf16 max|d|}}."""
    import torch

    from multi_style_transfer_gan_tpu_torch.ops import kernels as K

    out = {"attention": {}}
    for shape, packed in zip(PAST_MANY_ATTENTION, (False, True)):
        fn, plain = ((K.packed_window_channel_attention,
                      K.packed_window_channel_attention_plain) if packed
                     else (K.window_channel_attention,
                           K.window_channel_attention_plain))
        worst = 0.0
        for label, x, ws in attention_stress_inputs(rng, shape,
                                                    packed=packed):
            args = [torch.from_numpy(np.asarray(a, np.float32)).to(
                dev, torch.bfloat16) for a in [x] + ws]
            n0 = fn.launches
            got = fn(*args)
            ref = plain(*args)
            torch.cuda.synchronize()
            err, ok = compare(got, ref, torch.bfloat16)
            if not (ok and fn.launches == n0 + 1
                    and bool(torch.isfinite(got).all())):
                raise AssertionError(
                    f"[past 128 many windows] {fn.__name__} {shape} {label} "
                    f"bf16: max|d| {err:.3e} outside tolerance, not finite "
                    f"or not launched")
            worst = max(worst, err)
            del got, ref, args
        out["attention"][shape[-1]] = worst
        log(f"[past 128 many windows] {fn.__name__} {shape}: bf16 max|d| "
            f"{worst:.3e} (stress inputs)")
    out["block"] = phase_block_many_windows(rng, dev, PAST_MANY_BLOCK_DIMS,
                                            "[past 128 many windows]")
    return out


def phase_past_serving(rng, dev, counts, work):
    """The widths past 128 served (``PAST_SERVED_CHANNELS``: c132, c192,
    c256), each written to a ``.pth`` and loaded by ``load_generator`` on
    the card and on the CPU at precision 'highest': the fp32 uint8 program
    card vs CPU on the NHWC engine at PAST_FP32_SIZE^2 (one image; the CPU
    half in the pool) with 4 + 1 launches a forward; at
    ``PAST_PACKED_FP32_CHANNELS`` the fp32 packed engine on the card vs the
    NHWC one (5 relayouts and 4 packed attention calls a forward: c132); the bf16
    program's img/s at canvas 256, batch PAST_RATE_BATCH, in turns, and the
    device memory of each bf16 engine's weights, both engines at c132 and
    c192, the NHWC one at c256 (whose packed engine, 17.6 GiB of bf16
    weights repacked, runs in ``batch_process``'s ``auto``); c256
    also through ``batch_process`` on a folder of mixed sizes (``auto``,
    which builds the packed engine at batch 4) and ``serve_entry_points``
    (the batch CLI with ``--engine nhwc``, the server and
    ``direct_transform``). Returns {channels: {"parameters", "rates",
    "weights_gib", "launches"}}."""
    import torch

    from multi_style_transfer_gan_tpu_torch.pipelines import (
        load_generator, make_batch_fn,
    )

    names = ("window_channel_attention", "fused_structural_block",
             "packed_window_channel_attention", "window_relayout")
    canvas = CANVASES[0]
    out = {}
    for channels in PAST_SERVED_CHANNELS:
        start = counts()
        tag = f"[past 128 serving] c{channels}"
        path = os.path.join(work, f"enhanced_c{channels}.pth")
        n_params = width_checkpoint(path, channels)
        gpu = load_generator(path, precision="highest", device=dev)
        log(f"{tag}: {gpu.kind} c{gpu.channels}, {n_params} parameters")
        batch = np.stack(smooth_images(rng, WIDTH_CPU_BATCH[channels],
                                       (PAST_FP32_SIZE, PAST_FP32_SIZE)))
        nhwc = program_card_vs_cpu(tag, gpu, path, batch, counts, dev,
                                   ("nhwc",))["nhwc"]
        if channels in PAST_PACKED_FP32_CHANNELS:
            before = counts()
            packed = make_batch_fn(gpu, "cyclegan", engine="packed",
                                   device=dev)(batch).cpu().numpy()
            launched = [counts()[n] - before[n] for n in names]
            dmax, share = u8_diff(packed, nhwc)
            log(f"{tag} fp32 packed vs NHWC engine on the card, "
                f"{batch.shape}: launches {launched}, max diff {dmax}, "
                f"differing share {share:.3e}")
            if (launched != FORWARD_LAUNCHES["packed"]
                    or dmax > U8_MAX_DIFF or share > U8_MAX_SHARE):
                raise AssertionError(f"{tag}: packed and NHWC engines "
                                     f"disagree on the card")
            torch.cuda.empty_cache()
        clock(f"{tag} card vs CPU")

        x = torch.from_numpy(np.stack(smooth_images(
            rng, PAST_RATE_BATCH, (canvas, canvas)))).to(dev)
        engines = ENGINES if channels not in PAST_FULL_CHANNELS else ("nhwc",)
        held, turns = {}, {e: [] for e in engines}
        for e in engines:   # one engine on the card at a time
            m0 = torch.cuda.memory_allocated()
            fn = make_batch_fn(gpu, "cyclegan", engine=e,
                               compute_dtype=torch.bfloat16, device=dev)
            held[e] = (torch.cuda.memory_allocated() - m0) / 2 ** 30
            turns[e].append(program_rate(fn, x, iters=3, warmup=1))
            turns[e].append(program_rate(fn, x, iters=3, warmup=0))
            del fn
            torch.cuda.empty_cache()
        rates = {(PAST_RATE_BATCH, e): sum(t) / len(t)
                 for e, t in turns.items()}
        log(f"{tag} bf16 program, batch {PAST_RATE_BATCH} at canvas "
            f"{canvas} (device-resident uint8 in and out): "
            + ", ".join(f"{e} {rates[(PAST_RATE_BATCH, e)]:.2f} img/s (turns "
                        f"{turns[e]}; bf16 weights {held[e]:.3f} GiB)"
                        for e in engines) + f" ({card_line()})")
        del x
        clock(f"{tag} rates")
        if channels in PAST_FULL_CHANNELS:
            src, sizes = stylize_folder(rng, gpu, dev, work,
                                        f"past_c{channels}", tag)
            # the batch CLI on the NHWC engine: stylize_folder's
            # batch_process ran the packed one (auto at batch 4)
            serve_entry_points(rng, dev, path, src, sizes, work, channels,
                               ("nhwc",))
            clock(f"{tag} entry points")
        end = counts()
        out[channels] = {"parameters": n_params, "rates": rates,
                         "weights_gib": held,
                         "launches": {n: end[n] - start[n] for n in end}}
        del gpu
        torch.cuda.empty_cache()
    return out


def phase_past_train(rng, dev, counts, work):
    """c256 (``PAST_FULL_CHANNELS``) trained through the entry points:
    ``train_width`` (the bf16 CycleGAN step at 256^2, batch
    PAST_TRAIN_BATCH, every LocalAttention call on the route up to C =
    1024 over the streamed kernel and row 12 at 32 heads, over
    WIDE_TIMED_STEPS timed steps with its launches, device idle share and
    peak memory; the fp32 step card vs CPU at PAST_FP32_SIZE^2; the
    enhanced bf16 pretrain step at batch PAST_TRAIN_BATCH with its peak
    memory, and two fp32 pretrain steps at PAST_FP32_SIZE^2 card vs CPU);
    then ``train --channels 256`` and ``pretrain --model enhanced
    --channels 256`` for one epoch each on a folder of 8 images a domain at
    256^2 and batch PAST_TRAIN_BATCH, every other flag the CLIs' default,
    each checkpoint loaded back at its width. Returns {channels:
    train_width's record}."""
    import torch

    from multi_style_transfer_gan_tpu_torch.cli import pretrain as pretrain_cli
    from multi_style_transfer_gan_tpu_torch.cli import train as train_cli
    from multi_style_transfer_gan_tpu_torch.pipelines import load_generator

    gen = torch.Generator().manual_seed(SEED + 256)
    out = {c: train_width(rng, dev, counts, c, gen,
                          pretrain_batch=PAST_TRAIN_BATCH,
                          steps=WIDE_TIMED_STEPS, fp32_size=PAST_FP32_SIZE,
                          fp32_pretrain_size=PAST_FP32_SIZE,
                          batch=PAST_TRAIN_BATCH)
           for c in PAST_FULL_CHANNELS}
    data = os.path.join(work, "past_train_data")
    train_folder(rng, data)
    models = os.path.join(work, "past_models")
    one_epoch = ["--num_epochs", "1", "--checkpoint_every", "1",
                 "--log_every", "1", "--batch_size", str(PAST_TRAIN_BATCH)]
    for c in PAST_FULL_CHANNELS:
        tag = f"[past 128 train] c{c}"
        torch.cuda.reset_peak_memory_stats()
        run_cli(train_cli.main, ["--data_root", data, "--save_dir", models,
                                 "--channels", str(c)] + one_epoch,
                f"train --channels {c}", tag)
        model = load_generator(os.path.join(models, "G_AB_epoch_1.pth"),
                               device="cpu")
        if model.channels != c:
            raise AssertionError(f"the train CLI wrote a c{model.channels} "
                                 f"G_AB")
        del model
        run_cli(pretrain_cli.main, ["--data_root", data, "--save_dir",
                                    models, "--model", "enhanced",
                                    "--channels", str(c)] + one_epoch,
                f"pretrain --model enhanced --channels {c}", tag)
        pre = load_generator(os.path.join(
            models, "generator_pretrain_epoch_1.pth"), device="cpu")
        if (pre.kind, pre.channels) != ("enhanced", c):
            raise AssertionError(f"the pretrain CLI wrote {pre.kind} "
                                 f"c{pre.channels}")
        log(f"{tag} the CLIs' peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the data-parallel path: the train and pretrain CLIs under torchrun (NCCL,
# world 1), two gloo ranks sharing the card held against one rank, and the
# batch CLI's --data_parallel over two replicas of the program on the card

DP_RANK_FLAG = "--data-parallel-rank"   # the torchrun child's mode
DP_TRAIN_IMAGES = 24      # a domain: 3 steps of the train CLI's batch of 8
DP_PRETRAIN_IMAGES = 16   # a domain: 1 step a domain at the pretrain CLI's 16
DP_TIMED_STEPS = 10       # a turn of the world-1 step timing
DP_GLOO_SIZE = 128
DP_GLOO_BATCH = 4         # global: 2 a rank
DP_GLOO_POOL = 2          # full within the first step: the pool law samples
DP_LOSS_RTOL = 1e-3       # two ranks vs one, fp32, TF32 off
DP_FOLDER_IMAGES = 16
DP_REPLICA_BATCH = 8      # the batch a replica of the program takes
DP_TIMEOUT = 600          # a stage of the path, once released
DP_WAIT = 3600            # its processes wait at most this for the release
DP_JOBS = [None]          # the path's processes, started by dp_start


@contextlib.contextmanager
def without_process_group():
    """The port's steps run their single-process code for the block (the
    collectives skipped: ``parallel.mesh.active`` false), in the process
    group's process: the plain turns of the world-1 timing."""
    from multi_style_transfer_gan_tpu_torch.parallel import mesh

    active = mesh.active
    mesh.active = lambda: False
    try:
        yield
    finally:
        mesh.active = active


def data_parallel_rank(out_path, work, device="cuda", go=None):
    """The rank of the torchrun job :func:`dp_start` starts (NCCL at world
    1 on the card). Once the process group is up it waits for the file
    ``go`` (phase_data_parallel's signal; at once when None), then runs the
    train CLI at its defaults for one epoch of 3 steps and the pretrain CLI
    at its plain default for 2 steps, rank 0 writing their files under
    ``work``; then the bf16 c16 step (256^2, batch 8, pair batching) timed
    in turns with the process group's collectives and without them, and
    the two phases' gradient all-reduces alone. Writes what it saw to
    ``out_path`` (JSON)."""
    import torch
    import torch.distributed as dist

    from multi_style_transfer_gan_tpu_torch.cli import pretrain as pcli
    from multi_style_transfer_gan_tpu_torch.cli import train as tcli
    from multi_style_transfer_gan_tpu_torch.ops import kernels as K
    from multi_style_transfer_gan_tpu_torch.parallel import mesh
    from multi_style_transfer_gan_tpu_torch.train import cyclegan_init_state

    tcli.DEVICE = pcli.DEVICE = device
    if device == "cpu":   # a rehearsal on the CPU: the CLIs ask for CUDA
        torch.cuda.is_available = lambda: True
    dev = mesh.init_data_parallel(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    try:
        torch.zeros(1, device=dev)   # the context, before the wait
        wait_for(lambda: go is None or os.path.exists(go), "the go file")
        got = {"world": mesh.world_size(), "rank": mesh.rank(),
               "backend": dist.get_backend(), "device": str(dev)}
        K.reset_launch_counts()
        for name, cli, argv in (
                ("train", tcli, ["--data_root", os.path.join(work, "dp_train"),
                                 "--save_dir", os.path.join(work, "dp_models"),
                                 "--num_epochs", "1", "--checkpoint_every", "1",
                                 "--log_every", "1", "--seed", "0"]),
                ("pretrain", pcli, ["--data_root",
                                    os.path.join(work, "dp_pretrain"),
                                    "--save_dir",
                                    os.path.join(work, "dp_models"),
                                    "--num_epochs", "1",
                                    "--checkpoint_every", "1",
                                    "--log_every", "1", "--seed", "0"])):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                got[f"{name}_rc"] = cli.main(argv)
            got[f"{name}_s"] = time.perf_counter() - t0
            got[f"{name}_out"] = buf.getvalue()
        got["launches"] = {k.__name__: k.launches for k in K.KERNELS}

        state = cyclegan_init_state(SEED, 16, 1, device=dev)
        step = train_step_runner(
            state, uint8_pairs(np.random.default_rng(SEED + 31), 2,
                               TRAIN_BATCH, 256, dev), pair_batching=True)

        def turn(collectives):
            with (contextlib.nullcontext() if collectives
                  else without_process_group()):
                for _ in range(2):
                    step()
                sync()
                t0 = time.perf_counter()
                for _ in range(DP_TIMED_STEPS):
                    step()
                sync()
            return (time.perf_counter() - t0) * 1000 / DP_TIMED_STEPS

        plain_a, dp_a, dp_b, plain_b = (turn(c) for c in
                                        (False, True, True, False))
        got["step_ms"] = {"data_parallel": (dp_a + dp_b) / 2,
                          "plain": (plain_a + plain_b) / 2,
                          "turns": [plain_a, dp_a, dp_b, plain_b]}
        grads = [[p.grad for m in pair for p in getattr(state, m).parameters()
                  if p.grad is not None]
                 for pair in (("G_AB", "G_BA"), ("D_A", "D_B"))]
        got["allreduce_elements"] = [sum(g.numel() for g in gs)
                                     for gs in grads]

        def reduce_both():
            for gs in grads:
                mesh.all_reduce_mean_(gs)

        if dev.type == "cuda":
            got["allreduce_ms"] = time_ms(reduce_both)
        with open(out_path, "w") as f:
            json.dump(got, f)
    finally:
        mesh.close_data_parallel()


def off_zero_biases_(*modules, scale=0.01):
    """Every bias of ``modules`` moved off its zero init by N(0, scale)
    draws from a seeded CPU generator. At a zero q/k bias a window of zero
    inputs has q = 0, which the zero-safe L2 normalize keeps at 0 and any
    perturbation turns into a unit vector: there a step's gradients
    follow the convolutions' rounding (as tests/test_torch_parallel_train.py
    finds on the CPU)."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 5)
    with torch.no_grad():
        for m in modules:
            for k, p in m.named_parameters():
                if k.endswith("bias"):
                    p.add_((scale * torch.randn(p.shape, generator=gen))
                           .to(p.device))


def dp_state(dev, gen_seed):
    """The two-rank check's CycleGAN state (fp32, c16, biases off zero,
    warm Adams) and its pools of DP_GLOO_POOL."""
    import torch

    from multi_style_transfer_gan_tpu_torch.train import (
        cyclegan_init_state, pool_init,
    )

    st = cyclegan_init_state(SEED + 3, 16, 1, device=dev)
    off_zero_biases_(st.G_AB, st.G_BA, st.D_A, st.D_B)
    warm_adam(st.g_opt)
    warm_adam(st.d_opt)
    pools = (tuple(pool_init(DP_GLOO_POOL, DP_GLOO_SIZE, device=dev)
                   for _ in range(2)),
             torch.Generator().manual_seed(gen_seed))
    return st, pools


def dp_steps(dev, spec, block):
    """One fp32 CycleGAN step and one plain c64 pretrain step on ``block``
    (a function that takes this rank's block of a global batch; the
    identity for one rank): their losses and gradients (as the ranks
    averaged them), on the CPU. Run with cuDNN's deterministic
    algorithms, so that each side repeats bit for bit: with the default
    ones the generators' gradients at this init differ from run to run by
    2.4e-2 .. 3.6e-2 of a tensor's norm (the same step twice on one
    H100)."""
    import torch

    from multi_style_transfer_gan_tpu_torch.ops import to_model_range
    from multi_style_transfer_gan_tpu_torch.train import (
        cyclegan_train_step, pretrain_init_state, pretrain_train_step,
    )

    def grads_of(*mods):
        return {f"{i}.{k}": p.grad.detach().cpu().clone()
                for i, m in enumerate(mods)
                for k, p in m.named_parameters() if p.grad is not None}

    st, pools = dp_state(dev, SEED + 7)
    a, b = (to_model_range(block(torch.as_tensor(x)).to(dev))
            for x in spec["cyclegan"])
    _, losses, _ = cyclegan_train_step(st, a, b, compute_dtype=torch.float32,
                                       pools=pools)
    out = {"cyclegan": {"losses": {k: float(v) for k, v in losses.items()},
                        "grads": grads_of(st.G_AB, st.G_BA, st.D_A, st.D_B)}}
    pre = pretrain_init_state(SEED + 4, PLAIN_CHANNELS, num_epochs=2,
                              steps_per_epoch=1, device=dev)
    warm_adam(pre.opt)
    x, m = (block(torch.as_tensor(t)).to(dev) for t in spec["pretrain"])
    _, loss = pretrain_train_step(pre, to_model_range(x), m)
    out["pretrain"] = {"losses": {"loss": float(loss)},
                       "grads": grads_of(pre.model),
                       "running": {k: v.detach().cpu().clone() for k, v in
                                   pre.model.state_dict().items()
                                   if k.endswith(("running_mean",
                                                  "running_var"))}}
    return out


def wait_for(ready, what):
    """Poll ``ready()`` until it is true; raise after DP_WAIT seconds."""
    t0 = time.perf_counter()
    while not ready():
        if time.perf_counter() - t0 > DP_WAIT:
            raise TimeoutError(f"no {what} after {DP_WAIT} s")
        time.sleep(0.1)


def dp_gloo_rank(rank, port, spec_path, out_dir, device, go):
    """One of the two gloo ranks of :func:`dp_start`, on ``device`` (both
    on the one card). Once its process group is up it waits for the event
    ``go``, then runs :func:`dp_steps` on its block of the global batches,
    and again with the all-reduce summing instead of averaging (the planted
    fault); writes both and its launches."""
    import torch
    import torch.distributed as dist

    from multi_style_transfer_gan_tpu_torch.ops import kernels as K
    from multi_style_transfer_gan_tpu_torch.parallel import mesh

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True   # see dp_steps
    dist.init_process_group("gloo", rank=rank, world_size=2)
    try:
        spec = torch.load(spec_path, weights_only=True)
        torch.zeros(1, device=dev)   # the context, before the wait
        wait_for(go.is_set, "go event")
        K.reset_launch_counts()
        got = {"steps": dp_steps(dev, spec, mesh.rank_block)}
        got["launches"] = {k.__name__: k.launches for k in K.KERNELS}
        mean = mesh.all_reduce_mean_

        @torch.no_grad()
        def summed(tensors):
            mesh._flat_collective_(list(tensors), dist.all_reduce)

        mesh.all_reduce_mean_ = summed
        try:
            got["summed"] = dp_steps(dev, spec, mesh.rank_block)
        finally:
            mesh.all_reduce_mean_ = mean
        torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def dp_check(what, got, ref):
    """Two ranks' losses (DP_LOSS_RTOL) and averaged gradients' norms,
    tensor by tensor (``grad_rel``: GRAD_NORM_RTOL), against one rank's;
    returns the worst loss and norm gaps and the farthest gradient
    (the difference's norm, relative as ``grad_rel``), and raises past a
    limit. The norms, not the differences: the generators' gradients at
    this init follow the convolutions' rounding, and one rank's batch of
    4 against two of 2 (other cuDNN algorithms) put single tensors up to
    0.15 apart (deterministic algorithms, one H100), their norms 2.2e-2;
    a summed all-reduce doubles every one."""
    loss = max(abs(got["losses"][k] - v) / abs(v)
               for k, v in ref["losses"].items())
    keys = list(ref["grads"])
    norms = grad_rel([got["grads"][k].double().norm().item() for k in keys],
                     [ref["grads"][k].double().norm().item() for k in keys])
    floor = GRAD_NORM_FLOOR * max(ref["grads"][k].norm().item() for k in keys)
    far = max(((got["grads"][k] - ref["grads"][k]).norm().item()
               / max(ref["grads"][k].norm().item(), floor), k) for k in keys)
    if not (loss <= DP_LOSS_RTOL and norms <= GRAD_NORM_RTOL):  # NaN fails
        raise AssertionError(f"{what}: two ranks vs one, losses {loss:.2e} "
                             f"(limit {DP_LOSS_RTOL}), gradient norms "
                             f"{norms:.2e} (limit {GRAD_NORM_RTOL}); the "
                             f"farthest gradient {far[1]} {far[0]:.2e}")
    return loss, norms, far


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_dp_spec(path):
    """The two-rank check's global batches, seeded, to ``path``: two uint8
    (A, B) batches for the CycleGAN step, a uint8 batch and its patch mask
    for the pretrain step."""
    import torch

    rng = np.random.default_rng(SEED + 19)
    shape = (DP_GLOO_BATCH, DP_GLOO_SIZE, DP_GLOO_SIZE)
    keep = (rng.random(shape[:1] + (8, 8)) >= 0.4).astype(np.float32)
    spec = {"cyclegan": [np.stack(smooth_images(rng, DP_GLOO_BATCH,
                                                shape[1:])) for _ in range(2)],
            "pretrain": [np.stack(smooth_images(rng, DP_GLOO_BATCH,
                                                shape[1:])),
                         keep.repeat(DP_GLOO_SIZE // 8, 1)
                         .repeat(DP_GLOO_SIZE // 8, 2)[..., None]]}
    torch.save({k: [torch.from_numpy(np.ascontiguousarray(x)) for x in v]
                for k, v in spec.items()}, path)


def dp_start(dev, work):
    """Start the data-parallel path's processes ahead of it, so that their
    start-up (interpreters, imports, CUDA contexts, process groups) runs
    beside the other paths: ``torchrun --standalone --nproc_per_node=1``
    with this script as its rank (:func:`data_parallel_rank`), and two gloo
    ranks (:func:`dp_gloo_rank`) on the global batches of the two-rank
    check. Each waits for :func:`phase_data_parallel`'s release before it
    touches the card's compute; :func:`dp_stop` ends whatever is left."""
    import multiprocessing

    from multi_style_transfer_gan_tpu_torch.data import write_domains

    rng = np.random.default_rng(SEED + 30)
    train_folder(rng, os.path.join(work, "dp_train"), n=DP_TRAIN_IMAGES)
    write_domains(os.path.join(work, "dp_pretrain"),
                  n_train=DP_PRETRAIN_IMAGES, n_test=1, size=256, seed=SEED)
    jobs = {"go_file": os.path.join(work, "dp_go"),
            "rank_json": os.path.join(work, "dp_rank.json"),
            "spec": os.path.join(work, "dp_spec.pt"),
            "ranks_dir": os.path.join(work, "dp_ranks")}
    write_dp_spec(jobs["spec"])
    os.makedirs(jobs["ranks_dir"], exist_ok=True)
    jobs["torchrun"] = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=1", os.path.abspath(__file__), DP_RANK_FLAG,
         jobs["rank_json"], work, dev.type, jobs["go_file"]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    ctx = multiprocessing.get_context("spawn")
    jobs["go"] = ctx.Event()
    port = free_port()
    jobs["gloo"] = [ctx.Process(target=dp_gloo_rank,
                                args=(r, port, jobs["spec"],
                                      jobs["ranks_dir"], str(dev),
                                      jobs["go"]))
                    for r in range(2)]
    for p in jobs["gloo"]:
        p.start()
    jobs["started"] = time.perf_counter()
    DP_JOBS[0] = jobs


def dp_stop():
    """End the data-parallel path's processes that are still running (a
    run that stopped before the path): the torchrun job's whole process
    group, and the gloo ranks."""
    import signal

    jobs, DP_JOBS[0] = DP_JOBS[0], None
    if jobs is None:
        return
    proc = jobs["torchrun"]
    if proc.poll() is None:
        # SIGTERM first: torchrun's agent then stops its worker, which
        # runs in a process group of its own
        os.killpg(proc.pid, signal.SIGTERM)
        try:
            proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
    proc.communicate()
    for p in jobs["gloo"]:
        if p.is_alive():
            p.kill()
        p.join()


def phase_data_parallel(rng, dev, work):
    """The data-parallel path, its processes started by :func:`dp_start`
    (started here when they are not): (1) the torchrun job, released
    first and alone on the card (:func:`data_parallel_rank`: the train and
    pretrain CLIs over NCCL at world 1, rank 0 writing, then the world-1
    step timing); (2) the two gloo ranks on the card, released after it,
    against one rank on the same global batch, fp32, TF32 off, warm
    Adams, and again under the planted all-sum fault, which must fail the
    check; (3) ``batch_process`` over two replicas of the program on the
    card against one device, bf16, and the batch CLI with
    ``--data_parallel``. Returns the readings and the launches of the
    processes it started."""
    if DP_JOBS[0] is None:
        dp_start(dev, work)
    jobs = DP_JOBS[0]
    head_start = time.perf_counter() - jobs["started"]
    try:
        return dp_released(rng, dev, work, jobs, head_start)
    finally:
        dp_stop()


def dp_released(rng, dev, work, jobs, head_start):
    """The body of :func:`phase_data_parallel`, its processes released."""
    import signal

    import torch
    from PIL import Image

    from multi_style_transfer_gan_tpu_torch.cli.batch_process_images import (
        main as batch_main,
    )
    from multi_style_transfer_gan_tpu_torch.pipelines import (
        batch_process, load_generator,
    )

    # (1) the CLIs under torchrun, NCCL at world 1
    t0 = time.perf_counter()
    with open(jobs["go_file"], "w"):
        pass
    proc = jobs["torchrun"]
    try:
        out, _ = proc.communicate(timeout=DP_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"[data_parallel] torchrun ran past "
                             f"{DP_TIMEOUT} s after its release")
    for line in out.splitlines()[-40:]:
        log(f"    {line}")
    if proc.returncode != 0:
        raise AssertionError(f"[data_parallel] torchrun exited "
                             f"{proc.returncode}")
    torchrun_s = time.perf_counter() - t0
    with open(jobs["rank_json"]) as f:
        rank = json.load(f)
    written = [f"{n}_epoch_1.pth" for n in ("G_AB", "G_BA", "discriminators")]
    written.append("generator_pretrain_epoch_1.pth")
    missing = [n for n in written if not os.path.exists(
        os.path.join(work, "dp_models", n))]
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if (rank["world"], rank["backend"], rank["train_rc"],
            rank["pretrain_rc"]) != (1, backend, 0, 0) or missing:
        raise AssertionError(f"[data_parallel] torchrun run {rank}: missing "
                             f"{missing}")
    if "epoch 1 step 3:" not in rank["train_out"] or \
            "epoch 1 [photo]: mean loss" not in rank["pretrain_out"]:
        raise AssertionError("[data_parallel] the CLIs did not take their "
                             "steps:\n" + rank["train_out"]
                             + rank["pretrain_out"])
    ms = rank["step_ms"]
    share = rank.get("allreduce_ms", float("nan")) / ms["data_parallel"]
    mib = 4 * sum(rank["allreduce_elements"]) / 2**20
    log(f"[data_parallel] torchrun --nproc_per_node=1 ({rank['backend']}, "
        f"world {rank['world']}, {rank['device']}; started {head_start:.1f} "
        f"s ahead, {torchrun_s:.1f} s after its release): train CLI at its "
        f"defaults 3 steps {rank['train_s']:.2f} s, "
        f"pretrain CLI plain c{PLAIN_CHANNELS} 2 steps "
        f"{rank['pretrain_s']:.2f} s (rank 0 wrote {', '.join(written)}); "
        f"launches {rank['launches']}")
    log(f"[data_parallel] {card_line()}; bf16 c16 256^2 batch {TRAIN_BATCH} "
        f"step under torchrun (world 1): {ms['data_parallel']:.2f} ms/step "
        f"with the collectives, {ms['plain']:.2f} ms/step without (turns "
        f"plain, DP, DP, plain: "
        + ", ".join(f"{t:.2f}" for t in ms["turns"])
        + f"; {ms['data_parallel'] / ms['plain'] - 1:+.1%}); the two "
        f"gradient all-reduces alone {rank.get('allreduce_ms', float('nan')):.3f}"
        f" ms ({rank['allreduce_elements'][0]} + "
        f"{rank['allreduce_elements'][1]} fp32 values, {mib:.2f} MiB), "
        f"{share:.2%} of the step")

    # (2) two gloo ranks sharing the card against one rank
    t0 = time.perf_counter()
    jobs["go"].set()
    deterministic = torch.backends.cudnn.deterministic
    try:
        torch.backends.cudnn.deterministic = True   # see dp_steps
        one = dp_steps(dev, torch.load(jobs["spec"], weights_only=True),
                       lambda x: x)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    # (3) while the ranks run: --data_parallel, two replicas of the
    # program on the card (nothing here is timed)
    src = os.path.join(work, "dp_in")
    os.makedirs(src)
    for i, img in enumerate(smooth_images(rng, DP_FOLDER_IMAGES, (256, 256))):
        Image.fromarray(img).save(os.path.join(src, f"dp_{i:02d}.png"))
    model = load_generator(TRAINED, device=dev)
    outs = []
    # one device at a replica's batch: the bf16 program is not the same
    # function at every batch size on the card. The first site that
    # depends on the batch is the first InstanceNorm (``core.norm.in_relu``;
    # packed: ``packed_instance_norm``, then two packed convolutions):
    # its bf16 reductions split by the whole tensor's shape, and 13
    # InstanceNorms carry that last-bit change to up to ~100 levels on a
    # few pixels. That is bf16's conditioning on these weights, not a
    # fault: the bf16 gate holds at every batch (``bf16_batch_sweep``;
    # devtools/batch_invariance.py --bisect)
    for where, batch in (({"device": dev}, DP_REPLICA_BATCH),
                         ({"devices": [dev, dev]}, 2 * DP_REPLICA_BATCH)):
        out = os.path.join(work, f"dp_out_{len(outs)}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            stats = batch_process(model, src, out, batch_size=batch,
                                  compute_dtype=torch.bfloat16, **where)
        if stats["processed"] != DP_FOLDER_IMAGES or \
                "engine=auto -> packed (batch " not in buf.getvalue():
            raise AssertionError(f"[data_parallel] batch_process {where}: "
                                 f"{stats}; {buf.getvalue()}")
        outs.append((stats, os.path.join(out, "cyclegan_photo2monet")))
    d = [np.abs(np.asarray(Image.open(os.path.join(outs[0][1], n)), np.int16)
                - np.asarray(Image.open(os.path.join(outs[1][1], n)),
                             np.int16))
         for n in sorted(os.listdir(outs[0][1]))]
    levels = (max(x.max() for x in d),
              float(np.mean([(x > 0).mean() for x in d])))
    if levels[0] > 1:
        raise AssertionError(f"[data_parallel] two replicas {levels[0]} "
                             f"levels from one device")
    serve = os.path.join(work, "dp_serve")
    os.makedirs(serve)
    shutil.copy(TRAINED, os.path.join(serve, "cyclegan_epoch_200.pth"))
    text = run_cli(batch_main, ["--input_dir", src, "--output_dir",
                                os.path.join(work, "dp_cli_out"),
                                "--models_dir", serve, "--bf16",
                                "--batch_size", "8", "--data_parallel"],
                   "batch CLI --data_parallel", "[data_parallel]")
    if f"data-parallel over {torch.cuda.device_count()} devices" not in text:
        raise AssertionError("the batch CLI did not run data parallel")
    for p in jobs["gloo"]:
        p.join(DP_TIMEOUT)
    if any(p.exitcode != 0 for p in jobs["gloo"]):
        raise AssertionError(f"[data_parallel] gloo ranks exited "
                             f"{[p.exitcode for p in jobs['gloo']]}")
    gloo_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(jobs["ranks_dir"], f"rank{r}.pt"),
                        weights_only=True) for r in range(2)]
    gloo = {}
    for part in ("cyclegan", "pretrain"):
        gloo[part] = dp_check(f"[data_parallel] gloo {part}",
                              ranks[0]["steps"][part], one[part])
        for k, v in ranks[0]["steps"][part]["grads"].items():
            if not torch.equal(v, ranks[1]["steps"][part]["grads"][k]):
                raise AssertionError(f"[data_parallel] gloo {part}: the "
                                     f"ranks' averaged gradient {k} differs")
        try:
            dp_check(f"[data_parallel] gloo {part} all-sum",
                     ranks[0]["summed"][part], one[part])
        except AssertionError as e:
            log(f"[data_parallel] planted all-sum fault caught: {e}")
        else:
            raise AssertionError(f"[data_parallel] gloo {part}: the check "
                                 f"does not see the planted all-sum fault")
    running = max((ranks[0]["steps"]["pretrain"]["running"][k] - v).abs()
                  .max().item()
                  for k, v in one["pretrain"]["running"].items())
    if not running <= 1e-5:
        raise AssertionError(f"[data_parallel] gloo BatchNorm running "
                             f"statistics {running:.2e} from one rank's")
    gloo_launches = {n: sum(r["launches"][n] for r in ranks)
                     for n in ranks[0]["launches"]}
    log(f"[data_parallel] two gloo ranks on {dev} vs one rank, global batch "
        f"{DP_GLOO_BATCH} at {DP_GLOO_SIZE}^2, fp32, TF32 off, cuDNN "
        f"deterministic, warm Adams: "
        + "; ".join(f"{part} losses {r[0]:.2e}, gradient norms {r[1]:.2e} "
                    f"(farthest gradient {r[2][1]} {r[2][0]:.2e})"
                    for part, r in gloo.items())
        + f" (CycleGAN c16 with pools of {DP_GLOO_POOL}, plain "
        f"c{PLAIN_CHANNELS} pretrain with global BatchNorm, running "
        f"statistics {running:.2e}); the ranks' gradients bit-equal; "
        f"{gloo_s:.1f} s with the replicas' check beside them; launches in "
        f"the ranks {gloo_launches}")

    log(f"[data_parallel] batch_process over two replicas on {dev} (batch "
        f"{2 * DP_REPLICA_BATCH}) vs one device (batch {DP_REPLICA_BATCH}), "
        f"--engine auto (packed), bf16, canvas 256: max {levels[0]} "
        f"level(s), {levels[1]:.2%} of values differ")
    return {"step_ms": ms, "allreduce_ms": rank.get("allreduce_ms"),
            "allreduce_share": share, "gloo": gloo, "levels": levels,
            "launches": {n: rank["launches"][n] + gloo_launches[n]
                         for n in gloo_launches}}


# ---------------------------------------------------------------------------
# height-sharded inference (parallel/spatial.py): one image's rows over a
# list of devices, here [the card] * shards

SPATIAL_CASES = ((1024, 2), (1024, 4), (960, 4), (992, 2), (1008, 3))
SPATIAL_FAULT_CASE = (1024, 4)    # the planted faults must fail its check
SPATIAL_PLAIN_CASE = (1024, 4)    # the seeded plain c64 generator
SPATIAL_PLAIN_CHANNELS = 64
SPATIAL_TIMED_SIZE = 2048
SPATIAL_TIMED_SHARDS = (1, 2, 4)  # 1: the unsharded forward
SPATIAL_TIMED_ITERS = 3
# the sharded forward at precision 'default' (TF32) against the unsharded
# one at SPATIAL_TIMED_SIZE, held to SPATIAL_TF32_FACTOR times the distance
# between two unsharded 'default' forwards that differ only in cuDNN's
# algorithms (``spatial_tf32``): TF32 rounds each product to a 10-bit
# mantissa, and 13 InstanceNorms carry a rounding at other shapes to whole
# levels on a few pixels. At 2048^2 (NVIDIA H100 80GB HBM3, 700.00 W) 2 and
# 4 shards read 1.00x the pair's mean |d| and share differing
SPATIAL_TF32_FACTOR = 1.25


def spatial_shapes(size, shards):
    """(the four LocalAttention shard shapes, the block's piece shapes) of
    the trained c16 generator on a size^2 image over ``shards`` row
    shards: down1 / up1 (1, S/2sp, S/2, 32), down2 (1, S/4sp, S/4, 64), up2
    (1, S/sp, S, 16); a piece per shard in which an 8-row window of the
    (S/4)^2 token grid starts (``window_pieces``), at dim 64."""
    from multi_style_transfer_gan_tpu_torch.parallel.spatial import (
        window_pieces,
    )

    s = size // shards
    attention = [(1, s // 2, size // 2, 32), (1, s // 4, size // 4, 64),
                 (1, s // 2, size // 2, 32), (1, s, size, 16)]
    rows = size // 4
    starts = window_pieces([i * rows // shards for i in range(shards + 1)],
                           rows)
    pieces = [(1, hi - lo, size // 4, 64)
              for lo, hi in zip(starts, starts[1:]) if hi > lo]
    return attention, pieces


def phase_spatial_kernels(rng, dev):
    """Rows 1 and 4 vs their plain versions at every shape the sharded
    path gives them (``spatial_shapes`` of SPATIAL_CASES), fp32 with TF32
    off as the path runs: the random stress input at each shape, every
    stress input at the (1008, 3) shapes (a padded last window, 252 token
    columns). Returns the largest |d| of each."""
    import torch

    from multi_style_transfer_gan_tpu_torch.ops.kernels import (
        fused_structural_block, structural_block_plain,
        window_channel_attention, window_channel_attention_plain,
    )

    worst = {"attention": 0.0, "block": 0.0}
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    seen = set()
    for size, shards in SPATIAL_CASES:
        attention, pieces = spatial_shapes(size, shards)
        every = (size, shards) == SPATIAL_CASES[-1]
        for shape in dict.fromkeys(attention):
            if shape in seen:
                continue
            seen.add(shape)
            for label, x, ws in attention_stress_inputs(rng, shape)[
                    :None if every else 1]:
                args = [t(a) for a in [x] + ws]
                err = compare(window_channel_attention(*args),
                              window_channel_attention_plain(*args),
                              torch.float32)[0]
                log(f"[spatial kernels] attention {shape} {label}: max|d| "
                    f"{err:.3e}")
                if not err <= FP32_TOL:
                    raise AssertionError(f"window_channel_attention {shape} "
                                         f"{label}: outside tolerance")
                worst["attention"] = max(worst["attention"], err)
        for shape in dict.fromkeys(pieces):
            if shape in seen:
                continue
            seen.add(shape)
            for label, host, weights in block_stress_inputs(rng, shape)[
                    :None if every else 1]:
                args = (t(host[0]), t(host[1]), t(host[2]), t(host[3]))
                kw = {n: t(a) for n, a in weights.items()}
                got = fused_structural_block(*args, **kw)
                err = compare(got, structural_block_plain(*args, **kw),
                              torch.float32)[0]
                log(f"[spatial kernels] block {shape} {label}: max|d| "
                    f"{err:.3e}")
                if not (err <= BLOCK_FP32_TOL
                        and bool(torch.isfinite(got).all())):
                    raise AssertionError(f"fused_structural_block {shape} "
                                         f"{label}: outside tolerance")
                worst["block"] = max(worst["block"], err)
    return worst


def spatial_local_stats(xs, eps=1e-5):
    """Planted fault: each shard's own InstanceNorm statistics."""
    import torch

    out = []
    for x in xs:
        var, mean = torch.var_mean(x.float(), dim=(2, 3), correction=0,
                                   keepdim=True)
        out.append((mean, torch.rsqrt(var + eps)))
    return out


def spatial_zero_halos(xs, top, bottom):
    """Planted fault: zero rows where the neighbours' rows belong."""
    from multi_style_transfer_gan_tpu_torch.parallel.spatial import take_rows

    return [take_rows([x], -top, x.shape[2] + bottom, x.device) for x in xs]


SPATIAL_FAULTS = {"local statistics": ("instance_norm_stats",
                                       spatial_local_stats),
                  "zero halos": ("halo_rows", spatial_zero_halos)}


def spatial_u8(y):
    """A generator's [-1, 1] output as uint8 levels on the host."""
    import torch

    return torch.clamp(torch.round((y.float() + 1) * 127.5), 0, 255) \
        .to(torch.uint8).cpu().numpy()


def spatial_distance(got, ref):
    """(mean |d| in uint8 levels, share past BF16_GATE_LEVELS, max levels,
    share of values that differ, float max |d|) of the generator output
    ``got`` from ``ref``."""
    a, b = spatial_u8(got), spatial_u8(ref)
    return (*bf16_distance(a, b), *u8_diff(a, b),
            (got.float() - ref.float()).abs().max().item())


def spatial_tf32(model, x, dev, shards):
    """The sharded forward at precision 'default' (TF32; ``model`` loaded
    so) against the unsharded one on the image ``x``, at each of ``shards``,
    held to SPATIAL_TF32_FACTOR times the distance between two unsharded
    'default' forwards that differ only in cuDNN's algorithms: the image
    alone and first in a batch of two (``cudnn.benchmark`` on picks the
    algorithms it runs with off at 2048^2, 0 levels apart). The distance
    is the mean |d| and the share of values that differ, each alone (the
    share past a few levels counts too few values at this size to compare
    two draws); a sharded forward within the fp32 program's limit
    (U8_MAX_DIFF, U8_MAX_SHARE) passes whatever the pair reads. Also
    prints each forward's distance from the unsharded one at 'highest'
    (TF32 off). Raises past the gate; returns {name: distance} with the
    unsharded pair's under "pair" and each sharded one's under its
    shard count."""
    import torch

    from multi_style_transfer_gan_tpu_torch.parallel import spatial
    from multi_style_transfer_gan_tpu_torch.pipelines import load_generator

    ref = model.apply(x)
    outs = {"pair": model.apply(torch.cat([x, torch.flip(x, [2])]))[:1]}
    for n in shards:
        outs[n] = spatial.gather_rows(
            spatial.spatial_apply(model, devices=[dev] * n)(x), dev)
    fp32 = load_generator(TRAINED, precision="highest", device=dev).apply(x)
    log(f"[spatial] c16 {x.shape[1]}^2 'default' (TF32), unsharded from "
        f"'highest': {spatial_distance(ref, fp32)}")
    dist = {}
    for what, y in outs.items():
        dist[what] = spatial_distance(y, ref)
        name = "first in a batch of 2" if what == "pair" else f"{what} shards"
        log(f"[spatial] c16 {x.shape[1]}^2 'default' (TF32), {name}, from "
            f"unsharded (mean |d| levels, share past {BF16_GATE_LEVELS}, max "
            f"levels, share differing, float max|d|): {dist[what]}; from "
            f"unsharded 'highest': {spatial_distance(y, fp32)}")
    limit = [SPATIAL_TF32_FACTOR * dist["pair"][i] for i in (0, 3)]
    for n in shards:
        d = dist[n]
        if not ((d[0] <= limit[0] and d[3] <= limit[1])   # NaN fails too
                or (d[2] <= U8_MAX_DIFF and d[3] <= U8_MAX_SHARE)):
            raise AssertionError(
                f"{n} shards at 'default' lie {d[0]:.4f} levels (mean), "
                f"{d[3]:.4%} of values differing from unsharded, past "
                f"{SPATIAL_TF32_FACTOR} x the unsharded pair's ({limit})")
    return dist


def phase_spatial(rng, dev, counts, work):
    """The height-sharded path on the card, its shards on ``[dev] * sp``
    (the one-card stand-in for sp cards), with deterministic cuDNN: the
    trained c16 generator sharded against its unsharded forward at each of
    SPATIAL_CASES, at precision 'highest' (at most 1 uint8 level on at most
    1% of values; the float max |d| printed) and 'default' (max |d|
    printed; ``spatial_tf32`` holds it at SPATIAL_TIMED_SIZE), with 4 x sp
    attention launches and one block launch a
    non-empty piece per sharded forward and no plain version run; the two
    planted faults, each of which must fail the check at
    SPATIAL_FAULT_CASE; the seeded plain c64 generator sharded against
    unsharded; the unsharded forward and 2 and 4 shards at 2048^2 in
    turns (ms, peak memory); 2 and 4 shards at 'default' there against
    the unsharded forward, held to SPATIAL_TF32_FACTOR times the image
    alone against first in a batch of two (``spatial_tf32``); and
    ``direct_transform --spatial 2``, which on
    one card exits 1 with "need 2 devices, have 1" and on two or more
    matches the unsharded CLI within 1 level. Returns the readings."""
    import contextlib

    import torch
    from PIL import Image

    from multi_style_transfer_gan_tpu_torch.cli import direct_transform
    from multi_style_transfer_gan_tpu_torch.models import (
        enhanced_generator, structural_transformer,
    )
    from multi_style_transfer_gan_tpu_torch.parallel import spatial
    from multi_style_transfer_gan_tpu_torch.pipelines import load_generator

    u8 = spatial_u8

    def image(size):
        """A photo-like size^2 image in [-1, 1] on the card."""
        u = np.array(smooth_images(rng, 1, (size, size))[0], np.float32)
        return torch.from_numpy(u).to(dev)[None] / 127.5 - 1

    def sharded(model, x, shards):
        return spatial.gather_rows(
            spatial.spatial_apply(model, devices=[dev] * shards)(x), dev)

    def check(what, got, ref, strict=True):
        dmax, share = u8_diff(u8(got), u8(ref))
        dfloat = (got.float() - ref.float()).abs().max().item()
        ok = bool(torch.isfinite(got).all()) and got.shape == ref.shape
        within = dmax <= U8_MAX_DIFF and share <= U8_MAX_SHARE
        log(f"[spatial] {what}: float max|d| {dfloat:.3e}, uint8 max "
            f"{dmax}, differing share {share:.3e}")
        if not ok or (strict and not within):
            raise AssertionError(f"{what}: sharded and unsharded disagree")
        return dfloat, dmax, share, within

    # the plain versions the kernels stand in for: none may run on the path
    plain_calls = {"attention": 0, "block": 0}
    patched = ((enhanced_generator, "window_channel_attention_plain",
                "attention"),
               (structural_transformer, "structural_block_plain", "block"))
    saved = [getattr(mod, name) for mod, name, _ in patched]

    def counted(fn, key):
        def call(*a, **kw):
            plain_calls[key] += 1
            return fn(*a, **kw)
        return call

    cudnn = torch.backends.cudnn
    det = cudnn.deterministic
    cudnn.deterministic = True
    for mod, name, key in patched:
        setattr(mod, name, counted(getattr(mod, name), key))
    try:
        models = {p: load_generator(TRAINED, precision=p, device=dev)
                  for p in ("highest", "default")}
        cases = {}
        for size, shards in SPATIAL_CASES:
            x = image(size)
            _, pieces = spatial_shapes(size, shards)
            rec = {}
            for precision, model in models.items():
                ref = model.apply(x)
                before = counts()
                got = sharded(model, x, shards)
                after = counts()
                launched = {n: after[n] - before[n] for n in after}
                want = {"window_channel_attention": 4 * shards,
                        "fused_structural_block": len(pieces)}
                if any(launched[n] != want.get(n, 0) for n in launched):
                    raise AssertionError(f"sharded forward at {size}^2 over "
                                         f"{shards} launched {launched}, "
                                         f"expected {want}")
                rec[precision] = check(
                    f"c16 {size}^2 over {shards} shards, {precision}", got,
                    ref, strict=precision == "highest")
                if (size, shards) == SPATIAL_FAULT_CASE \
                        and precision == "highest":
                    for fault, (name, fn) in SPATIAL_FAULTS.items():
                        keep = getattr(spatial, name)
                        setattr(spatial, name, fn)
                        try:
                            bad = sharded(model, x, shards)
                        finally:
                            setattr(spatial, name, keep)
                        if check(f"planted fault ({fault})", bad, ref,
                                 strict=False)[3]:
                            raise AssertionError(f"the check missed the "
                                                 f"planted fault {fault}")
            cases[size, shards] = rec
        if any(plain_calls.values()):
            raise AssertionError(f"the sharded path ran a plain version: "
                                 f"{plain_calls}")

        size, shards = SPATIAL_PLAIN_CASE
        path = os.path.join(work, "spatial_plain.pth")
        plain_checkpoint(path, SPATIAL_PLAIN_CHANNELS)
        plain = load_generator(path, precision="highest", device=dev)
        x = image(size)
        plain_err = check(f"plain c{SPATIAL_PLAIN_CHANNELS} {size}^2 over "
                          f"{shards} shards, highest", sharded(plain, x, shards),
                          plain.apply(x))
        del plain
    finally:
        for (mod, name, _), fn in zip(patched, saved):
            setattr(mod, name, fn)
        cudnn.deterministic = det

    # cost on one card: unsharded against 2 and 4 shards, in turns (the
    # default precision, cuDNN's default algorithms)
    size = SPATIAL_TIMED_SIZE
    model = models["default"]
    x = image(size)
    runs = {sp: (model.apply if sp == 1 else spatial.spatial_apply(
        model, devices=[dev] * sp)) for sp in SPATIAL_TIMED_SHARDS}
    ms = dict(zip(runs, time_turns(
        *[lambda f=f: f(x) for f in runs.values()],
        timer=lambda fn: time_ms(fn, iters=SPATIAL_TIMED_ITERS, warmup=1))))
    peak = {}
    for sp, f in runs.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        f(x)
        torch.cuda.synchronize()
        peak[sp] = (torch.cuda.max_memory_allocated() - base) / 2**30
    log(f"[spatial] {card_line()}; c16 fp32 (TF32 allowed) {size}^2: "
        + ", ".join(f"{'unsharded' if sp == 1 else f'{sp} shards'} "
                    f"{ms[sp]:.2f} ms, peak {peak[sp]:.3f} GiB over the "
                    f"resident" for sp in runs))
    tf32 = spatial_tf32(model, x, dev, SPATIAL_TIMED_SHARDS[1:])

    # the CLI: --spatial 2 needs two cards
    photo = os.path.join(work, "spatial_photo.png")
    Image.fromarray(smooth_images(rng, 1, (400, 300))[0]).save(photo)
    cards = torch.cuda.device_count()
    outs = {}
    for n in (2, 0) if cards >= 2 else (2,):
        out = os.path.join(work, f"spatial_cli_{n}.png")
        buf, err = io.StringIO(), io.StringIO()
        saved_dev, direct_transform.DEVICE = direct_transform.DEVICE, dev.type
        try:
            with contextlib.redirect_stdout(buf), \
                    contextlib.redirect_stderr(err):
                rc = direct_transform.main([
                    "--image", photo, "--model", TRAINED, "--size", "512",
                    "--precision", "highest", "--spatial", str(n),
                    "--output", out])
        finally:
            direct_transform.DEVICE = saved_dev
        log(f"[spatial] direct_transform --spatial {n}: exit {rc}; "
            + " | ".join((buf.getvalue() + err.getvalue()).splitlines()))
        outs[n] = (rc, out, err.getvalue())
    rc, out, err = outs[2]
    if cards < 2:
        if rc != 1 or f"need 2 devices, have {cards}" not in err \
                or os.path.exists(out):
            raise AssertionError("direct_transform --spatial 2 on one card "
                                 "did not refuse")
        cli = f"exit 1 on {cards} card(s)"
    else:
        if rc != 0 or outs[0][0] != 0:
            raise AssertionError("direct_transform --spatial 2 failed")
        with Image.open(out) as a, Image.open(outs[0][1]) as b:
            dmax, share = u8_diff(np.asarray(a.convert("RGB")),
                                  np.asarray(b.convert("RGB")))
        if dmax > U8_MAX_DIFF or share > U8_MAX_SHARE:
            raise AssertionError("direct_transform --spatial 2 and unsharded "
                                 "disagree")
        cli = f"max {dmax} level(s) from unsharded on {cards} cards"
    return {"cases": cases, "plain": plain_err, "ms": ms, "peak_gib": peak,
            "tf32": tf32, "cli": cli}


# ---------------------------------------------------------------------------
# the trained-model study: docs/TRAINED_STUDY.md's recipe through the port's
# scripts (multi_style_transfer_gan_tpu_torch.scripts)

STUDY_DOMAINS = ["--n_train", "16", "--n_test", "8", "--size", "256",
                 "--seed", "0"]
STUDY_TRAIN = ["--num_epochs", "2", "--channels", "16", "--image_size", "256",
               "--batch_size", "8", "--checkpoint_every", "1"]
STUDY_SELECT = ["--n_val", "4", "--soup_max", "3"]
STUDY_BATCH_RUNS, STUDY_REQUESTS = 6, 24
STUDY_GRID = (1024, 768)   # 4 rows of 256^2 panels, 3 across


def phase_study(dev, counts, work):
    """The study recipe on the card: the synthetic domains (16 training and
    8 test images a domain at 256^2) through ``make_synthetic_domains``,
    the train CLI for 2 epochs at c16 (bf16, a checkpoint an epoch), the
    shipped trained pair staged as epoch 3, ``select_checkpoints`` (every
    forward EVAL_LAUNCHES_PER_FORWARD, timed), its fp32 ``forward_u8`` card
    vs CPU on the shipped pair, the exported soup bit-equal to a host
    recomputation, ``make_sample_grids`` (two 768 x 1024 JPEGs),
    ``run_trained_surface`` with no stage skipped (convert max |d| 0, six
    batch runs with every output written, 24/24 server replies) and
    ``reproduce_quality_study --synthetic``. Returns the select forwards'
    img/s, each surface stage's seconds and the server's numbers."""
    import torch
    from PIL import Image

    from multi_style_transfer_gan_tpu_torch.cli import train as train_cli
    from multi_style_transfer_gan_tpu_torch.pipelines import load_generator
    from multi_style_transfer_gan_tpu_torch.scripts import (
        make_sample_grids, make_synthetic_domains, reproduce_quality_study,
        run_trained_surface, select_checkpoints as sc,
    )
    from multi_style_transfer_gan_tpu_torch.weights import load_pth

    tag = "[study]"
    root = os.path.join(work, "study")
    data, models, selected, surface = (os.path.join(root, n) for n in (
        "domains", "models", "selected", "surface"))
    run_cli(make_synthetic_domains.main, ["--root", data] + STUDY_DOMAINS,
            "make_synthetic_domains", tag)
    run_cli(train_cli.main, ["--data_root", data, "--save_dir", models]
            + STUDY_TRAIN, "train CLI", tag)
    for key in ("AB", "BA"):
        shutil.copy(os.path.join(REPO, "trained", f"G_{key}_selected.pth"),
                    os.path.join(models, f"G_{key}_epoch_3.pth"))

    # select_checkpoints, each forward_u8 call timed and its launches read
    forwards = []
    real = sc.forward_u8

    def timed(model, x, batch=8, **kw):
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(model, x, batch, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        chunks = -(-len(x) // batch)
        launched = {n: k - before[n] for n, k in counts().items()}
        want = {n: EVAL_LAUNCHES_PER_FORWARD.get(n, 0) * chunks
                for n in launched}
        if launched != want:
            raise AssertionError(f"{tag} forward_u8 launched {launched} for "
                                 f"{chunks} forwards, expected {want}")
        forwards.append((len(x), seconds))
        return out

    sc.forward_u8 = timed
    try:
        run_cli(sc.main, ["--models_dir", models, "--data_root", data,
                          "--selected_dir", selected] + STUDY_SELECT,
                "select_checkpoints", tag)
    finally:
        sc.forward_u8 = real
    select_rate = sum(n for n, _ in forwards) / sum(t for _, t in forwards)
    log(f"{tag} select_checkpoints: {len(forwards)} forward_u8 calls of 4 + "
        f"1 launches a forward, {select_rate:.1f} img/s (bf16, 256^2)")

    # the shipped pair's fp32 forward_u8, card vs CPU (TF32 off)
    for key in ("BA", "AB"):
        inputs, _ = sc.make_eval(key, data, 4)
        path = os.path.join(REPO, "trained", f"G_{key}_selected.pth")
        got, want = (sc.forward_u8(load_generator(path, device=d), inputs,
                                   compute_dtype=torch.float32)
                     for d in (dev, "cpu"))
        dmax, share = u8_diff(got, want)
        log(f"{tag} forward_u8 G_{key} fp32 card vs CPU, {inputs.shape}: max "
            f"diff {dmax}, differing share {share:.3e}")
        if got.shape != inputs.shape or dmax > U8_MAX_DIFF \
                or share > U8_MAX_SHARE:
            raise AssertionError(f"{tag} forward_u8 G_{key}: card and CPU "
                                 f"disagree")

    # the export: the soup recomputed on the host from the same files (or the
    # picked epoch's tensors), bit for bit; the shipped pair's val SSIM
    report = json.load(open(os.path.join(selected, "selection_report.json")))
    shipped = json.load(open(os.path.join(REPO, "trained",
                                          "selection_report.json")))
    for key, rec in report["per_direction"].items():
        name = f"G_{key}_state_dict"
        paths = [os.path.join(models, f"G_{key}_epoch_{e}.pth")
                 for e in rec["soup"]["epochs"]]
        want = (sc.soup_state_dict(paths, name) if rec["selected"] == "soup"
                else load_pth(paths[-1])[name])
        got = load_pth(os.path.join(selected, f"G_{key}_epoch_0.pth"))[name]
        if list(got) != list(want) or not all(
                torch.equal(got[k], v) for k, v in want.items()):
            raise AssertionError(f"{tag} G_{key}_epoch_0.pth is not the "
                                 f"host's {rec['selected']}")
        ssim = {r["epoch"]: r["ssim"] for r in rec["curve"]}[3]
        ref = shipped["per_direction"][key]
        log(f"{tag} G_{key}: selected {rec['selected']} (curve "
            f"{rec['curve']}, soup {rec['soup']}), export bit-equal to the "
            f"host's; the shipped pair's val SSIM on the card {ssim} on the "
            f"last 4 of 8 test images, trained/selection_report.json: "
            f"best single {ref['best_single']}, soup {ref['soup']['ssim']}, "
            f"selected {ref['selected']} (another split: for reading)")

    grids = os.path.join(root, "grids")
    run_cli(make_sample_grids.main, ["--selected_dir", selected,
                                     "--data_root", data,
                                     "--output_dir", grids],
            "make_sample_grids", tag)
    for label in ("photo2monet", "monet2photo"):
        with Image.open(os.path.join(
                grids, f"{label}_input_output_truth.jpg")) as img:
            if img.size != STUDY_GRID[::-1] or img.format != "JPEG":
                raise AssertionError(f"{tag} the {label} grid is {img.size} "
                                     f"{img.format}")

    run_cli(run_trained_surface.main, ["--models_dir", selected, "--epoch",
                                       "0", "--data_root", data,
                                       "--output_dir", surface],
            "run_trained_surface", tag)
    summary = json.load(open(os.path.join(surface, "surface_summary.json")))
    n_test = len(os.listdir(os.path.join(data, "testB")))
    serving = summary["serving"]
    if (summary["convert"]["max_delta"] != 0.0
            or len(summary["batch"]) != STUDY_BATCH_RUNS
            or any(r["written"] != n_test for r in summary["batch"])
            or serving["replies"] != STUDY_REQUESTS):
        raise AssertionError(f"{tag} run_trained_surface: {summary}")

    # the smoke writes under a fresh temporary folder: keep it in ``work``
    saved, tempfile.tempdir = tempfile.tempdir, root
    try:
        run_cli(reproduce_quality_study.main, ["--synthetic"],
                "reproduce_quality_study --synthetic", tag)
    finally:
        tempfile.tempdir = saved
    return {"select_img_s": select_rate, "seconds": summary["seconds"],
            "serving": {k: serving[k] for k in (
                "img_s", "latency_p50_s", "latency_p95_s")}}


def main() -> int:
    if sys.argv[1:2] == [DP_RANK_FLAG]:   # torchrun's rank of the DP path
        data_parallel_rank(*sys.argv[2:])
        return 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        return run(work)


def run(work) -> int:
    """Every path and check, in order; ``work`` holds the files the paths
    share (the batch CLI's folders, which the evaluation path compares).
    The CPU halves of the card-vs-CPU checks run in a pool of CPU_WORKERS
    processes started here and stopped on the way out, as are the
    data-parallel path's processes (``dp_start``)."""
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; chip_smoke.py runs on the GPU",
              file=sys.stderr)
        return 1
    _STARTED[0] = time.perf_counter()
    CPU_HALVES[0] = CpuHalves(CPU_WORKERS, CPU_THREADS)
    try:
        return run_paths(work)
    finally:
        dp_stop()
        CPU_HALVES[0].close()
        CPU_HALVES[0] = None


def run_paths(work) -> int:
    """The body of :func:`run`."""
    import torch

    t_start = _STARTED[0]
    mark = clock   # the run's clock at each phase boundary

    card = card_line()
    log(card)  # name, power limit as nvidia-smi prints them
    log(f"torch.cuda.get_device_name(0): {torch.cuda.get_device_name(0)}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    from multi_style_transfer_gan_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    ready = phase_build()
    ready("window_channel_attention", "window_relayout")
    attn_err, attn_times = phase_attention(rng, dev)
    packed_err, packed_times = phase_packed_attention(rng, dev)
    relayout_err, relayout_ms = phase_relayout(rng, dev)
    mark("row 1, 5-7 and 9 phases")
    ready()
    mark("every source built")
    # the data-parallel path's processes start up beside the other paths
    # and wait for its release
    dp_start(dev, work)
    # the evaluation path's files and its FID check's CPU half, computed by
    # the CPU pool meanwhile
    fid_reference_of = cpu_result(fid_reference, (work, EVAL_CPU_IMAGES,
                                                  EVAL_BATCH))
    block_err, block_times = phase_block(rng, dev)
    # the int8 convolution, on its own rng
    int8_err, int8_rows = phase_int8_kernels(np.random.default_rng(SEED + 8),
                                             dev)
    photo_err = phase_photo_kernels(rng, dev)
    attn_err = max(attn_err, photo_err["attention"])
    block_err = max(block_err, photo_err["block"])
    # the height-sharded path's shard and piece shapes, on their own rng
    spatial_err = phase_spatial_kernels(np.random.default_rng(SEED + 20), dev)
    attn_err = max(attn_err, spatial_err["attention"])
    block_err = max(block_err, spatial_err["block"])
    # the width phases draw from their own generator, so that every other
    # phase keeps the inputs it had before them
    width_rng = np.random.default_rng(SEED)
    width_kernels = phase_width_kernels(width_rng, dev)
    # and so do the c64 phases, serving and training
    c64_rng = np.random.default_rng(SEED + 64)
    width_kernels.update(phase_width_kernels(c64_rng, dev, C64_CHANNELS))
    # and so do the padded widths' phases
    grid_rng = np.random.default_rng(SEED + 24)
    width_kernels.update(phase_width_kernels(grid_rng, dev, GRID_CHANNELS))
    # and so do the widths that are not multiples of 8
    any_rng = np.random.default_rng(SEED + 4)
    any_kernels = phase_any_kernels(any_rng, dev)
    width_kernels.update(phase_width_kernels(any_rng, dev, ANY_FULL_CHANNELS))
    mark("serving kernels up to c64")
    # and so do the widths past 64
    wide_rng = np.random.default_rng(SEED + 128)
    wide_kernels = phase_any_kernels(wide_rng, dev, WIDE_ATTENTION_WIDTHS,
                                     WIDE_BLOCK_DIMS, (), "[wide widths]")
    many_windows = phase_block_many_windows(
        np.random.default_rng(SEED + 416), dev)
    width_kernels.update(phase_width_kernels(wide_rng, dev, WIDE_FULL_CHANNELS))
    mark("serving kernels up to c128")
    # and so do the widths past 128
    past_rng = np.random.default_rng(SEED + 256)
    past_kernels = phase_any_kernels(past_rng, dev, PAST_ATTENTION_WIDTHS,
                                     PAST_BLOCK_DIMS, (), "[past 128]")
    past_many = phase_past_many_windows(np.random.default_rng(SEED + 512),
                                        dev)
    width_kernels.update(phase_width_kernels(past_rng, dev,
                                             PAST_FULL_CHANNELS,
                                             stress=False))
    mark("serving kernels")
    train_err, train_times = phase_train_kernels(rng, dev)
    # the c8 and c32 training phases draw from their own generator too
    width_train_rng = np.random.default_rng(SEED + 12)
    width_train_kernels = phase_width_train_kernels(width_train_rng, dev)
    fast_vjp = phase_fast_vjp(width_train_rng, dev)
    c64_train_rng = np.random.default_rng(SEED + 65)
    width_train_kernels.update(
        phase_width_train_kernels(c64_train_rng, dev, C64_CHANNELS))
    c64_fast_vjp = [phase_fast_vjp(c64_train_rng, dev, shape,
                                   check=shape[-1] == 256)
                    for shape in C64_FAST_VJP_SHAPES]
    grid_train_rng = np.random.default_rng(SEED + 25)
    width_train_kernels.update(
        phase_width_train_kernels(grid_train_rng, dev, GRID_CHANNELS))
    grid_fast_vjp = {c: [phase_fast_vjp(grid_train_rng, dev, shape,
                                        check=shape == shapes[-1])
                         for shape in shapes]
                     for c, shapes in GRID_FAST_VJP_SHAPES.items()}
    any_train_rng = np.random.default_rng(SEED + 5)
    width_train_kernels.update(
        phase_width_train_kernels(any_train_rng, dev, ANY_FULL_CHANNELS))
    # c60's down2 under grad, the route at C = 240
    any_fast_vjp = phase_fast_vjp(any_train_rng, dev, ANY_FAST_VJP_SHAPE)
    mark("training kernels up to c64")
    wide_train_rng = np.random.default_rng(SEED + 129)
    width_train_kernels.update(
        phase_width_train_kernels(wide_train_rng, dev, WIDE_FULL_CHANNELS))
    wide_fast_vjp = [phase_fast_vjp(wide_train_rng, dev, shape, check=check)
                     for shape, check in WIDE_FAST_VJP_SHAPES]
    past_train_rng = np.random.default_rng(SEED + 257)
    width_train_kernels.update(
        phase_width_train_kernels(past_train_rng, dev, PAST_FULL_CHANNELS))
    # c256's down2 under grad, the route at C = 1024
    past_fast_vjp = [phase_fast_vjp(past_train_rng, dev, shape, check=check)
                     for shape, check in PAST_FAST_VJP_SHAPES]
    mark("training kernels")
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
                   K.window_channel_attention_stage,
               "int8_conv": K.int8_conv}
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

    mark("before the c64 serving path")
    K.reset_launch_counts()   # the c64 serving path starts here
    width_serving.update(phase_width_serving(c64_rng, dev, counts, work,
                                             C64_CHANNELS))
    c64_serving = counts()    # ...and ends here
    log(f"[c64 serving path] launches: {c64_serving}")
    attention_calls = (c64_serving["window_channel_attention"]
                       + c64_serving["packed_window_channel_attention"])
    if (min(c64_serving[n] for n in serving_kernels) == 0
            or attention_calls != 4 * c64_serving["fused_structural_block"]):
        raise AssertionError(f"c64 serving path launches {c64_serving}: "
                             f"expected every serving kernel, 4 attention "
                             f"calls per block call")

    mark("before the grid serving path")
    K.reset_launch_counts()   # the grid serving path starts here
    width_serving.update(phase_width_serving(grid_rng, dev, counts, work,
                                             GRID_FULL_CHANNELS))
    width_serving.update(phase_grid_small_serving(grid_rng, dev, counts, work))
    grid_serving = counts()   # ...and ends here
    log(f"[grid serving path] launches: {grid_serving}")
    attention_calls = (grid_serving["window_channel_attention"]
                       + grid_serving["packed_window_channel_attention"])
    if (min(grid_serving[n] for n in serving_kernels) == 0
            or attention_calls != 4 * grid_serving["fused_structural_block"]):
        raise AssertionError(f"grid serving path launches {grid_serving}: "
                             f"expected every serving kernel, 4 attention "
                             f"calls per block call")

    mark("before the any-width serving path")
    K.reset_launch_counts()   # the any-width serving path starts here
    width_serving.update(phase_width_serving(any_rng, dev, counts, work,
                                             ANY_FULL_CHANNELS))
    width_serving.update(phase_any_small_serving(any_rng, dev, counts, work))
    any_serving = counts()    # ...and ends here
    log(f"[any-width serving path] launches: {any_serving}")
    attention_calls = (any_serving["window_channel_attention"]
                       + any_serving["packed_window_channel_attention"])
    if (min(any_serving[n] for n in serving_kernels) == 0
            or attention_calls != 4 * any_serving["fused_structural_block"]):
        raise AssertionError(f"any-width serving path launches "
                             f"{any_serving}: expected every serving kernel, "
                             f"4 attention calls per block call")

    mark("serving paths up to c64")
    K.reset_launch_counts()   # the wide serving path starts here
    width_serving.update(phase_width_serving(wide_rng, dev, counts, work,
                                             WIDE_FULL_CHANNELS))
    width_serving.update(phase_any_small_serving(
        wide_rng, dev, counts, work, WIDE_SMALL_CHANNELS, WIDE_SMALL_SIZE,
        "[wide serving]", ("nhwc",)))
    wide_serving = counts()   # ...and ends here
    log(f"[wide serving path] launches: {wide_serving}")
    attention_calls = (wide_serving["window_channel_attention"]
                       + wide_serving["packed_window_channel_attention"])
    if (min(wide_serving[n] for n in serving_kernels) == 0
            or attention_calls != 4 * wide_serving["fused_structural_block"]):
        raise AssertionError(f"wide serving path launches {wide_serving}: "
                             f"expected every serving kernel, 4 attention "
                             f"calls per block call")

    mark("serving paths up to c128")
    K.reset_launch_counts()   # the past-128 serving path starts here
    width_serving.update(phase_past_serving(past_rng, dev, counts, work))
    past_serving = counts()   # ...and ends here
    log(f"[past-128 serving path] launches: {past_serving}")
    attention_calls = (past_serving["window_channel_attention"]
                       + past_serving["packed_window_channel_attention"])
    if (min(past_serving[n] for n in serving_kernels) == 0
            or attention_calls != 4 * past_serving["fused_structural_block"]):
        raise AssertionError(f"past-128 serving path launches {past_serving}"
                             f": expected every serving kernel, 4 attention "
                             f"calls per block call")
    mark("serving paths")

    K.reset_launch_counts()   # the int8 path starts here
    int8_out = phase_int8(np.random.default_rng(SEED + 9), dev, counts, work)
    int8_path = counts()      # ...and ends here
    log(f"[int8 path] launches: {int8_path}")
    if min(int8_path[n] for n in ("int8_conv", "window_channel_attention",
                                  "fused_structural_block")) == 0:
        raise AssertionError(f"int8 path launches {int8_path}: the int8 "
                             f"convolution, the NHWC attention or the block "
                             f"never launched")
    mark("int8 path")

    K.reset_launch_counts()   # the single-image path starts here
    phase_single_image(rng, dev)
    single = counts()         # ...and ends here
    log(f"[single-image path] launches: {single}")
    if min(single[n] for n in ("window_channel_attention",
                               "fused_structural_block")) == 0:
        raise AssertionError(f"single-image path launches {single}: the "
                             f"NHWC attention or the block never launched")

    K.reset_launch_counts()   # the height-sharded path starts here
    sharded = phase_spatial(np.random.default_rng(SEED + 21), dev, counts,
                            work)
    spatial_path = counts()   # ...and ends here
    log(f"[spatial path] launches: {spatial_path}")
    if min(spatial_path[n] for n in ("window_channel_attention",
                                     "fused_structural_block")) == 0:
        raise AssertionError(f"spatial path launches {spatial_path}: the "
                             f"NHWC attention or the block never launched")
    mark("spatial path")

    K.reset_launch_counts()   # the training path starts here
    step_ms = phase_train_step(rng, dev)
    phase_train_cli(rng, dev)
    training = counts()       # ...and ends here
    log(f"[main path: training] launches: {training}")
    if min(training[n] for n in TRAIN_LAUNCHES_PER_STEP) == 0:
        raise AssertionError(f"training path launches {training}: a kernel "
                             f"of the path never launched")

    # the widths past 128 first among the width paths: c256's fp32 steps
    # card vs CPU at 128^2 are the pool's longest CPU halves
    K.reset_launch_counts()   # the past-128 training path starts here
    past_train = phase_past_train(past_train_rng, dev, counts, work)
    past_training = counts()  # ...and ends here
    log(f"[past-128 training path] launches: {past_training}")
    past_step = WIDTH_TRAIN_LAUNCHES_PER_STEP[PAST_FULL_CHANNELS[0]]
    if (min(past_training[n] for n, k in past_step.items() if k) == 0
            or past_training["window_attention_mid_fwd"]):
        raise AssertionError(f"past-128 training path launches "
                             f"{past_training}: a kernel of the path never "
                             f"launched, or row 11 took a width of the route")

    K.reset_launch_counts()   # the c8 and c32 training path starts here
    width_train = phase_width_train(width_train_rng, dev, counts, work)
    width_training = counts()  # ...and ends here
    width_train.update(past_train)
    log(f"[width training path] launches: {width_training}")
    if min(width_training[n] for n in TRAIN_LAUNCHES_PER_STEP) == 0:
        raise AssertionError(f"width training path launches "
                             f"{width_training}: a kernel of the path never "
                             f"launched")

    mark("before the c64 training path")
    K.reset_launch_counts()   # the c64 training path starts here
    width_train[C64_CHANNELS[0]] = phase_c64_train(c64_train_rng, dev, counts,
                                                   work)
    c64_training = counts()   # ...and ends here
    log(f"[c64 training path] launches: {c64_training}")
    if min(c64_training[n] for n in TRAIN_LAUNCHES_PER_STEP) == 0:
        raise AssertionError(f"c64 training path launches {c64_training}: a "
                             f"kernel of the path never launched")

    mark("before the grid training path")
    K.reset_launch_counts()   # the grid training path starts here
    width_train.update(phase_grid_train(grid_train_rng, dev, counts, work))
    grid_training = counts()  # ...and ends here
    log(f"[grid training path] launches: {grid_training}")
    grid_step = WIDTH_TRAIN_LAUNCHES_PER_STEP[GRID_FULL_CHANNELS[0]]
    if (min(grid_training[n] for n, k in grid_step.items() if k) == 0
            or grid_training["window_attention_mid_fwd"]):
        raise AssertionError(f"grid training path launches {grid_training}: "
                             f"a kernel of the path never launched, or row "
                             f"11 took a width of the route")

    mark("before the any-width training path")
    K.reset_launch_counts()   # the any-width training path starts here
    width_train.update(phase_any_train(any_train_rng, dev, counts, work))
    any_training = counts()   # ...and ends here
    log(f"[any-width training path] launches: {any_training}")
    if min(any_training[n] for n in TRAIN_LAUNCHES_PER_STEP) == 0:
        raise AssertionError(f"any-width training path launches "
                             f"{any_training}: a kernel of the path never "
                             f"launched")

    mark("training paths up to c64")
    K.reset_launch_counts()   # the wide training path starts here
    width_train.update(phase_wide_train(wide_train_rng, dev, counts, work))
    wide_training = counts()  # ...and ends here
    log(f"[wide training path] launches: {wide_training}")
    wide_step = WIDTH_TRAIN_LAUNCHES_PER_STEP[GRID_CHANNELS[0]]   # the route
    if (min(wide_training[n] for n, k in wide_step.items() if k) == 0
            or wide_training["window_attention_mid_fwd"]):
        raise AssertionError(f"wide training path launches {wide_training}: "
                             f"a kernel of the path never launched, or row "
                             f"11 took a width of the route")

    mark("training paths")

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
    fid_err, fids, fid_timing = phase_fid(dev, counts, work,
                                          fid_reference_of)
    folder_err = phase_folders(dev, work)
    evaluation = counts()     # ...and ends here
    log(f"[evaluation path] launches: {evaluation}")
    if evaluation["window_channel_attention"] == 0 or any(
            evaluation[n] != EVAL_LAUNCHES_PER_FORWARD.get(n, 0)
            * evaluation["fused_structural_block"] for n in evaluation):
        raise AssertionError(f"evaluation path launches {evaluation}: "
                             f"expected 4 NHWC attention calls per block "
                             f"call and no other kernel")

    K.reset_launch_counts()   # the study path starts here
    study = phase_study(dev, counts, work)
    studied = counts()        # ...and ends here
    log(f"[study path] launches: {studied}")
    if min(studied[n] for n in list(TRAIN_LAUNCHES_PER_STEP)
           + serving_kernels) == 0:
        raise AssertionError(f"study path launches {studied}: a kernel of "
                             f"the path never launched")
    mark("study path")

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

    K.reset_launch_counts()   # the data-parallel path starts here
    data_parallel = phase_data_parallel(np.random.default_rng(SEED + 31),
                                        dev, work)
    dp_here = counts()        # ...and ends here, with its ranks' launches
    dp_path = {n: dp_here[n] + data_parallel["launches"][n] for n in counted}
    log(f"[data-parallel path] launches (this process and its ranks): "
        f"{dp_path}")
    if min(dp_path[n] for n in list(TRAIN_LAUNCHES_PER_STEP)
           + serving_kernels) == 0:
        raise AssertionError(f"data-parallel path launches {dp_path}: a "
                             f"kernel of the path never launched")
    mark("data-parallel path")

    K.reset_launch_counts()   # the ablation path starts here
    phase_ablation()
    ablation = counts()       # ...and ends here
    log(f"[ablation path] launches: {ablation}")
    if ablation["window_channel_attention_stage"] == 0:
        raise AssertionError(f"ablation path launches {ablation}: the stage "
                             f"kernel never launched")
    settle_cpu_halves()   # every CPU half compared before the report
    launches = {n: serving[n] + widths[n] + c64_serving[n] + grid_serving[n]
                + any_serving[n] + wide_serving[n] + past_serving[n]
                + int8_path[n] + single[n] + spatial_path[n] + training[n]
                + width_training[n] + c64_training[n] + grid_training[n]
                + any_training[n] + wide_training[n] + past_training[n]
                + pretraining[n]
                + evaluation[n] + studied[n] + gui[n] + perceptual[n]
                + dp_path[n] + ablation[n] for n in counted}
    mark("all paths")

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
        # no PyTorch call computes an int8 convolution: the bf16 cuDNN
        # convolution and _int_mm stand beside it in the entry
        "int8_conv": (int8_bound(*[sum(w) for w in zip(*(
            int8_work(spec, shape, mode)
            for _, spec, shape, mode in int8_sites(16, canvas)))]),
            None, None),
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
         "source": f"{pkg}/fused_structural_block.cu; "
                   f"{pkg}/fused_structural_block_pair.cu; "
                   f"{pkg}/fused_structural_block_stream.cu",
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
        {"name": "int8_conv", "route": "cuda",
         "source": f"{pkg}/int8_conv.cu",
         "replaces": "XLA int8 convolutions (no Pallas kernel): "
                     "multi_style_transfer_gan_tpu/models/"
                     "quantized_generator.py:86-106",
         "launches": launches["int8_conv"],
         "max_abs_err": int8_err,
         "ms": sum(r["ms"] for r in int8_rows.values()),
         "plain_ms": sum(r["plain_ms"] for r in int8_rows.values()),
         "cudnn_bf16_ms": sum(r["cudnn_bf16_ms"] for r in int8_rows.values()),
         "int_mm_ms": sum(r["int_mm_ms"] for r in int8_rows.values()),
         "sites": int8_rows},
    ]}
    # per generator width: the serving kernels at c16 (this entry's own
    # numbers, launches of every path but the four width paths) and at c8,
    # c32 and c64 (phase_width_kernels at their canvas-256 forward, launches
    # of the width or c64 serving path, and of the width or c64 training
    # path beside them); the training kernels alike
    # (phase_width_train_kernels per generator forward and backward at
    # 256^2, launches of the width or c64 training path)
    width_paths = {n: widths[n] + c64_serving[n] + grid_serving[n]
                   + any_serving[n] + wide_serving[n] + past_serving[n]
                   for n in counted}
    width_train_paths = {n: width_training[n] + c64_training[n]
                         + grid_training[n] + any_training[n]
                         + wide_training[n] + past_training[n]
                         for n in counted}
    all_widths = (WIDTH_CHANNELS + C64_CHANNELS + GRID_CHANNELS
                  + ANY_FULL_CHANNELS + WIDE_FULL_CHANNELS
              + PAST_FULL_CHANNELS)
    any_rows = {"window_channel_attention": "window_channel_attention",
                "packed_window_channel_attention":
                    "packed_window_channel_attention",
                "fused_structural_block": "fused_structural_block",
                "window_attention_train": "window_attention_train",
                "window_mhsa_train": "window_mhsa_train"}
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
                "launches": entry["launches"] - width_paths[name]
                - width_train_paths[name]}}
            for c in all_widths:
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
                "launches": entry["launches"] - ran(width_train_paths)}}
            for c in all_widths:
                if name not in width_train_kernels[c]:   # the route's widths
                    continue
                rec = width_train_kernels[c][name]
                entry["widths"][f"c{c}"] = {
                    **{k: rec.get(k) for k in width_keys + (
                        "max_abs_err_bf16", "sdpa_mid_ms", "heads", "shapes")
                       if k in rec},
                    "launches": ran(width_train[c]["launches"])}
        if name in any_rows:
            # the variants of the widths that are not multiples of 8
            # (phase_any_kernels): fp32 and bf16 max|d| by width, and the
            # launches of c4, c12, .., c60 on their serving and training
            # paths (c12 .. c52 at ANY_SMALL_SIZE)
            entry["any_widths"] = {
                str(w): {"max_abs_err": e32, "max_abs_err_bf16": e16}
                for w, (e32, e16) in any_kernels[any_rows[name]].items()}
            # and those of the widths past 64 (C = 257 .. 512, dims 260 ..
            # 512), with the launches of c72, c96 and c116 at
            # WIDE_SMALL_SIZE
            entry["wide_widths"] = {
                str(w): {"max_abs_err": e32, "max_abs_err_bf16": e16}
                for w, (e32, e16) in wide_kernels[any_rows[name]].items()}
            # and those of the widths past 128 (C = 516 .. 2048, dims 528 ..
            # 2048, heads of 33 .. 127), with the launches of c132 and c192
            entry["past_widths"] = {
                str(w): {"max_abs_err": e32, "max_abs_err_bf16": e16}
                for w, (e32, e16) in past_kernels[any_rows[name]].items()}
            if name == "fused_structural_block":
                # bf16 on a grid of more windows than resident blocks, and
                # past dim 512 than one chunk of the chain's workspace
                entry["many_windows_bf16"] = {
                    str(d): e for d, e in many_windows.items()}
                entry["past_many_windows_bf16"] = {
                    str(d): e for d, e in past_many["block"].items()}
            if name in ("window_channel_attention",
                        "packed_window_channel_attention"):
                entry["past_many_windows_bf16"] = {
                    str(c): e for c, e in past_many["attention"].items()}
            ran = train_rows.get(name, (name,))
            for c in (ANY_SMALL_CHANNELS + WIDE_SMALL_CHANNELS
                      + PAST_SERVED_CHANNELS[:-1]):
                entry["widths"][f"c{c}"] = {
                    "launches": sum(width_serving[c]["launches"][n]
                                    for n in ran),
                    "training_launches": sum(
                        width_train[c]["launches"][n] for n in ran)
                    if c in width_train else 0}
        if name == "window_channel_attention":
            # c32's down2 under grad: this kernel forward, the backward
            # recomputed through the plain version (fwd + bwd at batch 8);
            # c64's down2 (C = 256) and down1 / up1 (C = 128 on 128^2)
            entry["fast_vjp_c128"] = fast_vjp
            entry["fast_vjp_c64"] = c64_fast_vjp
            entry["fast_vjp_grid"] = {f"c{c}": recs
                                      for c, recs in grid_fast_vjp.items()}
            entry["fast_vjp_c60"] = any_fast_vjp
            # c128's down2 (C = 512; checked on a small grid) and c68's
            # (C = 272)
            entry["fast_vjp_wide"] = wide_fast_vjp
            # c256's down2 (C = 1024; checked on a small grid)
            entry["fast_vjp_past"] = past_fast_vjp
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
    for c in (WIDTH_CHANNELS + C64_CHANNELS + GRID_FULL_CHANNELS
              + ANY_FULL_CHANNELS + WIDE_FULL_CHANNELS
              + PAST_FULL_CHANNELS):
        log(f"[summary] {card}; c{c} generator "
            f"({width_serving[c]['parameters']} parameters; bf16 weights "
            + ", ".join(f"{e} {g:.3f} GiB" for e, g in
                        width_serving[c]['weights_gib'].items())
            + ") bf16 program img/s at canvas 256: "
            + ", ".join(f"batch {n} {e} {r:.1f}"
                        for (n, e), r in width_serving[c]["rates"].items())
            + "; kernels per forward at canvas 256, batch "
            f"{BATCH}, bf16: "
            + "; ".join(f"{n} {r['ms']:.4f} ms ({r['device_ms']:.4f} ms "
                        f"device, plain {r['plain_ms']:.4f} ms, bound "
                        f"{r['bound_ms']:.6f} ms by {r['bound_by']})"
                        for n, r in width_kernels[c].items()))
    for c in PAST_SERVED_CHANNELS[:-1]:
        log(f"[summary] {card}; c{c} generator "
            f"({width_serving[c]['parameters']} parameters; bf16 weights "
            + ", ".join(f"{e} {g:.3f} GiB" for e, g in
                        width_serving[c]['weights_gib'].items())
            + ") bf16 program img/s at canvas 256: "
            + ", ".join(f"batch {n} {e} {r:.2f}"
                        for (n, e), r in width_serving[c]["rates"].items()))
    for c in (WIDTH_CHANNELS + C64_CHANNELS + GRID_FULL_CHANNELS
              + ANY_FULL_CHANNELS + WIDE_FULL_CHANNELS
              + PAST_FULL_CHANNELS):
        t = width_train[c]
        rows = width_train_kernels[c]
        log(f"[summary] {card}; c{c} training: bf16 CycleGAN step 256^2 batch "
            f"{t['batch']} {t['step_ms']:.2f} ms/step "
            f"({t['batch'] * 1000 / t['step_ms']:.1f} image pairs/s; "
            f"{t['step_device_ms']:.2f} ms device, idle {t['step_idle']:.1%}, "
            f"peak memory {t['step_peak_gib']:.2f} GiB; pretrain peak "
            f"{t['pretrain_peak_gib']:.2f} GiB); enhanced "
            f"pretrain step bf16 256^2 batch {t['pretrain_batch']} "
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
    c64 = width_train[C64_CHANNELS[0]]
    fwd_ms = c64_fast_vjp[0]["ms"] + 2 * c64_fast_vjp[1]["ms"]
    fwd_dev = c64_fast_vjp[0]["device_ms"] + 2 * c64_fast_vjp[1]["device_ms"]
    log(f"[summary] {card}; c64's route under grad, fwd + bwd at batch 8, "
        f"bf16: down2 C = 256 {c64_fast_vjp[0]['ms']:.4f} ms "
        f"({c64_fast_vjp[0]['device_ms']:.4f} ms device, plain formulation "
        f"{c64_fast_vjp[0]['plain_ms']:.4f} ms, peak "
        f"{c64_fast_vjp[0]['peak_gib']:.2f} GiB), down1 / up1 C = 128 on "
        f"128^2 {c64_fast_vjp[1]['ms']:.4f} ms "
        f"({c64_fast_vjp[1]['device_ms']:.4f} ms device, plain "
        f"{c64_fast_vjp[1]['plain_ms']:.4f} ms, peak "
        f"{c64_fast_vjp[1]['peak_gib']:.2f} GiB); 6 batch-8 generator "
        f"forwards a CycleGAN step are ~{6 * fwd_ms / c64['step_ms']:.1%} of "
        f"its host clock and ~{6 * fwd_dev / c64['step_device_ms']:.1%} of "
        f"its device time; the pretrain step's one batch-16 forward "
        f"~{2 * fwd_ms / c64['pretrain'][0]:.1%} and "
        f"~{2 * fwd_dev / c64['pretrain'][1]:.1%}")
    for c, recs in grid_fast_vjp.items():
        t = width_train[c]
        # a generator forward: up2 (C), down1 and up1 (2C), down2 (4C)
        fwd_ms, fwd_dev = (recs[0][k] + 2 * recs[1][k] + recs[2][k]
                           for k in ("ms", "device_ms"))
        log(f"[summary] {card}; c{c}'s route under grad (every LocalAttention "
            f"call of the generator), fwd + bwd at batch {TRAIN_BATCH}, bf16: "
            + ", ".join(f"C = {r['shape'][-1]} on {r['shape'][1]}^2 "
                        f"{r['ms']:.4f} ms ({r['device_ms']:.4f} ms device, "
                        f"plain formulation {r['plain_ms']:.4f} ms, peak "
                        f"{r['peak_gib']:.2f} GiB)" for r in recs)
            + f"; 6 batch-8 generator forwards a CycleGAN step are "
            f"~{6 * fwd_ms / t['step_ms']:.1%} of its host clock and "
            f"~{6 * fwd_dev / t['step_device_ms']:.1%} of its device time; "
            f"the pretrain step's one batch-8 forward "
            f"~{fwd_ms / t['pretrain'][0]:.1%} and "
            f"~{fwd_dev / t['pretrain'][1]:.1%}")
    for r in past_fast_vjp:
        log(f"[summary] {card}; the route under grad at {r['shape']} (c256's "
            f"down2 over the streamed kernel), fwd + bwd, bf16: "
            f"{r['ms']:.4f} ms ({r['device_ms']:.4f} ms device, plain "
            f"formulation {r['plain_ms']:.4f} ms, peak {r['peak_gib']:.2f} "
            f"GiB)")
    log(f"[summary] {card}; study path: select_checkpoints forwards "
        f"{study['select_img_s']:.1f} img/s (bf16, 256^2, batch 8); "
        f"run_trained_surface stages "
        + ", ".join(f"{k} {v:.2f} s" for k, v in study["seconds"].items())
        + f"; its server {study['serving']['img_s']:.2f} img/s, p50 "
        f"{study['serving']['latency_p50_s']:.3f} s, p95 "
        f"{study['serving']['latency_p95_s']:.3f} s ({STUDY_REQUESTS} "
        f"requests, concurrency 8)")
    dp_ms = data_parallel["step_ms"]
    log(f"[summary] {card}; data parallel: bf16 c16 256^2 batch "
        f"{TRAIN_BATCH} step under torchrun --nproc_per_node=1 (NCCL) "
        f"{dp_ms['data_parallel']:.2f} ms/step with the gradient "
        f"all-reduces, {dp_ms['plain']:.2f} without (in turns), the "
        f"all-reduces alone {data_parallel['allreduce_ms']:.3f} ms "
        f"({data_parallel['allreduce_share']:.2%} of the step); two gloo "
        f"ranks vs one on the card (fp32) CycleGAN losses "
        f"{data_parallel['gloo']['cyclegan'][0]:.2e}, gradient norms "
        f"{data_parallel['gloo']['cyclegan'][1]:.2e}, plain pretrain "
        f"{data_parallel['gloo']['pretrain'][0]:.2e} and "
        f"{data_parallel['gloo']['pretrain'][1]:.2e}; --data_parallel two "
        f"replicas vs one device max {data_parallel['levels'][0]} level(s)")
    log(f"[summary] {card}; height-sharded c16 fp32 on [the card] x shards "
        f"against unsharded, float max|d| at 'highest' / 'default': "
        + ", ".join(f"{s}^2 over {n} {r['highest'][0]:.3e} / "
                    f"{r['default'][0]:.3e}"
                    for (s, n), r in sharded["cases"].items())
        + f"; plain c{SPATIAL_PLAIN_CHANNELS} {sharded['plain'][0]:.3e}; at "
        f"{SPATIAL_TIMED_SIZE}^2 (TF32 allowed) "
        + ", ".join(f"{'unsharded' if n == 1 else f'{n} shards'} "
                    f"{sharded['ms'][n]:.2f} ms, peak "
                    f"{sharded['peak_gib'][n]:.3f} GiB" for n in sharded["ms"])
        + "; at 'default' mean |d| / share differing from unsharded: "
        + ", ".join(f"{'in a batch of 2' if k == 'pair' else f'{k} shards'} "
                    f"{d[0]:.4f} / {d[3]:.4%}"
                    for k, d in sharded["tf32"].items())
        + f"; direct_transform --spatial 2: {sharded['cli']}")
    log(f"[summary] {card}; int8 engine (EXPERIMENTAL), trained c16: "
        f"{INT8_LAUNCHES_PER_FORWARD} int8 convolutions a forward, "
        f"{sum(r['ms'] for r in int8_rows.values()):.4f} ms at canvas "
        f"{canvas}, batch {BATCH}; int8 gate vs fp32 mean |d| "
        f"{int8_out['gate'][0]:.4f} levels, past {BF16_GATE_LEVELS} "
        f"{int8_out['gate'][1]:.4%}; step by step vs the CPU: InstanceNorm "
        f"{int8_out['forced']['in_steps']:.0f} bf16 step on "
        f"{int8_out['forced']['in_neq']:.3e} of values, the rest bit-equal "
        f"but attention / block; planted faults caught step by step "
        f"{len(int8_out['faults'])} of {len(INT8_FAULTS)} ("
        + ", ".join(f"{k} {v}" for k, v in int8_out["faults"].items())
        + "); SSIM / PSNR int8 vs bf16 "
        f"{int8_out['quality']['bf16'][0]:.4f} / "
        f"{int8_out['quality']['bf16'][1]:.2f} dB, vs fp32 "
        f"{int8_out['quality']['fp32'][0]:.4f} / "
        f"{int8_out['quality']['fp32'][1]:.2f} dB (bf16 vs fp32 SSIM "
        f"{int8_out['bf16_ssim']:.4f}); img/s "
        + ", ".join(f"canvas {c} batch {n} int8 {r['int8']:.1f} bf16 NHWC "
                    f"{r['bf16 nhwc']:.1f}"
                    for (c, n), r in int8_out["rates"].items()))
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
