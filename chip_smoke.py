"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two main paths (``multi_style_transfer_gan_tpu_torch``) on
the card, serving at the full width of the trained c16 EnhancedGenerator
shipped in ``trained/`` with both engines (NHWC and packed space-to-depth)
and CycleGAN training at the reference configuration, and checks every
hand-written kernel on the way:

1. build: all five CUDA sources compile from ``csrc/`` at once, one nvcc
   each;
2. window channel attention, kernel vs plain PyTorch at every shape the
   generator gives it at canvas 256 and 512 (fp32 with TF32 off, and bf16);
3. the same op on packed rows (the packed engine's layout), kernel vs
   plain at every packed-engine shape, beside the NHWC kernel's time at the
   same windows; the window relayout, kernel vs plain, bit-exact;
4. the fused transformer block, kernel vs plain, including a ragged grid;
5. the training kernels (channel-attention mid, window-MHSA mid), forward
   and backward, kernel vs plain at every training shape, one all-zero
   window each;
6. serving path: the uint8 -> uint8 stylize program on the trained weights
   with each engine (fp32 on the card vs the plain path on the CPU, packed
   vs NHWC on the card, launch counts per forward, bf16 img/s of both
   engines at canvas 256 and 512, batch 16 and 64), the batch CLI on 24
   JPEGs of mixed sizes with ``--engine packed``, ``auto`` and ``nhwc``,
   the HTTP server answering 4 requests with each engine;
7. training path: the bf16 train step at c16, 256^2, batch 8 (launches per
   step, finite losses, moved G, D and u, ms/step), one fp32 step on the
   card vs the CPU, and the train CLI writing, resuming and producing a
   generator that stylizes.

Every phase raises on failure. The last line is the result JSON; the line
before it lists each kernel with its launches on the two main paths
(launch counts are reset just before each path and read just after), its
largest fp32 deviation from the plain version, and its time beside the
plain version's. Exits nonzero without a CUDA device.
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
# bf16: kernel and plain both compute in fp32 from the same bf16 inputs and
# round once, so they may differ by one bf16 rounding of the output (2^-7
# relative) on top of fp32 summation order.
BF16_ATOL, BF16_RTOL = 3e-2, 2 ** -7
# uint8 fp32 card vs CPU, and packed vs NHWC engine on the card: different
# conv algorithms (and, packed, the repacked convs' extra zero taps) move
# values by ~1e-5, which flips a rounding on a small share of pixels by one
# level.
U8_MAX_DIFF, U8_MAX_SHARE = 1, 0.01
# bf16 vs fp32 program on the card, mean |d| in uint8 levels (a sanity
# bound: a broken kernel lands far above it).
BF16_MEAN_LSB = 4.0


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


def time_pair(kernel_fn, plain_fn):
    """Kernel and plain times taken in turns (plain, kernel, kernel, plain)."""
    p1, k1, k2, p2 = (time_ms(plain_fn), time_ms(kernel_fn),
                      time_ms(kernel_fn), time_ms(plain_fn))
    return (k1 + k2) / 2, (p1 + p2) / 2


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


def attention_shapes(canvas):
    """(name, shape) of the four LocalAttention calls of one c16 forward."""
    return [("down1", (BATCH, canvas // 2, canvas // 2, 32)),
            ("down2", (BATCH, canvas // 4, canvas // 4, 64)),
            ("up1", (BATCH, canvas // 2, canvas // 2, 32)),
            ("up2", (BATCH, canvas, canvas, 16))]


def phase_attention(rng, dev):
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
            B, H, W, C = shape
            x = rng.standard_normal(shape).astype(np.float32)
            x[0, :4, :4] = 0.0  # one all-zero window: zero-safe normalize
            ws = [rng.standard_normal((3 * C, C)) * 0.1,
                  rng.standard_normal(3 * C),
                  rng.standard_normal((C, C)) * 0.1,
                  rng.standard_normal(C)]
            for dtype in (torch.float32, torch.bfloat16):
                args = [torch.from_numpy(a.astype(np.float32)).to(dev, dtype)
                        for a in [x] + ws]
                got = window_channel_attention(*args)
                ref = window_channel_attention_plain(*args)
                torch.cuda.synchronize()
                err, bf16_ok = compare(got, ref, dtype)
                ok = (err <= FP32_TOL if dtype == torch.float32 else bf16_ok)
                # the all-zero window: finite, and inside the same tolerance
                zero_ok = bool(torch.isfinite(got[0, :4, :4]).all())
                ok = ok and bool(torch.isfinite(got).all()) and zero_ok
                k_ms, p_ms = time_pair(
                    lambda: window_channel_attention(*args),
                    lambda: window_channel_attention_plain(*args))
                log(f"[attention] canvas {canvas} {stage} {shape} "
                    f"{str(dtype)[6:]}: max|d| {err:.3e} zero-window "
                    f"{'ok' if zero_ok else 'BAD'}, kernel {k_ms:.4f} ms, "
                    f"plain {p_ms:.4f} ms")
                if not ok:
                    raise AssertionError(f"window_channel_attention {shape} "
                                         f"{dtype}: max|d| {err:.3e} outside "
                                         f"tolerance")
                if dtype == torch.float32:
                    worst = max(worst, err)
                else:
                    times[(canvas, stage)] = seen[shape] = (k_ms, p_ms)
    return worst, times


def packed_attention_shapes(canvas):
    """(name, packed shape) of the four LocalAttention calls of one c16
    packed forward: (B, H/4, W/4, 16 C) at each stage's NHWC grid."""
    return [(stage, (B, H // 4, W // 4, 16 * C))
            for stage, (B, H, W, C) in attention_shapes(canvas)]


def phase_packed_attention(rng, dev):
    """Packed-row attention kernel vs plain at every packed-engine shape,
    one all-zero window each, and the NHWC kernel's time at the same
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
        for stage, shape in packed_attention_shapes(canvas):
            if shape in seen:  # up1 has down1's shape
                times[(canvas, stage)] = seen[shape]
                continue
            C = shape[-1] // 16
            x = rng.standard_normal(shape).astype(np.float32)
            x[0, 0, 0] = 0.0  # one all-zero window: zero-safe normalize
            ws = [rng.standard_normal((3 * C, C)) * 0.1,
                  rng.standard_normal(3 * C),
                  rng.standard_normal((C, C)) * 0.1,
                  rng.standard_normal(C)]
            for dtype in (torch.float32, torch.bfloat16):
                args = [torch.from_numpy(a.astype(np.float32)).to(dev, dtype)
                        for a in [x] + ws]
                got = packed_window_channel_attention(*args)
                ref = packed_window_channel_attention_plain(*args)
                torch.cuda.synchronize()
                err, bf16_ok = compare(got, ref, dtype)
                ok = (err <= FP32_TOL if dtype == torch.float32 else bf16_ok)
                zero_ok = bool(torch.isfinite(got[0, 0, 0]).all())
                ok = ok and bool(torch.isfinite(got).all()) and zero_ok
                k_ms, p_ms = time_pair(
                    lambda: packed_window_channel_attention(*args),
                    lambda: packed_window_channel_attention_plain(*args))
                nhwc = [depth_to_space_plain(args[0], 4).contiguous()] + args[1:]
                n_ms = time_ms(lambda: window_channel_attention(*nhwc))
                log(f"[packed attention] canvas {canvas} {stage} {shape} "
                    f"{str(dtype)[6:]}: max|d| {err:.3e} zero-window "
                    f"{'ok' if zero_ok else 'BAD'}, kernel {k_ms:.4f} ms, "
                    f"plain {p_ms:.4f} ms, NHWC kernel {n_ms:.4f} ms")
                if not ok:
                    raise AssertionError(f"packed_window_channel_attention "
                                         f"{shape} {dtype}: max|d| {err:.3e} "
                                         f"outside tolerance")
                if dtype == torch.float32:
                    worst = max(worst, err)
                else:
                    times[(canvas, stage)] = seen[shape] = (k_ms, p_ms, n_ms)
    return worst, times


def relayout_cases(canvas):
    """(name, NHWC shape, direction) of the five relayouts of one packed
    forward at BATCH: the input and output (C = 3) and the bottleneck
    tokens, struct and block output (C = 64)."""
    full, bottleneck = (BATCH, canvas, canvas, 3), (BATCH, canvas // 4,
                                                    canvas // 4, 64)
    return [("s2d input", full, "s2d"), ("d2s tokens", bottleneck, "d2s"),
            ("d2s struct", bottleneck, "d2s"), ("s2d block", bottleneck, "s2d"),
            ("d2s output", full, "d2s")]


def phase_relayout(rng, dev):
    """The relayout kernel vs the plain reshape + permute, both directions,
    bit-exact; returns the largest |d| (0) and the ms of the five relayouts
    of one forward at the first canvas (kernel, plain), bf16."""
    import torch

    from multi_style_transfer_gan_tpu_torch.ops.kernels import (
        depth_to_space_plain, space_to_depth_plain, window_relayout,
    )

    worst = 0.0
    case_ms = {}
    cases = relayout_cases(CANVASES[0])
    for shape in sorted({s for _, s, _ in cases}):
        host = rng.standard_normal(shape).astype(np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(host).to(dev, dtype)
            rows = space_to_depth_plain(x, 4).contiguous()
            for direction, src, plain in (
                    ("s2d", x, lambda t: space_to_depth_plain(t, 4).contiguous()),
                    ("d2s", rows, lambda t: depth_to_space_plain(t, 4).contiguous())):
                inverse = direction == "d2s"
                got = window_relayout(src, inverse=inverse)
                ref = plain(src)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                exact = torch.equal(got, ref)
                k_ms, p_ms = time_pair(
                    lambda: window_relayout(src, inverse=inverse),
                    lambda: plain(src))
                log(f"[relayout] {direction} {shape} {str(dtype)[6:]}: "
                    f"{'bit-exact' if exact else f'DIFFERS max|d| {err:.3e}'}, "
                    f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
                if not exact:
                    raise AssertionError(f"window_relayout {direction} {shape} "
                                         f"{dtype} is not bit-exact")
                worst = max(worst, err)
                if dtype == torch.bfloat16:
                    case_ms[(shape, direction)] = (k_ms, p_ms)
    per_fwd = [sum(case_ms[(shape, d)][i] for _, shape, d in cases)
               for i in (0, 1)]
    return worst, tuple(per_fwd)


def phase_block(rng, dev):
    import torch

    from multi_style_transfer_gan_tpu_torch.ops.kernels import (
        fused_structural_block, structural_block_plain,
    )
    from multi_style_transfer_gan_tpu_torch.ops.kernels.fused_transformer import (
        weight_shapes,
    )

    worst = 0.0
    times = {}
    for shape in [(BATCH, 64, 64, 64), (BATCH, 128, 128, 64), (2, 12, 20, 64)]:
        B, H, W, C = shape
        host = [rng.standard_normal(shape), rng.standard_normal(shape),
                rng.standard_normal((B, C)) * 0.1,
                rng.standard_normal((B, C)) * 0.1]
        weights = {}
        for n, s in weight_shapes(C).items():
            a = rng.standard_normal(s) * (0.1 if len(s) == 2 else 0.05)
            weights[n] = a + 1.0 if n in ("norm1_w", "norm2_w") else a
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
            ok = (err <= BLOCK_FP32_TOL if dtype == torch.float32 else bf16_ok)
            ok = ok and bool(torch.isfinite(got).all())
            k_ms, p_ms = time_pair(lambda: fused_structural_block(*args, **kw),
                                   lambda: structural_block_plain(*args, **kw))
            ragged = " (ragged)" if H % 8 or W % 8 else ""
            log(f"[block] {shape}{ragged} {str(dtype)[6:]}: max|d| {err:.3e}, "
                f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
            if not ok:
                raise AssertionError(f"fused_structural_block {shape} {dtype}: "
                                     f"max|d| {err:.3e} outside tolerance")
            if dtype == torch.float32:
                worst = max(worst, err)
            else:
                times[shape] = (k_ms, p_ms)
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


def phase_train_kernels(rng, dev):
    """Forward and backward of both training kernels vs their plain versions,
    fp32 (TF32 off) and bf16, one all-zero window in every input."""
    import torch

    from multi_style_transfer_gan_tpu_torch.ops import kernels as K

    fns = {
        "attention": (K.window_attention_mid_fwd, K.window_attention_mid_bwd,
                      K.window_attention_mid_plain,
                      K.window_attention_mid_backward_plain, ()),
        "mhsa": (K.window_mhsa_fwd, K.window_mhsa_bwd, K.window_mhsa_plain,
                 K.window_mhsa_backward_plain, (2,)),
    }
    worst = {"attention": 0.0, "mhsa": 0.0}
    times = {}
    for name, stage, shape in train_kernel_cases():
        fwd, bwd, fwd_plain, bwd_plain, extra = fns[name]
        win = 4 if name == "attention" else 8
        host = rng.standard_normal(shape).astype(np.float32)
        host[0, :win, :win] = 0.0      # one all-zero window
        g_host = rng.standard_normal(shape[:3] + (shape[3] // 3,))
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.from_numpy(host).to(dev, dtype)
            d_out = torch.from_numpy(g_host.astype(np.float32)).to(dev, dtype)
            got = fwd(qkv, *extra)
            dgot = bwd(qkv, d_out, *extra)
            ref = fwd_plain(qkv, *extra)
            dref = bwd_plain(qkv, d_out, *extra)
            torch.cuda.synchronize()
            err, ok = compare(got, ref, dtype)
            derr, dok = compare(dgot, dref, dtype)
            if dtype == torch.float32:
                ok, dok = err <= FP32_TOL, derr <= TRAIN_GRAD_FP32_TOL
                worst[name] = max(worst[name], err, derr)
            finite = bool(torch.isfinite(got).all() and torch.isfinite(dgot).all())
            zero_ok = bool(torch.isfinite(dgot[0, :win, :win]).all())
            k_ms, p_ms = time_pair(
                lambda: (fwd(qkv, *extra), bwd(qkv, d_out, *extra)),
                lambda: (fwd_plain(qkv, *extra), bwd_plain(qkv, d_out, *extra)))
            times[(name, stage, dtype)] = (k_ms, p_ms)
            log(f"[train kernels] {name} {stage} qkv {shape} {str(dtype)[6:]}: "
                f"fwd max|d| {err:.3e}, bwd max|d| {derr:.3e}, zero window "
                f"{'finite' if zero_ok else 'BAD'}; fwd+bwd kernel {k_ms:.4f} ms, "
                f"plain {p_ms:.4f} ms")
            if not (ok and dok and finite and zero_ok):
                raise AssertionError(f"{name} train kernel {shape} {dtype}: "
                                     f"outside tolerance or not finite")
    return worst, times


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


def phase_generator(rng, dev, counts):
    """The uint8 program with each engine: fp32 on the card vs the CPU plain
    path and packed vs NHWC on the card (launches per forward checked), then
    bf16 img/s of both engines in turns at every canvas and batch."""
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
            turns = {engine: [] for engine in ENGINES}
            for engine in ENGINES + ENGINES[::-1]:   # nhwc, packed, packed, nhwc
                turns[engine].append(program_rate(bf16[engine], x))
            rate = rates[(canvas, n)] = {e: sum(r) / len(r)
                                         for e, r in turns.items()}
            log(f"[generator] bf16 program, batch {n} at canvas {canvas} "
                f"(device-resident uint8 in and out): NHWC {rate['nhwc']:.1f} "
                f"img/s, packed {rate['packed']:.1f} img/s (packed/NHWC "
                f"{rate['packed'] / rate['nhwc']:.3f}); turns {turns}")
    return rates


def phase_cli(rng):
    """The batch CLI on 24 JPEGs of mixed sizes at --batch_size 8, once per
    engine flag; auto must resolve to packed at batch 8."""
    import contextlib

    from PIL import Image

    from multi_style_transfer_gan_tpu_torch.cli.batch_process_images import main

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in")
        models = os.path.join(tmp, "models")
        os.makedirs(src)
        os.makedirs(models)
        shutil.copy(TRAINED, os.path.join(models, "cyclegan_epoch_200.pth"))
        sizes = {}
        for i in range(24):
            w, h = int(rng.integers(96, 640)), int(rng.integers(96, 640))
            name = f"photo_{i:02d}.jpg"
            Image.fromarray(smooth_images(rng, 1, (w, h))[0]).save(
                os.path.join(src, name), quality=92)
            sizes[name] = (w, h)
        for engine in ("packed", "auto", "nhwc"):
            out = os.path.join(tmp, f"out_{engine}")
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = main(["--input_dir", src, "--output_dir", out,
                           "--models_dir", models, "--mode", "cyclegan",
                           "--direction", "photo2monet", "--bf16",
                           "--batch_size", "8", "--engine", engine])
            elapsed = time.perf_counter() - t0
            for line in buf.getvalue().splitlines():
                log(f"    {line}")
            if rc != 0:
                raise AssertionError(f"batch CLI --engine {engine} exited {rc}")
            if engine == "auto" and "engine=auto -> packed (batch 8" not in \
                    buf.getvalue():
                raise AssertionError("--engine auto did not take the packed "
                                     "engine at batch 8")
            done = 0
            for name, size in sizes.items():
                path = os.path.join(out, "cyclegan_photo2monet", name)
                if os.path.exists(path):
                    with Image.open(path) as img:
                        done += img.size == size
            log(f"[cli] --engine {engine}: {done}/24 outputs at their "
                f"original sizes; CLI wall {elapsed:.2f} s including model "
                f"load")
            if done != 24:
                raise AssertionError(f"batch CLI --engine {engine} wrote "
                                     f"{done}/24 correct outputs")


def phase_server(rng, dev, engine):
    import torch
    from PIL import Image

    from multi_style_transfer_gan_tpu_torch.pipelines import load_generator
    from multi_style_transfer_gan_tpu_torch.serving import (
        StyleTransferService, serve,
    )

    model = load_generator(TRAINED, device=dev)
    service = StyleTransferService(model, canvas=256, max_batch=8,
                                   compute_dtype=torch.bfloat16, engine=engine,
                                   device=dev)
    server = serve(service, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address
    try:
        sizes = [(320, 200), (200, 320), (256, 256), (500, 375)]
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
        log(f"[server] engine {engine}: {good}/4 replies 200 with a PNG of "
            f"the right size; /stats requests {stats['requests']}, batches "
            f"{stats['batches']}")
        if good != 4 or stats["requests"] != 4:
            raise AssertionError(f"server round trip failed (engine {engine})")
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(10)


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
    from multi_style_transfer_gan_tpu_torch.ops import to_model_range
    from multi_style_transfer_gan_tpu_torch.train import (
        cyclegan_init_state, cyclegan_train_step,
    )

    state = cyclegan_init_state(SEED, 16, 1, device=dev)
    before = {n: {k: v.clone() for k, v in getattr(state, n).state_dict().items()}
              for n in ("G_AB", "G_BA", "D_A", "D_B")}
    pairs = uint8_pairs(rng, 2, TRAIN_BATCH, 256, dev)

    def step(i):
        a, b = pairs[i % len(pairs)]
        return cyclegan_train_step(state, to_model_range(a), to_model_range(b),
                                   compute_dtype=torch.bfloat16,
                                   pair_batching=True)[1]

    kernels = {"window_attention_mid_fwd": K.window_attention_mid_fwd,
               "window_attention_mid_bwd": K.window_attention_mid_bwd,
               "window_mhsa_fwd": K.window_mhsa_fwd,
               "window_mhsa_bwd": K.window_mhsa_bwd,
               "window_channel_attention": K.window_channel_attention,
               "fused_structural_block": K.fused_structural_block}
    n0 = {n: k.launches for n, k in kernels.items()}
    losses = step(0)
    torch.cuda.synchronize()
    per_step = {n: k.launches - n0[n] for n, k in kernels.items()}
    log(f"[train step] launches in one step: {per_step}")
    if per_step != TRAIN_LAUNCHES_PER_STEP:
        raise AssertionError(f"launches per step {per_step}, predicted "
                             f"{TRAIN_LAUNCHES_PER_STEP}")
    for i in range(1, 3):   # warm-up: 3 steps in all
        step(i)
    torch.cuda.synchronize()
    iters = 10
    t0 = time.perf_counter()
    for i in range(iters):
        losses = step(i)
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
    host = [tuple(to_model_range(t).cpu() for t in pair)
            for pair in uint8_pairs(rng, 1, 2, 128, dev)]
    out = {}
    for device in (dev, torch.device("cpu")):
        st = cyclegan_init_state(SEED + 1, 16, 1, device=device)
        a, b = (t.to(device) for t in host[0])
        out[device.type] = {k: float(v) for k, v in cyclegan_train_step(
            st, a, b, compute_dtype=torch.float32)[1].items()}
    rel = {k: abs(out["cuda"][k] - out["cpu"][k]) / abs(out["cpu"][k])
           for k in out["cpu"]}
    log(f"[train step] fp32 c16 128^2 batch 2, card vs CPU: {out['cuda']} vs "
        f"{out['cpu']}; max relative difference {max(rel.values()):.2e}")
    if max(rel.values()) > TRAIN_FP32_RTOL:
        raise AssertionError(f"fp32 step on the card disagrees with the CPU: "
                             f"{rel}")
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

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; chip_smoke.py runs on the GPU",
              file=sys.stderr)
        return 1
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
    train_err, train_times = phase_train_kernels(rng, dev)

    counted = {"window_channel_attention": K.window_channel_attention,
               "fused_structural_block": K.fused_structural_block,
               "packed_window_channel_attention":
                   K.packed_window_channel_attention,
               "window_relayout": K.window_relayout,
               "window_attention_mid_fwd": K.window_attention_mid_fwd,
               "window_attention_mid_bwd": K.window_attention_mid_bwd,
               "window_mhsa_fwd": K.window_mhsa_fwd,
               "window_mhsa_bwd": K.window_mhsa_bwd}
    counts = lambda: {n: k.launches for n, k in counted.items()}
    serving_kernels = list(counted)[:4]   # the order of FORWARD_LAUNCHES

    K.reset_launch_counts()   # the serving path starts here
    rates = phase_generator(rng, dev, lambda: [
        counted[n].launches for n in serving_kernels])
    phase_cli(rng)
    for engine in ENGINES:
        phase_server(rng, dev, engine)
    serving = counts()        # ...and ends here
    log(f"[main path: serving] launches: {serving}")
    attention_calls = (serving["window_channel_attention"]
                       + serving["packed_window_channel_attention"])
    if (min(serving[n] for n in serving_kernels) == 0
            or attention_calls != 4 * serving["fused_structural_block"]):
        raise AssertionError(f"serving path launches {serving}: expected "
                             f"every kernel, 4 attention calls (NHWC + "
                             f"packed) per block call")

    K.reset_launch_counts()   # the training path starts here
    step_ms = phase_train_step(rng, dev)
    phase_train_cli(rng, dev)
    training = counts()       # ...and ends here
    log(f"[main path: training] launches: {training}")
    if min(training[n] for n in TRAIN_LAUNCHES_PER_STEP) == 0:
        raise AssertionError(f"training path launches {training}: a kernel "
                             f"of the path never launched")
    launches = {n: serving[n] + training[n] for n in counted}

    # inference kernels: per forward at canvas 256, batch 8, bf16 (the four
    # LocalAttention shapes, NHWC or packed; the block's one shape; the five
    # relayouts of a packed forward). Training kernels: fwd + bwd per
    # generator forward and backward at 256^2, batch 8, bf16.
    canvas = CANVASES[0]
    attn_ms, attn_plain = (sum(attn_times[(canvas, s)][i]
                               for s, _ in attention_shapes(canvas))
                           for i in (0, 1))
    pk_ms, pk_plain, pk_nhwc = (sum(packed_times[(canvas, s)][i]
                                    for s, _ in attention_shapes(canvas))
                                for i in (0, 1, 2))
    blk_ms, blk_plain = block_times[(BATCH, 64, 64, 64)]
    bf16 = torch.bfloat16
    per_fwd = {"down1/up1": 2, "down2": 1, "up2": 1}
    tr_ms = [sum(n * train_times[("attention", st, bf16)][i]
                 for st, n in per_fwd.items()) for i in (0, 1)]
    mh_ms = train_times[("mhsa", "block", bf16)]
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
         "max_abs_err": attn_err, "ms": attn_ms, "plain_ms": attn_plain},
        {"name": "packed_window_channel_attention", "route": "cuda",
         "source": f"{pkg}/window_channel_attention.cu",
         "replaces": f"{tpu}/window_attention_grouped.py:148 "
                     f"(packed_grouped_window_attention :168); "
                     f"{tpu}/window_attention_v3.py:173 "
                     f"(packed_window_attention_v3 :227); "
                     f"{tpu}/packed_attention.py:138",
         "launches": launches["packed_window_channel_attention"],
         "max_abs_err": packed_err, "ms": pk_ms, "plain_ms": pk_plain},
        {"name": "window_relayout", "route": "cuda",
         "source": f"{pkg}/window_relayout.cu",
         "replaces": f"{tpu}/window_relayout.py:81 (s2d_rows); "
                     f"{tpu}/window_relayout.py:102 (d2s_rows)",
         "launches": launches["window_relayout"],
         "max_abs_err": relayout_err, "ms": relayout_ms[0],
         "plain_ms": relayout_ms[1]},
        {"name": "fused_structural_block", "route": "cuda",
         "source": f"{pkg}/fused_structural_block.cu",
         "replaces": f"{tpu}/fused_transformer.py:169",
         "launches": launches["fused_structural_block"],
         "max_abs_err": block_err, "ms": blk_ms, "plain_ms": blk_plain},
        {"name": "window_attention_train", "route": "cuda",
         "source": f"{pkg}/window_attention_train.cu",
         "replaces": f"{tpu}/window_attention_train.py:220",
         "launches": launches["window_attention_mid_fwd"]
                     + launches["window_attention_mid_bwd"],
         "launches_fwd": launches["window_attention_mid_fwd"],
         "launches_bwd": launches["window_attention_mid_bwd"],
         "max_abs_err": train_err["attention"], "ms": tr_ms[0],
         "plain_ms": tr_ms[1]},
        {"name": "window_mhsa_train", "route": "cuda",
         "source": f"{pkg}/window_mhsa_train.cu",
         "replaces": f"{tpu}/window_mhsa_train.py:134",
         "launches": launches["window_mhsa_fwd"] + launches["window_mhsa_bwd"],
         "launches_fwd": launches["window_mhsa_fwd"],
         "launches_bwd": launches["window_mhsa_bwd"],
         "max_abs_err": train_err["mhsa"], "ms": mh_ms[0],
         "plain_ms": mh_ms[1]},
    ]}
    rate_text = "; ".join(
        f"canvas {c} batch {n} NHWC {r['nhwc']:.1f} packed {r['packed']:.1f}"
        for (c, n), r in rates.items())
    log(f"[summary] {card}; bf16 program img/s: {rate_text}; bf16 train step "
        f"c16 256^2 batch {TRAIN_BATCH}: {step_ms:.2f} ms "
        f"({TRAIN_BATCH * 1000 / step_ms:.1f} image pairs/s). Inference "
        f"kernel ms are per forward at canvas {canvas}, batch {BATCH}, bf16 (the "
        f"NHWC kernel at the packed attention's windows: {pk_nhwc:.4f} ms); "
        f"training kernel ms are forward + backward per generator at 256^2, "
        f"batch {TRAIN_BATCH}, bf16")
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
