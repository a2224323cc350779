"""The int8 engine against the bf16 one on the card: throughput and quality
(the counterpart of the JAX repo's ``scripts/ab_int8_engine.py``).

    PYTHONPATH=. python3 devtools/int8_ab.py [--batch 64] [--size 256]
        [--model PATH | --train_steps N] [--images_dir DIR]

The generator: the trained c16 (``chip_smoke.TRAINED``) or ``--model``;
with ``--train_steps N`` a fresh c16 trained N bf16 CycleGAN steps (batch
8, 256^2) on the port's train step, on the synthetic cool-A / warm-B
two-domain task of the JAX script (G_AB is measured).

Quality: SSIM and PSNR (skimage's, data range 255, on (y + 1) * 127.5
clipped, the mean over the images) and mean / max |d| of the bf16 and the
int8 forward against the fp32 one (TF32 off) on the same inputs: the 16
gate images of ``chip_smoke.gate_images`` at ``--size`` (int8 calibrated on
their first 8), or with ``--images_dir`` its first 4 images (calibrated on
the next 8, else on the same 4), resized to ``--size``. The bf16 line is the
floor the int8 engine is read against.

The hypothesis of the engine's one-pass statistics: the same int8 weights
and scales, run once more with two-pass InstanceNorm statistics (mean, then
the centred variance) at the absorbed sites in place of E[x^2] - E[x]^2.
On int32 sums of 1e4 .. 1e7 the one-pass variance of a near-flat channel
cancels in fp32 and may clamp to 0; if that is a cause of the engine's
distance, this line lies closer to fp32. A diagnostic of this tool only:
the engine computes the JAX package's function and has no such switch.

Throughput: the uint8 -> uint8 programs (``make_batch_fn``, bf16 NHWC and
int8) on a device-resident batch of ``--batch`` images at ``--size``, in
turns (bf16, int8, int8, bf16), img/s.

Prints the card's name and power limit. Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import copy
import sys

import numpy as np

import chip_smoke as smoke

STEP_BATCH, STEP_SIZE = 8, 256
RATE_ITERS = 10
DEVICE = "cuda"   # a rehearsal on the CPU replaces this


def trained_generator(steps, dev):
    """G_AB of a fresh c16 CycleGAN after ``steps`` bf16 steps on the cool /
    warm synthetic domains (scripts/ab_int8_engine.py's recipe, the port's
    step; inputs from a seeded torch.Generator)."""
    import torch

    from multi_style_transfer_gan_tpu_torch.train.cyclegan import (
        cyclegan_init_state, cyclegan_train_step,
    )

    state = cyclegan_init_state(0, 16, 1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    cool = torch.tensor([0.5, 0.7, 1.0], device=dev), \
        torch.tensor([-0.4, -0.1, -0.4], device=dev)
    warm = torch.tensor([1.0, 0.7, 0.5], device=dev), \
        torch.tensor([0.4, -0.1, -0.4], device=dev)
    shape = (STEP_BATCH, STEP_SIZE, STEP_SIZE, 3)
    for i in range(steps):
        ra, rb = (torch.rand(shape, generator=gen, device=dev) * 2 - 1
                  for _ in range(2))
        state, losses = cyclegan_train_step(
            state, ra * cool[0] + cool[1], rb * warm[0] + warm[1],
            compute_dtype=torch.bfloat16)
        if i % 10 == 0:
            print(f"  train step {i}: g={float(losses['g_loss']):.3f} "
                  f"cyc={float(losses['cycle_loss']):.3f}", flush=True)
    return state.G_AB.eval()


def eval_images(args):
    """(eval batch, calibration batch), uint8 (B, size, size, 3)."""
    if not args.images_dir:
        x = smoke.gate_images(args.size)
        return x, x[:smoke.INT8_CALIB_IMAGES]
    from PIL import Image

    from multi_style_transfer_gan_tpu_torch.data import list_images

    paths = list_images(args.images_dir)
    if len(paths) < 4:
        raise SystemExit(f"need at least 4 images in {args.images_dir}")
    load = lambda ps: np.stack([np.asarray(Image.open(p).convert("RGB").resize(
        (args.size, args.size), Image.LANCZOS), np.uint8) for p in ps])
    return load(paths[:4]), load(paths[4:12] if len(paths) > 4 else paths[:4])


def two_pass_in_relu(x, eps=1e-5):
    """relu(IN(x)) over H, W of (B, H, W, C) with two-pass fp32 statistics."""
    import torch

    xf = x.float()
    d = xf - xf.mean(dim=(1, 2), keepdim=True)
    var = d.square().mean(dim=(1, 2), keepdim=True)
    return torch.relu(d * torch.rsqrt(var + eps)).to(x.dtype)


def report(name, out, ref):
    """SSIM / PSNR / |d| of the (B, 3, H, W) forward ``out`` against
    ``ref``, both in [-1, 1]."""
    import torch

    from multi_style_transfer_gan_tpu_torch.metrics.quality import psnr, ssim

    u = lambda y: torch.clamp((y.float().permute(0, 2, 3, 1) + 1) * 127.5,
                              0, 255)
    a, b = u(out), u(ref)
    d = (out.float() - ref.float()).abs()
    print(f"  {name}: SSIM {ssim(a, b, 255.0).mean().item():.4f}  PSNR "
          f"{psnr(a, b, 255.0).mean().item():.2f} dB  mean|d| "
          f"{d.mean().item():.4f}  max|d| {d.max().item():.4f}", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--model", type=str, default=smoke.TRAINED)
    p.add_argument("--train_steps", type=int, default=0)
    p.add_argument("--images_dir", type=str, default=None)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    from multi_style_transfer_gan_tpu_torch.models import quantized_generator as tq
    from multi_style_transfer_gan_tpu_torch.ops import to_model_range
    from multi_style_transfer_gan_tpu_torch.pipelines import (
        load_generator, make_batch_fn,
    )
    from multi_style_transfer_gan_tpu_torch.pipelines.model_loader import (
        LoadedModel,
    )

    print(smoke.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    if args.train_steps:
        gen = trained_generator(args.train_steps, dev)
        model = LoadedModel("enhanced", 16, None, gen, None)
        print(f"generator: fresh c16 after {args.train_steps} bf16 steps",
              flush=True)
    else:
        model = load_generator(args.model, device=dev)
        print(f"generator: {args.model} (c{model.channels})", flush=True)
    gen = model.module
    x_u8, calib_u8 = eval_images(args)
    calib = [to_model_range(torch.from_numpy(calib_u8)).numpy()]
    q = tq.prepare_int8_model(gen, calib)
    x = to_model_range(torch.from_numpy(x_u8).to(dev)).permute(0, 3, 1, 2)

    print(f"quality on {len(x_u8)} images at {args.size}^2 "
          f"({args.images_dir or 'chip_smoke.gate_images'}), against fp32 "
          f"(TF32 off):", flush=True)
    with torch.inference_mode():
        ref = gen(x)
        bf16 = copy.deepcopy(gen).to(torch.bfloat16)(x.to(torch.bfloat16))
        int8 = q(x)
        conv_fn = lambda s, h, out, off: q.site(s)(h, out, off)
        two_pass = tq._forward(conv_fn, q.attention, q.style_encoder[2],
                               q.transformer_blocks, x.to(torch.bfloat16),
                               two_pass_in_relu)
    report("bf16 vs fp32 (the floor)             ", bf16, ref)
    report("int8 vs fp32                         ", int8, ref)
    report("int8, two-pass IN statistics, vs fp32", two_pass, ref)

    u8 = torch.from_numpy(np.stack(smoke.smooth_images(
        np.random.default_rng(0), args.batch, (args.size, args.size)))).to(dev)
    programs = {"bf16 nhwc": make_batch_fn(
        model, "cyclegan", compute_dtype=torch.bfloat16, device=dev),
        "int8": make_batch_fn(model, "cyclegan", engine="int8",
                              calib_batches=calib, device=dev)}
    turns = {k: [] for k in programs}
    for k in list(programs) + list(programs)[::-1]:
        turns[k].append(smoke.program_rate(programs[k], u8, RATE_ITERS))
    rate = {k: sum(v) / len(v) for k, v in turns.items()}
    print(f"throughput, batch {args.batch} at {args.size}^2 (uint8 in and "
          f"out on the card, in turns): bf16 NHWC {rate['bf16 nhwc']:.1f} "
          f"img/s, int8 {rate['int8']:.1f} img/s (int8 / bf16 "
          f"{rate['int8'] / rate['bf16 nhwc']:.3f}); turns {turns}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
