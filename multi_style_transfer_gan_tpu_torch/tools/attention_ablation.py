"""Stage ablation of the channel-attention kernel on the card: where its
time goes. The port's counterpart of ``scripts/ab_v3_ablation.py::main``.

    python -m multi_style_transfer_gan_tpu_torch.tools.attention_ablation \\
        [--batch 96] [--hw 512] [--c 16] [--rounds 4] [--iters 4]

Times cumulative prefixes of the kernel body of
``csrc/window_channel_attention.cuh``, each one launch of the stage kernel
(``window_channel_attention_stage``) on a (batch, hw, hw, c) NHWC tensor
in bf16, the type the JAX script fixes:

  copy    : launch, weight staging, one read and one write of x
  qkv     : + the 1x1 qkv product
  norm    : + both zero-safe L2 normalizes
  logits  : + the C x C Gram of each window
  softmax : + the row softmax
  full    : + the apply and the 1x1 proj (the op itself)

Each stage's time is the minimum over ``--rounds`` of the CUDA-event time
per call over ``--iters`` launches. The tool prints the card's name and
power limit, each stage's ms and its delta to the stage before, and the
shape's bytes bound (x read once, y written once, over 3.35 TB/s).

Inputs. The weights come from ``np.random.default_rng(0)`` in the JAX
script's order and scales (wqkv, bqkv, wproj, bproj, each N(0, 0.1^2),
1x1 kernels drawn in HWIO and laid out (out, in) here). The JAX script
draws x from that generator first; drawing its 402 M values on the host
would cost more than the run (3.2 GB of float64 at the default shape), so
x ~ N(0, 0.5^2) is drawn on the card from a ``torch.Generator`` seeded 0,
and the weights are not the JAX script's numbers (the times do not depend
on them). The TPU knob ``tile_rows`` has no counterpart.

Unlike the JAX script, a stage that fails to build or launch is not
caught: the tool raises. It exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory, published peak


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def ablation_inputs(batch: int, hw: int, c: int, device):
    """x on ``device`` and the four weights, bf16, as described above."""
    import torch

    rng = np.random.default_rng(0)
    wqkv = rng.standard_normal((1, 1, c, 3 * c)) * 0.1
    bqkv = rng.standard_normal((3 * c,)) * 0.1
    wproj = rng.standard_normal((1, 1, c, c)) * 0.1
    bproj = rng.standard_normal((c,)) * 0.1
    weights = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        device, torch.bfloat16)
        for a in (wqkv[0, 0].T, bqkv, wproj[0, 0].T, bproj)]
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((batch, hw, hw, c), generator=gen, device=device,
                    dtype=torch.bfloat16).mul_(0.5)
    return x, weights


def cuda_ms(fn, iters: int) -> float:
    """Device ms per call of ``fn``: CUDA events around ``iters`` calls."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def stage_times(x, weights, rounds: int, iters: int) -> dict:
    """{stage: ms per call}, the minimum over rounds of CUDA-event time over
    ``iters`` launches; each stage is built and run once first."""
    import torch

    from ..ops.kernels import STAGES, window_channel_attention_stage

    calls = {stage: (lambda s=stage: window_channel_attention_stage(
        x, *weights, stage=s)) for stage in STAGES}
    for call in calls.values():
        call()
    torch.cuda.synchronize()
    ms = {stage: float("inf") for stage in STAGES}
    for _ in range(rounds):
        for stage, call in calls.items():
            ms[stage] = min(ms[stage], cuda_ms(call, iters))
    return ms


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=96)
    p.add_argument("--hw", type=int, default=512)
    p.add_argument("--c", type=int, default=16)
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--iters", type=int, default=4)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; the attention ablation runs on the GPU",
              file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    B, HW, C = args.batch, args.hw, args.c
    with torch.inference_mode():
        x, weights = ablation_inputs(B, HW, C, torch.device("cuda"))
        ms = stage_times(x, weights, args.rounds, args.iters)
    moved = 2 * x.numel() * x.element_size()
    print(f"# stage ablation of the channel-attention kernel at {B}x{HW}^2 "
          f"C={C} bf16 (cumulative prefixes; {card}):")
    prev = 0.0
    for stage, t in ms.items():
        print(f"  {stage:8s} {t:9.4f} ms   (delta {t - prev:+9.4f})",
              flush=True)
        prev = t
    print(f"# bytes bound: x read once and y written once, {moved / 1e6:.1f} "
          f"MB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s = "
          f"{moved / HBM_BYTES_PER_S * 1e3:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
