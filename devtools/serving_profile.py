"""Where a serving forward's device time goes, by kernel family, on the card.

    PYTHONPATH=. python3 devtools/serving_profile.py [--canvas 256] [--batch 64]
        [--mode cyclegan|enhanced|advanced]

Runs the bf16 uint8 -> uint8 stylize program of the trained c16 generator
with each engine (NHWC, packed) on a device-resident batch, in ``--mode``:
``cyclegan`` (the generator alone) or ``enhanced`` / ``advanced`` (the
``local_style`` program with that post chain): first the wall time of a
forward without the profiler (host clock around work ending in a
synchronize), then ``torch.profiler`` over ``FORWARDS`` forwards, its CUDA
entries' ``self_device_time_total`` grouped by kernel name into families
(convolutions and matrix products, elementwise, reductions, copies and
casts, concatenation, indexing, pooling, histograms and scans, the
hand-written kernels by name). Prints ms per forward and share of each
family, the device operations launched per forward, the device's idle share
(1 - device / wall) and the ten largest kernels. With a post-chain mode it
then profiles the chain alone (``_postprocess`` on the same canvas and the
generator's output, fp32) the same way. Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

import chip_smoke as smoke

FORWARDS = 5
FAMILIES = (   # first match wins, on the lower-cased kernel name
    ("window_channel_attention", ("window_channel_attention",)),
    ("fused_structural_block", ("fused_structural_block",)),
    ("window_relayout", ("window_relayout",)),
    ("concatenation", ("catarray",)),
    ("indexing, gathers and rolls", ("index", "gather", "scatter", "roll")),
    ("pooling (dilate)", ("max_pool",)),
    ("histograms and scans", ("histogram", "scan", "bincount")),
    ("convolutions and matrix products",
     ("conv", "xmma", "cudnn", "cutlass", "gemm", "gemv", "wgrad", "dgrad",
      "nchwtonhwc", "nhwctonchw")),
    ("reductions", ("reduce", "welford")),
    ("copies and casts", ("copy", "memcpy", "memset")),
    ("elementwise", ("elementwise", "vectorized")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def profile(label, fn, wall_ms):
    """Profile ``FORWARDS`` calls of ``fn`` and print the family table."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(FORWARDS):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / FORWARDS / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    total = sum(ms for _, ms, _ in rows)
    launches = sum(count for _, _, count in rows) / FORWARDS
    fams: dict = {}
    for name, ms, _ in rows:
        fams[family(name)] = fams.get(family(name), 0.0) + ms
    print(f"[{label}] {wall_ms:.3f} ms per call wall, {total:.3f} ms device, "
          f"{launches:.0f} device operations, idle share "
          f"{max(0.0, 1 - total / wall_ms):.1%}")
    for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
        print(f"[{label}]   {fam}: {ms:.3f} ms ({ms / total:.1%})")
    for name, ms, count in sorted(rows, key=lambda r: -r[1])[:10]:
        print(f"[{label}]     {ms:.3f} ms x{count // FORWARDS} {name[:110]}")


def wall_ms(fn, iters=10, warmup=3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--canvas", type=int, default=256)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--mode", choices=["cyclegan", "enhanced", "advanced"],
                        default="cyclegan")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; the serving profile runs on the GPU",
              file=sys.stderr)
        return 1
    from multi_style_transfer_gan_tpu_torch.pipelines import (
        load_generator, make_batch_fn,
    )
    from multi_style_transfer_gan_tpu_torch.pipelines.batch import _postprocess

    print(smoke.card_line(), flush=True)
    model = load_generator(smoke.TRAINED, device="cuda")
    x = torch.from_numpy(np.stack(smoke.smooth_images(
        np.random.default_rng(smoke.SEED), args.batch,
        (args.canvas, args.canvas)))).cuda()
    mode = (("cyclegan", "enhanced") if args.mode == "cyclegan"
            else ("local_style", args.mode))
    for engine in smoke.ENGINES:
        fn = make_batch_fn(model, *mode, engine=engine,
                           compute_dtype=torch.bfloat16, device="cuda")
        ms = wall_ms(lambda: fn(x))
        print(f"[{engine}] {args.mode}, canvas {args.canvas}, batch "
              f"{args.batch}, bf16: {args.batch * 1000 / ms:.1f} img/s")
        profile(engine, lambda: fn(x), ms)
    if args.mode != "cyclegan":
        canvas_f = x.float()
        styled = make_batch_fn(model, "cyclegan", device="cuda")(x).float()
        chain = lambda: _postprocess(canvas_f, styled, args.mode, 0.8, 0.7,
                                     True, True)
        profile(f"{args.mode} chain", chain, wall_ms(chain))
    return 0


if __name__ == "__main__":
    sys.exit(main())
