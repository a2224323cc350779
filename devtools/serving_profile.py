"""Where a serving forward's device time goes, by kernel family, on the card.

    PYTHONPATH=. python3 devtools/serving_profile.py [--canvas 256] [--batch 64]

Runs the bf16 uint8 -> uint8 stylize program of the trained c16 generator
with each engine (NHWC, packed) on a device-resident batch: first the wall
time of a forward without the profiler (host clock around work ending in a
synchronize), then ``torch.profiler`` over ``FORWARDS`` forwards, its CUDA
entries' ``self_device_time_total`` grouped by kernel name into families
(convolutions and matrix products, elementwise, reductions, copies and
casts, concatenation, the hand-written kernels by name). Prints ms per
forward and share of each family, the device's idle share (1 - device /
wall) and the ten largest kernels. Exits 1 without a CUDA device.
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--canvas", type=int, default=256)
    parser.add_argument("--batch", type=int, default=64)
    args = parser.parse_args(argv)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("error: no CUDA device; the serving profile runs on the GPU",
              file=sys.stderr)
        return 1
    from multi_style_transfer_gan_tpu_torch.pipelines import (
        load_generator, make_batch_fn,
    )

    print(smoke.card_line(), flush=True)
    model = load_generator(smoke.TRAINED, device="cuda")
    x = torch.from_numpy(np.stack(smoke.smooth_images(
        np.random.default_rng(smoke.SEED), args.batch,
        (args.canvas, args.canvas)))).cuda()
    for engine in smoke.ENGINES:
        fn = make_batch_fn(model, "cyclegan", engine=engine,
                           compute_dtype=torch.bfloat16, device="cuda")
        for _ in range(3):
            fn(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fn(x)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 100.0   # ms per forward
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(FORWARDS):
                fn(x)
            torch.cuda.synchronize()
        rows = [(e.key, e.self_device_time_total / FORWARDS / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]
        total = sum(ms for _, ms, _ in rows)
        fams: dict = {}
        for name, ms, _ in rows:
            fams[family(name)] = fams.get(family(name), 0.0) + ms
        print(f"[{engine}] canvas {args.canvas}, batch {args.batch}, bf16: "
              f"{wall:.3f} ms per forward wall ({args.batch * 1000 / wall:.1f} "
              f"img/s), {total:.3f} ms device, idle share "
              f"{max(0.0, 1 - total / wall):.1%}")
        for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
            print(f"[{engine}]   {fam}: {ms:.3f} ms ({ms / total:.1%})")
        for name, ms, count in sorted(rows, key=lambda r: -r[1])[:10]:
            print(f"[{engine}]     {ms:.3f} ms x{count // FORWARDS} "
                  f"{name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
