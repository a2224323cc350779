"""CLI: batch folder processing on the CUDA device (the flags of the JAX
package's ``cli/batch_process_images.py``).

Model files follow the reference's fixed layout under --models_dir
(default ./models): cyclegan_epoch_200.pth, G_AB_epoch_200.pth,
G_BA_epoch_200.pth.

  python -m multi_style_transfer_gan_tpu_torch.cli.batch_process_images \\
      --input_dir photos --models_dir models --bf16
"""

import argparse
import os
import sys

DEVICE = "cuda"   # tests run the CLI on the CPU by replacing this


def main(argv=None):
    p = argparse.ArgumentParser(description="batch style-transfer processing")
    p.add_argument("--input_dir", type=str, default="test_images")
    p.add_argument("--output_dir", type=str, default="output/batch")
    p.add_argument("--mode", choices=["cyclegan", "local_style"],
                   default="cyclegan")
    p.add_argument("--direction", choices=["photo2monet", "monet2photo"],
                   default="photo2monet")
    p.add_argument("--local_style_mode",
                   choices=["simple", "enhanced", "advanced"],
                   default="enhanced")
    p.add_argument("--strength", type=float, default=0.8)
    p.add_argument("--detail", type=float, default=0.7)
    p.add_argument("--enhance_colors", action="store_true", default=True)
    p.add_argument("--no_enhance_colors", dest="enhance_colors",
                   action="store_false")
    p.add_argument("--smooth", action="store_true", default=True)
    p.add_argument("--no_smooth", dest="smooth", action="store_false")
    p.add_argument("--models_dir", type=str, default="models")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 generator compute (torch.bfloat16)")
    p.add_argument("--fast_attention", action="store_true",
                   help="accepted for script compatibility: on a CUDA "
                        "device the hand-written kernels always run")
    p.add_argument("--engine", choices=["auto", "nhwc", "packed", "int8"],
                   default="auto",
                   help="generator engine: nhwc, or packed (the "
                        "space-to-depth engine, same math, canvas a multiple "
                        "of 32); auto takes packed at a batch of 32 or less "
                        "(after the small-folder shrink) and nhwc above; "
                        "int8 is the EXPERIMENTAL post-training-quantized "
                        "engine, calibrated on the folder's first 8 images "
                        "(a plain checkpoint runs nhwc)")
    p.add_argument("--canvas", type=int, default=256,
                   help="working resolution (multiple of 32; the reference"
                        " fixes 256)")
    p.add_argument("--data_parallel", action="store_true",
                   help="one process over every local CUDA device: a "
                        "replica of the program on each, every batch "
                        "rounded up to a multiple of the device count and "
                        "split among them")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; the port runs on the GPU",
              file=sys.stderr)
        return 1
    from ..pipelines import batch_process, load_generator

    if args.mode == "cyclegan":
        path = os.path.join(args.models_dir, "cyclegan_epoch_200.pth")
        prefer = ("G_AB_state_dict" if args.direction == "monet2photo"
                  else "G_BA_state_dict")
        if not os.path.exists(path):
            print(f"error: missing CycleGAN model at {path}")
            return 1
        model = load_generator(path, prefer=prefer, device=DEVICE)
    else:
        name = ("G_AB_epoch_200.pth" if args.direction == "monet2photo"
                else "G_BA_epoch_200.pth")
        path = os.path.join(args.models_dir, name)
        if not os.path.exists(path):
            print(f"error: missing enhanced model at {path}")
            return 1
        model = load_generator(path, device=DEVICE)
    print(f"loaded {model.kind} generator (channels={model.channels})")

    where = {"device": DEVICE}
    if args.data_parallel:
        from ..parallel import local_devices

        where = {"devices": local_devices()}
        print(f"data-parallel over {len(where['devices'])} devices")
    batch_process(model, args.input_dir, args.output_dir, mode=args.mode,
                  local_style_mode=args.local_style_mode,
                  direction=args.direction, strength=args.strength,
                  detail=args.detail, enhance_colors=args.enhance_colors,
                  smooth=args.smooth, batch_size=args.batch_size,
                  compute_dtype=torch.bfloat16 if args.bf16 else None,
                  engine=args.engine, canvas=args.canvas, **where)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
