"""CLI: region-adaptive local style transfer on the CUDA device (the flags
of the JAX package's ``cli/enhanced_local_style.py``).

  python -m multi_style_transfer_gan_tpu_torch.cli.enhanced_local_style \\
      --image photo.jpg --model models/G_BA_epoch_200.pth
"""

import argparse
import sys

DEVICE = "cuda"   # tests run the CLI on the CPU by replacing this


def main(argv=None):
    p = argparse.ArgumentParser(description="region-adaptive style transfer")
    p.add_argument("--image", type=str, required=True)
    p.add_argument("--model", type=str, required=True)
    p.add_argument("--output", type=str, default="output/enhanced_local.png")
    p.add_argument("--method",
                   choices=["felzenszwalb", "slic", "quickshift"],
                   default="felzenszwalb")
    p.add_argument("--no_comparison", action="store_true")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; the port runs on the GPU",
              file=sys.stderr)
        return 1
    from ..pipelines import load_generator
    from ..pipelines.local_style import enhanced_local_style_transfer

    model = load_generator(args.model, device=DEVICE)
    print(f"loaded {model.kind} generator (channels={model.channels})")
    enhanced_local_style_transfer(model, args.image, args.output,
                                  method=args.method,
                                  make_comparison=not args.no_comparison)
    print(f"saved: {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
