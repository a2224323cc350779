"""CLI: single-image transform on the CUDA device (the flags of the JAX
package's ``cli/direct_transform.py``).

  python -m multi_style_transfer_gan_tpu_torch.cli.direct_transform \\
      --image photo.jpg --model models/G_BA_epoch_200.pth --output monet.png
"""

import argparse
import os
import sys

DEVICE = "cuda"   # tests run the CLI on the CPU by replacing this


def main(argv=None):
    p = argparse.ArgumentParser(description="single-image style transfer")
    p.add_argument("--image", type=str, required=True)
    p.add_argument("--model", type=str, required=True)
    p.add_argument("--output", type=str, default="output.png")
    p.add_argument("--test_sizes", action="store_true",
                   help="sweep 128/256/512/768 and save a comparison grid")
    p.add_argument("--test_skip", action="store_true",
                   help="blend output with input at 50/30/10%%")
    p.add_argument("--size", type=int, default=256,
                   help="square working size, a multiple of 16")
    p.add_argument("--precision",
                   choices=["default", "high", "highest", "int8"],
                   default="default",
                   help="'highest' turns TF32 off in the generator; 'int8' "
                        "is not ported")
    p.add_argument("--fast_attention", action="store_true",
                   help="accepted for script compatibility: on a CUDA "
                        "device the hand-written kernels always run")
    p.add_argument("--spatial", type=int, default=0,
                   help="not ported yet (height-sharded multi-device "
                        "forward)")
    args = p.parse_args(argv)

    import torch

    if args.spatial > 1:
        print("error: --spatial is not ported yet", file=sys.stderr)
        return 2
    if args.precision == "int8":
        print("error: --precision int8 is not ported", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("error: no CUDA device; the port runs on the GPU",
              file=sys.stderr)
        return 1
    from ..pipelines import (
        load_generator, test_different_sizes, transform_image,
        try_skip_connections,
    )

    model = load_generator(args.model, precision=args.precision,
                           device=DEVICE)
    print(f"loaded {model.kind} generator (channels={model.channels}, "
          f"direction={model.direction})")
    out_dir = os.path.dirname(os.path.abspath(args.output)) or "."
    if args.test_sizes:
        print(test_different_sizes(model, args.image, out_dir))
    elif args.test_skip:
        print(try_skip_connections(model, args.image, out_dir))
    else:
        transform_image(model, args.image, args.output, size=args.size)
        print(f"saved: {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
