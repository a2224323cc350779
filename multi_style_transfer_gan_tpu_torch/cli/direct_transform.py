"""CLI: single-image transform on the CUDA device (the flags of the JAX
package's ``cli/direct_transform.py``).

  python -m multi_style_transfer_gan_tpu_torch.cli.direct_transform \\
      --image photo.jpg --model models/G_BA_epoch_200.pth --output monet.png

``--spatial N`` splits the image's rows over the first N CUDA cards
(``parallel.spatial``); the size must be divisible by 16 * N, and a host
with fewer cards exits 1. ``--precision int8`` runs the EXPERIMENTAL int8
engine, calibrated on the image itself at ``--size``; it runs its own
program, unsharded, whatever ``--spatial`` says.
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
                   help="'default' lets cuDNN round the generator's "
                        "products to TF32, whose rounding 13 InstanceNorms "
                        "carry to several levels on a few pixels, as far "
                        "as any change of cuDNN's algorithms moves them "
                        "(another batch, --spatial); 'highest' turns TF32 "
                        "off in the generator; 'int8' runs the EXPERIMENTAL "
                        "post-training-quantized engine (enhanced models "
                        "only), calibrated on this image at --size, and "
                        "ignores --spatial")
    p.add_argument("--fast_attention", action="store_true",
                   help="accepted for script compatibility: on a CUDA "
                        "device the hand-written kernels always run")
    p.add_argument("--spatial", type=int, default=0,
                   help="shard the image height over N CUDA cards (for "
                        "sizes whose activations outgrow one card; size "
                        "must be divisible by 16*N). At --precision "
                        "'default' the sharded output lies as far from the "
                        "unsharded one as TF32 moves the unsharded output "
                        "between cuDNN's algorithms; 'highest' keeps it "
                        "within 1 level. Not applied at --precision int8, "
                        "which runs its own program on one device")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; the port runs on the GPU",
              file=sys.stderr)
        return 1
    if (args.spatial > 1 and torch.device(DEVICE).type == "cuda"
            and args.precision != "int8"):
        from ..parallel import spatial_mesh

        try:   # never quietly unsharded on too few cards
            spatial_mesh(args.spatial)
        except ValueError as e:
            print(f"error: --spatial {args.spatial}: {e}", file=sys.stderr)
            return 1
    from ..pipelines import (
        load_generator, test_different_sizes, transform_image,
        try_skip_connections,
    )

    calib = None
    if args.precision == "int8":
        # calibration on this image at the size the run executes at:
        # scales measured at another size would misquantize
        import numpy as np
        from PIL import Image

        from ..ops import resize, to_model_range

        img = np.array(Image.open(args.image).convert("RGB"), np.uint8)
        x01 = resize(torch.from_numpy(img).float() / 255.0,
                     (args.size, args.size))
        calib = [to_model_range(x01)[None].numpy()]
    model = load_generator(args.model, precision=args.precision,
                           calib_batches=calib, device=DEVICE)
    print(f"loaded {model.kind} generator (channels={model.channels}, "
          f"direction={model.direction})")
    out_dir = os.path.dirname(os.path.abspath(args.output)) or "."
    if args.test_sizes:
        print(test_different_sizes(model, args.image, out_dir,
                                   spatial=args.spatial,
                                   fast_attention=args.fast_attention))
    elif args.test_skip:
        print(try_skip_connections(model, args.image, out_dir,
                                   spatial=args.spatial))
    else:
        transform_image(model, args.image, args.output, size=args.size,
                        spatial=args.spatial,
                        fast_attention=args.fast_attention)
        print(f"saved: {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
