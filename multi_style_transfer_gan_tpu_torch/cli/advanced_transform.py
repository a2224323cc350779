"""CLI: the five-variant advanced transform on the CUDA device (the flags of
the JAX package's ``cli/advanced_transform.py``).

  python -m multi_style_transfer_gan_tpu_torch.cli.advanced_transform \\
      --image photo.jpg --model models/G_BA_epoch_200.pth
"""

import argparse
import sys

DEVICE = "cuda"   # tests run the CLI on the CPU by replacing this


def main(argv=None):
    p = argparse.ArgumentParser(description="advanced multi-variant transform")
    p.add_argument("--image", type=str, required=True)
    p.add_argument("--model", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="output/advanced")
    p.add_argument("--variants", type=str, nargs="*",
                   default=["standard", "contrast", "multiscale", "detail",
                            "local"])
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; the port runs on the GPU",
              file=sys.stderr)
        return 1
    from ..pipelines import load_generator
    from ..pipelines.advanced import generate_with_different_settings

    model = load_generator(args.model, device=DEVICE)
    print(f"loaded {model.kind} generator (channels={model.channels})")
    results = generate_with_different_settings(model, args.image,
                                               args.output_dir,
                                               variants=args.variants)
    for name, path in results.items():
        print(f"{name}: {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
