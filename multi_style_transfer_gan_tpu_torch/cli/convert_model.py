"""CLI: checkpoint conversion on the host (the flags of the reference's
convert_model.py:39-45); exits 1 when the conversion fails.

  python -m multi_style_transfer_gan_tpu_torch.cli.convert_model \\
      --input models/cyclegan_epoch_200.pth --output models/flat.pth
"""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(
        description="normalize a checkpoint into a flat state dict")
    p.add_argument("--input", type=str, required=True)
    p.add_argument("--output", type=str, required=True)
    args = p.parse_args(argv)

    from ..weights import convert_model

    ok = convert_model(args.input, args.output)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
