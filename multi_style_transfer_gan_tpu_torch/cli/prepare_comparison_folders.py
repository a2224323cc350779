"""CLI: collect prefixed outputs into a clean comparison folder (the flags
of the JAX package's ``cli/prepare_comparison_folders.py``; the reference's
prepare_comparison_folders.py:6-38). Like every CLI of the port it asks for
a CUDA device, though copying files needs none.

  python -m multi_style_transfer_gan_tpu_torch.cli.prepare_comparison_folders \\
      --src_dir out --prefix cyclegan_photo2monet_
"""

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(
        description="move prefixed outputs into a comparison subfolder")
    p.add_argument("--src_dir", type=str, required=True)
    p.add_argument("--prefix", type=str, default="cyclegan_photo2monet_")
    p.add_argument("--dest_name", type=str, default="for_comparison")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; the port runs on the GPU",
              file=sys.stderr)
        return 1
    from ..metrics.evaluation import prepare_comparison_folders

    moved = prepare_comparison_folders(args.src_dir, args.prefix,
                                       args.dest_name)
    print(f"prepared {len(moved)} files")
    for m in moved:
        print(f"  {m}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
