"""CLI: print a checkpoint's tensor names and shapes on the host (the
reference's pth_info.py).

  python -m multi_style_transfer_gan_tpu_torch.cli.pth_info model.pth
"""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="inspect a .pth checkpoint")
    p.add_argument("path", type=str)
    args = p.parse_args(argv)

    from ..weights import pth_info

    pth_info(args.path)


if __name__ == "__main__":
    main()
