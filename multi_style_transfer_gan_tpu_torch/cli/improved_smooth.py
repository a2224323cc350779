"""CLI: colour-block artifact repair on the CUDA device (the flags of the
JAX package's ``cli/improved_smooth.py``).

  python -m multi_style_transfer_gan_tpu_torch.cli.improved_smooth \\
      --input stylized.png --original photo.jpg --output fixed.png
"""

import argparse
import os
import sys

DEVICE = "cuda"   # tests run the CLI on the CPU by replacing this


def main(argv=None):
    p = argparse.ArgumentParser(description="fix color-block artifacts")
    p.add_argument("--input", type=str, required=True,
                   help="stylized image with artifacts")
    p.add_argument("--original", type=str, required=True,
                   help="original source image")
    p.add_argument("--output", type=str, required=True)
    args = p.parse_args(argv)

    import numpy as np
    import torch
    from PIL import Image

    if not torch.cuda.is_available():
        print("error: no CUDA device; the port runs on the GPU",
              file=sys.stderr)
        return 1
    from ..ops.smooth import fix_color_blocks

    img = np.asarray(Image.open(args.input).convert("RGB"), np.float32)
    orig = Image.open(args.original).convert("RGB")
    if orig.size != (img.shape[1], img.shape[0]):
        orig = orig.resize((img.shape[1], img.shape[0]), Image.LANCZOS)
    orig = np.asarray(orig, np.float32)

    out = fix_color_blocks(torch.from_numpy(img).to(DEVICE),
                           torch.from_numpy(orig).to(DEVICE))
    out_u8 = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(args.output)) or ".",
                exist_ok=True)
    Image.fromarray(out_u8.cpu().numpy()).save(args.output)
    print(f"saved: {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
