"""CLI: minimal API example on the CUDA device (the reference's
generate_new_image.py:9-113).

Runs a full-size transform: crops dimensions to a multiple of 16 (the
reference crops to 4 for its EnhancedGenerator(64, 3) example,
generate_new_image.py:30-37; the stride-2 ladder and the 4x4 attention
windows need 16), converts, saves, and plots before/after.

  python -m multi_style_transfer_gan_tpu_torch.cli.generate_new_image \\
      --image photo.jpg --model models/G_BA_epoch_200.pth --output out.png
"""

import argparse
import os
import sys

DEVICE = "cuda"   # tests run the CLI on the CPU by replacing this


def transform_full_size(model, img_u8):
    """(H, W, 3) uint8 numpy image -> (the input cropped to multiples of 16,
    the generator's uint8 output at that size), both numpy; the generator
    runs on the model's device."""
    import numpy as np
    import torch

    from ..ops import from_model_range, to_model_range

    h, w = img_u8.shape[:2]
    img = np.ascontiguousarray(img_u8[:(h // 16) * 16, :(w // 16) * 16])
    x = to_model_range(torch.from_numpy(img).to(model.device))[None]
    y = from_model_range(model.apply(x))[0]
    out = torch.clamp(torch.round(y * 255), 0, 255).to(torch.uint8)
    return img, out.cpu().numpy()


def main(argv=None):
    p = argparse.ArgumentParser(description="full-size single transform")
    p.add_argument("--image", type=str, required=True)
    p.add_argument("--model", type=str, required=True)
    p.add_argument("--output", type=str, default="output/new_image.png")
    args = p.parse_args(argv)

    import numpy as np
    import torch
    from PIL import Image

    if not torch.cuda.is_available():
        print("error: no CUDA device; the port runs on the GPU",
              file=sys.stderr)
        return 1
    from ..pipelines import load_generator

    model = load_generator(args.model, device=DEVICE)
    img, out = transform_full_size(
        model, np.asarray(Image.open(args.image).convert("RGB"), np.uint8))
    print(f"processing at {img.shape[1]}x{img.shape[0]} (cropped to /16 "
          f"multiple)")
    os.makedirs(os.path.dirname(os.path.abspath(args.output)) or ".",
                exist_ok=True)
    Image.fromarray(out).save(args.output)
    print(f"saved: {args.output}")

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(12, 6))
    axes[0].imshow(img); axes[0].set_title("input"); axes[0].axis("off")
    axes[1].imshow(out); axes[1].set_title("output"); axes[1].axis("off")
    fig.tight_layout()
    side = os.path.splitext(args.output)[0] + "_comparison.png"
    fig.savefig(side, dpi=110)
    plt.close(fig)
    print(f"comparison: {side}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
