"""CLI: checkpoint/model debugging on the CUDA device (the reference's
debug_model.py:9-100).

Prints parameter names/shapes and, with ``--image``, renders a side-by-side
comparison of the two preprocessing variants (Resize+CenterCrop vs plain
square Resize) through the generator.

  python -m multi_style_transfer_gan_tpu_torch.cli.debug_model \\
      --model models/G_BA_epoch_200.pth --image photo.jpg
"""

import argparse
import os
import sys

DEVICE = "cuda"   # tests run the CLI on the CPU by replacing this


def preprocess_variants(model, img01, size: int = 256) -> dict:
    """The two preprocessing variants of an (H, W, 3) [0, 1] image through
    the generator, on the model's device: {name: (input, output)}, each a
    (size, size, 3) [0, 1] tensor."""
    from ..ops import (
        from_model_range, resize, resize_center_crop, to_model_range,
    )

    img01 = img01.to(model.device)
    variants = {
        "resize_center_crop": resize_center_crop(img01, size),
        "plain_resize": resize(img01, (size, size)),
    }
    return {name: (x, from_model_range(model.apply(to_model_range(x)[None]))[0])
            for name, x in variants.items()}


def main(argv=None):
    p = argparse.ArgumentParser(description="model debug inspection")
    p.add_argument("--model", type=str, required=True)
    p.add_argument("--image", type=str, default=None)
    p.add_argument("--output_dir", type=str, default="output/debug")
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
    # the JAX package's parameter set: BatchNorm's num_batches_tracked aside
    params = {k: v for k, v in model.module.state_dict().items()
              if not k.endswith("num_batches_tracked")}
    print(f"model kind: {model.kind}  channels: {model.channels}  "
          f"direction: {model.direction}")
    print(f"parameters: {len(params)} tensors, "
          f"{sum(v.numel() for v in params.values()):,} elements")
    for k in sorted(params):
        print(f"  {k}: {tuple(params[k].shape)}")

    if args.image:
        os.makedirs(args.output_dir, exist_ok=True)
        img = torch.from_numpy(
            np.asarray(Image.open(args.image).convert("RGB"), np.float32)
            / 255.0)
        variants = preprocess_variants(model, img)
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(2, 2, figsize=(10, 10))
        for col, (name, (x, y)) in enumerate(variants.items()):
            axes[0, col].imshow(x.cpu().numpy())
            axes[0, col].set_title(name)
            axes[1, col].imshow(y.cpu().numpy())
            axes[1, col].set_title(f"output ({name})")
            for r in (0, 1):
                axes[r, col].axis("off")
        out = os.path.join(args.output_dir, "preprocess_comparison.png")
        fig.tight_layout(); fig.savefig(out, dpi=110); plt.close(fig)
        print(f"comparison saved: {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
