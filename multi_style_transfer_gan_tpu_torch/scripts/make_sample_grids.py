"""Render the trained-model sample grids (input | output | ground truth) on
the CUDA device (the flags of the JAX repo's ``scripts/make_sample_grids.py``).

For a pair of selected checkpoints: the first --n test images per
direction, each row input -> generator output -> the shipped closed-form
ground truth, saved as JPEG at quality 92.

  python -m multi_style_transfer_gan_tpu_torch.scripts.make_sample_grids \\
      --selected_dir runs/selected --data_root data/synth_monet2photo \\
      --output_dir trained/samples
"""

import argparse
import os
import sys

import numpy as np
from PIL import Image

from .select_checkpoints import forward_u8, load_batch

DEVICE = "cuda"   # tests run the script on the CPU by replacing this


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--selected_dir", required=True)
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--n", type=int, default=4)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; the port runs on the GPU",
              file=sys.stderr)
        return 1
    from ..pipelines import load_generator

    os.makedirs(args.output_dir, exist_ok=True)
    cases = [("BA", "testB", "truth_monet_for_testB", "photo2monet"),
             ("AB", "testA", "truth_photo_for_testA", "monet2photo")]
    for key, src, truth, label in cases:
        names = sorted(os.listdir(os.path.join(args.data_root, src)))[:args.n]
        inputs = load_batch(os.path.join(args.data_root, src), names)
        truths = load_batch(os.path.join(args.data_root, truth), names)
        model = load_generator(
            os.path.join(args.selected_dir, f"G_{key}_epoch_0.pth"),
            prefer=f"G_{key}_state_dict", device=DEVICE)
        outs = forward_u8(model, inputs)
        rows = [np.concatenate([i, o, t], axis=1)
                for i, o, t in zip(inputs, outs, truths)]
        grid = np.concatenate(rows, axis=0)
        out = os.path.join(args.output_dir,
                           f"{label}_input_output_truth.jpg")
        Image.fromarray(grid).save(out, quality=92)
        print(f"saved {out} ({grid.shape[1]}x{grid.shape[0]})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
