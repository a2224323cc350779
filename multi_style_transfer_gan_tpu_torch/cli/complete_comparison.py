"""CLI: three-folder comparison study on the CUDA device (the flags of the
JAX package's ``cli/complete_comparison.py``).

  python -m multi_style_transfer_gan_tpu_torch.cli.complete_comparison \\
      --original_dir photos --folder_a out/cyclegan --folder_b out/local_style
"""

import argparse
import sys

DEVICE = "cuda"   # tests run the CLI on the CPU by replacing this


def main(argv=None):
    p = argparse.ArgumentParser(description="3-folder quality study")
    p.add_argument("--original_dir", type=str, required=True)
    p.add_argument("--folder_a", type=str, required=True)
    p.add_argument("--folder_b", type=str, required=True)
    p.add_argument("--name_a", type=str, default="cyclegan")
    p.add_argument("--name_b", type=str, default="localstyle")
    p.add_argument("--output_dir", type=str, default=".")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; the port runs on the GPU",
              file=sys.stderr)
        return 1
    from ..metrics.evaluation import complete_comparison

    out = complete_comparison(args.original_dir, args.folder_a, args.folder_b,
                              args.name_a, args.name_b, args.output_dir,
                              device=DEVICE)
    print(f"images compared: {out['n_images']}")
    for name in (args.name_a, args.name_b):
        avg = out[name]
        if avg:
            print(f"{name}: MSE={avg['mse']:.6f} PSNR={avg['psnr']:.2f}dB "
                  f"SSIM={avg['ssim']:.4f}")
    print("win counts:", out["wins"])
    print("verdict:", out["verdict"])
    print(f"report: {out['xlsx']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
