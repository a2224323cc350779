"""CLI: folder-vs-folder quality comparison on the CUDA device (the flags of
the JAX package's ``cli/compare_image_quality.py``; the reference's
compare_image_quality.py:470-486).

  python -m multi_style_transfer_gan_tpu_torch.cli.compare_image_quality \\
      --base_dir photos --compare_dirs out/cyclegan out/local_style
"""

import argparse
import sys

DEVICE = "cuda"   # tests run the CLI on the CPU by replacing this


def main(argv=None):
    p = argparse.ArgumentParser(description="image quality comparison")
    p.add_argument("--base_dir", type=str, required=True,
                   help="reference/original images folder")
    p.add_argument("--compare_dirs", type=str, nargs="*", default=None)
    p.add_argument("--auto_detect", action="store_true",
                   help="discover sibling folders containing images")
    p.add_argument("--with_test_images", type=str, default=None,
                   help="3-way mode: also compare both folders against this "
                        "test-set folder (compare_with_test_images, "
                        "compare_image_quality.py:61-215)")
    p.add_argument("--output_prefix", type=str, default="comparison")
    p.add_argument("--output_dir", type=str, default=".")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; the port runs on the GPU",
              file=sys.stderr)
        return 1
    from ..metrics.evaluation import complete_comparison, compare_image_quality

    if args.with_test_images:
        if not args.compare_dirs:
            print("error: --with_test_images requires --compare_dirs")
            return 1
        dirs = ([args.base_dir] + args.compare_dirs)[:2]
        out = complete_comparison(args.with_test_images, dirs[0], dirs[-1],
                                  output_dir=args.output_dir, device=DEVICE)
        print("verdict:", out["verdict"])
        print(f"report: {out['xlsx']}")
        return 0

    out = compare_image_quality(args.base_dir, args.compare_dirs,
                                output_prefix=args.output_prefix,
                                output_dir=args.output_dir,
                                auto_detect=args.auto_detect, device=DEVICE)
    for name, res in out["results"].items():
        avg = res["average"]
        if avg:
            print(f"{name}: n={len(res['per_image'])} "
                  f"MSE={avg['mse']:.6f} PSNR={avg['psnr']:.2f}dB "
                  f"SSIM={avg['ssim']:.4f}")
        for n, why in res["skipped"]:
            print(f"  skipped {n}: {why}")
    print(f"report: {out['xlsx']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
