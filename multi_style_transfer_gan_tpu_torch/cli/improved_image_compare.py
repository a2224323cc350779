"""CLI: console-only three-folder quality comparison on the CUDA device (the
flags of the JAX package's ``cli/improved_image_compare.py``).

The reference's improved_image_compare.py:33-191: original vs two result
folders, per-image per-metric better/worse verdicts and overall win
percentages printed to the console (no Excel or chart output).

  python -m multi_style_transfer_gan_tpu_torch.cli.improved_image_compare \\
      --original_dir photos --folder_a out/cyclegan --folder_b out/local_style
"""

import argparse
import sys

DEVICE = "cuda"   # tests run the CLI on the CPU by replacing this


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Console 3-folder quality comparison (per-image verdicts)")
    p.add_argument("--original_dir", type=str, required=True,
                   help="folder of original images (comparison base)")
    p.add_argument("--folder_a", type=str, required=True)
    p.add_argument("--folder_b", type=str, required=True)
    p.add_argument("--name_a", type=str, default="cyclegan")
    p.add_argument("--name_b", type=str, default="localstyle")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; the port runs on the GPU",
              file=sys.stderr)
        return 1
    from ..metrics.evaluation import compare_folder_pair

    res_a = compare_folder_pair(args.original_dir, args.folder_a,
                                device=DEVICE)
    res_b = compare_folder_pair(args.original_dir, args.folder_b,
                                device=DEVICE)
    common = sorted(set(res_a["per_image"]) & set(res_b["per_image"]))
    if not common:
        print("no matching images across all three folders")
        return 0

    # per-metric direction: lower is better for MSE, higher for PSNR and
    # SSIM (improved_image_compare.py:98-128)
    metrics = (("mse", False), ("psnr", True), ("ssim", True))
    wins = {m: {args.name_a: 0, args.name_b: 0, "tie": 0} for m, _ in metrics}

    for n in common:
        ma, mb = res_a["per_image"][n], res_b["per_image"][n]
        print(f"\n{n}:")
        for m, higher in metrics:
            va, vb = ma[m], mb[m]
            if va == vb:
                verdict, winner = "tie", "tie"
            elif (vb > va) == higher:
                verdict, winner = f"{args.name_b} better", args.name_b
            else:
                verdict, winner = f"{args.name_a} better", args.name_a
            wins[m][winner] += 1
            print(f"  {m.upper():5s} {args.name_a}={va:.6f} "
                  f"{args.name_b}={vb:.6f}  -> {verdict}")

    n = len(common)
    print(f"\n=== Summary over {n} images ===")
    for nm, res in ((args.name_a, res_a), (args.name_b, res_b)):
        avg = res["average"]
        print(f"{nm}: avg MSE={avg['mse']:.6f} PSNR={avg['psnr']:.2f}dB "
              f"SSIM={avg['ssim']:.4f}")
    for m, _ in metrics:
        wa, wb = wins[m][args.name_a], wins[m][args.name_b]
        print(f"{m.upper():5s} win rate: {args.name_a} {100.0 * wa / n:.1f}%  "
              f"{args.name_b} {100.0 * wb / n:.1f}%")

    total_b = sum(wins[m][args.name_b] for m, _ in metrics)
    total_a = sum(wins[m][args.name_a] for m, _ in metrics)
    better = args.name_b if total_b >= total_a else args.name_a
    print(f"overall: {better} wins {max(total_a, total_b)}/{3 * n} "
          "metric comparisons")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
