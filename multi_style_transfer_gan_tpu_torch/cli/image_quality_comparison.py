"""CLI: two-folder comparison with an Excel report and a chart, on the CUDA
device (the flags of the JAX package's ``cli/image_quality_comparison.py``;
the reference's image_quality_comparison.py:36-188).

  python -m multi_style_transfer_gan_tpu_torch.cli.image_quality_comparison \\
      --dir_a photos --dir_b out/cyclegan --output_dir report
"""

import argparse
import os
import sys

DEVICE = "cuda"   # tests run the CLI on the CPU by replacing this


def main(argv=None):
    p = argparse.ArgumentParser(description="two-folder quality comparison")
    p.add_argument("--dir_a", type=str, required=True)
    p.add_argument("--dir_b", type=str, required=True)
    p.add_argument("--output_dir", type=str, default=".")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; the port runs on the GPU",
              file=sys.stderr)
        return 1
    from ..metrics.evaluation import compare_folder_pair
    from ..metrics.report import comparison_bar_chart, write_xlsx

    res = compare_folder_pair(args.dir_a, args.dir_b, device=DEVICE)
    detailed = [["image", "mse", "psnr", "ssim"]]
    for name, m in res["per_image"].items():
        detailed.append([name, m["mse"], m["psnr"], m["ssim"]])
    summary = [["metric", "average"]]
    for k, v in res["average"].items():
        summary.append([k, v])
        print(f"{k}: {v:.6f}")
    os.makedirs(args.output_dir, exist_ok=True)
    xlsx = os.path.join(args.output_dir, "image_comparison_results.xlsx")
    write_xlsx(xlsx, {"Detailed": detailed, "Summary": summary})
    if res["average"]:
        comparison_bar_chart(
            os.path.join(args.output_dir, "image_comparison_results_charts.png"),
            list(res["average"].keys()),
            {"average": list(res["average"].values())},
            "folder comparison", "value")
    print(f"report: {xlsx}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
