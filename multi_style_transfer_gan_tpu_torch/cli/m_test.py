"""CLI: FID evaluation of a generator pair over the test split, on the CUDA
device (the flags of the JAX package's ``cli/m_test.py``; the reference's
m_test.py).

  python -m multi_style_transfer_gan_tpu_torch.cli.m_test \\
      --data_root data/monet2photo --g_ab models/G_AB_epoch_200.pth \\
      --g_ba models/G_BA_epoch_200.pth --inception_weights inception_v3.pth
"""

import argparse
import sys

DEVICE = "cuda"   # tests run the CLI on the CPU by replacing this


def main(argv=None):
    p = argparse.ArgumentParser(description="FID evaluation")
    p.add_argument("--data_root", type=str, required=True)
    p.add_argument("--g_ab", type=str, default="models/G_AB_epoch_200.pth")
    p.add_argument("--g_ba", type=str, default="models/G_BA_epoch_200.pth")
    p.add_argument("--output_dir", type=str, default="output/m_test")
    p.add_argument("--max_images", type=int, default=100)
    p.add_argument(
        "--inception_weights", type=str, default=None,
        help="torchvision inception_v3 state_dict .pth; when given, FID uses "
             "real InceptionV3 pool features (m_test.py:16-34 parity) "
             "instead of the fallback pooled image statistics")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; the port runs on the GPU",
              file=sys.stderr)
        return 1
    from ..metrics.fid_harness import run_fid_eval
    from ..pipelines import load_generator

    feature_fn = None
    if args.inception_weights:
        from ..metrics.inception import make_inception_feature_fn
        feature_fn = make_inception_feature_fn(args.inception_weights,
                                               device=DEVICE)

    g_ab = load_generator(args.g_ab, device=DEVICE)
    g_ba = load_generator(args.g_ba, device=DEVICE)
    results = run_fid_eval(g_ab, g_ba, args.data_root, args.output_dir,
                           max_images=args.max_images, feature_fn=feature_fn)
    print(results)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
