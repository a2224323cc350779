"""Reproduce the reference's published 54-image quality study on the CUDA
device (the flags of the JAX repo's ``scripts/reproduce_quality_study.py``).

The reference ships its results as Excel files (extracted into BASELINE.md
as the quality bar). Given the monet2photo dataset and the reference
checkpoints, this regenerates the study and prints a diff against the
published numbers:

  1. take up to --max_images photos from {data_root}/testB,
  2. run the plain CycleGAN generator over them (mode=cyclegan,
     photo2monet: the batch pipeline),
  3. run the enhanced generator with local-style 'enhanced' post-processing,
  4. run the 3-folder detailed comparison (detailed_metrics_comparison.xlsx,
     charts, win statistics),
  5. print computed vs published averages and win rates with deltas.

Usage:
  python -m multi_style_transfer_gan_tpu_torch.scripts.reproduce_quality_study \\
      --data_root data/monet2photo --models_dir models \\
      [--output_dir output/quality_study]

  # smoke (no dataset or checkpoints: synthetic photos, seeded random models):
  python -m multi_style_transfer_gan_tpu_torch.scripts.reproduce_quality_study \\
      --synthetic
"""

import argparse
import os
import shutil
import sys
import tempfile

DEVICE = "cuda"   # tests run the script on the CPU by replacing this

# Published values extracted from the reference's shipped Excel files
# (BASELINE.md "Detailed 54-image study" and its win-rate tables).
PUBLISHED = {
    "n_images": 54,
    "cyclegan": {"mse": 0.011143, "psnr": 19.93, "ssim": 0.5318},
    "localstyle": {"mse": 0.008828, "psnr": 21.12, "ssim": 0.7852},
    "localstyle_win_rate": {"mse": 70.4, "psnr": 70.4, "ssim": 98.1},
}


def _stage_inputs(data_root, out_dir, max_images):
    """Copy the first N testB photos into a clean originals folder."""
    src = os.path.join(data_root, "testB")
    if not os.path.isdir(src):
        raise SystemExit(f"no testB folder under {data_root}")
    names = sorted(n for n in os.listdir(src)
                   if n.lower().endswith((".jpg", ".jpeg", ".png")))
    if not names:
        raise SystemExit(f"no images in {src}")
    originals = os.path.join(out_dir, "originals")
    os.makedirs(originals, exist_ok=True)
    for n in names[:max_images]:
        shutil.copy2(os.path.join(src, n), os.path.join(originals, n))
    return originals


def run_study(originals, cyclegan_model, enhanced_model, output_dir,
              batch_size=16, canvas=256):
    """The two batch runs on the models' device, then the comparison."""
    from ..metrics.evaluation import complete_comparison
    from ..pipelines.batch import batch_process

    work = os.path.join(output_dir, "outputs")
    batch_process(cyclegan_model, originals, work, mode="cyclegan",
                  direction="photo2monet", batch_size=batch_size,
                  canvas=canvas, device=cyclegan_model.device)
    batch_process(enhanced_model, originals, work, mode="local_style",
                  local_style_mode="enhanced", direction="photo2monet",
                  batch_size=batch_size, canvas=canvas,
                  device=enhanced_model.device)
    return complete_comparison(
        originals,
        os.path.join(work, "cyclegan_photo2monet"),
        os.path.join(work, "local_style_enhanced_photo2monet"),
        name_a="cyclegan", name_b="localstyle", output_dir=output_dir,
        device=enhanced_model.device)


def print_diff(results):
    n = results["n_images"]
    print(f"\n=== computed vs published (n={n} vs "
          f"{PUBLISHED['n_images']} images) ===")
    rows = []
    for model in ("cyclegan", "localstyle"):
        got = results.get(model) or {}
        for metric in ("mse", "psnr", "ssim"):
            pub = PUBLISHED[model][metric]
            val = got.get(metric)
            d = None if val is None else val - pub
            rows.append((f"{model} avg {metric}", pub, val, d))
    wins = results["wins"]["localstyle"]
    for metric in ("mse", "psnr", "ssim"):
        pub = PUBLISHED["localstyle_win_rate"][metric]
        val = 100.0 * wins[metric] / max(n, 1)
        rows.append((f"localstyle win% {metric}", pub, val, val - pub))
    print(f"{'quantity':28s} {'published':>10s} {'computed':>10s} "
          f"{'delta':>9s}")
    for name, pub, val, d in rows:
        vs = "   n/a" if val is None else f"{val:10.4f}"
        ds = "" if d is None else f"{d:+9.4f}"
        print(f"{name:28s} {pub:10.4f} {vs} {ds}")
    print(f"verdict: {results['verdict']}")
    print(f"tables:  {results['xlsx']}")


def random_models():
    """The smoke's generators as state dicts: a plain c8 and an enhanced c4
    with one transformer block, each from the port's init law on a seeded
    ``torch.Generator`` (seeds 0 and 1)."""
    import torch

    from ..models import EnhancedGenerator, PlainGenerator

    plain = PlainGenerator(8, generator=torch.Generator().manual_seed(0))
    enhanced = EnhancedGenerator(4, 1,
                                 generator=torch.Generator().manual_seed(1))
    return plain.state_dict(), enhanced.state_dict()


def synthetic_smoke(output_dir=None, canvas=64, n_images=6, seed=0):
    """An end-to-end run without the dataset or checkpoints: tiny synthetic
    photos and seeded random generators through the stage, forward, post
    chain, comparison and xlsx, on ``DEVICE``."""
    import numpy as np
    from PIL import Image

    from ..pipelines import model_from_state_dict

    td = output_dir or tempfile.mkdtemp(prefix="quality_study_")
    root = os.path.join(td, "monet2photo", "testB")
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n_images):
        g = np.linspace(40, 215, canvas)
        img = np.stack([np.add.outer(g, g[::-1]) / 2.0 + 20 * c
                        for c in range(3)], -1)
        img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255
                      ).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(root, f"photo_{i}.jpg"),
                                  quality=92)

    plain_sd, enhanced_sd = random_models()
    plain = model_from_state_dict(plain_sd, direction="BA", device=DEVICE)
    enh = model_from_state_dict(enhanced_sd, direction="BA", device=DEVICE)

    out_dir = os.path.join(td, "study")
    originals = _stage_inputs(os.path.join(td, "monet2photo"), out_dir,
                              n_images)
    results = run_study(originals, plain, enh, out_dir, batch_size=4,
                        canvas=canvas)
    print_diff(results)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data_root", type=str, default="data/monet2photo")
    ap.add_argument("--models_dir", type=str, default="models")
    ap.add_argument("--output_dir", type=str, default="output/quality_study")
    ap.add_argument("--max_images", type=int, default=54)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--synthetic", action="store_true",
                    help="smoke mode: synthetic data + random-init models")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; the port runs on the GPU",
              file=sys.stderr)
        return 1
    if args.synthetic:
        synthetic_smoke()
        return 0

    from ..pipelines import load_generator

    cyc_path = os.path.join(args.models_dir, "cyclegan_epoch_200.pth")
    enh_path = os.path.join(args.models_dir, "G_BA_epoch_200.pth")
    for p in (cyc_path, enh_path):
        if not os.path.exists(p):
            raise SystemExit(f"missing checkpoint: {p} (reference layout — "
                             "batch_process_images.py:66,91,107)")
    plain = load_generator(cyc_path, prefer="G_BA_state_dict", device=DEVICE)
    enh = load_generator(enh_path, device=DEVICE)

    os.makedirs(args.output_dir, exist_ok=True)
    originals = _stage_inputs(args.data_root, args.output_dir,
                              args.max_images)
    results = run_study(originals, plain, enh, args.output_dir,
                        batch_size=args.batch_size)
    print_diff(results)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
