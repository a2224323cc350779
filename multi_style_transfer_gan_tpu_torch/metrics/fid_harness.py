"""FID evaluation harness (port of ``metrics/fid_harness.py``).

The reference's flow (m_test.py:81-227): load both generators, run up to
100 test images per direction, save side-by-side panels (display
processing = gamma 1.1 + YUV luma histogram equalization, :52-78), take
InceptionV3 pool features, FID through the matrix square root (:37-50),
and write test_results.txt with the per-direction and mean FID (:221-225).

The generators and the features run on the generators' device; the images
decode on the host and the statistic runs there in float64. The feature
extractor is pluggable: ``feature_fn`` (for example
``metrics.inception.make_inception_feature_fn`` on a user's torchvision
weights), or ``default_feature_fn``, pooled multi-scale image statistics,
whose FID values compare between runs of this code but not with published
Inception-based FID numbers.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..data import ImageFolderDataset
from ..ops import from_model_range, resize, to_model_range
from ..ops.color import rgb_to_yuv, yuv_to_rgb
from ..ops.filters import equalize_hist
from .fid import fid_from_features


def display_process(img01: torch.Tensor) -> torch.Tensor:
    """m_test.py:52-78: gamma 1.1 and YUV luma equalization for display."""
    g = torch.clamp(img01, 0, 1) ** (1.0 / 1.1)
    yuv = rgb_to_yuv(g * 255.0)
    yeq = equalize_hist(yuv[..., 0])
    out = yuv_to_rgb(torch.stack([yeq, yuv[..., 1], yuv[..., 2]], -1))
    return torch.clamp(out, 0, 255) / 255.0


def default_feature_fn(imgs01: torch.Tensor) -> np.ndarray:
    """Fallback features: multi-scale pooled colour and gradient statistics,
    (N, H, W, 3) in [0, 1] -> (N, D), on the device of ``imgs01``. NOT
    Inception features (see the module docstring)."""
    feats = []
    x = imgs01.float()
    for size in (32, 16, 8):
        r = resize(x, (size, size), method="bilinear")
        feats.append(r.reshape(r.shape[0], -1))
        dx = torch.diff(r, dim=2).reshape(r.shape[0], -1)
        dy = torch.diff(r, dim=1).reshape(r.shape[0], -1)
        feats.append(torch.cat([dx.abs().mean(dim=-1, keepdim=True),
                                dy.abs().mean(dim=-1, keepdim=True)], -1))
    return torch.cat(feats, dim=-1).cpu().numpy()


def run_fid_eval(g_ab, g_ba, data_root, output_dir, *, max_images: int = 100,
                 feature_fn=None, batch: int = 16, save_panels: bool = True):
    """FID of both directions on the test split: ``g_ab`` (a ``LoadedModel``)
    on ``testA`` against ``testB``, ``g_ba`` on ``testB`` against
    ``testA``. Returns {direction: FID, "mean": ...} and writes
    test_results.txt in m_test.py's format (:221-225)."""
    feature_fn = feature_fn or default_feature_fn
    os.makedirs(output_dir, exist_ok=True)
    results = {}

    for direction, model, src_dom, tgt_dom in (
            ("monet2photo", g_ab, "A", "B"),
            ("photo2monet", g_ba, "B", "A")):
        src = ImageFolderDataset(data_root, src_dom, split="test",
                                 host_size=256)
        tgt = ImageFolderDataset(data_root, tgt_dom, split="test",
                                 host_size=256)
        n = min(len(src), max_images)
        n_t = min(len(tgt), max_images)
        if n < 2 or n_t < 2:
            # np.cov of one sample is NaN and the Frechet square root blows
            # up: FID needs at least 2 images a side
            print(f"{direction}: need >= 2 test images per domain "
                  f"(have {n}/{n_t}), skipping")
            continue

        dev = model.device
        fake_feats, real_feats = [], []
        for i in range(0, n, batch):
            imgs = np.stack([src._square(src.load(j))
                             for j in range(i, min(i + batch, n))])
            x = to_model_range(torch.from_numpy(imgs).to(dev))
            fake01 = from_model_range(model.apply(x))
            fake_feats.append(feature_fn(fake01))
            if save_panels and i == 0:
                _save_panels(imgs, fake01, direction, output_dir)
        for i in range(0, n_t, batch):
            imgs = np.stack([tgt._square(tgt.load(j))
                             for j in range(i, min(i + batch, n_t))])
            real_feats.append(feature_fn(
                torch.from_numpy(imgs).to(dev).float() / 255.0))

        fid = fid_from_features(np.concatenate(fake_feats),
                                np.concatenate(real_feats))
        results[direction] = fid
        print(f"{direction}: FID = {fid:.4f} ({n} generated vs {n_t} real)")

    if results:
        results["mean"] = float(np.mean(list(results.values())))
        with open(os.path.join(output_dir, "test_results.txt"), "w") as f:
            for k, v in results.items():
                f.write(f"{k} FID: {v:.4f}\n")
    return results


def _save_panels(inputs_u8, outputs01, direction, output_dir, max_panels=4):
    from ..utils.figures import have_matplotlib, panel_grid

    shown = display_process(outputs01[:max_panels]).cpu().numpy()
    if not have_matplotlib():
        n = min(max_panels, len(inputs_u8))
        titles = ["input"] + [""] * (n - 1)
        titles += ["generated (display-processed)"] + [""] * (n - 1)
        panel_grid(zip(list(inputs_u8[:n]) + list(shown[:n]), titles), n,
                   os.path.join(output_dir, f"panels_{direction}.png"))
        return
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, max_panels, figsize=(4 * max_panels, 8))
    for i in range(min(max_panels, len(inputs_u8))):
        axes[0, i].imshow(inputs_u8[i]); axes[0, i].axis("off")
        axes[1, i].imshow(shown[i]); axes[1, i].axis("off")
    axes[0, 0].set_title("input")
    axes[1, 0].set_title("generated (display-processed)")
    fig.tight_layout()
    fig.savefig(os.path.join(output_dir, f"panels_{direction}.png"), dpi=100)
    plt.close(fig)
