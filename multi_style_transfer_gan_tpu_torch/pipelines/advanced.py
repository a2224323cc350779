"""Advanced single-image pipeline, five named variants (port of
``pipelines/advanced.py``; the reference's advanced_transform.py).

Variants (generate_with_different_settings, advanced_transform.py:44-91):
- standard      plain forward, (x + 1) / 2 (:130-134)
- contrast      brightness/contrast jitter before the forward, CLAHE(2.0,
                8x8) on LAB L and saturation x1.2 after (:137-166)
- multiscale    the source at scales 0.5 / 0.75 / 1.0, each resized back to
                256^2, fused 0.2 / 0.3 / 0.5, brightness x1.1 (:169-215)
- detail        a Gaussian (sigma 3) high-pass of the original added to LAB
                L x0.5, saturation x1.2, value x1.1 (:218-258)
- local         K-means (K = 5) over the original's pixels, blend ratios 0.8
                (cluster 0) / 0.4 (cluster 1) / 0.6 (the rest), saturation
                x1.2 (:261-311)

Every forward of the pipeline is one generator call on the stacked variants
(standard, contrast and the three scales), and the colour chains run on the
model's device; K-means runs on the host in numpy, as in the JAX package.
The jitter uses fixed factors (the reference draws random ones).
"""

from __future__ import annotations

import os

import numpy as np
import torch
from PIL import Image

from ..ops import from_model_range, resize, to_model_range
from ..ops.clahe import clahe
from ..ops.color import hsv_to_rgb, rgb_to_gray, rgb_to_hsv, rgb_to_lab
from ..ops.filters import gaussian_filter
from .model_loader import LoadedModel

VARIANTS = ("standard", "contrast", "multiscale", "detail", "local")
_MS_SCALES = (0.5, 0.75, 1.0)
_MS_WEIGHTS = (0.2, 0.3, 0.5)


def _lab_l_to_rgb(lab_l_new, rgb_ref):
    """rgb_ref with its LAB L channel replaced by lab_l_new, approximated by
    scaling the RGB values by the ratio of the Ls (the JAX package's
    approximation of cv2's LAB round trip)."""
    lab = rgb_to_lab(rgb_ref)
    L = torch.clamp(lab[..., 0:1], min=1e-3)
    ratio = lab_l_new[..., None] / L
    return torch.clamp(rgb_ref * ratio, 0, 255)


def _saturate(rgb, s_mul=1.2, v_mul=1.0):
    hsv = rgb_to_hsv(torch.clamp(rgb, 0, 255))
    s = torch.clamp(hsv[..., 1] * s_mul, 0, 255)
    v = torch.clamp(hsv[..., 2] * v_mul, 0, 255)
    return torch.clamp(hsv_to_rgb(torch.stack([hsv[..., 0], s, v], -1)),
                       0, 255)


def _color_jitter(img01, brightness=1.05, contrast=1.1):
    out = img01 * brightness
    mean = torch.mean(rgb_to_gray(out * 255.0)) / 255.0
    out = (out - mean) * contrast + mean
    return torch.clamp(out, 0, 1)


def _kmeans(pixels: np.ndarray, k: int = 5, iters: int = 10,
            attempts: int = 10, seed: int = 0) -> np.ndarray:
    """cv2.kmeans-style Lloyd iterations from random centres, best of
    ``attempts`` (host numpy, the JAX package's code and seed)."""
    rng = np.random.default_rng(seed)
    best_labels, best_inertia = None, np.inf
    for _ in range(attempts):
        centers = pixels[rng.choice(len(pixels), k, replace=False)]
        for _ in range(iters):
            d = ((pixels[:, None, :] - centers[None]) ** 2).sum(-1)
            labels = d.argmin(1)
            for j in range(k):
                sel = pixels[labels == j]
                if len(sel):
                    centers[j] = sel.mean(0)
        inertia = ((pixels - centers[labels]) ** 2).sum()
        if inertia < best_inertia:
            best_inertia, best_labels = inertia, labels
    return best_labels


def render_variants(model: LoadedModel, image_path, variants=VARIANTS,
                    jitter=(1.05, 1.1)):
    """Every requested variant of the image at ``image_path`` on the model's
    device, in the order of ``VARIANTS``: returns (the original as a uint8
    array, {variant: (256, 256, 3) uint8 tensor})."""
    dev = model.device
    src = Image.open(image_path).convert("RGB")
    orig_np = np.array(src, np.uint8)
    orig256 = np.array(src.resize((256, 256), Image.LANCZOS), np.uint8)

    img01 = torch.from_numpy(orig_np).to(dev).float() / 255.0
    base01 = resize(img01, (256, 256))

    # one batched forward for every model call the variants need
    inputs = [base01]                               # standard (+ detail/local)
    if "contrast" in variants:
        inputs.append(_color_jitter(base01, *jitter))
    if "multiscale" in variants:
        w, h = src.size
        for s in _MS_SCALES:
            scaled = resize(img01, (max(1, int(h * s)), max(1, int(w * s))))
            inputs.append(resize(scaled, (256, 256)))
    batch = to_model_range(torch.stack(inputs))
    outs255 = from_model_range(model.apply(batch).float()) * 255.0

    idx = 0
    styled = outs255[idx]; idx += 1
    styled_contrast = None
    if "contrast" in variants:
        styled_contrast = outs255[idx]; idx += 1
    ms_outs = []
    if "multiscale" in variants:
        ms_outs = [outs255[idx + i] for i in range(len(_MS_SCALES))]
        idx += len(_MS_SCALES)

    out = {}
    if "standard" in variants:
        out["standard"] = styled

    if "contrast" in variants:
        lab = rgb_to_lab(styled_contrast)
        l_eq = clahe(lab[..., 0], 2.0, 8)
        out["contrast"] = _saturate(_lab_l_to_rgb(l_eq, styled_contrast), 1.2)

    if "multiscale" in variants:
        fused = sum(o / 255.0 * w for o, w in zip(ms_outs, _MS_WEIGHTS))
        out["multiscale"] = torch.clamp(fused * 1.1, 0, 1) * 255.0

    if "detail" in variants:
        og = rgb_to_gray(torch.from_numpy(orig256).to(dev).float())
        detail_layer = og - gaussian_filter(og, 3.0)
        lab = rgb_to_lab(styled)
        l_new = torch.clamp(lab[..., 0] + detail_layer * 0.5, 0, 255)
        out["detail"] = _saturate(_lab_l_to_rgb(l_new, styled), 1.2, 1.1)

    if "local" in variants:
        labels = _kmeans(orig256.reshape(-1, 3).astype(np.float32))
        labels = labels.reshape(256, 256)
        ratios = np.full(5, 0.6, np.float32)
        ratios[0], ratios[1] = 0.8, 0.4   # :289-295
        ratio_map = torch.from_numpy(ratios[labels]).to(dev)[..., None]
        orig_f = torch.from_numpy(orig256).to(dev).float()
        blended = styled * ratio_map + orig_f * (1 - ratio_map)
        out["local"] = _saturate(blended, 1.2)

    return orig_np, {name: torch.clamp(torch.round(arr), 0, 255).to(
        torch.uint8) for name, arr in out.items()}


def generate_with_different_settings(model: LoadedModel, image_path,
                                     output_dir, variants=VARIANTS,
                                     jitter=(1.05, 1.1)) -> dict:
    """Run every requested variant on the model's device; saves each as
    ``{kind}_{variant}.jpg`` and a comparison grid. Returns {variant:
    path}."""
    os.makedirs(output_dir, exist_ok=True)
    orig_np, images = render_variants(model, image_path, variants, jitter)
    results = {}
    for name, u8 in images.items():
        p = os.path.join(output_dir, f"{model.kind}_{name}.jpg")
        Image.fromarray(u8.cpu().numpy()).save(p)
        results[name] = p
    _comparison_grid(orig_np, results, output_dir, model.kind)
    return results


def _comparison_grid(orig, results, output_dir, model_kind):
    from ..utils.figures import have_matplotlib, panel_grid

    grid_path = os.path.join(output_dir, f"{model_kind}_comparison.jpg")
    if not have_matplotlib():
        panel_grid([(orig, "original")] + [(Image.open(p), name)
                                           for name, p in results.items()],
                   3, grid_path)
        return
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(results) + 1
    cols = 3
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(5 * cols, 4 * rows))
    axes = np.atleast_1d(axes).ravel()
    axes[0].imshow(orig); axes[0].set_title("original"); axes[0].axis("off")
    for ax, (name, path) in zip(axes[1:], results.items()):
        ax.imshow(np.asarray(Image.open(path)))
        ax.set_title(name)
        ax.axis("off")
    for ax in axes[n:]:
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(grid_path, dpi=110)
    plt.close(fig)
