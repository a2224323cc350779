"""Region-adaptive local style transfer (port of ``pipelines/local_style.py``;
the reference's enhanced_local_style.py).

Flow (enhanced_local_style_transfer, :178-292): aspect-preserving paste on
a BLACK 256^2 canvas -> generator forward -> felzenszwalb segmentation
(scale 100, sigma 0.5, min_size 50; slic or quickshift selectable, :56-74)
-> per-segment statistics (mean RGB and HSV, colour std, Sobel edge density
over the masked image, size, centroid; :76-124) -> per-segment blend ratio
0.7 + edge + colour variance - distance + size + saturation terms, clamped
to [0.3, 0.9] (:126-176) -> the blend map smoothed at sigma 3 -> blend ->
saturation x1.2, CLAHE(2.0, 8x8) on V, a 3x3 sharpen and a bilateral (5,
50, 50) denoise (:242-264) -> aspect crop and restore -> save, and a
4-panel comparison figure (:294-321).

Segmentation and the per-segment scalar work run on the host (numpy);
everything dense (the forward, the batched masked Sobel, the blend map's
Gaussian, the blend and the colour chain) runs on the model's device. As
in the JAX package, the final crop uses the paste geometry
(``aspect_crop_bounds``), not the reference's crop formula, which mis-sizes
the box for sources smaller than 256 px.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from PIL import Image

from ..ops import aspect_crop_bounds, from_model_range, to_model_range
from ..ops.clahe import clahe
from ..ops.color import hsv_to_rgb, rgb_to_gray, rgb_to_hsv
from ..ops.filters import bilateral_filter, filter2d, gaussian_filter, sobel
from ..ops.segmentation import felzenszwalb, quickshift, slic
from .batch import _decode_canvas
from .model_loader import LoadedModel

_SHARPEN = np.asarray([[-1, -1, -1], [-1, 9, -1], [-1, -1, -1]], np.float32)
_SOBEL_CHUNK = 32   # masked images per batched Sobel


def get_segmentation_mask(img_np: np.ndarray, method: str = "felzenszwalb",
                          n_segments: int = 100, compactness: float = 10.0):
    """Method dispatch of enhanced_local_style.py:56-74 (host numpy)."""
    if method == "slic":
        return slic(img_np, n_segments=n_segments, compactness=compactness)
    if method == "felzenszwalb":
        return felzenszwalb(img_np, scale=100, sigma=0.5, min_size=50)
    if method == "quickshift":
        return quickshift(img_np, kernel_size=3, max_dist=6, ratio=0.5)
    raise ValueError(f"unknown segmentation method: {method}")


def analyze_segments(img_np: np.ndarray, segments: np.ndarray, *,
                     device) -> dict:
    """Per-segment statistics (:76-124). HSV and the edge densities are
    computed on ``device``; the per-segment sums on the host.

    Edge density follows the reference: the Sobel magnitude of the image
    with everything outside the segment zeroed, averaged over the whole
    frame (:102-110), for all segments in batched Sobels.
    """
    img_t = torch.from_numpy(np.array(img_np)).to(device).float()
    hsv = rgb_to_hsv(img_t).cpu().numpy()
    seg_ids = np.unique(segments)
    n = len(seg_ids)
    flat = segments.ravel()
    remap = np.searchsorted(seg_ids, flat)
    counts = np.bincount(remap, minlength=n).astype(np.float64)

    def seg_mean(channel):
        return np.bincount(remap, channel.ravel().astype(np.float64),
                           minlength=n) / counts

    rgb_mean = np.stack([seg_mean(img_np[..., c]) for c in range(3)], 1)
    hsv_mean = np.stack([seg_mean(hsv[..., c]) for c in range(3)], 1)
    sq_mean = np.stack([seg_mean(img_np[..., c].astype(np.float64) ** 2)
                        for c in range(3)], 1)
    std = np.sqrt(np.maximum(sq_mean - rgb_mean ** 2, 0))

    ys, xs = np.mgrid[0:segments.shape[0], 0:segments.shape[1]]
    pos = np.stack([seg_mean(ys), seg_mean(xs)], 1)

    labels_t = torch.from_numpy(remap.reshape(segments.shape)).to(device)
    densities = []
    for c in range(0, n, _SOBEL_CHUNK):
        ids = torch.arange(c, min(c + _SOBEL_CHUNK, n), device=device)
        masks = labels_t[None] == ids[:, None, None]
        g = rgb_to_gray(masks[..., None] * img_t[None])
        gx = sobel(g[..., None], 0)[..., 0]
        gy = sobel(g[..., None], 1)[..., 0]
        mag = torch.sqrt(gx * gx + gy * gy)
        densities.append(torch.mean(mag, dim=(1, 2)).cpu().numpy())
    edge_density = np.concatenate(densities)

    return {
        int(sid): {
            "avg_color_rgb": rgb_mean[i], "avg_color_hsv": hsv_mean[i],
            "std_color": std[i], "edge_density": float(edge_density[i]),
            "size": int(counts[i]), "position": pos[i],
        }
        for i, sid in enumerate(seg_ids)
    }


def determine_blend_ratios(segment_stats: dict, segments: np.ndarray,
                           img_shape, *, device) -> np.ndarray:
    """The per-pixel blend map (:126-176): one ratio per segment on the
    host, looked up per pixel and smoothed at sigma 3 on ``device``."""
    cy, cx = img_shape[0] // 2, img_shape[1] // 2
    max_dist = np.sqrt(cx ** 2 + cy ** 2)
    seg_ids = np.unique(segments)
    ratios = np.empty(len(seg_ids), np.float32)
    for i, sid in enumerate(seg_ids):
        st = segment_stats[int(sid)]
        edge_factor = 0.3 * (st["edge_density"] / 30)
        color_var = 0.2 * (np.mean(st["std_color"]) / 50)
        py, px = st["position"]
        dist = np.sqrt((py - cy) ** 2 + (px - cx) ** 2)
        dist_factor = 0.1 * (dist / max_dist)
        size_factor = -0.1 * (st["size"] /
                              (img_shape[0] * img_shape[1] / 100))
        sat_factor = 0.2 * (st["avg_color_hsv"][1] / 255)
        ratio = 0.7 + edge_factor + color_var - dist_factor \
            + size_factor + sat_factor
        ratios[i] = max(0.3, min(0.9, ratio))
    blend_map = torch.from_numpy(
        ratios[np.searchsorted(seg_ids, segments)]).to(device)
    return gaussian_filter(blend_map, 3.0).cpu().numpy()


def enhanced_local_style_transfer(model: LoadedModel, img_path, output_path,
                                  method: str = "felzenszwalb",
                                  make_comparison: bool = True) -> Image.Image:
    """The whole pipeline on the model's device; returns the final PIL
    image."""
    dev = model.device
    src = Image.open(img_path).convert("RGB")
    width, height = src.size
    canvas, _ = _decode_canvas(img_path, canvas=256, fill=0)  # black canvas
    canvas = np.array(canvas)   # writable, for torch.from_numpy

    canvas_t = torch.from_numpy(canvas).to(dev)
    styled01 = from_model_range(model.apply(to_model_range(canvas_t)[None]))[0]
    styled_t = torch.clamp(torch.round(styled01.float() * 255.0), 0, 255)

    segments = get_segmentation_mask(canvas, method=method)
    stats = analyze_segments(canvas, segments, device=dev)
    blend_map = determine_blend_ratios(stats, segments, canvas.shape,
                                       device=dev)

    bm = torch.from_numpy(blend_map).to(dev)[..., None]
    blended = styled_t * bm + canvas_t.float() * (1 - bm)
    blended = torch.clamp(torch.round(blended), 0, 255)

    # colour chain (:242-264)
    hsv = rgb_to_hsv(blended)
    s = torch.clamp(hsv[..., 1] * 1.2, 0, 255)
    v = clahe(hsv[..., 2], 2.0, 8)
    enhanced = torch.clamp(hsv_to_rgb(torch.stack([hsv[..., 0], s, v], -1)),
                           0, 255)
    sharpened = torch.clamp(filter2d(enhanced, _SHARPEN), 0, 255)
    final = bilateral_filter(sharpened, 5, 50, 50)
    final_np = torch.clamp(torch.round(final), 0, 255).to(
        torch.uint8).cpu().numpy()

    out = Image.fromarray(final_np)
    box = aspect_crop_bounds(width, height, 256)
    if box != (0, 0, 256, 256):
        out = out.crop(box)
    # the reference's guard (enhanced_local_style.py:280-281): sources
    # smaller than the canvas keep their crop size, unlike the batch
    # pipeline's restore, which resizes whenever <= 1 MP
    if (width > 256 or height > 256) and width * height <= 1024 * 1024:
        out = out.resize((width, height), Image.LANCZOS)

    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    out.save(output_path)

    if make_comparison:
        styled = styled_t.to(torch.uint8).cpu().numpy()
        _comparison(canvas, styled, blend_map, out,
                    os.path.join(os.path.dirname(os.path.abspath(output_path)),
                                 "comparison.jpg"))
    return out


def _comparison(original, stylized, blend_map, final, path):
    """4-panel figure (:294-321); the blend map in grey where matplotlib is
    not installed."""
    from ..utils.figures import have_matplotlib, panel_grid

    if not have_matplotlib():
        panel_grid([(original, "original"), (stylized, "stylized"),
                    (blend_map, "blend map"), (final, "final")], 2, path)
        return
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 2, figsize=(12, 9))
    axes[0, 0].imshow(original); axes[0, 0].set_title("original")
    axes[0, 1].imshow(stylized); axes[0, 1].set_title("stylized")
    im = axes[1, 0].imshow(blend_map, cmap="viridis", vmin=0, vmax=1)
    axes[1, 0].set_title("blend map")
    fig.colorbar(im, ax=axes[1, 0])
    axes[1, 1].imshow(np.asarray(final)); axes[1, 1].set_title("final")
    for ax in axes.ravel():
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
