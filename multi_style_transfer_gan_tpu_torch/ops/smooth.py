"""Colour-block artifact repair (port of ``ops/smooth.py``; the reference's
improved_smooth.py).

- ``detect_color_blocks``: LAB a/b Sobel gradient magnitude below 30,
  dilated 11 x 11: flat-colour regions (improved_smooth.py:53-95).
- ``adaptive_color_correction``: flagged pixels blended 50% toward their
  neighbourhood mean colour (radius 50), as one box filter.
- ``edge_preserving_smoothing``: the bilateral filter with the window cv2
  derives from sigma_space when d <= 0 (:97-112).
- ``detail_enhancing_blend``: a Gaussian high-pass of the original added
  to the stylized blend (:114-135).
- ``fix_color_blocks``: the whole chain (:137-173).

Plus the ``smooth_output`` helpers of the JAX package's GUI:
``apply_guided_filter``, ``smooth_segmentation_edges``,
``blend_with_original``. Images are (..., H, W, 3) uint8-scale float
tensors.
"""

from __future__ import annotations

import torch

from .color import rgb_to_lab
from .filters import (
    bilateral_filter, box_filter, dilate, gaussian_blur, gaussian_filter,
    guided_filter, sobel,
)


def detect_color_blocks(img_u8f, grad_threshold: float = 30.0,
                        dilate_size: int = 11) -> torch.Tensor:
    """(..., H, W, 3) uint8-scale -> bool mask of flat-colour regions."""
    lab = rgb_to_lab(img_u8f)
    mag = torch.zeros(img_u8f.shape[:-1], dtype=torch.float32,
                      device=img_u8f.device)
    for c in (1, 2):  # a, b channels
        gx = sobel(lab[..., c], 0)
        gy = sobel(lab[..., c], 1)
        mag = mag + torch.sqrt(gx * gx + gy * gy)
    flat = (mag < grad_threshold).float()
    return dilate(flat, dilate_size) > 0


def adaptive_color_correction(img_u8f, mask, radius: int = 50,
                              blend: float = 0.5) -> torch.Tensor:
    """Blend flagged pixels toward the neighbourhood mean colour."""
    k = 2 * radius + 1
    neighborhood_mean = box_filter(img_u8f, k)
    corrected = img_u8f * (1 - blend) + neighborhood_mean * blend
    return torch.where(mask[..., None], corrected, img_u8f)


def edge_preserving_smoothing(img_u8f, sigma_s: float = 10.0,
                              sigma_r: float = 0.15) -> torch.Tensor:
    """cv2.bilateralFilter(img, 0, sigma_r * 255, sigma_s)."""
    d = max(int(round(sigma_s * 1.5)) * 2 + 1, 3)
    return bilateral_filter(img_u8f, d, sigma_r * 255.0, sigma_s)


def detail_enhancing_blend(img_u8f, orig_u8f, alpha: float = 0.3,
                           beta: float = 0.5) -> torch.Tensor:
    """img (1 - a) + orig a + highpass(orig) b, clipped to 0..255."""
    blurred = gaussian_blur(orig_u8f, 5)
    detail = orig_u8f - blurred
    out = img_u8f * (1 - alpha) + orig_u8f * alpha + detail * beta
    return torch.clamp(out, 0, 255)


def fix_color_blocks(img_u8f, orig_u8f) -> torch.Tensor:
    """The whole repair chain (improved_smooth.py:137-173)."""
    mask = detect_color_blocks(img_u8f)
    out = adaptive_color_correction(img_u8f, mask)
    out = edge_preserving_smoothing(out)
    return detail_enhancing_blend(out, orig_u8f)


def apply_guided_filter(img_u8f, guide_u8f=None, radius: int = 4,
                        eps: float = 0.01) -> torch.Tensor:
    """Edge-aware smoothing by the guided filter; self-guided by default."""
    guide = img_u8f if guide_u8f is None else guide_u8f
    return torch.clamp(guided_filter(guide, img_u8f, radius,
                                     eps * 255.0 * 255.0), 0, 255)


def smooth_segmentation_edges(mask, sigma: float = 2.0) -> torch.Tensor:
    """A hard region mask softened into a blend weight in [0, 1]."""
    return torch.clamp(gaussian_filter(mask.float(), sigma), 0.0, 1.0)


def blend_with_original(stylized_u8f, original_u8f, weight) -> torch.Tensor:
    """Per-pixel weighted blend; ``weight`` a scalar or an (..., H, W) map."""
    w = torch.as_tensor(weight, dtype=torch.float32,
                        device=stylized_u8f.device)
    if w.ndim == stylized_u8f.ndim - 1:
        w = w[..., None]
    return torch.clamp(stylized_u8f * w + original_u8f * (1.0 - w), 0, 255)
