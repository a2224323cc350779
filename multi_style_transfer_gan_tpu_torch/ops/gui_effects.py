"""GUI-tab blending effects (port of ``ops/gui_effects.py``;
gan_login_gui.py:1334-1394, duplicated at :2480-2540 of the reference).

The reference GUI's local-style worker uses a different sky heuristic from
the batch pipeline: a blue-HSV-range mask ([90,30,140]..[130,255,255] in
cv2 uint8 HSV) intersected with the upper half of the frame, dilated and
blurred into a soft weight; plus a Canny edge mask blurred with a 21x21
Gaussian as a detail-preservation weight; and a low-strength ramp
(strength/0.3 for strength<0.3, gan_login_gui.py:1404-1408). In BOTH of
the GUI's masks the masked region retains the ORIGINAL image, unlike the
batch pipeline's enhanced mode, which BOOSTS style in sky.

Inputs are (..., H, W, 3) fp32 tensors in uint8 scale, on any device.
"""

from __future__ import annotations

import torch

from .color import rgb_to_gray, rgb_to_hsv
from .filters import canny, dilate, gaussian_blur


def blue_sky_mask(img_u8f: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) -> soft sky weight in [0,1]: blue HSV range in the
    upper half, dilated 5x5 twice and Gaussian(15)-smoothed
    (gan_login_gui.py:1337-1361)."""
    hsv = rgb_to_hsv(img_u8f)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    in_range = (h >= 90) & (h <= 130) & (s >= 30) & (v >= 140)
    H = img_u8f.shape[-3]
    rows = torch.arange(H, device=img_u8f.device)[:, None] < (H // 2)
    mask = (in_range & rows).float()
    mask = dilate(mask, 5, iterations=2)
    return torch.clamp(gaussian_blur(mask, 15), 0.0, 1.0)


def edge_weight_mask(img_u8f: torch.Tensor) -> torch.Tensor:
    """Canny(50,150) edges, dilated 3x3, blurred 21x21 -> [0,1] detail
    weight (gan_login_gui.py:1373-1385)."""
    edges = (canny(rgb_to_gray(img_u8f), 50.0, 150.0) > 0).float()
    edges = torch.clamp(dilate(edges, 3), 0.0, 1.0)
    return torch.clamp(gaussian_blur(edges, 21), 0.0, 1.0)


def gui_local_style_blend(canvas_u8f: torch.Tensor, styled_u8f: torch.Tensor,
                          strength: float, detail: float, *,
                          sky_handling: bool = True,
                          direction: str = "photo2monet",
                          auto_regions: bool = True) -> torch.Tensor:
    """The GUI local-style 'enhanced' blend (gan_login_gui.py:1334-1408).

    The reference applies three affine blends toward the ORIGINAL, which
    compose into one styled-weight W = (1-sky)·(1-detail·edges)·ramp:
    - sky handling (photo2monet only): sky keeps the original
      (:1365-1366, the opposite of the batch pipeline's sky BOOST),
    - edge/detail preservation: edges keep the original, scaled by
      ``detail`` (:1390-1391),
    - global ramp: strength/0.3 for strength<0.3; NO global strength
      blend at all for strength>=0.3 (:1404-1408: the global_blend
      matrix built at :1398-1401 is never applied).
    """
    w = torch.ones(canvas_u8f.shape[:-1], dtype=torch.float32,
                   device=canvas_u8f.device)
    if sky_handling and direction == "photo2monet":
        w = w * (1.0 - blue_sky_mask(canvas_u8f))
    if auto_regions:
        w = w * (1.0 - detail * edge_weight_mask(canvas_u8f))
    if strength < 0.3:
        w = w * (strength / 0.3)
    w = torch.clamp(w, 0.0, 1.0)[..., None]
    return torch.clamp(canvas_u8f * (1 - w) + styled_u8f * w, 0, 255)
