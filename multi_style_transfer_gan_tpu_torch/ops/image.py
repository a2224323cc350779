"""Image range helpers and the aspect restore (port of ``ops/image.py``)."""

from __future__ import annotations

import numpy as np
import torch
from PIL import Image


def to_model_range(x: torch.Tensor) -> torch.Tensor:
    """uint8 or [0, 1] float image -> [-1, 1] (Normalize(0.5, 0.5))."""
    if x.dtype == torch.uint8:
        x = x.float() / 255.0
    return x * 2.0 - 1.0


def from_model_range(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1], clamped ((x + 1) / 2)."""
    return torch.clamp((x + 1.0) * 0.5, 0.0, 1.0)


def aspect_crop_bounds(orig_w: int, orig_h: int, canvas: int = 256):
    """The crop box that undoes the centred canvas paste for one image
    (batch_process_images.py:219-234 of the reference)."""
    if orig_w == orig_h:
        return 0, 0, canvas, canvas
    ar = orig_w / orig_h
    if ar > 1:
        cw, ch = canvas, int(canvas / ar)
    else:
        cw, ch = int(canvas * ar), canvas
    left = (canvas - cw) // 2
    top = (canvas - ch) // 2
    return left, top, left + cw, top + ch


def restore_aspect(out_u8, orig_wh, canvas: int = 256) -> Image.Image:
    """Aspect-crop a (canvas, canvas, 3) uint8 output back to the source's
    aspect ratio, and resize it to the source size when that is <= 1 MP."""
    w, h = orig_wh
    img = Image.fromarray(np.asarray(out_u8))
    box = aspect_crop_bounds(w, h, canvas)
    if box != (0, 0, canvas, canvas):
        img = img.crop(box)
    if w * h <= 1024 * 1024:
        img = img.resize((w, h), Image.LANCZOS)
    return img
