"""Image range helpers, the Lanczos resize and the aspect restore (port of
``ops/image.py``)."""

from __future__ import annotations

import numpy as np
import torch
from PIL import Image


def _lanczos3(x: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        y = 3.0 * np.sin(np.pi * x) * np.sin(np.pi * x / 3.0)
        out = np.where(x > 1e-3, y / np.where(x != 0, np.pi ** 2 * x ** 2, 1),
                       1.0)
    return np.where(x > 3.0, 0.0, out).astype(np.float32)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x)).astype(np.float32)


_KERNELS = {"lanczos3": _lanczos3, "bilinear": _triangle}


def _weight_mat(n_in: int, n_out: int, kernel=_lanczos3, scale=None,
                translation=0.0) -> np.ndarray:
    """The (n_in, n_out) weights of an antialiased resize along one axis, as
    ``jax.image.scale_and_translate`` builds them (``compute_weight_mat``
    in ``jax/_src/image/scale.py``, in fp32): the kernel widened by the
    downsampling factor, each output's weights normalised to sum 1, and
    zero columns where the sample falls outside the input. ``scale``
    defaults to n_out / n_in (``jax.image.resize``); output pixel i samples
    the input at (i + 0.5 - translation) / scale - 0.5."""
    f32 = np.float32
    scale = f32(n_out / n_in) if scale is None else f32(scale)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0))
    sample = ((np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale
              - f32(translation) * inv_scale - f32(0.5))
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = kernel(x)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _apply_weights(img: torch.Tensor, mats) -> torch.Tensor:
    """Contract H and W of (..., H, W, C) with the (n_in, n_out) matrices
    ``mats`` (None leaves an axis as it is), in fp64, rounded to fp32
    once, so no TF32 switch of the caller enters the products."""
    x = img.double()
    for axis, w in zip((-3, -2), mats):
        if w is None:
            continue
        w = torch.as_tensor(w, dtype=torch.float64, device=x.device)
        x = torch.movedim(torch.tensordot(torch.movedim(x, axis, -1), w,
                                          dims=1), -1, axis)
    return x.float()


def resize(img: torch.Tensor, size_hw, method: str = "lanczos3") -> torch.Tensor:
    """Antialiased resize of (B, H, W, C) or (H, W, C) to ``size_hw``, the
    JAX package's ``ops.image.resize`` (``jax.image.resize(..., 'lanczos3',
    antialias=True)``) or, with method 'bilinear', ``jax.image.resize(...,
    'bilinear')`` (a triangle kernel, antialiased the same way): one weight
    matrix per axis, applied as two products."""
    kernel = _KERNELS[method]
    mats = [None if img.shape[axis] == n_out
            else _weight_mat(img.shape[axis], n_out, kernel)
            for axis, n_out in ((-3, size_hw[0]), (-2, size_hw[1]))]
    return _apply_weights(img, mats)


def resize_center_crop(img: torch.Tensor, size: int = 256,
                       method: str = "lanczos3") -> torch.Tensor:
    """torchvision Resize(size) + CenterCrop(size) of (B, H, W, C) or (H, W,
    C): the shorter side -> ``size``, centre-cropped square (the training
    transform, pretrain.py:32-37 of the reference), as the JAX package's
    ``ops.image.resize_center_crop``. The long side goes to
    int(size * long / short), TRUNCATED as torchvision's
    ``_compute_resized_output_size`` does, and the crop starts at the
    integer offset (new - size) // 2; both axes resample in one antialiased
    product each, so the crop costs nothing extra."""
    f32 = np.float32
    H, W = img.shape[-3], img.shape[-2]
    h, w = f32(H), f32(W)
    new_h = f32(size) if h <= w else np.floor(f32(size) * h / w)
    new_w = f32(size) if w <= h else np.floor(f32(size) * w / h)
    mats = []
    for n_in, n_new in ((H, new_h), (W, new_w)):
        shift = -np.floor((n_new - f32(size)) / f32(2.0))
        mats.append(_weight_mat(n_in, size, _KERNELS[method],
                                scale=n_new / f32(n_in), translation=shift))
    return _apply_weights(img, mats)


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
