"""Colour-space conversions on uint8-scale float tensors (port of
``ops/color.py``).

cv2's uint8 conventions, which the post chains threshold against: values
0..255, H packed as degrees / 2 (0..180), YUV per BT.601 with U and V
centred at 128, LAB with L scaled to 0..255 and a, b offset by 128. The
channel axis is the last one.
"""

from __future__ import annotations

import torch


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """cv2.COLOR_RGB2GRAY: Y = 0.299 R + 0.587 G + 0.114 B (same scale)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return 0.299 * r + 0.587 * g + 0.114 * b


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """cv2.COLOR_RGB2HSV for uint8-scaled floats: H in 0..180, S, V 0..255."""
    x = rgb.float()
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = mx - mn
    # the divisions are guarded so that no inf or nan is ever formed
    safe = torch.where(diff == 0, 1.0, diff)
    h = torch.where(
        mx == r, 60.0 * (g - b) / safe,
        torch.where(mx == g, 120.0 + 60.0 * (b - r) / safe,
                    240.0 + 60.0 * (r - g) / safe))
    h = torch.where(diff == 0, 0.0, h)
    h = torch.where(h < 0, h + 360.0, h) / 2.0   # cv2 packs H/2 for uint8
    s = torch.where(mx == 0, 0.0,
                    255.0 * diff / torch.where(mx == 0, 1.0, mx))
    return torch.stack([h, s, mx], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`rgb_to_hsv` (cv2 uint8 conventions)."""
    x = hsv.float()
    h = x[..., 0] * 2.0   # back to degrees
    s = x[..., 1] / 255.0
    v = x[..., 2]
    c = v * s
    hp = h / 60.0
    xm = c * (1.0 - torch.abs(torch.remainder(hp, 2.0) - 1.0))
    z = torch.zeros_like(c)
    idx = torch.remainder(torch.floor(hp).to(torch.int32), 6)
    sector = [idx == i for i in range(6)]

    def pick(vals):
        out = z
        for cond, val in zip(sector[::-1], vals[::-1]):
            out = torch.where(cond, val, out)
        return out

    r = pick([c, xm, z, z, xm, c])
    g = pick([xm, c, c, xm, z, z])
    b = pick([z, z, xm, c, c, xm])
    m = v - c
    return torch.stack([r + m, g + m, b + m], dim=-1)


def rgb_to_yuv(rgb: torch.Tensor) -> torch.Tensor:
    """cv2.COLOR_RGB2YUV (BT.601, uint8 offsets: U, V centred at 128)."""
    x = rgb.float()
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.14713 * r - 0.28886 * g + 0.436 * b + 128.0
    v = 0.615 * r - 0.51499 * g - 0.10001 * b + 128.0
    return torch.stack([y, u, v], dim=-1)


def yuv_to_rgb(yuv: torch.Tensor) -> torch.Tensor:
    x = yuv.float()
    y, u, v = x[..., 0], x[..., 1] - 128.0, x[..., 2] - 128.0
    r = y + 1.13983 * v
    g = y - 0.39465 * u - 0.58060 * v
    b = y + 2.03211 * u
    return torch.stack([r, g, b], dim=-1)


def _srgb_to_linear01(c01: torch.Tensor) -> torch.Tensor:
    return torch.where(c01 > 0.04045, ((c01 + 0.055) / 1.055) ** 2.4,
                       c01 / 12.92)


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """cv2.COLOR_RGB2LAB for uint8-scaled floats: L 0..255, a, b offset 128
    (cv2 scales L by 255/100 for uint8)."""
    x = rgb.float() / 255.0
    lin = _srgb_to_linear01(x)
    r, g, b = lin[..., 0], lin[..., 1], lin[..., 2]
    # D65 sRGB matrix
    X = (0.412453 * r + 0.357580 * g + 0.180423 * b) / 0.950456
    Y = 0.212671 * r + 0.715160 * g + 0.072169 * b
    Z = (0.019334 * r + 0.119193 * g + 0.950227 * b) / 1.088754

    def f(t):   # t >= 0: the cube root is a power
        return torch.where(t > 0.008856, t ** (1.0 / 3.0),
                           7.787 * t + 16.0 / 116.0)

    fx, fy, fz = f(X), f(Y), f(Z)
    L = torch.where(Y > 0.008856, 116.0 * Y ** (1.0 / 3.0) - 16.0, 903.3 * Y)
    a = 500.0 * (fx - fy) + 128.0
    bb = 200.0 * (fy - fz) + 128.0
    return torch.stack([L * 255.0 / 100.0, a, bb], dim=-1)
