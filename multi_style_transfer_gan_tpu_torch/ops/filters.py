"""Classical-CV filters on batched tensors (port of ``ops/filters.py``).

The cv2/scipy calls of the local-style post chains: Gaussian blur,
scipy-style ``gaussian_filter``, Sobel, a Canny-compatible edge detector,
dilate/erode, box, 3x3 median, bilateral and guided filters, ``filter2d``,
histogram equalization and ``convert_scale_abs``.

Images are (..., H, W) or (..., H, W, C) float tensors in uint8 scale
(0..255) unless noted. A trailing axis of 8 or fewer is taken for channels,
the JAX package's rule, so a (B, H, W) mask with W > 8 is filtered per
image. Borders follow cv2's default (reflect-101) unless stated.

Every linear filter here is an fp32 sum of shifted slices, tap after tap,
and no convolution: cuDNN would pick an algorithm per shape and may run
TF32 on the card, and the masks threshold these sums (a flipped detail-mask
pixel moves the blend weight by 0.3 * detail, tens of uint8 levels), so the
sums are kept exact fp32 and the same on every device and run.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# layout and borders
# ---------------------------------------------------------------------------

def _as_bhwc(img: torch.Tensor):
    """(x, restore): ``img`` as fp32 (N, H, W, C), and the function that
    gives a (N, H, W, C) result back the input's layout."""
    x = img.float()
    chan = x.ndim >= 3 and x.shape[-1] <= 8
    if not chan:
        x = x[..., None]
    lead = x.shape[:-3]
    x = x.reshape(-1, *x.shape[-3:])

    def restore(y):
        y = y.reshape(*lead, *y.shape[1:])
        return y if chan else y[..., 0]

    return x, restore


def _border_index(n: int, r: int, mode: str, device) -> torch.Tensor:
    """Source index of each of the n + 2r padded positions along one axis.

    reflect (cv2's REFLECT_101, ``jnp.pad`` 'reflect'): ... 2 1 | 0 1 2 ...;
    edge (REPLICATE): 0 0 | 0 1 2; symmetric (scipy 'reflect'): 1 0 | 0 1 2.
    Pads as wide as the side or wider fold again, as ``jnp.pad`` does."""
    i = np.arange(-r, n + r)
    if mode == "edge":
        i = np.clip(i, 0, n - 1)
    elif mode == "reflect":
        period = max(2 * n - 2, 1)
        i = np.abs(i) % period
        i = np.where(i >= n, period - i, i)
    elif mode == "symmetric":
        period = 2 * n
        i = i % period
        i = np.where(i >= n, period - 1 - i, i)
    else:
        raise ValueError(f"unknown border mode {mode!r}")
    return torch.as_tensor(i, dtype=torch.long, device=device)


def _pad(x: torch.Tensor, ry: int, rx: int, mode: str) -> torch.Tensor:
    """Pad (N, H, W, C) by ry rows and rx columns on each side."""
    _, H, W, _ = x.shape
    if ry:
        x = x.index_select(1, _border_index(H, ry, mode, x.device))
    if rx:
        x = x.index_select(2, _border_index(W, rx, mode, x.device))
    return x


def _taps(xp: torch.Tensor, k, axis: int, n: int) -> torch.Tensor:
    """sum_i k[i] * xp shifted by i along ``axis`` (output length n), one
    tap after another in fp32; zero taps are skipped."""
    out = None
    for i, w in enumerate(np.asarray(k, np.float32).tolist()):
        if w == 0.0:
            continue
        term = xp.narrow(axis, i, n) * w
        out = term if out is None else out + term
    return out


# ---------------------------------------------------------------------------
# separable filters
# ---------------------------------------------------------------------------

def _sep_filter(img, ky, kx, mode: str = "reflect") -> torch.Tensor:
    """Separable correlation: ``ky`` down H, then ``kx`` along W, with the
    given border mode (reflect = reflect-101, edge, symmetric)."""
    x, restore = _as_bhwc(img)
    _, H, W, _ = x.shape
    ry, rx = len(ky) // 2, len(kx) // 2
    x = _pad(x, ry, rx, mode)
    x = _taps(x, ky, 1, H)
    x = _taps(x, kx, 2, W)
    return restore(x)


_CV2_SMALL_GAUSS = {  # cv2's hardcoded small_gaussian_tab (sigma<=0, k<=7)
    1: np.asarray([1.0]),
    3: np.asarray([0.25, 0.5, 0.25]),
    5: np.asarray([0.0625, 0.25, 0.375, 0.25, 0.0625]),
    7: np.asarray([0.03125, 0.109375, 0.21875, 0.28125,
                   0.21875, 0.109375, 0.03125]),
}


def _cv2_gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel, with the fixed small-kernel table cv2 uses
    when sigma <= 0 and ksize <= 7."""
    if sigma <= 0 and ksize in _CV2_SMALL_GAUSS:
        return _CV2_SMALL_GAUSS[ksize]
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-(xs ** 2) / (2.0 * sigma * sigma))
    return k / k.sum()


def gaussian_blur(img, ksize: int, sigma: float = 0.0) -> torch.Tensor:
    """cv2.GaussianBlur((k, k), sigma) with the default border."""
    k = _cv2_gaussian_kernel(ksize, sigma)
    return _sep_filter(img, k, k)


def gaussian_filter(img, sigma: float, truncate: float = 4.0) -> torch.Tensor:
    """scipy.ndimage.gaussian_filter over H, W (scipy's 'reflect' border,
    which repeats the edge sample: the symmetric pad)."""
    r = int(truncate * sigma + 0.5)
    xs = np.arange(-r, r + 1)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    k = k / k.sum()
    return _sep_filter(img, k, k, mode="symmetric")


def box_filter(img, ksize: int) -> torch.Tensor:
    k = np.ones(ksize) / ksize
    return _sep_filter(img, k, k)


def sobel(gray, axis: int) -> torch.Tensor:
    """cv2.Sobel, ksize 3: axis 0 -> d/dx (horizontal), 1 -> d/dy."""
    smooth = np.asarray([1.0, 2.0, 1.0])
    deriv = np.asarray([-1.0, 0.0, 1.0])
    if axis == 0:
        return _sep_filter(gray, smooth, deriv)
    return _sep_filter(gray, deriv, smooth)


# ---------------------------------------------------------------------------
# morphology, median
# ---------------------------------------------------------------------------

def dilate(mask, ksize: int = 5, iterations: int = 1) -> torch.Tensor:
    """cv2.dilate with a (k, k) ones kernel on a float or bool mask; the
    border is -inf, as ``lax.reduce_window``'s init in the JAX package."""
    x, restore = _as_bhwc(mask)
    x = x.permute(0, 3, 1, 2)
    for _ in range(iterations):
        x = F.max_pool2d(x, ksize, stride=1, padding=ksize // 2)
    return restore(x.permute(0, 2, 3, 1))


def erode(mask, ksize: int = 5, iterations: int = 1) -> torch.Tensor:
    return -dilate(-mask.float(), ksize, iterations)


def median_blur3(img) -> torch.Tensor:
    """cv2.medianBlur(img, 3): the middle of the 9 sorted taps (edge
    border)."""
    x, restore = _as_bhwc(img)
    _, H, W, _ = x.shape
    p = _pad(x, 1, 1, "edge")
    taps = torch.stack([p[:, dy:dy + H, dx:dx + W]
                        for dy in range(3) for dx in range(3)])
    return restore(torch.sort(taps, dim=0).values[4])


def filter2d(img, kernel: np.ndarray) -> torch.Tensor:
    """cv2.filter2D with a small dense kernel (correlation, reflect-101)."""
    x, restore = _as_bhwc(img)
    _, H, W, _ = x.shape
    kernel = np.asarray(kernel, np.float32)
    kh, kw = kernel.shape
    p = _pad(x, kh // 2, kw // 2, "reflect")
    out = None
    for dy in range(kh):
        for dx in range(kw):
            w = float(kernel[dy, dx])
            if w == 0.0:
                continue
            term = p[:, dy:dy + H, dx:dx + W] * w
            out = term if out is None else out + term
    return restore(out)


def convert_scale_abs(img, alpha: float = 1.0, beta: float = 0.0):
    """cv2.convertScaleAbs: saturate_cast<uint8>(round(|img*alpha + beta|))."""
    v = torch.abs(img.float() * alpha + beta)
    return torch.clamp(torch.round(v), 0, 255)


# ---------------------------------------------------------------------------
# histograms
# ---------------------------------------------------------------------------

def batched_hist256(values: torch.Tensor) -> torch.Tensor:
    """(R, N) integer values in 0..255 -> (R, 256) int64 counts, one
    ``bincount`` over value + 256 * row (exact)."""
    rows = values.shape[0]
    offset = 256 * torch.arange(rows, device=values.device)[:, None]
    flat = (values.long() + offset).reshape(-1)
    return torch.bincount(flat, minlength=256 * rows).reshape(rows, 256)


def equalize_hist(gray_u8) -> torch.Tensor:
    """cv2.equalizeHist on uint8-scale single-channel images (..., H, W):
    256-bin histogram, lut = round((cdf - cdf_min) * 255 / (N - cdf_min))
    with cdf_min the first nonzero cdf value; a single-valued image comes
    back unchanged."""
    x = torch.clamp(torch.round(gray_u8.float()), 0, 255)
    lead, (H, W) = x.shape[:-2], x.shape[-2:]
    n = H * W
    flat = x.reshape(-1, n).long()
    hist = batched_hist256(flat)
    cdf = torch.cumsum(hist, dim=-1)
    cdf_min = torch.where(hist > 0, cdf, n + 1).amin(dim=-1, keepdim=True)
    denom = torch.clamp(n - cdf_min, min=1)
    lut = torch.clamp(torch.round((cdf - cdf_min).float() * 255.0
                                  / denom.float()), 0, 255)
    constant = (hist == n).any(dim=-1, keepdim=True)
    identity = torch.arange(256, dtype=lut.dtype, device=lut.device)
    lut = torch.where(constant, identity.expand_as(lut), lut)
    return torch.gather(lut, 1, flat).reshape(*lead, H, W)


# ---------------------------------------------------------------------------
# edge-preserving smoothers
# ---------------------------------------------------------------------------

def bilateral_filter(img, d: int = 9, sigma_color: float = 75.0,
                     sigma_space: float = 75.0) -> torch.Tensor:
    """cv2.bilateralFilter-style smoother, exact over a circular window of
    radius d // 2: spatially and range (L1 over channels) weighted mean."""
    x, restore = _as_bhwc(img)
    _, H, W, _ = x.shape
    r = d // 2
    p = _pad(x, r, r, "reflect")
    num = torch.zeros_like(x)
    den = torch.zeros(x.shape[:-1] + (1,), dtype=torch.float32,
                      device=x.device)
    inv2sc = -0.5 / (sigma_color * sigma_color)
    inv2ss = -0.5 / (sigma_space * sigma_space)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy * dy + dx * dx > r * r:
                continue  # cv2 uses a circular window of radius d // 2
            shifted = p[:, dy + r:dy + r + H, dx + r:dx + r + W]
            cd = torch.sum(torch.abs(shifted - x), dim=-1, keepdim=True)
            w = torch.exp(cd * cd * inv2sc + (dy * dy + dx * dx) * inv2ss)
            num = num + w * shifted
            den = den + w
    return restore(num / den)


def guided_filter(guide, src, radius: int = 4, eps: float = 1e-4):
    """cv2.ximgproc.guidedFilter, per channel (the callers guide a colour
    image by itself, for which the per-channel form is the same): box-filter
    means, a = cov / (var + eps), b = mean_s - a mean_g, out = mean_a g +
    mean_b."""
    g = guide.float()
    s = src.float()
    k = 2 * radius + 1
    mean_g = box_filter(g, k)
    mean_s = box_filter(s, k)
    corr_gs = box_filter(g * s, k)
    corr_gg = box_filter(g * g, k)
    var_g = corr_gg - mean_g * mean_g
    cov_gs = corr_gs - mean_g * mean_s
    a = cov_gs / (var_g + eps)
    b = mean_s - a * mean_g
    return box_filter(a, k) * g + box_filter(b, k)


# ---------------------------------------------------------------------------
# Canny-compatible edges
# ---------------------------------------------------------------------------

def canny(gray_u8, low: float = 50.0, high: float = 150.0,
          hysteresis_iters: int = 10) -> torch.Tensor:
    """cv2.Canny-compatible edges (0 or 255) on (..., H, W) uint8-scale
    gray: Sobel-3 gradients, L1 magnitude, 4-direction non-maximum
    suppression (neighbours taken with wrap-around, as the JAX package's
    ``jnp.roll``), double threshold, and hysteresis as
    ``hysteresis_iters`` rounds of a 3x3 dilation of the strong edges
    ANDed with the weak ones."""
    gx = sobel(gray_u8, 0)
    gy = sobel(gray_u8, 1)
    mag = torch.abs(gx) + torch.abs(gy)

    deg = torch.remainder(torch.rad2deg(torch.atan2(gy, gx)), 180.0)
    d0 = (deg < 22.5) | (deg >= 157.5)
    d45 = (deg >= 22.5) & (deg < 67.5)
    d90 = (deg >= 67.5) & (deg < 112.5)

    def shift(m, dy, dx):
        return torch.roll(torch.roll(m, dy, dims=-2), dx, dims=-1)

    # neighbours in image (y-down) coordinates: a 45-degree gradient points
    # along +y+x on screen, so its comparisons are (+1, +1) and (-1, -1)
    n1 = torch.where(d0, shift(mag, 0, 1),
                     torch.where(d45, shift(mag, 1, 1),
                                 torch.where(d90, shift(mag, 1, 0),
                                             shift(mag, -1, 1))))
    n2 = torch.where(d0, shift(mag, 0, -1),
                     torch.where(d45, shift(mag, -1, -1),
                                 torch.where(d90, shift(mag, -1, 0),
                                             shift(mag, 1, -1))))
    keep = (mag >= n1) & (mag >= n2)
    mag_nms = torch.where(keep, mag, 0.0)

    strong = mag_nms > high
    weak = mag_nms > low
    edges = strong.float()
    for _ in range(hysteresis_iters):
        grown = dilate(edges, 3) > 0
        edges = (grown & weak).float()
    return edges * 255.0
