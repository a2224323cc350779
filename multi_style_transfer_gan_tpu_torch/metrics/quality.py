"""Image-quality metrics: MSE, PSNR and SSIM on batched tensors (port of
``metrics/quality.py``).

Semantics of the reference's metric kernel (compare_image_quality.py:14-33):
images as fp32 in [0, 1], ``data_range=1.0``, SSIM per channel and averaged
over channels (skimage's ``channel_axis=2`` with its defaults: a 7x7
uniform window, K1 = 0.01, K2 = 0.03, and the sample covariance
normalization N / (N - 1)). Inputs are (H, W, C) or (B, H, W, C); a single
image gives scalars, a batch (B,) vectors.

The metrics run on the device of their inputs. ``check_metrics_device``
holds a device's SSIM against the CPU's on a fixed probe and raises when
they disagree; it never moves the work elsewhere.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean squared error over all pixels and channels."""
    d = a.float() - b.float()
    sq = d.square()
    return sq.mean(dim=tuple(range(1, d.ndim))) if d.ndim > 3 else sq.mean()


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0):
    return 10.0 * torch.log10((data_range ** 2) / mse(a, b))


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0,
         win_size: int = 7, K1: float = 0.01, K2: float = 0.03):
    """Mean SSIM per image, skimage's ``structural_similarity`` with
    ``channel_axis=2`` and its defaults (uniform window, unbiased
    covariances): the window means with zero padding, then a crop of
    ``win_size // 2`` on each border before the mean over H, W and C."""
    single = a.ndim == 3
    if single:
        a, b = a[None], b[None]
    x = a.float().permute(0, 3, 1, 2)
    y = b.float().permute(0, 3, 1, 2)
    c = x.shape[1]

    NP = win_size * win_size
    cov_norm = NP / (NP - 1.0)  # skimage's sample covariance

    # The window means are one fp32 average pool (a sum of the 49 taps
    # over 49; count_include_pad keeps 49 at the zero-padded borders).
    # SSIM subtracts uxx - ux * ux, a cancellation, so the filter must not
    # be a convolution: cuDNN would run it in TF32 on the card whenever
    # torch.backends.cudnn.allow_tf32 is set (PyTorch's default). The pool
    # is PyTorch's own kernel on both the CPU and the card, no cuDNN and
    # no matrix product, so no TF32 switch reaches it.
    means = F.avg_pool2d(torch.cat([x, y, x * x, y * y, x * y], dim=1),
                         win_size, stride=1, padding=win_size // 2,
                         count_include_pad=True)
    ux, uy, uxx, uyy, uxy = torch.split(means, c, dim=1)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / (
        (ux * ux + uy * uy + C1) * (vx + vy + C2))

    pad = (win_size - 1) // 2
    S = S[:, :, pad:S.shape[2] - pad, pad:S.shape[3] - pad]
    out = S.mean(dim=(1, 2, 3))
    return out[0] if single else out


def compare_pair(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0):
    """The reference's per-pair metric triple (compare_image_quality.py:14-33)
    on the device of ``a`` and ``b``: {"mse", "psnr", "ssim"}."""
    with torch.inference_mode():
        return {"mse": mse(a, b), "psnr": psnr(a, b, data_range),
                "ssim": ssim(a, b, data_range)}


def _probe_pair():
    """The fixed probe of the JAX package's ``metrics_device``
    (quality.py:113-119): a smooth 64 x 64 x 3 ramp with noise, and a
    noisier copy, from a generator seeded 7."""
    rng = np.random.default_rng(7)
    base = np.add.outer(np.linspace(0, 1, 64),
                        np.linspace(1, 0, 64))[..., None] / 2
    a = np.clip(base + rng.normal(0, 0.05, (64, 64, 3)), 0, 1).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.03, a.shape), 0, 1).astype(np.float32)
    return torch.from_numpy(a), torch.from_numpy(b)


_CHECKED: set[str] = set()   # devices whose probe passed in this process


def check_metrics_device(device) -> None:
    """Hold ``device``'s SSIM to the CPU's on the probe pair, once per
    process and device.

    The JAX package's ``metrics_device`` answers a disagreement by quietly
    moving every metric to the CPU; here it is an error: raises
    ``RuntimeError`` with both values when the device's SSIM differs from
    the CPU's by more than 1e-3, or when its SSIM(x, x) is more than 1e-4
    from 1.
    """
    device = torch.device(device)
    if str(device) in _CHECKED:
        return
    a, b = _probe_pair()
    want = float(ssim(a, b))
    a, b = a.to(device), b.to(device)
    got = float(ssim(a, b))
    ident = float(ssim(a, a))
    if abs(got - want) > 1e-3 or abs(ident - 1.0) > 1e-4:
        raise RuntimeError(
            f"SSIM on {device} disagrees with the CPU on the probe pair: "
            f"{got!r} on {device} vs {want!r} on the CPU; SSIM(x, x) "
            f"{ident!r} on {device}")
    _CHECKED.add(str(device))
