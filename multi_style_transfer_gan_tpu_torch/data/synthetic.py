"""Synthetic unpaired two-domain dataset (port of ``data/synthetic.py``,
numpy, scipy and PIL only; the same bytes for the same seed).

A stand-in for monet2photo with its folder contract (``trainA/trainB/
testA/testB``): domain B ("photo") holds procedurally rendered landscapes
(sky gradient, sun, clouds, hill silhouettes, water), each from a seeded
generator; domain A ("monet") a deterministic painterly transform
(:func:`monetize`) of a disjoint set of renders, so the training sets are
unpaired while the mapping is known in closed form. The test split ships
ground truth: ``truth_monet_for_testB/`` holds ``monetize(testB)`` and
``truth_photo_for_testA/`` the renders under ``testA``, with the same file
names across folders.

The transform is local (colour matrix, tone curve, a small blur, oriented
stroke grain), so a convolutional generator can realize it.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

__all__ = ["render_photo", "monetize", "write_domains"]


def _smooth_noise(rng: np.random.Generator, shape, sigma: float) -> np.ndarray:
    """Band-limited noise in [0,1]: white noise blurred to scale ``sigma``."""
    from scipy.ndimage import gaussian_filter

    n = gaussian_filter(rng.standard_normal(shape), sigma, mode="wrap")
    lo, hi = float(n.min()), float(n.max())
    return (n - lo) / max(hi - lo, 1e-9)


def render_photo(seed: int, size: int = 256) -> np.ndarray:
    """Render one procedural 'photo' landscape as uint8 HWC.

    Deterministic in ``seed``. Scenes vary in horizon height, palette,
    sun position, cloudiness, hill layers, and water presence.
    """
    rng = np.random.default_rng(np.uint32(seed) + 12345)
    h = w = size
    y = np.linspace(0.0, 1.0, h)[:, None]
    img = np.zeros((h, w, 3), np.float32)

    # --- sky: vertical gradient between a zenith and a horizon color
    zenith = np.array([0.25, 0.45, 0.75]) + rng.uniform(-0.1, 0.1, 3)
    horizon_col = np.array([0.75, 0.80, 0.85]) + rng.uniform(-0.12, 0.08, 3)
    horizon = rng.uniform(0.45, 0.65)
    t = np.clip(y / horizon, 0, 1) ** rng.uniform(0.8, 1.5)
    sky = (1 - t) * zenith[None, None] + t * horizon_col[None, None]
    img[:] = sky

    # --- sun: soft disk somewhere in the upper sky (not every scene)
    if rng.random() < 0.7:
        sy, sx = rng.uniform(0.08, horizon * 0.7), rng.uniform(0.1, 0.9)
        rad = rng.uniform(0.03, 0.08)
        yy, xx = np.mgrid[0:h, 0:w] / size
        d = np.sqrt((yy - sy) ** 2 + (xx - sx) ** 2)
        glow = np.exp(-(d / rad) ** 2)[..., None]
        sun_col = np.array([1.0, 0.95, 0.75]) + rng.uniform(-0.05, 0.05, 3)
        img = img * (1 - glow) + glow * sun_col[None, None]

    # --- clouds: bright smooth-noise streaks in the sky band
    cloud = _smooth_noise(rng, (h, w), sigma=rng.uniform(8, 18))
    cloud = np.clip(cloud - rng.uniform(0.45, 0.65), 0, 1) * 2.5
    sky_band = np.clip(1 - y / horizon, 0, 1) ** 0.5
    cloud = (cloud * sky_band)[..., None]
    img = img * (1 - 0.6 * cloud) + 0.6 * cloud * np.array([0.97, 0.97, 0.98])

    # --- hills: 2-3 silhouette layers with smooth-noise ridgelines
    n_layers = rng.integers(2, 4)
    base_green = np.array([0.20, 0.38, 0.18]) + rng.uniform(-0.06, 0.06, 3)
    for k in range(n_layers):
        frac = (k + 1) / n_layers
        ridge_h = horizon + (1 - horizon) * (0.05 + 0.75 * frac * rng.uniform(0.6, 1.0))
        ridge = _smooth_noise(rng, (w,), sigma=rng.uniform(10, 30))
        ridge = ridge_h + (ridge - 0.5) * rng.uniform(0.05, 0.18)
        mask = (y >= ridge[None, :]).astype(np.float32)[..., None]
        # farther layers are hazier (mixed toward sky), nearer are darker
        col = base_green * (0.55 + 0.45 * frac) + rng.uniform(-0.04, 0.04, 3)
        haze = 0.45 * (1 - frac)
        col = col * (1 - haze) + horizon_col * haze
        shade = 0.85 + 0.3 * _smooth_noise(rng, (h, w), rng.uniform(4, 9))[..., None]
        img = img * (1 - mask) + mask * np.clip(col[None, None] * shade, 0, 1)

    # --- water band at the bottom (some scenes): darkened sky reflection
    if rng.random() < 0.5:
        wline = rng.uniform(0.82, 0.92)
        wmask = (y >= wline).astype(np.float32)[..., None]
        refl = sky[::-1] * 0.8 + 0.05
        streak = _smooth_noise(rng, (h, w), sigma=(1.0, 12.0))[..., None]
        water = np.clip(refl * (0.85 + 0.3 * streak), 0, 1)
        img = img * (1 - wmask) + wmask * water

    # --- fine texture so the domain isn't piecewise-constant
    img += (rng.standard_normal((h, w, 3)) * 0.015).astype(np.float32)
    return (np.clip(img, 0, 1) * 255).round().astype(np.uint8)


# Fixed painterly palette map: warm rotation mixing a little of each
# channel into the others (rows sum to 1 so grays stay near-gray).
_MONET_MATRIX = np.array(
    [
        [0.82, 0.16, 0.02],
        [0.10, 0.78, 0.12],
        [0.06, 0.18, 0.76],
    ],
    np.float32,
)
_MONET_LIFT = np.array([0.06, 0.045, 0.075], np.float32)  # lavender lift


def monetize(img: np.ndarray, *, stroke_seed: int = 7) -> np.ndarray:
    """Deterministic painterly ('Monet-ish') transform of a uint8 HWC image.

    Composition (all local — learnable by a small conv generator):
    palette matrix + lavender shadow lift, a softening blur, oriented
    brush-stroke grain, a mild tone curve, and a corner vignette.
    Deterministic given the image and ``stroke_seed``.

    ``stroke_seed`` MUST vary per image in a training set (write_domains
    derives it from each image's render seed): a fixed texture would make
    the GAN game unwinnable — a translation-equivariant conv generator
    cannot memorize one global 256^2 noise pattern, while the
    discriminator trivially keys on its absence (d_loss -> 4e-4 and
    high-frequency artifacts, in the JAX package's runs). With per-image seeds
    the target is a *distribution* of anisotropically-filtered noise,
    which a generator CAN realize by filtering the fine noise already
    present in the photo renders.
    """
    from scipy.ndimage import gaussian_filter

    x = img.astype(np.float32) / 255.0
    h, w = x.shape[:2]

    # palette: fixed linear color mix + shadow lift
    x = x @ _MONET_MATRIX.T
    x = x + _MONET_LIFT[None, None] * (1 - x)

    # soften: painterly loss of high-frequency detail
    x = gaussian_filter(x, sigma=(1.3, 1.3, 0))

    # oriented stroke grain: anisotropic smoothed noise, per-image texture
    rng = np.random.default_rng((int(stroke_seed) * 2654435761) % (2 ** 31))
    grain = gaussian_filter(rng.standard_normal((h, w)), sigma=(0.6, 4.0))
    grain = grain / max(float(np.abs(grain).max()), 1e-9)
    luma = x.mean(axis=2, keepdims=True)
    x = x + grain[..., None] * 0.04 * (0.3 + luma)

    # tone curve: lift shadows, compress highlights (soft filmic-ish)
    x = np.clip(x, 0, 1) ** 0.88
    x = x * 0.94 + 0.02

    # vignette toward canvas edges
    yy, xx = np.mgrid[0:h, 0:w]
    d = ((yy / h - 0.5) ** 2 + (xx / w - 0.5) ** 2) * 2.0
    x = x * (1 - 0.18 * d[..., None] ** 1.5)

    return (np.clip(x, 0, 1) * 255).round().astype(np.uint8)


def write_domains(root, *, n_train: int = 400, n_test: int = 54,
                  size: int = 256, seed: int = 0,
                  quality: int = 95) -> dict:
    """Write the full unpaired dataset under ``root``.

    Folder layout (reference folder contract + ground-truth extras):

    - ``trainA/``: monetized renders (seeds ``base..base+n_train``)
    - ``trainB/``: raw renders from a DISJOINT seed range (unpaired)
    - ``testA/`` + ``truth_photo_for_testA/``: monet test images and the
      underlying renders (G_BA target)
    - ``testB/`` + ``truth_monet_for_testB/``: photo test images and
      their monetized versions (G_AB target)

    Returns a manifest dict of folder -> file count.
    """
    from PIL import Image

    root = Path(root)
    base = int(seed) * 1_000_000
    ranges = {
        "trainA": range(base, base + n_train),
        "trainB": range(base + n_train, base + 2 * n_train),
        "testA": range(base + 2 * n_train, base + 2 * n_train + n_test),
        "testB": range(base + 2 * n_train + n_test,
                       base + 2 * n_train + 2 * n_test),
    }

    def _save(folder: Path, name: str, arr: np.ndarray):
        folder.mkdir(parents=True, exist_ok=True)
        Image.fromarray(arr).save(folder / name, quality=quality)

    manifest: dict[str, int] = {}
    for split, rng_ in ranges.items():
        for s in rng_:
            name = f"{split}_{s - base:05d}.jpg"
            photo = render_photo(s, size)
            # per-image stroke seed (see monetize's docstring): derived
            # from the render seed, so truth folders stay deterministic
            mon = lambda: monetize(photo, stroke_seed=s)
            if split == "trainA":
                _save(root / split, name, mon())
            elif split == "trainB":
                _save(root / split, name, photo)
            elif split == "testA":
                _save(root / split, name, mon())
                _save(root / "truth_photo_for_testA", name, photo)
            else:  # testB
                _save(root / split, name, photo)
                _save(root / "truth_monet_for_testB", name, mon())
        manifest[split] = len(rng_)
    manifest["truth_photo_for_testA"] = n_test
    manifest["truth_monet_for_testB"] = n_test
    return manifest
