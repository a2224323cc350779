"""The port's classical-CV toolbox against the JAX package on the CPU:
colour conversions, filters, CLAHE, the Lanczos resize, the colour-block
repair ops and the local-style post chain of the batch program.

Stated tolerances: continuous ops max |d| <= 1e-3 on uint8-scale floats
(1e-5 on [0, 1] for ``resize``); integer-valued ops exact; Canny on integer
gray equal on >= 99.99% of pixels (its direction bins go through arctan2);
the sky mask, the detail mask and Canny on the program's own inputs equal on
>= 99.9%; ``_postprocess`` fed the same styled array: > 1 level on <= 0.1%
of values and mean |d| <= 0.05 levels."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multi_style_transfer_gan_tpu.data.synthetic import render_photo
from multi_style_transfer_gan_tpu.ops import clahe as jclahe
from multi_style_transfer_gan_tpu.ops import color as jcolor
from multi_style_transfer_gan_tpu.ops import filters as jfilters
from multi_style_transfer_gan_tpu.ops import image as jimage
from multi_style_transfer_gan_tpu.ops import smooth as jsmooth
from multi_style_transfer_gan_tpu.pipelines import batch as jbatch
from multi_style_transfer_gan_tpu_torch.ops import clahe as tclahe
from multi_style_transfer_gan_tpu_torch.ops import color as tcolor
from multi_style_transfer_gan_tpu_torch.ops import filters as tfilters
from multi_style_transfer_gan_tpu_torch.ops import image as timage
from multi_style_transfer_gan_tpu_torch.ops import smooth as tsmooth
from multi_style_transfer_gan_tpu_torch.pipelines import batch as tbatch

CONT_TOL = 1e-3        # continuous ops, uint8 scale
RESIZE_TOL = 1e-5      # resize, [0, 1]
MASK_SHARE = 0.999     # masks and Canny on the program's inputs
CANNY_INT_SHARE = 0.9999
LEVEL_SHARE, MEAN_LEVELS = 1e-3, 0.05


def _photos(n=2, size=64):
    return np.stack([render_photo(900100 + i, size=size)
                     for i in range(n)]).astype(np.float32)


def _special(size=64):
    """Three images that reach the chain's corners: a pale overcast sky
    (trips the has-sky gate), seeded noise (a dense Canny map) and a grey
    ramp with black and white bands (H and S guards)."""
    rng = np.random.default_rng(7)
    sky = np.empty((size, size, 3), np.float32)
    sky[...] = [196.0, 206.0, 222.0]
    sky += rng.normal(0, 3, sky.shape)
    noise = rng.integers(0, 256, (size, size, 3)).astype(np.float32)
    ramp = np.repeat(np.linspace(0, 255, size, dtype=np.float32)[None, :, None],
                     size, 0).repeat(3, 2)
    ramp[:8] = 0.0
    ramp[-8:] = 255.0
    return np.stack([np.clip(np.round(sky), 0, 255), noise, ramp])


@pytest.fixture(scope="module")
def images():
    return np.concatenate([_photos(), _special()])


def _gray(img):
    return 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]


def _close(ref, got, tol):
    ref = np.asarray(ref, np.float64)
    got = got.numpy().astype(np.float64)
    assert ref.shape == got.shape
    assert np.abs(ref - got).max() <= tol


def _exact(ref, got):
    ref = np.asarray(ref)
    assert ref.shape == tuple(got.shape)
    np.testing.assert_array_equal(ref.astype(np.float64),
                                  got.numpy().astype(np.float64))


def _share_equal(ref, got):
    ref = np.asarray(ref)
    assert ref.shape == tuple(got.shape)
    return float((ref == got.numpy()).mean())


# ---------------------------------------------------------------------------
# colour
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["rgb_to_gray", "rgb_to_hsv", "rgb_to_yuv",
                                  "yuv_to_rgb", "rgb_to_lab"])
def test_color_conversion_matches_jax(images, name):
    _close(getattr(jcolor, name)(jnp.asarray(images)),
           getattr(tcolor, name)(torch.from_numpy(images)), CONT_TOL)


def test_hsv_round_trip_matches_jax(images):
    hsv = np.array(jcolor.rgb_to_hsv(jnp.asarray(images)))
    got = tcolor.hsv_to_rgb(torch.from_numpy(hsv))
    _close(jcolor.hsv_to_rgb(jnp.asarray(hsv)), got, CONT_TOL)
    _close(images, got, CONT_TOL)   # the inverse, on the same grid


def test_srgb_to_linear_matches_jax():
    c = np.linspace(0, 1, 1001, dtype=np.float32)
    _close(jcolor._srgb_to_linear01(jnp.asarray(c)),
           tcolor._srgb_to_linear01(torch.from_numpy(c)), 1e-6)


# ---------------------------------------------------------------------------
# borders and linear filters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["reflect", "edge", "symmetric"])
@pytest.mark.parametrize("n,r", [(7, 2), (5, 5), (3, 8)])
def test_border_padding_matches_numpy(mode, n, r):
    """Index-built pads equal ``np.pad`` (what ``jnp.pad`` follows), also
    when the pad is as wide as the side or wider."""
    x = np.arange(2 * n * n * 3, dtype=np.float32).reshape(2, n, n, 3)
    want = np.pad(x, ((0, 0), (r, r), (r, r), (0, 0)), mode=mode)
    _exact(want, tfilters._pad(torch.from_numpy(x), r, r, mode))


@pytest.mark.parametrize("ksize,sigma", [(3, 0.0), (5, 0.0), (7, 0.0),
                                         (9, 2.0)])
def test_gaussian_blur_matches_jax(images, ksize, sigma):
    _close(jfilters.gaussian_blur(jnp.asarray(images), ksize, sigma),
           tfilters.gaussian_blur(torch.from_numpy(images), ksize, sigma),
           CONT_TOL)


@pytest.mark.parametrize("sigma", [2.0, 3.0])
@pytest.mark.parametrize("layout", ["rgb", "gray", "narrow"])
def test_gaussian_filter_matches_jax(images, sigma, layout):
    """Colour, (B, H, W) gray, and a (B, H, 6) array whose trailing axis the
    channel rule takes for channels, in both packages."""
    x = {"rgb": images, "gray": _gray(images),
         "narrow": _gray(images)[:, :, :6]}[layout]
    _close(jfilters.gaussian_filter(jnp.asarray(x), sigma),
           tfilters.gaussian_filter(torch.from_numpy(x), sigma), CONT_TOL)


@pytest.mark.parametrize("ksize", [3, 9, 101])
def test_box_filter_matches_jax(images, ksize):
    _close(jfilters.box_filter(jnp.asarray(images), ksize),
           tfilters.box_filter(torch.from_numpy(images), ksize), CONT_TOL)


@pytest.mark.parametrize("axis", [0, 1])
def test_sobel_matches_jax(images, axis):
    g = _gray(images)
    _close(jfilters.sobel(jnp.asarray(g), axis),
           tfilters.sobel(torch.from_numpy(g), axis), CONT_TOL)


def test_filter2d_matches_jax(images):
    k = np.asarray([[-1, -1, -1], [-1, 9, -1], [-1, -1, -1]], np.float32)
    _close(jfilters.filter2d(jnp.asarray(images), k),
           tfilters.filter2d(torch.from_numpy(images), k), CONT_TOL)


@pytest.mark.parametrize("d,sc,ss", [(5, 50.0, 50.0), (9, 75.0, 75.0)])
def test_bilateral_filter_matches_jax(images, d, sc, ss):
    _close(jfilters.bilateral_filter(jnp.asarray(images), d, sc, ss),
           tfilters.bilateral_filter(torch.from_numpy(images), d, sc, ss),
           CONT_TOL)


@pytest.mark.parametrize("eps", [1e-4, 650.25])
def test_guided_filter_matches_jax(images, eps):
    x = jnp.asarray(images)
    t = torch.from_numpy(images)
    _close(jfilters.guided_filter(x, x, 4, eps),
           tfilters.guided_filter(t, t, 4, eps), CONT_TOL)


# ---------------------------------------------------------------------------
# integer-valued ops: exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["dilate", "erode"])
@pytest.mark.parametrize("ksize,iters", [(3, 1), (5, 2)])
def test_morphology_is_exact(images, op, ksize, iters):
    m = (_gray(images) > 120).astype(np.float32)
    _exact(getattr(jfilters, op)(jnp.asarray(m), ksize, iters),
           getattr(tfilters, op)(torch.from_numpy(m), ksize, iters))


def test_median_blur3_is_exact(images):
    _exact(jfilters.median_blur3(jnp.asarray(images)),
           tfilters.median_blur3(torch.from_numpy(images)))


def test_convert_scale_abs_is_exact(images):
    x = images * 0.93 - 11.0
    _exact(jfilters.convert_scale_abs(jnp.asarray(x), 1.1, 5),
           tfilters.convert_scale_abs(torch.from_numpy(x), 1.1, 5))


@pytest.mark.parametrize("case", ["photo", "constant", "two_values"])
def test_equalize_hist_is_exact(images, case):
    """Integer inputs, with cv2's special cases: a single-valued image
    comes back unchanged; two values map to 0 and 255."""
    g = np.round(_gray(images))
    if case == "constant":
        g = np.full_like(g, 77.0)
    elif case == "two_values":
        g = np.where(g > 100, 200.0, 30.0).astype(np.float32)
    _exact(jfilters.equalize_hist(jnp.asarray(g)),
           tfilters.equalize_hist(torch.from_numpy(g)))


@pytest.mark.parametrize("clip,grid", [(2.0, 8), (4.0, 4), (40.0, 8)])
def test_clahe_is_exact(images, clip, grid):
    g = np.round(_gray(images))
    _exact(jclahe.clahe(jnp.asarray(g), clip, grid),
           tclahe.clahe(torch.from_numpy(g), clip, grid))
    _exact(jclahe.clahe(jnp.asarray(g[0]), clip, grid),
           tclahe.clahe(torch.from_numpy(g[0]), clip, grid))


# ---------------------------------------------------------------------------
# Canny and the masks
# ---------------------------------------------------------------------------

def test_canny_on_integer_gray(images):
    g = np.round(_gray(images))
    assert _share_equal(jfilters.canny(jnp.asarray(g)),
                        tfilters.canny(torch.from_numpy(g))) >= CANNY_INT_SHARE


def test_canny_on_program_inputs(images):
    g = _gray(images)
    got = tfilters.canny(torch.from_numpy(g))
    assert set(np.unique(got.numpy())) <= {0.0, 255.0}
    assert _share_equal(jfilters.canny(jnp.asarray(g)), got) >= MASK_SHARE


def test_sky_mask_matches_jax(images):
    ref_mask, ref_has = jbatch._sky_mask(jnp.asarray(images))
    mask, has = tbatch._sky_mask(torch.from_numpy(images))
    assert _share_equal(ref_mask, mask) >= MASK_SHARE
    np.testing.assert_array_equal(np.asarray(ref_has), has.numpy())
    assert has.numpy()[2] and not has.numpy()[0]   # the sky image trips it


def test_detail_mask_matches_jax(images):
    ref = jbatch._detail_mask(jnp.asarray(images))
    got = tbatch._detail_mask(torch.from_numpy(images))
    assert _share_equal(ref, got) >= MASK_SHARE
    assert got.numpy()[3].mean() > 0.5   # the noise image: a dense map


# ---------------------------------------------------------------------------
# the post chain, fed the same styled array
# ---------------------------------------------------------------------------

def _levels_ok(ref, got):
    d = np.abs(np.asarray(ref, np.float64) - got.numpy().astype(np.float64))
    return float((d > 1).mean()) <= LEVEL_SHARE and d.mean() <= MEAN_LEVELS


@pytest.mark.parametrize("mode", ["simple", "enhanced", "advanced"])
@pytest.mark.parametrize("enhance_colors,smooth", [(True, True),
                                                   (False, False),
                                                   (True, False),
                                                   (False, True)])
def test_postprocess_matches_jax(images, mode, enhance_colors, smooth):
    styled = np.random.default_rng(3).integers(
        0, 256, images.shape).astype(np.float32)
    args = (mode, 0.8, 0.7, enhance_colors, smooth)
    ref = jnp.clip(jnp.round(jbatch._postprocess(
        jnp.asarray(images), jnp.asarray(styled), *args)), 0, 255)
    got = torch.clamp(torch.round(tbatch._postprocess(
        torch.from_numpy(images), torch.from_numpy(styled), *args)), 0, 255)
    assert _levels_ok(ref, got)


def test_smooth_transitions_matches_jax(images):
    mask = _gray(images) > 120
    _close(jbatch._smooth_transitions(jnp.asarray(images), jnp.asarray(mask)),
           tbatch._smooth_transitions(torch.from_numpy(images),
                                      torch.from_numpy(mask)), CONT_TOL)


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size_hw", [(32, 48), (96, 80), (17, 100), (64, 64),
                                     (256, 256)])
def test_resize_matches_jax(size_hw):
    x01 = _photos() / 255.0
    _close(jimage.resize(jnp.asarray(x01), size_hw),
           timage.resize(torch.from_numpy(x01), size_hw), RESIZE_TOL)
    _close(jimage.resize(jnp.asarray(x01[0]), size_hw),
           timage.resize(torch.from_numpy(x01[0]), size_hw), RESIZE_TOL)


# ---------------------------------------------------------------------------
# colour-block repair (ops/smooth.py)
# ---------------------------------------------------------------------------

def test_detect_color_blocks_matches_jax(images):
    assert _share_equal(jsmooth.detect_color_blocks(jnp.asarray(images)),
                        tsmooth.detect_color_blocks(torch.from_numpy(images))
                        ) >= MASK_SHARE


@pytest.mark.parametrize("name", ["adaptive_color_correction",
                                  "edge_preserving_smoothing",
                                  "detail_enhancing_blend",
                                  "apply_guided_filter",
                                  "smooth_segmentation_edges",
                                  "blend_with_original"])
def test_smooth_ops_match_jax(images, name):
    other = images[::-1].copy()
    mask = _gray(images) > 120
    weight = np.linspace(0, 1, images.shape[2], dtype=np.float32)[None, :]
    weight = np.broadcast_to(weight, images.shape[:-1]).copy()
    args = {"adaptive_color_correction": (images, mask),
            "edge_preserving_smoothing": (images,),
            "detail_enhancing_blend": (images, other),
            "apply_guided_filter": (images,),
            "smooth_segmentation_edges": (mask,),
            "blend_with_original": (images, other, weight)}[name]
    _close(getattr(jsmooth, name)(*map(jnp.asarray, args)),
           getattr(tsmooth, name)(*map(torch.from_numpy, args)), CONT_TOL)


def test_fix_color_blocks_matches_jax(images):
    orig = _photos(n=5)
    ref = jnp.clip(jnp.round(jsmooth.fix_color_blocks(jnp.asarray(images),
                                                      jnp.asarray(orig))),
                   0, 255)
    got = torch.clamp(torch.round(tsmooth.fix_color_blocks(
        torch.from_numpy(images), torch.from_numpy(orig))), 0, 255)
    assert _levels_ok(ref, got)
