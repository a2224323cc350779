"""The port's single-image pipelines (direct, advanced, local-style,
compare) and their CLIs against the JAX package's on the CPU, on the
trained c16 weights.

Each pipeline's saved uint8 images are held to the JAX pipeline's with the
post chain's limits: more than 1 level apart on at most 0.1% of values, mean
|d| at most 0.05 levels (the generators differ by ~1e-5, which flips a
rounding now and then)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from multi_style_transfer_gan_tpu.cli import advanced_transform as jax_advanced_cli
from multi_style_transfer_gan_tpu.cli import direct_transform as jax_direct_cli
from multi_style_transfer_gan_tpu.cli import enhanced_local_style as jax_local_cli
from multi_style_transfer_gan_tpu.cli import improved_smooth as jax_smooth_cli
from multi_style_transfer_gan_tpu.data.synthetic import render_photo
from multi_style_transfer_gan_tpu.pipelines import advanced as jadvanced
from multi_style_transfer_gan_tpu.pipelines import compare as jcompare
from multi_style_transfer_gan_tpu.pipelines import direct as jdirect
from multi_style_transfer_gan_tpu.pipelines import local_style as jlocal
from multi_style_transfer_gan_tpu.pipelines.model_loader import (
    load_generator as jax_load_generator,
)
from multi_style_transfer_gan_tpu_torch.cli import advanced_transform
from multi_style_transfer_gan_tpu_torch.cli import direct_transform
from multi_style_transfer_gan_tpu_torch.cli import enhanced_local_style
from multi_style_transfer_gan_tpu_torch.cli import improved_smooth
from multi_style_transfer_gan_tpu_torch.pipelines import advanced as tadvanced
from multi_style_transfer_gan_tpu_torch.pipelines import compare as tcompare
from multi_style_transfer_gan_tpu_torch.pipelines import direct as tdirect
from multi_style_transfer_gan_tpu_torch.pipelines import local_style as tlocal
from multi_style_transfer_gan_tpu_torch.pipelines import load_generator

TRAINED = "trained/G_BA_selected.pth"
LEVEL_SHARE, MEAN_LEVELS = 1e-3, 0.05
VARIANTS = ("standard", "contrast", "multiscale", "detail", "local")


@pytest.fixture(scope="module")
def models():
    return jax_load_generator(TRAINED), load_generator(TRAINED, device="cpu")


@pytest.fixture(scope="module")
def photo(tmp_path_factory):
    """A 120 x 90 landscape (not square, smaller than the canvas)."""
    path = tmp_path_factory.mktemp("img") / "photo.png"
    Image.fromarray(render_photo(900200, size=128)[:90, :120]).save(path)
    return str(path)


def _read(path):
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def _assert_levels(ref, got):
    ref = np.asarray(ref)
    got = np.asarray(got)
    assert ref.shape == got.shape
    d = np.abs(ref.astype(np.float64) - got.astype(np.float64))
    assert (d > 1).mean() <= LEVEL_SHARE, (d > 1).mean()
    assert d.mean() <= MEAN_LEVELS, d.mean()


def _assert_same_files(ref_paths, got_paths):
    assert len(ref_paths) == len(got_paths)
    for r, g in zip(ref_paths, got_paths):
        assert os.path.basename(r) == os.path.basename(g)
        _assert_levels(_read(r), _read(g))


# ---------------------------------------------------------------------------
# direct
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [64, 96])
def test_transform_image_matches_jax(models, photo, tmp_path, size):
    jm, tm = models
    ref = jdirect.transform_image(jm, photo, str(tmp_path / "jax.png"),
                                  size=size)
    got = tdirect.transform_image(tm, photo, str(tmp_path / "port.png"),
                                  size=size)
    assert got.shape == (size, size, 3) and got.dtype == np.float32
    _assert_levels(np.round(np.asarray(ref) * 255), np.round(got * 255))
    _assert_levels(_read(tmp_path / "jax.png"), _read(tmp_path / "port.png"))


def test_different_sizes_matches_jax(models, photo, tmp_path):
    jm, tm = models
    sizes = (64, 96)
    jdirect.test_different_sizes(jm, photo, str(tmp_path / "jax"),
                                 sizes=sizes)
    grid = tdirect.test_different_sizes(tm, photo, str(tmp_path / "port"),
                                        sizes=sizes)
    assert os.path.exists(grid)
    names = [f"size_{s}.png" for s in sizes]
    _assert_same_files([str(tmp_path / "jax" / n) for n in names],
                       [str(tmp_path / "port" / n) for n in names])


def test_try_skip_connections_matches_jax(models, photo, tmp_path):
    jm, tm = models
    ref = jdirect.try_skip_connections(jm, photo, str(tmp_path / "jax"),
                                       size=64)
    got = tdirect.try_skip_connections(tm, photo, str(tmp_path / "port"),
                                       size=64)
    assert os.path.exists(tmp_path / "port" / "skip_comparison.png")
    _assert_same_files(ref, got)



# ---------------------------------------------------------------------------
# advanced
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def advanced_runs(models, photo, tmp_path_factory):
    jm, tm = models
    d = tmp_path_factory.mktemp("advanced")
    ref = jadvanced.generate_with_different_settings(jm, photo,
                                                     str(d / "jax"))
    got = tadvanced.generate_with_different_settings(tm, photo,
                                                     str(d / "port"))
    return ref, got, d


@pytest.mark.parametrize("variant", VARIANTS)
def test_advanced_variant_matches_jax(advanced_runs, variant):
    ref, got, _ = advanced_runs
    assert list(got) == list(VARIANTS)
    _assert_same_files([ref[variant]], [got[variant]])


def test_advanced_writes_its_comparison_grid(advanced_runs):
    assert os.path.exists(advanced_runs[2] / "port" / "enhanced_comparison.jpg")


@pytest.mark.parametrize("part", ["jitter", "saturate", "lab_l"])
def test_advanced_helpers_match_jax(part):
    import jax.numpy as jnp

    rgb = render_photo(900300, size=64).astype(np.float32)
    if part == "jitter":
        ref = jadvanced._color_jitter(jnp.asarray(rgb / 255.0), 1.05, 1.1)
        got = tadvanced._color_jitter(torch.from_numpy(rgb / 255.0), 1.05, 1.1)
        tol = 1e-5
    elif part == "saturate":
        ref = jadvanced._saturate(jnp.asarray(rgb), 1.2, 1.1)
        got = tadvanced._saturate(torch.from_numpy(rgb), 1.2, 1.1)
        tol = 1e-3
    else:
        l_new = np.clip(rgb[..., 0] * 0.9 + 10, 0, 255)
        ref = jadvanced._lab_l_to_rgb(jnp.asarray(l_new), jnp.asarray(rgb))
        got = tadvanced._lab_l_to_rgb(torch.from_numpy(l_new),
                                      torch.from_numpy(rgb))
        tol = 1e-3
    assert np.abs(np.asarray(ref, np.float64)
                  - got.double().numpy()).max() <= tol


# ---------------------------------------------------------------------------
# local style
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["felzenszwalb", "slic", "quickshift"])
def test_segmentation_is_the_same(method):
    img = render_photo(900400, size=48)
    np.testing.assert_array_equal(
        jlocal.get_segmentation_mask(img, method=method),
        tlocal.get_segmentation_mask(img, method=method))


def test_segment_analysis_and_blend_map_match_jax():
    img = render_photo(900500, size=64)
    seg = jlocal.get_segmentation_mask(img)
    ref = jlocal.analyze_segments(img, seg)
    got = tlocal.analyze_segments(img, seg, device="cpu")
    assert sorted(ref) == sorted(got)
    for sid in ref:
        for key in ("avg_color_rgb", "avg_color_hsv", "std_color",
                    "position"):
            np.testing.assert_allclose(got[sid][key], ref[sid][key],
                                       atol=1e-3)
        assert got[sid]["size"] == ref[sid]["size"]
        assert abs(got[sid]["edge_density"]
                   - ref[sid]["edge_density"]) <= 1e-3
    ref_map = jlocal.determine_blend_ratios(ref, seg, img.shape)
    got_map = tlocal.determine_blend_ratios(got, seg, img.shape,
                                            device="cpu")
    assert got_map.shape == img.shape[:2]
    assert np.abs(ref_map - got_map).max() <= 1e-5


def _port_blend_map(stats, segments, shape):
    return tlocal.determine_blend_ratios(stats, segments, shape, device="cpu")


@pytest.fixture(scope="module")
def local_runs(models, photo, tmp_path_factory):
    """Both pipelines, the JAX one with the port's blend-map Gaussian.

    The blend map is flat at a clamped ratio (0.3 or 0.9) over most of the
    canvas, and there ``styled * 0.3 + canvas * 0.7`` is an exact .5 tie
    for about one pixel in ten. One ulp of the map decides those ties, and
    the sharpen then amplifies each flip ninefold: XLA's CPU summation order
    gives 0.29999998 where the correctly rounded sum (and the port) gives
    0.30000001. So the map is held on its own to 1e-5
    (``test_segment_analysis_and_blend_map_match_jax``) and the JAX run here
    takes the port's map computed from its own statistics; everything else
    of the two pipelines is compared end to end."""
    jm, tm = models
    d = tmp_path_factory.mktemp("local")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlocal, "determine_blend_ratios", _port_blend_map)
        jlocal.enhanced_local_style_transfer(jm, photo,
                                             str(d / "jax" / "out.png"))
    out = tlocal.enhanced_local_style_transfer(tm, photo,
                                               str(d / "port" / "out.png"))
    return out, d


def test_local_style_matches_jax(local_runs):
    out, d = local_runs
    assert out.size == (256, 192)   # smaller than the canvas: crop size
    _assert_levels(_read(d / "jax" / "out.png"), _read(d / "port" / "out.png"))


def test_local_style_writes_its_comparison(local_runs):
    assert os.path.exists(local_runs[1] / "port" / "comparison.jpg")


# ---------------------------------------------------------------------------
# compare
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def compare_runs(models, photo, tmp_path_factory):
    jm, tm = models
    d = tmp_path_factory.mktemp("compare")
    ref = jcompare.compare_models(jm, jm, photo, str(d / "jax"))
    got = tcompare.compare_models(tm, tm, photo, str(d / "port"))
    return ref, got


@pytest.mark.parametrize("key", ["enhanced", "cyclegan"])
def test_compare_models_matches_jax(compare_runs, key):
    ref, got = compare_runs
    assert _read(got[key]).shape == (90, 120, 3)
    _assert_same_files([ref[key]], [got[key]])


def test_compare_models_writes_its_figure(compare_runs):
    assert os.path.exists(compare_runs[1]["figure"])


# ---------------------------------------------------------------------------
# CLIs, on the CPU by replacing their DEVICE
# ---------------------------------------------------------------------------

@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for cli in (direct_transform, advanced_transform, enhanced_local_style,
                improved_smooth):
        monkeypatch.setattr(cli, "DEVICE", "cpu")


def test_direct_transform_cli_matches_jax(on_cpu, photo, tmp_path):
    argv = ["--image", photo, "--model", TRAINED, "--size", "64"]
    jax_direct_cli.main(argv + ["--output", str(tmp_path / "jax.png")])
    assert direct_transform.main(
        argv + ["--output", str(tmp_path / "port.png")]) == 0
    _assert_levels(_read(tmp_path / "jax.png"), _read(tmp_path / "port.png"))


@pytest.mark.parametrize("flags,match", [(["--precision", "int8"], "int8")])
def test_direct_transform_cli_refuses_what_is_not_ported(capsys, photo, flags,
                                                         match):
    """``--precision int8`` was refused (exit 2) until the int8 engine was
    ported: now it parses, and without a CUDA device the run stops at the
    device check like any other (tests/test_torch_int8.py holds it
    against JAX)."""
    assert direct_transform.main(["--image", photo, "--model", TRAINED]
                                 + flags) == 1
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "not ported" not in err
    assert match in " ".join(flags)


def test_advanced_transform_cli_matches_jax(on_cpu, photo, tmp_path):
    argv = ["--image", photo, "--model", TRAINED, "--variants", "standard",
            "detail"]
    jax_advanced_cli.main(argv + ["--output_dir", str(tmp_path / "jax")])
    assert advanced_transform.main(
        argv + ["--output_dir", str(tmp_path / "port")]) == 0
    names = ["enhanced_standard.jpg", "enhanced_detail.jpg"]
    _assert_same_files([str(tmp_path / "jax" / n) for n in names],
                       [str(tmp_path / "port" / n) for n in names])


def test_enhanced_local_style_cli_matches_jax(on_cpu, monkeypatch, photo,
                                              tmp_path):
    """With the port's blend-map Gaussian in the JAX run (see
    ``local_runs``)."""
    monkeypatch.setattr(jlocal, "determine_blend_ratios", _port_blend_map)
    argv = ["--image", photo, "--model", TRAINED, "--no_comparison"]
    jax_local_cli.main(argv + ["--output", str(tmp_path / "jax.png")])
    assert enhanced_local_style.main(
        argv + ["--output", str(tmp_path / "port.png")]) == 0
    _assert_levels(_read(tmp_path / "jax.png"), _read(tmp_path / "port.png"))
    assert not os.path.exists(tmp_path / "comparison.jpg")


def test_improved_smooth_cli_matches_jax(on_cpu, photo, tmp_path):
    styled = tmp_path / "styled.png"
    Image.fromarray(render_photo(900600, size=64)).save(styled)
    argv = ["--input", str(styled), "--original", photo]
    jax_smooth_cli.main(argv + ["--output", str(tmp_path / "jax.png")])
    assert improved_smooth.main(
        argv + ["--output", str(tmp_path / "port.png")]) == 0
    _assert_levels(_read(tmp_path / "jax.png"), _read(tmp_path / "port.png"))
