"""The port's checkpoint and inspection tools against the JAX package's on
the CPU: ``weights.save_pth`` / ``convert_model`` / ``pth_info`` and their
CLIs, ``ops.image.resize_center_crop``, and the ``debug_model`` and
``generate_new_image`` CLIs on the trained c16 weights (held at the post
chain's level limits: more than 1 level apart on at most 0.1% of values,
mean |d| at most 0.05 levels)."""

import contextlib
import io

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from multi_style_transfer_gan_tpu.cli import convert_model as jax_convert_cli
from multi_style_transfer_gan_tpu.cli import debug_model as jax_debug_cli
from multi_style_transfer_gan_tpu.cli import generate_new_image as jax_generate_cli
from multi_style_transfer_gan_tpu.cli import pth_info as jax_pth_info_cli
from multi_style_transfer_gan_tpu.data.synthetic import render_photo
from multi_style_transfer_gan_tpu.ops import (
    from_model_range as jax_from_model_range, resize as jax_resize,
    resize_center_crop as jax_resize_center_crop,
    to_model_range as jax_to_model_range,
)
from multi_style_transfer_gan_tpu.pipelines.model_loader import (
    load_generator as jax_load_generator,
)
from multi_style_transfer_gan_tpu_torch.cli import convert_model
from multi_style_transfer_gan_tpu_torch.cli import debug_model
from multi_style_transfer_gan_tpu_torch.cli import generate_new_image
from multi_style_transfer_gan_tpu_torch.cli import pth_info
from multi_style_transfer_gan_tpu_torch.ops import resize, resize_center_crop
from multi_style_transfer_gan_tpu_torch.pipelines import load_generator
from multi_style_transfer_gan_tpu_torch.weights import load_pth, save_pth

TRAINED = "trained/G_BA_selected.pth"
LEVEL_SHARE, MEAN_LEVELS = 1e-3, 0.05


def _assert_levels(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape
    d = np.abs(ref - got)
    assert (d > 1).mean() <= LEVEL_SHARE, (d > 1).mean()
    assert d.mean() <= MEAN_LEVELS, d.mean()


def _read(path):
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def _u8(x01):
    return np.clip(np.round(np.asarray(x01, np.float64) * 255), 0, 255)


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def models():
    return jax_load_generator(TRAINED), load_generator(TRAINED, device="cpu")


@pytest.fixture(scope="module")
def photo(tmp_path_factory):
    """A 200 x 150 landscape: cropped to 192 x 144 by generate_new_image, a
    block grid of 48 x 36 tokens (36 is not a multiple of the 8-window)."""
    path = tmp_path_factory.mktemp("img") / "photo.png"
    Image.fromarray(render_photo(900700, size=224)[:150, :200]).save(path)
    return str(path)


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for cli in (debug_model, generate_new_image):
        monkeypatch.setattr(cli, "DEVICE", "cpu")


# ---------------------------------------------------------------------------
# save_pth, convert_model, pth_info
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", [TRAINED, "dual"])
def test_pth_info_lines_match_jax(tmp_path, path):
    if path == "dual":   # a dual checkpoint: the first container key wins
        path = str(tmp_path / "dual.pth")
        sd = load_pth(TRAINED)["G_BA_state_dict"]
        torch.save({"epoch": 3, "G_AB_state_dict": sd,
                    "G_BA_state_dict": {k: v[:1] for k, v in sd.items()}},
                   path)
    ref = _stdout(jax_pth_info_cli.main, [path])[1]
    rc, got = _stdout(pth_info.main, [path])
    assert rc is None
    assert got == ref and len(got) > 10
    assert "initial.0.weight: (16, 3, 7, 7)" in got


@pytest.mark.parametrize("first", ["jax", "port"])
def test_converted_file_serves_in_the_other_package(models, tmp_path, first):
    """A file converted by one package loads in the other and gives that
    package's forward of the original checkpoint."""
    out = str(tmp_path / "flat.pth")
    cli = jax_convert_cli if first == "jax" else convert_model
    rc, lines = _stdout(cli.main, ["--input", TRAINED, "--output", out])
    assert rc == 0 and lines == [f"model converted and saved to {out}"]
    flat = load_pth(out)
    assert "initial.0.weight" in flat and "G_BA_state_dict" not in flat

    x = np.tanh(np.random.default_rng(1).standard_normal((1, 64, 64, 3))
                ).astype(np.float32)
    jax_model, port_model = models
    if first == "jax":
        ref = port_model.apply(torch.from_numpy(x)).numpy()
        got = load_generator(out, device="cpu").apply(
            torch.from_numpy(x)).numpy()
    else:
        ref = np.asarray(jax_model.apply(jnp.asarray(x)))
        got = np.asarray(jax_load_generator(out).apply(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_convert_model_cli_reports_a_failure(tmp_path):
    argv = ["--input", str(tmp_path / "missing.pth"),
            "--output", str(tmp_path / "out.pth")]
    ref = _stdout(jax_convert_cli.main, argv)
    rc, lines = _stdout(convert_model.main, argv)
    assert rc == ref[0] == 1
    assert lines[0].startswith("conversion failed:")
    assert ref[1][0].startswith("conversion failed:")


def test_save_pth_turns_nested_arrays_into_tensors(tmp_path):
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    path = str(tmp_path / "sub" / "x.pth")
    save_pth({"sd": {"w": a[:, ::2]}, "epoch": 4, "t": torch.ones(2)}, path)
    got = load_pth(path)
    assert got["epoch"] == 4
    torch.testing.assert_close(got["sd"]["w"], torch.from_numpy(a[:, ::2].copy()))
    torch.testing.assert_close(got["t"], torch.ones(2))


# ---------------------------------------------------------------------------
# resize_center_crop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,size", [
    ((90, 160, 3), 64),       # landscape
    ((301, 200, 3), 64),      # portrait
    ((77, 77, 3), 256),       # square, upsampled
    ((2, 40, 300, 3), 256),   # a batch, a wide landscape upsampled
])
def test_resize_center_crop_matches_jax(shape, size):
    x = np.random.default_rng(sum(shape)).random(shape).astype(np.float32)
    got = resize_center_crop(torch.from_numpy(x), size).numpy()
    ref = np.asarray(jax_resize_center_crop(jnp.asarray(x), size))
    assert got.shape == ref.shape == shape[:-3] + (size, size, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_resize_center_crop_truncates_and_crops_at_integer_offsets():
    """A 3 x 7 ramp to size 2: the long side goes to int(2 * 7 / 3) = 4
    and the crop starts at (4 - 2) // 2 = 1, so the output samples the
    4-wide resize's columns 1 and 2."""
    ramp = torch.arange(7, dtype=torch.float32).repeat(3, 1)[..., None]
    wide = resize(ramp, (2, 4))
    torch.testing.assert_close(resize_center_crop(ramp, 2), wide[:, 1:3])


# ---------------------------------------------------------------------------
# debug_model, generate_new_image
# ---------------------------------------------------------------------------

def test_debug_model_matches_jax(on_cpu, models, photo, tmp_path):
    jax_lines = _stdout(jax_debug_cli.main, ["--model", TRAINED])[1]
    rc, lines = _stdout(debug_model.main, [
        "--model", TRAINED, "--image", photo,
        "--output_dir", str(tmp_path)])
    assert rc == 0
    # the header is the JAX package's; each parameter's shape is torch's
    # layout of the same tensor
    assert lines[:2] == jax_lines[:2]
    assert lines[-1] == f"comparison saved: {tmp_path}/preprocess_comparison.png"
    ours = dict(line.strip().split(": ") for line in lines[2:-1])
    theirs = dict(line.strip().split(": ") for line in jax_lines[2:])
    assert list(ours) == list(theirs)
    for k, shape in ours.items():
        assert sorted(eval(shape)) == sorted(eval(theirs[k])), k

    jax_model, port_model = models
    img = np.asarray(Image.open(photo).convert("RGB"), np.float32) / 255.0
    got = debug_model.preprocess_variants(port_model, torch.from_numpy(img))
    ref = {"resize_center_crop": jax_resize_center_crop(jnp.asarray(img), 256),
           "plain_resize": jax_resize(jnp.asarray(img), (256, 256))}
    assert list(got) == list(ref)
    for name, x in ref.items():
        y = jax_from_model_range(jax_model.apply(jax_to_model_range(x)[None]))
        np.testing.assert_allclose(got[name][0].numpy(), np.asarray(x),
                                   rtol=0, atol=1e-4)
        _assert_levels(_u8(y[0]), _u8(got[name][1].numpy()))


def test_generate_new_image_matches_jax(on_cpu, photo, tmp_path):
    argv = ["--image", photo, "--model", TRAINED]
    jax_generate_cli.main(argv + ["--output", str(tmp_path / "jax.png")])
    rc, lines = _stdout(generate_new_image.main,
                        argv + ["--output", str(tmp_path / "port.png")])
    assert rc == 0
    assert lines[0] == "processing at 192x144 (cropped to /16 multiple)"
    got = _read(tmp_path / "port.png")
    assert got.shape == (144, 192, 3)
    _assert_levels(_read(tmp_path / "jax.png"), got)
    assert (tmp_path / "port_comparison.png").exists()


@pytest.mark.parametrize("cli,argv", [
    (debug_model, ["--model", TRAINED]),
    (generate_new_image, ["--image", "x.png", "--model", TRAINED]),
])
def test_device_clis_exit_nonzero_without_cuda(monkeypatch, capsys, cli, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(argv) == 1
    assert "no CUDA device" in capsys.readouterr().err
