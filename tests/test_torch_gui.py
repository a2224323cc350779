"""The port's GUI (``gui/``) and its blend effects (``ops/gui_effects.py``)
against the JAX package's on the CPU.

The tab workers run the whole image -> generator -> post chain -> save
path without a display, on the trained c16 weights (the plain cyclegan tab
on a seeded plain checkpoint); each saved PNG is held to the JAX worker's
with the post chain's limits: more than 1 level apart on at most 0.1% of
values, mean |d| at most 0.05 levels (the generators differ by ~1e-5,
which flips a rounding now and then)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from multi_style_transfer_gan_tpu.data.synthetic import render_photo
from multi_style_transfer_gan_tpu.gui import app as japp
from multi_style_transfer_gan_tpu.ops import gui_effects as jeffects
from multi_style_transfer_gan_tpu_torch.gui import app as tapp
from multi_style_transfer_gan_tpu_torch.gui import auth
from multi_style_transfer_gan_tpu_torch.models import PlainGenerator
from multi_style_transfer_gan_tpu_torch.ops import filters as tfilters
from multi_style_transfer_gan_tpu_torch.ops import gui_effects as teffects
from multi_style_transfer_gan_tpu_torch.pipelines.local_style import (
    enhanced_local_style_transfer,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED = {"ab": "trained/G_AB_selected.pth", "ba": "trained/G_BA_selected.pth"}
LEVEL_SHARE, MEAN_LEVELS = 1e-3, 0.05
BLEND_ATOL = 1e-4     # levels, the blend of the same inputs
# XLA's CPU convolution sums the 15- and 21-tap Gaussians of the soft masks
# in another order than the port's fp32 tap loop (the last ulp; the same
# holds for the 17-25-tap filters of the post chains)
MASK_ULP = 1e-6


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


def _plain_checkpoint(path, channels=8):
    """A seeded plain ``Generator(channels)`` with seeded BatchNorm
    statistics, in the reference's dual CycleGAN flavor."""
    sds = {}
    for i, name in enumerate(("G_AB_state_dict", "G_BA_state_dict")):
        m = PlainGenerator(channels,
                           generator=torch.Generator().manual_seed(11 + i))
        g = np.random.default_rng(11 + i)
        with torch.no_grad():
            for mod in m.modules():
                if isinstance(mod, torch.nn.BatchNorm2d):
                    n = mod.num_features
                    mod.running_mean.copy_(torch.from_numpy(
                        g.uniform(-0.1, 0.1, n).astype(np.float32)))
                    mod.running_var.copy_(torch.from_numpy(
                        g.uniform(0.5, 1.5, n).astype(np.float32)))
        sds[name] = m.state_dict()
    torch.save({**sds, "epoch": 200}, path)


@pytest.fixture(scope="module")
def models_dir(tmp_path_factory):
    """The GUI's fixed file names: the trained pair as the enhanced
    models, a seeded plain pair as the cyclegan checkpoint."""
    d = tmp_path_factory.mktemp("models")
    for suffix, path in TRAINED.items():
        os.symlink(os.path.join(REPO, path),
                   d / f"G_{suffix.upper()}_epoch_200.pth")
    _plain_checkpoint(d / "cyclegan_epoch_200.pth")
    return str(d)


@pytest.fixture(scope="module")
def managers(models_dir):
    """(JAX manager, port manager on the CPU), each with its four models."""
    jm = japp.ModelManager(models_dir=models_dir, precision="highest")
    jm.load(log=lambda msg: None)
    tm = tapp.ModelManager(models_dir=models_dir, device="cpu")
    logs = []
    tm.load(log=logs.append)
    assert tm.loaded() == 4, logs
    return jm, tm


@pytest.fixture(scope="module")
def photos(tmp_path_factory):
    """A 300 x 200 landscape whose upper half is sky (the blue-sky mask
    trips) and a 150 x 220 portrait."""
    d = tmp_path_factory.mktemp("photos")
    paths = {}
    for name, seed, (h, w) in (("landscape", 901, (200, 300)),
                               ("portrait", 902, (220, 150))):
        paths[name] = str(d / f"{name}.png")
        Image.fromarray(render_photo(seed, size=320)[:h, :w]).save(
            paths[name])
    return paths


# ---------------------------------------------------------------------------
# auth
# ---------------------------------------------------------------------------

def test_auth_round_trip_and_remember_me_stores_a_hash(tmp_path):
    users = str(tmp_path / "users.json")
    cred = str(tmp_path / "credentials.json")
    assert auth.register_user("ann", "s3cret", users) == (True, "registered")
    assert auth.register_user("ann", "other", users) == (
        False, "username already exists")
    assert auth.validate_login("ann", "s3cret", users)
    assert not auth.validate_login("ann", "wrong", users)
    assert not auth.validate_login("bob", "s3cret", users)
    for u, p in (("", "x"), ("x", "")):
        assert auth.register_user(u, p, users) == (
            False, "username and password required")

    auth.save_credentials("ann", "s3cret", cred)
    with open(cred) as f:
        text = f.read()
    assert "s3cret" not in text
    assert json.loads(text) == {"username": "ann",
                                "password_hash": auth.hash_password("s3cret")}
    assert auth.load_credentials(cred, users) == "ann"
    auth.register_user("eve", "pw", users)
    with open(cred, "w") as f:   # a hash that is not the user's is refused
        json.dump({"username": "ann",
                   "password_hash": auth.hash_password("pw")}, f)
    assert auth.load_credentials(cred, users) is None
    auth.clear_credentials(cred)
    assert not os.path.exists(cred)
    assert auth.load_credentials(cred, users) is None


# ---------------------------------------------------------------------------
# blend effects
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def effect_inputs():
    """A 2 x 96 x 128 canvas batch (the first with a blue sky in its upper
    half) and a styled batch, uint8-scale fp32."""
    rng = np.random.default_rng(5)
    canvas = np.stack([render_photo(s, size=128)[:96] for s in (903, 904)])
    canvas = canvas.astype(np.float32)
    canvas[0, :30] = canvas[0, :30] * 0.3 + np.float32([60, 120, 220]) * 0.7
    styled = (rng.random(canvas.shape) * 255).astype(np.float32)
    return canvas, styled


def _port_blur(img, ksize, sigma=0.0):
    """The port's Gaussian blur, for the JAX module: the masks' remaining
    steps are then held bit for bit."""
    return jnp.asarray(tfilters.gaussian_blur(
        torch.from_numpy(np.array(img)), ksize, sigma).numpy())


@pytest.mark.parametrize("name", ["blue_sky_mask", "edge_weight_mask"])
def test_masks_match_jax(effect_inputs, monkeypatch, name):
    canvas, _ = effect_inputs
    got = getattr(teffects, name)(torch.from_numpy(canvas)).numpy()
    ref = np.asarray(getattr(jeffects, name)(jnp.asarray(canvas)))
    assert 0.02 < got.mean() < 0.98
    np.testing.assert_allclose(got, ref, rtol=0, atol=MASK_ULP)
    monkeypatch.setattr(jeffects, "gaussian_blur", _port_blur)
    ref = np.asarray(getattr(jeffects, name)(jnp.asarray(canvas)))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("strength", [0.2, 0.5])
@pytest.mark.parametrize("sky", [True, False])
@pytest.mark.parametrize("direction", ["photo2monet", "monet2photo"])
def test_gui_local_style_blend_matches_jax(effect_inputs, strength, sky,
                                           direction):
    canvas, styled = effect_inputs
    kw = dict(sky_handling=sky, direction=direction)
    got = teffects.gui_local_style_blend(
        torch.from_numpy(canvas), torch.from_numpy(styled), strength, 0.6,
        **kw).numpy()
    ref = np.asarray(jeffects.gui_local_style_blend(
        jnp.asarray(canvas), jnp.asarray(styled), strength, 0.6, **kw))
    np.testing.assert_allclose(got, ref, rtol=0, atol=BLEND_ATOL)


def test_blend_sky_keeps_the_original_and_no_ramp_above_0_3(effect_inputs):
    """photo2monet's sky weight pulls the sky toward the ORIGINAL; at or
    above 0.3 strength no global blend applies."""
    canvas, styled = (torch.from_numpy(a) for a in effect_inputs)
    blend = lambda s, **kw: teffects.gui_local_style_blend(
        canvas, styled, s, 0.6, auto_regions=False, **kw)
    sky = teffects.blue_sky_mask(canvas)[0] > 0.99
    assert sky.any()
    with_sky = blend(0.5)
    torch.testing.assert_close(with_sky[0][sky], canvas[0][sky], atol=2.0,
                               rtol=0)
    torch.testing.assert_close(blend(0.5, direction="monet2photo"), styled)
    torch.testing.assert_close(blend(0.3, sky_handling=False), styled)
    torch.testing.assert_close(blend(0.9, sky_handling=False), styled)
    torch.testing.assert_close(blend(0.15, sky_handling=False),
                               canvas * 0.5 + styled * 0.5)


# ---------------------------------------------------------------------------
# the tab workers vs the JAX workers
# ---------------------------------------------------------------------------

STANDARD_CASES = {
    "fix_blocks": dict(blend_original=0.3, fix_blocks=True, strength=0.8,
                       smooth=2, enhance_colors=True,
                       direction="photo2monet"),
    "monet2photo_no_extras": dict(blend_original=0.0, fix_blocks=False,
                                  strength=0.5, smooth=0, enhance_colors=True,
                                  direction="monet2photo"),
    "smooth_on": dict(strength=0.5, smooth=5, enhance_colors=False,
                      adaptive_smooth=True),
    "smooth_off": dict(strength=0.5, smooth=5, enhance_colors=False,
                       adaptive_smooth=False),
}
LOCAL_CASES = {
    "simple": dict(mode="simple"),
    "advanced": dict(mode="advanced"),
    "enhanced": dict(mode="enhanced"),
    "enhanced_no_smooth": dict(mode="enhanced", smooth_transitions=False),
    "enhanced_no_colors": dict(mode="enhanced", smooth_transitions=False,
                               enhance_colors=False),
    "enhanced_no_sky": dict(mode="enhanced", sky_handling=False),
    "enhanced_monet2photo": dict(mode="enhanced", direction="monet2photo"),
}


def _run_pair(managers, tmp_path, worker, family, photo, direction=None,
              **kw):
    """One tab worker in both packages on ``photo``, with the model the tab
    picks for ``direction``: (JAX PNG, port PNG)."""
    jm, tm = managers
    if direction is not None:
        kw["direction"] = direction
    out = []
    for app, m in ((japp, jm), (tapp, tm)):
        path = str(tmp_path / f"{app.__name__.split('.')[0]}.png")
        model = m.pick(family, direction or "photo2monet")
        assert getattr(app, worker)(model, photo, path, **kw) == path
        out.append(_read(path))
    return out


@pytest.mark.parametrize("case", list(STANDARD_CASES))
def test_standard_tab_matches_jax(managers, photos, tmp_path, case):
    kw = STANDARD_CASES[case]
    ref, got = _run_pair(managers, tmp_path, "_process_standard", "enhanced",
                         photos["landscape"], **kw)
    assert got.shape == (200, 300, 3)   # aspect restored (<= 1 MP input)
    _assert_levels(ref, got)


@pytest.mark.parametrize("case", list(LOCAL_CASES))
def test_local_style_tab_matches_jax(managers, photos, tmp_path, case):
    kw = dict(strength=0.5, detail=0.6, **LOCAL_CASES[case])
    photo = photos["portrait" if case == "advanced" else "landscape"]
    ref, got = _run_pair(managers, tmp_path, "_process_local", "enhanced",
                         photo, **kw)
    _assert_levels(ref, got)


@pytest.mark.parametrize("direction", ["photo2monet", "monet2photo"])
def test_cyclegan_tab_matches_jax(managers, photos, tmp_path, direction):
    jm, tm = managers
    ref, got = (_read(app._process_cyclegan(
        m.pick("cyclegan", direction), photos["portrait"],
        str(tmp_path / f"{app.__name__.split('.')[0]}.png")))
        for app, m in ((japp, jm), (tapp, tm)))
    assert got.shape == (220, 150, 3)
    _assert_levels(ref, got)


def test_local_style_toggles_change_the_output(managers, photos, tmp_path):
    """The sky, colour and smoothing toggles each change the enhanced
    output (gan_login_gui.py:1334, 1410-1423)."""
    _, tm = managers
    model = tm.pick("enhanced", "photo2monet")
    outs = {}
    for case in ("enhanced", "enhanced_no_smooth", "enhanced_no_colors",
                 "enhanced_no_sky"):
        path = str(tmp_path / f"{case}.png")
        tapp._process_local(model, photos["landscape"], path, strength=0.5,
                            detail=0.6, **LOCAL_CASES[case])
        outs[case] = _read(path).astype(np.float32)
    for a, b in (("enhanced", "enhanced_no_smooth"),
                 ("enhanced_no_smooth", "enhanced_no_colors"),
                 ("enhanced", "enhanced_no_sky")):
        assert np.abs(outs[a] - outs[b]).mean() > 0.1, (a, b)


def test_enhanced_segmentation_mode_runs_the_local_style_pipeline(
        managers, photos, tmp_path):
    _, tm = managers
    model = tm.pick("enhanced", "photo2monet")
    path = str(tmp_path / "seg.png")
    assert tapp._process_local(model, photos["portrait"], path,
                               mode="enhanced_segmentation") == path
    assert os.path.exists(tmp_path / "comparison.jpg")
    direct = np.asarray(enhanced_local_style_transfer(
        model, photos["portrait"], str(tmp_path / "direct.png"),
        make_comparison=False))
    np.testing.assert_array_equal(_read(path), direct)


# ---------------------------------------------------------------------------
# the model manager, the info panel, main()
# ---------------------------------------------------------------------------

def test_model_info_text_matches_jax(managers):
    jm, tm = managers
    text = tapp.model_info_text(tm)
    assert text == japp.model_info_text(jm)
    assert "enhanced_ba: kind=enhanced  channels=16" in text
    assert "cyclegan_ab: kind=plain  channels=8" in text


def test_pick_and_its_error_while_a_model_is_missing(managers, tmp_path):
    _, tm = managers
    assert tm.pick("enhanced", "photo2monet") is tm.enhanced_ba
    assert tm.pick("enhanced", "monet2photo") is tm.enhanced_ab
    assert tm.pick("cyclegan", "photo2monet") is tm.cyclegan_ba
    assert tm.pick("cyclegan", "monet2photo") is tm.cyclegan_ab
    empty = tapp.ModelManager(models_dir=str(tmp_path), device="cpu")
    logs = []
    empty.load(log=logs.append)
    assert empty.loaded() == 0 and len(logs) == 4
    assert all(msg.startswith("model missing:") for msg in logs)
    assert tapp.model_info_text(empty).count("NOT loaded") == 4
    with pytest.raises(RuntimeError, match="not loaded"):
        empty.pick("cyclegan", "photo2monet")


def test_manager_logs_an_unreadable_checkpoint(tmp_path):
    (tmp_path / "G_AB_epoch_200.pth").write_bytes(b"not a checkpoint")
    m = tapp.ModelManager(models_dir=str(tmp_path), device="cpu")
    logs = []
    m.load(log=logs.append)
    assert m.enhanced_ab is None
    assert any(msg.startswith("failed to load enhanced_ab") for msg in logs)


def test_manager_needs_a_device_and_refuses_int8():
    """A device is required and an unknown precision refused; int8, the
    int8 engine's precision, is taken since the engine was ported
    (tests/test_torch_int8.py holds the int8 manager against JAX's)."""
    with pytest.raises(TypeError):
        tapp.ModelManager()
    assert tapp.ModelManager(precision="int8", device="cpu").precision == \
        "int8"
    with pytest.raises(ValueError):
        tapp.ModelManager(precision="bf16", device="cpu")


@pytest.mark.parametrize("precision,cuda,code,message", [
    ("bf16", True, 2, "is not one of"),
    ("default", False, 1, "no CUDA device"),
])
def test_main_exits_before_a_window(monkeypatch, capsys, precision, cuda,
                                    code, message):
    monkeypatch.setenv("MSTGAN_GUI_PRECISION", precision)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    assert tapp.main() == code
    assert message in capsys.readouterr().err


def test_gui_app_imports_neither_tkinter_nor_jax():
    code = ("import sys\n"
            "import multi_style_transfer_gan_tpu_torch.gui.app\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
            "             ('tkinter', '_tkinter', 'jax',\n"
            "              'multi_style_transfer_gan_tpu'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_thumb_headless_returns_none(photos):
    assert tapp._thumb("/nonexistent.png") is None
    tapp._thumb(photos["landscape"])   # no display: None, never a raise
