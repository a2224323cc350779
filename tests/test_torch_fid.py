"""The port's FID path against the JAX package's on the CPU: the InceptionV3
trunk and its importer on a torchvision-keyed random state dict
(``feature_oracle.make_inception_sd``), the harness's display processing and
fallback features, and ``run_fid_eval`` as a whole on a tiny test tree with
random c4 generators; on the card, the trunk against the CPU.

Tolerances: Inception features relative 1e-4 of the largest |feature| (the
JAX trunk against its torch oracle is held to 2e-3, tests/
test_feature_extractors.py; port and JAX agree to ~4e-7 here), the
fallback features 1e-5 relative, FID per direction 1e-4 relative."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from feature_oracle import make_inception_sd
from multi_style_transfer_gan_tpu.metrics import fid_harness as jharness
from multi_style_transfer_gan_tpu.metrics import inception as jinception
from multi_style_transfer_gan_tpu.pipelines.model_loader import (
    load_generator as jax_load_generator,
)
from multi_style_transfer_gan_tpu_torch.metrics import fid_harness as tharness
from multi_style_transfer_gan_tpu_torch.metrics import inception as tinception
from multi_style_transfer_gan_tpu_torch.pipelines import load_generator
from torch_oracle import make_enhanced_sd

FEATURE_RTOL = 1e-4
FID_RTOL = 1e-4


@pytest.fixture(scope="module")
def inception_sd():
    return make_inception_sd(np.random.default_rng(11))


@pytest.fixture(scope="module")
def trunk(inception_sd):
    model = tinception.InceptionV3()
    model.load_state_dict(tinception.inception_from_torch_sd(inception_sd),
                          strict=True)
    return model.to(memory_format=torch.channels_last).eval()


def _images(seed, shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _assert_features_close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FEATURE_RTOL * np.abs(want).max())


@pytest.mark.parametrize("hw", [299, 256])
def test_inception_features_match_jax(inception_sd, trunk, hw):
    """Batch 2 at 299^2 (no resize) and at 256^2 (through the bilinear
    resize to 299)."""
    imgs = _images(hw, (2, hw, hw, 3))
    want = np.asarray(jinception.inception_pool_features(
        jinception.inception_from_torch_sd(inception_sd), jnp.asarray(imgs)))
    got = tinception.inception_pool_features(trunk, torch.from_numpy(imgs))
    assert got.shape == (2, 2048)
    _assert_features_close(got.numpy(), want)


def test_importer_drops_the_head_and_loads_strict(inception_sd):
    sd = tinception.inception_from_torch_sd(inception_sd)
    assert not any(k.startswith(("AuxLogits", "fc."))
                   or k.endswith("num_batches_tracked") for k in sd)
    assert set(sd) == set(tinception.InceptionV3().state_dict())
    assert set(sd) == set(jinception.inception_from_torch_sd(inception_sd))
    assert all(v.dtype == torch.float32 for v in sd.values())
    assert sd["Conv2d_1a_3x3.conv.weight"].shape == (32, 3, 3, 3)   # OIHW
    del sd["Mixed_6b.branch7x7_2.bn.running_var"]
    with pytest.raises(RuntimeError, match="running_var"):
        tinception.InceptionV3().load_state_dict(sd, strict=True)


@pytest.mark.parametrize("container", [None, "state_dict"])
def test_make_inception_feature_fn_from_a_pth(inception_sd, trunk, tmp_path,
                                              container):
    path = tmp_path / "inception_v3.pth"
    torch.save(inception_sd if container is None
               else {container: inception_sd}, str(path))
    feature_fn = tinception.make_inception_feature_fn(str(path),
                                                      device="cpu")
    imgs = torch.from_numpy(_images(3, (3, 64, 80, 3)))
    got = feature_fn(imgs)
    assert isinstance(got, np.ndarray) and got.shape == (3, 2048)
    np.testing.assert_array_equal(
        got, tinception.inception_pool_features(trunk, imgs).numpy())
    assert np.isfinite(got).all() and got.std() > 0


def test_display_process_matches_jax():
    imgs = _images(5, (2, 40, 48, 3)) ** 2
    want = np.asarray(jharness.display_process(jnp.asarray(imgs)))
    got = tharness.display_process(torch.from_numpy(imgs)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_default_feature_fn_matches_jax():
    imgs = _images(6, (3, 64, 48, 3))
    want = jharness.default_feature_fn(jnp.asarray(imgs))
    got = tharness.default_feature_fn(torch.from_numpy(imgs))
    assert isinstance(got, np.ndarray) and got.shape == want.shape \
        == (3, 3 * (32 * 32 + 16 * 16 + 8 * 8) + 6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# the harness as a whole
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_tree(tmp_path_factory):
    """testA/testB with 4 JPEGs each (200 x 260, so the host resize and
    crop run), and a pair of random c4 generator checkpoints."""
    root = tmp_path_factory.mktemp("fid")
    rng = np.random.default_rng(11)
    for dom in ("A", "B"):
        d = root / "data" / f"test{dom}"
        d.mkdir(parents=True)
        for i in range(4):
            Image.fromarray((rng.random((200, 260, 3)) * 255).astype(
                np.uint8)).save(d / f"{dom}{i}.jpg")
    paths = {}
    for key in ("G_AB_state_dict", "G_BA_state_dict"):
        paths[key] = str(root / f"{key}.pth")
        torch.save({key: make_enhanced_sd(rng, c=4)}, paths[key])
    return root, paths


def _read_results(path):
    rows = [line.split(" FID: ") for line in open(path).read().splitlines()]
    return [(k, float(v)) for k, v in rows]


@pytest.fixture(scope="module")
def fid_runs(tiny_tree):
    """One run of each harness on the tiny tree, panels on. Each run's
    statistic is four float64 ``eigh`` of 4038 x 4038 (the fallback
    features), seconds each: they run on two BLAS threads, so that the
    other test workers' threads are not thrashed."""
    from threadpoolctl import threadpool_limits

    root, paths = tiny_tree
    runs = {}
    for side, load in (("jax", lambda p: jax_load_generator(p)),
                       ("port", lambda p: load_generator(p, device="cpu"))):
        g_ab, g_ba = (load(paths[k]) for k in ("G_AB_state_dict",
                                               "G_BA_state_dict"))
        harness = jharness if side == "jax" else tharness
        out = root / side
        with threadpool_limits(limits=2):
            runs[side] = (harness.run_fid_eval(
                g_ab, g_ba, str(root / "data"), str(out), batch=2), out)
    return runs


def test_run_fid_eval_matches_jax(fid_runs):
    (want, want_dir), (got, got_dir) = fid_runs["jax"], fid_runs["port"]
    assert list(got) == list(want) == ["monet2photo", "photo2monet", "mean"]
    for k in want:
        assert np.isfinite(got[k]) and got[k] > 0
        np.testing.assert_allclose(got[k], want[k], rtol=FID_RTOL, err_msg=k)
    got_txt = _read_results(got_dir / "test_results.txt")
    want_txt = _read_results(want_dir / "test_results.txt")
    assert [k for k, _ in got_txt] == [k for k, _ in want_txt] == list(want)
    for (k, g), (_, w) in zip(got_txt, want_txt):
        assert g == round(got[k], 4)
        np.testing.assert_allclose(g, w, rtol=FID_RTOL, atol=1e-4)


@pytest.mark.parametrize("direction", ["monet2photo", "photo2monet"])
def test_run_fid_eval_panels_match_jax(fid_runs, direction):
    name = f"panels_{direction}.png"
    with Image.open(fid_runs["port"][1] / name) as g, \
            Image.open(fid_runs["jax"][1] / name) as w:
        got, want = np.asarray(g.convert("RGB")), np.asarray(w.convert("RGB"))
    assert got.shape == want.shape == (800, 1600, 3)
    assert np.abs(got.astype(int) - want.astype(int)).mean() < 0.5


def test_run_fid_eval_skips_a_side_with_fewer_than_two_images(tiny_tree,
                                                              tmp_path,
                                                              capsys):
    root, paths = tiny_tree
    g = load_generator(paths["G_AB_state_dict"], device="cpu")
    out = tharness.run_fid_eval(g, g, str(root / "data"), str(tmp_path),
                                max_images=1, save_panels=False)
    assert out == {}
    assert "need >= 2 test images per domain (have 1/1), skipping" in \
        capsys.readouterr().out
    assert not os.path.exists(tmp_path / "test_results.txt")


def test_run_fid_eval_takes_the_inception_features(tiny_tree, inception_sd,
                                                   tmp_path):
    """The harness through a user's Inception ``.pth`` (the m_test CLI's
    route): finite FIDs, and the statistic on exactly the features the
    trunk gives the same images."""
    root, paths = tiny_tree
    torch.save(inception_sd, str(tmp_path / "inception.pth"))
    feature_fn = tinception.make_inception_feature_fn(
        str(tmp_path / "inception.pth"), device="cpu")
    seen = []
    g_ab, g_ba = (load_generator(paths[k], device="cpu")
                  for k in ("G_AB_state_dict", "G_BA_state_dict"))
    out = tharness.run_fid_eval(
        g_ab, g_ba, str(root / "data"), str(tmp_path / "eval"),
        feature_fn=lambda x: seen.append(feature_fn(x)) or seen[-1],
        batch=4, save_panels=False)
    assert list(out) == ["monet2photo", "photo2monet", "mean"]
    assert len(seen) == 4 and all(f.shape == (4, 2048) for f in seen)
    from multi_style_transfer_gan_tpu_torch.metrics import fid_from_features

    assert out["monet2photo"] == fid_from_features(seen[0], seen[1])
    assert out["photo2monet"] == fid_from_features(seen[2], seen[3])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest tests/ -m gpu` "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("allow_tf32", [False, True])
def test_inception_on_the_card_matches_cpu(cuda, trunk, allow_tf32):
    """fp32 with TF32 off inside the trunk whatever the caller's switches
    say: card and CPU features agree to 1e-4 of the largest."""
    imgs = torch.from_numpy(_images(7, (4, 256, 256, 3)))
    want = tinception.inception_pool_features(trunk, imgs).numpy()
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    torch.backends.cudnn.allow_tf32 = allow_tf32
    try:
        card = tinception.InceptionV3()
        card.load_state_dict(trunk.state_dict(), strict=True)
        card = card.to(cuda, memory_format=torch.channels_last).eval()
        got = tinception.inception_pool_features(card, imgs).cpu().numpy()
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == (allow_tf32, allow_tf32)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    _assert_features_close(got, want)
