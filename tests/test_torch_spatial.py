"""The port's height-sharded inference (``parallel/spatial.py``) against
the JAX package's (tests/test_spatial.py) and against the port's own
unsharded forward, on the CPU.

JAX shards over its 8-device virtual CPU mesh (conftest.py); the port over
``[cpu] * sp``, one process driving a list of devices that may repeat. The
weights are the port's, drawn by its init law from a seed with seeded
biases, FiLM and BatchNorm statistics on top (so that the style vector and
the running statistics reach the output), carried to JAX by its own
importer (``enhanced_generator_from_sd``, ``plain_generator_from_sd``).
Inputs are numpy draws from a seed. Tolerances: atol 1e-5 for the plain
generator (JAX's own test of its sharding), atol 1e-4 for the enhanced
one (the sharded reductions reorder sums through 13 InstanceNorms; JAX
read 2.3e-5 against its unsharded forward, the port up to 3.5e-5).
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from multi_style_transfer_gan_tpu.cli import direct_transform as jax_direct_cli
from multi_style_transfer_gan_tpu.data.synthetic import render_photo
from multi_style_transfer_gan_tpu.models import (
    enhanced_generator_apply, plain_generator_apply,
)
from multi_style_transfer_gan_tpu.parallel import (
    spatial_apply as jax_spatial_apply, spatial_mesh as jax_spatial_mesh,
)
from multi_style_transfer_gan_tpu.pipelines import direct as jdirect
from multi_style_transfer_gan_tpu.pipelines.model_loader import (
    LoadedModel as JaxLoadedModel, load_generator as jax_load_generator,
)
from multi_style_transfer_gan_tpu.weights.torch_import import (
    enhanced_generator_from_sd, plain_generator_from_sd,
)
from multi_style_transfer_gan_tpu_torch.cli import direct_transform
from multi_style_transfer_gan_tpu_torch.models import (
    EnhancedGenerator, PlainGenerator,
)
from multi_style_transfer_gan_tpu_torch.parallel import (
    spatial, spatial_apply, spatial_mesh,
)
from multi_style_transfer_gan_tpu_torch.parallel.spatial import (
    gather_rows, halo_rows, take_rows, window_pieces,
)
from multi_style_transfer_gan_tpu_torch.pipelines import (
    load_generator, model_from_state_dict,
)
from multi_style_transfer_gan_tpu_torch.pipelines import direct as tdirect

TRAINED = "trained/G_BA_selected.pth"
PLAIN_ATOL = 1e-5
ENHANCED_ATOL = 1e-4
CPU = torch.device("cpu")
# (H, W, shards): aligned 8-row windows (128 / 2); 4-row bottleneck shards
# (128 / 8, 64 / 4: a block piece draws on two shards, half the devices
# get none); windows across shard boundaries (96 / 2: 12 token rows a
# shard); a padded last window (48 / 3: 12 token rows); padded windows
# along the width (W = 48)
ENHANCED_CASES = [(128, 128, 2), (128, 128, 8), (96, 48, 2), (64, 64, 4),
                  (48, 48, 3)]


def _seeded_sd(module, seed):
    """The module's state dict with seeded biases, FiLM, LayerNorm shifts
    and BatchNorm running statistics (the init law leaves them 0 or 1)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in module.state_dict().items():
        a = v.numpy().copy()
        if k.endswith("bias") or "style_mod" in k or k.endswith("running_mean"):
            a = rng.normal(0, 0.1, a.shape).astype(a.dtype)
        elif k.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
        sd[k] = a
    return sd


def _image(seed, shape):
    return np.tanh(np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def _jax_loaded(kind, params, channels):
    fwd = {"plain": plain_generator_apply,
           "enhanced": enhanced_generator_apply}[kind]
    return JaxLoadedModel(kind=kind, channels=channels, direction=None,
                          params=params, apply=lambda x: fwd(params, x),
                          precision="highest")


def _port(sd):
    return model_from_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                                 precision="highest", device="cpu")


def _sharded(model, x, sp):
    """The port's sharded output joined on the CPU, as numpy."""
    shards = spatial_apply(model, devices=[CPU] * sp)(torch.from_numpy(x))
    return gather_rows(shards, CPU).numpy()


@pytest.fixture(scope="module")
def enhanced():
    """The c4 one-block generator: (state dict, port model, JAX params, JAX
    unsharded outputs by input shape, computed once)."""
    sd = _seeded_sd(EnhancedGenerator(
        4, 1, generator=torch.Generator().manual_seed(0)), 0)
    params = enhanced_generator_from_sd(sd)
    fwd = jax.jit(enhanced_generator_apply)   # ~1 s a shape; eager ~9 s
    refs = {}
    for H, W, _ in ENHANCED_CASES:
        if (H, W) not in refs:
            refs[H, W] = np.asarray(fwd(params, jnp.asarray(
                _image(H + W, (1, H, W, 3)))))
    return sd, _port(sd), params, refs


@pytest.fixture(scope="module")
def plain():
    sd = _seeded_sd(PlainGenerator(
        8, generator=torch.Generator().manual_seed(1)), 1)
    return sd, _port(sd), plain_generator_from_sd(sd)


def test_plain_spatial_matches_jax_and_unsharded(plain):
    """JAX's test_plain_spatial_matches_unsharded: c8, (2, 128, 64), 8
    shards, against JAX's spatial_apply on its 8-device mesh and against
    the port unsharded."""
    _, model, params = plain
    x = _image(1, (2, 128, 64, 3))
    got = _sharded(model, x, 8)
    ref = np.asarray(jax_spatial_apply(_jax_loaded("plain", params, 8),
                                       mesh=jax_spatial_mesh(8))(
        jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, atol=PLAIN_ATOL, rtol=PLAIN_ATOL)
    unsharded = model.apply(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, unsharded, atol=PLAIN_ATOL,
                               rtol=PLAIN_ATOL)


@pytest.mark.parametrize("H,W,sp", ENHANCED_CASES)
def test_enhanced_spatial_matches_unsharded(enhanced, H, W, sp):
    """JAX's test_enhanced_spatial_matches_unsharded (c4, one block) and
    the repartition cases: the sharded port against the port unsharded and
    against JAX's unsharded forward."""
    _, model, _, refs = enhanced
    x = _image(H + W, (1, H, W, 3))
    got = _sharded(model, x, sp)
    unsharded = model.apply(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, unsharded, atol=ENHANCED_ATOL,
                               rtol=ENHANCED_ATOL)
    np.testing.assert_allclose(got, refs[H, W], atol=ENHANCED_ATOL,
                               rtol=ENHANCED_ATOL)


@pytest.mark.slow   # as JAX tiers its sharded enhanced tests
def test_enhanced_spatial_matches_jax_spatial(enhanced):
    """Against JAX's own enhanced spatial_apply at 2 shards (JAX tiers it
    slow too)."""
    _, model, params, _ = enhanced
    x = _image(128 + 128, (1, 128, 128, 3))
    ref = np.asarray(jax_spatial_apply(_jax_loaded("enhanced", params, 4),
                                       mesh=jax_spatial_mesh(2))(
        jnp.asarray(x)))
    np.testing.assert_allclose(_sharded(model, x, 2), ref,
                               atol=ENHANCED_ATOL, rtol=ENHANCED_ATOL)


def _local_stats(xs, eps=1e-5):
    """Planted fault: each shard's own InstanceNorm statistics."""
    out = []
    for x in xs:
        var, mean = torch.var_mean(x.float(), dim=(2, 3), correction=0,
                                   keepdim=True)
        out.append((mean, torch.rsqrt(var + eps)))
    return out


def _zero_halos(xs, top, bottom):
    """Planted fault: zero rows where the neighbours' rows belong."""
    return [take_rows([x], -top, x.shape[2] + bottom, x.device) for x in xs]


def _shard_pieces(offsets, rows):
    """Planted fault: the block on each shard, padded to whole windows on
    its own, with no repartition."""
    return list(offsets)


@pytest.mark.parametrize("name,fault", [
    ("instance_norm_stats", _local_stats),
    ("halo_rows", _zero_halos),
    ("window_pieces", _shard_pieces)])
def test_planted_faults_fail(enhanced, monkeypatch, name, fault):
    """Each fault moves the output far past the tolerance (96 x 48 at 2
    shards: 12 token rows a shard, so the block's windows cross the
    boundary)."""
    _, model, _, refs = enhanced
    x = _image(96 + 48, (1, 96, 48, 3))
    monkeypatch.setattr(spatial, name, fault)
    got = _sharded(model, x, 2)
    assert np.abs(got - refs[96, 48]).max() > 100 * ENHANCED_ATOL


def test_spatial_rejects_undivisible_height(plain):
    """JAX's message: H must divide by 16 x the shard count."""
    _, model, params = plain
    x = np.zeros((1, 64, 64, 3), np.float32)
    with pytest.raises(ValueError) as jax_err:
        jax_spatial_apply(_jax_loaded("plain", params, 8),
                          mesh=jax_spatial_mesh(8))(jnp.asarray(x))
    with pytest.raises(ValueError) as err:
        spatial_apply(model, devices=[CPU] * 8)(torch.from_numpy(x))
    assert str(err.value) == str(jax_err.value) == (
        "height 64 not divisible by 16 * 8 mesh shards")


def test_spatial_mesh_needs_devices():
    """JAX's message for too few devices; with none named, the local CUDA
    cards (none on this host)."""
    with pytest.raises(ValueError) as jax_err:
        jax_spatial_mesh(9)
    with pytest.raises(ValueError) as err:
        spatial_mesh(9, [CPU] * 8)
    assert str(err.value) == str(jax_err.value) == "need 9 devices, have 8"
    with pytest.raises(ValueError, match="need 2 devices, have 0"):
        spatial_mesh(2)
    assert spatial_mesh(2, ["cpu"] * 3) == [CPU, CPU]


def test_spatial_output_is_height_sharded(plain):
    """JAX's test_spatial_output_is_height_sharded: no implicit gather, a
    list of the shard count's (B, H / sp, W, 3) row shards."""
    _, model, _ = plain
    shards = spatial_apply(model, devices=["cpu"] * 4)(
        torch.zeros(1, 128, 64, 3))
    assert len(shards) == 4
    assert all(tuple(s.shape) == (1, 32, 64, 3) and s.device == CPU
               for s in shards)
    assert tuple(gather_rows(shards, "cpu").shape) == (1, 128, 64, 3)


@pytest.mark.parametrize("offsets,rows,want", [
    ([0, 12, 24], 24, [0, 16, 24]),            # 96 rows, 2 shards
    ([0, 4, 8, 12, 16], 16, [0, 8, 8, 16, 16]),  # 64 rows, 4 shards
    ([0, 4, 8, 12], 12, [0, 8, 8, 12]),        # 48 rows, 3: padded last
    ([0, 84, 168, 252], 252, [0, 88, 168, 252]),  # 1008 rows, 3 shards
    ([0, 16, 32], 32, [0, 16, 32])])           # aligned: the shards
def test_window_pieces(offsets, rows, want):
    assert window_pieces(offsets, rows) == want


def test_halos_are_copies():
    """A halo is a copy of the neighbour's rows (zeros past the image),
    never a view: writing the shards afterwards leaves it as it was."""
    rows = torch.arange(2 * 1 * 8 * 2, dtype=torch.float32).reshape(
        2, 1, 8, 2).contiguous(memory_format=torch.channels_last)
    xs = [rows[:, :, :4].clone(), rows[:, :, 4:].clone()]
    halos = list(halo_rows(xs, 2, 1))
    for x in xs:
        x.fill_(-1)
    padded = torch.cat([torch.zeros(2, 1, 2, 2), rows,
                        torch.zeros(2, 1, 1, 2)], dim=2)
    torch.testing.assert_close(halos[0], padded[:, :, 0:7], atol=0, rtol=0)
    torch.testing.assert_close(halos[1], padded[:, :, 4:11], atol=0, rtol=0)
    assert halos[0].is_contiguous(memory_format=torch.channels_last)


# ---------------------------------------------------------------------------
# the pipelines and the CLI on the trained c16 weights, against JAX's on
# its mesh: within 1 level

@pytest.fixture(scope="module")
def photo(tmp_path_factory):
    path = tmp_path_factory.mktemp("img") / "photo.png"
    Image.fromarray(render_photo(900300, size=128)[:90, :120]).save(path)
    return str(path)


def _levels(path):
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), np.int64)


def test_transform_image_spatial_matches_jax(photo, tmp_path):
    got = tdirect.transform_image(load_generator(TRAINED, device="cpu"), photo,
                                  str(tmp_path / "port.png"), size=64,
                                  spatial=2)
    jdirect.transform_image(jax_load_generator(TRAINED), photo,
                            str(tmp_path / "jax.png"), size=64, spatial=2)
    assert got.shape == (64, 64, 3)
    d = np.abs(_levels(tmp_path / "port.png") - _levels(tmp_path / "jax.png"))
    assert d.max() <= 1


def test_direct_transform_cli_spatial_matches_jax(monkeypatch, photo,
                                                  tmp_path):
    """``--spatial 2`` with the CLI's device set to the CPU: two copies of
    the CPU stand in for two cards."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(direct_transform, "DEVICE", "cpu")
    argv = ["--image", photo, "--model", TRAINED, "--size", "64",
            "--spatial", "2"]
    jax_direct_cli.main(argv + ["--output", str(tmp_path / "jax.png")])
    assert direct_transform.main(
        argv + ["--output", str(tmp_path / "port.png")]) == 0
    d = np.abs(_levels(tmp_path / "port.png") - _levels(tmp_path / "jax.png"))
    assert d.max() <= 1


def test_direct_transform_cli_spatial_needs_the_cards(monkeypatch, capsys,
                                                      photo, tmp_path):
    """On a host with fewer cards than ``--spatial`` asks, exit 1 with
    JAX's message, and write nothing: never an unsharded run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    out = tmp_path / "out.png"
    assert direct_transform.main(["--image", photo, "--model", TRAINED,
                                  "--spatial", "2", "--output",
                                  str(out)]) == 1
    assert "need 2 devices, have 0" in capsys.readouterr().err
    assert not os.path.exists(out)


def test_size_sweep_and_skip_blends_take_spatial(photo, tmp_path):
    """``test_different_sizes`` and ``try_skip_connections`` with
    ``spatial=2`` write what their unsharded runs write, within 1 level."""
    model = load_generator(TRAINED, device="cpu")
    for spatial_n in (0, 2):
        d = tmp_path / f"sp{spatial_n}"
        tdirect.test_different_sizes(model, photo, str(d / "sizes"),
                                     sizes=(64,), spatial=spatial_n)
        tdirect.try_skip_connections(model, photo, str(d / "skip"), size=64,
                                     spatial=spatial_n)
    for name in ("sizes/size_64.png", "skip/skip_50.png"):
        d = np.abs(_levels(tmp_path / "sp0" / name)
                   - _levels(tmp_path / "sp2" / name))
        assert d.max() <= 1, name
