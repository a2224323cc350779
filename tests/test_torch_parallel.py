"""The port's data-parallel layer on the CPU without a process group: the
ranks' slices of the input pipeline, the batch-size rules and their JAX
messages, the single-process collectives, and the batch CLI's
``--data_parallel`` (``batch_process(devices=...)``) against the JAX
package's ``batch_process(mesh=make_mesh())`` on its 8-device virtual CPU
mesh. The two-rank training steps are in test_torch_parallel_train.py."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from multi_style_transfer_gan_tpu.data.dataset import (
    ImageFolderDataset as JaxImageFolderDataset,
)
from multi_style_transfer_gan_tpu.data.synthetic import render_photo
from multi_style_transfer_gan_tpu.parallel import (
    local_batch_size as jax_local_batch_size, make_mesh,
)
from multi_style_transfer_gan_tpu.pipelines.batch import (
    batch_process as jax_batch_process,
)
from multi_style_transfer_gan_tpu.pipelines.model_loader import (
    load_generator as jax_load_generator,
)
from multi_style_transfer_gan_tpu_torch import parallel
from multi_style_transfer_gan_tpu_torch.core.norm import batch_norm
from multi_style_transfer_gan_tpu_torch.data import ImageFolderDataset
from multi_style_transfer_gan_tpu_torch.pipelines import (
    batch_process, load_generator,
)

TRAINED = "trained/G_BA_selected.pth"
# uint8 outputs of the two pipelines: at most 1 level apart on at most 1%
# of the values
LEVEL_SHARE = 0.01


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """12 small images of mixed sizes in ``train{A}``."""
    root = tmp_path_factory.mktemp("dp_data")
    d = root / "trainA"
    d.mkdir()
    rng = np.random.default_rng(5)
    for i in range(12):
        h, w = int(rng.integers(10, 20)), int(rng.integers(10, 20))
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            d / f"{i:02d}.png")
    return root


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("seed", [0, 3, 42])
def test_batches_are_jax_slices(folder, seed, world):
    """Every rank's batches of two epochs (global batch 4 of 12 images,
    shuffled) are exactly the JAX dataset's for the same process index."""
    kw = dict(img_size=8, host_size=8)
    port = ImageFolderDataset(folder, "A", **kw)
    ref = JaxImageFolderDataset(folder, "A", **kw)
    seen = []
    for r in range(world):
        got = list(port.batches(4, seed=seed, epochs=2, process_index=r,
                                process_count=world))
        want = list(ref.batches(4, seed=seed, epochs=2, process_index=r,
                                process_count=world))
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            assert g.shape == (4 // world, 8, 8, 3)
            np.testing.assert_array_equal(g, w)
        seen.append(got)
    # the ranks' slices of a global batch are disjoint and make it whole
    whole = list(port.batches(4, seed=seed, epochs=2))
    for i, batch in enumerate(whole):
        parts = np.concatenate([s[i] for s in seen])
        assert sorted(map(bytes, parts)) == sorted(map(bytes, batch))


def test_indivisible_global_batch_raises_as_jax(folder):
    kw = dict(img_size=8, host_size=8)
    for ds in (ImageFolderDataset(folder, "A", **kw),
               JaxImageFolderDataset(folder, "A", **kw)):
        with pytest.raises(ValueError, match="global batch 6 not divisible "
                                             "by process count 4"):
            next(ds.batches(6, process_index=0, process_count=4))
    mesh = make_mesh(jax.devices()[:4])
    with pytest.raises(ValueError) as ref:
        jax_local_batch_size(6, mesh)
    with pytest.raises(ValueError) as got:
        parallel.local_batch_size(6, 4)
    assert str(got.value) == str(ref.value)
    assert parallel.local_batch_size(8, 4) == jax_local_batch_size(8, mesh)


def test_without_torchrun_it_is_one_rank(monkeypatch):
    """No torchrun environment: the device as given, no process group, rank
    0 of 1 and the writer, and every collective the identity."""
    for k in parallel.mesh.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    assert parallel.init_data_parallel("cpu") == torch.device("cpu")
    assert not parallel.active()
    assert (parallel.rank(), parallel.world_size()) == (0, 1)
    assert parallel.is_writer()
    x = torch.arange(12.0).reshape(4, 3)
    assert parallel.all_gather_batch(x) is x
    assert parallel.all_reduce_sum(x) is x
    assert torch.equal(parallel.rank_block(x), x)
    g = [x.clone()]
    parallel.all_reduce_mean_(g)
    assert torch.equal(g[0], x)
    m = torch.nn.Linear(3, 2)
    w = m.weight.detach().clone()
    assert parallel.broadcast_module_(m) is m and torch.equal(m.weight, w)
    parallel.close_data_parallel()


def test_batch_norm_without_a_group_is_the_single_device_one(rng):
    """Training-mode BatchNorm without a process group is torch's, running
    statistics included (the global-batch path runs only under
    torchrun)."""
    x = torch.from_numpy(rng.standard_normal((4, 3, 5, 5)).astype(np.float32))
    w, b = torch.rand(3) + 0.5, torch.rand(3)
    stats = [torch.zeros(3), torch.ones(3)]
    ref = [torch.zeros(3), torch.ones(3)]
    got = batch_norm(x, *stats, w, b, training=True)
    want = torch.nn.functional.batch_norm(x, *ref, w, b, True, 0.1, 1e-5)
    assert torch.equal(got, want)
    assert all(torch.equal(s, r) for s, r in zip(stats, ref))


def _photos(path, n):
    path.mkdir()
    for i in range(n):
        Image.fromarray(render_photo(700 + i, size=48 + 8 * (i % 3))).save(
            path / f"p{i:02d}.png")
    return path


def _outputs(path):
    return {name: np.asarray(Image.open(os.path.join(path, name)), np.int16)
            for name in sorted(os.listdir(path))}


@pytest.mark.parametrize("n_images,batch,replicas", [(10, 8, 2), (3, 64, 8)])
def test_data_parallel_batch_process_matches_jax_mesh(tmp_path, capsys,
                                                      n_images, batch,
                                                      replicas):
    """``devices`` repeating the CPU against JAX's 8-device mesh at canvas
    64 with ``--engine auto``: the same rounded batch (8: 10 images at
    batch 8 split 2 ways; 3 images shrink to 4 and round up to 8 over 8
    replicas) and engine choice (packed), and every output image within 1
    level on at most 1% of its values."""
    src = _photos(tmp_path / "in", n_images)
    jax_batch_process(jax_load_generator(TRAINED), src, tmp_path / "jax",
                      batch_size=batch, canvas=64, mesh=make_mesh())
    want_line = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("engine=auto")]
    stats = batch_process(load_generator(TRAINED, device="cpu"), src,
                          tmp_path / "port", batch_size=batch, canvas=64,
                          devices=["cpu"] * replicas)
    out = capsys.readouterr().out.splitlines()
    assert f"data-parallel: {replicas} replicas, {8 // replicas} images " \
           f"each of a batch of 8" in out
    assert want_line == ["engine=auto -> packed (batch 8, canvas 64)"]
    assert [ln for ln in out if ln.startswith("engine=auto")] == want_line
    assert stats["processed"] == n_images
    sub = "cyclegan_photo2monet"
    want, got = _outputs(tmp_path / "jax" / sub), _outputs(tmp_path / "port" / sub)
    assert sorted(got) == sorted(want) and len(got) == n_images
    for name, ref in want.items():
        d = np.abs(got[name] - ref)
        assert d.max() <= 1 and (d > 0).mean() <= LEVEL_SHARE, name


def test_batch_process_takes_one_device_or_a_list(tmp_path):
    model = load_generator(TRAINED, device="cpu")
    with pytest.raises(TypeError, match="one of device= and devices="):
        batch_process(model, tmp_path, tmp_path / "out")
    with pytest.raises(TypeError, match="one of device= and devices="):
        batch_process(model, tmp_path, tmp_path / "out", device="cpu",
                      devices=["cpu"])
