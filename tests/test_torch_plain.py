"""The port's plain encoder-decoder generator against the JAX package on the
CPU: the forward in eval and train mode, the weight converter, the loader,
the uint8 program, and a plain checkpoint through every serving entry
point; on the card, its forward against the CPU."""

import io
import threading
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from multi_style_transfer_gan_tpu.data.synthetic import render_photo
from multi_style_transfer_gan_tpu.models import plain_generator_apply
from multi_style_transfer_gan_tpu.pipelines import direct as jdirect
from multi_style_transfer_gan_tpu.pipelines.batch import (
    make_batch_fn as jax_make_batch_fn,
)
from multi_style_transfer_gan_tpu.pipelines.model_loader import (
    load_generator as jax_load_generator,
)
from multi_style_transfer_gan_tpu.weights.torch_import import (
    params_to_torch_sd, plain_generator_from_sd,
)
from multi_style_transfer_gan_tpu_torch.models import PlainGenerator
from multi_style_transfer_gan_tpu_torch.pipelines import (
    batch_process, load_generator, make_batch_fn,
)
from multi_style_transfer_gan_tpu_torch.pipelines import advanced as tadvanced
from multi_style_transfer_gan_tpu_torch.pipelines.compare import compare_models
from multi_style_transfer_gan_tpu_torch.pipelines import direct as tdirect
from multi_style_transfer_gan_tpu_torch.serving import (
    StyleTransferService, serve,
)
from multi_style_transfer_gan_tpu_torch.weights import (
    state_dict_from_jax_params,
)
from torch_oracle import make_plain_sd

TRAINED = "trained/G_BA_selected.pth"
C = 8
ATOL = 1e-5          # fp32 forward, port vs JAX
# uint8 program at fp32: conv algorithms differ by ~1e-6, which flips a
# rounding by one level on a small share of values
U8_MAX_DIFF, U8_MAX_SHARE = 1, 0.01
BF16_MEAN_LSB = 4.0  # bf16 program vs fp32, mean |d| in levels (chip_smoke.py)


@pytest.fixture(scope="module")
def jax_params():
    """JAX plain-generator parameters at c8 with random weights, BatchNorm
    affines and running statistics (so eval mode does real work)."""
    return {k: jnp.asarray(v) for k, v in plain_generator_from_sd(
        make_plain_sd(np.random.default_rng(3), c=C)).items()}


def _module(jax_params) -> PlainGenerator:
    m = PlainGenerator(C)
    m.load_state_dict(state_dict_from_jax_params(jax_params, "plain"),
                      strict=True)
    return m


def _images(n=2, size=64, seed=900300):
    return np.stack([render_photo(seed + i, size=size) for i in range(n)])


def _model_range(u8):
    return (u8.astype(np.float32) / 255.0) * 2.0 - 1.0


@pytest.mark.parametrize("training", [False, True])
def test_plain_forward_matches_jax(jax_params, training):
    """c8, 64^2, fp32: the output (atol 1e-5) and, in train mode, the
    updated running statistics (atol 1e-5) and num_batches_tracked."""
    x = _model_range(_images())
    out = plain_generator_apply(jax_params, jnp.asarray(x), training=training)
    ref, new = out if training else (out, None)
    m = _module(jax_params).train(training)
    with torch.no_grad():
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    sd = m.state_dict()
    for k, v in jax_params.items():
        if k.endswith(("running_mean", "running_var")):
            want = np.asarray(new[k] if training else v)
            np.testing.assert_allclose(sd[k].numpy(), want, atol=ATOL,
                                       rtol=0, err_msg=k)
            moved = not np.array_equal(want, np.asarray(v))
            assert moved == training, k
        if k.endswith("running_var"):
            nbt = sd[k[:-len("running_var")] + "num_batches_tracked"]
            assert int(nbt) == int(training)


def test_converter_round_trips_plain(jax_params):
    """state_dict_from_jax_params(kind='plain') is the JAX exporter's
    layout (the decoder's four IOHW transposed convs), plus the
    num_batches_tracked a strict load needs; the JAX importer takes it
    back to the same parameters."""
    ours = state_dict_from_jax_params(jax_params, "plain")
    ref = params_to_torch_sd(jax_params, "plain")
    assert sorted(k for k in ours if not k.endswith("num_batches_tracked")) \
        == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v),
                                      err_msg=k)
    assert tuple(ours["decoder.0.weight"].shape) == (8 * C, 4 * C, 4, 4)
    assert tuple(ours["encoder.2.weight"].shape) == (2 * C, C, 4, 4)
    back = plain_generator_from_sd({k: v.numpy() for k, v in ours.items()})
    assert sorted(back) == sorted(jax_params)
    for k, v in jax_params.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
    assert sorted(PlainGenerator(C).state_dict()) == sorted(ours)


@pytest.fixture(scope="module")
def plain_pth(tmp_path_factory):
    """A reference-schema plain checkpoint (the legacy ``G_A`` flavor)."""
    path = tmp_path_factory.mktemp("plain") / "G_A_plain.pth"
    torch.save({"G_A": make_plain_sd(np.random.default_rng(5), c=C),
                "epoch": 7}, path)
    return str(path)


@pytest.fixture(scope="module")
def plain_models(plain_pth):
    return jax_load_generator(plain_pth), load_generator(plain_pth,
                                                         device="cpu")


def test_load_generator_plain_matches_jax(plain_models):
    jm, tm = plain_models
    assert (tm.kind, tm.channels, tm.direction) == ("plain", C, None)
    assert not tm.module.training
    x = _model_range(_images())
    ref = np.asarray(jm.apply(jnp.asarray(x)))
    got = tm.apply(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("engine", ["nhwc", "packed"])
def test_plain_uint8_program_matches_jax(plain_models, engine):
    """The plain model runs its own forward whichever engine is asked for:
    fp32 uint8 at most 1 level apart on at most 1% of values."""
    jm, tm = plain_models
    batch = _images()
    ref = np.asarray(jax_make_batch_fn(jm, "cyclegan", "enhanced", 0.8, 0.7,
                                       True, True, engine=engine)(batch))
    got = make_batch_fn(tm, "cyclegan", engine=engine, device="cpu")(batch)
    assert got.dtype == torch.uint8 and got.shape == batch.shape
    d = np.abs(got.numpy().astype(int) - ref.astype(int))
    assert d.max() <= U8_MAX_DIFF and (d > 0).mean() <= U8_MAX_SHARE


def test_plain_bf16_program_keeps_batchnorm_fp32(plain_models):
    """bf16: conv weights in bf16, every BatchNorm weight, bias and running
    statistic in fp32 (the JAX batch_norm normalizes in fp32), within
    BF16_MEAN_LSB of the fp32 program and of the JAX bf16 program."""
    jm, tm = plain_models
    batch = _images()
    run = make_batch_fn(tm, "cyclegan", compute_dtype=torch.bfloat16,
                        device="cpu")
    for m in run.module.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            assert {t.dtype for t in (m.weight, m.bias, m.running_mean,
                                      m.running_var)} == {torch.float32}
        elif isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            assert m.weight.dtype == m.bias.dtype == torch.bfloat16
    assert tm.module.encoder[0].weight.dtype == torch.float32  # a copy
    got = run(batch).numpy().astype(float)
    fp32 = make_batch_fn(tm, "cyclegan", device="cpu")(batch).numpy()
    ref = np.asarray(jax_make_batch_fn(jm, "cyclegan", "enhanced", 0.8, 0.7,
                                       True, True,
                                       compute_dtype=jnp.bfloat16)(batch))
    assert np.abs(got - fp32).mean() <= BF16_MEAN_LSB
    assert np.abs(got - ref).mean() <= BF16_MEAN_LSB


# ---------------------------------------------------------------------------
# a plain checkpoint through every serving entry point
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def photo(tmp_path_factory):
    path = tmp_path_factory.mktemp("img") / "photo.png"
    Image.fromarray(render_photo(900310, size=96)[:72, :96]).save(path)
    return str(path)


def test_batch_process_runs_plain(plain_models, tmp_path):
    src = tmp_path / "in"
    src.mkdir()
    for i, (w, h) in enumerate([(70, 50), (40, 64), (64, 64)]):
        Image.fromarray(render_photo(900320 + i, size=96)[:h, :w]).save(
            src / f"{i}.png")
    for engine in ("auto", "packed"):
        stats = batch_process(plain_models[1], str(src),
                              str(tmp_path / engine), batch_size=4,
                              canvas=64, engine=engine, device="cpu")
        assert stats["processed"] == 3
        with Image.open(tmp_path / engine / "cyclegan_photo2monet" /
                        "0.png") as img:
            assert img.size == (70, 50)


def test_server_runs_plain(plain_models):
    service = StyleTransferService(plain_models[1], canvas=64, max_batch=2,
                                   max_wait_ms=1.0, device="cpu")
    server = serve(service, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    host, port = server.server_address
    try:
        buf = io.BytesIO()
        Image.fromarray(render_photo(900330, size=64)[:40, :50]).save(buf,
                                                                      "PNG")
        req = urllib.request.Request(f"http://{host}:{port}/stylize",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
            assert Image.open(io.BytesIO(r.read())).size == (50, 40)
    finally:
        server.shutdown()
        server.server_close()
        service.close()


def test_direct_transform_plain_matches_jax(plain_models, photo):
    jm, tm = plain_models
    ref = np.asarray(jdirect.transform_image(jm, photo, size=64))
    got = tdirect.transform_image(tm, photo, size=64)
    assert got.shape == (64, 64, 3)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_advanced_and_compare_take_plain(plain_models, photo, tmp_path):
    """advanced_transform's variants and the compare pipeline's CycleGAN
    side run a plain model (the compare's enhanced side is the trained
    c16)."""
    tm = plain_models[1]
    outs = tadvanced.generate_with_different_settings(
        tm, photo, str(tmp_path / "adv"), variants=("standard", "detail"))
    assert sorted(outs) == ["detail", "standard"]
    assert (tmp_path / "adv" / "plain_standard.jpg").exists()
    enhanced = load_generator(TRAINED, device="cpu")
    got = compare_models(enhanced, tm, photo, str(tmp_path / "cmp"))
    with Image.open(got["cyclegan"]) as img:
        assert img.size == (96, 72)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest tests/ -m gpu` "
                    "on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("training", [False, True])
def test_plain_forward_on_the_card_matches_cpu(cuda, jax_params, training):
    """fp32, TF32 off: the card's forward (and, in train mode, its running
    statistics) against the CPU's at atol 1e-4 (cuDNN and the CPU sum in
    other orders)."""
    x = torch.from_numpy(_model_range(_images())).permute(0, 3, 1, 2)
    outs = {}
    for dev in ("cpu", cuda):
        m = _module(jax_params).to(dev).train(training)
        with torch.no_grad():
            outs[str(dev)] = (m(x.to(dev)).cpu(),
                              {k: v.cpu() for k, v in m.state_dict().items()})
    (ref, ref_sd), (got, got_sd) = outs["cpu"], outs[str(cuda)]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4, rtol=0)
    for k, v in ref_sd.items():
        np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(), atol=1e-4,
                                   rtol=0, err_msg=k)
