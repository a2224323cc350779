"""The bf16 gate of ``chip_smoke.py`` (``bf16_gate``) on the CPU.

``chip_smoke.JAX_BF16_DISTANCE`` holds the JAX package's bf16 programs'
distances from its fp32 programs on the gate's seeded images; the card's
bf16 program is held to BF16_GATE_FACTOR times them. Here each constant is
recomputed from JAX on the same images and checked to its stated four
significant digits. Then the batch invariance the gate leans on: on the
CPU, the port's and JAX's bf16 ``forward_u8`` (the study's
``select_checkpoints``) give the same bytes at batches 1, 4 and 8."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke as smoke
from multi_style_transfer_gan_tpu_torch.pipelines import load_generator
from multi_style_transfer_gan_tpu_torch.scripts import select_checkpoints

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import select_checkpoints as jax_sc  # noqa: E402

INVARIANCE_IMAGES = 8
INVARIANCE_BATCHES = (1, 4, 8)


@pytest.fixture(scope="module")
def jax_trained():
    from multi_style_transfer_gan_tpu.pipelines import (
        load_generator as jax_load_generator,
    )

    return jax_load_generator(smoke.TRAINED)


def _jax_programs(model, engine="nhwc"):
    """JAX's uint8 program in fp32 and in bf16 (``make_batch_fn``)."""
    from multi_style_transfer_gan_tpu.pipelines.batch import make_batch_fn

    return [make_batch_fn(model, "cyclegan", "enhanced", 0.8, 0.7, True,
                          True, compute_dtype=dtype, engine=engine)
            for dtype in (None, jnp.bfloat16)]


def _jax_single_image(model, key, tmp_path):
    """(fp32, bf16) uint8 outputs of JAX's single-image pipeline ``key``
    ("direct" or "local style") on ``chip_smoke.gate_photo``."""
    from PIL import Image

    from multi_style_transfer_gan_tpu.pipelines import transform_image
    from multi_style_transfer_gan_tpu.pipelines.local_style import (
        enhanced_local_style_transfer,
    )

    photo = str(tmp_path / "photo.png")
    Image.fromarray(smoke.gate_photo()).save(photo)
    bf16 = dataclasses.replace(model, apply=jax.jit(
        lambda x: model.apply(x.astype(jnp.bfloat16)).astype(jnp.float32)))
    outs = []
    for name, m in (("fp32", model), ("bf16", bf16)):
        out = str(tmp_path / f"{name}.png")
        if key == "direct":
            transform_image(m, photo, out)
            with Image.open(out) as img:
                outs.append(np.asarray(img.convert("RGB")))
        else:
            outs.append(np.asarray(enhanced_local_style_transfer(
                m, photo, out, make_comparison=False)))
    return outs


@pytest.mark.parametrize("key", list(smoke.JAX_BF16_DISTANCE),
                         ids=lambda k: "-".join(map(str, k)))
def test_jax_bf16_distance_constants(key, jax_trained, tmp_path):
    from multi_style_transfer_gan_tpu.pipelines import (
        load_generator as jax_load_generator,
    )

    kind, canvas = key[0], key[-1]
    if kind in ("direct", "local style"):
        fp32, bf16 = _jax_single_image(jax_trained, kind, tmp_path)
    else:
        if kind == "plain":
            path = str(tmp_path / "plain.pth")
            smoke.plain_checkpoint(path, smoke.PLAIN_CHANNELS)
            model, engine = jax_load_generator(path), "nhwc"
        else:
            model, engine = jax_trained, key[1]
        x = smoke.gate_images(canvas)
        fp32, bf16 = (np.asarray(fn(x)) for fn in _jax_programs(model,
                                                                 engine))
    mean, share = smoke.bf16_distance(bf16, fp32)
    assert (float(f"{mean:.4g}"), float(f"{share:.4g}")) \
        == smoke.JAX_BF16_DISTANCE[key], (mean, share)


@pytest.fixture(scope="module")
def invariance_images():
    return smoke.gate_images(256)[:INVARIANCE_IMAGES]


@pytest.fixture(scope="module")
def forward_u8(jax_trained, invariance_images):
    """side -> batch -> that side's bf16 ``forward_u8`` output on the
    invariance images at that batch, computed once."""
    port = load_generator(smoke.TRAINED, device="cpu")
    runs = {"port": lambda n: select_checkpoints.forward_u8(
                port, invariance_images, batch=n,
                compute_dtype=torch.bfloat16),
            "jax": lambda n: jax_sc.forward_u8(jax_trained.apply,
                                               invariance_images, batch=n)}
    cache = {}

    def get(side, n):
        if (side, n) not in cache:
            cache[side, n] = runs[side](n)
        return cache[side, n]
    return get


@pytest.mark.parametrize("batch", INVARIANCE_BATCHES)
@pytest.mark.parametrize("side", ["port", "jax"])
def test_bf16_forward_u8_is_batch_invariant_on_cpu(side, batch, forward_u8,
                                                   invariance_images):
    got = forward_u8(side, batch)
    assert got.shape == invariance_images.shape and got.dtype == np.uint8
    assert np.array_equal(got, forward_u8(side, INVARIANCE_IMAGES))
