"""Port core ops vs the JAX package's (fp32 on the CPU, numpy inputs)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multi_style_transfer_gan_tpu.core import activations as jact
from multi_style_transfer_gan_tpu.core import norm as jnorm
from multi_style_transfer_gan_tpu_torch.core import (
    gelu, in_relu, instance_norm, l2_normalize,
)


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (1, 5, 7, 3)])
@pytest.mark.parametrize("op", ["instance_norm", "in_relu"])
def test_instance_norm_matches_jax(rng, op, shape):
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    ref = np.asarray(getattr(jnorm, op)(jnp.asarray(x)))
    ours = {"instance_norm": instance_norm, "in_relu": in_relu}[op]
    got = ours(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def test_instance_norm_keeps_bf16_and_channels_last(rng):
    x = torch.from_numpy(rng.standard_normal((2, 4, 6, 6)).astype(np.float32))
    x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    y = instance_norm(x)
    assert y.dtype == torch.bfloat16
    assert y.is_contiguous(memory_format=torch.channels_last)
    ref = instance_norm(x.float())
    assert (y.float() - ref).abs().max().item() <= 2 ** -7 * ref.abs().max().item()


def test_l2_normalize_matches_jax_including_zero_vector(rng):
    u = rng.standard_normal((4, 16, 32)).astype(np.float32)
    u[1, 3] = 0.0
    ref = np.asarray(jnorm.l2_normalize(jnp.asarray(u), 1e-12))
    got = l2_normalize(torch.from_numpy(u), 1e-12).numpy()
    assert np.isfinite(got).all() and not got[1, 3].any()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_l2_normalize_zero_vector_gradient_is_finite():
    u = torch.zeros(2, 8, requires_grad=True)
    l2_normalize(u).sum().backward()
    assert torch.isfinite(u.grad).all()


def test_gelu_is_exact_erf(rng):
    x = (rng.standard_normal(4096) * 4).astype(np.float32)
    ref = np.asarray(jact.gelu(jnp.asarray(x)))
    np.testing.assert_allclose(gelu(torch.from_numpy(x)).numpy(), ref,
                               atol=1e-5, rtol=0)
