"""The port's kernel modules vs the JAX package, and kernel vs plain on
the card.

On the CPU each wrapper runs its plain version, which is held against the
JAX math (and, for channel attention, against the three Pallas layouts in
interpret mode). Tests marked ``gpu`` build the CUDA kernels and hold them
against the plain versions; they skip without a CUDA device.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from multi_style_transfer_gan_tpu.models.enhanced_generator import (
    _attention_math,
)
from multi_style_transfer_gan_tpu.models.structural_transformer import (
    structural_transformer_apply, structural_transformer_init,
)
from multi_style_transfer_gan_tpu_torch.models import (
    StructuralTransformerBlock,
)
from multi_style_transfer_gan_tpu_torch.ops.kernels import (
    fused_structural_block, reset_launch_counts, structural_block_plain,
    window_channel_attention, window_channel_attention_plain,
)
from multi_style_transfer_gan_tpu_torch.ops.kernels.fused_transformer import (
    weight_shapes,
)
from multi_style_transfer_gan_tpu_torch.weights import (
    state_dict_from_jax_params,
)


def _attn_args(rng, shape, zero_window=True):
    """x (B, H, W, C) and the JAX-layout weights (1x1 HWIO kernels)."""
    C = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    if zero_window:
        x[0, :4, :4] = 0.0
    return (x,
            (rng.standard_normal((1, 1, C, 3 * C)) * 0.1).astype(np.float32),
            rng.standard_normal(3 * C).astype(np.float32),
            (rng.standard_normal((1, 1, C, C)) * 0.1).astype(np.float32),
            rng.standard_normal(C).astype(np.float32))


def _torch_attn_args(args, device="cpu", dtype=torch.float32):
    """The same arguments as tensors, weights in the PyTorch (out, in)
    layout of the 1x1 convs."""
    x, wq, bq, wp, bp = args
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)
    return t(x), t(wq[0, 0].T), t(bq), t(wp[0, 0].T), t(bp)


# ---------------------------------------------------------------------------
# channel attention on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C", [16, 32, 64])
def test_window_attention_plain_matches_jax_math(rng, C):
    args = _attn_args(rng, (2, 8, 12, C))
    ref = np.asarray(_attention_math(*map(jnp.asarray, args),
                                     window_size=4, eps=1e-12))
    got = window_channel_attention(*_torch_attn_args(args)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.fixture
def interpret_pallas(monkeypatch):
    import multi_style_transfer_gan_tpu.ops.pallas.window_attention as wa
    import multi_style_transfer_gan_tpu.ops.pallas.window_attention_grouped \
        as wag
    import multi_style_transfer_gan_tpu.ops.pallas.window_attention_v3 as wa3

    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    for mod in (wa, wag, wa3):
        monkeypatch.setattr(mod.pl, "pallas_call", interp)


@pytest.mark.parametrize("impl,shape", [
    ("v1", (1, 8, 8, 16)),
    ("grouped", (1, 8, 32, 16)),
    ("v3", (1, 8, 8, 16)),
])
def test_window_attention_matches_pallas_layouts(rng, interpret_pallas, impl,
                                                 shape):
    """One op, three TPU layouts: the port's single formulation matches
    each Pallas kernel (interpret mode) at a tiny shape."""
    from multi_style_transfer_gan_tpu.ops.pallas.window_attention import (
        fused_window_channel_attention,
    )
    from multi_style_transfer_gan_tpu.ops.pallas.window_attention_grouped \
        import grouped_window_channel_attention
    from multi_style_transfer_gan_tpu.ops.pallas.window_attention_v3 import (
        window_attention_v3,
    )

    fn = {"v1": fused_window_channel_attention,
          "grouped": grouped_window_channel_attention,
          "v3": window_attention_v3}[impl]
    args = _attn_args(rng, shape)
    ref = np.asarray(fn(*map(jnp.asarray, args), window_size=4, eps=1e-12))
    got = window_channel_attention(*_torch_attn_args(args)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_window_attention_rejects_ragged_grid(rng):
    args = _torch_attn_args(_attn_args(rng, (1, 8, 10, 16)))
    with pytest.raises(ValueError, match="divisible by 4"):
        window_channel_attention(*args)


# ---------------------------------------------------------------------------
# structural transformer block on the CPU
# ---------------------------------------------------------------------------

def _block_params(rng, dim):
    params = {k: np.asarray(v) for k, v in structural_transformer_init(
        jax.random.PRNGKey(3), dim).items()}
    # non-zero style modulation and norm affines, so FiLM and LN weights count
    for k in ("style_mod.weight", "style_mod.bias", "norm1.weight",
              "norm1.bias", "norm2.weight", "norm2.bias"):
        params[k] = (params[k] + rng.standard_normal(params[k].shape)
                     * 0.1).astype(np.float32)
    return params


@pytest.mark.parametrize("hw", [(8, 8), (12, 20)])
def test_structural_block_matches_jax(rng, hw):
    """The block module (struct embed, FiLM, body) == the JAX XLA block,
    on a divisible grid and on a ragged one (masked edge windows)."""
    H, W = hw
    B, dim = 2, 64
    params = _block_params(rng, dim)
    tokens = rng.standard_normal((B, H * W, dim)).astype(np.float32)
    style = rng.standard_normal((B, dim)).astype(np.float32)
    orig = rng.standard_normal((B, 4 * H, 4 * W, 3)).astype(np.float32)
    apply = jax.jit(lambda *a: structural_transformer_apply(*a, (H, W)))
    ref = np.asarray(apply({k: jnp.asarray(v) for k, v in params.items()},
                           jnp.asarray(tokens), jnp.asarray(style),
                           jnp.asarray(orig)))

    block = StructuralTransformerBlock(dim).eval()
    block.load_state_dict(state_dict_from_jax_params(params), strict=True)
    with torch.inference_mode():
        got = block(torch.from_numpy(tokens).reshape(B, H, W, dim),
                    torch.from_numpy(style),
                    torch.from_numpy(orig).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.reshape(B, H * W, dim).numpy(), ref,
                               atol=2e-4, rtol=2e-4)


def test_struct_resize_branch_is_not_ported(rng):
    """The struct-embed resize branch: a 36 x 44 input gives the embed a
    9 x 11 grid against the block's 8 x 8, so the embed is resized
    (antialiased bilinear, jax.image.resize) before the block == the JAX
    block."""
    B, dim, (H, W), (H0, W0) = 2, 64, (8, 8), (36, 44)
    params = _block_params(rng, dim)
    tokens = rng.standard_normal((B, H * W, dim)).astype(np.float32)
    style = rng.standard_normal((B, dim)).astype(np.float32)
    orig = rng.standard_normal((B, H0, W0, 3)).astype(np.float32)
    apply = jax.jit(lambda *a: structural_transformer_apply(*a, (H, W)))
    ref = np.asarray(apply({k: jnp.asarray(v) for k, v in params.items()},
                           jnp.asarray(tokens), jnp.asarray(style),
                           jnp.asarray(orig)))

    block = StructuralTransformerBlock(dim).eval()
    block.load_state_dict(state_dict_from_jax_params(params), strict=True)
    with torch.inference_mode():
        got = block(torch.from_numpy(tokens).reshape(B, H, W, dim),
                    torch.from_numpy(style),
                    torch.from_numpy(orig).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.reshape(B, H * W, dim).numpy(), ref,
                               atol=2e-4, rtol=2e-4)


# ---------------------------------------------------------------------------
# device dispatch
# ---------------------------------------------------------------------------

def _block_weights(rng, C, device="cpu", dtype=torch.float32):
    out = {}
    for n, shape in weight_shapes(C).items():
        a = rng.standard_normal(shape) * (0.1 if len(shape) == 2 else 0.05)
        if n in ("norm1_w", "norm2_w"):
            a = a + 1.0
        out[n] = torch.from_numpy(a.astype(np.float32)).to(device, dtype)
    return out


def _block_inputs(rng, shape, device="cpu", dtype=torch.float32):
    B, C = shape[0], shape[-1]
    t = lambda a, dt=dtype: torch.from_numpy(a.astype(np.float32)).to(device, dt)
    return (t(rng.standard_normal(shape)), t(rng.standard_normal(shape)),
            t(rng.standard_normal((B, C)) * 0.1, torch.float32),
            t(rng.standard_normal((B, C)) * 0.1, torch.float32))


def test_cpu_tensors_take_the_plain_path(rng):
    """A CPU tensor runs the plain version and launches nothing."""
    reset_launch_counts()
    args = _torch_attn_args(_attn_args(rng, (1, 8, 8, 32)))
    torch.testing.assert_close(window_channel_attention(*args),
                               window_channel_attention_plain(*args),
                               atol=0, rtol=0)
    inputs = _block_inputs(rng, (1, 8, 16, 64))
    weights = _block_weights(rng, 64)
    torch.testing.assert_close(fused_structural_block(*inputs, **weights),
                               structural_block_plain(*inputs, **weights),
                               atol=0, rtol=0)
    assert window_channel_attention.launches == 0
    assert fused_structural_block.launches == 0


# ---------------------------------------------------------------------------
# kernel vs plain on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest tests/ -m gpu` "
                    "on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# bf16: both sides compute in fp32 from the same bf16 inputs and round once,
# so they may differ by one bf16 rounding of the output (2^-7 relative) plus
# fp32 summation order.
BF16_TOL = dict(atol=3e-2, rtol=2 ** -7)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 16, 16), (1, 16, 32, 32),
                                   (3, 8, 12, 64)])
def test_window_attention_kernel_matches_plain(rng, cuda, shape, dtype):
    args = _torch_attn_args(_attn_args(rng, shape), cuda, dtype)
    n0 = window_channel_attention.launches
    got = window_channel_attention(*args)
    torch.cuda.synchronize()
    assert window_channel_attention.launches == n0 + 1
    ref = window_channel_attention_plain(*args)
    assert torch.isfinite(got).all()
    tol = dict(atol=1e-4, rtol=0) if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), ref.float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (2, 12, 20, 64),
                                   (1, 5, 3, 64)])
def test_block_kernel_matches_plain(rng, cuda, shape, dtype):
    inputs = _block_inputs(rng, shape, cuda, dtype)
    weights = _block_weights(rng, shape[-1], cuda, dtype)
    n0 = fused_structural_block.launches
    got = fused_structural_block(*inputs, **weights)
    torch.cuda.synchronize()
    assert fused_structural_block.launches == n0 + 1
    ref = structural_block_plain(*inputs, **weights)
    tol = dict(atol=2e-4, rtol=2e-4) if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), ref.float(), **tol)


@pytest.mark.gpu
def test_kernel_wrappers_raise_on_what_they_do_not_take(rng, cuda):
    args = _torch_attn_args(_attn_args(rng, (1, 8, 8, 264)), cuda)
    with pytest.raises(ValueError, match="built for C"):
        window_channel_attention(*args)
    x, wq, bq, wp, bp = _torch_attn_args(_attn_args(rng, (1, 8, 8, 16)), cuda)
    with pytest.raises(TypeError, match="expected torch.float32"):
        window_channel_attention(x, wq.double(), bq, wp, bp)
    with pytest.raises(ValueError, match="contiguous"):
        window_channel_attention(x.transpose(1, 2), wq, bq, wp, bp)
