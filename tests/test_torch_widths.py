"""The serving kernels at the c8 and c32 generators' widths: on the CPU
against the JAX package, and kernel vs plain on the card.

The c16 generator's widths (LocalAttention at C = 16, 32, 64; a 64-wide
block of 2 heads) are held in ``test_torch_kernels.py``,
``test_torch_serving_kernels.py`` and ``test_torch_packed*.py``. Here the
widths the c8 and c32 generators add: LocalAttention at C = 8 (c8's up2)
and C = 128 (c32's down2), the block at dim 32 with 1 head and at dim 128
with 4 heads. On the CPU each wrapper runs its plain version, held against
the JAX math and against the Pallas kernel JAX dispatches at that width
(interpret mode); the whole c8 and c32 generators, NHWC and packed, from
JAX params and from a ``.pth``, against the JAX forward with its fast
(Pallas) path in interpret mode; the launch layouts mirrored in Python;
the bf16 rounding emulation on ``chip_smoke.py``'s stress inputs; the
width checks where a model is loaded or built; the refused pooled resume.
Tests marked ``gpu`` hold the kernels against the plain versions at these
widths; they skip without a CUDA device.

Tolerances are those of the c16 cases: the plain attention 1e-5 against
the JAX math and the NHWC Pallas kernels, 2e-5 on packed rows
(``test_torch_packed*.py``); the block 2e-4 absolute and relative; the
generator 5e-4 absolute (``test_torch_models.py``).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import chip_smoke as smoke
from devtools import serving_kernel_rounding as rounding
from multi_style_transfer_gan_tpu.models.enhanced_generator import (
    _attention_math, enhanced_generator_apply, enhanced_generator_init,
)
from multi_style_transfer_gan_tpu.models.packed_generator import (
    _attention as jax_packed_attention,
    pack_enhanced_generator_params as jax_pack_params,
    packed_enhanced_generator_apply as jax_packed_apply,
)
from multi_style_transfer_gan_tpu.models.structural_transformer import (
    structural_transformer_apply, structural_transformer_init,
)
from multi_style_transfer_gan_tpu.ops.packed import space_to_depth
from multi_style_transfer_gan_tpu_torch.models import (
    EnhancedGenerator, PackedEnhancedGenerator, StructuralTransformerBlock,
)
from multi_style_transfer_gan_tpu_torch.ops import kernels as K
from multi_style_transfer_gan_tpu_torch.ops.kernels.fused_transformer import (
    block_launch_shape, weight_shapes,
)
from multi_style_transfer_gan_tpu_torch.ops.kernels.window_attention import (
    attention_launch_shape,
)
from multi_style_transfer_gan_tpu_torch.pipelines import load_generator
from multi_style_transfer_gan_tpu_torch.pipelines.model_loader import (
    SERVED_CHANNELS, check_serving_width,
)
from multi_style_transfer_gan_tpu_torch.train import (
    check_kernel_width, cyclegan_init_state, pool_init, restore_train_state,
    save_train_state,
)
from multi_style_transfer_gan_tpu_torch.weights import (
    state_dict_from_jax_params,
)

WIDTH_CHANNELS = smoke.WIDTH_CHANNELS          # (8, 32)
ATTENTION_ATOL, PACKED_ATOL = 1e-5, 2e-5
BLOCK_TOL = dict(atol=2e-4, rtol=2e-4)
GENERATOR_ATOL = 5e-4
SMEM_LIMIT = 227 * 1024


def _t(a):
    return torch.from_numpy(np.array(a))


def _attn_case(rng, shape):
    """NHWC x with one all-zero window, and (out, in) weights."""
    C = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    x[0, :4, :4] = 0.0
    return (x, (rng.standard_normal((3 * C, C)) * 0.1).astype(np.float32),
            rng.standard_normal(3 * C).astype(np.float32),
            (rng.standard_normal((C, C)) * 0.1).astype(np.float32),
            rng.standard_normal(C).astype(np.float32))


def _hwio(wq, bq, wp, bp):
    """The JAX layout of the same weights: 1x1 HWIO kernels."""
    return (jnp.asarray(wq.T[None, None]), jnp.asarray(bq),
            jnp.asarray(wp.T[None, None]), jnp.asarray(bp))


def _interpret_all(mp):
    """Every pallas_call of the attention and block modules in interpret
    mode, patched on ``mp`` (a pytest MonkeyPatch)."""
    import multi_style_transfer_gan_tpu.ops.pallas.fused_transformer as ft
    import multi_style_transfer_gan_tpu.ops.pallas.packed_attention as pa
    import multi_style_transfer_gan_tpu.ops.pallas.window_attention as wa
    import multi_style_transfer_gan_tpu.ops.pallas.window_attention_grouped \
        as wag
    import multi_style_transfer_gan_tpu.ops.pallas.window_attention_v3 as wa3
    import multi_style_transfer_gan_tpu.ops.pallas.window_relayout as wr

    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    for mod in (ft, pa, wa, wag, wa3, wr):
        mp.setattr(mod.pl, "pallas_call", interp)


@pytest.fixture
def interpret_pallas(monkeypatch):
    _interpret_all(monkeypatch)


# ---------------------------------------------------------------------------
# channel attention at C = 8 and 128 (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C", [8, 128])
def test_attention_plain_matches_jax_math(rng, C):
    args = _attn_case(rng, (2, 8, 12, C))
    ref = np.asarray(_attention_math(jnp.asarray(args[0]), *_hwio(*args[1:]),
                                     window_size=4, eps=1e-12))
    got = K.window_channel_attention(*map(_t, args)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=ATTENTION_ATOL, rtol=0)


@pytest.mark.parametrize("impl,shape", [
    ("grouped", (1, 16, 16, 8)),     # JAX's first choice at C = 8
    ("v3", (1, 8, 8, 8)),            # its second
    ("v1", (1, 8, 8, 128)),          # the only Pallas kernel at C = 128
])
def test_attention_plain_matches_the_dispatched_pallas_kernel(
        rng, interpret_pallas, impl, shape):
    from multi_style_transfer_gan_tpu.ops.pallas.attention_dispatch import (
        valid_impls,
    )
    from multi_style_transfer_gan_tpu.ops.pallas.window_attention import (
        fused_window_channel_attention,
    )
    from multi_style_transfer_gan_tpu.ops.pallas.window_attention_grouped \
        import grouped_window_channel_attention
    from multi_style_transfer_gan_tpu.ops.pallas.window_attention_v3 import (
        window_attention_v3,
    )

    assert impl in valid_impls(*shape, 4)
    fn = {"v1": fused_window_channel_attention,
          "grouped": grouped_window_channel_attention,
          "v3": window_attention_v3}[impl]
    args = _attn_case(rng, shape)
    ref = np.asarray(fn(jnp.asarray(args[0]), *_hwio(*args[1:]),
                        window_size=4, eps=1e-12))
    got = K.window_channel_attention(*map(_t, args)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATTENTION_ATOL, rtol=0)


@pytest.mark.parametrize("C", [8, 128])
def test_packed_attention_plain_matches_jax_packed_dispatch(
        rng, interpret_pallas, C):
    """The packed engine's attention as JAX dispatches it
    (``models/packed_generator.py::_attention``, fast): the packed v3 kernel
    at C = 8, the d2s -> v1 -> s2d hop at C = 128."""
    x, wq, bq, wp, bp = _attn_case(rng, (2, 16, 16, C))
    xp = np.asarray(space_to_depth(jnp.asarray(x), 4))
    p = dict(zip(("a.qkv.weight", "a.qkv.bias", "a.proj.weight",
                  "a.proj.bias"), _hwio(wq, bq, wp, bp)))
    ref = np.asarray(jax_packed_attention(p, jnp.asarray(xp), "a.", fast=True))
    got = K.packed_window_channel_attention(*map(_t, (xp, wq, bq, wp, bp)))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref, atol=PACKED_ATOL, rtol=0)
    # the same op as the NHWC attention, one relayout away
    nhwc = K.window_channel_attention(*map(_t, (x, wq, bq, wp, bp)))
    torch.testing.assert_close(got, K.space_to_depth_plain(nhwc, 4),
                               atol=PACKED_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the block at dim 32 / 1 head and 128 / 4 heads (CPU)
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


def _body_args(rng, B, H, W, dim):
    """Tokens, struct, gamma, beta and the weights by keyword, numpy."""
    x = rng.standard_normal((B, H, W, dim)).astype(np.float32)
    st = rng.standard_normal((B, H, W, dim)).astype(np.float32)
    gamma = (rng.standard_normal((B, dim)) * 0.1).astype(np.float32)
    beta = (rng.standard_normal((B, dim)) * 0.1).astype(np.float32)
    w = {n: (rng.standard_normal(s) * (0.1 if len(s) == 2 else 0.05)
             + (1.0 if n in ("norm1_w", "norm2_w") else 0.0)).astype(np.float32)
         for n, s in weight_shapes(dim).items()}
    return (x, st, gamma, beta), w


@pytest.mark.parametrize("dim", [32, 128])
def test_block_plain_matches_the_pallas_block(rng, interpret_pallas, dim):
    """The kernels' plain block body == JAX's fused Pallas block (interpret
    mode) on an 8 x 8 grid, at default_num_heads(dim) = dim / 32 heads."""
    from multi_style_transfer_gan_tpu.ops.pallas.fused_transformer import (
        fused_structural_block,
    )

    args, w = _body_args(rng, 2, 8, 8, dim)
    ref = np.asarray(fused_structural_block(
        *map(jnp.asarray, args), **{n: jnp.asarray(a) for n, a in w.items()}))
    got = K.fused_structural_block(*map(_t, args),
                                   **{n: _t(a) for n, a in w.items()})
    np.testing.assert_allclose(got.numpy(), ref, **BLOCK_TOL)


@pytest.mark.parametrize("hw", [(8, 8), (12, 20)])
@pytest.mark.parametrize("dim", [32, 128])
def test_structural_block_matches_jax_fast_path(rng, interpret_pallas, dim,
                                                hw):
    """The block module (struct embed, FiLM, body) == the JAX block on its
    fast path: the fused Pallas block (interpret mode) on the 8 x 8 grid,
    the zero-pad-and-mask XLA body on the ragged 12 x 20 one, as JAX runs
    them."""
    H, W = hw
    B = 2
    params = _block_params(rng, dim)
    tokens = rng.standard_normal((B, H * W, dim)).astype(np.float32)
    style = rng.standard_normal((B, dim)).astype(np.float32)
    orig = rng.standard_normal((B, 4 * H, 4 * W, 3)).astype(np.float32)
    apply = jax.jit(lambda *a: structural_transformer_apply(*a, (H, W),
                                                            fast=True))
    ref = np.asarray(apply({k: jnp.asarray(v) for k, v in params.items()},
                           jnp.asarray(tokens), jnp.asarray(style),
                           jnp.asarray(orig)))
    block = StructuralTransformerBlock(dim).eval()
    block.load_state_dict(state_dict_from_jax_params(params), strict=True)
    with torch.inference_mode():
        got = block(_t(tokens).reshape(B, H, W, dim), _t(style),
                    _t(orig).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.reshape(B, H * W, dim).numpy(), ref,
                               **BLOCK_TOL)


# ---------------------------------------------------------------------------
# the whole c8 and c32 generators, both engines (CPU)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def generators():
    """{channels: (JAX params at enhanced_generator_init's law, x, the JAX
    NHWC forward, the JAX packed forward)}, both forwards on the fast
    (Pallas) path in interpret mode, batch 2 at 64^2."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _interpret_all(mp)
        for c in WIDTH_CHANNELS:
            params = jax.jit(functools.partial(
                enhanced_generator_init, channels=c,
                num_transformer_blocks=1))(jax.random.PRNGKey(c))
            x = np.tanh(np.random.default_rng(c).standard_normal(
                (2, 64, 64, 3))).astype(np.float32)
            nhwc = jax.jit(functools.partial(enhanced_generator_apply,
                                             fast_attention=True))(
                params, jnp.asarray(x))
            packed = jax.jit(functools.partial(jax_packed_apply,
                                               fast_attention=True))(
                jax_pack_params(params), jnp.asarray(x))
            out[c] = (params, x, np.asarray(nhwc), np.asarray(packed))
    return out


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("source", ["jax params", ".pth"])
@pytest.mark.parametrize("channels", WIDTH_CHANNELS)
def test_generator_matches_jax_on_both_engines(generators, tmp_path,
                                               channels, source):
    params, x, ref_nhwc, ref_packed = generators[channels]
    sd = state_dict_from_jax_params(params)
    if source == ".pth":
        path = tmp_path / f"enhanced_c{channels}.pth"
        torch.save({"G_AB_state_dict": sd}, path)
        model = load_generator(path, device="cpu")
        assert (model.kind, model.channels) == ("enhanced", channels)
        module = model.module
        with torch.inference_mode():
            nhwc = model.apply(_t(x)).numpy()
    else:
        module = EnhancedGenerator(channels, 1).eval()
        module.load_state_dict(sd, strict=True)
        module = module.to(memory_format=torch.channels_last)
        with torch.inference_mode():
            nhwc = _nhwc(module(_t(x).permute(0, 3, 1, 2)))
    K.reset_launch_counts()
    with torch.inference_mode():
        packed = _nhwc(PackedEnhancedGenerator(module).eval()(
            _t(x).permute(0, 3, 1, 2)))
    assert all(k.launches == 0 for k in K.KERNELS)   # the CPU: plain versions
    assert np.isfinite(nhwc).all() and nhwc.shape == x.shape
    np.testing.assert_allclose(nhwc, ref_nhwc, atol=GENERATOR_ATOL, rtol=0)
    np.testing.assert_allclose(packed, ref_packed, atol=GENERATOR_ATOL, rtol=0)


def test_c32_checkpoint_through_direct_transform_and_the_server(
        generators, tmp_path):
    """A c32 ``.pth`` through the single-image pipeline (against the JAX
    package's ``transform_image`` on the same file, the direct-transform
    tolerance of ``test_torch_plain.py``) and one request to the server."""
    import io

    from PIL import Image

    from multi_style_transfer_gan_tpu.data.synthetic import render_photo
    from multi_style_transfer_gan_tpu.pipelines import direct as jdirect
    from multi_style_transfer_gan_tpu.pipelines.model_loader import (
        load_generator as jax_load_generator,
    )
    from multi_style_transfer_gan_tpu_torch.pipelines import direct
    from multi_style_transfer_gan_tpu_torch.serving import (
        StyleTransferService,
    )

    path = tmp_path / "enhanced_c32.pth"
    torch.save({"G_BA_state_dict": state_dict_from_jax_params(
        generators[32][0])}, path)
    photo = tmp_path / "photo.png"
    Image.fromarray(render_photo(900311, size=96)[:72, :96]).save(photo)
    model = load_generator(path, device="cpu")
    ref = np.asarray(jdirect.transform_image(jax_load_generator(str(path)),
                                             str(photo), size=64))
    got = direct.transform_image(model, str(photo), size=64)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    service = StyleTransferService(model, canvas=64, max_batch=2,
                                   max_wait_ms=1.0, device="cpu")
    try:
        out = service.stylize_bytes(photo.read_bytes())
    finally:
        service.close()
    assert Image.open(io.BytesIO(out)).size == (96, 72)


# ---------------------------------------------------------------------------
# launch layouts and the rounding emulation (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,bf16,units,smem", [
    (8, True, 256, 36608),      # padded to 16 channels: C = 16's layout
    (128, True, 683, 219648),   # 3 warps a block, one window each
    (8, False, 256, 21440),     # fp32: tiles of 8 windows
    (128, False, 2048, 101056),  # fp32: one window a tile, weights in L2
])
def test_attention_launch_shape_at_the_new_widths(C, bf16, units, smem):
    assert attention_launch_shape(2048, C, bf16) == (units, smem)
    assert smem <= SMEM_LIMIT


@pytest.mark.parametrize("shape,units,smem", [
    ((8, 64, 64, 32), 256, 82048),     # two windows a block, all resident
    ((2, 12, 20, 32), 6, 82048),
    ((8, 64, 64, 128), 512, 199680),   # one window a block, fc1/fc2 streamed
    ((2, 12, 20, 128), 12, 199680),
])
def test_block_launch_shape_at_the_new_widths(shape, units, smem):
    assert block_launch_shape(*shape) == (units, smem)
    assert smem <= SMEM_LIMIT


WIDTH_ATTENTION_SHAPES = ((8, 256, 256, 8), (8, 128, 128, 64),
                          (8, 64, 64, 128))
WIDTH_BLOCK_SHAPES = ((8, 64, 64, 32), (2, 12, 20, 32), (8, 64, 64, 128),
                      (2, 12, 20, 128))


@functools.lru_cache(maxsize=None)
def _attention_ratios():
    torch.set_num_threads(2)
    return rounding.attention_ratios(list(WIDTH_ATTENTION_SHAPES))


@functools.lru_cache(maxsize=None)
def _block_ratios():
    torch.set_num_threads(2)
    return rounding.block_ratios(shapes=WIDTH_BLOCK_SHAPES)


@pytest.mark.parametrize("label", ["random", "saturated", "small q, k"])
@pytest.mark.parametrize("shape", WIDTH_ATTENTION_SHAPES)
def test_attention_emulation_holds_the_bf16_bound(shape, label):
    """The attention kernel's rounding plan at c8's up2 (C = 8), c32's
    down1 (C = 64 on 128^2) and down2 (C = 128): inside the bf16 bound on
    every stress input, the saturated one with room to spare, which at
    C >= 64 the pairs of the softmax and the apply's output provide."""
    ratios = _attention_ratios()
    d, ratio = ratios[(shape, label, "kernel")]
    assert np.isfinite(d) and ratio < (0.8 if label == "saturated" else 1.0)
    assert ratios[(shape, "saturated", "all one term")][1] > ratio
    if shape[-1] >= 64:   # the softmax and apply pairs buy margin there
        assert (ratios[(shape, "saturated", "qn, kn pairs only")][1]
                > ratios[(shape, "saturated", "kernel")][1] + 0.1)


@pytest.mark.parametrize("label", ["random", "saturated"])
@pytest.mark.parametrize("shape", WIDTH_BLOCK_SHAPES)
def test_block_emulation_holds_the_bf16_bound(shape, label):
    d, ratio = _block_ratios()[(shape, label, "kernel")]
    assert np.isfinite(d) and ratio < (0.8 if label == "saturated" else 1.0)


def test_block_emulation_at_dim_128_needs_the_wider_pairs():
    """At dim 128 the pairs of the dim-64 kernel (LN1's output for q and k,
    q and k) leave the saturated block outside the bound; the dim-128 plan
    (also LN1's output for v, LN2's output and the GELU output) holds it."""
    ratios = _block_ratios()
    shape = (8, 64, 64, 128)
    assert ratios[(shape, "saturated", "h, q, k pairs only")][1] > 1.0
    assert ratios[(shape, "saturated", "kernel")][1] < 0.8


# ---------------------------------------------------------------------------
# width checks where the model is loaded or built, and the pooled resume
# (CPU; "cuda" as a device name needs no card: the checks come first)
# ---------------------------------------------------------------------------

def test_served_channels_are_those_of_the_built_kernels():
    assert SERVED_CHANNELS == (8, 16, 32)
    for c in SERVED_CHANNELS:
        check_serving_width(c)


@pytest.mark.parametrize("channels", [4, 12, 64])
def test_loader_refuses_widths_not_built_on_the_card(tmp_path, channels):
    path = tmp_path / f"enhanced_c{channels}.pth"
    torch.save({"G_BA_state_dict": EnhancedGenerator(channels, 1)
                .state_dict()}, path)
    with pytest.raises(ValueError, match=r"channels=%d is not served on the "
                                         r"card.*\(8, 16, 32\)" % channels):
        load_generator(path, device="cuda")
    # every width still runs on the CPU, through the plain versions
    model = load_generator(path, device="cpu")
    assert model.apply(torch.zeros(1, 32, 32, 3)).shape == (1, 32, 32, 3)


@pytest.mark.parametrize("channels", [4, 64])
def test_training_checks_read_the_training_kernels(channels):
    """c8, c16 and c32 train on the card, as they serve; a width whose
    LocalAttention or block the training routes do not take (c4, c64) is
    refused, and CycleGAN training says so before it builds anything."""
    for built in (8, 16, 32):
        check_serving_width(built)
        check_kernel_width(built, "CycleGAN training")
    with pytest.raises(ValueError, match="CycleGAN training at channels="
                                         f"{channels} is not served"):
        check_kernel_width(channels, "CycleGAN training")
    with pytest.raises(ValueError, match=r"channels in \(8, 16, 32\)"):
        cyclegan_init_state(0, channels, device="cuda")


def test_cyclegan_init_takes_any_width_on_the_cpu():
    state = cyclegan_init_state(0, 8, device="cpu")
    assert state.G_AB.initial[0].weight.shape[0] == 8


def test_train_cli_refuses_a_width_before_its_first_step(monkeypatch,
                                                         tmp_path):
    from multi_style_transfer_gan_tpu_torch.cli import train as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert cli.DEVICE == "cuda"
    K.reset_launch_counts()
    with pytest.raises(ValueError, match="channels=64 is not served"):
        cli.main(["--data_root", str(tmp_path / "no_data"), "--channels",
                  "64", "--save_dir", str(tmp_path / "models")])
    assert not (tmp_path / "models").exists()
    assert all(k.launches == 0 for k in K.KERNELS)


def test_pooled_resume_without_pools_raises(tmp_path):
    state = cyclegan_init_state(0, 4, device="cpu")
    pools = ((pool_init(2, 32, device="cpu"), pool_init(2, 32, device="cpu")),
             torch.Generator().manual_seed(1))
    save_train_state(state, tmp_path, 3, pools)
    fresh = cyclegan_init_state(1, 4, device="cpu")
    with pytest.raises(ValueError, match=r"checkpoint contains image-pool "
                                         r"state; pass --pool_size <N> to "
                                         r"resume it"):
        restore_train_state(tmp_path, None, fresh)
    # with pools it resumes, and a pool-free checkpoint still resumes bare
    (_, _), step = restore_train_state(tmp_path, None, fresh, (
        (pool_init(2, 32, device="cpu"), pool_init(2, 32, device="cpu")),
        torch.Generator()))
    assert step == 3
    save_train_state(state, tmp_path, 4)
    assert restore_train_state(tmp_path, None, fresh)[1] == 4


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


def _check(got, ref, dtype, fp32_tol):
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=fp32_tol, rtol=0)
    else:
        torch.testing.assert_close(got.float(), ref.float(),
                                   atol=smoke.BF16_ATOL, rtol=smoke.BF16_RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("shape", [(2, 32, 32, 8), (3, 8, 12, 8),
                                   (2, 16, 16, 128), (3, 8, 12, 128)])
def test_attention_kernels_at_the_new_widths(cuda, shape, packed, dtype):
    """NHWC and packed kernels vs plain at C = 8 and 128 on the three
    stress inputs, each with an all-zero window; one launch a call."""
    fn, plain = ((K.packed_window_channel_attention,
                  K.packed_window_channel_attention_plain) if packed else
                 (K.window_channel_attention, K.window_channel_attention_plain))
    for label, x, ws in smoke.attention_stress_inputs(
            np.random.default_rng(3), shape, packed=packed):
        args = [_t(np.asarray(a, np.float32)).to(cuda, dtype)
                for a in [x] + ws]
        n0 = fn.launches
        got = fn(*args)
        torch.cuda.synchronize()
        assert fn.launches == n0 + 1, label
        _check(got, plain(*args), dtype, smoke.FP32_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 16, 32), (2, 12, 20, 32),
                                   (1, 5, 3, 32), (2, 16, 16, 128),
                                   (2, 12, 20, 128), (1, 5, 3, 128)])
def test_block_kernel_at_the_new_widths(cuda, shape, dtype):
    """The block at dim 32 (1 head) and 128 (4 heads) vs plain on the
    stress inputs, ragged grids included."""
    for label, host, weights in smoke.block_stress_inputs(
            np.random.default_rng(4), shape):
        t = lambda a, dt=dtype: _t(np.asarray(a, np.float32)).to(cuda, dt)
        args = (t(host[0]), t(host[1]), t(host[2], torch.float32),
                t(host[3], torch.float32))
        kw = {n: t(a) for n, a in weights.items()}
        n0 = K.fused_structural_block.launches
        got = K.fused_structural_block(*args, **kw)
        torch.cuda.synchronize()
        assert K.fused_structural_block.launches == n0 + 1, label
        _check(got, K.structural_block_plain(*args, **kw), dtype,
               smoke.BLOCK_FP32_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [8, 32, 128])
def test_relayout_kernel_at_the_new_widths(cuda, C, dtype):
    """Row 9 at 16 * 8, 16 * 32 and 16 * 128 lanes: bit-exact both ways."""
    x = _t(np.random.default_rng(6).standard_normal((2, 32, 48, C))
           .astype(np.float32)).to(cuda, dtype)
    n0 = K.window_relayout.launches
    rows = K.window_relayout(x)
    back = K.window_relayout(rows, inverse=True)
    torch.cuda.synchronize()
    assert K.window_relayout.launches == n0 + 2
    assert torch.equal(rows, K.space_to_depth_plain(x, 4))
    assert torch.equal(back, x)


@pytest.mark.gpu
@pytest.mark.parametrize("channels", [4, 64])
def test_loader_refuses_unbuilt_widths_on_the_card(cuda, tmp_path, channels):
    path = tmp_path / f"enhanced_c{channels}.pth"
    torch.save({"G_AB_state_dict": EnhancedGenerator(channels, 1)
                .state_dict()}, path)
    with pytest.raises(ValueError, match="not served on the card"):
        load_generator(path, device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["nhwc", "packed"])
@pytest.mark.parametrize("channels", WIDTH_CHANNELS)
def test_generator_program_on_the_card_matches_cpu(cuda, tmp_path, channels,
                                                   engine):
    """The fp32 uint8 program of a seeded c8 / c32 generator at precision
    'highest' on the card vs the CPU: at most one level on <= 1% of
    values; 4 attention launches and 1 block a forward."""
    from multi_style_transfer_gan_tpu_torch.pipelines import make_batch_fn

    path = tmp_path / f"enhanced_c{channels}.pth"
    smoke.width_checkpoint(path, channels)
    batch = np.stack(smoke.smooth_images(np.random.default_rng(5), 2,
                                         (128, 128)))
    gpu = load_generator(path, precision="highest", device=cuda)
    cpu = load_generator(path, precision="highest", device="cpu")
    K.reset_launch_counts()
    got = make_batch_fn(gpu, "cyclegan", engine=engine, device=cuda)(
        batch).cpu().numpy()
    attention = (K.packed_window_channel_attention if engine == "packed"
                 else K.window_channel_attention)
    assert (attention.launches, K.fused_structural_block.launches) == (4, 1)
    ref = make_batch_fn(cpu, "cyclegan", engine=engine, device="cpu")(
        batch).numpy()
    dmax, share = smoke.u8_diff(got, ref)
    assert dmax <= smoke.U8_MAX_DIFF and share <= smoke.U8_MAX_SHARE
