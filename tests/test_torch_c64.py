"""The c64 EnhancedGenerator (the JAX pretrain CLI's default width): on the
CPU against the JAX package, and kernel vs plain on the card.

A generator of width c runs LocalAttention at 2c, 4c, 2c and c and its
transformer block at dim 4c with ``default_num_heads(4c)`` heads. At c64
that adds to the built widths: the channel attention (row 1, both layouts)
at C = 256, the block (row 4) at dim 256 with 8 heads, the window-MHSA
mid (row 12) at 8 heads, and, under grad, C = 128 and 256 through JAX's
own route (``window_channel_attention_fast_vjp``: the inference kernel
forward, the backward recomputed through the plain version; JAX has no
training kernel above C = 64). Here: each plain version against the JAX
math and the Pallas kernel JAX runs at that width (interpret mode); the
route at C = 256 against ``local_attention_apply(fast=False)`` under
``jax.grad``; the c64 generator forward and one enhanced pretrain step
against JAX; the routing by width under grad; the launch layouts at C =
256 against the shared-memory limit; the bf16 rounding emulation at the
c64 shapes. Tests marked ``gpu`` hold the kernels, the c64 program and a
c64 pretrain step on the card against the CPU; they skip without a CUDA
device.

Tolerances, as for the other widths: the plain attention 1e-5 against the
JAX math and the NHWC Pallas kernel (``test_torch_widths.py``); the block
2e-4 absolute and relative; forwards 1e-5 and gradients 2e-4 against JAX
(``test_torch_train_widths.py``); the generator 5e-4 absolute
(``test_torch_models.py``); the pretrain loss rtol 1e-5
(``test_torch_pretrain.py``).
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
from multi_style_transfer_gan_tpu.data.dataset import (
    random_patch_mask as jax_random_patch_mask,
)
from multi_style_transfer_gan_tpu.models.enhanced_generator import (
    _attention_math, enhanced_generator_apply, local_attention_apply,
)
from multi_style_transfer_gan_tpu.models.structural_transformer import (
    structural_transformer_apply, structural_transformer_init,
)
from multi_style_transfer_gan_tpu.ops.pallas.fused_transformer import (
    fused_structural_block as jax_fused_block,
)
from multi_style_transfer_gan_tpu.ops.pallas.window_attention import (
    fused_window_channel_attention,
)
from multi_style_transfer_gan_tpu.ops.pallas.window_mhsa_train import (
    window_mhsa_train as jax_mhsa_train,
)
from multi_style_transfer_gan_tpu.train import pretrain as jpretrain
from multi_style_transfer_gan_tpu.weights import enhanced_generator_from_sd
import multi_style_transfer_gan_tpu_torch.models.enhanced_generator as eg
import multi_style_transfer_gan_tpu_torch.models.structural_transformer as st
from multi_style_transfer_gan_tpu_torch.models import (
    EnhancedGenerator, LocalAttention, StructuralTransformerBlock,
)
from multi_style_transfer_gan_tpu_torch.ops import kernels as K
from multi_style_transfer_gan_tpu_torch.ops.kernels.fused_transformer import (
    block_launch_shape, weight_shapes,
)
from multi_style_transfer_gan_tpu_torch.ops.kernels.window_attention import (
    attention_launch_shape,
)
from multi_style_transfer_gan_tpu_torch.pipelines import load_generator
from multi_style_transfer_gan_tpu_torch.train import (
    pretrain_init_state, pretrain_train_step,
)
from multi_style_transfer_gan_tpu_torch.weights import (
    state_dict_from_jax_params,
)

C64 = 64
ATTENTION_ATOL = 1e-5
BLOCK_TOL = dict(atol=2e-4, rtol=2e-4)
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-4, rtol=2e-4)
GENERATOR_ATOL = 5e-4
PRETRAIN_RTOL = 1e-5
SMEM_LIMIT = 227 * 1024
WEIGHTS = ("qkv.weight", "qkv.bias", "proj.weight", "proj.bias")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Every pallas_call of the attention and block modules in interpret
    mode."""
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
        monkeypatch.setattr(mod.pl, "pallas_call", interp)


def _attn_case(rng, shape, stress):
    """x and JAX-layout LocalAttention weights (1x1 HWIO kernels). Every
    case has an all-zero window under zero q and k biases (q = k = 0 there);
    "saturated" scales the last batch entry by 8 (as the C = 128 cases of
    ``test_torch_train_widths.py``); "flat" makes batch entry 0 constant
    inside every window but the zero one and scales it by 8 (q and k sit on
    the same few channels at every position: the Gram's 16 terms add up
    coherently); "small" scales the window below the zero one by 1e-3
    (|q|, |k| ~ 1e-3)."""
    C = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w = {"qkv.weight": rng.standard_normal((1, 1, C, 3 * C)) * 0.1,
         "qkv.bias": rng.standard_normal(3 * C),
         "proj.weight": rng.standard_normal((1, 1, C, C)) * 0.1,
         "proj.bias": rng.standard_normal(C)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    w["qkv.bias"][:2 * C] = 0.0
    if stress == "saturated":
        x[-1] *= 8.0
    elif stress == "flat":
        B, H, W, _ = shape
        t = x.reshape(B, H // 4, 4, W // 4, 4, C)
        t[0] = t[0, :, :1, :, :1] * 8.0
        x = t.reshape(shape)
    elif stress == "small":
        x[0, 4:8, :4] *= 1e-3
    x[0, :4, :4] = 0.0
    return x, w


def _torch_weights(w):
    """The same weights in the PyTorch (out, in) layout."""
    return [_t(w["qkv.weight"][0, 0].T), _t(w["qkv.bias"]),
            _t(w["proj.weight"][0, 0].T), _t(w["proj.bias"])]


# ---------------------------------------------------------------------------
# row 1 at C = 256 (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stress", ["zero-window", "flat", "small"])
def test_attention_plain_at_c256_matches_jax(rng, interpret_pallas, stress):
    """The plain attention at C = 256 == _attention_math and == JAX's v1
    Pallas kernel (interpret mode), an all-zero window giving 0 there and
    finite values everywhere."""
    x, w = _attn_case(rng, (1, 8, 8, 256), stress)
    jw = [jnp.asarray(w[k]) for k in WEIGHTS]
    got = K.window_channel_attention(_t(x), *_torch_weights(w)).numpy()
    assert np.isfinite(got).all()
    for fn in (lambda *a: _attention_math(*a, window_size=4, eps=1e-12),
               lambda *a: fused_window_channel_attention(*a, window_size=4,
                                                         eps=1e-12)):
        ref = np.asarray(fn(jnp.asarray(x), *jw))
        np.testing.assert_allclose(got, ref, atol=ATTENTION_ATOL, rtol=0)
    # the zero window: q = k = 0 -> a uniform softmax over v = bias
    np.testing.assert_allclose(got[0, 0, 0], got[0, 3, 3], atol=1e-6)


def test_packed_attention_plain_at_c256_is_the_nhwc_op(rng):
    x, w = _attn_case(rng, (2, 8, 12, 256), "zero-window")
    ws = _torch_weights(w)
    nhwc = K.window_channel_attention(_t(x), *ws)
    packed = K.packed_window_channel_attention(
        K.space_to_depth_plain(_t(x), 4), *ws)
    torch.testing.assert_close(packed, K.space_to_depth_plain(nhwc, 4),
                               atol=ATTENTION_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# row 4 at dim 256 / 8 heads (CPU)
# ---------------------------------------------------------------------------

def _body_args(rng, B, H, W, dim):
    """Tokens, struct, gamma, beta and the weights by keyword, numpy."""
    x = rng.standard_normal((B, H, W, dim)).astype(np.float32)
    struct = rng.standard_normal((B, H, W, dim)).astype(np.float32)
    gamma = (rng.standard_normal((B, dim)) * 0.1).astype(np.float32)
    beta = (rng.standard_normal((B, dim)) * 0.1).astype(np.float32)
    w = {n: (rng.standard_normal(s) * (0.1 if len(s) == 2 else 0.05)
             + (1.0 if n in ("norm1_w", "norm2_w") else 0.0)).astype(np.float32)
         for n, s in weight_shapes(dim).items()}
    return (x, struct, gamma, beta), w


def test_block_plain_at_dim256_matches_the_pallas_block(rng,
                                                        interpret_pallas):
    """The plain block body at dim 256 == JAX's fused Pallas block
    (interpret mode, default_num_heads(256) = 8 heads) on an 8 x 8 grid."""
    args, w = _body_args(rng, 2, 8, 8, 256)
    ref = np.asarray(jax_fused_block(
        *map(jnp.asarray, args), **{n: jnp.asarray(a) for n, a in w.items()}))
    got = K.fused_structural_block(*map(_t, args),
                                   **{n: _t(a) for n, a in w.items()})
    np.testing.assert_allclose(got.numpy(), ref, **BLOCK_TOL)


@pytest.mark.parametrize("hw", [(8, 8), (12, 20)])
def test_structural_block_at_dim256_matches_jax_fast_path(rng,
                                                          interpret_pallas,
                                                          hw):
    """The block module at dim 256 == the JAX block on its fast path: the
    fused Pallas block on the 8 x 8 grid, the zero-pad-and-mask body on the
    ragged 12 x 20 one."""
    H, W = hw
    B, dim = 2, 256
    params = {k: np.asarray(v) for k, v in structural_transformer_init(
        jax.random.PRNGKey(3), dim).items()}
    for k in ("style_mod.weight", "style_mod.bias", "norm1.weight",
              "norm1.bias", "norm2.weight", "norm2.bias"):
        params[k] = (params[k] + rng.standard_normal(params[k].shape)
                     * 0.1).astype(np.float32)
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
# row 12 at 8 heads, and C = 256 under grad (CPU)
# ---------------------------------------------------------------------------

def test_window_mhsa_train_at_8_heads_matches_jax(rng):
    qkv = rng.standard_normal((2, 8, 16, 768)).astype(np.float32)
    ref = jax_mhsa_train(jnp.asarray(qkv), 8, 8, True)
    ref_g = jax.grad(lambda t: jnp.sum(jax_mhsa_train(t, 8, 8, True) ** 2))(
        jnp.asarray(qkv))
    t = torch.from_numpy(qkv).requires_grad_(True)
    out = K.window_mhsa_train(t, 8)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               **FWD_TOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref_g), **GRAD_TOL)


@pytest.mark.parametrize("stress", ["zero-window", "saturated", "small"])
def test_fast_vjp_at_c256_matches_jax_attention_math(rng, stress):
    """window_channel_attention_fast_vjp at C = 256 on the CPU ==
    local_attention_apply(fast=False) under jax.grad: the forward and the
    five gradients of sum(y^2), every one finite."""
    x, w = _attn_case(rng, (1, 8, 8, 256), stress)
    params = {f"a.{k}": jnp.asarray(v) for k, v in w.items()}

    def fn(x_, *ws):
        return local_attention_apply(dict(zip(params, ws)), x_, prefix="a.",
                                     fast=False)

    jargs = (jnp.asarray(x), *(jnp.asarray(w[k]) for k in WEIGHTS))
    ref = np.asarray(fn(*jargs))
    ref_grads = jax.grad(lambda *a: jnp.sum(fn(*a) ** 2),
                         argnums=tuple(range(5)))(*jargs)
    ref_grads = [np.asarray(g)[0, 0] if i in (1, 3) else np.asarray(g)
                 for i, g in enumerate(ref_grads)]
    args = [_t(x).requires_grad_(True)] + [
        t.requires_grad_(True) for t in _torch_weights(w)]
    y = K.window_channel_attention_fast_vjp(*args)
    grads = torch.autograd.grad((y ** 2).sum(), args)
    ours = [grads[0].numpy(), grads[1].T.numpy(), grads[2].numpy(),
            grads[3].T.numpy(), grads[4].numpy()]
    np.testing.assert_allclose(y.detach().numpy(), ref, **FWD_TOL)
    for got, want in zip(ours, ref_grads):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **GRAD_TOL)


# ---------------------------------------------------------------------------
# the c64 generator against JAX (CPU)
# ---------------------------------------------------------------------------

def test_c64_generator_matches_jax_fast_path(interpret_pallas, tmp_path):
    """A seeded c64 EnhancedGenerator through a ``.pth`` and
    ``load_generator`` on the CPU == ``enhanced_generator_apply`` on its
    fast path (Pallas in interpret mode) at 32^2, batch 2, NHWC engine."""
    module = EnhancedGenerator(C64, 1, generator=torch.Generator()
                               .manual_seed(64))
    path = tmp_path / "enhanced_c64.pth"
    torch.save({"G_AB_state_dict": module.state_dict()}, path)
    model = load_generator(str(path), device="cpu")
    assert (model.kind, model.channels) == ("enhanced", C64)
    sd = {k: v.detach().numpy().copy()
          for k, v in module.state_dict().items()}
    params = {k: jnp.asarray(v) for k, v in
              enhanced_generator_from_sd(sd).items()}
    x = np.tanh(np.random.default_rng(64).standard_normal(
        (2, 32, 32, 3))).astype(np.float32)
    ref = np.asarray(jax.jit(functools.partial(
        enhanced_generator_apply, fast_attention=True))(params,
                                                        jnp.asarray(x)))
    with torch.inference_mode():
        got = model.apply(_t(x)).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=GENERATOR_ATOL, rtol=0)


def test_enhanced_pretrain_step_at_c64_matches_jax(rng):
    """One enhanced pretrain step at c64 (the pretrain CLI's default
    width), 32^2, batch 2, from the same init and a fresh Adam, the port
    on JAX's mask: the loss at rtol 1e-5."""
    port = pretrain_init_state(3, C64, model="enhanced", num_epochs=2,
                               steps_per_epoch=1, device="cpu")
    sd = {k: v.detach().numpy().copy()
          for k, v in port.model.state_dict().items()}
    params = {k: jnp.asarray(v) for k, v in
              enhanced_generator_from_sd(sd).items()}
    tx = jpretrain.make_pretrain_optimizer(2, 1)
    jstate = jpretrain.PretrainState(params, tx.init(params),
                                     jnp.zeros((), jnp.int32))
    key = jax.random.PRNGKey(5)
    x = np.tanh(rng.standard_normal((2, 32, 32, 3))).astype(np.float32)
    mask = np.array(jax_random_patch_mask(key, 2, 32, width=32))
    # wait for JAX before the port's step updates the tensors it was
    # built from
    _, jloss = jax.block_until_ready(jax.jit(
        lambda s, x_, k: jpretrain.pretrain_train_step(s, tx, x_, k))(
        jstate, jnp.asarray(x), key))
    _, ploss = pretrain_train_step(port, torch.from_numpy(x),
                                   torch.from_numpy(mask))
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=PRETRAIN_RTOL)


# ---------------------------------------------------------------------------
# routing under grad (no card: the meta device stands in)
# ---------------------------------------------------------------------------

class _Spy:
    """Stands in for a wrapper on tensors off the CPU (the meta device):
    records its calls and returns a tensor of the right shape."""

    def __init__(self, shape_of):
        self.args, self.shape_of = [], shape_of

    def __call__(self, *args, **kw):
        self.args.append(args)
        x = args[0]
        return torch.zeros(self.shape_of(args), device=x.device,
                           dtype=x.dtype, requires_grad=True)


@pytest.fixture
def spies(monkeypatch):
    out = {"train": _Spy(lambda a: a[0].shape[:3] + (a[0].shape[3] // 3,)),
           "fast_vjp": _Spy(lambda a: a[0].shape),
           "mhsa": _Spy(lambda a: a[0].shape[:3] + (a[0].shape[3] // 3,))}
    monkeypatch.setattr(eg, "window_channel_attention_train", out["train"])
    monkeypatch.setattr(eg, "window_channel_attention_fast_vjp",
                        out["fast_vjp"])
    monkeypatch.setattr(st, "window_mhsa_train", out["mhsa"])
    return out


@pytest.mark.parametrize("C,route", [(256, "fast_vjp"), (128, "fast_vjp"),
                                     (64, "train")])
def test_c64_attention_widths_route_under_grad(spies, C, route):
    """Under grad off the CPU, the c64 generator's LocalAttention widths
    take their routes: C = 256 (down2) and 128 (down1, up1) the fast-VJP
    Function, C = 64 (up2) row 11's mid."""
    m = LocalAttention(C).to("meta")
    x = torch.zeros(1, C, 8, 8, device="meta", requires_grad=True)
    assert m(x).shape == x.shape
    assert len(spies[route].args) == 1
    assert sum(len(s.args) for s in spies.values()) == 1


def test_c64_block_routes_to_the_mhsa_mid_with_8_heads(spies):
    block = StructuralTransformerBlock(256).to("meta")
    tokens = torch.zeros(1, 8, 8, 256, device="meta", requires_grad=True)
    block(tokens, torch.zeros(1, 256, device="meta"),
          torch.zeros(1, 3, 32, 32, device="meta"))
    (qkv, heads), = spies["mhsa"].args
    assert heads == 8 and qkv.shape[-1] == 768


def test_c64_generator_forward_routes_every_call_under_grad(spies):
    """A whole c64 generator forward with grad off the CPU: 3 LocalAttention
    calls on the route (C = 128, 256, 128), 1 on row 11 (C = 64), 1 block
    on row 12 with 8 heads, which are the launch counts a pretrain step
    asserts on the card (``chip_smoke.WIDTH_PRETRAIN_LAUNCHES_PER_STEP[C64]``)."""
    g = EnhancedGenerator(C64, 1).to("meta")
    g(torch.zeros(1, 3, 32, 32, device="meta", requires_grad=True))
    assert [a[0].shape[-1] for a in spies["fast_vjp"].args] == [128, 256, 128]
    assert [a[0].shape[-1] for a in spies["train"].args] == [3 * 64]
    assert [a[1] for a in spies["mhsa"].args] == [8]
    want = smoke.WIDTH_PRETRAIN_LAUNCHES_PER_STEP[C64]
    assert want["window_channel_attention"] == len(spies["fast_vjp"].args)
    assert want["window_attention_mid_fwd"] == len(spies["train"].args)
    assert want["window_mhsa_fwd"] == len(spies["mhsa"].args)


# ---------------------------------------------------------------------------
# launch layouts and the rounding emulation (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,bf16,units,smem", [
    (256, True, 1024, 205824),   # two windows a block, weights in 64-row tiles
    (256, False, 2048, 135616),  # fp32: one window a tile, Gram 64 rows at a time
])
def test_attention_launch_shape_at_c256(C, bf16, units, smem):
    assert attention_launch_shape(2048, C, bf16) == (units, smem)
    assert smem <= SMEM_LIMIT


@pytest.mark.parametrize("shape,units", [((8, 64, 64, 256), 512),
                                         ((2, 12, 20, 256), 12)])
def test_block_launch_shape_at_dim256(shape, units):
    """One window a block; every weight through two 64-row tiles."""
    assert block_launch_shape(*shape) == (units, 208896)
    assert 208896 <= SMEM_LIMIT


C64_ATTENTION_SHAPES = ((8, 64, 64, 256), (8, 128, 128, 128))
C64_BLOCK_SHAPES = ((8, 64, 64, 256), (2, 12, 20, 256))


@functools.lru_cache(maxsize=None)
def _attention_ratios():
    torch.set_num_threads(2)
    return {**rounding.attention_ratios([C64_ATTENTION_SHAPES[0]], plans=(
        "kernel", "wide, S and out one term")),
            **rounding.attention_ratios([C64_ATTENTION_SHAPES[1]],
                                        plans=("kernel",))}


@functools.lru_cache(maxsize=None)
def _block_ratios():
    torch.set_num_threads(2)
    return rounding.block_ratios(shapes=C64_BLOCK_SHAPES,
                                 plans=("kernel", "dim-128 pairs"))


@pytest.mark.parametrize("label", ["random", "saturated", "small q, k"])
@pytest.mark.parametrize("shape", C64_ATTENTION_SHAPES)
def test_attention_emulation_at_c64_holds_the_bf16_bound(shape, label):
    """The attention kernel's rounding plan at c64's down2 (C = 256 on
    64^2: every operand a pair, the exponentials at the fixed shift 16) and
    down1 / up1 (C = 128 on 128^2) inside the bf16 bound on every stress
    input; at C = 256 the saturated window needs S and out as pairs."""
    ratios = _attention_ratios()
    d, ratio = ratios[(shape, label, "kernel")]
    assert np.isfinite(d) and ratio < (0.8 if label == "saturated" else 1.0)
    if shape[-1] == 256 and label == "saturated":
        assert ratios[(shape, label, "wide, S and out one term")][1] > 1.0


@pytest.mark.parametrize("label", ["random", "saturated"])
@pytest.mark.parametrize("shape", C64_BLOCK_SHAPES)
def test_block_emulation_at_dim256_holds_the_bf16_bound(shape, label):
    """The dim-256 plan (every operand a pair) inside the bf16 bound, where
    the dim-128 plan misses it on the random input of the 64^2 grid. On the
    saturated input the largest |d| is one ulp of the output rounding at
    |y| ~ 16 (0.81 of the bound)."""
    ratios = _block_ratios()
    d, ratio = ratios[(shape, label, "kernel")]
    assert np.isfinite(d) and ratio < 0.85
    if shape == C64_BLOCK_SHAPES[0] and label == "random":
        assert ratios[(shape, label, "dim-128 pairs")][1] > 1.0


def test_mhsa_emulation_at_8_heads_holds_the_bf16_bound():
    """Row 12's rounding plan (the exponentials and ds as pairs) at the c64
    block's 8 heads, (8, 64, 64, 768): forward and backward inside the bf16
    bound on the three inputs of ``chip_smoke.train_kernel_inputs``."""
    from devtools import train_kernel_rounding as tr

    torch.set_num_threads(2)
    rng = np.random.default_rng(smoke.SEED)
    shape = (8, 64, 64, 768)
    for label, host, g in smoke.train_kernel_inputs(rng, "mhsa", shape):
        qkv = torch.from_numpy(host).to(torch.bfloat16)
        d_out = torch.from_numpy(g).to(torch.bfloat16)
        got = tr.mhsa(qkv, d_out, tr.PLANS["mhsa"]["kernel"], 8)
        ref = (K.window_mhsa_plain(qkv, 8),
               K.window_mhsa_backward_plain(qkv, d_out, 8))
        for ours, want in zip(got, ref):
            d, ratio = tr.ratio(ours, want)
            assert np.isfinite(d) and ratio < 0.9, (label, ratio)


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


def _check(got, ref, dtype, fp32_tol):
    err, bf16_ok = smoke.compare(got, ref, dtype)
    assert torch.isfinite(got).all()
    assert err <= fp32_tol if dtype == torch.float32 else bf16_ok


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("shape", [(2, 8, 12, 256), (8, 64, 64, 256)])
def test_attention_at_c256_on_the_card(rng, cuda, shape, packed, dtype):
    """Row 1 at C = 256 (NHWC and packed rows) vs its plain version on the
    three stress inputs, one launch each; the zero window finite."""
    fn, plain = ((K.packed_window_channel_attention,
                  K.packed_window_channel_attention_plain) if packed else
                 (K.window_channel_attention, K.window_channel_attention_plain))
    for _, x, ws in smoke.attention_stress_inputs(rng, shape, packed=packed):
        args = [torch.from_numpy(np.asarray(a, np.float32)).to(cuda, dtype)
                for a in [x] + ws]
        n0 = fn.launches
        got = fn(*args)
        torch.cuda.synchronize()
        assert fn.launches == n0 + 1
        _check(got, plain(*args), dtype, smoke.FP32_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 64, 64, 256), (2, 12, 20, 256)])
def test_block_at_dim256_on_the_card(rng, cuda, shape, dtype):
    for _, host, weights in smoke.block_stress_inputs(rng, shape):
        t = lambda a, dt=dtype: torch.from_numpy(
            np.asarray(a, np.float32)).to(cuda, dt)
        args = (t(host[0]), t(host[1]), t(host[2], torch.float32),
                t(host[3], torch.float32))
        kw = {n: t(a) for n, a in weights.items()}
        n0 = K.fused_structural_block.launches
        got = K.fused_structural_block(*args, **kw)
        torch.cuda.synchronize()
        assert K.fused_structural_block.launches == n0 + 1
        _check(got, K.structural_block_plain(*args, **kw), dtype,
               smoke.BLOCK_FP32_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 24, 768), (8, 64, 64, 768)])
def test_window_mhsa_train_at_8_heads_on_the_card(rng, cuda, shape, dtype):
    for label, host, g_host in smoke.train_kernel_inputs(rng, "mhsa", shape):
        n0 = K.window_mhsa_fwd.launches + K.window_mhsa_bwd.launches
        smoke.check_train_kernel("[test]", "mhsa", "", shape, 8, label, host,
                                 g_host, dtype, cuda, timed=False)
        assert K.window_mhsa_fwd.launches + K.window_mhsa_bwd.launches == n0 + 2


@pytest.mark.gpu
def test_fast_vjp_at_c256_on_the_card_matches_cpu(rng, cuda):
    """C = 256 under grad: the forward on row 1's kernel (one launch), the
    five gradients against the same Function on the CPU (fp32), each
    relative to the largest of its tensor."""
    x, ws = smoke.attention_stress_inputs(rng, (2, 16, 16, 256))[0][1:]
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        args = [torch.from_numpy(np.asarray(a, np.float32)).to(dev)
                .requires_grad_(True) for a in [x] + ws]
        n0 = K.window_channel_attention.launches
        y = K.window_channel_attention_fast_vjp(*args)
        grads = torch.autograd.grad((y ** 2).sum(), args)
        if dev == cuda:
            assert K.window_channel_attention.launches == n0 + 1
        outs[dev.type] = [t.detach().cpu() for t in (y, *grads)]
    torch.testing.assert_close(outs["cuda"][0], outs["cpu"][0],
                               atol=smoke.FP32_TOL, rtol=0)
    for a, b in zip(outs["cuda"][1:], outs["cpu"][1:]):
        assert (a - b).abs().max() <= smoke.TRAIN_GRAD_FP32_TOL * max(
            1.0, b.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["nhwc", "packed"])
def test_c64_program_on_the_card_matches_cpu(cuda, tmp_path, engine):
    """The fp32 uint8 program of a seeded c64 generator at precision
    'highest' on the card vs the CPU: at most one level on <= 1% of
    values; 4 attention launches and 1 block a forward."""
    from multi_style_transfer_gan_tpu_torch.pipelines import make_batch_fn

    path = tmp_path / "enhanced_c64.pth"
    smoke.width_checkpoint(path, C64)
    batch = np.stack(smoke.smooth_images(np.random.default_rng(5), 1,
                                         (128, 128)))
    gpu = load_generator(str(path), precision="highest", device=cuda)
    cpu = load_generator(str(path), precision="highest", device="cpu")
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


@pytest.mark.gpu
def test_c64_pretrain_step_on_the_card_matches_cpu(rng, cuda):
    """One fp32 enhanced pretrain step at c64 (128^2, batch 2) on the card
    vs the CPU from the same init on the same mask: the loss at rtol 1e-3,
    with the launches of ``chip_smoke.WIDTH_PRETRAIN_LAUNCHES_PER_STEP[C64]``."""
    x = torch.from_numpy(np.tanh(rng.standard_normal((2, 128, 128, 3)))
                         .astype(np.float32))
    mask = torch.from_numpy(np.array(jax_random_patch_mask(
        jax.random.PRNGKey(2), 2, 128)))
    losses = []
    for dev in (cuda, torch.device("cpu")):
        K.reset_launch_counts()
        state = pretrain_init_state(1, C64, model="enhanced", device=dev)
        losses.append(float(pretrain_train_step(state, x.to(dev),
                                                mask.to(dev))[1]))
        if dev == cuda:
            launched = {n: getattr(K, n).launches
                        for n in smoke.WIDTH_PRETRAIN_LAUNCHES_PER_STEP[C64]}
            assert launched == smoke.WIDTH_PRETRAIN_LAUNCHES_PER_STEP[C64]
    assert abs(losses[0] - losses[1]) <= smoke.PRETRAIN_FP32_RTOL * abs(
        losses[1])
