"""Every EnhancedGenerator width that is a multiple of 8 up to 64: the
padded kernel layouts on the CPU, against the JAX package.

The kernels run each new width inside a layout they were built for: the
channel attention at C (24, 40, .., 224) in the layout of the next power of
two, CP, with zero pad channels and the pad keys at -inf; the block at dim
96 in the dim-128 design and 160-224 in the dim-256 design, zero pad
channels and head slots, both LayerNorms over the real dim. Here:

(a) those padding rules alone, in plain PyTorch: the padded computations
    equal the unpadded plain versions (and LayerNorm over the padded dim
    does not: the trap the kernels avoid);
(b) the c24, c40, c48 and c56 generators, NHWC and packed engines, from
    JAX params and from a ``.pth``, against the JAX forward and the JAX
    packed engine on their fast (Pallas) paths in interpret mode;
(c) a c24 generator forward and backward against JAX's
    ``fast_attention="train"``, the fast-VJP route at C = 24, 48 and 96
    against JAX's ``_attention_fast_vjp``, and the port's training-route
    choice against JAX's ``supports_train_kernel`` at every C % 8 == 0;
(d) the launch-shape helpers at the new widths.

Tolerances: (a) 1e-6 absolute for the attention (the padded sums add exact
zeros; only the matrix products' summation order may differ), 1e-5 for the
block (two LayerNorms and a 4C-wide MLP in fp32); (b) the generator's 5e-4
of ``test_torch_widths.py``; (c) the forward 1e-5 and the gradients 2e-4
absolute and relative of ``test_torch_train_widths.py``, the whole
generator's gradients 1e-4 of their largest value per tensor (the sums of
gradient over 32^2 positions in another order than XLA's; for the conv
biases that feed an InstanceNorm, whose gradient is zero in exact
arithmetic, 1e-4 of the largest gradient of the model).
"""

import functools
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import chip_smoke as smoke
from multi_style_transfer_gan_tpu.models.enhanced_generator import (
    _attention_fast_vjp, enhanced_generator_apply,
)
from multi_style_transfer_gan_tpu.models.packed_generator import (
    pack_enhanced_generator_params as jax_pack_params,
    packed_enhanced_generator_apply as jax_packed_apply,
)
from multi_style_transfer_gan_tpu.ops.pallas.window_attention_train import (
    supports_train_kernel,
)
from multi_style_transfer_gan_tpu.weights import enhanced_generator_from_sd
from multi_style_transfer_gan_tpu_torch.core.norm import l2_normalize
from multi_style_transfer_gan_tpu_torch.models import (
    EnhancedGenerator, PackedEnhancedGenerator,
)
from multi_style_transfer_gan_tpu_torch.ops import kernels as K
from multi_style_transfer_gan_tpu_torch.ops.kernels.fused_transformer import (
    _window_mhsa, block_launch_shape, kernel_takes as block_takes,
    structural_block_plain, weight_shapes,
)
from multi_style_transfer_gan_tpu_torch.ops.kernels.window_attention import (
    attention_launch_shape, kernel_takes, layout_width,
    window_rows_attention_plain,
)
from multi_style_transfer_gan_tpu_torch.pipelines import load_generator
from multi_style_transfer_gan_tpu_torch.weights import (
    state_dict_from_jax_params,
)
from test_torch_widths import _check, _interpret_all, cuda  # noqa: F401

GRID_CHANNELS = (24, 40, 48, 56)
ATTENTION_WIDTHS = tuple(range(8, 257, 8))
PAD_ATOL = 1e-6
BLOCK_PAD_TOL = dict(atol=1e-5, rtol=1e-5)
GENERATOR_ATOL = 5e-4
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-4, rtol=2e-4)
GENERATOR_GRAD_RTOL = 1e-4
NOISE_GRADIENT = re.compile(
    r"^(initial\.0|(down|up)\d\.0|(down|up)\d\.4\.(branch\d|fusion)\.0)\.bias$")
SMEM_LIMIT = 227 * 1024


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# (a) the padding rules alone, in plain PyTorch
# ---------------------------------------------------------------------------

def _attention_weights(rng, C):
    return [torch.from_numpy((rng.standard_normal(s) * sc).astype(np.float32))
            for s, sc in (((3 * C, C), 0.1), ((3 * C,), 1.0), ((C, C), 0.1),
                          ((C,), 1.0))]


def _padded_attention_rows(t, wqkv, bqkv, wproj, bproj, CP, eps=1e-12):
    """The op on (R, 16, C) windows as the kernel lays it out in CP
    channels: x, the weights and the biases zero past C, the pad keys of
    the Gram at -inf before the softmax; y cut back to C."""
    R, P, C = t.shape
    wq = torch.zeros(3, CP, CP)
    wq[:, :C, :C] = wqkv.reshape(3, C, C)
    bq = torch.zeros(3, CP)
    bq[:, :C] = bqkv.reshape(3, C)
    wp = torch.zeros(CP, CP)
    wp[:C, :C] = wproj
    bp = torch.zeros(CP)
    bp[:C] = bproj
    qkv = F.linear(F.pad(t, (0, CP - C)), wq.reshape(3 * CP, CP),
                   bq.reshape(3 * CP))
    q, k, v = qkv.split(CP, dim=-1)
    gram = l2_normalize(q, eps).transpose(1, 2) @ l2_normalize(k, eps)
    gram[..., C:] = float("-inf")
    out = v @ torch.softmax(gram, dim=-1).transpose(1, 2)
    return F.linear(out, wp, bp)[..., :C]


@pytest.mark.parametrize("C", ATTENTION_WIDTHS)
def test_padded_attention_is_the_op(rng, C):
    """At every width the kernel takes, the op in its layout (CP channels,
    pad keys at -inf) equals the unpadded op, an all-zero window included."""
    CP = layout_width(C, bf16=True)
    assert kernel_takes(C) and CP >= C and CP in (16, 32, 64, 128, 256)
    t = torch.from_numpy(rng.standard_normal((3, 16, C)).astype(np.float32))
    t[0] = 0.0
    ws = _attention_weights(rng, C)
    got = _padded_attention_rows(t, *ws, CP)
    ref = window_rows_attention_plain(t, *ws)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=PAD_ATOL, rtol=0)


def _layer_norm(h, w, b, C, eps, over_real):
    """LayerNorm of padded rows: statistics over the C real channels (the
    kernels' rule) or over every channel (the trap)."""
    if not over_real:
        return F.layer_norm(h, h.shape[-1:], w, b, eps)
    mean = h.sum(-1, keepdim=True) / C
    var = ((h[..., :C] - mean) ** 2).sum(-1, keepdim=True) / C
    return (h - mean) * torch.rsqrt(var + eps) * w + b


def _padded_block(x, struct, gamma, beta, DP, over_real, eps=1e-5, **w):
    """The block body with every channel padded from C to DP as the kernels
    stage it: zero pad channels, weight rows and columns, biases, norms and
    FiLM entries; DP / 32 head slots, those past the real heads all zero;
    both LayerNorms over the real C (``over_real``) or over DP."""
    C = x.shape[-1]

    def pad(a, *dims):
        out = torch.zeros(*dims)
        out[tuple(slice(0, n) for n in a.shape)] = a
        return out

    lead = x.shape[:-1]
    xp, sp = pad(x, *lead, DP), pad(struct, *lead, DP)
    g, bt = pad(gamma, gamma.shape[0], DP), pad(beta, beta.shape[0], DP)
    qkv_w = torch.zeros(3, DP, DP)
    qkv_w[:, :C, :C] = w["qkv_w"].reshape(3, C, C)
    qkv_b = torch.zeros(3, DP)
    qkv_b[:, :C] = w["qkv_b"].reshape(3, C)
    h = _layer_norm(xp + sp, pad(w["norm1_w"], DP), pad(w["norm1_b"], DP), C,
                    eps, over_real)
    h = h * (1.0 + g[:, None, None, :]) + bt[:, None, None, :]
    xp = xp + F.linear(_window_mhsa(h, qkv_w.reshape(3 * DP, DP),
                                    qkv_b.reshape(3 * DP)),
                       pad(w["proj_w"], DP, DP), pad(w["proj_b"], DP))
    h = _layer_norm(xp, pad(w["norm2_w"], DP), pad(w["norm2_b"], DP), C, eps,
                    over_real)
    h = F.linear(F.gelu(F.linear(h, pad(w["fc1_w"], 4 * DP, DP),
                                 pad(w["fc1_b"], 4 * DP))),
                 pad(w["fc2_w"], DP, 4 * DP), pad(w["fc2_b"], DP))
    return (xp + h)[..., :C]


@pytest.mark.parametrize("dim,DP", [(96, 128), (160, 256), (192, 256),
                                    (224, 256)])
def test_padded_block_is_the_block_only_with_layer_norm_over_the_real_dim(
        rng, dim, DP):
    """The block padded from dim to the layout's DP, with zero head slots,
    equals the unpadded block when both LayerNorms count the real dim only;
    over DP each pad channel adds (0 - mean)^2 to the variance and the
    result is another block."""
    assert block_takes(dim) and dim % 32 == 0 and DP in (128, 256)
    x, st = (torch.from_numpy(rng.standard_normal((1, 8, 8, dim))
                              .astype(np.float32)) for _ in range(2))
    gamma, beta = (torch.from_numpy((rng.standard_normal((1, dim)) * 0.1)
                                    .astype(np.float32)) for _ in range(2))
    w = {n: torch.from_numpy((rng.standard_normal(s) * (0.1 if len(s) == 2
                                                        else 0.05)
                              + (1.0 if n in ("norm1_w", "norm2_w") else 0.0))
                             .astype(np.float32))
         for n, s in weight_shapes(dim).items()}
    ref = structural_block_plain(x, st, gamma, beta, **w)
    got = _padded_block(x, st, gamma, beta, DP, over_real=True, **w)
    torch.testing.assert_close(got, ref, **BLOCK_PAD_TOL)
    trap = _padded_block(x, st, gamma, beta, DP, over_real=False, **w)
    assert (trap - ref).abs().max().item() > 1e-2


# ---------------------------------------------------------------------------
# (b) the c24, c40, c48 and c56 generators against JAX, both engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grid_generators():
    """{channels: (JAX params of a seeded port module, x, the JAX NHWC
    forward, the JAX packed forward)}, both forwards on the fast (Pallas)
    path in interpret mode, batch 1 at 32^2."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _interpret_all(mp)
        for c in GRID_CHANNELS:
            module = EnhancedGenerator(c, 1, generator=torch.Generator()
                                       .manual_seed(c))
            sd = {k: v.detach().numpy().copy()
          for k, v in module.state_dict().items()}
            params = {k: jnp.asarray(v) for k, v in
                      enhanced_generator_from_sd(sd).items()}
            x = np.tanh(np.random.default_rng(c).standard_normal(
                (1, 32, 32, 3))).astype(np.float32)
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
@pytest.mark.parametrize("channels", GRID_CHANNELS)
def test_grid_generator_matches_jax_on_both_engines(grid_generators,
                                                    tmp_path, channels,
                                                    source):
    params, x, ref_nhwc, ref_packed = grid_generators[channels]
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


# ---------------------------------------------------------------------------
# (c) training: the c24 generator, the route, the route's choice
# ---------------------------------------------------------------------------

def test_c24_generator_gradients_match_jax_fast_attention_train(
        monkeypatch):
    """Loss <G(x), g> of a seeded c24 generator at 32^2, batch 2, and the
    gradient of every parameter, against JAX's ``fast_attention="train"``
    (Pallas in interpret mode): JAX takes ``_attention_fast_vjp`` at C =
    24, 48 and 96 (no training kernel there) and ``window_mhsa_train`` at 3
    heads; the port on the CPU takes the plain mid and the plain MHSA mid in
    autograd around the same convolutions."""
    _interpret_all(monkeypatch)
    import multi_style_transfer_gan_tpu.ops.pallas.window_mhsa_train as wmt
    orig = wmt.pl.pallas_call
    monkeypatch.setattr(wmt.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    module = EnhancedGenerator(24, 1, generator=torch.Generator()
                               .manual_seed(24))
    sd = {k: v.detach().numpy().copy()
          for k, v in module.state_dict().items()}
    params = {k: jnp.asarray(v) for k, v in
              enhanced_generator_from_sd(sd).items()}
    rng = np.random.default_rng(24)
    x = np.tanh(rng.standard_normal((2, 32, 32, 3))).astype(np.float32)
    g = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)

    def jloss(p):
        y = enhanced_generator_apply(p, jnp.asarray(x), fast_attention="train")
        return jnp.sum(y * jnp.asarray(g))

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(params)
    module = module.to(memory_format=torch.channels_last)
    y = module(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    loss = (y * _t(g)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    ours = state_dict_from_jax_params(
        {k: np.asarray(v) for k, v in ref_grads.items()})
    named = dict(module.named_parameters())
    assert set(named) <= set(ours)
    largest = max(np.abs(t.numpy()).max() for t in ours.values())
    for name, p in named.items():
        want = ours[name].numpy()
        # a conv bias right before an InstanceNorm has a zero gradient in
        # exact arithmetic: both sides hold rounding noise there
        scale = (largest if NOISE_GRADIENT.match(name)
                 else np.abs(want).max())
        d = np.abs(p.grad.numpy() - want).max()
        assert d <= GENERATOR_GRAD_RTOL * scale, (name, d, scale)


@pytest.mark.parametrize("C", [24, 48, 96])
def test_fast_vjp_route_at_the_grid_widths_matches_jax(rng, monkeypatch, C):
    """The route c24 trains all its LocalAttention calls through (C = 24,
    48, 96): the forward and the five gradients of <y, g> on CPU tensors
    against JAX's ``_attention_fast_vjp`` (its forward the Pallas kernel in
    interpret mode, its backward XLA's VJP of ``_attention_math``)."""
    _interpret_all(monkeypatch)
    x = rng.standard_normal((2, 8, 8, C)).astype(np.float32)
    x[0, :4, :4] = 0.0
    w = [a.numpy() for a in _attention_weights(rng, C)]
    g = rng.standard_normal(x.shape).astype(np.float32)
    hwio = (w[0].T[None, None], w[1], w[2].T[None, None], w[3])

    def jfn(x_, wq, bq, wp, bp):
        y = _attention_fast_vjp(x_, wq, bq, wp, bp, 4, 1e-12)
        return jnp.sum(y * jnp.asarray(g)), y

    (_, ref), grads = jax.value_and_grad(jfn, argnums=(0, 1, 2, 3, 4),
                                         has_aux=True)(
        jnp.asarray(x), *map(jnp.asarray, hwio))
    args = [_t(a).requires_grad_(True) for a in [x] + w]
    y = K.window_channel_attention_fast_vjp(*args)
    (y * _t(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), **FWD_TOL)
    want = [np.asarray(grads[0]), np.asarray(grads[1])[0, 0].T,
            np.asarray(grads[2]), np.asarray(grads[3])[0, 0].T,
            np.asarray(grads[4])]
    for a, ref_g in zip(args, want):
        np.testing.assert_allclose(a.grad.numpy(), ref_g, **GRAD_TOL)


def test_train_route_is_jax_supports_train_kernel():
    """For every C % 8 == 0 up to 256 the port trains LocalAttention through
    the hand-written pair exactly where JAX's ``supports_train_kernel`` holds
    (at a grid whose window count every group size divides), and through
    the fast-VJP route everywhere else; C = 4 takes the pair, C = 12, 20
    and 264 the route (tests/test_torch_width_any.py holds every C from 1
    to 512), and so do the widths past 512, over the streamed kernel."""
    for C in ATTENTION_WIDTHS:
        want = "kernel" if supports_train_kernel(1, 32, 32, C) else "fast_vjp"
        assert K.train_route(C) == want, C
    assert [K.train_route(C) for C in (4, 12, 20, 264, 520)] == [
        "kernel", "fast_vjp", "fast_vjp", "fast_vjp", "fast_vjp"]


# ---------------------------------------------------------------------------
# (d) the launch-shape helpers at the new widths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,bf16,units,smem", [
    (24, True, 256, 69120),      # C = 32's layout, 8 warps
    (48, True, 256, 146432),     # C = 64's layout
    (96, True, 683, 219648),     # C = 128's layout, 3 warps
    (192, True, 1024, 205824),   # the C = 256 kernel, two windows a unit
    (24, False, 1024, 42368),    # fp32: C = 32's layout, tiles of 2 windows
    (160, False, 2048, 135616),  # fp32: C = 256's layout
])
def test_attention_launch_shape_at_the_grid_widths(C, bf16, units, smem):
    assert attention_launch_shape(2048, C, bf16) == (units, smem)
    assert smem <= SMEM_LIMIT


@pytest.mark.parametrize("C", [c * k for c in GRID_CHANNELS for k in (1, 2, 4)])
@pytest.mark.parametrize("bf16", [True, False])
def test_attention_launch_shape_is_the_layouts(C, bf16):
    """A padded width takes its layout's units and shared memory."""
    cp = layout_width(C, bf16)
    assert cp > C and attention_launch_shape(2048, C, bf16) == \
        attention_launch_shape(2048, cp, bf16)


@pytest.mark.parametrize("dim,layout", [(96, 128), (160, 256), (192, 256),
                                        (224, 256)])
def test_block_launch_shape_at_the_grid_dims(dim, layout):
    """Dim 96 in the dim-128 design, 160-224 in the dim-256 one: one
    window a unit, that design's shared memory."""
    shape = block_launch_shape(8, 64, 64, dim)
    assert shape == block_launch_shape(8, 64, 64, layout)
    assert shape[0] == 8 * 8 * 8 and shape[1] <= SMEM_LIMIT


# ---------------------------------------------------------------------------
# kernel vs plain on the card at the padded widths
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("C", [c * k for c in GRID_CHANNELS for k in (1, 2, 4)])
def test_attention_kernels_at_the_padded_widths(cuda, C, packed, dtype):
    """NHWC and packed kernels vs plain at every LocalAttention width of
    c24 .. c56 on the stress inputs (an all-zero window each), a ragged
    last block of windows included; one launch a call."""
    fn, plain = ((K.packed_window_channel_attention,
                  K.packed_window_channel_attention_plain) if packed else
                 (K.window_channel_attention, K.window_channel_attention_plain))
    for label, x, ws in smoke.attention_stress_inputs(
            np.random.default_rng(C), (3, 8, 12, C), packed=packed):
        args = [_t(np.asarray(a, np.float32)).to(cuda, dtype)
                for a in [x] + ws]
        n0 = fn.launches
        got = fn(*args)
        torch.cuda.synchronize()
        assert fn.launches == n0 + 1, label
        _check(got, plain(*args), dtype, smoke.FP32_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 16), (1, 12, 20)])
@pytest.mark.parametrize("dim", [96, 160, 192, 224])
def test_block_kernel_at_the_padded_dims(cuda, dim, shape, dtype):
    """The block at dims 96, 160, 192, 224 (3, 5, 6, 7 heads) vs plain on
    the stress inputs, a ragged grid included."""
    for label, host, weights in smoke.block_stress_inputs(
            np.random.default_rng(dim), shape + (dim,)):
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
@pytest.mark.parametrize("heads", [3, 5, 6, 7])
def test_mhsa_train_kernels_at_the_new_heads(cuda, heads, dtype):
    """Row 12 forward and backward at 3, 5, 6 and 7 heads vs plain on the
    three training inputs."""
    shape = (2, 16, 16, 96 * heads)
    for label, host, g in smoke.train_kernel_inputs(
            np.random.default_rng(heads), "mhsa", shape):
        smoke.check_train_kernel("[test]", "mhsa", "block", shape, heads,
                                 label, host, g, dtype, cuda, timed=False)
