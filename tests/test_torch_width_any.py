"""Every EnhancedGenerator width from 1 to 64: the kernels' layouts at the
widths that are not multiples of 8, on the CPU, against the JAX package.

The kernels take those widths as follows (csrc/):

- the channel attention (row 1) at any C from 1 to 256 in the layout of the
  next power of two (CP = 16 .. 256 in bf16, 8 .. 256 in fp32): zero pad
  channels, the pad keys at -inf before the softmax;
- the block (row 4) at a dim 4c that is not a multiple of 32: in bf16 the
  head-slot kernel, default_num_heads(dim) heads of hd = 4 .. 62 channels
  each in a slot of hd rounded up to 16 (zeros in the pad rows and
  columns), one head at a time, its share of the proj added onto the
  residual stream, in the dim-256 frame (zero pad channels), both
  LayerNorms over the real dim, the scale 1/sqrt(hd); in fp32 the FMA
  bodies, the same head by head with no pads;
- the window-MHSA mid (row 12) with each head in a slot of hd rounded up to
  16 channels, zeros in the pad channels, the scale 1/sqrt(hd) of the real
  width;
- the channel-attention mid (row 11) at C = 1, 2, 4 padded to 16 channels
  (bf16), the pad keys at -inf.

Here: (a) the width gates; (b) plain-PyTorch mirrors of those layouts
against JAX's formulations (``_attention_math``, ``_block_body_math``) and
its Pallas training kernels in interpret mode (``window_mhsa_train``,
``window_channel_attention_train``); (c) the c4 and c12 generators on both
engines against JAX; (d) one c12 enhanced pretrain step against JAX (the
c4 CycleGAN step against JAX is a case of
``test_torch_train_widths.py::test_cyclegan_step_at_the_width_matches_jax``,
where it shares the compiled JAX step with that file's c4
``--no_fast_attention`` step); (e) the training-route choice and the
launch-shape helpers. Tests marked ``gpu`` hold the kernels against their plain versions
on the card; they skip without a CUDA device.

Tolerances are the existing tests': the attention forward 1e-5 absolute
(``test_torch_widths.py``), the block 2e-4 absolute and relative
(``test_torch_c64.py``), the training mids' forwards 1e-5 and gradients
2e-4 (``test_torch_train_widths.py``), the generators 5e-4 and the
pretrain loss rtol 1e-5.
"""

import functools
import importlib
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import chip_smoke as smoke
from multi_style_transfer_gan_tpu.data.dataset import (
    random_patch_mask as jax_random_patch_mask,
)
from multi_style_transfer_gan_tpu.models.enhanced_generator import (
    _attention_math, enhanced_generator_apply,
)
from multi_style_transfer_gan_tpu.models.packed_generator import (
    pack_enhanced_generator_params as jax_pack_params,
    packed_enhanced_generator_apply as jax_packed_apply,
)
from multi_style_transfer_gan_tpu.models.structural_transformer import (
    _block_body_math,
)
from multi_style_transfer_gan_tpu.ops.pallas.window_attention_train import (
    supports_train_kernel, window_channel_attention_train as jax_mid_train,
)
from multi_style_transfer_gan_tpu.ops.pallas.window_mhsa_train import (
    window_mhsa_train as jax_mhsa_train,
)
from multi_style_transfer_gan_tpu.train import pretrain as jpretrain
from multi_style_transfer_gan_tpu.weights import enhanced_generator_from_sd
from multi_style_transfer_gan_tpu_torch.core.activations import gelu
from multi_style_transfer_gan_tpu_torch.models import (
    EnhancedGenerator, PackedEnhancedGenerator,
)
from multi_style_transfer_gan_tpu_torch.ops import kernels as K
from multi_style_transfer_gan_tpu_torch.ops.kernels import (
    fused_transformer, window_attention,
)
from multi_style_transfer_gan_tpu_torch.ops.kernels.fused_transformer import (
    block_launch_shape, default_num_heads, weight_shapes,
)
from multi_style_transfer_gan_tpu_torch.ops.kernels.window_attention import (
    attention_launch_shape, layout_width,
)
from multi_style_transfer_gan_tpu_torch.ops.kernels.window_attention_train import (
    window_merge, window_partition,
)
from multi_style_transfer_gan_tpu_torch.pipelines import load_generator
from multi_style_transfer_gan_tpu_torch.train import (
    cyclegan_init_state, pretrain_init_state, pretrain_train_step,
)
from multi_style_transfer_gan_tpu_torch.weights import (
    state_dict_from_jax_params,
)
from test_torch_widths import _check, cuda  # noqa: F401

WM = importlib.import_module(
    "multi_style_transfer_gan_tpu_torch.ops.kernels.window_mhsa_train")
ATTENTION_ATOL = 1e-5
BLOCK_TOL = dict(atol=2e-4, rtol=2e-4)
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-4, rtol=2e-4)
GENERATOR_ATOL = 5e-4
PRETRAIN_RTOL = 1e-5
SMEM_LIMIT = 227 * 1024
MIRROR_ATTENTION_WIDTHS = (1, 3, 12, 60, 63, 126, 252)
MIRROR_BLOCK_CHANNELS = (1, 3, 12, 28, 44, 60, 63)
# generator widths past 128 the entry points take
PAST_128 = (132, 192, 256)
# the widths up to 128 whose block heads are wider than 64 channels
WIDE_HEADED = (67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# (a) the gates
# ---------------------------------------------------------------------------

def test_gates_take_every_width_from_1_to_64():
    """Serving and training take every c from 1 to 128: every width's
    LocalAttention (C, 2C, 4C), block and window-MHSA mid are in the
    kernels' rules, the 13 whose block heads are wider than 64 channels
    (``WIDE_HEADED``) in the bf16 block chain and row 12's chunks of 64, the
    rest in the one-window designs and row 12's slots."""
    for c in range(1, 129):
        dim = 4 * c
        assert all(window_attention.kernel_takes(w) for w in (c, 2 * c, dim))
        assert fused_transformer.kernel_takes(dim)
        assert WM.kernel_takes(dim, default_num_heads(dim))
        assert K.train_route(c) and K.train_route(2 * c) and K.train_route(dim)
        wide = dim // default_num_heads(dim) > 64
        assert wide == (c in WIDE_HEADED)
        assert fused_transformer.stream_takes(dim) == wide


@pytest.mark.parametrize("channels", PAST_128)
def test_gates_take_widths_past_128(tmp_path, channels):
    """c132, c192 and c256 build at every entry point that refused a width
    before: ``load_generator``, ``cyclegan_init_state`` and enhanced
    pretraining (on the CPU here; the card takes the same widths, and a
    model that outgrows its memory raises PyTorch's own out-of-memory
    error). Their kernel shapes are in the rules: LocalAttention at C, 2C and
    4C (2C and 4C past 512 streamed), the block at 4C in its heads."""
    dim = 4 * channels
    assert all(window_attention.kernel_takes(w) and K.train_route(w)
               for w in (channels, 2 * channels, dim))
    assert fused_transformer.kernel_takes(dim)
    assert WM.kernel_takes(dim, default_num_heads(dim))
    path = tmp_path / f"enhanced_c{channels}.pth"
    torch.save({"G_AB_state_dict": EnhancedGenerator(channels, 1)
                .state_dict()}, path)
    assert load_generator(path, device="cpu").channels == channels
    width = lambda g: g.initial[0].weight.shape[0]
    assert width(cyclegan_init_state(0, channels, device="cpu").G_AB) \
        == channels
    state = pretrain_init_state(0, channels, model="enhanced", device="cpu")
    assert width(state.model) == channels


# ---------------------------------------------------------------------------
# (b) the kernels' layouts, mirrored in plain PyTorch, against JAX
# ---------------------------------------------------------------------------

def _attention_weights(rng, C):
    return [(rng.standard_normal(s) * sc).astype(np.float32)
            for s, sc in (((3 * C, C), 0.1), ((3 * C,), 1.0), ((C, C), 0.1),
                          ((C,), 1.0))]


def _hwio(wqkv, bqkv, wproj, bproj):
    """PyTorch (out, in) 1x1 weights as JAX's HWIO kernels."""
    return (jnp.asarray(wqkv.T[None, None]), jnp.asarray(bqkv),
            jnp.asarray(wproj.T[None, None]), jnp.asarray(bproj))


def mirror_attention(x, wqkv, bqkv, wproj, bproj, *, bf16, eps=1e-12):
    """The channel-attention kernel's layout on NHWC ``x``: each window's
    16 positions in CP = ``layout_width(C, bf16)`` channels, zeros in x, the
    weights and the biases past C; in bf16 the pad keys of the Gram at -inf
    before the softmax (fp32: the softmax over the C real keys, as the FMA
    body); y cut back to C."""
    B, H, W, C = x.shape
    CP = layout_width(C, bf16)
    t = window_partition(x, 4)
    wq = torch.zeros(3, CP, CP)
    wq[:, :C, :C] = wqkv.reshape(3, C, C)
    bq = torch.zeros(3, CP)
    bq[:, :C] = bqkv.reshape(3, C)
    wp, bp = torch.zeros(CP, CP), torch.zeros(CP)
    wp[:C, :C], bp[:C] = wproj, bproj
    qkv = F.linear(F.pad(t, (0, CP - C)), wq.reshape(3 * CP, CP),
                   bq.reshape(3 * CP))
    q, k, v = qkv.split(CP, dim=-1)
    norm = lambda u: u / torch.clamp_min(u.norm(dim=-1, keepdim=True), eps)
    gram = norm(q).transpose(1, 2) @ norm(k)
    if bf16:
        gram[..., C:] = float("-inf")
        a = torch.softmax(gram, dim=-1)
    else:
        a = torch.zeros_like(gram)
        a[..., :C] = torch.softmax(gram[..., :C], dim=-1)
    out = F.linear(v @ a.transpose(1, 2), wp, bp)[..., :C]
    return window_merge(out, B, H, W, 4)


@pytest.mark.parametrize("C", MIRROR_ATTENTION_WIDTHS)
def test_attention_layout_matches_jax(rng, C):
    """The attention kernel's layouts at C = 1, 3, 12, 60, 63, 126, 252 (in
    CP = 16 .. 256, bf16's and fp32's) == JAX's ``_attention_math``, an
    all-zero window included; so does the port's plain version."""
    x = rng.standard_normal((1, 8, 12, C)).astype(np.float32)
    x[0, :4, :4] = 0.0
    ws = _attention_weights(rng, C)
    ref = np.asarray(_attention_math(jnp.asarray(x), *_hwio(*ws),
                                     window_size=4, eps=1e-12))
    args = [_t(a) for a in [x] + ws]
    for bf16 in (True, False):
        got = mirror_attention(*args, bf16=bf16).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, atol=ATTENTION_ATOL, rtol=0)
    np.testing.assert_allclose(K.window_channel_attention(*args).numpy(), ref,
                               atol=ATTENTION_ATOL, rtol=0)


def mirror_block(x, struct, gamma, beta, *, norm1_w, norm1_b, qkv_w, qkv_b,
                 proj_w, proj_b, norm2_w, norm2_b, fc1_w, fc1_b, fc2_w, fc2_b,
                 eps=1e-5, DP=256):
    """The head-slot kernel's layout (``fused_structural_block_slot_kernel``)
    on an 8x8-multiple grid of (B, H, W, C) tokens, in fp32: the residual
    stream and every weight, bias, norm and FiLM entry in DP channels, zero
    past C; both LayerNorms over the C real channels; each of the
    default_num_heads(C) heads in a slot of S = hd rounded up to 16 (its q,
    k and v weight rows and its proj columns at the slot's start, zeros in
    the rest), one head at a time at the scale 1/sqrt(hd), its share of the
    proj added onto the stream; the MLP's 4C hidden columns in chunks of
    128, zero past 4C; y cut back to C."""
    B, H, W, C = x.shape
    heads = default_num_heads(C)
    hd = C // heads
    S = -(-hd // 16) * 16

    def pad(a, *dims):
        out = torch.zeros(*dims)
        out[tuple(slice(0, n) for n in a.shape)] = a
        return out

    hidden = -(-4 * C // 128) * 128
    lead = x.shape[:-1]
    xr, sp = pad(x, *lead, DP), pad(struct, *lead, DP)
    g, bt = pad(gamma, B, DP), pad(beta, B, DP)
    n1w, n1b, n2w, n2b = (pad(a, DP) for a in (norm1_w, norm1_b, norm2_w,
                                               norm2_b))
    mean = lambda h: h.sum(-1, keepdim=True) / C
    ln = lambda h, w, b: ((h - mean(h)) * torch.rsqrt(
        ((h - mean(h))[..., :C] ** 2).sum(-1, keepdim=True) / C + eps) * w
        + b)
    h = window_partition(ln(xr + sp, n1w, n1b) * (1 + g[:, None, None])
                         + bt[:, None, None], 8)
    xr = window_partition(xr, 8) + pad(proj_b, DP)
    for hh in range(heads):
        slot = []
        for p in range(3):
            w = torch.zeros(S, DP)
            w[:hd, :C] = qkv_w[p * C + hh * hd:p * C + (hh + 1) * hd]
            b = torch.zeros(S)
            b[:hd] = qkv_b[p * C + hh * hd:p * C + (hh + 1) * hd]
            slot.append(F.linear(h, w, b))
        q, k, v = slot
        o = torch.softmax((q @ k.transpose(1, 2)) / math.sqrt(hd), -1) @ v
        wp = torch.zeros(DP, S)
        wp[:C, :hd] = proj_w[:, hh * hd:(hh + 1) * hd]
        xr = xr + F.linear(o, wp)
    h = ln(xr, n2w, n2b)
    f1w, f1b = pad(fc1_w, hidden, DP), pad(fc1_b, hidden)
    f2w = pad(fc2_w, DP, hidden)
    xr = xr + pad(fc2_b, DP)
    for h0 in range(0, hidden, 128):
        a = gelu(F.linear(h, f1w[h0:h0 + 128], f1b[h0:h0 + 128]))
        xr = xr + F.linear(a, f2w[:, h0:h0 + 128])
    return window_merge(xr, B, H, W, 8)[..., :C]


def _block_args(rng, shape):
    B, H, W, C = shape
    host = [rng.standard_normal(shape), rng.standard_normal(shape),
            rng.standard_normal((B, C)) * 0.1, rng.standard_normal((B, C)) * 0.1]
    w = {n: rng.standard_normal(s) * (0.1 if len(s) == 2 else 0.05)
         + (1.0 if n in ("norm1_w", "norm2_w") else 0.0)
         for n, s in weight_shapes(C).items()}
    return ([a.astype(np.float32) for a in host],
            {n: a.astype(np.float32) for n, a in w.items()})


@pytest.mark.parametrize("channels", MIRROR_BLOCK_CHANNELS)
def test_block_layout_matches_jax(rng, channels):
    """The block's head-slot layout at the dims of c1, c3, c12, c28, c44,
    c60 and c63 (4 .. 252: 1 head of 4, 12, 48 in slots of 16, 16, 48; 2 of
    56, 4 of 44, 6 of 40, 7 of 36 in slots of 64, 48, 48, 48) == JAX's
    ``_block_body_math`` on a 16 x 16 grid; so does the port's plain
    version (what the FMA bodies compute, head by head, with no pads)."""
    dim = 4 * channels
    host, w = _block_args(rng, (1, 16, 16, dim))
    ref = np.asarray(jax.jit(functools.partial(
        _block_body_math, grid_hw=(16, 16), window=8))(
        *(jnp.asarray(a.reshape(1, 256, dim)) if i < 2 else jnp.asarray(a)
          for i, a in enumerate(host)),
        *(jnp.asarray(w[n]) for n in fused_transformer.WEIGHT_NAMES)
    )).reshape(1, 16, 16, dim)
    args = [_t(a) for a in host]
    kw = {n: _t(a) for n, a in w.items()}
    np.testing.assert_allclose(mirror_block(*args, **kw).numpy(), ref,
                               **BLOCK_TOL)
    np.testing.assert_allclose(K.fused_structural_block(*args, **kw).numpy(),
                               ref, **BLOCK_TOL)


def _slot(hd):
    return -(-hd // 16) * 16


def _slot_heads(t, heads, S):
    """(B, H, W, heads hd) -> (windows, heads, 64, S), zeros past hd."""
    w = window_partition(t.float(), 8)
    n, T, C = w.shape
    w = w.reshape(n, T, heads, C // heads).transpose(1, 2)
    return F.pad(w, (0, S - C // heads))


def _unslot(t, hd, B, H, W):
    return WM._merge_heads(t[..., :hd], B, H, W)


class MirrorMHSA(torch.autograd.Function):
    """The window-MHSA kernels' slot layout: each head of hd channels in a
    slot of S = hd rounded up to 16, zeros past hd; the scale 1/sqrt(hd);
    the forward and the hand-written backward (module docstring of
    ``ops/kernels/window_mhsa_train.py``) on the slots, cut back to hd."""

    @staticmethod
    def forward(ctx, qkv, heads):
        ctx.heads = heads
        ctx.save_for_backward(qkv)
        B, H, W, C3 = qkv.shape
        hd = C3 // 3 // heads
        q, k, v = (_slot_heads(t, heads, _slot(hd))
                   for t in qkv.split(C3 // 3, dim=-1))
        p = torch.softmax((q @ k.transpose(-2, -1)) / math.sqrt(hd), dim=-1)
        return _unslot(p @ v, hd, B, H, W)

    @staticmethod
    def backward(ctx, d_out):
        (qkv,) = ctx.saved_tensors
        heads = ctx.heads
        B, H, W, C3 = qkv.shape
        hd, scale = C3 // 3 // heads, (C3 // 3 // ctx.heads) ** -0.5
        S = _slot(hd)
        q, k, v = (_slot_heads(t, heads, S) for t in qkv.split(C3 // 3, -1))
        do = _slot_heads(d_out, heads, S)
        p = torch.softmax((q @ k.transpose(-2, -1)) * scale, dim=-1)
        dp = do @ v.transpose(-2, -1)
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        grads = ((ds @ k) * scale, (ds.transpose(-2, -1) @ q) * scale,
                 p.transpose(-2, -1) @ do)
        return torch.cat([_unslot(g, hd, B, H, W) for g in grads], -1), None


@pytest.mark.parametrize("channels", MIRROR_BLOCK_CHANNELS)
def test_mhsa_slot_layout_matches_jax(rng, channels):
    """Row 12's slot layout at the blocks of c1 .. c63 (heads of 4 .. 44
    channels in slots of 16 .. 48): the forward and the gradient of
    sum(out^2) == JAX's Pallas ``window_mhsa_train`` (interpret mode);
    so does the port's plain pair."""
    dim = 4 * channels
    heads = default_num_heads(dim)
    qkv = rng.standard_normal((2, 8, 16, 3 * dim)).astype(np.float32)
    fn = lambda t: jax_mhsa_train(t, 8, heads, True)
    ref, vjp = jax.jit(lambda t: jax.vjp(fn, t))(jnp.asarray(qkv))
    (ref_g,) = vjp(2 * ref)   # the gradient of sum(out^2)
    for fn in (MirrorMHSA.apply, K.window_mhsa_train):
        t = _t(qkv).requires_grad_(True)
        out = fn(t, heads)
        (out ** 2).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                                   **FWD_TOL)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref_g),
                                   **GRAD_TOL)


def _padded_windows(qkv, eps):
    """Row 11's bf16 layout: q, k, v of each 4x4 window padded from C to 16
    channels (zeros), normalized (0 -> 0); the Gram's pad keys at -inf."""
    C = qkv.shape[-1] // 3
    q, k, v = (F.pad(u, (0, 16 - C)) for u in window_partition(
        qkv.double(), 4).split(C, dim=-1))
    n = lambda u: u.norm(dim=-1, keepdim=True)
    inv = lambda u: 1.0 / torch.clamp_min(n(u), eps)
    sel = lambda u: ((n(u) > 0) & (n(u) > eps)).double()
    gram = (q * inv(q)).transpose(1, 2) @ (k * inv(k))
    gram[..., C:] = float("-inf")
    return q, k, v, torch.softmax(gram, dim=-1), (inv, sel)


class MirrorMid(torch.autograd.Function):
    """Row 11 at C = 1, 2, 4 in its bf16 layout (``_padded_windows``): the
    forward, and the hand-written backward (module docstring of
    ``ops/kernels/window_attention_train.py``) on the padded windows, cut
    back to C."""

    @staticmethod
    def forward(ctx, qkv, eps):
        ctx.eps = eps
        ctx.save_for_backward(qkv)
        B, H, W, C3 = qkv.shape
        _, _, v, s, _ = _padded_windows(qkv, eps)
        return window_merge((v @ s.transpose(1, 2))[..., :C3 // 3],
                            B, H, W, 4).float()

    @staticmethod
    def backward(ctx, d_out):
        (qkv,) = ctx.saved_tensors
        B, H, W, C3 = qkv.shape
        C = C3 // 3
        q, k, v, s, (inv, sel) = _padded_windows(qkv, ctx.eps)
        qn, kn = q * inv(q), k * inv(k)
        do = F.pad(window_partition(d_out.double(), 4), (0, 16 - C))
        ds = do.transpose(1, 2) @ v
        dl = s * (ds - (s * ds).sum(-1, keepdim=True))
        dqn, dkn = kn @ dl.transpose(1, 2), qn @ dl
        dq = (dqn - qn * (qn * dqn).sum(-1, keepdim=True) * sel(q)) * inv(q)
        dk = (dkn - kn * (kn * dkn).sum(-1, keepdim=True) * sel(k)) * inv(k)
        d = torch.cat([t[..., :C] for t in (dq, dk, do @ s)], -1)
        return window_merge(d, B, H, W, 4).float(), None


@pytest.mark.parametrize("C", [1, 2, 4])
def test_mid_padded_layout_at_c1_2_4_matches_jax(rng, C):
    """Row 11's layout at C = 1, 2, 4 (padded to 16, pad keys at -inf)
    between the two 1x1 convs == JAX's Pallas
    ``window_channel_attention_train`` (interpret mode; 128 windows, which
    every group size 128 / C divides): the forward and the five gradients
    of sum(y^2), an all-zero window (q = k = 0) and a window of |q|, |k| ~
    1e-3 included; so does the port's plain mid."""
    x = rng.standard_normal((2, 32, 32, C)).astype(np.float32)
    ws = _attention_weights(rng, C)
    x[0, :4, :4] = 0.0
    ws[1][:2 * C] = 0.0
    x[0, 4:8, :4] *= 1e-3
    assert supports_train_kernel(2, 32, 32, C)
    args = (jnp.asarray(x), *_hwio(*ws))
    fn = lambda *a: jax_mid_train(*a, interpret=True)
    ref, vjp = jax.jit(lambda *a: jax.vjp(fn, *a))(*args)
    ref_g = vjp(2 * ref)   # the gradients of sum(y^2)
    ref = np.asarray(ref)
    ref_g = [np.asarray(g)[0, 0].T if i in (1, 3) else np.asarray(g)
             for i, g in enumerate(ref_g)]
    for mid in (lambda q: MirrorMid.apply(q, 1e-12),
                K.window_channel_attention_train):
        t = [_t(a).requires_grad_(True) for a in [x] + ws]
        qkv = F.linear(t[0], t[1], t[2]).contiguous()
        y = F.linear(mid(qkv), t[3], t[4])
        (y ** 2).sum().backward()
        np.testing.assert_allclose(y.detach().numpy(), ref, **FWD_TOL)
        for a, want in zip(t, ref_g):
            assert torch.isfinite(a.grad).all()
            np.testing.assert_allclose(a.grad.numpy(), want, **GRAD_TOL)


# ---------------------------------------------------------------------------
# (c) the c4 and c12 generators on both engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [4, 12])
def test_generator_matches_jax_on_both_engines(tmp_path, channels):
    """A seeded c4 and c12 generator from a ``.pth`` through
    ``load_generator`` (NHWC) and the packed engine == JAX's forward and
    JAX's packed engine (the XLA formulations of the attention and the
    block), batch 1 at 32^2; no kernel launches on the CPU."""
    module = EnhancedGenerator(channels, 1, generator=torch.Generator()
                               .manual_seed(channels))
    sd = {k: v.detach().numpy().copy()
          for k, v in module.state_dict().items()}
    params = {k: jnp.asarray(v) for k, v in
              enhanced_generator_from_sd(sd).items()}
    x = np.tanh(np.random.default_rng(channels).standard_normal(
        (1, 32, 32, 3))).astype(np.float32)
    ref_nhwc = np.asarray(jax.jit(enhanced_generator_apply)(
        params, jnp.asarray(x)))
    ref_packed = np.asarray(jax.jit(jax_packed_apply)(
        jax_pack_params(params), jnp.asarray(x)))
    path = tmp_path / f"enhanced_c{channels}.pth"
    torch.save({"G_AB_state_dict": state_dict_from_jax_params(params)}, path)
    model = load_generator(path, device="cpu")
    assert (model.kind, model.channels) == ("enhanced", channels)
    K.reset_launch_counts()
    with torch.inference_mode():
        nhwc = model.apply(_t(x)).numpy()
        packed = PackedEnhancedGenerator(model.module).eval()(
            _t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert all(k.launches == 0 for k in K.KERNELS)
    assert np.isfinite(nhwc).all() and nhwc.shape == x.shape
    np.testing.assert_allclose(nhwc, ref_nhwc, atol=GENERATOR_ATOL, rtol=0)
    np.testing.assert_allclose(packed, ref_packed, atol=GENERATOR_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# (d) training steps against JAX
# ---------------------------------------------------------------------------

def test_enhanced_pretrain_step_at_c12_matches_jax(rng):
    """One enhanced pretrain step at c12 (LocalAttention at C = 12, 24, 48;
    the block at dim 48, 1 head of 48), 32^2, batch 2, from the same init
    and a fresh Adam, the port on JAX's mask: the loss at rtol 1e-5."""
    port = pretrain_init_state(3, 12, model="enhanced", num_epochs=2,
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
    _, ploss = pretrain_train_step(port, _t(x), _t(mask))
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=PRETRAIN_RTOL)


# ---------------------------------------------------------------------------
# (e) the route's choice and the launch shapes
# ---------------------------------------------------------------------------

def test_train_route_by_width_against_jax():
    """Every C has a training route. The port chooses by C
    alone: the hand-written pair at C = 1, 2, 4, 8, 16, 32, 64, where JAX's
    ``supports_train_kernel`` holds on a grid whose window count every
    group size divides (128 windows), the fast-VJP route elsewhere. JAX
    also asks 128 / C to divide the window count: at C = 1 a grid of 64
    windows takes JAX's route, and the port's kernel (which has no groups)
    computes the same function there."""
    for C in range(1, 257):
        want = ("kernel" if supports_train_kernel(2, 32, 32, C)
                else "fast_vjp")
        assert K.train_route(C) == want, C
    # past 256 (the LocalAttention widths of c65 .. c128) the route too, and
    # past 512 (c129 on) the route over the streamed kernel
    assert all(K.train_route(C) == "fast_vjp" for C in range(257, 513))
    assert K.train_route(513) == K.train_route(2048) == "fast_vjp"
    assert not supports_train_kernel(1, 32, 32, 1)   # 64 windows
    assert K.train_route(1) == "kernel"


@pytest.mark.parametrize("C", [1, 5, 12, 60, 63, 126, 252])
@pytest.mark.parametrize("bf16", [True, False])
def test_attention_launch_shape_at_any_width_is_its_layouts(C, bf16):
    """A width off the layouts runs in its layout's units and shared
    memory."""
    cp = layout_width(C, bf16)
    assert cp >= C and attention_launch_shape(2048, C, bf16) == \
        attention_launch_shape(2048, cp, bf16)


def test_block_launch_shape_of_the_slot_kernel_and_the_fma_bodies():
    """Every generator's dim that is not a multiple of 32 but c4's 16 (c12,
    .., c60: the EnhancedGenerator has widths c % 4 == 0 only) takes the
    slot kernel in bf16, one window a unit, inside the 227 KB a block may hold
    (the largest with slots of 64: c28's and c52's heads of 56 and 52);
    the other dims up to 256 with heads of at most 64 the FMA bodies, one
    window a block, within the limit too (the largest: dim 248, 4 heads of
    62); those with wider heads run in the streamed chain in bf16."""
    from multi_style_transfer_gan_tpu_torch.ops.kernels.fused_transformer \
        import slot_takes

    slot, fma = {}, {}
    for dim in range(1, 257):
        if dim % 32 == 0 or fused_transformer.stream_takes(dim):
            continue
        units, smem = block_launch_shape(8, 64, 64, dim)
        assert units == 8 * 8 * 8 and smem <= SMEM_LIMIT
        (slot if slot_takes(dim) else fma)[dim] = smem
    assert all(slot_takes(4 * c) for c in range(12, 65, 8))  # c12 .. c60
    assert not slot_takes(16) and 16 in fma
    assert max(slot.values()) == slot[112] == slot[208] == 226304
    assert max(fma, key=fma.get) == 248 and not slot_takes(244)


# ---------------------------------------------------------------------------
# on the card: each new variant against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("C", [1, 3, 5, 7, 12, 60, 63, 126, 252])
def test_attention_kernel_at_any_width(cuda, C, packed, dtype):
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
@pytest.mark.parametrize("channels", MIRROR_BLOCK_CHANNELS)
def test_block_kernel_at_any_dim(cuda, channels, dtype):
    for label, host, weights in smoke.block_stress_inputs(
            np.random.default_rng(channels), (1, 12, 20, 4 * channels)):
        t = lambda a, dt=dtype: _t(np.asarray(a, np.float32)).to(cuda, dt)
        args = (t(host[0]), t(host[1]), t(host[2], torch.float32),
                t(host[3], torch.float32))
        kw = {n: t(a) for n, a in weights.items()}
        got = K.fused_structural_block(*args, **kw)
        _check(got, K.structural_block_plain(*args, **kw), dtype,
               smoke.BLOCK_FP32_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels", MIRROR_BLOCK_CHANNELS)
def test_mhsa_train_kernels_at_any_head_width(cuda, channels, dtype):
    dim = 4 * channels
    shape = (2, 16, 16, 3 * dim)
    for label, host, g in smoke.train_kernel_inputs(
            np.random.default_rng(channels), "mhsa", shape):
        smoke.check_train_kernel("[test]", "mhsa", "block", shape,
                                 default_num_heads(dim), label, host, g,
                                 dtype, cuda, timed=False)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [1, 2, 4])
def test_mid_train_kernels_at_c1_2_4(cuda, C, dtype):
    shape = (2, 16, 16, 3 * C)
    for label, host, g in smoke.train_kernel_inputs(
            np.random.default_rng(C), "attention", shape):
        smoke.check_train_kernel("[test]", "attention", "mid", shape, None,
                                 label, host, g, dtype, cuda, timed=False)
