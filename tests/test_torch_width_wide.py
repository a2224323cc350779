"""The EnhancedGenerator widths past 64 (c65 .. c128): the kernels' new
layouts, on the CPU, against the JAX package.

The kernels take those widths as follows (csrc/):

- the channel attention (row 1, and rows 5-7 through its packed-row entry)
  at C = 257 .. 512 (4C of c65 .. c128) in the layout of 512 channels: one
  window a block, zero pad channels, the weights streamed in tiles of 64
  rows of half the width (the products summed over the two halves), the
  exponentials at the fixed shift 16 (qn and kn are unit or zero vectors at
  16 positions, so every logit lies in [-16, 16]) with a pad key's at 0, the
  apply over keys in chunks of 64 with running row sums and no running max,
  divided by the row sums at the end;
- the block (row 4) at the dims 260 .. 512: in bf16 the pair kernel, a
  cluster of two blocks a window, each on the 32 tokens of window rows 0-3
  or 4-7, the residual stream and every weight, bias, norm and FiLM entry
  in 512 channels (zero past C), both LayerNorms over the real dim, each of
  the 8 .. 16 heads in a slot of hd rounded up to 16 (32, 48, 64), the
  scale 1/sqrt(hd), the k and v tiles of both halves exchanged, the proj in
  four blocks of 128 output rows, the MLP in chunks of 64 hidden columns;
  in fp32 the FMA bodies, head by head, with the window's residual stream
  and LN output in a workspace;
- the window-MHSA mid (row 12) at 9 .. 16 heads: nothing in a block grows
  with the head count (a block is one window and one head).

Here: (a) plain-PyTorch mirrors of those layouts against JAX's
formulations (``_attention_math``, ``_block_body_math``) and its Pallas
training kernel in interpret mode (``window_mhsa_train``); (b) the c68 and
c128 generators against JAX (c68 on both engines; c128 on the NHWC
engine: its packed engine's repacked fp32 weights are 8.8 GiB a framework,
which the card's run holds against the CPU instead); (c) one c72 enhanced
pretrain step against JAX; (d) the launch shapes and the workspace. Tests
marked ``gpu`` hold the kernels against their plain versions on the card;
they skip without a CUDA device.

Tolerances are the existing tests': the attention forward 1e-5 absolute
(``test_torch_widths.py``), the block 2e-4 absolute and relative
(``test_torch_c64.py``), the training mids' forwards 1e-5 and gradients
2e-4 (``test_torch_train_widths.py``), the generators 5e-4 and the
pretrain loss rtol 1e-5.
"""

import functools
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
    block_launch_shape, block_workspace_windows, default_num_heads,
    pair_takes, weight_shapes,
)
from multi_style_transfer_gan_tpu_torch.ops.kernels.window_attention import (
    attention_launch_shape, layout_width,
)
from multi_style_transfer_gan_tpu_torch.ops.kernels.window_attention_train import (
    window_merge, window_partition,
)
from multi_style_transfer_gan_tpu_torch.pipelines import load_generator
from multi_style_transfer_gan_tpu_torch.train import (
    pretrain_init_state, pretrain_train_step,
)
from multi_style_transfer_gan_tpu_torch.weights import (
    state_dict_from_jax_params,
)
from test_torch_width_any import MirrorMHSA
from test_torch_widths import _check, cuda  # noqa: F401

ATTENTION_ATOL = 1e-5
BLOCK_TOL = dict(atol=2e-4, rtol=2e-4)
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-4, rtol=2e-4)
GENERATOR_ATOL = 5e-4
PRETRAIN_RTOL = 1e-5
SMEM_LIMIT = 227 * 1024
CP = 512                      # the attention layout past 256
DP = 512                      # the pair kernel's residual width
MIRROR_ATTENTION_WIDTHS = (272, 384, 512)
MIRROR_BLOCK_DIMS = (272, 288, 464, 512)
MHSA_DIMS = (288, 416, 512)   # 9, 13 and 16 heads of 32
KERNEL_ATTENTION_WIDTHS = (257, 272, 384, 500, 512)
KERNEL_BLOCK_DIMS = (260, 264, 272, 288, 416, 464, 480, 512)


def _t(a):
    return torch.from_numpy(np.array(a))


def _attention_weights(rng, C):
    return [(rng.standard_normal(s) * sc).astype(np.float32)
            for s, sc in (((3 * C, C), 0.1), ((3 * C,), 1.0), ((C, C), 0.1),
                          ((C,), 1.0))]


def _hwio(wqkv, bqkv, wproj, bproj):
    """PyTorch (out, in) 1x1 weights as JAX's HWIO kernels."""
    return (jnp.asarray(wqkv.T[None, None]), jnp.asarray(bqkv),
            jnp.asarray(wproj.T[None, None]), jnp.asarray(bproj))


def mirror_wide_attention(x, wqkv, bqkv, wproj, bproj, *, eps=1e-12):
    """The attention kernel's layout of 512 channels on NHWC ``x``, in
    fp32: each window's 16 positions in CP channels, zeros in x, the
    weights and the biases past C; q, k, v as the products of two
    half-width weight tiles summed; qn, kn zero-safe unit vectors; the
    exponentials of the Gram at the fixed shift 16 (0 at the pad keys),
    the apply and the row sums accumulated over keys in chunks of 64, the
    apply divided by the row sums; the proj over the two halves of out; y
    cut back to C."""
    B, H, W, C = x.shape
    t = F.pad(window_partition(x, 4), (0, CP - C))
    wq = torch.zeros(3, CP, CP)
    wq[:, :C, :C] = wqkv.reshape(3, C, C)
    bq = torch.zeros(3, CP)
    bq[:, :C] = bqkv.reshape(3, C)
    wp, bp = torch.zeros(CP, CP), torch.zeros(CP)
    wp[:C, :C], bp[:C] = wproj, bproj
    half = CP // 2
    halves = lambda a, w: sum(a[..., h:h + half] @ w[:, h:h + half].T
                              for h in (0, half))
    q, k, v = (halves(t, wq[i]) + bq[i] for i in range(3))
    norm = lambda u: u / torch.clamp_min(u.norm(dim=-1, keepdim=True), eps)
    gram = norm(q).transpose(1, 2) @ norm(k)          # (R, CP, CP)
    assert gram.abs().max() <= 16.0 + 1e-4            # unit or zero vectors
    e = torch.exp(gram - 16.0)
    e[..., C:] = 0.0
    out = torch.zeros_like(v)
    rows = torch.zeros(gram.shape[:2])
    for k0 in range(0, CP, 64):
        chunk = e[..., k0:k0 + 64]
        out = out + v[..., k0:k0 + 64] @ chunk.transpose(1, 2)
        rows = rows + chunk.sum(-1)
    out = out / rows[:, None, :]
    y = (halves(out, wp) + bp)[..., :C]
    return window_merge(y, B, H, W, 4)


@pytest.mark.parametrize("C", MIRROR_ATTENTION_WIDTHS)
def test_wide_attention_layout_matches_jax(rng, C):
    """The attention kernel's layout of 512 channels at C = 272, 384, 512
    (c68's, c96's and c128's down2) == JAX's ``_attention_math``, an
    all-zero window included; so does the port's plain version."""
    x = rng.standard_normal((1, 8, 8, C)).astype(np.float32)
    x[0, :4, :4] = 0.0
    ws = _attention_weights(rng, C)
    ref = np.asarray(_attention_math(jnp.asarray(x), *_hwio(*ws),
                                     window_size=4, eps=1e-12))
    args = [_t(a) for a in [x] + ws]
    got = mirror_wide_attention(*args).numpy()
    assert np.isfinite(got).all() and layout_width(C, True) == CP
    np.testing.assert_allclose(got, ref, atol=ATTENTION_ATOL, rtol=0)
    np.testing.assert_allclose(K.window_channel_attention(*args).numpy(), ref,
                               atol=ATTENTION_ATOL, rtol=0)


def mirror_pair_block(x, struct, gamma, beta, *, norm1_w, norm1_b, qkv_w,
                      qkv_b, proj_w, proj_b, norm2_w, norm2_b, fc1_w, fc1_b,
                      fc2_w, fc2_b, eps=1e-5):
    """The pair kernel's layout (``fused_structural_block_pair_kernel``) on
    an 8x8-multiple grid of (B, H, W, C) tokens, in fp32: each window split
    into the halves of window rows 0-3 and 4-7 (the two blocks of a
    cluster), every per-token step on a half alone; the residual stream and
    every weight, bias, norm and FiLM entry in DP channels, zero past C;
    both LayerNorms over the C real channels; each head in a slot of S = hd
    rounded up to 16, one at a time at the scale 1/sqrt(hd): q of the half,
    k and v of both halves (the exchange), the head's share of the proj in
    four blocks of 128 output rows onto the stream; the MLP's 4C hidden
    columns in chunks of 64, zero past 4C; y cut back to C."""
    B, H, W, C = x.shape
    heads = default_num_heads(C)
    hd = C // heads
    S = -(-hd // 16) * 16

    def pad(a, *dims):
        out = torch.zeros(*dims)
        out[tuple(slice(0, n) for n in a.shape)] = a
        return out

    hidden = -(-4 * C // 64) * 64
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
    halves = (slice(0, 32), slice(32, 64))
    hs = [h[:, r] for r in halves]
    xs = [xr[:, r] for r in halves]
    for hh in range(heads):
        w, b = torch.zeros(3, S, DP), torch.zeros(3, S)
        for p in range(3):
            w[p, :hd, :C] = qkv_w[p * C + hh * hd:p * C + (hh + 1) * hd]
            b[p, :hd] = qkv_b[p * C + hh * hd:p * C + (hh + 1) * hd]
        qkv = [[F.linear(hh_, w[p], b[p]) for p in range(3)] for hh_ in hs]
        k = torch.cat([qkv[0][1], qkv[1][1]], 1)      # both halves' keys
        v = torch.cat([qkv[0][2], qkv[1][2]], 1)
        wp = torch.zeros(DP, S)
        wp[:C, :hd] = proj_w[:, hh * hd:(hh + 1) * hd]
        for i in range(2):
            o = torch.softmax(qkv[i][0] @ k.transpose(1, 2) / math.sqrt(hd),
                              -1) @ v
            xs[i] = xs[i] + torch.cat([F.linear(o, wp[o0:o0 + 128])
                                       for o0 in range(0, DP, 128)], -1)
    f1w, f1b = pad(fc1_w, hidden, DP), pad(fc1_b, hidden)
    f2w = pad(fc2_w, DP, hidden)
    for i in range(2):
        hn = ln(xs[i], n2w, n2b)
        xs[i] = xs[i] + pad(fc2_b, DP)
        for h0 in range(0, hidden, 64):
            a = gelu(F.linear(hn, f1w[h0:h0 + 64], f1b[h0:h0 + 64]))
            xs[i] = xs[i] + F.linear(a, f2w[:, h0:h0 + 64])
    return window_merge(torch.cat(xs, 1), B, H, W, 8)[..., :C]


def _block_args(rng, shape):
    B, H, W, C = shape
    host = [rng.standard_normal(shape), rng.standard_normal(shape),
            rng.standard_normal((B, C)) * 0.1, rng.standard_normal((B, C)) * 0.1]
    w = {n: rng.standard_normal(s) * (0.1 if len(s) == 2 else 0.05)
         + (1.0 if n in ("norm1_w", "norm2_w") else 0.0)
         for n, s in weight_shapes(C).items()}
    return ([a.astype(np.float32) for a in host],
            {n: a.astype(np.float32) for n, a in w.items()})


@pytest.mark.parametrize("dim", MIRROR_BLOCK_DIMS)
def test_pair_block_layout_matches_jax(rng, dim):
    """The pair kernel's layout at dims 272 (c68: 8 heads of 34 in slots of
    48), 288 (c72: 9 of 32), 464 (c116: 8 of 58 in slots of 64) and 512
    (c128: 16 of 32) == JAX's ``_block_body_math`` on an 8 x 16 grid; so
    does the port's plain version (what the FMA bodies compute, head by
    head, with no pads)."""
    host, w = _block_args(rng, (1, 8, 16, dim))
    ref = np.asarray(jax.jit(functools.partial(
        _block_body_math, grid_hw=(8, 16), window=8))(
        *(jnp.asarray(a.reshape(1, 128, dim)) if i < 2 else jnp.asarray(a)
          for i, a in enumerate(host)),
        *(jnp.asarray(w[n]) for n in fused_transformer.WEIGHT_NAMES)
    )).reshape(1, 8, 16, dim)
    args = [_t(a) for a in host]
    kw = {n: _t(a) for n, a in w.items()}
    assert pair_takes(dim)
    np.testing.assert_allclose(mirror_pair_block(*args, **kw).numpy(), ref,
                               **BLOCK_TOL)
    np.testing.assert_allclose(K.fused_structural_block(*args, **kw).numpy(),
                               ref, **BLOCK_TOL)


@pytest.mark.parametrize("dim", MHSA_DIMS)
def test_mhsa_past_8_heads_matches_jax(rng, dim):
    """Row 12 at 9, 13 and 16 heads of 32 (the blocks of c72, c104 and
    c128): the slot layout's forward and the gradient of sum(out^2) ==
    JAX's Pallas ``window_mhsa_train`` (interpret mode); so does the port's
    plain pair."""
    heads = default_num_heads(dim)
    assert heads == dim // 32 > 8
    qkv = rng.standard_normal((1, 8, 16, 3 * dim)).astype(np.float32)
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


# ---------------------------------------------------------------------------
# (b) the c68 and c128 generators against JAX
# ---------------------------------------------------------------------------

def _generator_case(tmp_path, channels):
    module = EnhancedGenerator(channels, 1, generator=torch.Generator()
                               .manual_seed(channels))
    sd = {k: v.detach().numpy().copy()
          for k, v in module.state_dict().items()}
    params = {k: jnp.asarray(v) for k, v in
              enhanced_generator_from_sd(sd).items()}
    x = np.tanh(np.random.default_rng(channels).standard_normal(
        (1, 32, 32, 3))).astype(np.float32)
    path = tmp_path / f"enhanced_c{channels}.pth"
    torch.save({"G_AB_state_dict": state_dict_from_jax_params(params)}, path)
    model = load_generator(path, device="cpu")
    assert (model.kind, model.channels) == ("enhanced", channels)
    return params, x, model


@pytest.mark.parametrize("channels", [68, 128])
def test_wide_generator_matches_jax(tmp_path, channels):
    """A seeded c68 and c128 generator from a ``.pth`` through
    ``load_generator`` == JAX's forward (the XLA formulations of the
    attention and the block), batch 1 at 32^2; no kernel launches on the
    CPU."""
    params, x, model = _generator_case(tmp_path, channels)
    ref = np.asarray(jax.jit(enhanced_generator_apply)(params, jnp.asarray(x)))
    K.reset_launch_counts()
    with torch.inference_mode():
        got = model.apply(_t(x)).numpy()
    assert all(k.launches == 0 for k in K.KERNELS)
    assert np.isfinite(got).all() and got.shape == x.shape
    np.testing.assert_allclose(got, ref, atol=GENERATOR_ATOL, rtol=0)


def test_c68_packed_engine_matches_jax(tmp_path):
    """The c68 generator's packed engine (2.5 GiB of repacked fp32
    weights) == JAX's packed engine, batch 1 at 32^2."""
    params, x, model = _generator_case(tmp_path, 68)
    ref = np.asarray(jax.jit(jax_packed_apply)(jax_pack_params(params),
                                                jnp.asarray(x)))
    with torch.inference_mode():
        packed = PackedEnhancedGenerator(model.module).eval()(
            _t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(packed, ref, atol=GENERATOR_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# (c) training against JAX
# ---------------------------------------------------------------------------

def test_enhanced_pretrain_step_at_c72_matches_jax(rng):
    """One enhanced pretrain step at c72 (LocalAttention at C = 72, 144,
    288; the block at dim 288, 9 heads of 32), 32^2, batch 2, from the same
    init and a fresh Adam, the port on JAX's mask: the loss at rtol 1e-5."""
    port = pretrain_init_state(3, 72, model="enhanced", num_epochs=2,
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
# (d) the launch shapes and the workspace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bf16", [True, False])
def test_attention_launch_shape_past_256(bf16):
    """Every C from 257 to 512 runs in the layout of 512 channels, one
    window a unit, inside the 227 KB a block may hold; past 512 no layout
    holds a window, and the op streams through a workspace (its mid a block
    a window and strip of query channels, static shared memory only)."""
    for C in range(257, 513):
        units, smem = attention_launch_shape(1000, C, bf16)
        assert layout_width(C, bf16) == CP and units == 1000
        assert smem <= SMEM_LIMIT
    assert attention_launch_shape(1, 512, True)[1] == 208384
    assert window_attention.kernel_takes(512)
    assert window_attention.stream_windows(1000, 512) == 0
    assert window_attention.kernel_takes(513)
    assert window_attention.stream_windows(1000, 513) == 1000
    assert attention_launch_shape(1000, 513, bf16) == (
        1000 * (5 if bf16 else 9), 0)


def test_pair_block_launch_shape_and_widths():
    """The pair kernel takes every dim % 4 == 0 from 260 to 512 whose heads
    are at most 64 channels wide in bf16 (a cluster of two blocks a window,
    each inside the limit: the largest at slots of 64, the dims whose heads
    are 49 .. 64 wide), and no dim past 512: the streamed chain takes those
    (and the dims between with wider heads)."""
    taken = [d for d in range(257, 600) if pair_takes(d)]
    assert taken == [d for d in range(260, 513, 4)
                     if d // default_num_heads(d) <= 64]
    assert all(fused_transformer.stream_takes(d) != pair_takes(d)
               for d in range(257, 600))
    smem = {}
    for dim in taken:
        units, smem[dim] = block_launch_shape(8, 64, 64, dim)
        assert pair_takes(dim) and units == 8 * 8 * 8
        assert smem[dim] <= SMEM_LIMIT
    assert max(smem.values()) == smem[464] == 222208


def test_block_workspace_is_fp32_past_256_only():
    """The fp32 FMA bodies past dim 256 hold each window's residual stream
    and LN output in a workspace of whole images of at most 512 windows (at
    least one image); nothing else asks for one."""
    assert block_workspace_windows(8, 64, 64, 512, fp32=True) == 512
    assert block_workspace_windows(64, 64, 64, 512, fp32=True) == 512
    assert block_workspace_windows(1, 248, 188, 272, fp32=True) == 31 * 24
    assert block_workspace_windows(2, 12, 20, 260, fp32=True) == 2 * 2 * 3
    assert block_workspace_windows(8, 64, 64, 512, fp32=False) == 0
    assert block_workspace_windows(8, 64, 64, 256, fp32=True) == 0


# ---------------------------------------------------------------------------
# on the card: each new variant against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("C", KERNEL_ATTENTION_WIDTHS)
def test_attention_kernel_past_256(cuda, C, packed, dtype):
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
@pytest.mark.parametrize("dim", KERNEL_BLOCK_DIMS)
def test_block_kernel_past_256(cuda, dim, dtype):
    for grid in ((2, 16, 16, dim), (1, 12, 20, dim)):
        for label, host, weights in smoke.block_stress_inputs(
                np.random.default_rng(dim), grid):
            t = lambda a, dt=dtype: _t(np.asarray(a, np.float32)).to(cuda, dt)
            args = (t(host[0]), t(host[1]), t(host[2], torch.float32),
                    t(host[3], torch.float32))
            kw = {n: t(a) for n, a in weights.items()}
            got = K.fused_structural_block(*args, **kw)
            _check(got, K.structural_block_plain(*args, **kw), dtype,
                   smoke.BLOCK_FP32_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", KERNEL_BLOCK_DIMS)
def test_mhsa_train_kernels_past_8_heads(cuda, dim, dtype):
    shape = (2, 16, 16, 3 * dim)
    for label, host, g in smoke.train_kernel_inputs(
            np.random.default_rng(dim), "mhsa", shape):
        smoke.check_train_kernel("[test]", "mhsa", "block", shape,
                                 default_num_heads(dim), label, host, g,
                                 dtype, cuda, timed=False)


@pytest.mark.gpu
@pytest.mark.parametrize("dim", smoke.MANY_WINDOW_BLOCK_DIMS)
def test_block_kernel_on_more_windows_than_blocks(cuda, dim):
    """bf16 at the dims whose windows have an odd count of weight tiles,
    on 512 windows: each block (or pair) copies its next window's first
    tile while it reads this window's last one, into the other buffer."""
    label, host, weights = smoke.block_stress_inputs(
        np.random.default_rng(dim), smoke.MANY_WINDOW_GRID + (dim,))[0]
    t = lambda a, dt=torch.bfloat16: _t(np.asarray(a, np.float32)).to(cuda, dt)
    args = (t(host[0]), t(host[1]), t(host[2], torch.float32),
            t(host[3], torch.float32))
    kw = {n: t(a) for n, a in weights.items()}
    got = K.fused_structural_block(*args, **kw)
    _check(got, K.structural_block_plain(*args, **kw), torch.bfloat16,
           smoke.BLOCK_FP32_TOL)


@pytest.mark.gpu
def test_block_fp32_past_256_counts_a_launch_a_slice(cuda):
    """fp32 past dim 256 launches once a slice of the images the workspace
    holds (8 images of 64 windows at 64^2), and counts each launch."""
    dim, grid = 272, (17, 64, 64)
    label, host, weights = smoke.block_stress_inputs(
        np.random.default_rng(dim), grid + (dim,))[0]
    t = lambda a: _t(np.asarray(a, np.float32)).to(cuda)
    kw = {n: t(a) for n, a in weights.items()}
    n0 = K.fused_structural_block.launches
    got = K.fused_structural_block(*(t(a) for a in host), **kw)
    torch.cuda.synchronize()
    assert K.fused_structural_block.launches == n0 + 3
    _check(got, K.structural_block_plain(*(t(a) for a in host), **kw),
           torch.float32, smoke.BLOCK_FP32_TOL)
