"""The EnhancedGenerator widths past c128: the kernels' streamed designs, on
the CPU, against the JAX package.

The kernels take those widths as follows (csrc/):

- the channel attention (row 1, and rows 5-7 through its packed-row entry)
  past C = 512 (2C and 4C of c129 on: 516 .. 1024 up to c256, 2048 at c512)
  streams over channels through a workspace: the qkv product into fp32 rows,
  then a block a window and strip of query channels takes the inverse L2
  norms of the window's q and k rows, stages its strip of qn and passes
  over the keys in chunks of 64 (kn and v): the exponentials of the Gram at
  the fixed shift 16 (qn, kn are unit or zero vectors at 16 positions, so
  every logit lies in [-16, 16]), a pad key's at 0, the apply and the row
  sums accumulated over the chunks, divided by the row sums at the end;
  then the proj;
- the block (row 4) in bf16 past dim 512, and at any dim whose heads are
  wider than 64 channels, as a chain through a workspace: LN1 with the
  FiLM, the qkv product, the MHSA a (window, head) at a time in fp32 with
  the head in chunks of 32 channels (the scores summed over the chunks of q
  and k, the output a chunk of v at a time), keys outside a ragged grid at
  -inf, the proj onto the residual stream, LN2, fc1 with the GELU, fc2; in
  fp32
  the FMA bodies, head by head, with the window in a workspace and, past
  dim 512, the residual stream, the proj and the MLP in float64 (as the
  plain version carries them there);
- the window-MHSA mid (row 12) at any head count (64 heads of 32 at c512)
  and heads wider than 64 channels in chunks of 64 (16 of 67 at c268, 16 of
  127 at c508).

Here: (a) plain-PyTorch mirrors of the streamed designs against JAX's
formulations (``_attention_math``, ``_block_body_math``) and the port's
plain versions; (b) JAX's Pallas training kernel in interpret mode
(``window_mhsa_train``) at 32 heads of 32 and 16 heads of 67; (c) the c132
and c256 generators against JAX on the NHWC engine (their packed engines'
repacked fp32 weights, ~9 and ~35 GiB, are held against the CPU on the
card by ``chip_smoke.py``) and c132's packed layers through the plain
versions; (d) one c132 enhanced pretrain step against JAX. Tests marked
``gpu`` hold the kernels against their plain versions on the card; they
skip without a CUDA device.

Tolerances are the existing tests': the attention forward 1e-5 absolute,
the block 2e-4 absolute and relative, the training mids' forwards 1e-5 and
gradients 2e-4, the generators 5e-4 and the pretrain loss rtol 1e-5.
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
from devtools.fp32_step_spread import NarrowOps, lifted_fp32_casts
from multi_style_transfer_gan_tpu.data.dataset import (
    random_patch_mask as jax_random_patch_mask,
)
from multi_style_transfer_gan_tpu.models.enhanced_generator import (
    _attention_math, enhanced_generator_apply,
)
from multi_style_transfer_gan_tpu.models.packed_generator import (
    _attention as jax_packed_attention,
)
from multi_style_transfer_gan_tpu.models.structural_transformer import (
    _block_body_math,
)
from multi_style_transfer_gan_tpu.ops.packed import space_to_depth
from multi_style_transfer_gan_tpu.ops.pallas.window_mhsa_train import (
    window_mhsa_train as jax_mhsa_train,
)
from multi_style_transfer_gan_tpu.train import pretrain as jpretrain
from multi_style_transfer_gan_tpu.weights import enhanced_generator_from_sd
from multi_style_transfer_gan_tpu_torch.core.activations import gelu
from multi_style_transfer_gan_tpu_torch.models import EnhancedGenerator
from multi_style_transfer_gan_tpu_torch.ops import kernels as K
from multi_style_transfer_gan_tpu_torch.ops.kernels import (
    fused_transformer, window_attention,
)
from multi_style_transfer_gan_tpu_torch.ops.kernels.fused_transformer import (
    block_workspace_windows, default_num_heads, stream_takes,
    stream_workspace_windows, weight_shapes, workspace_floats,
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
from test_torch_widths import _check, cuda  # noqa: F401

ATTENTION_ATOL = 1e-5
BLOCK_TOL = dict(atol=2e-4, rtol=2e-4)
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-4, rtol=2e-4)
GENERATOR_ATOL = 5e-4
PRETRAIN_RTOL = 1e-5
CHUNK = 64                    # key channels (row 1), row 12's head channels a pass
BLOCK_CHUNK = 32              # the block chain's head channels a pass
STRIP = 128                   # query channels a block of row 1's bf16 mid
MIRROR_ATTENTION_WIDTHS = (516, 1024)
MIRROR_BLOCK_DIMS = (528, 1024, 1072)
MHSA_DIMS = (1024, 1072)      # 32 heads of 32, 16 heads of 67


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


# ---------------------------------------------------------------------------
# (a) the streamed designs' mirrors against JAX
# ---------------------------------------------------------------------------

def mirror_stream_attention(x, wqkv, bqkv, wproj, bproj, *, eps=1e-12):
    """The streamed attention on NHWC ``x``, in fp32: q, k, v of each
    window's 16 positions as workspace rows; the inverse norms 1 / max(|u|,
    eps) of the q and k rows (a zero row stays zero); per strip of 128 query
    channels, qn of the strip against the keys in chunks of 64 (kn and v
    staged): the Gram's exponentials at the fixed shift 16, 0 past C, the
    apply and the row sums accumulated chunk by chunk, divided at the end;
    the proj on the workspace's output rows."""
    B, H, W, C = x.shape
    t = window_partition(x, 4)                          # (R, 16, C)
    qkv = F.linear(t, wqkv, bqkv)
    q, k, v = qkv.split(C, dim=-1)
    inv = lambda u: 1.0 / torch.clamp_min(u.norm(dim=-1, keepdim=True), eps)
    qn, kn = q * inv(q), k * inv(k)
    out = torch.zeros_like(v)
    for c0 in range(0, C, STRIP):
        strip = qn[..., c0:c0 + STRIP]
        acc = torch.zeros(t.shape[0], 16, strip.shape[-1])
        rows = torch.zeros(t.shape[0], strip.shape[-1])
        for k0 in range(0, C, CHUNK):
            g = strip.transpose(1, 2) @ kn[..., k0:k0 + CHUNK]
            assert g.abs().max() <= 16.0 + 1e-4        # unit or zero vectors
            e = torch.exp(g - 16.0)
            acc = acc + v[..., k0:k0 + CHUNK] @ e.transpose(1, 2)
            rows = rows + e.sum(-1)
        out[..., c0:c0 + STRIP] = acc / rows[:, None, :]
    y = F.linear(out, wproj, bproj)
    return window_merge(y, B, H, W, 4)


@pytest.mark.parametrize("C", MIRROR_ATTENTION_WIDTHS)
def test_streamed_attention_matches_jax(rng, C):
    """The streamed attention at C = 516 (c129's down2: a last strip of 4
    query channels, a last key chunk of 4) and 1024 (c256's down2) == JAX's
    ``_attention_math``, an all-zero window included; so do the port's
    plain versions, NHWC and on packed rows (against JAX's packed engine
    attention)."""
    x = rng.standard_normal((1, 8, 8, C)).astype(np.float32)
    x[0, :4, :4] = 0.0
    ws = _attention_weights(rng, C)
    ref = np.asarray(_attention_math(jnp.asarray(x), *_hwio(*ws),
                                     window_size=4, eps=1e-12))
    args = [_t(a) for a in [x] + ws]
    got = mirror_stream_attention(*args).numpy()
    assert np.isfinite(got).all() and window_attention.stream_windows(4, C)
    np.testing.assert_allclose(got, ref, atol=ATTENTION_ATOL, rtol=0)
    np.testing.assert_allclose(K.window_channel_attention(*args).numpy(), ref,
                               atol=ATTENTION_ATOL, rtol=0)
    rows = np.asarray(space_to_depth(jnp.asarray(x), 4))
    p = dict(zip(("a.qkv.weight", "a.qkv.bias", "a.proj.weight",
                  "a.proj.bias"), (jnp.asarray(ws[0].T), jnp.asarray(ws[1]),
                                   jnp.asarray(ws[2].T), jnp.asarray(ws[3]))))
    packed_ref = np.asarray(jax_packed_attention(p, jnp.asarray(rows), "a."))
    packed = K.packed_window_channel_attention(_t(rows), *args[1:])
    np.testing.assert_allclose(packed.numpy(), packed_ref,
                               atol=ATTENTION_ATOL, rtol=0)


def _chunked_heads(q, k, v, hd, valid=None, chunk=CHUNK):
    """The chunked MHSA of (windows, heads, 64, hd) q, k, v: the scores
    summed over ``chunk``-channel chunks of the head, keys outside the grid
    at -inf, the softmax at scale 1/sqrt(hd), the output a chunk of v at a
    time."""
    s = sum(q[..., c0:c0 + chunk] @ k[..., c0:c0 + chunk].transpose(-2, -1)
            for c0 in range(0, hd, chunk))
    if valid is not None:
        s = s.masked_fill(~valid, float("-inf"))
    p = torch.softmax(s / math.sqrt(hd), dim=-1)
    return torch.cat([p @ v[..., c0:c0 + chunk]
                      for c0 in range(0, hd, chunk)], -1)


def mirror_stream_block(x, struct, gamma, beta, *, norm1_w, norm1_b, qkv_w,
                        qkv_b, proj_w, proj_b, norm2_w, norm2_b, fc1_w, fc1_b,
                        fc2_w, fc2_b, eps=1e-5):
    """The bf16 block chain's arithmetic in fp32 on (B, H, W, C) tokens: the
    grid padded to whole 8x8 windows in window-major rows (a token outside
    the grid as zeros), LN1 of x + struct with the FiLM, the qkv product,
    the chunked MHSA of every (window, head) (chunks of 32 channels) with
    keys outside the grid masked, the proj onto the residual stream, LN2,
    fc1 with the GELU, fc2, y at the tokens inside the grid."""
    B, H, W, C = x.shape
    heads = default_num_heads(C)
    hd = C // heads
    ph, pw = (-H) % 8, (-W) % 8
    pad = lambda a: F.pad(a, (0, 0, 0, pw, 0, ph))
    rows = lambda a: window_partition(pad(a), 8)          # (windows, 64, C)
    h = F.layer_norm(x + struct, (C,), norm1_w, norm1_b, eps)
    h = h * (1 + gamma[:, None, None]) + beta[:, None, None]
    xs, hs = rows(x), rows(h)
    valid = rows(torch.ones(B, H, W, 1))[..., 0] > 0       # (windows, 64)
    qkv = F.linear(hs, qkv_w, qkv_b)
    q, k, v = (u.reshape(u.shape[0], 64, heads, hd).transpose(1, 2)
               for u in qkv.split(C, -1))
    o = _chunked_heads(q, k, v, hd, valid[:, None, None, :], BLOCK_CHUNK)
    xs = xs + F.linear(o.transpose(1, 2).reshape(-1, 64, C), proj_w, proj_b)
    a = gelu(F.linear(F.layer_norm(xs, (C,), norm2_w, norm2_b, eps), fc1_w,
                      fc1_b))
    y = xs + F.linear(a, fc2_w, fc2_b)
    return window_merge(y, B, H + ph, W + pw, 8)[:, :H, :W]


def _block_args(rng, shape):
    B, H, W, C = shape
    host = [rng.standard_normal(shape), rng.standard_normal(shape),
            rng.standard_normal((B, C)) * 0.1, rng.standard_normal((B, C)) * 0.1]
    w = {n: rng.standard_normal(s) * (0.05 if len(s) == 2 else 0.05)
         + (1.0 if n in ("norm1_w", "norm2_w") else 0.0)
         for n, s in weight_shapes(C).items()}
    return ([a.astype(np.float32) for a in host],
            {n: a.astype(np.float32) for n, a in w.items()})


@pytest.mark.parametrize("dim", MIRROR_BLOCK_DIMS)
def test_streamed_block_matches_jax(rng, dim):
    """The bf16 block chain at dims 528 (c132: 16 heads of 33, two chunks a
    head), 1024 (c256: 32 of 32) and 1072 (c268: 16 of 67, three) == JAX's
    ``_block_body_math`` on a ragged 12 x 12 grid (keys outside it masked);
    so does the port's plain version (what the fp32 FMA bodies compute,
    with the residual stream, the proj and the MLP in float64 past 512)."""
    H, W = 12, 12
    host, w = _block_args(rng, (1, H, W, dim))
    ref = np.asarray(jax.jit(functools.partial(
        _block_body_math, grid_hw=(H, W), window=8))(
        *(jnp.asarray(a.reshape(1, H * W, dim)) if i < 2 else jnp.asarray(a)
          for i, a in enumerate(host)),
        *(jnp.asarray(w[n]) for n in fused_transformer.WEIGHT_NAMES)
    )).reshape(1, H, W, dim)
    args = [_t(a) for a in host]
    kw = {n: _t(a) for n, a in w.items()}
    assert stream_takes(dim)
    np.testing.assert_allclose(mirror_stream_block(*args, **kw).numpy(), ref,
                               **BLOCK_TOL)
    np.testing.assert_allclose(K.fused_structural_block(*args, **kw).numpy(),
                               ref, **BLOCK_TOL)


# ---------------------------------------------------------------------------
# (b) row 12 against JAX's Pallas training kernel
# ---------------------------------------------------------------------------

class MirrorChunkedMHSA(torch.autograd.Function):
    """Row 12's chunked design: the forward of ``_chunked_heads`` and the
    hand-written backward with s and dp = dO v^T summed over the chunks and
    dq, dk, dv a chunk at a time."""

    @staticmethod
    def forward(ctx, qkv, heads):
        ctx.heads = heads
        ctx.save_for_backward(qkv)
        B, H, W, C3 = qkv.shape
        q, k, v = _heads(qkv, heads)
        o = _chunked_heads(q, k, v, C3 // 3 // heads)
        return _merge(o, B, H, W)

    @staticmethod
    def backward(ctx, d_out):
        (qkv,) = ctx.saved_tensors
        B, H, W, C3 = qkv.shape
        hd = C3 // 3 // ctx.heads
        scale = hd ** -0.5
        q, k, v = _heads(qkv, ctx.heads)
        (do,) = _heads(d_out, ctx.heads, parts=1)
        chunks = range(0, hd, CHUNK)
        cut = lambda u, c0: u[..., c0:c0 + CHUNK]
        s = sum(cut(q, c) @ cut(k, c).transpose(-2, -1) for c in chunks)
        dp = sum(cut(do, c) @ cut(v, c).transpose(-2, -1) for c in chunks)
        p = torch.softmax(s * scale, dim=-1)
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        grads = [torch.cat([f(c) for c in chunks], -1) for f in (
            lambda c: (ds @ cut(k, c)) * scale,
            lambda c: (ds.transpose(-2, -1) @ cut(q, c)) * scale,
            lambda c: p.transpose(-2, -1) @ cut(do, c))]
        return torch.cat([_merge(g, B, H, W) for g in grads], -1), None


def _heads(t, heads, parts=3):
    """(B, H, W, parts C) -> parts x (windows, heads, 64, hd)."""
    out = []
    for u in t.split(t.shape[-1] // parts, dim=-1):
        w = window_partition(u, 8)
        out.append(w.reshape(w.shape[0], 64, heads, -1).transpose(1, 2))
    return out


def _merge(t, B, H, W):
    n, h, T, hd = t.shape
    return window_merge(t.transpose(1, 2).reshape(n, T, h * hd), B, H, W, 8)


@pytest.mark.parametrize("dim", MHSA_DIMS)
def test_mhsa_chunked_heads_match_jax(rng, dim):
    """Row 12 at 32 heads of 32 (c256's block) and 16 heads of 67 (c268's:
    two chunks a head, the second of 3 channels): the chunked forward and
    the gradient of sum(out^2) == JAX's Pallas ``window_mhsa_train``
    (interpret mode) on two windows; so does the port's plain pair."""
    heads = default_num_heads(dim)
    qkv = rng.standard_normal((1, 8, 16, 3 * dim)).astype(np.float32)
    fn = lambda t: jax_mhsa_train(t, 8, heads, True)
    ref, vjp = jax.block_until_ready(
        jax.jit(lambda t: jax.vjp(fn, t))(jnp.asarray(qkv.copy())))
    (ref_g,) = vjp(2 * ref)   # the gradient of sum(out^2)
    for fn in (MirrorChunkedMHSA.apply, K.window_mhsa_train):
        t = _t(qkv).requires_grad_(True)
        out = fn(t, heads)
        (out ** 2).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                                   **FWD_TOL)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref_g),
                                   **GRAD_TOL)


# ---------------------------------------------------------------------------
# (c) the c132 and c256 generators against JAX
# ---------------------------------------------------------------------------

def _generator_case(tmp_path, channels, size):
    module = EnhancedGenerator(channels, 1, generator=torch.Generator()
                               .manual_seed(channels))
    sd = {k: v.detach().numpy().copy()
          for k, v in module.state_dict().items()}
    params = {k: jnp.asarray(v) for k, v in
              enhanced_generator_from_sd(sd).items()}
    x = np.tanh(np.random.default_rng(channels).standard_normal(
        (1, size, size, 3))).astype(np.float32)
    path = tmp_path / f"enhanced_c{channels}.pth"
    torch.save({"G_AB_state_dict": state_dict_from_jax_params(params)}, path)
    model = load_generator(path, device="cpu")
    assert (model.kind, model.channels) == ("enhanced", channels)
    return params, x, model


@pytest.mark.parametrize("channels", [132, 256])
def test_generator_past_128_matches_jax(tmp_path, channels):
    """A seeded c132 and c256 generator from a ``.pth`` through
    ``load_generator`` == JAX's forward in float64, batch 1 at 64^2 (c256's
    down2 at C = 1024, its block at dim 1024 in 32 heads); no kernel
    launches on the CPU. c132 runs in fp32. c256 runs in float64, every
    operation of it (``lifted_fp32_casts``, ``NarrowOps``): in fp32 its
    ~1e-5 relative rounding (26 convs deep) meets pre-tanh activations of
    up to 42 at this init, and lands 4.4e-4 .. 5.0e-4 from its own float64
    forward and 4.5e-4 .. 5.2e-4 from JAX's by the thread count, JAX's
    fp32 3.4e-4 from JAX's (whose float64 forward keeps its attention
    products in fp32: 7.8e-5 from the port's;
    ``devtools/generator_fp32_spread.py --jax``)."""
    params, x, model = _generator_case(tmp_path, channels, 64)
    with jax.enable_x64(True):
        p64 = {k: jnp.asarray(np.asarray(v), jnp.float64)
               for k, v in params.items()}
        ref = np.asarray(jax.block_until_ready(jax.jit(
            enhanced_generator_apply)(p64, jnp.asarray(x, jnp.float64))))
    assert ref.dtype == np.float64
    K.reset_launch_counts()
    if channels == 256:
        model.module.double()
        x64 = torch.from_numpy(x).double()
        with lifted_fp32_casts(), NarrowOps() as narrow:
            got = model.apply(x64).numpy()
        assert narrow.count == 0 and got.dtype == np.float64
    else:
        got = model.apply(_t(x)).numpy()
    assert all(k.launches == 0 for k in K.KERNELS)
    assert np.isfinite(got).all() and got.shape == x.shape
    np.testing.assert_allclose(got, ref, atol=GENERATOR_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# (d) training against JAX
# ---------------------------------------------------------------------------

def test_enhanced_pretrain_step_at_c132_matches_jax(rng):
    """One enhanced pretrain step at c132 (LocalAttention at C = 132, 264,
    528 on the route; the block at dim 528, 16 heads of 33), 32^2, batch 2,
    from the same init and a fresh Adam, the port on JAX's mask: the loss
    at rtol 1e-5."""
    port = pretrain_init_state(3, 132, model="enhanced", num_epochs=2,
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
# (e) the launch shapes and the workspaces
# ---------------------------------------------------------------------------

def test_workspaces_past_512():
    """Row 1 past C = 512 holds at most 256 MiB of workspace (64 C floats a
    window), at least one window; the bf16 block chain the same (64 x 6C
    floats a window); the fp32 FMA bodies' workspace grows to 4 x 64 x (C
    + 1) floats a window past dim 512 and holds 512 x 512 / C windows of
    whole images."""
    assert window_attention.stream_windows(2048, 1024) == 1024
    assert window_attention.stream_windows(3, 1024) == 3
    assert window_attention.attention_launch_shape(100, 1024, True) == (800, 0)
    assert window_attention.attention_launch_shape(100, 1024, False) == (
        1600, 0)
    assert stream_workspace_windows(16, 64, 64, 1024) == 170
    assert stream_workspace_windows(1, 8, 8, 2048) == 1
    assert workspace_floats(512) == 3 * 64 * 513
    assert workspace_floats(1024) == 4 * 64 * 1025
    assert block_workspace_windows(8, 64, 64, 1024, fp32=True) == 256
    assert block_workspace_windows(1, 248, 188, 1024, fp32=True) == 31 * 24
    assert block_workspace_windows(8, 64, 64, 1024, fp32=False) == 0
    # c268's dim in heads of 67, and a dim up to 256 with a head wider than
    # 64 (254: 2 heads of 127), take the chain in bf16 and the workspace in
    # fp32
    for dim in (1072, 254):
        assert stream_takes(dim) and fused_transformer.kernel_takes(dim)
        assert block_workspace_windows(1, 8, 8, dim, fp32=True) == 1
    assert not stream_takes(512) and not stream_takes(256)
    assert fused_transformer.block_launch_shape(2, 16, 16, 1072) == (
        2 * 4 * 16, 0)


# ---------------------------------------------------------------------------
# on the card: the kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("C", [516, 768, 1024, 2048])
def test_streamed_attention_kernel_matches_plain(cuda, C, packed, dtype):
    """NHWC and packed entry points vs plain past C = 512 on the three
    stress inputs, each with an all-zero window; one launch a call."""
    fn, plain = ((K.packed_window_channel_attention,
                  K.packed_window_channel_attention_plain) if packed else
                 (K.window_channel_attention, K.window_channel_attention_plain))
    for label, x, ws in smoke.attention_stress_inputs(
            np.random.default_rng(3), (2, 16, 16, C), packed=packed):
        args = [_t(np.asarray(a, np.float32)).to(cuda, dtype)
                for a in [x] + ws]
        n0 = fn.launches
        got = fn(*args)
        torch.cuda.synchronize()
        assert fn.launches == n0 + 1
        _check(got, plain(*args), dtype, smoke.FP32_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 16, 528), (1, 12, 20, 1024),
                                   (1, 16, 16, 1072), (1, 8, 8, 2048)])
def test_streamed_block_kernel_matches_plain(cuda, shape, dtype):
    """The block past dim 512 (the bf16 chain, the fp32 FMA bodies in the
    workspace) vs plain on the stress inputs, a ragged grid among them."""
    for label, host, weights in smoke.block_stress_inputs(
            np.random.default_rng(4), shape):
        t = lambda a, dt=dtype: _t(np.asarray(a, np.float32)).to(cuda, dt)
        args = (t(host[0]), t(host[1]), t(host[2], torch.float32),
                t(host[3], torch.float32))
        kw = {n: t(a) for n, a in weights.items()}
        got = K.fused_structural_block(*args, **kw)
        _check(got, K.structural_block_plain(*args, **kw), dtype,
               smoke.BLOCK_FP32_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", [1024, 1072, 2032, 2048])
def test_mhsa_kernels_at_any_heads_match_plain(cuda, dim, dtype):
    """Row 12 forward and backward vs plain at 32 heads of 32, 16 of 67, 16
    of 127 and 64 of 32."""
    heads = default_num_heads(dim)
    rng = np.random.default_rng(5)
    qkv = _t(rng.standard_normal((1, 16, 16, 3 * dim)).astype(np.float32))
    do = _t(rng.standard_normal((1, 16, 16, dim)).astype(np.float32))
    qkv, do = qkv.to(cuda, dtype), do.to(cuda, dtype)
    tol = 1e-5 if dtype == torch.float32 else None
    _check(K.window_mhsa_fwd(qkv, heads), K.window_mhsa_plain(qkv, heads),
           dtype, tol)
    _check(K.window_mhsa_bwd(qkv, do, heads),
           K.window_mhsa_backward_plain(qkv, do, heads), dtype, 2e-4)
