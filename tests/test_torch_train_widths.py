"""Training at the c8 and c32 generators' widths: on the CPU against the JAX
package, and on the card against the CPU.

The c16 generator trains LocalAttention at C = 16, 32, 64 and a 64-wide
block of 2 heads (``test_torch_train_kernels.py``). The c8 and c32
generators add: the channel-attention mid (row 11) at C = 8, the
window-MHSA mid (row 12) at 1 head (dim 32) and 4 heads (dim 128), and c32's
down2 at C = 128, which has no training kernel in the JAX package either
and trains through ``window_channel_attention_fast_vjp`` (JAX's
``_attention_fast_vjp``). Here: the plain mid and the module's training
route at C = 8 against the Pallas training kernel (interpret mode) and
``_attention_math`` under ``jax.grad``; the plain MHSA mid against the
Pallas one at the new head counts; the C = 128 Function against
``local_attention_apply(fast=False)``; the routing by width under grad on
a non-CPU tensor; one CycleGAN step at c8 and at c32 and one enhanced
pretrain step at c8 against JAX; ``--no_fast_attention`` against JAX's
``fast_attention=False`` step. Tests marked ``gpu`` hold the kernels and
the steps on the card against the CPU; they skip without a CUDA device.

Tolerances: forwards 1e-5 and gradients 2e-4 (absolute and relative)
against JAX, as ``test_torch_train_kernels.py``; the steps' losses at rtol
2e-4 and the spectral-norm u at 1e-5, as ``test_torch_train.py``; the
pretrain loss at rtol 1e-5, as ``test_torch_pretrain.py``.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke as smoke
from multi_style_transfer_gan_tpu.data.dataset import (
    random_patch_mask as jax_random_patch_mask,
)
from multi_style_transfer_gan_tpu.models.enhanced_generator import (
    _attention_math, local_attention_apply,
)
from multi_style_transfer_gan_tpu.ops.pallas.window_attention_train import (
    window_channel_attention_train as jax_attention_train,
)
from multi_style_transfer_gan_tpu.ops.pallas.window_mhsa_train import (
    window_mhsa_train as jax_mhsa_train,
)
from multi_style_transfer_gan_tpu.train import pretrain as jpretrain
from multi_style_transfer_gan_tpu.train.cyclegan import (
    CycleGANState as JaxCycleGANState, cyclegan_train_step as jax_train_step,
    make_optimizers as jax_make_optimizers,
)
from multi_style_transfer_gan_tpu.weights import (
    discriminator_from_sd, enhanced_generator_from_sd,
)
import multi_style_transfer_gan_tpu_torch.models.enhanced_generator as eg
import multi_style_transfer_gan_tpu_torch.models.structural_transformer as st
from multi_style_transfer_gan_tpu_torch.models import (
    LocalAttention, StructuralTransformerBlock,
)
from multi_style_transfer_gan_tpu_torch.ops import kernels as K
from multi_style_transfer_gan_tpu_torch.ops.kernels import (
    window_attention_mid_backward_plain, window_channel_attention_fast_vjp,
    window_mhsa_train,
)
from multi_style_transfer_gan_tpu_torch.ops.kernels import (
    window_attention_train as WA,
)
from multi_style_transfer_gan_tpu_torch.train import (
    cyclegan_init_state, cyclegan_train_step, pretrain_init_state,
    pretrain_train_step,
)

FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-4, rtol=2e-4)
STEP_RTOL, U_ATOL, PRETRAIN_RTOL = 2e-4, 1e-5, 1e-5
KEYS = ("d_loss", "g_loss", "cycle_loss", "identity_loss", "structure_loss")
WEIGHTS = ("qkv.weight", "qkv.bias", "proj.weight", "proj.bias")


def _attn_case(rng, shape, stress):
    """x and JAX-layout LocalAttention weights (1x1 HWIO kernels). Every
    case has an all-zero window under zero q and k biases (q = k = 0 there);
    "saturated" scales the last batch entry by 8; "small" scales the window
    below the zero one by 1e-3 (|q|, |k| ~ 1e-3)."""
    C = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w = {"qkv.weight": rng.standard_normal((1, 1, C, 3 * C)) * 0.1,
         "qkv.bias": rng.standard_normal(3 * C),
         "proj.weight": rng.standard_normal((1, 1, C, C)) * 0.1,
         "proj.bias": rng.standard_normal(C)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x[0, :4, :4] = 0.0
    w["qkv.bias"][:2 * C] = 0.0
    if stress == "saturated":
        x[-1] *= 8.0
    elif stress == "small":
        x[0, 4:8, :4] *= 1e-3
    return x, w


def _jax_grads(fn, x, w):
    """fn's output and the five gradients of sum(out^2) (JAX layouts)."""
    args = (jnp.asarray(x), *(jnp.asarray(w[k]) for k in WEIGHTS))
    out = fn(*args)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a) ** 2),
                     argnums=tuple(range(5)))(*args)
    flat = lambda g, i: np.asarray(g)[0, 0] if i in (1, 3) else np.asarray(g)
    return np.asarray(out), [flat(g, i) for i, g in enumerate(grads)]


def _assert_matches(got, grads, ref, ref_grads):
    np.testing.assert_allclose(got, ref, **FWD_TOL)
    for ours, want in zip(grads, ref_grads):
        assert np.isfinite(ours).all()
        np.testing.assert_allclose(ours, want, **GRAD_TOL)


def _module_route(w, x):
    """The LocalAttention module's training route on the CPU: output and the
    five gradients of sum(y^2), in JAX layouts."""
    C = w["proj.bias"].shape[0]
    m = LocalAttention(C)
    with torch.no_grad():
        m.qkv.weight.copy_(torch.from_numpy(w["qkv.weight"][0, 0].T[..., None, None]))
        m.qkv.bias.copy_(torch.from_numpy(w["qkv.bias"]))
        m.proj.weight.copy_(torch.from_numpy(w["proj.weight"][0, 0].T[..., None, None]))
        m.proj.bias.copy_(torch.from_numpy(w["proj.bias"]))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = m(xt)
    (y ** 2).sum().backward()
    return (y.detach().permute(0, 2, 3, 1).numpy(),
            [xt.grad.permute(0, 2, 3, 1).numpy(),
             m.qkv.weight.grad[:, :, 0, 0].T.numpy(), m.qkv.bias.grad.numpy(),
             m.proj.weight.grad[:, :, 0, 0].T.numpy(),
             m.proj.bias.grad.numpy()])


# ---------------------------------------------------------------------------
# row 11 at C = 8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stress", ["zero-window", "saturated", "small"])
def test_local_attention_train_route_at_c8_matches_jax(rng, stress):
    """The module's training route at C = 8 (1x1 convs in autograd around
    the plain mid) == JAX window_channel_attention_train (Pallas, interpret
    mode; 16 windows a group at C = 8) and == _attention_math under
    jax.grad: the forward and all five gradients."""
    x, w = _attn_case(rng, (2, 16, 32, 8), stress)
    got, grads = _module_route(w, x)
    for fn in (lambda *a: jax_attention_train(*a, interpret=True),
               lambda *a: _attention_math(*a, window_size=4, eps=1e-12)):
        _assert_matches(got, grads, *_jax_grads(fn, x, w))


@pytest.mark.parametrize("stress", [None, "saturated", "small"])
def test_attention_plain_backward_at_c8_matches_autograd(rng, stress):
    """The plain backward's formulas (float64 inside) == autograd of the
    plain forward's formulas carried in float64 at C = 8, with an all-zero
    window (finite gradients); the plain forward itself is fp32, whose
    rounding the small window's gradients (~1e3) would magnify."""
    inputs = dict((label, (q, g)) for label, q, g in smoke.train_kernel_inputs(
        rng, "attention", (2, 8, 12, 24)))
    qkv, g = (torch.from_numpy(a) for a in inputs[
        {None: "random", "saturated": "saturated", "small": "small q, k"}[stress]])
    t = qkv.double().requires_grad_(True)
    _, _, v, s, _ = WA._split_windows(t, 1e-12, torch.float64)
    out = WA.window_merge(v @ s.transpose(1, 2), *qkv.shape[:3], WA.WINDOW)
    (out * g.double()).sum().backward()
    ours = window_attention_mid_backward_plain(qkv, g)
    assert torch.isfinite(ours).all()
    torch.testing.assert_close(ours.double(), t.grad, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# row 12 at 1 and 4 heads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,heads", [(32, 1), (128, 4)])
def test_window_mhsa_train_at_the_new_heads_matches_jax(rng, C, heads):
    qkv = rng.standard_normal((2, 8, 16, 3 * C)).astype(np.float32)
    ref = jax_mhsa_train(jnp.asarray(qkv), 8, heads, True)
    ref_g = jax.grad(lambda t: jnp.sum(jax_mhsa_train(t, 8, heads, True) ** 2))(
        jnp.asarray(qkv))
    t = torch.from_numpy(qkv).requires_grad_(True)
    out = window_mhsa_train(t, heads)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **FWD_TOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref_g), **GRAD_TOL)


# ---------------------------------------------------------------------------
# C = 128: JAX's route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stress", ["zero-window", "saturated", "small"])
def test_fast_vjp_matches_jax_attention_math(rng, stress):
    """window_channel_attention_fast_vjp at C = 128 on the CPU (its forward
    the plain version, its backward the VJP of the plain version) ==
    local_attention_apply(fast=False) under jax.grad: the forward and the
    five gradients."""
    x, w = _attn_case(rng, (1, 8, 8, 128), stress)
    params = {f"a.{k}": jnp.asarray(v) for k, v in w.items()}
    ref, ref_grads = _jax_grads(
        lambda x_, *ws: local_attention_apply(
            dict(zip(params, ws)), x_, prefix="a.", fast=False), x, w)
    tw = [torch.from_numpy(w["qkv.weight"][0, 0].T.copy()),
          torch.from_numpy(w["qkv.bias"]),
          torch.from_numpy(w["proj.weight"][0, 0].T.copy()),
          torch.from_numpy(w["proj.bias"])]
    args = [torch.from_numpy(x).requires_grad_(True)] + [
        t.requires_grad_(True) for t in tw]
    y = window_channel_attention_fast_vjp(*args)
    grads = torch.autograd.grad((y ** 2).sum(), args)
    ours = [grads[0].numpy(), grads[1].T.numpy(), grads[2].numpy(),
            grads[3].T.numpy(), grads[4].numpy()]
    _assert_matches(y.detach().numpy(), ours, ref, ref_grads)


# ---------------------------------------------------------------------------
# routing under grad by width
# ---------------------------------------------------------------------------

class _Fake:
    """Stands in for a wrapper on tensors that are not on the CPU (the meta
    device here): counts calls and returns a tensor of the right shape."""

    def __init__(self, shape_of):
        self.calls, self.args, self.shape_of = 0, [], shape_of

    def __call__(self, *args, **kw):
        self.calls += 1
        self.args.append(args)
        x = args[0]
        return torch.zeros(self.shape_of(args), device=x.device,
                           dtype=x.dtype, requires_grad=True)


@pytest.fixture
def fakes(monkeypatch):
    out = {
        "train": _Fake(lambda a: a[0].shape[:3] + (a[0].shape[3] // 3,)),
        "fast_vjp": _Fake(lambda a: a[0].shape),
        "mhsa": _Fake(lambda a: a[0].shape[:3] + (a[0].shape[3] // 3,)),
    }
    monkeypatch.setattr(eg, "window_channel_attention_train", out["train"])
    monkeypatch.setattr(eg, "window_channel_attention_fast_vjp",
                        out["fast_vjp"])
    monkeypatch.setattr(st, "window_mhsa_train", out["mhsa"])
    return out


@pytest.mark.parametrize("C,route", [(8, "train"), (16, "train"),
                                     (64, "train"), (128, "fast_vjp"),
                                     (12, "fast_vjp"), (256, "fast_vjp"),
                                     (1, "train"), (264, "fast_vjp"),
                                     (512, "fast_vjp"), (520, "fast_vjp")])
def test_local_attention_routes_by_width_off_the_cpu(fakes, C, route):
    """Under grad on a tensor off the CPU (meta: the wrappers' own device
    checks never run), C in row 11's widths (1, 2, 4, 8, 16, 32, 64) takes
    its mid, every other C the fast-VJP Function (past 512 over the
    streamed inference kernel)."""
    m = LocalAttention(C).to("meta")
    x = torch.zeros(1, C, 8, 8, device="meta", requires_grad=True)
    assert m(x).shape == x.shape
    assert fakes["train"].calls == (route == "train")
    assert fakes["fast_vjp"].calls == (route == "fast_vjp")


@pytest.mark.parametrize("dim,heads", [(32, 1), (64, 2), (128, 4)])
def test_block_routes_to_the_mhsa_mid_with_c_over_32_heads(fakes, dim, heads):
    block = StructuralTransformerBlock(dim).to("meta")
    tokens = torch.zeros(1, 8, 8, dim, device="meta", requires_grad=True)
    style = torch.zeros(1, dim, device="meta")
    orig = torch.zeros(1, 3, 32, 32, device="meta")
    block(tokens, style, orig)
    assert fakes["mhsa"].calls == 1
    assert fakes["mhsa"].args[0][1] == heads


def test_cpu_routes_every_width_through_the_plain_mid(monkeypatch):
    """On the CPU nothing changes: C = 128 under grad takes the training mid
    (its plain version), not the inference-kernel route."""
    spy = _Fake(lambda a: None)
    real = eg.window_channel_attention_train
    calls = []
    monkeypatch.setattr(eg, "window_channel_attention_train",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    monkeypatch.setattr(eg, "window_channel_attention_fast_vjp", spy)
    m = LocalAttention(128)
    m(torch.zeros(1, 128, 8, 8, requires_grad=True)).sum().backward()
    assert calls == [1] and spy.calls == 0


# ---------------------------------------------------------------------------
# the steps against JAX
# ---------------------------------------------------------------------------

def _jax_cyclegan_state(ts, g_tx, d_tx):
    """The JAX state holding the port state's G and D (and sn buffers)."""
    sd = lambda n: {k: v.detach().numpy().copy()
                    for k, v in getattr(ts, n).state_dict().items()}
    g = {n: {k: jnp.asarray(v) for k, v in enhanced_generator_from_sd(sd(n)).items()}
         for n in ("G_AB", "G_BA")}
    d, sn = {}, {}
    for n in ("D_A", "D_B"):
        p, s = discriminator_from_sd(sd(n))
        d[n], sn[n] = jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, s)
    return JaxCycleGANState(g, d, sn, g_tx.init(g), d_tx.init(d),
                            jnp.zeros((), jnp.int32))


@functools.lru_cache(maxsize=None)
def _jax_step():
    """The optimizers and JAX's jitted fp32 step (fast_attention=False,
    no remat), one for the module: steps at the same width share its
    compilation (c4's here and in ``test_no_fast_attention_step_matches_jax``)."""
    g_tx, d_tx = jax_make_optimizers()
    return g_tx, d_tx, jax.jit(lambda s, a, b: jax_train_step(
        s, a, b, g_tx, d_tx, compute_dtype=jnp.float32, remat=False,
        fast_attention=False))


def _step_against_jax(rng, channels, **port_kw):
    """One fp32 CycleGAN step, batch 1, 32^2, port (on the CPU) vs JAX
    (fast_attention=False, no remat) from the same init: the five losses
    and every D u after the step."""
    g_tx, d_tx, step = _jax_step()
    ts = cyclegan_init_state(0, channels, device="cpu")
    js = _jax_cyclegan_state(ts, g_tx, d_tx)
    xa, xb = (np.tanh(rng.standard_normal((1, 32, 32, 3))).astype(np.float32)
              for _ in range(2))
    # JAX runs its step asynchronously: wait for it before the port's step
    # updates the tensors JAX's state was built from
    js, jl = jax.block_until_ready(step(js, jnp.asarray(xa),
                                        jnp.asarray(xb)))
    ts, tl = cyclegan_train_step(ts, torch.from_numpy(xa),
                                 torch.from_numpy(xb), **port_kw)
    for k in KEYS:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=STEP_RTOL,
                                   err_msg=k)
    for name in ("D_A", "D_B"):
        sd = getattr(ts, name).state_dict()
        for conv, s in js.sn_state[name].items():
            np.testing.assert_allclose(sd[f"{conv}.weight_u"].numpy(),
                                       np.asarray(s["u"]), atol=U_ATOL, rtol=0,
                                       err_msg=f"{name} {conv}")


@pytest.mark.parametrize("channels", (4,) + smoke.WIDTH_CHANNELS)
def test_cyclegan_step_at_the_width_matches_jax(rng, channels):
    """c4 (LocalAttention at C = 4, 8, 16; the block at dim 16, 1 head),
    c8 and c32 (C = 128 at c32's down2), the port's training route on the
    CPU (the plain mids), without pair batching as JAX's fast=False step."""
    _step_against_jax(rng, channels, pair_batching=False)


def test_no_fast_attention_step_matches_jax(rng, monkeypatch):
    """fast_attention=False (the CLI's --no_fast_attention): every attention
    and every block through its plain version in autograd, pair
    batching off as in JAX; no wrapper of a kernel is called (c4)."""
    for name in ("window_channel_attention", "window_channel_attention_train",
                 "window_channel_attention_fast_vjp"):
        monkeypatch.setattr(eg, name, _Fake(lambda a: None))
    for name in ("window_mhsa_train", "fused_structural_block"):
        monkeypatch.setattr(st, name, _Fake(lambda a: None))
    _step_against_jax(rng, 4, fast_attention=False)
    assert all(getattr(m, n).calls == 0 for m, n in (
        (eg, "window_channel_attention"),
        (eg, "window_channel_attention_train"),
        (eg, "window_channel_attention_fast_vjp"),
        (st, "window_mhsa_train"), (st, "fused_structural_block")))


def test_train_cli_hands_no_fast_attention_to_the_step(rng, tmp_path,
                                                       monkeypatch):
    """--no_fast_attention no longer exits: the CLI trains with
    fast_attention=False (and True without the flag)."""
    from PIL import Image

    import multi_style_transfer_gan_tpu_torch.cli.train as cli
    import multi_style_transfer_gan_tpu_torch.train as train_pkg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cli, "DEVICE", "cpu")
    for domain in ("A", "B"):
        d = tmp_path / "data" / f"train{domain}"
        d.mkdir(parents=True)
        for i in range(2):
            Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)
                            ).save(d / f"{i}.png")
    seen = []
    real = train_pkg.cyclegan_train_step
    monkeypatch.setattr(train_pkg, "cyclegan_train_step", lambda *a, **k: (
        seen.append(k["fast_attention"]), real(*a, **k))[1])
    argv = ["--data_root", str(tmp_path / "data"), "--save_dir",
            str(tmp_path / "models"), "--image_size", "32", "--batch_size",
            "2", "--channels", "4", "--num_epochs", "1", "--fp32"]
    assert cli.main(argv + ["--no_fast_attention"]) == 0
    assert cli.main(argv) == 0
    assert seen == [False, True]


def test_enhanced_pretrain_step_at_c8_matches_jax(rng):
    """One enhanced pretrain step at c8, 32^2, batch 2 from the same init and
    a fresh Adam, the port on JAX's mask: the loss at rtol 1e-5."""
    port = pretrain_init_state(3, 8, model="enhanced", num_epochs=2,
                               steps_per_epoch=1, device="cpu")
    sd = {k: v.detach().numpy().copy()
          for k, v in port.model.state_dict().items()}
    params = {k: jnp.asarray(v) for k, v in enhanced_generator_from_sd(sd).items()}
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,shape,heads", [
    ("attention", (2, 16, 16, 24), None),
    ("attention", (3, 8, 12, 24), None),
    ("attention", (8, 256, 256, 24), None),
    ("mhsa", (2, 16, 24, 96), 1),
    ("mhsa", (8, 64, 64, 96), 1),
    ("mhsa", (2, 16, 24, 384), 4),
    ("mhsa", (8, 64, 64, 384), 4),
])
def test_train_kernels_at_the_new_widths_on_the_card(rng, cuda, name, shape,
                                                     heads, dtype):
    """Kernel vs plain, forward and backward, on the three inputs of
    ``chip_smoke.train_kernel_inputs`` (one all-zero window each): fp32 at
    1e-4 / 2e-4, bf16 at the bound; one launch each per call."""
    fwd, bwd = smoke.train_kernel_fns(name, heads)[:2]
    for label, host, g_host in smoke.train_kernel_inputs(rng, name, shape):
        n0 = fwd.launches + bwd.launches
        smoke.check_train_kernel("[test]", name, "", shape, heads, label, host,
                                 g_host, dtype, cuda, timed=False)
        assert fwd.launches + bwd.launches == n0 + 2


@pytest.mark.gpu
def test_fast_vjp_on_the_card_matches_cpu(rng, cuda):
    """C = 128 under grad: the forward on row 1's kernel (one launch), the
    five gradients against the same Function on the CPU (fp32)."""
    x, ws = smoke.attention_stress_inputs(rng, (2, 16, 16, 128))[0][1:]
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        args = [torch.from_numpy(np.asarray(a, np.float32)).to(dev)
                .requires_grad_(True) for a in [x] + ws]
        n0 = K.window_channel_attention.launches
        y = window_channel_attention_fast_vjp(*args)
        grads = torch.autograd.grad((y ** 2).sum(), args)
        if dev == cuda:
            assert K.window_channel_attention.launches == n0 + 1
        outs[dev.type] = [t.detach().cpu() for t in (y, *grads)]
    torch.testing.assert_close(outs["cuda"][0], outs["cpu"][0], atol=1e-4,
                               rtol=0)
    for a, b in zip(outs["cuda"][1:], outs["cpu"][1:]):
        assert (a - b).abs().max() <= 2e-4 * max(1.0, b.abs().max().item())


def _fp32_step_launches(cuda, channels, **kw):
    K.reset_launch_counts()
    launched = smoke.fp32_step_card_vs_cpu(cuda, channels, "[test]", **kw)
    return launched, {n: getattr(K, n).launches
                      for n in smoke.WIDTH_TRAIN_LAUNCHES_PER_STEP[channels]}


@pytest.mark.gpu
@pytest.mark.parametrize("channels", smoke.WIDTH_CHANNELS)
def test_width_step_on_the_card_matches_cpu(cuda, channels):
    """One fp32 CycleGAN step at c8 and c32 (128^2, batch 2, pair batching)
    on the card vs the CPU, losses at rtol 1e-3, with the launches a step
    makes (``chip_smoke.WIDTH_TRAIN_LAUNCHES_PER_STEP``)."""
    _, launched = _fp32_step_launches(cuda, channels)
    assert launched == smoke.WIDTH_TRAIN_LAUNCHES_PER_STEP[channels]


@pytest.mark.gpu
def test_no_fast_attention_step_on_the_card_matches_cpu(cuda):
    """fast_attention=False on the card: the plain formulation, card vs CPU
    at rtol 1e-3, and no kernel launches at all."""
    launched, per_kernel = _fp32_step_launches(cuda, 8, fast_attention=False)
    assert launched == 0 and not any(per_kernel.values())
