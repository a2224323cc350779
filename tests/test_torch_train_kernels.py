"""The port's training kernels (channel-attention mid, window-MHSA mid) vs
the JAX package, the gradient routing of the port's modules, and kernel vs
plain on the card.

On the CPU each wrapper runs its plain forward and its plain backward (the
formulas written out, not autograd), held against the Pallas training
kernels in interpret mode and against the XLA math under ``jax.grad``.
Tests marked ``gpu`` build the CUDA kernels; they skip without a device.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multi_style_transfer_gan_tpu.models.enhanced_generator import (
    _attention_math,
)
from multi_style_transfer_gan_tpu.ops.pallas.window_attention_train import (
    window_channel_attention_train as jax_attention_train,
)
from multi_style_transfer_gan_tpu.ops.pallas.window_mhsa_train import (
    window_mhsa_train as jax_mhsa_train,
)
import multi_style_transfer_gan_tpu_torch.models.enhanced_generator as eg
import multi_style_transfer_gan_tpu_torch.models.structural_transformer as st
from multi_style_transfer_gan_tpu_torch.models import (
    EnhancedGenerator, LocalAttention, StructuralTransformerBlock,
)
from multi_style_transfer_gan_tpu_torch.ops.kernels import (
    fused_structural_block, reset_launch_counts,
    window_attention_mid_backward_plain, window_attention_mid_bwd,
    window_attention_mid_fwd, window_attention_mid_plain,
    window_channel_attention, window_mhsa_backward_plain, window_mhsa_bwd,
    window_mhsa_fwd, window_mhsa_plain, window_mhsa_train,
)
from multi_style_transfer_gan_tpu_torch.ops.kernels.fused_transformer import (
    weight_shapes,
)

FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-4, rtol=2e-4)


def _attn_case(rng, shape, zero_window):
    """x and the JAX-layout LocalAttention weights (1x1 HWIO kernels), as in
    tests/test_pallas.py; a zero window also zeroes the qkv bias so q and k
    are exactly 0 there."""
    C = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w = {"qkv.weight": (rng.standard_normal((1, 1, C, 3 * C)) * 0.1),
         "qkv.bias": rng.standard_normal(3 * C),
         "proj.weight": (rng.standard_normal((1, 1, C, C)) * 0.1),
         "proj.bias": rng.standard_normal(C)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    if zero_window:
        x[0, :4, :4] = 0.0
        w["qkv.bias"][:] = 0.0
    return x, w


def _local_attention(w):
    """A LocalAttention module holding the JAX-layout weights ``w``."""
    C = w["proj.bias"].shape[0]
    m = LocalAttention(C)
    with torch.no_grad():
        m.qkv.weight.copy_(torch.from_numpy(w["qkv.weight"][0, 0].T[..., None, None]))
        m.qkv.bias.copy_(torch.from_numpy(w["qkv.bias"]))
        m.proj.weight.copy_(torch.from_numpy(w["proj.weight"][0, 0].T[..., None, None]))
        m.proj.bias.copy_(torch.from_numpy(w["proj.bias"]))
    return m


# ---------------------------------------------------------------------------
# row 11: the channel-attention mid, against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,zero_window", [
    ((2, 16, 12, 16), False),
    ((1, 16, 16, 64), False),
    ((1, 8, 32, 16), True),
])
def test_local_attention_train_route_matches_jax(rng, shape, zero_window):
    """The module's training route (1x1 convs in autograd around the mid's
    Function) == JAX window_channel_attention_train (Pallas, interpret
    mode) and == _attention_math under jax.grad: the forward and all five
    gradients of a quadratic loss."""
    x, w = _attn_case(rng, shape, zero_window)
    jargs = (jnp.asarray(x), *(jnp.asarray(w[k]) for k in
                               ("qkv.weight", "qkv.bias", "proj.weight",
                                "proj.bias")))
    ref_k = jax_attention_train(*jargs, interpret=True)
    ref_x = _attention_math(*jargs, window_size=4, eps=1e-12)
    loss_k = lambda *a: jnp.sum(jax_attention_train(*a, interpret=True) ** 2)
    loss_x = lambda *a: jnp.sum(
        _attention_math(*a, window_size=4, eps=1e-12) ** 2)
    gk = jax.grad(loss_k, argnums=tuple(range(5)))(*jargs)
    gx = jax.grad(loss_x, argnums=tuple(range(5)))(*jargs)

    m = _local_attention(w)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = m(xt)
    (y ** 2).sum().backward()
    got = y.detach().permute(0, 2, 3, 1).numpy()
    grads = (xt.grad.permute(0, 2, 3, 1).numpy(),
             m.qkv.weight.grad[:, :, 0, 0].T.numpy(), m.qkv.bias.grad.numpy(),
             m.proj.weight.grad[:, :, 0, 0].T.numpy(), m.proj.bias.grad.numpy())
    for ref in (ref_k, ref_x):
        np.testing.assert_allclose(got, np.asarray(ref), **FWD_TOL)
    # the JAX 1x1 kernels are (1, 1, in, out)
    flat = lambda g, i: np.asarray(g)[0, 0] if i in (1, 3) else np.asarray(g)
    for i, ours in enumerate(grads):
        assert np.isfinite(ours).all()
        np.testing.assert_allclose(ours, flat(gk[i], i), **GRAD_TOL)
        np.testing.assert_allclose(ours, flat(gx[i], i), **GRAD_TOL)


# ---------------------------------------------------------------------------
# row 12: the window-MHSA mid, against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,heads", [((2, 16, 16, 48), 1),
                                         ((1, 8, 16, 192), 2)])
def test_window_mhsa_train_matches_jax(rng, shape, heads):
    qkv = rng.standard_normal(shape).astype(np.float32)
    ref = jax_mhsa_train(jnp.asarray(qkv), 8, heads, True)
    ref_g = jax.grad(lambda t: jnp.sum(jax_mhsa_train(t, 8, heads, True) ** 2))(
        jnp.asarray(qkv))
    t = torch.from_numpy(qkv).requires_grad_(True)
    out = window_mhsa_train(t, heads)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **FWD_TOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref_g), **GRAD_TOL)


# ---------------------------------------------------------------------------
# the plain backwards are the formulas, checked against autograd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C", [16, 32, 64])
def test_attention_plain_backward_matches_autograd(rng, C):
    qkv = torch.from_numpy(rng.standard_normal((2, 8, 12, 3 * C)).astype(np.float32))
    qkv[0, :4, :4] = 0.0   # an all-zero window: finite, equal gradients
    g = torch.from_numpy(rng.standard_normal((2, 8, 12, C)).astype(np.float32))
    t = qkv.clone().requires_grad_(True)
    (window_attention_mid_plain(t) * g).sum().backward()
    ours = window_attention_mid_backward_plain(qkv, g)
    assert torch.isfinite(ours).all()
    torch.testing.assert_close(ours, t.grad, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape,heads", [((2, 8, 16, 48), 1),
                                         ((1, 16, 8, 192), 2)])
def test_mhsa_plain_backward_matches_autograd(rng, shape, heads):
    qkv = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    g = torch.from_numpy(
        rng.standard_normal(shape[:3] + (shape[3] // 3,)).astype(np.float32))
    t = qkv.clone().requires_grad_(True)
    (window_mhsa_plain(t, heads) * g).sum().backward()
    torch.testing.assert_close(window_mhsa_backward_plain(qkv, g, heads),
                               t.grad, atol=1e-5, rtol=1e-5)


def test_train_wrappers_reject_shapes_they_do_not_take():
    with pytest.raises(ValueError, match="divisible by 4"):
        window_attention_mid_fwd(torch.zeros(1, 6, 8, 48))
    with pytest.raises(ValueError, match="divisible by 8"):
        window_mhsa_fwd(torch.zeros(1, 12, 8, 192), 2)
    with pytest.raises(ValueError, match="heads"):
        window_mhsa_fwd(torch.zeros(1, 8, 8, 150), 4)


# ---------------------------------------------------------------------------
# gradient routing (the repaired fault: inference kernels cut the gradient)
# ---------------------------------------------------------------------------

class _Spy:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


@pytest.fixture
def spies(monkeypatch):
    out = {}
    for mod, name in ((eg, "window_channel_attention"),
                      (eg, "window_channel_attention_train"),
                      (st, "fused_structural_block"),
                      (st, "window_mhsa_train")):
        out[name] = _Spy(getattr(mod, name))
        monkeypatch.setattr(mod, name, out[name])
    return out


@pytest.mark.parametrize("mode", ["grad", "no_grad", "inference", "frozen"])
def test_modules_route_to_train_kernels_under_grad(rng, spies, mode):
    """Grad mode on and a parameter or the input requiring grad -> the
    training route; otherwise the inference kernels."""
    g = EnhancedGenerator(4, 1, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.tanh(rng.standard_normal((1, 3, 32, 32)))
                         .astype(np.float32))
    if mode == "frozen":   # parameters frozen, the input requires grad
        g.requires_grad_(False)
        x.requires_grad_(True)
    ctx = {"no_grad": torch.no_grad, "inference": torch.inference_mode}.get(
        mode, torch.enable_grad)
    with ctx():
        y = g(x)
    train = mode in ("grad", "frozen")
    assert spies["window_channel_attention_train"].calls == (4 if train else 0)
    assert spies["window_mhsa_train"].calls == (1 if train else 0)
    assert spies["window_channel_attention"].calls == (0 if train else 4)
    assert spies["fused_structural_block"].calls == (0 if train else 1)
    assert y.requires_grad == train


def test_both_routes_compute_the_same_function(rng):
    """Under grad and under no_grad the generator gives the same output (fp32,
    CPU; the routes sum in other orders through 13 InstanceNorms), and the
    training route gives every parameter a gradient."""
    g = EnhancedGenerator(4, 1, generator=torch.Generator().manual_seed(1))
    # nonzero FiLM so every parameter matters, drawn from a seeded generator:
    # the gradient of a bias just before an InstanceNorm is zero but for
    # rounding, so the check below must not depend on the global RNG state
    # that earlier tests in the process leave behind
    film = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for b in g.transformer_blocks:
            b.style_mod.weight.normal_(0, 0.1, generator=film)
    x = torch.from_numpy(np.tanh(rng.standard_normal((2, 3, 32, 32)))
                         .astype(np.float32))
    with torch.no_grad():
        ref = g(x)
    y = g(x)
    torch.testing.assert_close(y.detach(), ref, atol=1e-4, rtol=1e-4)
    (y ** 2).mean().backward()
    missing = [n for n, p in g.named_parameters()
               if p.grad is None or not p.grad.abs().sum() > 0]
    assert not missing, missing


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


# bf16: both sides compute in fp32 from the same bf16 inputs and round once,
# so they may differ by one bf16 rounding of each output plus fp32 order.
BF16_TOL = dict(atol=3e-2, rtol=2 ** -7)

_KERNELS = {
    "attention": (window_attention_mid_fwd, window_attention_mid_bwd,
                  window_attention_mid_plain,
                  window_attention_mid_backward_plain, (), 4),
    "mhsa": (window_mhsa_fwd, window_mhsa_bwd, window_mhsa_plain,
             window_mhsa_backward_plain, (2,), 8),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,shape", [("attention", (2, 16, 16, 48)),
                                        ("attention", (1, 16, 32, 96)),
                                        ("attention", (3, 8, 12, 192)),
                                        ("mhsa", (2, 16, 24, 192))])
def test_train_kernel_matches_plain(rng, cuda, name, shape, dtype):
    fwd, bwd, fwd_plain, bwd_plain, extra, win = _KERNELS[name]
    qkv = rng.standard_normal(shape).astype(np.float32)
    qkv[0, :win, :win] = 0.0
    g = rng.standard_normal(shape[:3] + (shape[3] // 3,)).astype(np.float32)
    qkv = torch.from_numpy(qkv).to(cuda, dtype)
    g = torch.from_numpy(g).to(cuda, dtype)
    n0, m0 = fwd.launches, bwd.launches
    out, dqkv = fwd(qkv, *extra), bwd(qkv, g, *extra)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (n0 + 1, m0 + 1)
    assert torch.isfinite(out).all() and torch.isfinite(dqkv).all()
    fwd_tol = dict(atol=1e-4, rtol=0) if dtype == torch.float32 else BF16_TOL
    bwd_tol = dict(atol=2e-4, rtol=0) if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(out.float(), fwd_plain(qkv, *extra).float(),
                               **fwd_tol)
    torch.testing.assert_close(dqkv.float(),
                               bwd_plain(qkv, g, *extra).float(), **bwd_tol)


@pytest.mark.gpu
def test_inference_wrappers_raise_under_grad_on_the_card(rng, cuda):
    C = 16
    x = torch.randn(1, 8, 8, C, device=cuda, requires_grad=True)
    w = [torch.randn(3 * C, C, device=cuda), torch.randn(3 * C, device=cuda),
         torch.randn(C, C, device=cuda), torch.randn(C, device=cuda)]
    with pytest.raises(RuntimeError, match="no gradient"):
        window_channel_attention(x, *w)
    with torch.no_grad():
        window_channel_attention(x, *w)      # no grad recorded: allowed
    xb = torch.randn(1, 8, 8, 64, device=cuda, requires_grad=True)
    weights = {n: torch.randn(s, device=cuda)
               for n, s in weight_shapes(64).items()}
    with pytest.raises(RuntimeError, match="no gradient"):
        fused_structural_block(xb, torch.randn_like(xb),
                               torch.zeros(1, 64, device=cuda),
                               torch.zeros(1, 64, device=cuda), **weights)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_generator_parameter_gets_a_gradient_on_the_card(rng, cuda,
                                                               dtype):
    """The repaired fault: on the card every parameter of a c16 generator
    gets a nonzero gradient, through the training kernels."""
    g = EnhancedGenerator(16, 1, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for b in g.transformer_blocks:
            b.style_mod.weight.normal_(0, 0.1)
    g = g.to(cuda, memory_format=torch.channels_last)
    x = torch.from_numpy(np.tanh(rng.standard_normal((2, 3, 64, 64)))
                         .astype(np.float32)).to(cuda, dtype)
    reset_launch_counts()
    (g(x).float() ** 2).mean().backward()
    torch.cuda.synchronize()
    assert window_attention_mid_fwd.launches == 4
    assert window_attention_mid_bwd.launches == 4
    assert window_mhsa_fwd.launches == 1 and window_mhsa_bwd.launches == 1
    missing = [n for n, p in g.named_parameters()
               if p.grad is None or not (p.grad.abs().sum() > 0)]
    assert not missing, missing


@pytest.mark.gpu
def test_block_train_route_matches_cpu(rng, cuda):
    """The transformer block's training body on the card (window-MHSA
    kernels) == the same body on the CPU (plain versions), forward and
    parameter gradients, fp32."""
    block = StructuralTransformerBlock(64)
    with torch.no_grad():
        block.style_mod.weight.normal_(0, 0.1)
    tokens = torch.from_numpy(rng.standard_normal((2, 8, 16, 64)).astype(np.float32))
    style = torch.from_numpy(rng.standard_normal((2, 64)).astype(np.float32))
    orig = torch.from_numpy(rng.standard_normal((2, 3, 32, 64)).astype(np.float32))
    outs = {}
    for dev in ("cpu", cuda):
        b = block.to(dev)
        b.zero_grad(set_to_none=True)
        y = b(tokens.to(dev), style.to(dev), orig.to(dev))
        (y ** 2).mean().backward()
        # copies: Module.to moves a parameter's .grad in place with it
        outs[str(dev)] = (y.detach().to("cpu", copy=True),
                          {n: p.grad.to("cpu", copy=True)
                           for n, p in b.named_parameters()})
    (y_cpu, g_cpu), (y_gpu, g_gpu) = outs["cpu"], outs[str(cuda)]
    torch.testing.assert_close(y_gpu, y_cpu, atol=2e-4, rtol=2e-4)
    for n in g_cpu:
        torch.testing.assert_close(g_gpu[n], g_cpu[n], atol=2e-4, rtol=2e-3)
