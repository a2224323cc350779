"""The port's VGG16 perceptual + Gram loss (``train/perceptual.py``) against
the JAX package's on the CPU: the trunk's taps on a seeded
torchvision-format ``vgg16`` state dict at full width, the Gram matrix,
the three losses and their gradient, the dtype of a bf16 input's trunk,
and the CycleGAN step with the loss as its ``extra_g_loss`` hook."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from feature_oracle import make_vgg16_sd, vgg16_taps_torch
from multi_style_transfer_gan_tpu.train import (
    cyclegan_init_state as jax_init_state,
    cyclegan_train_step as jax_train_step,
)
from multi_style_transfer_gan_tpu.train import perceptual as jperc
from multi_style_transfer_gan_tpu.train.cyclegan import (
    make_optimizers as jax_make_optimizers,
)
from multi_style_transfer_gan_tpu.weights import discriminator_from_sd
from multi_style_transfer_gan_tpu_torch.train import (
    cyclegan_init_state, cyclegan_train_step,
)
from multi_style_transfer_gan_tpu_torch.train import perceptual as tperc
from multi_style_transfer_gan_tpu_torch.weights import (
    discriminator_state_dict_from_jax, state_dict_from_jax_params,
    vgg16_state_dict_from_jax,
)

KEYS = ("d_loss", "g_loss", "cycle_loss", "identity_loss", "structure_loss")
TAP_RTOL = 1e-4    # of each tap's largest value
LOSS_RTOL = 1e-4


@pytest.fixture(scope="module")
def vgg():
    """(JAX params, port params on the CPU) of one seeded full-width
    torchvision-format vgg16 state dict (conv1_1..conv4_3)."""
    sd = make_vgg16_sd(np.random.default_rng(0))
    jp = jperc.vgg16_from_torchvision_sd({k: v.numpy() for k, v in sd.items()})
    return jp, tperc.vgg16_from_torchvision_sd(sd, device="cpu")


@pytest.fixture(scope="module")
def images():
    """pred, content, style: (2, 36, 44, 3) in [-1, 1] (36 and 44 pool
    down to odd sizes, which the VALID max-pool floors)."""
    rng = np.random.default_rng(1)
    return [np.tanh(rng.standard_normal((2, 36, 44, 3))).astype(np.float32)
            for _ in range(3)]


def test_vgg_taps_match_jax_and_torchvision(vgg, images):
    jp, tp = vgg
    x = images[0]
    ref = jperc.vgg16_features(jp, jnp.asarray(x))
    got = tperc.vgg16_features(tp, torch.from_numpy(x))
    sd = make_vgg16_sd(np.random.default_rng(0))
    oracle = vgg16_taps_torch(sd, torch.from_numpy(x).permute(0, 3, 1, 2))
    assert sorted(got) == sorted(ref) == [2, 7, 14, 21]
    for tap, r in ref.items():
        r = np.asarray(r)
        g = got[tap].numpy()
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=TAP_RTOL * np.abs(r).max(), err_msg=tap)
        np.testing.assert_array_equal(
            g, oracle[tap].permute(0, 2, 3, 1).numpy(), err_msg=tap)
    assert got[21].shape == (2, 4, 5, 512)


def test_taps_stop_at_the_largest_tap(vgg, images):
    got = tperc.vgg16_features(vgg[1], torch.from_numpy(images[0]), taps=(7,))
    assert list(got) == [7] and got[7].shape == (2, 18, 22, 128)


def test_vgg_params_carry_across_from_jax(vgg, images):
    jp, tp = vgg
    carried = tperc.vgg16_from_torchvision_sd(vgg16_state_dict_from_jax(jp),
                                              device="cpu")
    assert sorted(carried) == sorted(tp)
    for k, v in tp.items():
        torch.testing.assert_close(carried[k], v, rtol=0, atol=0)


def test_gram_matrix_matches_jax():
    f = np.random.default_rng(2).standard_normal((2, 6, 5, 8)).astype(np.float32)
    got = tperc.gram_matrix(torch.from_numpy(f).to(torch.bfloat16))
    ref = jperc.gram_matrix(jnp.asarray(f, jnp.bfloat16))
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-7)
    # an NHWC view of a channels_last tensor, as the train step hands it
    nchw = torch.from_numpy(f).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    torch.testing.assert_close(tperc.gram_matrix(nchw.permute(0, 2, 3, 1)),
                               tperc.gram_matrix(torch.from_numpy(f)))


@pytest.mark.parametrize("loss", ["perceptual_loss", "gram_style_loss",
                                  "perceptual_gram_loss"])
def test_losses_and_their_gradient_match_jax(vgg, images, loss):
    jp, tp = vgg
    pred, content, style = images
    extra = (style,) if loss == "perceptual_gram_loss" else ()
    j_fn = lambda p: getattr(jperc, loss)(
        jp, p, jnp.asarray(content), *map(jnp.asarray, extra))
    ref, ref_grad = jax.value_and_grad(j_fn)(jnp.asarray(pred))
    x = torch.from_numpy(pred).requires_grad_(True)
    got = getattr(tperc, loss)(tp, x, torch.from_numpy(content),
                               *map(torch.from_numpy, extra))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=LOSS_RTOL)
    ref_grad = np.asarray(ref_grad)
    np.testing.assert_allclose(x.grad.numpy(), ref_grad, rtol=LOSS_RTOL,
                               atol=LOSS_RTOL * np.abs(ref_grad).max())


def test_targets_carry_no_gradient(vgg, images):
    _, tp = vgg
    pred, content, style = (torch.from_numpy(a).requires_grad_(True)
                            for a in images)
    tperc.perceptual_gram_loss(tp, pred, content, style).backward()
    assert pred.grad is not None and pred.grad.abs().sum() > 0
    assert content.grad is None and style.grad is None


def test_bf16_input_runs_the_trunk_in_jax_dtype(vgg, images):
    """The fp32 ImageNet mean and std promote a bf16 input to fp32 (JAX's
    ``(h - mean) / std``), so the trunk runs in fp32 inside a bf16 step;
    the [-1, 1] -> [0, 1] step before it rounds in bf16 in both."""
    jp, tp = vgg
    x = images[0]
    ref = jperc.vgg16_features(jp, jnp.asarray(x, jnp.bfloat16))
    got = tperc.vgg16_features(tp, torch.from_numpy(x).to(torch.bfloat16))
    for tap, r in ref.items():
        assert str(got[tap].dtype) == f"torch.{r.dtype}" == "torch.float32"
        r = np.asarray(r)
        np.testing.assert_allclose(got[tap].numpy(), r, rtol=0,
                                   atol=TAP_RTOL * np.abs(r).max())
    loss = tperc.perceptual_gram_loss(
        tp, *(torch.from_numpy(a).to(torch.bfloat16) for a in images))
    assert loss.dtype == torch.float32


def test_hook_passes_the_source_as_content_and_the_target_as_style(
        vgg, images):
    _, tp = vgg
    fake_A, fake_B, real_A = (torch.from_numpy(a) for a in images)
    real_B = torch.flip(real_A, dims=(1,))
    got = tperc.make_extra_g_loss(tp, 0.7, 1.3)(fake_A, fake_B, real_A, real_B)
    want = 0.5 * (
        tperc.perceptual_gram_loss(tp, fake_B, real_A, real_B, 0.7, 1.3)
        + tperc.perceptual_gram_loss(tp, fake_A, real_B, real_A, 0.7, 1.3))
    swapped = 0.5 * (
        tperc.perceptual_gram_loss(tp, fake_B, real_B, real_A, 0.7, 1.3)
        + tperc.perceptual_gram_loss(tp, fake_A, real_A, real_B, 0.7, 1.3))
    assert float(got) == float(want)
    assert abs(float(got) - float(swapped)) > 1e-3 * abs(float(got))


def test_cyclegan_step_with_the_hook_matches_jax(vgg):
    """The step of ``test_torch_train.py::test_cyclegan_step_matches_jax``
    (fp32, c4, one block, batch 1, 32^2, from the same carried-across init)
    with ``extra_g_loss=make_extra_g_loss(vgg)`` on both sides: step-1
    losses at rtol 2e-4, step-2 at 1e-3.

    The losses are taken before each update, so the hook reaches them only
    through step 1's update of the generators, by less than the tolerance
    (5e-4 relative). So the step's use of the hook is held directly: after
    step 1, Adam's first moments with the hook less those without it are
    (1 - beta1) times the hook's own gradient through the generators, as
    the JAX step calls it: ``hook(G_BA(real_B), G_AB(real_A), real_A,
    real_B)`` (train/cyclegan.py:249-250); the hook itself is held against
    JAX by the tests above."""
    g_tx, d_tx = jax_make_optimizers()
    js = jax_init_state(jax.random.PRNGKey(0), channels=4, txs=(g_tx, d_tx))
    sn = {}
    for name, convs in js.sn_state.items():
        sd = discriminator_state_dict_from_jax(js.d_params[name], convs)
        _, sn[name] = discriminator_from_sd({k: v.numpy() for k, v in sd.items()})
    js = js._replace(sn_state=jax.tree.map(jnp.asarray, sn))

    def port_state():
        ts = cyclegan_init_state(0, 4, device="cpu")
        for name in ("G_AB", "G_BA"):
            getattr(ts, name).load_state_dict(
                state_dict_from_jax_params(js.g_params[name]), strict=True)
        for name in ("D_A", "D_B"):
            getattr(ts, name).load_state_dict(discriminator_state_dict_from_jax(
                js.d_params[name], js.sn_state[name]), strict=True)
        return ts

    jp, _ = vgg
    j_hook = jperc.make_extra_g_loss(jp)
    t_hook = tperc.make_extra_g_loss(
        tperc.vgg16_from_torchvision_sd(vgg16_state_dict_from_jax(jp),
                                        device="cpu"))
    step = jax.jit(lambda s, a, b: jax_train_step(
        s, a, b, g_tx, d_tx, compute_dtype=jnp.float32, remat=False,
        fast_attention=False, extra_g_loss=j_hook))
    rng = np.random.default_rng(0)
    xa, xb = ([np.tanh(rng.standard_normal((1, 32, 32, 3))).astype(np.float32)
               for _ in range(2)] for _ in range(2))
    ts, plain, init = port_state(), port_state(), port_state()
    for i, rtol in enumerate((2e-4, 1e-3)):
        a, b = torch.from_numpy(xa[i]), torch.from_numpy(xb[i])
        js, jl = step(js, jnp.asarray(xa[i]), jnp.asarray(xb[i]))
        ts, tl = cyclegan_train_step(ts, a, b, pair_batching=False,
                                     extra_g_loss=t_hook)
        plain = cyclegan_train_step(plain, a, b, pair_batching=False)[0]
        for k in KEYS:
            np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=rtol,
                                       err_msg=f"step {i + 1} {k}")
        if i == 0:
            _assert_hook_gradient(init, ts, plain, t_hook, a, b)
    assert ts.step == 2


def _assert_hook_gradient(init, hooked, plain, hook, real_A, real_B):
    """Adam's first moments after one step (fresh Adam: (1 - beta1) g),
    with the hook less without it, against the hook's own gradient through
    the generators at ``init``: within 1e-3 of the hook gradient's largest
    element, plus 1e-5 of the whole gradient's, the rounding of two fp32
    gradients whose reductions run in their own orders."""
    gens = lambda s: (p for g in (s.G_AB, s.G_BA) for p in g.parameters())
    nchw = lambda t: t.permute(0, 3, 1, 2)
    nhwc = lambda t: t.permute(0, 2, 3, 1)
    fake_A = nhwc(init.G_BA(nchw(real_B)))
    fake_B = nhwc(init.G_AB(nchw(real_A)))
    want = torch.autograd.grad(hook(fake_A, fake_B, real_A, real_B),
                               list(gens(init)))
    total = [hooked.g_opt.state[p]["exp_avg"] / 0.5 for p in gens(hooked)]
    got = [t - plain.g_opt.state[p]["exp_avg"] / 0.5
           for t, p in zip(total, gens(plain))]
    scale = max(float(w.abs().max()) for w in want)
    atol = 1e-3 * scale + 1e-5 * max(float(t.abs().max()) for t in total)
    assert atol < 1e-2 * scale, (atol, scale)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=atol)
