"""The port's masked-inpainting pretraining against the JAX package on the
CPU: the mask, the loss, the step (plain and enhanced), the schedule, the
checkpoints both ways, the pretrain CLI and the synthetic dataset; on the
card, one step against the CPU."""

import filecmp
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multi_style_transfer_gan_tpu.data.dataset import (
    random_patch_mask as jax_random_patch_mask,
)
from multi_style_transfer_gan_tpu.data.synthetic import (
    write_domains as jax_write_domains,
)
from multi_style_transfer_gan_tpu.models import (
    enhanced_generator_init, plain_generator_apply,
)
from multi_style_transfer_gan_tpu.train import pretrain as jpretrain
from multi_style_transfer_gan_tpu.train.losses import (
    masked_l1 as jax_masked_l1,
)
from multi_style_transfer_gan_tpu.weights.torch_import import (
    adam_state_to_torch, enhanced_generator_from_sd, extract_state_dict,
    load_pth as jax_load_pth, params_to_torch_sd, plain_generator_from_sd,
    save_pth, trainable_keys,
)
from multi_style_transfer_gan_tpu_torch.cli.pretrain import main as pretrain_main
from multi_style_transfer_gan_tpu_torch.cli.train import main as train_main
from multi_style_transfer_gan_tpu_torch.data import (
    random_patch_mask, write_domains,
)
from multi_style_transfer_gan_tpu_torch.ops.kernels import (
    reset_launch_counts, window_attention_mid_bwd, window_attention_mid_fwd,
    window_mhsa_bwd, window_mhsa_fwd,
)
from multi_style_transfer_gan_tpu_torch.pipelines import load_generator
from multi_style_transfer_gan_tpu_torch.train import (
    learning_rate, masked_l1, pretrain_init_state, pretrain_train_step,
    restore_pretrain_state, save_pretrain_checkpoint,
)
from multi_style_transfer_gan_tpu_torch.train.pretrain import (
    clip_by_global_norm_,
)
from multi_style_transfer_gan_tpu_torch.weights import (
    load_pth, state_dict_from_jax_params,
)

C = 8
RTOL_LOSS = 1e-5     # loss, port vs JAX
ATOL_PARAM = 1e-5    # parameters and running statistics, port vs JAX


def _to_jax(x):
    return jnp.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _images(rng, n=2, size=32):
    return np.tanh(rng.standard_normal((n, size, size, 3))).astype(np.float32)


def _assert_params_close(model, jax_params, kind):
    """Every parameter and running statistic at ATOL_PARAM."""
    sd = model.state_dict()
    for k, v in state_dict_from_jax_params(jax_params, kind).items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(),
                                       atol=ATOL_PARAM, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# mask and loss
# ---------------------------------------------------------------------------

def test_random_patch_mask_law():
    """(B, H, W, 1) of 0s and 1s, constant on each cell of the 8 x 8 grid
    (a rectangular input too), about 40% of cells dropped, the same draws
    from the same seed; a side that the grid does not divide raises."""
    g = torch.Generator().manual_seed(0)
    m = random_patch_mask(64, 64, width=96, generator=g, device="cpu")
    assert m.shape == (64, 64, 96, 1) and m.dtype == torch.float32
    assert set(m.unique().tolist()) <= {0.0, 1.0}
    cells = m[..., 0].reshape(64, 8, 8, 8, 12)
    assert torch.equal(cells, cells[:, :, :1, :, :1].expand_as(cells))
    dropped = 1.0 - cells[:, :, 0, :, 0].mean().item()
    assert abs(dropped - 0.4) < 0.03     # 4096 cells: ~4 standard errors
    again = random_patch_mask(64, 64, width=96, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    assert torch.equal(m, again)
    with pytest.raises(ValueError, match="divisible"):
        random_patch_mask(1, 60, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        random_patch_mask(1, 64, width=36, device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_l1_matches_jax(rng, dtype):
    """fp32 reduction over all pixels, an fp32 or bf16 prediction; rtol
    1e-6."""
    pred = torch.from_numpy(_images(rng)).to(dtype)
    target = _images(rng)
    mask = np.array(jax_random_patch_mask(jax.random.PRNGKey(1), 2, 32))
    ref = float(jax_masked_l1(_to_jax(pred.float()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32),
        jnp.asarray(target), jnp.asarray(mask)))
    got = float(masked_l1(pred, torch.from_numpy(target),
                          torch.from_numpy(mask)))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


# ---------------------------------------------------------------------------
# the step and the schedule
# ---------------------------------------------------------------------------

# A fresh Adam's first update is sign-like (m / sqrt(v) = g / |g|): an
# element whose gradient is within fp32 rounding noise of zero (the conv
# biases right before a BatchNorm or an InstanceNorm are such: the norm
# removes them, so their gradient is zero in exact arithmetic) moves by up
# to lr either way, on either side, whatever the two sides agree on. So the
# steps from a fresh Adam are held to what is well conditioned there (the
# losses, the running statistics), and the parameters element by element
# after steps from a resumed Adam state whose second moments (1e-6) keep
# the update linear in the gradient.
WARM_STEP, WARM_NU = 10, 1e-6


def _jax_plain_params():
    return jpretrain.pretrain_init_state(jax.random.PRNGKey(0), C)[0].params


def _write_checkpoint(params, kind, path, step, epoch=0):
    """A reference-schema checkpoint of JAX ``params``, Adam at ``step``
    with zero first moments and WARM_NU second moments."""
    keys = trainable_keys(params)
    mu = {k: np.zeros(params[k].shape, np.float32) for k in keys}
    nu = {k: np.full(params[k].shape, WARM_NU, np.float32) for k in keys}
    sd = params_to_torch_sd(params, kind)
    for k in list(sd):
        if k.endswith("running_mean"):
            sd[k[:-len("running_mean")] + "num_batches_tracked"] = \
                np.asarray(step, np.int64)
    save_pth({"epoch": epoch, "model_state_dict": sd,
              "optimizer_state_dict": adam_state_to_torch(
                  params, mu, nu, step, kind, jpretrain.LR)}, path)


def _jax_resume(path, kind, num_epochs, steps_per_epoch):
    """The JAX CLI's resume (cli/pretrain.py:83-101): (state, tx)."""
    ck = jax_load_pth(path)
    conv = plain_generator_from_sd if kind == "plain" \
        else enhanced_generator_from_sd
    params = {k: jnp.asarray(v) for k, v in
              conv(extract_state_dict(ck)).items()}
    step = (int(ck["epoch"]) + 1) * steps_per_epoch
    tx = jpretrain.make_pretrain_optimizer(num_epochs, steps_per_epoch)
    opt = jpretrain.restore_opt_state(tx, params, step,
                                      ck["optimizer_state_dict"], kind=kind)
    return jpretrain.PretrainState(params, opt, jnp.asarray(step)), tx


def _run_both(jstate, tx, port, seed, n):
    """``n`` steps of each side on the same images and JAX's masks; returns
    (jstate, port, JAX losses, port losses, the port's learning rates)."""
    rng = np.random.default_rng(seed)
    step = jax.jit(lambda s, x, k: jpretrain.pretrain_train_step(s, tx, x, k))
    jl, pl, lrs = [], [], []
    for key in jax.random.split(jax.random.PRNGKey(seed), n):
        x = _images(rng)
        mask = np.array(jax_random_patch_mask(key, 2, 32, width=32))
        # wait for JAX before the port's step updates its parameters
        jstate, jloss = jax.block_until_ready(
            step(jstate, jnp.asarray(x), key))
        port, ploss = pretrain_train_step(port, torch.from_numpy(x),
                                          torch.from_numpy(mask))
        jl.append(float(jloss))
        pl.append(float(ploss))
        lrs.append(port.opt.param_groups[0]["lr"])
    return jstate, port, jl, pl, lrs


def test_two_fresh_plain_steps_match_jax():
    """Two plain steps at c8, 32^2, batch 2 from JAX's init and a fresh
    Adam, one step per epoch over three epochs (the second step takes the
    next epoch's rate): the losses at rtol 1e-5 (and a third batch's loss
    under the updated models), the running statistics at atol 1e-5,
    num_batches_tracked at 2."""
    tx = jpretrain.make_pretrain_optimizer(3, 1)
    params = _jax_plain_params()
    jstate = jpretrain.PretrainState(params, tx.init(params),
                                     jnp.zeros((), jnp.int32))
    port = pretrain_init_state(0, C, num_epochs=3, steps_per_epoch=1,
                               device="cpu")
    port.model.load_state_dict(state_dict_from_jax_params(params, "plain"),
                               strict=True)
    jstate, port, jl, pl, lrs = _run_both(jstate, tx, port, 11, 2)
    np.testing.assert_allclose(pl, jl, rtol=RTOL_LOSS)
    assert lrs == [learning_rate(0, 3, 1), learning_rate(1, 3, 1)]
    assert lrs[1] < lrs[0] and port.step == 2
    sd = port.model.state_dict()
    for k, v in jstate.params.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), np.asarray(v),
                                       atol=ATOL_PARAM, rtol=0, err_msg=k)
    assert int(sd["encoder.3.num_batches_tracked"]) == 2
    x = _images(np.random.default_rng(12))
    mask = np.array(jax_random_patch_mask(jax.random.PRNGKey(3), 2, 32))
    ref = jax_masked_l1(plain_generator_apply(
        jstate.params, jnp.asarray(x * mask), training=True)[0],
        jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        gen = port.model(torch.from_numpy(x * mask).permute(0, 3, 1, 2))
    got = masked_l1(gen.permute(0, 2, 3, 1), torch.from_numpy(x),
                    torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL_LOSS)


@pytest.fixture(scope="module")
def warm_runs(tmp_path_factory):
    """Two plain steps at c8, 32^2, batch 2 in JAX and in the port, both
    resumed from one checkpoint of JAX's init (epoch 0, ten steps per
    epoch: the step count resumes at 10)."""
    path = str(tmp_path_factory.mktemp("warm") / "warm.pth")
    _write_checkpoint(_jax_plain_params(), "plain", path, WARM_STEP)
    jstate, tx = _jax_resume(path, "plain", 3, WARM_STEP)
    port = pretrain_init_state(9, C, num_epochs=3, steps_per_epoch=WARM_STEP,
                               device="cpu")
    assert restore_pretrain_state(port, load_pth(path)) == 1
    assert port.step == WARM_STEP
    return (tx, *_run_both(jstate, tx, port, 21, 2))


def test_two_resumed_plain_steps_match_jax(warm_runs):
    """Losses at rtol 1e-5; every parameter and running statistic at atol
    1e-5."""
    _, jstate, port, jl, pl, lrs = warm_runs
    np.testing.assert_allclose(pl, jl, rtol=RTOL_LOSS)
    assert lrs == [learning_rate(WARM_STEP, 3, WARM_STEP)] * 2
    assert port.step == int(jstate.step) == WARM_STEP + 2
    _assert_params_close(port.model, jstate.params, "plain")


def _jax_lr(step, num_epochs, steps_per_epoch, lr=jpretrain.LR):
    """The learning rate JAX's optimizer applies at ``step``, read back from
    one update of a unit gradient after ``restore_opt_state``."""
    tx = jpretrain.make_pretrain_optimizer(num_epochs, steps_per_epoch, lr)
    params = {"w": jnp.zeros((1,), jnp.float32)}
    opt = jpretrain.restore_opt_state(tx, params, step)
    g = 0.5   # under the clip norm
    upd, _ = tx.update({"w": jnp.full((1,), g, jnp.float32)}, opt, params)
    b1, b2 = jpretrain.ADAM_BETAS
    t = step + 1
    mu_hat = (1 - b1) * g / (1 - b1 ** t)
    nu_hat = (1 - b2) * g * g / (1 - b2 ** t)
    return -float(upd["w"][0]) / (mu_hat / (np.sqrt(nu_hat) + 1e-8))


def test_learning_rate_matches_jax_schedule():
    """The closed form at steps on both sides of each epoch boundary (5
    steps per epoch, 4 epochs) and past the end, against the rate JAX's
    optimizer applies."""
    for step in (0, 4, 5, 9, 10, 14, 15, 19, 20, 23):
        np.testing.assert_allclose(learning_rate(step, 4, 5),
                                   _jax_lr(step, 4, 5), rtol=1e-5,
                                   err_msg=str(step))
    assert learning_rate(20, 4, 5) == pytest.approx(1e-6)


def test_enhanced_step_matches_jax(tmp_path):
    """One enhanced step at c4, 32^2, batch 2 (the attention mids through
    the kernel wrappers' plain versions on the CPU) from a fresh Adam (the
    loss at rtol 1e-5), then one from a resumed Adam (the loss at rtol
    1e-5, every parameter at atol 1e-5)."""
    port = pretrain_init_state(3, 4, model="enhanced", num_epochs=2,
                               steps_per_epoch=1, device="cpu")
    sd = {k: v.detach().numpy().copy()
          for k, v in port.model.state_dict().items()}
    params = {k: jnp.asarray(v) for k, v in
              enhanced_generator_from_sd(sd).items()}
    tx = jpretrain.make_pretrain_optimizer(2, 1)
    jstate = jpretrain.PretrainState(params, tx.init(params),
                                     jnp.zeros((), jnp.int32))
    jstate, _, jl, pl, _ = _run_both(jstate, tx, port, 5, 1)
    np.testing.assert_allclose(pl, jl, rtol=RTOL_LOSS)

    # the warm checkpoint holds the parameters after that step (at the
    # fresh init the conv biases in front of InstanceNorm are exact zeros,
    # where a step's parameters are ill-conditioned)
    path = str(tmp_path / "warm.pth")
    _write_checkpoint(jstate.params, "enhanced", path, WARM_STEP)
    jstate, tx = _jax_resume(path, "enhanced", 2, WARM_STEP)
    port = pretrain_init_state(4, 4, model="enhanced", num_epochs=2,
                               steps_per_epoch=WARM_STEP, device="cpu")
    assert restore_pretrain_state(port, load_pth(path)) == 1
    jstate, port, jl, pl, _ = _run_both(jstate, tx, port, 6, 1)
    np.testing.assert_allclose(pl, jl, rtol=RTOL_LOSS)
    _assert_params_close(port.model, jstate.params, "enhanced")


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_matches_optax(rng, scale):
    """Under the norm the gradients pass unchanged; over it they scale to
    norm 1 exactly as optax.clip_by_global_norm does (rtol 1e-6)."""
    import optax

    grads = [rng.standard_normal(s).astype(np.float32) * scale
             for s in ((4, 3, 2, 2), (7,), (5, 5))]
    ref, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    clip_by_global_norm_(got)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_init_needs_a_device_and_a_served_width():
    """A device is required and the model kind checked; every width is
    served (no width check is left: the kernels take every width), c132's
    enhanced generator among them."""
    with pytest.raises(TypeError, match="device"):
        pretrain_init_state()
    state = pretrain_init_state(0, 132, model="enhanced", device="cpu")
    assert state.model.initial[0].weight.shape[0] == 132
    with pytest.raises(ValueError, match="model must be"):
        pretrain_init_state(0, 8, model="int8", device="cpu")


# ---------------------------------------------------------------------------
# checkpoints both ways
# ---------------------------------------------------------------------------

def test_port_checkpoint_loads_in_jax(warm_runs, tmp_path):
    """The port's checkpoint: the reference schema, and JAX's
    restore_opt_state takes the same Adam moments (exact) at the resumed
    step."""
    tx, _, port, *_ = warm_runs
    path = tmp_path / "pretrain.pth"
    save_pretrain_checkpoint(port, path, epoch=1, loss=0.25)
    ck = jax_load_pth(path)
    assert sorted(ck) == ["epoch", "loss", "model_state_dict",
                          "optimizer_state_dict", "scheduler_state_dict"]
    assert ck["scheduler_state_dict"] == {"last_epoch": 1}
    assert int(ck["model_state_dict"]["decoder.4.num_batches_tracked"]) \
        == port.step
    params = plain_generator_from_sd(extract_state_dict(ck))
    opt = jpretrain.restore_opt_state(tx, params, 2 * WARM_STEP,
                                      ck["optimizer_state_dict"])
    adam = opt[1][0]       # chain(clip, adam(scale_by_adam, schedule))
    assert int(adam.count) == 2 * WARM_STEP
    names = dict(port.model.named_parameters())
    for moments, key in ((adam.mu, "exp_avg"), (adam.nu, "exp_avg_sq")):
        sd = params_to_torch_sd(moments, "plain")
        for name, p in names.items():
            np.testing.assert_array_equal(
                sd[name], port.opt.state[p][key].numpy(), err_msg=name)


def test_jax_checkpoint_resumes_in_the_port(warm_runs, tmp_path):
    """A JAX save_pretrain_checkpoint (epoch 1, ten steps per epoch)
    resumes in the port at epoch 2, step 20, and the next step equals the
    JAX CLI's resumed step: the loss at rtol 1e-5, every parameter at atol
    1e-5."""
    _, jstate, *_ = warm_runs
    path = str(tmp_path / "jax_pretrain.pth")
    jpretrain.save_pretrain_checkpoint(jstate, path, 1, 0.5)
    jres, tx = _jax_resume(path, "plain", 3, WARM_STEP)
    port = pretrain_init_state(9, C, num_epochs=3, steps_per_epoch=WARM_STEP,
                               device="cpu")
    assert restore_pretrain_state(port, load_pth(path)) == 2
    assert port.step == 2 * WARM_STEP
    jres, port, jl, pl, lrs = _run_both(jres, tx, port, 31, 1)
    assert lrs == [learning_rate(2 * WARM_STEP, 3, WARM_STEP)]
    np.testing.assert_allclose(pl, jl, rtol=RTOL_LOSS)
    _assert_params_close(port.model, jres.params, "plain")


def test_enhanced_checkpoint_moments_follow_names(tmp_path):
    """The JAX package's enhanced parameters come in another order than the
    module's: a checkpoint written in that order restores each Adam moment
    onto the parameter of its name."""
    port = pretrain_init_state(1, 4, model="enhanced", device="cpu")
    sd = {k: v.detach().numpy().copy()
          for k, v in port.model.state_dict().items()}
    order = list(jax.eval_shape(lambda k: enhanced_generator_init(
        k, 4, num_transformer_blocks=1), jax.random.PRNGKey(0)))
    assert order != list(sd)
    conv = enhanced_generator_from_sd(sd)
    params = {k: conv[k] for k in order}
    rng = np.random.default_rng(2)
    mu = {k: rng.standard_normal(v.shape).astype(np.float32)
          for k, v in params.items()}
    nu = {k: np.abs(v) for k, v in mu.items()}
    path = str(tmp_path / "enh.pth")
    save_pth({"epoch": 0,
              "model_state_dict": params_to_torch_sd(params, "enhanced"),
              "optimizer_state_dict": adam_state_to_torch(
                  params, mu, nu, 3, "enhanced", 2e-4)}, path)
    assert restore_pretrain_state(port, load_pth(path)) == 1
    mu_sd = params_to_torch_sd(mu, "enhanced")
    for name, p in port.model.named_parameters():
        np.testing.assert_array_equal(port.opt.state[p]["exp_avg"].numpy(),
                                      mu_sd[name], err_msg=name)
        assert float(port.opt.state[p]["step"]) == port.step == 1000


# ---------------------------------------------------------------------------
# the CLIs and the synthetic data
# ---------------------------------------------------------------------------

@pytest.fixture
def on_cpu(monkeypatch):
    import multi_style_transfer_gan_tpu_torch.cli.pretrain as pcli
    import multi_style_transfer_gan_tpu_torch.cli.train as tcli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(pcli, "DEVICE", "cpu")
    monkeypatch.setattr(tcli, "DEVICE", "cpu")


def test_pretrain_cli_writes_logs_and_resumes(on_cpu, tmp_path, capsys):
    """Plain c4 on a write_domains folder (2 images per domain, batch 2:
    two steps per epoch): two epochs with a checkpoint each, metrics
    logged, then a rerun to three epochs that resumes at epoch 2; the
    checkpoint serves through load_generator."""
    write_domains(tmp_path / "data", n_train=2, n_test=1, size=48, seed=3)
    argv = ["--data_root", str(tmp_path / "data"), "--save_dir",
            str(tmp_path / "models"), "--batch_size", "2", "--channels", "4",
            "--checkpoint_every", "1", "--log_every", "1", "--seed", "0",
            "--metrics_log", str(tmp_path / "m.jsonl"), "--fp32"]
    assert pretrain_main(argv + ["--num_epochs", "2"]) == 0
    first = capsys.readouterr().out
    assert "monet images: 2  photo images: 2" in first
    assert "epoch 2/2 done" in first
    ck2 = tmp_path / "models" / "generator_pretrain_epoch_2.pth"
    assert pretrain_main(argv + ["--num_epochs", "3", "--resume",
                                 str(ck2)]) == 0
    second = capsys.readouterr().out
    assert "at epoch 2" in second and "epoch 1 [" not in second
    assert "epoch 3 [photo]: mean loss" in second
    ck = load_pth(tmp_path / "models" / "generator_pretrain_epoch_3.pth")
    assert ck["epoch"] == 2
    assert int(ck["model_state_dict"]["encoder.3.num_batches_tracked"]) == 6
    rows = [json.loads(x) for x in
            (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows if "mean_loss" in r] == [1, 1, 2, 2, 3, 3]
    assert all(np.isfinite(r["loss"]) for r in rows if "loss" in r)
    m = load_generator(tmp_path / "models" / "generator_pretrain_epoch_3.pth",
                       device="cpu")
    assert m.kind == "plain" and m.channels == 4


def test_enhanced_pretrain_warm_starts_the_train_cli(on_cpu, tmp_path,
                                                     capsys):
    """An enhanced pretrain checkpoint from the CLI warm-starts the CycleGAN
    trainer's two generators with every tensor."""
    write_domains(tmp_path / "data", n_train=2, n_test=1, size=48, seed=4)
    assert pretrain_main([
        "--data_root", str(tmp_path / "data"), "--save_dir",
        str(tmp_path / "models"), "--batch_size", "2", "--channels", "4",
        "--model", "enhanced", "--num_epochs", "1", "--checkpoint_every",
        "1", "--fp32"]) == 0
    path = tmp_path / "models" / "generator_pretrain_epoch_1.pth"
    n = len(load_pth(path)["model_state_dict"])
    capsys.readouterr()
    assert train_main([
        "--data_root", str(tmp_path / "data"), "--save_dir",
        str(tmp_path / "cyc"), "--pretrained", str(path), "--channels", "4",
        "--image_size", "32", "--batch_size", "2", "--num_epochs", "1",
        "--checkpoint_every", "1", "--fp32"]) == 0
    assert f"warm start: {2 * n} tensors transferred" in capsys.readouterr().out


def test_pretrain_cli_exits_nonzero_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pretrain_main(["--data_root", "nowhere"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_write_domains_is_byte_equal_to_jax(tmp_path):
    manifest = write_domains(tmp_path / "port", n_train=2, n_test=1,
                             size=40, seed=5)
    assert manifest == jax_write_domains(tmp_path / "jax", n_train=2,
                                         n_test=1, size=40, seed=5)
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*.jpg"))
    assert len(files) == 2 * 2 + 4 * 1
    for f in files:
        assert filecmp.cmp(tmp_path / "jax" / f, tmp_path / "port" / f,
                           shallow=False), f


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
@pytest.mark.parametrize("kind,channels,size", [("plain", 8, 64),
                                                ("enhanced", 16, 64)])
def test_pretrain_step_on_the_card_matches_cpu(cuda, kind, channels, size):
    """One fp32 step from the same init and mask on the card and on the
    CPU: loss at rtol 1e-4 (cuDNN and the CPU sum in other orders); the
    enhanced step launches 4 + 4 channel-attention and 1 + 1 MHSA kernels."""
    rng = np.random.default_rng(17)
    x = torch.from_numpy(_images(rng, 2, size))
    mask = random_patch_mask(2, size, device="cpu",
                             generator=torch.Generator().manual_seed(1))
    losses = {}
    for dev in ("cpu", cuda):
        st = pretrain_init_state(5, channels, model=kind, device=dev)
        reset_launch_counts()
        _, loss = pretrain_train_step(st, x.to(dev), mask.to(dev))
        losses[str(dev)] = float(loss)
    got = [k.launches for k in (window_attention_mid_fwd,
                                window_attention_mid_bwd, window_mhsa_fwd,
                                window_mhsa_bwd)]
    assert got == ([4, 4, 1, 1] if kind == "enhanced" else [0, 0, 0, 0])
    np.testing.assert_allclose(losses[str(cuda)], losses["cpu"], rtol=1e-4)
