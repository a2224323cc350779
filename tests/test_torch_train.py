"""The port's CycleGAN training slice vs the JAX package (CPU): one whole
train step from the same carried-across init, the step's variants,
checkpoints and resume, the image pool, the LR schedule, the input
pipeline and the train CLI."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
import optax

from multi_style_transfer_gan_tpu.train import (
    cyclegan_init_state as jax_init_state,
    cyclegan_train_step as jax_train_step,
)
from multi_style_transfer_gan_tpu.train.cyclegan import (
    make_optimizers as jax_make_optimizers,
)
from multi_style_transfer_gan_tpu.weights import (
    discriminator_from_sd, enhanced_generator_from_sd,
)
from multi_style_transfer_gan_tpu_torch.cli.train import main as train_main
from multi_style_transfer_gan_tpu_torch.data import (
    ImageFolderDataset, prefetch_to_device,
)
from multi_style_transfer_gan_tpu_torch.pipelines import load_generator
from multi_style_transfer_gan_tpu_torch.train import (
    cyclegan_init_state, cyclegan_train_step, latest_step, make_optimizers,
    pool_init, pool_sample, restore_train_state, save_models,
    save_train_state,
)
from multi_style_transfer_gan_tpu_torch.train.cyclegan import lr_factor
from multi_style_transfer_gan_tpu_torch.utils import MetricsLogger
from multi_style_transfer_gan_tpu_torch.weights import (
    discriminator_state_dict_from_jax, state_dict_from_jax_params,
)

KEYS = ("d_loss", "g_loss", "cycle_loss", "identity_loss", "structure_loss")


def _batches(rng, n, size=32, batch=1):
    return [np.tanh(rng.standard_normal((batch, size, size, 3)))
            .astype(np.float32) for _ in range(n)]


def _floats(losses):
    return {k: float(v) for k, v in losses.items()}


def test_cyclegan_step_matches_jax(rng):
    """The mandated parity proof: JAX cyclegan_train_step (fp32, no remat,
    XLA attention) vs the port on the CPU, c4, one block, batch 1, 32^2,
    from the same carried-across init. Step-1 losses at rtol 2e-4, step-2
    at 1e-3 (the adversarial updates amplify reassociation noise, see
    tests/test_train.py:486-491), every D u after step 1 at 1e-5."""
    g_tx, d_tx = jax_make_optimizers()
    js = jax_init_state(jax.random.PRNGKey(0), channels=4, txs=(g_tx, d_tx))
    # the port keeps v in its state from the start; a v computed from u is
    # what the JAX step would use, and the D phase's iteration ignores it
    sn = {}
    for name, convs in js.sn_state.items():
        sd = discriminator_state_dict_from_jax(js.d_params[name], convs)
        _, sn[name] = discriminator_from_sd({k: v.numpy() for k, v in sd.items()})
    js = js._replace(sn_state=jax.tree.map(jnp.asarray, sn))

    ts = cyclegan_init_state(0, 4, device="cpu")
    for name in ("G_AB", "G_BA"):
        getattr(ts, name).load_state_dict(
            state_dict_from_jax_params(js.g_params[name]), strict=True)
    for name in ("D_A", "D_B"):
        getattr(ts, name).load_state_dict(discriminator_state_dict_from_jax(
            js.d_params[name], js.sn_state[name]), strict=True)

    step = jax.jit(lambda s, a, b: jax_train_step(
        s, a, b, g_tx, d_tx, compute_dtype=jnp.float32, remat=False,
        fast_attention=False))
    xa, xb = _batches(rng, 2), _batches(rng, 2)
    for i, rtol in enumerate((2e-4, 1e-3)):
        js, jl = step(js, jnp.asarray(xa[i]), jnp.asarray(xb[i]))
        ts, tl = cyclegan_train_step(ts, torch.from_numpy(xa[i]),
                                     torch.from_numpy(xb[i]),
                                     pair_batching=False)
        jl, tl = _floats(jl), _floats(tl)
        assert sorted(tl) == sorted(KEYS)
        for k in KEYS:
            np.testing.assert_allclose(tl[k], jl[k], rtol=rtol, err_msg=k)
        if i == 0:
            for name in ("D_A", "D_B"):
                sd = getattr(ts, name).state_dict()
                for conv, st in js.sn_state[name].items():
                    np.testing.assert_allclose(
                        sd[f"{conv}.weight_u"].numpy(), np.asarray(st["u"]),
                        atol=1e-5, rtol=0, err_msg=f"{name} {conv}")
    assert ts.step == 2


@pytest.fixture(scope="module")
def fresh_sd():
    """A c4 state, as a state dict, every step test starts from."""
    return cyclegan_init_state(7, 4, device="cpu").state_dict()


def _state(sd, **kw):
    s = cyclegan_init_state(1, 4, device="cpu", **kw)
    s.load_state_dict(sd)
    return s


def _run(sd, xa, xb, **kw):
    s = _state(sd)
    out = [_floats(cyclegan_train_step(s, torch.from_numpy(a),
                                       torch.from_numpy(b), **kw)[1])
           for a, b in zip(xa, xb)]
    return s, out


def test_pair_batching_and_remat_give_the_same_step(rng, fresh_sd):
    """Port-only variants: pair batching on and off give the same step-1
    losses within 1e-6 (every op is per sample; sigma depends only on
    weights; a 2x batch only sums in another order), and step 2 within 1e-4
    once Adam has amplified that order; remat recomputes without changing a
    loss or a parameter."""
    xa, xb = _batches(rng, 2, batch=2), _batches(rng, 2, batch=2)
    s_off, off = _run(fresh_sd, xa, xb, pair_batching=False)
    s_on, on = _run(fresh_sd, xa, xb, pair_batching=True)
    s_re, re = _run(fresh_sd, xa, xb, pair_batching=True, remat=True)
    for a, b, c, tol in zip(off, on, re, (1e-6, 1e-4)):
        for k in KEYS:
            np.testing.assert_allclose(b[k], a[k], rtol=tol, atol=1e-6)
            np.testing.assert_allclose(c[k], b[k], rtol=1e-6, atol=1e-6)
    for n, p in s_on.G_AB.state_dict().items():
        torch.testing.assert_close(s_re.G_AB.state_dict()[n], p,
                                   atol=1e-6, rtol=1e-5)


def test_step_moves_g_d_and_u(rng, fresh_sd):
    s = _state(fresh_sd)
    ref = _state(fresh_sd).state_dict()
    a, b = _batches(rng, 1, batch=2)[0], _batches(rng, 1, batch=2)[0]
    _, losses = cyclegan_train_step(s, torch.from_numpy(a), torch.from_numpy(b))
    assert all(np.isfinite(v) for v in _floats(losses).values())
    now = s.state_dict()
    for model in ("G_AB", "G_BA", "D_A", "D_B"):
        moved = [k for k in ref[model] if not torch.equal(ref[model][k],
                                                          now[model][k])]
        assert moved, model
    for conv in ("main.0", "main.8"):
        assert not torch.equal(ref["D_A"][f"{conv}.weight_u"],
                               now["D_A"][f"{conv}.weight_u"])


def test_bf16_step_runs_with_fp32_parameters(rng, fresh_sd):
    s = _state(fresh_sd)
    a, b = _batches(rng, 1)[0], _batches(rng, 1)[0]
    _, losses = cyclegan_train_step(s, torch.from_numpy(a), torch.from_numpy(b),
                                    compute_dtype=torch.bfloat16)
    assert all(np.isfinite(v) for v in _floats(losses).values())
    for m in (s.G_AB, s.D_A):
        assert all(p.dtype == torch.float32 for p in m.parameters())
        assert all(p.grad is None or p.grad.dtype == torch.float32
                   for p in m.parameters())


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_save_models_loads_in_the_port_and_in_jax(rng, fresh_sd, tmp_path):
    s = _state(fresh_sd)
    a, b = _batches(rng, 1)[0], _batches(rng, 1)[0]
    cyclegan_train_step(s, torch.from_numpy(a), torch.from_numpy(b))
    paths = save_models(s, tmp_path, 3)
    assert sorted(os.path.basename(p) for p in paths) == [
        "G_AB_epoch_3.pth", "G_BA_epoch_3.pth", "discriminators_epoch_3.pth"]
    g = load_generator(tmp_path / "G_AB_epoch_3.pth", device="cpu")
    assert (g.kind, g.channels, g.direction) == ("enhanced", 4, "AB")
    x = torch.from_numpy(a)
    with torch.no_grad():
        ref = s.G_AB(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    torch.testing.assert_close(g.apply(x), ref, atol=1e-5, rtol=1e-5)

    ckpt = torch.load(tmp_path / "G_BA_epoch_3.pth", weights_only=True)
    assert ckpt["epoch"] == 3
    params = enhanced_generator_from_sd(ckpt["G_BA_state_dict"])
    assert set(params) == set(ckpt["G_BA_state_dict"])
    d = torch.load(tmp_path / "discriminators_epoch_3.pth", weights_only=True)
    for name in ("D_A", "D_B"):
        d_params, sn = discriminator_from_sd(d[f"{name}_state_dict"])
        assert len(sn) == 7 and all(st["v"] is not None for st in sn.values())
        assert d_params["main.0.weight_orig"].shape == (4, 4, 3, 4)


def test_resume_is_bit_exact(rng, fresh_sd, tmp_path):
    """1 step, save, restore into a fresh state, 1 step == 2 steps."""
    xa, xb = _batches(rng, 2, batch=2), _batches(rng, 2, batch=2)
    s2, two = _run(fresh_sd, xa, xb)

    s1, one = _run(fresh_sd, xa[:1], xb[:1])
    save_train_state(s1, tmp_path, 1)
    assert latest_step(tmp_path) == 1
    resumed = cyclegan_init_state(99, 4, device="cpu")
    resumed, step = restore_train_state(tmp_path, None, resumed)
    assert step == 1 and resumed.step == 1
    _, last = cyclegan_train_step(resumed, torch.from_numpy(xa[1]),
                                  torch.from_numpy(xb[1]))
    assert _floats(last) == two[1]
    want, got = s2.state_dict(), resumed.state_dict()
    for model in ("G_AB", "G_BA", "D_A", "D_B"):
        for k, v in want[model].items():
            assert torch.equal(got[model][k], v), (model, k)


def test_checkpoint_carries_pools_and_schedule(rng, tmp_path):
    s = cyclegan_init_state(0, 4, decay_steps=4, device="cpu")
    pools = ((pool_init(3, 32, device="cpu"),
              pool_init(3, 32, device="cpu")),
             torch.Generator().manual_seed(5))
    a, b = _batches(rng, 1, batch=2)[0], _batches(rng, 1, batch=2)[0]
    s, _, pools = cyclegan_train_step(s, torch.from_numpy(a),
                                      torch.from_numpy(b), pools=pools)
    assert pools[0][0].n == 2 and pools[0][1].n == 2
    save_train_state(s, tmp_path, 4, pools)
    r = cyclegan_init_state(1, 4, decay_steps=4, device="cpu")
    rp = ((pool_init(3, 32, device="cpu"), pool_init(3, 32, device="cpu")),
          torch.Generator())
    (r, rp), step = restore_train_state(tmp_path, None, r, rp)
    assert step == 4
    for p, q in zip(pools[0], rp[0]):
        assert p.n == q.n and torch.equal(p.images, q.images)
    assert torch.equal(pools[1].get_state(), rp[1].get_state())
    assert r.g_sched.state_dict()["last_epoch"] == 1
    assert r.g_opt.param_groups[0]["lr"] == s.g_opt.param_groups[0]["lr"]


# ---------------------------------------------------------------------------
# optimizer schedule and image pool
# ---------------------------------------------------------------------------

def test_lr_schedule_matches_optax():
    """LambdaLR over Adam == the optax join of constant and linear
    schedules the JAX make_optimizers builds (update i uses count i)."""
    steps, start = 10, 4
    ref = optax.schedules.join_schedules(
        [optax.constant_schedule(1.0),
         optax.linear_schedule(1.0, 0.0, steps - start)], [start])
    f = lr_factor(steps, start)
    for i in range(steps + 3):
        assert abs(f(i) - float(ref(i))) < 1e-6, i
    assert lr_factor(None) is None
    p = [torch.nn.Parameter(torch.zeros(1))]
    g_opt, d_opt, g_sched, _ = make_optimizers(p, p, decay_steps=steps,
                                               decay_start=start)
    lrs = []
    for _ in range(steps):
        lrs.append(g_opt.param_groups[0]["lr"])
        g_opt.step()
        g_sched.step()
    np.testing.assert_allclose(lrs, [5e-5 * float(ref(i)) for i in range(steps)],
                               rtol=1e-6)
    assert d_opt.param_groups[0]["betas"] == (0.5, 0.999)


def test_image_pool_law():
    """train/pool.py's law, as tests/test_train.py:429-473 checks the JAX
    pool: the fill phase passes fakes through while inserting them; the
    full phase conserves the multiset and mixes history in at ~p = 0.5."""
    P, H = 4, 8

    def batch(vals):
        return torch.stack([torch.full((H, H, 3), float(v)) for v in vals])

    gen = torch.Generator().manual_seed(0)
    pool = pool_init(P, H, device="cpu")
    first = batch([1, 2, 3, 4])
    pool, out = pool_sample(pool, first, gen)
    assert torch.equal(out, first) and torch.equal(pool.images, first)
    assert pool.n == P

    ids = lambda x: sorted(x.mean(dim=(1, 2, 3)).tolist())
    old = pool.images.clone()
    second = batch([5, 6, 7, 8])
    pool, out2 = pool_sample(pool, second, gen)
    assert ids(torch.cat([pool.images, out2])) == ids(torch.cat([old, second]))

    hist = total = 0
    v = 10.0
    for _ in range(50):
        fakes = batch([v, v + 1, v + 2, v + 3])
        pool, out = pool_sample(pool, fakes, gen)
        hist += int((out.mean(dim=(1, 2, 3)) != fakes.mean(dim=(1, 2, 3))).sum())
        total += 4
        v += 4
    assert 0.3 < hist / total < 0.7, hist / total
    with pytest.raises(ValueError, match="positive"):
        pool_init(0, H, device="cpu")


# ---------------------------------------------------------------------------
# input pipeline, metrics log, CLI
# ---------------------------------------------------------------------------

def _write_domain(root, domain, n, rng, size=(40, 30)):
    d = root / f"train{domain}"
    d.mkdir(parents=True)
    for i in range(n):
        img = (rng.random((size[1], size[0], 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(d / f"{i:02d}.jpg")


def test_image_folder_dataset_and_prefetch(rng, tmp_path):
    _write_domain(tmp_path, "A", 5, rng)
    ds = ImageFolderDataset(tmp_path, "A", img_size=32, host_size=32)
    assert len(ds) == 5
    batches = list(ds.batches(2, seed=3, epochs=1))
    assert len(batches) == 2 and batches[0].shape == (2, 32, 32, 3)
    assert batches[0].dtype == np.uint8
    again = list(ds.batches(2, seed=3, epochs=1))
    assert all(np.array_equal(a, b) for a, b in zip(batches, again))
    got = list(prefetch_to_device(zip(iter(batches), iter(batches)), "cpu"))
    assert len(got) == 2 and isinstance(got[0], tuple)
    assert got[0][0].dtype == torch.uint8 and torch.equal(
        got[1][1], torch.from_numpy(batches[1]))


def test_prefetch_reraises_the_worker_error():
    def bad():
        yield np.zeros((1, 2, 2, 3), np.uint8)
        raise OSError("decode failed")

    it = prefetch_to_device(bad(), "cpu")
    assert next(it).shape == (1, 2, 2, 3)
    with pytest.raises(OSError, match="decode failed"):
        next(it)


def test_metrics_logger_appends_json_lines(tmp_path):
    path = tmp_path / "logs" / "m.jsonl"
    with MetricsLogger(str(path)) as m:
        m.log(epoch=1, d_loss=0.5)
        m.log(epoch=2)
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [1, 2] and "t" in rows[0]
    MetricsLogger(None).log(epoch=1)   # a no-op


@pytest.mark.parametrize("args,message", [
    # the case once held the flag's refusal; the flag is ported now, so it
    # parses and the run stops at the device check like the others
    pytest.param(["--no_fast_attention"], "no CUDA device",
                 id="args0-not ported"),
    (["--image_size", "48"], "multiple of 32"),
    ([], "no CUDA device"),
])
def test_train_cli_exits_nonzero(tmp_path, monkeypatch, capsys, args, message):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = train_main(["--data_root", str(tmp_path), *args])
    assert rc != 0
    assert message in capsys.readouterr().err


def test_train_cli_writes_and_resumes(rng, tmp_path, monkeypatch, capsys):
    """The CLI's loop end to end on the CPU at c4, 32^2: two epochs with
    checkpoints every epoch, then a rerun to three that resumes at epoch 2
    and logs metrics; the saved G_AB loads and stylizes."""
    import multi_style_transfer_gan_tpu_torch.cli.train as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cli, "DEVICE", "cpu")
    for domain in ("A", "B"):
        _write_domain(tmp_path / "data", domain, 2, rng)
    argv = ["--data_root", str(tmp_path / "data"), "--save_dir",
            str(tmp_path / "models"), "--image_size", "32", "--batch_size", "2",
            "--channels", "4", "--checkpoint_every", "1", "--log_every", "1",
            "--resume_dir", str(tmp_path / "ckpt"), "--metrics_log",
            str(tmp_path / "m.jsonl"), "--fp32", "--pool_size", "3"]
    assert train_main(argv + ["--num_epochs", "2"]) == 0
    first = capsys.readouterr().out
    assert "starting fresh" in first and "epoch 2/2 done" in first
    assert train_main(argv + ["--num_epochs", "3"]) == 0
    second = capsys.readouterr().out
    assert "at epoch 2" in second and "epoch 1 step" not in second
    for epoch in (1, 2, 3):
        for name in ("G_AB", "G_BA", "discriminators"):
            assert (tmp_path / "models" / f"{name}_epoch_{epoch}.pth").exists()
    assert latest_step(tmp_path / "ckpt") == 3
    rows = [json.loads(x) for x in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows if "d_loss" in r] == [1, 2, 3]
    g = load_generator(tmp_path / "models" / "G_AB_epoch_3.pth", device="cpu")
    y = g.apply(torch.zeros(1, 32, 32, 3))
    assert y.shape == (1, 32, 32, 3) and torch.isfinite(y).all()


def test_warm_start_transfers_matching_tensors(capsys):
    """Non-strict warm start: every key the generator has with the same shape
    is copied into both generators and counted; a plain-generator checkpoint
    matches nothing, and says so."""
    from multi_style_transfer_gan_tpu_torch.models import EnhancedGenerator

    src = EnhancedGenerator(4, 1, generator=torch.Generator().manual_seed(9))
    src = src.state_dict()
    s = cyclegan_init_state(0, 4, device="cpu", pretrained_params=src)
    assert f"warm start: {2 * len(src)} tensors transferred" in \
        capsys.readouterr().out
    for g in (s.G_AB, s.G_BA):
        for k, v in g.state_dict().items():
            assert torch.equal(v, src[k]), k
    cyclegan_init_state(0, 4, device="cpu", pretrained_params={
        "encoder.0.weight": torch.zeros(8, 3, 7, 7)})
    assert "0 tensors transferred (the reference's plain->enhanced" in \
        capsys.readouterr().out


def test_init_entry_points_need_a_device():
    """The state and the pool take ``device`` as a required keyword, like
    every other entry point of the port: nothing defaults to the CPU."""
    with pytest.raises(TypeError, match="device"):
        cyclegan_init_state()
    with pytest.raises(TypeError, match="device"):
        pool_init(3, 32)
