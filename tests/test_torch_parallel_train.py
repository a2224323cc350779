"""Data-parallel training on the CPU: two gloo ranks against the JAX
package's single-device steps on the same global batch.

One launch of two ranks (``tests/torch_parallel_worker.py``, started with
the environment torchrun gives its processes) runs every case below at c4
(c8 for the plain generator), 32^2, a global batch of 4 (2 a rank), while
this process computes the references:

- the CycleGAN step with pools and ``--lr_decay``'s schedule on, 3 steps.
  Each step is held against JAX's step from the state the ranks held
  before it (parameters, spectral-norm vectors, Adam moments and counts,
  the schedule, the pools): every loss at rtol 2e-4 (JAX's own
  mesh-parity bound, tests/test_train.py:477-530) and the pools. Chained,
  two implementations drift apart: from this init a change of 1e-7 in the
  generators' weights moves the next step's losses by ~1e-3 (the JAX
  package's mesh test measures ~x50 a step), which measures the init's
  conditioning, not the data parallelism. The port's pool draws come from
  a ``torch.Generator`` and JAX's from ``jax.random``, so here the pool (16
  a direction) is still filling and passes every fake through;
- the same step with pools of 3, which sample from the first step on,
  against the port's one-rank step on the global batch from the same
  states: the losses, every gradient as averaged over the ranks, every
  parameter after the step element by element, and the pool's law over
  the global batch. (Against JAX the generators' updates are sign-like
  at this init, their gradients being far above the warm moments, and
  single elements lie up to 3e-5 apart where the step moves them ~5e-5:
  the one-rank port, which tests/test_torch_train.py holds against JAX, is
  the reference for the gradients and parameters.)
- the plain pretrain step (BatchNorm on the global batch's statistics) and
  the enhanced one, 2 steps chained against JAX's from a resumed
  checkpoint: losses at rtol 1e-5, every parameter and running statistic
  at atol 1e-5, as tests/test_torch_pretrain.py;
- the train CLI for one epoch: only rank 0 writes, and its checkpoint is
  the one-rank run's within atol 1e-5.

Every rank ends with parameters, Adam moments and pools bit-equal to rank
0's. Each check fails on its planted fault
(``torch_parallel_worker.FAULTS``): an all-reduce that sums without
dividing, BatchNorm on local statistics, a pool per rank.
"""

import copy
import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from multi_style_transfer_gan_tpu.data.dataset import (
    random_patch_mask as jax_random_patch_mask,
)
from multi_style_transfer_gan_tpu.train import (
    cyclegan_init_state as jax_init_state,
    cyclegan_train_step as jax_train_step,
)
from multi_style_transfer_gan_tpu.train.pool import ImagePool as JaxImagePool
from multi_style_transfer_gan_tpu.train import pretrain as jpretrain
from multi_style_transfer_gan_tpu.train.cyclegan import (
    make_optimizers as jax_make_optimizers,
)
from multi_style_transfer_gan_tpu.weights.torch_import import (
    adam_state_to_torch, discriminator_from_sd, enhanced_generator_from_sd,
    extract_state_dict, load_pth as jax_load_pth, params_to_torch_sd,
    plain_generator_from_sd, save_pth, trainable_keys,
)
from multi_style_transfer_gan_tpu_torch.train import (
    ImagePool, cyclegan_init_state, cyclegan_train_step, latest_step,
    pretrain_init_state, save_train_state,
)
from multi_style_transfer_gan_tpu_torch.weights import (
    discriminator_state_dict_from_jax, load_pth, state_dict_from_jax_params,
)

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 2
GLOBAL_BATCH = 4
SIZE = 32
C = 4
PLAIN_C = 8
STEPS = 3
DECAY_STEPS = 3          # the linear decay acts from the third update
JAX_POOL = 16            # fills over the 3 steps: every fake passes through
SAMPLING_POOL = 3        # full within the first step: the law samples
POOL_SEED = 9
LOSS_RTOL = 2e-4         # CycleGAN losses (tests/test_train.py:477-530)
ONE_RANK_RTOL = 1e-5     # CycleGAN losses, two ranks vs one (the port's)
GRAD_RTOL = 1e-3         # each gradient tensor's norm, two ranks vs one,
GRAD_FLOOR = 1e-3        # relative to at least this share of the largest
PRETRAIN_RTOL = 1e-5     # pretrain losses (tests/test_torch_pretrain.py)
PARAM_ATOL = 1e-5        # parameters and running statistics
POOL_ATOL = 1e-3         # pool images: the generators' fakes, which at
                         # this init lie up to 3.6e-4 from JAX's (measured)
WARM_NU = 1e-6           # the warm Adams' second moments (see warm)
WARM_STEP = 10           # the resumed pretrain step count
LAUNCH_TIMEOUT = 600
KEYS = ("d_loss", "g_loss", "cycle_loss", "identity_loss", "structure_loss")


def _images(rng, n=GLOBAL_BATCH):
    return np.tanh(rng.standard_normal((n, SIZE, SIZE, 3))).astype(np.float32)


def warm(opt):
    """Adam as after one step with zero first moments and second moments of
    WARM_NU, so the next updates are linear in the gradient where it is
    small: a fresh Adam's first update is lr times the gradient's sign, and
    an element whose gradient is rounding noise then moves either way
    (ROADMAP: "Adam's first step is sign-like")."""
    for group in opt.param_groups:
        for p in group["params"]:
            opt.state[p] = {"step": torch.tensor(1.0),
                            "exp_avg": torch.zeros_like(p),
                            "exp_avg_sq": torch.full_like(p, WARM_NU)}


@torch.no_grad()
def off_zero_biases_(*modules, scale=0.01):
    """Every bias of ``modules`` moved off its zero init by N(0, scale)
    draws (seeded). At a zero q/k bias a window of zero inputs has q = 0,
    which the zero-safe L2 normalize maps to 0, and any update turns it
    into a unit vector: there a step's losses are ill-conditioned."""
    gen = torch.Generator().manual_seed(3)
    for m in modules:
        for k, p in m.named_parameters():
            if k.endswith("bias"):
                p.add_(scale * torch.randn(p.shape, generator=gen))


def _numpy_sd(module):
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def _warm_checkpoint(sd, kind, path):
    """A reference-schema pretrain checkpoint of the port state dict
    ``sd`` (epoch 0), its Adam at WARM_STEP with zero first moments and
    WARM_NU second moments (tests/test_torch_pretrain.py's recipe)."""
    conv = plain_generator_from_sd if kind == "plain" \
        else enhanced_generator_from_sd
    params = {k: np.asarray(v) for k, v in conv(sd).items()}
    keys = trainable_keys(params)
    mu = {k: np.zeros(params[k].shape, np.float32) for k in keys}
    nu = {k: np.full(params[k].shape, WARM_NU, np.float32)
          for k in keys}
    out = params_to_torch_sd(params, kind)
    for k in list(out):
        if k.endswith("running_mean"):
            out[k[:-len("running_mean")] + "num_batches_tracked"] = \
                np.asarray(WARM_STEP, np.int64)
    save_pth({"epoch": 0, "model_state_dict": out,
              "optimizer_state_dict": adam_state_to_torch(
                  params, mu, nu, WARM_STEP, kind, jpretrain.LR)}, path)


def _write_domains(root, rng, n=GLOBAL_BATCH):
    for domain in ("A", "B"):
        d = root / f"train{domain}"
        d.mkdir(parents=True)
        for i in range(n):
            px = rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
            Image.fromarray(px).save(d / f"{i}.png")


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("dp")


@pytest.fixture(scope="module")
def spec(work):
    """Every case's inputs, built here and handed to both ranks."""
    rng = np.random.default_rng(0)
    st = cyclegan_init_state(0, C, decay_steps=DECAY_STEPS, device="cpu")
    off_zero_biases_(st.G_AB, st.G_BA, st.D_A, st.D_B)
    warm(st.g_opt)
    warm(st.d_opt)
    cg = {"kind": "cyclegan", "channels": C, "decay_steps": DECAY_STEPS,
          "state": st.state_dict(), "pool_seed": POOL_SEED,
          "a": [torch.from_numpy(_images(rng)) for _ in range(STEPS)],
          "b": [torch.from_numpy(_images(rng)) for _ in range(STEPS)]}

    pre = {}
    for kind, channels, seed in (("plain", PLAIN_C, 1), ("enhanced", C, 2)):
        model = pretrain_init_state(seed, channels, model=kind,
                                    device="cpu").model
        sd = _numpy_sd(model)
        if kind == "enhanced":
            # biases off their zero init, where a step's parameters are
            # ill-conditioned (tests/test_torch_pretrain.py)
            brng = np.random.default_rng(3)
            for k in sd:
                if k.endswith(".bias"):
                    sd[k] = sd[k] + 0.01 * brng.standard_normal(
                        sd[k].shape).astype(np.float32)
        path = str(work / f"{kind}_warm.pth")
        _warm_checkpoint(sd, kind, path)
        keys = jax.random.split(jax.random.PRNGKey(seed), 2)
        pre[kind] = {"kind": "pretrain", "model": kind, "channels": channels,
                     "num_epochs": 3, "steps_per_epoch": WARM_STEP,
                     "checkpoint": path, "keys": keys,
                     "images": [torch.from_numpy(_images(rng)) for _ in keys],
                     "masks": [torch.from_numpy(np.array(
                         jax_random_patch_mask(k, GLOBAL_BATCH, SIZE)))
                         for k in keys]}

    _write_domains(work / "data", rng)
    cli_state = cyclegan_init_state(42, C, device="cpu")
    warm(cli_state.g_opt)
    warm(cli_state.d_opt)
    save_train_state(cli_state, work / "ckpt_one", 0)
    shutil.copytree(work / "ckpt_one", work / "ckpt_two")

    def argv(run):
        return ["--data_root", str(work / "data"), "--save_dir",
                str(work / f"models_{run}"), "--resume_dir",
                str(work / f"ckpt_{run}"), "--metrics_log",
                str(work / f"metrics_{run}.jsonl"), "--image_size", str(SIZE),
                "--batch_size", str(GLOBAL_BATCH), "--channels", str(C),
                "--num_epochs", "1", "--checkpoint_every", "1",
                "--log_every", "1", "--fp32"]

    cases = [
        {**cg, "name": "cg_jax", "pool_size": JAX_POOL},
        {**cg, "name": "cg_jax_sum", "pool_size": JAX_POOL, "fault": "sum"},
        {**cg, "name": "cg_pool", "pool_size": SAMPLING_POOL},
        {**cg, "name": "cg_pool_rank", "pool_size": SAMPLING_POOL,
         "fault": "rank_pools"},
        {**pre["plain"], "name": "plain"},
        {**pre["plain"], "name": "plain_local_bn", "fault": "local_bn"},
        {**pre["enhanced"], "name": "enhanced"},
        {"kind": "train_cli", "name": "cli", "argv": argv("two")},
    ]
    for case in cases:
        case.pop("keys", None)
    return {"cases": cases, "cg": cg, "pre": pre, "argv": argv}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def launched(spec, work):
    """Both ranks started (they run while the references are computed)."""
    path = work / "spec.pt"
    torch.save({"cases": spec["cases"]}, path)
    out = work / "ranks"
    out.mkdir()
    port = str(_free_port())
    procs = []
    for r in range(WORLD):
        env = {**os.environ, "RANK": str(r), "WORLD_SIZE": str(WORLD),
               "LOCAL_RANK": str(r), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": port, "WORKER_THREADS": "2"}
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_parallel_worker.py"),
             str(path), str(out)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    yield procs, out
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def ranks(launched, jax_first_step, jax_plain, jax_enhanced, one_rank_cli):
    """Each rank's results, once both have exited 0 (the references that
    need none of them are computed first, while the ranks run)."""
    procs, out = launched
    logs = [p.communicate(timeout=LAUNCH_TIMEOUT)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    got = [torch.load(out / f"rank{r}.pt", weights_only=True)
           for r in range(WORLD)]
    assert [g["rank"] for g in got] == [0, 1]
    assert all(g["world"] == WORLD for g in got)
    return got, logs


# ---------------------------------------------------------------------------
# references
# ---------------------------------------------------------------------------

def _optimizer_names():
    """(module, key) of every parameter in the order of the G and the D
    Adam's state."""
    st = cyclegan_init_state(0, C, device="cpu")
    return [[(n, k) for n in pair for k, _ in getattr(st, n).named_parameters()]
            for pair in (("G_AB", "G_BA"), ("D_A", "D_B"))]


def _jax_tree(per_module, convert):
    return {n: {k: jnp.asarray(v) for k, v in convert(sd).items()}
            for n, sd in per_module.items()}


def _jax_opt(tx, params, opt_sd, sched_sd, names, convert):
    """JAX's optimizer state from the port's Adam and LambdaLR state dicts:
    the moments in JAX's layouts, Adam's count, the schedule's count."""
    moments = {m: {} for m in ("exp_avg", "exp_avg_sq")}
    for i, (n, k) in enumerate(names):
        for m in moments:
            moments[m].setdefault(n, {})[k] = \
                opt_sd["state"][i][m].numpy().copy()
    adam, *rest = tx.init(params)
    adam = adam._replace(
        count=jnp.asarray(int(opt_sd["state"][0]["step"]), jnp.int32),
        mu=_jax_tree(moments["exp_avg"], convert),
        nu=_jax_tree(moments["exp_avg_sq"], convert))
    if sched_sd is not None:
        rest = [r._replace(count=jnp.asarray(sched_sd["last_epoch"],
                                             jnp.int32)) for r in rest]
    return (adam, *rest)


def _jax_state(sd, g_tx, d_tx, names):
    """JAX's CycleGANState from a port ``CycleGANState.state_dict``."""
    def numpy(n):
        return {k: t.numpy().copy() for k, t in sd[n].items()}

    g = _jax_tree({n: numpy(n) for n in ("G_AB", "G_BA")},
                  enhanced_generator_from_sd)
    d, sn = {}, {}
    for n in ("D_A", "D_B"):
        params, state = discriminator_from_sd(numpy(n))
        d[n] = {k: jnp.asarray(v) for k, v in params.items()}
        sn[n] = jax.tree.map(jnp.asarray, state)
    js = jax_init_state(jax.random.PRNGKey(0), channels=C, txs=(g_tx, d_tx))
    return js._replace(
        g_params=g, d_params=d, sn_state=sn,
        g_opt=_jax_opt(g_tx, g, sd["g_opt"], sd["g_sched"], names[0],
                       enhanced_generator_from_sd),
        d_opt=_jax_opt(d_tx, d, sd["d_opt"], sd["d_sched"], names[1],
                       lambda x: discriminator_from_sd(x)[0]),
        step=jnp.asarray(sd["step"], jnp.int32))


def _models(js):
    out = {n: state_dict_from_jax_params(js.g_params[n])
           for n in ("G_AB", "G_BA")}
    out.update({n: discriminator_state_dict_from_jax(js.d_params[n],
                                                     js.sn_state[n])
                for n in ("D_A", "D_B")})
    return out


class JaxCycleGAN:
    """JAX's single-device step on the global batches, from a port state
    and pools (images and fill counts; the key is unused while the pools
    fill)."""

    def __init__(self, spec):
        self.g_tx, self.d_tx = jax_make_optimizers(decay_steps=DECAY_STEPS)
        self.names = _optimizer_names()
        self.cg = spec["cg"]
        self.fn = jax.jit(lambda s, p, a, b: jax_train_step(
            s, a, b, self.g_tx, self.d_tx, compute_dtype=jnp.float32,
            remat=False, fast_attention=False, pools=p))

    def step(self, i, sd, pools):
        js = _jax_state(sd, self.g_tx, self.d_tx, self.names)
        jp = (tuple(JaxImagePool(jnp.asarray(im.numpy().copy()),
                                 jnp.asarray(n, jnp.int32))
                    for im, n in zip(pools["images"], pools["n"])),
              jax.random.PRNGKey(POOL_SEED))
        js, jl, (jpools, _) = jax.block_until_ready(self.fn(
            js, jp, jnp.asarray(self.cg["a"][i].numpy().copy()),
            jnp.asarray(self.cg["b"][i].numpy().copy())))
        return {"losses": {k: float(v) for k, v in jl.items()},
                "models": _models(js),
                "pools": {"images": [torch.from_numpy(np.array(p.images))
                                     for p in jpools],
                          "n": [int(p.n) for p in jpools]}}


def _empty_pools(size):
    return {"images": [torch.zeros(size, SIZE, SIZE, 3) for _ in range(2)],
            "n": [0, 0]}


@pytest.fixture(scope="module")
def jax_first_step(launched, spec):
    """JAX's first step, from the spec's state (computed, and the step
    compiled, while the ranks run)."""
    ref = JaxCycleGAN(spec)
    return ref, ref.step(0, spec["cg"]["state"], _empty_pools(JAX_POOL))


@pytest.fixture(scope="module")
def jax_steps(jax_first_step, ranks):
    """For a CycleGAN case of the ranks: JAX's step i from the state and
    pools the ranks held before their step i, for every step."""
    ref, first = jax_first_step

    def of(case):
        got = ranks[0][0][case]
        return [first] + [ref.step(i, got["states"][i], got["pools"][i])
                          for i in range(1, STEPS)]
    return of


@pytest.fixture(scope="module")
def one_rank_steps(spec, ranks):
    """For a CycleGAN case of the ranks: the port's one-rank step i on the
    global batch from the state and pools (their generator's state too)
    the ranks held before their step i, for every step."""
    def of(case):
        got = ranks[0][0][case]
        return [_one_rank_step(spec["cg"], i, got) for i in range(STEPS)]
    return of


def _one_rank_step(cg, i, got):
    st = cyclegan_init_state(0, C, decay_steps=DECAY_STEPS, device="cpu")
    st.load_state_dict(copy.deepcopy(got["states"][i]))
    pools = got["pools"][i]
    gen = torch.Generator()
    gen.set_state(pools["generator"])
    pools = (tuple(ImagePool(im.clone(), n)
                   for im, n in zip(pools["images"], pools["n"])), gen)
    st, tl, pools = cyclegan_train_step(st, cg["a"][i], cg["b"][i],
                                        pair_batching=False, pools=pools)
    (pa, pb), gen = pools
    return {"losses": {k: float(v) for k, v in tl.items()},
            "grads": {n: {k: p.grad.clone() for k, p in getattr(st, n)
                          .named_parameters() if p.grad is not None}
                      for n in ("G_AB", "G_BA", "D_A", "D_B")},
            "models": {n: getattr(st, n).state_dict()
                       for n in ("G_AB", "G_BA", "D_A", "D_B")},
            "pools": {"images": [pa.images, pb.images], "n": [pa.n, pb.n],
                      "generator": gen.get_state()}}


def _jax_pretrain(case):
    """JAX's CLI resume of case["checkpoint"] (cli/pretrain.py:83-101), then
    its steps on the global images with the keys the masks came from."""
    kind = case["model"]
    ck = jax_load_pth(case["checkpoint"])
    conv = plain_generator_from_sd if kind == "plain" \
        else enhanced_generator_from_sd
    params = {k: jnp.asarray(v) for k, v in
              conv(extract_state_dict(ck)).items()}
    step0 = (int(ck["epoch"]) + 1) * case["steps_per_epoch"]
    tx = jpretrain.make_pretrain_optimizer(case["num_epochs"],
                                           case["steps_per_epoch"])
    opt = jpretrain.restore_opt_state(tx, params, step0,
                                      ck["optimizer_state_dict"], kind=kind)
    js = jpretrain.PretrainState(params, opt, jnp.asarray(step0))
    step = jax.jit(lambda s, x, k: jpretrain.pretrain_train_step(s, tx, x, k))
    losses = []
    for x, key in zip(case["images"], case["keys"]):
        js, loss = jax.block_until_ready(step(
            js, jnp.asarray(x.numpy().copy()), key))
        losses.append(float(loss))
    return {"losses": losses,
            "model": state_dict_from_jax_params(js.params, kind)}


@pytest.fixture(scope="module")
def jax_plain(launched, spec):
    return _jax_pretrain(spec["pre"]["plain"])


@pytest.fixture(scope="module")
def jax_enhanced(launched, spec):
    return _jax_pretrain(spec["pre"]["enhanced"])


@pytest.fixture(scope="module")
def one_rank_cli(launched, spec, work):
    """The train CLI without a process group on the same data and resume
    state (on the CPU, as tests/test_torch_train.py drives it)."""
    import multi_style_transfer_gan_tpu_torch.cli.train as cli

    mp = pytest.MonkeyPatch()
    mp.setattr(torch.cuda, "is_available", lambda: True)
    mp.setattr(cli, "DEVICE", "cpu")
    try:
        assert cli.main(spec["argv"]("one")) == 0
    finally:
        mp.undo()
    return work / "models_one"


# ---------------------------------------------------------------------------
# the checks, each raising AssertionError (the planted faults must trip them)
# ---------------------------------------------------------------------------

def _rel(got, ref):
    return abs(got - ref) / max(abs(ref), 1e-8)


def _close_models(got, ref, skip=("weight_v", "num_batches_tracked")):
    for name, sd in ref.items():
        for k, v in sd.items():
            if k.endswith(skip):
                continue
            np.testing.assert_allclose(got[name][k].numpy(), v.numpy(),
                                       atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"{name} {k}")


def _check_pools(i, pools, ref):
    assert pools["n"] == ref["n"], i
    for g, r in zip(pools["images"], ref["images"]):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=POOL_ATOL,
                                   rtol=0, err_msg=str(i))
    if "generator" in ref:
        assert torch.equal(pools["generator"], ref["generator"]), i


def check_jax_steps(got, refs):
    """Step i of the ranks (``got``: their losses, and their pools after
    it) against ``refs[i]``, JAX's step i from the state and pools the
    ranks held before it: every loss at LOSS_RTOL, the pools' fill counts
    and images."""
    for i, ref in enumerate(refs):
        for k in KEYS:
            g, r = got["losses"][i][k], ref["losses"][k]
            assert _rel(g, r) <= LOSS_RTOL, (i, k, g, r)
        _check_pools(i, got["pools"][i + 1], ref["pools"])


def check_one_rank_steps(got, refs):
    """Step i of the ranks against ``refs[i]``, the port's one-rank step i
    from the same state and pools: every loss at ONE_RANK_RTOL, every
    parameter gradient (the ranks' average) at GRAD_RTOL, every model
    tensor after the step at PARAM_ATOL, the pools with their generator's
    state."""
    for i, ref in enumerate(refs):
        for k in KEYS:
            g, r = got["losses"][i][k], ref["losses"][k]
            assert _rel(g, r) <= ONE_RANK_RTOL, (i, k, g, r)
        for name, grads in ref["grads"].items():
            top = max(t.norm().item() for t in grads.values())
            for k, t in grads.items():
                d = (got["grads"][i][name][k] - t).norm().item()
                assert d <= GRAD_RTOL * max(t.norm().item(),
                                            GRAD_FLOOR * top), \
                    (i, name, k, d, t.norm().item())
        _close_models(got["states"][i + 1], ref["models"])
        _check_pools(i, got["pools"][i + 1], ref["pools"])


def check_pretrain_vs_jax(got, ref):
    np.testing.assert_allclose(got["losses"], ref["losses"],
                               rtol=PRETRAIN_RTOL)
    _close_models({"m": got["model"]}, {"m": ref["model"]})


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_cyclegan_step_over_two_ranks_matches_jax(ranks, jax_steps):
    """Pools and the LR decay on, 3 steps, each from the ranks' state before
    it: every loss at rtol 2e-4, the pools' fill counts and images."""
    check_jax_steps(ranks[0][0]["cg_jax"], jax_steps("cg_jax"))


def test_pool_law_over_two_ranks_matches_one_rank(ranks, one_rank_steps):
    """Pools of 3 sample from the first step. Each of 3 steps from the same
    state: the losses at rtol 1e-5, every averaged gradient at 1e-3 of its
    norm, every parameter at atol 1e-5, and the two ranks' global pool
    holding what one rank's holds, its generator in the same state."""
    check_one_rank_steps(ranks[0][0]["cg_pool"], one_rank_steps("cg_pool"))


def test_plain_pretrain_over_two_ranks_matches_jax(ranks, jax_plain):
    """BatchNorm on the global batch's statistics: the losses, every
    parameter and running statistic."""
    check_pretrain_vs_jax(ranks[0][0]["plain"], jax_plain)


def test_enhanced_pretrain_over_two_ranks_matches_jax(ranks, jax_enhanced):
    check_pretrain_vs_jax(ranks[0][0]["enhanced"], jax_enhanced)


@pytest.mark.parametrize("case", ["cg_jax", "cg_pool", "plain", "enhanced"])
def test_ranks_hold_bit_equal_parameters(ranks, case):
    """After the steps every rank's losses, parameters, buffers and Adam
    moments are rank 0's bit for bit (and the pools where the case has
    them)."""
    (zero, one), _ = ranks
    a, b = zero[case], one[case]
    assert a["losses"] == b["losses"]
    if "states" not in a:
        for k, v in a["model"].items():
            assert torch.equal(v, b["model"][k]), (case, k)
        return
    last_a, last_b = a["states"][-1], b["states"][-1]
    for name in ("G_AB", "G_BA", "D_A", "D_B"):
        for k, v in last_a[name].items():
            assert torch.equal(v, last_b[name][k]), (case, name, k)
    for opt in ("g_opt", "d_opt"):
        for i, st in last_a[opt]["state"].items():
            for k in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(st[k], last_b[opt]["state"][i][k])
    for p, q in zip(a["pools"][-1]["images"], b["pools"][-1]["images"]):
        assert torch.equal(p, q)


def test_train_cli_over_two_ranks(ranks, one_rank_cli, work):
    """One epoch (one global batch) resumed from a warm state: both ranks
    exit 0, rank 0 alone writes the three .pth files and the resume state,
    the metrics log holds one rank's lines, and the checkpoint is the
    one-rank run's within atol 1e-5."""
    (zero, one), logs = ranks
    assert zero["cli"]["rc"] == 0 and one["cli"]["rc"] == 0
    assert one["cli"]["writes"] == []
    names = sorted(os.path.basename(p) for p in zero["cli"]["writes"])
    assert names[:3] == ["G_AB_epoch_1.pth", "G_BA_epoch_1.pth",
                         "discriminators_epoch_1.pth"]
    assert len(names) == 4 and names[3].startswith("state.pt")
    assert latest_step(work / "ckpt_two") == 1
    assert "data parallel: rank 1 of 2, 2 images" in logs[1]
    rows = [json.loads(x) for x in
            (work / "metrics_two.jsonl").read_text().splitlines()]
    assert [("d_loss" in r, "epoch_seconds" in r) for r in rows] == \
        [(True, False), (False, True)]
    for name in ("G_AB", "G_BA", "discriminators"):
        two = load_pth(work / "models_two" / f"{name}_epoch_1.pth")
        one = load_pth(one_rank_cli / f"{name}_epoch_1.pth")
        for key, sd in two.items():
            if key == "epoch":
                continue
            _close_models({key: sd}, {key: one[key]})


@pytest.mark.parametrize("fault,case", [("sum", "cg_jax_sum"),
                                        ("local_bn", "plain_local_bn"),
                                        ("rank_pools", "cg_pool_rank")])
def test_planted_fault_is_caught(ranks, jax_steps, jax_plain, one_rank_steps,
                                 fault, case):
    """The negative controls: the check of each case above fails on the
    ranks' run with its fault planted."""
    got = ranks[0][0][case]
    with pytest.raises(AssertionError):
        if fault == "sum":
            check_jax_steps(got, jax_steps(case))
        elif fault == "local_bn":
            check_pretrain_vs_jax(got, jax_plain)
        else:
            check_one_rank_steps(got, one_rank_steps(case))
