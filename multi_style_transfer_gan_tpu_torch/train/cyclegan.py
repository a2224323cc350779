"""CycleGAN trainer (port of ``train/cyclegan.py``).

The reference's EnhancedCycleGAN recipe (enhanced_train.py:13-131 of the
reference): G_AB, G_BA = EnhancedGenerator(16, 1); D_A, D_B =
EnhancedDiscriminator(16); Adam(G) lr 5e-5, Adam(D) lr 2e-4, betas (0.5,
0.999); the D phase first (LSGAN real -> 1, fake -> 0, each pair averaged),
then the G phase against the *updated* discriminators, G loss = GAN + 10 *
cycle + 2 * identity + 0.5 * structure.

Precision follows the JAX dtype policy: parameters and Adam stay fp32,
activations run in ``compute_dtype`` and every op casts its weights at use,
so gradients land on the fp32 parameters; bf16 needs no loss scaling.
Spectral norm iterates once per call site, on the real pass of the D phase,
as the JAX step does.

Unlike the functional JAX step, the port updates the state in place (its
modules, optimizers and step count) and returns it.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from dataclasses import dataclass

import torch
from torch.optim.lr_scheduler import LambdaLR

from ..models import EnhancedDiscriminator, EnhancedGenerator
from .losses import l1_loss, lsgan_loss
from .pool import pool_sample
from .pretrain import check_kernel_width

LAMBDA_CYCLE = 10.0     # enhanced_train.py:55
LAMBDA_IDENTITY = 2.0   # enhanced_train.py:56
LAMBDA_STRUCTURE = 0.5  # enhanced_train.py:57
G_LR = 5e-5             # enhanced_train.py:38
D_LR = 2e-4             # enhanced_train.py:42
ADAM_BETAS = (0.5, 0.999)
CHANNELS_LAST = torch.channels_last


@dataclass
class CycleGANState:
    G_AB: EnhancedGenerator
    G_BA: EnhancedGenerator
    D_A: EnhancedDiscriminator
    D_B: EnhancedDiscriminator
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    g_sched: LambdaLR | None = None
    d_sched: LambdaLR | None = None
    step: int = 0

    _MODELS = ("G_AB", "G_BA", "D_A", "D_B")
    _OPTS = ("g_opt", "d_opt", "g_sched", "d_sched")

    def state_dict(self) -> dict:
        """Parameters with the spectral-norm buffers, Adam moments,
        schedules and the step, all on the CPU."""
        sd = {n: {k: v.detach().cpu() for k, v in getattr(self, n)
                  .state_dict().items()} for n in self._MODELS}
        for n in self._OPTS:
            obj = getattr(self, n)
            sd[n] = None if obj is None else obj.state_dict()
        sd["step"] = self.step
        return sd

    def load_state_dict(self, sd: dict) -> None:
        for n in self._MODELS:
            getattr(self, n).load_state_dict(sd[n], strict=True)
        for n in self._OPTS:
            obj = getattr(self, n)
            if (obj is None) != (sd[n] is None):
                raise ValueError(f"checkpoint {n} is {'absent' if sd[n] is None else 'present'} "
                                 f"but this run's is not: the LR schedule differs")
            if obj is not None:
                obj.load_state_dict(sd[n])
        self.step = int(sd["step"])


def lr_factor(decay_steps: int | None, decay_start: int | None = None):
    """The LR multiplier of update i: constant until ``decay_start``
    (default decay_steps // 2), then linear to 0 at ``decay_steps`` (the
    optax join of constant and linear schedules). None when decay_steps is
    None: the reference's constant LRs."""
    if decay_steps is None:
        return None
    start = decay_start if decay_start is not None else decay_steps // 2
    span = max(decay_steps - start, 1)
    return lambda i: 1.0 if i < start else max(0.0, 1.0 - (i - start) / span)


def make_optimizers(g_params, d_params, g_lr: float = G_LR, d_lr: float = D_LR,
                    decay_steps: int | None = None,
                    decay_start: int | None = None):
    """Adam pair at the reference learning rates, and their LambdaLR
    schedules (None without decay). Returns (g_opt, d_opt, g_sched,
    d_sched); step each schedule once after each optimizer step."""
    g_opt = torch.optim.Adam(g_params, lr=g_lr, betas=ADAM_BETAS)
    d_opt = torch.optim.Adam(d_params, lr=d_lr, betas=ADAM_BETAS)
    factor = lr_factor(decay_steps, decay_start)
    if factor is None:
        return g_opt, d_opt, None, None
    return g_opt, d_opt, LambdaLR(g_opt, factor), LambdaLR(d_opt, factor)


def cyclegan_init_state(seed: int = 0, channels: int = 16,
                        num_transformer_blocks: int = 1, *,
                        pretrained_params=None, g_lr: float = G_LR,
                        d_lr: float = D_LR, decay_steps: int | None = None,
                        decay_start: int | None = None,
                        device) -> CycleGANState:
    """Fresh G/D on ``device`` (drawn from a ``torch.Generator`` seeded
    with ``seed``), optionally warm-starting both generators non-strictly
    from ``pretrained_params`` (a state dict): only keys present in the
    generator with matching shapes are copied, and the count is printed.
    On a CUDA device the width is checked first against the training
    kernels (``check_kernel_width``)."""
    if torch.device(device).type == "cuda":
        check_kernel_width(channels, "CycleGAN training")
    gen = torch.Generator().manual_seed(seed)
    g_ab = EnhancedGenerator(channels, num_transformer_blocks, generator=gen)
    g_ba = EnhancedGenerator(channels, num_transformer_blocks, generator=gen)
    d_a = EnhancedDiscriminator(channels, generator=gen)
    d_b = EnhancedDiscriminator(channels, generator=gen)
    if pretrained_params:
        # the reference warm-starts EnhancedGenerator from the PLAIN pretrain
        # checkpoint with strict=False (enhanced_train.py:28-33): the two
        # share no key, so the count below makes that visible
        transferred = 0
        with torch.no_grad():
            for tgt in (g_ab, g_ba):
                own = tgt.state_dict()
                for k, v in pretrained_params.items():
                    if k in own and tuple(own[k].shape) == tuple(v.shape):
                        own[k].copy_(torch.as_tensor(v))
                        transferred += 1
        print(f"warm start: {transferred} tensors transferred"
              + (" (the reference's plain->enhanced warm start also "
                 "matches zero keys)" if transferred == 0 else ""))
    models = [m.to(device=device, memory_format=CHANNELS_LAST)
              for m in (g_ab, g_ba, d_a, d_b)]
    g_ab, g_ba, d_a, d_b = models
    opts = make_optimizers([*g_ab.parameters(), *g_ba.parameters()],
                           [*d_a.parameters(), *d_b.parameters()],
                           g_lr, d_lr, decay_steps, decay_start)
    return CycleGANState(g_ab, g_ba, d_a, d_b, *opts)


@contextmanager
def _frozen(*modules):
    """Parameters of ``modules`` out of autograd (the G phase takes
    gradients for the generators only)."""
    params = [p for m in modules for p in m.parameters()]
    flags = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, f in zip(params, flags):
            p.requires_grad_(f)


def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous(memory_format=CHANNELS_LAST)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def cyclegan_train_step(state: CycleGANState, real_A, real_B, *,
                        compute_dtype=torch.float32, remat: bool = False,
                        fast_attention: bool = True,
                        pair_batching: bool | None = None, extra_g_loss=None,
                        pools=None):
    """One full CycleGAN step. real_A, real_B: (B, H, W, 3) in [-1, 1], on
    the state's device, H and W multiples of 32.

    Returns (state, losses) with the reference's five loss keys (detached
    scalar tensors). remat recomputes each generator stage and block in the
    backward. fast_attention=False runs the generators' attention and
    blocks through their plain formulation (JAX's XLA path; no kernel
    launches), True through the kernels. pair_batching runs the (fake,
    identity) generator pair and the (real, fake) discriminator pair as
    single 2x-batch calls (the same math: every op is per sample, sigma
    depends only on weights); None (the default) follows fast_attention, as
    in the JAX step. extra_g_loss:
    optional ``f(fake_A, fake_B, real_A, real_B) -> scalar`` (NHWC) added to
    the G loss. pools: optional ``((pool_A, pool_B), generator)`` replay
    buffers; the D phase then scores pool-sampled fakes and the return is
    ``(state, losses, pools)``.
    """
    xa = _nchw(real_A.to(compute_dtype))
    xb = _nchw(real_B.to(compute_dtype))
    if pair_batching is None:
        pair_batching = bool(fast_attention)
    for g in (state.G_AB, state.G_BA):
        g.remat = remat
        g.fast_attention = fast_attention

    def paired(gen, first, second):
        if pair_batching:
            return gen(torch.cat([first, second])).chunk(2)
        return gen(first), gen(second)

    def d_pair(disc, real, fake, update_sn):
        """Scores and structure maps of (real, fake); the real half runs the
        power iteration when update_sn, and the fake half sees its result."""
        if pair_batching:
            s, m = disc(torch.cat([real, fake]), update_sn)
            return (*s.chunk(2), *m.chunk(2))
        r, rm = disc(real, update_sn)
        f, fm = disc(fake, False)
        return r, f, rm, fm

    # D-phase fakes are values only (the JAX stop_gradient): made under
    # no_grad, the generators take the inference kernels here
    with torch.no_grad():
        fake_B0 = state.G_AB(xa)
        fake_A0 = state.G_BA(xb)
    if pools is not None:
        (pool_a, pool_b), pgen = pools
        pool_a, fa = pool_sample(pool_a, _nhwc(fake_A0), pgen)
        pool_b, fb = pool_sample(pool_b, _nhwc(fake_B0), pgen)
        fake_A0 = _nchw(fa.to(compute_dtype))
        fake_B0 = _nchw(fb.to(compute_dtype))
        pools = ((pool_a, pool_b), pgen)

    # ---------------- discriminator phase ----------------
    state.d_opt.zero_grad(set_to_none=True)
    ra, fa, _, _ = d_pair(state.D_A, xa, fake_A0, True)
    rb, fb, _, _ = d_pair(state.D_B, xb, fake_B0, True)
    d_real = (lsgan_loss(ra, 1.0) + lsgan_loss(rb, 1.0)) * 0.5
    d_fake = (lsgan_loss(fa, 0.0) + lsgan_loss(fb, 0.0)) * 0.5
    d_loss = d_real + d_fake
    d_loss.backward()
    state.d_opt.step()
    if state.d_sched is not None:
        state.d_sched.step()

    # ---------------- generator phase (vs the updated D) ----------------
    state.g_opt.zero_grad(set_to_none=True)
    with _frozen(state.D_A, state.D_B):
        fake_B, idt_B = paired(state.G_AB, xa, xb)
        fake_A, idt_A = paired(state.G_BA, xb, xa)
        identity = (l1_loss(idt_A, xa) + l1_loss(idt_B, xb)) * LAMBDA_IDENTITY
        recon_A = state.G_BA(fake_B)
        recon_B = state.G_AB(fake_A)
        cycle = (l1_loss(recon_A, xa) + l1_loss(recon_B, xb)) * LAMBDA_CYCLE
        _, fa, ra_map, fa_map = d_pair(state.D_A, xa, fake_A, False)
        _, fb, rb_map, fb_map = d_pair(state.D_B, xb, fake_B, False)
        gan = lsgan_loss(fa, 1.0) + lsgan_loss(fb, 1.0)
        structure = (l1_loss(ra_map, fa_map)
                     + l1_loss(rb_map, fb_map)) * LAMBDA_STRUCTURE
        total = gan + cycle + identity + structure
        if extra_g_loss is not None:
            total = total + extra_g_loss(_nhwc(fake_A), _nhwc(fake_B),
                                         _nhwc(xa), _nhwc(xb))
        total.backward()
    state.g_opt.step()
    if state.g_sched is not None:
        state.g_sched.step()
    state.step += 1

    losses = {"d_loss": d_loss, "g_loss": gan, "cycle_loss": cycle,
              "identity_loss": identity, "structure_loss": structure}
    losses = {k: v.detach() for k, v in losses.items()}
    if pools is not None:
        return state, losses, pools
    return state, losses


def _cpu_state_dict(module) -> dict:
    return {k: v.detach().cpu().contiguous()
            for k, v in module.state_dict().items()}


def save_models(state: CycleGANState, save_dir, epoch: int) -> list[str]:
    """Write the reference's three .pth files (enhanced_train.py:133-152):
    G_AB_epoch_N, G_BA_epoch_N and discriminators_epoch_N, in torch's own
    layouts (the spectral-norm ``weight_v`` is already in torch's order).
    Returns their paths."""
    os.makedirs(save_dir, exist_ok=True)
    files = {
        f"G_AB_epoch_{epoch}.pth": {"G_AB_state_dict": _cpu_state_dict(state.G_AB)},
        f"G_BA_epoch_{epoch}.pth": {"G_BA_state_dict": _cpu_state_dict(state.G_BA)},
        f"discriminators_epoch_{epoch}.pth": {
            "D_A_state_dict": _cpu_state_dict(state.D_A),
            "D_B_state_dict": _cpu_state_dict(state.D_B)},
    }
    paths = []
    for name, payload in files.items():
        path = os.path.join(save_dir, name)
        torch.save({"epoch": epoch, **payload}, path)
        paths.append(path)
    return paths
