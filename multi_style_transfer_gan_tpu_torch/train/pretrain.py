"""Masked-inpainting self-supervised pretraining (port of
``train/pretrain.py``; the reference's pretrain.py:99-230).

The recipe: the plain ``Generator(64)``, Adam(2e-4, betas 0.5/0.999), the
learning rate cosine-annealed per epoch to 1e-6, gradients clipped to global
norm 1.0, loss = L1 on the dropped patches of a random 8 x 8 patch mask,
checkpoints holding the model, optimizer, scheduler and epoch.
``model="enhanced"`` pretrains the EnhancedGenerator itself, so that the
CycleGAN trainer's ``--pretrained`` warm start transfers every tensor (the
reference's plain -> enhanced warm start matches no key). Under autograd
the EnhancedGenerator runs the hand-written training kernels on the card
(``ops.kernels.window_channel_attention_train``, ``window_mhsa_train``;
at C = 128 the JAX package's route, ``window_channel_attention_fast_vjp``),
which take the c8, c16 and c32 widths (``check_kernel_width``).

Precision follows the JAX dtype policy: parameters and Adam stay fp32, the
generator runs in ``compute_dtype`` with its weights cast at use, BatchNorm
and the loss in fp32. Unlike the functional JAX step, the port updates the
state in place (the module, its running statistics, Adam and the step) and
returns it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..models import EnhancedGenerator, PlainGenerator
from ..ops.kernels import FAST_VJP_WIDTHS
from ..ops.kernels.fused_transformer import default_num_heads
from ..ops.kernels.window_attention_train import KERNEL_WIDTHS
from ..ops.kernels.window_mhsa_train import (
    KERNEL_WIDTHS as BLOCK_WIDTHS, kernel_heads,
)
from .losses import masked_l1

LR = 2e-4             # pretrain.py:99
ETA_MIN = 1e-6        # pretrain.py:131
CLIP_NORM = 1.0       # pretrain.py:165
ADAM_BETAS = (0.5, 0.999)
MODELS = ("plain", "enhanced")
_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


@dataclass
class PretrainState:
    model: nn.Module           # PlainGenerator or EnhancedGenerator
    opt: torch.optim.Adam
    num_epochs: int
    steps_per_epoch: int
    lr: float = LR
    step: int = 0              # optimizer steps taken


def learning_rate(step: int, num_epochs: int, steps_per_epoch: int,
                  lr: float = LR) -> float:
    """The learning rate of optimizer step ``step`` (0-based), in the closed
    form of the JAX schedule (train/pretrain.py:45-49): cosine from ``lr``
    to ETA_MIN over ``num_epochs`` epochs, constant within an epoch, as
    torch's CosineAnnealingLR(T_max=num_epochs) stepped once per epoch."""
    epoch = step // max(steps_per_epoch, 1)
    cos = 0.5 * (1.0 + math.cos(math.pi * min(epoch, num_epochs)
                                / num_epochs))
    return ETA_MIN + (lr - ETA_MIN) * cos


def check_kernel_width(channels: int,
                       what: str = "enhanced pretraining") -> None:
    """The EnhancedGenerator at ``channels`` trains on the card only where
    its widths are built: LocalAttention at C, 2C and 4C each in the
    training kernel's widths or on the inference-kernel route
    (``FAST_VJP_WIDTHS``), and the transformer block at 4C with
    ``default_num_heads(4C)`` heads in the window-MHSA kernel's. So c8, c16
    and c32 train. Raises otherwise: there is no plain fallback on the
    card. ``what`` names the caller in the message. The widths are the
    training routes' own, not the serving kernels'."""
    attention = set(KERNEL_WIDTHS) | set(FAST_VJP_WIDTHS)
    dim = 4 * channels
    if (not {channels, 2 * channels, dim} <= attention
            or dim not in BLOCK_WIDTHS
            or default_num_heads(dim) != kernel_heads(dim)):
        built = [c for c in range(1, max(attention) + 1)
                 if {c, 2 * c, 4 * c} <= attention and 4 * c in BLOCK_WIDTHS]
        raise ValueError(
            f"{what} at channels={channels} is not served on the card: "
            f"LocalAttention trains at C in {tuple(sorted(attention))} and "
            f"the block at dim in {BLOCK_WIDTHS} (C / 32 heads), i.e. "
            f"channels in {tuple(built)}")


def pretrain_init_state(seed: int = 0, channels: int = 64, *,
                        num_epochs: int = 200, steps_per_epoch: int = 1000,
                        lr: float = LR, model: str = "plain",
                        num_transformer_blocks: int = 1,
                        device) -> PretrainState:
    """A fresh generator on ``device`` in train mode, drawn from a
    ``torch.Generator`` seeded with ``seed`` (model 'plain': the reference's
    ``Generator(channels)``; 'enhanced': ``EnhancedGenerator(channels,
    num_transformer_blocks)``), and its Adam."""
    if model not in MODELS:
        raise ValueError(f"model must be one of {MODELS}, got {model!r}")
    device = torch.device(device)
    gen = torch.Generator().manual_seed(seed)
    if model == "enhanced":
        if device.type == "cuda":
            check_kernel_width(channels)
        module = EnhancedGenerator(channels, num_transformer_blocks,
                                   generator=gen)
    else:
        module = PlainGenerator(channels, generator=gen)
    module = module.to(device=device, memory_format=torch.channels_last)
    opt = torch.optim.Adam(module.train().parameters(), lr=lr,
                           betas=ADAM_BETAS)
    return PretrainState(module, opt, num_epochs, steps_per_epoch, lr)


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float = CLIP_NORM) -> None:
    """optax's ``clip_by_global_norm`` in place: every gradient scaled by
    max_norm / norm when the global norm exceeds max_norm (no epsilon, unlike
    ``clip_grad_norm_``), without a host sync."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, max_norm / torch.clamp_min(norm, max_norm))


def pretrain_train_step(state: PretrainState, images: torch.Tensor,
                        mask: torch.Tensor, compute_dtype=torch.float32):
    """One step: generate from the masked images, masked L1, clip, Adam.

    images: (B, H, W, 3) in [-1, 1]; mask: (B, H, W, 1), 1 = keep (the CLI
    draws it with ``data.random_patch_mask``); both on the state's device.
    The generator sees ``images * mask`` in ``compute_dtype``; the plain
    model's BatchNorms run in train mode and update their running
    statistics. The learning rate is set from :func:`learning_rate` at the
    step count before the update. Returns (state, loss), the loss a
    detached fp32 scalar tensor.
    """
    x = (images * mask).to(compute_dtype).permute(0, 3, 1, 2)
    for group in state.opt.param_groups:
        group["lr"] = learning_rate(state.step, state.num_epochs,
                                    state.steps_per_epoch, state.lr)
    state.opt.zero_grad(set_to_none=True)
    state.model.train()
    gen = state.model(x.contiguous(memory_format=torch.channels_last))
    loss = masked_l1(gen.permute(0, 2, 3, 1), images, mask)
    loss.backward()
    clip_by_global_norm_([p.grad for p in state.model.parameters()
                          if p.grad is not None])
    state.opt.step()
    state.step += 1
    return state, loss.detach()


def _cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_cpu(v) for v in obj]
    return obj


def save_pretrain_checkpoint(state: PretrainState, path, epoch: int,
                             loss: float = 0.0) -> None:
    """The reference schema (pretrain.py:210-216): ``epoch``,
    ``model_state_dict`` (every ``num_batches_tracked`` set to the step, as
    the JAX writer does), ``optimizer_state_dict`` (the torch Adam state
    dict itself), ``scheduler_state_dict`` {"last_epoch": epoch} and
    ``loss``; every tensor on the CPU."""
    model_sd = _cpu(state.model.state_dict())
    for k in model_sd:
        if k.endswith("num_batches_tracked"):
            model_sd[k] = torch.tensor(state.step, dtype=torch.int64)
    torch.save({
        "epoch": epoch,
        "model_state_dict": model_sd,
        "optimizer_state_dict": _cpu(state.opt.state_dict()),
        "scheduler_state_dict": {"last_epoch": epoch},
        "loss": float(loss),
    }, path)


def _opt_state_by_name(opt_sd: dict, ckpt_keys, own_names) -> dict:
    """The checkpoint's Adam state renumbered to this module's parameter
    order. The writer numbers its state in its state dict's order of
    trainable keys (the JAX package's enhanced parameters come in another
    order than the module's)."""
    index = {k: i for i, k in enumerate(ckpt_keys)}
    state = opt_sd["state"]
    renumbered = {}
    for i, name in enumerate(own_names):
        st = state.get(index[name], state.get(str(index[name])))
        if st is not None:
            renumbered[i] = st
    return {"state": renumbered, "param_groups": opt_sd["param_groups"]}


def restore_pretrain_state(state: PretrainState, ckpt: dict) -> int:
    """Load a pretrain checkpoint (this port's, the JAX package's or the
    reference's) into ``state`` in place; returns the epoch to resume at,
    the checkpoint's epoch + 1.

    As the JAX ``restore_opt_state`` (train/pretrain.py:131-152): the step
    count, and so the schedule and Adam's bias corrections, resume at
    start_epoch * steps_per_epoch; the Adam moments come from the
    checkpoint when it carries a torch Adam state, else they start at 0.
    """
    sd = ckpt["model_state_dict"]
    state.model.load_state_dict(sd, strict=True)
    start_epoch = int(ckpt.get("epoch", 0)) + 1
    step = start_epoch * state.steps_per_epoch
    params = dict(state.model.named_parameters())
    opt_sd = ckpt.get("optimizer_state_dict") or {}
    if isinstance(opt_sd.get("state"), dict) and opt_sd["state"]:
        state.opt.load_state_dict(_opt_state_by_name(
            opt_sd, [k for k in sd if not k.endswith(_BUFFERS)],
            list(params)))
    for p in params.values():
        st = state.opt.state[p]
        if not st:
            st["exp_avg"] = torch.zeros_like(p)
            st["exp_avg_sq"] = torch.zeros_like(p)
        st["step"] = torch.tensor(float(step), dtype=torch.float32)
    state.step = step
    return start_epoch
