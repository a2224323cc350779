"""EnhancedGenerator (port of ``models/enhanced_generator.py``).

Dataflow, as the JAX ``enhanced_generator_apply`` (:310-402): 7x7 stem ->
two stride-2 stages (conv, IN+ReLU, LocalAttention, MultiScaleBlock) ->
style vector (global average pool + Linear + ReLU) -> StructuralTransformer
blocks on the bottleneck grid -> two transposed-conv stages -> 7x7 conv +
tanh.

Activations are logical NCHW in ``torch.channels_last`` memory: the
LocalAttention kernel and the transformer block read their (B, H, W, C)
view without a copy. The ``nn.Sequential`` indices are the reference
checkpoint's (``down1.0`` conv, ``down1.3`` attention, ``down1.4``
multi-scale block), so its ``.pth`` loads with ``strict=True``; indices 1
and 2 hold the parameter-free InstanceNorm and ReLU, which the forward runs
as one ``in_relu``.

Precision: every op casts its weights to the activation's type at use
(``core.conv``), as the JAX ops do, so fp32 parameters train under bf16
compute and their gradients land in fp32.

Routes: where autograd will need a gradient (grad mode on, and the input or
a parameter requires grad) LocalAttention runs the 1x1 qkv conv, the
training kernel of the mid and the 1x1 proj conv (on the card at the
kernel's widths, ``window_attention_train.KERNEL_WIDTHS``, C = 1, 2, 4, 8,
16, 32, 64; at every other C up to 512 the JAX package's route instead,
``window_channel_attention_fast_vjp``: the inference kernel forward, the
backward recomputed through the XLA formulation; ``train_route`` chooses,
and any other width raises), and the transformer block its
training body; otherwise the inference kernels run (the serving path, and
the D-phase fakes of a train step, made under ``torch.no_grad()``). On the
CPU every width takes the plain versions.

``fast_attention = False`` (the train CLI's ``--no_fast_attention``, JAX's
``fast_attention=False``) runs every LocalAttention and every block through
its plain version in autograd (the ports of ``_attention_math`` and
``_block_body_math``) on any device, with or without grad: no kernel
launches.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.conv import conv, linear
from ..core.norm import InstanceNorm, in_relu
from ..ops.kernels import (
    train_route, window_channel_attention, window_channel_attention_fast_vjp,
    window_channel_attention_plain, window_channel_attention_train,
)
from ..ops.kernels._checks import grad_needed
from .init_utils import init_generator_module_
from .structural_transformer import StructuralTransformerBlock

CHANNELS_LAST = torch.channels_last


class LocalAttention(nn.Module):
    """Windowed channel attention over 4x4 windows."""

    def __init__(self, channels: int):
        super().__init__()
        self.qkv = nn.Conv2d(channels, 3 * channels, 1)
        self.proj = nn.Conv2d(channels, channels, 1)
        self.fast = True   # False: the plain version (_attention_math)

    def forward(self, x):
        x = x.contiguous(memory_format=CHANNELS_LAST)
        nhwc = x.permute(0, 2, 3, 1)
        C = x.shape[1]
        weights = [w.to(x.dtype) for w in (self.qkv.weight, self.qkv.bias,
                                           self.proj.weight, self.proj.bias)]
        if not self.fast:
            return window_channel_attention_plain(
                nhwc, *weights).permute(0, 3, 1, 2)
        if not grad_needed(x, *self.parameters()):
            return window_channel_attention(nhwc, *weights).permute(0, 3, 1, 2)
        # training routes (local_attention_apply(fast="train"),
        # enhanced_generator.py:131-146)
        route = train_route(C)
        if x.device.type == "cpu" or route == "kernel":
            # convs in autograd around the hand-written mid
            qkv = conv(self.qkv, x).permute(0, 2, 3, 1)
            mid = window_channel_attention_train(qkv)
            return conv(self.proj, mid.permute(0, 3, 1, 2))
        # no training kernel at this width, in JAX either
        return window_channel_attention_fast_vjp(
            nhwc, *weights).permute(0, 3, 1, 2)


_MSB_BRANCHES = (  # (name, kernel, padding, dilation)
    ("branch1", 1, 0, 1),
    ("branch2", 3, 1, 1),
    ("branch3", 3, 2, 2),
    ("branch4", 3, 4, 4),
)


class MultiScaleBlock(nn.Module):
    """Four dilated branches, IN+ReLU over their concatenation, the 1x1
    fusion conv, IN+ReLU, and the residual (enhanced_generator.py:230-242).
    InstanceNorm is per channel, so one IN over the concatenation equals
    the reference's per-branch INs."""

    def __init__(self, channels: int):
        super().__init__()
        for name, k, p, d in _MSB_BRANCHES:
            setattr(self, name, nn.Sequential(
                nn.Conv2d(channels, channels // 4, k, padding=p, dilation=d)))
        self.fusion = nn.Sequential(nn.Conv2d(channels, channels, 1))

    def forward(self, x):
        h = torch.cat([conv(getattr(self, name)[0], x)
                       for name, *_ in _MSB_BRANCHES], dim=1)
        return in_relu(conv(self.fusion[0], in_relu(h))) + x


class _Stage(nn.Sequential):
    """conv (or transposed conv) -> IN+ReLU -> LocalAttention ->
    MultiScaleBlock, at the checkpoint's indices 0-4."""

    def __init__(self, first: nn.Module, channels: int):
        super().__init__(first, InstanceNorm(), nn.ReLU(),
                         LocalAttention(channels), MultiScaleBlock(channels))

    def forward(self, h):
        return self[4](self[3](in_relu(conv(self[0], h))))


class EnhancedGenerator(nn.Module):
    """A fresh module follows ``enhanced_generator_init``'s law
    (:260-295): Kaiming-normal fan_out convs with zero biases, the default
    law for the Linears, ``style_mod`` zero and unit/zero LayerNorms.
    ``generator`` is the ``torch.Generator`` it draws from (None: torch's
    default one). ``remat`` recomputes each stage and transformer block in
    the backward pass (``torch.utils.checkpoint``, as ``ckpt`` does at
    :339-395)."""

    def __init__(self, channels: int = 16, num_transformer_blocks: int = 1,
                 *, generator: torch.Generator | None = None,
                 remat: bool = False):
        super().__init__()
        c = channels
        self.remat = remat
        self.initial = nn.Sequential(nn.Conv2d(3, c, 7, padding=3),
                                     InstanceNorm(), nn.ReLU())
        self.down1 = _Stage(nn.Conv2d(c, 2 * c, 4, stride=2, padding=1), 2 * c)
        self.down2 = _Stage(nn.Conv2d(2 * c, 4 * c, 4, stride=2, padding=1),
                            4 * c)
        self.style_encoder = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Flatten(), nn.Linear(4 * c, 4 * c),
            nn.ReLU())
        self.transformer_blocks = nn.ModuleList(
            StructuralTransformerBlock(4 * c)
            for _ in range(num_transformer_blocks))
        self.up1 = _Stage(nn.ConvTranspose2d(4 * c, 2 * c, 4, stride=2,
                                             padding=1), 2 * c)
        self.up2 = _Stage(nn.ConvTranspose2d(2 * c, c, 4, stride=2,
                                             padding=1), c)
        self.output = nn.Sequential(nn.Conv2d(c, 3, 7, padding=3), nn.Tanh())
        self.reset_parameters(generator)
        self.fast_attention = True

    @property
    def fast_attention(self) -> bool:
        """True: the kernel routes. False: the plain versions of the
        attention and the block everywhere (``--no_fast_attention``)."""
        return self._fast_attention

    @fast_attention.setter
    def fast_attention(self, on: bool) -> None:
        self._fast_attention = bool(on)
        for m in self.modules():
            if isinstance(m, (LocalAttention, StructuralTransformerBlock)):
                m.fast = self._fast_attention

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        for m in self.modules():
            init_generator_module_(m, generator)
        for block in self.transformer_blocks:
            block.style_mod.weight.zero_()  # FiLM starts at identity
            block.style_mod.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 3, H, W) in [-1, 1], H and W divisible by 16 -> same."""
        if self.remat and torch.is_grad_enabled():
            run = lambda f, *a: checkpoint(f, *a, use_reentrant=False)
        else:
            run = lambda f, *a: f(*a)
        h = in_relu(conv(self.initial[0], x))
        h = run(self.down2, run(self.down1, h))
        style = torch.relu(linear(self.style_encoder[2], h.mean(dim=(2, 3))))
        tokens = h.contiguous(memory_format=CHANNELS_LAST).permute(0, 2, 3, 1)
        for block in self.transformer_blocks:
            tokens = run(block, tokens, style, x)
        h = run(self.up2, run(self.up1, tokens.permute(0, 3, 1, 2)))
        return torch.tanh(conv(self.output[0], h))


def num_transformer_blocks_of(state_dict) -> int:
    n = 0
    while any(k.startswith(f"transformer_blocks.{n}.") for k in state_dict):
        n += 1
    return n


def channels_of(state_dict) -> int:
    """Channel width from the stem kernel (``initial.0.weight``, OIHW)."""
    return int(state_dict["initial.0.weight"].shape[0])
