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
and 2 hold the parameter-free InstanceNorm and ReLU.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.norm import InstanceNorm, in_relu
from ..ops.kernels import window_channel_attention
from .structural_transformer import StructuralTransformerBlock

CHANNELS_LAST = torch.channels_last


class LocalAttention(nn.Module):
    """Windowed channel attention over 4x4 windows; one kernel call."""

    def __init__(self, channels: int):
        super().__init__()
        self.qkv = nn.Conv2d(channels, 3 * channels, 1)
        self.proj = nn.Conv2d(channels, channels, 1)

    def forward(self, x):
        x = x.contiguous(memory_format=CHANNELS_LAST)
        y = window_channel_attention(
            x.permute(0, 2, 3, 1), self.qkv.weight, self.qkv.bias,
            self.proj.weight, self.proj.bias)
        return y.permute(0, 3, 1, 2)


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
        h = torch.cat([getattr(self, name)(x) for name, *_ in _MSB_BRANCHES],
                      dim=1)
        return in_relu(self.fusion(in_relu(h))) + x


def _stage(conv: nn.Module, channels: int) -> nn.Sequential:
    return nn.Sequential(conv, InstanceNorm(), nn.ReLU(),
                         LocalAttention(channels), MultiScaleBlock(channels))


class EnhancedGenerator(nn.Module):
    def __init__(self, channels: int = 16, num_transformer_blocks: int = 1):
        super().__init__()
        c = channels
        self.initial = nn.Sequential(nn.Conv2d(3, c, 7, padding=3),
                                     InstanceNorm(), nn.ReLU())
        self.down1 = _stage(nn.Conv2d(c, 2 * c, 4, stride=2, padding=1), 2 * c)
        self.down2 = _stage(nn.Conv2d(2 * c, 4 * c, 4, stride=2, padding=1),
                            4 * c)
        self.style_encoder = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Flatten(), nn.Linear(4 * c, 4 * c),
            nn.ReLU())
        self.transformer_blocks = nn.ModuleList(
            StructuralTransformerBlock(4 * c)
            for _ in range(num_transformer_blocks))
        self.up1 = _stage(nn.ConvTranspose2d(4 * c, 2 * c, 4, stride=2,
                                             padding=1), 2 * c)
        self.up2 = _stage(nn.ConvTranspose2d(2 * c, c, 4, stride=2,
                                             padding=1), c)
        self.output = nn.Sequential(nn.Conv2d(c, 3, 7, padding=3), nn.Tanh())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 3, H, W) in [-1, 1], H and W divisible by 16 -> same."""
        h = self.down2(self.down1(self.initial(x)))
        style = self.style_encoder(h)
        tokens = h.contiguous(memory_format=CHANNELS_LAST).permute(0, 2, 3, 1)
        for block in self.transformer_blocks:
            tokens = block(tokens, style, x)
        h = self.up2(self.up1(tokens.permute(0, 3, 1, 2)))
        return self.output(h)


def num_transformer_blocks_of(state_dict) -> int:
    n = 0
    while any(k.startswith(f"transformer_blocks.{n}.") for k in state_dict):
        n += 1
    return n


def channels_of(state_dict) -> int:
    """Channel width from the stem kernel (``initial.0.weight``, OIHW)."""
    return int(state_dict["initial.0.weight"].shape[0])
