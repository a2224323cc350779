"""The plain encoder-decoder CycleGAN generator (port of
``models/plain_generator.py``; the reference's ``Generator``,
pretrain.py:60-97).

Four stride-2 4x4 convs (BatchNorm + LeakyReLU 0.2 after all but the
first) down to 8C channels, four stride-2 4x4 transposed convs (BatchNorm +
ReLU after all but the last) back up, Tanh output, no skip connections and
no attention: nothing here launches a hand-written kernel.

The ``nn.Sequential`` indices are the reference checkpoint's: convs at
``encoder.{0,2,5,8}``, BatchNorms at ``encoder.{3,6,9}``, transposed convs
at ``decoder.{0,3,6,9}``, BatchNorms at ``decoder.{1,4,7}``, each BatchNorm
with its ``num_batches_tracked``, so a reference ``.pth`` loads with
``strict=True``. Convs cast their weights to the activation's type at use
(``core.conv``); BatchNorm takes fp32 statistics and affine whatever that
type (``core.batch_norm``), so a bf16 copy keeps its BatchNorms in fp32.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.conv import conv
from ..core.norm import batch_norm
from .init_utils import init_generator_module_


def _down(cin: int, cout: int, norm: bool):
    conv_ = nn.Conv2d(cin, cout, 4, stride=2, padding=1)
    tail = [nn.BatchNorm2d(cout)] if norm else []
    return [conv_, *tail, nn.LeakyReLU(0.2)]


def _up(cin: int, cout: int, last: bool):
    conv_ = nn.ConvTranspose2d(cin, cout, 4, stride=2, padding=1)
    if last:
        return [conv_, nn.Tanh()]
    return [conv_, nn.BatchNorm2d(cout), nn.ReLU()]


class PlainGenerator(nn.Module):
    """A fresh module follows ``plain_generator_init``'s law: Kaiming-normal
    fan_out convs with zero biases, unit/zero BatchNorm affines, zero/unit
    running statistics. ``generator`` is the ``torch.Generator`` it draws
    from (None: torch's default one)."""

    def __init__(self, channels: int = 64, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        c = channels
        self.encoder = nn.Sequential(
            *_down(3, c, False), *_down(c, 2 * c, True),
            *_down(2 * c, 4 * c, True), *_down(4 * c, 8 * c, True))
        self.decoder = nn.Sequential(
            *_up(8 * c, 4 * c, False), *_up(4 * c, 2 * c, False),
            *_up(2 * c, c, False), *_up(c, 3, True))
        with torch.no_grad():
            for m in self.modules():
                init_generator_module_(m, generator)

    def _bn(self, m: nn.BatchNorm2d, h: torch.Tensor) -> torch.Tensor:
        if self.training:
            m.num_batches_tracked.add_(1)
        return batch_norm(h, m.running_mean, m.running_var, m.weight, m.bias,
                          training=self.training, momentum=m.momentum,
                          eps=m.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 3, H, W) in [-1, 1], H and W divisible by 16 -> same. In
        train mode BatchNorm normalizes with batch statistics and updates
        its running buffers, as ``plain_generator_apply(training=True)``."""
        h = x
        for m in (*self.encoder, *self.decoder):
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                h = conv(m, h)
            elif isinstance(m, nn.BatchNorm2d):
                h = self._bn(m, h)
            elif isinstance(m, nn.LeakyReLU):
                # where(x >= 0, ...) as the JAX leaky_relu: its gradient at
                # an exact 0 is 1, F.leaky_relu's the slope, and the first
                # conv gives exact 0s over the masked patches in pretraining
                h = torch.where(h >= 0, h, h * m.negative_slope)
            else:
                h = m(h)
        return h

    def cast_convs_(self, dtype: torch.dtype) -> "PlainGenerator":
        """The conv weights in ``dtype``, the BatchNorms left in fp32 (the
        JAX package normalizes with fp32 statistics and affine,
        core/norm.py:158-171): the serving program's bf16 copy."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                m.to(dtype=dtype)
        return self
