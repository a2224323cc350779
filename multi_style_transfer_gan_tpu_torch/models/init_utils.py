"""Weight initializers (port of ``models/init_utils.py``).

The reference initializes convs Kaiming-normal (mode='fan_out',
nonlinearity='relu') with zero biases (enhanced_generator.py:152-161 of the
reference); linear layers and the discriminator's convs keep PyTorch's
default uniform law. Every draw comes from an explicit ``torch.Generator``
(None draws from torch's default one). JAX and torch draw different numbers
from the same seed, so only the laws match, not the values.

Shapes are given as (kh, kw, in, out), as in the JAX package; the returned
weight is in PyTorch's layout: (out, in, kh, kw) for a conv, (in, out, kh,
kw) for a transposed conv.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def _torch_layout(shape_hwio, transposed: bool):
    kh, kw, cin, cout = shape_hwio
    return (cin, cout, kh, kw) if transposed else (cout, cin, kh, kw)


def _uniform(shape, bound: float, generator):
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


def kaiming_conv(shape_hwio, generator=None, *, mode: str = "fan_out",
                 transposed: bool = False):
    """He-normal conv weight, std sqrt(2 / fan), and a zero bias."""
    kh, kw, cin, cout = shape_hwio
    fan = (cout if mode == "fan_out" else cin) * kh * kw
    w = torch.randn(_torch_layout(shape_hwio, transposed),
                    generator=generator) * math.sqrt(2.0 / fan)
    return w, torch.zeros(cout)


def torch_default_conv(shape_hwio, generator=None, *, transposed: bool = False):
    """PyTorch's default Conv2d law: weight and bias U(-b, b), b =
    1/sqrt(fan_in)."""
    kh, kw, cin, cout = shape_hwio
    bound = 1.0 / math.sqrt(cin * kh * kw)
    return (_uniform(_torch_layout(shape_hwio, transposed), bound, generator),
            _uniform((cout,), bound, generator))


def torch_default_linear(out_features: int, in_features: int, generator=None):
    """PyTorch's default Linear law: weight and bias U(-b, b), b =
    1/sqrt(in_features)."""
    bound = 1.0 / math.sqrt(in_features)
    return (_uniform((out_features, in_features), bound, generator),
            _uniform((out_features,), bound, generator))


def conv_shape_hwio(m: nn.Module):
    """(kh, kw, in, out) of a Conv2d or ConvTranspose2d."""
    kh, kw = m.kernel_size
    return kh, kw, m.in_channels, m.out_channels


@torch.no_grad()
def init_generator_module_(m: nn.Module, generator=None) -> None:
    """Apply the generator's law to one leaf module in place: Kaiming
    fan_out convs with zero biases, default-law Linears, unit/zero
    LayerNorms (enhanced_generator_init, structural_transformer_init)."""
    if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
        w, b = kaiming_conv(conv_shape_hwio(m), generator,
                            transposed=isinstance(m, nn.ConvTranspose2d))
    elif isinstance(m, nn.Linear):
        w, b = torch_default_linear(m.out_features, m.in_features, generator)
    elif isinstance(m, nn.LayerNorm):
        w, b = torch.ones_like(m.weight), torch.zeros_like(m.bias)
    else:
        return
    m.weight.copy_(w)
    m.bias.copy_(b)
