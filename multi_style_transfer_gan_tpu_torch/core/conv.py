"""Convolutions and Linears with the JAX package's dtype policy (port of
``core/conv.py``): the weights are cast to the activation's type at use
(:60, :166), so fp32 parameters run in bf16 compute and receive fp32
gradients. ``nn.Conv2d``, ``nn.ConvTranspose2d`` and ``nn.Linear`` carry the
semantics (strides, padding, layouts) that the JAX file re-derives."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _cast(t, x):
    return None if t is None else t.to(x.dtype)


def conv(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``m`` (a Conv2d or ConvTranspose2d) applied with its weights cast to
    x's type."""
    if isinstance(m, nn.ConvTranspose2d):
        return F.conv_transpose2d(x, _cast(m.weight, x), _cast(m.bias, x),
                                  m.stride, m.padding, m.output_padding,
                                  m.groups, m.dilation)
    return F.conv2d(x, _cast(m.weight, x), _cast(m.bias, x), m.stride,
                    m.padding, m.dilation, m.groups)


def linear(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``m`` applied with its weights cast to x's type."""
    return F.linear(x, _cast(m.weight, x), _cast(m.bias, x))
