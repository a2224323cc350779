"""Normalization primitives (PyTorch port of ``core/norm.py``).

Statistics are always taken in fp32, whatever the activation dtype.
"""

from __future__ import annotations

import torch
from torch import nn


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``InstanceNorm2d`` with PyTorch defaults (affine=False, biased
    variance) over the H, W axes of a (B, C, H, W) tensor.

    The JAX package takes two-pass fp32 statistics for fp32 inputs and
    one-pass E[x^2] - E[x]^2 ones for bf16 (core/norm.py:115-135). Here
    every dtype gets fp32 ``torch.var_mean`` (Welford: as accurate as two
    passes, one read); for bf16 activations the gap between the two
    formulations is far below bf16's own rounding.
    """
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=(2, 3), correction=0, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def in_relu(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``relu(instance_norm(x))``."""
    return torch.relu(instance_norm(x, eps))


def l2_normalize(u: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Zero-safe ``F.normalize`` over the last axis, fp32 result.

    A vector of exact zeros gives zeros (and a finite gradient: the square
    root never sees 0), as ``core/norm.py:223-237`` does.
    """
    uf = u.float()
    ss = uf.square().sum(dim=-1, keepdim=True)
    zero = ss == 0
    n = torch.where(zero, 0.0, torch.sqrt(torch.where(zero, 1.0, ss)))
    return uf / torch.clamp_min(n, eps)


class InstanceNorm(nn.Module):
    """Parameter-free module form of :func:`instance_norm`; it fills the
    IN slot of the checkpoint's ``nn.Sequential`` layouts."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        return instance_norm(x, self.eps)
