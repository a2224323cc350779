"""Activations (PyTorch port of ``core/activations.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU with the exact erf, like ``jax.nn.gelu(approximate=False)``."""
    return F.gelu(x, approximate="none")


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    """``where(x >= 0, x, negative_slope * x)``."""
    return F.leaky_relu(x, negative_slope)
