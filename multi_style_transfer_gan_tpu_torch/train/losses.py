"""Loss functions (port of ``train/losses.py``): the reference's recipe,
MSE for the GAN terms (LSGAN) and L1 for cycle, identity and structure.
Every reduction is fp32, whatever the activation type."""

from __future__ import annotations

import torch


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() - b.float()).abs().mean()


def mse_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() - b.float()).square().mean()


def lsgan_loss(scores: torch.Tensor, target: float) -> torch.Tensor:
    """MSE against a constant target (criterion_gan of the reference)."""
    return (scores.float() - target).square().mean()
