"""Loss functions (port of ``train/losses.py``): the reference's recipe,
MSE for the GAN terms (LSGAN), L1 for cycle, identity and structure, and
the masked L1 of inpainting pretraining. Every reduction is fp32, whatever
the activation type."""

from __future__ import annotations

import torch


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() - b.float()).abs().mean()


def mse_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() - b.float()).square().mean()


def lsgan_loss(scores: torch.Tensor, target: float) -> torch.Tensor:
    """MSE against a constant target (criterion_gan of the reference)."""
    return (scores.float() - target).square().mean()


def masked_l1(pred: torch.Tensor, target: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """L1 on the dropped patches only, L1(pred (1 - m), target (1 - m)),
    normalized over ALL pixels as the reference does (pretrain.py:162), not
    over the dropped count."""
    keep = (1.0 - mask).float()
    return l1_loss(pred.float() * keep, target.float() * keep)
