"""Normalization primitives (PyTorch port of ``core/norm.py``).

Statistics are always taken in fp32, whatever the activation dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``InstanceNorm2d`` with PyTorch defaults (affine=False, biased
    variance) over the H, W axes of a (B, C, H, W) tensor.

    The JAX package takes two-pass fp32 statistics for fp32 inputs and
    one-pass E[x^2] - E[x]^2 ones for bf16 (core/norm.py:115-135). Under
    autograd this takes the same two passes, whose backward (through
    x - mean and its square) is the JAX one: ``torch.var_mean``'s backward
    left the fp32 generator gradient at c4, 32^2 6.4e-4 of a tensor's
    largest element from float64, against 3.3e-4 for the two passes, and
    that spread made two chained fp32 train steps drift 1-2% from JAX's.
    Without autograd every dtype gets fp32 ``torch.var_mean`` (Welford: as
    accurate as two passes, one read); for bf16 activations the gap
    between the formulations is far below bf16's own rounding.
    """
    xf = x.float()
    if torch.is_grad_enabled() and xf.requires_grad:
        d = xf - xf.mean(dim=(2, 3), keepdim=True)
        var = d.square().mean(dim=(2, 3), keepdim=True)
        return (d * torch.rsqrt(var + eps)).to(x.dtype)
    var, mean = torch.var_mean(xf, dim=(2, 3), correction=0, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class _InAct(torch.autograd.Function):
    """IN -> (leaky-)ReLU with one-pass fp32 statistics and the hand-written
    backward of ``_in_act`` (core/norm.py:62-101). It saves only xhat, in
    the input's type, and the (B, C, 1, 1) rstd; the activation mask is
    recomputed from xhat."""

    @staticmethod
    def forward(ctx, x, eps: float, slope: float):
        xf = x.float()
        mean = xf.mean(dim=(2, 3), keepdim=True)
        meansq = xf.square().mean(dim=(2, 3), keepdim=True)
        rstd = torch.rsqrt(torch.clamp_min(meansq - mean.square(), 0.0) + eps)
        xhat = (xf - mean) * rstd
        ctx.slope = slope
        ctx.save_for_backward(xhat.to(x.dtype), rstd)
        return torch.where(xhat > 0, xhat, slope * xhat).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        xhat, rstd = ctx.saved_tensors
        xh = xhat.float()
        g = dy.float() * torch.where(xh > 0, 1.0, ctx.slope)
        # d/dx of xhat = (x - mean) * rstd with biased-variance statistics:
        #   dx = rstd * (g - mean_HW(g) - xhat * mean_HW(g * xhat))
        gm = g.mean(dim=(2, 3), keepdim=True)
        gxm = (g * xh).mean(dim=(2, 3), keepdim=True)
        return (rstd * (g - gm - xh * gxm)).to(xhat.dtype), None, None


def _fused(x: torch.Tensor) -> bool:
    """bf16 under autograd takes ``_InAct``, as the JAX package's bf16 does;
    fp32 keeps two-pass-accurate statistics under autograd (one-pass
    statistics drift ~2e-3 over the generator's 13 INs,
    core/norm.py:127-131). Without autograd the hand-written backward has
    nothing to do, and the single-read Welford statistics of
    :func:`instance_norm` are the cheaper forward."""
    return (x.dtype != torch.float32 and torch.is_grad_enabled()
            and x.requires_grad)


def in_relu(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``relu(instance_norm(x))`` (see :func:`_fused` for the route)."""
    if _fused(x):
        return _InAct.apply(x, eps, 0.0)
    return torch.relu(instance_norm(x, eps))


def in_leaky_relu(x: torch.Tensor, slope: float = 0.2,
                  eps: float = 1e-5) -> torch.Tensor:
    """``leaky_relu(instance_norm(x), slope)``, the discriminator's flavor
    of :func:`in_relu` (core/norm.py:138-143)."""
    if _fused(x):
        return _InAct.apply(x, eps, slope)
    y = instance_norm(x, eps)
    return torch.where(y > 0, y, slope * y)


def batch_norm(x: torch.Tensor, running_mean: torch.Tensor,
               running_var: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor, *, training: bool = False,
               momentum: float = 0.1, eps: float = 1e-5) -> torch.Tensor:
    """``BatchNorm2d`` over the B, H, W axes of a (B, C, H, W) tensor
    (core/norm.py:146-171): statistics and affine in fp32 whatever x's
    type, one rounding back to it.

    Eval mode normalizes with the running statistics. Training mode
    normalizes with the biased batch variance and updates the fp32 running
    buffers IN PLACE (the JAX function returns them), the variance's with
    the unbiased estimate, as PyTorch does. Under data parallelism the
    batch is the GLOBAL batch (:func:`_batch_norm_global`), as under the
    JAX package's sharded batch axis.
    """
    if training and mesh.active():
        return _batch_norm_global(x, running_mean, running_var, weight, bias,
                                  momentum, eps)
    return F.batch_norm(x.float(), running_mean, running_var, weight.float(),
                        bias.float(), training, momentum, eps).to(x.dtype)


def _batch_norm_global(x, running_mean, running_var, weight, bias, momentum,
                       eps):
    """Training-mode :func:`batch_norm` over the global batch of every rank.

    Each rank's sum and sum of squares per channel (float64, so the one-pass
    variance keeps fp32's accuracy) cross in one all-reduce; the output is
    normalized with the global mean and biased variance in fp32 and rounded
    back to x's type once, and the running variance takes the unbiased
    estimate over the global count. The all-reduce is differentiable: its
    backward all-reduces the gradients of the sums (SyncBatchNorm's rule),
    so with the parameter gradients averaged over the ranks the step takes
    the gradient of the global mean loss."""
    xf = x.float()
    xd = xf.double()
    sums = mesh.all_reduce_sum(torch.cat([xd.sum(dim=(0, 2, 3)),
                                          xd.square().sum(dim=(0, 2, 3))]))
    n = x.shape[0] * x.shape[2] * x.shape[3] * mesh.world_size()
    mean, meansq = (sums / n).chunk(2)
    var = torch.clamp_min(meansq - mean.square(), 0.0).float()
    mean = mean.float()
    with torch.no_grad():
        running_mean.mul_(1 - momentum).add_(momentum * mean)
        running_var.mul_(1 - momentum).add_(
            momentum * (var * (n / max(n - 1, 1))))
    scale = torch.rsqrt(var + eps)[:, None, None]
    out = (xf - mean[:, None, None]) * scale
    out = out * weight.float()[:, None, None] + bias.float()[:, None, None]
    return out.to(x.dtype)


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


def spectral_normalize(w_orig: torch.Tensor, u: torch.Tensor,
                       v: torch.Tensor | None = None, *,
                       n_power_iterations: int = 1, eps: float = 1e-12,
                       update: bool = True):
    """Spectral normalization of a conv kernel (core/norm.py:174-220).

    w_orig: (O, I, kh, kw), reshaped to the (O, I*kh*kw) matrix of
    ``nn.utils.spectral_norm``, so ``u`` (O,) and ``v`` (I*kh*kw,) are in
    torch's own order. update=True runs ``n_power_iterations`` steps of
    power iteration from ``u`` (v is recomputed, its input ignored) and
    returns the new u and v detached; update=False reuses ``v`` (or derives
    it from u when None). The gradient reaches w_orig through sigma, as in
    torch's hook. Returns (w_orig / sigma, u, v).
    """
    mat = w_orig.reshape(w_orig.shape[0], -1).float()

    def l2n(t):
        return t / (torch.linalg.vector_norm(t) + eps)

    uu = u.float()
    if update:
        with torch.no_grad():
            for _ in range(n_power_iterations):
                v = l2n(mat.t() @ uu)
                uu = l2n(mat @ v)
    elif v is None:
        v = l2n(mat.t() @ uu).detach()
    else:
        v = v.float()
    sigma = uu @ (mat @ v)
    return (w_orig / sigma).to(w_orig.dtype), uu.to(u.dtype), v


class InstanceNorm(nn.Module):
    """Parameter-free module form of :func:`instance_norm`; it fills the
    IN slot of the checkpoint's ``nn.Sequential`` layouts."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        return instance_norm(x, self.eps)

