"""LocalAttention under grad where no training kernel is built: the JAX
package's ``_attention_fast_vjp`` (models/enhanced_generator.py:87-112).

JAX trains the channel attention through its hand-written kernel pair
(``window_channel_attention_train``) only where ``supports_train_kernel``
holds (ops/pallas/window_attention_train.py:55-64, 274-277: 128 % C == 0,
C <= 64 and a window count that the group size 128 / C divides). At any
other width, every LocalAttention call of a generator whose width is not a
power of two (c3's C = 3, 6, 12; c24's 24, 48, 96; c60's 60, 120, 240),
c32's down2 at C = 128 and c64's down1, up1 (C = 128) and down2 (C = 256)
among them,
``local_attention_apply(fast="train")`` takes ``_attention_fast_vjp``
(:131-146): the forward is the inference kernel, and the backward is XLA's
VJP of ``_attention_math`` (:168-205), recomputed from the saved inputs.
The port does the same (``train_route`` is the choice, as a function of C):

- the forward launches row 1's kernel, ``window_channel_attention``
  (``csrc/window_channel_attention.cu``, any C);
- the backward recomputes ``window_channel_attention_plain``, the port of
  ``_attention_math`` (the qkv 1x1 product, the window partition, the
  zero-safe L2 normalize, the Gram, its softmax, the apply and the proj,
  in fp32), under autograd from the saved x and weights and returns its
  VJP. It is plain PyTorch because in JAX it is XLA code, not a Pallas
  kernel.

The forward and the backward differ as the JAX pair does: the backward is
the gradient of the formulation, not of the kernel's bf16 roundings.
"""

from __future__ import annotations

import torch

from .window_attention import (
    window_channel_attention, window_channel_attention_plain,
)
from .window_attention_train import KERNEL_WIDTHS as TRAIN_KERNEL_WIDTHS


def train_route(C: int) -> str:
    """How LocalAttention at width C trains on the card: "kernel" (the
    hand-written pair, ``window_channel_attention_train``, at the widths
    where JAX's ``supports_train_kernel`` can hold: C = 1, 2, 4, 8, 16, 32,
    64) or "fast_vjp" (this route: every other C, all of which the
    inference kernel takes). The choice is by C alone: JAX also asks that
    the group size 128 / C divide the window count (C = 1 takes its kernel
    only with 128 | windows), and takes this route where it does not; both
    routes compute the same function and its exact gradient."""
    return "kernel" if C in TRAIN_KERNEL_WIDTHS else "fast_vjp"


class _FastVJP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wproj, bproj, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, wqkv, bqkv, wproj, bproj)
        return window_channel_attention(x, wqkv, bqkv, wproj, bproj, eps=eps)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            out = window_channel_attention_plain(*inputs, eps=ctx.eps)
        return (*torch.autograd.grad(out, inputs, g.to(out.dtype)), None)


def window_channel_attention_fast_vjp(x, wqkv, bqkv, wproj, bproj, *,
                                      eps: float = 1e-12) -> torch.Tensor:
    """LocalAttention on a contiguous (B, H, W, C) tensor with the JAX
    package's training-grade VJP: the forward is
    ``window_channel_attention`` (the kernel on a CUDA tensor, which raises
    at a width it is not built for; the plain version on a CPU tensor), the
    backward the VJP of ``window_channel_attention_plain`` recomputed from
    the saved inputs. Gradients reach x and all four weights."""
    return _FastVJP.apply(x, wqkv, bqkv, wproj, bproj, eps)
