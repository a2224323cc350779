"""LocalAttention under grad where no training kernel is built: the JAX
package's ``_attention_fast_vjp`` (models/enhanced_generator.py:87-112).

JAX trains the channel attention through its hand-written kernel pair
(``window_channel_attention_train``) only at C <= 64
(ops/pallas/window_attention_train.py:55-64). At any other width, the c32
generator's down2 at C = 128 among them, ``local_attention_apply(fast=
"train")`` takes ``_attention_fast_vjp`` (:131-146): the forward is the
inference kernel, and the backward is XLA's VJP of ``_attention_math``
(:168-205), recomputed from the saved inputs. The port does the same:

- the forward launches row 1's kernel, ``window_channel_attention``
  (``csrc/window_channel_attention.cu``, built at C = 128 for serving);
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

FAST_VJP_WIDTHS = (128,)   # LocalAttention widths that train through this route


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
