"""StructuralTransformerBlock (port of ``models/structural_transformer.py``).

The block conditions the bottleneck tokens on structure (two 3x3 stride-2
convs over the network input, projected) and on style (a FiLM of the
pre-attention norm), then runs the body: window-8 multi-head
self-attention and a GELU MLP, both pre-norm and residual.

Two routes for the body, as in the JAX package. Where autograd will need a
gradient, the training body (``_train_block_body``, :183-205): LN1 + FiLM,
the qkv Linear, the proj Linear, LN2 and the MLP in autograd around the
window-MHSA mid ``ops.kernels.window_mhsa_train``. Otherwise one call into
the inference kernel ``ops.kernels.fused_structural_block``. With ``fast``
off (the train CLI's ``--no_fast_attention``) the body is its plain version,
``structural_block_plain`` (the port of ``_block_body_math``), in autograd,
on any device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.activations import gelu
from ..core.conv import conv, linear
from ..ops.image import resize
from ..ops.kernels import (
    fused_structural_block, structural_block_plain, window_mhsa_train,
)
from ..ops.kernels._checks import grad_needed
from ..ops.kernels.fused_transformer import default_num_heads

__all__ = ["StructuralTransformerBlock", "default_num_heads"]


def _layer_norm(x, ln: nn.LayerNorm):
    """fp32 statistics and affine, one rounding to x's type (:89-94)."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps).to(x.dtype)


class _Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class _MLP(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)


class StructuralTransformerBlock(nn.Module):
    """One block at width ``dim``; parameter names are the checkpoint's
    (``struct_embed.{0,2}``, ``struct_proj``, ``style_mod``, ``norm{1,2}``,
    ``attn.{qkv,proj}``, ``mlp.{fc1,fc2}``). The EnhancedGenerator
    initializes it by ``structural_transformer_init``'s law."""

    def __init__(self, dim: int):
        super().__init__()
        self.struct_embed = nn.Sequential(
            nn.Conv2d(3, dim // 2, 3, stride=2, padding=1), nn.ReLU(),
            nn.Conv2d(dim // 2, dim, 3, stride=2, padding=1), nn.ReLU())
        self.struct_proj = nn.Linear(dim, dim)
        self.style_mod = nn.Linear(dim, 2 * dim)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.attn = _Attention(dim)
        self.mlp = _MLP(dim)
        self.fast = True   # False: the plain body (_block_body_math)

    def forward(self, tokens: torch.Tensor, style: torch.Tensor,
                orig: torch.Tensor) -> torch.Tensor:
        """tokens: (B, H, W, C) grid; style: (B, C); orig: the network
        input, (B, 3, 4H, 4W) in [-1, 1]. Returns (B, H, W, C), contiguous."""
        struct = self.structure(orig, tokens)
        gamma, beta = self.film(style)
        return self.body(tokens, struct, gamma, beta)

    def structure(self, orig: torch.Tensor,
                  tokens: torch.Tensor) -> torch.Tensor:
        """The structure tokens, (B, H, W, C) in tokens' type: two 3x3
        stride-2 convs over the network input (``struct_embed``), then
        ``struct_proj`` (:230-241)."""
        H, W = tokens.shape[1:3]
        s = torch.relu(conv(self.struct_embed[0], orig.to(tokens.dtype)))
        s = torch.relu(conv(self.struct_embed[2], s))
        s = s.permute(0, 2, 3, 1)
        if s.shape[1:3] != (H, W):
            # antialiased bilinear, as jax.image.resize (:237-238); an input
            # whose sides divide by 4 never reaches it
            s = resize(s, (H, W), method="bilinear").to(tokens.dtype)
        return linear(self.struct_proj, s)

    def film(self, style: torch.Tensor):
        """(gamma, beta), each (B, C): the style FiLM (``style_mod``,
        :243-245)."""
        return linear(self.style_mod, style).chunk(2, dim=-1)

    def body(self, tokens: torch.Tensor, struct: torch.Tensor,
             gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
        """The block body on (B, H, W, C) tokens with their structure tokens
        and FiLM: the training body where autograd will need a gradient,
        else the inference kernel (its plain version with ``fast`` off).
        The height-sharded forward calls it on window-aligned pieces of the
        token grid (``parallel.spatial``)."""
        if self.fast and grad_needed(tokens, struct, gamma, beta,
                                     *self.parameters()):
            return self._train_body(tokens, struct, gamma, beta)
        c = lambda t: t.to(tokens.dtype)
        body = fused_structural_block if self.fast else structural_block_plain
        return body(
            tokens.contiguous(), struct.contiguous(), gamma, beta,
            eps=self.norm1.eps,
            norm1_w=c(self.norm1.weight), norm1_b=c(self.norm1.bias),
            qkv_w=c(self.attn.qkv.weight), qkv_b=c(self.attn.qkv.bias),
            proj_w=c(self.attn.proj.weight), proj_b=c(self.attn.proj.bias),
            norm2_w=c(self.norm2.weight), norm2_b=c(self.norm2.bias),
            fc1_w=c(self.mlp.fc1.weight), fc1_b=c(self.mlp.fc1.bias),
            fc2_w=c(self.mlp.fc2.weight), fc2_b=c(self.mlp.fc2.bias))

    def _train_body(self, tokens, struct, gamma, beta):
        """``_train_block_body``: autograd around the window-MHSA mid."""
        C = tokens.shape[-1]
        h = _layer_norm(tokens + struct, self.norm1)
        h = h * (1.0 + gamma[:, None, None, :]) + beta[:, None, None, :]
        mid = window_mhsa_train(linear(self.attn.qkv, h),
                                default_num_heads(C))
        tokens = tokens + linear(self.attn.proj, mid)
        h = _layer_norm(tokens, self.norm2)
        return tokens + linear(self.mlp.fc2, gelu(linear(self.mlp.fc1, h)))
