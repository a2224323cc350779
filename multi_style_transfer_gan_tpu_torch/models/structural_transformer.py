"""StructuralTransformerBlock (port of ``models/structural_transformer.py``).

The block conditions the bottleneck tokens on structure (two 3x3 stride-2
convs over the network input, projected) and on style (a FiLM of the
pre-attention norm), then runs the fused body: window-8 multi-head
self-attention and a GELU MLP, both pre-norm and residual. The body is one
call into ``ops.kernels.fused_structural_block``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.kernels import fused_structural_block
from ..ops.kernels.fused_transformer import default_num_heads

__all__ = ["StructuralTransformerBlock", "default_num_heads"]


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
    ``attn.{qkv,proj}``, ``mlp.{fc1,fc2}``)."""

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

    def forward(self, tokens: torch.Tensor, style: torch.Tensor,
                orig: torch.Tensor) -> torch.Tensor:
        """tokens: (B, H, W, C) grid; style: (B, C); orig: the network
        input, (B, 3, 4H, 4W) in [-1, 1]. Returns (B, H, W, C), contiguous."""
        B, H, W, C = tokens.shape
        s = self.struct_embed(orig)
        if s.shape[-2:] != (H, W):
            # The JAX block resizes with jax.image.resize (antialiased
            # bilinear), which F.interpolate does not reproduce; inputs
            # whose sides divide by 16 never reach it.
            raise NotImplementedError(
                f"struct-embed resize from {tuple(s.shape[-2:])} to {(H, W)} "
                f"is not ported (input sides must be multiples of 16; "
                f"ROADMAP.md lists the resize branch)")
        struct = self.struct_proj(s.permute(0, 2, 3, 1))
        gamma, beta = self.style_mod(style).chunk(2, dim=-1)
        return fused_structural_block(
            tokens.contiguous(), struct.contiguous(), gamma, beta,
            eps=self.norm1.eps,
            norm1_w=self.norm1.weight, norm1_b=self.norm1.bias,
            qkv_w=self.attn.qkv.weight, qkv_b=self.attn.qkv.bias,
            proj_w=self.attn.proj.weight, proj_b=self.attn.proj.bias,
            norm2_w=self.norm2.weight, norm2_b=self.norm2.bias,
            fc1_w=self.mlp.fc1.weight, fc1_b=self.mlp.fc1.bias,
            fc2_w=self.mlp.fc2.weight, fc2_b=self.mlp.fc2.bias)
