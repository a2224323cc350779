"""Packed (space-to-depth) EnhancedGenerator forward (port of
``models/packed_generator.py``).

Runs the EnhancedGenerator math on s2d(4) tensors (``ops/packed.py``):
the 4x4 LocalAttention windows are packed pixels, every conv is a repacked
conv on 16x wider channels, and the transformer block runs its fused kernel
on the bottleneck grid between two relayouts. On a CUDA tensor one forward
launches the packed-row attention kernel 4 times, the relayout kernel 5
times (s2d of the input; d2s of tokens and struct and s2d of the block's
output; d2s of the result) and the block kernel once.

    packed = PackedEnhancedGenerator(generator)   # repacks once per load
    y = packed(x)                                  # (B, 3, H, W) -> same

H and W must be multiples of 16, the NHWC generator's own rule: the
packed convs then meet the NHWC grid at every stage, and the struct embed
lands on the token grid (JAX's resize branch, :253-256, is reached only
off that rule, where the packed engine's stages no longer match the NHWC
generator's). The block runs on the unpacked bottleneck grid, whose side
at a multiple of 16 but not of 32 is 4 mod 8: a ragged window-8 grid,
padded with the padded keys masked out of the softmax as in the NHWC
block. The JAX package's packed route for that grid
(``_packed_window8_mhsa``, :198-239) zero-pads qkv without the mask and so
computes another function than its own NHWC generator (up to 1.96 apart
at c4, 48 x 80); this engine keeps the NHWC generator's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels import fused_structural_block
from ..ops.packed import (
    depth_to_space, pack_conv2d_spec, pack_conv2d_weight,
    pack_conv_transpose2d_spec, pack_conv_transpose2d_weight, packed_conv2d,
    packed_conv_transpose2d, packed_global_avg_pool, packed_instance_norm,
    packed_per_channel_linear, packed_window_channel_attention,
    space_to_depth,
)
from .enhanced_generator import _MSB_BRANCHES, num_transformer_blocks_of

PACK = 4   # packing factor == LocalAttention window size
P = PACK * PACK
MULTIPLE = 16
_BLOCK_WEIGHTS = {"norm1_w": "norm1.weight", "norm1_b": "norm1.bias",
                  "qkv_w": "attn.qkv.weight", "qkv_b": "attn.qkv.bias",
                  "proj_w": "attn.proj.weight", "proj_b": "attn.proj.bias",
                  "norm2_w": "norm2.weight", "norm2_b": "norm2.bias",
                  "fc1_w": "mlp.fc1.weight", "fc1_b": "mlp.fc1.bias",
                  "fc2_w": "mlp.fc2.weight", "fc2_b": "mlp.fc2.bias"}


# ---------------------------------------------------------------------------
# Parameter packing (once per model load)
# ---------------------------------------------------------------------------

def pack_enhanced_generator_params(state_dict, dtype=None) -> dict:
    """Repack an EnhancedGenerator ``state_dict`` for the packed forward
    (JAX :46-104), on the CPU.

    Convs become packed OIHW kernels, the transposed convs packed IOHW
    kernels, biases are tiled over the 16 phases; the 1x1 convs of
    LocalAttention and of the MultiScaleBlock become (out, in) matrices;
    the transformer blocks' Linears and norms and the style Linear are
    kept. ``dtype`` casts every entry (the program's compute type).
    """
    sd = {k: v.detach().cpu() for k, v in state_dict.items()}
    p = {}

    def conv(key, **kw):
        p[f"{key}.weight"], p[f"{key}.bias"], _ = pack_conv2d_weight(
            sd[f"{key}.weight"], sd[f"{key}.bias"], f_in=PACK, f_out=PACK,
            **kw)

    def convt(key, **kw):
        p[f"{key}.weight"], p[f"{key}.bias"], _ = pack_conv_transpose2d_weight(
            sd[f"{key}.weight"], sd[f"{key}.bias"], f_in=PACK, f_out=PACK,
            **kw)

    def matrix(key):
        w = sd[f"{key}.weight"]
        p[f"{key}.weight"] = w.reshape(w.shape[0], w.shape[1])
        p[f"{key}.bias"] = sd[f"{key}.bias"]

    conv("initial.0", stride=1, padding=3)
    for name in ("down1", "down2"):
        conv(f"{name}.0", stride=2, padding=1)
    for name in ("up1", "up2"):
        convt(f"{name}.0", stride=2, padding=1)
    conv("output.0", stride=1, padding=3)
    for name in ("down1", "down2", "up1", "up2"):
        matrix(f"{name}.3.qkv")
        matrix(f"{name}.3.proj")
        matrix(f"{name}.4.branch1.0")
        matrix(f"{name}.4.fusion.0")
        for bname, _, pad, dil in _MSB_BRANCHES[1:]:
            conv(f"{name}.4.{bname}.0", stride=1, padding=pad, dilation=dil)
    for i in range(num_transformer_blocks_of(sd)):
        pre = f"transformer_blocks.{i}."
        conv(f"{pre}struct_embed.0", stride=2, padding=1)
        conv(f"{pre}struct_embed.2", stride=2, padding=1)
        for k in ("struct_proj", "style_mod", "attn.qkv", "attn.proj",
                  "mlp.fc1", "mlp.fc2", "norm1", "norm2"):
            for suf in ("weight", "bias"):
                p[f"{pre}{k}.{suf}"] = sd[f"{pre}{k}.{suf}"]
    for suf in ("weight", "bias"):
        p[f"style_encoder.2.{suf}"] = sd[f"style_encoder.2.{suf}"]
    if dtype is not None:
        p = {k: v.to(dtype) for k, v in p.items()}
    return p


# ---------------------------------------------------------------------------
# The forward on packed NHWC tensors
# ---------------------------------------------------------------------------

def _attention(p, x, prefix):
    """LocalAttention on packed rows: the packed-row kernel at every width
    (JAX :111-162 dispatches three Pallas kernels and a layout hop by
    width and window count; those were TPU VMEM and MXU limits)."""
    return packed_window_channel_attention(
        x, p[f"{prefix}qkv.weight"], p[f"{prefix}qkv.bias"],
        p[f"{prefix}proj.weight"], p[f"{prefix}proj.bias"])


def _msb(p, x, prefix, c):
    """MultiScaleBlock on packed tensors (JAX :165-187)."""
    outs = []
    for bname, k, pad, dil in _MSB_BRANCHES:
        key = f"{prefix}{bname}.0"
        if k == 1:
            h = packed_per_channel_linear(x, p[f"{key}.weight"],
                                          p[f"{key}.bias"], PACK)
        else:
            spec = pack_conv2d_spec(k, f_in=PACK, f_out=PACK, stride=1,
                                    padding=pad, dilation=dil)
            h = packed_conv2d(x, p[f"{key}.weight"], p[f"{key}.bias"], spec)
        outs.append(h)
    # interleave the phases so the concatenation has the original channel
    # order; IN is per channel, so one IN + ReLU after it equals the
    # per-branch ones
    B, Hp, Wp, _ = x.shape
    h = torch.cat([o.reshape(B, Hp, Wp, P, c // 4) for o in outs], dim=-1)
    h = torch.relu(packed_instance_norm(h.reshape(B, Hp, Wp, P * c), PACK))
    h = packed_per_channel_linear(h, p[f"{prefix}fusion.0.weight"],
                                  p[f"{prefix}fusion.0.bias"], PACK)
    return torch.relu(packed_instance_norm(h, PACK)) + x


def _packed_transformer_block(p, tokens_p, style, xp_input, prefix):
    """StructuralTransformerBlock on packed tensors, the grid route (JAX
    :241-281): the struct embed as two packed stride-2 convs on the packed
    input, FiLM from the style vector, then the fused block kernel on the
    unpacked bottleneck grid (ragged where the packed grid is odd) between
    two d2s and one s2d."""
    g = lambda n: p[f"{prefix}{n}"]
    B, Hp, Wp, _ = tokens_p.shape
    spec = pack_conv2d_spec(3, f_in=PACK, f_out=PACK, stride=2, padding=1)
    s = torch.relu(packed_conv2d(xp_input, g("struct_embed.0.weight"),
                                 g("struct_embed.0.bias"), spec))
    s = torch.relu(packed_conv2d(s, g("struct_embed.2.weight"),
                                 g("struct_embed.2.bias"), spec))
    struct = packed_per_channel_linear(s, g("struct_proj.weight"),
                                       g("struct_proj.bias"), PACK)
    mod = F.linear(style, g("style_mod.weight").to(style.dtype),
                   g("style_mod.bias").to(style.dtype))
    gamma, beta = mod.chunk(2, dim=-1)
    out = fused_structural_block(
        depth_to_space(tokens_p, PACK), depth_to_space(struct, PACK),
        gamma, beta, eps=1e-5,
        **{n: g(k).to(tokens_p.dtype) for n, k in _BLOCK_WEIGHTS.items()})
    return space_to_depth(out, PACK)


def packed_enhanced_generator_apply(p, x: torch.Tensor) -> torch.Tensor:
    """EnhancedGenerator forward on s2d(4) tensors (JAX :305-354).

    p: the packed weights (:func:`pack_enhanced_generator_params`), in x's
    type; x: (B, H, W, 3) in [-1, 1], H and W multiples of 16. Returns
    (B, H, W, 3), contiguous.
    """
    B, H, W, _ = x.shape
    if H % MULTIPLE or W % MULTIPLE:
        raise ValueError(f"the packed engine needs H and W divisible by "
                         f"{MULTIPLE}, got {H}x{W}")
    c = p["initial.0.weight"].shape[0] // P
    spec7 = pack_conv2d_spec(7, f_in=PACK, f_out=PACK, stride=1, padding=3)
    spec4s2 = pack_conv2d_spec(4, f_in=PACK, f_out=PACK, stride=2, padding=1)
    spect = pack_conv_transpose2d_spec(4, f_in=PACK, f_out=PACK, stride=2,
                                       padding=1)

    xp = space_to_depth(x.contiguous(), PACK)
    h = torch.relu(packed_instance_norm(packed_conv2d(
        xp, p["initial.0.weight"], p["initial.0.bias"], spec7), PACK))
    for name, width in (("down1", 2 * c), ("down2", 4 * c)):
        h = packed_conv2d(h, p[f"{name}.0.weight"], p[f"{name}.0.bias"],
                          spec4s2)
        h = torch.relu(packed_instance_norm(h, PACK))
        h = _attention(p, h, f"{name}.3.")
        h = _msb(p, h, f"{name}.4.", width)

    style = torch.relu(F.linear(packed_global_avg_pool(h, PACK),
                                p["style_encoder.2.weight"],
                                p["style_encoder.2.bias"]))
    for i in range(num_transformer_blocks_of(p)):
        h = _packed_transformer_block(p, h, style, xp,
                                      f"transformer_blocks.{i}.")

    for name, width in (("up1", 2 * c), ("up2", c)):
        out_hw = (h.shape[1] * 2, h.shape[2] * 2)
        h = packed_conv_transpose2d(h, p[f"{name}.0.weight"],
                                    p[f"{name}.0.bias"], spect, out_hw=out_hw)
        h = torch.relu(packed_instance_norm(h, PACK))
        h = _attention(p, h, f"{name}.3.")
        h = _msb(p, h, f"{name}.4.", width)

    h = packed_conv2d(h, p["output.0.weight"], p["output.0.bias"], spec7)
    return depth_to_space(torch.tanh(h), PACK)


class PackedEnhancedGenerator(nn.Module):
    """The packed engine as a module: built from an ``EnhancedGenerator``,
    it holds the packed weights as buffers (``.to(device, dtype)`` moves
    and casts them) and takes the generator's own (B, 3, H, W) interface.
    Inference only."""

    def __init__(self, generator: nn.Module):
        super().__init__()
        packed = pack_enhanced_generator_params(generator.state_dict())
        self._keys = tuple(packed)
        for key, value in packed.items():
            self.register_buffer(key.replace(".", "__"), value)

    def packed_weights(self) -> dict:
        return {k: getattr(self, k.replace(".", "__")) for k in self._keys}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 3, H, W) in [-1, 1], H and W multiples of 16 -> same."""
        y = packed_enhanced_generator_apply(self.packed_weights(),
                                            x.permute(0, 2, 3, 1))
        return y.permute(0, 3, 1, 2)
