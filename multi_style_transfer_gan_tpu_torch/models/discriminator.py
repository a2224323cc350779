"""EnhancedDiscriminator (port of ``models/discriminator.py``).

A spectral-norm PatchGAN with two heads: four stride-2 4x4 convs
(IN + LeakyReLU 0.2) to 8C channels, then
- ``batch_head``: a 4x4 conv to 1 channel and a global average -> one
  realness score per sample;
- ``structure_head``: 3x3 conv + IN + LeakyReLU + 4x4 conv -> a spatial
  structure map (the structure-preservation L1 of the train step).

Every conv is spectrally normalized with torch's own state-dict layout
(``weight_orig``, ``bias``, buffers ``weight_u`` (O,) and ``weight_v``
(I*kh*kw,)), so a saved state dict loads into the reference. The power
iteration is explicit: ``forward(x, update_sn=True)`` runs one step per conv
and writes the buffers, ``update_sn=False`` reuses them, which is how the
JAX train step threads its ``sn_state`` (train/cyclegan.py:176-191), and
not the hook of ``torch.nn.utils.spectral_norm``, which iterates on every
training-mode forward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.activations import leaky_relu
from ..core.norm import in_leaky_relu, spectral_normalize
from .init_utils import torch_default_conv

_CONVS = (  # name, k, stride, pad, cin (x channels; "rgb" = 3), cout (x; "one" = 1)
    ("main.0", 4, 2, 1, "rgb", 1),
    ("main.2", 4, 2, 1, 1, 2),
    ("main.5", 4, 2, 1, 2, 4),
    ("main.8", 4, 2, 1, 4, 8),
    ("batch_head.0", 4, 1, 1, 8, "one"),
    ("structure_head.0", 3, 1, 1, 8, 8),
    ("structure_head.3", 4, 1, 1, 8, "one"),
)


class SNConv2d(nn.Module):
    """A conv whose weight is ``weight_orig / sigma``, sigma from one power
    iteration on the (O, I*kh*kw) matrix (core.norm.spectral_normalize)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, padding: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.stride, self.padding = stride, padding
        w, b = torch_default_conv((k, k, cin, cout), generator)
        self.weight_orig = nn.Parameter(w)
        self.bias = nn.Parameter(b)
        u = torch.randn(cout, generator=generator)
        self.register_buffer("weight_u", u / torch.linalg.vector_norm(u))
        # the v the first iteration would make, which is what the JAX
        # package uses while its v is None (core/norm.py:215-216)
        _, _, v = spectral_normalize(w, self.weight_u, update=False)
        self.register_buffer("weight_v", v)

    def forward(self, x: torch.Tensor, update_sn: bool) -> torch.Tensor:
        w, u, v = spectral_normalize(self.weight_orig, self.weight_u,
                                     self.weight_v, update=update_sn)
        if update_sn:
            with torch.no_grad():
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        return F.conv2d(x, w.to(x.dtype), self.bias.to(x.dtype),
                        self.stride, self.padding)


class EnhancedDiscriminator(nn.Module):
    """Keys ``main.{0,2,5,8}``, ``batch_head.0``, ``structure_head.{0,3}``;
    a fresh module follows ``discriminator_init``'s law (PyTorch's default
    conv law, u a normalized Gaussian)."""

    def __init__(self, channels: int = 16, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        c = channels
        heads = {"main": nn.ModuleDict(), "batch_head": nn.ModuleDict(),
                 "structure_head": nn.ModuleDict()}
        for name, k, stride, pad, cin_m, cout_m in _CONVS:
            cin = 3 if cin_m == "rgb" else cin_m * c
            cout = 1 if cout_m == "one" else cout_m * c
            head, idx = name.split(".")
            heads[head][idx] = SNConv2d(cin, cout, k, stride, pad, generator)
        self.main = heads["main"]
        self.batch_head = heads["batch_head"]
        self.structure_head = heads["structure_head"]

    def forward(self, x: torch.Tensor, update_sn: bool = True):
        """x: (B, 3, H, W) in [-1, 1]. Returns (scores (B,), structure map
        (B, 1, H/16 - 1, W/16 - 1)), as ``discriminator_apply`` (:63-99).
        update_sn=True runs the power iteration and updates the buffers."""
        m, sh = self.main, self.structure_head
        h = leaky_relu(m["0"](x, update_sn), 0.2)
        h = in_leaky_relu(m["2"](h, update_sn), 0.2)
        h = in_leaky_relu(m["5"](h, update_sn), 0.2)
        feats = in_leaky_relu(m["8"](h, update_sn), 0.2)
        score = self.batch_head["0"](feats, update_sn).mean(dim=(1, 2, 3))
        s = in_leaky_relu(sh["0"](feats, update_sn), 0.2)
        return score, sh["3"](s, update_sn)
