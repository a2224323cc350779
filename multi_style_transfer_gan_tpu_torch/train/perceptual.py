"""VGG-feature perceptual + Gram-matrix style losses (port of
``train/perceptual.py``, an EXTENSION there too).

The reference contains no VGG/Gram loss: its training losses are LSGAN +
cycle + identity + structure. The JAX package provides the named
capability as a flagged extension, and so does the port:

- a functional VGG16 feature trunk (conv1_1..conv4_3) on NHWC tensors,
- an importer for torchvision-format ``vgg16`` state dicts (features.N.*);
  pretrained weights must be supplied as a .pth by the user (none ship
  here),
- Gram-matrix style loss and feature-space (perceptual) L1,
- a combined ``perceptual_gram_loss`` usable as an additional generator term
  through ``cyclegan_train_step``'s ``extra_g_loss`` hook.

Convolutions and products run in PyTorch (cuDNN and matmul on the card):
the JAX package computes them outside any Pallas kernel too. The ImageNet
mean and std are fp32 tensors, so a bf16 input promotes to fp32 at the
normalization and the trunk runs in fp32, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

# torchvision vgg16.features conv layer indices and channel widths
_VGG16_CONVS = (
    (0, 3, 64), (2, 64, 64),
    (5, 64, 128), (7, 128, 128),
    (10, 128, 256), (12, 256, 256), (14, 256, 256),
    (17, 256, 512), (19, 512, 512), (21, 512, 512),
)
# after which conv indices a 2x2 maxpool sits
_POOL_AFTER = {2, 7, 14}
# default feature taps (relu1_2, relu2_2, relu3_3, relu4_3)
DEFAULT_TAPS = (2, 7, 14, 21)

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def vgg16_from_torchvision_sd(sd, *, device) -> Dict[str, torch.Tensor]:
    """Import ``torchvision.models.vgg16().state_dict()`` conv weights onto
    ``device``: {``conv{idx}.weight`` (OIHW), ``conv{idx}.bias``} in fp32,
    without grad (the trunk is frozen)."""
    params = {}
    for idx, _, _ in _VGG16_CONVS:
        for name in ("weight", "bias"):
            params[f"conv{idx}.{name}"] = torch.as_tensor(
                sd[f"features.{idx}.{name}"], dtype=torch.float32).to(device)
    return params


def vgg16_features(params, x, taps: Sequence[int] = DEFAULT_TAPS):
    """x: (B, H, W, 3) in [-1, 1], any strides. Returns {conv_idx: (B, h, w,
    C) feature map} at taps (NHWC views of the trunk's NCHW maps)."""
    mean = torch.tensor(_IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(_IMAGENET_STD, dtype=torch.float32, device=x.device)
    h = (x + 1.0) * 0.5  # to [0,1], in x's dtype
    h = ((h - mean) / std).permute(0, 3, 1, 2)
    feats = {}
    for idx, _, _ in _VGG16_CONVS:
        h = F.relu(F.conv2d(h, params[f"conv{idx}.weight"],
                            params[f"conv{idx}.bias"], padding=1))
        if idx in taps:
            feats[idx] = h.permute(0, 2, 3, 1)
            if idx == max(taps):
                break
        if idx in _POOL_AFTER:
            h = F.max_pool2d(h, 2, 2)   # VALID: floor sizes
    return feats


def gram_matrix(f):
    """(B, H, W, C) -> (B, C, C) normalized Gram, in fp32."""
    B, H, W, C = f.shape
    t = f.float()
    return torch.einsum("bhwc,bhwd->bcd", t, t) / (H * W * C)


def _feature_l1(fp, ft, taps):
    return sum(torch.mean(torch.abs(fp[i].float() - ft[i].float()))
               for i in taps) / len(taps)


def _gram_mse(fp, ft, taps):
    return sum(torch.mean(torch.square(gram_matrix(fp[i])
                                       - gram_matrix(ft[i])))
               for i in taps) / len(taps)


def _target_features(params, target, taps):
    """The trunk on a target: a constant of the loss (the JAX
    ``stop_gradient``), so no graph is kept."""
    with torch.no_grad():
        return vgg16_features(params, target, taps)


def perceptual_loss(vgg_params, pred, target,
                    taps: Sequence[int] = DEFAULT_TAPS):
    fp = vgg16_features(vgg_params, pred, taps)
    return _feature_l1(fp, _target_features(vgg_params, target, taps), taps)


def gram_style_loss(vgg_params, pred, style_target,
                    taps: Sequence[int] = DEFAULT_TAPS):
    fp = vgg16_features(vgg_params, pred, taps)
    return _gram_mse(fp, _target_features(vgg_params, style_target, taps),
                     taps)


def perceptual_gram_loss(vgg_params, pred, content, style,
                         w_perceptual: float = 1.0, w_gram: float = 1.0,
                         taps: Sequence[int] = DEFAULT_TAPS):
    """Combined loss; the VGG trunk runs ONCE on ``pred`` and its taps are
    shared by both terms."""
    fp = vgg16_features(vgg_params, pred, taps)
    fc = _target_features(vgg_params, content, taps)
    fs = _target_features(vgg_params, style, taps)
    return (w_perceptual * _feature_l1(fp, fc, taps)
            + w_gram * _gram_mse(fp, fs, taps))


def make_extra_g_loss(vgg_params, w_perceptual: float = 1.0,
                      w_gram: float = 1.0):
    """Adapter for ``cyclegan_train_step(..., extra_g_loss=...)``: perceptual
    vs the translation source (content) + Gram vs the target domain
    (style), averaged over both directions."""
    def hook(fake_A, fake_B, real_A, real_B):
        return 0.5 * (
            perceptual_gram_loss(vgg_params, fake_B, real_A, real_B,
                                 w_perceptual, w_gram)
            + perceptual_gram_loss(vgg_params, fake_A, real_B, real_A,
                                   w_perceptual, w_gram))
    return hook
