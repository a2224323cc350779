"""Int8 post-training-quantized EnhancedGenerator, the int8 serving engine
(port of ``models/quantized_generator.py``).

EXPERIMENTAL, as in the JAX package: static per-channel activation scales
from one calibration batch cannot cover a trained GAN's activation
ranges, and its authors measured the trained c16 unusable (SSIM 0.22
against the bf16 floor on a TPU). The bf16 and fp32 engines stay the
defaults; ``devtools/int8_ab.py`` measures this one on the card.

Every backbone convolution runs int8 x int8 -> int32 (``ops.kernels.
int8_conv``: the hand-written tensor-core kernel on the card, its float64
plain version on the CPU). Every conv but the output conv is followed by
InstanceNorm, which is invariant to a per-channel affine map: its int32
sums, as bf16, feed the InstanceNorm directly, so the weight scale, the
input scale and the conv bias are absorbed (and the bias dropped). Only
``output.0`` dequantizes (``acc * s_w + b``) before the tanh. The absorbed
sites normalise with one-pass E[x^2] - E[x]^2 fp32 statistics clamped at 0
(:func:`in_relu_onepass`), as the JAX package's bf16 ``in_relu`` does: on
sums of 1e4 .. 1e7 those differ from the Welford statistics of the port's
``core.norm`` wherever a channel is nearly flat, so this engine takes its
own call and ``core.norm`` keeps its routes. LocalAttention's qkv/proj,
the style encoder and the transformer blocks stay floating point and run
in bf16 on the serving kernels (rows 1 and 4).

Quantization (``quantize_enhanced_generator``): symmetric per-output-
channel absmax/127 weights after folding the per-input-channel activation
scale into them (``conv(x, w) == conv(x / s_in, w * s_in)``); activations
quantized with static per-channel scales, the calibration run's absmax/127
(``calibrate_enhanced_generator``, a bf16 forward on the plain attention
and block), the model input at the fixed 1/127.

    q = prepare_int8_model(generator, calib_batches)   # -> nn.Module
    y = q(x)                                            # (B, 3, H, W) bf16

The module holds the int8 weights in the kernel's layout, the scales and
the output bias as buffers (``.to(device)`` moves them; it is not meant to
be cast) and its own copies of the floating-point parts.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from ..core.conv import conv, linear
from ..ops.kernels.int8_conv import (
    Int8ConvSpec, int8_conv, pack_weight, quantize_act,
)
from .enhanced_generator import _MSB_BRANCHES

__all__ = ["EXPERIMENTAL_WARNING", "QuantizedEnhancedGenerator",
           "calibrate_enhanced_generator",
           "from_jax_qparams", "in_relu_onepass", "prepare_int8_model",
           "quantize_act", "quantize_enhanced_generator", "quantize_weight"]

_DEQUANT_SITES = ("output",)
# printed by every entry point that builds the engine
EXPERIMENTAL_WARNING = (
    "WARNING: the int8 engine is EXPERIMENTAL: the JAX package's authors "
    "measured it unusable on trained weights (SSIM 0.22 against the bf16 "
    "floor 0.9965 on the trained c16 model at 0.99x throughput, on a TPU: "
    "static activation scales cannot cover a trained GAN's activation "
    "ranges). Use bf16 for serving; devtools/int8_ab.py measures it on "
    "the card.")
STAGES = ("down1", "down2", "up1", "up2")
CALIBRATION_SHAPE = (2, 256, 256, 3)   # prepare_int8_model's default batch
CALIBRATION_SEED = 0                   # ... and its torch.Generator's seed


# ---------------------------------------------------------------------------
# quantization helpers
# ---------------------------------------------------------------------------

def quantize_weight(w: torch.Tensor, out_axis: int = 0):
    """Symmetric per-output-channel absmax int8 quantization of a weight in
    PyTorch's layout (``out_axis`` 0 for OIHW, 1 for a transposed conv's
    IOHW): (int8 weight, fp32 scale (Cout,)), quantized_generator.py:62-73.
    """
    w = w.float()
    m = w.abs().amax(dim=[d for d in range(w.ndim) if d != out_axis])
    s = torch.clamp_min(m, 1e-12) / 127.0
    shape = [1] * w.ndim
    shape[out_axis] = -1
    q = torch.clamp(torch.round(w / s.reshape(shape)), -127, 127)
    return q.to(torch.int8), s


def _site_of(key: str) -> str | None:
    """A state-dict key -> its quantization site, or None to keep it
    floating point (:118-133): the style encoder, the transformer blocks
    and LocalAttention's qkv/proj stay floating point."""
    if key.endswith(".weight"):
        base = key[:-len(".weight")]
        if (base.startswith("style_encoder") or "transformer_blocks" in base
                or base.endswith(".qkv") or base.endswith(".proj")):
            return None
        return base
    return None


def _needs_dequant(site: str) -> bool:
    leaf = site.rsplit(".", 1)[-1]
    return leaf in _DEQUANT_SITES or site == "output.0"


def _spec_of(m: nn.Module) -> Int8ConvSpec:
    if isinstance(m, nn.ConvTranspose2d):
        if (m.kernel_size, m.stride, m.padding) != ((4, 4), (2, 2), (1, 1)):
            raise ValueError(f"the int8 engine takes ConvTranspose2d(4, 2, "
                             f"1) only, got {m}")
        return Int8ConvSpec(m.in_channels, m.out_channels, 4, 2, 1,
                            transposed=True)
    return Int8ConvSpec(m.in_channels, m.out_channels, m.kernel_size[0],
                        m.stride[0], m.padding[0], m.dilation[0])


def in_relu_onepass(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``relu(instance_norm(x))`` over the H, W axes of (B, H, W, C) ``x``
    with one-pass fp32 statistics, var = max(E[x^2] - E[x]^2, 0), rounded
    once to x's type: the JAX package's bf16 ``in_relu``
    (core/norm.py:62-71)."""
    xf = x.float()
    mean = xf.mean(dim=(1, 2), keepdim=True)
    meansq = xf.square().mean(dim=(1, 2), keepdim=True)
    var = torch.clamp_min(meansq - mean.square(), 0.0)
    return torch.relu((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


# ---------------------------------------------------------------------------
# the forward (one structure, two modes)
# ---------------------------------------------------------------------------

def _msb(conv_fn, h, prefix, in_act):
    """MultiScaleBlock: the four branches into one concatenation (each
    conv writes its channel slice), IN + ReLU, fusion, IN + ReLU, the
    residual (:262-269)."""
    B, H, W, C = h.shape
    cat = h.new_empty(B, H, W, C)
    for i, (name, *_) in enumerate(_MSB_BRANCHES):
        conv_fn(f"{prefix}{name}.0", h, cat, i * (C // 4))
    return in_act(conv_fn(f"{prefix}fusion.0", in_act(cat), None, 0)) + h


def _forward(conv_fn, attention, style_linear, blocks, x, in_act):
    """The EnhancedGenerator on NHWC activations (:272-309): ``conv_fn(site,
    h, out, channel_offset)`` runs each quantized site (the int8 conv, or
    the calibration's recording bf16 conv); ``attention`` holds the four
    LocalAttention modules by stage; ``x`` is the (B, 3, H, W) bf16 input.
    Returns (B, 3, H, W)."""
    nhwc = lambda t: t.permute(0, 2, 3, 1)
    nchw = lambda t: t.permute(0, 3, 1, 2)
    h = in_act(conv_fn("initial.0", nhwc(x).contiguous(), None, 0))
    for name in ("down1", "down2"):
        h = in_act(conv_fn(f"{name}.0", h, None, 0))
        h = nhwc(attention[name](nchw(h))).contiguous()
        h = _msb(conv_fn, h, f"{name}.4.", in_act)
    style = torch.relu(linear(style_linear, h.mean(dim=(1, 2))))
    for block in blocks:
        h = block(h, style, x)
    for name in ("up1", "up2"):
        h = in_act(conv_fn(f"{name}.0", h, None, 0))
        h = nhwc(attention[name](nchw(h))).contiguous()
        h = _msb(conv_fn, h, f"{name}.4.", in_act)
    return torch.tanh(nchw(conv_fn("output.0", h, None, 0)))


class _Int8Site(nn.Module):
    """One quantized convolution: the int8 weight in the kernel's layout,
    its dequant scale s_w, the per-channel input scale s_in, and at a
    dequant site the fp32 bias."""

    def __init__(self, spec: Int8ConvSpec, weight_q: torch.Tensor,
                 weight_scale: torch.Tensor, act_scale: torch.Tensor,
                 bias: torch.Tensor | None, dequant: bool):
        super().__init__()
        self.spec = spec
        self.dequant = dequant
        self.register_buffer("weight", pack_weight(weight_q, spec))
        self.register_buffer("weight_scale", weight_scale.float().contiguous())
        self.register_buffer("act_scale", act_scale.float().contiguous())
        self.register_buffer("bias", None if bias is None
                             else bias.float().contiguous())

    def forward(self, x, out=None, channel_offset=0):
        if self.dequant:
            return int8_conv(x, self.act_scale, self.weight, self.spec,
                             "dequant", self.weight_scale, self.bias, out,
                             channel_offset)
        return int8_conv(x, self.act_scale, self.weight, self.spec, "bf16",
                         out=out, channel_offset=channel_offset)


class QuantizedEnhancedGenerator(nn.Module):
    """The int8 engine of one EnhancedGenerator: built by
    :func:`quantize_enhanced_generator` (or :func:`from_jax_qparams`) from
    the generator and its int8 sites, {site: (int8 weight in PyTorch's
    layout, s_w, s_in, output bias or None)}. Inference only; the input is
    computed in bf16, whatever its type, and the output is bf16."""

    def __init__(self, generator: nn.Module, sites: dict):
        super().__init__()
        self.site_names = tuple(sites)
        self.sites = nn.ModuleDict({
            s.replace(".", "_"): _Int8Site(
                _spec_of(generator.get_submodule(s)), q, sw, si, b,
                _needs_dequant(s))
            for s, (q, sw, si, b) in sites.items()})
        self.attention = nn.ModuleDict({
            name: copy.deepcopy(getattr(generator, name)[3])
            for name in STAGES})
        self.style_encoder = copy.deepcopy(generator.style_encoder)
        self.transformer_blocks = copy.deepcopy(generator.transformer_blocks)

    def site(self, name: str) -> _Int8Site:
        return self.sites[name.replace(".", "_")]

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 3, H, W) in [-1, 1], H and W divisible by 16 -> (B, 3, H,
        W) bf16."""
        conv_fn = lambda s, h, out, off: self.site(s)(h, out, off)
        return _forward(conv_fn, self.attention, self.style_encoder[2],
                        self.transformer_blocks, x.to(torch.bfloat16),
                        in_relu_onepass)


# ---------------------------------------------------------------------------
# parameter quantization + calibration
# ---------------------------------------------------------------------------

@torch.no_grad()
def calibrate_enhanced_generator(generator: nn.Module, batches) -> dict:
    """Per-site activation scales from a bf16 forward over ``batches`` on
    the plain attention and block (:181-201): {site: fp32 (Cin,) numpy
    array}, each conv input's per-channel absmax over batch and space,
    max(v, 1e-6) / 127. ``batches``: (B, H, W, 3) arrays or tensors in
    [-1, 1]; the forward runs on the generator's device."""
    gen = copy.deepcopy(generator).eval()
    gen.fast_attention = False
    device = next(gen.parameters()).device
    bf16 = torch.bfloat16
    rec = {}

    def conv_fn(site, h, out, off):
        m = h.float().abs().amax(dim=(0, 1, 2))
        rec[site] = torch.maximum(rec[site], m) if site in rec else m
        y = conv(gen.get_submodule(site), h.permute(0, 3, 1, 2))
        y = y.permute(0, 2, 3, 1)
        if out is None:
            return y.contiguous()
        out[..., off:off + y.shape[-1]] = y
        return out

    attention = {name: getattr(gen, name)[3] for name in STAGES}
    for x in batches:
        x = torch.as_tensor(np.asarray(x, np.float32)).to(device)
        _forward(conv_fn, attention, gen.style_encoder[2],
                 gen.transformer_blocks, x.permute(0, 3, 1, 2).to(bf16),
                 in_relu_onepass)
    return {k: (torch.clamp_min(v, 1e-6) / 127.0).cpu().numpy()
            for k, v in rec.items()}


def quantize_enhanced_generator(generator: nn.Module,
                                act_scales: dict) -> QuantizedEnhancedGenerator:
    """The int8 engine of ``generator`` from per-site activation scales
    (:136-173), on the generator's device. Each site's s_in is folded into
    its weight over the input channels before the weight is quantized;
    conv biases at the InstanceNorm-absorbed sites are dropped."""
    sd = {k: v.detach().cpu() for k, v in generator.state_dict().items()}
    sites = {}
    for key, val in sd.items():
        site = _site_of(key)
        if site is None:
            continue
        transposed = isinstance(generator.get_submodule(site),
                                nn.ConvTranspose2d)
        s_in = torch.as_tensor(np.asarray(act_scales[site], np.float32))
        # the input-channel axis: 1 of OIHW, 0 of a transposed conv's IOHW
        fold = s_in[:, None, None, None] if transposed else \
            s_in[None, :, None, None]
        q, s = quantize_weight(val.float() * fold, 1 if transposed else 0)
        bias = sd.get(f"{site}.bias") if _needs_dequant(site) else None
        sites[site] = (q, s, s_in, bias)
    return _build_on(generator, sites)


def _build_on(generator: nn.Module, sites: dict) -> QuantizedEnhancedGenerator:
    """The engine on the generator's device, its copies made there."""
    device = next(generator.parameters()).device
    return QuantizedEnhancedGenerator(generator, sites).to(device).eval()


def from_jax_qparams(generator: nn.Module, qparams: dict
                     ) -> QuantizedEnhancedGenerator:
    """The engine with the JAX package's int8 parameters (the tree of
    ``quantize_enhanced_generator_params``, as numpy arrays: HWIO int8
    weights, ``weight_scale``, ``act_scales``, ``bias``) and the float
    parts of ``generator``: both packages then run identical int8
    weights."""
    sites = {}
    for site, w in qparams["weights_q"].items():
        w = torch.as_tensor(np.asarray(w))
        transposed = isinstance(generator.get_submodule(site),
                                nn.ConvTranspose2d)
        # HWIO -> IOHW (transposed: I is the input) or OIHW
        w = w.permute(2, 3, 0, 1) if transposed else w.permute(3, 2, 0, 1)
        bias = qparams["bias"].get(site)
        sites[site] = (w.contiguous(),
                       torch.as_tensor(np.asarray(qparams["weight_scale"][site],
                                                  np.float32)),
                       torch.as_tensor(np.asarray(qparams["act_scales"][site],
                                                  np.float32)),
                       None if bias is None
                       else torch.as_tensor(np.asarray(bias, np.float32)))
    return _build_on(generator, sites)


def prepare_int8_model(generator: nn.Module, calib_batches=None
                       ) -> QuantizedEnhancedGenerator:
    """One-call post-training quantization (:323-336): calibrate on the
    given batches, or on one synthetic batch of CALIBRATION_SHAPE uniform
    in [-1, 1) from a ``torch.Generator`` seeded with CALIBRATION_SEED (the
    JAX package draws it from ``PRNGKey(0)``, which PyTorch cannot
    reproduce), pin the model input's scale to 1/127, and quantize."""
    if calib_batches is None:
        gen = torch.Generator().manual_seed(CALIBRATION_SEED)
        calib_batches = [torch.rand(CALIBRATION_SHAPE, generator=gen) * 2 - 1]
    scales = calibrate_enhanced_generator(generator, calib_batches)
    # the model input is [-1, 1]: the exact domain scale, not the
    # calibration batch's observed max
    scales["initial.0"] = np.full(3, 1.0 / 127.0, np.float32)
    return quantize_enhanced_generator(generator, scales)
