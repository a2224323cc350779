"""int8 x int8 -> int32 convolution of the int8 serving engine: CUDA kernel
and plain version.

The JAX package runs the int8 engine's convolutions as XLA int8
convolutions (``models/quantized_generator.py:86-106``: ``_conv_i8`` and
``_convt_i8_k4s2p1``); ``int8_conv`` launches ``csrc/int8_conv.cu``, an
implicit-GEMM convolution on Hopper's int8 tensor cores, and
``int8_conv_plain`` is the same function in float64 PyTorch.

Both take the bf16 (or float) NHWC activation and its per-channel scale
and quantize it themselves (``quantize_act``: IEEE division, round half to
even, clip to +-127; the padding is int8 zero). The weight is int8 in the
kernel's layout (``pack_weight``): (phases, Cout padded to 8, K padded to
32), K-major with k in (kh, kw, cin) order; a ``ConvTranspose2d(4, 2, 1)``
as its four output phases, each a 2x2 convolution over the input. The
output (``mode``): ``"int32"`` the sums; ``"bf16"`` the sums rounded to
bf16 through fp32, as XLA's and PyTorch's int32 -> bf16 casts round;
``"dequant"`` bf16 of ``acc * s_w + bias``, product and sum rounded apart.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import _build
from ._checks import check_no_grad

MODES = {"int32": 0, "bf16": 1, "dequant": 2}
CONVT_KERNEL = 4   # the only transposed convolution: ConvTranspose2d(4, 2, 1)


@dataclass(frozen=True)
class Int8ConvSpec:
    """One convolution site: channels, square kernel, stride, padding and
    dilation; ``transposed`` is ``ConvTranspose2d(4, 2, 1)``."""
    cin: int
    cout: int
    kernel: int
    stride: int = 1
    padding: int = 0
    dilation: int = 1
    transposed: bool = False

    @property
    def taps(self) -> int:
        """Kernel side of one GEMM: 2 for a phase of the transposed conv."""
        return 2 if self.transposed else self.kernel

    @property
    def k(self) -> int:
        return self.taps * self.taps * self.cin

    def out_hw(self, H: int, W: int) -> tuple:
        if self.transposed:
            return 2 * H, 2 * W
        span = self.dilation * (self.kernel - 1) + 1
        return ((H + 2 * self.padding - span) // self.stride + 1,
                (W + 2 * self.padding - span) // self.stride + 1)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _phase_taps(p: int) -> list:
    """Kernel rows (or columns) of taps dh = 0, 1 of output phase p of
    ``ConvTranspose2d(4, 2, 1)``: output 2u + p takes input u - 1 + p + dh
    through kernel row 3 - p - 2 dh."""
    return [3 - p, 1 - p]


def pack_weight(wq: torch.Tensor, spec: Int8ConvSpec) -> torch.Tensor:
    """int8 weight in PyTorch's layout (OIHW; IOHW for the transposed conv)
    -> the kernel's (phases, Npad, Kpad) int8, zero padded."""
    if spec.transposed:
        mats = torch.stack([
            wq[:, :, _phase_taps(py)][:, :, :, _phase_taps(px)]
            .permute(1, 2, 3, 0).reshape(spec.cout, spec.k)
            for py in (0, 1) for px in (0, 1)])
    else:
        mats = wq.permute(0, 2, 3, 1).reshape(1, spec.cout, spec.k)
    out = torch.zeros(mats.shape[0], _round_up(spec.cout, 8),
                      _round_up(spec.k, 32), dtype=torch.int8)
    out[:, :spec.cout, :spec.k] = mats
    return out


def unpack_weight(w: torch.Tensor, spec: Int8ConvSpec) -> torch.Tensor:
    """Inverse of :func:`pack_weight`."""
    t, cin, cout = spec.taps, spec.cin, spec.cout
    mats = w[:, :cout, :spec.k].reshape(-1, cout, t, t, cin)
    if not spec.transposed:
        return mats[0].permute(0, 3, 1, 2).contiguous()
    out = torch.empty(cin, cout, CONVT_KERNEL, CONVT_KERNEL, dtype=w.dtype,
                      device=w.device)
    for p, (py, px) in enumerate((a, b) for a in (0, 1) for b in (0, 1)):
        for dh, kh in enumerate(_phase_taps(py)):
            for dw, kw in enumerate(_phase_taps(px)):
                out[:, :, kh, kw] = mats[p, :, dh, dw, :].T
    return out


def quantize_act(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Static-scale symmetric int8 quantization over the last (channel)
    axis (quantized_generator.py:76-83): fp32 division, round half to
    even, clip to +-127."""
    q = torch.round(x.float() / scale)
    return torch.clamp(q, -127, 127).to(torch.int8)


def _epilogue(acc: torch.Tensor, mode: str, s_w, bias) -> torch.Tensor:
    if mode == "int32":
        return acc
    y = acc.float()
    if mode == "dequant":
        y = y * s_w
        if bias is not None:
            y = y + bias
    return y.to(torch.bfloat16)


def int8_conv_plain(x: torch.Tensor, s_in: torch.Tensor, w: torch.Tensor,
                    spec: Int8ConvSpec, mode: str = "bf16", s_w=None,
                    bias=None) -> torch.Tensor:
    """The convolution of (B, H, W, Cin) ``x`` in float64 on the int8
    values (every partial sum is an integer below 2^53: exact), rounded
    to int32, then the epilogue of ``mode``. Returns (B, Ho, Wo, Cout)."""
    xq = quantize_act(x, s_in).double().permute(0, 3, 1, 2)
    wd = unpack_weight(w, spec).double()
    if spec.transposed:
        y = F.conv_transpose2d(xq, wd, stride=2, padding=1)
    else:
        y = F.conv2d(xq, wd, stride=spec.stride, padding=spec.padding,
                     dilation=spec.dilation)
    acc = torch.round(y).to(torch.int32).permute(0, 2, 3, 1)
    return _epilogue(acc, mode, s_w, bias).contiguous()


def int8_conv(x: torch.Tensor, s_in: torch.Tensor, w: torch.Tensor,
              spec: Int8ConvSpec, mode: str = "bf16", s_w=None, bias=None,
              out: torch.Tensor | None = None,
              channel_offset: int = 0) -> torch.Tensor:
    """The int8 convolution of (B, H, W, Cin) ``x`` (see the module
    docstring); ``out``, when given, a (B, Ho, Wo, ld) tensor whose
    channels [channel_offset, channel_offset + Cout) take the result.
    Returns ``out`` or a new (B, Ho, Wo, Cout) tensor.

    A CPU tensor takes the plain version. A CUDA tensor launches the
    kernel (bf16 x, contiguous and 16-byte aligned; fp32 scales and bias;
    the int8 weight of :func:`pack_weight`) or raises."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, got {mode!r}")
    if mode == "dequant" and s_w is None:
        raise ValueError("mode 'dequant' needs s_w")
    B, H, W, C = x.shape
    if C != spec.cin:
        raise ValueError(f"int8_conv: x has {C} channels, the site {spec.cin}")
    Ho, Wo = spec.out_hw(H, W)
    out_dtype = torch.int32 if mode == "int32" else torch.bfloat16
    if out is not None and (tuple(out.shape[:3]) != (B, Ho, Wo)
                            or out.dtype != out_dtype
                            or channel_offset + spec.cout > out.shape[3]):
        raise ValueError(f"int8_conv: out {tuple(out.shape)} {out.dtype} "
                         f"does not hold ({B}, {Ho}, {Wo}) x {spec.cout} "
                         f"{out_dtype} at channel {channel_offset}")
    if x.device.type == "cpu":
        y = int8_conv_plain(x, s_in, w, spec, mode, s_w, bias)
        if out is None:
            return y
        out[..., channel_offset:channel_offset + spec.cout] = y
        return out
    check_no_grad("int8_conv", x)
    phases = 4 if spec.transposed else 1
    npad, kpad = _round_up(spec.cout, 8), _round_up(spec.k, 32)
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("int8_conv: x must be a contiguous, 16-byte aligned "
                         "bf16 (B, H, W, C) tensor")
    if (w.dtype != torch.int8 or tuple(w.shape) != (phases, npad, kpad)
            or not w.is_contiguous() or w.data_ptr() % 16):
        raise ValueError(f"int8_conv: w must be the contiguous int8 "
                         f"({phases}, {npad}, {kpad}) of pack_weight, got "
                         f"{w.dtype} {tuple(w.shape)}")
    for name, t, n in (("s_in", s_in, spec.cin), ("s_w", s_w, spec.cout),
                       ("bias", bias, spec.cout)):
        if t is None:
            continue
        if (t.dtype != torch.float32 or tuple(t.shape) != (n,)
                or not t.is_contiguous() or t.data_ptr() % 16
                or t.device != x.device):
            raise ValueError(f"int8_conv: {name} must be a contiguous, "
                             f"16-byte aligned fp32 ({n},) on {x.device}")
    if w.device != x.device:
        raise ValueError(f"int8_conv: w is on {w.device}, x on {x.device}")
    if out is None:
        out = torch.empty(B, Ho, Wo, spec.cout, dtype=out_dtype,
                          device=x.device)
    elif out.device != x.device or not out.is_contiguous():
        raise ValueError("int8_conv: out must be contiguous, on x's device")
    if x.numel() and out.numel():
        ptr = lambda t: None if t is None else t.data_ptr()
        rc = _build.kernel("int8_conv")(
            x.data_ptr(), s_in.data_ptr(), w.data_ptr(), ptr(s_w), ptr(bias),
            out.data_ptr(), B, H, W, spec.cin, spec.cout, spec.taps,
            spec.taps, spec.stride, spec.padding, spec.dilation,
            int(spec.transposed), kpad, npad, Ho, Wo, out.shape[3],
            channel_offset, MODES[mode], x.device.index,
            torch.cuda.current_stream(x.device).cuda_stream)
        if rc:
            raise RuntimeError(f"int8_conv launch failed: CUDA error {rc}")
        int8_conv.launches += 1
    return out


int8_conv.launches = 0
