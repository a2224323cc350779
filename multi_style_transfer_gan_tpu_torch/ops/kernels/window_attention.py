"""Windowed channel attention (LocalAttention): CUDA kernel and plain version.

``window_channel_attention`` is the op the JAX package computes with three
Pallas layouts (v1, grouped, v3, dispatched by
``ops/pallas/attention_dispatch.py``); on Hopper one kernel,
``csrc/window_channel_attention.cu``, serves every width the generator has
(C = 16, 32, 64). ``window_channel_attention_plain`` is the port of
``_attention_math`` / ``_attention_windows``
(models/enhanced_generator.py:168-205).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.norm import l2_normalize
from . import _build
from ._checks import check_cuda_args, check_no_grad, dtype_code

WINDOW = 4
KERNEL_WIDTHS = (16, 32, 64)


def window_channel_attention_plain(x, wqkv, bqkv, wproj, bproj, *,
                                   eps: float = 1e-12) -> torch.Tensor:
    """Plain PyTorch version. x: (B, H, W, C); wqkv (3C, C[, 1, 1]), bqkv
    (3C,), wproj (C, C[, 1, 1]), bproj (C,) in the PyTorch (out, in) layout.

    Computes in fp32 whatever the input type and rounds once at the end,
    as the kernel does, so the two agree to fp32 rounding in fp32 and to
    one output rounding in bf16.
    """
    B, H, W, C = x.shape
    ws = WINDOW
    nh, nw = H // ws, W // ws
    qkv = F.linear(x.float(), wqkv.reshape(3 * C, C).float(), bqkv.float())
    t = qkv.reshape(B, nh, ws, nw, ws, 3 * C).permute(0, 1, 3, 2, 4, 5)
    q, k, v = t.reshape(-1, ws * ws, 3 * C).split(C, dim=-1)   # (Bw, P, C)
    # attn[c1, c2] = sum_t qn[t, c1] kn[t, c2]
    attn = torch.softmax(l2_normalize(q, eps).transpose(1, 2)
                         @ l2_normalize(k, eps), dim=-1)
    out = v @ attn.transpose(1, 2)   # out[t, c1] = sum_c2 attn[c1, c2] v[t, c2]
    out = out.reshape(B, nh, nw, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    out = out.reshape(B, H, W, C)
    return F.linear(out, wproj.reshape(C, C).float(), bproj.float()).to(x.dtype)


def window_channel_attention(x, wqkv, bqkv, wproj, bproj, *,
                             eps: float = 1e-12) -> torch.Tensor:
    """LocalAttention forward on a (B, H, W, C) tensor, 4x4 windows.

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    (contiguous fp32 or bf16 input, weights of the same type, C in 16/32/64,
    H % 4 == W % 4 == 0) or raises. The kernel is forward-only: a CUDA call
    that autograd would record raises (the training route is
    ``window_channel_attention_train`` between the two 1x1 convs).
    """
    B, H, W, C = x.shape
    if H % WINDOW or W % WINDOW:
        raise ValueError(f"window attention needs H and W divisible by "
                         f"{WINDOW}, got {H}x{W}")
    if x.device.type == "cpu":
        return window_channel_attention_plain(x, wqkv, bqkv, wproj, bproj,
                                              eps=eps)
    check_no_grad("window_channel_attention", x, wqkv, bqkv, wproj, bproj)
    if C not in KERNEL_WIDTHS:
        raise ValueError(f"window_channel_attention kernel is built for C in "
                         f"{KERNEL_WIDTHS}, got C={C}")
    wqkv = wqkv.reshape(3 * C, C)
    wproj = wproj.reshape(C, C)
    check_cuda_args("window_channel_attention", x,
                    {"wqkv": (wqkv, (3 * C, C)), "bqkv": (bqkv, (3 * C,)),
                     "wproj": (wproj, (C, C)), "bproj": (bproj, (C,))})
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.numel():
        rc = _build.kernel("window_channel_attention")(
            x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wproj.data_ptr(),
            bproj.data_ptr(), y.data_ptr(), B, H, W, C, dtype_code(x), eps,
            x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
        if rc:
            raise RuntimeError(f"window_channel_attention launch failed: "
                               f"CUDA error {rc}")
        window_channel_attention.launches += 1
    return y


window_channel_attention.launches = 0
