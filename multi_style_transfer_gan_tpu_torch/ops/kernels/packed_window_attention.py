"""Windowed channel attention on packed rows: CUDA kernel and plain version.

The packed (space-to-depth) engine holds each 4x4 LocalAttention window as
one packed pixel: (B, Hp, Wp, 16 * C), position major (lane ``p * C + c``,
``p = 4 * pi + pj``). The JAX package runs the op there with three Pallas
kernels (``packed_grouped_window_attention``, ``packed_window_attention_v3``,
``packed_window_attention_pallas``); on Hopper
``packed_window_channel_attention`` launches one kernel, the packed-row
entry point of ``csrc/window_channel_attention.cu``, at any C (16 C lanes;
``window_attention.kernel_takes``; past C = 512 streamed through a
workspace, as the NHWC entry point is).
``packed_window_channel_attention_plain`` is the port of ``ops/packed.py::packed_window_channel_attention``.
"""

from __future__ import annotations

import torch

from .window_attention import launch_attention, window_rows_attention_plain

P = 16   # positions per window (4 x 4), lanes per channel of a packed pixel


def _width(x, wqkv) -> int:
    """C, from the weights; x must hold 16 C lanes."""
    C = wqkv.shape[1]
    if x.shape[-1] != P * C:
        raise ValueError(f"packed attention: x has {x.shape[-1]} lanes, "
                         f"expected {P} x C = {P * C} for C={C}")
    return C


def packed_window_channel_attention_plain(x, wqkv, bqkv, wproj, bproj, *,
                                          eps: float = 1e-12) -> torch.Tensor:
    """Plain PyTorch version. x: (B, Hp, Wp, 16C); wqkv (3C, C[, 1, 1]),
    bqkv (3C,), wproj (C, C[, 1, 1]), bproj (C,) in the PyTorch (out, in)
    layout.

    Computes in fp32 whatever the input type and rounds once at the end,
    as the kernel does.
    """
    out = window_rows_attention_plain(x.reshape(-1, P, _width(x, wqkv)),
                                      wqkv, bqkv, wproj, bproj, eps=eps)
    return out.reshape(x.shape).to(x.dtype)


def packed_window_channel_attention(x, wqkv, bqkv, wproj, bproj, *,
                                    eps: float = 1e-12) -> torch.Tensor:
    """LocalAttention forward on a packed (B, Hp, Wp, 16C) tensor.

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    (contiguous fp32 or bf16 input, weights of the same type,
    ``window_attention.kernel_takes(C)``) or raises. The kernel is
    forward-only: a CUDA call that autograd would record raises.
    """
    C = _width(x, wqkv)
    if x.device.type == "cpu":
        return packed_window_channel_attention_plain(x, wqkv, bqkv, wproj,
                                                     bproj, eps=eps)
    return launch_attention(packed_window_channel_attention, x, wqkv, bqkv,
                            wproj, bproj, C, x.shape[:3], eps)


packed_window_channel_attention.launches = 0
