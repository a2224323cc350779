"""Argument checks shared by the kernel wrappers: what a kernel does not
take raises here, before any pointer reaches CUDA."""

from __future__ import annotations

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(x: torch.Tensor) -> int:
    """The element-type code the C entry points take (0 fp32, 1 bf16)."""
    return _DTYPE_CODES[x.dtype]


def check_cuda_args(kernel: str, x: torch.Tensor, operands: dict) -> None:
    """x: the contiguous activation on a CUDA device, fp32 or bf16.
    operands: {name: (tensor, expected shape)}, each on x's device, of x's
    type, contiguous and 16-byte aligned (the kernels load 4 at a time)."""
    if x.device.type != "cuda":
        raise ValueError(f"{kernel}: expected a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{kernel}: dtype {x.dtype} not supported "
                        f"(float32 or bfloat16)")
    if not x.is_contiguous():
        raise ValueError(f"{kernel}: input must be a contiguous (B, H, W, C) "
                         f"tensor (channels_last memory for NCHW)")
    for name, (t, shape) in operands.items():
        if t.device != x.device or t.dtype != x.dtype:
            raise TypeError(f"{kernel}: {name} is {t.dtype} on {t.device}, "
                            f"expected {x.dtype} on {x.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be contiguous and "
                             f"16-byte aligned")
