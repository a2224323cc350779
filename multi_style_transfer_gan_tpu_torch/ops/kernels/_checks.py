"""Argument checks shared by the kernel wrappers: what a kernel does not
take raises here, before any pointer reaches CUDA."""

from __future__ import annotations

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(x: torch.Tensor) -> int:
    """The element-type code the C entry points take (0 fp32, 1 bf16)."""
    return _DTYPE_CODES[x.dtype]


def grad_needed(*tensors) -> bool:
    """True when autograd records ops on any of ``tensors``: grad mode is on
    and one of them requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def check_no_grad(kernel: str, *tensors) -> None:
    """An inference kernel writes through raw pointers, so its output has
    no ``grad_fn``: raise rather than cut the gradient silently."""
    if grad_needed(*tensors):
        raise RuntimeError(
            f"{kernel} is an inference kernel and its output carries no "
            f"gradient, but an input requires grad while grad is enabled; "
            f"run it under torch.no_grad() or use the training route "
            f"(window_channel_attention_train, window_mhsa_train)")


def check_cuda_args(kernel: str, x: torch.Tensor, operands: dict,
                    align: int = 16) -> None:
    """x: the contiguous, ``align``-byte aligned activation on a CUDA
    device, fp32 or bf16 (the kernels move it 16 bytes at a time).
    operands: {name: (tensor, expected shape)}, each on x's device, of x's
    type, contiguous and ``align``-byte aligned (16 where a kernel loads 4
    elements at a time)."""
    if x.device.type != "cuda":
        raise ValueError(f"{kernel}: expected a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{kernel}: dtype {x.dtype} not supported "
                        f"(float32 or bfloat16)")
    if not x.is_contiguous() or x.data_ptr() % align:
        raise ValueError(f"{kernel}: input must be a contiguous (B, H, W, C) "
                         f"tensor (channels_last memory for NCHW), "
                         f"{align}-byte aligned")
    for name, (t, shape) in operands.items():
        if t.device != x.device or t.dtype != x.dtype:
            raise TypeError(f"{kernel}: {name} is {t.dtype} on {t.device}, "
                            f"expected {x.dtype} on {x.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"{kernel}: {name} must be contiguous and "
                             f"{align}-byte aligned")
