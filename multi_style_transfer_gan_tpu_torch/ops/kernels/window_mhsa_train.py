"""Window-8 multi-head self-attention mid with a hand-written backward:
CUDA kernels and plain versions.

``window_mhsa_train`` replaces ``ops/pallas/window_mhsa_train.py::
window_mhsa_train``; its kernels are ``csrc/window_mhsa_train.cu``. The
differentiable surface is the windowed MHSA MID on the (B, H, W, 3C) qkv
grid of the transformer block: window partition -> per-head softmax
attention -> merge. The qkv, proj and MLP matmuls and the LayerNorms stay
in autograd around it (structural_transformer._train_block_body).

Per window and head (window_mhsa_train.py:21-28), scale = hd^-0.5:

    s  = q k^T scale, max-subtracted ;  p = softmax(s)  ;  o = p v
    dv = p^T dO ;  dp = dO v^T ;  ds = p (.) (dp - rowsum(p (.) dp))
    dq = ds k scale ;  dk = ds^T q scale

The plain backward writes these formulas out; it is not autograd of the
plain forward.

The kernels take the blocks of the c8, c16 and c32 generators: C = 32, 64
and 128 (``KERNEL_WIDTHS``) in C / 32 heads of 32 (``kernel_heads``).
"""

from __future__ import annotations

import torch

from . import _build
from ._checks import check_cuda_args, dtype_code
from .window_attention_train import window_merge, window_partition

WINDOW = 8
KERNEL_WIDTHS = (32, 64, 128)   # each in kernel_heads(C) = C / 32 heads


def kernel_heads(C: int) -> int:
    """The head count the kernels take at width C: heads of 32 channels."""
    return C // 32


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, H, W, C) -> (windows, heads, 64, C / heads), fp32."""
    w = window_partition(t.float(), WINDOW)
    n, T, C = w.shape
    return w.reshape(n, T, heads, C // heads).transpose(1, 2)


def _qkv_heads(qkv: torch.Tensor, heads: int):
    C = qkv.shape[-1] // 3
    return [_split_heads(t, heads) for t in qkv.split(C, dim=-1)]


def _softmax_p(q, k):
    scale = q.shape[-1] ** -0.5
    return torch.softmax((q @ k.transpose(-2, -1)) * scale, dim=-1), scale


def _merge_heads(t: torch.Tensor, B: int, H: int, W: int):
    """(windows, heads, 64, hd) -> (B, H, W, heads * hd)."""
    n, h, T, hd = t.shape
    return window_merge(t.permute(0, 2, 1, 3).reshape(n, T, h * hd),
                        B, H, W, WINDOW)


def window_mhsa_plain(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain forward: (B, H, W, 3C) -> (B, H, W, C), fp32 inside, one
    rounding to qkv's type at the end, as the kernel does."""
    B, H, W, _ = qkv.shape
    q, k, v = _qkv_heads(qkv, heads)
    p, _ = _softmax_p(q, k)
    return _merge_heads(p @ v, B, H, W).to(qkv.dtype)


def window_mhsa_backward_plain(qkv: torch.Tensor, d_out: torch.Tensor,
                               heads: int) -> torch.Tensor:
    """Plain backward: d(qkv) (B, H, W, 3C) by the formulas in the module
    docstring."""
    B, H, W, C3 = qkv.shape
    q, k, v = _qkv_heads(qkv, heads)
    do = _split_heads(d_out, heads)
    p, scale = _softmax_p(q, k)
    dv = p.transpose(-2, -1) @ do
    dp = do @ v.transpose(-2, -1)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = (ds @ k) * scale
    dk = (ds.transpose(-2, -1) @ q) * scale
    dqkv = torch.cat([_merge_heads(t, B, H, W) for t in (dq, dk, dv)], dim=-1)
    return dqkv.to(qkv.dtype)


def _check(qkv: torch.Tensor, heads: int):
    if qkv.dim() != 4 or qkv.shape[-1] % 3 or (qkv.shape[-1] // 3) % heads:
        raise ValueError(f"window MHSA takes a (B, H, W, 3C) qkv grid with C "
                         f"divisible by heads={heads}, got {tuple(qkv.shape)}")
    B, H, W, C3 = qkv.shape
    if H % WINDOW or W % WINDOW:
        raise ValueError(f"window MHSA needs H and W divisible by {WINDOW}, "
                         f"got {H}x{W}")
    C = C3 // 3
    if qkv.device.type != "cpu" and (C not in KERNEL_WIDTHS
                                     or heads != kernel_heads(C)):
        raise ValueError(f"window_mhsa_train kernel is built for C in "
                         f"{KERNEL_WIDTHS} in C / 32 heads, got C={C} in "
                         f"{heads}")


def window_mhsa_fwd(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Forward of the mid. A CPU tensor takes the plain version; a CUDA
    tensor (contiguous, 16-byte aligned, fp32 or bf16, C in
    ``KERNEL_WIDTHS`` in C / 32 heads, H % 8 == W % 8 == 0) launches the
    kernel or raises."""
    _check(qkv, heads)
    if qkv.device.type == "cpu":
        return window_mhsa_plain(qkv, heads)
    # the bf16 kernels stage with 16-byte copies
    check_cuda_args("window_mhsa_fwd", qkv, {"qkv": (qkv, qkv.shape)})
    B, H, W, C3 = qkv.shape
    out = torch.empty((B, H, W, C3 // 3), device=qkv.device, dtype=qkv.dtype)
    if out.numel():
        rc = _build.kernel("window_mhsa_train_fwd")(
            qkv.data_ptr(), out.data_ptr(), B, H, W, C3 // 3, heads,
            dtype_code(qkv), qkv.device.index,
            torch.cuda.current_stream(qkv.device).cuda_stream)
        if rc:
            raise RuntimeError(f"window_mhsa_train forward launch failed: "
                               f"CUDA error {rc}")
        window_mhsa_fwd.launches += 1
    return out


def window_mhsa_bwd(qkv: torch.Tensor, d_out: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """Backward of the mid: d(qkv) from qkv and d(mid). Dispatch as
    :func:`window_mhsa_fwd`."""
    _check(qkv, heads)
    if qkv.device.type == "cpu":
        return window_mhsa_backward_plain(qkv, d_out, heads)
    B, H, W, C3 = qkv.shape
    check_cuda_args("window_mhsa_bwd", qkv,
                    {"qkv": (qkv, qkv.shape),
                     "d_out": (d_out, (B, H, W, C3 // 3))})
    dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
    if dqkv.numel():
        rc = _build.kernel("window_mhsa_train_bwd")(
            qkv.data_ptr(), d_out.data_ptr(), dqkv.data_ptr(), B, H, W,
            C3 // 3, heads, dtype_code(qkv), qkv.device.index,
            torch.cuda.current_stream(qkv.device).cuda_stream)
        if rc:
            raise RuntimeError(f"window_mhsa_train backward launch failed: "
                               f"CUDA error {rc}")
        window_mhsa_bwd.launches += 1
    return dqkv


window_mhsa_fwd.launches = 0
window_mhsa_bwd.launches = 0


class _WindowMHSA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, heads):
        ctx.heads = heads
        ctx.save_for_backward(qkv)
        return window_mhsa_fwd(qkv, heads)

    @staticmethod
    def backward(ctx, d_out):
        (qkv,) = ctx.saved_tensors
        d_out = d_out.to(qkv.dtype).contiguous()
        return window_mhsa_bwd(qkv, d_out, ctx.heads), None


def window_mhsa_train(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Differentiable window-8 MHSA mid on a contiguous (B, H, W, 3C) qkv
    grid -> (B, H, W, C); its backward returns d(qkv) as one tensor."""
    return _WindowMHSA.apply(qkv.contiguous(), heads)
