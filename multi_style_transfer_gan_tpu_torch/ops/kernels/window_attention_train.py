"""Windowed channel-attention mid with a hand-written backward: CUDA
kernels and plain versions.

``window_channel_attention_train`` replaces
``ops/pallas/window_attention_train.py::window_channel_attention_train``;
its kernels are ``csrc/window_attention_train.cu``. The differentiable
surface is the MID only, on the (B, H, W, 3C) map the 1x1 qkv conv makes:

    normalize q, k -> per-4x4-window C x C Gram -> softmax -> apply to v

so the qkv and proj convs stay in autograd around it, as in the JAX
package. The TPU's grouped lane-stacked layout and block-diagonal mask are
not ported: one window is one C x C Gram here. Backward per window
(window_attention_train.py:19-28), with S the softmax and dO the output
cotangent:

    dS  = dO^T v ;  dL = S (.) (dS - rowsum(S (.) dS))
    dv  = dO S ;  dqn = kn dL^T ;  dkn = qn dL
    dq  = (dqn - qn <qn, dqn> sel) / max(|q|, eps)   (and dk alike)

where sel is 0 for a vector whose norm is 0 or under eps, so an all-zero
window gives finite gradients. The plain backward writes these formulas
out; it is not autograd of the plain forward. It carries them in float64,
as the fp32 kernel's backward does: where |q| ~ 1e-3 the gradients reach
~4e3, past the reach of two fp32 evaluations in different orders
(``csrc/window_attention_train.cu``).

The kernels take C = 8, 16, 32 and 64 (``KERNEL_WIDTHS``), the
LocalAttention widths of the c8, c16 and c32 generators but c32's C = 128,
which has no training kernel in the JAX package either:
``window_attention_fast_vjp`` is its route.
"""

from __future__ import annotations

import torch

from . import _build
from ._checks import check_cuda_args, dtype_code

WINDOW = 4
KERNEL_WIDTHS = (8, 16, 32, 64)


def window_partition(t: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, K) -> (B * H/ws * W/ws, ws*ws, K), windows row-major,
    positions row-major inside each window."""
    B, H, W, K = t.shape
    t = t.reshape(B, H // ws, ws, W // ws, ws, K).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(-1, ws * ws, K)


def window_merge(t: torch.Tensor, B: int, H: int, W: int, ws: int):
    """Inverse of :func:`window_partition`."""
    K = t.shape[-1]
    t = t.reshape(B, H // ws, W // ws, ws, ws, K).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(B, H, W, K)


def _normalize(u: torch.Tensor, eps: float):
    """(u / max(|u|, eps) with 0 -> 0, 1 / that divisor, sel) over the last
    axis, as ``_norm_fwd`` (window_attention_train.py:96-106)."""
    ss = u.square().sum(dim=-1, keepdim=True)
    nz = ss > 0
    n = torch.sqrt(torch.where(nz, ss, 1.0))
    inv = 1.0 / torch.where(nz, torch.clamp_min(n, eps), eps)
    sel = (nz & (n > eps)).to(u.dtype)
    return u * inv, inv, sel


def _split_windows(qkv: torch.Tensor, eps: float, dtype=torch.float32):
    C = qkv.shape[-1] // 3
    q, k, v = window_partition(qkv.to(dtype), WINDOW).split(C, dim=-1)
    qn, inv_q, sel_q = _normalize(q, eps)
    kn, inv_k, sel_k = _normalize(k, eps)
    # S[c1, c2] = softmax_c2(sum_p qn[p, c1] kn[p, c2]), max-subtracted
    s = torch.softmax(qn.transpose(1, 2) @ kn, dim=-1)
    return qn, kn, v, s, (inv_q, sel_q, inv_k, sel_k)


def window_attention_mid_plain(qkv: torch.Tensor, eps: float = 1e-12):
    """Plain forward: (B, H, W, 3C) -> (B, H, W, C), fp32 inside, one
    rounding to qkv's type at the end, as the kernel does."""
    B, H, W, _ = qkv.shape
    _, _, v, s, _ = _split_windows(qkv, eps)
    out = v @ s.transpose(1, 2)      # out[p, c1] = sum_c2 S[c1, c2] v[p, c2]
    return window_merge(out, B, H, W, WINDOW).to(qkv.dtype)


def window_attention_mid_backward_plain(qkv: torch.Tensor, d_out: torch.Tensor,
                                        eps: float = 1e-12):
    """Plain backward: d(qkv) (B, H, W, 3C) from qkv and d(mid), by the
    formulas in the module docstring, float64 inside and one rounding to
    qkv's type at the end, as the kernels do in fp32."""
    B, H, W, _ = qkv.shape
    qn, kn, v, s, (inv_q, sel_q, inv_k, sel_k) = _split_windows(
        qkv, eps, torch.float64)
    do = window_partition(d_out.to(torch.float64), WINDOW)
    ds = do.transpose(1, 2) @ v                       # dS[c1, c2]
    dl = s * (ds - (s * ds).sum(dim=-1, keepdim=True))
    dv = do @ s                                       # dv[p, c2]
    dqn = kn @ dl.transpose(1, 2)                     # dqn[p, c1]
    dkn = qn @ dl                                     # dkn[p, c2]
    dq = (dqn - qn * (qn * dqn).sum(-1, keepdim=True) * sel_q) * inv_q
    dk = (dkn - kn * (kn * dkn).sum(-1, keepdim=True) * sel_k) * inv_k
    dqkv = torch.cat([dq, dk, dv], dim=-1)
    return window_merge(dqkv, B, H, W, WINDOW).to(qkv.dtype)


def _check(qkv: torch.Tensor):
    if qkv.dim() != 4 or qkv.shape[-1] % 3:
        raise ValueError(f"window attention mid takes a (B, H, W, 3C) qkv "
                         f"map, got {tuple(qkv.shape)}")
    B, H, W, C3 = qkv.shape
    if H % WINDOW or W % WINDOW:
        raise ValueError(f"window attention needs H and W divisible by "
                         f"{WINDOW}, got {H}x{W}")
    if qkv.device.type != "cpu" and C3 // 3 not in KERNEL_WIDTHS:
        raise ValueError(f"window_attention_train kernel is built for C in "
                         f"{KERNEL_WIDTHS}, got C={C3 // 3}")


def window_attention_mid_fwd(qkv: torch.Tensor, eps: float = 1e-12):
    """Forward of the mid. A CPU tensor takes the plain version; a CUDA
    tensor (contiguous, 16-byte aligned, fp32 or bf16, C in
    ``KERNEL_WIDTHS``) launches the kernel or raises."""
    _check(qkv)
    if qkv.device.type == "cpu":
        return window_attention_mid_plain(qkv, eps)
    # the bf16 kernels stage with 16-byte copies
    check_cuda_args("window_attention_mid_fwd", qkv, {"qkv": (qkv, qkv.shape)})
    B, H, W, C3 = qkv.shape
    out = torch.empty((B, H, W, C3 // 3), device=qkv.device, dtype=qkv.dtype)
    if out.numel():
        rc = _build.kernel("window_attention_train_fwd")(
            qkv.data_ptr(), out.data_ptr(), B, H, W, C3 // 3, dtype_code(qkv),
            eps, qkv.device.index,
            torch.cuda.current_stream(qkv.device).cuda_stream)
        if rc:
            raise RuntimeError(f"window_attention_train forward launch "
                               f"failed: CUDA error {rc}")
        window_attention_mid_fwd.launches += 1
    return out


def window_attention_mid_bwd(qkv: torch.Tensor, d_out: torch.Tensor,
                             eps: float = 1e-12):
    """Backward of the mid: d(qkv) from qkv and d(mid). Dispatch as
    :func:`window_attention_mid_fwd`."""
    _check(qkv)
    if qkv.device.type == "cpu":
        return window_attention_mid_backward_plain(qkv, d_out, eps)
    B, H, W, C3 = qkv.shape
    check_cuda_args("window_attention_mid_bwd", qkv,
                    {"qkv": (qkv, qkv.shape),
                     "d_out": (d_out, (B, H, W, C3 // 3))})
    dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
    if dqkv.numel():
        rc = _build.kernel("window_attention_train_bwd")(
            qkv.data_ptr(), d_out.data_ptr(), dqkv.data_ptr(), B, H, W,
            C3 // 3, dtype_code(qkv), eps, qkv.device.index,
            torch.cuda.current_stream(qkv.device).cuda_stream)
        if rc:
            raise RuntimeError(f"window_attention_train backward launch "
                               f"failed: CUDA error {rc}")
        window_attention_mid_bwd.launches += 1
    return dqkv


window_attention_mid_fwd.launches = 0
window_attention_mid_bwd.launches = 0


class _WindowAttentionMid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, eps):
        ctx.eps = eps
        ctx.save_for_backward(qkv)
        return window_attention_mid_fwd(qkv, eps)

    @staticmethod
    def backward(ctx, d_out):
        (qkv,) = ctx.saved_tensors
        d_out = d_out.to(qkv.dtype).contiguous()
        return window_attention_mid_bwd(qkv, d_out, ctx.eps), None


def window_channel_attention_train(qkv: torch.Tensor,
                                   eps: float = 1e-12) -> torch.Tensor:
    """Differentiable channel-attention mid on a contiguous (B, H, W, 3C)
    qkv map -> (B, H, W, C); its backward returns d(qkv) as one tensor."""
    return _WindowAttentionMid.apply(qkv.contiguous(), eps)
